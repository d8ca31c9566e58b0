"""Whole-step HALS: the CUDA kernel's wrapper, its plain version and its fit test.

Port of the TPU kernel smallk_tpu/solvers/hals_pallas.py:_hals_step_kernel
(K2).  One call is one HALS iteration on a dense operand:

    W sweep (clamp, zero-column rescue, unit L2) -> W'W, W'A -> H sweep
    -> gradH = W'W H - W'A -> HH', AH' -> gradW = W HH' - AH'

`hals_step` launches the hand-written Hopper kernel (csrc/hals_step.cu) on
CUDA tensors and takes the plain torch version, `hals_step_reference`,
only for tensors that lie on the CPU.  Both return
(W, H, gradW, gradH, HHt, AHt, ok), `ok` a 0-d bool tensor that is true
when both gradients are finite; the kernel writes that flag itself.

The kernel sums in f64 and keeps f32 wherever the plain version holds a
tensor between ops (the factors, W'A and the outputs); the CUDA source
says why.

The fit test.  The kernel is a cluster of CLUSTER = 8 CTAs; CTA q keeps
its slice of the factor-side state in shared memory, and reads the other
CTAs' slices of W and H through distributed shared memory:

    f32: its rows of W^T (k, ms) and its columns of H (k, ns),
         ms = ceil(m / 8) | 1, ns = ceil(n / 8) | 1 (odd strides); its
         rows of AH'^T (k, ms) until the W sweep ends, then in the same
         bytes its columns of W'A (k, ns)
    f64: HH', W'W and the two partial Grams (k, k) each, and 4 x 8
         doubles of reduction slots

    bytes = 4 k (ms + ns + max(ms, ns)) + 8 (4 k^2 + 32) <= 232448

(232448 bytes, 227 KB, is the most a block may opt into on Hopper).  A
stays in global memory (L2-resident at these sizes) in its own dtype.  On
top of that, a shape must pass the reference's own envelope
(hals_pallas.py:39-45: A stored + its f32 upcast + ~4 copies of each
factor + 4 k x k, within 8 MiB), so that no shape goes through this kernel
that the TPU would not have sent to its own.  At k = 16 the envelope binds
first: the largest square A is 992 x 992 in f32 and 1140 x 1140 in bf16
(32,448 bytes of shared memory a CTA at 992 x 992, 14,784 at 256 x 256).
"""

from __future__ import annotations

import torch

from . import _build

MAX_SMEM = 232448       # bytes of shared memory a block may opt into
CLUSTER = 8             # CTAs of a step
RED_DOUBLES = 32        # reduction slots in the kernel's layout
# the study's build: phase stamps per CTA (csrc/hals_step.cu)
STAMP_DEFINES = ("SMALLK_HALS_STAMPS",)
SEAMS = ("start", "staged", "W sweep", "W'W", "W'A", "H sweep",
         "gradH + partial HH'", "HH'", "AH' + gradW", "end")
_REF_VMEM_BUDGET = 8 * 1024 * 1024  # the reference's envelope
SOURCE = "smallk_torch/csrc/hals_step.cu"
REPLACES = "smallk_tpu/solvers/hals_pallas.py:56"

# kernel launches since the last reset; the only place it grows is the
# launch below
launches = 0


def _stride(d: int) -> int:
    """A CTA's rows (or columns) of a d-long axis, as an odd stride."""
    return -(-d // CLUSTER) | 1


def smem_bytes(m: int, n: int, k: int) -> int:
    """Dynamic shared memory of one CTA (csrc/hals_step.cu layout)."""
    ms, ns = _stride(m), _stride(n)
    return 4 * k * (ms + ns + max(ms, ns)) + 8 * (4 * k * k + RED_DOUBLES)


def hals_fits(m: int, n: int, k: int, a_itemsize: int = 4) -> bool:
    """Whether (m, n, k) goes through the kernel (module docstring)."""
    if min(m, n, k) < 1:
        return False
    a_bytes = m * n * a_itemsize + m * n * 4
    fac = 4 * (k * m + k * n) * 4
    in_envelope = a_bytes + fac + 4 * k * k * 4 <= _REF_VMEM_BUDGET
    return in_envelope and smem_bytes(m, n, k) <= MAX_SMEM


def hals_step(A, W, H, HHt, AHt, *, stamped=False):
    """A (m, n); W (m, k), H (k, n), HHt (k, k), AHt (m, k) -> the step.

    CUDA tensors: the kernel (A float32 or bfloat16, the rest float32, a
    shape that passes `hals_fits`), or an exception.  CPU tensors: the
    plain version.  `stamped` launches the study's build, whose phase
    stamps `read_stamps` returns.
    """
    global launches
    m, n, k = _check_shapes(A, W, H, HHt, AHt)
    dev = W.device
    if dev.type == "cpu":
        return hals_step_reference(A, W, H, HHt, AHt)
    if dev.type != "cuda":
        raise ValueError(f"hals_step: unsupported device {dev}")
    if A.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"hals_step: A dtype {A.dtype} (the kernel takes "
                         "float32 or bfloat16)")
    for name, t in (("W", W), ("H", H), ("HHt", HHt), ("AHt", AHt)):
        if t.dtype != torch.float32:
            raise ValueError(f"hals_step: {name} dtype {t.dtype} (the "
                             "kernel takes float32 factors)")
    if not hals_fits(m, n, k, A.element_size()):
        raise ValueError(f"hals_step: m={m}, n={n}, k={k} does not fit the "
                         "kernel (hals_fits)")
    A, W, H, HHt, AHt = (t.contiguous() for t in (A, W, H, HHt, AHt))
    f32 = dict(dtype=torch.float32, device=dev)
    W2 = torch.empty((m, k), **f32)
    H2 = torch.empty((k, n), **f32)
    gW = torch.empty((m, k), **f32)
    gH = torch.empty((k, n), **f32)
    HHt2 = torch.empty((k, k), **f32)
    AHt2 = torch.empty((m, k), **f32)
    ok = torch.empty((), dtype=torch.uint8, device=dev)
    lib = _build.load_library("hals_step", STAMP_DEFINES if stamped else ())
    fn = (lib.smallk_hals_step_f32 if A.dtype == torch.float32
          else lib.smallk_hals_step_bf16)
    err = fn(A.data_ptr(), W.data_ptr(), H.data_ptr(), HHt.data_ptr(),
             AHt.data_ptr(), W2.data_ptr(), H2.data_ptr(), gW.data_ptr(),
             gH.data_ptr(), HHt2.data_ptr(), AHt2.data_ptr(), ok.data_ptr(),
             m, n, k, torch.cuda.current_stream(dev).cuda_stream, dev.index)
    if err != 0:
        msg = lib.smallk_hals_cuda_error_string(err).decode()
        raise RuntimeError(f"hals_step kernel launch failed: {msg} "
                           f"(cudaError {err}, m={m}, n={n}, k={k})")
    launches += 1
    return W2, H2, gW, gH, HHt2, AHt2, ok.view(torch.bool)


def _raise(lib, err, what):
    msg = lib.smallk_hals_cuda_error_string(err).decode()
    raise RuntimeError(f"{what} failed: {msg} (cudaError {err})")


def read_stamps(device=None):
    """The phase stamps of the last stamped launch on `device`: a (CLUSTER,
    len(SEAMS), 2) int64 tensor of (clock64, %globaltimer ns) per CTA and
    seam (synchronises the device)."""
    dev = torch.device("cuda" if device is None else device)
    lib = _build.load_library("hals_step", STAMP_DEFINES)
    out = torch.zeros((CLUSTER, len(SEAMS), 2), dtype=torch.int64)
    got = lib.smallk_hals_stamps(out.data_ptr(), out.numel(),
                                 dev.index or 0)
    if got != out.numel():
        _raise(lib, -got, "reading the phase stamps")
    return out


def max_active_clusters(m: int, n: int, k: int, device=None) -> int:
    """cudaOccupancyMaxActiveClusters for the f32 kernel at (m, n, k)."""
    dev = torch.device("cuda" if device is None else device)
    lib = _build.load_library("hals_step")
    got = lib.smallk_hals_max_active_clusters(m, n, k, dev.index or 0)
    if got < 0:
        _raise(lib, -got, "cudaOccupancyMaxActiveClusters")
    return got


def cluster_probe(iters: int, device=None):
    """One run of the cluster probe: (cycles per cluster barrier, ns per
    cluster barrier, cycles per dependent DSMEM load, cycles per dependent
    local shared-memory load), over `iters` of each."""
    dev = torch.device("cuda" if device is None else device)
    lib = _build.load_library("hals_step")
    out = torch.zeros(5, dtype=torch.int64, device=dev)
    err = lib.smallk_cluster_probe(out.data_ptr(), iters,
                                   torch.cuda.current_stream(dev).cuda_stream,
                                   dev.index or 0)
    if err != 0:
        _raise(lib, err, "the cluster probe's launch")
    vals = out.cpu().tolist()
    return tuple(v / iters for v in vals[:4])


def _check_shapes(A, W, H, HHt, AHt):
    if A.ndim != 2 or W.ndim != 2:
        raise ValueError("hals_step: A and W must be matrices")
    (m, n), k = A.shape, W.shape[1]
    want = {"W": (m, k), "H": (k, n), "HHt": (k, k), "AHt": (m, k)}
    for name, t in (("W", W), ("H", H), ("HHt", HHt), ("AHt", AHt)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"hals_step: {name} is {tuple(t.shape)}, "
                             f"expected {want[name]}")
    if not (A.device == W.device == H.device == HHt.device == AHt.device):
        raise ValueError("hals_step: operands on different devices")
    return m, n, k


def hals_step_reference(A, W, H, HHt, AHt):
    """Plain torch version: the torch-ops step of solvers/hals.py on a dense
    operand, op for op the reference's XLA step (hals.py:115-130)."""
    from ..ops.aop import DenseAOp
    from ..solvers.hals import torch_step

    return torch_step(DenseAOp(A), W, H, HHt, AHt)
