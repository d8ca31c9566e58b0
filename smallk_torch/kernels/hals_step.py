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

The fit test.  The kernel is one CTA that keeps the factor-side state in
shared memory:

    f32: W^T (k, m), AH'^T (k, m), H (k, n), W'A (k, n)
    f64: HH' (k, k), W'W (k, k) and 128 doubles of reduction scratch

    bytes = 4 (2 k m + 2 k n) + 8 (2 k^2 + 128) <= 232448

(232448 bytes, 227 KB, is the most a block may opt into on Hopper).  A
stays in global memory (L2-resident at these sizes) in its own dtype.  On
top of that, a shape must pass the reference's own envelope
(hals_pallas.py:39-45: A stored + its f32 upcast + ~4 copies of each
factor + 4 k x k, within 8 MiB), so that no shape goes through this kernel
that the TPU would not have sent to its own.  At k = 16 the shared-memory
bound binds first: the largest square A is 888 x 888 (the envelope alone
would allow 992 x 992 in f32).
"""

from __future__ import annotations

import torch

from . import _build

MAX_SMEM = 232448       # bytes of shared memory a block may opt into
RED_DOUBLES = 128       # reduction scratch in the kernel's layout
_REF_VMEM_BUDGET = 8 * 1024 * 1024  # the reference's envelope
SOURCE = "smallk_torch/csrc/hals_step.cu"
REPLACES = "smallk_tpu/solvers/hals_pallas.py:56"

# kernel launches since the last reset; the only place it grows is the
# launch below
launches = 0


def smem_bytes(m: int, n: int, k: int) -> int:
    """Dynamic shared memory of one launch (csrc/hals_step.cu layout)."""
    return 4 * (2 * k * m + 2 * k * n) + 8 * (2 * k * k + RED_DOUBLES)


def hals_fits(m: int, n: int, k: int, a_itemsize: int = 4) -> bool:
    """Whether (m, n, k) goes through the kernel (module docstring)."""
    if min(m, n, k) < 1:
        return False
    a_bytes = m * n * a_itemsize + m * n * 4
    fac = 4 * (k * m + k * n) * 4
    in_envelope = a_bytes + fac + 4 * k * k * 4 <= _REF_VMEM_BUDGET
    return in_envelope and smem_bytes(m, n, k) <= MAX_SMEM


def hals_step(A, W, H, HHt, AHt):
    """A (m, n); W (m, k), H (k, n), HHt (k, k), AHt (m, k) -> the step.

    CUDA tensors: the kernel (A float32 or bfloat16, the rest float32, a
    shape that passes `hals_fits`), or an exception.  CPU tensors: the
    plain version.
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
    lib = _build.load_library("hals_step")
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
