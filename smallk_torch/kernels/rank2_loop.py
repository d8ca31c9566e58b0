"""Rank-2 A-products and the rank-2 iteration loop: the CUDA kernel's
wrappers and their plain versions (K3).

Port of the TPU kernel scripts/tpu_batch60.py:kernel (P3), the probe of
the rank-2 solve's iteration floor: ITERS times over a resident (m, w)
slab A,

    H = Wt . A   (2, w);   Wn = H . A^T   (2, m);   Wt = Wn / (max|Wn| + 1)

Its two products are the two A-products of every rank-2 NMF step
(solvers/rank2.py: W^T A and A H^T at k = 2), so K3 exports them alone,
and `ops.aop.DenseAOp` sends every k = 2 product of an f32 factor on a
CUDA f32 or bf16 A to them:

    wt_a(A, Wt) -> (2, w) f32       Wt (2, m) f32
    h_at(A, H)  -> (2, m) f32       H (2, w) f32
    rank2_loop(A, Wt, iters) -> (2, m) f32, P3's whole function

On CUDA tensors each launches the hand-written Hopper kernel
(csrc/rank2_loop.cu) or raises; on CPU tensors it takes its plain torch
version (`wt_a_plain`, `h_at_plain`, `rank2_loop_plain`), and only there.
A is read in its own dtype and every sum is in f32, as P3's
preferred_element_type=jnp.float32; no f32 copy of A is made.

`wt_a` cuts A's rows into slabs, one grid row each, so that a narrow slab
(w = 512 is 2 column blocks) still puts about four blocks on each of the
card's 132 SMs; `slab_plan` picks the cut, and a second launch adds the
slabs' partial sums in order.
"""

from __future__ import annotations

import torch

from . import _build

SOURCE = "smallk_torch/csrc/rank2_loop.cu"
REPLACES = "scripts/tpu_batch60.py:27"
ITERS = 200               # P3's iteration count
COLS = 256                # columns per wt_a block (csrc/rank2_loop.cu kCols)
TARGET_BLOCKS = 4 * 132   # about four blocks per SM of an H100
MIN_ROWS = 64             # fewest rows a slab is cut to

# wrapper calls that launched the kernel since the last reset; the only
# places it grows are the launches below
launches = 0

_A_DTYPES = (torch.float32, torch.bfloat16)


def slab_plan(m: int, w: int) -> tuple[int, int]:
    """(slabs, rows per slab) of wt_a's row cut for an (m, w) A."""
    col_blocks = -(-w // COLS)
    slabs = max(1, min(-(-TARGET_BLOCKS // col_blocks), -(-m // MIN_ROWS)))
    rows = -(-m // slabs)
    return -(-m // rows), rows


def wt_a(A, Wt):
    """A (m, w), Wt (2, m) -> Wt . A (2, w) f32."""
    global launches
    m, w = _check(A, Wt, "wt_a", (2, A.shape[0]))
    if Wt.device.type == "cpu":
        return wt_a_plain(A, Wt)
    dev = Wt.device
    slabs, rows = slab_plan(m, w)
    out = torch.empty((2, w), dtype=torch.float32, device=dev)
    partial = (torch.empty((slabs, 2, w), dtype=torch.float32, device=dev)
               if slabs > 1 else out)
    lib = _build.load_library("rank2_loop")
    fn = (lib.smallk_wt_a_f32 if A.dtype == torch.float32
          else lib.smallk_wt_a_bf16)
    _raise_on(lib, fn(A.data_ptr(), Wt.data_ptr(), out.data_ptr(),
                      partial.data_ptr(), m, w, slabs, rows,
                      torch.cuda.current_stream(dev).cuda_stream, dev.index),
              "wt_a", m, w)
    launches += 1
    return out


def h_at(A, H):
    """A (m, w), H (2, w) -> H . A^T (2, m) f32."""
    global launches
    m, w = _check(A, H, "h_at", (2, A.shape[1]))
    if H.device.type == "cpu":
        return h_at_plain(A, H)
    dev = H.device
    out = torch.empty((2, m), dtype=torch.float32, device=dev)
    lib = _build.load_library("rank2_loop")
    fn = (lib.smallk_h_at_f32 if A.dtype == torch.float32
          else lib.smallk_h_at_bf16)
    _raise_on(lib, fn(A.data_ptr(), H.data_ptr(), out.data_ptr(), m, w,
                      torch.cuda.current_stream(dev).cuda_stream, dev.index),
              "h_at", m, w)
    launches += 1
    return out


def rank2_loop(A, Wt, iters: int = ITERS):
    """P3: `iters` iterations of Wt <- (Wt.A).A^T / (max|.| + 1) from Wt
    (2, m); returns the last Wt (2, m) f32."""
    global launches
    m, w = _check(A, Wt, "rank2_loop", (2, A.shape[0]))
    if iters < 0:
        raise ValueError(f"rank2_loop: iters={iters} < 0")
    if Wt.device.type == "cpu":
        return rank2_loop_plain(A, Wt, iters)
    dev = Wt.device
    f32 = dict(dtype=torch.float32, device=dev)
    slabs, rows = slab_plan(m, w)
    out = Wt.clone()
    H = torch.empty((2, w), **f32)
    Wn = torch.empty((2, m), **f32)
    partial = torch.empty((slabs, 2, w), **f32) if slabs > 1 else H
    maxbits = torch.empty((1,), dtype=torch.int32, device=dev)
    lib = _build.load_library("rank2_loop")
    fn = (lib.smallk_rank2_loop_f32 if A.dtype == torch.float32
          else lib.smallk_rank2_loop_bf16)
    _raise_on(lib, fn(A.data_ptr(), out.data_ptr(), H.data_ptr(),
                      Wn.data_ptr(), partial.data_ptr(), maxbits.data_ptr(),
                      m, w, iters, slabs, rows,
                      torch.cuda.current_stream(dev).cuda_stream, dev.index),
              "rank2_loop", m, w)
    launches += 1
    return out


def _check(A, F, name, want):
    """Shapes, devices, dtypes and layout the kernel takes; (m, w)."""
    if A.ndim != 2 or tuple(F.shape) != want:
        raise ValueError(f"{name}: A {tuple(A.shape)} and factor "
                         f"{tuple(F.shape)} (expected {want})")
    if A.device != F.device:
        raise ValueError(f"{name}: operands on different devices")
    m, w = A.shape
    if m < 1 or w < 1:
        raise ValueError(f"{name}: empty A {tuple(A.shape)}")
    if F.device.type == "cpu":
        return m, w
    if F.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {F.device}")
    if A.dtype not in _A_DTYPES:
        raise ValueError(f"{name}: A dtype {A.dtype} (the kernel takes "
                         "float32 or bfloat16)")
    if F.dtype != torch.float32:
        raise ValueError(f"{name}: factor dtype {F.dtype} (the kernel takes "
                         "float32)")
    if not (A.is_contiguous() and F.is_contiguous()):
        raise ValueError(f"{name}: A and the factor must be contiguous")
    return m, w


def _raise_on(lib, err, name, m, w):
    if err != 0:
        msg = lib.smallk_rank2_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} "
                           f"(cudaError {err}, m={m}, w={w})")


def wt_a_plain(A, Wt):
    """Plain torch version of wt_a: A upcast to the factor's dtype, then
    one product."""
    return torch.matmul(Wt, A.to(Wt.dtype))


def h_at_plain(A, H):
    """Plain torch version of h_at."""
    return torch.matmul(H, A.to(H.dtype).T)


def rank2_loop_plain(A, Wt, iters: int = ITERS):
    """Plain torch version of P3: the body of scripts/tpu_batch60.py's
    xla_loop, op for op."""
    for _ in range(iters):
        H = wt_a_plain(A, Wt)
        Wn = h_at_plain(A, H)
        s = torch.max(torch.abs(Wn)) + 1.0
        Wt = (Wn / s).to(Wt.dtype)
    return Wt

