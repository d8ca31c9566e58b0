"""Masked Gauss-Jordan solve: the CUDA kernel's wrapper and its plain version.

Port of the TPU kernel smallk_tpu/solvers/pallas_kernels.py:_gj_kernel
(K1).  For each column j, with p = passive[:, j], it solves

    ((p p^T) .* LHS + diag(1 - p)) x = p .* rhs_j

by unpivoted Gauss-Jordan with the dead-pivot guard, giving the solution
of the passive subsystem and zeros on the non-passive rows.

`masked_gj_solve` launches a hand-written Hopper kernel
(csrc/masked_gj.cu) on CUDA tensors and takes the plain torch version,
`masked_gj_solve_reference`, only for tensors that lie on the CPU.  The
source holds two device kernels, picked by k: one for narrow ranks (a
thread per column and row group, the full masked system) and one for wide
ranks (a warp per column, the column's compact passive system).  What
bounds each on the card and how its design answers that is written at the
top of the CUDA source.  `masked_gj_solve_compact_reference` is the wide
kernel's specification in torch ops; only the tests use it.
"""

from __future__ import annotations

import torch

from . import _build

MAX_K = 128
SOURCE = "smallk_torch/csrc/masked_gj.cu"
REPLACES = "smallk_tpu/solvers/pallas_kernels.py:59"

# From this rank on the wide kernel is the faster of the two.  Measured by
# chip_smoke.py's k-sweep (f32, device ms per call, narrow / wide) on an
# NVIDIA H100 80GB HBM3, 700.00 W: (8, 7984) 0.0084 / 0.0228, (8, 12411)
# 0.0095 / 0.0324, (16, 7984) 0.0237 / 0.0274, (16, 65536)
# 0.1098 / 0.1779, (32, 2000) 0.0504 / 0.0198, (32, 65536) 0.6853 / 0.3106,
# (64, 500) 0.0794 / 0.0302, (128, 130) 0.2338 / 0.0793.
WIDE_MIN_K = 32

# kernel launches since the last reset, and the columns they solved (the
# sum of n over launches); the only place they grow is `_launch`
launches = 0
columns = 0

# bound on the plain version's (k, k+1, chunk) working tensor
_REF_BYTES_BUDGET = 256 * 1024 * 1024


def masked_gj_solve(LHS, RHS, passive):
    """LHS (k, k), RHS (k, n), passive (k, n) bool -> X (k, n), LHS's dtype.

    CUDA tensors: a kernel (f32 or f64, 1 <= k <= MAX_K, contiguous; the
    wide one from k = WIDE_MIN_K), or an exception.  CPU tensors: the
    plain version.
    """
    _check_shapes(LHS, RHS, passive)
    dev = LHS.device
    if dev.type == "cpu":
        return masked_gj_solve_reference(LHS, RHS, passive)
    if dev.type != "cuda":
        raise ValueError(f"masked_gj_solve: unsupported device {dev}")
    if LHS.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"masked_gj_solve: dtype {LHS.dtype} (the kernel "
                         "takes float32 or float64)")
    k, n = RHS.shape
    if k > MAX_K:
        raise ValueError(f"masked_gj_solve: k={k} exceeds the kernel's "
                         f"limit of {MAX_K}")
    for name, t in (("LHS", LHS), ("RHS", RHS), ("passive", passive)):
        if not t.is_contiguous():
            raise ValueError(f"masked_gj_solve: {name} is not contiguous")
    if k >= WIDE_MIN_K:
        return _launch_wide(LHS, RHS, passive)
    return _launch_narrow(LHS, RHS, passive)


def _launch_narrow(LHS, RHS, passive):
    """The narrow-rank device kernel on checked CUDA operands."""
    return _launch("smallk_masked_gj", LHS, RHS, passive)


def _launch_wide(LHS, RHS, passive):
    """The wide-rank device kernel on checked CUDA operands."""
    return _launch("smallk_masked_gj_wide", LHS, RHS, passive)


def _launch(entry, LHS, RHS, passive):
    global launches, columns
    k, n = RHS.shape
    dev = LHS.device
    X = torch.empty((k, n), dtype=LHS.dtype, device=dev)
    if n == 0:
        return X
    lib = _build.load_library("masked_gj")
    fn = getattr(lib, entry + ("_f32" if LHS.dtype == torch.float32
                               else "_f64"))
    err = fn(LHS.data_ptr(), RHS.data_ptr(), passive.data_ptr(),
             X.data_ptr(), k, n, torch.cuda.current_stream(dev).cuda_stream,
             dev.index)
    if err != 0:
        msg = lib.smallk_cuda_error_string(err).decode()
        raise RuntimeError(f"masked_gj kernel launch failed: {msg} "
                           f"(cudaError {err}, {entry}, k={k}, n={n})")
    launches += 1
    columns += n
    return X


def _check_shapes(LHS, RHS, passive):
    if RHS.ndim != 2 or LHS.shape != (RHS.shape[0], RHS.shape[0]):
        raise ValueError(f"masked_gj_solve: LHS {tuple(LHS.shape)} and RHS "
                         f"{tuple(RHS.shape)} must be (k, k) and (k, n)")
    if passive.shape != RHS.shape or passive.dtype != torch.bool:
        raise ValueError("masked_gj_solve: passive must be a bool tensor "
                         "of RHS's shape")
    if RHS.dtype != LHS.dtype:
        raise ValueError(f"masked_gj_solve: RHS dtype {RHS.dtype} differs "
                         f"from LHS dtype {LHS.dtype}")
    if not (LHS.device == RHS.device == passive.device):
        raise ValueError("masked_gj_solve: operands on different devices")
    if RHS.shape[0] < 1:
        raise ValueError("masked_gj_solve: k must be >= 1")


def masked_gj_solve_reference(LHS, RHS, passive):
    """Plain torch version, op for op the reference's
    smallk_tpu/solvers/nnls.py:_gj_solve_block, in column chunks that bound
    its (k, k+1, chunk) working tensor.  Columns are independent, so the
    chunking does not change a single bit of the result."""
    k, n = RHS.shape
    chunk = max(1, _REF_BYTES_BUDGET // (k * (k + 1) * LHS.element_size()))
    if n <= chunk:
        return _gj_block(LHS, RHS, passive)
    return torch.cat([
        _gj_block(LHS, RHS[:, s:s + chunk], passive[:, s:s + chunk])
        for s in range(0, n, chunk)
    ], dim=1)


def _gj_block(LHS, RHS, passive):
    k, n = RHS.shape
    dtype, dev = LHS.dtype, LHS.device
    p = passive.to(dtype)  # (k, n)
    eye = torch.eye(k, dtype=dtype, device=dev)
    # (k, k+1, n): the batch of columns is the last axis
    M = (LHS[:, :, None] * (p[:, None, :] * p[None, :, :])
         + eye[:, :, None] * (1.0 - p)[:, None, :])  # (k, k, n)
    b = RHS * p
    aug = torch.cat([M, b[:, None, :]], dim=1)
    unit = torch.arange(k, device=dev)
    # dead-pivot guard: a dead topic's ~0 diagonal becomes a unit row whose
    # solution component is 0 (see the reference's _gj_solve_block)
    tiny = k * torch.finfo(dtype).eps * (torch.max(torch.abs(LHS)) + 1.0)
    unit_rows = torch.cat(
        [eye, torch.zeros((k, 1), dtype=dtype, device=dev)], dim=1)
    for j in range(k):
        piv = aug[j, j, :]
        safe = torch.abs(piv) > tiny
        piv_use = torch.where(safe, piv, 1.0)
        row_j = torch.where(safe[None, :], aug[j] / piv_use[None, :],
                            unit_rows[j][:, None])  # (k+1, n)
        factors = torch.where((unit == j)[:, None], 0.0, aug[:, j, :])
        factors = torch.where(safe[None, :], factors, 0.0)
        aug.sub_(factors[:, None, :] * row_j[None, :, :])  # in place
        aug[j] = row_j
    return aug[:, k, :].contiguous()  # a copy: the view would pin aug


def masked_gj_solve_compact_reference(LHS, RHS, passive):
    """The wide kernel's specification in torch ops, column by column:
    gather the column's q x (q+1) passive system, run the same unpivoted
    Gauss-Jordan with the same dead-pivot guard (tiny from the full k and
    the full LHS) on it, scatter x to the passive rows and leave zeros on
    the others.  A column whose rhs holds a non-finite value comes out all
    NaN.  Equal to `masked_gj_solve_reference` on finite inputs (a zero's
    sign may differ)."""
    k, n = RHS.shape
    dtype = LHS.dtype
    tiny = k * torch.finfo(dtype).eps * (torch.max(torch.abs(LHS)) + 1.0)
    X = torch.zeros((k, n), dtype=dtype, device=LHS.device)
    for c in range(n):
        if not bool(torch.isfinite(RHS[:, c]).all()):
            X[:, c] = float("nan")
            continue
        idx = torch.nonzero(passive[:, c])[:, 0]
        q = idx.numel()
        S = torch.cat([LHS[idx][:, idx] + 0.0, RHS[idx, c][:, None]], dim=1)
        for j in range(q):
            piv = S[j, j]
            if bool(torch.abs(piv) > tiny):
                S[j, j + 1:] = S[j, j + 1:] / piv
                rows = torch.arange(q, device=S.device) != j
                S[rows, j + 1:] -= (S[rows, j][:, None]
                                    * S[j, j + 1:][None, :])
            else:  # a dead pivot leaves a unit row and eliminates nothing
                S[j, j + 1:] = 0.0
        X[idx, c] = S[:, q]
    return X
