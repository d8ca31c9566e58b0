"""HALS (hierarchical alternating least squares, Cichocki 'Da' variant) —
port of smallk_tpu/solvers/hals.py.

  For each column c of W (sequentially):
      W(:,c) = clamp0( W(:,c) + (AH'(:,c) - W HH'(:,c)) / HH'(c,c) )
      all-zero column -> filled with machine eps, then unit L2
  For each row r of H (sequentially, using the partially updated H):
      H(r,:) = clamp0( H(r,:) + (W'A(r,:) - W'W(r,:) H) / W'W(r,r) )

`step` sends a dense f32 problem on the card whose shape passes
`kernels.hals_step.hals_fits` to the whole-step kernel K2, one launch per
step, as the reference's `_pallas_step_ok` sends such a problem to its
Pallas kernel.  Everything else (f64, the CPU, shapes that do not fit)
runs the torch-ops step: a dispatch rule, not a fallback.  Inside the
gate a kernel that fails to build or launch raises.  A sharded operand
(parallel/mesh.py) is outside it: K2 needs all of A and each W column's
global norm inside one launch, so a sharded step is the torch-ops step,
each W column's rescue test and unit norm taken over the terms axis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import hals_step as k2
from ..ops.aop import DenseAOp
from ..ops.dense import UNSHARDED, gemm, gram, gram_t


class HalsState(NamedTuple):
    HHt: torch.Tensor  # k x k
    AHt: torch.Tensor  # m x k


def init(a_op, W, H) -> HalsState:
    return HalsState(HHt=a_op.sum_docs(gram_t(H)), AHt=a_op.mm_nt(H))


def _clamp0(x):
    """NaN or negative -> 0; +Inf stays (the reference's select, not a max)."""
    return torch.where(torch.isnan(x) | (x < 0), 0.0, x)


def update_h(H, WtW, WtA):
    """Sequential HALS row sweep over H (reference UpdateH_Hals): k rank-1
    updates on a copy of H."""
    H = H.clone()
    for r in range(H.shape[0]):
        wtwh_r = gemm(WtW[r:r + 1, :], H)  # (1, n)
        h_new = H[r:r + 1] + (WtA[r:r + 1] - wtwh_r) / WtW[r, r]
        H[r:r + 1] = _clamp0(h_new)
    return H


def update_w(W, HHt, AHt, a_op=UNSHARDED):
    """Sequential HALS column sweep over W with zero-column rescue and
    per-column normalization (reference UpdateW_Hals), on a copy of W.
    On a sharded operand each column's rescue test and norm are global:
    two reductions over the terms axis a column."""
    W = W.clone()
    eps = torch.finfo(W.dtype).eps
    for c in range(W.shape[1]):
        whht_c = gemm(W, HHt[:, c:c + 1])  # (m, 1)
        w_new = _clamp0(W[:, c:c + 1] + (AHt[:, c:c + 1] - whht_c) / HHt[c, c])
        # all-zero column rescue
        w_new = torch.where(a_op.all_terms(w_new == 0), eps, w_new)
        # unit L2 normalization
        W[:, c:c + 1] = w_new / torch.sqrt(
            a_op.sum_terms(torch.sum(torch.square(w_new))))
    return W


def torch_step(a_op, W, H, HHt, AHt):
    """One HALS step in torch ops -> (W, H, gradW, gradH, HHt, AHt, ok)."""
    W = update_w(W, HHt, AHt, a_op)

    WtW = a_op.sum_terms(gram(W))
    WtA = a_op.mm_tn(W)

    H = update_h(H, WtW, WtA)

    gradH = gemm(WtW, H) - WtA

    HHt = a_op.sum_docs(gram_t(H))
    AHt = a_op.mm_nt(H)
    gradW = gemm(W, HHt) - AHt

    # isfinite, not just not-NaN: f32 overflow yields Inf without NaN
    ok = torch.all(torch.isfinite(gradW)) & torch.all(torch.isfinite(gradH))
    return W, H, gradW, gradH, HHt, AHt, ok


def _kernel_step_ok(a_op, W, H) -> bool:
    """The reference's `_pallas_step_ok`, for the card: dense A in f32,
    bf16 or e4m3, f32 W, CUDA tensors, and a shape that fits the kernel;
    so never a sharded operand (a `ShardedAOp` is no `DenseAOp`)."""
    if not (isinstance(a_op, DenseAOp) and W.dtype == torch.float32
            and a_op.A.dtype in k2.A_DTYPES
            and W.is_cuda):
        return False
    m, k = W.shape
    return k2.hals_fits(m, H.shape[1], k, a_op.A.element_size())


def step(a_op, W, H, state: HalsState):
    HHt, AHt = state
    if _kernel_step_ok(a_op, W, H):
        out = k2.hals_step(a_op.A, W, H, HHt, AHt)
    else:
        out = torch_step(a_op, W, H, HHt, AHt)
    W, H, gradW, gradH, HHt, AHt, ok = out
    return W, H, gradW, gradH, HalsState(HHt=HHt, AHt=AHt), ok
