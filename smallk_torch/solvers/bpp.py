"""ANLS block-principal-pivoting NMF solver — port of smallk_tpu/solvers/bpp.py.

Alternates NnlsBlockpivot(W'W, W'A) -> H and NnlsBlockpivot(HH', HA') -> W',
warm-starting each NNLS from the previous factors, and recomputes gradH
with the updated W after both solves.

On a sharded operand (parallel/mesh.py) the H-side NNLS solves the rank's
columns and the W-side its rows, each with its pivot loop's decisions and
infeasibility floor taken over the axis that shards its columns; the Grams
and the rebalance's norms are summed over the axis that shards W or H.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.dense import gemm, gram, gram_t, normalize_and_scale
from .nnls import nnls_blockpivot


class BppState(NamedTuple):
    Wt: torch.Tensor   # k x m (warm start for the W-side NNLS)
    WtW: torch.Tensor  # k x k
    WtA: torch.Tensor  # k x n
    pivot_rounds: int  # cumulative NNLS pivot rounds


def init(a_op, W, H) -> BppState:
    return BppState(Wt=W.T, WtW=a_op.sum_terms(gram(W)), WtA=a_op.mm_tn(W),
                    pivot_rounds=0)


def step(a_op, W, H, state: BppState):
    Wt, WtW, WtA, rounds = state

    # H-side: solve (W'W) H = W'A with H >= 0
    H, gradH, ok_h, r_h = nnls_blockpivot(WtW, WtA, H, a_op.max_docs)

    # W-side: solve (HH') W' = H A' with W' >= 0
    HHt = a_op.sum_docs(gram_t(H))
    HAt = a_op.mm_nt(H).T  # (k, m) == H @ A'
    Wt, gradWt, ok_w, r_w = nnls_blockpivot(HHt, HAt, Wt, a_op.max_terms)

    W = Wt.T

    # Per-iteration W/H scale rebalancing (product-invariant).  In f32 the
    # W-up/H-down scale drift of alternating NNLS compounds into kappa(W'W)
    # until topics collapse (k=32 diverges after ~400 iterations without it).
    W, H, norms = normalize_and_scale(W, H, a_op)
    Wt = W.T
    # gradient at the rebalanced point: dL/dW_new = dL/dW_old * diag(norms)
    gradW = gradWt.T * norms[None, :]

    # recompute gradH with the updated W
    WtW = a_op.sum_terms(gram(W))
    WtA = a_op.mm_tn(W)
    gradH = gemm(WtW, H) - WtA

    ok = ok_h & ok_w
    return W, H, gradW, gradH, BppState(
        Wt=Wt, WtW=WtW, WtA=WtA, pivot_rounds=rounds + r_h + r_w
    ), ok
