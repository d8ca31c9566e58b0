"""ANLS block-principal-pivoting NMF solver — port of smallk_tpu/solvers/bpp.py.

Alternates NnlsBlockpivot(W'W, W'A) -> H and NnlsBlockpivot(HH', HA') -> W',
warm-starting each NNLS from the previous factors, and recomputes gradH
with the updated W after both solves.

On a sharded operand (parallel/mesh.py) the H-side NNLS solves the rank's
columns and the W-side its rows, each with its pivot loop's decisions and
infeasibility floor taken over the axis that shards its columns; the Grams
and the rebalance's norms are summed over the axis that shards W or H.

The pivot counts stay on the device, so that a step reads nothing from
the host and can be captured (solvers/graph.py): `pivot_rounds`, the
state's count, which the solve loop's freeze selects with the rest of the
state, and `rounds_run`, the rounds of every step that ran, frozen steps
too, which the step adds in place to a counter of the card's
(`rounds_counter`) and the freeze does not select away.
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
    pivot_rounds: torch.Tensor  # 0-d int64: cumulative NNLS pivot rounds


# per device, a 0-d int64 tensor: the pivot rounds of every step run since
# the last reset_rounds_run (the launch gate's "rounds run")
_rounds_run: dict = {}


def rounds_counter(device) -> torch.Tensor:
    """The card's count of pivot rounds run on `device`, made at a solve's
    init (outside any capture) and only ever added to in place."""
    t = _rounds_run.get(device)
    if t is None:
        t = _rounds_run[device] = torch.zeros((), dtype=torch.int64,
                                              device=device)
    return t


def rounds_run() -> int:
    """Pivot rounds run since the last reset, every device's (a host
    read)."""
    return sum(int(t) for t in _rounds_run.values())


def reset_rounds_run() -> None:
    for t in _rounds_run.values():
        t.zero_()


def init(a_op, W, H) -> BppState:
    rounds_counter(W.device)
    return BppState(Wt=W.T, WtW=a_op.sum_terms(gram(W)), WtA=a_op.mm_tn(W),
                    pivot_rounds=torch.zeros((), dtype=torch.int64,
                                             device=W.device))


def step(a_op, W, H, state: BppState):
    Wt, WtW, WtA, rounds = state
    # the pivot loops' stop tests and floors over the ranks of a sharded
    # operand; None (no reduction) on another
    docs, terms = ((a_op.max_docs, a_op.max_terms) if a_op.sharded
                   else (None, None))

    # H-side: solve (W'W) H = W'A with H >= 0
    H, gradH, ok_h, r_h = nnls_blockpivot(WtW, WtA, H, docs)

    # W-side: solve (HH') W' = H A' with W' >= 0
    HHt = a_op.sum_docs(gram_t(H))
    HAt = a_op.mm_nt(H).T  # (k, m) == H @ A'
    Wt, gradWt, ok_w, r_w = nnls_blockpivot(HHt, HAt, Wt, terms)
    rounds_counter(W.device).add_(r_h + r_w)

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
