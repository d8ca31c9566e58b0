"""Convergence progress estimators — port of smallk_tpu/solvers/progress.py.

  - PG_RATIO:    projected-gradient norm ratio pg_i / pg_0
  - DELTA_FNORM: ||W - W_prev||_F / ||W||_F

Each estimator is (init, update) over an explicit state tensor; the metric
stays on the device until the solve loop reads it.
"""

from __future__ import annotations

import torch

from ..common.options import NmfProgressAlgorithm
from ..ops.dense import UNSHARDED, fro_norm, projected_gradient_norm


def prog_init(method: NmfProgressAlgorithm, W):
    if method == NmfProgressAlgorithm.PG_RATIO:
        # state: pg0 (set on iteration 0)
        return torch.ones((), dtype=W.dtype, device=W.device)
    if method == NmfProgressAlgorithm.DELTA_FNORM:
        # state: W_prev, initially W_init
        return W
    raise ValueError(f"unknown progress method {method}")


def prog_update(method: NmfProgressAlgorithm, it, W, H, gradW, gradH,
                state, have_pg0: bool = False, a_op=UNSHARDED):
    """Returns (metric, new_state); `it` is the 0-based iteration, an int
    or a 0-d tensor on the device (read by no branch of the host, so the
    update runs inside a captured step).

    `have_pg0`: the PG_RATIO denominator was supplied from outside, so
    iteration 0 measures against it instead of priming it.  `a_op`: the
    operand, whose reductions make a sharded solve's metric global.
    """
    if method == NmfProgressAlgorithm.PG_RATIO:
        pg = projected_gradient_norm(gradW, gradH, W, H, a_op)
        is_first = torch.as_tensor(it, device=pg.device) == 0
        if have_pg0:
            is_first = torch.zeros_like(is_first)
        pg0 = torch.where(is_first, pg, state)
        return torch.where(is_first, torch.ones_like(pg), pg / pg0), pg0
    if method == NmfProgressAlgorithm.DELTA_FNORM:
        return (fro_norm(state - W, a_op.sum_terms)
                / fro_norm(W, a_op.sum_terms), W)
    raise ValueError(f"unknown progress method {method}")
