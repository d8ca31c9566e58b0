"""NMF iteration loop — port of smallk_tpu/solvers/solve.py.

The reference compiles the whole loop into one lax.while_loop.  PyTorch
runs eagerly, so here it is a host loop over device tensors with the same
semantics:

  - iteration 0 always primes the progress estimator;
  - checks run from `min_iter`, every `check_interval` iterations;
  - convergence after `tolcount` consecutive checks with metric <= tol,
    or after `stall_patience` checks without a 1% improvement;
  - the first failed step (`ok` false) ends the loop and its factors are
    returned unnormalized;
  - reaching max_iter without failure counts as success.

Host syncs: one per step (the step's `ok` and the metric, read together).
BPP adds one per test of each NNLS pivot loop's condition (rounds + 1 per
NNLS, two NNLS per step); MU, HALS and RANK2 add none.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..common.options import (
    NmfAlgorithm,
    NmfOptions,
    NmfProgressAlgorithm,
)
from ..ops.dense import normalize_and_scale, projected_gradient_norm
from . import bpp, hals, mu, rank2
from .progress import prog_init, prog_update

_SOLVERS = {
    NmfAlgorithm.MU: mu,
    NmfAlgorithm.HALS: hals,
    NmfAlgorithm.RANK2: rank2,
    NmfAlgorithm.BPP: bpp,
}


class SolveResult(NamedTuple):
    W: torch.Tensor
    H: torch.Tensor
    iterations: int    # completed solver steps
    converged: bool    # metric criterion satisfied
    success: bool      # converged OR ran to max_iter without failure
    metric: float      # last progress metric value (numpy scalar)
    pivot_rounds: int = 0  # cumulative NNLS pivot rounds
    # final progress-estimator state: the PG_RATIO pg0 anchor (scalar) or
    # the DELTA_FNORM W_prev; pass it as pg0_hint to continue a solve
    prog_state: torch.Tensor = 0

    def to_numpy(self) -> "SolveResult":
        """The same result with every field a numpy array or scalar."""
        def host(v):
            if isinstance(v, torch.Tensor):
                return v.detach().cpu().numpy()
            return np.asarray(v)

        return SolveResult(*(host(v) for v in self))


def get_solver(algorithm: NmfAlgorithm):
    try:
        return _SOLVERS[algorithm]
    except KeyError:
        raise NotImplementedError(
            f"{algorithm} has no solver in the port (it has "
            f"{', '.join(a.value for a in _SOLVERS)})") from None


def nmf_solve(a_op, W0, H0, opts: NmfOptions, pg0_hint=None) -> SolveResult:
    """Run the NMF iteration loop on W0's device.

    `pg0_hint`: an externally supplied PG_RATIO denominator (see
    `reference_pg1`), used in place of the first iteration's PG.
    """
    solver = get_solver(opts.algorithm)
    method = opts.prog_est_algorithm
    # host copies of the scalar state keep the factor dtype, so every
    # comparison rounds as the reference's on-device one does
    npdt = np.float64 if W0.dtype == torch.float64 else np.float32
    tol = npdt(opts.tol)
    interval = max(1, opts.check_interval)

    sstate = solver.init(a_op, W0, H0)
    pstate = prog_init(method, W0)
    have_pg0 = (pg0_hint is not None
                and method == NmfProgressAlgorithm.PG_RATIO)
    if have_pg0:
        pstate = torch.as_tensor(pg0_hint, dtype=W0.dtype, device=W0.device)

    W, H = W0, H0
    metric, best = npdt(1.0), npdt(np.inf)
    sc = stall = it = 0
    done = failed = False
    while it < opts.max_iter and not done and not failed:
        W, H, gW, gH, sstate, ok = solver.step(a_op, W, H, sstate)

        at_check = (it >= opts.min_iter
                    and (it - opts.min_iter) % interval == 0)
        if it == 0 or at_check:
            metric_t, pstate = prog_update(method, it, W, H, gW, gH, pstate,
                                           have_pg0)
            ok_h, metric_h = torch.stack(
                [ok.to(metric_t.dtype), metric_t]).tolist()
            metric = npdt(metric_h)
        else:
            ok_h = bool(ok)
        failed = not ok_h

        if at_check and not failed:
            sc = sc + 1 if metric <= tol else 0
            done = sc >= opts.tolcount
            if opts.stall_patience is not None:
                if metric < npdt(0.99) * best:
                    best, stall = metric, 0
                else:
                    stall += 1
                done = done or stall >= opts.stall_patience

        if opts.verbose and ((it + 1) < 10 or (it + 1) % 10 == 0):
            # reference cadence: iterations 1-9, then every 10th
            print(f"{it + 1}:\tprogress metric:\t{metric!s}")
        it += 1

    if opts.normalize and not failed:
        W, H, _ = normalize_and_scale(W, H)

    success = not failed and (done or it >= opts.max_iter)
    return SolveResult(
        W=W, H=H, iterations=it, converged=done, success=success,
        metric=metric, pivot_rounds=getattr(sstate, "pivot_rounds", 0),
        prog_state=pstate,
    )


def reference_pg1(a_op, W0, H0, opts: NmfOptions):
    """PG after ONE solver step from (W0, H0): the reference's PG_1."""
    solver = get_solver(opts.algorithm)
    st = solver.init(a_op, W0, H0)
    W, H, gW, gH, st, ok = solver.step(a_op, W0, H0, st)
    return projected_gradient_norm(gW, gH, W, H)
