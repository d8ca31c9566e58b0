"""NMF iteration loop — port of smallk_tpu/solvers/solve.py.

The reference compiles the whole loop into one lax.while_loop whose body
runs `loop_unroll` steps.  Here the loop's state lives in device tensors
(W, H, the solver and progress state, and the scalars it, sc, metric,
done, failed, best, stall; a step's gradients feed its progress update
and nothing later), and one step is the reference's `one_step` with the
same semantics:

  - iteration 0 always primes the progress estimator;
  - checks run from `min_iter`, every `check_interval` iterations (the
    predicate is evaluated on the device and both branches of the update
    are computed, then one is selected);
  - convergence after `tolcount` consecutive checks with metric <= tol,
    or after `stall_patience` checks without a 1% improvement;
  - the first failed step (`ok` false) ends the solve and its factors are
    returned unnormalized;
  - reaching max_iter without failure counts as success;
  - a step taken once the solve is done, failed or at max_iter is frozen:
    every piece of state keeps its value and `it` does not advance.

The host reads (done, failed, it, metric) after iteration 0 and then once
every U = max(1, opts.loop_unroll) steps (0 picks U by `auto_unroll`); the
steps in between run without a host read.  A block is cut short only at
max_iter, so the steps past convergence or failure (at most U - 1 a solve)
are the freeze's waste.  The reference checks `it < max_iter` only between
trips, so with U > 1 its loop runs past max_iter (10 iterations asked, 12
run at U = 3 or 4); here the freeze also covers `it >= max_iter`, and a
solve never runs past it.

On the card, at U > 1, a MU, HALS or RANK2 step after iteration 0 is
captured once as a CUDA graph and replayed between the host reads
(solvers/graph.py); at U = 1, and for BPP, whose pivot loop reads the host
inside a step, the same loop runs eagerly.
`verbose` prints the reference's lines at its cadence (iterations 1-9,
then every 10th) after each read, from a device buffer of the block's
metrics.
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
from . import bpp, graph, hals, mu, rank2
from .progress import prog_init, prog_update

_SOLVERS = {
    NmfAlgorithm.MU: mu,
    NmfAlgorithm.HALS: hals,
    NmfAlgorithm.RANK2: rank2,
    NmfAlgorithm.BPP: bpp,
}

# U for opts.loop_unroll = 0 on the card, by solver, from the U sweeps of
# chip_smoke.py --loop on an H100 80GB HBM3 at 700 W (PERF.md §7).  A
# hierclust node's RANK2 solve runs tens to hundreds of steps, so the
# frozen tail of its last block counts: U = 4 was fastest at the Reuters
# shape (0.91-0.96 s; 0.95-1.05 at 8, 1.08-1.24 at 32) and at 50k x 1M
# (2.93 s; 2.96 at 8, 3.51 at 32).  flatclust's HALS solve runs ~3100
# steps of ~140 us, where the reads cost more than the tail: U = 32
# (0.42-0.45 s; 0.46-0.48 at 8).  MU on the 12411 x 7984 main path's
# operand at k = 8, to a tol at iteration 91: U = 8 (0.030 s; 0.031 at 4,
# 0.135 eager at U = 1).  BPP and the CPU take 1 (auto_unroll).
AUTO_UNROLL = {NmfAlgorithm.RANK2: 4, NmfAlgorithm.HALS: 32,
               NmfAlgorithm.MU: 8}
# A MU solve whose W and H hold this many entries or more is device-bound:
# a frozen step costs a whole step and a graph's copy-back more than the
# host's launches, so it runs at U = 1, eagerly.  The same sweep at the
# 50,000 x 1,000,000 operand: eager U = 1 fastest at k = 16 (16.8M
# entries; 0.303 s, 0.311 at U = 2) and at k = 128 (134M; 1.91 s, 1.95 at
# U = 2), where the k = 8 operand above (163k entries) ran 4.5x faster
# captured.
MU_ONE_STEP_ENTRIES = 1 << 22

# the loop's counts since the last reset; they grow only in nmf_solve
steps_run = 0     # solver steps run, frozen ones included
host_reads = 0    # reads of (done, failed, it, metric) by the host
frozen_steps = 0  # steps run after the solve was done, failed or at max_iter
solves = 0        # nmf_solve calls


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


class Carry(NamedTuple):
    """The loop's state, every field a tensor on the factors' device."""
    W: torch.Tensor
    H: torch.Tensor
    sstate: tuple       # the solver's state (a NamedTuple of tensors)
    pstate: torch.Tensor
    it: torch.Tensor    # int64: completed steps
    sc: torch.Tensor    # int64: consecutive checks under tol
    metric: torch.Tensor
    done: torch.Tensor
    failed: torch.Tensor
    best: torch.Tensor
    stall: torch.Tensor  # int64: checks without a 1% improvement


def get_solver(algorithm: NmfAlgorithm):
    try:
        return _SOLVERS[algorithm]
    except KeyError:
        raise NotImplementedError(
            f"{algorithm} has no solver in the port (it has "
            f"{', '.join(a.value for a in _SOLVERS)})") from None


def auto_unroll(opts: NmfOptions, W, H) -> int:
    """U for opts.loop_unroll = 0: the solver's AUTO_UNROLL on the card,
    and 1 for a MU solve whose factors W and H hold MU_ONE_STEP_ENTRIES
    entries or more; 1 for BPP (its pivot rounds read the host anyway)
    and on the CPU (a host read costs nothing there)."""
    if not W.is_cuda:
        return 1
    if opts.algorithm == NmfAlgorithm.MU \
            and W.numel() + H.numel() >= MU_ONE_STEP_ENTRIES:
        return 1
    return AUTO_UNROLL.get(opts.algorithm, 1)


def select(frozen, old, new, out=None):
    """torch.where(frozen, old, new) over a (nested) NamedTuple of tensors,
    written into `out`'s tensors when it is given (which may be `old`'s).
    `frozen` None (U = 1: no step can be frozen, and none is captured)
    selects `new` itself.  A new tensor keeps `new`'s layout (BPP's
    factors are transposed views), so the next step's products take the
    paths, and give the bits, they take with no select."""
    if frozen is None:
        return new
    if isinstance(new, tuple):
        outs = out if out is not None else (None,) * len(new)
        return new._make(select(frozen, o, n, d)
                         for o, n, d in zip(old, new, outs, strict=True))
    if out is None:
        if not isinstance(new, torch.Tensor):
            return torch.where(frozen, old, new)
        out = torch.empty_like(new)
    return torch.where(frozen, old, new, out=out)


class _Loop:
    """One frozen step of the solve (`step`) and the host's read."""

    def __init__(self, solver, a_op, opts: NmfOptions, have_pg0: bool,
                 unroll: int, device):
        self.solver, self.a_op, self.opts = solver, a_op, opts
        self.method = opts.prog_est_algorithm
        self.have_pg0 = have_pg0
        self.interval = max(1, opts.check_interval)
        self.unroll = unroll
        # the metric of the step at iteration i in slot i % U (verbose)
        self.metrics = (torch.zeros(unroll, dtype=torch.float64,
                                    device=device)
                        if opts.verbose else None)

    def step(self, c: Carry, out: Carry | None = None) -> Carry:
        """The reference's one_step; with `out` (the graph's static carry,
        which `c` may be) the new state is written there."""
        o = self.opts
        # at U = 1 the host reads after every step and runs the next only
        # while the solve goes on: no step is frozen, and none is selected
        frozen = (c.done | c.failed | (c.it >= o.max_iter)
                  if self.unroll > 1 else None)
        W, H, gW, gH, sstate, ok = self.solver.step(self.a_op, c.W, c.H,
                                                    c.sstate)
        failed = c.failed | ~ok

        at_check = (c.it >= o.min_iter) & (
            (c.it - o.min_iter) % self.interval == 0)
        do_update = (c.it == 0) | at_check
        metric, pstate = prog_update(self.method, c.it, W, H, gW, gH,
                                     c.pstate, self.have_pg0)
        metric = torch.where(do_update, metric, c.metric)
        pstate = torch.where(do_update, pstate, c.pstate)

        check = at_check & ~failed
        hit = check & (metric <= o.tol)
        sc = torch.where(check, torch.where(hit, c.sc + 1, 0), c.sc)
        done = c.done | (check & (sc >= o.tolcount))
        best, stall = c.best, c.stall
        if o.stall_patience is not None:
            improved = metric < 0.99 * c.best
            best = torch.where(check & improved, metric, c.best)
            stall = torch.where(check, torch.where(improved, 0, c.stall + 1),
                                c.stall)
            done = done | (check & (stall >= o.stall_patience))

        if self.metrics is not None:
            self.metrics.index_copy_(0, (c.it % self.unroll).reshape(1),
                                     metric.reshape(1).double())
        new = Carry(W, H, sstate, pstate, c.it + 1, sc, metric, done,
                    failed, best, stall)
        return select(frozen, c, new, out)

    def read(self, c: Carry, it_before: int, npdt):
        """One host read: (done, failed, it, metric), and the verbose lines
        of the steps since `it_before`."""
        global host_reads
        parts = [t.reshape(1).double()
                 for t in (c.done, c.failed, c.it, c.metric)]
        if self.metrics is not None:
            parts.append(self.metrics)
        vals = torch.cat(parts).tolist()
        host_reads += 1
        done, failed, it, metric = bool(vals[0]), bool(vals[1]), \
            int(vals[2]), npdt(vals[3])
        if self.metrics is not None:
            for i in range(it_before, it):
                # reference cadence: iterations 1-9, then every 10th
                if (i + 1) < 10 or (i + 1) % 10 == 0:
                    print(f"{i + 1}:\tprogress metric:\t"
                          f"{npdt(vals[4 + i % self.unroll])!s}")
        return done, failed, it, metric


class _Eager:
    """Steps run one after another from the host, as they are on the CPU."""

    def __init__(self, step, carry):
        self.step = step
        self.carry = carry

    def run(self, n: int) -> int:
        for _ in range(n):
            self.carry = self.step(self.carry)
        return n

    def close(self) -> None:
        self.carry = None


def _tensors(state, device):
    """The solver state with every plain number made a 0-d tensor (BPP's
    pivot count), so that the freeze can select it."""
    return state._make(torch.as_tensor(v, device=device)
                       if isinstance(v, (int, float)) else v for v in state)


def initial_carry(solver, a_op, W0, H0, pstate) -> Carry:
    """The loop's state before iteration 0."""
    dev, dt = W0.device, W0.dtype

    def scalar(v, dtype=torch.int64):
        return torch.full((), v, dtype=dtype, device=dev)

    return Carry(W0, H0, _tensors(solver.init(a_op, W0, H0), dev), pstate,
                 scalar(0), scalar(0), scalar(1.0, dt),
                 scalar(False, torch.bool), scalar(False, torch.bool),
                 scalar(np.inf, dt), scalar(0))


def nmf_solve(a_op, W0, H0, opts: NmfOptions, pg0_hint=None) -> SolveResult:
    """Run the NMF iteration loop on W0's device.

    `pg0_hint`: an externally supplied PG_RATIO denominator (see
    `reference_pg1`), used in place of the first iteration's PG.
    """
    global steps_run, frozen_steps, solves
    solver = get_solver(opts.algorithm)
    method = opts.prog_est_algorithm
    dev, dt = W0.device, W0.dtype
    # host copies of the scalar state keep the factor dtype, as the
    # reference's on-device values do
    npdt = np.float64 if dt == torch.float64 else np.float32
    unroll = opts.loop_unroll if opts.loop_unroll > 0 \
        else auto_unroll(opts, W0, H0)

    pstate = prog_init(method, W0)
    have_pg0 = (pg0_hint is not None
                and method == NmfProgressAlgorithm.PG_RATIO)
    if have_pg0:
        pstate = torch.as_tensor(pg0_hint, dtype=dt, device=dev)

    c = initial_carry(solver, a_op, W0, H0, pstate)
    loop = _Loop(solver, a_op, opts, have_pg0, unroll, dev)

    metric, it, steps = npdt(1.0), 0, 0
    done = failed = False
    runner = None
    try:
        if opts.max_iter > 0:
            # iteration 0 runs eagerly, on the card too: it primes the
            # estimator and warms everything a capture must not do
            # (library loads, cuBLAS handles, K2's shared-memory opt-in)
            c = loop.step(c)
            steps = 1
            if opts.max_iter > 1:
                # captured while the device still runs iteration 0, on
                # its fresh state (every field a new tensor of the
                # freeze's select), which becomes the graph's buffers
                runner = (graph.StepGraph(loop.step, c)
                          if graph.applies(opts.algorithm, W0, unroll)
                          else _Eager(loop.step, c))
            done, failed, it, metric = loop.read(c, 0, npdt)
        while not (done or failed) and it < opts.max_iter:
            steps += runner.run(min(unroll, opts.max_iter - it))
            c = runner.carry
            done, failed, it, metric = loop.read(c, it, npdt)
    finally:
        if runner is not None:
            runner.close()
        steps_run += steps
        frozen_steps += steps - it
        solves += 1

    W, H = c.W, c.H
    if opts.normalize and not failed:
        W, H, _ = normalize_and_scale(W, H)

    rounds = getattr(c.sstate, "pivot_rounds", None)
    success = not failed and (done or it >= opts.max_iter)
    return SolveResult(
        W=W, H=H, iterations=it, converged=done, success=success,
        metric=metric, pivot_rounds=0 if rounds is None else int(rounds),
        prog_state=c.pstate,
    )


def reference_pg1(a_op, W0, H0, opts: NmfOptions):
    """PG after ONE solver step from (W0, H0): the reference's PG_1."""
    solver = get_solver(opts.algorithm)
    st = solver.init(a_op, W0, H0)
    W, H, gW, gH, st, ok = solver.step(a_op, W0, H0, st)
    return projected_gradient_norm(gW, gH, W, H)
