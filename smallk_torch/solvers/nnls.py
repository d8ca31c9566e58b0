"""Nonnegative least squares by block principal pivoting (Kim-Park).

Port of smallk_tpu/solvers/nnls.py:nnls_blockpivot.  Every column's
masked SPD subproblem,

    M = (p p^T) .* LHS + diag(1 - p),   M x = p .* rhs,

is solved a whole batch of columns at once: by the masked Gauss-Jordan
kernel (kernels/masked_gj.py) up to its rank limit, and above it on the
card by the warm-started, Jacobi-preconditioned masked conjugate gradient
(`_cg_solve_block`, torch ops, as the reference's is XLA code).  The pivot
rules (PBAR = 3, Ninf counters, the backup single-bit toggle) and the
tolerance-based sign tests are the reference's, line for line.  The pivot
loop and the CG loop run as the reference's while_loops run them, with
their tests on the device, in a step captured as a CUDA graph: each a
WHILE node (solvers/graph.py), the CG loop of a pivot round's solve
inside the pivot loop's body; elsewhere they are host loops, one host
sync a round and one every _CG_CHECK_EVERY CG steps.  Where the
right-hand side is large a round solves only the columns that still
pivot (a host loop).

`nnls_hals` is the fixed-W NNLS by HALS row sweeps that hierclust's flat
refinement calls.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..kernels import masked_gj
from ..ops.dense import (
    gemm,
    normalize_and_scale,
    projected_gradient_norm_single,
    zeroize_small,
)
from . import graph
from .hals import update_h

PBAR = 3

# Where RHS has at least this many entries (k * n) a pivot round solves only
# the columns that are not optimal yet; below it the gathers, the scatters
# and the host's wait for the column ids cost more than the narrower round
# saves.  From `chip_smoke.py --k1` (NVIDIA H100 80GB HBM3, 700.00 W; f32,
# k = 8..128, n = 2048..1,000,000): narrowed rounds lose by 2-5 ms a call
# up to 8.0 M entries, tie at 8.4-12.6 M and win from 16 M.
_NARROW_MIN_ENTRIES = 1 << 23


# Masked-solve tier: "auto" sends a CUDA solve above the GJ kernel's rank
# limit to CG and every other solve to the GJ kernel (its plain version on
# CPU tensors); "cg" sends every solve to CG (tests use it to reach the CG
# tier on the CPU, as the reference's `set_masked_solver("cg")` does).
MASKED_SOLVER = "auto"

# CG step cap: k + this.  Exact arithmetic needs <= |passive support| + 1
# steps; the slack absorbs rounding.  Module-level so that a test can
# strangle the cap and reach the cap-out poison (the reference's value).
_CG_EXTRA_STEPS = 16
# CG steps between two looks at the residuals in the host form (each look
# is one host sync): a solve that converges in s steps syncs
# ceil(s / _CG_CHECK_EVERY) + 1 times.  Columns freeze on the device, so
# the steps run past convergence change nothing.  The device form tests
# after every step, as the reference does.
_CG_CHECK_EVERY = 8

# CG solves and CG steps run since the last reset; the only place they
# grow is `_cg_solve_block` (in a captured step, counted on the card and
# settled at the loop's host read: solvers/graph.py)
cg_solves = 0
cg_steps = 0


def set_masked_solver(name: str) -> None:
    global MASKED_SOLVER
    if name not in ("auto", "cg"):
        raise ValueError("masked solver must be 'auto' or 'cg'")
    MASKED_SOLVER = name


def _routes_to_cg(LHS, k: int) -> bool:
    return MASKED_SOLVER == "cg" or (LHS.is_cuda and k > masked_gj.MAX_K)


def _masked_solve(LHS, RHS, passive, x0=None):
    """All columns' masked solves: the CG tier where `_routes_to_cg`, else
    the K1 kernel (its plain version for CPU tensors).  `x0`, a warm start,
    is read by the CG tier only."""
    if _routes_to_cg(LHS, RHS.shape[0]):
        return _cg_solve_block(LHS, RHS, passive, x0)
    return masked_gj.masked_gj_solve(LHS, RHS, passive)


class _Cg(NamedTuple):
    """The CG loop's carry: the reference's while_loop carry."""
    x: torch.Tensor    # (k, n)
    r: torch.Tensor    # (k, n): the residual b - M x
    pd: torch.Tensor   # (k, n): the search direction
    rz: torch.Tensor   # (n,): r' D^-1 r
    rr: torch.Tensor   # (n,): r' r
    it: torch.Tensor   # 0-d int64: steps run


def _cg_solve_block(LHS, RHS, passive, x0=None):
    """Masked SPD solve by Jacobi-preconditioned conjugate gradient — port
    of smallk_tpu/solvers/nnls.py:_cg_solve_block.

    The system is the GJ tier's, M x = b with M = (p p^T) .* LHS +
    diag(1 - p) and b = p .* rhs, for all n columns at once; a step is one
    (k, k) x (k, n) GEMM against the shared LHS.  Dead topics (a Gram
    diagonal <= k eps (max|LHS| + 1)) are forced non-passive.  It iterates
    in f32 at least and returns LHS's dtype.  Every carried vector is zero
    off the passive support, so the identity block never enters a product.

    Columns freeze on the device at a relative residual of 64 eps; the
    loop stops when none is live or after k + _CG_EXTRA_STEPS steps.  A
    step is a function of the carry (`_Cg`), the reference's `body`, and
    the test `live` the reference's `cond`.  In a captured step the loop
    is a WHILE node that tests after every step, as the reference's
    while_loop does, so it runs the reference's steps; elsewhere it is a
    host loop that looks at the residuals every _CG_CHECK_EVERY steps (its
    only host syncs).  Warm start: `x0` on the passive support; a column
    holding a non-finite value starts cold.  A column that capped out far
    above the backward-stable floor eps (|LHS| |x| + |b|) comes back NaN,
    so the caller's finiteness gate fails the attempt instead of feeding
    an approximate x to the pivot sign tests.
    """
    global cg_solves
    k, n = RHS.shape
    dtype = torch.promote_types(torch.promote_types(LHS.dtype, RHS.dtype),
                                torch.float32)
    out_dtype = LHS.dtype
    LHS = LHS.to(dtype)
    eps = torch.finfo(dtype).eps
    diag = torch.diagonal(LHS)
    tiny = k * eps * (torch.max(torch.abs(LHS)) + 1.0)
    alive = diag > tiny
    pf = passive & alive[:, None]
    dinv = torch.where(alive, 1.0 / torch.where(alive, diag, 1.0),
                       1.0)[:, None]
    b = torch.where(pf, RHS, 0).to(dtype)

    def matvec(v):
        return torch.where(pf, gemm(LHS, v), 0)

    bb = torch.sum(b * b, dim=0)
    tol2 = (64.0 * eps) ** 2 * bb
    max_steps = k + _CG_EXTRA_STEPS

    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = torch.where(pf, x0.to(dtype), 0)
        x = torch.where(torch.isfinite(x), x, 0)
        r = torch.where(pf, b - gemm(LHS, x), 0)
    pd = r * dinv
    rz = torch.sum(r * pd, dim=0)
    rr = torch.sum(r * r, dim=0)

    def live(c: _Cg):
        return torch.any(c.rr > tol2) & (c.it < max_steps)

    def step(c: _Cg) -> _Cg:
        global cg_steps
        cg_steps += 1
        on = (c.rr > tol2)[None, :]
        Mp = matvec(c.pd)
        pMp = torch.sum(c.pd * Mp, dim=0)
        alpha = torch.where(pMp > 0, c.rz / torch.where(pMp > 0, pMp, 1.0),
                            0.0)
        x = torch.where(on, c.x + alpha[None, :] * c.pd, c.x)
        r = torch.where(on, c.r - alpha[None, :] * Mp, c.r)
        rz_new = torch.sum(r * r * dinv, dim=0)
        beta = torch.where(c.rz > 0,
                           rz_new / torch.where(c.rz > 0, c.rz, 1.0), 0.0)
        pd = torch.where(on, r * dinv + beta[None, :] * c.pd, c.pd)
        rz = torch.where(on[0], rz_new, c.rz)
        rr = torch.where(on[0], torch.sum(r * r, dim=0), c.rr)
        return _Cg(x, r, pd, rz, rr, c.it + 1)

    c = _Cg(x, r, pd, rz, rr,
            torch.zeros((), dtype=torch.int64, device=RHS.device))
    loop = _device_loop(None, max_steps)
    if loop is not None:
        c = loop(live, step, c)
    else:
        it = 0
        while it < max_steps and bool(torch.any(c.rr > tol2)):
            for _ in range(min(_CG_CHECK_EVERY, max_steps - it)):
                c = step(c)
                it += 1
    cg_solves += 1
    x, rr = c.x, c.rr

    floor = eps * (
        torch.sqrt(torch.sum(gemm(torch.abs(LHS), torch.abs(x)) ** 2, dim=0))
        + torch.sqrt(bb))
    capped = (rr > tol2) & (torch.sqrt(rr) > 256.0 * k * floor)
    x = torch.where(capped[None, :], torch.nan, x)
    return torch.where(pf, x, 0).to(out_dtype)


def _pivot_cols(P, Ninf, nonopt, infeas, not_good, sel):
    """One pivot-rule update (UpdatePassiveSet) on the columns in `sel`."""
    cols1 = sel & (not_good < Ninf)
    cols2 = sel & (not_good >= Ninf) & (P >= 1)
    cols3 = sel & ~cols1 & ~cols2

    P = torch.where(cols1, PBAR, torch.where(cols2, P - 1, P))
    Ninf = torch.where(cols1, not_good, Ninf)
    return P, Ninf, cols1, cols2, cols3


def _update_passive(passive, nonopt, infeas, cols1, cols2, cols3):
    w = passive.shape[0]
    rids = torch.arange(w, dtype=torch.int32, device=passive.device)[:, None]
    # full exchange for cols1|cols2: set nonopt bits, clear infeasible ones
    cc = (cols1 | cols2)[None, :]
    passive = (passive | (nonopt & cc)) & ~(infeas & cc)
    # backup rule for cols3: toggle the highest-index offending bit
    r1 = torch.amax(torch.where(nonopt, rids, -1), dim=0)
    r2 = torch.amax(torch.where(infeas, rids, -1), dim=0)
    toggle = (rids == torch.maximum(r1, r2)[None, :]) & cols3[None, :]
    return passive ^ toggle


def _count(nonopt, infeas):
    return (torch.sum(nonopt, dim=0, dtype=torch.int32)
            + torch.sum(infeas, dim=0, dtype=torch.int32))


class _Pivot(NamedTuple):
    """The pivot loop's carry: the reference's while_loop carry."""
    X: torch.Tensor         # (k, n)
    Y: torch.Tensor         # (k, n): LHS X - RHS
    passive: torch.Tensor   # (k, n) bool
    P: torch.Tensor         # (n,) int32: backup-rule budget
    Ninf: torch.Tensor      # (n,) int32: fewest offenders seen
    nonopt: torch.Tensor    # (k, n) bool
    infeas: torch.Tensor    # (k, n) bool
    not_good: torch.Tensor  # (n,) int32: offenders a column
    it: torch.Tensor        # 0-d int64: rounds run


def _round_cap(k: int) -> int:
    """The reference's cap on full-width pivot rounds (nnls.hpp: 5 k)."""
    return 5 * k


def _select_loop(cap, live, step, c):
    """The device form of a loop on any device: each of `cap` trips runs
    and is kept only where its test holds, the while_loop's semantics
    without control flow (every trip runs, and counts).  Only the tests
    use it (SELECT_ROUNDS)."""
    for _ in range(cap):
        keep = live(c)
        c = c._make(torch.where(keep, new, old)
                    for new, old in zip(step(c), c, strict=True))
    return c


# Tests set this to run the device form of the loops on the CPU
SELECT_ROUNDS = False


def _device_loop(across, cap: int):
    """The device form of a loop of at most `cap` trips, a callable
    while_loop(live, step, c) that reads nothing from the host: in a
    captured step a WHILE node (graph.while_loop), with SELECT_ROUNDS the
    select; None (the host loop) elsewhere and on a sharded problem."""
    if across is not None:
        return None
    if graph.capturing():
        return graph.while_loop
    return functools.partial(_select_loop, cap) if SELECT_ROUNDS else None


def nnls_blockpivot(LHS, RHS, Xinit, across=None):
    """Solve LHS @ X = RHS s.t. X >= 0 columnwise, LHS (k, k) SPD.

    Returns (X, Y, ok, rounds): Y = LHS X - RHS is the gradient, `ok` a
    bool tensor (converged and finite), `rounds` the number of pivot
    rounds (masked solves after the first), a 0-d int64 tensor.

    A round is a function of the carry (`_Pivot`), the reference's `body`,
    and its test `live` = any(not_good > 0) & (it < 5 k) a 0-d tensor, the
    reference's `cond`.  Two forms run it.  The device form reads nothing
    from the host: in a step that solvers/graph.py captures, the loop is
    one WHILE node on that test with the round as its body, as the
    reference's while_loop.  The host loop, everywhere else, reads each
    round's test: one host sync a round.

    `across`: where RHS holds one rank's columns of a sharded problem
    (parallel/mesh.py; BPP's H side over docs, its W side over terms), the
    max over the ranks that hold the others.  The rounds' stop test and
    the two quantities taken over all columns, the infeasibility floor and
    the dust threshold, go through it, so every rank runs the same rounds
    and each column's pivots are the unsharded problem's; each rank solves
    only its columns.  Always the host loop.

    Where RHS is large (k * n >= _NARROW_MIN_ENTRIES) a round gathers the
    columns that are not optimal yet, applies the pivot rules, the masked
    solve and the two small GEMMs at that exact width, and scatters the
    results back: the port of what the reference's slab ladder is for,
    without its slabs, padding and nested loops, which exist for XLA's
    static shapes.  Its column ids are a host read, so these rounds run in
    a host loop.  Each column's pivot sequence is independent of every
    other column's, and the one global quantity, the infeasibility floor
    dx from max|X|, is taken over all columns, so X, ok and `rounds` are
    what full-width rounds give (and Y up to the summation order of a GEMM
    at another width, well inside the sign tests' allowance dy); only the
    work per round shrinks.  A round here is a round over all live
    columns, so the cap is the reference's 5 k for full-width rounds; the
    reference counts its slab rounds against 8x that, so there `rounds`
    can differ.
    """
    k, n = RHS.shape
    RHS = RHS.contiguous()
    narrow_rounds = k * n >= _NARROW_MIN_ENTRIES
    max_iter = _round_cap(k)
    eps = torch.finfo(RHS.dtype).eps
    glob = across or (lambda x: x)

    # Per-entry sign-test tolerances (the reference's `deltas`): values are
    # never altered, the tests treat anything above -delta as nonnegative.
    # For f64 they collapse to ~1e-12, the reference's zeroize level.
    abs_lhs = torch.abs(LHS)
    abs_rhs = torch.abs(RHS)

    def delta_x(X):  # over all columns, also in a narrowed round
        return 512.0 * eps * torch.clamp(glob(torch.max(torch.abs(X))),
                                         min=1.0)

    def delta_y(X, abs_rhs):
        return 16.0 * eps * (gemm(abs_lhs, torch.abs(X)) + abs_rhs)  # (k, n)

    passive = (Xinit > 0).contiguous()
    # the CG tier starts each solve from the last X (the reference's x0)
    cg = _routes_to_cg(LHS, k)
    X = _masked_solve(LHS, RHS, passive, x0=Xinit if cg else None)
    Y = gemm(LHS, X) - RHS

    P = torch.full((n,), PBAR, dtype=torch.int32, device=RHS.device)
    Ninf = torch.full((n,), k + 1, dtype=torch.int32, device=RHS.device)

    nonopt = (Y < -delta_y(X, abs_rhs)) & ~passive
    infeas = (X < -delta_x(X)) & passive
    not_good = _count(nonopt, infeas)

    if narrow_rounds:
        it = 0
        while it < max_iter:
            # solve the non-optimal columns only, at their exact width;
            # their ids are the round's one host sync
            ids = torch.nonzero(not_good > 0)[:, 0]
            live = ids.numel() > 0
            if not (live if across is None else bool(across(torch.tensor(
                    live, device=RHS.device)))):
                break
            it += 1
            if not live:
                # this rank's columns are optimal: it takes the round's
                # floor with the others and solves nothing
                delta_x(X)
                continue
            RHS_s = RHS.index_select(1, ids)
            nonopt_s = nonopt.index_select(1, ids)
            infeas_s = infeas.index_select(1, ids)
            P_s, Ninf_s, cols1, cols2, cols3 = _pivot_cols(
                P[ids], Ninf[ids], nonopt_s, infeas_s, not_good[ids],
                torch.ones_like(ids, dtype=torch.bool))
            passive_s = _update_passive(passive.index_select(1, ids),
                                        nonopt_s, infeas_s,
                                        cols1, cols2, cols3).contiguous()
            Xs = _masked_solve(LHS, RHS_s, passive_s,
                               x0=X.index_select(1, ids) if cg else None)
            Ys = gemm(LHS, Xs) - RHS_s
            X[:, ids] = Xs
            Y[:, ids] = Ys
            passive[:, ids] = passive_s
            P[ids] = P_s
            Ninf[ids] = Ninf_s

            nonopt_s = (Ys < -delta_y(Xs, torch.abs(RHS_s))) & ~passive_s
            infeas_s = (Xs < -delta_x(X)) & passive_s
            nonopt[:, ids] = nonopt_s
            infeas[:, ids] = infeas_s
            not_good[ids] = _count(nonopt_s, infeas_s)
        rounds = torch.full((), it, dtype=torch.int64, device=RHS.device)
    else:
        def step(c: _Pivot) -> _Pivot:
            notopt_col = c.not_good > 0
            P, Ninf, cols1, cols2, cols3 = _pivot_cols(
                c.P, c.Ninf, c.nonopt, c.infeas, c.not_good, notopt_col)
            passive = _update_passive(c.passive, c.nonopt, c.infeas,
                                      cols1, cols2, cols3)
            # solve every column with the updated passive sets; keep the
            # non-optimal ones
            Xs = _masked_solve(LHS, RHS, passive, x0=c.X if cg else None)
            Ys = gemm(LHS, Xs) - RHS
            mask = notopt_col[None, :]
            X = torch.where(mask, Xs, c.X)
            Y = torch.where(mask, Ys, c.Y)
            nonopt = mask & (Y < -delta_y(X, abs_rhs)) & ~passive
            infeas = mask & (X < -delta_x(X)) & passive
            return _Pivot(X, Y, passive, P, Ninf, nonopt, infeas,
                          _count(nonopt, infeas), c.it + 1)

        def live(c: _Pivot):
            return glob(torch.any(c.not_good > 0)) & (c.it < max_iter)

        c = _Pivot(X, Y, passive, P, Ninf, nonopt, infeas, not_good,
                   torch.zeros((), dtype=torch.int64, device=RHS.device))
        loop = _device_loop(across, max_iter)
        if loop is None:
            while bool(live(c)):  # the round's host sync
                c = step(c)
        else:
            c = loop(live, step, c)
        X, Y, not_good, rounds = c.X, c.Y, c.not_good, c.it

    converged = ~torch.any(not_good > 0)
    # isfinite, not just not-NaN: an f32 overflow yields +/-Inf
    finite = torch.all(torch.isfinite(X)) & torch.all(torch.isfinite(Y))
    # project tolerated negatives onto the constraint set, then zeroize dust
    # relative to the solution's magnitude
    X = torch.clamp(X, min=0.0)
    X = zeroize_small(X, 8.0 * eps * torch.clamp(glob(torch.max(X)),
                                                 min=1.0))
    return X, Y, converged & finite, rounds


def nnls_hals(a_op, W, H, tol, max_iter):
    """Fixed-W NNLS by HALS row sweeps, for flat-clustering refinement —
    port of smallk_tpu/solvers/nnls.py:nnls_hals (reference NnlsHals).

    Sweeps H until the projected-gradient norm drops below tol * pg0
    (pg0: the first sweep's), at most `max_iter` sweeps, one host sync per
    sweep.  Returns (W, H, success); on success W and H come back
    normalized, as the reference's do.  On a sharded operand W and H are
    the rank's blocks and the Gram, the norm and the scale are global.
    """
    WtW = a_op.sum_terms(gemm(W.T, W))
    WtA = a_op.mm_tn(W)
    pg0 = None
    done = False
    it = 0
    while not done and it < max_iter:
        H = update_h(H, WtW, WtA)
        gradH = gemm(WtW, H) - WtA
        pg = projected_gradient_norm_single(gradH, H, a_op.sum_docs)
        if it == 0:
            pg0 = pg
        else:
            done = bool(pg < tol * pg0)
        it += 1
    if done:
        W, H, _ = normalize_and_scale(W, H, a_op)
    return W, H, done
