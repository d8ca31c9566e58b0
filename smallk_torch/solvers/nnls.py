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
loop is a host loop: one host sync per round.  Where the right-hand side
is large a round solves only the columns that still pivot.

`nnls_hals` is the fixed-W NNLS by HALS row sweeps that hierclust's flat
refinement calls.
"""

from __future__ import annotations

import torch

from ..kernels import masked_gj
from ..ops.dense import (
    gemm,
    normalize_and_scale,
    projected_gradient_norm_single,
    zeroize_small,
)
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
# CG steps between two looks at the residuals (each look is one host sync):
# a solve that converges in s steps syncs ceil(s / _CG_CHECK_EVERY) + 1
# times.  Columns freeze on the device, so the steps run past convergence
# change nothing.
_CG_CHECK_EVERY = 8

# CG solves and CG steps since the last reset; the only place they grow is
# `_cg_solve_block`
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
    loop stops when none is live or after k + _CG_EXTRA_STEPS steps, and
    looks at the residuals every _CG_CHECK_EVERY steps (its only host
    syncs).  Warm start: `x0` on the passive support; a column holding a
    non-finite value starts cold.  A column that capped out far above the
    backward-stable floor eps (|LHS| |x| + |b|) comes back NaN, so the
    caller's finiteness gate fails the attempt instead of feeding an
    approximate x to the pivot sign tests.
    """
    global cg_solves, cg_steps
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

    it = 0
    while it < max_steps and bool(torch.any(rr > tol2)):
        for _ in range(min(_CG_CHECK_EVERY, max_steps - it)):
            live = (rr > tol2)[None, :]
            Mp = matvec(pd)
            pMp = torch.sum(pd * Mp, dim=0)
            alpha = torch.where(pMp > 0,
                                rz / torch.where(pMp > 0, pMp, 1.0), 0.0)
            x = torch.where(live, x + alpha[None, :] * pd, x)
            r = torch.where(live, r - alpha[None, :] * Mp, r)
            rz_new = torch.sum(r * r * dinv, dim=0)
            beta = torch.where(rz > 0, rz_new / torch.where(rz > 0, rz, 1.0),
                               0.0)
            pd = torch.where(live, r * dinv + beta[None, :] * pd, pd)
            rz = torch.where(live[0], rz_new, rz)
            rr = torch.where(live[0], torch.sum(r * r, dim=0), rr)
            it += 1
    cg_solves += 1
    cg_steps += it

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


def nnls_blockpivot(LHS, RHS, Xinit):
    """Solve LHS @ X = RHS s.t. X >= 0 columnwise, LHS (k, k) SPD.

    Returns (X, Y, ok, rounds): Y = LHS X - RHS is the gradient, `ok` a
    bool tensor (converged and finite), `rounds` the number of pivot
    rounds (masked solves after the first) as a Python int.

    Where RHS is large (k * n >= _NARROW_MIN_ENTRIES) a round gathers the
    columns that are not optimal yet, applies the pivot rules, the masked
    solve and the two small GEMMs at that exact width, and scatters the
    results back: the port of what the reference's slab ladder is for,
    without its slabs, padding and nested loops, which exist for XLA's
    static shapes.  Each column's pivot sequence is independent of every
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
    max_iter = 5 * k
    eps = torch.finfo(RHS.dtype).eps

    # Per-entry sign-test tolerances (the reference's `deltas`): values are
    # never altered, the tests treat anything above -delta as nonnegative.
    # For f64 they collapse to ~1e-12, the reference's zeroize level.
    abs_lhs = torch.abs(LHS)
    abs_rhs = torch.abs(RHS)

    def delta_x(X):  # over all columns, also in a narrowed round
        return 512.0 * eps * torch.clamp(torch.max(torch.abs(X)), min=1.0)

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

    it = 0
    while it < max_iter:
        notopt_col = not_good > 0
        if narrow_rounds:
            # solve the non-optimal columns only, at their exact width;
            # their ids are the round's one host sync
            ids = torch.nonzero(notopt_col)[:, 0]
            if ids.numel() == 0:
                break
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
        else:
            if not bool(torch.any(notopt_col)):  # the round's host sync
                break
            P, Ninf, cols1, cols2, cols3 = _pivot_cols(
                P, Ninf, nonopt, infeas, not_good, notopt_col)
            passive = _update_passive(passive, nonopt, infeas,
                                      cols1, cols2, cols3)

            # solve every column with the updated passive sets; keep the
            # non-optimal ones
            Xs = _masked_solve(LHS, RHS, passive, x0=X if cg else None)
            Ys = gemm(LHS, Xs) - RHS
            mask = notopt_col[None, :]
            X = torch.where(mask, Xs, X)
            Y = torch.where(mask, Ys, Y)

            nonopt = mask & (Y < -delta_y(X, abs_rhs)) & ~passive
            infeas = mask & (X < -delta_x(X)) & passive
            not_good = _count(nonopt, infeas)
        it += 1

    converged = ~torch.any(not_good > 0)
    # isfinite, not just not-NaN: an f32 overflow yields +/-Inf
    finite = torch.all(torch.isfinite(X)) & torch.all(torch.isfinite(Y))
    # project tolerated negatives onto the constraint set, then zeroize dust
    # relative to the solution's magnitude
    X = torch.clamp(X, min=0.0)
    X = zeroize_small(X, 8.0 * eps * torch.clamp(torch.max(X), min=1.0))
    return X, Y, converged & finite, it


def nnls_hals(a_op, W, H, tol, max_iter):
    """Fixed-W NNLS by HALS row sweeps, for flat-clustering refinement —
    port of smallk_tpu/solvers/nnls.py:nnls_hals (reference NnlsHals).

    Sweeps H until the projected-gradient norm drops below tol * pg0
    (pg0: the first sweep's), at most `max_iter` sweeps, one host sync per
    sweep.  Returns (W, H, success); on success W and H come back
    normalized, as the reference's do.
    """
    WtW = gemm(W.T, W)
    WtA = a_op.mm_tn(W)
    pg0 = None
    done = False
    it = 0
    while not done and it < max_iter:
        H = update_h(H, WtW, WtA)
        gradH = gemm(WtW, H) - WtA
        pg = projected_gradient_norm_single(gradH, H)
        if it == 0:
            pg0 = pg
        else:
            done = bool(pg < tol * pg0)
        it += 1
    if done:
        W, H, _ = normalize_and_scale(W, H)
    return W, H, done
