"""The port's block-principal-pivoting NNLS against the JAX package (f64)
and against the numpy transcription of the reference NnlsBlockpivot; its
rounds over the non-optimal columns only against full-width rounds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smallk_tpu.solvers.nnls as jnnls
from smallk_torch.kernels import masked_gj
from smallk_torch.ops.dense import gemm, zeroize_small
from smallk_torch.solvers import nnls as tnnls
from test_oracles import np_nnls_blockpivot

torch.set_num_threads(1)


def _problem(k, n, seed, cols=3):
    rng = np.random.RandomState(seed)
    B = rng.rand(k, cols * k)
    LHS = B @ B.T + 0.1 * np.eye(k)
    RHS = B @ rng.rand(cols * k, n) - 0.3 * B.sum(1, keepdims=True)
    Xinit = rng.rand(k, n) - 0.5
    return LHS, RHS, Xinit


def _port(LHS, RHS, Xinit):
    X, Y, ok, rounds = tnnls.nnls_blockpivot(
        *(torch.from_numpy(np.ascontiguousarray(a))
          for a in (LHS, RHS, Xinit)))
    return X.numpy(), Y.numpy(), bool(ok), rounds


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("k", [4, 8, 16])
def test_matches_jax_f64(k, seed):
    LHS, RHS, Xinit = _problem(k, 150, seed)
    Xj, Yj, okj, rj = jnnls.nnls_blockpivot(
        jnp.asarray(LHS), jnp.asarray(RHS), jnp.asarray(Xinit))
    X, Y, ok, rounds = _port(LHS, RHS, Xinit)
    assert ok == bool(okj) and ok
    assert rounds == int(rj) and rounds > 0
    np.testing.assert_allclose(X, np.asarray(Xj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(Y, np.asarray(Yj), rtol=0, atol=1e-10)
    # KKT: X >= 0, gradient >= 0 where X == 0, complementarity
    assert (X >= 0).all()
    assert np.abs(X * Y).max() < 1e-8


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matches_numpy_oracle(seed):
    LHS, RHS, Xinit = _problem(8, 40, seed)
    Xn, _, okn = np_nnls_blockpivot(LHS, RHS, Xinit)
    X, _, ok, _ = _port(LHS, RHS, Xinit)
    assert ok and okn
    np.testing.assert_allclose(X, Xn, atol=1e-10)


def test_optimal_warm_start_needs_no_rounds():
    LHS, RHS, Xinit = _problem(6, 60, 3)
    X, _, ok, _ = _port(LHS, RHS, Xinit)
    X2, _, ok2, rounds = _port(LHS, RHS, X)
    assert ok and ok2 and rounds == 0
    np.testing.assert_allclose(X2, X, atol=1e-12)


def test_transposed_operands_are_accepted():
    """bpp passes W^T views (non-contiguous) as RHS and warm start."""
    LHS, RHS, Xinit = _problem(5, 30, 4)
    X, Y, ok, r = _port(LHS, RHS, Xinit)
    Xt, Yt, okt, rt = tnnls.nnls_blockpivot(
        torch.from_numpy(LHS), torch.from_numpy(RHS.T.copy()).T,
        torch.from_numpy(Xinit.T.copy()).T)
    assert okt and ok and rt == r
    np.testing.assert_array_equal(Xt.numpy(), X)


def test_nonfinite_inputs_fail_not_succeed():
    """An Inf in RHS (an f32 overflow upstream) reports failure."""
    k, n = 4, 12
    rng = np.random.RandomState(0)
    B = rng.rand(k, 3 * k)
    LHS = B @ B.T + 0.1 * np.eye(k)
    RHS = B @ rng.rand(3 * k, n)
    RHS[1, 3] = np.inf
    _, _, ok, _ = _port(LHS, RHS, rng.rand(k, n))
    _, _, okj, _ = jnnls.nnls_blockpivot(jnp.asarray(LHS), jnp.asarray(RHS),
                                         jnp.asarray(rng.rand(k, n)))
    assert not ok and not bool(okj)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pivot_rules_match_reference(seed):
    rng = np.random.RandomState(seed)
    k, n = 7, 64
    passive = rng.rand(k, n) > 0.5
    nonopt = (rng.rand(k, n) > 0.7) & ~passive
    infeas = (rng.rand(k, n) > 0.7) & passive
    not_good = (nonopt.sum(0) + infeas.sum(0)).astype(np.int32)
    P = rng.randint(0, 4, n).astype(np.int32)
    Ninf = rng.randint(0, k + 2, n).astype(np.int32)
    sel = not_good > 0

    jout = jnnls._pivot_cols(*(jnp.asarray(a) for a in
                               (P, Ninf, nonopt, infeas, not_good, sel)))
    tout = tnnls._pivot_cols(*(torch.from_numpy(a) for a in
                               (P, Ninf, nonopt, infeas, not_good, sel)))
    for j, t in zip(jout, tout, strict=True):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    _, _, c1, c2, c3 = tout
    assert (c1 | c2 | c3).numpy().tolist() == sel.tolist()
    pj = jnnls._update_passive(jnp.asarray(passive), jnp.asarray(nonopt),
                               jnp.asarray(infeas), *jout[2:])
    pt = tnnls._update_passive(torch.from_numpy(passive),
                               torch.from_numpy(nonopt),
                               torch.from_numpy(infeas), c1, c2, c3)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))


def test_rank_above_kernel_limit_uses_plain_version_on_cpu():
    """k > 128 is the CG tier's on the card (tests/test_torch_cg.py); on
    CPU tensors the plain GJ solves it unless CG is forced."""
    LHS, RHS, Xinit = _problem(130, 6, 5, cols=2)
    X, Y, ok, _ = _port(LHS, RHS, Xinit)
    assert ok and (X >= 0).all()
    assert np.abs(X * Y).max() < 1e-6


def _full_width_blockpivot(LHS, RHS, Xinit):
    """The oracle for the narrowed rounds: nnls_blockpivot with every round
    at full width (all n columns solved, the non-optimal ones kept), as the
    reference's `body` has it."""
    k, n = RHS.shape
    max_iter = 5 * k
    eps = torch.finfo(RHS.dtype).eps
    abs_lhs, abs_rhs = torch.abs(LHS), torch.abs(RHS)

    def deltas(X):
        dx = 512.0 * eps * torch.clamp(torch.max(torch.abs(X)), min=1.0)
        dy = 16.0 * eps * (gemm(abs_lhs, torch.abs(X)) + abs_rhs)
        return dx, dy

    passive = Xinit > 0
    X = masked_gj.masked_gj_solve_reference(LHS, RHS, passive)
    Y = gemm(LHS, X) - RHS
    P = torch.full((n,), tnnls.PBAR, dtype=torch.int32)
    Ninf = torch.full((n,), k + 1, dtype=torch.int32)
    dx, dy = deltas(X)
    nonopt = (Y < -dy) & ~passive
    infeas = (X < -dx) & passive
    not_good = tnnls._count(nonopt, infeas)
    it = 0
    live = []
    while it < max_iter and bool(torch.any(not_good > 0)):
        notopt_col = not_good > 0
        live.append(int(notopt_col.sum()))
        P, Ninf, c1, c2, c3 = tnnls._pivot_cols(
            P, Ninf, nonopt, infeas, not_good, notopt_col)
        passive = tnnls._update_passive(passive, nonopt, infeas, c1, c2, c3)
        Xs = masked_gj.masked_gj_solve_reference(LHS, RHS, passive)
        Ys = gemm(LHS, Xs) - RHS
        mask = notopt_col[None, :]
        X = torch.where(mask, Xs, X)
        Y = torch.where(mask, Ys, Y)
        dx, dy = deltas(X)
        nonopt = mask & (Y < -dy) & ~passive
        infeas = mask & (X < -dx) & passive
        not_good = tnnls._count(nonopt, infeas)
        it += 1
    converged = ~torch.any(not_good > 0)
    finite = torch.all(torch.isfinite(X)) & torch.all(torch.isfinite(Y))
    X = torch.clamp(X, min=0.0)
    X = zeroize_small(X, 8.0 * eps * torch.clamp(torch.max(X), min=1.0))
    return X, Y, converged & finite, it, live


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("k,n", [(48, 2048), (50, 2100)])
def test_active_column_rounds_equal_full_width_rounds(k, n, dtype,
                                                      monkeypatch):
    """With the gate lowered to this size (on the card it is k n >= 2^23,
    too large for a CPU test) a round solves only the columns still not
    optimal; X, ok and rounds are those of full-width rounds, bit for bit,
    and the columns solved are fewer than rounds x n.  Y = LHS X - RHS
    comes from a GEMM at another width, which may sum in another order: it
    is held to a quarter of the sign tests' own rounding allowance,
    4 eps (|LHS| |X| + |RHS|) entry by entry (and is bit-equal wherever
    the BLAS sums alike)."""
    monkeypatch.setattr(tnnls, "_NARROW_MIN_ENTRIES", k * n)
    LHS, RHS, Xinit = (torch.from_numpy(a.astype(dtype))
                       for a in _problem(k, n, 11, cols=2))
    Xo, Yo, oko, ro, live = _full_width_blockpivot(LHS, RHS, Xinit)
    solved = []
    plain = masked_gj.masked_gj_solve_reference

    def counting(L, R, p):
        solved.append(R.shape[1])
        return plain(L, R, p)

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(masked_gj, "masked_gj_solve_reference", counting)
        X, Y, ok, rounds = tnnls.nnls_blockpivot(LHS, RHS, Xinit)
    finally:
        mp.undo()
    assert rounds == ro and rounds > 2
    assert bool(ok) == bool(oko) and bool(ok)
    assert torch.equal(X, Xo)
    allowance = 4.0 * torch.finfo(X.dtype).eps * (
        gemm(torch.abs(LHS), torch.abs(X)) + torch.abs(RHS))
    assert bool(torch.all(torch.abs(Y - Yo) <= allowance))
    # the first solve and every round at the width of its non-optimal set
    assert solved == [n] + live
    assert sum(solved[1:]) < rounds * n


def test_active_column_rounds_match_jax_f64(monkeypatch):
    """The same shape and narrowed rounds against the JAX nnls_blockpivot,
    whose width ladder is live here.  The ladder counts its slab rounds, so
    its `rounds` may differ from the port's and is not compared."""
    k, n = 48, 2048
    monkeypatch.setattr(tnnls, "_NARROW_MIN_ENTRIES", k * n)
    LHS, RHS, Xinit = _problem(k, n, 11, cols=2)
    Xj, Yj, okj, _ = jnnls.nnls_blockpivot(
        jnp.asarray(LHS), jnp.asarray(RHS), jnp.asarray(Xinit))
    X, Y, ok, rounds = _port(LHS, RHS, Xinit)
    assert ok == bool(okj) and ok and rounds > 0
    np.testing.assert_allclose(X, np.asarray(Xj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(Y, np.asarray(Yj), rtol=0, atol=1e-10)


def test_narrow_shapes_keep_full_width_rounds():
    """Below the gate (k n < _NARROW_MIN_ENTRIES) every round solves all n
    columns."""
    LHS, RHS, Xinit = (torch.from_numpy(a) for a in _problem(8, 300, 2))
    Xo, Yo, oko, ro, _ = _full_width_blockpivot(LHS, RHS, Xinit)
    before = masked_gj.launches, masked_gj.columns
    X, Y, ok, rounds = tnnls.nnls_blockpivot(LHS, RHS, Xinit)
    assert (masked_gj.launches, masked_gj.columns) == before  # CPU tensors
    assert rounds == ro and bool(ok) and bool(oko)
    assert torch.equal(X, Xo) and torch.equal(Y, Yo)
