"""The port's block-principal-pivoting NNLS against the JAX package (f64)
and against the numpy transcription of the reference NnlsBlockpivot."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smallk_tpu.solvers.nnls as jnnls
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
    """k > 128 is the CG tier's on the card (not ported, raises there); on
    CPU tensors the plain GJ solves it."""
    LHS, RHS, Xinit = _problem(130, 6, 5, cols=2)
    X, Y, ok, _ = _port(LHS, RHS, Xinit)
    assert ok and (X >= 0).all()
    assert np.abs(X * Y).max() < 1e-6
