"""The port's masked conjugate-gradient tier (solvers/nnls._cg_solve_block,
`set_masked_solver`, the warm start through nnls_blockpivot) against the
JAX package's (smallk_tpu/solvers/nnls.py:120-222), in f64 on the CPU,
and its routing: on the card every solve above the GJ kernel's rank limit
goes to CG, on the CPU only when CG is forced.

Tolerances: a CG solve is iterated to a relative residual of 64 eps, so
two runs that sum in other orders agree to far less than that times the
systems' condition numbers: CG_RTOL (relative to the largest entry) for
one solve, BPP_RTOL for a pivoting NNLS and a BPP trajectory.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smallk_tpu.common.options as jopt
import smallk_tpu.solvers.nnls as jnnls
from smallk_tpu.ops.aop import DenseAOp as JDenseAOp
from smallk_tpu.solvers.solve import nmf_solve as jnmf_solve
from smallk_torch.common import options as topt
from smallk_torch.kernels import masked_gj
from smallk_torch.ops.aop import DenseAOp
from smallk_torch.solvers import nnls
from smallk_torch.solvers.solve import nmf_solve

torch.set_num_threads(1)

CG_RTOL = 1e-10
BPP_RTOL = 1e-8


def _system(k, n, seed, dead=(), passive_share=0.6):
    rng = np.random.RandomState(seed)
    B = rng.rand(3 * k, k)
    B[:, list(dead)] = 0.0  # a dead topic: zero Gram row and column
    LHS = B.T @ B
    RHS = B.T @ rng.rand(3 * k, n)
    passive = rng.rand(k, n) < passive_share
    return LHS, RHS, passive, rng


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture
def forced_cg():
    """Both packages' masked solves forced onto CG, restored after."""
    nnls.set_masked_solver("cg")
    jnnls.set_masked_solver("cg")
    yield
    nnls.set_masked_solver("auto")
    jnnls.set_masked_solver("auto")


@pytest.mark.parametrize("start", ["cold", "warm"])
def test_cg_matches_jax_f64(start):
    """Cold and warm-started solves, with a dead topic (forced non-passive)
    and, warm, a non-finite x0 entry (its column restarts cold)."""
    k, n = 40, 90
    LHS, RHS, passive, rng = _system(k, n, 1, dead=(5,))
    x0 = None
    if start == "warm":
        x0 = rng.rand(k, n)
        x0[3, 7] = np.inf
        x0[:, 11] = np.nan
    want = np.asarray(jnnls._cg_solve_block(
        jnp.asarray(LHS), jnp.asarray(RHS), jnp.asarray(passive),
        None if x0 is None else jnp.asarray(x0)))
    before = nnls.cg_solves
    got = nnls._cg_solve_block(
        torch.from_numpy(LHS), torch.from_numpy(RHS),
        torch.from_numpy(passive),
        None if x0 is None else torch.from_numpy(x0)).numpy()
    assert nnls.cg_solves == before + 1
    assert np.isfinite(got).all()
    assert _rel(got, want) <= CG_RTOL
    np.testing.assert_array_equal(got[5], 0.0)  # the dead topic
    np.testing.assert_array_equal(got[~passive], 0.0)


def test_cg_solves_the_masked_system():
    """What CG returns is the masked system's solution: each column's
    passive block solved, zeros elsewhere (the GJ tier's contract)."""
    k, n = 24, 30
    LHS, RHS, passive, _ = _system(k, n, 4)
    got = nnls._cg_solve_block(torch.from_numpy(LHS), torch.from_numpy(RHS),
                               torch.from_numpy(passive)).numpy()
    for j in range(n):
        p = passive[:, j]
        want = np.zeros(k)
        want[p] = np.linalg.solve(LHS[np.ix_(p, p)], RHS[p, j])
        np.testing.assert_allclose(got[:, j], want, rtol=0,
                                   atol=CG_RTOL * np.abs(want).max())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cg_capout_poisons_the_reference_columns(dtype, monkeypatch):
    """A step cap far below what the columns need poisons the capped
    columns with NaN, the same columns as the JAX package's
    (tests/test_solvers.py:672-700): a column with one passive entry is
    solved exactly in one Jacobi-preconditioned step and stays finite, a
    fully passive one caps out."""
    k, n = 32, 64
    LHS, RHS, _, rng = _system(k, n, 2)
    LHS += 0.1 * np.eye(k)
    passive = np.ones((k, n), dtype=bool)
    passive[:, ::3] = False
    passive[rng.randint(0, k, n)[::3], np.arange(0, n, 3)] = True
    args = [a.astype(dtype) if a.dtype != bool else a
            for a in (LHS, RHS, passive)]
    healthy = nnls._cg_solve_block(*(torch.from_numpy(a) for a in args))
    assert torch.isfinite(healthy).all()
    monkeypatch.setattr(nnls, "_CG_EXTRA_STEPS", -(k - 1))
    monkeypatch.setattr(jnnls, "_CG_EXTRA_STEPS", -(k - 1))
    got = nnls._cg_solve_block(*(torch.from_numpy(a) for a in args)).numpy()
    want = np.asarray(jnnls._cg_solve_block(*(jnp.asarray(a) for a in args)))
    poisoned = np.isnan(got).any(axis=0)
    np.testing.assert_array_equal(poisoned, np.isnan(want).any(axis=0))
    np.testing.assert_array_equal(poisoned, passive.sum(axis=0) > 1)


def test_masked_solver_switch():
    """'auto' keeps every CPU solve on the GJ tier's plain version at any
    rank; 'cg' sends it to CG; other names are refused."""
    k, n = 136, 12
    LHS, RHS, passive, _ = _system(k, n, 3)
    args = [torch.from_numpy(a) for a in (LHS, RHS, passive)]
    solves = nnls.cg_solves
    gj = nnls._masked_solve(*args)
    assert nnls.cg_solves == solves
    nnls.set_masked_solver("cg")
    try:
        cg = nnls._masked_solve(*args)
    finally:
        nnls.set_masked_solver("auto")
    assert nnls.cg_solves == solves + 1 and nnls.MASKED_SOLVER == "auto"
    np.testing.assert_allclose(cg.numpy(), gj.numpy(), rtol=0,
                               atol=BPP_RTOL * float(gj.abs().max()))
    with pytest.raises(ValueError, match="masked solver"):
        nnls.set_masked_solver("pallas")


def test_nnls_through_cg_matches_jax_f64(forced_cg):
    """nnls_blockpivot with every masked solve on CG (each warm-started
    from the last X, as the reference passes x0) against the JAX
    package's, in full-width rounds at both."""
    k, n = 64, 150
    rng = np.random.RandomState(5)
    B = rng.rand(k, 3 * k)
    LHS = B @ B.T + 0.1 * np.eye(k)
    RHS = B @ rng.rand(3 * k, n) - 0.3 * B.sum(1, keepdims=True)
    Xinit = rng.rand(k, n) - 0.5
    Xj, Yj, okj, rj = jnnls.nnls_blockpivot(
        jnp.asarray(LHS), jnp.asarray(RHS), jnp.asarray(Xinit))
    solves = nnls.cg_solves
    X, Y, ok, rounds = nnls.nnls_blockpivot(
        *(torch.from_numpy(a) for a in (LHS, RHS, Xinit)))
    assert bool(ok) and bool(okj) and rounds == int(rj) and rounds > 0
    assert nnls.cg_solves == solves + rounds + 1
    assert _rel(X.numpy(), np.asarray(Xj)) <= BPP_RTOL
    assert _rel(Y.numpy(), np.asarray(Yj)) <= BPP_RTOL


def _bpp_opts(pkg, m, n, k):
    return pkg.NmfOptions(
        height=m, width=n, k=k, dtype="float64", verbose=False, tol=1e-30,
        min_iter=1, max_iter=4, algorithm=pkg.NmfAlgorithm("BPP"))


def test_bpp_through_cg_matches_jax_f64(forced_cg):
    """BPP at k = 136 (above the GJ kernel's rank limit, the CG tier's on
    the card) with CG forced in both packages: four iterations, the same
    pivot rounds, W and H to BPP_RTOL."""
    m, n, k = 220, 180, 136
    rng = np.random.RandomState(7)
    A = rng.rand(m, n)
    W0, H0 = rng.rand(m, k), rng.rand(k, n)
    j = jnmf_solve(JDenseAOp(jnp.asarray(A)), jnp.asarray(W0),
                   jnp.asarray(H0), _bpp_opts(jopt, m, n, k))
    r = nmf_solve(DenseAOp(torch.from_numpy(A)), torch.from_numpy(W0),
                  torch.from_numpy(H0), _bpp_opts(topt, m, n, k)).to_numpy()
    assert int(r.iterations) == int(j.iterations) == 4
    assert bool(r.success) and bool(j.success)
    assert int(r.pivot_rounds) == int(j.pivot_rounds)
    assert _rel(r.W, np.asarray(j.W)) <= BPP_RTOL
    assert _rel(r.H, np.asarray(j.H)) <= BPP_RTOL


@pytest.mark.cuda
def test_cuda_rank_above_kernel_limit_goes_to_cg():
    """On the card a solve with k > masked_gj.MAX_K goes to CG (no K1
    launch) and equals the CPU's forced-CG solve in f64; k <= MAX_K stays
    on K1."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    k, n = masked_gj.MAX_K + 8, 300
    LHS, RHS, passive, _ = _system(k, n, 6)
    LHS += 0.1 * np.eye(k)
    Xinit = np.random.RandomState(6).rand(k, n) - 0.5
    launches, solves = masked_gj.launches, nnls.cg_solves
    X, Y, ok, rounds = nnls.nnls_blockpivot(
        *(torch.from_numpy(a).cuda() for a in (LHS, RHS, Xinit)))
    assert bool(ok) and masked_gj.launches == launches
    assert nnls.cg_solves == solves + rounds + 1
    nnls.set_masked_solver("cg")
    try:
        Xh, _, okh, rh = nnls.nnls_blockpivot(
            *(torch.from_numpy(a) for a in (LHS, RHS, Xinit)))
    finally:
        nnls.set_masked_solver("auto")
    assert bool(okh) and rh == rounds
    assert _rel(X.cpu().numpy(), Xh.numpy()) <= BPP_RTOL
    small = [torch.from_numpy(a[:8, :8]).cuda() for a in (LHS, RHS)]
    nnls._masked_solve(*small, torch.ones((8, 8), dtype=torch.bool,
                                          device="cuda"))
    assert masked_gj.launches == launches + 1
