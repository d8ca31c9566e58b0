"""The port's MU, RANK2 and HALS solvers, `nnls_hals`, the solve loop over
all four algorithms and the nmf CLI, against the JAX package and the numpy
oracles (f64 on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smallk_tpu.common.options as jopt
import smallk_tpu.solvers.mu as jmu
import smallk_tpu.solvers.rank2 as jrank2
from smallk_tpu.engines.nmf import run_nmf as jrun_nmf
from smallk_tpu.io.delimited import load_delimited, write_delimited
from smallk_tpu.ops.aop import DenseAOp as JDenseAOp
from smallk_tpu.solvers import bpp as jbpp
from smallk_tpu.solvers import hals as jhals
from smallk_tpu.solvers.nnls import nnls_hals as jnnls_hals
from smallk_tpu.solvers.solve import nmf_solve as jnmf_solve
from smallk_torch.cli.nmf_cli import entry as tnmf_entry
from smallk_torch.common import options as topt
from smallk_torch.engines.nmf import run_nmf
from smallk_torch.interop import from_reference, state_from_reference
from smallk_torch.ops.aop import DenseAOp
from smallk_torch.solvers import bpp, hals, mu, rank2
from smallk_torch.solvers.nnls import nnls_hals
from smallk_torch.solvers.solve import nmf_solve
from test_oracles import (
    np_hals_trajectory,
    np_mu_trajectory,
    np_rank2_trajectory,
)

torch.set_num_threads(1)

RTOL, ATOL = 1e-8, 1e-9


def _problem(seed, m=40, n=30, k=5):
    rng = np.random.RandomState(seed)
    return rng.rand(m, n), rng.rand(m, k), rng.rand(k, n)


def _opts(pkg, **kw):
    """NmfOptions of `pkg`'s own options module (`topt`, the port's, or
    `jopt`, the JAX package's); enum fields are given by value."""
    for key, cls in (("algorithm", "NmfAlgorithm"),
                     ("prog_est_algorithm", "NmfProgressAlgorithm")):
        if key in kw:
            kw[key] = getattr(pkg, cls)(kw[key])
    return pkg.NmfOptions(**kw)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _close(t, j, **kw):
    np.testing.assert_allclose(t.numpy() if isinstance(t, torch.Tensor)
                               else t, np.asarray(j), **(kw or dict(
                                   rtol=RTOL, atol=ATOL)))


@pytest.mark.parametrize("module,jmodule,k", [(mu, jmu, 5),
                                              (rank2, jrank2, 2),
                                              (hals, jhals, 5)],
                         ids=["mu", "rank2", "hals"])
def test_step_matches_reference(module, jmodule, k):
    """Four steps from the same state, every output and state field."""
    A, W0, H0 = _problem(1, k=k)
    ja = JDenseAOp(jnp.asarray(A))
    js = jmodule.init(ja, jnp.asarray(W0), jnp.asarray(H0))
    aop, W, H = from_reference(A, W0, H0, device="cpu", dtype="float64")
    ts = module.init(aop, W, H)
    for t, j in zip(ts, js, strict=True):
        _close(t, j)
    Wj, Hj = jnp.asarray(W0), jnp.asarray(H0)
    for _ in range(4):
        Wj, Hj, gWj, gHj, js, okj = jmodule.step(ja, Wj, Hj, js)
        W, H, gW, gH, ts, ok = module.step(aop, W, H, ts)
        assert bool(ok) and bool(okj)
        assert type(ts).__name__ == type(js).__name__
        for t, j in zip((W, H, gW, gH, *ts), (Wj, Hj, gWj, gHj, *js),
                        strict=True):
            _close(t, j)


def test_rank2_solves_and_fixups_match_reference():
    rng = np.random.RandomState(2)
    B = rng.rand(2, 50) - 0.2
    for G in (np.array([[3.0, 1.0], [1.0, 2.0]]),      # cosine form
              np.array([[0.5, 2.0], [2.0, 9.0]]),      # sine form
              np.array([[0.0, 0.0], [0.0, 1.0]])):     # singular: ok false
        Xj, okj = jrank2._system_solve_h(jnp.asarray(G), jnp.asarray(B))
        Xt, okt = rank2._system_solve_h(*_t(G, B))
        assert bool(okt) == bool(okj)
        _close(Xt, Xj, rtol=RTOL, atol=ATOL, equal_nan=True)
        Xj, okj = jrank2._system_solve_w(jnp.asarray(G), jnp.asarray(B.T))
        Xt, okt = rank2._system_solve_w(*_t(G, B.T))
        assert bool(okt) == bool(okj)
        _close(Xt, Xj, rtol=RTOL, atol=ATOL, equal_nan=True)
    G = np.array([[3.0, 1.0], [1.0, 2.0]])
    R = rng.rand(2, 50)
    X = rng.rand(2, 50) - 0.3
    _close(rank2._optimal_active_set_h(*_t(X, G, R)),
           jrank2._optimal_active_set_h(*map(jnp.asarray, (X, G, R))))
    _close(rank2._optimal_active_set_w(*_t(X.T, G, R.T)),
           jrank2._optimal_active_set_w(*map(jnp.asarray, (X.T, G, R.T))))


def test_spectral_init_rank2_matches_reference():
    rng = np.random.RandomState(3)
    # a planted two-cluster operand: a clear top-2 gap
    A = np.abs(rng.rand(60, 45) * 0.1)
    A[:30, :20] += 1.0
    A[30:, 20:] += 1.0
    v0 = rng.rand(2, 45)
    Wj, Hj = jrank2.spectral_init_rank2(JDenseAOp(jnp.asarray(A)),
                                        jnp.asarray(v0))
    Wt, Ht = rank2.spectral_init_rank2(DenseAOp(_t(A)[0]), _t(v0)[0])
    assert (Wt.numpy() >= 0).all() and (Ht.numpy() >= 0).all()
    _close(Wt, Wj)
    _close(Ht, Hj)


def test_nnls_hals_matches_reference():
    A, W, H0 = _problem(4, 50, 40, 6)
    for tol, max_iter in ((1e-3, 500), (1e-12, 7)):
        Wj, Hj, okj = jnnls_hals(JDenseAOp(jnp.asarray(A)), jnp.asarray(W),
                                 jnp.asarray(H0), tol, max_iter)
        tA, tW, tH = _t(A, W, H0)
        Wt, Ht, ok = nnls_hals(DenseAOp(tA), tW, tH, tol, max_iter)
        assert ok == bool(okj) == (max_iter == 500)
        _close(Wt, Wj)
        _close(Ht, Hj)


def _run_steps(module, A, W0, H0, iters):
    aop, W, H = from_reference(A, W0, H0, device="cpu", dtype="float64")
    st = module.init(aop, W, H)
    for _ in range(iters):
        W, H, _, _, st, ok = module.step(aop, W, H, st)
        assert bool(ok)
    return W.numpy(), H.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hals_trajectory_matches_numpy_oracle(seed):
    A, W0, H0 = _problem(seed, 30, 24, 5)
    Wn, Hn = np_hals_trajectory(A, W0, H0, 40)
    W, H = _run_steps(hals, A, W0, H0, 40)
    np.testing.assert_allclose(W, Wn, atol=1e-10)
    np.testing.assert_allclose(H, Hn, atol=1e-10)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mu_trajectory_matches_numpy_oracle(seed):
    A, W0, H0 = _problem(seed, 30, 24, 5)
    Wn, Hn = np_mu_trajectory(A, W0, H0, 50)
    W, H = _run_steps(mu, A, W0, H0, 50)
    np.testing.assert_allclose(W, Wn, atol=1e-10)
    np.testing.assert_allclose(H, Hn, atol=1e-10)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rank2_trajectory_matches_numpy_oracle(seed):
    rng = np.random.RandomState(seed)
    A, W0, H0 = rng.rand(30, 24), rng.rand(30, 2), rng.rand(2, 24)
    Wn, Hn = np_rank2_trajectory(A, W0, H0, 30)
    W, H = _run_steps(rank2, A, W0, H0, 30)
    np.testing.assert_allclose(W, Wn, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(H, Hn, rtol=1e-9, atol=1e-11)


SOLVE_CASES = {
    "mu_delta_fnorm": dict(algorithm="MU", tol=1e-3,
                           prog_est_algorithm="DELTA_FNORM"),
    "mu_pg_ratio": dict(algorithm="MU", tol=1e-12, max_iter=40),
    "hals": dict(algorithm="HALS", tol=1e-4),
    "hals_delta_fnorm": dict(algorithm="HALS", tol=1e-4,
                             prog_est_algorithm="DELTA_FNORM"),
    "rank2": dict(algorithm="RANK2", k=2, tol=1e-4),
    "rank2_stall": dict(algorithm="RANK2", k=2, tol=1e-14,
                        stall_patience=5, min_iter=2),
}


@pytest.mark.parametrize("case", sorted(SOLVE_CASES))
def test_nmf_solve_matches_reference(case):
    kw = dict(height=40, width=30, k=5, dtype="float64", verbose=False,
              max_iter=400)
    kw.update(SOLVE_CASES[case])
    opts = _opts(topt, **kw)
    A, W0, H0 = _problem(5, k=opts.k)
    j = jnmf_solve(JDenseAOp(jnp.asarray(A)), jnp.asarray(W0),
                   jnp.asarray(H0), _opts(jopt, **kw))
    aop, W, H = from_reference(A, W0, H0, device="cpu", dtype="float64")
    r = nmf_solve(aop, W, H, opts).to_numpy()
    assert int(r.iterations) == int(j.iterations) > 1
    assert bool(r.converged) == bool(j.converged)
    assert bool(r.success) == bool(j.success)
    _close(r.W, j.W)
    _close(r.H, j.H)
    # the metric is a ratio; a converged rank-2 solve takes it to ~1e-12,
    # where the last digits are rounding
    np.testing.assert_allclose(float(r.metric), float(j.metric), rtol=1e-6,
                               atol=1e-14)
    _close(r.prog_state, j.prog_state)


@pytest.mark.parametrize("algorithm,k", [("MU", 4), ("HALS", 4),
                                         ("RANK2", 2)])
def test_run_nmf_matches_reference(algorithm, k):
    A, W0, H0 = _problem(6, 36, 28, k)
    kw = dict(height=36, width=28, k=k, dtype="float64", verbose=False,
              tol=1e-4, algorithm=algorithm)
    st, jst = topt.NmfStats(), jopt.NmfStats()
    W, H, ok = run_nmf(A, W0, H0, _opts(topt, **kw), st, device="cpu")
    Wj, Hj, okj = jrun_nmf(A, W0, H0, _opts(jopt, **kw), jst)
    assert ok and okj and st.iteration_count == jst.iteration_count
    _close(W, Wj)
    _close(H, Hj)


@pytest.mark.parametrize("name", ["mu", "hals", "rank2", "bpp"])
def test_state_from_reference_round_trips(name):
    module, jmodule = {"mu": (mu, jmu), "hals": (hals, jhals),
                       "rank2": (rank2, jrank2), "bpp": (bpp, jbpp)}[name]
    k = 2 if name == "rank2" else 4
    A, W0, H0 = _problem(7, k=k)
    js = jmodule.init(JDenseAOp(jnp.asarray(A)), jnp.asarray(W0),
                      jnp.asarray(H0))
    host = jax.tree.map(np.asarray, js)
    ts = state_from_reference(host, device="cpu", dtype="float64")
    assert type(ts) is type(module.init(*from_reference(
        A, W0, H0, device="cpu", dtype="float64")))
    for a, b in zip(ts, host, strict=True):
        np.testing.assert_array_equal(
            a.numpy() if isinstance(a, torch.Tensor) else a, b)
    f32 = state_from_reference(host, device="cpu")
    assert all(v.dtype == torch.float32 for v in f32
               if isinstance(v, torch.Tensor))
    with pytest.raises(ValueError):
        state_from_reference((1, 2), device="cpu")


def test_port_state_drives_the_port_step():
    """A reference HALS state handed over mid-solve continues the port's
    solve as the reference continues its own."""
    A, W0, H0 = _problem(8, k=4)
    ja = JDenseAOp(jnp.asarray(A))
    js = jhals.init(ja, jnp.asarray(W0), jnp.asarray(H0))
    Wj, Hj = jnp.asarray(W0), jnp.asarray(H0)
    for _ in range(3):
        Wj, Hj, _, _, js, _ = jhals.step(ja, Wj, Hj, js)
    ts = state_from_reference(jax.tree.map(np.asarray, js), device="cpu",
                              dtype="float64")
    aop, W, H = from_reference(A, np.asarray(Wj), np.asarray(Hj),
                               device="cpu", dtype="float64")
    W, H, _, _, ts, _ = hals.step(aop, W, H, ts)
    Wj, Hj, _, _, js, _ = jhals.step(ja, Wj, Hj, js)
    _close(W, Wj)
    _close(H, Hj)


@pytest.mark.parametrize("algorithm", ["MU", "HALS", "RANK2"])
def test_nmf_cli_runs_every_algorithm(algorithm, tmp_path):
    """The nmf CLI offers MU, HALS and RANK2 on its command line; each runs
    and exits 0, and matches the reference's CLI on the same start."""
    A, W0, H0 = _problem(9, k=2 if algorithm == "RANK2" else 4)
    k = W0.shape[1]
    csv = str(tmp_path / "a.csv")
    write_delimited(csv, A, 17)
    win, hin = str(tmp_path / "w0.csv"), str(tmp_path / "h0.csv")
    write_delimited(win, W0, 17)
    write_delimited(hin, H0, 17)
    w, h = str(tmp_path / "w.csv"), str(tmp_path / "h.csv")
    rc = tnmf_entry(["--matrixfile", csv, "--k", str(k), "--algorithm",
                     algorithm, "--device", "cpu", "--verbose", "0",
                     "--dtype", "float64", "--infile_W", win, "--infile_H",
                     hin, "--outfile_W", w, "--outfile_H", h, "--tol",
                     "0.001"])
    assert rc == 0
    W, H = load_delimited(w), load_delimited(h)
    assert W.shape == (40, k) and H.shape == (k, 30)
    opts = _opts(jopt, height=40, width=30, k=k, dtype="float64",
                 verbose=False, tol=0.001, algorithm=algorithm)
    Wj, Hj, okj = jrun_nmf(A, W0, H0, opts)
    assert okj
    np.testing.assert_allclose(W, Wj, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(H, Hj, rtol=1e-5, atol=1e-6)
