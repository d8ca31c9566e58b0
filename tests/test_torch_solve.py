"""The port's BPP step, solve loop, engine and CLI against the JAX package
(f64 on the CPU), and the import boundary: the port never loads jax."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import smallk_tpu.common.options as jopt
import smallk_tpu.solvers.bpp as jbpp
from smallk_tpu.cli.nmf_cli import main as jnmf_main
from smallk_tpu.engines.nmf import run_nmf as jrun_nmf
from smallk_tpu.io.delimited import load_delimited, write_delimited
from smallk_tpu.io.matrix_market import write_matrix_market
from smallk_tpu.ops.aop import DenseAOp as JDenseAOp
from smallk_tpu.solvers.solve import nmf_solve as jnmf_solve
from smallk_tpu.solvers.solve import reference_pg1 as jreference_pg1
from smallk_torch.cli.nmf_cli import entry as tnmf_entry
from smallk_torch.cli.nmf_cli import main as tnmf_main
from smallk_torch.common import options as topt
from smallk_torch.common.options import NmfAlgorithm, NmfStats
from smallk_torch.engines.nmf import run_nmf
from smallk_torch.interop import from_reference
from smallk_torch.solvers import bpp
from smallk_torch.solvers.solve import nmf_solve, reference_pg1
from test_oracles import np_bpp_trajectory

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
M, N, K = 60, 40, 6
RTOL, ATOL = 1e-8, 1e-9


def _problem(seed=0, m=M, n=N, k=K):
    rng = np.random.RandomState(seed)
    return rng.rand(m, n), rng.rand(m, k), rng.rand(k, n)


def _opts(pkg=topt, **kw):
    """NmfOptions of `pkg`'s own options module (the port's by default, the
    JAX package's with `jopt`); enum fields are given by value."""
    base = dict(height=M, width=N, k=K, dtype="float64", verbose=False,
                tol=1e-4, max_iter=300)
    base.update(kw)
    for key, cls in (("algorithm", "NmfAlgorithm"),
                     ("prog_est_algorithm", "NmfProgressAlgorithm")):
        if key in base:
            base[key] = getattr(pkg, cls)(base[key])
    return pkg.NmfOptions(**base)


def _jax_solve(A, W0, H0, opts, pg0_hint=None):
    return jnmf_solve(JDenseAOp(jnp.asarray(A)), jnp.asarray(W0),
                      jnp.asarray(H0), opts, pg0_hint=pg0_hint)


def _port_solve(A, W0, H0, opts, pg0_hint=None):
    aop, W, H = from_reference(A, W0, H0, device="cpu", dtype="float64")
    return nmf_solve(aop, W, H, opts, pg0_hint=pg0_hint).to_numpy()


def _assert_same_result(r, j, equal_nan=False):
    assert int(r.iterations) == int(j.iterations)
    assert bool(r.converged) == bool(j.converged)
    assert bool(r.success) == bool(j.success)
    assert int(r.pivot_rounds) == int(j.pivot_rounds)
    for a, b in ((r.W, j.W), (r.H, j.H)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL,
                                   equal_nan=equal_nan)
    np.testing.assert_allclose(float(r.metric), float(j.metric), rtol=1e-6,
                               equal_nan=equal_nan)


def test_bpp_step_matches_reference():
    A, W0, H0 = _problem(1)
    ja = JDenseAOp(jnp.asarray(A))
    js = jbpp.init(ja, jnp.asarray(W0), jnp.asarray(H0))
    aop, W, H = from_reference(A, W0, H0, device="cpu", dtype="float64")
    ts = bpp.init(aop, W, H)
    Wj, Hj = jnp.asarray(W0), jnp.asarray(H0)
    for _ in range(3):
        Wj, Hj, gWj, gHj, js, okj = jbpp.step(ja, Wj, Hj, js)
        W, H, gW, gH, ts, ok = bpp.step(aop, W, H, ts)
        assert bool(ok) and bool(okj)
        for t, j in ((W, Wj), (H, Hj), (gW, gWj), (gH, gHj),
                     (ts.Wt, js.Wt), (ts.WtW, js.WtW), (ts.WtA, js.WtA)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                                       atol=ATOL)
        assert ts.pivot_rounds == int(js.pivot_rounds)


def test_bpp_trajectory_matches_numpy_oracle():
    """Scale-invariant comparison: the port, like the reference, rebalances
    W/H every iteration; the numpy oracle does not."""
    A, W0, H0 = _problem(2, 30, 24, 4)
    Wn, Hn = np_bpp_trajectory(A, W0, H0, 25)
    aop, W, H = from_reference(A, W0, H0, device="cpu", dtype="float64")
    st = bpp.init(aop, W, H)
    for _ in range(25):
        W, H, _, _, st, ok = bpp.step(aop, W, H, st)
        assert bool(ok)
    W, H = W.numpy(), H.numpy()
    np.testing.assert_allclose(W @ H, Wn @ Hn, atol=1e-10)
    np.testing.assert_allclose(W / np.linalg.norm(W, axis=0),
                               Wn / np.linalg.norm(Wn, axis=0), atol=1e-10)


SOLVE_CASES = {
    "pg_ratio": {},
    "delta_fnorm": dict(prog_est_algorithm="DELTA_FNORM", tol=1e-3),
    "min_iter_tolcount": dict(min_iter=12, tolcount=3, tol=2e-3),
    "max_iter_is_success": dict(tol=1e-12, max_iter=7, min_iter=1),
    "check_interval": dict(check_interval=4, tol=1e-3),
    "stall_patience": dict(tol=1e-12, stall_patience=3, min_iter=2),
    "no_normalize": dict(normalize=False, tol=1e-3),
}


@pytest.mark.parametrize("case", sorted(SOLVE_CASES))
def test_nmf_solve_matches_reference(case):
    A, W0, H0 = _problem(3)
    r = _port_solve(A, W0, H0, _opts(**SOLVE_CASES[case]))
    j = _jax_solve(A, W0, H0, _opts(jopt, **SOLVE_CASES[case]))
    _assert_same_result(r, j)
    assert bool(r.success)
    if case == "max_iter_is_success":
        assert int(r.iterations) == 7 and not bool(r.converged)
    if case == "min_iter_tolcount":
        assert int(r.iterations) >= 12 + 3
    np.testing.assert_allclose(np.asarray(r.prog_state),
                               np.asarray(j.prog_state), rtol=1e-8)


def test_pg0_hint_and_reference_pg1():
    A, W0, H0 = _problem(4)
    opts, jopts = _opts(tol=2e-3), _opts(jopt, tol=2e-3)
    ja = JDenseAOp(jnp.asarray(A))
    pg1_j = float(jreference_pg1(ja, jnp.asarray(W0), jnp.asarray(H0),
                                 jopts))
    aop, W, H = from_reference(A, W0, H0, device="cpu", dtype="float64")
    pg1 = float(reference_pg1(aop, W, H, opts))
    np.testing.assert_allclose(pg1, pg1_j, rtol=1e-10)
    r = _port_solve(A, W0, H0, opts, pg0_hint=pg1)
    j = _jax_solve(A, W0, H0, jopts, pg0_hint=pg1_j)
    _assert_same_result(r, j)


def test_failed_step_ends_the_solve_unnormalized():
    """A non-finite input fails the first step: the loop stops, reports
    failure, and returns that step's factors without normalizing them."""
    A, W0, H0 = _problem(5)
    A[3, 7] = np.inf
    r = _port_solve(A, W0, H0, _opts())
    j = _jax_solve(A, W0, H0, _opts(jopt))
    assert not bool(r.success) and int(r.iterations) == 1
    _assert_same_result(r, j, equal_nan=True)


@pytest.mark.parametrize("algorithm", [NmfAlgorithm.MU, NmfAlgorithm.HALS,
                                       NmfAlgorithm.RANK2])
def test_unported_algorithms_raise(algorithm, monkeypatch):
    """Every algorithm has a solver now; one missing from the registry
    raises instead of running another."""
    import smallk_torch.solvers.solve as solve

    A, W0, H0 = _problem(6, k=2)
    opts = _opts(algorithm=algorithm.value, k=2)
    assert set(solve._SOLVERS) == set(NmfAlgorithm)
    monkeypatch.delitem(solve._SOLVERS, algorithm)
    with pytest.raises(NotImplementedError, match="no solver"):
        _port_solve(A, W0, H0, opts)


def test_verbose_cadence(capsys):
    A, W0, H0 = _problem(7)
    _port_solve(A, W0, H0, _opts(tol=1e-12, max_iter=25, verbose=True))
    lines = capsys.readouterr().out.strip().splitlines()
    its = [int(line.split(":")[0]) for line in lines]
    assert its == [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 20]
    assert all("progress metric:" in line for line in lines)


def test_run_nmf_from_sparse_matches_reference():
    rng = np.random.RandomState(8)
    A = sp.random(M, N, density=0.3, random_state=rng, format="csc")
    _, W0, H0 = _problem(8)
    st, jst = NmfStats(), jopt.NmfStats()
    W, H, ok = run_nmf(A, W0, H0, _opts(tol=1e-3), st, device="cpu")
    Wj, Hj, okj = jrun_nmf(A, W0, H0, _opts(jopt, tol=1e-3), jst)
    assert ok and okj
    assert (st.iteration_count, st.pivot_rounds) == (jst.iteration_count,
                                                     jst.pivot_rounds)
    assert st.elapsed_us > 0
    assert isinstance(W, np.ndarray) and W.dtype == np.float64
    np.testing.assert_allclose(W, Wj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(H, Hj, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bad", ["opts_shape", "W0_shape", "H0_shape",
                                 "k_too_large"])
def test_run_nmf_validation(bad):
    A, W0, H0 = _problem(9)
    opts = _opts()
    if bad == "opts_shape":
        opts = dataclasses.replace(opts, height=M + 1)
    elif bad == "W0_shape":
        W0 = W0[:, :-1]
    elif bad == "H0_shape":
        H0 = H0[:-1]
    else:
        opts = dataclasses.replace(opts, k=N + 1)
    with pytest.raises(ValueError):
        run_nmf(A, W0, H0, opts, device="cpu")


def test_cli_matches_reference_cli(tmp_path):
    A, W0, H0 = _problem(10)
    mtx = str(tmp_path / "a.mtx")
    write_matrix_market(mtx, sp.coo_matrix(A), precision=17)
    win, hin = str(tmp_path / "w0.csv"), str(tmp_path / "h0.csv")
    write_delimited(win, W0, 17)
    write_delimited(hin, H0, 17)
    common = ["--matrixfile", mtx, "--k", str(K), "--infile_W", win,
              "--infile_H", hin, "--dtype", "float64", "--verbose", "0",
              "--tol", "0.001"]
    outs = {}
    for name, main, extra in (("port", tnmf_main, ["--device", "cpu"]),
                              ("jax", jnmf_main, [])):
        w, h = str(tmp_path / f"w_{name}.csv"), str(tmp_path / f"h_{name}.csv")
        assert main(common + extra + ["--outfile_W", w,
                                      "--outfile_H", h]) == 0
        outs[name] = (load_delimited(w), load_delimited(h))
    for a, b in zip(outs["port"], outs["jax"], strict=True):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-5)


def test_cli_exit_codes(tmp_path):
    A, _, _ = _problem(11)
    csv = str(tmp_path / "a.csv")
    write_delimited(csv, A, 8)
    w, h = str(tmp_path / "w.csv"), str(tmp_path / "h.csv")
    ok = tnmf_entry(["--matrixfile", csv, "--k", "4", "--seed", "1",
                     "--device", "cpu", "--verbose", "0", "--maxiter", "10",
                     "--outfile_W", w, "--outfile_H", h])
    assert ok == 0 and load_delimited(w).shape == (M, 4)
    assert tnmf_entry(["--matrixfile", str(tmp_path / "missing.mtx"),
                       "--k", "4", "--device", "cpu"]) == 2  # BAD_PARAM
    assert tnmf_entry(["--matrixfile", csv, "--k", "4", "--device", "cpu",
                       "--algorithm", "MU", "--verbose", "0", "--maxiter",
                       "10", "--outfile_W", w, "--outfile_H", h]) == 0
    assert tnmf_entry(["--matrixfile", csv, "--k", "4", "--device", "cpu",
                       "--algorithm", "ALS"]) == 2  # BAD_PARAM: no such flag
    assert tnmf_entry(["--k", "4"]) == 2  # usage error


_NO_JAX = r"""
import importlib, pkgutil, sys
import numpy as np
import smallk_torch
mods = [m.name for m in pkgutil.walk_packages(smallk_torch.__path__,
                                              "smallk_torch.")]
for name in mods:
    importlib.import_module(name)
from smallk_torch import NmfOptions, NmfStats, Random, random_matrix
from smallk_torch import random_sparse_matrix
from smallk_torch.engines.nmf import run_nmf
rng = Random(1)
A = random_sparse_matrix(rng, 120, 90, nz_per_col=10, dtype=np.float32)
W0, H0 = random_matrix(120, 5, rng), random_matrix(5, 90, rng)
opts = NmfOptions(height=120, width=90, k=5, max_iter=10, verbose=False,
                  a_dtype="bfloat16")
st = NmfStats()
W, H, ok = run_nmf(A, W0, H0, opts, st, device="cpu")
assert ok and st.iteration_count > 0 and W.shape == (120, 5)
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
print("modules", len(mods))
"""


def test_port_never_imports_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    env.pop("SMALLK_TPU_COMPILE_CACHE", None)
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 14
