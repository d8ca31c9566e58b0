"""The port's solve loop (smallk_torch/solvers/solve.py): the JAX loop's
freeze, `loop_unroll` steps between host reads, and its counters, against
the JAX package's nmf_solve in f64 on the CPU; and, on the card (tests
marked `cuda`), the step captured as a CUDA graph (solvers/graph.py)
against the same loop run eagerly.

Tolerances: W and H to tests/test_torch_solve.py's (rtol 1e-8, atol 1e-9:
f64 runs of the same arithmetic in two frameworks); the port against
itself at another U, or captured against eager, bit for bit (a frozen step
changes no bit of the state).

One stated departure: the JAX loop tests `it < max_iter` only between
trips of U steps, so at U > 1 it runs past max_iter (12 iterations of 10
at U = 3 and 4); the port's freeze also covers `it >= max_iter`.
"""

import dataclasses
import math
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smallk_tpu.common.options as jopt
import smallk_tpu.solvers.mu as jmu
import smallk_tpu.solvers.solve as jsolve
from smallk_tpu.common.rng import Random as JRandom
from smallk_tpu.engines.hierclust import clust_hier as jclust_hier
from smallk_tpu.ops.aop import DenseAOp as JDenseAOp
from smallk_torch.common import options as topt
from smallk_torch.common.rng import Random
from smallk_torch.engines.hierclust import clust_hier
from smallk_torch.interop import from_reference, options_from_reference
from smallk_torch.ops.dense import normalize_and_scale
from smallk_torch.solvers import graph, mu, solve
from test_hier_oracle import _clust_opts, _planted_sparse, _write_initdir
from test_torch_hierclust import _assert_same_tree

torch.set_num_threads(1)

RTOL, ATOL = 1e-8, 1e-9
M, N = 30, 24
UNROLLS = (1, 3, 4, 7)
# per algorithm: k, and a tolerance the run reaches before max_iter
# (80, 97, 72 and 38 iterations: each a block's middle at some U > 1)
ALGS = {"MU": (4, 0.1), "HALS": (4, 1e-3), "RANK2": (2, 1e-4),
        "BPP": (4, 0.01)}


def _problem(k, seed=1):
    """A planted rank-k matrix with noise (RANK2: plain uniform) and
    uniform starts."""
    rng = np.random.RandomState(seed)
    if k == 2:
        return rng.rand(M, N), rng.rand(M, k), rng.rand(k, N)
    A = rng.rand(M, k) @ rng.rand(k, N) + 0.01 * rng.rand(M, N)
    return A, rng.rand(M, k), rng.rand(k, N)


def _opts(pkg, alg, **kw):
    k, tol = ALGS[alg]
    base = dict(height=M, width=N, k=k, dtype="float64", verbose=False,
                tol=tol, max_iter=300, algorithm=alg)
    base.update(kw)
    base["algorithm"] = pkg.NmfAlgorithm(base["algorithm"])
    if "prog_est_algorithm" in base:
        base["prog_est_algorithm"] = pkg.NmfProgressAlgorithm(
            base["prog_est_algorithm"])
    return pkg.NmfOptions(**base)


def _jax(A, W0, H0, opts, pg0_hint=None):
    return jsolve.nmf_solve(JDenseAOp(jnp.asarray(A)), jnp.asarray(W0),
                            jnp.asarray(H0), opts, pg0_hint=pg0_hint)


def _port(A, W0, H0, opts, pg0_hint=None):
    aop, W, H = from_reference(A, W0, H0, device="cpu", dtype="float64")
    return solve.nmf_solve(aop, W, H, opts, pg0_hint=pg0_hint)


def _same_as_jax(r, j):
    assert int(r.iterations) == int(j.iterations)
    assert bool(r.converged) == bool(j.converged)
    assert bool(r.success) == bool(j.success)
    assert int(r.pivot_rounds) == int(j.pivot_rounds)
    for a, b in ((r.W, j.W), (r.H, j.H)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)


def _bit_equal(r, s):
    assert (r.iterations, r.converged, r.success, r.pivot_rounds) == (
        s.iterations, s.converged, s.success, s.pivot_rounds)
    assert r.metric.tobytes() == s.metric.tobytes()
    for a, b in ((r.W, s.W), (r.H, s.H), (r.prog_state, s.prog_state)):
        assert torch.equal(a, b)


def _reset():
    solve.steps_run = solve.host_reads = solve.frozen_steps = 0


@pytest.mark.parametrize("stop", ["converged", "max_iter"])
@pytest.mark.parametrize("unroll", UNROLLS)
@pytest.mark.parametrize("alg", sorted(ALGS))
def test_unrolled_loop_matches_jax_and_itself(alg, unroll, stop):
    """At every U: the JAX loop at the same U (which stops before max_iter
    here, or at a max_iter that is a multiple of U), the port at U = 1 bit
    for bit, and the host reads the counters pin."""
    A, W0, H0 = _problem(ALGS[alg][0])
    kw = dict(loop_unroll=unroll)
    if stop == "max_iter":
        kw.update(tol=1e-30, max_iter=12 if 12 % unroll == 0 else 14)
    _reset()
    r = _port(A, W0, H0, _opts(topt, alg, **kw))
    steps, reads = solve.steps_run, solve.host_reads
    _same_as_jax(r, _jax(A, W0, H0, _opts(jopt, alg, **kw)))
    assert bool(r.success) and bool(r.converged) == (stop == "converged")
    # the fault this loop repairs: loop_unroll was read by nothing
    assert reads == 1 + math.ceil((steps - 1) / unroll)
    assert steps - r.iterations == solve.frozen_steps < unroll
    if unroll > 1:
        _bit_equal(r, _port(A, W0, H0, _opts(topt, alg, loop_unroll=1,
                                             **{k: v for k, v in kw.items()
                                                if k != "loop_unroll"})))


@pytest.mark.parametrize("unroll", [3, 4])
@pytest.mark.parametrize("alg", ["MU", "HALS"])
def test_no_overshoot_past_max_iter(alg, unroll):
    """max_iter = 10: the port runs 10 iterations at every U, equal to the
    JAX loop at U = 1; the JAX loop at U > 1 runs 12 (its stated
    departure, ROADMAP §3)."""
    A, W0, H0 = _problem(ALGS[alg][0])
    kw = dict(tol=1e-30, max_iter=10)
    r = _port(A, W0, H0, _opts(topt, alg, loop_unroll=unroll, **kw))
    j1 = _jax(A, W0, H0, _opts(jopt, alg, loop_unroll=1, **kw))
    ju = _jax(A, W0, H0, _opts(jopt, alg, loop_unroll=unroll, **kw))
    assert int(r.iterations) == 10 and bool(r.success)
    _same_as_jax(r, j1)
    assert int(ju.iterations) == 12


@pytest.mark.parametrize("alg", ["MU", "HALS", "RANK2"])
def test_freeze_at_max_iter_changes_nothing(alg):
    """Steps taken at it == max_iter (a captured block that runs past the
    end) leave every bit of the state as it was."""
    A, W0, H0 = _problem(ALGS[alg][0])
    opts = _opts(topt, alg, tol=1e-30, max_iter=3, loop_unroll=4)
    aop, W, H = from_reference(A, W0, H0, device="cpu", dtype="float64")
    r = solve.nmf_solve(aop, W, H, opts)
    assert r.iterations == 3 and r.success
    solver = solve.get_solver(opts.algorithm)
    loop = solve._Loop(solver, aop, opts, False, 4, W.device)
    c = solve.initial_carry(solver, aop, W, H, torch.ones((), dtype=W.dtype))
    for _ in range(3):
        c = loop.step(c)
    assert int(c.it) == 3
    frozen = c
    for _ in range(4):
        frozen = loop.step(frozen)
    for a, b in zip(_leaves(c), _leaves(frozen), strict=True):
        assert torch.equal(a, b)
    W_n, H_n, _ = normalize_and_scale(c.W, c.H)
    assert torch.equal(r.W, W_n) and torch.equal(r.H, H_n)


def _leaves(c):
    for v in c:
        if isinstance(v, tuple):
            yield from _leaves(v)
        else:
            yield v


SPECIAL = {
    "stall_patience": dict(tol=1e-12, stall_patience=3, min_iter=2),
    "check_interval_3": dict(check_interval=3),
    "delta_fnorm": dict(prog_est_algorithm="DELTA_FNORM", tol=1e-3),
    "min_iter_tolcount": dict(min_iter=9, tolcount=3),
}


@pytest.mark.parametrize("case", sorted(SPECIAL))
@pytest.mark.parametrize("alg", ["HALS", "RANK2"])
def test_options_at_u4_match_jax(alg, case):
    """stall_patience, check_interval = 3, DELTA_FNORM and tolcount at
    U = 4 against the JAX loop at U = 4, and the port at U = 1."""
    A, W0, H0 = _problem(ALGS[alg][0])
    kw = dict(SPECIAL[case], loop_unroll=4)
    r = _port(A, W0, H0, _opts(topt, alg, **kw))
    j = _jax(A, W0, H0, _opts(jopt, alg, **kw))
    _same_as_jax(r, j)
    np.testing.assert_allclose(np.asarray(r.prog_state),
                               np.asarray(j.prog_state), rtol=1e-8)
    _bit_equal(r, _port(A, W0, H0, _opts(topt, alg,
                                         **dict(kw, loop_unroll=1))))


@pytest.mark.parametrize("unroll", [1, 4])
def test_pg0_hint_matches_jax(unroll):
    A, W0, H0 = _problem(2)
    opts, jopts = (_opts(pkg, "RANK2", loop_unroll=unroll)
                   for pkg in (topt, jopt))
    aop, W, H = from_reference(A, W0, H0, device="cpu", dtype="float64")
    pg1 = float(solve.reference_pg1(aop, W, H, opts))
    r = _port(A, W0, H0, opts, pg0_hint=pg1)
    _same_as_jax(r, _jax(A, W0, H0, jopts, pg0_hint=pg1))
    assert float(r.prog_state) == pg1


def test_convergence_mid_block_freezes_the_rest():
    """MU converges at iteration 80: at U = 7 the block that holds it runs
    frozen steps after it, which change nothing."""
    A, W0, H0 = _problem(4)
    _reset()
    r = _port(A, W0, H0, _opts(topt, "MU", loop_unroll=7))
    assert r.converged and r.iterations == 80
    assert solve.frozen_steps == solve.steps_run - 80 > 0
    _bit_equal(r, _port(A, W0, H0, _opts(topt, "MU", loop_unroll=1)))


class _FailState(NamedTuple):
    inner: tuple
    n: object   # steps taken


def _failing(step, init, zeros, fail_at):
    """A solver whose step fails at step `fail_at` (0-based): MU's, with a
    step count in its state."""
    class Failing:
        @staticmethod
        def init(a, W, H):
            return _FailState(init(a, W, H), zeros())

        @staticmethod
        def step(a, W, H, st):
            W, H, gW, gH, inner, ok = step(a, W, H, st.inner)
            return W, H, gW, gH, _FailState(inner, st.n + 1), \
                ok & (st.n != fail_at)
    return Failing


@pytest.mark.parametrize("unroll", [1, 4])
def test_failed_step_mid_block_returns_unnormalized(unroll, monkeypatch):
    """A step that fails in the middle of a block (the 7th, at U = 4 the
    second of the second block) ends the solve: failure, that step's
    factors unnormalized, the JAX loop's result."""
    monkeypatch.setitem(solve._SOLVERS, topt.NmfAlgorithm.MU,
                        _failing(mu.step, mu.init,
                                 lambda: torch.zeros((), dtype=torch.int64),
                                 6))
    monkeypatch.setitem(jsolve._SOLVERS, jopt.NmfAlgorithm.MU,
                        _failing(jmu.step, jmu.init,
                                 lambda: jnp.zeros((), jnp.int32), 6))
    A, W0, H0 = _problem(4)
    # a max_iter no other test uses: the JAX loop is compiled per options
    kw = dict(tol=1e-30, max_iter=41, loop_unroll=unroll)
    r = _port(A, W0, H0, _opts(topt, "MU", **kw))
    j = _jax(A, W0, H0, _opts(jopt, "MU", **kw))
    assert not r.success and not r.converged and r.iterations == 7
    _same_as_jax(r, j)
    assert not np.allclose(np.linalg.norm(r.W.numpy(), axis=0), 1.0)


def _verbose_lines(capsys, A, W0, H0, opts):
    _port(A, W0, H0, opts)
    return capsys.readouterr().out


@pytest.mark.parametrize("unroll", [3, 7])
def test_verbose_text_equals_u1(unroll, capsys):
    A, W0, H0 = _problem(4)
    base = _opts(topt, "HALS", verbose=True)
    want = _verbose_lines(capsys, A, W0, H0, base)
    got = _verbose_lines(capsys, A, W0, H0,
                         dataclasses.replace(base, loop_unroll=unroll))
    assert got == want
    its = [int(line.split(":")[0]) for line in want.splitlines()]
    assert its == list(range(1, 10)) + list(range(10, 98, 10))


def test_auto_unroll():
    """0 is auto: 1 for BPP and on the CPU; the card's value for the
    captured solvers, and 1 for MU once its factors hold
    MU_ONE_STEP_ENTRIES entries."""
    W, H = torch.zeros((3, 2)), torch.zeros((2, 5))
    for alg in ("MU", "HALS", "RANK2", "BPP"):
        assert solve.auto_unroll(_opts(topt, alg), W, H) == 1

    class OnCard:
        is_cuda = True

        def __init__(self, entries):
            self.entries = entries

        def numel(self):
            return self.entries

    small, at = OnCard(16), OnCard(solve.MU_ONE_STEP_ENTRIES - 16)
    for alg in ("MU", "HALS", "RANK2"):
        assert solve.auto_unroll(_opts(topt, alg), small, small) == \
            solve.AUTO_UNROLL[topt.NmfAlgorithm(alg)] > 1
    assert solve.auto_unroll(_opts(topt, "MU"), at, OnCard(15)) > 1
    assert solve.auto_unroll(_opts(topt, "MU"), at, small) == 1
    for alg in ("HALS", "RANK2"):
        assert solve.auto_unroll(_opts(topt, alg), at, small) > 1
    assert solve.auto_unroll(_opts(topt, "BPP"), small, small) == 1


def test_capture_rule(monkeypatch):
    """A MU, HALS or RANK2 solve on the card is captured at U > 1 while
    CAPTURE is on; not at U = 1, not BPP, not on the CPU."""
    class OnCard:
        is_cuda = True

    monkeypatch.setattr(graph, "CAPTURE", True)
    for alg in ("MU", "HALS", "RANK2"):
        a = topt.NmfAlgorithm(alg)
        assert graph.applies(a, OnCard, 2) and graph.applies(a, OnCard, 32)
        assert not graph.applies(a, OnCard, 1)
        assert not graph.applies(a, torch.zeros(2), 8)
    assert not graph.applies(topt.NmfAlgorithm.BPP, OnCard, 8)
    monkeypatch.setattr(graph, "CAPTURE", False)
    assert not graph.applies(topt.NmfAlgorithm.MU, OnCard, 8)


def test_no_capture_on_the_cpu(monkeypatch):
    """On the CPU the loop runs eagerly, whatever CAPTURE says."""
    def refuse(*args, **kwargs):
        raise AssertionError("captured on the CPU")

    monkeypatch.setattr(graph, "StepGraph", refuse)
    A, W0, H0 = _problem(4)
    assert _port(A, W0, H0, _opts(topt, "HALS", loop_unroll=4)).converged


def test_hierclust_initdir_at_u4_matches_jax(tmp_path):
    """Hierclust in initdir mode with every node solved at U = 4: the JAX
    engine's tree (its loop at U = 1)."""
    A, _ = _planted_sparse(48, 72, [24, 18, 16, 14], seed=3)
    initdir = _write_initdir(tmp_path, 48, 72, 60, seed=11)
    jopts = _clust_opts(4, initdir)
    jtree, jstats = jclust_hier(A, jopts, JRandom(1))
    topts = options_from_reference(jopts)
    topts = dataclasses.replace(topts, nmf_opts=dataclasses.replace(
        topts.nmf_opts, loop_unroll=4))
    _reset()
    tree, stats = clust_hier(A, topts, Random(1), device="cpu")
    _assert_same_tree(tree, jtree)
    assert (stats.nmf_count, stats.max_count, stats.iter_count) == (
        jstats.nmf_count, jstats.max_count, jstats.iter_count)
    assert solve.frozen_steps > 0


# ---------------------------------------------------------------- the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from smallk_torch.common.device import setup
    return setup("cuda")


def _counts():
    return {f"{mod.__name__.rsplit('.', 1)[1]}.{name}": getattr(mod, name)
            for mod, name in graph.counters()} | {
        "steps_run": solve.steps_run, "host_reads": solve.host_reads}


def _card_run(a_op, W0, H0, opts, capture, monkeypatch):
    monkeypatch.setattr(graph, "CAPTURE", capture)
    for mod, name in graph.counters():
        monkeypatch.setattr(mod, name, 0)
    _reset()
    r = solve.nmf_solve(a_op, W0, H0, opts)
    torch.cuda.synchronize()
    return r, _counts()


def _card_problem(kind, dev):
    from smallk_torch.ops.aop import DenseAOp
    from smallk_torch.ops.ell import EllAOp
    import scipy.sparse as sp

    rng = np.random.RandomState(5)
    if kind == "HALS":     # K2: dense f32 A, a shape hals_fits admits
        m, n, k, alg = 256, 256, 16, "HALS"
        A = DenseAOp(torch.tensor(rng.rand(m, n), dtype=torch.float32,
                                  device=dev))
    elif kind == "RANK2":  # K3: dense bf16 A, k = 2
        m, n, k, alg = 2000, 1500, 2, "RANK2"
        A = DenseAOp(torch.tensor(rng.rand(m, n), dtype=torch.bfloat16,
                                  device=dev))
    else:                  # ell_spmm: an EllAOp, k = 8
        m, n, k, alg = 3000, 5000, 8, "MU"
        A = EllAOp.from_scipy(sp.random(m, n, density=0.01, random_state=rng,
                                        format="csc"), "float32", device=dev)
    W0 = torch.tensor(rng.rand(m, k), dtype=torch.float32, device=dev)
    H0 = torch.tensor(rng.rand(k, n), dtype=torch.float32, device=dev)
    opts = topt.NmfOptions(height=m, width=n, k=k, algorithm=
                           topt.NmfAlgorithm(alg), tol=1e-4, max_iter=203,
                           verbose=False, loop_unroll=8)
    return A, W0, H0, opts


@pytest.mark.cuda
@pytest.mark.parametrize("unroll", [1, 8])
@pytest.mark.parametrize("kind", ["HALS", "RANK2", "MU"])
def test_captured_equals_eager_on_the_card(kind, unroll, monkeypatch):
    """HALS through K2, RANK2 through K3 on bf16 A, MU through ell_spmm:
    the captured loop bit for bit the eager one, with the same launch
    counts, at U = 8 (the freeze's select written into the graph's
    buffers); at U = 1 nothing is captured."""
    dev = _card()
    A, W0, H0, opts = _card_problem(kind, dev)
    opts = dataclasses.replace(opts, loop_unroll=unroll)
    eager, ce = _card_run(A, W0, H0, opts, False, monkeypatch)
    graph.captures = 0
    captured, cc = _card_run(A, W0, H0, opts, True, monkeypatch)
    assert graph.captures == (unroll > 1)
    assert (captured.iterations, captured.converged, captured.success) == (
        eager.iterations, eager.converged, eager.success)
    assert torch.equal(captured.W, eager.W) and torch.equal(captured.H,
                                                            eager.H)
    assert captured.metric.tobytes() == eager.metric.tobytes()
    assert cc == ce
    launches = {"HALS": "hals_step.launches", "RANK2": "rank2_loop.launches",
                "MU": "ell_spmm.launches"}[kind]
    assert cc[launches] > 0
    if kind == "HALS":
        assert cc[launches] == cc["steps_run"]


@pytest.mark.cuda
def test_a_host_read_in_a_step_makes_capture_raise(monkeypatch):
    """A step that reads the host cannot be captured: the solve raises, it
    does not run the loop eagerly instead."""
    dev = _card()
    A, W0, H0, opts = _card_problem("HALS", dev)
    real = solve._SOLVERS[topt.NmfAlgorithm.HALS]

    class Reading:
        init = staticmethod(real.init)

        @staticmethod
        def step(a, W, H, st):
            out = real.step(a, W, H, st)
            bool(out[-1])   # a host read
            return out

    monkeypatch.setitem(solve._SOLVERS, topt.NmfAlgorithm.HALS, Reading)
    monkeypatch.setattr(graph, "CAPTURE", True)
    with pytest.raises(RuntimeError):
        solve.nmf_solve(A, W0, H0, opts)
    torch.cuda.synchronize()
    # the card still works, its random generator too, and the eager loop
    # runs the same step
    assert torch.rand(4, device=dev).shape == (4,)
    monkeypatch.setattr(graph, "CAPTURE", False)
    assert solve.nmf_solve(A, W0, H0, opts).iterations > 1
