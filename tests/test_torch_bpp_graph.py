"""BPP's pivot loop in its device form (smallk_torch/solvers/nnls.py)
against the JAX package's nnls_blockpivot (f64, the CPU) and the port's
host loop; a whole BPP step in the device form with no host read; the
rule by which a BPP solve is captured (solvers/graph.py) and its auto U;
and, on the card (tests marked `cuda`), BPP captured as a CUDA graph, its
pivot rounds in conditional IF nodes, against the same loop run eagerly.

On the CPU the device form runs through the test-only select guard
(nnls.SELECT_ROUNDS): every round up to the cap runs and is kept only
where its test holds, which is the JAX while_loop's semantics.

Tolerances: X and Y against JAX to 1e-10 absolute (f64, the same
arithmetic in two frameworks, as tests/test_torch_nnls.py); the device
form against the host loop, and captured against eager, bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import smallk_tpu.solvers.nnls as jnnls
from smallk_torch.common import options as topt
from smallk_torch.kernels import masked_gj
from smallk_torch.ops.aop import DenseAOp
from smallk_torch.ops.dense import UNSHARDED
from smallk_torch.solvers import bpp, graph, solve
from smallk_torch.solvers import nnls as tnnls

torch.set_num_threads(1)

ATOL = 1e-10
BPP = topt.NmfAlgorithm.BPP


def _problem(k, n, seed, cols=3):
    """tests/test_torch_nnls.py's problem: an SPD Gram and a right-hand
    side with negative parts, from a random start."""
    rng = np.random.RandomState(seed)
    B = rng.rand(k, cols * k)
    LHS = B @ B.T + 0.1 * np.eye(k)
    RHS = B @ rng.rand(cols * k, n) - 0.3 * B.sum(1, keepdims=True)
    Xinit = rng.rand(k, n) - 0.5
    return LHS, RHS, Xinit


def _port(LHS, RHS, Xinit, device_form, monkeypatch):
    monkeypatch.setattr(tnnls, "SELECT_ROUNDS", device_form)
    X, Y, ok, rounds = tnnls.nnls_blockpivot(
        *(torch.from_numpy(np.ascontiguousarray(a))
          for a in (LHS, RHS, Xinit)))
    assert isinstance(rounds, torch.Tensor) and rounds.ndim == 0
    return X, Y, ok, rounds


def _jax(LHS, RHS, Xinit):
    Xj, Yj, okj, rj = jnnls.nnls_blockpivot(
        jnp.asarray(LHS), jnp.asarray(RHS), jnp.asarray(Xinit))
    return np.asarray(Xj), np.asarray(Yj), bool(okj), int(rj)


def _both_forms(LHS, RHS, Xinit, monkeypatch):
    """The device form, after checking that it equals the host loop bit
    for bit (NaNs in the same places)."""
    dev = _port(LHS, RHS, Xinit, True, monkeypatch)
    host = _port(LHS, RHS, Xinit, False, monkeypatch)
    for d, h in zip(dev, host, strict=True):
        assert d.dtype == h.dtype
        np.testing.assert_array_equal(d.numpy(), h.numpy())
    return dev


def _same_as_jax(port, ref):
    X, Y, ok, rounds = port
    Xj, Yj, okj, rj = ref
    assert bool(ok) == okj and int(rounds) == rj
    np.testing.assert_allclose(X.numpy(), Xj, rtol=0, atol=ATOL)
    np.testing.assert_allclose(Y.numpy(), Yj, rtol=0, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [2, 5, 8, 16])
def test_device_form_matches_jax_and_the_host_loop(k, seed, monkeypatch):
    LHS, RHS, Xinit = _problem(k, 150, seed)
    port = _both_forms(LHS, RHS, Xinit, monkeypatch)
    ref = _jax(LHS, RHS, Xinit)
    _same_as_jax(port, ref)
    assert bool(port[2])
    # the cases pivot: the warm start is not optimal
    assert int(port[3]) > 0 or k == 2


def test_device_form_warm_start_needs_no_rounds(monkeypatch):
    LHS, RHS, Xinit = _problem(6, 60, 3)
    X, _, ok, rounds = _both_forms(LHS, RHS, Xinit, monkeypatch)
    assert bool(ok) and int(rounds) > 0
    port = _both_forms(LHS, RHS, X.numpy(), monkeypatch)
    assert bool(port[2]) and int(port[3]) == 0
    _same_as_jax(port, _jax(LHS, RHS, X.numpy()))


def test_device_form_nonfinite_rhs_fails(monkeypatch):
    """An Inf in RHS (an f32 overflow upstream): ok is false, as in JAX,
    after the same rounds."""
    k, n = 4, 12
    rng = np.random.RandomState(0)
    B = rng.rand(k, 3 * k)
    LHS = B @ B.T + 0.1 * np.eye(k)
    RHS = B @ rng.rand(3 * k, n)
    RHS[1, 3] = np.inf
    Xinit = rng.rand(k, n)
    X, Y, ok, rounds = _both_forms(LHS, RHS, Xinit, monkeypatch)
    Xj, Yj, okj, rj = _jax(LHS, RHS, Xinit)
    assert not bool(ok) and not okj and int(rounds) == rj
    np.testing.assert_allclose(X.numpy(), Xj, rtol=0, atol=ATOL)
    np.testing.assert_allclose(Y.numpy(), Yj, rtol=0, atol=ATOL)


@pytest.mark.parametrize("cap", [1, 2])
def test_device_form_strangled_cap_fails_as_jax(cap, monkeypatch):
    """With the rounds capped at 1 or 2, short of what the problem needs,
    the loop stops at the cap with ok false, as JAX's does when its
    while_loop is capped the same."""
    LHS, RHS, Xinit = _problem(8, 150, 1)
    monkeypatch.setattr(tnnls, "SELECT_ROUNDS", False)
    full = tnnls.nnls_blockpivot(*(torch.from_numpy(a)
                                   for a in (LHS, RHS, Xinit)))
    assert int(full[3]) > cap
    monkeypatch.setattr(tnnls, "_round_cap", lambda k: cap)
    port = _both_forms(LHS, RHS, Xinit, monkeypatch)
    while_loop = jax.lax.while_loop

    def capped(cond, body, init):
        return while_loop(lambda c: cond(c) & (c[8] < cap), body, init)

    monkeypatch.setattr(jax.lax, "while_loop", capped)
    ref = _jax(LHS, RHS, Xinit)
    assert not bool(port[2]) and not ref[2] and int(port[3]) == cap
    _same_as_jax(port, ref)


class _HostReads(TorchDispatchMode):
    """Raises on every op that brings a tensor's value to the host."""

    READS = (torch.ops.aten._local_scalar_dense, torch.ops.aten.is_nonzero,
             torch.ops.aten.nonzero)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in self.READS:
            raise AssertionError(f"host read: {func}")
        return func(*args, **(kwargs or {}))


def _bpp_problem(seed=3, m=40, n=30, k=5):
    rng = np.random.RandomState(seed)
    A = rng.rand(m, k) @ rng.rand(k, n) + 0.01 * rng.rand(m, n)
    return (DenseAOp(torch.from_numpy(A)), torch.from_numpy(rng.rand(m, k)),
            torch.from_numpy(rng.rand(k, n)))


@pytest.mark.parametrize("device_form", [True, False])
def test_a_bpp_step_in_the_device_form_reads_nothing(device_form,
                                                     monkeypatch):
    """A whole BPP step, both NNLS sides and the rebalance, runs under a
    dispatch mode that refuses host reads in the device form; the host
    loop, which reads each round's test, is caught by the same mode."""
    a_op, W, H = _bpp_problem()
    st = bpp.init(a_op, W, H)
    monkeypatch.setattr(tnnls, "SELECT_ROUNDS", device_form)
    if device_form:
        with _HostReads():
            W1, H1, _, _, st1, ok = bpp.step(a_op, W, H, st)
        monkeypatch.setattr(tnnls, "SELECT_ROUNDS", False)
        W2, H2, _, _, st2, ok2 = bpp.step(a_op, W, H, st)
        assert torch.equal(W1, W2) and torch.equal(H1, H2)
        assert bool(ok) and bool(ok2)
        assert int(st1.pivot_rounds) == int(st2.pivot_rounds) > 0
    else:
        with pytest.raises(AssertionError, match="host read"), _HostReads():
            bpp.step(a_op, W, H, st)


def test_bpp_step_counts_rounds_on_the_device(monkeypatch):
    """pivot_rounds is a tensor of the state; rounds_run, the card's count
    of every round run, grows by the same rounds."""
    a_op, W, H = _bpp_problem()
    bpp.reset_rounds_run()
    st = bpp.init(a_op, W, H)
    assert isinstance(st.pivot_rounds, torch.Tensor)
    before = bpp.rounds_run()
    W1, H1, _, _, st, _ = bpp.step(a_op, W, H, st)
    _, _, _, _, st, _ = bpp.step(a_op, W1, H1, st)
    assert bpp.rounds_run() - before == int(st.pivot_rounds) > 0


class _Fake:
    """A factor of a given shape on a given device kind."""

    def __init__(self, shape, cuda=True):
        self.shape, self.is_cuda = shape, cuda

    def numel(self):
        return self.shape[0] * self.shape[1]


class _Sharded:
    sharded = True


def _factors(m, n, k, cuda=True):
    return _Fake((m, k), cuda), _Fake((k, n), cuda)


def _applies(m, n, k, unroll=8, cuda=True, a_op=UNSHARDED):
    W, H = _factors(m, n, k, cuda)
    return graph.applies(BPP, W, unroll, a_op, H)


def test_bpp_capture_rule(monkeypatch):
    """BPP is captured at U > 1 on the card; not at U = 1, not on the CPU,
    not on a sharded operand, not where a side's rounds narrow
    (k * max(m, n) >= _NARROW_MIN_ENTRIES), not above K1's MAX_K (the CG
    tier), not above BPP_CAPTURE_MAX_K, not with CG forced."""
    monkeypatch.setattr(graph, "CAPTURE", True)
    reuters = (12411, 7984, 8)
    assert _applies(*reuters) and _applies(*reuters, unroll=2)
    assert not _applies(*reuters, unroll=1)
    assert not _applies(*reuters, cuda=False)
    assert not _applies(*reuters, a_op=_Sharded())
    wide = tnnls._NARROW_MIN_ENTRIES // 8
    assert _applies(wide - 1, 10, 8) and _applies(10, wide - 1, 8)
    assert not _applies(wide, 10, 8) and not _applies(10, wide, 8)
    monkeypatch.setattr(graph, "BPP_CAPTURE_MAX_K", 10 ** 6)
    assert _applies(500, 400, masked_gj.MAX_K)
    assert not _applies(500, 400, masked_gj.MAX_K + 1)
    monkeypatch.setattr(graph, "BPP_CAPTURE_MAX_K", 4)
    assert _applies(500, 400, 4) and not _applies(500, 400, 5)
    monkeypatch.setattr(graph, "BPP_CAPTURE_MAX_K", 10 ** 6)
    monkeypatch.setattr(tnnls, "MASKED_SOLVER", "cg")
    assert not _applies(*reuters)
    monkeypatch.setattr(tnnls, "MASKED_SOLVER", "auto")
    monkeypatch.setattr(graph, "CAPTURE", False)
    assert not _applies(*reuters)


def test_bpp_auto_unroll(monkeypatch):
    """0 is auto: BPP's card value where it is captured, 1 where its pivot
    loops read the host and on the CPU."""
    opts = topt.NmfOptions(algorithm=BPP, k=8, verbose=False)
    W, H = _factors(12411, 7984, 8)
    assert solve.auto_unroll(opts, W, H) == solve.AUTO_UNROLL[BPP] > 1
    assert solve.auto_unroll(opts, *_factors(12411, 7984, 8, False)) == 1
    monkeypatch.setattr(graph, "BPP_CAPTURE_MAX_K", 4)
    assert solve.auto_unroll(opts, W, H) == 1
    monkeypatch.setattr(graph, "BPP_CAPTURE_MAX_K", 10 ** 6)
    wide = tnnls._NARROW_MIN_ENTRIES // 8
    assert solve.auto_unroll(opts, *_factors(10, wide, 8)) == 1


# ---------------------------------------------------------------- the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from smallk_torch.common.device import setup
    return setup("cuda")


# the card's problem converges at this iteration, a block's middle at U = 8
CARD_FIXED = 21


def _card_problem(dev, unroll):
    """A dense f32 problem of the main path's kind at k = 8, to a tol that
    it meets at iteration CARD_FIXED: the PG ratio there in a fixed run,
    with checks from there on."""
    rng = np.random.RandomState(11)
    m, n, k = 3000, 2000, 8
    A = rng.rand(m, k) @ rng.rand(k, n) + 0.1 * rng.rand(m, n)
    a_op = DenseAOp(torch.tensor(A, dtype=torch.float32, device=dev))
    W0 = torch.tensor(rng.rand(m, k), dtype=torch.float32, device=dev)
    H0 = torch.tensor(rng.rand(k, n), dtype=torch.float32, device=dev)
    opts = topt.NmfOptions(height=m, width=n, k=k, algorithm=BPP, tol=1e-30,
                           min_iter=1, max_iter=CARD_FIXED, verbose=False,
                           loop_unroll=1)
    tol = float(solve.nmf_solve(a_op, W0, H0, opts).metric)
    opts = dataclasses.replace(opts, tol=tol, min_iter=CARD_FIXED - 1,
                               max_iter=4 * CARD_FIXED, loop_unroll=unroll)
    return a_op, W0, H0, opts


def _card_run(a_op, W0, H0, opts, capture, monkeypatch):
    monkeypatch.setattr(graph, "CAPTURE", capture)
    for mod, name in graph.counters():
        monkeypatch.setattr(mod, name, 0)
    monkeypatch.setattr(solve, "steps_run", 0)
    monkeypatch.setattr(graph, "captures", 0)
    bpp.reset_rounds_run()
    r = solve.nmf_solve(a_op, W0, H0, opts)
    torch.cuda.synchronize()
    return r, {"K1": masked_gj.launches, "K1 columns": masked_gj.columns,
               "steps": solve.steps_run, "rounds run": bpp.rounds_run(),
               "graphs": graph.captures}


@pytest.mark.cuda
def test_captured_bpp_equals_eager_on_the_card(monkeypatch):
    """BPP captured at U = 8, its pivot rounds in IF nodes, bit for bit
    BPP eager at U = 8 and at U = 1 (W, H, metric, iterations, pivot
    rounds), with K1 counted exactly: 2 a step run and one a round run,
    the same captured and eager."""
    dev = _card()
    a_op, W0, H0, opts = _card_problem(dev, 8)
    runs = {}
    for label, unroll, capture in (("eager 8", 8, False),
                                   ("captured 8", 8, True),
                                   ("eager 1", 1, False)):
        runs[label] = _card_run(a_op, W0, H0, dataclasses.replace(
            opts, loop_unroll=unroll), capture, monkeypatch)
    (e, ce), (c, cc), (e1, ce1) = runs.values()
    assert cc["graphs"] == 1 and ce["graphs"] == ce1["graphs"] == 0
    for r in (e, e1):
        assert torch.equal(c.W, r.W) and torch.equal(c.H, r.H)
        assert (c.iterations, c.converged, c.success, c.pivot_rounds) == (
            r.iterations, r.converged, r.success, r.pivot_rounds)
        assert c.metric.tobytes() == r.metric.tobytes()
    assert c.success and c.converged and c.iterations == CARD_FIXED
    assert cc["steps"] > c.iterations  # frozen steps ran, and counted
    assert {**cc, "graphs": 0} == ce
    for counts in (cc, ce1):
        assert counts["K1"] == 2 * counts["steps"] + counts["rounds run"]
        assert counts["rounds run"] > 0
    assert ce1["rounds run"] == c.pivot_rounds


@pytest.mark.cuda
def test_a_host_read_in_a_pivot_round_makes_capture_raise(monkeypatch):
    """A round that reads the host cannot be captured: the solve raises,
    it does not run the loop eagerly instead."""
    dev = _card()
    a_op, W0, H0, opts = _card_problem(dev, 8)
    real = tnnls._pivot_cols

    def reading(*args):
        out = real(*args)
        bool(out[2].any())   # a host read
        return out

    monkeypatch.setattr(tnnls, "_pivot_cols", reading)
    monkeypatch.setattr(graph, "CAPTURE", True)
    with pytest.raises(RuntimeError):
        solve.nmf_solve(a_op, W0, H0, opts)
    torch.cuda.synchronize()
    # the card still works, its random generator too, and the eager loop
    # runs the same rounds
    assert torch.rand(4, device=dev).shape == (4,)
    monkeypatch.setattr(graph, "CAPTURE", False)
    assert solve.nmf_solve(a_op, W0, H0, opts).iterations > 1
