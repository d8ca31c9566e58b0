"""BPP's pivot loop in its device form (smallk_torch/solvers/nnls.py)
against the JAX package's nnls_blockpivot (f64, the CPU) and the port's
host loop; a whole BPP step in the device form with no host read; the
rule by which a BPP solve is captured (solvers/graph.py) and its auto U;
and, on the card (tests marked `cuda`), BPP captured as a CUDA graph, its
pivot loops (and above K1's rank limit its CG loops) in conditional WHILE
nodes, against the same loop run eagerly.

On the CPU the device form runs through the test-only select form
(nnls.SELECT_ROUNDS): every round up to the cap runs and is kept only
where its test holds, which is the JAX while_loop's semantics; and
through WhileNode, a stand-in for the WHILE node that runs the loops'
bodies under HostReads, a dispatch mode that refuses every host read but
the node's own of its handle between trips (tests/test_torch_cg_loop.py
uses both for the CG loop).

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


class HostReads(TorchDispatchMode):
    """Raises on every op that brings a tensor's value to the host, while
    `allowed` is false."""

    READS = (torch.ops.aten._local_scalar_dense, torch.ops.aten.is_nonzero,
             torch.ops.aten.nonzero)
    allowed = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in self.READS and not self.allowed:
            raise AssertionError(f"host read: {func}")
        return func(*args, **(kwargs or {}))


class WhileNode:
    """graph.while_loop(live, step, c) as the WHILE node runs it: `step`
    written into the carry's tensors, then the handle set from `live`, read
    between trips and nothing else read (under `mode`, a HostReads);
    `trips`, the trips of each loop it ran, in the order the loops ended
    (an inner loop before the loop whose body holds it)."""

    def __init__(self, mode: HostReads):
        self.mode = mode
        self.trips = []

    def _handle(self, pred) -> bool:
        """The node's read of its handle, which the set kernel wrote from
        `pred`."""
        assert pred.dtype == torch.bool and pred.numel() == 1
        self.mode.allowed = True
        try:
            return bool(pred)
        finally:
            self.mode.allowed = False

    def __call__(self, live, step, c):
        trips = 0
        while self._handle(live(c)):
            for dst, src in zip(c, step(c), strict=True):
                dst.copy_(src)
            trips += 1
        self.trips.append(trips)
        return c


def stand_in(monkeypatch, mode: HostReads) -> WhileNode:
    """Make the loops take their device form through a WhileNode, as in a
    captured step."""
    node = WhileNode(mode)
    monkeypatch.setattr(graph, "capturing", lambda: True)
    monkeypatch.setattr(graph, "while_loop", node)
    return node


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
        with HostReads():
            W1, H1, _, _, st1, ok = bpp.step(a_op, W, H, st)
        monkeypatch.setattr(tnnls, "SELECT_ROUNDS", False)
        W2, H2, _, _, st2, ok2 = bpp.step(a_op, W, H, st)
        assert torch.equal(W1, W2) and torch.equal(H1, H2)
        assert bool(ok) and bool(ok2)
        assert int(st1.pivot_rounds) == int(st2.pivot_rounds) > 0
    else:
        with pytest.raises(AssertionError, match="host read"), HostReads():
            bpp.step(a_op, W, H, st)


@pytest.mark.parametrize("solver", ["auto", "cg"])
def test_a_bpp_step_on_a_while_node_reads_nothing(solver, monkeypatch):
    """A whole BPP step with its pivot loops (and, with CG forced, every
    solve's CG loop, inside a pivot loop's body where a round solves) on
    the stand-in WHILE node: nothing read from the host but the node's
    handle between trips, and the host loops' bits, pivot rounds and CG
    steps; the pivot loops' trips are the rounds."""
    a_op, W, H = _bpp_problem()
    st = bpp.init(a_op, W, H)
    monkeypatch.setattr(tnnls, "MASKED_SOLVER", solver)
    monkeypatch.setattr(tnnls, "cg_steps", 0)
    W2, H2, gW2, gH2, st2, ok2 = bpp.step(a_op, W, H, st)
    host_steps = tnnls.cg_steps
    monkeypatch.setattr(tnnls, "cg_steps", 0)
    mode = HostReads()
    node = stand_in(monkeypatch, mode)
    with mode:
        W1, H1, gW1, gH1, st1, ok = bpp.step(a_op, W, H, st)
    for a, b in ((W1, W2), (H1, H2), (gW1, gW2), (gH1, gH2)):
        assert torch.equal(a, b)
    assert bool(ok) and bool(ok2)
    rounds = int(st1.pivot_rounds)
    assert rounds == int(st2.pivot_rounds) > 0
    if solver == "auto":
        assert node.trips and sum(node.trips) == rounds
        assert tnnls.cg_steps == host_steps == 0
    else:
        # the H side's first solve, its pivot loop with a CG loop a round,
        # then the W side's; the host form's checks run past the last step
        assert len(node.trips) == 2 + 2 + rounds
        assert tnnls.cg_steps == sum(node.trips) - rounds > 0
        assert tnnls.cg_steps <= host_steps


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
    (k * max(m, n) >= _NARROW_MIN_ENTRIES); at every rank otherwise, the
    CG tier's above K1's MAX_K too, and with CG forced: their CG loops are
    WHILE nodes, as the pivot loops are."""
    monkeypatch.setattr(graph, "CAPTURE", True)
    reuters = (12411, 7984, 8)
    assert _applies(*reuters) and _applies(*reuters, unroll=2)
    assert not _applies(*reuters, unroll=1)
    assert not _applies(*reuters, cuda=False)
    assert not _applies(*reuters, a_op=_Sharded())
    wide = tnnls._NARROW_MIN_ENTRIES // 8
    assert _applies(wide - 1, 10, 8) and _applies(10, wide - 1, 8)
    assert not _applies(wide, 10, 8) and not _applies(10, wide, 8)
    for k in (16, 32, 64, masked_gj.MAX_K, masked_gj.MAX_K + 1, 160):
        assert _applies(12411, 7984, k)
    wide = -(-tnnls._NARROW_MIN_ENTRIES // 160)
    assert _applies(wide - 1, 10, 160) and not _applies(wide, 10, 160)
    monkeypatch.setattr(tnnls, "MASKED_SOLVER", "cg")
    assert _applies(*reuters)
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
    assert solve.auto_unroll(opts, *_factors(12411, 7984, 160)) > 1
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
               "graphs": graph.captures, "CG solves": tnnls.cg_solves,
               "CG steps": tnnls.cg_steps}


@pytest.mark.cuda
def test_captured_bpp_equals_eager_on_the_card(monkeypatch):
    """BPP captured at U = 8, its pivot loops in WHILE nodes, bit for bit
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


def _f64_problem(dev, k, seed=5, m=600, n=500):
    """A dense f64 problem of full rank and a start at rank k (above K1's
    MAX_K, the CG tier's on the card; at k = 160 a low-rank A would give
    Grams so ill-conditioned that CG caps out and the step fails, eager
    and captured alike)."""
    rng = np.random.RandomState(seed)
    A = rng.rand(m, n)
    opts = topt.NmfOptions(height=m, width=n, k=k, algorithm=BPP, tol=1e-30,
                           min_iter=1, max_iter=10, verbose=False,
                           loop_unroll=4, dtype="float64")
    return (DenseAOp(torch.tensor(A, device=dev)),
            torch.tensor(rng.rand(m, k), device=dev),
            torch.tensor(rng.rand(k, n), device=dev), opts)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [8, 32, 160])
def test_captured_bpp_equals_eager_at_every_rank(k, monkeypatch):
    """f64 BPP captured at U = 4 bit for bit eager at k = 8 and 32 (K1's
    pivot rounds in WHILE nodes) and at k = 160 (the CG tier: each solve's
    CG loop a WHILE node, inside the pivot loop's body in a round), with
    the same launches, rounds run and CG solves; the CG steps captured
    are the reference's, which the eager form's 8-step checks overrun."""
    dev = _card()
    a_op, W0, H0, opts = _f64_problem(dev, k)
    e, ce = _card_run(a_op, W0, H0, opts, False, monkeypatch)
    c, cc = _card_run(a_op, W0, H0, opts, True, monkeypatch)
    assert cc["graphs"] == 1 and ce["graphs"] == 0
    assert torch.equal(c.W, e.W) and torch.equal(c.H, e.H)
    assert (c.iterations, c.success, c.pivot_rounds) == (
        e.iterations, e.success, e.pivot_rounds)
    assert c.success and c.iterations == opts.max_iter
    rest = ("graphs", "CG steps")
    assert {n: v for n, v in cc.items() if n not in rest} == {
        n: v for n, v in ce.items() if n not in rest}
    if k <= masked_gj.MAX_K:
        assert cc["K1"] == 2 * cc["steps"] + cc["rounds run"]
    else:
        assert cc["K1"] == 0
        assert cc["CG solves"] == 2 * cc["steps"] + cc["rounds run"]
        assert 0 < cc["CG steps"] <= ce["CG steps"]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [8, 160])
def test_one_graph_replayed_from_two_carries(k, monkeypatch):
    """One kept graph (nmf_solve's `graphs`, as hierclust keeps one a
    width) runs two solves from two starts, and each equals its eager
    solve bit for bit: the WHILE nodes' handles are set anew on every
    replay (a handle left at 0 by one replay's last trip would skip the
    next replay's loops)."""
    dev = _card()
    a_op, W0, H0, opts = _f64_problem(dev, k)
    rng = np.random.RandomState(99)
    starts = ((W0, H0), (torch.tensor(rng.rand(*W0.shape), device=dev),
                         torch.tensor(rng.rand(*H0.shape), device=dev)))
    monkeypatch.setattr(graph, "CAPTURE", True)
    graphs = {}
    try:
        kept = [solve.nmf_solve(a_op, W, H, opts, graphs=graphs)
                for W, H in starts]
    finally:
        for g in graphs.values():
            g.close()
    assert len(graphs) == 1
    monkeypatch.setattr(graph, "CAPTURE", False)
    for r, (W, H) in zip(kept, starts, strict=True):
        e = solve.nmf_solve(a_op, W, H, opts)
        assert torch.equal(r.W, e.W) and torch.equal(r.H, e.H)
        assert (r.iterations, r.pivot_rounds) == (e.iterations,
                                                  e.pivot_rounds)
    assert kept[0].pivot_rounds > 0 and not torch.equal(kept[0].W,
                                                        kept[1].W)
