"""The multi-split chain (engines/hier_chain.py) against the port's own
sequential engine, and against the JAX package's chain.

The port of tests/test_hierclust.py's TestMultiSplitChain, with its bar:
under CHAIN = True a run gives the tree of the sequential engine
(CHAIN = False) on the same Random(seed), bit for bit (`_assert_identical`:
assignments, leaves, parents, docs, term indices, priorities and the solve
and iteration counts).  Random-mode trees cannot equal the reference's
(torch cannot draw threefry's numbers), so the port's chain is held to the
reference chain's NMI against the planted labels, within NMI_TOL = 0.02 on
the same corpus.

Each of the chain's bails is driven by a test: the unbalanced gate, a
child of <= 3 documents, a solver failure, a subset past the ladder and a
pop order the host tree does not share.  Both engines solve a dense
subset at its own bucket width, in the width's operand buffer with the
step graphs kept on it (hierclust.KEEP_GRAPHS); the trees do not depend on
that switch.  Tests marked `cuda` hold the same on the card (skipped
without one).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from smallk_torch.common.options import (
    ClustOptions,
    NmfAlgorithm,
    NmfOptions,
    NmfProgressAlgorithm,
)
from smallk_torch.common.rng import Random
from smallk_torch.engines import hier_chain
from smallk_torch.engines import hierclust as hc
from smallk_torch.engines.corpus import synthetic_term_doc_corpus
from smallk_torch.engines.hierclust import clust_hier
from smallk_torch.engines.scoring import nmi
from smallk_torch.solvers import solve as tsolve

torch.set_num_threads(1)

NMI_TOL = 0.02


def _opts(k, dtype="float64", **kw):
    return ClustOptions(
        nmf_opts=NmfOptions(
            tol=1e-4, algorithm=NmfAlgorithm.RANK2,
            prog_est_algorithm=NmfProgressAlgorithm.PG_RATIO,
            height=0, width=0, k=2, min_iter=1, max_iter=5000,
            verbose=False, dtype=dtype,
        ),
        num_clusters=k, verbose=False, **kw)


def _corpus(dtype=np.float64, m=700, n=1400, k=10, seed=5):
    A, labels = synthetic_term_doc_corpus(m, n, k, seed=seed)
    return np.asarray(A.todense()).astype(dtype), labels


def _planted(m=96, n=900, k=5, seed=4, noise=0.01):
    """tests/test_hierclust.py's _planted_matrix."""
    rng = np.random.RandomState(seed)
    A = noise * rng.rand(m, n)
    docs_per, terms_per = n // k, m // k
    for c in range(k):
        cols = slice(c * docs_per, (c + 1) * docs_per if c < k - 1 else n)
        rows = slice(c * terms_per, (c + 1) * terms_per)
        A[rows, cols] += 1.0 + rng.rand(rows.stop - rows.start,
                                        (cols.stop or n) - cols.start)
    return A


def _seq_vs_chain(A, opts, seed, seg, monkeypatch, device="cpu"):
    monkeypatch.setattr(hier_chain, "CHAIN", False)
    ref = clust_hier(A, opts, Random(seed), device=device)
    monkeypatch.setattr(hier_chain, "CHAIN", True)
    monkeypatch.setattr(hier_chain, "CHAIN_SEG", seg)
    return (*ref, *clust_hier(A, opts, Random(seed), device=device))


def _assert_identical(ref_tree, ref_stats, tree, stats):
    np.testing.assert_array_equal(tree.assignments, ref_tree.assignments)
    assert list(tree.is_leaf) == list(ref_tree.is_leaf)
    for q, (n1, n2) in enumerate(zip(tree.nodes, ref_tree.nodes)):
        assert n1.priority == n2.priority, f"node {q} priority"
        assert n1.pop_priority == n2.pop_priority, f"node {q} pop"
        assert n1.parent_index == n2.parent_index, f"node {q} parent"
        if n1.docs is not None or n2.docs is not None:
            np.testing.assert_array_equal(n1.docs, n2.docs,
                                          err_msg=f"node {q} docs")
        t1, t2 = n1.term_indices, n2.term_indices
        assert (t1 is None) == (t2 is None), f"node {q} terms"
        if t1 is not None:
            np.testing.assert_array_equal(t1, t2, err_msg=f"node {q} terms")
    assert stats.nmf_count == ref_stats.nmf_count
    assert stats.iter_count == ref_stats.iter_count
    assert stats.max_count == ref_stats.max_count


def _reference_chain_nmi(A, labels, k, seed):
    """NMI of the JAX package's chain (its default engine) on A."""
    from smallk_tpu.common.options import ClustOptions as JC
    from smallk_tpu.common.options import NmfAlgorithm as JA
    from smallk_tpu.common.options import NmfOptions as JN
    from smallk_tpu.common.options import NmfProgressAlgorithm as JP
    from smallk_tpu.common.rng import Random as JRandom
    from smallk_tpu.engines.hierclust import clust_hier as jclust_hier

    opts = JC(nmf_opts=JN(tol=1e-4, algorithm=JA.RANK2,
                          prog_est_algorithm=JP.PG_RATIO, height=0, width=0,
                          k=2, min_iter=1, max_iter=5000, verbose=False,
                          dtype=str(A.dtype)),
              num_clusters=k, verbose=False)
    tree, _ = jclust_hier(A, opts, JRandom(seed))
    return nmi(labels, tree.assignments)


@pytest.mark.parametrize("seg", [2, 32])
def test_bit_identical_clean_path(monkeypatch, seg):
    A, labels = _corpus()
    out = _seq_vs_chain(A, _opts(10), 21, seg, monkeypatch)
    _assert_identical(*out)
    # the chain carried the splits (nothing bailed); seg 2: 5 segments
    assert hier_chain.LAST_STATS["committed"] == 9
    assert hier_chain.LAST_STATS["bails"] == 0
    assert hier_chain.LAST_STATS["segments"] == -(-9 // seg)
    if seg == 32:
        mine = nmi(labels, out[2].assignments)
        ref = _reference_chain_nmi(A, labels, 10, 21)
        assert abs(mine - ref) <= NMI_TOL, (mine, ref)


def test_bit_identical_spectral(monkeypatch):
    A, _ = _corpus()
    opts = dataclasses.replace(_opts(10), init_method="spectral")
    _assert_identical(*_seq_vs_chain(A, opts, 21, 32, monkeypatch))
    assert hier_chain.LAST_STATS["committed"] >= 5


def test_bit_identical_f32(monkeypatch):
    A, labels = _corpus(np.float32)
    out = _seq_vs_chain(A, _opts(10, dtype="float32"), 21, 32, monkeypatch)
    _assert_identical(*out)
    assert hier_chain.LAST_STATS["committed"] >= 5
    mine = nmi(labels, out[2].assignments)
    ref = _reference_chain_nmi(A, labels, 10, 21)
    assert abs(mine - ref) <= NMI_TOL, (mine, ref)


def test_bail_on_outlier_gate_and_reentry(monkeypatch):
    """A tiny planted cluster and a high unbalanced threshold force
    TrialSplit's outlier branch: the chain bails, the sequential engine
    drops or recycles, the device state is rebuilt and the chain goes on;
    the tree is still the sequential one."""
    rng = np.random.RandomState(5)
    m, n = 300, 1400
    A = np.zeros((m, n))
    col = 0
    for c, sz in enumerate([650, 620, 130]):
        rows = slice(c * 100, (c + 1) * 100)
        block = rng.rand(100, sz) * (rng.rand(100, sz) < 0.25)
        block[0, :] += 0.5
        A[rows, col:col + sz] = block
        col += sz
    A += (np.random.RandomState(6).rand(m, n) < 0.02) * 0.1
    opts = dataclasses.replace(_opts(3), unbalanced=0.45, trial_allowance=2)
    out = _seq_vs_chain(A, opts, 7, 32, monkeypatch)
    _assert_identical(*out)
    assert out[1].nmf_count > 5  # trial retries happened
    assert hier_chain.LAST_BAILS.get("gate", 0) >= 1
    assert hier_chain.LAST_STATS["resyncs"] >= 2


def test_done_path(monkeypatch):
    """More clusters asked than leaves that split: the chain stops on the
    all-negative priorities where the sequential engine does."""
    rng = np.random.RandomState(2)
    m, n = 200, 900
    A = np.zeros((m, n))
    A[:100, :450] = rng.rand(100, 450) * (rng.rand(100, 450) < 0.25)
    A[100:, 450:] = rng.rand(100, 450) * (rng.rand(100, 450) < 0.25)
    A[0, :] += 0.5
    A[100, :] += 0.5
    opts = dataclasses.replace(_opts(8), unbalanced=0.45, trial_allowance=2)
    _assert_identical(*_seq_vs_chain(A, opts, 7, 3, monkeypatch))


def test_bail_on_small_children(monkeypatch):
    """Many clusters of a small corpus: children of <= 3 documents bail to
    the sequential engine, whose ActualSplit keeps them as leaves."""
    A, _ = _corpus(m=120, n=530, k=4, seed=2)
    out = _seq_vs_chain(A, _opts(20), 11, 32, monkeypatch)
    _assert_identical(*out)
    assert hier_chain.LAST_BAILS.get("small", 0) >= 1
    assert hier_chain.LAST_STATS["committed"] >= 1


def test_bail_on_subsets_past_the_ladder(monkeypatch):
    """A ladder of one rung (512): every pair wider than it bails, and the
    sequential engine solves it at its exact width."""
    A, _ = _corpus()
    monkeypatch.setattr(hc, "BUCKET_POW2_MAX", 512)
    monkeypatch.setattr(hc, "BUCKET_STEP", 10 ** 6)
    assert hc.bucket_widths(1400) == (512,)
    out = _seq_vs_chain(A, _opts(10), 21, 32, monkeypatch)
    _assert_identical(*out)
    assert hier_chain.LAST_BAILS.get("wide", 0) >= 1
    assert hier_chain.LAST_STATS["committed"] >= 1


def test_bail_on_a_pop_the_host_does_not_share(monkeypatch):
    """The device pops the second-best leaf once: the replay stops at that
    split, the stream goes back to its start, and the sequential engine
    takes it; the tree is still the sequential one."""
    A, _ = _corpus()
    real, calls = hier_chain.ChainDriver._pop, []

    def wrong_once(self):
        calls.append(1)
        if len(calls) != 4:
            return real(self)
        best = torch.argmax(torch.where(self.leaf, self.pop, -torch.inf))
        saved = self.pop[best].clone()
        self.pop[best] = -torch.inf
        try:
            return real(self)
        finally:
            self.pop[best] = saved

    monkeypatch.setattr(hier_chain.ChainDriver, "_pop", wrong_once)
    out = _seq_vs_chain(A, _opts(10), 21, 32, monkeypatch)
    _assert_identical(*out)
    assert hier_chain.LAST_BAILS.get("pop", 0) == 1


def test_chain_ineligible_paths_fall_back(monkeypatch, tmp_path):
    """initdir, the test interrupt hook and a sparse operand without its
    host matrix (no chunk table) run the sequential engine; checkpointing,
    the dense default, spectral init and a sparse operand with its host
    matrix run the chain."""
    A = _planted(m=96, n=1400, k=6, seed=3)
    opts = _opts(6)
    calls = []
    real = hier_chain.ChainDriver.run_segment

    def spy(self, *a, **kw):
        calls.append(1)
        return real(self, *a, **kw)

    monkeypatch.setattr(hier_chain.ChainDriver, "run_segment", spy)
    clust_hier(A, opts, Random(21), device="cpu",
               checkpoint_path=str(tmp_path / "c.npz"))
    assert calls
    calls.clear()
    with pytest.raises(KeyboardInterrupt):
        clust_hier(A, opts, Random(21), device="cpu", _interrupt_after=2)
    assert calls == []
    clust_hier(A, dataclasses.replace(opts, init_method="spectral"),
               Random(21), device="cpu")
    assert calls
    calls.clear()

    import scipy.sparse as sp

    from smallk_torch.ops.aop import as_aop

    op = as_aop(sp.csc_matrix(A), device="cpu", densify_threshold_bytes=0)
    clust_hier(op, opts, Random(21), device="cpu")
    assert calls == []
    clust_hier(op, opts, Random(21), device="cpu", host_A=sp.csc_matrix(A))
    assert calls
    calls.clear()

    d = tmp_path / "init"
    d.mkdir()
    from smallk_torch.io.delimited import write_delimited

    rng = np.random.RandomState(0)
    for q in range(1, 40):
        write_delimited(str(d / f"Winit_{q}.csv"), rng.rand(96, 2), 15)
        write_delimited(str(d / f"Hinit_{q}.csv"), rng.rand(2, 1400), 15)
    clust_hier(A, dataclasses.replace(opts, initdir=str(d)), Random(21),
               device="cpu")
    assert calls == []


@pytest.mark.parametrize("keep", [True, False],
                         ids=["kept_graphs", "graph_a_solve"])
def test_root_runs_once_and_children_in_the_chain(monkeypatch, keep):
    """On the clean path the host's node solve runs for the root only;
    every child is solved in the chain, one after another, each at its own
    bucket width, in that width's kept buffer (KEEP_GRAPHS) or in a tensor
    of its own."""
    A, _ = _corpus()
    monkeypatch.setattr(hc, "KEEP_GRAPHS", keep)
    real, subsets = hc._Rank2Runner.solve, []
    real_op, operands = hc._Rank2Runner.dense_operand, []

    def spy(self, subset=None, *a, **kw):
        subsets.append(subset)
        return real(self, subset, *a, **kw)

    def spy_op(self, idx, width):
        op, graphs = real_op(self, idx, width)
        operands.append((idx.shape[0], width, op, graphs))
        return op, graphs

    monkeypatch.setattr(hc._Rank2Runner, "solve", spy)
    monkeypatch.setattr(hc._Rank2Runner, "dense_operand", spy_op)
    tree, stats = clust_hier(A, _opts(8), Random(21), device="cpu")
    assert subsets == [None]
    assert int(np.sum(tree.is_leaf)) == 8
    assert stats.nmf_count == 15  # root + 7 pairs of children
    assert len(operands) == 14
    for size, width, op, graphs in operands:
        assert width == hc.bucket_width(size, A.shape[1])
        assert op.shape == (A.shape[0], width)
        assert (graphs is not None) == keep
    if keep:  # one buffer a width, shared by every subset of that width
        for width in {w for _, w, _, _ in operands}:
            assert len({id(op.A) for _, w, op, _ in operands
                        if w == width}) == 1


def test_dense_operand_pads_and_reuses_the_width_buffer(monkeypatch):
    """dense_operand gathers the subset's columns, then zero columns to the
    width; with KEEP_GRAPHS into one buffer and one graph dict a width,
    without into a tensor of its own and no graphs; an exact width (None)
    keeps nothing."""
    A = np.arange(1.0, 1.0 + 12 * 40).reshape(12, 40)
    runner = hc._Rank2Runner(hc.as_aop(A, "float64", device="cpu"),
                             _opts(4), hc._InitializerSource(
                                 12, 40, Random(1), None), hc.ClustStats(),
                             torch.float64)
    idx = torch.tensor([3, 7, 1])
    for keep in (True, False):
        monkeypatch.setattr(hc, "KEEP_GRAPHS", keep)
        op, graphs = runner.dense_operand(idx, 8)
        np.testing.assert_array_equal(op.A[:, :3].numpy(), A[:, [3, 7, 1]])
        assert not op.A[:, 3:].any()
        op2, graphs2 = runner.dense_operand(torch.tensor([0, 2]), 8)
        assert (op2.A.data_ptr() == op.A.data_ptr()) == keep
        if keep:
            assert graphs is not None and graphs2 is graphs
        else:
            assert graphs is None and graphs2 is None
        op3, graphs3 = runner.dense_operand(idx, None)
        assert op3.shape == (12, 3) and graphs3 is None
    runner.close()
    assert runner.slots == {}


def test_kept_graphs_solve_equals_a_solve_of_its_own():
    """nmf_solve with a graph dict on the CPU captures nothing and gives
    the bits of a solve without one."""
    g = torch.Generator().manual_seed(3)
    m, w = 80, 96
    A = hc.DenseAOp(torch.rand((m, w), generator=g, dtype=torch.float64))
    W0 = torch.rand((m, 2), generator=g, dtype=torch.float64)
    H0 = torch.rand((2, w), generator=g, dtype=torch.float64)
    opts = NmfOptions(tol=1e-4, algorithm=NmfAlgorithm.RANK2, height=m,
                      width=w, k=2, max_iter=800, verbose=False,
                      dtype="float64")
    graphs = {}
    kept = tsolve.nmf_solve(A, W0, H0, opts, graphs=graphs)
    own = tsolve.nmf_solve(A, W0, H0, opts)
    assert graphs == {}
    assert kept.iterations == own.iterations
    assert torch.equal(kept.W, own.W) and torch.equal(kept.H, own.H)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_bit_identical_graph_options(monkeypatch, dtype):
    """size_ndcg pop policy and best-of-R restarts (the graph preset) run
    through the chain and stay bit-identical."""
    A, _ = _corpus(np.float64 if dtype == "float64" else np.float32)
    opts = dataclasses.replace(_opts(10, dtype=dtype),
                               priority_method="size_ndcg", restarts=3)
    _assert_identical(*_seq_vs_chain(A, opts, 21, 32, monkeypatch))
    assert hier_chain.LAST_STATS["committed"] >= 5


@pytest.mark.parametrize("leaf", [False, True], ids=["raise", "leaf"])
def test_on_node_failure_under_the_chain(monkeypatch, leaf):
    """Every child's solve fails (in the chain and in the host's retry
    ladder): the chain bails, and the sequential engine raises or,
    with on_node_failure="leaf", keeps both root children as leaves."""
    A = _planted(m=96, n=1400, k=5, seed=4)
    opts = dataclasses.replace(_opts(5),
                               on_node_failure="leaf" if leaf else "abort")
    real = hc._Rank2Runner.solve

    def failing_solve(self, subset=None, *a, **kw):
        if subset is None:
            return real(self, subset, *a, **kw)
        return hc._NodeSolve(None, None, None, -1.0, False)

    def failing_single(*a, **kw):
        W, H, _, iters = hc._solve_from_draw(*a, **kw)
        return W, H, False, iters

    monkeypatch.setattr(hc._Rank2Runner, "solve", failing_solve)
    # the chain's children fail too
    monkeypatch.setattr(hier_chain, "_solve_from_draw", failing_single)
    if not leaf:
        with pytest.raises(RuntimeError):
            clust_hier(A, opts, Random(3), device="cpu")
        assert hier_chain.LAST_BAILS == {"failed": 1}
        return
    tree, _ = clust_hier(A, opts, Random(3), device="cpu")
    leaves = [q for q, lf in enumerate(tree.is_leaf) if lf]
    assert len(leaves) == 2
    assert all(tree.nodes[q].priority == -2.0 for q in leaves)
    assert (tree.assignments >= 0).all()
    assert hier_chain.LAST_BAILS["failed"] >= 1


def test_chain_checkpoint_resume(monkeypatch, tmp_path):
    """Checkpoints at segment granularity: a run cut in its third segment
    and resumed gives the run that was never cut."""
    A, _ = _corpus()
    opts = _opts(10)
    monkeypatch.setattr(hier_chain, "CHAIN_SEG", 4)
    ref_tree, ref_stats = clust_hier(A, opts, Random(21), device="cpu")

    ckpt = str(tmp_path / "chain.ckpt")
    calls = {"n": 0}
    real = hier_chain.ChainDriver.run_segment

    def interrupting(self, *a, **kw):
        calls["n"] += 1
        if calls["n"] == 3:
            raise KeyboardInterrupt("test interrupt")
        return real(self, *a, **kw)

    monkeypatch.setattr(hier_chain.ChainDriver, "run_segment", interrupting)
    with pytest.raises(KeyboardInterrupt):
        clust_hier(A, opts, Random(21), device="cpu", checkpoint_path=ckpt)
    monkeypatch.setattr(hier_chain.ChainDriver, "run_segment", real)
    assert os.path.exists(ckpt)
    with np.load(ckpt) as z:
        assert int(z["i_next"]) == 8  # two segments of 4 splits
    tree, stats = clust_hier(A, opts, Random(21), device="cpu",
                             checkpoint_path=ckpt)
    _assert_identical(ref_tree, ref_stats, tree, stats)


@pytest.mark.cuda
@pytest.mark.parametrize("keep", [True, False],
                         ids=["kept_graphs", "graph_a_solve"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_cuda_chain_equals_sequential(monkeypatch, dtype, keep):
    """On the card: the chain's tree is the sequential engine's (f64: the
    products through cuBLAS; f32: K3), with KEEP_GRAPHS one graph captured
    a bucket width in each run, without it one a solve."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from smallk_torch.solvers import graph

    A, _ = _corpus(np.float64 if dtype == "float64" else np.float32,
                   m=2000, n=3000, k=12, seed=7)
    monkeypatch.setattr(hc, "KEEP_GRAPHS", keep)
    real, widths = graph.StepGraph.__init__, []

    def spy(self, step, carry):
        widths.append(carry.H.shape[1])
        real(self, step, carry)

    monkeypatch.setattr(graph.StepGraph, "__init__", spy)
    runs = []
    for chain in (False, True):
        monkeypatch.setattr(hier_chain, "CHAIN", chain)
        widths.clear()
        runs.append(clust_hier(A, _opts(12, dtype=dtype), Random(21),
                               device="cuda"))
        buckets = [w for w in widths if w in hc.bucket_widths(3000)]
        assert buckets
        if keep:
            assert len(buckets) == len(set(buckets))
        else:
            assert len(buckets) > len(set(buckets))
    _assert_identical(*runs[0], *runs[1])
    assert hier_chain.LAST_STATS["committed"] >= 8


@pytest.mark.parametrize("variant", ["random", "spectral", "restarts",
                                     "size_ndcg_f32"])
def test_kept_graphs_switch_keeps_the_tree(monkeypatch, variant):
    """The chain with KEEP_GRAPHS off (each subset in a tensor of its own)
    against the sequential engine with it on (the widths' buffers): still
    one tree."""
    dtype = "float32" if variant.endswith("f32") else "float64"
    A, _ = _corpus(np.float32 if dtype == "float32" else np.float64)
    opts = _opts(10, dtype=dtype)
    if variant == "spectral":
        opts = dataclasses.replace(opts, init_method="spectral")
    elif variant == "restarts":
        opts = dataclasses.replace(opts, restarts=3)
    elif variant.startswith("size_ndcg"):
        opts = dataclasses.replace(opts, priority_method="size_ndcg")
    monkeypatch.setattr(hier_chain, "CHAIN", False)
    ref = clust_hier(A, opts, Random(21), device="cpu")
    monkeypatch.setattr(hc, "KEEP_GRAPHS", False)
    monkeypatch.setattr(hier_chain, "CHAIN", True)
    _assert_identical(*ref, *clust_hier(A, opts, Random(21), device="cpu"))
    assert hier_chain.LAST_STATS["committed"] == 9
