"""Sparse hierclust on the chunk table's static operand (engines/
hierclust.py, engines/hier_chain.py, ops/ell_cols.ChunkColsAOp): the bucket
ladder and the chunk tier against the JAX package's, and the chain's
sparse and masked branches against the port's own sequential engine.

The bar of tests/test_torch_hier_chain.py: under CHAIN = True a sparse run
gives the tree of the sequential engine (CHAIN = False) on the same
Random(seed), bit for bit, whichever tier each child takes (the chunk
width's static operand, or the masked view past MASKED_SHARE).  Random
mode cannot reproduce the reference's threefry draws, so the port's sparse
chain is held to the JAX package's sparse chain by NMI against the planted
labels, within NMI_TOL = 0.02 on the same corpus.  Tests marked `cuda`
hold the same on the card (skipped without one)."""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from smallk_tpu.engines import hierclust as jhc
from smallk_tpu.ops.ell_cols import CscChunks as JCscChunks
from smallk_torch.common.rng import Random
from smallk_torch.engines import hier_chain
from smallk_torch.engines import hierclust as hc
from smallk_torch.engines.corpus import synthetic_term_doc_corpus
from smallk_torch.engines.scoring import nmi
from smallk_torch.kernels import seg_spmm as smod
from smallk_torch.ops.aop import EllAOp, MaskedAOp, as_aop
from smallk_torch.ops.ell_cols import ChunkColsAOp, CscChunks
from test_torch_hier_chain import _assert_identical, _opts

torch.set_num_threads(1)

NMI_TOL = 0.02


def _sparse(m=700, n=1400, k=10, seed=5, dtype=np.float64):
    A, labels = synthetic_term_doc_corpus(m, n, k, seed=seed)
    return sp.csc_matrix(A, dtype=dtype), labels


def _seq_vs_chain(A, opts, seed, monkeypatch, device="cpu"):
    """The sequential engine's run and the chain's on the sparse operand
    of A (host matrix given: the chunk table)."""
    dt = opts.nmf_opts.dtype
    op = as_aop(A, dt, device=device, densify_threshold_bytes=0)
    runs = []
    for chain in (False, True):
        monkeypatch.setattr(hier_chain, "CHAIN", chain)
        runs.append(hc.clust_hier(op, opts, Random(seed), host_A=A,
                                  device=device))
    return (*runs[0], *runs[1])


@pytest.mark.parametrize("n", [600, 4096, 5000, 8192, 16384, 16385, 30000,
                               100_000, 262_144, 1_000_000, 2_000_000])
def test_ladder_matches_reference(n):
    """The rungs below n and the rung at or above a size are the
    reference's (powers of two to 4096, then steps of about 12.5% past
    16384)."""
    assert hc.bucket_widths(n) == jhc._bucket_widths(n)
    for size in (1, 513, n // 3 + 1, n - 1, n, n + 1):
        assert hc.bucket_for(size) == jhc._bucket_for(size)
        want = jhc._bucket_for(size)
        assert hc.bucket_width(size, n) == (want if want < n else None)


@pytest.mark.parametrize("share", [0.5, None])
def test_chunk_width_matches_reference_tier(share, monkeypatch):
    """The width of a sparse subset (the rung at or above its chunks and
    its documents) and its tier: at MASKED_SHARE = 0.5 the reference's
    _chunk_bucket, subset for subset; at the port's own MASKED_SHARE the
    same widths, masked from that share of the table's chunks up."""
    A, _ = _sparse(m=300, n=9000, k=6, seed=3)
    if share is not None:
        monkeypatch.setattr(hc, "MASKED_SHARE", share)
    jchunks = JCscChunks.from_scipy(A, dtype=jnp.float64)
    fake = types.SimpleNamespace(_A_chunks=jchunks, _budget=None)
    op = as_aop(A, "float64", device="cpu", densify_threshold_bytes=0)
    runner = hc._Rank2Runner(
        op, _opts(4), hc._InitializerSource(300, 9000, Random(1), None),
        hc.ClustStats(), torch.float64,
        chunks=CscChunks.from_scipy(A, torch.float64, device="cpu"))
    rng = np.random.RandomState(0)
    tiers = set()
    for size in (5, 300, 1000, 2500, 4000, 4600, 6000, 8999):
        sub = np.sort(rng.choice(9000, size, replace=False))
        count = runner.chunks.subset_chunk_count(sub)
        got = runner.chunk_width(size, count)
        wc = jhc._bucket_for(max(size, count))
        assert got in (None, wc)
        assert (got is None) == (wc >= hc.MASKED_SHARE * (jchunks.C + 1))
        if share is not None:
            assert got == jhc._Rank2Runner._chunk_bucket(fake, sub)
        tiers.add(got is None)
    if share is not None:
        assert tiers == {True, False}  # both tiers reached
    assert runner.chunk_width(9000, jchunks.C, root=True) == \
        jhc._bucket_for(max(9000, jchunks.C))


@pytest.mark.parametrize("variant", ["random", "spectral", "restarts",
                                     "size_ndcg", "masked", "graph_a_solve"])
def test_sparse_chain_equals_sequential(variant, monkeypatch):
    """f64: the chain's tree is the sequential engine's, every child on
    its chunk width's static operand (masked: every child on the masked
    view, MASKED_SHARE = 0), with kept graphs or without them, the root on
    the static operand."""
    A, labels = _sparse()
    opts = _opts(10)
    if variant == "spectral":
        opts = dataclasses.replace(opts, init_method="spectral")
    elif variant == "restarts":
        opts = dataclasses.replace(opts, restarts=3)
    elif variant == "size_ndcg":
        opts = dataclasses.replace(opts, priority_method="size_ndcg")
    elif variant == "masked":
        monkeypatch.setattr(hc, "MASKED_SHARE", 0.0)
    elif variant == "graph_a_solve":
        monkeypatch.setattr(hc, "KEEP_GRAPHS", False)
    hc.gathered_operands = hc.masked_operands = 0
    out = _seq_vs_chain(A, opts, 21, monkeypatch)
    _assert_identical(*out)
    assert hier_chain.LAST_STATS["committed"] >= 5
    assert hier_chain.LAST_STATS["bails"] <= 1
    if variant == "masked":
        assert hc.masked_operands > 0
    else:
        assert hc.gathered_operands > 0
    assert nmi(labels, out[2].assignments) > 0.9


def test_sparse_chain_nmi_matches_jax_sparse_chain(monkeypatch):
    """The port's sparse chain against the JAX package's (its chunk-
    gathered chain, its default engine on a sparse operand with its host
    matrix) on the same planted corpus: NMI within NMI_TOL."""
    from smallk_tpu.common.options import ClustOptions as JC
    from smallk_tpu.common.options import NmfAlgorithm as JA
    from smallk_tpu.common.options import NmfOptions as JN
    from smallk_tpu.common.options import NmfProgressAlgorithm as JP
    from smallk_tpu.common.rng import Random as JRandom
    from smallk_tpu.ops.ell import EllAOp as JEllAOp

    A, labels = _sparse(m=500, n=1200, k=8, seed=9)
    jopts = JC(nmf_opts=JN(tol=1e-4, algorithm=JA.RANK2,
                           prog_est_algorithm=JP.PG_RATIO, height=0, width=0,
                           k=2, min_iter=1, max_iter=5000, verbose=False,
                           dtype="float64"),
               num_clusters=8, verbose=False)
    jtree, _ = jhc.clust_hier(JEllAOp.from_scipy(A, dtype=np.float64), jopts,
                              JRandom(21), host_A=A)
    out = _seq_vs_chain(A, _opts(8), 21, monkeypatch)
    _assert_identical(*out)
    mine, ref = nmi(labels, out[2].assignments), nmi(labels,
                                                    jtree.assignments)
    assert abs(mine - ref) <= NMI_TOL, (mine, ref)


@pytest.mark.parametrize("keep", [True, False],
                         ids=["kept_graphs", "graph_a_solve"])
def test_sparse_children_solve_at_their_chunk_width(monkeypatch, keep):
    """Every sparse child solves on the static operand of its chunk width
    (the rung at or above its chunks and documents): with KEEP_GRAPHS in
    that width's one buffer with its kept graphs, without in buffers of
    its own; the root on the full-width static operand."""
    A, _ = _sparse()
    monkeypatch.setattr(hc, "KEEP_GRAPHS", keep)
    real, operands = hc._Rank2Runner.sparse_operand, []
    ops = []

    def spy(self, plan, width):
        op, graphs = real(self, plan, width)
        docs = int((torch.as_tensor(plan[0]) < self.n).sum())
        chunks = int((torch.as_tensor(plan[1]) < self.chunks.C).sum())
        operands.append((docs, chunks, width, op, graphs))
        return op, graphs

    real_solve = hc.nmf_solve

    def spy_solve(op, *a, **kw):
        ops.append(type(op))
        return real_solve(op, *a, **kw)

    monkeypatch.setattr(hc._Rank2Runner, "sparse_operand", spy)
    monkeypatch.setattr(hc, "nmf_solve", spy_solve)
    op = as_aop(A, "float64", device="cpu", densify_threshold_bytes=0)
    tree, stats = hc.clust_hier(op, _opts(8), Random(21), host_A=A,
                                device="cpu")
    assert ops[0] is ChunkColsAOp and operands[0][2] == hc.bucket_for(
        max(A.shape[1], operands[0][1]))
    assert all(t in (ChunkColsAOp, MaskedAOp) for t in ops)
    for docs, chunks, width, o, graphs in operands[1:]:
        assert width == hc.bucket_for(max(docs, chunks))
        assert o.shape == (A.shape[0], width)
        assert (graphs is not None) == keep
    if keep:
        for width in {w for _, _, w, _, _ in operands}:
            assert len({id(o) for _, _, w, o, _ in operands
                        if w == width}) == 1
    assert int(np.sum(tree.is_leaf)) == 8


@pytest.mark.parametrize("host_a", [True, False])
def test_root_routing(host_a, monkeypatch):
    """The root of a sparse A solves on the full-width static operand when
    the run has the chunk table (its host matrix given), and on the
    bucketed-ELL operand when it has none."""
    A, _ = _sparse(m=300, n=600, k=4, seed=2)
    op = as_aop(A, "float64", device="cpu", densify_threshold_bytes=0)
    first = []
    real = hc.nmf_solve

    def spy(o, *a, **kw):
        first.append(type(o))
        return real(o, *a, **kw)

    monkeypatch.setattr(hc, "nmf_solve", spy)
    hc.clust_hier(op, _opts(3), Random(5), host_A=A if host_a else None,
                  device="cpu")
    assert first[0] is (ChunkColsAOp if host_a else EllAOp)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_cuda_sparse_chain_equals_sequential(monkeypatch, dtype):
    """On the card: the sparse chain's tree is the sequential engine's,
    every static operand product through seg_spmm (none through its plain
    version), one graph kept a chunk width."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from smallk_torch.solvers import graph

    A, _ = _sparse(m=2000, n=6000, k=12, seed=7,
                   dtype=np.float64 if dtype == "float64" else np.float32)
    before = (smod.launches, smod.plain_cuda_calls, graph.captures)
    out = _seq_vs_chain(A, _opts(12, dtype=dtype), 21, monkeypatch,
                        device="cuda")
    _assert_identical(*out)
    assert hier_chain.LAST_STATS["committed"] >= 8
    assert smod.launches - before[0] >= 2 * out[1].iter_count
    assert smod.plain_cuda_calls == before[1]
    assert graph.captures > before[2]
