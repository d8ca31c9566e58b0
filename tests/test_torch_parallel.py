"""The port's sharded solve (smallk_torch/parallel) against the JAX
package's (smallk_tpu/parallel, GSPMD on the conftest's 8 virtual CPU
devices) and against the port's unsharded solve: f64 on the CPU, the
port's ranks real processes over gloo (tests/torch_dist_worker.py), one
spawn a mesh shape.  The counterpart of tests/test_parallel.py.

Several ranks must equal one to the JAX package's own tolerances (rtol
1e-10, atol 1e-12; the CG tier 1e-6, 1e-8); a mesh of one rank must be
bit-equal to the unsharded solve (an all-reduce over one rank is a copy).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import smallk_tpu.common.options as jopt
import smallk_tpu.solvers.nnls as jnnls
import torch_dist_worker as w
from smallk_tpu.ops.aop import DenseAOp as JDenseAOp
from smallk_tpu.ops.aop import SparseAOp as JSparseAOp
from smallk_tpu.ops.ell import EllAOp as JEllAOp
from smallk_tpu.parallel.mesh import make_mesh as jmake_mesh
from smallk_tpu.parallel.mesh import sharded_nmf_solve as jsharded_nmf_solve
from smallk_torch.common import options as topt
from smallk_torch.engines.embeddings import EmbeddingTable, NmfEmbeddings
from smallk_torch.ops.aop import as_aop
from smallk_torch.parallel import mesh as pm
from smallk_torch.solvers import nnls
from smallk_torch.solvers.solve import nmf_solve

torch.set_num_threads(1)

TOL = dict(rtol=1e-10, atol=1e-12)
CG_TOL = dict(rtol=1e-6, atol=1e-8)
SHAPES = [(1, 2), (2, 1), (2, 2)]
CASES = ("dense", "algorithms", "coo", "ell", "cg", "narrow", "host_matrix",
         "embeddings")
ALGS = ("MU", "HALS", "BPP", "RANK2")


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def ranks(request, tmp_path_factory):
    """(shape, every rank's results): one spawn a mesh shape; the (2, 2)
    ranks join their world from torchrun's environment variables."""
    shape = request.param
    out = tmp_path_factory.mktemp(f"mesh{shape[0]}x{shape[1]}")
    return shape, w.spawn(shape, CASES, out, env=shape == (2, 2))


def _jax_mesh(shape):
    return jmake_mesh(shape, devices=jax.devices()[: shape[0] * shape[1]])


def _jopts(alg, m, n, k, **kw):
    return w.nmf_opts(jopt, alg, m, n, k, **kw)


def _port(A, W0, H0, opts, **aop_kw):
    """The port's unsharded solve on the CPU."""
    a = as_aop(A, opts.a_dtype or opts.dtype, device="cpu", **aop_kw)
    return nmf_solve(a, torch.from_numpy(np.array(W0)),
                     torch.from_numpy(np.array(H0)), opts)


def _same(got, ref, iterations=None, tol=TOL):
    """got (the port's sharded result arrays under `prefix`) against a
    SolveResult of either package."""
    np.testing.assert_allclose(got["W"], np.asarray(ref.W), **tol)
    np.testing.assert_allclose(got["H"], np.asarray(ref.H), **tol)
    if iterations is not None:
        assert int(got["iterations"]) == int(ref.iterations) == iterations


def _case(results, case, rank=0, prefix=""):
    head = f"{case}/{prefix}"
    return {k[len(head):]: v for k, v in results[rank].items()
            if k.startswith(head)}


def test_sharded_matches_jax_and_single_device(ranks):
    """Dense BPP (test_parallel.py::test_sharded_matches_single_device):
    the port's mesh, the JAX package's mesh of the same shape, and the
    port's unsharded solve."""
    shape, res = ranks
    A, W0, H0 = w.dense_problem()
    got = _case(res, "dense")
    ref = _port(A, W0, H0, w.nmf_opts(topt, "BPP", 64, 48, 4))
    jref = jsharded_nmf_solve(JDenseAOp(jnp.asarray(A)), jnp.asarray(W0),
                              jnp.asarray(H0), _jopts("BPP", 64, 48, 4),
                              _jax_mesh(shape))
    _same(got, ref, int(jref.iterations))
    _same(got, jref)
    assert int(got["pivot_rounds"]) == int(ref.pivot_rounds)
    # every rank holds the same full factors, bit for bit
    for r in res[1:]:
        np.testing.assert_array_equal(r["dense/W"], got["W"])
        np.testing.assert_array_equal(r["dense/H"], got["H"])


@pytest.mark.parametrize("alg", ALGS)
def test_all_algorithms_shard(ranks, alg):
    shape, res = ranks
    k = 2 if alg == "RANK2" else 4
    A, W0, H0 = w.dense_problem()
    W0, H0 = W0[:, :k], H0[:k]
    got = _case(res, "algorithms", prefix=f"{alg}.")
    assert bool(got["success"])
    ref = _port(A, W0, H0, w.nmf_opts(topt, alg, 64, 48, k))
    jref = jsharded_nmf_solve(JDenseAOp(jnp.asarray(A)), jnp.asarray(W0),
                              jnp.asarray(H0), _jopts(alg, 64, 48, k),
                              _jax_mesh(shape))
    _same(got, ref, int(jref.iterations))
    _same(got, jref)


def test_sparse_operand_shards(ranks):
    """A SparseAOp block a rank (dual-sorted COO)."""
    shape, res = ranks
    A = w.sparse_problem(64, 48, 0.2, 0)
    W0, H0 = w.dense_problem(64, 48, 4, 1)[1:]
    got = _case(res, "coo")
    assert str(got["kind"]) == "SparseAOp"
    opts = w.nmf_opts(topt, "MU", 64, 48, 4, max_iter=30)
    ref = _port(A, W0, H0, opts, densify_threshold_bytes=0,
                sparse_format="coo")
    jref = jsharded_nmf_solve(JSparseAOp.from_scipy(A, jnp.float64),
                              jnp.asarray(W0), jnp.asarray(H0),
                              _jopts("MU", 64, 48, 4, max_iter=30),
                              _jax_mesh(shape))
    _same(got, ref, int(jref.iterations))
    _same(got, jref)


def test_ell_operand_shards(ranks):
    """An EllAOp block a rank, against the JAX package's per-bucket
    sharding (which needs its buckets padded to the mesh)."""
    shape, res = ranks
    A = w.sparse_problem(96, 80, 0.12, 5)
    _, W0, H0 = w.dense_problem(96, 80, 4, 2)
    got = _case(res, "ell")
    assert str(got["kind"]) == "EllAOp"
    opts = w.nmf_opts(topt, "BPP", 96, 80, 4)
    ref = _port(A, W0, H0, opts, densify_threshold_bytes=0)
    jop = JEllAOp.from_scipy(A, dtype=jnp.float64, pad_multiple=max(shape))
    jref = jsharded_nmf_solve(jop, jnp.asarray(W0), jnp.asarray(H0),
                              _jopts("BPP", 96, 80, 4), _jax_mesh(shape))
    _same(got, ref, int(jref.iterations))
    _same(got, jref)


def test_ell_operand_of_any_shape_shards(ranks):
    """What the JAX package refuses without padding
    (test_ell_shard_requires_padding): a prebuilt EllAOp of a shape no
    axis divides shards by its host matrix into unpadded blocks."""
    shape, res = ranks
    B = w.sparse_problem(41, 31, 0.2, 6)
    _, W1, H1 = w.dense_problem(41, 31, 3, 7)
    opts = w.nmf_opts(topt, "MU", 41, 31, 3, max_iter=20)
    ref = _port(B, W1, H1, opts, densify_threshold_bytes=0)
    for rank, r in enumerate(res):
        got = _case(res, "ell", rank, "odd.")
        assert str(got["kind"]) == "EllAOp"
        t, d = divmod(rank, shape[1])
        (r0, r1), (c0, c1) = (pm.block_bounds(41, shape[0], t),
                              pm.block_bounds(31, shape[1], d))
        assert tuple(got["shape"]) == (r1 - r0, c1 - c0)
        _same(got, ref, 20)


def test_cg_solve_tier_shards(ranks):
    """BPP through the masked CG tier: iterative, so residual-level
    parity."""
    shape, res = ranks
    A, W0, H0 = w.dense_problem(96, 64, 8, 0)
    got = _case(res, "cg")
    assert bool(got["success"])
    opts = w.nmf_opts(topt, "BPP", 96, 64, 8)
    nnls.set_masked_solver("cg")
    jnnls.set_masked_solver("cg")
    try:
        ref = _port(A, W0, H0, opts)
        jref = jsharded_nmf_solve(JDenseAOp(jnp.asarray(A)),
                                  jnp.asarray(W0), jnp.asarray(H0),
                                  _jopts("BPP", 96, 64, 8), _jax_mesh(shape))
    finally:
        nnls.set_masked_solver("auto")
        jnnls.set_masked_solver("auto")
    _same(got, ref, int(jref.iterations), CG_TOL)
    _same(got, jref, tol=CG_TOL)


def test_narrowed_rounds_shard(ranks, monkeypatch):
    """Narrowed pivot rounds (only the non-optimal columns solved): every
    rank runs the same rounds, those with no column left solve nothing."""
    shape, res = ranks
    A, W0, H0 = w.dense_problem(64, 48, 4, 3)
    monkeypatch.setattr(nnls, "_NARROW_MIN_ENTRIES", 1)
    ref = _port(A, W0, H0, w.nmf_opts(topt, "BPP", 64, 48, 4))
    got = _case(res, "narrow")
    _same(got, ref, int(ref.iterations))
    assert int(got["pivot_rounds"]) == int(ref.pivot_rounds)


def test_block_layout(ranks):
    """Rank (t, d) holds A's rows and columns of np.array_split's t-th and
    d-th blocks (tests/test_parallel.py::test_shardings_layout,
    test_shard_operand_dense): the blocks tile A once; a matrix too small
    to give every rank a row and a column is refused on every rank."""
    shape, res = ranks
    A = w.dense_problem()[0]
    seen = np.zeros(A.shape, dtype=int)
    for rank, r in enumerate(res):
        r0, r1, c0, c1 = r["dense/bounds"]
        t, d = divmod(rank, shape[1])
        rows = np.array_split(np.arange(64), shape[0])[t]
        cols = np.array_split(np.arange(48), shape[1])[d]
        assert (r0, r1, c0, c1) == (rows[0], rows[-1] + 1, cols[0],
                                    cols[-1] + 1)
        assert str(r["dense/kind"]) == "DenseAOp"
        np.testing.assert_array_equal(r["dense/block"], A[r0:r1, c0:c1])
        seen[r0:r1, c0:c1] += 1
        assert bool(r["dense/tiny_refused"])
    assert (seen == 1).all()


def test_replicated_blocks_are_bit_identical(ranks):
    """W's block is held by every rank of a terms row and H's by every rank
    of a docs column: bit for bit the same, and each is its slice of the
    gathered factor."""
    shape, res = ranks
    T, D = shape
    for rank, r in enumerate(res):
        t, d = divmod(rank, D)
        r0, r1, c0, c1 = r["dense/bounds"]
        np.testing.assert_array_equal(r["dense/W_local"],
                                      res[t * D]["dense/W_local"])
        np.testing.assert_array_equal(r["dense/H_local"],
                                      res[d]["dense/H_local"])
        np.testing.assert_array_equal(r["dense/W_local"], r["dense/W"][r0:r1])
        np.testing.assert_array_equal(r["dense/H_local"],
                                      r["dense/H"][:, c0:c1])


def test_host_matrix_ranks_match_single(ranks):
    """The multi-process worker of the JAX package (scripts/dist_worker.py,
    test_two_process_distributed_matches_single): each process moves only
    its block of the host matrix; the (2, 2) ranks joined their world from
    the launcher's variables."""
    shape, res = ranks
    A, W0, H0 = w.dense_problem(64, 96, 8, 42)
    opts = w.nmf_opts(topt, "BPP", 64, 96, 8, tol=1e-30, min_iter=1,
                      max_iter=30)
    ref = _port(A, W0, H0, opts)
    for rank, r in enumerate(res):
        got = _case(res, "host_matrix", rank)
        assert bool(got["success"]) and str(got["kind"]) == "DenseAOp"
        assert int(got["count"]) == shape[0] * shape[1]
        assert bool(got["coordinator"]) == (rank == 0)
        _same(got, ref)


def test_embeddings_shard(ranks):
    """Row-sharded tables give the unsharded top-k: the same indices,
    ties to the lower one, and values; the saved file holds the whole
    tables."""
    shape, res = ranks
    _, W, H = w.dense_problem(40, 37, 5, 9)
    W[3] = W[5]
    emb = NmfEmbeddings(W, H, device="cpu")
    want = {}
    for t in range(5):
        want[f"docs{t}"] = emb.top_docs_for_topic(t, 7)
        want[f"terms{t}"] = emb.top_terms_for_topic(t, 7)
    want["similar"] = emb.similar_docs(4, 6)
    q = np.zeros(40)
    q[[1, 7, 30]] = 1.0
    want["search"] = emb.search(q, 5)
    want["by_docs"] = EmbeddingTable(H.T, device="cpu").topk_cosine(H.T[:3],
                                                                   4)
    for rank in range(len(res)):
        got = _case(res, "embeddings", rank)
        for key, (idx, vals) in want.items():
            np.testing.assert_array_equal(got[key], idx, err_msg=key)
            np.testing.assert_allclose(got[f"{key}.v"], vals, rtol=1e-6,
                                       err_msg=key)
        np.testing.assert_array_equal(got["saved_W"], W)
        np.testing.assert_array_equal(got["saved_Ht"], H.T)
    # the tie: terms 3 and 5 hold the same row, the lower index first
    idx = want["terms0"][0]
    if 3 in idx and 5 in idx:
        assert list(idx).index(3) < list(idx).index(5)


@pytest.fixture
def world_of_one():
    """A mesh of one rank in this process (gloo on the CPU), left after
    the test."""
    mesh = pm.make_mesh((1, 1), device="cpu")
    yield mesh
    mesh.close()
    assert not torch.distributed.is_initialized()


def _bits(a, b):
    return torch.equal(a, b) and a.dtype == b.dtype


@pytest.mark.parametrize("alg", ALGS)
@pytest.mark.parametrize("kind", ["dense", "ell"])
def test_one_rank_mesh_is_bit_equal(world_of_one, alg, kind):
    """A mesh of one rank runs the unsharded ops and all-reduces over one
    rank: W, H, the iterations and the pivot rounds bit-equal."""
    k = 2 if alg == "RANK2" else 4
    A, W0, H0 = w.dense_problem(64, 48, k, 5)
    kw = {}
    if kind == "ell":
        A, kw = w.sparse_problem(64, 48, 0.15, 8), dict(
            densify_threshold_bytes=0)
    opts = w.nmf_opts(topt, alg, 64, 48, k)
    ref = _port(A, W0, H0, opts, **kw)
    op = pm.shard_operand(A, world_of_one, torch.float64, **kw)
    got = pm.sharded_nmf_solve(op, W0, H0, opts, world_of_one)
    assert _bits(got.W, ref.W) and _bits(got.H, ref.H)
    assert (got.iterations, got.pivot_rounds) == (ref.iterations,
                                                  ref.pivot_rounds)


def test_one_rank_mesh_cli(world_of_one, tmp_path):
    """`--mesh 1x1` inside a world of one: the files of the unsharded run
    (f32 on the CPU); a mesh of another size exits 2."""
    from smallk_tpu.io.matrix_market import write_matrix_market
    from smallk_torch.cli.flatclust_cli import entry as flat_entry
    from smallk_torch.cli.hierclust_cli import entry as hier_entry

    A = w.blocks_problem(4)
    mtx, dic = str(tmp_path / "a.mtx"), str(tmp_path / "dict.txt")
    write_matrix_market(mtx, sp.coo_matrix(A))
    with open(dic, "w") as f:
        f.write("".join(f"t{i}\n" for i in range(64)))
    for entry, extra in ((flat_entry, ["--maxiter", "40"]),
                         (hier_entry, ["--flat", "1"])):
        files = {}
        for mesh in ("", "1x1"):
            out = tmp_path / f"{entry.__module__}{mesh}"
            out.mkdir()
            args = ["--matrixfile", mtx, "--dictfile", dic, "--clusters",
                    "3", "--outdir", str(out), "--verbose", "0", "--seed",
                    "2", "--device", "cpu", *extra]
            assert entry(args + (["--mesh", mesh] if mesh else [])) == 0
            files[mesh] = {p: (out / p).read_bytes()
                           for p in sorted(os.listdir(out))}
        assert files[""] == files["1x1"]
        assert entry(args + ["--mesh", "2x1"]) == 2
    # the CLI left the world the fixture joined
    assert torch.distributed.is_initialized()
