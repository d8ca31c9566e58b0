"""Sharded hierarchical and flat clustering in the port against the JAX
package's sharded runs (on the conftest's virtual CPU mesh) and the port's
unsharded runs, f64 on the CPU, the port's ranks real processes over gloo
(tests/torch_dist_worker.py), one spawn a mesh shape.  The counterpart of
tests/test_parallel.py's hierclust, flatclust and checkpoint tests, and of
the JAX package's dryrun resume leg.

Initdir mode consumes the same initializer files in both packages, so the
port's sharded tree must be the JAX package's sharded tree.  Random mode
draws from the port's own generator, so there the port's sharded tree must
be its unsharded tree.  The entry points (the API, the facade, the
flatclust CLI) run on every rank; only the coordinator writes.
"""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import smallk_tpu.common.options as jopt
import torch_dist_worker as w
from smallk_tpu.common.rng import Random as JRandom
from smallk_tpu.engines.hierclust import clust_hier as jclust_hier
from smallk_tpu.io.matrix_market import write_matrix_market
from smallk_tpu.parallel.mesh import make_mesh as jmake_mesh
from smallk_torch import api
from smallk_torch.common import options as topt
from smallk_torch.common.rng import Random
from smallk_torch.engines.flatclust import run_flatclust, run_hier_nmf2
from smallk_torch.engines.hierclust import clust_hier
from smallk_torch.ops.ell import EllAOp
from test_hier_oracle import _planted_sparse, _write_initdir

torch.set_num_threads(1)

SHAPES = [(1, 2), (2, 1), (2, 2)]
# every shape runs the trees; the (2, 2) mesh also the rest (a collective
# over gloo costs ~1 ms on a loopback, so the ranks' cases are few)
TREE_CASES = ("hier_initdir", "hier_random")
MESH22_CASES = ("hier_ell", "hier_flat", "hier_checkpoint", "entry_points",
                "hier_restarts")
PRIORITY_TOL = dict(rtol=1e-10, atol=1e-12)
FLAT_TOL = dict(rtol=1e-8, atol=1e-10)   # test_parallel.py's


def _inputs(tmp):
    """The planted matrix and initializer files of the initdir case, and
    the CLI's files."""
    A, _ = _planted_sparse(48, 72, [24, 18, 16, 14], seed=3)
    np.savez(tmp / "planted.npz", A=A)
    initdir = tmp / "init"
    initdir.mkdir()
    _write_initdir(initdir, 48, 72, 60, seed=11)
    mtx, dic = tmp / "a.mtx", tmp / "dict.txt"
    write_matrix_market(str(mtx), sp.coo_matrix(w.blocks_problem(4)))
    dic.write_text("".join(f"t{i}\n" for i in range(64)))
    return {"planted": str(tmp / "planted.npz"), "initdir": str(initdir),
            "mtx": str(mtx), "dict": str(dic)}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return _inputs(tmp_path_factory.mktemp("inputs"))


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def ranks(request, inputs, tmp_path_factory):
    shape = request.param
    out = tmp_path_factory.mktemp(f"hier{shape[0]}x{shape[1]}")
    return shape, w.spawn(shape, TREE_CASES, out, inputs), out


@pytest.fixture(scope="module")
def ranks22(inputs, tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh2x2")
    return (2, 2), w.spawn((2, 2), MESH22_CASES, out, inputs), out


def _record(results, case, rank=0, prefix=""):
    head = f"{case}/{prefix}"
    return {k[len(head):]: v for k, v in results[rank].items()
            if k.startswith(head)}


def _same_tree(got: dict, want: dict) -> None:
    """Structure, documents, assignments and top terms equal; priorities
    to 1e-10 (f64, other summation orders)."""
    for key in ("structure", "is_leaf", "docs", "docs_offsets",
                "assignments", "leaf_terms"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["priority"], want["priority"],
                               **PRIORITY_TOL)


def _every_rank(res, case, want):
    for rank in range(len(res)):
        _same_tree(_record(res, case, rank), want)


def test_initdir_tree_matches_jax_sharded(ranks, inputs):
    """test_parallel.py::test_hierclust_sharded_matches_single_device in
    initdir mode: the port's tree on its mesh is the JAX package's on a
    mesh of the same shape, and its unsharded tree."""
    shape, res, _ = ranks
    A = np.load(inputs["planted"])["A"]
    jmesh = jmake_mesh(shape, devices=jax.devices()[: shape[0] * shape[1]])
    jtree, jstats = jclust_hier(A, w.clust_opts(jopt, 4, inputs["initdir"]),
                                JRandom(7), mesh=jmesh)
    want = w.tree_record(jtree)
    _every_rank(res, "hier_initdir", want)
    assert int(_record(res, "hier_initdir")["nmf_count"]) == jstats.nmf_count
    tree, _ = clust_hier(A, w.clust_opts(topt, 4, inputs["initdir"]),
                         Random(7), device="cpu")
    _same_tree(w.tree_record(tree), want)


def test_random_tree_matches_unsharded(ranks):
    shape, res, _ = ranks
    tree, _ = clust_hier(w.blocks_problem(4), w.clust_opts(topt, 4),
                         Random(7), device="cpu")
    _every_rank(res, "hier_random", w.tree_record(tree))


def test_restarts_tree_matches_unsharded(ranks22):
    """Best-of-3 restarts, each node one solve of 3 lanes on the masked
    view of the rank's block: every rank's tree is the unsharded one."""
    _, res, _ = ranks22
    tree, _ = clust_hier(*w.restarts_problem(topt), Random(7), device="cpu")
    _every_rank(res, "hier_restarts", w.tree_record(tree))


def test_ell_operand_tree_matches_unsharded(ranks22):
    """A prebuilt EllAOp with its host matrix
    (test_hierclust_sharded_ell_operand)."""
    shape, res, _ = ranks22
    A = w.blocks_problem(12)
    tree, _ = clust_hier(EllAOp.from_scipy(A, dtype=torch.float64,
                                           device="cpu"),
                         w.clust_opts(topt, 4), Random(7), host_A=A,
                         device="cpu")
    _every_rank(res, "hier_ell", w.tree_record(tree))


def test_flatclust_and_refinement_shard(ranks22):
    """run_hier_nmf2 with the flat refinement (NNLS-HALS on the sharded
    operand) and run_flatclust BPP, against the unsharded runs."""
    shape, res, _ = ranks22
    A = w.blocks_problem(9)
    tree, _, flat = run_hier_nmf2(A, w.clust_opts(topt, 4, flat=True),
                                  Random(3), device="cpu")
    rng = np.random.RandomState(9)
    W0, H0 = rng.rand(64, 4), rng.rand(4, 48)
    Wr, Hr, ar, fr, okr = run_flatclust(
        A, W0, H0, w.nmf_opts(topt, "BPP", 64, 48, 4, max_iter=100),
        device="cpu")
    assert okr
    for rank in range(len(res)):
        got = _record(res, "hier_flat", rank)
        _same_tree(got, w.tree_record(tree))
        np.testing.assert_allclose(got["flat.W"], flat["W"], **FLAT_TOL)
        np.testing.assert_allclose(got["flat.H"], flat["H"], **FLAT_TOL)
        np.testing.assert_array_equal(got["flat.assignments"],
                                      flat["assignments"])
        assert bool(got["flat.success"]) == bool(flat["success"])
        assert bool(got["fc.ok"])
        np.testing.assert_allclose(got["fc.W"], Wr, **FLAT_TOL)
        np.testing.assert_allclose(got["fc.H"], Hr, **FLAT_TOL)
        np.testing.assert_array_equal(got["fc.assign"], ar)


def test_entry_points_shard_and_coordinator_writes(ranks22):
    """mesh= through api.Hierclust, api.Flatclust, the facade's
    HierNmf2WithFlat and the flatclust CLI's --mesh: the same results on
    every rank, files from the coordinator alone; a --mesh whose size is
    not the world's exits 2."""
    shape, res, _ = ranks22
    hc = api.Hierclust(device="cpu")
    hc.seed(1)
    hc.load_matrix(matrix=w.blocks_problem(4))
    hc.cluster(4, verbose=False, dtype="float64", max_iter=100)
    first = _record(res, "entry_points")
    for rank in range(len(res)):
        got = _record(res, "entry_points", rank)
        np.testing.assert_array_equal(got["api.assignments"],
                                      hc.get_assignments())
        np.testing.assert_array_equal(got["fc.W"], first["fc.W"])
        assert int(got["cli.rc"]) == 0 and int(got["cli.bad_rc"]) == 2
        written = rank == 0
        assert (len(got["api.files"]) > 0) == written
        assert (len(got["facade.files"]) > 0) == written
        assert (len(got["cli.files"]) > 0) == written
    assert sorted(first["api.files"]) == ["assignments_4.csv", "tree_4.xml"]
    assert "assignments_flat_4.csv" in first["facade.files"]
    assert sorted(first["cli.files"]) == [
        "assignments_3.csv", "assignments_fuzzy_3.csv", "clusters_3.xml"]


def test_checkpoint_resume_on_mesh(ranks22):
    """Interrupted after one split and resumed from the checkpoint on a
    (2, 2) mesh (the coordinator wrote it, every rank read it): the
    uninterrupted sharded tree, on every rank."""
    shape, res, _ = ranks22
    for rank in range(len(res)):
        got = _record(res, "hier_checkpoint", rank)
        assert bool(got["written"])
        _same_tree(_record(res, "hier_checkpoint", rank, "resumed."),
                   _record(res, "hier_checkpoint", rank, "whole."))
    tree, _ = clust_hier(w.blocks_problem(4), w.clust_opts(topt, 4),
                         Random(7), device="cpu")
    _same_tree(_record(res, "hier_checkpoint", 0, "whole."),
               w.tree_record(tree))
