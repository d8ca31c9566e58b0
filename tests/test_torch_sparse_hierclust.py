"""Hierclust on a sparse operand (ROADMAP slices 11 and 14b-ii): the
bucketed-ELL operand and its chunk table, each node's static operand
gathered from the table on the device (ops/ell_cols.py), and the masked
full-width view (ops/aop.MaskedAOp) for initdir runs and a prebuilt operand
without its host matrix.  The sparse path is forced on small matrices by a
densify threshold of 0.

Initdir mode against the JAX package (its sparse operand takes the masked
view there too) and the numpy oracle tests/np_hierclust.py, in f64: the
same trees, priorities to 1e-10 (other summation orders).  Random mode:
the gathered, the masked and the dense tiers factor the same subsets from
the same draws, so their trees are equal.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from smallk_tpu.common.rng import Random as JRandom
from smallk_tpu.engines.hierclust import clust_flat as jclust_flat
from smallk_tpu.engines.hierclust import clust_hier as jclust_hier
from smallk_tpu.ops.ell import EllAOp as JEllAOp
from smallk_torch.common import options as topt
from smallk_torch.common.rng import Random
from smallk_torch.engines import flatclust as tflat
from smallk_torch.engines import hierclust as thc
from smallk_torch.interop import options_from_reference
from smallk_torch.kernels import ell_spmm as kmod
from smallk_torch.kernels import seg_spmm as smod
from smallk_torch.ops import aop as taop
from smallk_torch.ops.ell import EllAOp
from smallk_torch.ops.ell_cols import CscChunks
from np_hierclust import np_clust_hier
from test_hier_oracle import (
    _assert_trees_match,
    _clust_opts,
    _np_opts,
    _planted_sparse,
    _write_initdir,
)
from test_torch_hierclust import CASES, _assert_same_tree, _corpus, \
    _random_opts

torch.set_num_threads(1)

FLAT_TOL = dict(rtol=1e-8, atol=1e-9)


def _sparse_op(A, dtype=torch.float64, device="cpu"):
    return taop.as_aop(A, dtype, device=device, densify_threshold_bytes=0)


def _initdir_case(name, tmp_path):
    c = CASES[name]
    A, labels = _planted_sparse(c["m"], c["n"], c["sizes"], seed=c["seed"])
    initdir = _write_initdir(tmp_path, c["m"], c["n"], c["files"],
                             seed=c["init_seed"])
    jopts = _clust_opts(c["k"], initdir, unbalanced=c["unbalanced"],
                        trial_allowance=c["trial_allowance"])
    return sp.csc_matrix(A), jopts, c


@pytest.mark.parametrize("name", sorted(CASES))
def test_initdir_tree_matches_jax_and_numpy_oracle(name, tmp_path):
    """A prebuilt sparse operand with its host matrix, initdir: the masked
    tier, the JAX package's sparse run, the oracle and the port's dense run
    give one tree."""
    A, jopts, c = _initdir_case(name, tmp_path)
    jtree, jstats = jclust_hier(JEllAOp.from_scipy(A, dtype=np.float64),
                                jopts, JRandom(1), host_A=A)
    opts = options_from_reference(jopts)
    thc.masked_operands = thc.gathered_operands = 0
    tree, stats = thc.clust_hier(_sparse_op(A), opts, Random(1), host_A=A,
                                 device="cpu")
    assert thc.masked_operands > 0 and thc.gathered_operands == 0
    dtree, dstats = thc.clust_hier(A.toarray(), opts, Random(1),
                                   device="cpu")
    nptree, events = np_clust_hier(
        A.toarray(), _np_opts(c["k"], unbalanced=c["unbalanced"],
                              trial_allowance=c["trial_allowance"]),
        jopts.initdir)
    _assert_same_tree(tree, jtree)
    _assert_same_tree(tree, dtree)
    _assert_trees_match(tree, nptree)
    assert (stats.nmf_count, stats.iter_count) == (
        jstats.nmf_count, jstats.iter_count) == (
        dstats.nmf_count, dstats.iter_count) == (
        events["nmf_count"], events["iter_count"])


def test_scipy_input_above_the_threshold_clusters(monkeypatch):
    """A scipy matrix above the densify threshold (forced by a threshold
    of 0) becomes the EllAOp plus its chunk table, every node takes a
    static operand, and the tree is the dense run's."""
    A, _ = _corpus()
    A = sp.csc_matrix(A, dtype=np.float64)
    opts = _random_opts(topt, 6)
    dense, dstats = thc.clust_hier(A.toarray(), opts, Random(4),
                                   device="cpu")
    built = []

    def low_threshold(*args, **kw):
        op = taop.as_aop(*args, densify_threshold_bytes=0, **kw)
        built.append(type(op).__name__)
        return op

    monkeypatch.setattr(thc, "as_aop", low_threshold)
    thc.gathered_operands = thc.masked_operands = 0
    tree, stats = thc.clust_hier(A, opts, Random(4), device="cpu")
    assert built == ["EllAOp"]
    assert thc.gathered_operands > 0 and thc.masked_operands == 0
    np.testing.assert_array_equal(tree.assignments, dense.assignments)
    assert (stats.nmf_count, stats.iter_count) == (dstats.nmf_count,
                                                   dstats.iter_count)


@pytest.mark.parametrize("restarts", [1, 3])
def test_gathered_and_masked_tiers_give_the_same_tree(restarts):
    """Random mode: every node gathered (the host matrix given; the root's
    static operand too) against every node but the root on the masked view
    (a prebuilt operand with no host matrix has no chunks to gather from;
    its root solves on the EllAOp), the reference's
    test_chunk_matches_masked_path idea (tests/test_hierclust.py:883-903),
    here with equal trees: H is drawn at full width in both, and the masked
    columns never reach the solution."""
    A, _ = _corpus(seed=5)
    A = sp.csc_matrix(A, dtype=np.float64)
    op = _sparse_op(A)
    opts = _random_opts(topt, 5, restarts=restarts)
    runs = {}
    for tier, host in (("gathered", A), ("masked", None)):
        thc.gathered_operands = thc.masked_operands = 0
        tree, stats = thc.clust_hier(op, opts, Random(9), host_A=host,
                                     device="cpu")
        runs[tier] = (tree, stats, thc.gathered_operands,
                      thc.masked_operands)
    (t1, s1, g1, m1), (t0, s0, g0, m0) = runs["gathered"], runs["masked"]
    assert g1 > 0 and m1 == 0 and g0 == 0 and m0 == g1 - 1
    np.testing.assert_array_equal(t1.assignments, t0.assignments)
    assert (s1.nmf_count, s1.iter_count) == (s0.nmf_count, s0.iter_count)
    for a, b in zip(t1.nodes, t0.nodes):
        if a.is_valid:
            assert a.priority == pytest.approx(b.priority, rel=1e-9,
                                               abs=1e-12)


def test_prebuilt_operand_without_host_matrix_takes_the_masked_view():
    """A prebuilt EllAOp with no host matrix has no columns to gather
    from: every node solves on the masked view, and the tree is the dense
    run's."""
    A, _ = _corpus(seed=6)
    A = sp.csc_matrix(A, dtype=np.float64)
    opts = _random_opts(topt, 4)
    thc.gathered_operands = thc.masked_operands = 0
    tree, _ = thc.clust_hier(_sparse_op(A), opts, Random(2), device="cpu")
    assert thc.masked_operands > 0 and thc.gathered_operands == 0
    dense, _ = thc.clust_hier(A.toarray(), opts, Random(2), device="cpu")
    np.testing.assert_array_equal(tree.assignments, dense.assignments)


def test_clust_flat_on_a_sparse_operand_matches_jax(tmp_path):
    """clust_flat runs nnls_hals on the bucketed-ELL operand: its W and H
    equal the JAX package's on its sparse operand and the port's on the
    dense matrix (the same random H0 stream)."""
    A, jopts, _ = _initdir_case("four_clusters", tmp_path)
    jop = JEllAOp.from_scipy(A, dtype=np.float64)
    jtree, _ = jclust_hier(jop, jopts, JRandom(1), host_A=A)
    opts = options_from_reference(jopts)
    op = _sparse_op(A)
    tree, _ = thc.clust_hier(op, opts, Random(1), host_A=A, device="cpu")
    jW, jH, jok = jclust_flat(jop, jtree, jopts, JRandom(5))
    W, H, ok = thc.clust_flat(op, tree, opts, Random(5), device="cpu")
    dW, dH, dok = thc.clust_flat(A.toarray(), tree, opts, Random(5),
                                 device="cpu")
    assert ok and bool(jok) and dok
    for got, want in ((W, np.asarray(jW)), (H, np.asarray(jH)), (W, dW),
                      (H, dH)):
        np.testing.assert_allclose(got, want, **FLAT_TOL)


def test_run_hier_nmf2_builds_one_operand(monkeypatch):
    """run_hier_nmf2 on a matrix above the threshold builds the bucketed
    ELL and the chunk table once, for the tree and the flat refinement."""
    A, _ = _corpus(seed=8)
    A = sp.csc_matrix(A)
    builds = []
    ell_build, csc_build = EllAOp.from_scipy.__func__, \
        CscChunks.from_scipy.__func__

    def count(kind, build):
        def wrapped(cls, *args, **kw):
            builds.append(kind)
            return build(cls, *args, **kw)
        return classmethod(wrapped)

    monkeypatch.setattr(EllAOp, "from_scipy", count("ell", ell_build))
    monkeypatch.setattr(CscChunks, "from_scipy", count("csc", csc_build))
    monkeypatch.setattr(tflat, "as_aop", lambda *a, **kw: taop.as_aop(
        *a, densify_threshold_bytes=0, **kw))
    opts = dataclasses.replace(_random_opts(topt, 5, dtype="float32"),
                               flat=True)
    tree, stats, flat = tflat.run_hier_nmf2(A, opts, Random(3),
                                            device="cpu")
    assert sorted(builds) == ["csc", "ell"]
    assert flat["success"] and flat["W"].shape == (A.shape[0], 5)
    assert (tree.assignments >= 0).all() and stats.nmf_count >= 9


@pytest.mark.cuda
def test_cuda_sparse_hierclust_matches_cpu(tmp_path):
    """On the card: f64 initdir (masked view) gives the CPU's tree, and
    f32 random mode gathers its nodes, every product through seg_spmm's
    or ell_spmm's kernel and none through a dense copy of A."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    A, jopts, _ = _initdir_case("four_clusters", tmp_path)
    opts = options_from_reference(jopts)
    card, _ = thc.clust_hier(_sparse_op(A, device="cuda"), opts, Random(1),
                             host_A=A)
    cpu, _ = thc.clust_hier(_sparse_op(A), opts, Random(1), host_A=A,
                            device="cpu")
    _assert_same_tree(card, cpu)

    C, _ = _corpus()
    C = sp.csc_matrix(C)
    opts = _random_opts(topt, 6, dtype="float32")
    launches = kmod.launches + smod.launches
    plain = kmod.plain_cuda_calls + smod.plain_cuda_calls
    dense = taop.matmul_products + taop.kernel_products
    thc.gathered_operands = 0
    tree, stats = thc.clust_hier(_sparse_op(C, torch.float32, "cuda"), opts,
                                 Random(2), host_A=C)
    assert thc.gathered_operands > 0 and (tree.assignments >= 0).all()
    assert kmod.launches + smod.launches - launches >= 2 * stats.iter_count
    assert kmod.plain_cuda_calls + smod.plain_cuda_calls == plain
    assert taop.matmul_products + taop.kernel_products == dense
