"""The port's hierarchical clustering (engines/hierclust.py, tree.py,
priority.py, run_hier_nmf2 and the hierclust CLI) against the JAX package
and the numpy oracle tests/np_hierclust.py, in f64 on the CPU.

Initdir mode consumes the same initializer files in both packages, so
trees, assignments, priorities and the result files must match: equal
structure and documents, priorities to 1e-10 (f64, other summation
orders), byte-equal files.  Random mode draws its starts from a
torch.Generator that cannot reproduce the JAX package's threefry draws, so
it is held to the JAX run's NMI against the planted labels, within 0.05.
"""

import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smallk_tpu.common.options as jopt
from smallk_tpu.cli.hierclust_cli import main as jhier_main
from smallk_tpu.common.rng import Random as JRandom
from smallk_tpu.engines.flatclust import run_hier_nmf2 as jrun_hier_nmf2
from smallk_tpu.engines.hierclust import clust_hier as jclust_hier
from smallk_tpu.engines.priority import compute_priority as jcompute_priority
from smallk_tpu.engines.priority import (
    compute_priority_device as jcompute_priority_device,
)
from smallk_tpu.io.matrix_market import write_matrix_market
from smallk_torch.cli.hierclust_cli import entry as thier_entry
from smallk_torch.cli.hierclust_cli import main as thier_main
from smallk_torch.common.rng import Random
from smallk_torch.engines.corpus import synthetic_term_doc_corpus
from smallk_torch.engines.flatclust import run_hier_nmf2
from smallk_torch.engines.hierclust import clust_hier
from smallk_torch.engines.priority import (
    compute_priority,
    compute_priority_device,
)
from smallk_torch.engines.scoring import nmi
from smallk_torch.interop import options_from_reference
from np_hierclust import np_clust_hier
from test_hier_oracle import (
    _assert_trees_match,
    _clust_opts,
    _np_opts,
    _planted_sparse,
    _write_initdir,
)

torch.set_num_threads(1)

PRIORITY_TOL = dict(rel=1e-10, abs=1e-12)

# the fixtures of tests/test_hier_oracle.py: a 4-cluster planted matrix,
# and the unbalanced-0.45 / trial_allowance-2 case whose small planted
# cluster drives TrialSplit's outlier drop and recycle
CASES = {
    "four_clusters": dict(m=48, n=72, sizes=[24, 18, 16, 14], seed=3, k=4,
                          files=60, init_seed=11, unbalanced=0.1,
                          trial_allowance=3),
    "drop_and_recycle": dict(m=40, n=64, sizes=[30, 28, 6], seed=5, k=3,
                             files=80, init_seed=17, unbalanced=0.45,
                             trial_allowance=2),
}


def _case(name, tmp_path):
    c = CASES[name]
    A, labels = _planted_sparse(c["m"], c["n"], c["sizes"], seed=c["seed"])
    initdir = _write_initdir(tmp_path, c["m"], c["n"], c["files"],
                             seed=c["init_seed"])
    jopts = _clust_opts(c["k"], initdir, unbalanced=c["unbalanced"],
                        trial_allowance=c["trial_allowance"])
    return A, labels, initdir, jopts, c


def _assert_same_tree(tree, jtree):
    """Structure, documents, priorities, top terms and assignments."""
    assert len(tree.nodes) == len(jtree.nodes)
    assert tree.is_leaf == jtree.is_leaf
    for q, (a, b) in enumerate(zip(tree.nodes, jtree.nodes)):
        assert (a.is_valid, a.parent_index, a.left_child_index,
                a.right_child_index, a.is_left_child) == (
            b.is_valid, b.parent_index, b.left_child_index,
            b.right_child_index, b.is_left_child), f"node {q}"
        if not a.is_valid:
            continue
        np.testing.assert_array_equal(a.docs, b.docs, err_msg=f"node {q}")
        assert a.priority == pytest.approx(b.priority, **PRIORITY_TOL)
        assert a.pop_priority == pytest.approx(b.pop_priority,
                                               **PRIORITY_TOL)
        np.testing.assert_array_equal(a.term_indices, b.term_indices)
    np.testing.assert_array_equal(tree.assignments, jtree.assignments)
    np.testing.assert_array_equal(tree.outliers, jtree.outliers)


@pytest.mark.parametrize("name", sorted(CASES))
def test_initdir_tree_matches_jax_and_numpy_oracle(name, tmp_path, capsys):
    A, _, initdir, jopts, c = _case(name, tmp_path)
    jtree, jstats = jclust_hier(A, jopts, JRandom(1))
    tree, stats = clust_hier(A, options_from_reference(jopts), Random(1),
                             device="cpu")
    nptree, events = np_clust_hier(
        A, _np_opts(c["k"], unbalanced=c["unbalanced"],
                    trial_allowance=c["trial_allowance"]), initdir)
    _assert_same_tree(tree, jtree)
    _assert_trees_match(tree, nptree)
    assert (stats.nmf_count, stats.max_count, stats.iter_count) == (
        jstats.nmf_count, jstats.max_count, jstats.iter_count)
    assert stats.nmf_count == events["nmf_count"]
    assert stats.iter_count == events["iter_count"]
    if name == "drop_and_recycle":  # the branches ran
        assert events["drops"] and events["recycles"]


def test_initdir_verbose_output_matches_jax(tmp_path, capsys):
    """The drop/recycle messages, split markers and the early-stop
    message print as the JAX package prints them."""
    A, _, _, jopts, _ = _case("drop_and_recycle", tmp_path)
    jopts = type(jopts)(**{**jopts.__dict__, "verbose": True})
    jclust_hier(A, jopts, JRandom(1))
    ref = capsys.readouterr().out
    clust_hier(A, options_from_reference(jopts), Random(1), device="cpu")
    out = capsys.readouterr().out
    for word in ("dropping", "recycling", "[1]", "no further"):
        assert ref.count(word) > 0, word
    assert out == ref


def _pair(rng, m, zero_frac=0.0, ties=False):
    w_parent = rng.rand(m)
    if zero_frac:
        w_parent[rng.rand(m) < zero_frac] = 0.0
    w_child = rng.rand(m, 2)
    if ties:
        w_parent = np.round(w_parent, 1)
        w_child = np.round(w_child, 1)
    return w_parent, w_child


@pytest.mark.parametrize("m", [16, 100, 257])
@pytest.mark.parametrize("zero_frac,ties", [(0.0, False), (0.3, False),
                                            (0.0, True), (0.5, True)])
def test_priority_device_matches_both_references(m, zero_frac, ties):
    rng = np.random.RandomState(m + int(zero_frac * 10) + int(ties))
    for _ in range(5):
        w_parent, w_child = _pair(rng, m, zero_frac, ties)
        host = jcompute_priority(w_parent, w_child)
        jdev = float(jcompute_priority_device(jnp.asarray(w_parent),
                                              jnp.asarray(w_child)))
        dev = compute_priority_device(torch.from_numpy(w_parent),
                                      torch.from_numpy(w_child))
        assert dev.dtype == torch.float64 and dev.ndim == 0
        assert float(dev) == pytest.approx(host, rel=1e-12, abs=1e-12)
        assert float(dev) == pytest.approx(jdev, rel=1e-12, abs=1e-12)
        assert compute_priority(w_parent, w_child) == host


@pytest.mark.parametrize("nnz", [0, 1])
def test_priority_degenerate_parent_sentinel(nnz):
    w_child = np.random.RandomState(0).rand(32, 2)
    w_parent = np.zeros(32)
    w_parent[:nnz] = 1.0
    assert compute_priority(w_parent, w_child) == -3.0
    assert float(compute_priority_device(torch.from_numpy(w_parent),
                                         torch.from_numpy(w_child))) == -3.0


def test_priority_negative_zero_ties_with_zero():
    """-0.0 and +0.0 tie in the rankings, as they do in the reference."""
    rng = np.random.RandomState(4)
    w_parent, w_child = _pair(rng, 40, zero_frac=0.4)
    flipped = np.where(w_parent == 0, -0.0, w_parent)
    want = jcompute_priority(w_parent, w_child)
    assert float(compute_priority_device(
        torch.from_numpy(flipped), torch.from_numpy(w_child))) == \
        pytest.approx(want, rel=1e-12)


def _corpus(m=300, n=240, k=6, seed=11):
    """A small planted corpus with the Reuters-like statistics of
    engines/corpus.py, made harder than its default (topic weight 0.5)."""
    return synthetic_term_doc_corpus(m, n, k, seed=seed, topic_weight=0.5)


def _random_opts(pkg, k, dtype="float64", **kw):
    return pkg.ClustOptions(
        nmf_opts=pkg.NmfOptions(
            tol=1e-4, algorithm=pkg.NmfAlgorithm.RANK2,
            prog_est_algorithm=pkg.NmfProgressAlgorithm.PG_RATIO, k=2,
            min_iter=1, max_iter=5000, verbose=False, dtype=dtype,
            stall_patience=100),
        num_clusters=k, verbose=False, **kw)


@pytest.mark.parametrize("init,restarts,priority", [
    ("random", 1, "ndcg"), ("spectral", 1, "ndcg"),
    ("random", 3, "size_ndcg"),
])
def test_random_mode_nmi_matches_jax(init, restarts, priority):
    A, labels = _corpus()
    kw = dict(init_method=init, restarts=restarts, priority_method=priority)
    jtree, _ = jclust_hier(A, _random_opts(jopt, 6, **kw), JRandom(2))
    from smallk_torch.common import options as topt

    tree, stats = clust_hier(A, _random_opts(topt, 6, **kw), Random(2),
                             device="cpu")
    leaves = [q for q, leaf in enumerate(tree.is_leaf) if leaf]
    assert len(leaves) == 6 and (tree.assignments >= 0).all()
    assert stats.nmf_count >= 11 and stats.iter_count > 0
    got, ref = nmi(tree.assignments, labels), nmi(jtree.assignments, labels)
    assert got >= ref - 0.05, (got, ref)


@pytest.mark.parametrize("mode", ["random", "initdir"])
def test_checkpoint_interrupt_resume(mode, tmp_path):
    """A run interrupted after two splits and resumed from its checkpoint
    builds the tree of the uninterrupted run."""
    from smallk_torch.common import options as topt

    if mode == "initdir":
        A, _, _, jopts, _ = _case("four_clusters", tmp_path)
        opts = options_from_reference(jopts)
    else:
        A, _ = _corpus(200, 150, 5, seed=3)
        opts = _random_opts(topt, 5)
    ref, ref_stats = clust_hier(A, opts, Random(7), device="cpu")

    ckpt = str(tmp_path / "run.hckpt")
    with pytest.raises(KeyboardInterrupt):
        clust_hier(A, opts, Random(7), checkpoint_path=ckpt, device="cpu",
                   _interrupt_after=2)
    assert os.path.exists(ckpt)
    tree, stats = clust_hier(A, opts, Random(123), checkpoint_path=ckpt,
                             device="cpu")
    _assert_same_tree(tree, ref)
    assert (stats.nmf_count, stats.iter_count) == (ref_stats.nmf_count,
                                                   ref_stats.iter_count)
    # a checkpoint of another configuration is refused
    wrong = type(opts)(**{**opts.__dict__,
                          "num_clusters": opts.num_clusters + 1})
    with pytest.raises(ValueError, match="checkpoint"):
        clust_hier(A, wrong, Random(7), checkpoint_path=ckpt, device="cpu")


def test_run_hier_nmf2_flat_matches_jax(tmp_path):
    A, _, _, jopts, c = _case("four_clusters", tmp_path)
    jopts = type(jopts)(**{**jopts.__dict__, "flat": True})
    jtree, jstats, jflat = jrun_hier_nmf2(A, jopts, JRandom(5))
    tree, stats, flat = run_hier_nmf2(A, options_from_reference(jopts),
                                      Random(5), device="cpu")
    _assert_same_tree(tree, jtree)
    assert flat["success"] and jflat["success"]
    for key in ("W", "H"):
        np.testing.assert_allclose(flat[key], np.asarray(jflat[key]),
                                   rtol=1e-8, atol=1e-9)
    np.testing.assert_array_equal(flat["assignments"], jflat["assignments"])
    np.testing.assert_allclose(flat["fuzzy"], jflat["fuzzy"], atol=1e-6)
    assert flat["W"].shape == (c["m"], c["k"])


def _files(outdir):
    return {p.name: p.read_bytes() for p in sorted(Path(outdir).iterdir())}


@pytest.mark.parametrize("fmt,flat", [("XML", 1), ("JSON", 0)])
def test_cli_matches_reference_cli(fmt, flat, tmp_path):
    import scipy.sparse as sp

    A, _, initdir, _, c = _case("four_clusters", tmp_path)
    mtx = str(tmp_path / "a.mtx")
    write_matrix_market(mtx, sp.coo_matrix(A), precision=17)
    dic = str(tmp_path / "dict.txt")
    with open(dic, "w") as f:
        f.write("".join(f"term{i}\n" for i in range(c["m"])))
    outs = {}
    for name, main, extra in (("port", thier_main, ["--device", "cpu"]),
                              ("jax", jhier_main, [])):
        out = tmp_path / name
        out.mkdir()
        assert main(["--matrixfile", mtx, "--dictfile", dic, "--clusters",
                     str(c["k"]), "--initdir", initdir, "--outdir", str(out),
                     "--format", fmt, "--verbose", "0", "--dtype", "float64",
                     "--miniter", "1", "--flat", str(flat), "--seed", "3",
                     *extra]) == 0
        outs[name] = _files(out)
    port, ref = outs["port"], outs["jax"]
    k = c["k"]
    names = [f"assignments_{k}.csv", f"tree_{k}.{fmt.lower()}"]
    if flat:
        names += [f"assignments_flat_{k}.csv", f"assignments_fuzzy_{k}.csv",
                  f"clusters_{k}.{fmt.lower()}"]
    assert sorted(port) == sorted(ref) == sorted(names)
    for fname in names:
        assert port[fname] == ref[fname], fname


def test_cli_exit_codes(tmp_path):
    import scipy.sparse as sp

    A, _, _, _, c = _case("four_clusters", tmp_path)
    mtx = str(tmp_path / "a.mtx")
    write_matrix_market(mtx, sp.coo_matrix(A))
    dic = str(tmp_path / "dict.txt")
    with open(dic, "w") as f:
        f.write("".join(f"t{i}\n" for i in range(c["m"])))
    base = ["--matrixfile", mtx, "--dictfile", dic, "--clusters", "3",
            "--outdir", str(tmp_path), "--verbose", "0", "--seed", "1",
            "--device", "cpu"]
    assert thier_entry(base + ["--treefile", "t.json", "--format", "JSON",
                               "--assignfile", "a.csv"]) == 0
    assert (tmp_path / "t.json").is_file() and (tmp_path / "a.csv").is_file()
    # --mesh whose size is not the world's (one process: a world of one)
    assert thier_entry(base + ["--mesh", "1x8"]) == 2
    assert thier_entry(base + ["--init", "nndsvd"]) == 2
    assert thier_entry(["--matrixfile", str(tmp_path / "no.mtx"),
                        "--dictfile", dic, "--clusters", "3",
                        "--device", "cpu"]) == 2
    assert thier_entry(["--clusters", "3"]) == 2
    if not torch.cuda.is_available():
        # FAILURE: the default device is the card, and there is none
        assert thier_entry(base[:-2]) == 1


def test_cli_graph_preset(tmp_path, capsys):
    """--graph normalizes a planted-partition adjacency and runs the graph
    presets (size-scaled pop, best-of-3 restarts): the communities come
    back."""
    from smallk_torch.engines.corpus import planted_partition_graph

    G, labels = planted_partition_graph(90, 3, seed=2)
    mtx = str(tmp_path / "g.mtx")
    write_matrix_market(mtx, G)
    dic = str(tmp_path / "dict.txt")
    with open(dic, "w") as f:
        f.write("".join(f"v{i}\n" for i in range(90)))
    assert thier_entry(["--matrixfile", mtx, "--dictfile", dic, "--clusters",
                        "3", "--graph", "--outdir", str(tmp_path),
                        "--verbose", "0", "--seed", "1", "--device",
                        "cpu"]) == 0
    assert "factorizations converged" in capsys.readouterr().out
    with open(tmp_path / "assignments_3.csv") as f:
        assign = np.array([int(v) for v in f.readline().split(",")])
    assert nmi(assign, labels) > 0.9


@pytest.mark.parametrize("restarts", [1, 3])
def test_padded_exact_width_nodes_keep_the_tree(restarts, monkeypatch):
    """A dense node past the bucket ladder is gathered at `row_width`
    (on the card: whole 16-byte rows, so that K3 takes its aligned loads):
    its zero columns leave the tree as it is at the exact width.  Forced
    here on the CPU, 13 zero columns a node, in f64."""
    from types import SimpleNamespace

    from smallk_torch.common import options as topt
    from smallk_torch.engines import hierclust as hc
    from smallk_torch.engines.tree import _host

    card = lambda item: SimpleNamespace(is_cuda=True,  # noqa: E731
                                        element_size=lambda: item)
    assert [hc.row_width(2999, card(i)) for i in (4, 2, 1, 8)] == \
        [3000, 3000, 3008, 3000]
    assert hc.row_width(7983, card(2)) == 7984
    assert hc.row_width(2999, torch.zeros(1, 1)) == 2999
    A, _ = _corpus()
    opts = _random_opts(topt, 5, restarts=restarts)
    want, wstats = clust_hier(A, opts, Random(2), device="cpu")
    widths = []

    def padded(size, A):
        widths.append(size)
        return size + 13

    monkeypatch.setattr(hc, "row_width", padded)
    got, stats = clust_hier(A, opts, Random(2), device="cpu")
    assert widths and stats.nmf_count == wstats.nmf_count
    np.testing.assert_array_equal(got.assignments, want.assignments)
    for a, b in zip(got.nodes, want.nodes):
        assert (a.topic_vector is None) == (b.topic_vector is None)
        if a.topic_vector is not None:
            np.testing.assert_allclose(_host(a.topic_vector),
                                       _host(b.topic_vector),
                                       rtol=0, atol=1e-9)
