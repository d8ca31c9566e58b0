"""The port stands alone: neither smallk_torch nor chip_smoke.py imports jax
or the JAX package, importing the port loads neither, and the port's own
copies of the framework-free host modules behave as the reference's do.
Its entry points run on the card unless the caller asks for the CPU, so
without a card they raise instead of running on the CPU."""

import ast
import dataclasses
import enum
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import smallk_tpu.common.options as jopt
from smallk_tpu.cli import run_cli as jrun_cli
from smallk_tpu.common.rng import Random as JRandom
from smallk_tpu.common.rng import random_matrix as jrandom_matrix
from smallk_tpu.engines import corpus as jcorpus
from smallk_tpu.engines import graph as jgraph
from smallk_tpu.engines import matrixgen as jmatrixgen
from smallk_tpu.engines import scoring as jscoring
from smallk_tpu.engines.tree import Tree as JTree
from smallk_tpu.io import delimited as jdelimited
from smallk_tpu.io import matrix_market as jmm
from smallk_tpu.io import writers as jwriters
from smallk_torch.cli import run_cli
from smallk_torch.common import options as topt
from smallk_torch.common.rng import Random, random_matrix
from smallk_torch.engines import corpus, graph, matrixgen, scoring
from smallk_torch.engines.tree import Tree
from smallk_torch.interop import options_from_reference
from smallk_torch.io import delimited, matrix_market, writers

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "smallk_tpu")


def _port_files():
    return sorted((ROOT / "smallk_torch").rglob("*.py")) + sorted(
        (ROOT / "examples" / "torch_drivers").glob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _imported_names(path):
    """Every module an `import` or `from ... import` statement names."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_the_jax_package(path):
    bad = [name for name in _imported_names(path)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import smallk_torch
mods = [m.name for m in pkgutil.walk_packages(smallk_torch.__path__,
                                              "smallk_torch.")]
for name in ("ops.ell_cols", "api", "common.profiling", "engines.embeddings",
             "engines.preprocess", "cli.matrixgen_cli",
             "cli.preprocessor_cli", "solvers.graph"):
    assert "smallk_torch." + name in mods, mods
for name in mods:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "smallk_tpu"))
assert not loaded, loaded
print(len(mods))
"""


def test_importing_the_port_loads_neither():
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 36  # every module was imported


@pytest.mark.parametrize("seed", [0, 7, 2**32 + 5])
def test_random_streams_equal(seed):
    r, j = Random(seed), JRandom(seed)
    assert r.seed == j.seed
    np.testing.assert_array_equal(random_matrix(13, 4, r),
                                  jrandom_matrix(13, 4, j))
    np.testing.assert_array_equal(r.uniform((3, 5), 1.0, 0.25),
                                  j.uniform((3, 5), 1.0, 0.25))
    assert r.device_key_seed() == j.device_key_seed()
    assert r.double() == j.double()
    state = r.get_state()
    a = r.choice(50, 7)
    r.set_state(state)
    np.testing.assert_array_equal(r.choice(50, 7), a)
    np.testing.assert_array_equal(a, j.choice(50, 7))


@pytest.mark.parametrize("kind", list(jmatrixgen.GENERATOR_TYPES))
def test_matrixgen_equal(kind):
    got = matrixgen.generate(12, 9, kind, rng=Random(3))
    want = jmatrixgen.generate(12, 9, kind, rng=JRandom(3))
    if sp.issparse(want):
        got, want = got.toarray(), want.toarray()
    np.testing.assert_array_equal(got, want)


def test_sparse_generators_and_corpus_equal():
    a = matrixgen.random_sparse_matrix(Random(4), 40, 30, nz_per_col=5)
    b = jmatrixgen.random_sparse_matrix(JRandom(4), 40, 30, nz_per_col=5)
    assert (a != b).nnz == 0
    A, la = corpus.synthetic_term_doc_corpus(300, 120, 6, seed=11)
    B, lb = jcorpus.synthetic_term_doc_corpus(300, 120, 6, seed=11)
    assert (A != B).nnz == 0 and A.dtype == B.dtype
    np.testing.assert_array_equal(la, lb)
    G, lg = corpus.planted_partition_graph(80, 4, seed=2)
    H, lh = jcorpus.planted_partition_graph(80, 4, seed=2)
    assert (G != H).nnz == 0
    np.testing.assert_array_equal(lg, lh)
    assert (graph.normalized_adjacency(G)
            != jgraph.normalized_adjacency(H)).nnz == 0
    labels = np.arange(80) % 3
    assert scoring.score_clustering(labels, lg) == \
        jscoring.score_clustering(labels, lg)


def test_matrix_files_equal(tmp_path):
    A = sp.random(20, 15, density=0.3, random_state=1, format="csc")
    matrix_market.write_matrix_market(str(tmp_path / "p.mtx"), A)
    jmm.write_matrix_market(str(tmp_path / "j.mtx"), A)
    assert (tmp_path / "p.mtx").read_bytes() == \
        (tmp_path / "j.mtx").read_bytes()
    assert (matrix_market.load_matrix_market(str(tmp_path / "j.mtx"))
            != jmm.load_matrix_market(str(tmp_path / "j.mtx"))).nnz == 0
    X = np.random.RandomState(2).rand(4, 3)
    delimited.write_delimited(str(tmp_path / "p.csv"), X, 9)
    jdelimited.write_delimited(str(tmp_path / "j.csv"), X, 9)
    assert (tmp_path / "p.csv").read_bytes() == \
        (tmp_path / "j.csv").read_bytes()


def _tree(cls, W):
    """The same 3-leaf tree in either package, built by hand."""
    t = cls()
    t.init(3, 6, 8)
    t.split_root(W[0], labels=np.array([1, 1, 0, 1, 0, 0, 1, 0], bool))
    t.set_node_priority(0, 0.5)
    t.set_node_priority(1, 0.25)
    t.split(0, W[1], labels=np.array([1, 0, 1, 0], bool))
    t.compute_top_terms(3)
    t.compute_assignments()
    return t


@pytest.mark.parametrize("fmt", ["XML", "JSON"])
def test_hierclust_writers_byte_equal(fmt, tmp_path):
    rng = np.random.RandomState(5)
    W = [rng.rand(6, 2), rng.rand(6, 2)]
    words = [f"w{i}" for i in range(6)]
    out = {}
    for name, cls, wmod, opt in (("port", Tree, writers, topt),
                                 ("jax", JTree, jwriters, jopt)):
        tree = _tree(cls, W)
        tree.write_tree(wmod.make_hierclust_writer(opt.OutputFormat(fmt)),
                        str(tmp_path / f"{name}.tree"), words)
        tree.write_assignments(str(tmp_path / f"{name}.csv"))
        out[name] = [(tmp_path / f"{name}.{ext}").read_bytes()
                     for ext in ("tree", "csv")]
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("fmt", ["XML", "JSON"])
def test_flatclust_writers_byte_equal(fmt, tmp_path):
    words = [f"w{i}" for i in range(6)]
    terms = [[0, 3], [5, 1]]
    out = {}
    for name, wmod, opt in (("port", writers, topt),
                            ("jax", jwriters, jopt)):
        with open(tmp_path / name, "w") as f:
            wmod.make_flatclust_writer(opt.OutputFormat(fmt)).write(
                f, 9, {0: 4, 1: 5}, terms, words)
        out[name] = (tmp_path / name).read_bytes()
    assert out["port"] == out["jax"]


def _raiser(exc):
    def main(argv):
        raise exc
    return main


@pytest.mark.parametrize("main", [
    lambda argv: 0, lambda argv: None, lambda argv: 1, lambda argv: 5,
    _raiser(SystemExit(0)), _raiser(SystemExit(2)), _raiser(ValueError("v")),
    _raiser(FileNotFoundError("f")), _raiser(MemoryError()),
    _raiser(OverflowError()), _raiser(RuntimeError("r")),
], ids=["0", "None", "1", "5", "exit0", "exit2", "value", "file", "memory",
        "overflow", "runtime"])
def test_run_cli_exit_codes_equal(main):
    assert run_cli(main, []) == jrun_cli(main, [])
    with pytest.raises(KeyboardInterrupt):
        run_cli(_raiser(KeyboardInterrupt()), [])


def _same_fields(port, ref):
    """Field by field, enums by name."""
    for f in dataclasses.fields(ref):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(b):
            _same_fields(a, b)
        elif isinstance(b, enum.Enum):
            assert type(a).__module__ == topt.__name__
            assert a.name == b.name
        else:
            assert a == b, f.name


def test_options_from_reference_round_trips():
    ref = jopt.NmfOptions(tol=1e-3, algorithm=jopt.NmfAlgorithm.HALS,
                          prog_est_algorithm=jopt.NmfProgressAlgorithm
                          .DELTA_FNORM, height=9, width=7, k=3,
                          a_dtype="bfloat16", stall_patience=4)
    port = options_from_reference(ref)
    assert type(port) is topt.NmfOptions
    _same_fields(port, ref)
    # the enums are distinct classes: the reference's compares unequal
    assert port.algorithm == topt.NmfAlgorithm.HALS
    assert ref.algorithm != topt.NmfAlgorithm.HALS
    cref = jopt.ClustOptions(nmf_opts=ref, num_clusters=5, flat=True,
                             restarts=2, priority_method="size_ndcg",
                             init_method="spectral")
    cport = options_from_reference(cref)
    assert type(cport) is topt.ClustOptions
    assert type(cport.nmf_opts) is topt.NmfOptions
    _same_fields(cport, cref)
    assert options_from_reference(cport) is cport
    with pytest.raises(ValueError):
        options_from_reference(jopt.NmfStats())


def test_entry_points_need_a_card_by_default():
    """With no device named, every entry point runs on the card; without
    one it raises rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from smallk_torch.engines.flatclust import run_flatclust, run_hier_nmf2
    from smallk_torch.engines.hierclust import clust_hier
    from smallk_torch.engines.nmf import run_nmf
    from smallk_torch.interop import from_reference
    from smallk_torch.ops.aop import as_aop
    from smallk_torch.parallel.mesh import make_mesh

    rng = np.random.RandomState(0)
    A, W0, H0 = rng.rand(12, 9), rng.rand(12, 2), rng.rand(2, 9)
    nmf = topt.NmfOptions(height=12, width=9, k=2,
                          algorithm=topt.NmfAlgorithm.RANK2, verbose=False)
    clust = topt.ClustOptions(num_clusters=2, verbose=False)
    calls = [lambda: run_nmf(A, W0, H0, nmf),
             lambda: run_flatclust(A, W0, H0, nmf),
             lambda: as_aop(A),
             lambda: from_reference(A, W0, H0),
             lambda: clust_hier(A, clust, Random(1)),
             lambda: run_hier_nmf2(A, clust, Random(1)),
             lambda: make_mesh(),
             lambda: make_mesh((1, 1), backend="gloo")]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # the mesh raised before it joined a world
    assert not torch.distributed.is_initialized()
