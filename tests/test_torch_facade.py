"""The port's stateful `smallk` facade (smallk_torch/__init__.py) against
the JAX package's (smallk_tpu/__init__.py), f64 on the CPU.

Both facades run the same seeded host draws, so Nmf writes byte-equal
w.csv/h.csv.  HierNmf2 in random mode draws its starts from each
package's own device generator, so its files are held equal to the
reference's in initdir mode (both facades' ClustOptions given the same
initializer files), and in random mode equal to a direct `run_hier_nmf2`
of the port with the same seed.
"""

import functools
import os
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import smallk_tpu as jsmallk
import smallk_torch as smallk
from smallk_torch.engines.flatclust import (
    run_hier_nmf2,
    write_flatclust_results,
)
from smallk_torch.io.delimited import load_delimited, write_delimited
from smallk_torch.io.matrix_market import write_matrix_market
from smallk_torch.io.writers import make_hierclust_writer
from test_hier_oracle import _planted_sparse, _write_initdir

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def fresh():
    smallk.Initialize(device="cpu")
    jsmallk.Initialize()
    yield
    smallk.Finalize()
    jsmallk.Finalize()


def _both(fn):
    """fn(pkg) for the port's facade and the reference's."""
    return fn(smallk), fn(jsmallk)


def _files(outdir):
    return {p.name: p.read_bytes() for p in sorted(Path(outdir).iterdir())}


def _setup(pkg, outdir, seed):
    os.makedirs(outdir, exist_ok=True)
    pkg.SetOutputDir(str(outdir))
    pkg._state.dtype = "float64"
    pkg.SeedRNG(seed)


def test_version():
    assert smallk.GetVersionString() == smallk.__version__ == \
        jsmallk.GetVersionString()
    assert (smallk.GetMajorVersion(), smallk.GetMinorVersion(),
            smallk.GetPatchLevel()) == (jsmallk.GetMajorVersion(),
                                        jsmallk.GetMinorVersion(),
                                        jsmallk.GetPatchLevel())


def test_defaults_match_reference():
    # reference defaults: smallk.hpp:102-311
    getters = ("GetOutputPrecision", "GetNmfTolerance", "GetMaxIter",
               "GetMinIter", "GetMaxThreads", "GetHierNmf2Tolerance",
               "GetMaxTerms", "GetOutputDir")
    for name in getters:
        port, ref = _both(lambda pkg: getattr(pkg, name)())
        assert port == ref, name
    assert smallk.GetNmfTolerance() == 0.005
    assert smallk.GetHierNmf2Tolerance() == 0.0001
    assert smallk.GetOutputFormat() == smallk.OutputFormat.JSON
    assert smallk.GetOutputFormat().name == jsmallk.GetOutputFormat().name
    assert [a.value for a in smallk.Algorithm] == \
        [a.value for a in jsmallk.Algorithm]
    assert smallk._state.dtype == jsmallk._state.dtype == "float32"
    # the one field the port adds: where the engines run
    assert smallk._state.device == "cpu"
    smallk.Initialize()
    assert smallk._state.device == "cuda"


def test_setters_validate():
    for pkg in (smallk, jsmallk):
        with pytest.raises(ValueError):
            pkg.SetNmfTolerance(0.0)
        with pytest.raises(ValueError):
            pkg.SetHierNmf2Tolerance(1.5)
        pkg.SetNmfTolerance(0.01)
        pkg.SetMaxIter(77)
        pkg.SetMinIter(3)
        pkg.SetMaxTerms(9)
        pkg.SetOutputPrecision(4)
        pkg.SetOutputDir("")
        assert pkg.GetNmfTolerance() == 0.01 and pkg.GetMaxIter() == 77
        assert pkg.GetMinIter() == 3 and pkg.GetMaxTerms() == 9
        assert pkg.GetOutputPrecision() == 4 and pkg.GetOutputDir() == "."
        pkg.Reset()
        assert pkg.GetNmfTolerance() == 0.005 and pkg.GetMaxIter() == 5000
        assert pkg.IsInitialized()
    # Reset keeps the device Initialize chose
    assert smallk._state.device == "cpu"


def test_requires_initialize():
    for pkg in (smallk, jsmallk):
        pkg.Finalize()
        assert not pkg.IsInitialized()
        with pytest.raises(RuntimeError):
            pkg.LoadMatrix(matrix=np.ones((3, 3)))
        with pytest.raises(RuntimeError):
            pkg.Nmf(2)
        with pytest.raises(RuntimeError):
            pkg.LockedBufferW()
    smallk.Initialize(device="cpu")
    with pytest.raises(RuntimeError, match="no matrix"):
        smallk.Nmf(2)
    smallk.LoadMatrix(matrix=np.ones((4, 4)))
    with pytest.raises(RuntimeError, match="no dictionary"):
        smallk.HierNmf2(2)


def _dump(out):
    """The option dump's lines (the run's timings differ)."""
    return [ln for ln in out.splitlines() if ln.startswith("\t")
            and "progress metric" not in ln]


@pytest.mark.parametrize("algorithm,k,iters", [("BPP", 5, 5000),
                                               ("HALS", 4, 5000),
                                               ("MU", 3, 200)])
def test_nmf_files_equal_reference(algorithm, k, iters, tmp_path, capsys):
    """Nmf from a .csv with SeedRNG: byte-equal w.csv and h.csv, the same
    option dump (MU forced to DELTA_FNORM, smallk.cpp:574-582) and
    iteration count, the factors in LockedBufferW/H."""
    A = np.random.RandomState(0).rand(40, 30)
    path = str(tmp_path / "a.csv")
    write_delimited(path, A, 12)
    outs = {}
    for name, pkg in (("port", smallk), ("jax", jsmallk)):
        _setup(pkg, tmp_path / name, 42)
        pkg.SetMaxIter(iters)
        pkg.LoadMatrix(path)
        assert pkg.IsMatrixLoaded()
        capsys.readouterr()
        pkg.Nmf(k, pkg.Algorithm[algorithm])
        out = capsys.readouterr().out.replace(str(tmp_path / name), "OUT")
        outs[name] = (_files(tmp_path / name), _dump(out),
                      out.strip().splitlines()[-1],
                      np.asarray(pkg.LockedBufferW()),
                      np.asarray(pkg.LockedBufferH()))
    (files, dump, its, W, H), (jfiles, jdump, jits, Wj, Hj) = (
        outs["port"], outs["jax"])
    assert sorted(files) == ["h.csv", "w.csv"]
    assert files == jfiles
    assert dump == jdump and its == jits
    want = "DELTA_FNORM" if algorithm == "MU" else "PG_RATIO"
    assert f"\tstopping criterion: {want}" in dump
    assert W.shape == (40, k) and H.shape == (k, 30)
    np.testing.assert_allclose(W, Wj, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(H, Hj, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(load_delimited(str(tmp_path / "port" /
                                                  "w.csv")), W, atol=1e-6)
    rel = np.linalg.norm(A - W @ H) / np.linalg.norm(A)
    assert rel < 0.5


def test_nmf_initfiles(tmp_path):
    """Nmf from W and H initializer files writes the reference's files."""
    rng = np.random.RandomState(3)
    A = rng.rand(20, 16)
    write_delimited(str(tmp_path / "w0.csv"), rng.rand(20, 3), 17)
    write_delimited(str(tmp_path / "h0.csv"), rng.rand(3, 16), 17)
    files = {}
    for name, pkg in (("port", smallk), ("jax", jsmallk)):
        _setup(pkg, tmp_path / name, 1)
        pkg.LoadMatrix(matrix=A)
        pkg.Nmf(3, pkg.Algorithm.BPP, str(tmp_path / "w0.csv"),
                str(tmp_path / "h0.csv"))
        files[name] = _files(tmp_path / name)
    assert files["port"] == files["jax"]


def _initdir_opts(pkg, initdir):
    """The package's ClustOptions with `initdir` preset, so that its
    facade's rank-2 solves start from the initializer files."""
    return functools.partial(pkg.ClustOptions, initdir=initdir)


@pytest.mark.parametrize("flat", [True, False])
def test_hiernmf2_files_equal_reference(flat, tmp_path, monkeypatch):
    A, _ = _planted_sparse(48, 72, [24, 18, 16, 14], seed=3)
    A = sp.csc_matrix(A)
    initdir = _write_initdir(tmp_path, 48, 72, 60, seed=11)
    mtx = str(tmp_path / "a.mtx")
    write_matrix_market(mtx, A, precision=17)
    words = [f"t{i}" for i in range(48)]
    files = {}
    for name, pkg in (("port", smallk), ("jax", jsmallk)):
        monkeypatch.setattr(pkg, "ClustOptions", _initdir_opts(pkg, initdir))
        _setup(pkg, tmp_path / name, 11)
        pkg.SetMinIter(1)
        pkg.LoadMatrix(mtx)
        pkg.LoadDictionary(words)
        pkg.SetOutputFormat(pkg.OutputFormat.XML)
        (pkg.HierNmf2WithFlat if flat else pkg.HierNmf2)(4)
        files[name] = _files(tmp_path / name)
    names = ["assignments_4.csv", "tree_4.xml"]
    if flat:
        names += ["assignments_flat_4.csv", "assignments_fuzzy_4.csv",
                  "clusters_4.xml"]
    assert sorted(files["port"]) == sorted(names)
    assert files["port"] == files["jax"]


@pytest.mark.parametrize("restarts,priority,checkpoint", [
    (1, "ndcg", False), (2, "size_ndcg", True)])
def test_hiernmf2_random_mode_equals_direct_run(restarts, priority,
                                                checkpoint, tmp_path):
    """HierNmf2WithFlat in random mode writes the files of a direct
    run_hier_nmf2 with the facade's options and seed; `restarts`,
    `priority_method` and `checkpoint_path` reach the engine."""
    rng = np.random.RandomState(2)
    A = sp.random(60, 50, density=0.2, random_state=rng, format="csc")
    A.data = np.ceil(A.data * 5)
    words = [f"t{i}" for i in range(60)]
    ckpt = str(tmp_path / "run.ckpt") if checkpoint else None
    _setup(smallk, tmp_path / "facade", 11)
    smallk.LoadMatrix(matrix=A)
    smallk.LoadDictionary(words)
    smallk.HierNmf2WithFlat(4, checkpoint_path=ckpt, restarts=restarts,
                            priority_method=priority)
    assert (ckpt is None) or os.path.exists(ckpt)

    opts = smallk.ClustOptions(
        nmf_opts=smallk.NmfOptions(
            tol=1e-4, algorithm=smallk.NmfAlgorithm.RANK2,
            prog_est_algorithm=smallk.NmfProgressAlgorithm.PG_RATIO,
            height=60, width=50, k=2, min_iter=5, max_iter=5000, tolcount=1,
            max_threads=smallk.GetMaxThreads(), verbose=False,
            normalize=True, dtype="float64"),
        maxterms=5, unbalanced=0.1, trial_allowance=3, num_clusters=4,
        verbose=False, flat=True, restarts=restarts,
        priority_method=priority)
    tree, _, flat = run_hier_nmf2(A, opts, smallk.Random(11), device="cpu")
    direct = tmp_path / "direct"
    direct.mkdir()
    fmt = smallk.OutputFormat.JSON
    tree.write_assignments(str(direct / "assignments_4.csv"))
    tree.write_tree(make_hierclust_writer(fmt), str(direct / "tree_4.json"),
                    words)
    write_flatclust_results(str(direct), flat["assignments"], flat["fuzzy"],
                            flat["W"], words, 5, fmt, 4,
                            assignments_prefix="assignments_flat_")
    got = _files(tmp_path / "facade")
    assert sum(tree.is_leaf) == 4
    assert got == _files(direct)


def test_load_matrix_forms_match_reference(tmp_path):
    """The four forms of LoadMatrix, and a .mtx and a .csv path, load what
    the reference's load."""
    buf = np.arange(12, dtype=np.float64)  # 3x4 col-major
    S = sp.random(9, 7, density=0.4, random_state=1, format="csc")
    write_matrix_market(str(tmp_path / "s.mtx"), S, precision=17)
    write_delimited(str(tmp_path / "d.csv"), np.random.RandomState(5)
                    .rand(5, 4), 17)
    forms = [((buf, 3, 3, 4), {}),
             ((3, 2, 2, [1.0, 2.0], [0, 2], [0, 1, 2]), {}),
             ((str(tmp_path / "s.mtx"),), {}),
             ((str(tmp_path / "d.csv"),), {}),
             ((S,), {}),
             ((), {"matrix": S.tocsr()})]
    for args, kw in forms:
        got, want = _both(lambda pkg: (pkg.LoadMatrix(*args, **kw),
                                       pkg._state.matrix)[1])
        assert type(got) is type(want) and got.shape == want.shape
        if sp.issparse(want):
            got, want = got.toarray(), want.toarray()
        np.testing.assert_array_equal(got, want)
    smallk.LoadMatrix(buf, 3, 3, 4)
    assert smallk._state.matrix[0, 1] == 3.0  # column 1 starts at offset 3
    with pytest.raises(TypeError):
        smallk.LoadMatrix(1, 2)


def test_load_dictionary_forms(tmp_path):
    path = tmp_path / "dict.txt"
    path.write_text("alpha\nbeta\n\ngamma\n")
    got, want = _both(lambda pkg: (pkg.LoadDictionary(str(path)),
                                   pkg._state.dictionary)[1])
    assert got == want == ["alpha", "beta", "gamma"]
    smallk.LoadDictionary(("x", "y"))
    assert smallk._state.dictionary == ["x", "y"]


def test_mesh_raises():
    smallk.LoadMatrix(matrix=np.ones((6, 5)))
    smallk.LoadDictionary([f"t{i}" for i in range(6)])
    # a mesh that is not the port's (a JAX mesh, say) is refused
    for fn in (smallk.HierNmf2, smallk.HierNmf2WithFlat):
        with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
            fn(2, mesh=object())


def test_default_device_is_the_card():
    """Initialized without a device, the facade runs on the card; without
    one it raises rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    smallk.Initialize()
    smallk.LoadMatrix(matrix=np.random.RandomState(0).rand(8, 6))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        smallk.Nmf(2)
    smallk.LoadDictionary([f"t{i}" for i in range(8)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        smallk.HierNmf2(2)
