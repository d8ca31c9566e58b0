"""The port's pysmallk-style API (smallk_torch/api.py) against the JAX
package's (smallk_tpu/api.py): the six cases of tests/test_api.py, each
run through both packages on the same inputs and seeds, f64 on the CPU.
Equal files where the reference's are deterministic; Hierclust through
its initializer files (random starts come from each package's own
device generator)."""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import smallk_tpu.api as japi
import smallk_torch.api as tapi
from test_hier_oracle import _planted_sparse, _write_initdir

torch.set_num_threads(1)


def _files(outdir):
    return {p.name: p.read_bytes() for p in sorted(Path(outdir).iterdir())}


def _smallkapi(mod, seed):
    api = mod.SmallkAPI(device="cpu") if mod is tapi else mod.SmallkAPI()
    api._facade._state.dtype = "float64"
    api._facade.SeedRNG(seed)
    return api


@pytest.mark.parametrize("case", ["dense_bpp", "sparse_hals"])
def test_smallkapi_nmf(case, tmp_path):
    rng = np.random.RandomState(0 if case == "dense_bpp" else 1)
    if case == "dense_bpp":
        A, k, alg, kw = rng.rand(30, 24), 4, "BPP", {}
    else:
        A = sp.random(40, 30, density=0.3, random_state=rng, format="csr")
        k, alg, kw = 3, "HALS", {"tol": 0.01}
    out = {}
    for name, mod in (("port", tapi), ("jax", japi)):
        api = _smallkapi(mod, 7)
        api.load_matrix(matrix=A)
        assert api.is_matrix_loaded()
        outdir = tmp_path / name
        outdir.mkdir()
        api.nmf(k, alg, outdir=str(outdir), **kw)
        inputs = api.get_inputs()
        inputs.pop("outdir")
        out[name] = (api.get_W(), api.get_H(), _files(outdir), inputs,
                     api.get_version_string())
        api.finalize()
    (W, H, files, inputs, ver), (Wj, Hj, jfiles, jinputs, jver) = (
        out["port"], out["jax"])
    assert W.shape == (A.shape[0], k) and H.shape == (k, A.shape[1])
    np.testing.assert_allclose(W, Wj, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(H, Hj, rtol=1e-8, atol=1e-9)
    assert sorted(files) == ["h.csv", "w.csv"] and files == jfiles
    assert inputs == jinputs and ver == jver


def test_smallkapi_hiernmf2_and_parser(tmp_path, monkeypatch):
    """The full reference flag surface plus --device, and hiernmf2 through
    the facade on the API's device."""
    argv = ["--matrixfile", "a.mtx", "--k", "3"]
    args = tapi.SmallkAPI(device="cpu").parser(argv)
    jargs = japi.SmallkAPI().parser(argv)
    assert args.device == "cuda"
    assert {**vars(args), "device": None} == {**vars(jargs), "device": None}
    assert tapi.SmallkAPI(device="cpu").parser(
        argv + ["--device", "cpu"]).device == "cpu"

    rng = np.random.RandomState(4)
    A = sp.random(40, 30, density=0.4, random_state=rng, format="csc")
    A.data[:] = np.abs(A.data) + 0.1
    monkeypatch.chdir(tmp_path)
    api = _smallkapi(tapi, 2)
    api.load_matrix(matrix=A)
    api.load_dictionary(dictionary=[f"term{i}" for i in range(40)])
    api.hiernmf2(3, format="JSON", maxterms=4, tol=1e-3)
    assert (tmp_path / "assignments_3.csv").exists()
    assert (tmp_path / "tree_3.json").exists()
    api.finalize()


def test_flatclust_class(tmp_path, monkeypatch):
    rng = np.random.RandomState(2)
    A = rng.rand(40, 32)
    words = [f"t{i}" for i in range(40)]
    out = {}
    for name, mod in (("port", tapi), ("jax", japi)):
        fc = mod.Flatclust(device="cpu") if mod is tapi else mod.Flatclust()
        fc.seed(5)
        fc.load_matrix(matrix=A)
        fc.load_dictionary(dictionary=words)
        ok = fc.cluster(4, algorithm="HALS", verbose=False, tol=0.001,
                        dtype="float64")
        assert ok
        outdir = tmp_path / name
        outdir.mkdir()
        fc.write_output(outdir=str(outdir), format="JSON")
        out[name] = (fc.W, fc.H, fc.get_assignments(), fc.get_top_terms(),
                     fc.get_top_indices(), _files(outdir),
                     fc._stats.iteration_count)
    port, ref = out["port"], out["jax"]
    np.testing.assert_allclose(port[0], ref[0], rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(port[1], ref[1], rtol=1e-8, atol=1e-9)
    np.testing.assert_array_equal(port[2], ref[2])
    assert port[2].shape == (32,)
    assert port[3] == ref[3] and len(port[3]) == 4 * 5
    np.testing.assert_array_equal(port[4], ref[4])
    assert "clusters_4.json" in port[5] and port[5] == ref[5]
    assert port[6] == ref[6]

    monkeypatch.setattr(sys, "argv", ["flatclust", "--matrixfile", "a.csv",
                                      "--dictfile", "d.txt", "--clusters",
                                      "4"])
    args, jargs = tapi.Flatclust().parser(), japi.Flatclust().parser()
    assert args.device == "cuda"
    assert {**vars(args), "device": None} == {**vars(jargs), "device": None}


@pytest.mark.parametrize("flat,fmt", [(1, "XML"), (0, "JSON")])
def test_hierclust_class(flat, fmt, tmp_path, monkeypatch):
    A, _ = _planted_sparse(48, 72, [24, 18, 16, 14], seed=3)
    A = sp.csc_matrix(A)
    initdir = _write_initdir(tmp_path, 48, 72, 60, seed=11)
    words = [f"t{i}" for i in range(48)]
    out = {}
    for name, mod in (("port", tapi), ("jax", japi)):
        hc = mod.Hierclust(device="cpu") if mod is tapi else mod.Hierclust()
        hc.seed(7)
        hc.load_matrix(matrix=A)
        hc.load_dictionary(dictionary=words)
        hc.cluster(4, initdir=initdir, verbose=False, flat=flat,
                   dtype="float64", min_iter=1)
        outdir = tmp_path / name
        outdir.mkdir()
        hc.write_output(outdir=str(outdir), format=fmt)
        out[name] = (hc.get_assignments(), hc.get_top_indices(),
                     _files(outdir))
    port, ref = out["port"], out["jax"]
    assert port[0].shape == (72,) and port[1].shape == (5, 4)
    np.testing.assert_array_equal(port[0], ref[0])
    np.testing.assert_array_equal(port[1], ref[1])
    names = {"assignments_4.csv", f"tree_4.{fmt.lower()}"}
    if flat:
        names |= {"assignments_flat_4.csv", "assignments_fuzzy_4.csv",
                  f"clusters_4.{fmt.lower()}"}
    assert set(port[2]) == names and port[2] == ref[2]

    monkeypatch.setattr(sys, "argv", ["hierclust", "--matrixfile", "a.mtx",
                                      "--dictfile", "d.txt", "--clusters",
                                      "4", "--device", "cpu"])
    assert tapi.Hierclust().parser().device == "cpu"


def test_hierclust_random_mode_and_graph_preset(tmp_path):
    """Random starts (the port's own generator): four leaves covering every
    document; the graph preset normalizes the adjacency and clusters it;
    restarts, priority_method and checkpoint_path reach the engine."""
    rng = np.random.RandomState(3)
    A = sp.random(60, 50, density=0.25, random_state=rng, format="csc")
    A.data = np.ceil(A.data * 5)
    hc = tapi.Hierclust(device="cpu")
    hc.seed(7)
    hc.load_matrix(matrix=A)
    hc.load_dictionary(dictionary=[f"t{i}" for i in range(60)])
    ckpt = str(tmp_path / "run.ckpt")
    assert hc.cluster(4, verbose=False, flat=1, dtype="float64", restarts=2,
                      priority_method="size_ndcg", checkpoint_path=ckpt)
    assert os.path.exists(ckpt)
    assert hc.get_assignments().shape == (50,)
    assert hc.get_top_indices().shape == (5, 4)
    assert sum(hc.tree.is_leaf) == 4

    from smallk_torch.engines.corpus import planted_partition_graph

    G, _ = planted_partition_graph(120, 3, seed=2)
    gc = tapi.Hierclust(device="cpu")
    gc.seed(1)
    gc.load_matrix(matrix=G)
    gc.load_dictionary(dictionary=[f"n{i}" for i in range(120)])
    gc.cluster(3, verbose=False, dtype="float64", graph=True)
    assert sum(gc.tree.is_leaf) == 3
    assert gc.get_assignments().shape == (120,)


def test_mesh_raises_and_default_device():
    fc, hc = tapi.Flatclust(device="cpu"), tapi.Hierclust(device="cpu")
    for c in (fc, hc):
        c.load_matrix(matrix=np.random.RandomState(0).rand(8, 6))
        # a mesh that is not the port's (a JAX mesh, say) is refused
        with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
            c.cluster(2, mesh=object())
    if torch.cuda.is_available():
        return
    # the default device is the card: without one the API raises
    fc = tapi.Flatclust()
    fc.load_matrix(matrix=np.random.RandomState(0).rand(8, 6))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fc.cluster(2, verbose=False)
    api = tapi.SmallkAPI()
    api.load_matrix(matrix=np.random.RandomState(0).rand(8, 6))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.nmf(2, "BPP")
    api.finalize()


def test_matrixgen_class(tmp_path):
    out = {}
    for name, mod in (("port", tapi), ("jax", japi)):
        mg = mod.Matrixgen()
        mg.seed(1)
        got = [mg.uniform(10, 8), mg.densediag(6, 5, 2.0, 0.5),
               mg.sparsediag(7), mg.identity(4, 4), mg.ones(3, 3),
               mg.zeros(3, 3), mg.sparse(20, 10, 3)]
        mg.write_output(str(tmp_path / f"{name}.mtx"), precision=6)
        mg.uniform(5, 4)
        mg.write_output(str(tmp_path / f"{name}.csv"), precision=9)
        out[name] = got
    for a, b in zip(out["port"], out["jax"], strict=True):
        assert sp.issparse(a) == sp.issparse(b)
        if sp.issparse(b):
            a, b = a.toarray(), b.toarray()
        np.testing.assert_array_equal(a, b)
    assert out["port"][0].shape == (10, 8)
    assert out["port"][3].trace() == 4 and out["port"][4].sum() == 9
    for ext in ("mtx", "csv"):
        assert (tmp_path / f"port.{ext}").read_bytes() == \
            (tmp_path / f"jax.{ext}").read_bytes()


def test_preprocessor_class(tmp_path):
    rng = np.random.RandomState(4)
    A = sp.random(50, 40, density=0.3, random_state=rng, format="csc")
    A.data = np.ceil(A.data * 9)
    out = {}
    for name, mod in (("port", tapi), ("jax", japi)):
        pre = mod.Preprocessor()
        pre.load_matrix(matrix=A)
        pre.load_dictionary(dictionary=[f"t{i}" for i in range(50)])
        pre.load_documents(documents=[f"d{i}" for i in range(40)])
        pre.preprocess(docsperterm=2, termsperdoc=3)
        assert len(pre.get_reduced_dictionary()) == \
            pre.result.matrix.shape[0]
        outdir = tmp_path / name
        outdir.mkdir()
        pre.write_output(str(outdir / "reduced_matrix.mtx"),
                         str(outdir / "reduced_dictionary.txt"),
                         str(outdir / "reduced_documents.txt"))
        out[name] = (pre.get_reduced_scores(), pre.get_reduced_row_indices(),
                     pre.get_reduced_col_offsets(),
                     pre.get_reduced_documents(),
                     pre.get_reduced_field(values=[f"f{i}"
                                                   for i in range(40)]),
                     _files(outdir))
    port, ref = out["port"], out["jax"]
    for a, b in zip(port[:3], ref[:3], strict=True):
        np.testing.assert_array_equal(a, b)
    assert port[3:] == ref[3:]
    assert port[0].size > 0
