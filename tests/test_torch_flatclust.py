"""The port's flatclust (library and CLI) against the JAX package (f64 on
the CPU), the result writer byte for byte, and the import boundary of the
new modules."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import smallk_tpu.common.options as jopt
from smallk_tpu.cli.flatclust_cli import main as jflat_main
from smallk_tpu.engines.flatclust import run_flatclust as jrun_flatclust
from smallk_tpu.engines.flatclust import (
    write_flatclust_results as jwrite_results,
)
from smallk_tpu.io.matrix_market import write_matrix_market
from smallk_torch.cli.flatclust_cli import entry as tflat_entry
from smallk_torch.cli.flatclust_cli import main as tflat_main
from smallk_torch.common import options as topt
from smallk_torch.engines.flatclust import run_flatclust, write_flatclust_results

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-8, 1e-9
M, N = 60, 45


def _opts(pkg, algorithm, **kw):
    """NmfOptions of `pkg`'s own options module (`topt`, the port's, or
    `jopt`, the JAX package's)."""
    return pkg.NmfOptions(algorithm=pkg.NmfAlgorithm(algorithm), **kw)


def _operand(sparse, seed=0):
    rng = np.random.RandomState(seed)
    if sparse:
        A = sp.random(M, N, density=0.3, random_state=rng, format="csc")
        A.data = np.ceil(A.data * 9)
        return A
    return rng.rand(M, N)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("algorithm", ["HALS", "RANK2", "BPP"])
def test_run_flatclust_matches_reference(algorithm, sparse):
    k = 2 if algorithm == "RANK2" else 5
    A = _operand(sparse)
    rng = np.random.RandomState(1)
    W0, H0 = rng.rand(M, k), rng.rand(k, N)
    kw = dict(height=M, width=N, k=k, dtype="float64", verbose=False,
              tol=1e-4)
    st, jst = topt.NmfStats(), jopt.NmfStats()
    W, H, assign, fuzzy, ok = run_flatclust(
        A, W0, H0, _opts(topt, algorithm, **kw), st, device="cpu")
    Wj, Hj, assign_j, fuzzy_j, okj = jrun_flatclust(
        A, W0, H0, _opts(jopt, algorithm, **kw), jst)
    assert ok and okj
    assert st.iteration_count == jst.iteration_count > 1
    assert st.elapsed_us > 0
    np.testing.assert_allclose(W, Wj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(H, Hj, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(assign, assign_j)
    assert assign.shape == (N,) and assign.dtype == assign_j.dtype
    assert fuzzy.dtype == np.float32 and fuzzy.shape == (k, N)
    np.testing.assert_allclose(fuzzy, fuzzy_j, rtol=0, atol=1e-6)


def test_run_flatclust_refuses_mu():
    A = _operand(False)
    rng = np.random.RandomState(2)
    args = (A, rng.rand(M, 3), rng.rand(3, N))
    kw = dict(height=M, width=N, k=3, dtype="float64")
    with pytest.raises(ValueError, match="excludes MU"):
        run_flatclust(*args, _opts(topt, "MU", **kw), device="cpu")
    with pytest.raises(ValueError, match="excludes MU"):
        jrun_flatclust(*args, _opts(jopt, "MU", **kw))


@pytest.mark.parametrize("fmt", ["XML", "JSON"])
def test_write_flatclust_results_byte_equal(fmt, tmp_path):
    rng = np.random.RandomState(3)
    k, n, m = 4, 37, 25
    H = rng.rand(k, n)
    H[:, 5] = 0.0  # an all-zero column: fuzzy falls back to the raw H
    W = rng.rand(m, k)
    assign = np.argmax(H, axis=0).astype(np.int32)
    fuzzy = (H / np.where(H.sum(0) == 0, 1, H.sum(0))).astype(np.float32)
    dictionary = [f"term{i}" for i in range(m)]
    files = {}
    for name, write, pkg in (("port", write_flatclust_results, topt),
                             ("jax", jwrite_results, jopt)):
        out = tmp_path / name
        out.mkdir()
        paths = write(str(out), assign, fuzzy, W, dictionary, 3,
                      pkg.OutputFormat(fmt), k,
                      assignments_prefix="assignments_flat_")
        files[name] = {os.path.basename(p): Path(p).read_bytes()
                       for p in paths}
    assert sorted(files["port"]) == sorted(
        ["assignments_flat_4.csv", "assignments_fuzzy_4.csv",
         f"clusters_4.{fmt.lower()}"])
    assert files["port"] == files["jax"]


@pytest.fixture
def corpus(tmp_path):
    """Synthetic sparse term-doc corpus on disk (tests/test_cli.py)."""
    rng = np.random.RandomState(0)
    m, n = 120, 90
    A = sp.random(m, n, density=0.15, random_state=rng, format="csc")
    A.data = np.ceil(A.data * 9)
    mtx = str(tmp_path / "corpus.mtx")
    write_matrix_market(mtx, A)
    dic = str(tmp_path / "dict.txt")
    with open(dic, "w") as f:
        for i in range(m):
            f.write(f"term{i}\n")
    return mtx, dic, tmp_path


def _read_outputs(outdir):
    return {p.name: p.read_bytes() for p in sorted(Path(outdir).iterdir())}


def _fuzzy(blob):
    return np.array([[float(v) for v in line.split(",")]
                     for line in blob.decode().strip().splitlines()])


@pytest.mark.parametrize("algorithm,clusters,fmt", [("HALS", 4, "XML"),
                                                    ("RANK2", 2, "JSON"),
                                                    ("BPP", 5, "XML")])
def test_cli_matches_reference_cli(corpus, algorithm, clusters, fmt):
    mtx, dic, tmp_path = corpus
    outs = {}
    for name, main, extra in (("port", tflat_main, ["--device", "cpu"]),
                              ("jax", jflat_main, [])):
        outdir = tmp_path / name
        outdir.mkdir()
        assert main([
            "--matrixfile", mtx, "--dictfile", dic, "--clusters",
            str(clusters), "--algorithm", algorithm, "--outdir", str(outdir),
            "--format", fmt, "--verbose", "0", "--seed", "5", "--dtype",
            "float64", "--tol", "0.001", *extra]) == 0
        outs[name] = _read_outputs(outdir)
    port, ref = outs["port"], outs["jax"]
    fuzzy = f"assignments_fuzzy_{clusters}.csv"
    assert sorted(port) == sorted(ref) == sorted(
        [f"assignments_{clusters}.csv", fuzzy,
         f"clusters_{clusters}.{fmt.lower()}"])
    for name in port:
        if name == fuzzy:  # f32 values printed to 4 digits
            np.testing.assert_allclose(_fuzzy(port[name]), _fuzzy(ref[name]),
                                       rtol=0, atol=1e-6)
        else:
            assert port[name] == ref[name], name
    assign = port[f"assignments_{clusters}.csv"].decode().strip().split(",")
    assert len(assign) == 90


def test_cli_renames_and_exit_codes(corpus, capsys):
    mtx, dic, tmp_path = corpus
    outdir = str(tmp_path / "out")
    os.mkdir(outdir)
    base = ["--matrixfile", mtx, "--dictfile", dic, "--clusters", "3",
            "--algorithm", "HALS", "--outdir", outdir, "--verbose", "0",
            "--seed", "2", "--device", "cpu", "--maxiter", "30"]
    assert tflat_entry(base + ["--clustfile", "c.xml", "--assignfile",
                               "a.csv"]) == 0
    assert sorted(os.listdir(outdir)) == ["a.csv", "assignments_fuzzy_3.csv",
                                          "c.xml"]
    assert "iterations;" in capsys.readouterr().out
    # BAD_PARAM: an algorithm flatclust does not offer, an unknown flag,
    # a missing file; usage errors too
    assert tflat_entry(base + ["--algorithm", "MU"]) == 2
    assert tflat_entry(base + ["--mesh", "1x8"]) == 2
    assert tflat_entry(["--matrixfile", str(tmp_path / "no.mtx"),
                        "--dictfile", dic, "--clusters", "3",
                        "--device", "cpu"]) == 2
    assert tflat_entry(["--clusters", "3"]) == 2
    # FAILURE: a CUDA device without a card (the port never falls back)
    if not torch.cuda.is_available():
        assert tflat_entry(base[:-4] + ["--device", "cuda"]) == 1


_NO_JAX = r"""
import sys
import numpy as np
import scipy.sparse as sp
import smallk_torch.cli.flatclust_cli as cli
import smallk_torch.engines.flatclust
import smallk_torch.interop
import smallk_torch.kernels.hals_step
import smallk_torch.solvers.hals
import smallk_torch.solvers.mu
import smallk_torch.solvers.nnls
import smallk_torch.solvers.rank2
out = sys.argv[1]
A = sp.random(80, 60, density=0.2, random_state=1, format="coo")
A.data = np.ceil(A.data * 9)
mtx = out + "/a.mtx"
with open(mtx, "w") as f:
    f.write("%%MatrixMarket matrix coordinate real general\n")
    f.write(f"80 60 {A.nnz}\n")
    for i, j, v in zip(A.row, A.col, A.data):
        f.write(f"{i + 1} {j + 1} {v}\n")
with open(out + "/dict.txt", "w") as f:
    f.write("".join(f"t{i}\n" for i in range(80)))
for alg, k in (("HALS", 4), ("RANK2", 2), ("BPP", 3)):
    rc = cli.entry(["--matrixfile", mtx, "--dictfile", out + "/dict.txt",
                    "--clusters", str(k), "--algorithm", alg, "--outdir",
                    out, "--verbose", "0", "--seed", "1", "--device", "cpu",
                    "--maxiter", "20"])
    assert rc == 0, (alg, rc)
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
print("ok")
"""


def test_new_modules_never_import_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    env.pop("SMALLK_TPU_COMPILE_CACHE", None)
    proc = subprocess.run([sys.executable, "-c", _NO_JAX, str(tmp_path)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"
    assert (tmp_path / "clusters_4.xml").is_file()
