"""The port's example drivers (examples/torch_drivers/) run end to end on
the CPU (`--device cpu`), beside the JAX package's drivers
(examples/drivers/) on the same arguments: the same printed results where
the run is deterministic in both packages."""

import os
import runpy
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from smallk_torch.io.matrix_market import load_matrix_market

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]


def _run(pkg, name, argv, capsys):
    """Run examples/<pkg>/<name>.py as __main__ with `argv`; its stdout."""
    path = os.path.join(REPO, "examples", pkg, f"{name}.py")
    old_argv = sys.argv
    sys.argv = [path] + argv
    capsys.readouterr()
    try:
        runpy.run_path(path, run_name="__main__")
    except SystemExit as e:
        assert not e.code
    finally:
        sys.argv = old_argv
    return capsys.readouterr().out


def _both(name, argv, capsys, port_extra=CPU):
    return (_run("torch_drivers", name, argv + port_extra, capsys),
            _run("drivers", name, argv, capsys))


def test_smallkapi_inmem(capsys):
    out, ref = _both("smallkapi_inmem", [], capsys)
    for line in ("dense W: (100, 8)", "sparse W: (200, 6)",
                 "buffer W: (200, 4)"):
        assert line in out and line in ref


def test_flatclust_inmem(capsys):
    out, ref = _both("flatclust_inmem", [], capsys)
    assert "clusters found:" in out and "top terms per cluster:" in out
    assert out.count("  cluster ") == ref.count("  cluster ") == 16


def test_hierclust_inmem(capsys):
    out = _run("torch_drivers", "hierclust_inmem", CPU, capsys)
    assert "clusters found:" in out
    assert "top terms per leaf:" in out and out.count("  leaf ") == 6


def test_preprocessor_inmem(capsys):
    out, ref = _both("preprocessor_inmem", [], capsys, port_extra=[])
    assert "columns tf-idf unit-normalized: True" in out
    assert out == ref


def test_smallkapi_driver(tmp_path, monkeypatch, capsys):
    """The documented invocations: NMF, and `--hiernmf2 1` writing the
    tree and assignments."""
    rng = np.random.RandomState(4)
    A = sp.random(40, 30, density=0.4, random_state=rng, format="csc")
    A.data[:] = np.abs(A.data) + 0.1
    from smallk_torch.io.matrix_market import write_matrix_market

    mtx = tmp_path / "a.mtx"
    write_matrix_market(str(mtx), A)
    dic = tmp_path / "dict.txt"
    dic.write_text("\n".join(f"term{i}" for i in range(40)) + "\n")
    monkeypatch.chdir(tmp_path)
    out, ref = _both("smallkapi", ["--matrixfile", str(mtx), "--k", "3",
                                   "--maxiter", "50"], capsys)
    assert "W: (40, 3) H: (3, 30)" in out and out.splitlines()[-1] == \
        ref.splitlines()[-1]
    _run("torch_drivers", "smallkapi", [
        "--matrixfile", str(mtx), "--k", "3", "--dictfile", str(dic),
        "--hiernmf2", "1", "--format", "JSON", "--maxterms", "4",
        "--tol", "1e-3", *CPU], capsys)
    assert (tmp_path / "assignments_3.csv").exists()
    assert (tmp_path / "tree_3.json").exists()


def test_command_line_drivers_chained(tmp_path, capsys):
    """matrixgen -> preprocessor -> flatclust and hierclust, each through
    the API class of its driver; the preprocessor writes the reference
    driver's files (matrixgen's driver, as pysmallk's, takes no seed)."""
    indir = tmp_path / "in"
    indir.mkdir()
    out = _run("torch_drivers", "matrixgen", [
        "--height", "120", "--width", "90", "--filename",
        str(indir / "matrix.mtx"), "--type", "SPARSE", "--nz_per_col",
        "20"], capsys)
    assert load_matrix_market(str(indir / "matrix.mtx")).shape == (120, 90)
    assert "wrote" in out
    (indir / "dictionary.txt").write_text(
        "".join(f"term{i}\n" for i in range(120)))
    (indir / "documents.txt").write_text(
        "".join(f"doc{i}\n" for i in range(90)))
    red = {}
    for pkg in ("torch_drivers", "drivers"):
        d = tmp_path / f"{pkg}_out"
        d.mkdir()
        out = _run(pkg, "preprocessor", ["--indir", str(indir), "--outdir",
                                         str(d)], capsys)
        red[pkg] = ({p.name: p.read_bytes() for p in d.iterdir()}, out)
    assert red["torch_drivers"] == red["drivers"]

    reduced = tmp_path / "torch_drivers_out"
    R = load_matrix_market(str(reduced / "reduced_matrix.mtx"))
    args = ["--matrixfile", str(reduced / "reduced_matrix.mtx"),
            "--dictfile", str(reduced / "reduced_dictionary.txt"),
            "--clusters", "3", "--verbose", "0", "--maxiter", "300",
            *CPU]
    for name in ("flatclust", "hierclust"):
        od = tmp_path / name
        od.mkdir()
        out = _run("torch_drivers", name, args + ["--outdir", str(od)],
                   capsys)
        assert f"assignments: ({R.shape[1]},)" in out
        assert (od / "assignments_3.csv").exists()


def test_community_graph_driver(tmp_path, capsys):
    out = _run("torch_drivers", "community_graph",
               ["--communities", "4", "--seed", "5", "--outdir",
                str(tmp_path), *CPU], capsys)
    assert "NMI=" in out
    assign = np.loadtxt(tmp_path / "communities_4.csv", delimiter=",",
                        dtype=np.int64)
    assert assign.shape == (3000,)
    nmi = float(out.split("NMI=")[1].split()[0])
    assert nmi > 0.5


# examples/*.py that the port carries beside the drivers
TOP_LEVEL = ["large_corpus_demo.py", "multihost_demo.py", "scaling_demo.py",
             "smallk_example.py"]


def test_drivers_mirror_the_reference_set():
    """The port's drivers are the reference's drivers and the two
    top-level examples, each importing the port and not the JAX package."""
    ref = sorted(os.listdir(os.path.join(REPO, "examples", "drivers")))
    port = sorted(os.listdir(os.path.join(REPO, "examples",
                                          "torch_drivers")))
    ref = [f for f in ref if f.endswith(".py")]
    assert len(ref) == 10
    for name in TOP_LEVEL:
        assert os.path.exists(os.path.join(REPO, "examples", name))
    ref = sorted(ref + TOP_LEVEL)
    assert [f for f in port if f.endswith(".py")] == ref
    for name in ref:
        text = open(os.path.join(REPO, "examples", "torch_drivers",
                                 name)).read()
        assert "smallk_tpu" not in text and "smallk_torch" in text, name


@pytest.mark.slow
def test_smallk_example_synthetic(capsys):
    """The facade walkthrough on its synthetic corpus, as the reference's
    (tests/test_examples.py, marked slow there too)."""
    out = _run("torch_drivers", "smallk_example", ["--synthetic", *CPU],
               capsys)
    assert "HierNmf2" in out and "W factor: (1200, 32)" in out


def test_large_corpus_demo(capsys):
    """The blocked bf16 EllAOp, BPP and the checkpoint driver at the
    reference test's size, beside the reference's demo."""
    path = os.path.join(REPO, "examples", "torch_drivers",
                        "large_corpus_demo.py")
    mod = runpy.run_path(path, run_name="demo")
    W, H, total, success = mod["main"](m=400, n=500, k=8, nz_per_col=12,
                                       iters=12, device="cpu")
    assert success and total == 12
    assert (W > 0).any() and (H > 0).any()
    out = capsys.readouterr().out
    assert "resume: returns at iteration 12" in out
    assert "on cpu" in out


def _spawning(name, argv, capfd):
    """Run examples/torch_drivers/<name>.py as __main__; the output of the
    ranks it starts (processes of their own) too."""
    path = os.path.join(REPO, "examples", "torch_drivers", f"{name}.py")
    old_argv = sys.argv
    sys.argv = [path] + argv
    capfd.readouterr()
    try:
        runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = old_argv
    return capfd.readouterr().out


def test_multihost_demo(capfd):
    """Two processes joined into one gloo world, a 2 x 1 mesh: each moves
    its block of the host matrix and runs BPP on it."""
    out = _spawning("multihost_demo", CPU, capfd)
    assert "multihost demo OK" in out
    for pid, rows in ((0, "(0, 32)"), (1, "(32, 64)")):
        assert f"[p{pid}] OK: " in out and f"W rows {rows}" in out


def test_scaling_demo(capfd):
    out = _spawning("scaling_demo", CPU + ["--size", "96", "--iters", "3"],
                    capfd)
    assert "mesh (1, 1): " in out and "mesh (1, 2): " in out


def test_dryrun_multichip(capfd):
    """The port of __graft_entry__.dryrun_multichip on two gloo ranks: the
    dense, COO, ELL and blocked-ELL solves, hierclust with its checkpoint
    resume, flatclust and preprocess -> NMF on a (2, 1) mesh."""
    from smallk_torch.parallel.dryrun import dryrun_multichip

    capfd.readouterr()
    dryrun_multichip(2, device="cpu")
    out = capfd.readouterr().out
    assert "dryrun_multichip OK: mesh (2, 1) over 2 ranks (gloo, cpu)" in out
