"""The port's preprocessor (engines/preprocess.py) and its two host-only
CLIs (preprocessor_cli, matrixgen_cli) against the JAX package's: the
same results on tests/test_engines.py's inputs, byte-equal files and the
same exit codes."""

import numpy as np
import pytest
import scipy.sparse as sp

from smallk_tpu.cli.matrixgen_cli import entry as jmg_entry
from smallk_tpu.cli.preprocessor_cli import entry as jpre_entry
from smallk_tpu.engines.preprocess import preprocess_tf as jpreprocess_tf
from smallk_tpu.engines.preprocess import (
    term_occurrence_histogram as jhistogram,
)
from smallk_torch.cli.matrixgen_cli import build_parser as mg_parser
from smallk_torch.cli.matrixgen_cli import entry as mg_entry
from smallk_torch.cli.preprocessor_cli import build_parser as pre_parser
from smallk_torch.cli.preprocessor_cli import entry as pre_entry
from smallk_torch.engines.preprocess import (
    preprocess_tf,
    term_occurrence_histogram,
)
from smallk_torch.io.matrix_market import write_matrix_market


def _toy():
    """tests/test_engines.py::TestPreprocessor._toy: 6 terms x 8 docs, a
    term in every document, a rare term."""
    rows, cols, vals = [], [], []
    for c in range(8):
        rows.append(0), cols.append(c), vals.append(5)
    for r in range(1, 5):
        for c in range(8):
            if (r + c) % 2 == 0:
                rows.append(r), cols.append(c), vals.append(r + 1)
    rows.append(5), cols.append(0), vals.append(1)
    return sp.csc_matrix((vals, (rows, cols)), shape=(6, 8),
                         dtype=np.float64)


def _random(m, n, density, seed, scale):
    A = sp.random(m, n, density=density,
                  random_state=np.random.RandomState(seed), format="csc")
    A.data = np.ceil(A.data * scale)
    return A


def _dup_cols():
    A = np.zeros((10, 6))
    rng = np.random.RandomState(1)
    for c in range(6):
        A[rng.choice(10, 6, replace=False), c] = 1 + rng.randint(1, 4, 6)
    A[:, 5] = A[:, 1]
    return sp.csc_matrix(A)


def _news():
    """The 20news-shaped corpus of test_20news_shape_performance."""
    rng = np.random.RandomState(3)
    m, n, nnz = 39771, 11237, 877_453
    A = sp.csc_matrix((rng.randint(1, 20, nnz).astype(np.float64),
                       (rng.randint(0, m, nnz), rng.randint(0, n, nnz))),
                      shape=(m, n))
    return A


CASES = {
    "toy": (_toy, dict(docs_per_term=3, terms_per_doc=1)),
    "prune_cols": (lambda: _random(40, 30, 0.3, 0, 5),
                   dict(docs_per_term=1, terms_per_doc=10)),
    "dedup": (_dup_cols, dict(docs_per_term=1, terms_per_doc=1)),
    "tfidf": (lambda: _random(50, 40, 0.3, 2, 9),
              dict(docs_per_term=2, terms_per_doc=3)),
    "boolean": (lambda: _random(30, 20, 0.4, 4, 9),
                dict(docs_per_term=2, terms_per_doc=2, boolean_mode=True)),
    "dense_input": (lambda: _random(30, 25, 0.5, 6, 4).toarray(),
                    dict(docs_per_term=2, terms_per_doc=2, max_iter=1)),
    "20news": (_news, dict(docs_per_term=3, terms_per_doc=5)),
}


def _same_csc(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


@pytest.mark.parametrize("case", sorted(CASES))
def test_preprocess_tf_matches_reference(case, capsys):
    make, kw = CASES[case]
    A = make()
    res = preprocess_tf(A, **kw)
    out = capsys.readouterr().out
    ref = jpreprocess_tf(A, **kw)
    assert out == capsys.readouterr().out  # the same progress lines
    _same_csc(res.matrix, ref.matrix)
    _same_csc(res.tf_matrix, ref.tf_matrix)
    np.testing.assert_array_equal(res.term_indices, ref.term_indices)
    np.testing.assert_array_equal(res.doc_indices, ref.doc_indices)
    assert res.matrix.shape[0] > 0
    if case == "toy":
        assert 0 not in res.term_indices and 5 not in res.term_indices
    if case == "dedup":
        assert 5 in res.doc_indices and 1 not in res.doc_indices
    for got, want in zip(term_occurrence_histogram(res.tf_matrix),
                         jhistogram(ref.tf_matrix), strict=True):
        np.testing.assert_array_equal(got, want)


def test_all_cols_pruned_raises_as_reference():
    A = sp.csc_matrix(np.ones((4, 4)))
    for fn in (preprocess_tf, jpreprocess_tf):
        with pytest.raises(ValueError, match="all columns were pruned"):
            fn(A, docs_per_term=1, terms_per_doc=100, verbose=False)


def _indir(tmp_path, m=80, n=60):
    A = _random(m, n, 0.25, 1, 9)
    indir = tmp_path / "in"
    indir.mkdir()
    write_matrix_market(str(indir / "matrix.mtx"), A)
    (indir / "dictionary.txt").write_text(
        "".join(f"term{i}\n" for i in range(m)))
    (indir / "documents.txt").write_text(
        "".join(f"doc{i}\n" for i in range(n)))
    return indir


@pytest.mark.parametrize("extra", [[], ["--docs_per_term", "2",
                                        "--terms_per_doc", "3",
                                        "--precision", "6"],
                                   ["--boolean_mode", "1", "--maxiter", "1"]])
def test_preprocessor_cli_byte_equal(extra, tmp_path):
    indir = _indir(tmp_path)
    outs = {}
    for name, entry in (("port", pre_entry), ("jax", jpre_entry)):
        out = tmp_path / name
        out.mkdir()
        assert entry(["--indir", str(indir), "--outdir", str(out),
                      *extra]) == 0
        outs[name] = {p.name: p.read_bytes() for p in sorted(out.iterdir())}
    assert sorted(outs["port"]) == ["reduced_dictionary.txt",
                                    "reduced_documents.txt",
                                    "reduced_matrix.mtx"]
    assert outs["port"] == outs["jax"]


@pytest.mark.parametrize("kind,extra", [
    ("UNIFORM", []), ("DENSE_DIAG", ["--rng_center", "2", "--rng_radius",
                                     "0.25"]),
    ("SPARSE_DIAG", []), ("IDENTITY", []), ("ONES", []), ("ZEROS", []),
    ("SPARSE", ["--nz_per_col", "4", "--precision", "9"])])
def test_matrixgen_cli_byte_equal(kind, extra, tmp_path):
    ext = "mtx" if kind in ("SPARSE", "SPARSE_DIAG") else "csv"
    files = {}
    for name, entry in (("port", mg_entry), ("jax", jmg_entry)):
        path = tmp_path / f"{name}.{ext}"
        assert entry(["--height", "30", "--width", "30", "--filename",
                      str(path), "--type", kind, "--seed", "7",
                      *extra]) == 0
        files[name] = path.read_bytes()
    assert files["port"] == files["jax"] and files["port"]


def test_cli_exit_codes_equal_reference(tmp_path):
    """Usage errors, a missing input folder and a bad generator type exit
    with the reference's Result codes; neither tool takes --device or
    --compile-cache."""
    bad = [
        (pre_entry, jpre_entry, []),
        (pre_entry, jpre_entry, ["--indir", str(tmp_path / "none")]),
        (mg_entry, jmg_entry, ["--height", "3"]),
        (mg_entry, jmg_entry, ["--height", "3", "--width", "3",
                               "--filename", str(tmp_path / "x.csv"),
                               "--type", "GAUSSIAN"]),
        (mg_entry, jmg_entry, ["--height", "3", "--width", "3",
                               "--filename",
                               str(tmp_path / "no" / "x.csv")]),
    ]
    for port, ref, argv in bad:
        rc = port(argv)
        assert rc == ref(argv) and rc != 0, argv
    for parser in (mg_parser(), pre_parser()):
        flags = {a.dest for a in parser._actions}
        assert "device" not in flags and "compile_cache" not in flags
