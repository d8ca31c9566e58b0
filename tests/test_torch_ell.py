"""The port's sparse operands (ops/ell.EllAOp, ops/aop.SparseAOp), as_aop's
sparse branch, the operand interop and the solvers on a sparse operand,
against the JAX package on the same inputs (f64 on the CPU unless a test
says otherwise)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp
import torch

import smallk_tpu.common.options as jopt
import smallk_tpu.ops.ell as jell
from smallk_tpu.ops.aop import SparseAOp as JSparseAOp
from smallk_tpu.solvers.solve import nmf_solve as jnmf_solve
from smallk_torch.cli.nmf_cli import entry as tnmf_entry
from smallk_torch.common import options as topt
from smallk_torch.common.rng import Random
from smallk_torch.engines import nmf as tnmf
from smallk_torch.engines.flatclust import run_hier_nmf2
from smallk_torch.engines.hierclust import clust_hier
from smallk_torch.interop import from_reference, operand_from_reference
from smallk_torch.io.delimited import load_delimited
from smallk_torch.ops import ell as tell
from smallk_torch.ops.aop import DenseAOp, SparseAOp, as_aop
from smallk_torch.ops.ell import EllAOp
from smallk_torch.solvers.solve import nmf_solve

torch.set_num_threads(1)

F64_RTOL = 1e-12           # the same sums in another order
F32_RTOL, F32_ATOL = 1e-5, 1e-6   # f32 sums of bf16 values, other orders
SOLVE_RTOL, SOLVE_ATOL = 1e-8, 1e-9   # as tests/test_torch_solvers.py


def _random(m, n, density, seed):
    return sp.random(m, n, density=density, random_state=seed, format="csc")


def _concentrated(m=400, n=256, lo=75, hi=82, seed=11):
    """Columns of ~80 nonzeros, as the flagship corpus has: a populous
    pow-2 class (128) that the fine ladder splits."""
    rng = np.random.RandomState(seed)
    cols, rows, vals = [], [], []
    for j in range(n):
        nzc = rng.randint(lo, hi)
        rows.append(rng.choice(m, size=nzc, replace=False))
        cols.append(np.full(nzc, j))
        vals.append(rng.rand(nzc))
    return sp.csc_matrix((np.concatenate(vals), (np.concatenate(rows),
                                                 np.concatenate(cols))),
                         shape=(m, n))


def _fine(monkeypatch, gate=64):
    """The fine ladder forced on in both packages."""
    monkeypatch.setattr(jell, "_FINE_SPLIT_MIN", gate)
    monkeypatch.setattr(tell, "_FINE_SPLIT_MIN", gate)


def _pairs(top, jop, fam):
    """(port inv, port buckets, ref inv, ref buckets) per block of one
    family ("col" or "row")."""
    tb, jb = getattr(top, f"{fam}_blocks"), getattr(jop, f"{fam}_blocks")
    if jb is None:
        assert tb is None
        return [(getattr(top, f"{fam}_inv"), getattr(top, f"{fam}_buckets"),
                 getattr(jop, f"{fam}_inv"), getattr(jop, f"{fam}_buckets"))]
    assert len(tb) == len(jb)
    return [(ti, tbk, ji, jbk) for (ti, tbk), (ji, jbk) in zip(tb, jb)]


def _assert_same_layout(top, jop):
    """Exactly the reference's buckets: inv, idx, vals (in f64), blocks;
    and each bucket's ids are the majors at its stacked positions."""
    assert top.shape == tuple(jop.shape)
    assert (top.row_block_size, top.col_block_size) == (
        jop.row_block_size, jop.col_block_size)
    for fam in ("col", "row"):
        for ti, tbk, ji, jbk in _pairs(top, jop, fam):
            np.testing.assert_array_equal(ti, np.asarray(ji))
            assert len(tbk) == len(jbk)
            off = 0
            for (ids, idx, vals), (jidx, jvals) in zip(tbk, jbk):
                np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
                np.testing.assert_array_equal(
                    vals.double().numpy(),
                    np.asarray(jvals).astype(np.float64))
                np.testing.assert_array_equal(
                    ti[ids.numpy()], off + np.arange(ids.shape[0]))
                off += idx.shape[0]


LAYOUTS = {
    "monolithic": dict(),
    "blocked": dict(doc_block=64, term_block=32),
    "doc_blocked_padded": dict(doc_block=100, pad_multiple=4),
    "fine_ladder": dict(fine=True),
}


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_bucket_layout_equals_reference(case, monkeypatch):
    kw = dict(LAYOUTS[case])
    if kw.pop("fine", False):
        _fine(monkeypatch)
        A = _concentrated()
    else:
        A = _random(70, 300, 0.05, seed=9)
    top = EllAOp.from_scipy(A, torch.float64, device="cpu", **kw)
    jop = jell.EllAOp.from_scipy(A, jnp.float64, **kw)
    _assert_same_layout(top, jop)
    assert top.padded_nnz == jop.padded_nnz
    if case == "fine_ladder":  # the ladder really was refined
        assert all(idx.shape[1] < 128 for _, idx, _ in top.col_buckets)
    # the interop crossing reads the reference's buckets as they are
    conv = operand_from_reference(jop, device="cpu")
    _assert_same_layout(conv, jop)


@pytest.mark.parametrize("min_len", [64, 128])
def test_refined_targets_respect_min_len(min_len, monkeypatch):
    """The reference's refined ladder puts short slices of a class raised
    to min_len below min_len.  The port clamps; its products still
    agree."""
    _fine(monkeypatch)
    A = _concentrated(300, 200, 5, 40, seed=3)
    top = EllAOp.from_scipy(A, torch.float64, min_len=min_len, device="cpu")
    jop = jell.EllAOp.from_scipy(A, jnp.float64, min_len=min_len)
    assert min(idx.shape[1] for _, idx, _ in top.col_buckets) >= min_len
    assert min(idx.shape[1] for idx, _ in jop.col_buckets) < min_len
    lengths = np.diff(A.indptr)
    assert (tell._target_lengths(lengths, min_len) >= min_len).all()
    np.testing.assert_array_equal(tell._target_lengths(lengths, 8),
                                  jell._target_lengths(lengths, 8))
    W = np.random.RandomState(1).rand(300, 3)
    np.testing.assert_allclose(top.mm_tn(torch.from_numpy(W)).numpy(),
                               np.asarray(jop.mm_tn(jnp.asarray(W))),
                               rtol=F64_RTOL, atol=F64_RTOL)


@pytest.mark.parametrize("kind", ["ell", "coo"])
def test_bf16_storage_rounds_as_the_reference(kind):
    """bf16 values equal the reference's bit for bit, including values
    whose rounding through f32 differs from a direct f64 -> bf16 rounding
    (both packages round f64 -> f32 -> bf16)."""
    A = _random(40, 30, 0.2, seed=4)
    A.data[:4] = [1 + 2**-8 + 2**-30, -(1 + 2**-8 + 2**-30), 0.3, 1e-40]
    if kind == "ell":
        top = EllAOp.from_scipy(A, "bfloat16", device="cpu")
        jop = jell.EllAOp.from_scipy(A, jnp.bfloat16)
        got = [v for _, _, v in top.col_buckets + top.row_buckets]
        want = [v for _, v in jop.col_buckets + jop.row_buckets]
    else:
        top = SparseAOp.from_scipy(A, "bfloat16", device="cpu")
        jop = JSparseAOp.from_scipy(A, jnp.bfloat16)
        got, want = [top.c_vals, top.r_vals], [jop.c_vals, jop.r_vals]
    assert top.dtype == torch.bfloat16
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                      np.asarray(w).view(np.int16))


def _operands(kind, A, dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    if kind == "coo":
        return (SparseAOp.from_scipy(A, tdt, device="cpu"),
                JSparseAOp.from_scipy(A, jdt))
    blocks = dict(doc_block=64, term_block=32) if kind == "ell_blocked" \
        else {}
    return (EllAOp.from_scipy(A, tdt, device="cpu", **blocks),
            jell.EllAOp.from_scipy(A, jdt, **blocks))


@pytest.mark.parametrize("kind", ["ell", "ell_blocked", "coo"])
def test_products_match_reference_f64(kind):
    A = _random(70, 300, 0.05, seed=9)
    rng = np.random.RandomState(2)
    W, H = rng.rand(70, 5), rng.rand(5, 300)
    top, jop = _operands(kind, A, "float64")
    for conv in (top, operand_from_reference(jop, device="cpu")):
        for name, F in (("mm_tn", W), ("mm_nt", H)):
            got = getattr(conv, name)(torch.from_numpy(F))
            assert got.dtype == torch.float64
            np.testing.assert_allclose(
                got.numpy(), np.asarray(getattr(jop, name)(jnp.asarray(F))),
                rtol=F64_RTOL, atol=F64_RTOL)
        np.testing.assert_allclose(conv.col_sums().numpy(),
                                   np.asarray(jop.col_sums()),
                                   rtol=F64_RTOL, atol=F64_RTOL)


@pytest.mark.parametrize("kind", ["ell", "ell_blocked", "coo"])
def test_bf16_products_follow_the_factor_dtype(kind):
    """bf16 storage, f32 factors: products in f32 (a bf16 W'A collapses
    BPP), equal to the reference's to f32 rounding."""
    A = _random(70, 300, 0.05, seed=5)
    rng = np.random.RandomState(3)
    W = rng.rand(70, 5).astype(np.float32)
    H = rng.rand(5, 300).astype(np.float32)
    top, jop = _operands(kind, A, "bfloat16")
    for name, F in (("mm_tn", W), ("mm_nt", H)):
        got = getattr(top, name)(torch.from_numpy(F))
        want = getattr(jop, name)(jnp.asarray(F))
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=F32_RTOL, atol=F32_ATOL)
    assert top.col_sums().dtype == torch.bfloat16


@pytest.mark.parametrize("blocks", [{}, dict(term_block=32)],
                         ids=["monolithic", "term_blocked"])
def test_mm_tn_writes_k_by_n_in_place(blocks, monkeypatch):
    """W'A comes out of the kernel's transposed mode as the (k, n) tensor
    the buckets were written into (no copy after it), equal to the JAX
    package's mm_tn in f64 and, bit for bit, to the row-mode product
    transposed; term-blocked families accumulate in the same layout."""
    A = _random(70, 300, 0.05, seed=13)
    W = np.random.RandomState(5).rand(70, 6)
    top = EllAOp.from_scipy(A, torch.float64, device="cpu", **blocks)
    jop = jell.EllAOp.from_scipy(A, jnp.float64, **blocks)
    assert (top.col_blocks is not None) == bool(blocks)
    written = []
    kernel = tell.ell_spmm_buckets

    def spy(buckets, table, out, accumulate=False, transposed=False):
        assert transposed and out.shape == (6, 300)
        written.append((out.data_ptr(), accumulate))
        return kernel(buckets, table, out, accumulate, transposed)

    monkeypatch.setattr(tell, "ell_spmm_buckets", spy)
    got = top.mm_tn(torch.from_numpy(W))
    assert got.shape == (6, 300) and got.is_contiguous()
    assert {p for p, _ in written} == {got.data_ptr()}
    assert any(a for _, a in written) == bool(blocks)
    np.testing.assert_allclose(got.numpy(), np.asarray(jop.mm_tn(
        jnp.asarray(W))), rtol=F64_RTOL, atol=F64_RTOL)
    monkeypatch.setattr(tell, "ell_spmm_buckets", kernel)
    rows = top._product(top.col_packs, torch.from_numpy(W), 300)
    assert torch.equal(got, rows.T)


def _one_term_everywhere(m=60, n=3000, seed=21):
    """A corpus whose term 0 is in every document (as the sparse hierclust
    corpus's most frequent term is in ~92% of them): its row is a bucket
    of its own, 4096 long monolithic, and in every doc block."""
    A = _random(m, n, 0.03, seed=seed).tolil()
    A[0, :] = np.random.RandomState(seed).rand(n) + 0.1
    return A.tocsc()


@pytest.mark.parametrize("blocks", [{}, dict(doc_block=1024)],
                         ids=["monolithic", "doc_blocked"])
def test_one_term_in_every_document_matches_reference(blocks):
    """The heaviest row the operands build: bucket layout equal to the JAX
    package's, and the products at k = 2 and 5 equal to its in f64."""
    A = _one_term_everywhere()
    top = EllAOp.from_scipy(A, torch.float64, device="cpu", **blocks)
    jop = jell.EllAOp.from_scipy(A, jnp.float64, **blocks)
    _assert_same_layout(top, jop)
    longest = max(idx.shape[1] for _, bk in (top.row_blocks or
                                              [(None, top.row_buckets)])
                  for _, idx, _ in bk)
    assert longest == (1024 if blocks else 4096)
    rng = np.random.RandomState(4)
    for k in (2, 5):
        W, H = rng.rand(60, k), rng.rand(k, 3000)
        for name, F in (("mm_tn", W), ("mm_nt", H)):
            np.testing.assert_allclose(
                getattr(top, name)(torch.from_numpy(F)).numpy(),
                np.asarray(getattr(jop, name)(jnp.asarray(F))),
                rtol=F64_RTOL, atol=F64_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [{}, dict(doc_block=1024)],
                         ids=["monolithic", "doc_blocked"])
def test_cuda_one_term_in_every_document(blocks):
    """On the card the heaviest row runs the long-row plan (several warps a
    row): the f64 products at k = 2 equal the CPU operand's to
    F64_RTOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    A = _one_term_everywhere()
    cpu = EllAOp.from_scipy(A, torch.float64, device="cpu", **blocks)
    card = EllAOp.from_scipy(A, torch.float64, device="cuda", **blocks)
    rng = np.random.RandomState(6)
    for name, F in (("mm_tn", rng.rand(60, 2)), ("mm_nt", rng.rand(2, 3000))):
        F = torch.from_numpy(F)
        np.testing.assert_allclose(getattr(card, name)(F.cuda()).cpu().numpy(),
                                   getattr(cpu, name)(F).numpy(),
                                   rtol=F64_RTOL, atol=F64_RTOL)


def test_as_aop_sparse_branch():
    A = _random(40, 30, 0.1, seed=0)
    small = dict(device="cpu", densify_threshold_bytes=100)
    ell = as_aop(A, torch.float32, **small)
    assert isinstance(ell, EllAOp) and ell.dtype == torch.float32
    assert ell.shape == (40, 30) and ell.row_blocks is None
    padded = as_aop(A, torch.float32, ell_pad_multiple=8, **small)
    assert all(idx.shape[0] % 8 == 0 for _, idx, _ in padded.row_buckets)
    coo = as_aop(A, torch.float64, sparse_format="coo", **small)
    assert isinstance(coo, SparseAOp) and coo.nnz % 1024 == 0
    assert isinstance(as_aop(A, torch.float32, device="cpu"), DenseAOp)
    for op in (ell, coo):  # a prebuilt operand passes through unchanged
        assert as_aop(op, device="cpu") is op
    with pytest.raises(ValueError, match="sparse_format"):
        as_aop(A, torch.float32, sparse_format="csr", **small)


def test_from_reference_takes_a_reference_operand():
    A = _random(30, 20, 0.2, seed=6)
    rng = np.random.RandomState(1)
    W0, H0 = rng.rand(30, 3), rng.rand(3, 20)
    jop = jell.EllAOp.from_scipy(A, jnp.float64)
    aop, W, H = from_reference(jop, W0, H0, device="cpu", dtype="float64")
    assert isinstance(aop, EllAOp) and aop.dtype == torch.float64
    _assert_same_layout(aop, jop)
    coo, _, _ = from_reference(JSparseAOp.from_scipy(A, jnp.float32), W0,
                               H0, device="cpu")
    assert isinstance(coo, SparseAOp) and coo.dtype == torch.float32
    with pytest.raises(ValueError, match="not a reference sparse operand"):
        operand_from_reference(object(), device="cpu")


SOLVERS = {"bpp": dict(algorithm="BPP", tol=1e-4, min_iter=2, max_iter=50),
           "mu": dict(algorithm="MU", tol=1e-12, max_iter=40),
           "hals": dict(algorithm="HALS", tol=1e-4, max_iter=200)}


@pytest.mark.parametrize("blocked", [False, True], ids=["mono", "blocked"])
@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_nmf_solve_on_ell_matches_reference(solver, blocked):
    """The JAX nmf_solve and the port's on the same buckets (the operand
    crosses over by interop), f64."""
    A = _random(60, 48, 0.1, seed=9)
    rng = np.random.RandomState(1)
    W0, H0 = rng.rand(60, 4), rng.rand(4, 48)
    kw = dict(height=60, width=48, k=4, dtype="float64", verbose=False,
              **SOLVERS[solver])
    blocks = dict(doc_block=16, term_block=16) if blocked else {}
    jop = jell.EllAOp.from_scipy(A, jnp.float64, **blocks)
    j = jnmf_solve(jop, jnp.asarray(W0), jnp.asarray(H0),
                   jopt.NmfOptions(**{**kw, "algorithm": jopt.NmfAlgorithm(
                       kw["algorithm"])}))
    aop, W, H = from_reference(jop, W0, H0, device="cpu", dtype="float64")
    assert (aop.row_blocks is None) != blocked
    r = nmf_solve(aop, W, H, topt.NmfOptions(**{
        **kw, "algorithm": topt.NmfAlgorithm(kw["algorithm"])})).to_numpy()
    assert int(r.iterations) == int(j.iterations) > 1
    assert bool(r.success) == bool(j.success)
    np.testing.assert_allclose(r.W, np.asarray(j.W), rtol=SOLVE_RTOL,
                               atol=SOLVE_ATOL)
    np.testing.assert_allclose(r.H, np.asarray(j.H), rtol=SOLVE_RTOL,
                               atol=SOLVE_ATOL)


def test_nmf_cli_on_a_sparse_operand(tmp_path, monkeypatch):
    """The nmf CLI on a sparse .mtx, with the densify threshold forced low
    so that run_nmf takes an EllAOp, writes the dense run's factors (f64,
    to SOLVE_RTOL)."""
    A = _random(60, 48, 0.1, seed=12)
    mtx = str(tmp_path / "a.mtx")
    scipy.io.mmwrite(mtx, A)
    taken = []

    def low_threshold(*args, **kw):
        op = as_aop(*args, densify_threshold_bytes=0, **kw)
        taken.append(type(op).__name__)
        return op

    factors = {}
    for run in ("dense", "sparse"):
        if run == "sparse":
            monkeypatch.setattr(tnmf, "as_aop", low_threshold)
        w, h = str(tmp_path / f"{run}_w.csv"), str(tmp_path / f"{run}_h.csv")
        rc = tnmf_entry(["--matrixfile", mtx, "--k", "4", "--device", "cpu",
                         "--verbose", "0", "--dtype", "float64", "--seed",
                         "3", "--outprecision", "16", "--outfile_W", w,
                         "--outfile_H", h])
        assert rc == 0
        factors[run] = (load_delimited(w), load_delimited(h))
    assert taken == ["EllAOp"]
    for d, s in zip(factors["dense"], factors["sparse"]):
        np.testing.assert_allclose(s, d, rtol=SOLVE_RTOL, atol=SOLVE_ATOL)


@pytest.mark.parametrize("kind", ["ell", "coo"])
def test_hierclust_on_a_sparse_operand_names_slice_11(kind, tmp_path):
    """Hierclust on a prebuilt sparse operand (ROADMAP slice 11, which
    raised before it was ported) clusters: with no host matrix every node
    solves on the masked view, and clust_hier and run_hier_nmf2 (tree and
    flat refinement) equal the JAX package's on its operand of the same
    kind, in f64 initdir mode (the same initializers)."""
    from smallk_tpu.common.rng import Random as JRandom
    from smallk_tpu.engines.flatclust import run_hier_nmf2 as jrun_hier_nmf2
    from smallk_tpu.engines.hierclust import clust_hier as jclust_hier
    from smallk_torch.interop import options_from_reference
    from test_hier_oracle import _clust_opts, _write_initdir
    from test_torch_hierclust import _assert_same_tree

    A = _random(40, 30, 0.2, seed=7)
    op = as_aop(A, torch.float64, device="cpu", densify_threshold_bytes=0,
                sparse_format=kind)
    jop = (jell.EllAOp.from_scipy(A, dtype=jnp.float64) if kind == "ell"
           else JSparseAOp.from_scipy(A, dtype=jnp.float64))
    jopts = _clust_opts(3, _write_initdir(tmp_path, 40, 30, 30, seed=2))
    jopts = type(jopts)(**{**jopts.__dict__, "flat": True})
    opts = options_from_reference(jopts)
    jtree, jstats = jclust_hier(jop, jopts, JRandom(1))
    tree, stats = clust_hier(op, opts, Random(1), device="cpu")
    _assert_same_tree(tree, jtree)
    assert (stats.nmf_count, stats.iter_count) == (jstats.nmf_count,
                                                   jstats.iter_count)
    jtree, _, jflat = jrun_hier_nmf2(jop, jopts, JRandom(1))
    tree, _, flat = run_hier_nmf2(op, opts, Random(1), device="cpu")
    _assert_same_tree(tree, jtree)
    assert flat["success"] and jflat["success"]
    for key in ("W", "H"):
        np.testing.assert_allclose(flat[key], np.asarray(jflat[key]),
                                   rtol=SOLVE_RTOL, atol=SOLVE_ATOL)
