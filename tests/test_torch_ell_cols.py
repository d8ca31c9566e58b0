"""The port's column-subset operand (ops/ell_cols.py: CscColumns,
GatheredColsAOp) and the masked view (ops/aop.MaskedAOp) against the JAX
package's (smallk_tpu/ops/ell_cols.py, smallk_tpu/ops/aop.py:186-226) and
against dense products, in f64 on the CPU (the products run ell_spmm's
plain version there).  Both sum the same terms in other orders: TOL,
relative to the largest entry."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from smallk_tpu.ops.aop import DenseAOp as JDenseAOp
from smallk_tpu.ops.aop import MaskedAOp as JMaskedAOp
from smallk_tpu.ops.ell import EllAOp as JEllAOp
from smallk_tpu.ops.ell_cols import CscChunks
from smallk_torch.kernels import ell_spmm as kmod
from smallk_torch.ops import ell_cols
from smallk_torch.ops.aop import DenseAOp, MaskedAOp, as_aop
from smallk_torch.ops.ell_cols import CscColumns

torch.set_num_threads(1)

TOL = 1e-12


def _matrix(kind, seed=0):
    """Sparse test matrices: random, with empty columns and rows, with
    duplicate (row, column) entries, and with one long row and column."""
    rng = np.random.RandomState(seed)
    m, n = 70, 90
    if kind == "random":
        return sp.random(m, n, density=0.12, random_state=seed, format="csc")
    if kind == "empty":
        A = sp.random(m, n, density=0.1, random_state=seed, format="lil")
        A[:, [4, 5, 60]] = 0.0
        A[[2, 30], :] = 0.0
        return A.tocsc()
    if kind == "duplicates":
        coo = sp.random(m, n, density=0.08, random_state=seed, format="coo")
        extra = rng.randint(0, coo.nnz, 40)
        rows = np.r_[coo.row, coo.row[extra]]
        cols = np.r_[coo.col, coo.col[extra]]
        vals = np.r_[coo.data, rng.rand(40)]
        return _csc_with_duplicates(rows, cols, vals, m, n)
    # "long": one term in every document, one document with every term
    A = sp.random(m, n, density=0.05, random_state=seed, format="lil")
    A[7, :] = rng.rand(1, n) + 0.1
    A[:, 11] = rng.rand(m, 1) + 0.1
    return A.tocsc()


def _csc_with_duplicates(rows, cols, vals, m, n):
    """A CSC matrix that keeps its duplicate entries stored apart."""
    order = np.lexsort((rows, cols))
    indptr = np.r_[0, np.cumsum(np.bincount(cols, minlength=n))]
    A = sp.csc_matrix((vals[order], rows[order], indptr), shape=(m, n))
    assert not A.has_canonical_format  # duplicates stay stored
    return A


SUBSETS = {
    "ragged": lambda rng, n: rng.choice(n, 37, replace=False),
    "sorted": lambda rng, n: np.sort(rng.choice(n, 50, replace=False)),
    "one": lambda rng, n: np.array([11]),
    "empties": lambda rng, n: np.array([60, 4, 5, 0, 89]),
    "all": lambda rng, n: np.arange(n),
}


def _reference_products(A, subset, W, H):
    """The JAX package's GatheredColsAOp on the same subset (host plan,
    pow-2 slot width), cut to the subset's columns."""
    chunks = CscChunks.from_scipy(A, dtype=jnp.float64)
    w = len(subset)
    wc = 8
    while wc < max(chunks.subset_chunk_count(subset), w):
        wc <<= 1
    _, idx_chunks, slot = chunks.gather_host(subset, wc)
    op = chunks.gathered(jnp.asarray(idx_chunks), jnp.asarray(slot), wc)
    Hp = np.zeros((H.shape[0], wc))
    Hp[:, :w] = H
    return (np.asarray(op.mm_tn(jnp.asarray(W)))[:, :w],
            np.asarray(op.mm_nt(jnp.asarray(Hp))),
            np.asarray(op.col_sums())[:w])


def _close(got, want):
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= TOL * scale


@pytest.mark.parametrize("max_len", [None, 16])
@pytest.mark.parametrize("subset", sorted(SUBSETS))
@pytest.mark.parametrize("kind", ["random", "empty", "duplicates", "long"])
def test_subset_products_match_jax_and_dense(kind, subset, max_len,
                                             monkeypatch):
    """Every slice whole (max_len None: the module's _MAX_LEN, longer than
    any slice here), or slices past 16 entries cut into pieces."""
    if max_len is not None:
        monkeypatch.setattr(ell_cols, "_MAX_LEN", max_len)
    A = _matrix(kind)
    rng = np.random.RandomState(1)
    sub = SUBSETS[subset](rng, A.shape[1])
    W, H = rng.rand(A.shape[0], 2), rng.rand(2, len(sub))
    op = CscColumns.from_scipy(A, torch.float64, device="cpu").gathered(
        torch.from_numpy(sub))
    assert op.shape == (A.shape[0], len(sub))
    got = (op.mm_tn(torch.from_numpy(W)).numpy(),
           op.mm_nt(torch.from_numpy(H)).numpy(), op.col_sums().numpy())
    D = A.toarray()[:, sub]  # duplicates summed
    dense = (W.T @ D, D @ H.T, D.sum(axis=0))
    for g, r, d in zip(got, _reference_products(A, sub, W, H), dense):
        _close(g, d)
        _close(g, r)


@pytest.mark.parametrize("max_len", [None, 16])
def test_buckets_are_pow2_padded_with_the_sentinel(max_len, monkeypatch):
    """Each family holds the slices with nonzeros up to _MAX_LEN long in
    buckets of one power-of-two length (>= 8), padded with the sentinel
    and zero values, and cuts each longer slice into pieces of _MAX_LEN
    whose partial sums its row adds up; an empty slice is in neither;
    padded_nnz counts the padding."""
    if max_len is not None:
        monkeypatch.setattr(ell_cols, "_MAX_LEN", max_len)
    A = _matrix("long")
    sub = np.array([11, 3, 60, 2, 8])
    op = CscColumns.from_scipy(A, torch.float64, device="cpu").gathered(
        torch.from_numpy(sub))
    m, w = op.shape
    lens = {"col": np.diff(A.indptr)[sub],
            "row": np.bincount(A[:, sub].tocoo().row, minlength=m)}
    cap = ell_cols._MAX_LEN
    for fam, (buckets, split), sentinel in (("col", op.cols, m),
                                            ("row", op.rows, w)):
        seen = []
        for ids, idx, vals in buckets:
            L = idx.shape[1]
            assert 8 <= L <= cap and L & (L - 1) == 0
            assert ids.dtype == idx.dtype == torch.int32
            n_ent = lens[fam][ids.long().numpy()]
            assert (n_ent <= L).all() and ((n_ent > L // 2) | (L == 8)).all()
            pad = np.arange(L)[None, :] >= n_ent[:, None]
            assert (idx.numpy()[pad] == sentinel).all()
            assert (vals.numpy()[pad] == 0).all()
            seen += ids.tolist()
        long = np.flatnonzero(lens[fam] > cap)
        if split is None:
            assert not len(long)
        else:
            p_idx, p_vals, ids, refs, ones = split
            assert p_idx.shape[1] == cap
            np.testing.assert_array_equal(ids.numpy(), long)
            pieces = -(-lens[fam][long] // cap)
            assert p_idx.shape[0] == pieces.sum()
            np.testing.assert_array_equal(
                (refs.numpy() < p_idx.shape[0]).sum(axis=1), pieces)
            np.testing.assert_array_equal(ones.numpy(),
                                          refs.numpy() < p_idx.shape[0])
            assert int((p_idx.numpy() < sentinel).sum()) == \
                lens[fam][long].sum()
            seen += ids.tolist()
        assert sorted(seen) == np.flatnonzero(lens[fam]).tolist()
    assert (op.cols[1] is not None) == (max_len is not None)  # column 11
    entries = [sum(int(idx.numel()) for _, idx, _ in b)
               + (int(sp_[0].numel()) if sp_ is not None else 0)
               for b, sp_ in (op.cols, op.rows)]
    assert op.padded_nnz == max(entries)
    assert op.nnz == int(lens["col"].sum())


@pytest.mark.parametrize("base", ["ell", "dense"])
def test_masked_aop_matches_jax(base):
    A = _matrix("empty", seed=3)
    rng = np.random.RandomState(2)
    mask = (rng.rand(A.shape[1]) < 0.4).astype(np.float64)
    W, H = rng.rand(A.shape[0], 2), rng.rand(2, A.shape[1])
    if base == "ell":
        top = as_aop(A, torch.float64, device="cpu",
                     densify_threshold_bytes=0)
        jop = JEllAOp.from_scipy(A, dtype=jnp.float64)
    else:
        top = DenseAOp(torch.from_numpy(A.toarray()))
        jop = JDenseAOp(jnp.asarray(A.toarray()))
    op = MaskedAOp(top, torch.from_numpy(mask))
    jm = JMaskedAOp(jop, jnp.asarray(mask))
    assert op.shape == A.shape and op.dtype == torch.float64
    assert as_aop(op, device="cpu") is op
    D = A.toarray() * mask[None, :]
    for got, want, dense in (
            (op.mm_tn(torch.from_numpy(W)), jm.mm_tn(jnp.asarray(W)),
             W.T @ D),
            (op.mm_nt(torch.from_numpy(H)), jm.mm_nt(jnp.asarray(H)),
             D @ H.T),
            (op.col_sums(), jm.col_sums(), D.sum(axis=0))):
        _close(got.numpy(), np.asarray(want))
        _close(got.numpy(), dense)


def test_products_in_the_factor_dtype():
    """bf16 storage with f32 factors: the products come back f32, summed
    in f32 from the bf16-rounded values."""
    A = _matrix("random", seed=5)
    sub = np.arange(0, 90, 2)
    cols = CscColumns.from_scipy(A, "bfloat16", device="cpu")
    assert cols.data.dtype == torch.bfloat16 and cols.nnz == A.nnz
    op = cols.gathered(torch.from_numpy(sub))
    W = torch.rand(A.shape[0], 2)
    got = op.mm_tn(W)
    assert got.dtype == torch.float32 and op.col_sums().dtype == torch.bfloat16
    D = torch.from_numpy(A.toarray()[:, sub]).float().to(torch.bfloat16)
    torch.testing.assert_close(got, W.T @ D.float(), rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_cuda_gathered_products_match_plain(dtype, monkeypatch):
    """On the card both products run ell_spmm's kernel (one launch a
    bucket, two for the cut slices, none of the plain version) and equal
    the plain version within ELL_TOL's 2e-5 (f32 sums) or 1e-12 (f64);
    slices past 32 entries are cut."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    monkeypatch.setattr(ell_cols, "_MAX_LEN", 32)
    A = _matrix("long", seed=4)
    sub = torch.from_numpy(np.random.RandomState(0).permutation(90)[:61])
    cpu = CscColumns.from_scipy(A, dtype, device="cpu").gathered(sub)
    card = CscColumns.from_scipy(A, dtype, device="cuda").gathered(
        sub.cuda())
    fdt = torch.float64 if dtype == "float64" else torch.float32
    W, H = torch.rand(A.shape[0], 2, dtype=fdt), torch.rand(2, 61, dtype=fdt)
    tol = 1e-12 if dtype == "float64" else 2e-5
    launches, plain = kmod.launches, kmod.plain_cuda_calls
    for name, x in (("mm_tn", W), ("mm_nt", H)):
        got = getattr(card, name)(x.cuda()).cpu()
        want = getattr(cpu, name)(x)
        assert float((got - want).abs().max()) <= tol * float(
            want.abs().max())
    assert kmod.launches - launches == sum(
        len(buckets) + 2 * (split is not None)
        for buckets, split in (card.cols, card.rows))
    assert kmod.plain_cuda_calls == plain
