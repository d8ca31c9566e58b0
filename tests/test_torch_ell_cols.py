"""The port's chunk table and static-shape column-subset operand
(ops/ell_cols.py: CscChunks, ChunkColsAOp) and the masked view
(ops/aop.MaskedAOp) against the JAX package's (smallk_tpu/ops/ell_cols.py,
smallk_tpu/ops/aop.py:186-226) and against dense products, in f64 on the
CPU (the products run seg_spmm's and ell_spmm's plain versions there).
Both sum the same terms in other orders: TOL, relative to the largest
entry."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from smallk_tpu.ops.aop import DenseAOp as JDenseAOp
from smallk_tpu.ops.aop import MaskedAOp as JMaskedAOp
from smallk_tpu.ops.ell import EllAOp as JEllAOp
from smallk_tpu.ops.ell_cols import CscChunks
from smallk_torch.ops import ell_cols
from smallk_torch.ops.aop import DenseAOp, MaskedAOp, as_aop

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


def _close(got, want):
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= TOL * scale


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


# --- the chunk table and the static-shape operand ---------------------------

def _chunks(A, L0, dtype=torch.float64):
    return (CscChunks.from_scipy(A, dtype=jnp.float64, L0=L0),
            ell_cols.CscChunks.from_scipy(A, dtype, L0=L0, device="cpu"))


@pytest.mark.parametrize("L0", [None, 8])
@pytest.mark.parametrize("kind", ["random", "empty", "duplicates", "long"])
def test_chunk_table_and_plans_match_jax(kind, L0):
    """The chunk table (rows, values, chunk documents, counts and starts),
    the host plan of random subsets and the device plan of their masks are
    the JAX package's, element for element."""
    A = _matrix(kind)
    ref, mine = _chunks(A, L0)
    assert (mine.L0, mine.C, mine.shape) == (ref.L0, ref.C, ref.shape)
    np.testing.assert_array_equal(mine.rows.numpy(), np.asarray(ref.rows))
    np.testing.assert_array_equal(mine.vals.numpy(), np.asarray(ref.vals))
    np.testing.assert_array_equal(mine.chunk_doc.numpy(),
                                  np.asarray(ref.chunk_doc))
    np.testing.assert_array_equal(mine.cnt, ref.cnt)
    np.testing.assert_array_equal(mine.starts, ref.starts)
    # each chunk's live length: its entries off the sentinel row m
    np.testing.assert_array_equal(
        mine.clen.numpy(), (np.asarray(ref.rows) < A.shape[0]).sum(axis=1))
    rng = np.random.RandomState(2)
    for size in (1, 17, 45, 90):
        sub = rng.choice(90, size, replace=False)
        wc = max(mine.subset_chunk_count(sub), size) + rng.randint(0, 9)
        assert mine.subset_chunk_count(sub) == ref.subset_chunk_count(sub)
        for got, want in zip(mine.gather_host(sub, wc),
                             ref.gather_host(sub, wc)):
            np.testing.assert_array_equal(got, want)
        mask = np.zeros(90, dtype=bool)
        mask[sub] = True
        for got, want in zip(mine.gather_device(torch.from_numpy(mask), wc),
                             ref.gather_device(jnp.asarray(mask), wc)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_chunk_length_rule():
    """The median nonzero column length rounded up to a power of two,
    clamped to [L0_MIN, L0_MAX]: the reference's L0 on the same matrix."""
    assert ell_cols.chunk_length(np.array([0, 0])) == ell_cols.L0_MIN
    assert ell_cols.chunk_length(np.array([0, 3, 70, 80, 90])) == 128
    assert ell_cols.chunk_length(np.array([1, 2, 3])) == ell_cols.L0_MIN
    assert ell_cols.chunk_length(np.array([900, 1000])) == ell_cols.L0_MAX
    for density in (0.05, 0.4):
        A = sp.csc_matrix(sp.random(300, 40, density=density,
                                    random_state=1))
        assert ell_cols.CscChunks.from_scipy(
            A, torch.float64, device="cpu").L0 == CscChunks.from_scipy(
            A, dtype=jnp.float64).L0


@pytest.mark.parametrize("L0", [None, 8])
@pytest.mark.parametrize("subset", sorted(SUBSETS))
@pytest.mark.parametrize("kind", ["random", "empty", "duplicates", "long"])
def test_static_operand_matches_jax_and_dense(kind, subset, L0):
    """mm_tn, mm_nt and col_sums of the static operand against the JAX
    package's GatheredColsAOp on the same plan and against dense products
    (at L0 = 8 column 11 of "long" has more than 4 L0 entries; "empties"
    holds empty columns); pad columns are zero."""
    A = _matrix(kind)
    ref, mine = _chunks(A, L0)
    rng = np.random.RandomState(1)
    sub = SUBSETS[subset](rng, A.shape[1])
    w = len(sub)
    wc = max(mine.subset_chunk_count(sub), w) + 5
    _, idx_chunks, slot = mine.gather_host(sub, wc)
    op = ell_cols.ChunkColsAOp(mine, wc).load(idx_chunks, slot)
    jop = ref.gathered(jnp.asarray(idx_chunks), jnp.asarray(slot), wc)
    assert op.shape == (A.shape[0], wc) and op.dtype == torch.float64
    W = rng.rand(A.shape[0], 2)
    H = np.zeros((2, wc))
    H[:, :w] = rng.rand(2, w)
    got = (op.mm_tn(torch.from_numpy(W)).numpy(),
           op.mm_nt(torch.from_numpy(H)).numpy(), op.col_sums().numpy())
    want = (np.asarray(jop.mm_tn(jnp.asarray(W))),
            np.asarray(jop.mm_nt(jnp.asarray(H))),
            np.asarray(jop.col_sums()))
    D = A.toarray()[:, sub]
    dense = (W.T @ D, D @ H[:, :w].T, D.sum(axis=0))
    for g, r, d in zip(got, want, dense):
        _close(g, r)
        _close(g[..., :w] if g.ndim == 1 or g.shape[0] == 2 else g, d)
    assert not got[0][:, w:].any() and not got[2][w:].any()


def test_static_operand_reloads_in_place():
    """A second node loaded into the same buffers: the buffers (the
    entries, each chunk's live length, each slot's first chunk, each
    term's first entry) keep their addresses, are rewritten to those of
    an operand of its own, and so are the products."""
    A = _matrix("long")
    mine = ell_cols.CscChunks.from_scipy(A, torch.float64, L0=8,
                                         device="cpu")
    wc = 300
    op = ell_cols.ChunkColsAOp(mine, wc)
    names = ("rows", "vals", "lens", "starts", "t_gather", "t_vals",
             "t_ptr")
    ptrs = [getattr(op, name).data_ptr() for name in names]
    rng = np.random.RandomState(4)
    W, H = torch.rand(70, 2, dtype=torch.float64), torch.rand(
        2, wc, dtype=torch.float64)
    for sub in (np.arange(90), rng.choice(90, 20, replace=False),
                np.array([11, 60])):
        plan = mine.gather_host(sub, wc)
        op.load(*plan[1:])
        own = ell_cols.ChunkColsAOp(mine, wc).load(*plan[1:])
        assert torch.equal(op.mm_tn(W), own.mm_tn(W))
        assert torch.equal(op.mm_nt(H), own.mm_nt(H))
        for name in ("lens", "starts", "t_ptr"):
            assert torch.equal(getattr(op, name), getattr(own, name))
        assert int(op.t_ptr[-1]) == int(mine.lens[sub].sum())
        assert int(op.starts[-1]) == mine.subset_chunk_count(sub)
        assert int(op.lens.sum()) == int(mine.lens[sub].sum())
    assert ptrs == [getattr(op, name).data_ptr() for name in names]


@pytest.mark.parametrize("node", ["all pad", "long document"])
def test_static_operand_edge_nodes(node):
    """A node with no document (every chunk and slot a pad: all products
    zero) and one whose document spans 16+ chunks (column 11 of "long" at
    L0 = 4, 70 nonzeros in 18 chunks), against the JAX package's
    GatheredColsAOp and dense products in f64."""
    A = _matrix("long")
    ref, mine = _chunks(A, 4)
    sub = np.array([], dtype=np.int64) if node == "all pad" else np.array(
        [3, 11, 50])
    assert node == "all pad" or mine.cnt[11] >= 16
    wc = max(mine.subset_chunk_count(sub), len(sub)) + 3
    if len(sub):
        _, idx_chunks, slot = mine.gather_host(sub, wc)
    else:  # the plan of no document: every chunk the all-pad one
        idx_chunks = np.full(wc, mine.C, dtype=np.int32)
        slot = np.full(wc, wc, dtype=np.int32)
    op = ell_cols.ChunkColsAOp(mine, wc).load(idx_chunks, slot)
    jop = ref.gathered(jnp.asarray(idx_chunks), jnp.asarray(slot), wc)
    rng = np.random.RandomState(6)
    W, H = rng.rand(A.shape[0], 2), rng.rand(2, wc)
    H[:, len(sub):] = 0.0
    got = (op.mm_tn(torch.from_numpy(W)).numpy(),
           op.mm_nt(torch.from_numpy(H)).numpy(), op.col_sums().numpy())
    want = (np.asarray(jop.mm_tn(jnp.asarray(W))),
            np.asarray(jop.mm_nt(jnp.asarray(H))),
            np.asarray(jop.col_sums()))
    D = A.toarray()[:, sub]
    dense = (W.T @ D, D @ H[:, :len(sub)].T, D.sum(axis=0))
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, r, rtol=TOL, atol=0)
    for g, d in zip(got, dense):
        np.testing.assert_allclose(
            g[..., :len(sub)] if g.ndim == 1 or g.shape[0] == 2 else g, d,
            rtol=1e-12, atol=1e-14)
    if node == "all pad":
        assert not any(g.any() for g in got)
        assert int(op.t_ptr[-1]) == 0 and int(op.starts[-1]) == 0


def test_static_operand_in_the_factor_dtype():
    """bf16 storage with f32 factors: products come back f32, summed in
    f32 from the bf16-rounded values; e4m3 storage likewise."""
    A = _matrix("random", seed=5)
    sub = np.arange(0, 90, 2)
    W = torch.rand(A.shape[0], 2)
    for dt in ("bfloat16", "float8_e4m3fn"):
        mine = ell_cols.CscChunks.from_scipy(A, dt, device="cpu")
        wc = max(mine.subset_chunk_count(sub), len(sub))
        op = ell_cols.ChunkColsAOp(mine, wc).load(
            *mine.gather_host(sub, wc)[1:])
        got = op.mm_tn(W)
        assert got.dtype == torch.float32
        assert op.col_sums().dtype == getattr(torch, dt)
        D = torch.from_numpy(A.toarray()[:, sub]).float().to(
            getattr(torch, dt)).float()
        torch.testing.assert_close(got[:, :len(sub)], W.T @ D, rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_cuda_static_operand_matches_plain(dtype):
    """On the card both products run seg_spmm's kernel (one launch a
    product, none of the plain version) and equal the CPU's plain version
    within 2e-5 (f32 sums) or 1e-12 (f64)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from smallk_torch.kernels import seg_spmm as smod

    A = _matrix("long", seed=4)
    sub = np.random.RandomState(0).permutation(90)[:61]
    cpu = ell_cols.CscChunks.from_scipy(A, dtype, L0=8, device="cpu")
    card = ell_cols.CscChunks.from_scipy(A, dtype, L0=8, device="cuda")
    wc = 512
    plan = cpu.gather_host(sub, wc)
    ops = (ell_cols.ChunkColsAOp(cpu, wc).load(*plan[1:]),
           ell_cols.ChunkColsAOp(card, wc).load(*plan[1:]))
    fdt = torch.float64 if dtype == "float64" else torch.float32
    W, H = torch.rand(A.shape[0], 2, dtype=fdt), torch.rand(2, wc, dtype=fdt)
    tol = 1e-12 if dtype == "float64" else 2e-5
    launches, plain = smod.launches, smod.plain_cuda_calls
    for name, x in (("mm_tn", W), ("mm_nt", H)):
        got = getattr(ops[1], name)(x.cuda()).cpu()
        want = getattr(ops[0], name)(x)
        assert float((got - want).abs().max()) <= tol * float(
            want.abs().max())
    assert smod.launches - launches == 2
    assert smod.plain_cuda_calls == plain


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_cuda_frequent_term(dtype):
    """A term in 95% of 60,000 documents (its entries span many blocks of
    the term pass): both products on the card equal the CPU's plain version
    within 2e-5 (f32 sums) or 1e-12 (f64), and two calls, eager and
    captured, give equal bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.RandomState(8)
    A = sp.random(3000, 60_000, density=0.003, random_state=8, format="lil")
    docs = np.flatnonzero(rng.rand(60_000) < 0.95)
    A[17, docs] = rng.rand(1, len(docs)) + 0.1
    A = A.tocsc()
    cpu = ell_cols.CscChunks.from_scipy(A, dtype, device="cpu")
    card = ell_cols.CscChunks.from_scipy(A, dtype, device="cuda")
    sub = np.sort(rng.choice(60_000, 50_000, replace=False))
    wc = max(cpu.subset_chunk_count(sub), len(sub)) + 1000
    plan = cpu.gather_host(sub, wc)
    ops = (ell_cols.ChunkColsAOp(cpu, wc).load(*plan[1:]),
           ell_cols.ChunkColsAOp(card, wc).load(*plan[1:]))
    fdt = torch.float64 if dtype == "float64" else torch.float32
    W, H = torch.rand(3000, 2, dtype=fdt), torch.rand(2, wc, dtype=fdt)
    tol = 1e-12 if dtype == "float64" else 2e-5
    for name, x in (("mm_tn", W), ("mm_nt", H)):
        fn = getattr(ops[1], name)
        got = fn(x.cuda())
        assert torch.equal(got, fn(x.cuda()))
        g = torch.cuda.CUDAGraph()
        xc = x.cuda()
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s), torch.cuda.graph(g):
            captured = fn(xc)
        torch.cuda.current_stream().wait_stream(s)
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, captured)
        want = getattr(ops[0], name)(x)
        assert float((got.cpu() - want).abs().max()) <= tol * float(
            want.abs().max())
