"""The port's ELL gather-SpMM (kernels/ell_spmm.py) against a numpy loop
and the JAX package's bucket product.

On the CPU the wrapper takes its plain torch version.  The CUDA kernel is
held against the plain version by the tests marked `cuda` (skipped
without a card) and by chip_smoke.py on the H100.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smallk_tpu.ops.ell import EllAOp as JEllAOp
from smallk_torch.kernels import _build, ell_spmm as kmod
from smallk_torch.kernels.ell_spmm import ell_spmm, ell_spmm_reference

torch.set_num_threads(1)

F64_RTOL = 1e-12  # f64 sums in another order
F32_RTOL = 1e-5   # f32 sums of up to ~100 terms in another order


def _bucket(g_pad, L, B, k, seed, sentinel_share=0.3, n_rows=None):
    """A ragged bucket: random minor ids with sentinels (== B) scattered
    through the rows, both signs of values, a table, and rows to write."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, max(B, 1), (g_pad, L)).astype(np.int32)
    idx[rng.rand(g_pad, L) < sentinel_share] = B
    idx[-1] = B  # an all-sentinel (padding) row
    vals = rng.rand(g_pad, L) - 0.3
    vals[idx == B] = 0.0
    table = rng.rand(B, k) - 0.5
    g = g_pad if n_rows is None else n_rows
    rows = rng.permutation(g + 5)[:g].astype(np.int32)
    return idx, vals, table, rows


def _numpy_loop(idx, vals, table, out, rows, accumulate):
    out = out.copy()
    B = table.shape[0]
    for r in range(len(rows)):
        s = np.zeros(table.shape[1])
        for j, v in zip(idx[r], vals[r]):
            if j < B:
                s += v * table[j]
        out[rows[r]] = out[rows[r]] + s if accumulate else s
    return out


CASES = {
    "k1": (9, 5, 7, 1),
    "k2": (13, 33, 20, 2),
    "k8": (17, 64, 50, 8),
    "k128": (6, 40, 30, 128),
    "k130_ragged": (5, 31, 11, 130),
    "empty_table": (4, 3, 0, 8),
}


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_numpy_loop(case, accumulate):
    g_pad, L, B, k = CASES[case]
    idx, vals, table, rows = _bucket(g_pad, L, B, k, seed=g_pad * L,
                                     n_rows=g_pad - 1)
    n_out = int(rows.max()) + 3
    out0 = np.random.RandomState(1).rand(n_out, k)
    want = _numpy_loop(idx, vals, table, out0, rows, accumulate)
    out = torch.from_numpy(out0.copy())
    got = ell_spmm(*(torch.from_numpy(a) for a in (idx, vals, table)), out,
                   rows=torch.from_numpy(rows), accumulate=accumulate)
    assert got is out
    np.testing.assert_allclose(out.numpy(), want, rtol=F64_RTOL,
                               atol=F64_RTOL)


@pytest.mark.parametrize("pair", [("float32", "float32"),
                                  ("bfloat16", "float32"),
                                  ("float32", "bfloat16")])
def test_reference_dtype_pairs_sum_in_f32(pair):
    """The kernel's three f32 pairs: bf16 is widened exactly, sums are f32
    (to F32_RTOL of the f64 loop on the rounded inputs)."""
    idx, vals, table, _ = _bucket(40, 24, 30, 8, seed=3)
    v = torch.from_numpy(vals).to(getattr(torch, pair[0]))
    t = torch.from_numpy(table).to(getattr(torch, pair[1]))
    out = torch.empty((40, 8), dtype=torch.float32)
    ell_spmm(torch.from_numpy(idx), v, t, out)
    want = _numpy_loop(idx, v.double().numpy(), t.double().numpy(),
                       np.zeros((40, 8)), np.arange(40), False)
    np.testing.assert_allclose(out.numpy(), want, rtol=F32_RTOL,
                               atol=F32_RTOL)


@pytest.mark.parametrize("storage", ["float64", "float32", "bfloat16"])
def test_matches_reference_bucket_product(storage):
    """The JAX package's EllAOp._bucket_product on the same bucket, with
    its appended zero row as the sentinel's target: f64 to F64_RTOL, f32
    sums to F32_RTOL."""
    idx, vals, table, _ = _bucket(64, 40, 100, 16, seed=5)
    factor = "float64" if storage == "float64" else "float32"
    jvals = jnp.asarray(vals.astype(np.float32) if storage == "bfloat16"
                        else vals, dtype=storage)
    jtab = jnp.asarray(np.concatenate([table, np.zeros((1, 16))]), factor)
    ref = JEllAOp._bucket_product(jnp.asarray(idx), jvals, jtab,
                                  out_dtype=jnp.dtype(factor))
    v = torch.from_numpy(vals.astype(np.float32) if storage == "bfloat16"
                         else vals).to(getattr(torch, storage))
    out = torch.empty((64, 16), dtype=getattr(torch, factor))
    ell_spmm(torch.from_numpy(idx), v,
             torch.from_numpy(table).to(getattr(torch, factor)), out)
    tol = F64_RTOL if storage == "float64" else F32_RTOL
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=tol,
                               atol=tol)


def test_reference_chunking_is_exact(monkeypatch):
    idx, vals, table, rows = _bucket(50, 12, 20, 4, seed=8)
    args = [torch.from_numpy(a) for a in (idx, vals, table)]
    whole = ell_spmm_reference(*args, torch.zeros(60, 4),
                               torch.from_numpy(rows))
    # a budget of 7 bucket rows: 8 chunks, the last one ragged
    monkeypatch.setattr(kmod, "_REF_BYTES_BUDGET", 7 * 12 * 4 * 8)
    chunked = ell_spmm_reference(*args, torch.zeros(60, 4),
                                 torch.from_numpy(rows))
    assert torch.equal(whole, chunked)


def test_sentinel_never_reads_the_table():
    """A sentinel contributes 0 even when table row 0 is not finite."""
    idx = np.array([[0, 2, 2], [2, 2, 2]], np.int32)
    vals = np.array([[1.0, 5.0, 7.0], [3.0, 3.0, 3.0]])
    table = np.array([[2.0, 4.0], [np.inf, np.nan]])
    out = torch.full((2, 2), 9.0, dtype=torch.float64)
    ell_spmm(*(torch.from_numpy(a) for a in (idx, vals, table)), out)
    np.testing.assert_array_equal(out.numpy(), [[2.0, 4.0], [0.0, 0.0]])


def test_wrapper_takes_plain_version_on_cpu():
    idx, vals, table, rows = _bucket(20, 8, 10, 4, seed=9)
    args = [torch.from_numpy(a) for a in (idx, vals, table)]
    before = (kmod.launches, kmod.plain_cuda_calls)
    got = ell_spmm(*args, torch.zeros(30, 4), torch.from_numpy(rows))
    assert (kmod.launches, kmod.plain_cuda_calls) == before  # no kernel ran
    assert torch.equal(got, ell_spmm_reference(*args, torch.zeros(30, 4),
                                               torch.from_numpy(rows)))


def _bad_inputs(case):
    idx, vals, table, rows = (torch.from_numpy(a) for a in
                              _bucket(6, 4, 5, 3, seed=2))
    out = torch.zeros(12, 3, dtype=torch.float64)
    if case == "idx_dtype":
        idx = idx.long()
    elif case == "vals_shape":
        vals = vals[:, :3]
    elif case == "out_width":
        out = out[:, :2]
    elif case == "rows_dtype":
        rows = rows.long()
    elif case == "rows_too_many":
        rows = torch.arange(7, dtype=torch.int32)
    elif case == "no_rows_too_few_out":
        rows, out = None, out[:5]
    elif case == "meta_device":
        idx, vals, table, out = (t.to("meta") for t in (idx, vals, table, out))
        rows = rows.to("meta")
    elif case == "transposed_row_layout":
        return idx, vals, table, out, rows, False, True
    elif case == "transposed_too_few_columns":
        return idx, vals, table, out.T[:, :5], None, False, True
    return idx, vals, table, out, rows


@pytest.mark.parametrize("case", ["idx_dtype", "vals_shape", "out_width",
                                  "rows_dtype", "rows_too_many",
                                  "no_rows_too_few_out", "meta_device",
                                  "transposed_row_layout",
                                  "transposed_too_few_columns"])
def test_wrapper_rejects_bad_inputs(case):
    with pytest.raises(ValueError):
        ell_spmm(*_bad_inputs(case))


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_transposed_reference_matches_numpy_loop(case, accumulate):
    """Transposed mode: bucket row r lands in column rows[r] of a (k, n)
    output; ids that are not consecutive, sentinels, an all-padding row."""
    g_pad, L, B, k = CASES[case]
    idx, vals, table, rows = _bucket(g_pad, L, B, k, seed=g_pad * L + 1,
                                     n_rows=g_pad - 1)
    n_out = int(rows.max()) + 3
    out0 = np.random.RandomState(2).rand(n_out, k)
    want = _numpy_loop(idx, vals, table, out0, rows, accumulate)
    out = torch.from_numpy(out0.T.copy())
    got = ell_spmm(*(torch.from_numpy(a) for a in (idx, vals, table)), out,
                   rows=torch.from_numpy(rows), accumulate=accumulate,
                   transposed=True)
    assert got is out and out.shape == (k, n_out)
    np.testing.assert_allclose(out.numpy(), want.T, rtol=F64_RTOL,
                               atol=F64_RTOL)


PAIRS = [("float32", "float32"), ("bfloat16", "float32"),
         ("float32", "bfloat16"), ("float64", "float64")]


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: "_".join(p))
def test_transposed_equals_row_mode_bit_for_bit(pair, accumulate):
    """The transposed mode writes the row mode's sums, bit for bit, for
    every dtype pair, with and without rows (ids not consecutive)."""
    vt, tt = (getattr(torch, p) for p in pair)
    acc = torch.float64 if vt == torch.float64 else torch.float32
    idx, vals, table, rows = _bucket(33, 20, 40, 12, seed=21, n_rows=30)
    args = (torch.from_numpy(idx), torch.from_numpy(vals).to(vt),
            torch.from_numpy(table).to(tt))
    out0 = torch.from_numpy(np.random.RandomState(4).rand(40, 12)).to(acc)
    for r in (torch.from_numpy(rows), None):
        row = ell_spmm(*args, out0.clone(), r, accumulate)
        tr = ell_spmm(*args, out0.T.contiguous(), r, accumulate,
                      transposed=True)
        assert tr.dtype == acc
        assert torch.equal(tr, row.T)


def test_transposed_sentinel_never_reads_the_table():
    """Transposed mode: a sentinel contributes 0 even when table row 0 is
    not finite, and each bucket row lands in its column."""
    idx = np.array([[0, 2, 2], [2, 2, 2]], np.int32)
    vals = np.array([[1.0, 5.0, 7.0], [3.0, 3.0, 3.0]])
    table = np.array([[2.0, 4.0], [np.inf, np.nan]])
    out = torch.full((2, 3), 9.0, dtype=torch.float64)
    ell_spmm(*(torch.from_numpy(a) for a in (idx, vals, table)), out,
             rows=torch.tensor([2, 0], dtype=torch.int32), transposed=True)
    np.testing.assert_array_equal(out.numpy(), [[0.0, 9.0, 2.0],
                                                [0.0, 9.0, 4.0]])


def test_build_knows_the_library():
    assert (_build.CSRC / "ell_spmm.cu").is_file()
    assert kmod.SOURCE == "smallk_torch/csrc/ell_spmm.cu"
    sigs = _build.SIGNATURES["ell_spmm"]
    for pair in ("f32_f32", "bf16_f32", "f32_bf16", "f64_f64"):
        args, ret = sigs[f"smallk_ell_spmm_{pair}"]
        # the buckets' launch records and their count; table and out; B,
        # k, n_out, accumulate, transposed; the stream as a pointer, the
        # device; where the failed bucket's index is written
        assert args == (_build._P, _build._I, _build._P, _build._P) + (
            _build._I,) * 5 + (_build._P, _build._I, _build._P)
        assert ret is _build._I
    assert set(kmod.REPLACES) == {"P1", "P2"}
    text = (_build.CSRC / "ell_spmm.cu").read_text()
    # no atomics: accumulate adds in launch order
    assert "atomicAdd" not in text


def test_kernel_source_has_no_float_atomics():
    """Every sum of the kernel has a fixed order: no atomic operation of
    any kind in its code (comments aside), so no floating-point atomicAdd,
    and the long rows' partial sums meet in shared memory behind
    barriers."""
    text = (_build.CSRC / "ell_spmm.cu").read_text()
    code = "\n".join(line.split("//")[0] for line in text.splitlines())
    assert "atomic" not in code.lower()
    assert "__syncthreads" in code and "__shfl_xor_sync" in code


# ---------------------------------------------------------------------------
# the launch plan


PLAN_KS = [1, 2, 3, 8, 16, 128]
PLAN_LS = [8, 1024, 4096, 131072, 262144, 10**6]


@pytest.mark.parametrize("L", PLAN_LS)
@pytest.mark.parametrize("k", PLAN_KS)
def test_launch_plan(k, L):
    """Every lane has work at any k, and no row's length sets a warp's
    time: an entry takes the lanes its k needs (k = 2: one lane, 32
    entries in flight a warp), and a row past SPLIT_MIN_L takes warps
    until every lane's chain is within MAX_CHAIN (up to 262,144 entries
    at k = 2), or 32 warps."""
    plan = kmod.launch_plan(k, L, 4, 16)
    vec, per_entry, per_row, warps = plan
    assert k % vec == 0 and vec in (1, 2, 4)
    assert per_entry == min(32, kmod._pow2_at_least(-(-k // vec)))
    assert per_entry * vec >= min(k, 32 * vec)   # one pass when k allows
    assert per_entry <= per_row <= 32
    assert per_row == 32 or (warps == 1 and per_row >= min(L, 32))
    if k == 2:
        assert (vec, per_entry) == (2, 1)
        assert 32 // per_entry == 32            # entries in flight a warp
    if k == 128 and L <= kmod.SPLIT_MIN_L:
        assert plan == (4, 32, 32, 1)          # the flagship's plan
    if L <= kmod.SPLIT_MIN_L:
        assert warps == 1
    else:
        assert 1 < warps <= kmod.MAX_WARPS_PER_ROW or plan.chain(L) <= \
            kmod.MAX_CHAIN
        if (32 // per_entry) * 32 * kmod.MAX_CHAIN >= L:
            assert plan.chain(L) <= kmod.MAX_CHAIN
            # the fewest warps that do it
            assert warps == 1 or -(-L // ((32 // per_entry) * warps // 2)) \
                > kmod.MAX_CHAIN
        else:
            assert warps == kmod.MAX_WARPS_PER_ROW
    if k <= 2 and L <= 262144:
        assert plan.chain(L) <= 256


@pytest.mark.parametrize("L", [80, 96, 128, 160, 192, 224, 256, 320, 384,
                               448, 512])
def test_launch_plan_keeps_the_flagship_path(L):
    """At k = 128 and every bucket length of the flagship (PR 6's ladder,
    L <= 512) the plan is PR 7's: a float4 a lane, one entry broadcast to
    a warp, one warp a row; so the flagship's products keep their bits."""
    assert kmod.launch_plan(128, L, 4, 256) == (4, 32, 32, 1)
    assert kmod.launch_plan(128, L, 2, 256) == (4, 32, 32, 1)


@pytest.mark.parametrize("item,aligned,k,vec", [
    (4, 16, 2, 2), (4, 8, 4, 2), (4, 4, 4, 1), (4, 16, 6, 2), (4, 16, 3, 1),
    (8, 16, 2, 2), (8, 16, 4, 2), (8, 32, 4, 4), (2, 8, 8, 4), (2, 4, 8, 2),
    (2, 2, 8, 1)])
def test_launch_plan_vector_width(item, aligned, k, vec):
    """The widest load of 4, 2 or 1 columns that divides k and that the
    table's address allows for its entry size."""
    assert kmod.launch_plan(k, 64, item, aligned).vec == vec


@pytest.mark.parametrize("k,L,per_row", [(2, 8, 8), (2, 9, 16), (2, 16, 16),
                                         (2, 31, 32), (2, 64, 32),
                                         (8, 8, 8), (16, 8, 8), (32, 8, 8),
                                         (64, 8, 16), (128, 8, 32)])
def test_launch_plan_short_rows_share_a_warp(k, L, per_row):
    """A row shorter than a warp takes a sub-warp of its length (never
    fewer lanes than its entry)."""
    assert kmod.launch_plan(k, L, 4, 16).lanes_per_row == per_row


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("k", [1, 2])
def test_reference_on_rows_of_2_17_entries(k, transposed):
    """The plain version on rows of 2^17 entries (the length of the sparse
    hierclust root's heaviest term rows in a doc block), full, half full
    and nearly empty, with sentinels through them, against a numpy f64
    sum: f64 to F64_RTOL scaled by the length, f32 sums to 1e-4 (a chain
    of 2^17 positive terms)."""
    L, B = 1 << 17, 5000
    rng = np.random.RandomState(17 + k)
    idx = rng.randint(0, B, (3, L)).astype(np.int32)
    idx[1, L // 2:] = B
    idx[2, 7:] = B
    idx[rng.rand(3, L) < 0.1] = B
    vals = rng.rand(3, L)
    table = rng.rand(B, k)
    rows = np.array([4, 0, 2], np.int32)
    want = np.zeros((5, k))
    for r in range(3):
        keep = idx[r] < B
        want[rows[r]] = vals[r, keep] @ table[idx[r, keep]]
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-4)):
        out = torch.zeros((k, 5) if transposed else (5, k), dtype=dtype)
        ell_spmm(torch.from_numpy(idx), torch.from_numpy(vals).to(dtype),
                 torch.from_numpy(table).to(dtype), out,
                 rows=torch.from_numpy(rows), transposed=transposed)
        got = out.T if transposed else out
        np.testing.assert_allclose(got.double().numpy(), want, rtol=tol,
                                   atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("pair,tol", [(("float32", "float32"), 2e-5),
                                      (("bfloat16", "float32"), 2e-5),
                                      (("float32", "bfloat16"), 2e-5),
                                      (("float64", "float64"), 1e-12)])
def test_cuda_kernel_matches_plain(pair, tol):
    """max |kernel - plain| / max |plain| within `tol` (f32 sums in other
    orders; f64 the same sums)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    vt, tt = (getattr(torch, p) for p in pair)
    acc = torch.float64 if vt == torch.float64 else torch.float32
    for (g_pad, L, B, k), accumulate in [(c, a) for c in CASES.values()
                                         for a in (False, True)]:
        idx, vals, table, rows = _bucket(g_pad, L, B, k, seed=g_pad + k,
                                         n_rows=g_pad - 1)
        args = [torch.from_numpy(idx).cuda(),
                torch.from_numpy(vals).to(vt).cuda(),
                torch.from_numpy(table).to(tt).cuda()]
        r = torch.from_numpy(rows).cuda()
        out0 = torch.rand((int(rows.max()) + 3, k), dtype=acc, device="cuda")
        before = kmod.launches
        got = ell_spmm(*args, out0.clone(), r, accumulate)
        want = ell_spmm_reference(*args, out0.clone(), r, accumulate)
        torch.cuda.synchronize()
        assert kmod.launches == before + 1
        # an empty table stores zeros: the relative error of 0 is 0
        err = (float((got - want).abs().max())
               / max(float(want.abs().max()), 1e-300))
        assert err <= tol, (g_pad, L, B, k, accumulate, err)


@pytest.mark.cuda
def test_cuda_rejects_other_dtype_pairs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    idx, vals, table, _ = (torch.from_numpy(a).cuda() for a in
                           _bucket(4, 4, 4, 4, seed=1))
    out = torch.zeros((4, 4), device="cuda")
    with pytest.raises(ValueError, match="kernel takes"):
        ell_spmm(idx, vals.bfloat16(), table.bfloat16(), out)
    with pytest.raises(ValueError, match="out dtype"):
        ell_spmm(idx, vals.float(), table.float(), out.double())


# (g_pad, L, B, k): the flagship's W'A length (80), P1/P2's (128), an
# AH'-like one (200) and a ragged k
LAYOUT_CASES = [(300, 80, 500, 128), (97, 128, 300, 128), (64, 200, 900, 128),
                (50, 33, 60, 36)]


@pytest.mark.cuda
@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: "_".join(p))
def test_cuda_variants_match_plain(pair):
    """Row and transposed output: each within the plain version's
    tolerance, and the transposed sums equal to the row mode's bit for
    bit (both sum in the same fixed order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    vt, tt = (getattr(torch, p) for p in pair)
    acc = torch.float64 if vt == torch.float64 else torch.float32
    tol = 1e-12 if vt == torch.float64 else 2e-5
    for g_pad, L, B, k in LAYOUT_CASES:
        idx, vals, table, rows = _bucket(g_pad, L, B, k, seed=L + k,
                                         n_rows=g_pad - 2)
        args = [torch.from_numpy(idx).cuda(),
                torch.from_numpy(vals).to(vt).cuda(),
                torch.from_numpy(table).to(tt).cuda()]
        r = torch.from_numpy(rows).cuda()
        out0 = torch.rand((int(rows.max()) + 3, k), dtype=acc, device="cuda")
        for accumulate in (False, True):
            got = {}
            for transposed in (False, True):
                o = out0.T.contiguous() if transposed else out0.clone()
                want = ell_spmm_reference(*args, o.clone(), r, accumulate,
                                          transposed)
                before = (kmod.launches, kmod.transposed_launches)
                got[transposed] = ell_spmm(*args, o, r, accumulate,
                                           transposed)
                torch.cuda.synchronize()
                assert (kmod.launches, kmod.transposed_launches) == (
                    before[0] + 1, before[1] + transposed)
                err = (float((got[transposed] - want).abs().max())
                       / float(want.abs().max()))
                assert err <= tol, (g_pad, L, B, k, transposed, err)
            assert torch.equal(got[True], got[False].T), (g_pad, L, B, k)


# (g_pad, L, B, k): the narrow-k plans (an entry a lane at k <= 2 and 4,
# 2-8 lanes an entry at 3, 8, 16), rows shorter than a warp sharing one,
# and rows past SPLIT_MIN_L shared by several warps, up to 2^17 entries
NARROW_CASES = [(40, 8, 30, 2), (33, 20, 50, 2), (50, 80, 300, 1),
                (37, 64, 100, 3), (29, 8, 40, 8), (64, 128, 500, 16),
                (7, 4096, 2000, 2), (5, 20000, 3000, 3), (3, 1 << 17, 5000, 2),
                (4, 1 << 17, 5000, 1), (3, 40000, 800, 8),
                (3, 1 << 17, 4000, 16), (2, 5000, 600, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: "_".join(p))
def test_cuda_narrow_and_long_rows(pair):
    """The narrow-k and long-row plans: within the plain version's
    tolerance, evaluated in f64 (f32 sums of long rows in other orders:
    2e-5 of the largest output, as chip_smoke.py holds them), row and
    transposed output bit-equal, and two launches bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    vt, tt = (getattr(torch, p) for p in pair)
    acc = torch.float64 if vt == torch.float64 else torch.float32
    tol = 1e-12 if vt == torch.float64 else 2e-5
    for g_pad, L, B, k in NARROW_CASES:
        idx, vals, table, rows = _bucket(g_pad, L, B, k, seed=L + k,
                                         n_rows=g_pad - 1)
        vals = np.abs(vals)  # long sums of positive terms
        args = [torch.from_numpy(idx).cuda(),
                torch.from_numpy(vals).to(vt).cuda(),
                torch.from_numpy(table + 0.5).to(tt).cuda()]
        wide = [args[0], args[1].double(), args[2].double()]
        r = torch.from_numpy(rows).cuda()
        out0 = torch.rand((int(rows.max()) + 3, k), dtype=acc, device="cuda")
        for accumulate in (False, True):
            want = ell_spmm_reference(*wide, out0.double().clone(), r,
                                      accumulate)
            got = ell_spmm(*args, out0.clone(), r, accumulate)
            again = ell_spmm(*args, out0.clone(), r, accumulate)
            tr = ell_spmm(*args, out0.T.contiguous(), r, accumulate,
                          transposed=True)
            torch.cuda.synchronize()
            err = (float((got.double() - want).abs().max())
                   / float(want.abs().max()))
            assert err <= tol, (g_pad, L, B, k, accumulate, err)
            assert torch.equal(got, again), (g_pad, L, B, k)
            assert torch.equal(tr, got.T), (g_pad, L, B, k)
