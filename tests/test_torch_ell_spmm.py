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
    return idx, vals, table, out, rows


@pytest.mark.parametrize("case", ["idx_dtype", "vals_shape", "out_width",
                                  "rows_dtype", "rows_too_many",
                                  "no_rows_too_few_out", "meta_device"])
def test_wrapper_rejects_bad_inputs(case):
    with pytest.raises(ValueError):
        ell_spmm(*_bad_inputs(case))


def test_build_knows_the_library():
    assert (_build.CSRC / "ell_spmm.cu").is_file()
    assert kmod.SOURCE == "smallk_torch/csrc/ell_spmm.cu"
    sigs = _build.SIGNATURES["ell_spmm"]
    for pair in ("f32_f32", "bf16_f32", "f32_bf16", "f64_f64"):
        args, ret = sigs[f"smallk_ell_spmm_{pair}"]
        # five pointers, six ints, the stream as a pointer, the device
        assert args == (_build._P,) * 5 + (_build._I,) * 6 + (_build._P,
                                                             _build._I)
        assert ret is _build._I
    assert set(kmod.REPLACES) == {"P1", "P2"}


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
