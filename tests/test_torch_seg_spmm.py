"""The sorted segmented gather-SpMM (kernels/seg_spmm.py): its plain
version against a dense numpy evaluation on the CPU, and (marked `cuda`)
the CUDA kernel against the plain version on the card: each output entry
within TOL of its own sum of |val * table| (f32 sums in another order,
grown as the square root of the entry's segment past 128 entries; f64 to
1e-12), bit-equal between two launches and between an eager and a
captured launch."""

import numpy as np
import pytest
import torch

from smallk_torch.kernels import seg_spmm as kmod
from smallk_torch.kernels.seg_spmm import seg_spmm, seg_spmm_reference

torch.set_num_threads(1)

TOL = {torch.float32: 2e-5, torch.float64: 1e-12}


def _inputs(cap, n_live, n_keys, k, B, shift=0, heavy=0.0, seed=0,
            val_dtype=torch.float64, table_dtype=torch.float64,
            device="cpu"):
    """Sorted keys (one per 2^shift entries) over n_keys, a share `heavy`
    of the live keys on one key, gather indices with ~10% sentinels (B),
    values and a (B, k) table; entries past n_live hold junk."""
    rng = np.random.RandomState(seed)
    nk = -(-cap // (1 << shift))
    key = np.sort(rng.randint(0, n_keys, nk))
    if heavy:
        lo = int(nk * 0.3)
        key[lo:lo + int(heavy * nk)] = key[lo]
        key = np.sort(key)
    gather = rng.randint(0, B, cap)
    gather[rng.rand(cap) < 0.1] = B
    gather[n_live:] = rng.randint(0, B + 1, cap - n_live)
    val = rng.rand(cap) + 0.1
    table = rng.rand(B, k)
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)  # noqa
    return (t(key, torch.int32), t(gather, torch.int32), t(val, val_dtype),
            t(table, table_dtype),
            torch.tensor(n_live, dtype=torch.int64, device=device))


def _dense(key, gather, val, table, n_live, shift, n_out):
    """out[key(e)] += val[e] * table[gather[e]] in numpy f64."""
    key, gather = key.cpu().numpy(), gather.cpu().numpy()
    val = val.cpu().double().numpy()
    table = table.cpu().double().numpy()
    out = np.zeros((n_out, table.shape[1]))
    for e in range(int(n_live)):
        if gather[e] < table.shape[0]:
            out[key[e >> shift]] += val[e] * table[gather[e]]
    return out


def _close(got, want, tol):
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= tol * scale


def _close_rows(got, key, gather, val, table, n_live, shift, transposed,
                tol, grow):
    """`got` against the plain version evaluated in f64, entry by entry:
    within `tol` of the entry's sum of |val * table|, grown (`grow`, an f32
    sum) as the square root of its segment's entries past 128."""
    def plain(v, t):
        out = torch.empty(got.shape, dtype=torch.float64)
        return seg_spmm_reference(key.cpu(), gather.cpu(), v, t, out,
                                  n_live.cpu(), shift, transposed)

    v, t = val.cpu().double(), table.cpu().double()
    want = plain(v, t)
    rowsum = plain(v.abs(), t.abs())
    rowlen = plain(torch.ones_like(v), torch.ones_like(t))
    grown = rowlen.div(128).clamp(min=1.0).sqrt() if grow else 1.0
    err = (got.cpu().double() - want).abs()
    assert bool((err <= tol * grown * rowsum).all())


CASES = {
    "small": dict(cap=40, n_live=33, n_keys=7, k=2, B=9),
    "chunked": dict(cap=4096, n_live=3000, n_keys=300, k=2, B=50, shift=4),
    "heavy": dict(cap=5000, n_live=4999, n_keys=40, k=3, B=400, heavy=0.8),
    "k8": dict(cap=1500, n_live=1500, n_keys=90, k=8, B=120, shift=2),
    "none live": dict(cap=300, n_live=0, n_keys=10, k=2, B=20),
}


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_dense(case, transposed):
    c = CASES[case]
    key, gather, val, table, n_live = _inputs(**c)
    n_out = c["n_keys"]
    out = torch.full((c["k"], n_out) if transposed else (n_out, c["k"]),
                     7.0, dtype=torch.float64)
    seg_spmm(key, gather, val, table, out, n_live, c.get("shift", 0),
             transposed)
    want = _dense(key, gather, val, table, n_live, c.get("shift", 0), n_out)
    _close(out.numpy().T if transposed else out.numpy(), want, 1e-13)


def test_strided_table_and_low_precision_values():
    """A transposed view as the table (H^T), bf16 and e4m3 values summed
    in f32."""
    key, gather, val, table, n_live = _inputs(**CASES["chunked"])
    H = table.T.contiguous().float()
    for vdt in (torch.bfloat16, torch.float8_e4m3fn):
        v = val.to(torch.float32).to(vdt)
        out = torch.empty((300, 2), dtype=torch.float32)
        seg_spmm(key, gather, v, H.T, out, n_live, 4)
        want = _dense(key, gather, v.float(), H.T, n_live, 4, 300)
        _close(out.numpy(), want, 2e-6)


@pytest.mark.parametrize("bad", ["k", "n_live", "key dtype", "short keys",
                                 "out shape", "devices"])
def test_wrapper_checks(bad):
    key, gather, val, table, n_live = _inputs(**CASES["small"])
    out = torch.zeros((7, 2), dtype=torch.float64)
    if bad == "k":
        table = torch.rand(9, 9, dtype=torch.float64)
        out = torch.zeros((7, 9), dtype=torch.float64)
    elif bad == "n_live":
        n_live = torch.tensor(3)
        n_live = n_live.to(torch.int32)
    elif bad == "key dtype":
        key = key.long()
    elif bad == "short keys":
        key = key[:10]
    elif bad == "out shape":
        out = torch.zeros((7, 3), dtype=torch.float64)
    else:
        out = out.to("meta")
    with pytest.raises(ValueError):
        seg_spmm(key, gather, val, table, out, n_live)


@pytest.mark.cuda
@pytest.mark.parametrize("pair", [("float32", "float32"),
                                  ("bfloat16", "float32"),
                                  ("float8_e4m3fn", "float32"),
                                  ("float64", "float64")])
@pytest.mark.parametrize("case", sorted(CASES) + ["long"])
def test_cuda_kernel_matches_plain(case, pair):
    """The kernel against the plain version on the same inputs (held to
    the plain version evaluated in f64); two launches and a captured
    launch give the same bits; the counter counts each call once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    c = dict(CASES.get(case, dict(cap=600_000, n_live=590_000, n_keys=5000,
                                  k=2, B=20_000, heavy=0.5)))
    vdt, tdt = (getattr(torch, d) for d in pair)
    key, gather, val, table, n_live = _inputs(**c, device="cuda")
    val = val.float().to(vdt)
    table = table.to(tdt)
    shift = c.get("shift", 0)
    acc = kmod.sum_dtype(tdt)
    for transposed in (False, True):
        shape = ((c["k"], c["n_keys"]) if transposed
                 else (c["n_keys"], c["k"]))
        out = torch.empty(shape, dtype=acc, device="cuda")
        before = kmod.launches
        seg_spmm(key, gather, val, table, out, n_live, shift, transposed)
        again = torch.empty_like(out)
        seg_spmm(key, gather, val, table, again, n_live, shift, transposed)
        assert kmod.launches - before == 2
        assert torch.equal(out, again)
        g = torch.cuda.CUDAGraph()
        captured = torch.empty_like(out)
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            with torch.cuda.graph(g):
                seg_spmm(key, gather, val, table, captured, n_live, shift,
                         transposed)
        torch.cuda.current_stream().wait_stream(s)
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, captured)
        _close_rows(out, key, gather, val, table, n_live, shift, transposed,
                    TOL[acc], acc == torch.float32)
