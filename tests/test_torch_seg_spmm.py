"""The gather-SpMMs of the static sparse node operand (kernels/seg_spmm.py):
the term pass (`seg_spmm`, entries by term offsets) and the chunk pass
(`chunk_spmm`, chunks by slot, each chunk's live entries only).  Their
plain versions against a dense numpy evaluation on the CPU, and (marked
`cuda`) the CUDA kernel against the plain version on the card: each output
entry within TOL of its own sum of |val * table| (f32 sums in another
order, grown as the square root of the entry's segment past 128 entries;
f64 to 1e-12), bit-equal between two launches and between an eager and a
captured launch."""

import numpy as np
import pytest
import torch

from smallk_torch.kernels import seg_spmm as kmod
from smallk_torch.kernels.seg_spmm import (chunk_spmm, chunk_spmm_reference,
                                           seg_spmm, seg_spmm_reference)

torch.set_num_threads(1)

TOL = {torch.float32: 2e-5, torch.float64: 1e-12}
PAIRS = [("float32", "float32"), ("bfloat16", "float32"),
         ("float8_e4m3fn", "float32"), ("float64", "float64")]


def _t(a, dt, device):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)


def _term_inputs(cap, n_live, n_keys, k, B, heavy=0.0, seed=0,
                 device="cpu", **_):
    """The term pass's inputs: n_live entries sorted by key over n_keys
    (a share `heavy` of them on one key), as offsets ptr (n_keys + 1);
    gather indices with ~10% sentinels (B), values and a (B, k) table in
    f64; entries past n_live hold junk."""
    rng = np.random.RandomState(seed)
    key = np.sort(rng.randint(0, n_keys, n_live))
    if heavy:
        lo = int(n_live * 0.3)
        key[lo:lo + int(heavy * n_live)] = key[lo] if n_live else 0
        key = np.sort(key)
    ptr = np.searchsorted(key, np.arange(n_keys + 1))
    gather = rng.randint(0, B, cap)
    gather[rng.rand(cap) < 0.1] = B
    gather[n_live:] = rng.randint(0, B + 1, cap - n_live)
    return (_t(ptr, torch.int32, device), _t(gather, torch.int32, device),
            _t(rng.rand(cap) + 0.1, torch.float64, device),
            _t(rng.rand(B, k), torch.float64, device))


def _chunk_inputs(n_slots, L0, k, B, full=0.5, spare=3, seed=0,
                  device="cpu", **_):
    """The chunk pass's inputs: 0 to 3 chunks a slot (slots past n_slots
    // 2 + 1 with none at all when `full` is 0), each chunk's live length
    from 0 to L0 (L0 for a share `full`), `spare` chunks past the last;
    rows of live entries in [0, B] (B the sentinel), and in the padding
    valid indices and large values, which must not be read."""
    rng = np.random.RandomState(seed)
    cnt = rng.randint(0, 4, n_slots)
    if not full:
        cnt[n_slots // 2 + 1:] = 0
    starts = np.concatenate([[0], np.cumsum(cnt)])
    chunks = int(starts[-1]) + spare
    lens = rng.randint(0, L0 + 1, chunks)
    lens[rng.rand(chunks) < full] = L0
    lens[int(starts[-1]):] = rng.randint(0, L0 + 1, spare)
    rows = rng.randint(0, B, (chunks, L0))
    rows[rng.rand(chunks, L0) < 0.1] = B
    vals = rng.rand(chunks, L0) + 0.1
    pad = np.arange(L0)[None, :] >= lens[:, None]
    vals[pad] = 1e6
    return (_t(starts, torch.int32, device), _t(lens, torch.int32, device),
            _t(rows.ravel(), torch.int32, device),
            _t(vals.ravel(), torch.float64, device),
            _t(rng.rand(B, k), torch.float64, device))


def _dense_terms(ptr, gather, val, table):
    ptr, gather = ptr.cpu().numpy(), gather.cpu().numpy()
    val, table = val.cpu().double().numpy(), table.cpu().double().numpy()
    out = np.zeros((len(ptr) - 1, table.shape[1]))
    for r in range(len(ptr) - 1):
        for e in range(ptr[r], ptr[r + 1]):
            if gather[e] < table.shape[0]:
                out[r] += val[e] * table[gather[e]]
    return out


def _dense_chunks(starts, lens, rows, vals, table):
    starts, lens = starts.cpu().numpy(), lens.cpu().numpy()
    rows, vals = rows.cpu().numpy(), vals.cpu().double().numpy()
    table = table.cpu().double().numpy()
    L0 = len(rows) // len(lens)
    out = np.zeros((len(starts) - 1, table.shape[1]))
    for s in range(len(starts) - 1):
        for c in range(starts[s], starts[s + 1]):
            for e in range(c * L0, c * L0 + lens[c]):
                if rows[e] < table.shape[0]:
                    out[s] += vals[e] * table[rows[e]]
    return out


def _close(got, want, tol):
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= tol * scale


def _close_rows(got, plain, val, table, tol, grow):
    """`got` against the plain version (`plain(val, table)`) evaluated in
    f64, entry by entry: within `tol` of the entry's sum of |val * table|,
    grown (`grow`, an f32 sum) as the square root of its segment's entries
    past 128."""
    v, t = val.cpu().double(), table.cpu().double()
    want = plain(v, t)
    rowsum = plain(v.abs(), t.abs())
    rowlen = plain(torch.ones_like(v), torch.ones_like(t))
    grown = rowlen.div(128).clamp(min=1.0).sqrt() if grow else 1.0
    err = (got.cpu().double() - want).abs()
    assert bool((err <= tol * grown * rowsum).all())


# each case: a term pass (cap, n_live, n_keys, k, B, heavy) and a chunk
# pass (n_slots, L0, k, B, full)
CASES = {
    "small": dict(cap=40, n_live=33, n_keys=7, k=2, B=9, n_slots=7, L0=4),
    "chunked": dict(cap=4096, n_live=3000, n_keys=300, k=2, B=50,
                    n_slots=300, L0=16, full=0.3),
    "heavy": dict(cap=5000, n_live=4999, n_keys=40, k=3, B=400, heavy=0.8,
                  n_slots=40, L0=128, full=0.9),
    "k8": dict(cap=1500, n_live=1500, n_keys=90, k=8, B=120, n_slots=90,
               L0=8),
    "none live": dict(cap=300, n_live=0, n_keys=10, k=2, B=20, n_slots=10,
                      L0=8, full=0.0),
}


def _out(shape, transposed, dtype=torch.float64, device="cpu", fill=7.0):
    n, k = shape
    return torch.full((k, n) if transposed else (n, k), fill, dtype=dtype,
                      device=device)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_dense(case, transposed):
    """Both passes' plain versions (what the CPU runs) against a dense
    evaluation; every key written, 0 where it has no entry."""
    c = CASES[case]
    ptr, gather, val, table = _term_inputs(**c)
    out = _out((c["n_keys"], c["k"]), transposed)
    seg_spmm(ptr, gather, val, table, out, transposed)
    want = _dense_terms(ptr, gather, val, table)
    _close(out.numpy().T if transposed else out.numpy(), want, 1e-13)
    args = _chunk_inputs(**c)
    out = _out((c["n_slots"], c["k"]), transposed)
    chunk_spmm(*args, out, transposed)
    want = _dense_chunks(*args)
    _close(out.numpy().T if transposed else out.numpy(), want, 1e-13)


def test_strided_table_and_low_precision_values():
    """A transposed view as the table (H^T), bf16 and e4m3 values summed
    in f32."""
    ptr, gather, val, table = _term_inputs(**CASES["chunked"])
    starts, lens, rows, cvals, ctable = _chunk_inputs(**CASES["chunked"])
    H = table.T.contiguous().float()
    for vdt in (torch.bfloat16, torch.float8_e4m3fn):
        v = val.to(torch.float32).to(vdt)
        out = torch.empty((300, 2), dtype=torch.float32)
        seg_spmm(ptr, gather, v, H.T, out)
        _close(out.numpy(), _dense_terms(ptr, gather, v.float(), H.T), 2e-6)
        cv = cvals.clamp(max=2).float().to(vdt)
        out = torch.empty((2, 300), dtype=torch.float32)
        chunk_spmm(starts, lens, rows, cv, H.T, out, transposed=True)
        _close(out.numpy().T, _dense_chunks(starts, lens, rows, cv.float(),
                                            H.T), 2e-6)


@pytest.mark.parametrize("bad", ["k", "n_live", "key dtype", "short keys",
                                 "out shape", "devices"])
def test_wrapper_checks(bad):
    """The term pass's checks: k, ptr's length and dtype, a ptr that does
    not rise from 0 (the live count `n_live` is ptr's last entry), out's
    shape, devices."""
    ptr, gather, val, table = _term_inputs(**CASES["small"])
    out = torch.zeros((7, 2), dtype=torch.float64)
    if bad == "k":
        table = torch.rand(9, 9, dtype=torch.float64)
        out = torch.zeros((7, 9), dtype=torch.float64)
    elif bad == "n_live":
        ptr = ptr.clone()
        ptr[-1] = gather.numel() + 1
    elif bad == "key dtype":
        ptr = ptr.long()
    elif bad == "short keys":
        ptr = ptr[:-1]
    elif bad == "out shape":
        out = torch.zeros((7, 3), dtype=torch.float64)
    else:
        out = out.to("meta")
    with pytest.raises(ValueError):
        seg_spmm(ptr, gather, val, table, out)


@pytest.mark.parametrize("bad", ["L0", "starts length", "lens dtype",
                                 "vals shape", "starts past the chunks",
                                 "devices"])
def test_chunk_wrapper_checks(bad):
    """The chunk pass's checks: a power-of-two chunk length of at least 4,
    starts (n_slots + 1) int32 rising to at most the chunks, vals as rows,
    devices."""
    starts, lens, rows, vals, table = _chunk_inputs(**CASES["chunked"])
    out = torch.zeros((300, 2), dtype=torch.float64)
    if bad == "L0":
        rows, vals = rows[:-1], vals[:-1]
    elif bad == "starts length":
        starts = starts[:-1]
    elif bad == "lens dtype":
        lens = lens.long()
    elif bad == "vals shape":
        vals = vals[:-1]
    elif bad == "starts past the chunks":
        starts = starts.clone()
        starts[-1] = lens.numel() + 1
    else:
        out = out.to("meta")
    with pytest.raises(ValueError):
        chunk_spmm(starts, lens, rows, vals, table, out)


def test_chunk_pass_reads_no_padding():
    """Entries past a chunk's live length hold valid indices and large
    values: the plain version reads none of them, and lengths of 0 give a
    zero slot."""
    starts, lens, rows, vals, table = _chunk_inputs(**CASES["heavy"])
    out = torch.empty((40, 3), dtype=torch.float64)
    chunk_spmm(starts, lens, rows, vals, table, out)
    assert float(out.max()) < 1e5
    zero = torch.zeros_like(lens)
    chunk_spmm(starts, zero, rows, vals, table, out)
    assert not out.any()


def _cuda_case(c, pair, device="cuda"):
    """A case's term and chunk inputs on the card in `pair`'s dtypes."""
    vdt, tdt = (getattr(torch, d) for d in pair)
    ptr, gather, val, table = _term_inputs(**c, device=device)
    starts, lens, rows, cvals, ctable = _chunk_inputs(**c, device=device)
    cvals = cvals.clamp(max=2.0)  # the padding's values fit e4m3 too
    return ((ptr, gather, val.float().to(vdt), table.to(tdt)),
            (starts, lens, rows, cvals.float().to(vdt), ctable.to(tdt)))


def _check_kernel(fn, reference, args, n, k, transposed):
    """`fn` (a pass) on the card: two launches and a captured one
    bit-equal, the counter one a call, each entry within tolerance of the
    plain version evaluated in f64."""
    acc = kmod.sum_dtype(args[-1].dtype)
    out = torch.empty((k, n) if transposed else (n, k), dtype=acc,
                      device="cuda")
    before = kmod.launches
    fn(*args, out, transposed)
    again = torch.empty_like(out)
    fn(*args, again, transposed)
    assert kmod.launches - before == 2
    assert torch.equal(out, again)
    g = torch.cuda.CUDAGraph()
    captured = torch.empty_like(out)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        with torch.cuda.graph(g):
            fn(*args, captured, transposed)
    torch.cuda.current_stream().wait_stream(s)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, captured)
    assert bool(torch.isfinite(out).all())
    head = [a.cpu() for a in args[:-2]]

    def plain(v, t):
        o = torch.empty(out.shape, dtype=torch.float64)
        return reference(*head, v, t, o, transposed)

    _close_rows(out, plain, args[-2], args[-1], TOL[acc],
                acc == torch.float32)


LONG = dict(cap=3_200_000, n_live=3_100_000, n_keys=5000, k=2, B=20_000,
            heavy=0.5, n_slots=200_000, L0=128, full=0.6)


@pytest.mark.cuda
@pytest.mark.parametrize("pair", PAIRS)
@pytest.mark.parametrize("case", sorted(CASES) + ["long"])
def test_cuda_kernel_matches_plain(case, pair):
    """Both passes' kernels against their plain versions on the same
    inputs (held to the plain version evaluated in f64); two launches and
    a captured launch give the same bits; the counter counts each call
    once.  "long" gives each block of the term pass several tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    c = CASES.get(case, LONG)
    terms, chunks = _cuda_case(c, pair)
    for transposed in (False, True):
        _check_kernel(seg_spmm, seg_spmm_reference, terms, c["n_keys"],
                      c["k"], transposed)
        _check_kernel(chunk_spmm, chunk_spmm_reference, chunks,
                      c["n_slots"], c["k"], transposed)


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(1, 9))
def test_cuda_every_k(k):
    """k = 1 to 8 at every type pair, the table contiguous (rows read as
    pairs at an even k) and as a transposed view."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    c = dict(CASES["chunked"], k=k)
    for pair in PAIRS:
        terms, chunks = _cuda_case(c, pair)
        for args, fn, ref, n in ((terms, seg_spmm, seg_spmm_reference,
                                  c["n_keys"]),
                                 (chunks, chunk_spmm, chunk_spmm_reference,
                                  c["n_slots"])):
            strided = args[-1].T.contiguous().T
            for table in (args[-1], strided):
                _check_kernel(fn, ref, (*args[:-1], table), n, k, False)


@pytest.mark.cuda
@pytest.mark.parametrize("live", ["none", "all"])
def test_cuda_live_counts(live):
    """No live entry (every key 0) and every entry live (ptr[-1] the
    capacity; every chunk full, none spare)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    n = 0 if live == "none" else 200_000
    c = dict(cap=200_000, n_live=n, n_keys=700, k=2, B=3000, heavy=0.3,
             n_slots=3000, L0=128, full=float(bool(n)), spare=0)
    for pair in PAIRS:
        terms, chunks = _cuda_case(c, pair)
        if not n:
            chunks = (torch.zeros_like(chunks[0]), *chunks[1:])
        _check_kernel(seg_spmm, seg_spmm_reference, terms, c["n_keys"], 2,
                      False)
        _check_kernel(chunk_spmm, chunk_spmm_reference, chunks,
                      c["n_slots"], 2, True)
        if not n:
            out = torch.full((700, 2), 7.0, device="cuda",
                             dtype=kmod.sum_dtype(terms[-1].dtype))
            assert not seg_spmm(*terms, out).any()
