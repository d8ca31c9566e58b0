"""ELL gather-SpMM: the CUDA kernel's wrapper and its plain version.

The counterpart of the TPU probes scripts/tpu_batch29.py (P1) and
scripts/tpu_batch33.py (P2), which tried to fuse the bucket product of
the bucketed-ELL operand (smallk_tpu/ops/ell.py, `_bucket_product`) into
one Pallas kernel.  For one bucket,

    out[row(r), :] (= or +=) sum over l with idx[r, l] < B of
                             vals[r, l] * table[idx[r, l], :]

with idx (g_pad, L) int32, vals (g_pad, L) in A's storage dtype, table
(B, k), row(r) = rows[r] for r < len(rows) (the bucket's major ids) or r
for r < g_pad when `rows` is None.  idx == B is the padding sentinel and
contributes nothing.  `accumulate` adds the bucket's sums to what `out`
holds (the minor-blocked families add their per-block partials so).
`transposed` takes `out` as (k, n_out) and writes bucket row r to its
column row(r): the same sums, bit for bit, in the layout W'A is used in.
Each output entry is summed over l in ascending order, in every variant.

`ell_spmm` launches the hand-written Hopper kernel (csrc/ell_spmm.cu) on
CUDA tensors, for (vals, table) in (f32, f32), (bf16, f32), (f32, bf16)
with an f32 `out`, and (f64, f64) with an f64 `out`; any other pair
raises.  On CPU tensors it takes the plain torch version,
`ell_spmm_reference`, and only there.  `ell_spmm_buckets` does the same
for a list of buckets checked once (`Buckets`), one kernel launch a
bucket from one host call; the operands launch their families so.
`launch_plan` decides how the kernel spreads a bucket over the card's
lanes (a pure function, so the CPU tests pin it).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import _build

SOURCE = "smallk_torch/csrc/ell_spmm.cu"
REPLACES = {"P1": "scripts/tpu_batch29.py:72",
            "P2": "scripts/tpu_batch33.py:71"}

# kernel launches since the last reset; the only place it grows is the
# launch below
launches = 0
# the transposed ones among them (W'A's column buckets)
transposed_launches = 0
# plain-version calls on CUDA tensors since the last reset: the main path
# makes none (chip_smoke.py holds it to that)
plain_cuda_calls = 0

# bound on the plain version's (chunk, L, k) gathered tensor
_REF_BYTES_BUDGET = 256 * 1024 * 1024

# A row of more than SPLIT_MIN_L entries is shared by several warps, so
# that no lane's chain of fmas passes MAX_CHAIN entries (up to 32 warps, one
# 1024-thread block; at k <= 2 that keeps chains within 256 up to 262,144
# entries).  A long row's launch waits out its chain, a batch of 8 entries
# a lane at a time: on an H100 80GB HBM3 (700 W) the sparse hierclust
# root's AH' took 1.78 ms of device time at 32, 2.02 at 64, 2.61 at 128,
# 3.85 at 256 and 11.20 unsplit (chip_smoke.py --ell; PERF.md).  Rows up
# to SPLIT_MIN_L keep one warp at every k: the flagship's rows (L <= 512
# at k = 128) keep their bits.  Rows shorter than a warp share one: a row
# takes as many lanes as its length rounded up to a power of two (at least
# one entry's).  On the same card a k = 2 bucket of 20,000 rows took
# 0.0049-0.0050 ms at L = 8 and 0.0070-0.0072 at L = 16 so, 0.0110-0.0114
# with a warp a row.
MAX_CHAIN = 32
SPLIT_MIN_L = 1024
MAX_WARPS_PER_ROW = 32


class Plan(NamedTuple):
    """How one launch spreads a bucket over the card (csrc/ell_spmm.cu):
    `vec` table columns a lane loads at once, `lanes_per_entry` lanes on
    one entry's table row, `lanes_per_row` lanes of the sub-warp a row has
    (32, or fewer for short rows), `warps_per_row` warps sharing a long
    row."""
    vec: int
    lanes_per_entry: int
    lanes_per_row: int
    warps_per_row: int

    @property
    def in_flight(self) -> int:
        """Entries of one row in flight at once."""
        return (self.lanes_per_row // self.lanes_per_entry
                * self.warps_per_row)

    def chain(self, L: int) -> int:
        """The longest chain of fmas a lane keeps for a row of L."""
        return -(-L // self.in_flight)


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def launch_plan(k: int, L: int, item: int, aligned: int) -> Plan:
    """The launch plan for a bucket of length L into k columns, for a table
    of `item`-byte entries whose address is a multiple of `aligned` bytes.

    A lane loads 4, 2 or 1 consecutive columns (the widest that divides k
    and the address allows); an entry takes the next power of two of
    k / vec lanes, at most 32, so a warp holds 32 / that many entries in
    flight (32 at k = 2, one at k = 128: one entry broadcast to the warp;
    at k = 8 and 16 groups of 2 and 4 lanes took 2.1-5.0x less device time
    than the broadcast to a warp in the same sparse hierclust products:
    chip_smoke.py --ell, PERF.md).
    Past SPLIT_MIN_L entries a row takes the fewest warps, a power of two
    up to MAX_WARPS_PER_ROW, that keep every lane's chain within
    MAX_CHAIN.  A row shorter than 32 entries takes a sub-warp of its
    length rounded up to a power of two (never fewer lanes than one entry
    needs), so a warp holds several such rows."""
    vec = next(v for v in (4, 2, 1) if k % v == 0 and aligned % (v * item) == 0)
    lanes = min(32, _pow2_at_least(-(-k // vec)))
    warps, per_row = 1, 32
    if L > SPLIT_MIN_L:
        need = -(-L // ((32 // lanes) * MAX_CHAIN))
        warps = min(MAX_WARPS_PER_ROW, _pow2_at_least(need))
    else:
        per_row = max(lanes, min(32, _pow2_at_least(L)))
    return Plan(vec, lanes, per_row, warps)


f32, bf16, f64 = torch.float32, torch.bfloat16, torch.float64
f8 = torch.float8_e4m3fn
# (vals dtype, table dtype) -> (C entry point, out dtype)
_KERNELS = {
    (f32, f32): ("smallk_ell_spmm_f32_f32", f32),
    (bf16, f32): ("smallk_ell_spmm_bf16_f32", f32),
    (f8, f32): ("smallk_ell_spmm_f8_f32", f32),
    (f32, bf16): ("smallk_ell_spmm_f32_bf16", f32),
    (f64, f64): ("smallk_ell_spmm_f64_f64", f64),
}


def ell_spmm(idx, vals, table, out, rows=None, accumulate=False,
             transposed=False):
    """One bucket's product into `out`, (n_out, k) or with `transposed`
    (k, n_out); returns `out`.

    CUDA tensors: the kernel (contiguous operands, a dtype pair of
    `_KERNELS`), or an exception.  CPU tensors: the plain version.
    """
    return ell_spmm_buckets(Buckets([(rows, idx, vals)]), table, out,
                            accumulate, transposed)


class Buckets:
    """Buckets (rows, idx, vals) of one operand family, checked once and
    recorded for the kernel: each bucket's idx, vals and rows addresses,
    g and L, and per (k, entry size, alignment) of the table, with its
    launch plan (`descriptors`).  The operands build one per family and
    minor block and launch all of its buckets with one host call
    (`ell_spmm_buckets`): a launch through the wrapper costs the host
    tens of us, the card's launch a few."""

    def __init__(self, buckets):
        self.buckets = tuple(buckets)
        record = []
        for rows, idx, vals in self.buckets:
            g = _check_bucket(idx, vals, rows)
            record.append((idx.data_ptr(), vals.data_ptr(),
                           rows.data_ptr() if rows is not None else 0, g,
                           idx.shape[1]))
        self._record = np.array(record, np.int64).reshape(-1, 5)
        self._descriptors = {}
        devices = {t.device for b in self.buckets for t in b if t is not None}
        dtypes = {vals.dtype for _, _, vals in self.buckets}
        if len(devices) > 1 or len(dtypes) > 1:
            raise ValueError(f"ell_spmm: buckets on {devices} in {dtypes}: "
                             "one device and one value dtype")
        self.device = devices.pop() if devices else None
        self.dtype = dtypes.pop() if dtypes else None
        # kernel launches a product makes (a bucket with no rows makes none)
        self.launching = int((self._record[:, 3] > 0).sum())
        # output rows a bucket without `rows` writes (its g)
        self.direct_rows = max((int(g) for (_, _, rows_ptr, g, _) in record
                                if not rows_ptr), default=0)

    def __len__(self):
        return len(self.buckets)

    def descriptors(self, k: int, item: int, aligned: int) -> np.ndarray:
        """(n, 9) int64, C-contiguous: idx, vals, rows, g, L and the launch
        plan of each bucket for a table of k columns of `item` bytes at an
        address that is a multiple of `aligned`."""
        key = (k, item, aligned)
        desc = self._descriptors.get(key)
        if desc is None:
            plans = np.array([launch_plan(k, int(L), item, aligned)
                              for L in self._record[:, 4]],
                             np.int64).reshape(-1, 4)
            desc = np.ascontiguousarray(np.concatenate([self._record, plans],
                                                       axis=1))
            self._descriptors[key] = desc
        return desc


def ell_spmm_buckets(buckets: Buckets, table, out, accumulate=False,
                     transposed=False):
    """Every bucket of `buckets` into `out`, in their order (with
    `accumulate`, each adds to what the ones before it wrote); returns
    `out`.  CUDA tensors: one kernel launch a bucket, all from one host
    call, or an exception.  CPU tensors: the plain version, bucket by
    bucket (`ell_spmm_buckets_reference`)."""
    global launches, transposed_launches
    _check_table(buckets, table, out, transposed)
    dev = table.device
    if dev.type == "cpu":
        return ell_spmm_buckets_reference(buckets, table, out, accumulate,
                                          transposed)
    if dev.type != "cuda":
        raise ValueError(f"ell_spmm: unsupported device {dev}")
    if not len(buckets):
        return out
    ptr = table.data_ptr()
    # the address's alignment, up to the widest load's 32 bytes
    desc = buckets.descriptors(table.shape[1], table.element_size(),
                               min(ptr & -ptr, 32) if ptr else 32)
    _launch(desc, buckets.dtype, table, out, accumulate, transposed)
    launches += buckets.launching
    if transposed:
        transposed_launches += buckets.launching
    return out


def _launch(desc, vals_dtype, table, out, accumulate, transposed):
    """One kernel launch a row of `desc` (`Buckets.descriptors`, a launch
    plan a bucket), in order on the current stream, or an exception.
    Counts nothing: `ell_spmm_buckets` counts its launches."""
    try:
        name, out_dtype = _KERNELS[vals_dtype, table.dtype]
    except KeyError:
        raise ValueError(f"ell_spmm: vals {vals_dtype} with table "
                         f"{table.dtype} (the kernel takes "
                         f"{sorted((str(v)[6:], str(t)[6:]) for v, t in _KERNELS)})"
                         ) from None
    if out.dtype != out_dtype:
        raise ValueError(f"ell_spmm: out dtype {out.dtype} (the kernel sums "
                         f"this pair into {out_dtype})")
    B, k = table.shape
    dev = table.device
    lib = _build.load_library("ell_spmm")
    failed = ctypes.c_int(-1)
    err = getattr(lib, name)(
        desc.ctypes.data, len(desc), table.data_ptr(), out.data_ptr(), B, k,
        out.shape[1 if transposed else 0], int(bool(accumulate)),
        int(bool(transposed)), torch.cuda.current_stream(dev).cuda_stream,
        dev.index, ctypes.byref(failed))
    if err != 0:
        msg = lib.smallk_ell_cuda_error_string(err).decode()
        i = failed.value
        where = (f"bucket {i} of {len(desc)}, (g, L) = "
                 f"{tuple(desc[i, 3:5])}, plan {tuple(desc[i, 5:])}"
                 if 0 <= i < len(desc) else f"{len(desc)} buckets")
        raise RuntimeError(f"ell_spmm kernel launch failed: {msg} (cudaError "
                           f"{err}, {where}, B={B}, k={k}, "
                           f"transposed={bool(transposed)})")


def _check_bucket(idx, vals, rows):
    """A bucket's shapes, index dtypes, devices and layout; the number of
    rows it computes."""
    if idx.ndim != 2 or vals.shape != idx.shape or idx.dtype != torch.int32:
        raise ValueError(f"ell_spmm: idx {tuple(idx.shape)} {idx.dtype} and "
                         f"vals {tuple(vals.shape)} must be one (g, L) shape, "
                         "idx int32")
    if idx.shape[1] < 1:
        raise ValueError("ell_spmm: L must be >= 1")
    g = idx.shape[0]
    if rows is not None:
        if rows.ndim != 1 or rows.dtype != torch.int32 or rows.shape[0] > g:
            raise ValueError(f"ell_spmm: rows {tuple(rows.shape)} "
                             f"{rows.dtype} must be int32 (g,), g <= "
                             f"{idx.shape[0]}")
        g = rows.shape[0]
    tensors = (("idx", idx), ("vals", vals)) + (
        (("rows", rows),) if rows is not None else ())
    if any(t.device != idx.device for _, t in tensors):
        raise ValueError("ell_spmm: operands on different devices")
    for tname, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"ell_spmm: {tname} is not contiguous")
    return g


def _check_table(buckets, table, out, transposed):
    """The table's and out's shapes, layout and devices against the
    buckets'."""
    kdim, ndim = (0, 1) if transposed else (1, 0)
    if table.ndim != 2 or out.ndim != 2 or out.shape[kdim] != table.shape[1]:
        raise ValueError(f"ell_spmm: table {tuple(table.shape)} and out "
                         f"{tuple(out.shape)} must be (B, k) and "
                         f"{'(k, n)' if transposed else '(n, k)'}")
    if table.shape[1] < 1:
        raise ValueError("ell_spmm: k must be >= 1")
    if buckets.direct_rows > out.shape[ndim]:
        raise ValueError(f"ell_spmm: {buckets.direct_rows} bucket rows into "
                         f"{out.shape[ndim]} output rows")
    if out.device != table.device or buckets.device not in (None,
                                                            table.device):
        raise ValueError("ell_spmm: operands on different devices")
    for tname, t in (("table", table), ("out", out)):
        if not t.is_contiguous():
            raise ValueError(f"ell_spmm: {tname} is not contiguous")


def ell_spmm_buckets_reference(buckets: Buckets, table, out,
                               accumulate=False, transposed=False):
    """Plain torch version of `ell_spmm_buckets`: `ell_spmm_reference` on
    each bucket in order."""
    for rows, idx, vals in buckets.buckets:
        ell_spmm_reference(idx, vals, table, out, rows, accumulate,
                           transposed)
    return out


def ell_spmm_reference(idx, vals, table, out, rows=None, accumulate=False,
                       transposed=False):
    """Plain torch version: per chunk of bucket rows, `index_select` of the
    table rows, a weighted sum over L in out's dtype, and the rows written
    (or added) into `out`, or with `transposed` into its columns.  The
    chunk bounds the (chunk, L, k) gathered tensor; bucket rows are
    independent, so the chunking does not change a bit of the result, and
    the transposed mode writes the same sums."""
    global plain_cuda_calls
    if table.is_cuda:
        plain_cuda_calls += 1
    g = idx.shape[0] if rows is None else rows.shape[0]
    L = idx.shape[1]
    B, k = table.shape
    acc = out.dtype
    chunk = max(1, _REF_BYTES_BUDGET // (L * k * out.element_size()))
    for s in range(0, g, chunk):
        e = min(g, s + chunk)
        ix = idx[s:e].long()
        valid = (ix >= 0) & (ix < B)
        if B:
            gathered = table.index_select(0, torch.where(valid, ix, 0)
                                          .reshape(-1)).reshape(e - s, L, k)
            # a sentinel contributes nothing, whatever table row 0 holds
            gathered = gathered.to(acc).masked_fill_(~valid[..., None], 0)
            part = torch.einsum("gl,glk->gk", vals[s:e].to(acc), gathered)
        else:
            part = torch.zeros((e - s, k), dtype=acc, device=out.device)
        dst = (torch.arange(s, e, device=out.device) if rows is None
               else rows[s:e].long())
        dim, part = (1, part.T) if transposed else (0, part)
        if accumulate:
            out.index_add_(dim, dst, part)
        else:
            out.index_copy_(dim, dst, part)
    return out
