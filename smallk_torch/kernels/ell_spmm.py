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

`ell_spmm` launches the hand-written Hopper kernel (csrc/ell_spmm.cu) on
CUDA tensors, for (vals, table) in (f32, f32), (bf16, f32), (f32, bf16)
with an f32 `out`, and (f64, f64) with an f64 `out`; any other pair
raises.  On CPU tensors it takes the plain torch version,
`ell_spmm_reference`, and only there.
"""

from __future__ import annotations

import torch

from . import _build

SOURCE = "smallk_torch/csrc/ell_spmm.cu"
REPLACES = {"P1": "scripts/tpu_batch29.py:72",
            "P2": "scripts/tpu_batch33.py:71"}

# kernel launches since the last reset; the only place it grows is the
# launch below
launches = 0
# plain-version calls on CUDA tensors since the last reset: the main path
# makes none (chip_smoke.py holds it to that)
plain_cuda_calls = 0

# bound on the plain version's (chunk, L, k) gathered tensor
_REF_BYTES_BUDGET = 256 * 1024 * 1024

f32, bf16, f64 = torch.float32, torch.bfloat16, torch.float64
# (vals dtype, table dtype) -> (C entry point, out dtype)
_KERNELS = {
    (f32, f32): ("smallk_ell_spmm_f32_f32", f32),
    (bf16, f32): ("smallk_ell_spmm_bf16_f32", f32),
    (f32, bf16): ("smallk_ell_spmm_f32_bf16", f32),
    (f64, f64): ("smallk_ell_spmm_f64_f64", f64),
}


def ell_spmm(idx, vals, table, out, rows=None, accumulate=False):
    """One bucket's product into `out` (n_out, k); returns `out`.

    CUDA tensors: the kernel (contiguous operands, a dtype pair of
    `_KERNELS`), or an exception.  CPU tensors: the plain version.
    """
    global launches
    g = _check(idx, vals, table, out, rows)
    dev = table.device
    if dev.type == "cpu":
        return ell_spmm_reference(idx, vals, table, out, rows, accumulate)
    if dev.type != "cuda":
        raise ValueError(f"ell_spmm: unsupported device {dev}")
    try:
        name, out_dtype = _KERNELS[vals.dtype, table.dtype]
    except KeyError:
        raise ValueError(f"ell_spmm: vals {vals.dtype} with table "
                         f"{table.dtype} (the kernel takes "
                         f"{sorted((str(v)[6:], str(t)[6:]) for v, t in _KERNELS)})"
                         ) from None
    if out.dtype != out_dtype:
        raise ValueError(f"ell_spmm: out dtype {out.dtype} (the kernel sums "
                         f"this pair into {out_dtype})")
    named = (("idx", idx), ("vals", vals), ("table", table), ("out", out))
    for tname, t in named + ((("rows", rows),) if rows is not None else ()):
        if not t.is_contiguous():
            raise ValueError(f"ell_spmm: {tname} is not contiguous")
    if g == 0:
        return out
    B, k = table.shape
    # a lane takes 4 columns where a row's 4-column groups are aligned
    item = table.element_size()
    vec = 4 if k % 4 == 0 and table.data_ptr() % (4 * item) == 0 else 1
    lib = _build.load_library("ell_spmm")
    err = getattr(lib, name)(
        idx.data_ptr(), vals.data_ptr(), table.data_ptr(), out.data_ptr(),
        rows.data_ptr() if rows is not None else None, g, idx.shape[1], B, k,
        int(bool(accumulate)), vec, torch.cuda.current_stream(dev).cuda_stream,
        dev.index)
    if err != 0:
        msg = lib.smallk_ell_cuda_error_string(err).decode()
        raise RuntimeError(f"ell_spmm kernel launch failed: {msg} (cudaError "
                           f"{err}, g={g}, L={idx.shape[1]}, B={B}, k={k})")
    launches += 1
    return out


def _check(idx, vals, table, out, rows):
    """Shapes, index dtypes and devices; the number of rows to compute."""
    if idx.ndim != 2 or vals.shape != idx.shape or idx.dtype != torch.int32:
        raise ValueError(f"ell_spmm: idx {tuple(idx.shape)} {idx.dtype} and "
                         f"vals {tuple(vals.shape)} must be one (g, L) shape, "
                         "idx int32")
    if table.ndim != 2 or out.ndim != 2 or out.shape[1] != table.shape[1]:
        raise ValueError(f"ell_spmm: table {tuple(table.shape)} and out "
                         f"{tuple(out.shape)} must be (B, k) and (n, k)")
    if idx.shape[1] < 1 or table.shape[1] < 1:
        raise ValueError("ell_spmm: L and k must be >= 1")
    g = idx.shape[0]
    if rows is not None:
        if rows.ndim != 1 or rows.dtype != torch.int32 or rows.shape[0] > g:
            raise ValueError(f"ell_spmm: rows {tuple(rows.shape)} "
                             f"{rows.dtype} must be int32 (g,), g <= "
                             f"{idx.shape[0]}")
        g = rows.shape[0]
    elif g > out.shape[0]:
        raise ValueError(f"ell_spmm: {g} bucket rows into {out.shape[0]} "
                         "output rows")
    tensors = (idx, vals, table, out) + ((rows,) if rows is not None else ())
    if any(t.device != table.device for t in tensors):
        raise ValueError("ell_spmm: operands on different devices")
    return g


def ell_spmm_reference(idx, vals, table, out, rows=None, accumulate=False):
    """Plain torch version: per chunk of bucket rows, `index_select` of the
    table rows, a weighted sum over L in out's dtype, and the rows written
    (or added) into `out`.  The chunk bounds the (chunk, L, k) gathered
    tensor; bucket rows are independent, so the chunking does not change
    a bit of the result."""
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
        if accumulate:
            out.index_add_(0, dst, part)
        else:
            out.index_copy_(0, dst, part)
    return out
