"""Sorted segmented gather-SpMM: the CUDA kernel's wrapper and its plain
version.

The products of the static-shape sparse node operand
(ops/ell_cols.ChunkColsAOp), which the JAX package computes in XLA
(smallk_tpu/ops/ell_cols.py:186-246: a gather of factor rows, then a
sorted segment sum).  For entries e < n_live,

    out[key(e), :] = sum of val[e] * table[gather[e], :]

over the entries of each key, key(e) = key[e >> key_shift] ascending in e;
gather[e] >= B (the table's rows) is the padding sentinel and contributes
nothing, and a key no live entry has gets 0.  `n_live` is a 0-d int64
tensor on the operands' device: on the card the kernel reads it there, so
a launch's shape depends on the capacity `gather.numel()` alone and one
captured CUDA graph serves every node of a width.  `transposed` writes
out as (k, n_out).

`seg_spmm` launches the hand-written Hopper kernel (csrc/seg_spmm.cu, a
tile pass and a carry pass) on CUDA tensors, for (val, table) in (f32,
f32), (bf16, f32), (e4m3, f32) with an f32 out and (f64, f64) with an f64
out, k <= 8; anything else raises.  On CPU tensors it takes the plain torch
version, `seg_spmm_reference` (index_add_ in the sum's dtype), and only
there.
"""

from __future__ import annotations

import torch

from . import _build

SOURCE = "smallk_torch/csrc/seg_spmm.cu"
# no TPU kernel: the XLA formulation of the gathered node operand's products
REPLACES = "smallk_tpu/ops/ell_cols.py:172"
TILE = 256     # entries a warp takes (csrc/seg_spmm.cu kTile)
MAX_K = 8

# wrapper calls that launched the kernel (its tile and carry passes) since
# the last reset; the only place it grows is the launch below
launches = 0
# plain-version calls on CUDA tensors since the last reset: the main path
# makes none (chip_smoke.py holds it to that)
plain_cuda_calls = 0

f32, bf16, f64 = torch.float32, torch.bfloat16, torch.float64
f8 = torch.float8_e4m3fn
# (val dtype, table dtype) -> (C entry point, sum dtype)
_KERNELS = {
    (f32, f32): ("smallk_seg_spmm_f32_f32", f32),
    (bf16, f32): ("smallk_seg_spmm_bf16_f32", f32),
    (f8, f32): ("smallk_seg_spmm_f8_f32", f32),
    (f64, f64): ("smallk_seg_spmm_f64_f64", f64),
}


def sum_dtype(table_dtype):
    """The dtype of the sums and of out: f64 for an f64 table, else f32."""
    return f64 if table_dtype == f64 else f32


def seg_spmm(key, gather, val, table, out, n_live, key_shift=0,
             transposed=False):
    """The product into `out`, (n_out, k) or with `transposed` (k, n_out),
    which it overwrites; returns `out`.

    CUDA tensors: the kernel, or an exception.  CPU tensors: the plain
    version."""
    global launches
    k, n_out = _check(key, gather, val, table, out, n_live, key_shift,
                      transposed)
    dev = table.device
    if dev.type == "cpu":
        return seg_spmm_reference(key, gather, val, table, out, n_live,
                                  key_shift, transposed)
    if dev.type != "cuda":
        raise ValueError(f"seg_spmm: unsupported device {dev}")
    try:
        name, acc = _KERNELS[val.dtype, table.dtype]
    except KeyError:
        raise ValueError(f"seg_spmm: val {val.dtype} with table "
                         f"{table.dtype} (the kernel takes "
                         f"{sorted((str(v)[6:], str(t)[6:]) for v, t in _KERNELS)})"
                         ) from None
    if out.dtype != acc:
        raise ValueError(f"seg_spmm: out dtype {out.dtype} (the kernel sums "
                         f"this pair into {acc})")
    cap = gather.numel()
    tiles = -(-cap // TILE)
    head = torch.empty((tiles, k), dtype=acc, device=dev)
    tail = torch.empty((tiles, k), dtype=acc, device=dev)
    out.zero_()
    out_row, out_col = (1, n_out) if transposed else (k, 1)
    lib = _build.load_library("seg_spmm")
    err = getattr(lib, name)(
        key.data_ptr(), key_shift, gather.data_ptr(), val.data_ptr(),
        table.data_ptr(), table.stride(0), table.stride(1), table.shape[0],
        k, out.data_ptr(), out_row, out_col, n_out, head.data_ptr(),
        tail.data_ptr(), n_live.data_ptr(), cap,
        torch.cuda.current_stream(dev).cuda_stream, dev.index)
    if err != 0:
        msg = lib.smallk_seg_cuda_error_string(err).decode()
        raise RuntimeError(f"seg_spmm kernel launch failed: {msg} (cudaError "
                           f"{err}, capacity {cap}, k={k}, n_out={n_out}, "
                           f"key_shift={key_shift})")
    launches += 1
    return out


def _check(key, gather, val, table, out, n_live, key_shift, transposed):
    """Shapes, dtypes, devices and layouts; (k, n_out)."""
    if (key.ndim != 1 or gather.ndim != 1 or key.dtype != torch.int32
            or gather.dtype != torch.int32 or val.shape != gather.shape):
        raise ValueError(f"seg_spmm: key {tuple(key.shape)} {key.dtype}, "
                         f"gather {tuple(gather.shape)} {gather.dtype} and val "
                         f"{tuple(val.shape)} must be 1-d, int32 indices, val "
                         "as gather")
    if not 0 <= key_shift <= 20 or key.numel() << key_shift < gather.numel():
        raise ValueError(f"seg_spmm: {key.numel()} keys of 2^{key_shift} "
                         f"entries for {gather.numel()} entries")
    if table.ndim != 2 or out.ndim != 2:
        raise ValueError("seg_spmm: table and out must be 2-d")
    k = table.shape[1]
    n_out = out.shape[1] if transposed else out.shape[0]
    if (out.shape[0] if transposed else out.shape[1]) != k:
        raise ValueError(f"seg_spmm: table {tuple(table.shape)} and out "
                         f"{tuple(out.shape)} must be (B, k) and "
                         f"{'(k, n)' if transposed else '(n, k)'}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"seg_spmm: k = {k} (1 to {MAX_K})")
    if n_live.ndim != 0 or n_live.dtype != torch.int64:
        raise ValueError("seg_spmm: n_live must be a 0-d int64 tensor")
    if len({t.device for t in (key, gather, val, table, out, n_live)}) > 1:
        raise ValueError("seg_spmm: operands on different devices")
    for tname, t in (("key", key), ("gather", gather), ("val", val),
                     ("out", out)):
        if not t.is_contiguous():
            raise ValueError(f"seg_spmm: {tname} is not contiguous")
    return k, n_out


def seg_spmm_reference(key, gather, val, table, out, n_live, key_shift=0,
                       transposed=False):
    """Plain torch version: the live entries' val * table rows in out's
    dtype, summed into the zeroed `out` by index_add_ at their keys."""
    global plain_cuda_calls
    if table.is_cuda:
        plain_cuda_calls += 1
    n = min(int(n_live), gather.numel())
    B = table.shape[0]
    acc = out.dtype
    ent = torch.arange(n, device=gather.device)
    keys = key[ent >> key_shift].long()
    g = gather[:n].long()
    valid = (g >= 0) & (g < B)
    rows = table.index_select(0, torch.where(valid, g, 0)).to(acc)
    # a sentinel contributes nothing, whatever table row 0 holds
    part = val[:n].to(acc)[:, None] * rows.masked_fill_(~valid[:, None], 0)
    out.zero_()
    if transposed:
        out.index_add_(1, keys, part.T)
    else:
        out.index_add_(0, keys, part)
    return out
