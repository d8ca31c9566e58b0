"""The gather-SpMMs of the static-shape sparse node operand: the CUDA
kernel's wrappers and their plain versions.

The products of ops/ell_cols.ChunkColsAOp, which the JAX package computes
in XLA (smallk_tpu/ops/ell_cols.py:217-262: a gather of factor rows, then
a sorted segment sum).  Two passes of one kernel (csrc/seg_spmm.cu):

  - `chunk_spmm` (W'A), by document slot: slot s sums the live entries of
    chunks [starts[s], starts[s+1]), chunk c holding `lens[c]` live
    entries at the head of its L0 = rows.numel() / lens.numel() places;
  - `seg_spmm` (A H'), by term: term r sums entries [ptr[r], ptr[r+1]) of
    the term-sorted stream (ptr[0] = 0, ascending), with no per-entry key.

Each writes every key of its output, `val[e] * table[gather[e], :]` summed
over the key's entries and 0 for a key with none; a gather index >= B (the
table's rows) is the padding sentinel and contributes nothing.  The live
counts (starts[-1], ptr[-1]) stay on the operands' device: on the card the
kernel reads them there, so a launch's shape depends on the capacities
alone and one captured CUDA graph serves every node of a width.
`transposed` writes out as (k, n_out).

On CUDA tensors both launch the hand-written Hopper kernel, for (val,
table) in (f32, f32), (bf16, f32), (e4m3, f32) with an f32 out and (f64,
f64) with an f64 out, k <= 8; anything else raises.  On CPU tensors they
take their plain torch versions (index_add_ in the sum's dtype), and only
there.
"""

from __future__ import annotations

import torch

from . import _build

SOURCE = "smallk_torch/csrc/seg_spmm.cu"
# no TPU kernel: the XLA formulation of the gathered node operand's products
REPLACES = "smallk_tpu/ops/ell_cols.py:172"
MAX_K = 8
ALIGN = 16     # bytes: the kernel reads the entry streams 16 bytes at a time

# wrapper calls that launched the kernel (a pass's launches) since the last
# reset; the only place it grows is the launches below
launches = 0
# plain-version calls on CUDA tensors since the last reset: the main path
# makes none (chip_smoke.py holds it to that)
plain_cuda_calls = 0

f32, bf16, f64 = torch.float32, torch.bfloat16, torch.float64
f8 = torch.float8_e4m3fn
# (val dtype, table dtype) -> (entry points' suffix, sum dtype)
_KERNELS = {
    (f32, f32): ("f32_f32", f32),
    (bf16, f32): ("bf16_f32", f32),
    (f8, f32): ("f8_f32", f32),
    (f64, f64): ("f64_f64", f64),
}


def sum_dtype(table_dtype):
    """The dtype of the sums and of out: f64 for an f64 table, else f32."""
    return f64 if table_dtype == f64 else f32


def carries_for(dtype, device):
    """The scratch `seg_spmm` keeps its cross-block partials in, for sums of
    `dtype` on `device` (a CUDA device): enough for any capacity and k, so
    an operand allocates it once.  None on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    lib = _build.load_library("seg_spmm")
    grid = lib.smallk_seg_max_grid(torch.cuda.current_device()
                                   if device.index is None else device.index)
    return torch.empty(2 * grid * MAX_K, dtype=dtype, device=device)


def chunk_spmm(starts, lens, rows, vals, table, out, transposed=False):
    """W'A by slot into `out`, (n_slots, k) or with `transposed` (k,
    n_slots), which it overwrites; returns `out`.

    CUDA tensors: the kernel, or an exception.  CPU tensors: the plain
    version."""
    global launches
    k, n_out, shift = _check_chunks(starts, lens, rows, vals, table, out,
                                    transposed)
    dev = table.device
    if dev.type == "cpu":
        return chunk_spmm_reference(starts, lens, rows, vals, table, out,
                                    transposed)
    suffix, lib, pairs = _kernel(vals, table, out, (rows, vals), dev)
    out_row, out_col = (1, n_out) if transposed else (k, 1)
    err = getattr(lib, f"smallk_seg_chunks_{suffix}")(
        starts.data_ptr(), lens.data_ptr(), rows.data_ptr(), vals.data_ptr(),
        shift, table.data_ptr(), table.stride(0), table.stride(1),
        table.shape[0], k, pairs, out.data_ptr(), out_row, out_col, n_out,
        torch.cuda.current_stream(dev).cuda_stream, dev.index)
    _raise(lib, err, "chunk pass", rows.numel(), k, n_out)
    launches += 1
    return out


def seg_spmm(ptr, gather, val, table, out, transposed=False, carries=None):
    """A H' by term into `out`, (n_out, k) or with `transposed` (k, n_out),
    which it overwrites; returns `out`.  `carries` (`carries_for`) is the
    kernel's scratch, allocated here when not given.

    CUDA tensors: the kernel, or an exception.  CPU tensors: the plain
    version."""
    global launches
    k, n_out = _check_terms(ptr, gather, val, table, out, transposed)
    dev = table.device
    if dev.type == "cpu":
        return seg_spmm_reference(ptr, gather, val, table, out, transposed)
    suffix, lib, pairs = _kernel(val, table, out, (gather, val), dev)
    acc = out.dtype
    if carries is None:
        carries = carries_for(acc, dev)
    if (carries.dtype != acc or carries.device != dev
            or not carries.is_contiguous()):
        raise ValueError(f"seg_spmm: carries {carries.dtype} on "
                         f"{carries.device} (want contiguous {acc} on {dev})")
    out_row, out_col = (1, n_out) if transposed else (k, 1)
    err = getattr(lib, f"smallk_seg_terms_{suffix}")(
        ptr.data_ptr(), gather.data_ptr(), val.data_ptr(), table.data_ptr(),
        table.stride(0), table.stride(1), table.shape[0], k, pairs,
        out.data_ptr(), out_row, out_col, n_out, carries.data_ptr(),
        carries.numel(), gather.numel(),
        torch.cuda.current_stream(dev).cuda_stream, dev.index)
    _raise(lib, err, "term pass", gather.numel(), k, n_out)
    launches += 1
    return out


def _kernel(val, table, out, streams, dev):
    """The entry points' suffix, the library and whether a table row is
    read as pairs, after the checks only the kernel needs."""
    if dev.type != "cuda":
        raise ValueError(f"seg_spmm: unsupported device {dev}")
    try:
        suffix, acc = _KERNELS[val.dtype, table.dtype]
    except KeyError:
        raise ValueError(f"seg_spmm: val {val.dtype} with table "
                         f"{table.dtype} (the kernel takes "
                         f"{sorted((str(v)[6:], str(t)[6:]) for v, t in _KERNELS)})"
                         ) from None
    if out.dtype != acc:
        raise ValueError(f"seg_spmm: out dtype {out.dtype} (the kernel sums "
                         f"this pair into {acc})")
    for t in streams:
        if t.data_ptr() % ALIGN:
            raise ValueError(f"seg_spmm: an entry stream at {t.data_ptr():#x}"
                             f" is not {ALIGN}-byte aligned")
    k = table.shape[1]
    pairs = int(k % 2 == 0 and table.stride(1) == 1
                and table.stride(0) % 2 == 0
                and table.data_ptr() % (2 * table.element_size()) == 0)
    return suffix, _build.load_library("seg_spmm"), pairs


def _raise(lib, err, what, cap, k, n_out):
    if err != 0:
        msg = lib.smallk_seg_cuda_error_string(err).decode()
        raise RuntimeError(f"seg_spmm {what} launch failed: {msg} (cudaError "
                           f"{err}, capacity {cap}, k={k}, n_out={n_out})")


def _check_out(table, out, transposed):
    """(k, n_out) of a (B, k) table and its out."""
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
    if not out.is_contiguous():
        raise ValueError("seg_spmm: out is not contiguous")
    return k, n_out


def _check_index(name, t, n=None):
    if t.ndim != 1 or t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(f"seg_spmm: {name} {tuple(t.shape)} {t.dtype} must "
                         "be a contiguous 1-d int32 tensor")
    if n is not None and t.numel() != n:
        raise ValueError(f"seg_spmm: {name} has {t.numel()} entries, not {n}")


def _check_terms(ptr, gather, val, table, out, transposed):
    """Shapes, dtypes, devices and layouts of `seg_spmm`; (k, n_out)."""
    k, n_out = _check_out(table, out, transposed)
    _check_index("ptr", ptr, n_out + 1)
    _check_index("gather", gather)
    if val.shape != gather.shape or not val.is_contiguous():
        raise ValueError(f"seg_spmm: val {tuple(val.shape)} must be "
                         f"contiguous, as gather {tuple(gather.shape)}")
    if len({t.device for t in (ptr, gather, val, table, out)}) > 1:
        raise ValueError("seg_spmm: operands on different devices")
    return k, n_out


def _check_chunks(starts, lens, rows, vals, table, out, transposed):
    """Shapes, dtypes, devices and layouts of `chunk_spmm`; (k, n_slots,
    log2 L0)."""
    k, n_out = _check_out(table, out, transposed)
    _check_index("starts", starts, n_out + 1)
    _check_index("lens", lens)
    _check_index("rows", rows)
    if vals.shape != rows.shape or not vals.is_contiguous():
        raise ValueError(f"seg_spmm: vals {tuple(vals.shape)} must be "
                         f"contiguous, as rows {tuple(rows.shape)}")
    L0 = rows.numel() // max(lens.numel(), 1)
    if (L0 * lens.numel() != rows.numel() or L0 < 4 or L0 & (L0 - 1)
            or L0 > 1 << 20):
        raise ValueError(f"seg_spmm: {rows.numel()} entries in "
                         f"{lens.numel()} chunks (L0 a power of two, 4 to "
                         "2^20)")
    if len({t.device for t in (starts, lens, rows, vals, table, out)}) > 1:
        raise ValueError("seg_spmm: operands on different devices")
    return k, n_out, L0.bit_length() - 1


def _count_plain(table):
    global plain_cuda_calls
    if table.is_cuda:
        plain_cuda_calls += 1


def _sum_into(out, keys, ent, gather, val, table, transposed):
    """out = the sum of val[ent] * table[gather[ent]] by `keys`, in out's
    dtype, a sentinel gather index contributing nothing."""
    B, acc = table.shape[0], out.dtype
    g = gather[ent].long()
    valid = (g >= 0) & (g < B)
    rows = table.index_select(0, torch.where(valid, g, 0)).to(acc)
    # a sentinel contributes nothing, whatever table row 0 holds
    part = val[ent].to(acc)[:, None] * rows.masked_fill_(~valid[:, None], 0)
    out.zero_()
    if transposed:
        out.index_add_(1, keys, part.T)
    else:
        out.index_add_(0, keys, part)
    return out


def seg_spmm_reference(ptr, gather, val, table, out, transposed=False,
                       carries=None):
    """Plain torch version of `seg_spmm`: term r's entries [ptr[r],
    ptr[r+1]) summed into the zeroed `out` by index_add_ (`carries`, the
    kernel's scratch, unused)."""
    _count_plain(table)
    n_out = ptr.numel() - 1
    counts = (ptr[1:] - ptr[:-1]).long()
    n = int(ptr[-1])
    if int(ptr[0]) != 0 or bool((counts < 0).any()) or n > gather.numel():
        raise ValueError("seg_spmm: ptr must rise from 0 to at most the "
                         "entries")
    keys = torch.repeat_interleave(torch.arange(n_out, device=ptr.device),
                                   counts, output_size=n)
    ent = torch.arange(n, device=ptr.device)
    return _sum_into(out, keys, ent, gather, val, table, transposed)


def chunk_spmm_reference(starts, lens, rows, vals, table, out,
                         transposed=False):
    """Plain torch version of `chunk_spmm`: each slot's chunks' first
    lens[c] entries summed into the zeroed `out` by index_add_."""
    _count_plain(table)
    n_out, dev = starts.numel() - 1, starts.device
    L0 = rows.numel() // lens.numel()
    chunks = (starts[1:] - starts[:-1]).long()
    if bool((chunks < 0).any()) or int(starts[-1]) > lens.numel():
        raise ValueError("seg_spmm: starts must rise to at most the chunks")
    c_slot = torch.repeat_interleave(torch.arange(n_out, device=dev), chunks,
                                     output_size=int(chunks.sum()))
    c_idx = int(starts[0]) + torch.arange(c_slot.numel(), device=dev)
    live = lens[c_idx].long().clamp(0, L0)
    ent = torch.repeat_interleave(c_idx * L0, live) + (
        torch.arange(int(live.sum()), device=dev)
        - torch.repeat_interleave(torch.cumsum(live, 0) - live, live))
    keys = torch.repeat_interleave(c_slot, live)
    return _sum_into(out, keys, ent, rows, vals, table, transposed)
