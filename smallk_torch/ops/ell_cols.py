"""Column-subset operand for sparse hierclust — the port of
smallk_tpu/ops/ell_cols.py (CscChunks, GatheredColsAOp).

Hierclust factors each tree node on A's columns at the node's documents
(the reference's `SubMatrixColsCompact`, sparse_matrix_impl.hpp:479), so a
node's product cost should scale with the subset's nonzeros, not with A.
As the JAX package does, the port cuts every column into chunks of L0
nonzeros once (`CscChunks`, on the device) and gathers a node's chunks
into an operand of a fixed shape a width (`ChunkColsAOp`, the reference's
GatheredColsAOp): the width is a rung of hierclust's bucket ladder, the
buffers are allocated once a width and each node's build writes into
them, and both products run through kernels/seg_spmm with a launch shape
fixed by (width, L0).  So one captured step graph a width serves every
node of that width (engines/hierclust.KEEP_GRAPHS), as on the dense path.

The subset keeps its given order: local column i is document subset[i],
as on the dense path.

Why this operand: on an H100 80GB HBM3 (700 W) at 50,000 x 1,000,000 (73 M
nonzeros, bf16 values, f32 factors, k = 2; chip_smoke.py --cols and phase
`sparse chain`, PERF.md) the earlier operand, gathered at each node's exact
width (ELL buckets through ell_spmm, whose bucket count and sizes depend on
the data) took 0.62 + 0.61 ms (W'A + A H') at the root against this one's
0.66-0.93 + 0.99-1.04 with the kernel of that time, but it could keep no
graph: sparse hierclust ran 3.36-3.59 s with 27 graph captures, and
3.10-3.23 s on this operand with 10.  Its products' XLA formulation in
torch ops (torch.segment_reduce) took 1.6 + 63.6 ms at the root.

The chunk length L0 is the reference's rule, the median column length
rounded up to a power of two (128 on that corpus, 1.91x padding).  W'A
reads no padding since the kernel's redesign, so padding no longer sets
the choice: on the same card the root's two products took 0.856 + 0.576,
0.629 + 0.557, 0.503 + 0.546 and 0.435 + 0.542 device ms at L0 = 16, 32,
64 and 128 (a shorter chunk makes more chunks and a wider operand: the
root's width 5.48 M at 16, 1.19 M at 128), and sparse hierclust took
3.20-3.25 s at L0 = 32, 3.07-3.28 at 64 and 2.93-3.05 at 128
(chip_smoke.py --cols).
"""

from __future__ import annotations

import numpy as np
import torch

from ..common.device import setup, storage_dtype
from ..kernels.seg_spmm import carries_for, chunk_spmm, seg_spmm, sum_dtype
from .dense import Unsharded
from .ell import _to_storage


# The chunk length's clamp (chunk_length)
L0_MIN, L0_MAX = 8, 256


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def chunk_length(lens) -> int:
    """The chunk length L0 for columns of `lens` nonzeros: the median
    nonzero length rounded up to a power of two, clamped to [L0_MIN,
    L0_MAX] (the reference's rule, smallk_tpu/ops/ell_cols.py:60-62; the
    H100's sweep kept it, see the module's docstring)."""
    lens = np.asarray(lens)
    med = int(np.median(lens[lens > 0])) if (lens > 0).any() else L0_MIN
    return min(L0_MAX, max(L0_MIN, _next_pow2(med)))


class CscChunks:
    """A sparse matrix's columns cut into chunks of L0 nonzeros (the last of
    a column padded), on the device: `rows` (C+1, L0) int32 with the
    sentinel row m on pads, `vals` (C+1, L0) in the storage dtype, 0 on
    pads, `chunk_doc` (C+1,) int32, chunk C the all-pad chunk with the
    sentinel document n, and `clen` (C+1,) int32, each chunk's live entries
    (at its head; 0 for chunk C); on the host `cnt` (n,) chunks a column,
    `lens` (n,) nonzeros a column and `starts` (n+1,) the first chunk of
    each column.  `cnt_dev` is `cnt` on the device (the chain sizes its
    children by it)."""

    def __init__(self, shape, L0, rows, vals, chunk_doc, cnt, lens, starts):
        self.shape = tuple(int(s) for s in shape)
        self.L0 = int(L0)
        self.rows = rows
        self.vals = vals
        self.chunk_doc = chunk_doc
        self.cnt = cnt
        self.lens = lens
        self.starts = starts
        self.C = int(chunk_doc.shape[0]) - 1
        dev = rows.device
        self.cnt_dev = torch.from_numpy(cnt.astype(np.int64)).to(dev)
        # chunk j of column c holds min(L0, lens[c] - (j - starts[c]) L0)
        doc = chunk_doc[:self.C].long()
        first = torch.from_numpy(np.asarray(starts[:-1], np.int64)).to(dev)
        left = torch.from_numpy(np.asarray(lens, np.int64)).to(dev)[doc] - (
            torch.arange(self.C, device=dev) - first[doc]) * self.L0
        self.clen = torch.zeros(self.C + 1, dtype=torch.int32, device=dev)
        self.clen[:self.C] = left.clamp(max=self.L0)

    @classmethod
    def from_scipy(cls, A, dtype=torch.float32, L0=None, *, device="cuda"):
        """The chunk table of scipy sparse `A` on `device` (the card unless
        the caller asks for the CPU), its values rounded f64 -> f32 ->
        storage as the bucketed-ELL operand rounds them; L0 by
        `chunk_length` unless given (a power of two)."""
        dev = setup(device)
        csc = A.tocsc()
        csc.sort_indices()
        m, n = csc.shape
        lens = np.diff(csc.indptr).astype(np.int64)
        L0 = chunk_length(lens) if L0 is None else int(L0)
        if L0 & (L0 - 1):
            raise ValueError(f"CscChunks: L0 = {L0} is not a power of two")
        cnt = -(-lens // L0)  # 0 chunks for an empty column
        starts = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(cnt, out=starts[1:])
        C = int(starts[-1])
        # on the device: entry e of column j lands in chunk
        # starts[j] + e // L0, lane e % L0
        lens_d = torch.from_numpy(lens).to(dev)
        col = torch.repeat_interleave(torch.arange(n, device=dev), lens_d,
                                      output_size=csc.nnz)
        within = (torch.arange(csc.nnz, device=dev)
                  - torch.from_numpy(csc.indptr[:-1].astype(np.int64)).to(
                      dev)[col])
        pos = (torch.from_numpy(starts[:-1]).to(dev)[col] + within // L0) \
            * L0 + within % L0
        del col, within
        rows = torch.full(((C + 1) * L0,), m, dtype=torch.int32, device=dev)
        rows[pos] = torch.from_numpy(csc.indices.astype(np.int32)).to(dev)
        data = _to_storage(csc.data.astype(np.float64), storage_dtype(dtype))
        vals = torch.zeros(((C + 1) * L0,), dtype=data.dtype, device=dev)
        vals[pos] = data.to(dev)
        cnt_d = torch.from_numpy(cnt).to(dev)
        chunk_doc = torch.full((C + 1,), n, dtype=torch.int32, device=dev)
        chunk_doc[:C] = torch.repeat_interleave(
            torch.arange(n, dtype=torch.int32, device=dev), cnt_d,
            output_size=C)
        return cls((m, n), L0, rows.view(C + 1, L0), vals.view(C + 1, L0),
                   chunk_doc, cnt.astype(np.int32), lens, starts)

    @property
    def device(self):
        return self.rows.device

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def nnz(self) -> int:
        return int(self.lens.sum())

    @property
    def table_bytes(self) -> int:
        """Device bytes of the table (rows, vals, chunk_doc, clen)."""
        return sum(t.numel() * t.element_size()
                   for t in (self.rows, self.vals, self.chunk_doc, self.clen))

    @property
    def padding(self) -> float:
        """Table entries over nonzeros (1 when no chunk is padded)."""
        return self.C * self.L0 / max(1, self.nnz)

    # --- the sequential engine's plan, on the host --------------------------

    def subset_chunk_count(self, subset) -> int:
        return int(self.cnt[np.asarray(subset)].sum())

    def gather_host(self, subset, wc: int):
        """The gather plan of a document subset padded to wc chunks and wc
        document slots, as numpy int32 arrays (idx_docs, idx_chunks, slot):
        slot i is document subset[i] (the subset's order, as on the dense
        path), chunk c of the plan belongs to slot slot[c]; pads are the
        sentinel document n, the all-pad chunk C and slot wc."""
        subset = np.asarray(subset, dtype=np.int64)
        if len(subset) > wc:
            raise ValueError("gather_host: wc too small for subset docs")
        idx_docs = np.full(wc, self.shape[1], dtype=np.int32)
        idx_docs[: len(subset)] = subset
        reps = self.cnt[subset]
        total = int(reps.sum())
        if total > wc:
            raise ValueError("gather_host: wc too small for subset")
        idx_chunks = np.full(wc, self.C, dtype=np.int32)
        slot = np.full(wc, wc, dtype=np.int32)
        base = np.repeat(self.starts[subset], reps)
        offs = np.arange(total, dtype=np.int64) - np.repeat(
            np.concatenate([[0], np.cumsum(reps)[:-1]]), reps)
        idx_chunks[:total] = (base + offs).astype(np.int32)
        slot[:total] = np.repeat(np.arange(len(subset), dtype=np.int32),
                                 reps)
        return idx_docs, idx_chunks, slot

    # --- the chain's plan, on the device -------------------------------------

    def gather_device(self, mask, wc: int):
        """The gather plan of the documents in `mask` ((n,) bool on the
        device), ascending, padded to wc, as int32 tensors on the device:
        the arrays `gather_host` gives for the same ascending subset.  Two
        host syncs (the counts of documents and chunks)."""
        n = self.shape[1]
        maskc = torch.cat([mask, mask.new_zeros(1)])[self.chunk_doc.long()]
        idx_docs = _padded_nonzero(mask, wc, n)
        idx_chunks = _padded_nonzero(maskc, wc, self.C)
        cdocs = self.chunk_doc[idx_chunks.long()]
        slot = torch.searchsorted(idx_docs, cdocs).to(torch.int32)
        slot = torch.where(cdocs >= n, wc, slot)
        return idx_docs, idx_chunks, slot


def _padded_nonzero(mask, size: int, fill: int):
    """The ascending positions of `mask`'s True entries, int32, padded to
    `size` with `fill` (a host sync: the count)."""
    pos = torch.nonzero(mask).squeeze(1).to(torch.int32)
    if pos.numel() > size:
        raise ValueError(f"gather_device: {pos.numel()} entries for a plan "
                         f"of {size}")
    out = torch.full((size,), fill, dtype=torch.int32, device=mask.device)
    out[: pos.numel()] = pos
    return out


class ChunkColsAOp(Unsharded):
    """A column subset of a `CscChunks` table at a fixed width wc: its
    (m, wc) operand, column i the sum of the chunks of slot i, pad columns
    exactly zero (the dense path's zero-pad contract).  The buffers are
    allocated once a width and each node's `load` writes into them in
    place (the dense path's `gather_columns(..., out=)`), so a step graph
    captured on one node's operand replays for every node of the width:

      - W'A, by slot: the plan's chunks in chunk order, `rows` and `vals`
        (wc * L0), `lens` (wc) the live entries of each (0 on pads) and
        `starts` (wc + 1) each slot's first chunk (the plan's slots
        ascend), each entry gathering a row of W, written (k, wc);
      - A H', by term: the same live entries sorted by term once a node
        (outside the graph, as the reference hoists its row sort,
        smallk_tpu/ops/ell_cols.py:187-197), `t_gather` the entry's slot
        and `t_vals`, and `t_ptr` (m + 1) each term's first entry, each
        entry gathering a row of H^T from a contiguous (wc, k) copy made
        each product: one 8-byte row an entry at k = 2 in f32, where H's
        transposed view costs k loads wc x 4 bytes apart (PERF.md).

    The live counts stay on the device (starts[wc], the plan's chunks;
    t_ptr[m], the subset's nonzeros).  Both products run through
    kernels/seg_spmm (the CUDA kernel on the card, its plain version on the
    CPU) with launch shapes fixed by (wc, L0); `carries` is A H''s scratch
    on the card, allocated once."""

    def __init__(self, chunks: CscChunks, wc: int):
        self.chunks = chunks
        self.m = chunks.shape[0]
        self.wc = int(wc)
        L0, dev, dt = chunks.L0, chunks.device, chunks.dtype
        cap = self.wc * L0
        self.shift = L0.bit_length() - 1
        i32 = dict(dtype=torch.int32, device=dev)
        self.rows = torch.empty(cap, **i32)
        self.vals = torch.empty(cap, dtype=dt, device=dev)
        self.lens = torch.zeros(self.wc, **i32)
        self.starts = torch.zeros(self.wc + 1, **i32)
        self.t_gather = torch.empty(cap, **i32)
        self.t_vals = torch.empty(cap, dtype=dt, device=dev)
        self.t_ptr = torch.zeros(self.m + 1, **i32)
        self.carries = carries_for(sum_dtype(dt), dev)

    @property
    def shape(self):
        return (self.m, self.wc)

    @property
    def dtype(self):
        return self.chunks.dtype

    @property
    def device(self):
        return self.chunks.device

    def load(self, idx_chunks, slot):
        """Write the node of plan (idx_chunks, slot) (`CscChunks.gather_host`
        or `gather_device`, wc long) into the buffers; returns self.  One
        host sync (the plan's chunk count)."""
        ch, dev = self.chunks, self.device
        idx_chunks = torch.as_tensor(idx_chunks, device=dev)
        slot = torch.as_tensor(slot, device=dev)
        total = int((idx_chunks < ch.C).sum())
        n = total * ch.L0
        live = idx_chunks[:total].long()
        rows = self.rows[:n].view(total, ch.L0)
        torch.index_select(ch.rows, 0, live, out=rows)
        torch.index_select(ch.vals, 0, live, out=self.vals[:n].view(
            total, ch.L0))
        torch.index_select(ch.clen, 0, idx_chunks.long(), out=self.lens)
        slots = torch.arange(self.wc + 1, dtype=torch.int32, device=dev)
        torch.searchsorted(slot[:total].to(torch.int32).contiguous(), slots,
                           out_int32=True, out=self.starts)
        # the pads' sentinel term m sorts last, past t_ptr[m]
        order = torch.argsort(self.rows[:n], stable=True)
        t_key = self.rows[:n][order]
        torch.index_select(self.vals[:n], 0, order, out=self.t_vals[:n])
        torch.index_select(slot[:total].to(torch.int32), 0,
                           order >> self.shift, out=self.t_gather[:n])
        terms = torch.arange(self.m + 1, dtype=torch.int32, device=dev)
        torch.searchsorted(t_key, terms, out_int32=True, out=self.t_ptr)
        return self

    def mm_tn(self, W):
        """W^T A_sub -> (k, wc) in W's dtype."""
        out = torch.empty((W.shape[1], self.wc), dtype=sum_dtype(W.dtype),
                          device=W.device)
        chunk_spmm(self.starts, self.lens, self.rows, self.vals, W, out,
                   transposed=True)
        return out.to(W.dtype)

    def mm_nt(self, H):
        """A_sub H^T -> (m, k) in H's dtype."""
        out = torch.empty((self.m, H.shape[0]), dtype=sum_dtype(H.dtype),
                          device=H.device)
        seg_spmm(self.t_ptr, self.t_gather, self.t_vals, H.T.contiguous(),
                 out, carries=self.carries)
        return out.to(H.dtype)

    # seg_spmm's launch shape is fixed at k = 2 here: lanes take one
    # product each
    def mm_tn_lanes(self, W):
        """W (R, m, 2) -> (R, 2, wc), a product a lane."""
        return torch.stack([self.mm_tn(w) for w in W])

    def mm_nt_lanes(self, H):
        """H (R, 2, wc) -> (R, m, 2), a product a lane."""
        return torch.stack([self.mm_nt(h) for h in H])

    def col_sums(self):
        """Column sums in the storage dtype, summed in the accumulator."""
        ones = torch.ones((self.m, 1), dtype=sum_dtype(self.dtype),
                          device=self.device)
        return self.mm_tn(ones)[0].to(self.dtype)
