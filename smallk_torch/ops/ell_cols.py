"""Column-subset operand for sparse hierclust — the port of
smallk_tpu/ops/ell_cols.py (CscChunks, GatheredColsAOp).

Hierclust factors each tree node on A's columns at the node's documents
(the reference's `SubMatrixColsCompact`, sparse_matrix_impl.hpp:479), so a
node's product cost should scale with the subset's nonzeros, not with A.
The JAX package cuts every column into fixed-length chunks and buckets the
chunk counts, so that XLA compiles few programs.  The port has no such
constraint and gathers each node at its exact width:

  - `CscColumns` holds the corpus's CSC arrays on the device, copied there
    once; no node builds anything on the host.
  - `CscColumns.gathered(idx)` builds, on the device, the node's operand
    `GatheredColsAOp`: the subset's columns as ELL buckets (W'A) and, after
    one stable sort of the subset's nonzeros by term, its rows as ELL
    buckets (A H').  A bucket holds the slices whose length rounds up to
    one power of two (8 to _MAX_LEN), padded with the one-past-the-end
    sentinel; a longer slice is cut into pieces of _MAX_LEN, summed in two
    launches; a slice with no nonzeros is in no bucket.
  - Both products run through the ELL gather-SpMM (kernels/ell_spmm.py),
    the hand-written CUDA kernel on the card and its plain version on the
    CPU, into a zeroed output.

The subset keeps its given order: local column i is document idx[i], as
on the dense path.

Why ELL buckets through ell_spmm and not the reference's formulation in
torch ops (a gather of factor rows, then a sorted segment sum,
`torch.segment_reduce`): the rule is the formulation whose two k = 2
products together take less time at the root and at a node of 1/8 of the
documents.  On an H100 80GB HBM3 (700 W) at 50,000 x 1,000,000 (73 M
nonzeros, bf16 values, f32 factors; chip_smoke.py --cols, PERF.md): ELL
0.65 + 0.57 ms at the root and 0.12 + 0.24 at 1/8 (W'A + AH'), torch ops
1.65 + 63.4 and 0.32 + 8.07 (its AH' walks each term's segment in one
thread).
"""

from __future__ import annotations

import numpy as np
import torch

from ..common.device import setup, torch_dtype
from ..kernels.ell_spmm import Buckets, ell_spmm, ell_spmm_buckets
from .ell import _to_storage

_MIN_LEN = 8  # shortest bucket length, as the bucketed-ELL operand's
# Longest bucket length.  A slice longer than this (a term in most of a
# node's documents) is cut into pieces of this length, summed into a
# table of partial rows by one launch and the pieces then into the
# slice's row by a second.  ell_spmm shares a long row among at most 32
# warps, so uncut, the corpus's most frequent term (in ~92% of the
# documents, ~900 k entries) still walks chains of ~900 entries a lane:
# AH' at 50,000 x 1,000,000 on an H100 took 1.20 ms uncut against 0.57
# cut, and at a 1/8 node 0.230 against 0.235 (chip_smoke.py --cols;
# PERF.md).
_MAX_LEN = 1024


def _acc_dtype(dtype):
    """The sums' dtype: f64 for f64 storage, else f32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _fill(starts, lens, L, minor, vals, sentinel):
    """(idx int32 (g, L), vals (g, L)): row r holds entries starts[r] ..
    starts[r] + lens[r] - 1 of `minor` and `vals`, then the sentinel and
    zeros."""
    lane = torch.arange(L, device=lens.device)
    valid = lane[None, :] < lens[:, None]
    pos = torch.where(valid, starts[:, None] + lane[None, :], 0)
    return (torch.where(valid, minor[pos], sentinel).to(torch.int32),
            torch.where(valid, vals[pos], 0).contiguous())


def _ell_family(lens, starts, minor, vals, sentinel):
    """One family of ELL buckets over the slices with nonzeros: slice s
    holds entries starts[s] .. starts[s] + lens[s] - 1 of `minor` (their
    minor ids) and `vals`.  Returns (buckets, split):

      - buckets: (ids int32 (g,), idx int32 (g, L), vals (g, L)), one per
        power-of-two length L in [_MIN_LEN, _MAX_LEN]: the slices up to
        _MAX_LEN long, padded with `sentinel`;
      - split, for the longer slices, or None: (idx, vals) of their pieces
        (_MAX_LEN entries each, the last padded), and (ids, refs, ones):
        slice ids[i]'s pieces are rows refs[i, :] of the pieces' partial
        sums (sentinel: the piece count), each with weight 1.

    A few host syncs (the set of lengths, the piece count)."""
    segs = torch.nonzero(lens)[:, 0]
    seg_lens = lens[segs]
    short = seg_lens <= _MAX_LEN
    buckets = []
    if bool(short.any()):
        ids, n = segs[short], seg_lens[short]
        padded = torch.exp2(torch.ceil(torch.log2(
            torch.clamp(n, min=_MIN_LEN).double()))).long()
        for L in torch.unique(padded).tolist():
            pick = padded == L
            buckets.append((ids[pick].to(torch.int32),
                            *_fill(starts[ids[pick]], n[pick], L, minor,
                                   vals, sentinel)))
    if bool(short.all()):
        return buckets, None
    ids, n = segs[~short], seg_lens[~short]
    pieces = (n + _MAX_LEN - 1) // _MAX_LEN
    total = int(pieces.sum())
    first = torch.cumsum(pieces, 0) - pieces
    owner = torch.repeat_interleave(
        torch.arange(len(ids), device=lens.device), pieces,
        output_size=total)
    offset = (torch.arange(total, device=lens.device) - first[owner]) \
        * _MAX_LEN
    p_idx, p_vals = _fill(starts[ids][owner] + offset,
                          torch.clamp(n[owner] - offset, max=_MAX_LEN),
                          _MAX_LEN, minor, vals, sentinel)
    lane = torch.arange(int(pieces.max()), device=lens.device)
    valid = lane[None, :] < pieces[:, None]
    refs = torch.where(valid, first[:, None] + lane[None, :],
                       total).to(torch.int32)
    ones = valid.to(_acc_dtype(vals.dtype))
    return buckets, (p_idx, p_vals, ids.to(torch.int32), refs, ones)


class CscColumns:
    """A sparse matrix's CSC arrays on the device: indptr (n+1,) int64,
    indices (nnz,) int32 row ids, data (nnz,) in the storage dtype."""

    def __init__(self, shape, indptr, indices, data):
        self.shape = tuple(int(s) for s in shape)
        self.indptr = indptr
        self.indices = indices
        self.data = data

    @classmethod
    def from_scipy(cls, A, dtype=torch.float32, *, device="cuda"):
        """Copy scipy sparse `A` to `device` (the card unless the caller
        asks for the CPU), its values rounded f64 -> f32 -> storage as the
        bucketed-ELL operand rounds them."""
        dev = setup(device)
        csc = A.tocsc()
        csc.sort_indices()
        return cls(
            csc.shape,
            torch.from_numpy(csc.indptr.astype(np.int64)).to(dev),
            torch.from_numpy(csc.indices.astype(np.int32)).to(dev),
            _to_storage(csc.data.astype(np.float64),
                        torch_dtype(dtype)).to(dev))

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def device(self):
        return self.data.device

    def entries(self, idx):
        """The columns `idx`'s nonzeros on the device: (lens, starts) of
        each column in the CSC arrays, `pos` the entries' positions there
        in column order, `local` their local column, `terms` their row,
        `order` the stable sort of them by term (within a term they stay in
        local-column order) and `row_lens` the entries per term."""
        starts = self.indptr[idx]
        lens = self.indptr[idx + 1] - starts
        nnz = int(torch.sum(lens))
        local = torch.repeat_interleave(
            torch.arange(len(idx), device=idx.device), lens, output_size=nnz)
        first = torch.cumsum(lens, 0) - lens
        pos = (torch.repeat_interleave(starts - first, lens, output_size=nnz)
               + torch.arange(nnz, device=idx.device))
        terms = self.indices[pos].long()
        return {"lens": lens, "starts": starts, "pos": pos, "local": local,
                "terms": terms, "order": torch.argsort(terms, stable=True),
                "row_lens": torch.bincount(terms, minlength=self.shape[0])}

    def gathered(self, idx) -> GatheredColsAOp:
        """A[:, idx] at its exact width, built on the device."""
        m = self.shape[0]
        e = self.entries(idx)
        cols = _ell_family(e["lens"], e["starts"], self.indices, self.data, m)
        row_starts = torch.cumsum(e["row_lens"], 0) - e["row_lens"]
        rows = _ell_family(e["row_lens"], row_starts, e["local"][e["order"]],
                           self.data[e["pos"]][e["order"]], len(idx))
        return GatheredColsAOp((m, len(idx)), cols, rows,
                               int(e["pos"].numel()), self.data.dtype,
                               self.device)


class GatheredColsAOp:
    """A column subset as two families of ELL buckets on the device
    (`_ell_family`): by local column (`cols`, W'A written (k, w) by the
    kernel's transposed mode) and by term (`rows`, A H')."""

    def __init__(self, shape, cols, rows, nnz, dtype, device):
        self._shape = tuple(int(s) for s in shape)
        self.cols = cols
        self.rows = rows
        # each family's buckets recorded for the kernel once: one host
        # call launches them all
        self._packs = {"cols": Buckets(cols[0]), "rows": Buckets(rows[0])}
        self.nnz = int(nnz)
        self._dtype = dtype
        self.device = device

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return self._dtype

    @property
    def padded_nnz(self):
        """Padded entries a product gathers (the larger family's)."""
        def entries(family):
            buckets, split = family
            n = sum(int(idx.numel()) for _, idx, _ in buckets)
            return n + (int(split[0].numel()) if split is not None else 0)

        return max(entries(self.cols), entries(self.rows))

    def _product(self, family, table, out_shape, transposed):
        split = getattr(self, family)[1]
        acc = _acc_dtype(self._dtype)
        out = torch.zeros(out_shape, dtype=acc, device=table.device)
        ell_spmm_buckets(self._packs[family], table, out,
                         transposed=transposed)
        if split is not None:
            p_idx, p_vals, ids, refs, ones = split
            part = torch.empty((p_idx.shape[0], table.shape[1]), dtype=acc,
                               device=table.device)
            ell_spmm(p_idx, p_vals, table, part)
            ell_spmm(refs, ones, part, out, rows=ids, transposed=transposed)
        return out

    def mm_tn(self, W):
        """W^T A_sub -> (k, w) in W's dtype."""
        out = self._product("cols", W.contiguous(),
                            (W.shape[1], self._shape[1]), True)
        return out.to(W.dtype)

    def mm_nt(self, H):
        """A_sub H^T -> (m, k) in H's dtype (H transposed once a product:
        the kernel gathers whole rows of its table)."""
        out = self._product("rows", H.T.contiguous(),
                            (self._shape[0], H.shape[0]), False)
        return out.to(H.dtype)

    def col_sums(self):
        """Column sums in the storage dtype, summed in the accumulator."""
        ones = torch.ones((self._shape[0], 1), dtype=_acc_dtype(self._dtype),
                          device=self.device)
        return self.mm_tn(ones)[0].to(self._dtype)
