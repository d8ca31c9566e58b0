"""Bucketed-ELL sparse operand — port of smallk_tpu/ops/ell.py.

For matrices too large to densify.  The nonzeros are held twice, grouped
by columns (for W^T A) and by rows (for A H^T): the slices of each axis
are put into buckets by padded nonzero length (a pow-2 ladder, refined in
quarter steps inside populous classes), and each bucket is a rectangle
idx (g, L), vals (g, L) padded with a one-past-the-end sentinel.  Each
product is, bucket by bucket,

    out[ids[r], :] = sum_l vals[r, l] * table[idx[r, l], :]

which is the hand-written CUDA gather-SpMM (kernels/ell_spmm.py) on the
card and its plain torch version on the CPU, all of a family's (or a
minor block's) buckets from one host call.  The kernel writes each
bucket row straight to its major id and skips the sentinel, so neither
the reference's appended zero table row nor its stacked outputs and
inverse-permutation take are needed; `col_inv`/`row_inv` are kept on the
host as the layout record.  W'A is written in its (k, n) layout directly
(the kernel's transposed mode), so no strided copy follows it.

The host code that forms the buckets (`_target_lengths`,
`_build_buckets`) is the reference's numpy code, copied, with one
repair: a refined target never falls below `min_len`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..common.device import setup, torch_dtype
from ..kernels.ell_spmm import Buckets, ell_spmm_buckets

# Quarter-step refinement of the pow-2 bucket ladder: a pow-2 class with
# at least this many slices is split into sub-lengths {5/8, 3/4, 7/8, 1}
# of its pow-2 length, cutting the padded entries every product gathers.
# The population gate keeps small workloads on the coarse ladder (more
# buckets = more launches); L >= 64 keeps sub-lengths multiples of 8.
# The reference's v5e constant, kept until an H100 measurement moves it.
_FINE_SPLIT_MIN = 4096


def _target_lengths(lengths, min_len):
    """Padded bucket length per slice: pow-2, quarter-step-refined inside
    populous classes (see _FINE_SPLIT_MIN), never below `min_len`."""
    classes = np.maximum(
        np.ceil(np.log2(np.maximum(lengths, 1))).astype(np.int64),
        int(np.log2(min_len)),
    )
    targets = (1 << classes).astype(np.int64)
    uniq, counts = np.unique(classes, return_counts=True)
    for cls, cnt in zip(uniq, counts):
        L = 1 << int(cls)
        if cnt < _FINE_SPLIT_MIN or L < 64:
            continue
        sel = classes == cls
        # len in (L/2, L] -> smallest of {5L/8, 6L/8, 7L/8, L} >= len; a
        # class raised to min_len also holds shorter slices, which the
        # clamp keeps at min_len
        step = L // 8
        targets[sel] = np.maximum(np.minimum(
            (-(-lengths[sel] // step)) * step, L
        ), min_len).astype(np.int64)
    return targets


def _build_buckets(indptr, indices, data, minor_dim, min_len=8,
                   pad_multiple=1):
    """Group the major-axis slices of a CS{C,R} structure by padded
    length (pow-2 ladder, quarter-step-refined for populous classes —
    _target_lengths).

    Returns (inv, bucket_list) where bucket_list entries are
    (ids, idx, vals): ids (g,) major indices, idx (g_pad, L) minor indices
    padded with `minor_dim` (one-past-the-end sentinel), vals (g_pad, L)
    f64.  inv[j] is slice j's position in the buckets' concatenation.

    `pad_multiple`: pad each bucket's major (g) axis to this multiple with
    all-sentinel rows (they contribute zeros and no output row).
    """
    indptr = np.asarray(indptr, dtype=np.int64)
    lengths = np.diff(indptr)
    n_major = len(lengths)

    targets = _target_lengths(lengths, min_len)
    out = []
    inv = np.empty(n_major, dtype=np.int32)
    offset = 0
    for L in np.unique(targets):
        L = int(L)
        ids = np.where(targets == L)[0].astype(np.int32)
        g = len(ids)
        g_pad = -(-g // pad_multiple) * pad_multiple
        lens = lengths[ids]
        total = int(lens.sum())
        # flat gather indices into the CSC arrays for all bucket entries
        within = np.arange(total) - np.repeat(
            np.concatenate([[0], np.cumsum(lens)[:-1]]), lens
        )
        flat_src = np.repeat(indptr[ids], lens) + within
        rows_in_bucket = np.repeat(np.arange(g), lens)
        idx = np.full((g_pad, L), minor_dim, dtype=np.int32)
        vals = np.zeros((g_pad, L), dtype=np.float64)
        idx[rows_in_bucket, within] = indices[flat_src]
        vals[rows_in_bucket, within] = data[flat_src]
        out.append((ids, idx, vals))
        # stacked-product position of each real slice in this bucket
        inv[ids] = offset + np.arange(g, dtype=np.int32)
        offset += g_pad
    return inv, out


# Minor-dim entries per bucket block for very large matrices: each block's
# launches gather only from that block's slice of the factor table, which
# keeps the gather near the H100's 50 MB L2.  Chosen on an H100 80GB HBM3
# (700 W) at the flagship 50k x 1M, k = 128 shape, bf16 A, f32 H
# (chip_smoke.py --sparse; PERF.md): AH' took 10.16 ms monolithic (a 512 MB table), 7.09 ms at
# 32768, 7.06 ms at 65536 and 6.59 ms at 131072 (a 67 MB slice; fewer
# launches and accumulate passes).  "auto" blocks an axis with at least
# twice this many entries.
_DOC_BLOCK = 131072


def _to_storage(vals, dtype):
    """Host f64 values -> a tensor in the storage dtype, rounded as the
    reference's cast rounds them: f64 -> f32 -> bf16, each to nearest."""
    if dtype == torch.float64:
        return torch.from_numpy(vals)
    return torch.from_numpy(vals.astype(np.float32)).to(dtype)


def _packs(buckets, blocks, block_size):
    """A family's buckets recorded for the kernel (kernels/ell_spmm.Buckets)
    with the table rows they gather from: [(0, None, all of them)], or one
    (lo, hi, its buckets) a minor block."""
    if blocks is None:
        return [(0, None, Buckets(buckets))]
    return [(b * block_size, (b + 1) * block_size, Buckets(bkts))
            for b, (_inv, bkts) in enumerate(blocks)]


class EllAOp:
    """Sparse operand in dual bucketed-ELL form (by columns and by rows).

    A family is monolithic (`col_buckets`, `col_inv`) or, past 2x
    `_DOC_BLOCK` entries of its minor axis, built per minor block
    (`col_blocks`: a list of (inv, buckets) over term ranges for W'A;
    `row_blocks` over doc ranges for AH').  Buckets are (ids, idx, vals)
    tensors on the device; inv arrays are host numpy."""

    def __init__(self, shape, col_inv, col_buckets, row_inv, row_buckets,
                 row_blocks=None, row_block_size=0,
                 col_blocks=None, col_block_size=0):
        self._shape = tuple(int(s) for s in shape)
        self.col_inv = col_inv          # (n,) — None when term-blocked
        self.col_buckets = col_buckets  # list of (ids(g,), idx, vals)
        self.row_inv = row_inv          # (m,) — None when doc-blocked
        self.row_buckets = row_buckets
        self.row_blocks = row_blocks    # list of (inv(m,), buckets) or None
        self.row_block_size = int(row_block_size)
        self.col_blocks = col_blocks    # list of (inv(n,), buckets) or None
        self.col_block_size = int(col_block_size)
        # each family's buckets recorded for the kernel once: one host
        # call a minor block
        self.col_packs = _packs(col_buckets, col_blocks, col_block_size)
        self.row_packs = _packs(row_buckets, row_blocks, row_block_size)

    @property
    def padded_nnz(self):
        """Padded gather-table entries per product (the per-product gather
        work including bucket padding)."""
        def fam(buckets, blocks):
            if blocks is not None:
                return sum(int(idx.numel()) for _, bkts in blocks
                           for _, idx, _ in bkts)
            return sum(int(idx.numel()) for _, idx, _ in buckets)

        return max(fam(self.col_buckets, self.col_blocks),
                   fam(self.row_buckets, self.row_blocks))

    @classmethod
    def from_scipy(cls, A, dtype=torch.float32, min_len=8, pad_multiple=1,
                   doc_block="auto", term_block="auto", *, device="cuda"):
        """Build on `device` (the card unless the caller asks for the CPU).
        `pad_multiple`: pad bucket majors to this multiple.  `doc_block` /
        `term_block`: minor entries per block for the row/col bucket
        families ("auto": `_DOC_BLOCK` when that axis has >= 2x that many
        entries, else monolithic; None/0 forces monolithic)."""
        dev = setup(device)
        dtype = torch_dtype(dtype)
        csc = A.tocsc()
        csc.sort_indices()
        csr = A.tocsr()
        csr.sort_indices()
        m, n = csc.shape
        if doc_block == "auto":
            doc_block = _DOC_BLOCK if n >= 2 * _DOC_BLOCK else 0
        if term_block == "auto":
            term_block = _DOC_BLOCK if m >= 2 * _DOC_BLOCK else 0

        def dev_buckets(bkts):
            return [(torch.from_numpy(ids).to(dev),
                     torch.from_numpy(idx).to(dev),
                     _to_storage(vals, dtype).to(dev))
                    for ids, idx, vals in bkts]

        def build_family(major_cs, minor_cs, minor_dim, block):
            """(inv, buckets, blocks): the major-axis bucket family,
            monolithic or split into minor-dim blocks.  `major_cs` is
            the compressed-sparse form whose slices are the major axis
            (CSC for columns, CSR for rows); `minor_cs` the transpose
            form, whose cheap indptr-arithmetic slicing along the minor
            axis feeds the per-block rebuild."""
            if not block:
                inv, bk = _build_buckets(
                    major_cs.indptr, major_cs.indices, major_cs.data,
                    minor_dim, min_len, pad_multiple,
                )
                return inv, dev_buckets(bk), None
            blocks = []
            for b0 in range(0, minor_dim, int(block)):
                b1 = min(minor_dim, b0 + int(block))
                if minor_cs.format == "csc":
                    slab = minor_cs[:, b0:b1].tocsr()
                else:
                    slab = minor_cs[b0:b1, :].tocsc()
                slab.sort_indices()
                inv_b, bk_b = _build_buckets(
                    slab.indptr, slab.indices, slab.data, b1 - b0,
                    min_len, pad_multiple,
                )
                blocks.append((inv_b, dev_buckets(bk_b)))
            return None, None, blocks

        col_inv, cb, col_blocks = build_family(csc, csr, m, term_block)
        row_inv, rb, row_blocks = build_family(csr, csc, n, doc_block)

        return cls(
            (m, n),
            col_inv,
            cb,
            row_inv,
            rb,
            row_blocks=row_blocks,
            row_block_size=int(doc_block or 0),
            col_blocks=col_blocks,
            col_block_size=int(term_block or 0),
        )

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        if self.col_buckets:
            return self.col_buckets[0][2].dtype
        if self.col_blocks:
            return self.col_blocks[0][1][0][2].dtype
        return torch.float32

    @property
    def device(self):
        return (self.col_buckets or self.col_blocks[0][1])[0][1].device

    def _acc_dtype(self):
        """f32/f64 sums, as the reference's einsum preferred_element_type:
        blocked partials add up in it and are rounded once."""
        return torch.float64 if self.dtype == torch.float64 else torch.float32

    def _product(self, packs, table, n_major, transposed=False):
        """(n_major, k), or (k, n_major) when `transposed`, in the
        accumulator dtype: every bucket's rows, summed over the minor
        blocks in block order."""
        k = table.shape[1]
        out = torch.empty((k, n_major) if transposed else (n_major, k),
                          dtype=self._acc_dtype(), device=table.device)
        for b, (lo, hi, pack) in enumerate(packs):
            ell_spmm_buckets(pack, table[lo:hi], out, accumulate=b > 0,
                             transposed=transposed)
        return out

    def mm_tn(self, W):
        """W^T A -> (k, n) in W's dtype (the factor-dtype contract: a
        bf16-rounded product collapses BPP's sign tests to zero), written
        in that layout by the kernel; a factor dtype other than the
        accumulator's costs one contiguous rounding pass."""
        out = self._product(self.col_packs, W.contiguous(), self._shape[1],
                            transposed=True)
        return out.to(W.dtype)

    def mm_nt(self, H):
        """A H^T -> (m, k) in H's dtype; H is transposed once per product,
        not once per block: the kernel gathers whole k-wide rows of its
        table, which H's own (k, n) layout would turn into strided reads."""
        out = self._product(self.row_packs, H.T.contiguous(),
                            self._shape[0])
        return out.to(H.dtype)

    def col_sums(self):
        """Column sums in A's storage dtype, summed in the accumulator
        dtype and rounded once."""
        ones = torch.ones((self._shape[0], 1), dtype=self._acc_dtype(),
                          device=self.device)
        return self.mm_tn(ones)[0].to(self.dtype)
