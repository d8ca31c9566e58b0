"""A-operand: port of smallk_tpu/ops/aop.py (DenseAOp, SparseAOp, as_aop).

Solvers see A only through two products,

    mm_tn(W) = W^T A   (k x n)
    mm_nt(H) = A H^T   (m x k)

Products come back in the FACTOR dtype whatever A's storage dtype is (the
reference's `jnp.matmul(..., preferred_element_type=_pet(W)).astype(W.dtype)`
contract).  With bf16 A and f32 factors, a bf16 result would feed the NNLS
sign tests 8-bit products and collapse BPP to zero.

Three operands, and a view:
  - DenseAOp: A as an (m, n) tensor.  Which code computes a product is a
    dispatch by device, dtype and shape: a k = 2 product of an f32 factor
    on a CUDA A in f32, bf16 or e4m3 goes to K3 (kernels/rank2_loop.py:
    `wt_a`, `h_at`), which reads A in its own dtype and sums in f32, and so
    does the lane-stacked product of R rank-2 lanes (k = 2R, R <=
    rank2_loop.MAX_LANES: `mm_tn_lanes`, `mm_nt_lanes`); every other
    product (BPP's k = 8 among them) is `torch.matmul` on A upcast to the
    accumulation dtype (at the 12411 x 7984 bf16 shape a 396 MB f32
    temporary per product).  A K3 failure raises.  `kernel_products` and
    `matmul_products` count the products that took each branch.
  - EllAOp (ops/ell.py): bucketed ELL, every product through the CUDA
    gather-SpMM kernel on the card.
  - SparseAOp: dual-sorted COO, products by `index_select` and
    `index_add_` (the reference's XLA gather + segment-sum; no kernel).
    No path of the port picks it unless asked (`sparse_format="coo"`):
    it and the pad-multiple options keep the reference's `as_aop` API,
    which the tests hold the port to; a sharded operand's block may be
    one (parallel/mesh.shard_operand, sparse_format="coo"), and no
    sharded operand needs the pad-multiple options.
  - MaskedAOp: a column-masked view of any of them (hierclust's
    full-width node solves).
  - ShardedAOp: one rank's block of A on a terms x docs mesh of ranks
    (parallel/mesh.py), any of the above, whose products are summed over
    the mesh axis they contract.

Every operand carries the reductions of `ops.dense.Unsharded` (sum_terms,
sum_docs, ...): identities, except on a ShardedAOp, where they are the
collectives of its mesh; a MaskedAOp takes its base's.  Every operand also
takes the products of R rank-2 lanes at once (`mm_tn_lanes` W (R, m, 2) ->
(R, 2, n), `mm_nt_lanes` H (R, 2, n) -> (R, m, 2)): one product of the 2R
stacked factor rows where its kernel takes them (K3, ell_spmm, the COO
gather), so A is read once a side whatever R is; the static chunk operand
(ops/ell_cols.ChunkColsAOp), whose seg_spmm launch shape is fixed at
k = 2, runs one product a lane.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..common.device import setup, storage_dtype
from ..kernels import rank2_loop
from .dense import Unsharded, _pet
from .ell import EllAOp, _to_storage

# products since the last reset, by branch; the only places they grow are
# the two product methods below
kernel_products = 0
matmul_products = 0


def _kernel_product_ok(A, F, k: int, lanes: int = 1) -> bool:
    """The dispatch rule: A on CUDA in f32, bf16 or e4m3, an f32 factor,
    k = 2 a lane, at most rank2_loop.MAX_LANES lanes (a product outside a
    lane step is one lane: k = 2)."""
    return (A.is_cuda and A.dtype in rank2_loop.A_DTYPES
            and F.dtype == torch.float32 and k == 2 * lanes
            and 1 <= lanes <= rank2_loop.MAX_LANES)


class DenseAOp(Unsharded):
    """Dense operand: A stored as an (m, n) tensor."""

    def __init__(self, A: torch.Tensor):
        self.A = A

    @property
    def shape(self):
        return tuple(self.A.shape)

    @property
    def dtype(self):
        return self.A.dtype

    @property
    def device(self):
        return self.A.device

    def mm_tn(self, W):
        global kernel_products, matmul_products
        if _kernel_product_ok(self.A, W, W.shape[1]):
            out = rank2_loop.wt_a(self.A, W.T.contiguous())
            kernel_products += 1
            return out
        matmul_products += 1
        pet = _pet(W)
        return torch.matmul(W.T.to(pet), self.A.to(pet)).to(W.dtype)

    def mm_nt(self, H):
        global kernel_products, matmul_products
        if _kernel_product_ok(self.A, H, H.shape[0]):
            out = rank2_loop.h_at(self.A, H.contiguous()).T
            kernel_products += 1
            return out
        matmul_products += 1
        pet = _pet(H)
        return torch.matmul(self.A.to(pet), H.T.to(pet)).to(H.dtype)

    def mm_tn_lanes(self, W):
        """W (R, m, 2) -> (R, 2, n); the 2R stacked rows through K3 where
        the rule takes them (one read of A), else `mm_tn`'s branch."""
        global kernel_products
        R, m, k = W.shape
        if not _kernel_product_ok(self.A, W, R * k, lanes=R):
            return super().mm_tn_lanes(W)
        out = rank2_loop.wt_a(self.A, W.transpose(1, 2).reshape(R * k, m))
        kernel_products += 1
        return out.reshape(R, k, -1)

    def mm_nt_lanes(self, H):
        """H (R, 2, n) -> (R, m, 2), as mm_tn_lanes."""
        global kernel_products
        R, k, n = H.shape
        if not _kernel_product_ok(self.A, H, R * k, lanes=R):
            return super().mm_nt_lanes(H)
        out = rank2_loop.h_at(self.A, H.reshape(R * k, n).contiguous())
        kernel_products += 1
        return out.reshape(R, k, -1).transpose(1, 2)

    def col_sums(self):
        if self.A.dtype == torch.float8_e4m3fn:
            # torch has no e4m3 sum: f32 sums, rounded once
            return torch.sum(self.A, dim=0, dtype=torch.float32).to(
                self.A.dtype)
        return torch.sum(self.A, dim=0)


class SparseAOp(Unsharded):
    """Sparse operand in dual-sorted COO form.

    Stores the nonzeros twice, sorted by column and by row, so both
    products are a gather plus a segment sum:

      mm_tn: (W^T A)[:, j] = sum_{nz in col j} val * W[row, :]
      mm_nt: (A H^T)[i, :] = sum_{nz in row i} val * H[:, col]

    The sums run in the product's dtype (f32 for an f32 factor on bf16 A),
    in chunks of nonzeros that bound the (chunk, k) gathered tensor.  On
    the card `index_add_` adds with atomics, so the order of a sum varies
    from run to run.
    """

    # bound on one chunk's (chunk, k) gathered tensor
    _GATHER_BYTES_BUDGET = 256 * 1024 * 1024

    def __init__(self, shape, c_rows, c_cols, c_vals, r_rows, r_cols, r_vals):
        self._shape = tuple(int(s) for s in shape)
        self.c_rows = c_rows  # nonzeros sorted by column id
        self.c_cols = c_cols
        self.c_vals = c_vals
        self.r_rows = r_rows  # nonzeros sorted by row id
        self.r_cols = r_cols
        self.r_vals = r_vals

    @classmethod
    def from_scipy(cls, A_csc, dtype=torch.float32, pad_multiple=1024, *,
                   device="cuda"):
        """Build on `device`.  The nonzero lists are padded to a multiple of
        `pad_multiple` with zero-valued entries at the last row/col id: the
        lists stay sorted and the padding contributes nothing."""
        dev = setup(device)
        dtype = storage_dtype(dtype)
        coo = A_csc.tocoo()
        order_c = np.lexsort((coo.row, coo.col))
        order_r = np.lexsort((coo.col, coo.row))
        nnz = coo.nnz
        padded = -(-max(nnz, 1) // pad_multiple) * pad_multiple

        def pad(x, fill, np_dtype):
            out = np.full(padded, fill, dtype=np_dtype)
            out[:nnz] = x
            return out

        def ids(x, fill):
            return torch.from_numpy(pad(x, fill, np.int32)).to(dev)

        def vals(order):
            return _to_storage(pad(coo.data[order], 0, np.float64),
                               dtype).to(dev)

        m, n = A_csc.shape
        return cls(
            A_csc.shape,
            ids(coo.row[order_c], m - 1),
            ids(coo.col[order_c], n - 1),
            vals(order_c),
            ids(coo.row[order_r], m - 1),
            ids(coo.col[order_r], n - 1),
            vals(order_r),
        )

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return self.c_vals.dtype

    @property
    def device(self):
        return self.c_vals.device

    @property
    def nnz(self):
        return self.c_vals.shape[0]

    def _segment_product(self, gather_ids, seg_ids, vals, table, n_out):
        """out[seg, :] = sum of vals * table[gather, :] over the nonzeros,
        in the dtype of vals * table."""
        k = table.shape[1]
        # torch promotes no e4m3 type: its values widen to the table's
        dt = (table.dtype if vals.dtype == torch.float8_e4m3fn
              else torch.promote_types(vals.dtype, table.dtype))
        out = torch.zeros((n_out, k), dtype=dt, device=table.device)
        elem = torch.empty((), dtype=dt).element_size()
        chunk = max(1, self._GATHER_BYTES_BUDGET // (k * elem))
        for s in range(0, vals.shape[0], chunk):
            part = (table.index_select(0, gather_ids[s:s + chunk])
                    * vals[s:s + chunk, None].to(dt))
            out.index_add_(0, seg_ids[s:s + chunk], part)
        return out

    def mm_tn(self, W):
        out = self._segment_product(self.c_rows, self.c_cols, self.c_vals, W,
                                    self._shape[1])
        return out.T.to(W.dtype).contiguous()

    def mm_nt(self, H):
        out = self._segment_product(self.r_cols, self.r_rows, self.r_vals,
                                    H.T, self._shape[0])
        return out.to(H.dtype)

    def col_sums(self):
        if self.dtype == torch.float8_e4m3fn:
            ones = torch.ones((self._shape[0], 1), dtype=torch.float32,
                              device=self.device)
            return self.mm_tn(ones)[0].to(self.dtype)
        out = torch.zeros(self._shape[1], dtype=self.c_vals.dtype,
                          device=self.c_vals.device)
        return out.index_add_(0, self.c_cols, self.c_vals)


class MaskedAOp:
    """Column-masked view of another operand: A' = A diag(mask) — port of
    smallk_tpu/ops/aop.py:MaskedAOp, without the `_t` variants.

    Masking commutes with both products, so nothing is built:
      W^T (A diag(m)) = (W^T A) * m[None, :]
      (A diag(m)) H^T = A (H * m[None, :])^T
    A masked column behaves as a removed one for every solver: its W'A
    column is 0, so the rank-2 H update zeroes it and it adds nothing to
    A H^T.  Hierclust solves a node on it when it has no chunk table to
    gather the node's operand from (ops/ell_cols.py): in initdir mode, and
    for a prebuilt sparse operand that comes with no host matrix; and past
    the chunk tier's cut-over (engines/hierclust.MASKED_SHARE).
    """

    def __init__(self, base, mask):
        self.base = base
        self.mask = mask  # (n,), 0 or 1, in a factor-compatible dtype

    @property
    def shape(self):
        return self.base.shape

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def device(self):
        return self.base.device

    def mm_tn(self, W):
        return self.base.mm_tn(W) * self.mask.to(W.dtype)[None, :]

    def mm_nt(self, H):
        return self.base.mm_nt(H * self.mask.to(H.dtype)[None, :])

    def mm_tn_lanes(self, W):
        return self.base.mm_tn_lanes(W) * self.mask.to(W.dtype)

    def mm_nt_lanes(self, H):
        return self.base.mm_nt_lanes(H * self.mask.to(H.dtype))

    def col_sums(self):
        sums = self.base.col_sums()
        return sums * self.mask.to(sums.dtype)

    # a mask keeps its base's layout: the base's reductions
    @property
    def sharded(self):
        return self.base.sharded

    def sum_terms(self, x):
        return self.base.sum_terms(x)

    def sum_docs(self, x):
        return self.base.sum_docs(x)

    def max_terms(self, x):
        return self.base.max_terms(x)

    def max_docs(self, x):
        return self.base.max_docs(x)

    def all_terms(self, flags):
        return self.base.all_terms(flags)

    def all_ranks(self, ok):
        return self.base.all_ranks(ok)


class ShardedAOp:
    """One rank's block of A on a mesh of ranks over (terms, docs): rows
    `rows` = (r0, r1) and columns `cols` = (c0, c1) of the global (m, n)
    `shape`, held as `local`, an operand of any other kind
    (parallel/mesh.shard_operand).  Beside it the rank holds W's rows
    r0..r1 and H's columns c0..c1, so

      mm_tn(W_t) = sum over the terms axis of W_t^T A_td   (k, c1 - c0)
      mm_nt(H_d) = sum over the docs axis of A_td H_d^T    (r1 - r0, k)

    both the local operand's products (its kernels run on the block) and
    one all-reduce each.  The reductions are `mesh.all_reduce` over the
    named axis, or over every rank for `all_ranks`.  `shape` is the global
    shape, as a sharded array's is in the JAX package."""

    sharded = True

    def __init__(self, local, mesh, shape, rows, cols):
        self.local = local
        self.mesh = mesh
        self._shape = tuple(int(s) for s in shape)
        self.rows = tuple(rows)
        self.cols = tuple(cols)

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return self.local.dtype

    @property
    def device(self):
        return self.local.device

    def mm_tn(self, W):
        return self.sum_terms(self.local.mm_tn(W))

    def mm_nt(self, H):
        return self.sum_docs(self.local.mm_nt(H))

    def mm_tn_lanes(self, W):
        return self.sum_terms(self.local.mm_tn_lanes(W))

    def mm_nt_lanes(self, H):
        return self.sum_docs(self.local.mm_nt_lanes(H))

    def col_sums(self):
        sums = self.local.col_sums()
        if sums.dtype == torch.float8_e4m3fn:
            # no collective sums e4m3: f32 sums, rounded once
            return self.sum_terms(sums.float()).to(sums.dtype)
        return self.sum_terms(sums)

    def sum_terms(self, x):
        return self.mesh.all_reduce(x, "terms", "sum")

    def sum_docs(self, x):
        return self.mesh.all_reduce(x, "docs", "sum")

    def max_terms(self, x):
        return self.mesh.all_reduce(x, "terms", "max")

    def max_docs(self, x):
        return self.mesh.all_reduce(x, "docs", "max")

    def all_terms(self, flags):
        return self.mesh.all_reduce(torch.all(flags), "terms", "min")

    def all_ranks(self, ok):
        return self.mesh.all_reduce(ok, None, "min")


_SPARSE_FORMATS = ("ell", "coo")
DENSIFY_THRESHOLD_BYTES = 2 << 30


def densifies(A, dtype, threshold=DENSIFY_THRESHOLD_BYTES) -> bool:
    """Whether `as_aop` densifies the scipy sparse `A` in `dtype`: its
    dense image fits under `threshold` bytes."""
    m, n = A.shape
    return m * n * torch.empty((), dtype=storage_dtype(dtype)).element_size() \
        <= threshold


def as_aop(A, dtype=torch.float32, *, device="cuda",
           densify_threshold_bytes=DENSIFY_THRESHOLD_BYTES,
           sparse_format="ell", ell_pad_multiple=1):
    """Build an operand on `device` (the card unless the caller asks for
    the CPU) from a host matrix (ndarray or scipy sparse); a prebuilt
    operand comes back unchanged.

    Sparse inputs whose dense image fits under `densify_threshold_bytes`
    are densified ON the device from their COO triplets: the host->device
    copy is proportional to nnz, and duplicate entries are summed (one
    scatter-add in the storage dtype, as the reference's `.at[].add`).
    Larger ones become an `EllAOp` (bucketed ELL, buckets padded to
    `ell_pad_multiple` rows), or a `SparseAOp` for sparse_format="coo".
    """
    if isinstance(A, (DenseAOp, SparseAOp, MaskedAOp, EllAOp, ShardedAOp)):
        return A
    if sparse_format not in _SPARSE_FORMATS:
        raise ValueError(f"sparse_format {sparse_format!r}; expected one of "
                         f"{_SPARSE_FORMATS}")
    dev = setup(device)
    dtype = storage_dtype(dtype)
    if sp.issparse(A):
        m, n = A.shape
        if not densifies(A, dtype, densify_threshold_bytes):
            if sparse_format == "coo":
                return SparseAOp.from_scipy(A.tocsc(), dtype=dtype,
                                            device=dev)
            return EllAOp.from_scipy(A.tocsc(), dtype=dtype,
                                     pad_multiple=ell_pad_multiple,
                                     device=dev)
        coo = A.tocoo()
        rows = torch.from_numpy(coo.row.astype(np.int64)).to(dev)
        cols = torch.from_numpy(coo.col.astype(np.int64)).to(dev)
        if dtype == torch.float8_e4m3fn:
            # torch has no e4m3 scatter-add: the values are rounded to e4m3
            # and summed in f32, and a sum of duplicates is rounded again
            vals = torch.from_numpy(np.ascontiguousarray(coo.data)).to(
                dtype).to(dev)
            dense = torch.zeros((m, n), dtype=torch.float32, device=dev)
            dense.index_put_((rows, cols), vals.float(), accumulate=True)
            return DenseAOp(dense.to(dtype))
        vals = torch.from_numpy(np.ascontiguousarray(coo.data)).to(
            dtype).to(dev)
        dense = torch.zeros((m, n), dtype=dtype, device=dev)
        dense.index_put_((rows, cols), vals, accumulate=True)
        return DenseAOp(dense)
    host = torch.from_numpy(np.ascontiguousarray(np.asarray(A)))
    return DenseAOp(host.to(dtype).to(dev))
