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
    on a CUDA A in f32 or bf16 goes to K3 (kernels/rank2_loop.py: `wt_a`,
    `h_at`), which reads A in its own dtype and sums in f32; every other
    product is `torch.matmul` on A upcast to the accumulation dtype (at
    the 12411 x 7984 bf16 shape a 396 MB f32 temporary per product).  A
    K3 failure raises.  `kernel_products` and `matmul_products` count the
    products that took each branch.
  - EllAOp (ops/ell.py): bucketed ELL, every product through the CUDA
    gather-SpMM kernel on the card.
  - SparseAOp: dual-sorted COO, products by `index_select` and
    `index_add_` (the reference's XLA gather + segment-sum; no kernel).
    No path of the port picks it unless asked (`sparse_format="coo"`):
    it and the pad-multiple options keep the reference's `as_aop` API,
    which the tests hold the port to, and are what a sharded operand
    will split (ROADMAP slice 15).
  - MaskedAOp: a column-masked view of any of them (hierclust's
    full-width node solves).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..common.device import setup, torch_dtype
from ..kernels import rank2_loop
from .dense import _pet
from .ell import EllAOp, _to_storage

# products since the last reset, by branch; the only places they grow are
# the two product methods below
kernel_products = 0
matmul_products = 0


def _kernel_product_ok(A, F, k: int) -> bool:
    """The dispatch rule: A on CUDA in f32 or bf16, an f32 factor, k = 2."""
    return (A.is_cuda and A.dtype in (torch.float32, torch.bfloat16)
            and F.dtype == torch.float32 and k == 2)


class DenseAOp:
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

    def col_sums(self):
        return torch.sum(self.A, dim=0)


class SparseAOp:
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
        dtype = torch_dtype(dtype)
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
        dt = torch.promote_types(vals.dtype, table.dtype)
        out = torch.zeros((n_out, k), dtype=dt, device=table.device)
        elem = torch.empty((), dtype=dt).element_size()
        chunk = max(1, self._GATHER_BYTES_BUDGET // (k * elem))
        for s in range(0, vals.shape[0], chunk):
            part = (table.index_select(0, gather_ids[s:s + chunk])
                    * vals[s:s + chunk, None])
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
    A H^T.  Hierclust solves a node on it when it has no column table to
    gather the node's operand from (ops/ell_cols.py): in initdir mode, and
    for a prebuilt sparse operand that comes with no host matrix.
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

    def col_sums(self):
        sums = self.base.col_sums()
        return sums * self.mask.to(sums.dtype)


_SPARSE_FORMATS = ("ell", "coo")
DENSIFY_THRESHOLD_BYTES = 2 << 30


def densifies(A, dtype, threshold=DENSIFY_THRESHOLD_BYTES) -> bool:
    """Whether `as_aop` densifies the scipy sparse `A` in `dtype`: its
    dense image fits under `threshold` bytes."""
    m, n = A.shape
    return m * n * torch.empty((), dtype=torch_dtype(dtype)).element_size() \
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
    if isinstance(A, (DenseAOp, SparseAOp, MaskedAOp, EllAOp)):
        return A
    if sparse_format not in _SPARSE_FORMATS:
        raise ValueError(f"sparse_format {sparse_format!r}; expected one of "
                         f"{_SPARSE_FORMATS}")
    dev = setup(device)
    dtype = torch_dtype(dtype)
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
        vals = torch.from_numpy(np.ascontiguousarray(coo.data)).to(
            dtype).to(dev)
        dense = torch.zeros((m, n), dtype=dtype, device=dev)
        dense.index_put_((rows, cols), vals, accumulate=True)
        return DenseAOp(dense)
    host = torch.from_numpy(np.ascontiguousarray(np.asarray(A)))
    return DenseAOp(host.to(dtype).to(dev))
