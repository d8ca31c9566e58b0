"""A-operand: port of smallk_tpu/ops/aop.py (DenseAOp + as_aop densify).

Solvers see A only through two products,

    mm_tn(W) = W^T A   (k x n)
    mm_nt(H) = A H^T   (m x k)

Products come back in the FACTOR dtype whatever A's storage dtype is (the
reference's `jnp.matmul(..., preferred_element_type=_pet(W)).astype(W.dtype)`
contract).  With bf16 A and f32 factors, a bf16 result would feed the NNLS
sign tests 8-bit products and collapse BPP to zero.

Which code computes a product is a dispatch by device, dtype and shape:
a k = 2 product of an f32 factor on a CUDA A in f32 or bf16 goes to K3
(kernels/rank2_loop.py: `wt_a`, `h_at`), which reads A in its own dtype
and sums in f32; every other product is `torch.matmul` on A upcast to the
accumulation dtype (at the 12411 x 7984 bf16 shape a 396 MB f32 temporary
per product).  A K3 failure raises.  `kernel_products` and
`matmul_products` count the products that took each branch.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..common.device import setup, torch_dtype
from ..kernels import rank2_loop
from .dense import _pet

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


def as_aop(A, dtype=torch.float32, *, device="cuda",
           densify_threshold_bytes=2 << 30):
    """Build an operand on `device` (the card unless the caller asks for
    the CPU) from a host matrix (ndarray or scipy sparse).

    Sparse inputs whose dense image fits under `densify_threshold_bytes`
    are densified ON the device from their COO triplets: the host->device
    copy is proportional to nnz, and duplicate entries are summed (one
    scatter-add in the storage dtype, as the reference's `.at[].add`).
    """
    if isinstance(A, DenseAOp):
        return A
    dev = setup(device)
    dtype = torch_dtype(dtype)
    if sp.issparse(A):
        m, n = A.shape
        itemsize = torch.empty((), dtype=dtype).element_size()
        if m * n * itemsize > densify_threshold_bytes:
            raise NotImplementedError(
                f"sparse operand of {m}x{n} exceeds the densify threshold "
                f"({densify_threshold_bytes} bytes); sparse operands are "
                "ROADMAP slice 10 of the port")
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
