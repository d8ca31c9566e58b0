"""The sharded NMF solve on a terms x docs mesh of ranks — port of
smallk_tpu/parallel/mesh.py on torch.distributed.

torch has no GSPMD, so the port runs SPMD ranks with a block layout and
explicit collectives, and no DTensor (no hand kernel or CUDA graph of the
port knows its dispatch):

  - `make_mesh` lays the world's ranks out as a (terms, docs) grid; each
    axis has its process group (a `torch.distributed.device_mesh.
    DeviceMesh` holds them).  Rank (t, d) holds A's rows [r_t, r_t+1) and
    columns [c_d, c_d+1) (`block_bounds`: np.array_split's bounds, so no
    shape is padded), W's rows r_t..r_t+1 and H's columns c_d..c_d+1.
    W's block is replicated along docs, H's along terms.
  - `shard_operand` builds the rank's block of A from the host matrix
    through `ops.aop.as_aop` (dense, `SparseAOp`, `EllAOp`; a mask takes
    the rank's slice) and wraps it in `ops.aop.ShardedAOp`, whose products
    are the block's (the port's kernels run on it) summed over the axis
    they contract.  This block layout replaces the JAX package's
    per-bucket sharding of an ELL operand, so no `pad_multiple` is needed.
  - Every other reduction over a sharded axis goes through the operand
    (`sum_terms`, `sum_docs`, `max_terms`, `max_docs`, `all_terms`,
    `all_ranks`): the k x k Grams, the norms of W's columns, the
    projected-gradient sums, the progress metric, the pivot loop's
    decisions and floors, a failed step.  Every stop test reads values
    that are already global, so all ranks take the same decisions.  An
    all-reduce gives every rank of its group the same bits (NCCL and
    gloo alike), so the replicated blocks stay bit-identical.
  - The NNLS solves stay local (K1 on the rank's columns of H and rows of
    W), as do the CG tier and every elementwise update.

`sharded_nmf_solve` returns the full W and H on every rank, gathered once
at the end (the JAX package's global arrays), and the rank's blocks.

Counters since the last reset, grown only here: `all_reduces` and
`all_reduce_bytes` (the reductions above), and `gathers`.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence

import numpy as np
import scipy.sparse as sp
import torch
import torch.distributed as dist

from ..common.device import setup, torch_dtype
from ..ops.aop import (
    DENSIFY_THRESHOLD_BYTES,
    DenseAOp,
    EllAOp,
    MaskedAOp,
    ShardedAOp,
    SparseAOp,
    as_aop,
    densifies,
)
from . import distributed

all_reduces = 0
all_reduce_bytes = 0
gathers = 0

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}
_ROLES = ("terms", "docs")


def block_bounds(length: int, parts: int, index: int) -> tuple[int, int]:
    """[start, stop) of block `index` of `parts` over `length`:
    np.array_split's bounds (the first length % parts blocks one longer)."""
    q, r = divmod(int(length), int(parts))
    start = index * q + min(index, r)
    return start, start + q + (index < r)


def block_sizes(length: int, parts: int) -> list[int]:
    return [b - a for a, b in (block_bounds(length, parts, i)
                               for i in range(parts))]


class Mesh:
    """The world's ranks as a (terms, docs) grid; this rank's coordinates,
    device and the process group of each axis."""

    def __init__(self, device_mesh, axis_names, device, owns_world: bool):
        self.device_mesh = device_mesh
        self.axis_names = tuple(axis_names)
        self.shape = tuple(int(s) for s in device_mesh.shape)
        self.coords = tuple(int(c) for c in device_mesh.get_coordinate())
        self.device = device
        self.backend = dist.get_backend()
        self.ranks = device_mesh.mesh.reshape(self.shape).tolist()
        self._groups = {role: device_mesh.get_group(name)
                        for role, name in zip(_ROLES, self.axis_names)}
        self._groups[None] = dist.group.WORLD
        self._owns_world = owns_world

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def rank(self) -> int:
        """This rank's index in the grid, row-major (its global rank)."""
        return self.coords[0] * self.shape[1] + self.coords[1]

    @property
    def is_coordinator(self) -> bool:
        return self.rank == 0

    def axis_size(self, role) -> int:
        """Ranks along the "terms" or "docs" axis, or (None) in the mesh."""
        return self.size if role is None else self.shape[_ROLES.index(role)]

    def axis_index(self, role) -> int:
        return self.rank if role is None else self.coords[_ROLES.index(role)]

    def group(self, role):
        """The process group of the "terms" or "docs" axis, or (None) of
        the mesh."""
        return self._groups[role]

    def _global_rank(self, role, j: int) -> int:
        t, d = self.coords
        if role == "terms":
            return self.ranks[j][d]
        if role == "docs":
            return self.ranks[t][j]
        return self.ranks[j // self.shape[1]][j % self.shape[1]]

    def all_reduce(self, x: torch.Tensor, role, op: str) -> torch.Tensor:
        """`op` ("sum", "max", "min") of x over the ranks of the "terms"
        or "docs" axis, or (None) of the mesh: a new tensor, x's layout (a
        transposed view comes back transposed), the same bits on every
        rank of the group.  A bool tensor reduces as int32."""
        global all_reduces, all_reduce_bytes
        flip = x.dim() == 2 and not x.is_contiguous() and x.T.is_contiguous()
        y = (x.T if flip else x).clone(memory_format=torch.contiguous_format)
        if y.dtype == torch.bool:
            y = y.to(torch.int32)
        dist.all_reduce(y, op=_OPS[op], group=self.group(role))
        all_reduces += 1
        all_reduce_bytes += y.numel() * y.element_size()
        if x.dtype == torch.bool:
            y = y.bool()
        return y.T if flip else y

    def gather(self, x: torch.Tensor, role, dim: int, length: int):
        """The blocks of x held along the `role` axis, concatenated along
        `dim` into its global extent `length` (np.array_split blocks): one
        broadcast a rank of the axis, exact bits on every rank (gloo has no
        all-gather of CUDA tensors)."""
        global gathers
        me = self.axis_index(role)
        parts = []
        for j, size in enumerate(block_sizes(length, self.axis_size(role))):
            if j == me:
                buf = x.clone(memory_format=torch.contiguous_format)
                if buf.shape[dim] != size:
                    raise ValueError(f"gather: block of {buf.shape[dim]} "
                                     f"along dim {dim}, expected {size}")
            else:
                shape = list(x.shape)
                shape[dim] = size
                buf = torch.empty(shape, dtype=x.dtype, device=x.device)
            dist.broadcast(buf, src=self._global_rank(role, j),
                           group=self.group(role))
            parts.append(buf)
        gathers += 1
        return torch.cat(parts, dim=dim)

    def barrier(self) -> None:
        """Wait for every rank of the mesh (an all-reduce of one int, so
        it needs no device id on NCCL; not counted)."""
        dist.all_reduce(torch.zeros(1, dtype=torch.int32, device=self.device),
                        group=self.group(None))

    def close(self) -> None:
        """Leave the world, where `make_mesh` joined it."""
        if self._owns_world and dist.is_initialized():
            dist.destroy_process_group()
        self._owns_world = False


def check_mesh(mesh, where: str):
    """`mesh` itself where it is None or a port `Mesh`; anything else (a
    JAX mesh, say) raises TypeError."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"{where}: mesh= takes a smallk_torch.parallel.mesh."
                        f"Mesh (make_mesh), not {type(mesh).__name__}")
    return mesh


def _rank_device(device="cuda") -> torch.device:
    """`device` validated; a bare "cuda" is this rank's card,
    cuda:LOCAL_RANK (torchrun's variable, else 0)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return setup(dev)


def _mesh_shape(shape, world: int) -> tuple[int, int]:
    shape = (1, world) if shape is None else tuple(int(s) for s in shape)
    if len(shape) != 2:
        raise ValueError(f"mesh shape {shape}: expected (terms, docs)")
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} != world size {world}")
    return shape


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("terms", "docs"),
              device="cuda", backend: Optional[str] = None) -> Mesh:
    """The world's ranks as a (terms, docs) mesh on this rank's `device`
    (cuda:LOCAL_RANK for "cuda"; an explicit device lets ranks share a
    card).  Default shape: (1, world), every rank on the docs axis.  A
    process outside a world joins it first (`initialize_distributed`, with
    `backend`, else nccl on CUDA and gloo on the CPU); a shape whose
    product is not the world size raises ValueError, as does a `backend`
    other than the world's."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = _rank_device(device)
    owns = not dist.is_initialized()
    if owns:
        shape = _mesh_shape(shape, distributed.launcher_world())
        distributed.initialize_distributed(backend=backend, device=dev)
    elif backend is not None and backend != dist.get_backend():
        raise ValueError(f"backend {backend!r}: the world runs "
                         f"{dist.get_backend()!r}")
    try:
        shape = _mesh_shape(shape, dist.get_world_size())
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        # gloo groups carry CUDA tensors too; the DeviceMesh's device type
        # only decides how it sets up its device, which is set above
        kind = dev.type if dist.get_backend() == "nccl" else "cpu"
        dm = init_device_mesh(kind, shape, mesh_dim_names=tuple(axis_names))
        return Mesh(dm, axis_names, dev, owns)
    except BaseException:
        if owns:
            dist.destroy_process_group()
        raise


def nmf_blocks(mesh: Mesh, m: int, n: int):
    """((r0, r1), (c0, c1)): this rank's rows of A and W and columns of A
    and H (the counterpart of the JAX package's `nmf_shardings`)."""
    t, d = mesh.coords
    return (block_bounds(m, mesh.shape[0], t),
            block_bounds(n, mesh.shape[1], d))


def _host_block(A, rows, cols):
    """Rows [r0, r1) and columns [c0, c1) of the host matrix A (A itself
    where they are all of it)."""
    (r0, r1), (c0, c1) = rows, cols
    if (r0, c0) == (0, 0) and (r1, c1) == A.shape:
        return A
    if sp.issparse(A):
        return A.tocsr()[r0:r1][:, c0:c1]
    return np.asarray(A)[r0:r1, c0:c1]


def shard_operand(A, mesh: Mesh, dtype=torch.float32, *,
                  densify_threshold_bytes=DENSIFY_THRESHOLD_BYTES,
                  sparse_format="ell", host_A=None) -> ShardedAOp:
    """This rank's block of A on the mesh's device, as a `ShardedAOp`.

    A: the host matrix (ndarray or scipy sparse; its block is made an
    operand by `as_aop`'s rules), a `DenseAOp` (its block is copied), a
    `MaskedAOp` (its base sharded, the rank's slice of its mask), or a
    ShardedAOp of this mesh (returned).  A prebuilt `EllAOp` or
    `SparseAOp` holds no block of its own: give its host matrix as
    `host_A`, which is sharded into that kind."""
    if isinstance(A, ShardedAOp):
        if A.mesh is not mesh:
            raise ValueError("shard_operand: the operand is sharded over "
                             "another mesh")
        return A
    m, n = A.shape
    if m < mesh.shape[0] or n < mesh.shape[1]:
        raise ValueError(f"shard_operand: a {m} x {n} matrix leaves a rank "
                         f"of the {mesh.shape} mesh no row or no column")
    rows, cols = nmf_blocks(mesh, m, n)
    dev = mesh.device
    if isinstance(A, MaskedAOp):
        base = shard_operand(A.base, mesh, dtype,
                             densify_threshold_bytes=densify_threshold_bytes,
                             sparse_format=sparse_format, host_A=host_A)
        return MaskedAOp(base, A.mask[cols[0]:cols[1]].to(dev).contiguous())
    if isinstance(A, DenseAOp):
        local = DenseAOp(A.A[rows[0]:rows[1], cols[0]:cols[1]]
                         .to(dev).contiguous())
    elif isinstance(A, (EllAOp, SparseAOp)):
        if host_A is None:
            raise ValueError(f"shard_operand: a prebuilt {type(A).__name__} "
                             "needs its host matrix (host_A=)")
        block = sp.csc_matrix(_host_block(host_A, rows, cols))
        if isinstance(A, SparseAOp):
            local = SparseAOp.from_scipy(block, A.dtype, device=dev)
        else:
            # the prebuilt operand's blocking (0: monolithic)
            local = EllAOp.from_scipy(block, A.dtype,
                                      doc_block=A.row_block_size or None,
                                      term_block=A.col_block_size or None,
                                      device=dev)
    elif sp.issparse(A):
        # the kind (dense or sparse) is decided on the whole matrix, so a
        # sharded run takes the unsharded run's
        dense = densifies(A, dtype, densify_threshold_bytes)
        local = as_aop(_host_block(A, rows, cols), dtype, device=dev,
                       densify_threshold_bytes=float("inf") if dense else -1,
                       sparse_format=sparse_format)
    else:
        local = as_aop(_host_block(A, rows, cols), dtype, device=dev)
    return ShardedAOp(local, mesh, (m, n), rows, cols)


def shard_factors(W, H, mesh: Mesh, dtype=None):
    """This rank's rows of W (m, k) and columns of H (k, n) on the mesh's
    device in `dtype` (default: their own): a host array's block made
    contiguous, as run_nmf makes its factors; a tensor's block contiguous,
    unless it is the whole tensor, which keeps its layout (so a mesh of one
    rank solves on the unsharded solve's very tensors, whose layout
    decides the products' paths and bits)."""
    (r0, r1), (c0, c1) = nmf_blocks(mesh, W.shape[0], H.shape[1])

    def put(x, block):
        if isinstance(x, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(x[block]))
        else:
            t = x[block]
            if t.shape != x.shape:
                t = t.contiguous()
        return t.to(device=mesh.device, dtype=dtype or t.dtype)

    return (put(W, np.s_[r0:r1]), put(H, np.s_[:, c0:c1]))


class ShardedSolveResult(NamedTuple):
    """`solvers.solve.SolveResult`'s fields, W and H the full factors
    (gathered once at the end, on every rank), and this rank's blocks."""
    W: torch.Tensor
    H: torch.Tensor
    iterations: int
    converged: bool
    success: bool
    metric: float
    pivot_rounds: int
    prog_state: torch.Tensor
    W_local: torch.Tensor
    H_local: torch.Tensor


def gather_factors(W, H, mesh: Mesh, m: int, n: int):
    """The full W (m, k) and H (k, n) from the ranks' blocks."""
    return mesh.gather(W, "terms", 0, m), mesh.gather(H, "docs", 1, n)


def sharded_nmf_solve(a_op, W0, H0, opts, mesh: Mesh) -> ShardedSolveResult:
    """The NMF solve loop with A, W and H sharded over `mesh`.

    `a_op`: a host matrix or an operand (`shard_operand`); W0 (m, k) and
    H0 (k, n): the full initializers (host arrays or tensors), of which
    each rank takes its blocks in `opts.dtype`.  The solver bodies are the
    unsharded ones; the operand's reductions make them global."""
    from ..solvers.solve import nmf_solve

    a = shard_operand(a_op, mesh, opts.a_dtype or opts.dtype)
    m, n = a.shape
    W, H = shard_factors(W0, H0, mesh, torch_dtype(opts.dtype))
    res = nmf_solve(a, W, H, opts)
    Wg, Hg = gather_factors(res.W, res.H, mesh, m, n)
    return ShardedSolveResult(Wg, Hg, *res[2:], W_local=res.W,
                              H_local=res.H)
