"""Hierarchical clustering via recursive rank-2 NMF (HierNMF2) — port of
smallk_tpu/engines/hierclust.py, the sequential engine.

Reference: hierclust/include/clust_hier_generic.hpp (ClustHier :77-238,
TrialSplit :245-376, ActualSplit :383-517), hierclust/include/
clust_flat_generic.hpp (ClustFlat).

Each node is factored on A's columns at its document subset.  On a dense A
the subset is one `index_select` on the device into the buffer of the
bucket ladder's next width, padded with zero columns (`bucket_width`), so
that a run's solves share a few shapes and, with KEEP_GRAPHS, one captured
step graph a width (solvers/graph.py); the rank-2 solve's two A-products
of an f32 factor go to K3 (ops.aop), so a bf16 A is never upcast.  A sparse
A too large to densify is the bucketed-ELL operand (ops/ell.py) plus its
chunk table on the device (ops/ell_cols.CscChunks, the reference's
chunk-expanded table): each node, the root too, is
gathered from it into the static-shape operand of its chunk width
(ChunkColsAOp: the ladder's rung at or above the subset's chunks and
documents, the reference's _chunk_bucket), whose products run through
seg_spmm with a launch shape fixed by the width, so one kept graph a width
serves every node of it as on the dense path; from MASKED_SHARE of the
table's chunks up a node solves on the masked view of the root
(ops/aop.MaskedAOp).  An initdir run and a prebuilt sparse operand without
its host matrix solve every node on the masked view, as the reference's
initdir runs do.  Tree bookkeeping and document partitioning are
host-side numpy; a node's W and H stay on the device, and the host reads
back its split labels and priority.

Random mode draws each node's initializers with a `torch.Generator`
seeded from the host stream (`Random.device_key_seed`): W0 (m, 2) and H at
full width, then H's subset columns, as the reference does.  Torch cannot
reproduce the reference's threefry draws, so random-mode trees match the
reference statistically, not bit for bit; initdir mode matches it exactly.

On the random and spectral path (a dense operand, or a sparse one with its
chunk table) the multi-split chain (engines/hier_chain.py) runs the splits
and hands any split off its common path back to the loop here, one split
at a time.

With `mesh` (parallel/mesh.Mesh), as in the reference: A is sharded once
over the mesh's ranks (ops/aop.ShardedAOp) and every node solves on the
masked view of it, the mask the rank's slice; each rank draws W0 and H0 in
full from the same seed and takes its blocks, and after each solve the
node's W is gathered over the terms axis and its H over the docs axis, so
the tree, priority and assignment code runs unchanged and identically on
every rank.  Only the coordinator writes the checkpoint; every rank reads
it on resume.  The chain is off.

Not ported: speculation, the prefetch pool, bit-packed results and the
dispatch-budget segmentation (workarounds for a high-latency TPU link).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import NamedTuple, Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..common.checkpoint import atomic_savez
from ..common.device import setup, torch_dtype
from ..common.options import ClustOptions, ClustStats
from ..common.rng import Random, random_matrix
from ..io.delimited import load_delimited
from ..ops.aop import DenseAOp, MaskedAOp, as_aop
from ..ops.dense import gemm_nt, gram
from ..ops.ell_cols import ChunkColsAOp, CscChunks
from ..parallel.mesh import (
    check_mesh,
    gather_factors,
    shard_factors,
    shard_operand,
)
from ..solvers.nnls import nnls_hals
from ..solvers.rank2 import spectral_init_rank2
from ..solvers.solve import nmf_solve, reference_pg1
from .priority import compute_priority, compute_priority_device
from .tree import DeviceColumn, Tree, _host


# sparse node operands built since the last reset, by tier (the static
# operand, the masked view); the only places they grow are
# `_Rank2Runner.sparse_operand` and `masked_operand`
gathered_operands = 0
masked_operands = 0

# The bucket ladder of node subsets: powers of two from BUCKET_MIN to
# BUCKET_POW2_MAX, then steps of BUCKET_STEP, which grow with the width past
# 8 * BUCKET_STEP (BUCKET_STEP * (w // (8 * BUCKET_STEP)), about 12.5%): the
# reference's ladder, smallk_tpu/engines/hierclust.py:113-127; its rungs
# from the H100 sweep of chip_smoke.py --ladder, PERF.md §7.  A dense subset
# takes only rungs below n (a wider one solves at its exact width); a sparse
# one takes the rung at or above its chunk count and its document count.
BUCKET_MIN = 512
BUCKET_POW2_MAX = 4096
BUCKET_STEP = 2048

# Module switch, as solvers/graph.CAPTURE (chip_smoke.py times the engine
# with it off and on; not an option of the user's): node subsets gather
# into one operand buffer a bucket width and keep the solve's captured step
# graph on it for the run, so that a later solve at that width replays it;
# off, each solve captures a graph of its own and releases it
KEEP_GRAPHS = True

# Sparse node operands: a sparse A's nodes are gathered from its chunk table
# (ops/ell_cols.CscChunks) into the static-shape operand of their chunk
# width (ChunkColsAOp).  A node whose width reaches MASKED_SHARE of the
# table's chunks solves on the masked view of the root instead (the
# reference's cut-over is 0.5, smallk_tpu/engines/hierclust.py:709, a v5e
# constant).  On an H100 80GB HBM3 (700 W) at 50,000 x 1,000,000 (bf16 A,
# k = 2; chip_smoke.py --cols, PERF.md) the static operand's two products
# took 0.29, 0.54, 0.98, 1.44 and 1.70 ms at 1/8, 1/4, 1/2, 3/4 and 7/8 of
# the documents, the masked view 2.69-2.73 ms at every share, and the
# full-width static operand 1.67-1.95 ms: no share sends a node to the
# masked view.  For the same reason the root of a sparse A with a chunk
# table solves on the full-width static operand and not on the
# bucketed-ELL operand, whose two products took 2.65 ms (0.65 + 2.00).
MASKED_SHARE = float("inf")


def _ladder():
    """The ladder's rungs, ascending, without end."""
    w = BUCKET_MIN
    while True:
        yield w
        w = (w * 2 if w < BUCKET_POW2_MAX
             else w + BUCKET_STEP * max(1, w // (8 * BUCKET_STEP)))


def bucket_widths(n: int) -> tuple:
    """The ladder's rungs below n, ascending."""
    out = []
    for w in _ladder():
        if w >= n:
            return tuple(out)
        out.append(w)


def bucket_for(size: int) -> int:
    """The smallest rung >= size."""
    return next(w for w in _ladder() if w >= size)


def bucket_width(size: int, n: int):
    """The smallest rung >= size below n, or None (exact width)."""
    w = bucket_for(size)
    return w if w < n else None


def row_width(size: int, A) -> int:
    """The width a dense subset of `size` documents past the ladder is
    gathered at: on the card, `size` rounded up to a whole number of 16
    bytes a row of A, so that K3's products take their aligned loads (the
    extra columns are zero, as a bucket's padding); on the CPU, `size`."""
    if not A.is_cuda:
        return size
    per = 16 // np.gcd(16, A.element_size())
    return -(-size // per) * per


def gather_columns(A, idx, width: int, out=None):
    """A's columns at `idx` (s,), then width - s zero columns: an (m, width)
    tensor, written into `out` if given.  An e4m3 A is gathered as its
    bytes (a copy; +0.0 is the zero byte)."""
    if A.dtype == torch.float8_e4m3fn:
        if out is None:
            out = torch.empty((A.shape[0], width), dtype=A.dtype,
                              device=A.device)
        gather_columns(A.view(torch.uint8), idx, width,
                       out=out.view(torch.uint8))
        return out
    s = idx.shape[0]
    if width > s:
        idx = torch.cat([idx, idx.new_zeros(width - s)])
    out = torch.index_select(A, 1, idx, out=out)
    out[:, s:] = 0
    return out


class _InitializerSource:
    """W/H initializers for each factorization, in consumption order.

    Random by default; with `initdir`, loads Winit_N.csv / Hinit_N.csv in
    factorization order for deterministic testing (reference
    LoadInitializers, clust_hier_generic.hpp:568-622).

    In random mode the engine draws initializers on the device and only
    consumes a 31-bit generator seed from the host stream per
    factorization, so runs stay deterministic under the host seed and the
    checkpointed RNG state.
    """

    def __init__(self, m, n, rng: Random, initdir=None, dtype=np.float64):
        self.m, self.n = m, n
        self.rng = rng
        self.initdir = initdir
        self.counter = 1
        self.dtype = dtype

    def next(self):
        if self.initdir:
            W = load_delimited(
                f"{self.initdir.rstrip('/')}/Winit_{self.counter}.csv",
                dtype=self.dtype,
            )
            H = load_delimited(
                f"{self.initdir.rstrip('/')}/Hinit_{self.counter}.csv",
                dtype=self.dtype,
            )
            self.counter += 1
            if W.shape != (self.m, 2) or H.shape != (2, self.n):
                raise ValueError(
                    f"initializer {self.counter - 1} has wrong shape"
                )
            return W, H
        W = random_matrix(self.m, 2, self.rng, dtype=self.dtype)
        H = random_matrix(2, self.n, self.rng, dtype=self.dtype)
        return W, H

    def next_seed(self):
        """31-bit device-generator seed for one factorization (advances
        the stream)."""
        return self.rng.device_key_seed()


class _NodeSolve(NamedTuple):
    """One node factorization result.  W/H stay where they were computed;
    `left` is the host boolean split mask in the subset's doc order;
    `priority` already encodes the reference's gates (-1 when one side is
    empty, -3 on a degenerate parent topic)."""

    W: object
    H: object
    left: Optional[np.ndarray]
    priority: float
    ok: bool


def _objective(op, W, H):
    """||A_sub - W H||_F^2 up to the constant ||A_sub||^2, one value a lane
    of W (R, m, 2) and H (R, 2, n): tr((W'W)(HH')) - 2 <W'A, H>, W'A for
    every lane in one lane-stacked product."""
    return (torch.sum(op.sum_terms(gram(W)) * op.sum_docs(gemm_nt(H, H)),
                      dim=(-2, -1))
            - 2.0 * op.sum_docs(torch.sum(op.mm_tn_lanes(W) * H,
                                          dim=(-2, -1))))


def _solve_from_draw(op, draw, opts, init, restarts, graphs=None):
    """Initializer draw(s) + (optional spectral start) + solve loop.

    `draw() -> (W0, H0)` draws the next start.  With restarts > 1 the R
    random starts, drawn one after another, run as one solve of R lanes
    (nmf_solve), as the JAX package's vmap runs them
    (smallk_tpu/engines/hierclust.py:237-255), spectral init aside: the
    lane with the lowest rank-2 reconstruction objective wins (ties: the
    lowest lane), failed lanes score +inf, and the node fails only if
    every lane fails; the iterations are the winner's.  `graphs`: the
    caller's kept graphs for `op` (nmf_solve).
    Returns (W, H, success, iterations).
    """
    if restarts == 1:
        W0, H0 = draw()
        pg0 = None
        if init == "spectral":
            # tolerance stays anchored to the random-start PG_1 scale; a
            # degenerate spectral pair falls back to the random start
            pg0 = reference_pg1(op, W0, H0, opts)
            W0s, H0s = spectral_init_rank2(op, H0)
            if op.sharded:
                good = bool(op.all_ranks(torch.all(torch.isfinite(W0s)))
                            & torch.all(op.sum_terms(torch.sum(
                                torch.square(W0s), dim=0)) > 0))
            else:
                good = bool(torch.all(torch.isfinite(W0s))
                            & torch.all(torch.linalg.norm(W0s, dim=0) > 0))
            if good:
                W0, H0 = W0s, H0s
        res = nmf_solve(op, W0, H0, opts, pg0_hint=pg0, graphs=graphs)
        return res.W, res.H, bool(res.success), int(res.iterations)

    W0, H0 = zip(*(draw() for _ in range(restarts)))
    res = nmf_solve(op, torch.stack(W0), torch.stack(H0), opts,
                    graphs=graphs)
    ok = torch.as_tensor(res.success, device=res.W.device)
    scores = torch.where(ok, _objective(op, res.W, res.H), torch.inf)
    best = int(torch.argmin(scores))  # ties -> the lowest lane
    return (res.W[best], res.H[best], bool(res.success.any()),
            int(res.iterations[best]))


class _Rank2Runner:
    """Runs per-node rank-2 factorizations on the device with the retry
    ladder (clust_hier_generic.hpp:123-151, 435-472)."""

    def __init__(self, a_op, opts: ClustOptions, inits: _InitializerSource,
                 stats: ClustStats, dtype, host_A=None, chunks=None,
                 mesh=None):
        self.a_op = a_op
        # with a mesh, a_op is the rank's block (a ShardedAOp): every node
        # solves on its masked view
        self.mesh = mesh
        self.opts = opts
        self.inits = inits
        self.stats = stats
        self.dtype = dtype
        self.device = a_op.device
        # a sparse operand's chunk table on the device (the nodes' static
        # operands are gathered from it), or None
        self.chunks = chunks
        # host-side A (scipy/ndarray), initdir runs only: provides each
        # subset's row support for the reference's compacted-W0 semantics
        self.host_A = host_A
        self.init = opts.init_method
        # best-of-R restarts; initdir runs are pinned to the reference's
        # one-start-per-file semantics
        self.restarts = 1 if inits.initdir else max(1, opts.restarts)
        # the random path's solves print no per-iteration progress, as the
        # reference's fused node programs do not
        self.quiet_opts = dataclasses.replace(opts.nmf_opts, verbose=False)
        self.m, self.n = a_op.shape
        # with KEEP_GRAPHS, width -> (the width's operand buffers, the step
        # graphs kept on them): every subset of that bucket solves there
        self.slots = {}

    def _wp(self, w_parent):
        """The parent topic vector as an (m,) tensor on the device."""
        if w_parent is None:
            return torch.zeros(self.m, dtype=self.dtype, device=self.device)
        if isinstance(w_parent, DeviceColumn):
            w_parent = w_parent.materialize()
        return torch.as_tensor(w_parent, dtype=self.dtype,
                               device=self.device)

    def width(self, size: int):
        """The width a dense node subset of `size` documents solves at: its
        bucket (`bucket_width`), or None for its exact width (a sparse
        operand, an initdir run, a subset past the ladder)."""
        if self.inits.initdir or not isinstance(self.a_op, DenseAOp):
            return None
        return bucket_width(size, self.n)

    def dense_operand(self, idx, width):
        """(operand, kept graphs) of a dense subset at `idx`: A's columns
        padded with zero columns to `width` (None: its exact width, on the
        card padded to whole 16-byte rows, `row_width`, but in an initdir
        run, whose H initializers come at the subset's width).  With
        KEEP_GRAPHS a bucket's subset is gathered into the width's buffer
        and comes with the graphs kept on it (the operand stays valid until
        the next subset of that width); else it is a tensor of its own and
        its solve keeps no graph."""
        if width is None or not KEEP_GRAPHS:
            w = width or (idx.shape[0] if self.inits.initdir
                          else row_width(idx.shape[0], self.a_op.A))
            return DenseAOp(gather_columns(self.a_op.A, idx, w)), None
        slot = self.slots.get(width)
        if slot is None:
            A = self.a_op.A
            slot = self.slots[width] = (
                DenseAOp(torch.empty((self.m, width), dtype=A.dtype,
                                     device=A.device)), {})
        gather_columns(self.a_op.A, idx, width, out=slot[0].A)
        return slot

    def chunk_width(self, docs: int, chunks: int, root: bool = False):
        """The width a sparse subset of `docs` documents and `chunks` chunks
        solves at on the chunk table: the ladder's rung at or above both
        (the reference's _chunk_bucket), or None (the masked view) from
        MASKED_SHARE of the table's chunks up; the root has no cut-over."""
        wc = bucket_for(max(docs, chunks))
        if not root and wc >= MASKED_SHARE * (self.chunks.C + 1):
            return None
        return wc

    def sparse_operand(self, plan, width):
        """(operand, kept graphs) of a sparse subset: its chunk plan `plan`
        ((idx_docs, idx_chunks, slot) of `CscChunks.gather_host` or
        `gather_device`) loaded into an operand of `width`: with
        KEEP_GRAPHS the width's buffers, with the graphs kept on them (the
        operand stays valid until the next subset of that width); else
        buffers of its own, whose solve keeps no graph."""
        global gathered_operands
        gathered_operands += 1
        if not KEEP_GRAPHS:
            return ChunkColsAOp(self.chunks, width).load(*plan[1:]), None
        slot = self.slots.get(width)
        if slot is None:
            slot = self.slots[width] = (ChunkColsAOp(self.chunks, width), {})
        slot[0].load(*plan[1:])
        return slot

    def masked_operand(self, idx):
        """The full-width operand with every column but `idx`'s masked
        out (on a mesh, the rank's slice of the mask)."""
        global masked_operands
        masked_operands += 1
        mask = torch.zeros(self.n, dtype=self.dtype, device=self.device)
        mask[idx] = 1.0
        if self.mesh is not None:
            c0, c1 = self.a_op.cols
            mask = mask[c0:c1].contiguous()
        return MaskedAOp(self.a_op, mask)

    def local(self, W, H):
        """This rank's rows of W (m, 2) and columns of H (2, n), or W and H
        without a mesh."""
        if self.mesh is None:
            return W, H
        return shard_factors(W, H, self.mesh)

    def gathered(self, W, H):
        """The full W and H from the ranks' blocks (without a mesh, W and
        H)."""
        if self.mesh is None:
            return W, H
        return gather_factors(W, H, self.mesh, self.m, self.n)

    def close(self) -> None:
        """Release every kept graph and operand buffer."""
        for _, graphs in self.slots.values():
            for g in graphs.values():
                g.close()
        self.slots.clear()

    def _subset(self, subset):
        """(operand, index tensor, masked, kept graphs) for a node: A's
        columns at `subset` (a dense A: at the subset's bucket width,
        `dense_operand`; a sparse A: gathered from its chunk table at the
        subset's chunk width, `sparse_operand`), or (masked: past the chunk
        ladder's cut-over, or a sparse operand with no columns to gather
        from) the full-width view with every other column masked out.  The
        root (subset None) takes the full-width static operand of a chunk
        table where there is one, else the full operand."""
        root = subset is None
        if root:
            if self.chunks is None:
                return self.a_op, None, False, None
            subset = np.arange(self.n)
        idx = torch.as_tensor(np.asarray(subset), dtype=torch.long,
                              device=self.device)
        if self.mesh is not None:
            return self.masked_operand(idx), idx, True, None
        if isinstance(self.a_op, DenseAOp):
            op, graphs = self.dense_operand(idx, self.width(len(subset)))
            return op, idx, False, graphs
        if self.chunks is not None:
            wc = self.chunk_width(len(subset),
                                  self.chunks.subset_chunk_count(subset), root)
            if wc is not None:
                op, graphs = self.sparse_operand(
                    self.chunks.gather_host(subset, wc), wc)
                return op, idx, False, graphs
        return self.masked_operand(idx), idx, True, None

    def _record(self, success, iterations):
        if success:
            self.stats.nmf_count += 1
            self.stats.iter_count += int(iterations)
            if iterations >= self.opts.nmf_opts.max_iter:
                self.stats.max_count += 1
        return success

    def solve(self, subset=None, w_parent=None, max_attempts=3):
        """Factor A[:, subset] (full A when subset is None).

        Returns a _NodeSolve.  Retries with fresh initializers up to
        `max_attempts` times on solver failure (singular system),
        mirroring clust_hier_generic.hpp:123-151,435-472.
        """
        if self.inits.initdir:
            return self._solve_hostinit(subset, w_parent, max_attempts)

        op, idx, masked, graphs = self._subset(subset)
        wp = self._wp(w_parent)
        for attempt in range(max_attempts):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(self.inits.next_seed()))

            def draw(gen=gen):
                # H is drawn at full width then gathered, as the reference
                # draws it (hierclust.py:309-314); the masked view keeps it
                # whole (its other columns never reach the solution)
                W0 = torch.rand((self.m, 2), generator=gen, dtype=self.dtype,
                                device=self.device)
                H0 = torch.rand((2, self.n), generator=gen, dtype=self.dtype,
                                device=self.device)
                if idx is None or masked:
                    return self.local(W0, H0)
                return W0, gather_columns(H0, idx, op.shape[1])

            # spectral start on the first attempt only: a retry means that
            # basin failed and the reference's random restart is the escape
            init = self.init if attempt == 0 else "random"
            W, H, success, iters = _solve_from_draw(
                op, draw, self.quiet_opts, init, self.restarts, graphs)
            if self._record(success, iters):
                W, H = self.gathered(W, H)
                if masked:
                    H = H.index_select(1, idx)
                elif idx is not None:
                    H = H[:, :idx.shape[0]]  # the padding's columns go
                left = H[0, :] > H[1, :]
                pr = compute_priority_device(wp, W)
                split = torch.any(left) & torch.any(~left)
                pr = torch.where(split, pr, -1.0)
                return _NodeSolve(W, H, left.cpu().numpy(), float(pr), True)
            if self.opts.verbose:
                print("\nNode factorization failed, retrying with new "
                      "initializers...")
        return _NodeSolve(None, None, None, -1.0, False)

    def _solve_hostinit(self, subset, w_parent, max_attempts):
        """initdir parity path: host-loaded initializers, host priority
        (f64 reference transcription), sequential file consumption.

        The reference extracts a row-COMPACTED W initializer per node
        (ActualSplit -> ExtractSubmatrices via new_to_old_rows,
        clust_hier_generic.hpp:440-452): rows of A[:, subset] with no
        nonzeros contribute nothing to the compacted solve.  The
        full-height equivalent is zeroing W0 at those rows — W'W/W'A then
        match the compacted Grams exactly, and the rank-2 W update keeps
        off-support rows at exact zero (AH' rows are zero), so the whole
        trajectory equals the reference's compact solve scattered back."""
        nmf_opts = self.opts.nmf_opts
        row_support = None
        if subset is not None and self.host_A is not None:
            sub = self.host_A[:, np.asarray(subset)]
            if sp.issparse(sub):
                row_support = np.zeros(self.m, dtype=bool)
                row_support[np.unique(sub.tocoo().row)] = True
            else:
                row_support = np.any(np.asarray(sub) != 0, axis=1)
        op, _, masked, _ = self._subset(subset)

        for _ in range(max_attempts):
            W0, H0 = self.inits.next()
            if row_support is not None and not row_support.all():
                W0 = np.where(row_support[:, None], W0, 0.0)
            if subset is not None and not masked:
                H0 = H0[:, np.asarray(subset)]
            res = nmf_solve(op, *self.local(
                torch.as_tensor(W0, dtype=self.dtype, device=self.device),
                torch.as_tensor(H0, dtype=self.dtype, device=self.device)),
                nmf_opts)
            if self._record(bool(res.success), int(res.iterations)):
                W, H = self.gathered(res.W, res.H)
                W = W.cpu().numpy()
                H = H.cpu().numpy()
                if masked:
                    H = H[:, np.asarray(subset)]
                left = H[0, :] > H[1, :]
                priority = -1.0
                if left.any() and (~left).any() and w_parent is not None:
                    priority = compute_priority(_host(w_parent), W)
                return _NodeSolve(W, H, left, priority, True)
            if self.opts.verbose:
                print("\nNode factorization failed, retrying with new "
                      "initializers...")
        return _NodeSolve(None, None, None, -1.0, False)


def _actual_split(runner: _Rank2Runner, subset, w_parent):
    """One split attempt on a column subset.

    Reference: ActualSplit (clust_hier_generic.hpp:383-517).
    Returns (priority, W (m,2), left (|subset|,) bool).
    """
    m = runner.m
    if len(subset) <= 3:
        return -1.0, np.zeros((m, 2)), np.zeros(len(subset), dtype=bool)

    ns = runner.solve(subset, w_parent)
    if not ns.ok:
        if runner.opts.on_node_failure == "leaf":
            # production mode: an unsplittable node becomes a permanent
            # leaf, like an exhausted TrialSplit, instead of aborting
            if runner.opts.verbose:
                print("\nNode factorization failed on every retry; "
                      "keeping the node as a leaf.")
            return -2.0, np.zeros((m, 2)), np.zeros(len(subset),
                                                    dtype=bool)
        raise RuntimeError(
            "HierNMF2: node factorization failed after three attempts."
        )
    return ns.priority, ns.W, ns.left


def _trial_split(runner: _Rank2Runner, subset, min_priority, w_parent,
                 opts: ClustOptions):
    """Split with outlier detection and retries.

    Reference: TrialSplit (clust_hier_generic.hpp:245-376).  May shrink
    `subset` by dropping outlier items; on exhausting trial_allowance the
    node becomes a permanent leaf (priority -2) with its original docs.
    Returns (priority, subset, W, left).
    """
    subset = np.asarray(subset, dtype=np.int64)
    subset_backup = subset.copy()
    subset_small = np.empty(0, dtype=np.int64)

    trial = 0
    priority_one = -2.0
    W = left = None
    while trial < opts.trial_allowance:
        priority_one, W, left = _actual_split(runner, subset, w_parent)
        if priority_one < 0:
            break

        counts = np.array([int(left.sum()), int((~left).sum())])
        smallest_size = int(counts.min())
        if smallest_size < opts.unbalanced * len(left):
            label_small = 0 if smallest_size == counts[0] else 1
            subset_small = subset[left if label_small == 0 else ~left]

            # score the small cluster on its own; its parent topic vector is
            # the corresponding column of this split's W
            pr_small, _, _ = _actual_split(
                runner, subset_small, W[:, label_small]
            )
            if pr_small < min_priority:
                trial += 1
                if trial < opts.trial_allowance:
                    if opts.verbose:
                        print(f"dropping {len(subset_small)} items ...")
                    subset = np.setdiff1d(subset, subset_small)
            else:
                break
        else:
            break

    if trial == opts.trial_allowance:
        # exhausted all attempts: permanent leaf with original docs
        if opts.verbose:
            print(f"recycling {len(subset_small)} items ...")
        subset = subset_backup
        W = np.zeros((runner.m, 2))
        left = np.zeros(len(subset), dtype=bool)
        priority_one = -2.0

    return priority_one, subset, W, left


def _save_hier_checkpoint(path, tree, W_buffer, L_buffer, rng_state, stats,
                          i_next, root_W=None, root_left=None, config=None,
                          init_counter=1):
    """Atomic npz checkpoint of the full hierclust state, in the
    reference's format (tree, per-node factor buffers and split labels,
    RNG stream, split counter).  `config` is the (num_clusters, m, n)
    fingerprint a resume must match; `init_counter` preserves initdir
    file-consumption order."""
    payload = dict(tree.to_arrays())
    payload["i_next"] = np.int64(i_next)
    payload["nmf_count"] = np.int64(stats.nmf_count)
    payload["max_count"] = np.int64(stats.max_count)
    payload["iter_count"] = np.int64(stats.iter_count)
    payload["init_counter"] = np.int64(init_counter)
    if config is not None:
        payload["config"] = np.asarray(config, dtype=np.int64)
    payload["rng_state"] = np.frombuffer(pickle.dumps(rng_state),
                                         dtype=np.uint8)
    for idx, (Wb, Lb) in enumerate(zip(W_buffer, L_buffer)):
        if Wb is not None:
            payload[f"Wbuf_{idx}"] = _host(Wb)
            payload[f"Lbuf_{idx}"] = np.asarray(Lb, dtype=bool)
    if root_W is not None:
        payload["root_W"] = _host(root_W)
        payload["root_left"] = np.asarray(root_left, dtype=bool)
    atomic_savez(path, payload, suffix=".hckpt.tmp")


def _save_on_coordinator(mesh, path, *args, **kwargs):
    """`_save_hier_checkpoint` by the mesh's coordinator (by the process
    without a mesh); the other ranks wait until it is written."""
    if mesh is None or mesh.is_coordinator:
        _save_hier_checkpoint(path, *args, **kwargs)
    if mesh is not None:
        mesh.barrier()


def _load_hier_checkpoint(path, node_count, config):
    with np.load(path, allow_pickle=False) as z:
        arrs = {k: z[k] for k in z.files}
    tree = Tree.from_arrays(arrs)
    saved = tuple(int(v) for v in arrs["config"])
    if saved != tuple(int(v) for v in config):
        raise ValueError(
            f"hierclust checkpoint at {path} was written for "
            f"(num_clusters, m, n)={saved}, but this run is "
            f"{tuple(int(v) for v in config)}"
        )
    W_buffer = [arrs.get(f"Wbuf_{idx}") for idx in range(node_count)]
    L_buffer = [arrs.get(f"Lbuf_{idx}") for idx in range(node_count)]
    rng_state = pickle.loads(bytes(arrs["rng_state"]))
    root = (arrs.get("root_W"), arrs.get("root_left"))
    return (tree, W_buffer, L_buffer, rng_state, int(arrs["i_next"]),
            int(arrs["nmf_count"]), int(arrs["max_count"]),
            int(arrs["iter_count"]), root, int(arrs["init_counter"]))


def _operand(A, opts: ClustOptions, device, host_A=None):
    """(a_op, chunks): the operand the root is factored on, and for a
    sparse one the chunk table on the card that the nodes gather from (None
    for a dense operand and in initdir mode, whose nodes solve on the masked
    view as the reference's do).  A host matrix is densified on `device` when its
    dense image fits the densify threshold, else it becomes a bucketed-ELL
    operand; a prebuilt operand comes back as it is, and a sparse one takes
    its columns from the scipy `host_A`, if given."""
    dtype = opts.nmf_opts.a_dtype or opts.nmf_opts.dtype
    a_op = as_aop(A, dtype=dtype, device=device)
    host = A if sp.issparse(A) else host_A
    chunks = None
    if (not isinstance(a_op, DenseAOp) and sp.issparse(host)
            and not opts.initdir):
        chunks = CscChunks.from_scipy(host, dtype=a_op.dtype,
                                      device=a_op.device)
    return a_op, chunks


def clust_hier(A, opts: ClustOptions, rng: Random,
               stats: ClustStats | None = None,
               checkpoint_path: str | None = None,
               host_A=None, mesh=None, *, device="cuda",
               _interrupt_after: int | None = None):
    """Build the hierarchical clustering tree on `device` (the card unless
    the caller asks for the CPU; a prebuilt operand keeps its own).
    `host_A`, the host matrix of a prebuilt operand, gives a sparse one its
    chunk table (its nodes' static operands) and initdir runs their row
    support.  With `mesh`, A is sharded over its ranks, on its device
    (a prebuilt sparse operand by its `host_A`), and every node solves on
    the masked view of the rank's block.

    Reference: ClustHier (clust_hier_generic.hpp:77-238).
    Returns (tree, stats).

    With `checkpoint_path`, the full engine state (tree, per-node factor
    buffers, RNG stream, split counter) is checkpointed after the root
    factorization and after every split; an existing checkpoint resumes
    the run.  `_interrupt_after` is a test hook that raises after N
    completed splits.
    """
    stats = stats if stats is not None else ClustStats()
    opts.validate()
    dtype = torch_dtype(opts.nmf_opts.dtype)
    if check_mesh(mesh, "clust_hier") is None:
        a_op, chunks = _operand(A, opts, device, host_A)
    else:
        a_op = shard_operand(A, mesh, opts.nmf_opts.a_dtype
                             or opts.nmf_opts.dtype, host_A=host_A)
        chunks = None
    setup(a_op.device)
    m, n = a_op.shape

    num_clusters = opts.num_clusters
    node_count = 2 * (num_clusters - 1)

    inits = _InitializerSource(m, n, rng, opts.initdir, dtype=np.float64)
    if host_A is None and opts.initdir:
        # the initdir row-support semantics read the host matrix
        if sp.issparse(A):
            host_A = A.tocsc()
        elif isinstance(A, np.ndarray):
            host_A = A
    runner = _Rank2Runner(a_op, opts, inits, stats, dtype, host_A=host_A,
                          chunks=chunks, mesh=mesh)

    W = left = None
    start_i = 0
    ckpt_config = (num_clusters, m, n)
    if checkpoint_path and os.path.exists(checkpoint_path):
        (tree, W_buffer, L_buffer, rng_state, start_i,
         stats.nmf_count, stats.max_count, stats.iter_count,
         root, inits.counter) = _load_hier_checkpoint(
            checkpoint_path, node_count, ckpt_config)
        rng.set_state(rng_state)
        if start_i == 0:
            W, left = root
    else:
        tree = Tree()
        tree.init(num_clusters, m, n)
        W_buffer = [None] * node_count
        L_buffer = [None] * node_count

    if W is None and start_i == 0:
        # factor the root (<= 3 attempts)
        ns = runner.solve(None)
        if not ns.ok:
            raise RuntimeError(
                "HierNMF2: root node factorization failed after three "
                "attempts"
            )
        W, left = ns.W, ns.left
        if checkpoint_path:
            _save_on_coordinator(
                mesh, checkpoint_path, tree, W_buffer, L_buffer,
                rng.get_state(), stats, 0, root_W=W, root_left=left,
                config=ckpt_config, init_counter=inits.counter,
            )

    def save(i_next):
        if checkpoint_path:
            _save_on_coordinator(
                mesh, checkpoint_path, tree, W_buffer, L_buffer,
                rng.get_state(), stats, i_next, config=ckpt_config,
                init_counter=inits.counter,
            )

    def split(i):
        """One split of the sequential engine; False when no leaf can be
        split."""
        if i == 0:
            min_priority = np.inf
            tree.split_root(W, labels=left)
        else:
            min_priority, max_priority, split_index = (
                tree.min_max_leaf_priorities()
            )
            if max_priority < 0:
                if opts.verbose:
                    print("\nHierNMF2: no further factorization possible.\n")
                return False
            tree.split(split_index, W_buffer[split_index],
                       labels=L_buffer[split_index])

        for idx, docs, tv in (
            (tree.index0, tree.left_child_docs(),
             tree.left_child_topic_vector()),
            (tree.index1, tree.right_child_docs(),
             tree.right_child_topic_vector()),
        ):
            priority, subset, W_c, left_c = _trial_split(
                runner, docs, min_priority, tv, opts)
            tree.nodes[idx].docs = subset  # TrialSplit may drop outliers
            # pop order: raw NDCG (reference) or size-scaled NDCG (graph
            # workloads — a leaf holding half the corpus must not be
            # starved by sliver splits with higher NDCG)
            pop = priority
            if opts.priority_method == "size_ndcg" and priority > 0:
                pop = priority * len(subset)
            tree.set_node_priority(idx, priority, pop)
            W_buffer[idx] = W_c
            L_buffer[idx] = left_c

        if opts.verbose:
            print(f"[{i + 1}] ", end="", flush=True)
        save(i + 1)
        if _interrupt_after is not None and (i + 1) >= _interrupt_after:
            raise KeyboardInterrupt(f"test interrupt after {i + 1} splits")
        return True

    from .hier_chain import ChainDriver

    chain = (ChainDriver(runner, node_count, W, left)
             if ChainDriver.available(runner, opts, _interrupt_after)
             else None)
    i = start_i
    try:
        while i < num_clusters - 1:
            if chain is not None:
                # segments of the chain; a split off its common path comes
                # back here and runs on the sequential engine
                i_next, outcome = chain.run_segment(i, num_clusters, tree,
                                                    W_buffer, L_buffer,
                                                    stats, opts)
                if i_next > i:
                    save(i_next)
                i = i_next
                if outcome == "done":
                    if opts.verbose:
                        print("\nHierNMF2: no further factorization "
                              "possible.\n")
                    break
                if outcome == "ok" or i >= num_clusters - 1:
                    continue
                chain.mark_dirty()
            if not split(i):
                break
            i += 1
    finally:
        runner.close()

    tree.compute_top_terms(opts.maxterms)
    tree.compute_assignments()
    if opts.verbose:
        print()
    return tree, stats


def clust_flat(A, tree: Tree, opts: ClustOptions, rng: Random, mesh=None,
               *, device="cuda"):
    """Flat refinement: W from the k leaf topic vectors, H by NNLS-HALS on
    the whole operand (a sparse one's bucketed ELL); with `mesh`, sharded
    over its ranks, on its device.

    Reference: ClustFlat (clust_flat_generic.hpp:15-76), <= 3 attempts with
    fresh random H.  Returns host (W (m,k), H (k,n), success).
    """
    dtype = torch_dtype(opts.nmf_opts.dtype)
    a_dtype = opts.nmf_opts.a_dtype or opts.nmf_opts.dtype
    if check_mesh(mesh, "clust_flat") is None:
        a_op = as_aop(A, dtype=a_dtype, device=device)
    else:
        a_op = shard_operand(A, mesh, a_dtype)
    dev = setup(a_op.device)
    m, n = a_op.shape
    k = opts.num_clusters

    def local(W, H):
        if mesh is None:
            return W, H
        return shard_factors(W, H, mesh)

    def host(W, H):
        if mesh is not None:
            W, H = gather_factors(W, H, mesh, m, n)
        return W.cpu().numpy(), H.cpu().numpy()

    W_full = torch.as_tensor(tree.flatclust_init_w(m, k), dtype=dtype,
                             device=dev)
    for _ in range(3):
        H0 = random_matrix(k, n, rng, dtype=np.float64)
        W_out, H_out, ok = nnls_hals(
            a_op, *local(W_full, torch.as_tensor(H0, dtype=dtype,
                                                 device=dev)),
            opts.nmf_opts.tol, opts.nmf_opts.max_iter,
        )
        if ok:
            return (*host(W_out, H_out), True)
    print("Flatclust NNLS solver failed after 3 attempts.")
    return (*host(W_out, H_out), False)
