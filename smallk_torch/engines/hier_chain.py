"""Multi-split chain for HierNMF2 — port of smallk_tpu/engines/
hier_chain.py (its dense gather path, its sparse chunk path and its masked
branch).

Reference: the sequential tree loop in clust_hier_generic.hpp:77-238 (pop
the max-priority leaf, split it, factor both children, repeat), which
engines/hierclust.py runs one node at a time: it builds each node's
operand from a numpy subset and reads each node's split mask and priority
back.  The chain keeps the tree's device state on the card and runs up to
CHAIN_SEG splits a segment:

  - pop, partition and commit on the device: the leaves' labels (a full
    width boolean row a node), assignments, pop priorities and the W slab
    (one (m, 2) row a node) stay on the card; a step pops the
    max-priority leaf (argmax, first max, as Tree.min_max_leaf_priorities),
    partitions its documents by its stored labels and gathers each child's
    columns into the buffer of its width, the runner's operand and rule
    (whose step graphs the sequential engine shares): a dense child's
    bucket width (`dense_operand`); a sparse child's chunk width, the rung
    at or above max(its documents, its chunks) (the reference's sizing,
    smallk_tpu/engines/hier_chain.py:399-411), into the static operand
    from the chunk table's device plan of its mask (`sparse_operand`,
    `CscChunks.gather_device`), or past the cut-over the masked view of
    the root (`masked_operand`; the reference's _child_solve_masked);
  - the two children are solved one after another, each at its own bucket
    width, as the sequential engine solves them;
  - the host reads once a split besides the children's solve loops and
    operand builds: their priorities and gate flags together with the next
    pop's leaf, subset sizes and (sparse) chunk counts (the commit is written before the read; a split that bails is
    rolled back by rebuilding the device state);
  - at the end of a segment the host replays the committed splits through
    the ordinary Tree methods, asserting the pop order, and reads the
    committed children's labels in one copy.

Bit-parity with the sequential engine is by construction: both solve a
child on the same operand (its width's buffer, padded with zero columns or
pad chunks; or the same masked view) with the same kept graphs;
initializer seeds come from the same host stream (left child, then right child), each child's W0 and H0 drawn
from its own generator at full width and gathered, and a bail restores the
stream to the split's start.

Anything off the common path bails to the sequential engine for one split,
then the chain resumes: TrialSplit's unbalanced gate (checked on the
device with the reference's conservative margin, so a borderline split
bails and the host's gate decides), children with <= 3 documents, a
solver failure (the retry ladder), dense subsets wider than the ladder, and
a pop-order mismatch.  With `restarts` > 1 each child draws its R starts
and solves them as one solve of R lanes, as the sequential engine does
(hierclust._solve_from_draw), and keeps the best lane.

The chain runs only on the common fast path: a dense operand or a sparse
one with its chunk table, random or spectral init, RANK2, no initdir, and
no test interrupt.  Checkpoints are written at segment granularity
(clust_hier saves after every segment).

On an H100 at the Reuters shape the chain is no faster than the
sequential engine once that one keeps a graph a bucket width too
(hierclust.KEEP_GRAPHS): both spend their time in the solves' host reads
every U steps (chip_smoke.py phase `chain`, PERF.md).
"""

from __future__ import annotations

import numpy as np
import torch

from ..common.options import NmfAlgorithm
from ..ops.aop import DenseAOp
from .hierclust import _solve_from_draw, bucket_widths, gather_columns
from .priority import compute_priority_device

# Module switches, as solvers/graph.CAPTURE (tests and chip_smoke.py time
# the engine with and without them; not options of the user's)
CHAIN = True          # run the multi-split chain where it is available
CHAIN_SEG = 32        # splits a segment between host replays
# Telemetry of the most recent clust_hier run, and its bails by reason:
# "gate" (the unbalanced gate), "small" (a child of <= 3 documents),
# "failed" (a solver failure), "wide" (a dense subset past the ladder), "pop"
# (a pop order the host tree does not share)
LAST_STATS = {"segments": 0, "committed": 0, "bails": 0, "resyncs": 0}
LAST_BAILS: dict = {}


class ChainDriver:
    """Host side of the chain: owns the device state, runs segments,
    replays committed splits through the Tree, and rebuilds the device
    state after sequential (bail) splits."""

    def __init__(self, runner, node_count: int, root_W=None, root_left=None):
        global LAST_STATS, LAST_BAILS
        self.runner = runner
        self.nc = node_count
        self.m, self.n = runner.m, runner.n
        self.device = runner.device
        self.root_W, self.root_left = root_W, root_left
        self._dirty = True
        self._head = None   # the next pop: (device tensors, host values)
        LAST_STATS = {"segments": 0, "committed": 0, "bails": 0,
                      "resyncs": 0}
        LAST_BAILS = {}

    @staticmethod
    def available(runner, opts, interrupt_after) -> bool:
        """Whether the chain runs this tree: not on a mesh (as in the
        reference, its nodes are sharded masks there), nor in initdir
        mode, nor for options off its common path."""
        return (CHAIN
                and runner.mesh is None
                and ((isinstance(runner.a_op, DenseAOp)
                      and len(bucket_widths(runner.n)) > 0)
                     or runner.chunks is not None)
                and runner.inits.initdir is None
                and opts.init_method in ("random", "spectral")
                and opts.priority_method in ("ndcg", "size_ndcg")
                and opts.nmf_opts.algorithm == NmfAlgorithm.RANK2
                and interrupt_after is None)

    def mark_dirty(self) -> None:
        """The host tree advanced outside the chain (a sequential split):
        rebuild the device state before the next segment."""
        self._dirty = True

    # --- device state ------------------------------------------------------

    def _sync_from_host(self, tree, W_buffer, L_buffer) -> None:
        """The device state from the host tree.  Slot nc is the virtual
        root: before split 0 every document sits there, a leaf with pop
        priority +inf, labels and W those of the root's solve."""
        nc, n, dev = self.nc, self.n, self.device
        assign = np.full(n, -1, dtype=np.int64)
        labels = np.zeros((nc + 1, n), dtype=bool)
        pop = np.zeros(nc + 1)
        leaf = np.zeros(nc + 1, dtype=bool)
        self.W_slab = torch.zeros((nc + 1, self.m, 2),
                                  dtype=self.runner.dtype, device=dev)
        if tree.active_nodes == 0:
            assign[:] = nc
            leaf[nc] = True
            pop[nc] = np.inf
            labels[nc] = np.asarray(self.root_left, dtype=bool)
            self.W_slab[nc] = torch.as_tensor(self.root_W,
                                              dtype=self.runner.dtype,
                                              device=dev)
        for q, is_leaf in enumerate(tree.is_leaf):
            node = tree.nodes[q]
            if not node.is_valid:
                continue
            pop[q] = node.pop_priority
            if not is_leaf:
                continue
            leaf[q] = True
            assign[node.docs] = q
            lb = L_buffer[q]
            if lb is not None and len(lb) == len(node.docs):
                labels[q, node.docs[np.asarray(lb, dtype=bool)]] = True
            if W_buffer[q] is not None:
                self.W_slab[q] = torch.as_tensor(W_buffer[q],
                                                 dtype=self.runner.dtype,
                                                 device=dev)
        self.assign = torch.from_numpy(assign).to(dev)
        self.labels = torch.from_numpy(labels).to(dev)
        self.pop = torch.from_numpy(pop).to(dev)
        self.leaf = torch.from_numpy(leaf).to(dev)
        self._dirty = False
        self._head = None

    def _pop(self):
        """The next pop on the device: (p, mask0, mask1) and the values
        the host reads, [max pop priority, p, |left|, |right|], then on a
        chunk table the children's chunk counts."""
        ppl = torch.where(self.leaf, self.pop, -torch.inf)
        p = torch.argmax(ppl)
        go_left = self.labels[p]
        in_p = self.assign == p
        mask0, mask1 = in_p & go_left, in_p & ~go_left
        vals = [ppl[p], p.double(), mask0.sum().double(),
                mask1.sum().double()]
        chunks = self.runner.chunks
        if chunks is not None:
            vals += [torch.where(mk, chunks.cnt_dev, 0).sum().double()
                     for mk in (mask0, mask1)]
        return (p, mask0, mask1), torch.stack(vals)

    def _widths(self, sizes, chunk_counts):
        """Each child's width, the runner's rule: a dense child's bucket
        (None past the ladder: the split bails), a sparse child's chunk
        width (None: the masked view)."""
        runner = self.runner
        if runner.chunks is None:
            return tuple(runner.width(s) for s in sizes)
        return tuple(runner.chunk_width(s, int(c))
                     for s, c in zip(sizes, chunk_counts))

    # --- segments ------------------------------------------------------------

    def run_segment(self, i: int, num_clusters: int, tree, W_buffer,
                    L_buffer, stats, opts):
        """Run up to CHAIN_SEG splits from split ordinal `i`, replaying the
        committed ones into `tree`, the host buffers and `stats`.  Returns
        (i_next, outcome): "ok" (the segment ran), "bail" (the host runs
        split i_next sequentially) or "done" (no leaf can be split)."""
        runner = self.runner
        rng = runner.inits.rng
        if self._dirty:
            self._sync_from_host(tree, W_buffer, L_buffer)
            LAST_STATS["resyncs"] += 1
        LAST_STATS["segments"] += 1
        if self._head is None:
            dev_head, row = self._pop()
            self._head = (dev_head, row.tolist())

        n_steps = min(CHAIN_SEG, (num_clusters - 1) - i)
        committed, outcome, reason = [], "ok", None
        for s in range(n_steps):
            (p_t, mask0, mask1), (maxpp, p, s0, s1, *counts) = self._head
            p, s0, s1 = int(p), int(s0), int(s1)
            if i + s > 0 and maxpp < 0:
                outcome = "done"
                break
            widths = self._widths((s0, s1), counts)
            if (i + s == 0) != (p == self.nc):
                reason = "pop"
            elif min(s0, s1) <= 3:
                reason = "small"
            elif None in widths and runner.chunks is None:
                reason = "wide"
            else:
                state = rng.get_state()
                seeds = (int(runner.inits.next_seed()),
                         int(runner.inits.next_seed()))
                rec, reason = self._split(i + s, p_t, p, (mask0, mask1),
                                          (s0, s1), widths, seeds, opts)
                if rec is not None:
                    committed.append((state, rec))
                    continue
                rng.set_state(state)
            outcome = "bail"
            break

        i_next = self._replay(i, committed, tree, W_buffer, L_buffer,
                              stats, opts, rng)
        if i_next < i + len(committed):
            outcome, reason = "bail", "pop"
        if outcome == "bail":
            self._dirty = True
            LAST_STATS["bails"] += 1
            LAST_BAILS[reason] = LAST_BAILS.get(reason, 0) + 1
        LAST_STATS["committed"] += i_next - i
        return i_next, outcome

    def _operand(self, mask, ix, width):
        """(operand, kept graphs, masked) of a child: the runner's dense
        operand at its bucket width, its chunk operand at its chunk width
        (the device plan of `mask`), or the masked view (width None on a
        chunk table)."""
        runner = self.runner
        if runner.chunks is None:
            return (*runner.dense_operand(ix, width), False)
        if width is None:
            return runner.masked_operand(ix), None, True
        return (*runner.sparse_operand(
            runner.chunks.gather_device(mask, width), width), False)

    def _split(self, i, p_t, p, masks, sizes, widths, seeds, opts):
        """Split `i` of leaf p: gather and solve each child, gates, commit
        on the device, and the next pop.  Returns (the split's record for
        the replay, None), or (None, the reason) when it bails (the device
        state is then rebuilt from the host)."""
        runner, dev, n = self.runner, self.device, self.n
        idx, solved = [], []
        for mask, seed, width in zip(masks, seeds, widths):
            ix = torch.nonzero(mask).squeeze(1)
            op, graphs, masked = self._operand(mask, ix, width)
            idx.append(ix)
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)

            def draw(gen=gen, ix=ix, w=op.shape[1], masked=masked):
                # H at full width, then gathered (the masked view keeps it
                # whole), as the sequential engine draws it
                W0 = torch.rand((self.m, 2), generator=gen,
                                dtype=runner.dtype, device=dev)
                H0 = torch.rand((2, n), generator=gen, dtype=runner.dtype,
                                device=dev)
                return W0, H0 if masked else gather_columns(H0, ix, w)

            W, H, ok, iters = _solve_from_draw(
                op, draw, runner.quiet_opts, runner.init, runner.restarts,
                graphs)
            solved.append((W, H.index_select(1, ix) if masked else H, ok,
                           iters))
        if not all(r[2] for r in solved):
            return None, "failed"

        c = (2 * i, 2 * i + 1)
        w_parent = self.W_slab[p_t]
        gates = []
        new_assign = self.assign
        for b, ((W, H, _, _), size) in enumerate(zip(solved, sizes)):
            left = H[0, :size] > H[1, :size]
            pr = compute_priority_device(w_parent[:, b], W)
            split = torch.any(left) & torch.any(~left)
            pr = torch.where(split, pr, -1.0).double()
            nl = left.sum()
            smallest = torch.minimum(nl, size - nl).double()
            # the reference's conservative margin: a borderline split
            # bails, and the host's TrialSplit decides
            unbal = (pr >= 0) & (smallest < opts.unbalanced * size * 1.000001
                                 + 1e-3)
            gates += [pr, unbal.double()]
            full = torch.zeros(n, dtype=torch.bool, device=dev)
            full[idx[b]] = left
            self.labels[c[b]] = full
            self.W_slab[c[b]] = W
            self.pop[c[b]] = (torch.where(pr > 0, pr * size, pr)
                              if opts.priority_method == "size_ndcg"
                              else pr)
            self.leaf[c[b]] = True
            new_assign = torch.where(masks[b], c[b], new_assign)
        self.assign = new_assign
        self.leaf[p_t] = False
        dev_head, head = self._pop()
        vals = torch.cat([torch.stack(gates), head]).tolist()
        pr0, unbal0, pr1, unbal1 = vals[:4]
        if unbal0 or unbal1:
            return None, "gate"
        self._head = (dev_head, vals[4:])
        return (p, (pr0, pr1), tuple(r[3] for r in solved), sizes, c), None

    def _replay(self, i, committed, tree, W_buffer, L_buffer, stats, opts,
                rng) -> int:
        """The committed splits through the Tree; returns the split ordinal
        after the last one replayed.  A pop that differs from the host
        tree's ends the replay there, and the stream goes back to that
        split's start."""
        if not committed:
            return i
        rows = [c for _, rec in committed for c in rec[4]]
        labels = self.labels[rows].cpu().numpy()
        max_iter = opts.nmf_opts.max_iter
        for k, (state, (p, prs, iters, _, c)) in enumerate(committed):
            if i + k == 0:
                tree.split_root(self.root_W, labels=self.root_left)
            else:
                _, max_pr, split_index = tree.min_max_leaf_priorities()
                if split_index != p or max_pr < 0:
                    rng.set_state(state)
                    return i + k
                tree.split(split_index, W_buffer[split_index],
                           labels=L_buffer[split_index])
            for b, q in enumerate((tree.index0, tree.index1)):
                docs = tree.nodes[q].docs
                L_buffer[q] = labels[2 * k + b][docs]
                W_buffer[q] = self.W_slab[q]
                pop = prs[b]
                if opts.priority_method == "size_ndcg" and pop > 0:
                    pop = prs[b] * len(docs)
                tree.set_node_priority(q, prs[b], pop)
                stats.nmf_count += 1
                stats.iter_count += iters[b]
                if iters[b] >= max_iter:
                    stats.max_count += 1
            if opts.verbose:
                print(f"[{i + k + 1}] ", end="", flush=True)
        return i + len(committed)

