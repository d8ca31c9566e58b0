#!/usr/bin/env python3
"""Smoke run of the PyTorch port (smallk_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths through their user entry points on the card and
fails (nonzero exit, no result line) on any fault:

  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles the CUDA kernels from smallk_torch/csrc/, one nvcc
     per library, all started together;
  3. K1, the masked Gauss-Jordan solve: both device kernels (narrow and
     wide ranks) and the wrapper's pick against the plain torch version on
     the card with tolerance 0, f32 and f64, at the BPP path's shapes and
     up to k = 128, plus the dead-pivot case and non-finite inputs; the
     two kernels side by side over k (what the dispatch constant is set
     from); kernel, plain and library times at the BPP shapes;
  4. K2, the whole-step HALS kernel (a cluster of 8 CTAs), against its
     plain version at the flatclust shape (f32 and bf16 A), small and
     ragged shapes, the largest square shape the kernel admits at k = 16
     and the zero-column rescue; kernel and plain times at 256 x 256,
     k = 16;
  5. slice parity in f64: run_nmf with BPP, MU, HALS and RANK2 on the card
     against the same calls on the CPU (f64 runs the torch-ops steps), and
     nnls_blockpivot at a shape where its rounds narrow to the columns
     still not optimal;
  6. the BPP main path at full width: the 12411 x 7984 Reuters shape, 80
     nnz per column, k = 8, bf16 A, f32 factors, 100 fixed iterations, at
     the auto U, so captured: each step a CUDA graph whose two pivot
     loops are conditional WHILE nodes (solvers/graph.py,
     csrc/graph_if.cu); the graphs, their nodes, capture and instantiation
     ms, host reads and pivot rounds run printed, bits equal to the same
     run eager, and K1's launches exactly 2 a step run and one a round
     run;
  7. the flatclust HALS path at full width: the reference's flatclust
     configuration (dense 256 x 256 UNIFORM, k = 16, tol 1e-4) through
     run_flatclust, with K2's launches counted over that run; HALS it/s
     over 2000 fixed iterations; f32 on the card against f32 on the CPU;
  8. MU and RANK2 on a dense 800 x 600 operand and flatclust BPP at
     256 x 256, k = 16 beside it;
  9. K3, the rank-2 products and loop: its kernels' registers, shared
     memory and spills from the build (a spill fails), then against its
     plain version at the shapes of P3 (scripts/tpu_batch60.py), small
     ragged shapes, a misaligned view and exact widths (the scalar
     path, whose bits must be the vector path's), and its two
     products alone at the hierclust root shape (12411 x 7984 bf16) at
     every factor row count K3 takes; kernel, plain and library times;
 10. hierclust parity: a small planted corpus in initdir mode, f64 on the
     card against the CPU (same tree, assignments and priorities), and f32
     on the card (through K3) against f32 on the CPU by NMI;
 11. the hierclust path at full width: the Reuters-shape corpus (12411 x
     7984, bf16 A, f32 factors) to 12 clusters, as bench.py times the
     reference, with K3's launches and the products' branches counted;
 12. ell_spmm, the ELL gather-SpMM kernel, against its plain version on
     ragged buckets with sentinels (every dtype pair, store and
     accumulate, row and transposed output), on its narrow-k and long-row
     launch plans (k = 1, 2, 3, 8, 16, 128, rows of skewed lengths up to
     131,072 entries, against the plain version evaluated in f64; two
     launches bit-equal) and at the shapes of P1 (scripts/tpu_batch29.py)
     and P2 (scripts/tpu_batch33.py), the transposed output bit-equal to
     the row output transposed; kernel, plain and torch.sparse.mm times;
 12b. seg_spmm, the gather-SpMMs of the static sparse node operand (the
     term pass by offsets, the chunk pass by slot over each chunk's live
     entries), against their plain versions evaluated in f64 (SEG_CASES:
     every dtype pair, row and transposed output, one key holding up to
     90% of the entries, chunks of 4 to 128 entries), two launches and an
     eager against a captured launch bit-equal;
 13. sparse parity in f64: run_nmf BPP and MU on a blocked EllAOp and on
     a SparseAOp, the card against the CPU;
 14. the flagship at full width: rank-128 MU and BPP on the uncut 50,000 x
     1,000,000 bf16 EllAOp (bench.py:164-195), timed as bench.py times
     the reference (two-point fits), with the operand's host build time;
     its two products (ell_spmm) and K1's full-width rounds, each timed
     and held against its plain version at these shapes (K1 also against
     the narrow kernel and torch.linalg.solve_ex at the W side's width);
     W'A's one bucket timed beside its plain version and torch.sparse.mm,
     and op.mm_tn checked by the profiler to run nothing but that launch;
     the sparse-side relative error (from plain products), ell_spmm's
     launches, and BPP's pivot rounds, K1 launches and K1 columns counted;
 15. sparse against dense: a planted 50,000 x 40,000 corpus (above the
     densify threshold) clustered on its sparse operand and on the same
     matrix as a DenseAOp: equal trees in f64 initdir mode, the f32
     random-mode NMI within HIER_NMI_MARGIN of the dense run's;
 16. sparse hierclust at the flagship's size: the planted 50,000 x
     1,000,000 corpus (bf16 A, f32 factors, 12 clusters) through its chunk
     table, every node and the root on the static operand of its chunk
     width (seg_spmm), a warm-up run and the timed run with seg_spmm's and
     ell_spmm's launches gated exactly against each solve's steps; the
     root's (EllAOp and static operand) and a 1/8 node's products timed
     against their plain version, the torch-ops formulation,
     torch.sparse.mm and index_add_;
 17. the user-facing entry points over the kernels (facade): the stateful
     facade's Nmf(8) (BPP) on the main path's operand, bit-equal to a
     direct run_nmf from the same draws, K1 = 2 x iterations + pivot
     rounds; its HierNmf2WithFlat(12) on the Reuters-shape hierclust
     corpus, files equal to a direct run_hier_nmf2's, K3 >= 2 x
     iter_count; api.Flatclust HALS on the flatclust problem, one K2
     launch an iteration, equal to a direct run_flatclust; api.Hierclust
     on phase 16's corpus (reused), 12 leaves, NMI within
     FACADE_NMI_MARGIN of phase 16's, products through ell_spmm only;
     NmfEmbeddings on the flagship's MU factors (phase 14's), top-k
     against f64 on the host; profiling.block_and_time on a K1 call
     against device_ms, and a device_trace of K1 calls (in a process of
     its own); each entry point's wall beside the direct call's;
 18. BPP at k = 160 (the masked CG tier's) on the main path's operand,
     captured (its CG loops WHILE nodes, inside the pivot loops' bodies)
     and eager, bit-equal, the CG solves and steps counted, and f64 on a slice against the CPU;
 19. the nmf, flatclust and hierclust CLIs as subprocesses, the nmf and
     hierclust CLIs on a 30000 x 20000 .mtx above the densify threshold
     (EllAOp), and the five CLIs chained: matrixgen -> preprocess_tf ->
     nmf and hierclust on the card;
 20. the solve loop (loop): flatclust HALS, Reuters hierclust, sparse
     hierclust at 50,000 x 1,000,000 (phase 16's operand), flagship MU
     at 25 iterations (phase 14's operand, through nmf_solve) and Reuters
     BPP at 100 iterations (phase 6's problem, through nmf_solve), each run
     with solvers/graph.CAPTURE off and on, in turns (on, the loop
     replays its steps as a CUDA graph at U > 1; flagship MU's auto U is
     1, eager in both, solve.MU_ONE_STEP_ENTRIES): equal
     bits and counts, launch gates exact against the steps run, the walls,
     host reads, graphs, capture and replay times and steps wasted to the
     freeze; f64 captured-against-eager runs of HALS, RANK2 and MU; then
     (--loop-busy lean, a process of its own) each run once more inside
     one profiler session for the device's busy share and the host's
     launch calls, the hierclust cells captured only (`--loop-busy` alone
     profiles them eager too, and on every engine);
 21. the multi-split chain (engines/hier_chain.py) against the sequential
     engine, with and without a kept graph a bucket width
     (hierclust.KEEP_GRAPHS): the Reuters-shape hierclust on each engine
     of CHAIN_MODES in turns (CHAIN_ORDER), walls, graphs, replays, host
     reads a split, the chain's busy share (from the loop's busy child;
     the other engines' are `--loop-busy`'s), NMI, and the trees, which
     must be one;
     then a dense f64 2000 x 3000 problem on which they must be one too;
 21b. the same on the sparse hierclust cell (phase `sparse chain`: the
     50,000 x 1,000,000 corpus on the static operand, S, G and C in turns,
     walls, graphs, replays, host reads, node-build ms, the root's steps,
     busy shares, NMI at least SPARSE_CHAIN_NMI, one tree), then an f64
     sparse 2000 x 6000 problem whose trees must be identical;
 22. e4m3 A-storage: K3's, K2's and ell_spmm's e4m3 loads against their
     plain versions, timed, and a path through each (Reuters hierclust,
     flatclust-shape HALS, BPP on a blocked EllAOp) with its launches
     counted;
 23. examples/torch_drivers/large_corpus_demo.py on the card (the
     checkpoint driver's segments and its resume, which runs no solve),
     two profiling.device_trace blocks in this process after its earlier
     profiles, and (with the CLIs) examples/torch_drivers/
     smallk_example.py --synthetic;
 23b. the sharded solve (phase `mesh`, smallk_torch/parallel; in a process
     of its own, `--mesh-child`, so that no process group outlives it,
     run beside the CLI processes of phase 19):
     (a) a mesh of one rank over NCCL at full width: Reuters-shape BPP
     (phase 6's problem) and BPP k = 16 on the sparse 50,000 x 40,000
     EllAOp (phase 15's corpus), each bit-equal to nmf_solve on the same
     operand with the same K1 and ell_spmm launches, their it/s and walls
     (U, S, S, U) and the all-reduces an iteration and their bytes; the
     facade's HierNmf2WithFlat(12, mesh=) on phase 11's corpus, every
     node on the masked view of the sharded operand, K3 exact against the
     steps run, its NMI and result files beside the unsharded run's; the
     f64 CHAIN_F64 corpus to MESH_HIER_K clusters, the tree equal to the
     unsharded one; (b) two and four ranks sharing the card over gloo,
     meshes 1x2, 2x1 and 2x2: BPP, MU, HALS and RANK2 in f64 within
     MESH_TOL of (a)'s one-rank runs, the MESH_HIER_K-cluster tree equal
     to (a)'s, and on every rank K1 (f64 BPP), K3 (an f32 RANK2 solve,
     exact) and ell_spmm (f32 BPP on an EllAOp block) launched; (c) with
     two cards or more, NCCL a card a rank at 1x2 (and 2x2 with four) at
     the Reuters shape against (a), else one line saying it was not run;
 23c. graph community detection (phase `graph`, bench.py:218-302; the
     graph preset runs best-of-3 restarts as one solve of 3 lanes): (a)
     K3 over lanes (2R factor rows) against its plain version at the two
     graph roots (20,000^2 e4m3, 3,000^2 f32) for R = 1..8, at a bucket-
     width node of each cell and at ragged shapes for R = 1, 2, 3, 4, 8,
     each root and node product's device ms beside the plain version's,
     torch.matmul's after the upcast and its bound; (b) 3 lanes
     against the 3 single solves from the same starts, f64 on the card
     (equal iterations, success and best lane, factors within 1e-10);
     (c) the community cell: planted_partition_graph(3000, 20, seed=7),
     normalized, graph_clust_options(20), engine seeds 3-7, NMI median
     and worst gated, K3 exact (2 x steps run + 2 x solves, every launch a
     lane launch), then restarts 1 against 3 in turns (3, 1, 3); (d) the
     north-star cell: 100 leaves of the 20,000-node graph, e4m3 A, restarts
     1, the best of two timed runs, NMI gated, K3 exact (2 x steps run +
     solves); (e) hierclust_cli --graph on the 3000-node graph's .mtx;
 24. the kernel table as one JSON line, the card line, and last the result
     line {"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile

runs only the full-width hierclust path: once under torch.profiler, to
print where the device time goes, then with its rank-2 products through
K3 and through torch.matmul, alternating, to time what K3 moves end to
end.

    python3 chip_smoke.py --k1

runs only K1: phase 3 above, then full-width rounds at the flagship's two
shapes on synthetic systems.

    python3 chip_smoke.py --sparse

runs only the studies of the flagship operand: AH' for each doc block of
DOC_BLOCKS (how ops/ell._DOC_BLOCK was chosen), MU with its products
through ell_spmm and through torch.sparse.mm, alternating, and one BPP
run (3 iterations) and one MU run under torch.profiler.

    python3 chip_smoke.py --ell

runs only ell_spmm: phase 12 above, then its launch plan against
ELL_VARIANTS of it (rows sharing a warp or not, other chain lengths for
long rows, no split, and a warp's broadcast walk in place of groups of
lanes at k = 8 and 16) at the sparse hierclust root's EllAOp products,
each variant launched from descriptors of its own and timed alone on the
device and back to back.

    python3 chip_smoke.py --k2

runs only the K2 study: a cluster barrier's and a DSMEM load's latency,
cudaOccupancyMaxActiveClusters, the phase split of one step from a build
with per-CTA stamps at 256 x 256 (f32 and bf16 A), 888 and 992, the
wrapper's host cost, and the flatclust HALS path under torch.profiler.

    python3 chip_smoke.py --cols

runs only the sparse hierclust operand study: at k = 2 on the 50,000 x
1,000,000 corpus, the root's EllAOp and its static operand (beside the
torch-ops formulation, torch.sparse.mm and index_add_), the static operand
against the masked view of the root at shares 1/8 to 7/8 of the documents,
the chunk length sweep (product ms, padding, table bytes at L0 = 16 to
128) and sparse hierclust's wall at L0 = 32, 64 and 128.

    python3 chip_smoke.py --sparse-chain

runs only phase 21b, with the busy shares of its runs from a profile of
the sparse cell on each engine in a process of its own (`--loop-busy
sparse`).

    python3 chip_smoke.py --cg

runs only the GJ/CG crossover: one full-width pivot round through K1 and
through the CG tier (cold and warm-started), k = 32..128, n = 12,411,
50,000 and 1,000,000.

    python3 chip_smoke.py --bpp

runs only the captured BPP step's phases: 6 (the main path at k = 8),
18 (k = 160, the CG tier) and --loop's BPP sweep (k = 8 to 160 and the
short solve, eager against captured).

    python3 chip_smoke.py --facade

runs only phases 16, 17 and the CLI chain of 19, with the flagship's MU
factors made on their own.

    python3 chip_smoke.py --loop

runs only the U sweep of the solve loop: flatclust HALS, Reuters
hierclust, sparse hierclust, Reuters BPP at 100 iterations and to a tol,
and three MU solves that converge (the main path's operand at k = 8, the
flagship's at k = 16 and 128), eager at U = 1 and with one step replayed
U times at U = 2, 4, 8, 16, 32 (what solvers/solve.AUTO_UNROLL and
MU_ONE_STEP_ENTRIES are set from); then Reuters BPP at k = 8 to 160,
eager at U = 1 and captured at BPP's auto U, with each graph's nodes,
capture and instantiation ms and memory (what graph.bpp_captures's rule
is set from), and the short solve: BPP at k = 16, 10 iterations, on the
50,000 x 40,000 EllAOp (phase 23b's), eager against captured.

    python3 chip_smoke.py --slice

runs only phases 21-23 (the chain phases' busy shares not measured).

    python3 chip_smoke.py --ladder

sweeps the bucket ladders of LADDERS under the chain at the Reuters shape,
each run twice in turns (what the hierclust.BUCKET_* constants are set
from).

    python3 chip_smoke.py --mesh

runs only phase 23b (the sharded solve), after the build.

    python3 chip_smoke.py --graph

runs only phase 23c (graph community detection), after the build, then
the device's busy share of its cells from profiles (one community seed at
restarts 3 and 1, one north-star run).

    python3 chip_smoke.py --k3

runs only K3's checks and times (phase 9 and phase 23c (a)), after the
build: the kernels' registers, shared memory and spills, the misaligned
view and the exact widths, and both products at every factor row count at
the roots.

    python3 chip_smoke.py --pair DIR

times K2, P1, P2, the flatclust HALS path, the Reuters BPP path, the
flagship (products, MU, BPP) and sparse hierclust at 50,000 x 1,000,000
(the k = 2 products at the root's static operand, at its EllAOp and at a
1/8 node, and the clustering's wall) with the
package of an archived tree at DIR and of this one, in the order DIR,
this, this, DIR, each in a process of its own (`--times TREE`), and
fails unless the flagship's products are bit-equal and every sparse
hierclust run has 12 leaves.

There is no CPU fallback: without a card the script exits 1.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# kernel vs plain version on the card; the plain version runs the same
# ops in the same order, so these bound only rounding-mode differences
TOL = {"float32": 1e-5, "float64": 1e-10}
K1_SHAPES = [(8, 7984), (8, 12411), (16, 7984), (32, 2000), (64, 500),
             (128, 130)]
MAIN_SHAPES = [(8, 7984), (8, 12411)]  # H side (n = docs), W side (n = terms)
# nnls_blockpivot with narrowed and with full-width rounds (--k1)
NNLS_SWEEP_K, NNLS_SWEEP_N = (8, 16, 32, 48, 128), (
    2048, 12411, 65536, 262144, 1_000_000)
K1_SWEEP_K, K1_SWEEP_N = (8, 16, 32, 48, 64, 96, 128), 65536  # narrow vs wide
SLICE_ATOL = 1e-9
NNLS_SHAPE = (48, 2048)   # nnls_blockpivot, narrowed rounds, card vs CPU
M, N, K, NZ_PER_COL, ITERS = 12411, 7984, 8, 80, 100

# K2 against its plain version, evaluated in f64 on the same inputs, with
# the reference's Pallas-vs-XLA tolerances (tests/test_solvers.py:720-727):
# W, H, gradW, gradH, HH', AH'.  The plain version in f32 misses these
# tolerances itself at 256 x 256 and above (the step is a chain of
# cancellations; its distance to f64 is printed beside the kernel's), so
# the kernel sums in f64 and is held against the f64 evaluation.
K2_OUTPUTS = ("W", "H", "gradW", "gradH", "HHt", "AHt")
K2_TOL = [dict(rtol=2e-5, atol=2e-6)] * 2 + [dict(rtol=2e-4, atol=2e-5)] * 2 \
    + [dict(rtol=2e-5, atol=2e-6)] * 2
FLAT_M, FLAT_N, FLAT_K = 256, 256, 16   # the reference's flatclust config
FLAT_ITERS = 2000

# K3 against its plain version: max |kernel - plain| / max |plain|.  Both
# sum in f32, in other orders; the 200-iteration loop compounds them.
K3_TOL = {"product": 2e-5, "loop": 1e-4}
P3_SHAPES = [(12411, 512, "bfloat16"), (12411, 512, "float32"),
             (20000, 512, "bfloat16"), (12411, 2048, "bfloat16")]
K3_RAGGED = [(1, 1, "float32"), (100, 3, "bfloat16"), (257, 130, "float32"),
             (257, 130, "bfloat16"), (4097, 33, "bfloat16")]
# K3's device kernels by name, for its share of a profile's device time
K3_KERNELS = ("wt_a_kernel", "h_at_kernel", "split_sum_kernel")
# a view one element past an aligned allocation (rows not 16-byte aligned:
# the kernels' scalar path), at a bucket width
K3_VIEW = (3000, 1024)
# exact widths whose rows are not 16-byte aligned (the scalar path, each
# row at its own offset), the widest below each cell's root: the community
# cell's f32, the Reuters hierclust bf16 and the north star's e4m3.  A node
# of such a width, past the bucket ladder, is gathered at whole 16-byte rows
# (engines/hierclust.py row_width); a root of it would take this path.
K3_EXACT = {"float32": (3000, 2999), "bfloat16": (12411, 7983),
            "float8_e4m3fn": (20000, 19999)}
HIER_M, HIER_N, HIER_TOPICS, HIER_K = 12411, 7984, 16, 12  # bench.py:60-79
# phase graph (bench.py:218-302): K3 over R lanes (2R factor rows) at
# GRAPH_LANES, at the two graph roots and ragged shapes; the community cell
# (nodes, communities, generator seed), its engine seeds and the repo's
# NMI targets (ROUND_NOTES.md:345-349); the north-star cell (nodes,
# communities, generator seed), its NMI gate and the numpy oracle's NMI
# (bench.py:31); the CLI's engine seed; the f64 lane check's lanes
GRAPH_LANES = (1, 2, 3, 4, 8)
GRAPH_K3_SHAPES = ((20000, 20000, "float8_e4m3fn"), (3000, 3000, "float32"))
GRAPH_K3_RAGGED = ((257, 130, "float32"), (100, 3, "bfloat16"),
                   (3001, 2999, "float8_e4m3fn"))
# bucket-width node operands of the two graph cells (hierclust's ladder):
# ((m, w, A dtype), lanes)
GRAPH_K3_NODES = (((3000, 1024, "float32"), 3),
                  ((20000, 4096, "float8_e4m3fn"), 1))
GRAPH_COMM, GRAPH_SEEDS = (3000, 20, 7), (3, 4, 5, 6, 7)
GRAPH_NMI_MEDIAN, GRAPH_NMI_WORST = 0.85, 0.6
GRAPH_STAR, GRAPH_STAR_NMI, GRAPH_ORACLE_NMI = (20000, 100, 17), 0.95, 0.991
GRAPH_CLI_SEED, GRAPH_F64_LANES = 3, 3
HIER_NMI_MARGIN = 0.05   # f32 card run's NMI may trail the CPU run's by this
HIER_PRIORITY_TOL = 1e-10

# ell_spmm against its plain version: max |kernel - plain| / max |plain|.
# f32 sums of up to 128 terms in other orders; f64 the same sums.
ELL_TOL = {"float32": 2e-5, "float64": 1e-12}
# seg_spmm against its plain version (evaluated in f64), each output entry
# relative to its own sum of |val * table| (within_rows grows the f32 value
# with the entry's segment).  Each case runs both passes: the term pass on
# (capacity, live entries, keys, k, table rows, a share of the live entries
# on one key) and the chunk pass on (keys slots, chunks of L0 entries
# filling about the capacity):
# (capacity, live entries, keys, k, table rows, heavy share, L0)
SEG_TOL = {"float32": 2e-5, "float64": 1e-12}
SEG_CASES = [(40, 33, 7, 2, 9, 0.0, 4), (5000, 4999, 40, 3, 400, 0.8, 8),
             (1 << 16, 60_000, 3000, 2, 50_000, 0.0, 32),
             (1 << 20, 1_000_000, 50_000, 2, 1_000_000, 0.6, 128),
             (20_000, 19_000, 800, 8, 5000, 0.3, 4),
             (3000, 2000, 100, 1, 700, 0.0, 16),
             (1 << 22, 4_000_000, 50_000, 2, 200_000, 0.9, 128)]
# what a device trace's seg_spmm kernels have in their names
SEG_KERNEL = "::seg_"
SEG_PAIRS = (("float32", "float32"), ("bfloat16", "float32"),
             ("float8_e4m3fn", "float32"), ("float64", "float64"))
# (G, L, B, k, vals, table) of the probes the kernel replaces:
# P1 scripts/tpu_batch29.py:38-45, P2 scripts/tpu_batch33.py:27-29, 56-58
ELL_PROBES = {"P1": (8192, 128, 8192, 128, "float32", "bfloat16"),
              "P2": (65536, 128, 8192, 128, "float32", "float32")}
# ragged buckets with sentinels scattered through them, every dtype pair
ELL_RAGGED = [(1, 1, 1, 1, "float32", "float32"),
              (37, 5, 50, 2, "bfloat16", "float32"),
              (1000, 33, 4097, 8, "float32", "bfloat16"),
              (513, 80, 20000, 128, "bfloat16", "float32"),
              (300, 17, 999, 130, "float32", "float32"),
              (777, 40, 5000, 128, "float64", "float64"),
              (100, 9, 300, 3, "float64", "float64")]
# the narrow-k and long-row plans (kernels/ell_spmm.launch_plan): every
# k of ELL_NARROW_K at every bucket length of ELL_NARROW_L, g rows of
# skewed lengths (row 0 full, the others L u^3) over B table rows, every
# dtype pair; held against the plain version evaluated in f64
ELL_NARROW_K = (1, 2, 3, 8, 16, 128)
ELL_NARROW_L = {8: 5000, 100: 2000, 1024: 1024, 4096: 256, 32768: 32,
                131072: 8}  # L -> g
ELL_NARROW_B = 50_000
ELL_PAIRS = (("float32", "float32"), ("bfloat16", "float32"),
             ("float32", "bfloat16"), ("float64", "float64"))
# --ell: the launch plan (kernels/ell_spmm.launch_plan) against what it
# was chosen over, per k of the sparse hierclust root's products
ELL_VARIANTS = {2: ("plan", "a warp a row", "chain 64", "chain 128",
                    "chain 256", "no split"),
                8: ("plan", "warp broadcast"),
                16: ("plan", "warp broadcast")}
SP_M, SP_N, SP_K = 600, 3000, 8        # f64 sparse parity, blocked EllAOp
# the flagship: rank-128 NMF on a 50,000-term x 1,000,000-document corpus
# with 80 draws per column, bf16 A, f32 factors (bench.py:164-195), uncut
FLAG_M, FLAG_N, FLAG_K, FLAG_NZ = 50_000, 1_000_000, 128, 80
# two-point fits; BPP's first iteration (every entry passive, some twenty
# pivot rounds) is run and reported on its own, and its fit spans twenty
# steady iterations
FLAG_MU_ITERS, FLAG_BPP_ITERS = (5, 25), (3, 23)
FLAG_K1_CHECK = 65536   # columns of a full-width K1 round held to plain
# the flagship BPP run recorded before W'A was written transposed
# (PERF.md), which bit-equal products reproduce: iterations
# -> ((pivot rounds, K1 launches, K1 columns), relative error)
RECORDED_BPP = {1: ((21, 23, 6983098), 0.999090),
                3: ((41, 47, 14706625), 0.998719),
                23: ((181, 227, 61684791), 0.998003)}
DOC_BLOCKS = (0, 32768, 65536, 131072)           # the --sparse sweep
CLI_M, CLI_N, CLI_NZ = 30000, 20000, 80   # f32 dense image 2.4 GB > 2 GiB

# sparse hierclust at the flagship's size: a planted term-doc corpus of
# 50,000 terms and 1,000,000 documents (bf16 dense image 100 GB, so sparse
# on its own), HIER_TOPICS planted topics, seed 11; a node of 1/SPH_NODE of
# the documents is timed beside the root
SPH_M, SPH_N, SPH_TOPICS, SPH_NODE = 50_000, 1_000_000, 16, 8
# --cols: shares of the documents at which the static operand is set
# against the masked view of the root, the chunk lengths swept at the root
# and a node, and those at which sparse hierclust's wall is taken
CUT_SHARES = (1 / 8, 1 / 4, 1 / 2, 3 / 4, 7 / 8)
COLS_L0 = (16, 32, 64, 128)
COLS_L0_WALL = (32, 64, 128)
# sparse against dense: 50,000 x 40,000 (bf16 image 4 GB, sparse on its
# own; dense it fits the card); the f64 initdir comparison at
# SVD_INITDIR_K clusters reads at most SVD_INIT_FILES initializer pairs
SVD_N, SVD_INITDIR_K, SVD_INIT_FILES = 40_000, 6, 40
# BPP past the GJ kernel's rank limit (the CG tier) on the main path's
# operand; its f64 card-vs-CPU check on a slice, to the CPU tests'
# tolerance (tests/test_torch_nnls.py: forced-CG BPP against the JAX
# package)
BPP_WIDE_K, BPP_WIDE_ITERS, BPP_WIDE_SLICE = 160, 10, (2000, 1500)
BPP_CG_RTOL = 1e-8
# --cg: the GJ/CG crossover grid
CG_SWEEP_K, CG_SWEEP_N = (32, 64, 96, 128), (12411, 50_000, 1_000_000)
# the facade phase: the facade's and the API's seeds; api.Hierclust's
# NMI on the sparse corpus (f32 A, min_iter 5) against the sparse
# hierclust phase's run (bf16 A, min_iter 1) with the same seed; the
# embedding queries of each kind, their top-k, the f64 score gap within
# which two indices may trade places, and the values' relative tolerance
FACADE_SEED, FACADE_NMI_MARGIN = 7, 0.01
TRACE_CALLS = 20   # K1 calls inside profiling.device_trace
EMB_QUERIES, EMB_TOPK, EMB_TIE, EMB_RTOL = 64, 10, 1e-6, 1e-5

# the loop phase: each cell run eagerly and captured (solvers/graph.CAPTURE)
# in turns; --loop sweeps U over LOOP_UNROLLS; sparse hierclust's NMI on
# the planted corpus (PERF.md)
LOOP_ORDER = (False, True, True, False)
LOOP_UNROLLS = (1, 2, 4, 8, 16, 32)
# the --loop sweep's MU cells and its Reuters BPP cell to a tol converge
# after these many iterations; its BPP ranks (graph.bpp_captures's sweep;
# 160 the CG tier's)
LOOP_MU_FIXED = 91
LOOP_BPP_FIXED = 91
LOOP_BPP_KS = (8, 16, 32, 64, 128, 160)
SPH_NMI = 0.912

# the chain phase (engines/hier_chain.py): Reuters hierclust on the
# sequential engine capturing a graph a solve (PR 10's loop, at bucket
# widths), the sequential engine keeping a graph a bucket width, and the
# chain (the default, which keeps them too), in the order CHAIN_ORDER; the
# NMI the sequential engine gave that run before the chain (PERF.md) and
# the margin the chain's keeps to it; the f64 dense problem (m, n,
# clusters, corpus seed) on which the engines' trees must be identical
CHAIN_MODES = {"sequential": {"CHAIN": False, "KEEP_GRAPHS": False},
               "sequential, kept graphs": {"CHAIN": False,
                                           "KEEP_GRAPHS": True},
               "chain": {"CHAIN": True, "KEEP_GRAPHS": True}}
CHAIN_ORDER = ("sequential", "sequential, kept graphs", "chain", "chain",
               "sequential, kept graphs", "sequential")
HIER_NMI, CHAIN_NMI_MARGIN = 0.9322, 0.005
CHAIN_F64 = (2000, 3000, 12, 7)
# the sparse chain phase: the sparse hierclust cell (50,000 x 1,000,000,
# host_A given) on each engine of CHAIN_MODES in the order CHAIN_ORDER, on
# the static operand, whose NMI must reach SPARSE_CHAIN_NMI (0.9120
# measured, PERF.md); the f64 sparse problem (m, n, clusters, corpus seed)
# on which the engines must give one tree too
SPARSE_CHAIN_NMI = 0.91
SPARSE_F64 = (2000, 6000, 12, 7)
# --ladder: these bucket ladders (BUCKET_MIN, BUCKET_POW2_MAX, BUCKET_STEP)
LADDERS = ((512, 4096, 2048), (512, 1 << 20, 1), (1024, 4096, 1024),
           (256, 4096, 2048), (512, 2048, 1024))

# phase mesh (the sharded solve, smallk_torch/parallel): leg (b)'s f64
# problem is the chain's CHAIN_F64 corpus, its factor starts from numpy's
# generator at MESH_SEED, MESH_ITERS fixed iterations at k = MESH_K (RANK2
# 2) within MESH_TOL of the one-rank run (tests/test_parallel.py's
# tolerances), and a MESH_HIER_K-cluster tree (node solves capped at
# MESH_HIER_MAX_ITER steps); MESH_ELL: leg (a)'s sparse EllAOp (m, n, k,
# BPP iterations); MESH_TIMEOUT: seconds for a world of ranks
MESH_SEED, MESH_K, MESH_ITERS, MESH_HIER_K = 5, 8, 30, 8
MESH_HIER_MAX_ITER = 200
MESH_TOL = dict(rtol=1e-10, atol=1e-12)
MESH_ELL = (SPH_M, SVD_N, 16, 10)
MESH_TIMEOUT = 300
MESH_CALLS = 500   # collectives timed back to back

# H100 SXM data sheet: f32 outside the tensor cores, HBM3 bandwidth
F32_FLOPS, HBM_BYTES_PER_S = 67e12, 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, iters: int, queued: bool = True) -> float:
    """Device time of one fn() call in ms, with the host out of the way.

    fn is captured once in a CUDA graph, so a call is one launch however
    many kernels it runs; `iters` replays are queued behind a sleep kernel,
    and the events around them time the device alone.  The run fails if
    the sleep ended before the last replay was queued.

    A graph of ~1000 kernels (a 200-iteration loop) fills the device's
    launch queue behind the sleep, so the host cannot queue it all; with
    `queued=False` the replays run back to back instead, which times the
    device when a replay's device time exceeds its host cost.
    """
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch asks
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    replays = back_to_back_ms(graph.replay, iters)
    if not queued:
        return replays
    sleep_s = replays * iters / 1e3 * 2 + 0.01
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    for _ in range(4):
        torch.cuda._sleep(int(sleep_s * 2e9))  # cycles; the clock is < 2 GHz
        start.record()
        for _ in range(iters):
            graph.replay()
        stop.record()
        held = not start.query()  # still sleeping once all are queued
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(stop) / iters
        sleep_s *= 4
    raise RuntimeError("the sleep never outlasted the host's enqueue")


def back_to_back_ms(fn, iters: int) -> float:
    """Per-call time of `iters` calls issued back to back (CUDA events),
    the host's launch cost included, as a caller that waits on nothing
    sees it."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound(flop: float, nbytes: float) -> tuple[float, str]:
    """The least time (ms) the card could take for `flop` f32 operations
    on `nbytes` bytes moved, and which of the two bounds it."""
    t_ops, t_bytes = flop / F32_FLOPS, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def reset_counts() -> None:
    """Every kernel's launch count, the product branch counts and the solve
    loop's counts (steps run, host reads, frozen steps, solves, graphs
    captured and replayed) and the CG tier's to 0, just before a path is
    driven."""
    from smallk_torch.kernels import (ell_spmm, hals_step, masked_gj,
                                      rank2_loop, seg_spmm)
    from smallk_torch.ops import aop
    from smallk_torch.solvers import bpp, graph, nnls, solve

    nnls.cg_solves = nnls.cg_steps = 0
    seg_spmm.launches = seg_spmm.plain_cuda_calls = 0
    masked_gj.launches = 0
    masked_gj.columns = 0
    hals_step.launches = 0
    rank2_loop.launches = rank2_loop.lane_launches = 0
    ell_spmm.launches = 0
    ell_spmm.transposed_launches = 0
    ell_spmm.plain_cuda_calls = 0
    aop.kernel_products = 0
    aop.matmul_products = 0
    solve.steps_run = solve.host_reads = solve.frozen_steps = 0
    solve.solves = 0
    bpp.reset_rounds_run()
    graph.captures = graph.replays = 0
    graph.capture_seconds = graph.replay_seconds = 0.0


def read_counts() -> dict:
    """Launches of K1, K2, K3 (and K3's of lanes, more than 2 rows),
    ell_spmm (and ell_spmm's transposed ones) and seg_spmm, the columns
    K1 solved, ell_spmm's and seg_spmm's plain-version calls on CUDA
    tensors, the dense products that went to K3 and to torch.matmul, and
    the solve loop's counts (BPP's pivot rounds run among them) and the CG
    tier's solves and steps, since the last reset_counts().  Launches
    replayed from a CUDA graph count once a replay, and those in its WHILE
    bodies once a trip (solvers/graph.py)."""
    from smallk_torch.kernels import (ell_spmm, hals_step, masked_gj,
                                      rank2_loop, seg_spmm)
    from smallk_torch.ops import aop
    from smallk_torch.solvers import bpp, graph, nnls, solve

    return {"K1": masked_gj.launches, "K1_columns": masked_gj.columns,
            "cg_solves": nnls.cg_solves, "cg_steps": nnls.cg_steps,
            "K2": hals_step.launches,
            "K3": rank2_loop.launches,
            "K3_lanes": rank2_loop.lane_launches,
            "ell_spmm": ell_spmm.launches,
            "ell_spmm_transposed": ell_spmm.transposed_launches,
            "ell_plain_cuda": ell_spmm.plain_cuda_calls,
            "seg_spmm": seg_spmm.launches,
            "seg_plain_cuda": seg_spmm.plain_cuda_calls,
            "kernel_products": aop.kernel_products,
            "matmul_products": aop.matmul_products,
            "steps": solve.steps_run, "host_reads": solve.host_reads,
            "frozen": solve.frozen_steps, "solves": solve.solves,
            "rounds_run": bpp.rounds_run(),
            "captures": graph.captures, "replays": graph.replays}


def k1_gate(counts: dict) -> bool:
    """K1 launches exactly 2 a BPP step run (its two NNLS problems' first
    solves) and one a pivot round run, frozen steps' too."""
    return counts["K1"] == 2 * counts["steps"] + counts["rounds_run"]


def cg_gate(counts: dict) -> bool:
    """Above K1's rank limit: no K1 launch, and CG solves exactly 2 a BPP
    step run and one a pivot round run, frozen steps' too."""
    return counts["K1"] == 0 and counts["cg_solves"] == (
        2 * counts["steps"] + counts["rounds_run"])


def k3_want(counts: dict) -> tuple[int, int]:
    """(K3 launches, products through K3) that a dense hierclust run must
    count: two products a step run (frozen steps too) and W'A once a
    solve, one launch a product."""
    want = 2 * counts["steps"] + counts["solves"]
    return want, want


def graph_seconds() -> tuple[float, float]:
    """The host's seconds in graph captures (with instantiation) and in
    replay calls since the last reset_counts()."""
    from smallk_torch.solvers import graph

    return graph.capture_seconds, graph.replay_seconds


def k1_inputs(k: int, n: int, dtype, device):
    """As the reference's kernel parity test makes them."""
    import torch

    rng = np.random.RandomState(k)
    B = rng.rand(k, 2 * k)
    LHS = B @ B.T + 0.1 * np.eye(k)
    RHS = B @ rng.rand(2 * k, n)
    passive = rng.rand(k, n) > 0.6
    return (torch.tensor(LHS, dtype=dtype, device=device),
            torch.tensor(RHS, dtype=dtype, device=device),
            torch.tensor(passive, device=device))


def dead_pivot_inputs(dtype, device):
    """A dead topic: column 3 of W is zero, so the Gram's diagonal is ~0."""
    import torch

    k, n = 16, 64
    rng = np.random.RandomState(0)
    W = rng.rand(3 * k, k)
    W[:, 3] = 0.0
    return (torch.tensor(W.T @ W, dtype=dtype, device=device),
            torch.tensor(W.T @ rng.rand(3 * k, n), dtype=dtype,
                         device=device),
            torch.ones((k, n), dtype=torch.bool, device=device))


def phase_build() -> None:
    from smallk_torch.kernels import _build

    t0 = time.perf_counter()
    names = sorted(_build.SIGNATURES)
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per library
        paths = list(pool.map(_build.build, names))
    for name in names:
        _build.load_library(name)
    secs = time.perf_counter() - t0
    log(f"[build] {', '.join(str(p.relative_to(ROOT)) for p in paths)} "
        f"in {secs:.2f} s")


def nonfinite_inputs(dtype, device):
    """Right-hand sides that are not finite: an Inf on a non-passive row of
    column 2 (rhs * 0 = NaN poisons the column in the plain version) and a
    NaN on a passive row of column 5."""
    LHS, RHS, passive = k1_inputs(64, 40, dtype, device)
    passive[4, 2], passive[7, 5] = False, True
    RHS[4, 2], RHS[7, 5] = float("inf"), float("nan")
    return LHS, RHS, passive


def k1_sweep() -> None:
    """The two device kernels side by side in f32, at every K1_SHAPES entry
    and at K1_SWEEP_N columns of the same ranks: what WIDE_MIN_K is set
    from."""
    import torch

    from smallk_torch.kernels import masked_gj

    for k, n in K1_SHAPES + [(k, K1_SWEEP_N) for k in K1_SWEEP_K]:
        LHS, RHS, passive = k1_inputs(k, n, torch.float32, "cuda")
        iters = 100 if k * k * n < 1 << 26 else 5
        narrow = device_ms(lambda: masked_gj._launch_narrow(
            LHS, RHS, passive), iters)
        wide = device_ms(lambda: masked_gj._launch_wide(
            LHS, RHS, passive), iters)
        picked = "wide" if k >= masked_gj.WIDE_MIN_K else "narrow"
        log(f"[K1 sweep f32] k={k} n={n}: device ms per call: narrow "
            f"{narrow:.4f}, wide {wide:.4f}; masked_gj_solve takes the "
            f"{picked} one (WIDE_MIN_K = {masked_gj.WIDE_MIN_K})")


def phase_kernel() -> dict:
    import torch

    from smallk_torch.kernels import masked_gj
    from smallk_torch.kernels.masked_gj import (
        masked_gj_solve, masked_gj_solve_reference)

    # both device kernels and the wrapper's pick against the plain version:
    # the same operations in the same order with the same roundings, so on
    # finite inputs the tolerance is 0
    kernels = (("narrow", masked_gj._launch_narrow),
               ("wide", masked_gj._launch_wide),
               ("masked_gj_solve", masked_gj_solve))
    worst = 0.0
    for name in TOL:
        dtype = getattr(torch, name)
        cases = [(f"k={k} n={n}", k1_inputs(k, n, dtype, "cuda"))
                 for k, n in K1_SHAPES]
        cases.append(("dead-pivot k=16 n=64", dead_pivot_inputs(dtype,
                                                                 "cuda")))
        for label, (LHS, RHS, passive) in cases:
            Xr = masked_gj_solve_reference(LHS, RHS, passive)
            errs = {}
            for which, solve in kernels:
                X = solve(LHS, RHS, passive)
                torch.cuda.synchronize()
                errs[which] = float((X - Xr).abs().max())
                if label.startswith("dead"):
                    if not bool(torch.isfinite(X).all()):
                        raise AssertionError("dead-pivot solve is not finite")
                    torch.testing.assert_close(X[3], torch.zeros_like(X[3]),
                                               rtol=0, atol=TOL[name])
            log(f"[K1 {name}] {label}: max|kernel - plain|: " + ", ".join(
                f"{w} {e:.3e}" for w, e in errs.items()) + " (tolerance 0)")
            if any(e != 0.0 for e in errs.values()):
                raise AssertionError(f"K1 {name} {label}: a kernel differs "
                                     f"from the plain version: {errs}")
            worst = max(worst, *errs.values())

        # non-finite right-hand sides: every column that is not finite in
        # the plain version is not finite in the kernels, the others equal
        LHS, RHS, passive = nonfinite_inputs(dtype, "cuda")
        Xr = masked_gj_solve_reference(LHS, RHS, passive)
        bad = ~torch.isfinite(Xr).all(dim=0)
        for which, solve in kernels:
            X = solve(LHS, RHS, passive)
            bad_k = ~torch.isfinite(X).all(dim=0)
            err = float((X[:, ~bad] - Xr[:, ~bad]).abs().max())
            log(f"[K1 {name}] non-finite rhs, {which}: non-finite columns "
                f"plain {bad.nonzero()[:, 0].tolist()}, kernel "
                f"{bad_k.nonzero()[:, 0].tolist()}; the others differ by "
                f"{err:.3e}")
            if not bool((bad_k | ~bad).all()) or bad.sum() != 2 or err:
                raise AssertionError(f"K1 {name} {which}: non-finite "
                                     "columns are not kept")
        # a NaN in LHS: tiny is NaN and every pivot dead, in all of them
        LHS = LHS.clone()
        LHS[3, 6] = float("nan")
        Xr = masked_gj_solve_reference(LHS, RHS[:, ~bad].contiguous(),
                                       passive[:, ~bad].contiguous())
        for which, solve in kernels:
            X = solve(LHS, RHS[:, ~bad].contiguous(),
                      passive[:, ~bad].contiguous())
            if not torch.equal(X, Xr):
                raise AssertionError(f"K1 {name} {which}: NaN in LHS")
    k1_sweep()

    times = {}
    for k, n in MAIN_SHAPES:
        LHS, RHS, passive = k1_inputs(k, n, torch.float32, "cuda")
        def kernel():
            return masked_gj_solve(LHS, RHS, passive)

        def plain_version():
            return masked_gj_solve_reference(LHS, RHS, passive)

        ms, plain = device_ms(kernel, 100), device_ms(plain_version, 20)
        ms_host = back_to_back_ms(kernel, 200)
        plain_host = back_to_back_ms(plain_version, 50)
        # the library call: one batched torch.linalg.solve_ex of the (n, k,
        # k) masked systems, built beforehand and not timed
        p = passive.to(LHS.dtype).T                       # (n, k)
        M = (LHS[None] * (p[:, :, None] * p[:, None, :])
             + torch.diag_embed(1.0 - p))
        b = (RHS.T * p)[:, :, None]
        X = kernel()
        lib_rel = float((torch.linalg.solve_ex(M, b)[0][:, :, 0].T - X)
                        .abs().max() / X.abs().max())
        if not lib_rel <= 1e-3:  # the same function, solved another way
            raise AssertionError(f"K1 library solve differs by {lib_rel}")
        library = device_ms(lambda: torch.linalg.solve_ex(M, b), 50)
        lib_host = back_to_back_ms(lambda: torch.linalg.solve_ex(M, b), 50)
        times[(k, n)] = (ms, plain, library, *k1_bound(passive))
        log(f"[K1 time f32] k={k} n={n}: device ms per call: kernel "
            f"{ms:.4f}, plain {plain:.4f}, library torch.linalg.solve_ex on "
            f"the (n, k, k) batch {library:.4f} (max rel diff "
            f"{lib_rel:.1e}); back-to-back with host launch cost: kernel "
            f"{ms_host:.4f}, plain {plain_host:.4f}, library {lib_host:.4f}; "
            f"bound {times[(k, n)][3]:.6f} ms ({times[(k, n)][4]})")
    return {"max_abs_err": worst, "times": times}


def k1_bound(passive) -> tuple[float, str]:
    """K1's bound for an f32 solve with this (k, n) passive set: what these
    inputs need is a Gauss-Jordan on each column's q x (q+1) passive system
    that touches only the columns beyond the pivot (step j of q: q - j
    divisions and a multiply and a subtract on (q-1)(q-j) entries, in all
    q (q+1)/2 (2q-1) operations), and each input and output moved once."""
    k, n = passive.shape
    q = passive.sum(dim=0).double()
    flop = float((q * (q + 1) / 2 * (2 * q - 1)).sum())
    return bound(flop, 4 * k * k + (4 + 1 + 4) * k * n)


def k2_inputs(m: int, n: int, k: int, a_dtype, rescue: bool = False):
    """As the reference's kernel parity test makes them; `rescue` zeroes W's
    column 3 and makes its AH' column negative, so that the sweep drives
    it to all zeros and the eps fill takes over."""
    import torch

    from smallk_torch.ops.aop import DenseAOp
    from smallk_torch.solvers import hals

    rs = np.random.RandomState(0)
    A = torch.tensor(rs.rand(m, n).astype(np.float32), device="cuda")
    A = A.to(a_dtype)
    W = torch.tensor(rs.rand(m, k).astype(np.float32), device="cuda")
    H = torch.tensor(rs.rand(k, n).astype(np.float32), device="cuda")
    HHt, AHt = hals.init(DenseAOp(A), W, H)
    if rescue:
        W[:, 3] = 0.0
        AHt[:, 3] = -1.0
    return A, W, H, HHt, AHt


def phase_k2() -> dict:
    import torch

    from smallk_torch.kernels import hals_step as k2

    side = max(s for s in range(1, 2048) if k2.hals_fits(s, s, FLAT_K))
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [((256, 256, 16), f32, False), ((256, 256, 16), bf16, False),
             ((96, 80, 8), f32, False), ((200, 130, 5), f32, False),
             ((side, side, FLAT_K), f32, False),
             ((side, side, FLAT_K), bf16, False),
             ((96, 80, 8), f32, True)]
    worst = 0.0
    for (m, n, k), a_dtype, rescue in cases:
        label = (f"m={m} n={n} k={k} A {str(a_dtype)[6:]}"
                 + (" zero-column rescue" if rescue else ""))
        args = k2_inputs(m, n, k, a_dtype, rescue)
        before = k2.launches
        out = k2.hals_step(*args)
        plain64 = k2.hals_step_reference(*(t.double() for t in args))
        plain32 = k2.hals_step_reference(*args)
        torch.cuda.synchronize()
        if k2.launches != before + 1:
            raise AssertionError("hals_step did not launch its kernel")
        errs = [float((a.double() - b).abs().max())
                for a, b in zip(out[:6], plain64[:6])]
        errs32 = [float((a.double() - b).abs().max())
                  for a, b in zip(plain32[:6], plain64[:6])]
        log(f"[K2] {label}: max|kernel - plain f64|: " + ", ".join(
            f"{o} {e:.2e}" for o, e in zip(K2_OUTPUTS, errs)))
        log(f"[K2] {label}: max|plain f32 - plain f64|: " + ", ".join(
            f"{o} {e:.2e}" for o, e in zip(K2_OUTPUTS, errs32)))
        for name, a, b, tol in zip(K2_OUTPUTS, out[:6], plain64[:6], K2_TOL):
            torch.testing.assert_close(a, b.float(), **tol,
                                       msg=lambda m, name=name: f"{name}: {m}")
        if not (bool(out[6]) and bool(plain64[6])):
            raise AssertionError(f"K2 {label}: a gradient is not finite")
        if rescue:
            col = out[0][:, 3]
            if not bool(torch.isfinite(col).all()) or bool((col < 0).any()):
                raise AssertionError("rescued column is not finite and >= 0")
        worst = max(worst, *errs)
    log(f"[K2] tolerances (rtol, atol): W, H, HHt, AHt (2e-5, 2e-6); gradW, "
        f"gradH (2e-4, 2e-5); largest square shape at k={FLAT_K}: {side}")

    args = k2_inputs(FLAT_M, FLAT_N, FLAT_K, f32)

    def kernel():
        return k2.hals_step(*args)

    def plain_version():
        return k2.hals_step_reference(*args)

    ms, plain = device_ms(kernel, 200), device_ms(plain_version, 20)
    ms_host = back_to_back_ms(kernel, 500)
    plain_host = back_to_back_ms(plain_version, 50)
    # one HALS step: W'A and AH' (2 m n k each), W'W, HH', the two sweeps
    # and the gradients (2 k^2 (3 m + 3 n)); inputs A, W, H, HH', AH' and
    # the six outputs moved once.  No single PyTorch call computes a step.
    m, n, k = FLAT_M, FLAT_N, FLAT_K
    flop = 4 * m * n * k + 2 * k * k * (3 * m + 3 * n)
    nbytes = 4 * (m * n + 2 * (2 * m * k + 2 * k * n + k * k))
    bound_ms, bound_by = bound(flop, nbytes)
    log(f"[K2 time f32] m={FLAT_M} n={FLAT_N} k={FLAT_K}: device ms per "
        f"call: kernel {ms:.4f}, plain {plain:.4f}; back-to-back with host "
        f"launch cost: kernel {ms_host:.4f}, plain {plain_host:.4f}; bound "
        f"{bound_ms:.6f} ms ({bound_by}); no library call computes a step")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_slice_parity() -> None:
    from smallk_torch import (NmfAlgorithm, NmfOptions, NmfStats, Random,
                              random_matrix)
    from smallk_torch.engines.nmf import run_nmf
    from smallk_torch.kernels import hals_step, masked_gj

    m, n = 300, 200
    for algorithm, k in ((NmfAlgorithm.BPP, 8), (NmfAlgorithm.MU, 8),
                         (NmfAlgorithm.HALS, 8), (NmfAlgorithm.RANK2, 2)):
        rng = Random(7)
        A = rng.uniform((m, n))
        W0 = random_matrix(m, k, rng)
        H0 = random_matrix(k, n, rng)
        opts = NmfOptions(tol=1e-30, algorithm=algorithm, height=m, width=n,
                          k=k, min_iter=1, max_iter=30, verbose=False,
                          dtype="float64")
        runs = {}
        for device in ("cuda", "cpu"):
            stats = NmfStats()
            k1, k2 = masked_gj.launches, hals_step.launches
            W, H, ok = run_nmf(A, W0, H0, opts, stats, device=device)
            runs[device] = (W, H, ok, stats, masked_gj.launches - k1,
                            hals_step.launches - k2)
        (Wc, Hc, okc, sc, lc, hc), (Wh, Hh, okh, sh, lh, hh) = (
            runs["cuda"], runs["cpu"])
        dW, dH = float(np.abs(Wc - Wh).max()), float(np.abs(Hc - Hh).max())
        log(f"[slice f64] run_nmf {algorithm.value} {m}x{n} k={k}: cuda vs "
            f"cpu max|dW| = {dW:.3e}, max|dH| = {dH:.3e}, iterations "
            f"{sc.iteration_count}/{sh.iteration_count}, pivot rounds "
            f"{sc.pivot_rounds}/{sh.pivot_rounds}, K1 launches {lc}/{lh}")
        np.testing.assert_allclose(Wc, Wh, rtol=0, atol=SLICE_ATOL)
        np.testing.assert_allclose(Hc, Hh, rtol=0, atol=SLICE_ATOL)
        if not (okc and okh):
            raise AssertionError(f"slice run success cuda={okc} cpu={okh}")
        if (sc.iteration_count, sc.pivot_rounds) != (sh.iteration_count,
                                                     sh.pivot_rounds):
            raise AssertionError("slice runs differ in iterations or rounds")
        want_k1 = 2 * sc.iteration_count if algorithm == NmfAlgorithm.BPP \
            else 0
        # f64 takes the torch-ops HALS step: K2 takes f32 factors only
        if lc < want_k1 or (want_k1 == 0 and lc) or lh or hc or hh:
            raise AssertionError(f"kernel launches: K1 cuda {lc}, cpu {lh}; "
                                 f"K2 cuda {hc}, cpu {hh}")


def phase_nnls_parity() -> None:
    """nnls_blockpivot in f64 with its rounds narrowed to the columns still
    not optimal (the gate lowered to this shape, which a CPU run can
    afford): the card against the CPU, and K1's launches and columns
    counted on the card."""
    import torch

    from smallk_torch.solvers import nnls

    k, n = NNLS_SHAPE
    rng = np.random.RandomState(11)
    B = rng.rand(k, 2 * k)
    LHS = B @ B.T + 0.1 * np.eye(k)
    RHS = B @ rng.rand(2 * k, n) - 0.3 * B.sum(1, keepdims=True)
    Xinit = rng.rand(k, n) - 0.5
    runs = {}
    gate, nnls._NARROW_MIN_ENTRIES = nnls._NARROW_MIN_ENTRIES, k * n
    try:
        for device in ("cuda", "cpu"):
            reset_counts()
            X, Y, ok, rounds = nnls.nnls_blockpivot(*(
                torch.tensor(a, device=device) for a in (LHS, RHS, Xinit)))
            runs[device] = (X.cpu(), Y.cpu(), bool(ok), int(rounds),
                            read_counts())
    finally:
        nnls._NARROW_MIN_ENTRIES = gate
    (Xc, Yc, okc, rc, cc), (Xh, Yh, okh, rh, ch) = runs["cuda"], runs["cpu"]
    dX, dY = float((Xc - Xh).abs().max()), float((Yc - Yh).abs().max())
    log(f"[slice f64] nnls_blockpivot k={k} n={n}: cuda vs cpu max|dX| = "
        f"{dX:.3e}, max|dY| = {dY:.3e} (atol {SLICE_ATOL:g}), rounds "
        f"{rc}/{rh}, K1 launches {cc['K1']}/{ch['K1']}, K1 columns "
        f"{cc['K1_columns']} (full-width rounds: {(rc + 1) * n})")
    if not (okc and okh) or rc != rh or rc < 2:
        raise AssertionError(f"nnls parity: ok {okc}/{okh}, rounds {rc}/{rh}")
    if not (dX <= SLICE_ATOL and dY <= SLICE_ATOL):
        raise AssertionError("nnls parity: the card and the CPU disagree")
    if (cc["K1"] != rc + 1 or not n < cc["K1_columns"] < (rc + 1) * n
            or ch["K1"]):
        raise AssertionError(f"nnls parity: K1 counts {cc}, cpu {ch}")


def while_node_line() -> str:
    """torch's version and the WHILE-node path the captured BPP step
    takes."""
    import torch

    binding = hasattr(torch.cuda.CUDAGraph, "begin_capture_to_while_loop")
    return (f"[graph] torch {torch.__version__}: WHILE nodes from "
            f"smallk_torch/csrc/graph_if.cu (torch's own binding "
            f"{'present, unused' if binding else 'absent'}); WHILE bodies' "
            f"allocations through "
            f"torch._C._cuda_beginAllocateCurrentStreamToPool, a pool a "
            f"level of nesting")


def main_problem():
    """The main path's operand (host, f32) and factor starts, from its
    seed."""
    from smallk_torch import Random, random_matrix, random_sparse_matrix

    rng = Random(2024)
    A = random_sparse_matrix(rng, M, N, nz_per_col=NZ_PER_COL,
                             dtype=np.float32)
    W0 = random_matrix(M, K, rng, dtype=np.float32)
    H0 = random_matrix(K, N, rng, dtype=np.float32)
    return A, W0, H0


def phase_main_path(card: str) -> dict:
    import torch

    from smallk_torch import NmfAlgorithm, NmfOptions, NmfStats
    from smallk_torch.engines.nmf import run_nmf
    from smallk_torch.ops.aop import as_aop
    from smallk_torch.ops.dense import relative_fnorm
    from smallk_torch.solvers import graph, solve

    A, W0, H0 = main_problem()
    opts = NmfOptions(tol=1e-30, algorithm=NmfAlgorithm.BPP, height=M,
                      width=N, k=K, min_iter=1, max_iter=ITERS,
                      verbose=False, a_dtype="bfloat16")
    unroll = solve.auto_unroll(opts, torch.empty((M, K), device="cuda"),
                               torch.empty((K, N), device="cuda"))

    def rel_err(W, H):
        A32 = as_aop(A, "float32", device="cuda").A
        return float(relative_fnorm(A32, torch.from_numpy(W).cuda(),
                                    torch.from_numpy(H).cuda()))

    W1, H1, ok1 = run_nmf(A, W0, H0, dataclasses.replace(opts, max_iter=1),
                          device="cuda")
    rel1 = rel_err(W1, H1)
    run_nmf(A, W0, H0, opts, device="cuda")  # warm-up

    stats = NmfStats()
    reset_counts()
    t0 = time.perf_counter()
    W, H, ok = run_nmf(A, W0, H0, opts, stats, device="cuda")
    wall = time.perf_counter() - t0
    counts = read_counts()
    capture_s, _ = graph_seconds()
    nodes = graph.last_nodes
    launches, k2_launches = counts["K1"], counts["K2"]
    with patched(graph, "CAPTURE", False):
        We, He, oke = run_nmf(A, W0, H0, opts, device="cuda")
    same = oke and np.array_equal(W, We) and np.array_equal(H, He)

    rel = rel_err(W, H)
    its = stats.iteration_count / (stats.elapsed_us / 1e6)
    log(f"[main] BPP {M}x{N} nnz/col={NZ_PER_COL} k={K} bf16 A: "
        f"success={ok}, iterations={stats.iteration_count}, "
        f"pivot rounds={stats.pivot_rounds}, K1 launches={launches}, "
        f"rel err {rel:.6f} (after 1 iteration {rel1:.6f})")
    log(f"[main] {its:.2f} it/s (solve {stats.elapsed_us / 1e6:.4f} s, "
        f"run_nmf wall {wall:.4f} s) on {card}")
    log(f"[main] at the auto U = {unroll}: graphs {counts['captures']} "
        f"({nodes} nodes, WHILE bodies' included), capture + instantiate "
        f"{1e3 * capture_s:.1f} ms, host reads "
        f"{counts['host_reads']}, steps run {counts['steps']}, pivot rounds "
        f"run {counts['rounds_run']}; K1 {launches} = 2 x {counts['steps']}"
        f" + {counts['rounds_run']}: {k1_gate(counts)}; W and H "
        f"{'equal' if same else 'DIFFERENT'} to the same run eager on "
        f"{card}")
    if not (ok and ok1):
        raise AssertionError("main-path run failed")
    if stats.iteration_count != ITERS:
        raise AssertionError(f"ran {stats.iteration_count} iterations")
    for name, F in (("W", W), ("H", H)):
        if not np.isfinite(F).all() or (F < 0).any():
            raise AssertionError(f"{name} is not finite and nonnegative")
    if not rel < rel1:
        raise AssertionError(f"rel err {rel} not below 1-iteration {rel1}")
    if launches < 2 * ITERS:
        raise AssertionError(f"K1 launched {launches} times in {ITERS} "
                             "iterations: masked solves bypassed the kernel")
    if k2_launches:
        raise AssertionError(f"K2 launched {k2_launches} times in a BPP run")
    if counts["K3"]:
        # BPP's k = 8 products stay on torch.matmul: only the rank-2 lane
        # step's stacked products reach K3 past k = 2
        raise AssertionError(f"K3 launched {counts['K3']} times "
                             f"({counts['K3_lanes']} of lanes) in a BPP run")
    # captured: one graph, a host read after iteration 0 and each U steps
    reads = 1 + -(-(ITERS - 1) // unroll)
    if unroll < 2 or counts["captures"] != 1 \
            or counts["host_reads"] != reads:
        raise AssertionError(f"main path not captured at U = {unroll}: "
                             f"{counts}")
    if not k1_gate(counts) or counts["rounds_run"] != stats.pivot_rounds:
        raise AssertionError(f"main path K1 gate: {counts}, "
                             f"{stats.pivot_rounds} pivot rounds")
    if not same:
        raise AssertionError("main path: captured differs from eager")
    return {"launches": launches, "it_per_s": its,
            "capture_ms": 1e3 * capture_s, "nodes": nodes,
            "counts": counts}


def rel_err(A, W, H) -> float:
    """||A - WH||_F / ||A||_F on the host, in f64."""
    A = np.asarray(A, dtype=np.float64)
    return float(np.linalg.norm(A - W.astype(np.float64) @ H) /
                 np.linalg.norm(A))


def flat_problem():
    """The reference's flatclust workload (pages_tests.rst:276-287): a dense
    256 x 256 uniform matrix, as its rnd_256_256.csv is, made from a seed,
    and the CLI's random initializers."""
    from smallk_torch import Random, generate, random_matrix

    rng = Random(256)
    A = generate(FLAT_M, FLAT_N, "UNIFORM", rng=rng)
    W0 = random_matrix(FLAT_M, FLAT_K, rng)
    H0 = random_matrix(FLAT_K, FLAT_N, rng)
    return A, W0, H0


def phase_flatclust(card: str) -> dict:
    from smallk_torch import (NmfAlgorithm, NmfOptions, NmfProgressAlgorithm,
                              NmfStats)
    from smallk_torch.engines.flatclust import run_flatclust
    from smallk_torch.engines.nmf import run_nmf

    A, W0, H0 = flat_problem()
    # the flatclust CLI's defaults
    opts = NmfOptions(tol=1e-4, algorithm=NmfAlgorithm.HALS,
                      prog_est_algorithm=NmfProgressAlgorithm.PG_RATIO,
                      height=FLAT_M, width=FLAT_N, k=FLAT_K, min_iter=5,
                      max_iter=5000, tolcount=1, verbose=False,
                      normalize=True, dtype="float32")
    run_flatclust(A, W0, H0, dataclasses.replace(opts, max_iter=20),
                  device="cuda")  # warm-up

    stats = NmfStats()
    reset_counts()
    W, H, assign, fuzzy, ok = run_flatclust(A, W0, H0, opts, stats,
                                            device="cuda")
    counts = read_counts()
    k1_launches, launches = counts["K1"], counts["K2"]
    its = stats.iteration_count
    rel = rel_err(A, W, H)
    log(f"[flatclust] HALS {FLAT_M}x{FLAT_N} k={FLAT_K} tol 1e-4: "
        f"success={ok}, iterations={its}, steps run {counts['steps']}, K2 "
        f"launches={launches}, rel err {rel:.6f}, "
        f"{its / (stats.elapsed_us / 1e6):.1f} it/s to convergence")
    if not ok:
        raise AssertionError("flatclust HALS run failed")
    for name, F in (("W", W), ("H", H)):
        if not np.isfinite(F).all() or (F < 0).any():
            raise AssertionError(f"{name} is not finite and nonnegative")
    if assign.shape != (FLAT_N,) or not ((0 <= assign) & (assign < FLAT_K)).all():
        raise AssertionError(f"assignments {assign.shape}")
    col_sums = fuzzy.astype(np.float64).sum(axis=0)
    if fuzzy.shape != (FLAT_K, FLAT_N) or np.abs(col_sums - 1).max() > 1e-5:
        raise AssertionError("fuzzy columns do not sum to 1")
    # one K2 launch a step run, frozen steps after convergence included
    if launches != counts["steps"] or counts["steps"] < its:
        raise AssertionError(f"K2 launched {launches} times in "
                             f"{counts['steps']} steps ({its} iterations): "
                             "a step took another route")
    if k1_launches:
        raise AssertionError(f"K1 launched {k1_launches} times in a HALS run")

    # HALS it/s over a fixed number of iterations, after one warm-up
    fixed = dataclasses.replace(opts, tol=1e-30, max_iter=FLAT_ITERS)
    run_flatclust(A, W0, H0, dataclasses.replace(fixed, max_iter=200),
                  device="cuda")
    stats2 = NmfStats()
    reset_counts()
    *_, ok2 = run_flatclust(A, W0, H0, fixed, stats2, device="cuda")
    counts2 = read_counts()
    fixed_its = stats2.iteration_count / (stats2.elapsed_us / 1e6)
    log(f"[flatclust] HALS {FLAT_ITERS} fixed iterations: {fixed_its:.1f} "
        f"it/s (solve {stats2.elapsed_us / 1e6:.4f} s) on {card}")
    # a block is cut short at max_iter: no frozen step
    if not ok2 or stats2.iteration_count != FLAT_ITERS or \
            counts2["K2"] != counts2["steps"] or counts2["steps"] != FLAT_ITERS:
        raise AssertionError(f"fixed-iteration HALS run failed: {counts2}")

    # quality gate: f32 on the card (K2) against f32 on the CPU (torch ops)
    short = dataclasses.replace(fixed, max_iter=50)
    rels = {}
    for device in ("cuda", "cpu"):
        Wd, Hd, okd = run_nmf(A, W0, H0, short, device=device)
        if not okd:
            raise AssertionError(f"50-iteration HALS run failed on {device}")
        rels[device] = rel_err(A, Wd, Hd)
    log(f"[flatclust] 50 iterations f32: rel err cuda {rels['cuda']:.8f}, "
        f"cpu {rels['cpu']:.8f}")
    if abs(rels["cuda"] - rels["cpu"]) > 1e-4:
        raise AssertionError("f32 relative errors differ by more than 1e-4")
    return {"launches": launches, "it_per_s": fixed_its}


def phase_beside(card: str) -> None:
    """MU and RANK2 on a dense 800 x 600 operand (as the reference's TPU
    smoke runs them) and flatclust BPP at the flatclust shape."""
    from smallk_torch import (NmfAlgorithm, NmfOptions, NmfProgressAlgorithm,
                              NmfStats, Random, random_matrix)
    from smallk_torch.engines.flatclust import run_flatclust
    from smallk_torch.engines.nmf import run_nmf

    m, n = 800, 600
    A = np.random.RandomState(1).rand(m, n).astype(np.float32)
    rng = Random(5)
    for alg, k, prog in (("MU", 8, NmfProgressAlgorithm.DELTA_FNORM),
                         ("RANK2", 2, NmfProgressAlgorithm.PG_RATIO)):
        W0 = random_matrix(m, k, rng, dtype=np.float32)
        H0 = random_matrix(k, n, rng, dtype=np.float32)
        opts = NmfOptions(tol=0.005, algorithm=NmfAlgorithm(alg),
                          prog_est_algorithm=prog, height=m, width=n, k=k,
                          min_iter=5, max_iter=5000, verbose=False,
                          stall_patience=200)
        one = dataclasses.replace(opts, min_iter=1, max_iter=1)
        W1, H1, _ = run_nmf(A, W0, H0, one, device="cuda")
        stats = NmfStats()
        W, H, ok = run_nmf(A, W0, H0, opts, stats, device="cuda")
        rel, rel1 = rel_err(A, W, H), rel_err(A, W1, H1)
        log(f"[beside] {alg} {m}x{n} k={k}: success={ok}, iterations="
            f"{stats.iteration_count}, rel err {rel:.6f} (after 1 iteration "
            f"{rel1:.6f}), {stats.iteration_count / (stats.elapsed_us / 1e6):.1f}"
            f" it/s on {card}")
        if not ok or not rel < rel1 or not np.isfinite(W).all():
            raise AssertionError(f"{alg} run failed")

    A, W0, H0 = flat_problem()
    opts = NmfOptions(tol=1e-4, algorithm=NmfAlgorithm.BPP, height=FLAT_M,
                      width=FLAT_N, k=FLAT_K, min_iter=5, max_iter=200,
                      verbose=False, dtype="float32")
    one = dataclasses.replace(opts, min_iter=1, max_iter=1)
    W1, H1, *_ = run_flatclust(A, W0, H0, one, device="cuda")
    stats = NmfStats()
    reset_counts()
    W, H, assign, fuzzy, ok = run_flatclust(A, W0, H0, opts, stats,
                                            device="cuda")
    launches = read_counts()["K1"]
    rel, rel1 = rel_err(A, W, H), rel_err(A, W1, H1)
    log(f"[beside] flatclust BPP {FLAT_M}x{FLAT_N} k={FLAT_K}: success={ok}, "
        f"iterations={stats.iteration_count}, K1 launches={launches}, rel "
        f"err {rel:.6f} (after 1 iteration {rel1:.6f})")
    if not ok or not rel < rel1 or launches < 2 * stats.iteration_count:
        raise AssertionError("flatclust BPP run failed or bypassed K1")


def phase_cli() -> None:
    import scipy.io
    import scipy.sparse as sp

    m, n, k = 200, 150, 8
    with tempfile.TemporaryDirectory() as td:
        A = sp.random(m, n, density=0.2, random_state=5, format="coo")
        mtx = os.path.join(td, "a.mtx")
        scipy.io.mmwrite(mtx, A)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
        cmd = [sys.executable, "-m", "smallk_torch.cli.nmf_cli",
               "--matrixfile", mtx, "--k", str(k), "--maxiter", "20",
               "--seed", "1"]
        proc = subprocess.run(cmd, cwd=td, env=env, capture_output=True,
                              text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"nmf CLI exited {proc.returncode}:\n"
                                 f"{proc.stdout}\n{proc.stderr}")
        W = np.loadtxt(os.path.join(td, "w.csv"), delimiter=",", ndmin=2)
        H = np.loadtxt(os.path.join(td, "h.csv"), delimiter=",", ndmin=2)
        dic = os.path.join(td, "dict.txt")
        with open(dic, "w") as f:
            f.write("".join(f"term{i}\n" for i in range(m)))
        clusters = 4
        cmd = [sys.executable, "-m", "smallk_torch.cli.hierclust_cli",
               "--matrixfile", mtx, "--dictfile", dic, "--clusters",
               str(clusters), "--flat", "1", "--device", "cuda",
               "--verbose", "0", "--seed", "1", "--outdir", td]
        t0 = time.perf_counter()
        hproc = subprocess.run(cmd, cwd=td, env=env, capture_output=True,
                               text=True, timeout=600)
        hwall = time.perf_counter() - t0
        if hproc.returncode != 0:
            raise AssertionError(f"sparse hierclust CLI exited "
                                 f"{hproc.returncode}:\n{hproc.stdout}\n"
                                 f"{hproc.stderr}")
        with open(os.path.join(td, f"tree_{clusters}.xml")) as f:
            nodes = f.read().count("<node id=")
        flat = np.loadtxt(os.path.join(td, f"assignments_flat_{clusters}.csv"),
                          delimiter=",", dtype=np.int64, ndmin=1, max_rows=1)
    if nodes != 2 * (clusters - 1) or flat.shape != (n,):
        raise AssertionError(f"sparse hierclust CLI: {nodes} tree nodes, "
                             f"flat assignments {flat.shape}")
    if W.shape != (m, k) or H.shape != (k, n):
        raise AssertionError(f"CLI wrote W {W.shape}, H {H.shape}")
    tail = proc.stdout.strip().splitlines()[-1]
    log(f"[cli] nmf_cli {m}x{n} k={k} --device cuda: rc 0, w.csv {W.shape}, "
        f"h.csv {H.shape}; {tail}")


def phase_flat_cli() -> None:
    A, _, _ = flat_problem()
    k = FLAT_K
    with tempfile.TemporaryDirectory() as td:
        csv = os.path.join(td, "rnd_256_256.csv")
        np.savetxt(csv, A, delimiter=",", fmt="%.9g")
        dic = os.path.join(td, "dict.txt")
        with open(dic, "w") as f:
            f.write("".join(f"term{i}\n" for i in range(FLAT_M)))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
        cmd = [sys.executable, "-m", "smallk_torch.cli.flatclust_cli",
               "--matrixfile", csv, "--dictfile", dic, "--clusters", str(k),
               "--algorithm", "HALS", "--device", "cuda", "--verbose", "0",
               "--seed", "1", "--outdir", td]
        proc = subprocess.run(cmd, cwd=td, env=env, capture_output=True,
                              text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"flatclust CLI exited {proc.returncode}:\n"
                                 f"{proc.stdout}\n{proc.stderr}")
        assign = np.loadtxt(os.path.join(td, f"assignments_{k}.csv"),
                            delimiter=",", dtype=np.int64, ndmin=1)
        fuzzy = np.loadtxt(os.path.join(td, f"assignments_fuzzy_{k}.csv"),
                           delimiter=",", ndmin=2)
        with open(os.path.join(td, f"clusters_{k}.xml")) as f:
            xml = f.read()
    if assign.shape != (FLAT_N,) or not ((0 <= assign) & (assign < k)).all():
        raise AssertionError(f"assignments_{k}.csv holds {assign.shape}")
    if fuzzy.shape != (FLAT_N, k) or np.abs(fuzzy.sum(axis=1) - 1).max() > 2e-3:
        raise AssertionError(f"assignments_fuzzy_{k}.csv holds {fuzzy.shape}")
    if xml.count("<node id=") != k or f'<DataSet id="{FLAT_N}">' not in xml:
        raise AssertionError(f"clusters_{k}.xml is malformed")
    tail = proc.stdout.strip().splitlines()[-1]
    log(f"[cli] flatclust_cli {FLAT_M}x{FLAT_N} --clusters {k} --algorithm "
        f"HALS --device cuda: rc 0, assignments {assign.shape}, fuzzy "
        f"{fuzzy.shape}, clusters_{k}.xml with {k} nodes; {tail}")


def k3_inputs(m: int, w: int, dtype: str, seed: int = 0):
    """A >= 0 in `dtype`, a Wt with both signs and an H, made on the card
    from a seed."""
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(seed + m + w)
    A = torch.rand((m, w), generator=g, device="cuda").to(getattr(torch,
                                                                  dtype))
    Wt = torch.rand((2, m), generator=g, device="cuda") - 0.3
    H = torch.rand((2, w), generator=g, device="cuda")
    return A, Wt, H


def k3_resources() -> None:
    """K3's kernels as ptxas built them (the build's log): registers,
    shared memory and spills a kernel; a spill fails the run (the plan keeps
    each lane's sums in registers)."""
    import re

    from smallk_torch.kernels import _build

    types = {"f": "f32", "13__nv_bfloat16": "bf16", "13__nv_fp8_e4m3": "e4m3"}
    rows, name = {}, None
    for line in _build.build_log("rank2_loop").splitlines():
        hit = re.search(r"(?:Compiling entry function|Function properties "
                        r"for) '?(\w+)", line)
        if hit:
            name = hit.group(1)
            continue
        if name is None:
            continue
        row = rows.setdefault(name, {})
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill:
            row["spill"] = int(spill.group(1)) + int(spill.group(2))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            row["regs"] = int(regs.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            row["smem"] = int(smem.group(1)) if smem else 0
    labels = []
    for name, row in sorted(rows.items()):
        hit = re.search(r"(wt_a_kernel|h_at_kernel)I(f|13__nv_bfloat16|"
                        r"13__nv_fp8_e4m3)Li(\d+)E", name)
        label = (f"{hit.group(1)}<{types[hit.group(2)]}, K={hit.group(3)}>"
                 if hit else next((k for k in ("split_sum_kernel",
                                               "scale_kernel") if k in name),
                                  name))
        labels.append(f"{label} {row.get('regs')} regs {row.get('smem')} B "
                      f"smem {row.get('spill', 0)} B spilled")
    log(f"[K3 build] {len(rows)} kernels (ptxas -v): " + "; ".join(labels))
    spilled = [name for name, row in rows.items() if row.get("spill", 0)]
    if not rows or spilled:
        raise AssertionError(f"K3 kernels spill: {spilled}" if rows else
                             "no K3 kernel in the build's log")


def k3_side_times(label: str, A, Wt, H) -> dict:
    """Device ms of each K3 product on A (W'A with Wt, AH' with H), of the
    library's (torch.matmul after the upcast) and each side's bound: A
    read once, the factor in and the product out, 2 k m w operations."""
    import torch

    from smallk_torch.kernels import rank2_loop as k3

    (m, w), k = A.shape, Wt.shape[0]
    side = bound(2.0 * k * m * w,
                 A.numel() * A.element_size() + 4 * k * (m + w))
    out = {"wt_a_ms": device_ms(lambda: k3.wt_a(A, Wt), 20),
           "h_at_ms": device_ms(lambda: k3.h_at(A, H), 20),
           "lib_wt_a_ms": device_ms(
               lambda: torch.matmul(Wt, A.to(torch.float32)), 5),
           "lib_h_at_ms": device_ms(
               lambda: torch.matmul(H, A.to(torch.float32).T), 5),
           "side_bound_ms": side[0], "bound_by": side[1]}
    out["ms"] = out["wt_a_ms"] + out["h_at_ms"]
    out["library_ms"] = out["lib_wt_a_ms"] + out["lib_h_at_ms"]
    log(f"[K3 sides] {label} k={k}: device ms wt_a {out['wt_a_ms']:.4f} "
        f"({100 * side[0] / out['wt_a_ms']:.1f}% of its bound), h_at "
        f"{out['h_at_ms']:.4f} ({100 * side[0] / out['h_at_ms']:.1f}%); "
        f"library (torch.matmul after the upcast) wt_a "
        f"{out['lib_wt_a_ms']:.4f}, h_at {out['lib_h_at_ms']:.4f}; pair "
        f"{out['ms']:.4f} against {out['library_ms']:.4f} "
        f"({out['ms'] / out['library_ms']:.2f}x); bound a side "
        f"{side[0]:.4f} ms ({side[1]})")
    return out


def k3_misaligned(dt: str):
    """A K3_VIEW A in `dt` one element past an aligned allocation: a
    contiguous view whose rows are not 16-byte aligned."""
    import torch

    m, w = K3_VIEW
    g = torch.Generator(device="cuda")
    g.manual_seed(m + w)
    base = torch.rand((m * w + 1,), generator=g, device="cuda").to(
        getattr(torch, dt))
    return base[1:].view(m, w)


def phase_k3() -> dict:
    """K3 against its plain version at P3's shapes, ragged ones and a
    misaligned view and exact widths (the kernels' scalar path, whose
    sums must be the vector path's bit for bit); times of the loop at P3's
    shapes and, at the hierclust root shape, of the two products at every
    factor row count K3 takes (k = 2 is the path's; k = 8 is BPP's step,
    which runs torch.matmul after the upcast)."""
    import torch

    from smallk_torch.kernels import rank2_loop as k3

    k3_resources()
    worst_abs = worst_rel = 0.0

    def check(label, got, want, tol):
        nonlocal worst_abs, worst_rel
        diff = float((got - want).abs().max())
        # a loop whose A has no singular value above 1 decays to exact 0
        rel = diff / max(float(want.abs().max()), 1e-30)
        log(f"[K3] {label}: max|kernel - plain| = {diff:.3e}, relative "
            f"{rel:.3e} (tolerance {tol:g})")
        if not (rel <= tol and bool(torch.isfinite(got).all())):
            raise AssertionError(f"K3 {label} disagrees with its plain "
                                 "version")
        worst_abs, worst_rel = max(worst_abs, diff), max(worst_rel, rel)

    for m, w, dt in K3_RAGGED + P3_SHAPES:
        A, Wt, H = k3_inputs(m, w, dt)
        before = k3.launches
        got = (k3.wt_a(A, Wt), k3.h_at(A, H), k3.rank2_loop(A, Wt))
        want = (k3.wt_a_plain(A, Wt), k3.h_at_plain(A, H),
                k3.rank2_loop_plain(A, Wt))
        torch.cuda.synchronize()
        if k3.launches != before + 3:
            raise AssertionError("a K3 wrapper did not launch its kernel")
        label = f"m={m} w={w} A {dt}"
        check(f"{label} wt_a", got[0], want[0], K3_TOL["product"])
        check(f"{label} h_at", got[1], want[1], K3_TOL["product"])
        check(f"{label} loop x{k3.ITERS}", got[2], want[2], K3_TOL["loop"])
        if (m, w, dt) not in P3_SHAPES:
            continue
        ms = device_ms(lambda: k3.rank2_loop(A, Wt), 10, queued=False)
        plain = device_ms(lambda: k3.rank2_loop_plain(A, Wt), 3,
                          queued=False)
        # the library's products of one iteration: torch.matmul after the
        # upcast, as the port computed them before K3
        library = device_ms(lambda: torch.matmul(
            torch.matmul(Wt, A.float()), A.float().T), 20)
        b_ms, b_by = bound(8.0 * m * w * k3.ITERS,
                           A.numel() * A.element_size() + 16 * m)
        log(f"[K3 time] P3 m={m} w={w} A {dt}, {k3.ITERS} iterations: "
            f"device ms (graph replays back to back) kernel {ms:.4f}, plain "
            f"{plain:.4f}; library products "
            f"of one iteration {library:.4f} (x{k3.ITERS} = "
            f"{library * k3.ITERS:.4f}); bound {b_ms:.4f} ms ({b_by})")

    # the scalar path, each A dtype (the loop: f32 and bf16): a view whose
    # rows all sit one element past 16-byte alignment, whose sums must be
    # the vector path's on an aligned copy bit for bit, and an exact-width
    # node, whose rows each sit at their own offset; each against the plain
    # version, and timed beside an aligned copy (the node's padded with
    # zero columns to a multiple of 16 bytes)
    for dt in ("float32", "bfloat16", "float8_e4m3fn"):
        A = k3_misaligned(dt)
        Ac = A.clone()
        if k3.vector_path(A) or not k3.vector_path(Ac):
            raise AssertionError("K3's vector rule misjudged the view")
        m, w = A.shape
        for lanes in (1, 3, 8):
            _, Wt, H = lane_inputs(m, w, lanes, dt)
            label = f"misaligned view m={m} w={w} A {dt} k={2 * lanes}"
            got = (k3.wt_a(A, Wt), k3.h_at(A, H))
            check(f"{label} wt_a", got[0], k3.wt_a_plain(A, Wt),
                  K3_TOL["product"])
            check(f"{label} h_at", got[1], k3.h_at_plain(A, H),
                  K3_TOL["product"])
            if not (torch.equal(got[0], k3.wt_a(Ac, Wt))
                    and torch.equal(got[1], k3.h_at(Ac, H))):
                raise AssertionError(f"K3 {label}: the scalar path's sums "
                                     "are not the vector path's")
        if dt != "float8_e4m3fn":
            _, Wt, _ = k3_inputs(m, w, dt)
            check(f"misaligned view m={m} w={w} A {dt} loop x{k3.ITERS}",
                  k3.rank2_loop(A, Wt), k3.rank2_loop_plain(A, Wt),
                  K3_TOL["loop"])
        _, Wt, H = k3_inputs(m, w, dt)
        log(f"[K3 time] m={m} w={w} A {dt} k=2, device ms wt_a + h_at: "
            f"scalar path (misaligned view) "
            f"{device_ms(lambda: (k3.wt_a(A, Wt), k3.h_at(A, H)), 20):.4f}, "
            f"vector path (aligned copy) "
            f"{device_ms(lambda: (k3.wt_a(Ac, Wt), k3.h_at(Ac, H)), 20):.4f}")
        del A, Ac
        m, w = K3_EXACT[dt]
        A, Wt, H = k3_inputs(m, w, dt)
        if k3.vector_path(A):
            raise AssertionError("K3's vector rule misjudged an exact width")
        label = f"exact width m={m} w={w} A {dt} k=2"
        check(f"{label} wt_a", k3.wt_a(A, Wt), k3.wt_a_plain(A, Wt),
              K3_TOL["product"])
        check(f"{label} h_at", k3.h_at(A, H), k3.h_at_plain(A, H),
              K3_TOL["product"])
        wp = -(-w * A.element_size() // 16) * 16 // A.element_size()
        Ap = torch.zeros((m, wp), dtype=A.dtype, device="cuda")
        Ap[:, :w] = A
        Hp = torch.zeros((2, wp), device="cuda")
        Hp[:, :w] = H
        log(f"[K3 time] {label}, device ms wt_a + h_at: scalar path "
            f"{device_ms(lambda: (k3.wt_a(A, Wt), k3.h_at(A, H)), 20):.4f}, "
            f"vector path (padded to w={wp}) "
            f"{device_ms(lambda: (k3.wt_a(Ap, Wt), k3.h_at(Ap, Hp)), 20):.4f}")
        del A, Ap

    # the hierclust root: one rank-2 iteration's A-products at k = 2 (the
    # path's), and the products at every other k K3 takes
    A, Wt, H = k3_inputs(HIER_M, HIER_N, "bfloat16")
    check(f"root m={HIER_M} w={HIER_N} A bfloat16 wt_a", k3.wt_a(A, Wt),
          k3.wt_a_plain(A, Wt), K3_TOL["product"])
    check(f"root m={HIER_M} w={HIER_N} A bfloat16 h_at", k3.h_at(A, H),
          k3.h_at_plain(A, H), K3_TOL["product"])
    ms = device_ms(lambda: (k3.wt_a(A, Wt), k3.h_at(A, H)), 20)
    plain = device_ms(lambda: (k3.wt_a_plain(A, Wt), k3.h_at_plain(A, H)), 10)
    library = device_ms(lambda: (torch.matmul(Wt, A.to(torch.float32)),
                                 torch.matmul(H, A.to(torch.float32).T)), 10)
    parts = [device_ms(lambda: k3.wt_a(A, Wt), 20),
             device_ms(lambda: k3.h_at(A, H), 20)]
    # the two are separate launches with a data dependency between them
    # (W'A, the 2 x 2 H solve, then AH' with the new H: solvers/rank2.py),
    # so each reads A once: a launch's bound is A plus its own factor in
    # and product out, 4 m w operations; the pair's is the sum
    a_bytes = A.numel() * A.element_size()
    bounds = [bound(4.0 * HIER_M * HIER_N, a_bytes + 8 * (HIER_M + HIER_N))
              for _ in parts]
    b_ms, b_by = sum(b for b, _ in bounds), bounds[0][1]
    log(f"[K3 time] root products m={HIER_M} w={HIER_N} A bfloat16: device "
        f"ms wt_a + h_at {ms:.4f} (wt_a {parts[0]:.4f}, h_at {parts[1]:.4f}), "
        f"plain {plain:.4f}, library (torch.matmul after the upcast) "
        f"{library:.4f}; bound per launch {bounds[0][0]:.4f} ms ({b_by}: one "
        f"read of A), so wt_a at {100 * bounds[0][0] / parts[0]:.1f}% and "
        f"h_at at {100 * bounds[1][0] / parts[1]:.1f}% of its bound; the "
        f"pair's bound {b_ms:.4f} ms")
    for k in k3.ROWS[1:]:
        _, Wt, H = lane_inputs(HIER_M, HIER_N, k // 2, "bfloat16")
        check(f"root m={HIER_M} w={HIER_N} A bfloat16 k={k} wt_a",
              k3.wt_a(A, Wt), k3.wt_a_plain(A, Wt), K3_TOL["product"])
        check(f"root m={HIER_M} w={HIER_N} A bfloat16 k={k} h_at",
              k3.h_at(A, H), k3.h_at_plain(A, H), K3_TOL["product"])
        k3_side_times(f"m={HIER_M} w={HIER_N} A bfloat16"
                      + (" (BPP's k = 8 step)" if k == 8 else ""), A, Wt, H)
    return {"max_abs_err": worst_abs, "max_rel_err": worst_rel, "ms": ms,
            "plain_ms": plain, "library_ms": library, "bound_ms": b_ms,
            "bound_by": b_by}


def hier_opts(k: int, dtype: str, initdir=None, a_dtype=None):
    """The hierclust configuration of bench.py:60-79 (RANK2, PG_RATIO,
    tol 1e-4, min_iter 1, max_iter 5000, stall_patience 100)."""
    from smallk_torch import ClustOptions, NmfAlgorithm, NmfOptions
    from smallk_torch import NmfProgressAlgorithm

    return ClustOptions(
        nmf_opts=NmfOptions(
            tol=1e-4, algorithm=NmfAlgorithm.RANK2,
            prog_est_algorithm=NmfProgressAlgorithm.PG_RATIO, k=2,
            min_iter=1, max_iter=5000, verbose=False, dtype=dtype,
            a_dtype=a_dtype, stall_patience=100),
        num_clusters=k, verbose=False, initdir=initdir)


def phase_hier_parity() -> None:
    """A small planted corpus in initdir mode: f64 on the card against the
    CPU (the same tree), and f32 on the card, through K3, against f32 on
    the CPU by NMI against the planted labels."""
    from smallk_torch import Random
    from smallk_torch.engines.corpus import synthetic_term_doc_corpus
    from smallk_torch.engines.hierclust import clust_hier
    from smallk_torch.engines.scoring import nmi

    m, n, k = 600, 400, 6
    A, labels = synthetic_term_doc_corpus(m, n, k, seed=5, topic_weight=0.5)
    rng = np.random.RandomState(9)
    with tempfile.TemporaryDirectory() as initdir:
        for i in range(1, 61):
            np.savetxt(os.path.join(initdir, f"Winit_{i}.csv"),
                       rng.rand(m, 2), delimiter=",", fmt="%.17g")
            np.savetxt(os.path.join(initdir, f"Hinit_{i}.csv"),
                       rng.rand(2, n), delimiter=",", fmt="%.17g")
        runs = {}
        for dtype in ("float64", "float32"):
            for device in ("cuda", "cpu"):
                reset_counts()
                tree, stats = clust_hier(A, hier_opts(k, dtype, initdir),
                                         Random(1), device=device)
                runs[dtype, device] = (tree, stats, read_counts())
    (tc, sc, cc), (th, sh, ch) = runs["float64", "cuda"], runs["float64",
                                                               "cpu"]
    worst = 0.0
    for q, (a, b) in enumerate(zip(tc.nodes, th.nodes)):
        same = ((a.is_valid, a.parent_index, a.left_child_index)
                == (b.is_valid, b.parent_index, b.left_child_index))
        if not same or (a.is_valid and not np.array_equal(a.docs, b.docs)):
            raise AssertionError(f"f64 trees differ at node {q}")
        worst = max(worst, abs(a.priority - b.priority))
    if not np.array_equal(tc.assignments, th.assignments):
        raise AssertionError("f64 assignments differ between cuda and cpu")
    if worst > HIER_PRIORITY_TOL or cc["K3"] or cc["kernel_products"]:
        raise AssertionError(f"f64 priorities differ by {worst}, or f64 "
                             f"took K3 ({cc})")
    log(f"[hier parity f64] {m}x{n} k={k} initdir: cuda vs cpu same tree "
        f"and assignments, max|d priority| = {worst:.2e} (tolerance "
        f"{HIER_PRIORITY_TOL:g}); iterations {sc.iter_count}/{sh.iter_count}, "
        f"factorizations {sc.nmf_count}/{sh.nmf_count}")
    (t32, s32, c32), (h32, hs32, _) = runs["float32", "cuda"], runs[
        "float32", "cpu"]
    nmi_card, nmi_cpu = nmi(t32.assignments, labels), nmi(h32.assignments,
                                                          labels)
    log(f"[hier parity f32] NMI cuda {nmi_card:.4f} (K3 launches "
        f"{c32['K3']}, matmul products {c32['matmul_products']}), cpu "
        f"{nmi_cpu:.4f}; iterations {s32.iter_count}/{hs32.iter_count}")
    if c32["K3"] < 2 * s32.iter_count or c32["matmul_products"]:
        raise AssertionError(f"f32 card run bypassed K3: {c32}")
    if nmi_card < nmi_cpu - HIER_NMI_MARGIN:
        raise AssertionError(f"f32 NMI on the card {nmi_card} trails the "
                             f"CPU's {nmi_cpu} by more than "
                             f"{HIER_NMI_MARGIN}")


@functools.lru_cache(maxsize=1)
def hier_corpus():
    """bench.py's Reuters-shape hierclust corpus on the host, made from its
    seed once a process: (scipy A, planted labels)."""
    from smallk_torch.engines.corpus import synthetic_term_doc_corpus

    return synthetic_term_doc_corpus(HIER_M, HIER_N, HIER_TOPICS, seed=11)


def hier_problem():
    """The Reuters-shape hierclust corpus as a bf16 operand on the card
    (built outside the timing)."""
    from smallk_torch.ops.aop import as_aop

    A, labels = hier_corpus()
    return as_aop(A, dtype="bfloat16", device="cuda"), labels


def phase_hierclust(card: str) -> dict:
    import torch

    from smallk_torch import ClustStats, Random
    from smallk_torch.engines.hierclust import clust_hier
    from smallk_torch.engines.scoring import nmi

    a_op, labels = hier_problem()
    opts = hier_opts(HIER_K, "float32", a_dtype="bfloat16")
    clust_hier(a_op, opts, Random(1))  # warm-up
    stats = ClustStats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree, stats = clust_hier(a_op, opts, Random(2), stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    leaves = sum(tree.is_leaf)
    score = nmi(tree.assignments, labels)
    log(f"[hierclust] {HIER_M}x{HIER_N} bf16 A, f32 factors, {HIER_K} "
        f"clusters: wall {wall:.4f} s, nmf_count {stats.nmf_count}, "
        f"converged {stats.nmf_count - stats.max_count}, iter_count "
        f"{stats.iter_count}, {stats.iter_count / wall:.1f} rank-2 it/s, "
        f"steps run {counts['steps']} in {counts['solves']} solves, K3 "
        f"launches {counts['K3']}, k=2 products to torch.matmul "
        f"{counts['matmul_products']}, leaves {leaves}, outliers "
        f"{len(tree.outliers)}, NMI {score:.4f} on {card}")
    if leaves != HIER_K:
        raise AssertionError(f"{leaves} leaves, expected {HIER_K}")
    if (tree.assignments < 0).any():
        raise AssertionError(f"{len(tree.outliers)} documents unassigned")
    want = k3_want(counts)
    if (counts["K3"], counts["kernel_products"]) != want:
        raise AssertionError(f"K3 launched {counts['K3']} times for "
                             f"{counts['steps']} steps run in "
                             f"{counts['solves']} solves (expected "
                             f"{want})")
    if counts["matmul_products"]:
        raise AssertionError(f"{counts['matmul_products']} k=2 f32 products "
                             "went to torch.matmul")
    return {"launches": counts["K3"], "wall": wall}


def profile_hierclust() -> None:
    """The full-width hierclust path once under torch.profiler: device time
    by kernel, the device's busy share of the window, launches and
    syncs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from smallk_torch import Random
    from smallk_torch.engines.hierclust import clust_hier

    a_op, _ = hier_problem()
    opts = hier_opts(HIER_K, "float32", a_dtype="bfloat16")
    clust_hier(a_op, opts, Random(1))  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, stats = clust_hier(a_op, opts, Random(2))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    profile_summary(prof, wall, f"hierclust, iter_count {stats.iter_count}")

    # the same path with K3 and with every k = 2 product sent to
    # torch.matmul (the dispatch rule switched off), alternating
    from smallk_torch.ops import aop

    rule = aop._kernel_product_ok
    try:
        for side in ("K3", "matmul", "matmul", "K3"):
            aop._kernel_product_ok = (rule if side == "K3"
                                      else lambda *args: False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, stats = clust_hier(a_op, opts, Random(2))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            log(f"[profile] hierclust with the products through {side}: "
                f"wall {wall:.4f} s, iter_count {stats.iter_count}, "
                f"{stats.iter_count / wall:.1f} rank-2 it/s")
    finally:
        aop._kernel_product_ok = rule


def phase_hier_cli() -> None:
    """The hierclust CLI with --flat 1 on a small .mtx with a dictionary."""
    import scipy.io

    from smallk_torch.engines.corpus import synthetic_term_doc_corpus

    m, n, k = 400, 300, 5
    A, _ = synthetic_term_doc_corpus(m, n, k, seed=3)
    with tempfile.TemporaryDirectory() as td:
        mtx = os.path.join(td, "corpus.mtx")
        scipy.io.mmwrite(mtx, A)
        dic = os.path.join(td, "dict.txt")
        with open(dic, "w") as f:
            f.write("".join(f"term{i}\n" for i in range(m)))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
        cmd = [sys.executable, "-m", "smallk_torch.cli.hierclust_cli",
               "--matrixfile", mtx, "--dictfile", dic, "--clusters", str(k),
               "--device", "cuda", "--flat", "1", "--verbose", "0",
               "--seed", "1", "--outdir", td]
        proc = subprocess.run(cmd, cwd=td, env=env, capture_output=True,
                              text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"hierclust CLI exited {proc.returncode}:\n"
                                 f"{proc.stdout}\n{proc.stderr}")
        with open(os.path.join(td, f"tree_{k}.xml")) as f:
            xml = f.read()
        assign = [np.loadtxt(os.path.join(td, name), delimiter=",",
                             dtype=np.int64, ndmin=1, max_rows=1)
                  for name in (f"assignments_{k}.csv",
                               f"assignments_flat_{k}.csv")]
        names = sorted(os.listdir(td))
    # the tree file holds every stored node: 2 (k - 1), the root is not
    # stored (tree.hpp)
    if xml.count("<node id=") != 2 * (k - 1) or "<DataSet id=" not in xml:
        raise AssertionError(f"tree_{k}.xml holds {xml.count('<node id=')} "
                             "nodes")
    for a in assign:
        if a.shape != (n,) or not ((-1 <= a) & (a < 2 * (k - 1))).all():
            raise AssertionError(f"an assignment file holds {a.shape}")
    tail = proc.stdout.strip().splitlines()
    log(f"[cli] hierclust_cli {m}x{n} --clusters {k} --flat 1 --device cuda: "
        f"rc 0, tree_{k}.xml with {2 * (k - 1)} nodes, files {names}; "
        f"{' '.join(tail[-2:])}")


def lane_inputs(m: int, w: int, lanes: int, dtype: str, seed: int = 0):
    """A >= 0 in `dtype` and factors of 2R rows (Wt with both signs, H),
    made on the card from a seed."""
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(seed + m + w + lanes)
    A = torch.rand((m, w), generator=g, device="cuda").to(getattr(torch,
                                                                  dtype))
    Wt = torch.rand((2 * lanes, m), generator=g, device="cuda") - 0.3
    H = torch.rand((2 * lanes, w), generator=g, device="cuda")
    return A, Wt, H


def graph_k3() -> dict:
    """(a) K3 over R lanes (2R factor rows) against its plain version: at
    the graph roots for every R K3 takes, at bucket-width nodes and at
    ragged shapes for GRAPH_LANES; at the roots and nodes each product's
    device ms, the plain version's and torch.matmul's after the upcast (one
    call each side), and the bound: one read of A, the factor in and the
    product out, 4R m w operations a side."""
    import torch

    from smallk_torch.kernels import rank2_loop as k3

    worst_abs, rows = 0.0, {}
    every = tuple(range(1, k3.MAX_LANES + 1))
    cases = [(shape, lanes) for shape in GRAPH_K3_RAGGED
             for lanes in GRAPH_LANES]
    cases += [(shape, lanes) for shape in GRAPH_K3_SHAPES for lanes in every]
    cases += list(GRAPH_K3_NODES)
    for (m, w, dt), lanes in cases:
        A, Wt, H = lane_inputs(m, w, lanes, dt)
        before = (k3.launches, k3.lane_launches)
        got = (k3.wt_a(A, Wt), k3.h_at(A, H))
        want = (k3.wt_a_plain(A, Wt), k3.h_at_plain(A, H))
        torch.cuda.synchronize()
        if (k3.launches - before[0], k3.lane_launches - before[1]) \
                != (2, 2 if lanes > 1 else 0):
            raise AssertionError(f"K3 lanes R={lanes}: a wrapper did "
                                 "not launch its kernel")
        errs = []
        for side, g_, w_ in zip(("wt_a", "h_at"), got, want):
            diff = float((g_ - w_).abs().max())
            rel = diff / max(float(w_.abs().max()), 1e-30)
            if not (rel <= K3_TOL["product"]
                    and bool(torch.isfinite(g_).all())):
                raise AssertionError(
                    f"K3 lanes R={lanes} m={m} w={w} A {dt} {side}: "
                    f"relative {rel:.3e} (tolerance "
                    f"{K3_TOL['product']:g})")
            worst_abs = max(worst_abs, diff)
            errs.append(f"{side} {rel:.2e}")
        label = f"m={m} w={w} A {dt} R={lanes} ({2 * lanes} rows)"
        log(f"[graph K3] {label}: relative |kernel - plain| "
            f"{', '.join(errs)} (tolerance {K3_TOL['product']:g})")
        if (m, w, dt) in GRAPH_K3_RAGGED:
            continue
        t = k3_side_times(f"graph {label}", A, Wt, H)
        plain = device_ms(lambda: (k3.wt_a_plain(A, Wt),
                                   k3.h_at_plain(A, H)), 5)
        b_ms = 2 * t["side_bound_ms"]
        log(f"[graph K3 time] {label}: device ms wt_a {t['wt_a_ms']:.4f}, "
            f"h_at {t['h_at_ms']:.4f} (pair {t['ms']:.4f}; a lane's share "
            f"{t['ms'] / lanes:.4f}), plain {plain:.4f}, library "
            f"(torch.matmul after the upcast) {t['library_ms']:.4f}; bound "
            f"a side {t['side_bound_ms']:.4f} ms ({t['bound_by']}; A read "
            f"once), wt_a at {100 * t['side_bound_ms'] / t['wt_a_ms']:.1f}% "
            f"and h_at at {100 * t['side_bound_ms'] / t['h_at_ms']:.1f}% of "
            "it")
        rows[(m, w, dt, lanes)] = {
            "ms": t["ms"], "wt_a_ms": t["wt_a_ms"], "h_at_ms": t["h_at_ms"],
            "plain_ms": plain, "library_ms": t["library_ms"],
            "bound_ms": b_ms, "bound_by": t["bound_by"]}
    return {"max_abs_err": worst_abs, "rows": rows}


def community_graph():
    """The community cell's graph (bench.py:222-230): the planted partition,
    its labels and its degree-normalized adjacency."""
    from smallk_torch.engines.corpus import planted_partition_graph
    from smallk_torch.engines.graph import normalized_adjacency

    nodes, kc, seed = GRAPH_COMM
    G, labels = planted_partition_graph(nodes, kc, seed=seed)
    return G, labels, normalized_adjacency(G)


def graph_lanes_f64(Gn) -> None:
    """(b) R = GRAPH_F64_LANES lanes against the R unbatched solves from the
    same starts, f64 on the card (the community graph's root, the graph
    preset's solve options; captured at the auto U): factors within 1e-10
    relative, equal iterations and success, the same best lane."""
    import torch

    from smallk_torch.engines.graph import graph_clust_options
    from smallk_torch.engines.hierclust import _objective
    from smallk_torch.ops.aop import as_aop
    from smallk_torch.solvers import graph
    from smallk_torch.solvers.solve import nmf_solve

    op = as_aop(Gn, dtype="float64")
    m, n = op.shape
    opts = dataclasses.replace(graph_clust_options(GRAPH_COMM[1]).nmf_opts,
                               dtype="float64")
    g = torch.Generator(device="cuda")
    g.manual_seed(GRAPH_COMM[2])
    f64 = dict(dtype=torch.float64, device="cuda")
    W0 = torch.rand((GRAPH_F64_LANES, m, 2), generator=g, **f64)
    H0 = torch.rand((GRAPH_F64_LANES, 2, n), generator=g, **f64)
    graph.captures = 0
    lanes = nmf_solve(op, W0, H0, opts)
    singles = [nmf_solve(op, W0[r], H0[r], opts)
               for r in range(GRAPH_F64_LANES)]
    captures = graph.captures
    worst = 0.0
    for r, one in enumerate(singles):
        for a, b in ((lanes.W[r], one.W), (lanes.H[r], one.H)):
            worst = max(worst, float((a - b).abs().max() / b.abs().max()))
    ok = torch.as_tensor(lanes.success, device="cuda")
    best = int(torch.argmin(torch.where(ok, _objective(op, lanes.W, lanes.H),
                                        torch.inf)))
    best_one = int(np.argmin([
        float(_objective(op, one.W[None], one.H[None])[0])
        if one.success else np.inf for one in singles]))
    iters = [int(i) for i in lanes.iterations]
    log(f"[graph lanes f64] {GRAPH_F64_LANES} lanes against {GRAPH_F64_LANES} "
        f"single solves at {m}x{n}: iterations {iters} against "
        f"{[one.iterations for one in singles]}, success "
        f"{[bool(v) for v in lanes.success]}, best lane {best} against "
        f"{best_one}, max relative difference {worst:.3e} (tolerance 1e-10), "
        f"{captures} graphs captured")
    if (iters != [one.iterations for one in singles]
            or [bool(v) for v in lanes.success]
            != [one.success for one in singles]
            or best != best_one or not worst <= 1e-10):
        raise AssertionError("f64 lanes differ from the single solves")


def graph_runs(op, opts, seeds, labels) -> dict:
    """clust_hier on `op` for each engine seed, counted from 0: walls,
    NMIs, nmf_count, iter_count and the counts of the whole block."""
    import torch

    from smallk_torch import ClustStats, Random
    from smallk_torch.engines.hierclust import clust_hier
    from smallk_torch.engines.scoring import score_clustering

    walls, nmis, nmf, iters, leaves = [], [], 0, 0, []
    reset_counts()
    for seed in seeds:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree, stats = clust_hier(op, opts, Random(seed), ClustStats())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        nmis.append(score_clustering(tree.assignments, labels)["nmi"])
        nmf += stats.nmf_count
        iters += stats.iter_count
        leaves.append(int(sum(tree.is_leaf)))
    return {"walls": walls, "nmi": nmis, "nmf_count": nmf,
            "iter_count": iters, "leaves": leaves, "counts": read_counts()}


def graph_launch_gate(label: str, counts: dict, lanes: int) -> None:
    """K3 exactly: two lane-stacked products a step run (frozen steps too)
    and W'A once a solve, plus, with lanes, the lanes' scores' W'A once a
    solve; every product one launch through K3, none through
    torch.matmul, and with lanes every launch a lane launch."""
    want = 2 * counts["steps"] + counts["solves"] * (2 if lanes > 1 else 1)
    got = (counts["K3"], counts["kernel_products"], counts["K3_lanes"],
           counts["matmul_products"])
    expect = (want, want, want if lanes > 1 else 0, 0)
    log(f"[graph] {label}: K3 launches {counts['K3']} = 2 x {counts['steps']} "
        f"steps run + {2 if lanes > 1 else 1} x {counts['solves']} solves "
        f"(lane launches {counts['K3_lanes']}, products through "
        f"torch.matmul {counts['matmul_products']})")
    if got != expect:
        raise AssertionError(f"{label}: (K3, products through K3, lane "
                             f"launches, matmul products) {got}, expected "
                             f"{expect}")


def graph_community(card: str, Gn, labels) -> dict:
    """(c) the community cell, bench.py:222-252: graph_clust_options(20),
    f32, the operand built once, engine seeds GRAPH_SEEDS; then restarts 1
    against 3 on the same seeds, in turns (3, 1, 3) with the run above
    (depth cut from (1, 3, 3, 1) after it to keep the full run's time)."""
    from smallk_torch.engines.graph import graph_clust_options
    from smallk_torch.ops.aop import as_aop

    opts = graph_clust_options(GRAPH_COMM[1])
    op = as_aop(Gn, dtype="float32")
    run = graph_runs(op, opts, GRAPH_SEEDS, labels)
    c = run["counts"]
    med, worst = float(np.median(run["nmi"])), min(run["nmi"])
    splits = sum(v - 1 for v in run["leaves"])
    log(f"[graph community] {GRAPH_COMM[0]} nodes, {GRAPH_COMM[1]} "
        f"communities, restarts {opts.restarts}, seeds {GRAPH_SEEDS}: NMI "
        f"{[round(v, 4) for v in run['nmi']]}, median {med:.4f} (gate >= "
        f"{GRAPH_NMI_MEDIAN}), worst {worst:.4f} (gate >= "
        f"{GRAPH_NMI_WORST}); walls s {[round(v, 4) for v in run['walls']]}, "
        f"leaves {run['leaves']}, nmf_count {run['nmf_count']}, iter_count "
        f"{run['iter_count']}, steps run {c['steps']} in {c['solves']} "
        f"solves, host reads {c['host_reads']} ({c['host_reads'] / splits:.1f}"
        f" a split), graphs {c['captures']}, replays {c['replays']} on "
        f"{card}")
    graph_launch_gate("community cell", c, opts.restarts)
    if not (med >= GRAPH_NMI_MEDIAN and worst >= GRAPH_NMI_WORST):
        raise AssertionError(f"community NMI median {med}, worst {worst}")
    turns = {}
    for restarts in (1, 3):
        o = dataclasses.replace(opts, restarts=restarts)
        r = graph_runs(op, o, GRAPH_SEEDS, labels)
        graph_launch_gate(f"community cell, restarts {restarts}",
                          r["counts"], restarts)
        turns.setdefault(restarts, []).append(r)
        log(f"[graph restarts] restarts {restarts}: wall {sum(r['walls']):.4f}"
            f" s over {len(GRAPH_SEEDS)} seeds, host reads "
            f"{r['counts']['host_reads']}, steps run "
            f"{r['counts']['steps']}, K3 launches {r['counts']['K3']}, NMI "
            f"median {float(np.median(r['nmi'])):.4f}")
    return {"launches": c["K3"], "median": med, "worst": worst}


def graph_north_star(card: str) -> dict:
    """(d) the north-star cell, bench.py:254-302: 100 leaves of the
    planted 20,000-node graph, restarts 1, stall 25, tol 3e-4, e4m3 A
    prebuilt; a warm-up with Random(1), the best of two timed runs with
    Random(2)."""
    import torch

    from smallk_torch import ClustStats, Random
    from smallk_torch.engines.corpus import planted_partition_graph
    from smallk_torch.engines.graph import (graph_clust_options,
                                            normalized_adjacency)
    from smallk_torch.engines.hierclust import clust_hier
    from smallk_torch.engines.scoring import score_clustering
    from smallk_torch.ops.aop import as_aop

    nodes, kc, seed = GRAPH_STAR
    t0 = time.perf_counter()
    G, labels = planted_partition_graph(nodes, kc, seed=seed)
    Gn = normalized_adjacency(G)
    opts = graph_clust_options(kc, restarts=1)
    opts = dataclasses.replace(opts, nmf_opts=dataclasses.replace(
        opts.nmf_opts, stall_patience=25, tol=3e-4,
        a_dtype="float8_e4m3fn"))
    op = as_aop(Gn, dtype="float8_e4m3fn")
    torch.cuda.synchronize()
    build = time.perf_counter() - t0
    clust_hier(op, opts, Random(1))  # warm-up
    best = None
    for _ in range(2):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree, stats = clust_hier(op, opts, Random(2), ClustStats())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        if best is None or wall < best[0]:
            best = (wall, tree, stats, counts)
    wall, tree, stats, counts = best
    score = score_clustering(tree.assignments, labels)["nmi"]
    leaves = int(sum(tree.is_leaf))
    log(f"[graph north star] {nodes} nodes, {kc} communities, e4m3 A "
        f"({op.A.numel() * op.A.element_size() / 1e6:.0f} MB, built in "
        f"{build:.2f} s): best wall {wall:.4f} s, NMI {score:.4f} (gate >= "
        f"{GRAPH_STAR_NMI}; the numpy oracle's {GRAPH_ORACLE_NMI}, "
        f"bench.py:31), leaves {leaves}, nmf_count {stats.nmf_count}, "
        f"iter_count {stats.iter_count}, steps run {counts['steps']} in "
        f"{counts['solves']} solves, graphs {counts['captures']}, replays "
        f"{counts['replays']}, host reads {counts['host_reads']} "
        f"({counts['host_reads'] / max(leaves - 1, 1):.1f} a split) on "
        f"{card}")
    graph_launch_gate("north-star cell", counts, 1)
    if leaves != kc:
        raise AssertionError(f"north star: {leaves} leaves, expected {kc}")
    if not score >= GRAPH_STAR_NMI:
        raise AssertionError(f"north star: NMI {score}, gate "
                             f"{GRAPH_STAR_NMI}")
    return {"launches": counts["K3"], "wall": wall, "nmi": score}


def graph_cli(G, labels) -> None:
    """(e) the hierclust CLI's --graph preset on the card, the community
    graph written as a .mtx: exit 0 and NMI >= GRAPH_NMI_MEDIAN."""
    import scipy.io

    from smallk_torch.engines.scoring import score_clustering

    kc = GRAPH_COMM[1]
    with tempfile.TemporaryDirectory() as td:
        mtx = os.path.join(td, "graph.mtx")
        scipy.io.mmwrite(mtx, G)
        dic = os.path.join(td, "dict.txt")
        with open(dic, "w") as f:
            f.write("".join(f"v{i}\n" for i in range(G.shape[0])))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
        cmd = [sys.executable, "-m", "smallk_torch.cli.hierclust_cli",
               "--matrixfile", mtx, "--dictfile", dic, "--clusters",
               str(kc), "--graph", "--device", "cuda", "--verbose", "0",
               "--seed", str(GRAPH_CLI_SEED), "--outdir", td]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=td, env=env, capture_output=True,
                              text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"hierclust CLI --graph exited "
                                 f"{proc.returncode}:\n{proc.stdout}\n"
                                 f"{proc.stderr}")
        assign = np.loadtxt(os.path.join(td, f"assignments_{kc}.csv"),
                            delimiter=",", dtype=np.int64, ndmin=1,
                            max_rows=1)
    score = score_clustering(assign, labels)["nmi"]
    tail = proc.stdout.strip().splitlines()
    log(f"[graph cli] hierclust_cli --graph --clusters {kc} --device cuda "
        f"--seed {GRAPH_CLI_SEED} on the {G.shape[0]}-node graph: rc 0 in "
        f"{wall:.2f} s (the process's start and build load included), NMI "
        f"{score:.4f} (gate >= {GRAPH_NMI_MEDIAN}); {' '.join(tail[-2:])}")
    if not score >= GRAPH_NMI_MEDIAN:
        raise AssertionError(f"hierclust CLI --graph: NMI {score}")


def phase_graph(card: str) -> dict:
    """Graph community detection on the card (bench.py:218-302): (a) K3
    over lanes, (b) f64 lanes against single solves, (c) the community
    cell with restarts 1 against 3, (d) the north-star cell, (e) the
    CLI's --graph preset."""
    t0 = time.perf_counter()
    k3 = graph_k3()
    G, labels, Gn = community_graph()
    graph_lanes_f64(Gn)
    community = graph_community(card, Gn, labels)
    star = graph_north_star(card)
    graph_cli(G, labels)
    log(f"[graph] phase graph in {time.perf_counter() - t0:.1f} s")
    return {"k3": k3, "community": community, "star": star}


def graph_busy(card: str) -> None:
    """The device's busy share of the graph cells: one community seed at
    restarts 3 and at restarts 1, and one north-star run, each inside a
    profiler session of its own (after a warm run), in a process where no
    profiler ran before (torch's profiler loses records after earlier
    sessions in a process, PERF.md)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from smallk_torch import Random
    from smallk_torch.engines.corpus import planted_partition_graph
    from smallk_torch.engines.graph import (graph_clust_options,
                                            normalized_adjacency)
    from smallk_torch.engines.hierclust import clust_hier
    from smallk_torch.ops.aop import as_aop

    _, _, Gn = community_graph()
    comm = as_aop(Gn, dtype="float32")
    nodes, kc, seed = GRAPH_STAR
    star_opts = graph_clust_options(kc, restarts=1)
    star_opts = dataclasses.replace(star_opts, nmf_opts=dataclasses.replace(
        star_opts.nmf_opts, stall_patience=25, tol=3e-4,
        a_dtype="float8_e4m3fn"))
    star = as_aop(normalized_adjacency(planted_partition_graph(
        nodes, kc, seed=seed)[0]), dtype="float8_e4m3fn")
    cells = [(f"community seed {GRAPH_SEEDS[0]}, restarts {r}", comm,
              dataclasses.replace(graph_clust_options(GRAPH_COMM[1]),
                                  restarts=r), GRAPH_SEEDS[0])
             for r in (3, 1)]
    cells.append(("north star, Random(2)", star, star_opts, 2))
    for label, op, opts, rng_seed in cells:
        clust_hier(op, opts, Random(rng_seed))  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            clust_hier(op, opts, Random(rng_seed))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        profile_summary(prof, wall, f"graph {label} on {card}")


def graph_study(card: str) -> None:
    phase_graph(card)
    graph_busy(card)


def k3_study(card: str) -> None:
    """--k3: K3's checks and times alone (phase K3, phase graph (a))."""
    phase_k3()
    graph_k3()


def ell_inputs(g: int, L: int, B: int, k: int, vals_dtype: str,
               table_dtype: str, sentinel_share: float, seed: int):
    """A bucket on the card from a seed: minor ids in [0, B), a share of
    them the sentinel B (with value 0), values and a table in [0, 1)."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    cuda = dict(device="cuda", generator=gen)
    idx = torch.randint(0, B, (g, L), dtype=torch.int32, **cuda)
    if sentinel_share:
        idx[torch.rand((g, L), **cuda) < sentinel_share] = B
    vals = torch.rand((g, L), dtype=torch.float64, **cuda)
    vals = vals.masked_fill(idx == B, 0.0).to(getattr(torch, vals_dtype))
    table = torch.rand((B, k), dtype=torch.float64, **cuda).to(
        getattr(torch, table_dtype))
    return idx, vals, table


def ell_skewed_inputs(g: int, L: int, B: int, k: int, vals_dtype: str,
                      table_dtype: str, seed: int):
    """A bucket on the card whose rows have skewed lengths: row 0 all L
    entries, row r > 0 the first max(1, L u^3) (u uniform), the rest and a
    tenth of the others the sentinel B; values and a table in [0, 1)."""
    import torch

    idx, vals, table = ell_inputs(g, L, B, k, vals_dtype, table_dtype, 0.1,
                                  seed)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 1)
    lens = (L * torch.rand(g, generator=gen, device="cuda",
                           dtype=torch.float64) ** 3).long().clamp(min=1)
    lens[0] = L
    pad = torch.arange(L, device="cuda")[None, :] >= lens[:, None]
    idx[pad] = B
    return idx, vals.masked_fill(pad, 0), table


def ell_narrow_checks() -> tuple[float, float]:
    """The narrow-k and long-row plans against the plain version evaluated
    in f64, within ELL_TOL, every dtype pair, store and accumulate; one
    line per (k, L) with the worst relative distance and the f32 plain
    version's own distance to f64 beside it.  Row and transposed output
    bit-equal, and two launches bit-equal.  Returns the worst absolute and
    relative distances."""
    import torch

    from smallk_torch.kernels import ell_spmm as kmod

    worst_abs = worst_rel = 0.0
    for k in ELL_NARROW_K:
        for L, g in ELL_NARROW_L.items():
            plan = kmod.launch_plan(k, L, 4, 16)
            rels, plain_rels = [], []
            for p, (vt, tt) in enumerate(ELL_PAIRS):
                idx, vals, table = ell_skewed_inputs(
                    g, L, ELL_NARROW_B, k, vt, tt, seed=31 * k + L + p)
                acc = torch.float64 if vt == "float64" else torch.float32
                tol = ELL_TOL[vt if vt == "float64" else "float32"]
                gen = torch.Generator(device="cuda")
                gen.manual_seed(k + L)
                rows = torch.randperm(g + 3, generator=gen,
                                      device="cuda")[:g].to(torch.int32)
                out0 = torch.rand((g + 3, k), generator=gen, dtype=acc,
                                  device="cuda")
                wide = (idx, vals.double(), table.double())
                label = f"k={k} L={L} g={g} vals {vt} table {tt} {plan}"
                for accumulate in (False, True):
                    want = kmod.ell_spmm_reference(
                        *wide, out0.double().clone(), rows, accumulate)
                    plain = kmod.ell_spmm_reference(
                        idx, vals, table, out0.clone(), rows, accumulate)
                    before = kmod.launches
                    got = kmod.ell_spmm(idx, vals, table, out0.clone(), rows,
                                        accumulate)
                    again = kmod.ell_spmm(idx, vals, table, out0.clone(),
                                          rows, accumulate)
                    tr = kmod.ell_spmm(idx, vals, table, out0.T.contiguous(),
                                       rows, accumulate, transposed=True)
                    torch.cuda.synchronize()
                    if kmod.launches != before + 3:
                        raise AssertionError("ell_spmm did not launch its "
                                             "kernel")
                    scale = float(want.abs().max())
                    diff = float((got.double() - want).abs().max())
                    rel = diff / scale
                    plain_rels.append(float((plain.double() - want).abs()
                                            .max()) / scale)
                    if not (rel <= tol and bool(torch.isfinite(got).all())):
                        raise AssertionError(
                            f"ell_spmm {label} accumulate={accumulate}: "
                            f"{rel:.3e} from the f64 plain version "
                            f"(tolerance {tol:g})")
                    if not torch.equal(got, again):
                        raise AssertionError(f"ell_spmm {label}: two launches "
                                             "differ")
                    if not torch.equal(tr, got.T):
                        raise AssertionError(f"ell_spmm {label}: the "
                                             "transposed mode is not the row "
                                             "mode transposed")
                    rels.append(rel)
                    worst_abs, worst_rel = max(worst_abs, diff), max(worst_rel,
                                                                     rel)
                del idx, vals, table, want, plain, got, again, tr
            log(f"[ell_spmm] k={k} L={L} g={g} {plan} (chain "
                f"{plan.chain(L)}): relative distance to the f64 plain "
                f"version {max(rels):.2e} over the four dtype pairs, store "
                f"and accumulate (tolerance {ELL_TOL['float32']:g} f32, "
                f"{ELL_TOL['float64']:g} f64); the f32 plain version "
                f"{max(plain_rels):.2e}")
    log("[ell_spmm] narrow k and long rows: row and transposed output "
        "bit-equal, two launches bit-equal, in every case")
    return worst_abs, worst_rel


def phase_ell_spmm() -> dict:
    """ell_spmm against its plain version on ragged buckets (store and
    accumulate, every dtype pair), on the narrow-k and long-row plans
    (ell_narrow_checks) and at P1's and P2's shapes; times of the kernel,
    the plain version and torch.sparse.mm at the probes'."""
    import torch

    from smallk_torch.kernels import ell_spmm as kmod

    worst_abs = worst_rel = 0.0

    def check(label, got, want, tol):
        nonlocal worst_abs, worst_rel
        diff = float((got - want).abs().max())
        rel = diff / max(float(want.abs().max()), 1e-300)
        log(f"[ell_spmm] {label}: max|kernel - plain| = {diff:.3e}, "
            f"relative {rel:.3e} (tolerance {tol:g})")
        if not (rel <= tol and bool(torch.isfinite(got).all())):
            raise AssertionError(f"ell_spmm {label} disagrees with its "
                                 "plain version")
        worst_abs, worst_rel = max(worst_abs, diff), max(worst_rel, rel)

    def launch(args, out0, rows, accumulate, transposed, label, tol):
        """One launch in the given layout, against the plain version."""
        want = kmod.ell_spmm_reference(*args, out0.clone(), rows, accumulate,
                                       transposed)
        before = kmod.launches
        got = kmod.ell_spmm(*args, out0.clone(), rows, accumulate, transposed)
        torch.cuda.synchronize()
        if kmod.launches != before + 1:
            raise AssertionError("ell_spmm did not launch its kernel")
        check(f"{label} {'transposed' if transposed else 'row'} "
              f"{'accumulate' if accumulate else 'store'}", got, want, tol)
        return got

    for i, (g, L, B, k, vt, tt) in enumerate(ELL_RAGGED):
        idx, vals, table = ell_inputs(g, L, B, k, vt, tt, 0.3, seed=i)
        acc = torch.float64 if vt == "float64" else torch.float32
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1000 + i)
        rows = torch.randperm(g + 7, generator=gen, device="cuda")[:g].to(
            torch.int32)
        out0 = torch.rand((g + 7, k), generator=gen, dtype=acc, device="cuda")
        label = f"g={g} L={L} B={B} k={k} vals {vt} table {tt}"
        tol = ELL_TOL[vt if vt == "float64" else "float32"]
        for accumulate in (False, True):
            row = launch((idx, vals, table), out0, rows, accumulate, False,
                         label, tol)
            tr = launch((idx, vals, table), out0.T.contiguous(), rows,
                        accumulate, True, label, tol)
            if not torch.equal(tr, row.T):
                raise AssertionError(f"ell_spmm {label}: the transposed mode "
                                     "is not the row mode transposed")
    log("[ell_spmm] row and transposed output bit-equal to each other on "
        "every ragged bucket")
    narrow_abs, narrow_rel = ell_narrow_checks()
    worst_abs, worst_rel = max(worst_abs, narrow_abs), max(worst_rel,
                                                           narrow_rel)

    probes = {}
    for p, (name, (G, L, B, k, vt, tt)) in enumerate(ELL_PROBES.items()):
        idx, vals, table = ell_inputs(G, L, B, k, vt, tt, 0.0, seed=100 + p)
        out = torch.empty((G, k), dtype=torch.float32, device="cuda")

        def kernel():
            return kmod.ell_spmm(idx, vals, table, out)

        def plain_version():
            return kmod.ell_spmm_reference(idx, vals, table, out)

        got = kernel().clone()
        check(f"{name} G={G} L={L} B={B} k={k} vals {vt} table {tt}", got,
              plain_version(), ELL_TOL["float32"])
        tr = launch((idx, vals, table), torch.zeros((k, G), device="cuda"),
                    None, False, True, name, ELL_TOL["float32"])
        if not torch.equal(tr, got.T):
            raise AssertionError(f"ell_spmm {name}: the transposed mode is "
                                 "not the row mode transposed")
        # the library call: torch.sparse.mm on the bucket as an f32 CSR
        # (duplicate ids summed) and the table in f32, built beforehand
        rows = torch.arange(G, device="cuda").repeat_interleave(L)
        csr = torch.sparse_coo_tensor(
            torch.stack([rows, idx.reshape(-1).long()]),
            vals.reshape(-1).float(), (G, B)).coalesce().to_sparse_csr()
        table32 = table.float()
        lib = torch.sparse.mm(csr, table32)
        lib_rel = float((lib - got).abs().max() / got.abs().max())
        if not lib_rel <= 1e-4:  # the same function, summed another way
            raise AssertionError(f"{name}: torch.sparse.mm differs by "
                                 f"{lib_rel}")
        ms, plain = device_ms(kernel, 50), device_ms(plain_version, 5)
        library = back_to_back_ms(lambda: torch.sparse.mm(csr, table32), 20)
        ms_b2b = back_to_back_ms(kernel, 50)
        # what these inputs need: 2 k operations per stored entry; idx,
        # vals and the table read once, out written once
        nnz = int((idx < B).sum())
        nbytes = (idx.numel() * 4 + vals.numel() * vals.element_size()
                  + table.numel() * table.element_size() + G * k * 4)
        b_ms, b_by = bound(2.0 * nnz * k, nbytes)
        probes[name] = {"ms": ms, "plain_ms": plain, "library_ms": library,
                        "bound_ms": b_ms, "bound_by": b_by}
        log(f"[ell_spmm time] {name} G={G} L={L} B={B} k={k} vals {vt} "
            f"table {tt}: device ms per call kernel {ms:.4f} ({nnz / ms / 1e6:.2f}"
            f" Gnnz/s, {nnz * k * table.element_size() / 1e9:.3f} GB of "
            f"gathered rows at {nnz * k * table.element_size() / ms / 1e9:.2f}"
            f" TB/s; back to back {ms_b2b:.4f}), plain {plain:.4f}, "
            f"library torch.sparse.mm on the bucket as an f32 CSR {library:.4f} "
            f"(back to back; max rel diff {lib_rel:.1e}); bound {b_ms:.4f} ms "
            f"({b_by})")
    return {"max_abs_err": worst_abs, "max_rel_err": worst_rel,
            "probes": probes}


def seg_inputs(cap, n_live, n_keys, k, B, heavy, L0, vt, tt, seed):
    """seg_spmm's inputs on the card, the term pass's (ptr, gather, val,
    table) and the chunk pass's (starts, lens, rows, vals, table): for the
    term pass n_live entries sorted by key over n_keys, a share `heavy` of
    them on one key, as offsets; for the chunk pass n_keys slots of 0 to
    about twice their share of cap / L0 chunks, each chunk's live length
    L0 (70%) or less, the padding holding valid indices; gather indices
    with ~10% sentinels, values in `vt` and a (B, k) table in `tt`."""
    import torch

    rng = np.random.RandomState(seed)
    key = np.sort(rng.randint(0, n_keys, n_live))
    if heavy:
        lo = int(n_live * 0.3)
        key[lo:lo + int(heavy * n_live)] = key[lo]
        key = np.sort(key)
    chunks = cap // L0
    cnt = rng.randint(0, 2 * max(1, int(0.9 * chunks / n_keys)) + 1, n_keys)
    cnt[np.cumsum(cnt) > chunks] = 0
    lens = np.where(rng.rand(chunks) < 0.7, L0, rng.randint(0, L0 + 1,
                                                             chunks))
    dev, i32 = "cuda", torch.int32

    def entries(n):
        idx = rng.randint(0, B, n)
        idx[rng.rand(n) < 0.1] = B
        return (torch.from_numpy(idx).to(dev, i32),
                torch.from_numpy(rng.rand(n) + 0.1).to(dev).float().to(
                    getattr(torch, vt)))

    table = torch.from_numpy(rng.rand(B, k)).to(dev).to(getattr(torch, tt))
    starts = np.concatenate([[0], np.cumsum(cnt)])
    return ((torch.from_numpy(np.searchsorted(key, np.arange(n_keys + 1)))
             .to(dev, i32), *entries(cap), table),
            (torch.from_numpy(starts).to(dev, i32),
             torch.from_numpy(lens).to(dev, i32), *entries(chunks * L0),
             table))


def within_rows(got, want, rowsum, rowlen, tol: float, grow: bool):
    """Each output entry of a sum against the plain version evaluated in
    f64 (`want`), on its own terms: |got - want| at most `tol` times that
    entry's sum of |val * table| (`rowsum`), grown, for an f32 sum (`grow`),
    as the square root of its segment's entries (`rowlen`) past 128, as the
    rounding of a long sum of positive terms grows.  A key no entry has
    must come out 0.  Returns (within, the largest error as a share of its
    entry's rowsum)."""
    err = (got.double() - want).abs()
    grown = (rowlen.double() / 128).clamp(min=1.0).sqrt() if grow else 1.0
    within = bool((err <= tol * grown * rowsum).all())
    share = (float((err / rowsum.clamp(min=1e-300)).max()) if err.numel()
             else 0.0)
    return within, share


def phase_seg_spmm() -> dict:
    """seg_spmm's two passes (the term pass and the chunk pass) against
    their plain versions (evaluated in f64) on SEG_CASES at every dtype
    pair, row and transposed output: within within_rows, two launches
    bit-equal, and an eager launch bit-equal to a captured one (a CUDA
    graph replayed)."""
    import torch

    from smallk_torch.kernels import seg_spmm as kmod

    passes = (("term", kmod.seg_spmm, kmod.seg_spmm_reference),
              ("chunk", kmod.chunk_spmm, kmod.chunk_spmm_reference))
    worst_abs = worst_rel = 0.0
    for i, (cap, n_live, n_keys, k, B, heavy, L0) in enumerate(SEG_CASES):
        for vt, tt in SEG_PAIRS:
            inputs = seg_inputs(cap, n_live, n_keys, k, B, heavy, L0, vt, tt,
                                seed=i)
            acc = kmod.sum_dtype(inputs[0][-1].dtype)
            for (name, fn, ref), args in zip(passes, inputs):
                for tr in (False, True):
                    shape = (k, n_keys) if tr else (n_keys, k)
                    before = kmod.launches
                    got = fn(*args, torch.empty(shape, dtype=acc,
                                                device="cuda"), tr)
                    again = fn(*args, torch.empty_like(got), tr)
                    captured = torch.empty_like(got)
                    graph = torch.cuda.CUDAGraph()
                    side = torch.cuda.Stream()
                    side.wait_stream(torch.cuda.current_stream())
                    with torch.cuda.stream(side), torch.cuda.graph(graph):
                        fn(*args, captured, tr)
                    torch.cuda.current_stream().wait_stream(side)
                    graph.replay()
                    torch.cuda.synchronize()
                    if kmod.launches != before + 3:
                        raise AssertionError("seg_spmm did not launch its "
                                             "kernel")
                    # the plain version in f64, each entry's sum of
                    # |val * table| and its segment's entries, in out's
                    # layout
                    val, table = args[-2], args[-1]
                    one = torch.ones((), dtype=torch.float64, device="cuda")
                    want, rowsum, rowlen = (
                        ref(*args[:-2], v, t, torch.empty(
                            shape, dtype=torch.float64, device="cuda"), tr)
                        for v, t in ((val.double(), table.double()),
                                     (val.double().abs(),
                                      table.double().abs()),
                                     (one.expand(val.shape),
                                      one.expand(table.shape))))
                    diff = float((got.double() - want).abs().max()) \
                        if got.numel() else 0.0
                    tol = SEG_TOL[str(acc)[6:]]
                    within, rel = within_rows(got, want, rowsum, rowlen, tol,
                                              acc == torch.float32)
                    label = (f"{name} pass, cap={cap} live={n_live} "
                             f"keys={n_keys} k={k} B={B} heavy={heavy} L0={L0}"
                             f" vals {vt} table {tt} "
                             f"{'transposed' if tr else 'row'}")
                    if not (within and torch.equal(got, again)
                            and torch.equal(got, captured)
                            and bool(torch.isfinite(got).all())):
                        raise AssertionError(
                            f"seg_spmm {label}: worst entry {rel:.3e} of its "
                            f"sum of |val * table| (tolerance {tol:g}, f32 "
                            f"grown by its segment), two launches "
                            f"{'equal' if torch.equal(got, again) else 'DIFFER'}"
                            f", captured "
                            f"{'equal' if torch.equal(got, captured) else 'DIFFERS'}")
                    worst_abs = max(worst_abs, diff)
                    worst_rel = max(worst_rel, rel)
        log(f"[seg_spmm] case {i}: cap={cap} live={n_live} keys={n_keys} k={k}"
            f" B={B} heavy={heavy} L0={L0}, both passes, every pair "
            f"{SEG_PAIRS} and layout: within tolerance, two launches and "
            f"eager against captured bit-equal")
    log(f"[seg_spmm] max|kernel - plain (f64)| {worst_abs:.3e}; the worst "
        f"entry {worst_rel:.3e} of its sum of |val * table|")
    return {"max_abs_err": worst_abs, "max_rel_err": worst_rel}


def phase_sparse_parity() -> None:
    """run_nmf BPP and MU in f64 on a blocked EllAOp, the card (through
    ell_spmm) against the CPU (its plain version), and on a SparseAOp
    (torch ops on both; on the card index_add_ sums in no fixed order)."""
    import scipy.sparse as sp

    from smallk_torch import NmfAlgorithm, NmfOptions, NmfStats, Random
    from smallk_torch import random_matrix
    from smallk_torch.engines.nmf import run_nmf
    from smallk_torch.ops.aop import SparseAOp
    from smallk_torch.ops.ell import EllAOp

    A = sp.random(SP_M, SP_N, density=0.01, random_state=21, format="csc")
    blocks = dict(doc_block=1024, term_block=256)
    ell = {d: EllAOp.from_scipy(A, "float64", device=d, **blocks)
           for d in ("cuda", "cpu")}
    coo = {d: SparseAOp.from_scipy(A, "float64", device=d)
           for d in ("cuda", "cpu")}
    rng = Random(7)
    W0 = random_matrix(SP_M, SP_K, rng)
    H0 = random_matrix(SP_K, SP_N, rng)
    for ops, algorithm in ((ell, NmfAlgorithm.BPP), (ell, NmfAlgorithm.MU),
                           (coo, NmfAlgorithm.BPP), (coo, NmfAlgorithm.MU)):
        kind = ("a blocked EllAOp" if ops is ell else "a SparseAOp")
        per_iter = ell_launches_per_iteration(ops["cuda"]) if ops is ell \
            else 0
        opts = NmfOptions(tol=1e-30, algorithm=algorithm, height=SP_M,
                          width=SP_N, k=SP_K, min_iter=1, max_iter=30,
                          verbose=False, dtype="float64")
        runs = {}
        for device in ("cuda", "cpu"):
            stats = NmfStats()
            reset_counts()
            W, H, ok = run_nmf(ops[device], W0, H0, opts, stats,
                               device=device)
            runs[device] = (W, H, ok, stats, read_counts())
        (Wc, Hc, okc, sc, cc), (Wh, Hh, okh, sh, ch) = runs["cuda"], runs[
            "cpu"]
        dW, dH = float(np.abs(Wc - Wh).max()), float(np.abs(Hc - Hh).max())
        log(f"[sparse f64] run_nmf {algorithm.value} on {kind} "
            f"{SP_M}x{SP_N} nnz={A.nnz} k={SP_K}: cuda vs cpu max|dW| = "
            f"{dW:.3e}, max|dH| = {dH:.3e} (atol {SLICE_ATOL:g}), iterations "
            f"{sc.iteration_count}/{sh.iteration_count}, ell_spmm launches "
            f"{cc['ell_spmm']}/{ch['ell_spmm']}, plain calls on cuda "
            f"{cc['ell_plain_cuda']}")
        np.testing.assert_allclose(Wc, Wh, rtol=0, atol=SLICE_ATOL)
        np.testing.assert_allclose(Hc, Hh, rtol=0, atol=SLICE_ATOL)
        if not (okc and okh) or sc.iteration_count != sh.iteration_count:
            raise AssertionError("sparse parity runs failed or differ")
        if (cc["ell_spmm"] < per_iter * sc.iteration_count
                or (ops is coo and cc["ell_spmm"])
                or cc["ell_plain_cuda"] or ch["ell_spmm"]):
            raise AssertionError(f"ell_spmm counts: cuda {cc}, cpu {ch}")


def ell_launches_per_iteration(op) -> int:
    """Kernel launches of one W'A and one AH': one per bucket, of every
    minor block."""
    def family(buckets, blocks):
        if blocks is None:
            return len(buckets)
        return sum(len(b) for _, b in blocks)

    return (family(op.col_buckets, op.col_blocks)
            + family(op.row_buckets, op.row_blocks))


def flagship_problem():
    """bench.py:164-176's corpus, made from its seed (80 row draws per
    column, duplicates summed), and the port's W0, H0 from Random(5)."""
    import scipy.sparse as sp

    from smallk_torch import Random, random_matrix

    m, n, nzc = FLAG_M, FLAG_N, FLAG_NZ
    gs = np.random.RandomState(9)
    A = sp.csc_matrix(
        (gs.rand(n * nzc).astype(np.float32),
         gs.randint(0, m, n * nzc).astype(np.int32),
         np.arange(0, n * nzc + 1, nzc, dtype=np.int64)),
        shape=(m, n))
    A.sum_duplicates()
    rng = Random(5)
    return (A, random_matrix(m, FLAG_K, rng, dtype=np.float32),
            random_matrix(FLAG_K, n, rng, dtype=np.float32))


@contextlib.contextmanager
def plain_ell():
    """EllAOp's and ChunkColsAOp's products (and an archived tree's
    GatheredColsAOp's) through
    ell_spmm's and seg_spmm's plain versions, bucket by bucket and block by
    block as the kernel runs them (on the card, counted as plain calls).  Each entry
    point an operand module imports is swapped for its plain version, so
    an archived tree's package (`--times`) is swapped too."""
    from smallk_torch.kernels import ell_spmm as kmod
    from smallk_torch.ops import ell, ell_cols

    plain = {"ell_spmm": kmod.ell_spmm_reference,
             "ell_spmm_buckets": getattr(kmod, "ell_spmm_buckets_reference",
                                         None)}
    if hasattr(ell_cols, "seg_spmm"):  # an archived tree may have none
        from smallk_torch.kernels import seg_spmm as smod

        plain["seg_spmm"] = smod.seg_spmm_reference
        if hasattr(smod, "chunk_spmm"):
            plain["chunk_spmm"] = smod.chunk_spmm_reference
    saved = [(mod, name, getattr(mod, name)) for mod in (ell, ell_cols)
             for name in plain if hasattr(mod, name)]
    for mod, name, _ in saved:
        setattr(mod, name, plain[name])
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def sparse_rel_err(op, W, H) -> float:
    """||A - W H||_F / ||A||_F without a dense W H: ||A||^2 - 2 <W'A, H> +
    <W'W, HH'>, in f64, with A's stored values and W'A from the plain
    version (so that a kernel fault cannot hide in the gate)."""
    import torch

    W = torch.as_tensor(W, device="cuda")
    H = torch.as_tensor(H, device="cuda")
    vals = ([v for _, _, v in op.col_buckets] if op.col_blocks is None
            else [v for _, b in op.col_blocks for _, _, v in b])
    a2 = sum(float(v.double().square().sum()) for v in vals)
    with plain_ell():
        cross = float((op.mm_tn(W).double() * H.double()).sum())
    Wd, Hd = W.double(), H.double()
    quad = float(((Wd.T @ Wd) * (Hd @ Hd.T)).sum())
    return (max(a2 - 2.0 * cross + quad, 0.0) / a2) ** 0.5


def k1_round_ms(sides: dict) -> dict:
    """K1's device ms for one full-width round of each BPP side at the
    flagship shape, and its bound: `sides` maps "H" to (LHS, RHS) of shape
    (k, k), (k, n) and "W" to those of (k, k), (k, m), on the card; half
    the entries are made passive.  The round's first FLAG_K1_CHECK columns
    (all of the W side's) are held against the plain version on the same
    columns (the columns are independent systems) with tolerance 0, for
    both device kernels.  At the W side's width it also times the narrow
    kernel; at both sides the plain version and the library call, one
    torch.linalg.solve_ex of the (n, k, k) batch of masked systems built
    beforehand (3.3 GB at (128, 50,000)), on the first FLAG_K1_CHECK
    columns and scaled by n / FLAG_K1_CHECK (the H side's whole batch
    would be 64 GB).  A round with every entry passive (q = k, the
    first solve from a positive start) is timed beside it."""
    import torch

    from smallk_torch.kernels import masked_gj
    from smallk_torch.kernels.masked_gj import (
        masked_gj_solve, masked_gj_solve_reference)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    out = {}
    for side, (LHS, RHS) in sides.items():
        RHS = RHS.contiguous()
        k, n = RHS.shape
        passive = torch.rand(RHS.shape, generator=gen, device="cuda") < 0.5
        c = min(n, FLAG_K1_CHECK)
        Xr = masked_gj_solve_reference(LHS, RHS[:, :c].contiguous(),
                                       passive[:, :c].contiguous())
        errs = {}
        for which, solve, cols in (("masked_gj_solve", masked_gj_solve, n),
                                   ("wide", masked_gj._launch_wide, c),
                                   ("narrow", masked_gj._launch_narrow, c)):
            X = solve(LHS, RHS[:, :cols].contiguous(),
                      passive[:, :cols].contiguous())[:, :c]
            errs[which] = float((X - Xr).abs().max())
            del X
        log(f"[flagship K1] {side} side (k={k}, first {c} of {n} columns): "
            f"max|kernel - plain|: " + ", ".join(
                f"{w} {e:.3e}" for w, e in errs.items()) + " (tolerance 0)")
        if any(e != 0.0 for e in errs.values()):
            raise AssertionError(f"flagship K1 {side} side differs from the "
                                 f"plain version: {errs}")
        del Xr
        res = {"ms": back_to_back_ms(
                   lambda: masked_gj_solve(LHS, RHS, passive), 3),
               "err": max(errs.values())}
        res["bound_ms"], res["bound_by"] = k1_bound(passive)
        full = torch.ones_like(passive)
        res["all_passive_ms"] = back_to_back_ms(
            lambda: masked_gj_solve(LHS, RHS, full), 2)
        res["all_passive_bound_ms"] = k1_bound(full)[0]
        del full
        if n <= FLAG_K1_CHECK:
            res["narrow_ms"] = back_to_back_ms(
                lambda: masked_gj._launch_narrow(LHS, RHS, passive), 3)
        # the plain version and the library call on the first c columns,
        # scaled by n / c (the H side's whole batch would be 64 GB)
        Rc, Pc = RHS[:, :c].contiguous(), passive[:, :c].contiguous()
        scale = n / c
        res["plain_ms"] = scale * back_to_back_ms(
            lambda: masked_gj_solve_reference(LHS, Rc, Pc), 1)
        p = Pc.to(LHS.dtype).T.contiguous()          # (c, k)
        M = LHS[None] * p[:, :, None]
        M *= p[:, None, :]
        M.diagonal(dim1=1, dim2=2).add_(1.0 - p)
        b = (Rc.T * p)[:, :, None].contiguous()
        X = masked_gj_solve(LHS, Rc, Pc)
        lib = torch.linalg.solve_ex(M, b)[0][:, :, 0].T
        res["library_rel"] = float((lib - X).abs().max() / X.abs().max())
        del X, lib
        res["library_ms"] = scale * back_to_back_ms(
            lambda: torch.linalg.solve_ex(M, b), 2)
        del M, b, p, Rc, Pc
        if not res["library_rel"] <= 1e-2:  # another elimination order
            raise AssertionError("K1 library solve differs by "
                                 f"{res['library_rel']}")
        out[side] = res
        scaled = f" (scaled from {c} columns by {scale:.3f})" if c < n else ""
        extra = (f"; narrow kernel {res['narrow_ms']:.2f}" if "narrow_ms" in
                 res else "") + (
            f"; plain {res['plain_ms']:.2f}, library torch.linalg.solve_ex on "
            f"the (n, k, k) batch {res['library_ms']:.2f}{scaled} (max rel "
            f"diff {res['library_rel']:.1e})")
        log(f"[flagship K1] {side} side (k, {n}), device ms per full-width "
            f"round, half the entries passive: {res['ms']:.2f} (bound "
            f"{res['bound_ms']:.3f}, {res['bound_by']}){extra}; every entry "
            f"passive: {res['all_passive_ms']:.2f} (bound "
            f"{res['all_passive_bound_ms']:.3f})")
    return out


def nnls_gate_sweep(card: str) -> None:
    """nnls_blockpivot in f32 with its rounds narrowed to the columns still
    not optimal and at full width, over ranks and widths on both sides of
    its gate (k n >= _NARROW_MIN_ENTRIES): wall ms per call, the best of
    four, the two bodies alternating.  What the gate is set from."""
    import torch

    from smallk_torch.solvers import nnls

    gate = nnls._NARROW_MIN_ENTRIES

    def wall_ms(args, narrowed: bool):
        nnls._NARROW_MIN_ENTRIES = 0 if narrowed else 1 << 62
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = nnls.nnls_blockpivot(*args)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3, out
        finally:
            nnls._NARROW_MIN_ENTRIES = gate

    for k in NNLS_SWEEP_K:
        for n in NNLS_SWEEP_N:
            rng = np.random.RandomState(k + n)
            B = rng.rand(k, 2 * k)
            args = [torch.tensor(a, dtype=torch.float32, device="cuda")
                    for a in (B @ B.T + 0.1 * np.eye(k),
                              B @ rng.rand(2 * k, n)
                              - 0.3 * B.sum(1, keepdims=True),
                              rng.rand(k, n) - 0.5)]
            best = {True: float("inf"), False: float("inf")}
            outs = {}
            for narrowed in (True, False) * 4:  # the first pair warms up
                ms, outs[narrowed] = wall_ms(args, narrowed)
                best[narrowed] = min(best[narrowed], ms)
            (Xn, _, okn, rn), (Xf, _, okf, rf) = outs[True], outs[False]
            if not (torch.equal(Xn, Xf) and bool(okn) and bool(okf)
                    and rn == rf):
                raise AssertionError(f"nnls sweep k={k} n={n}: the narrowed "
                                     "and the full-width rounds disagree")
            picked = "narrowed" if k * n >= gate else "full width"
            log(f"[nnls sweep f32] k={k} n={n}: {int(rn)} rounds, wall ms per "
                f"call: narrowed {best[True]:.3f}, full width "
                f"{best[False]:.3f}; nnls_blockpivot takes the {picked} "
                f"rounds (k n = {k * n}, gate {gate}) on {card}")


def k1_study(card: str) -> None:
    """--k1: K1 alone.  Both device kernels against the plain version and
    side by side (phase_kernel), then full-width rounds at the flagship's
    two shapes on synthetic systems (k1_inputs' Gram, right-hand sides made
    on the card)."""
    import torch

    phase_kernel()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    k = FLAG_K
    B = torch.rand((k, 2 * k), generator=gen, device="cuda")
    LHS = B @ B.T + 0.1 * torch.eye(k, device="cuda")
    sides = {side: (LHS, B @ torch.rand((2 * k, n), generator=gen,
                                        device="cuda"))
             for side, n in (("W", FLAG_M), ("H", FLAG_N))}
    k1_round_ms(sides)
    del sides
    nnls_gate_sweep(card)
    log(f"[k1] on {card}")


def phase_flagship(card: str) -> dict:
    """MU and BPP at k = 128 on the uncut 50,000 x 1,000,000 bf16 EllAOp,
    timed as bench.py times the reference (two-point fits), with the
    gates and the launches counted over the timed runs."""
    import torch

    from smallk_torch import NmfAlgorithm, NmfOptions, NmfStats
    from smallk_torch.engines.nmf import run_nmf
    from smallk_torch.ops.ell import EllAOp

    t0 = time.perf_counter()
    A, W0, H0 = flagship_problem()
    gen_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    op = EllAOp.from_scipy(A, "bfloat16", device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    nnz = A.nnz
    at_csr = transposed_csr(A)  # the library call's operand (W'A)
    del A
    per_iter = ell_launches_per_iteration(op)
    tn_per = sum(p.launching for _, _, p in op.col_packs)
    nt_per = sum(p.launching for _, _, p in op.row_packs)
    op_bytes = torch.cuda.memory_allocated()
    log(f"[flagship] {FLAG_M}x{FLAG_N} nnz={nnz} bf16 EllAOp: corpus made "
        f"in {gen_s:.2f} s, operand built (tocsr, buckets, "
        f"{len(op.row_blocks or ())} doc blocks of {op.row_block_size}, "
        f"host to card) in {build_s:.2f} s; padded entries {op.padded_nnz}, "
        f"{per_iter} kernel launches per W'A + AH', {op_bytes / 1e9:.3f} GB "
        f"on the card")

    W = torch.from_numpy(W0).cuda()
    H = torch.from_numpy(H0).cuda()
    # each product through the kernel and through the plain version on the
    # same buckets and blocks: W'A one monolithic family, AH' the blocked
    # one (the accumulate launches)
    worst_abs = 0.0
    for name, product, F in (("W'A", op.mm_tn, W), ("AH'", op.mm_nt, H)):
        got = product(F)
        with plain_ell():
            want = product(F)
        diff = float((got - want).abs().max())
        rel = diff / float(want.abs().max())
        finite = bool(torch.isfinite(got).all())
        log(f"[flagship] {name} {tuple(got.shape)} through ell_spmm against "
            f"its plain version: max|kernel - plain| = {diff:.3e}, relative "
            f"{rel:.3e} (tolerance {ELL_TOL['float32']:g})")
        if not (rel <= ELL_TOL["float32"] and finite):
            raise AssertionError(f"flagship {name}: ell_spmm disagrees with "
                                 "its plain version")
        worst_abs = max(worst_abs, diff)
        del got, want
    tn_ms = back_to_back_ms(lambda: op.mm_tn(W), 5)
    nt_ms = back_to_back_ms(lambda: op.mm_nt(H), 5)
    # AH''s bound: 2 nnz k operations; values and ids once, H once, the
    # (m, k) product once
    nt_bound, nt_by = bound(2.0 * nnz * FLAG_K,
                            nnz * (2 + 4) + 4 * FLAG_K * (FLAG_N + FLAG_M))
    log(f"[flagship] products at k={FLAG_K}: W'A {tn_ms:.3f} ms, AH' "
        f"{nt_ms:.3f} ms (bound {nt_bound:.4f} ms, {nt_by}) "
        f"({nnz / ((tn_ms + nt_ms) / 2) / 1e6:.3f} Gnnz/s "
        f"each on average; {nnz * FLAG_K * 4 / 1e9:.2f} GB of gathered "
        f"table rows each, at {nnz * FLAG_K * 4 / tn_ms / 1e9:.2f} and "
        f"{nnz * FLAG_K * 4 / nt_ms / 1e9:.2f} TB/s)")
    wta = flagship_wta(op, W, at_csr)
    del at_csr
    # K1's full-width rounds on the real Grams and right-hand sides
    k1_rounds = k1_round_ms({"H": (W.T @ W, op.mm_tn(W)),
                             "W": (H @ H.T, op.mm_nt(H).T)})
    del W, H

    launches = wta_launches = k1_launches = 0
    rates, k1_stats = {}, {}
    for alg, iters in (("MU", FLAG_MU_ITERS), ("BPP", FLAG_BPP_ITERS)):
        opts = NmfOptions(tol=1e-30, algorithm=NmfAlgorithm(alg),
                          height=FLAG_M, width=FLAG_N, k=FLAG_K, min_iter=1,
                          max_iter=1, verbose=False, a_dtype="bfloat16")
        walls, rel = {}, {}
        # the 1-iteration run gives the gate's reference error (for MU it
        # is also the warm-up); each run is counted from zero
        for it in sorted({1, *iters}):
            stats = NmfStats()
            reset_counts()
            W, H, ok = run_nmf(op, W0, H0,
                               dataclasses.replace(opts, max_iter=it), stats,
                               device="cuda")
            counts = read_counts()
            walls[it] = stats.elapsed_us / 1e6
            if not ok or stats.iteration_count != it:
                raise AssertionError(f"flagship {alg} {it} iterations: "
                                     f"success={ok}, ran "
                                     f"{stats.iteration_count}")
            for name, F in (("W", W), ("H", H)):
                if not np.isfinite(F).all() or (F < 0).any():
                    raise AssertionError(f"flagship {alg}: {name} is not "
                                         "finite and nonnegative")
            rel[it] = sparse_rel_err(op, W, H)
            if alg == "MU" and it == iters[-1]:
                mu_factors = (W, H)   # the embedding tables' (phase_facade)
            # K1's columns beyond the two first solves of each iteration:
            # full-width rounds would make them rounds x n
            round_cols = counts["K1_columns"] - it * (FLAG_N + FLAG_M)
            rounds_txt = (f", pivot rounds {stats.pivot_rounds} "
                          f"({stats.pivot_rounds / it:.1f} per iteration), "
                          f"K1 columns {counts['K1_columns']} "
                          f"({counts['K1_columns'] / it:.0f} per iteration; "
                          f"{round_cols} in the rounds, "
                          f"{round_cols / max(stats.pivot_rounds, 1):.0f} "
                          f"per round)" if alg == "BPP" else "")
            log(f"[flagship] {alg} {it} iteration(s): solve {walls[it]:.3f} "
                f"s, rel err {rel[it]:.6f}, ell_spmm launches "
                f"{counts['ell_spmm']} ({counts['ell_spmm_transposed']} "
                f"transposed: W'A), K1 launches {counts['K1']}, plain "
                f"calls on cuda {counts['ell_plain_cuda']}{rounds_txt}")
            # a W'A (written transposed) and an AH' a step run, and W'A
            # once more for the solver's state before iteration 0
            steps = counts["steps"]
            if counts["ell_spmm"] != nt_per * steps + tn_per * (steps + 1) \
                    or counts["ell_plain_cuda"] or steps < it:
                raise AssertionError(f"flagship {alg}: products bypassed "
                                     f"ell_spmm ({counts})")
            if counts["ell_spmm_transposed"] != tn_per * (steps + 1):
                raise AssertionError(f"flagship {alg}: W'A was not written "
                                     f"transposed ({counts})")
            want_k1 = 2 * steps if alg == "BPP" else 0
            if counts["K1"] < want_k1 or (not want_k1 and counts["K1"]):
                raise AssertionError(f"flagship {alg}: K1 launches {counts}")
            if alg == "BPP":
                if counts["K1"] != want_k1 + stats.pivot_rounds:
                    raise AssertionError(
                        f"flagship BPP: {counts['K1']} K1 launches for "
                        f"{stats.pivot_rounds} rounds in {it} iteration(s)")
                if not 0 < round_cols < stats.pivot_rounds * FLAG_N:
                    raise AssertionError(
                        f"flagship BPP: the rounds solved {round_cols} "
                        f"columns, not fewer than {stats.pivot_rounds} "
                        "full-width rounds")
                k1_stats[it] = (stats.pivot_rounds, counts["K1"],
                                counts["K1_columns"])
            if it in iters:
                launches += counts["ell_spmm"]
                wta_launches += counts["ell_spmm_transposed"]
                k1_launches += counts["K1"]
        lo, hi = iters[0], iters[-1]
        if not rel[hi] < rel[1]:
            raise AssertionError(f"flagship {alg}: rel err {rel[hi]} after "
                                 f"{hi} iterations not below the "
                                 f"1-iteration {rel[1]}")
        rates[alg] = (hi - lo) / max(walls[hi] - walls[lo], 1e-9)
        k1_txt = "".join(
            f"; {it} iteration(s): {r} pivot rounds, {l} K1 launches, {c} "
            f"K1 columns" for it, (r, l, c) in sorted(k1_stats.items())
        ) if alg == "BPP" else ""
        log(f"[flagship] {alg} k={FLAG_K}: {rates[alg]:.4f} it/s "
            f"(({hi} - {lo}) iterations / ({walls[hi]:.3f} - {walls[lo]:.3f}) "
            f"s), first iteration {walls[1]:.3f} s{k1_txt} on {card}")
        if alg == "MU":
            mu_rel = dict(rel)
        if alg == "BPP":
            found = {it: (k1_stats[it], round(rel[it], 6))
                     for it in RECORDED_BPP}
            log("[flagship] BPP against the recorded run ((pivot rounds, K1 "
                "launches, K1 columns), rel err per iteration count): "
                + ("the same" if found == RECORDED_BPP
                   else f"DIFFERENT: {found}, recorded {RECORDED_BPP}"))
    log(f"[flagship] peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB")
    # the operand, the starts and MU's errors stay for the loop phase
    return {"launches": launches, "wta_launches": wta_launches,
            "rates": rates, "max_abs_err": worst_abs,
            "k1_launches": k1_launches, "k1_rounds": k1_rounds,
            "k1_stats": k1_stats, "wta": wta, "mu_factors": mu_factors,
            "op": op, "W0": W0, "H0": H0, "mu_rel": mu_rel}


def transposed_csr(A):
    """A^T (n x m) as a CUDA f32 CSR holding the operand's bf16-rounded
    values: torch.sparse.mm's operand for W'A, built beforehand."""
    import torch

    csc = A.tocsc()
    vals = torch.from_numpy(csc.data.astype(np.float32)).to(
        torch.bfloat16).float()
    return torch.sparse_csr_tensor(
        torch.from_numpy(csc.indptr.astype(np.int64)),
        torch.from_numpy(csc.indices.astype(np.int64)), vals,
        (csc.shape[1], csc.shape[0])).cuda()


def flagship_wta(op, W, at_csr) -> dict:
    """W'A at the flagship: its one column bucket (every column has 78-80
    entries, so the ladder makes one bucket of L = 80) as one transposed
    ell_spmm launch, held against its plain version and timed beside it
    and torch.sparse.mm; and a profiler check that op.mm_tn runs only the
    kernel's launches (no strided copy after it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from smallk_torch.kernels import ell_spmm as kmod

    if op.col_blocks is not None or len(op.col_buckets) != 1:
        raise AssertionError(f"flagship W'A: {len(op.col_buckets or ())} "
                             "column buckets, expected one")
    ids, idx, vals = op.col_buckets[0]
    W = W.contiguous()  # as mm_tn hands it to the kernel
    (B, k), (g, L) = W.shape, idx.shape
    out = torch.empty((k, FLAG_N), dtype=torch.float32, device="cuda")

    def kernel():
        return kmod.ell_spmm(idx, vals, W, out, rows=ids, transposed=True)

    def plain_version():
        return kmod.ell_spmm_reference(idx, vals, W, out, rows=ids,
                                       transposed=True)

    got = kernel().clone()
    want = plain_version().clone()
    diff = float((got - want).abs().max())
    rel = diff / float(want.abs().max())
    if not (rel <= ELL_TOL["float32"] and bool(torch.isfinite(got).all())):
        raise AssertionError(f"flagship W'A bucket: relative {rel}")
    lib = torch.sparse.mm(at_csr, W)
    lib_rel = float((lib.T - got).abs().max() / got.abs().max())
    if not lib_rel <= 1e-4:
        raise AssertionError(f"flagship W'A: torch.sparse.mm differs by "
                             f"{lib_rel}")
    del got, want, lib
    ms = back_to_back_ms(kernel, 10)
    plain = back_to_back_ms(plain_version, 2)
    library = back_to_back_ms(lambda: torch.sparse.mm(at_csr, W), 3)
    nnz = int((idx < B).sum())
    nbytes = (idx.numel() * 4 + vals.numel() * vals.element_size()
              + W.numel() * 4 + out.numel() * 4)
    b_ms, b_by = bound(2.0 * nnz * k, nbytes)
    gathered = nnz * k * W.element_size()

    # op.mm_tn on the card: nothing but the kernel's launches
    before = kmod.launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res = op.mm_tn(W)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type.name == "CUDA" and e.device_time_total > 0]
    launched = kmod.launches - before
    if not names or any("ell_spmm_kernel" not in nm for nm in names) or \
            len(names) != launched or not res.is_contiguous() or \
            tuple(res.shape) != (k, FLAG_N):
        raise AssertionError(f"flagship W'A: mm_tn ran {names} for "
                             f"{launched} launches")
    log(f"[flagship W'A] g={g} L={L} B={B} k={k}, bf16 vals, f32 table, "
        f"transposed out: max|kernel - plain| {diff:.3e}, relative "
        f"{rel:.3e}; device ms per call kernel {ms:.4f} ({nnz / ms / 1e6:.2f}"
        f" Gnnz/s, {gathered / 1e9:.2f} GB of gathered rows at "
        f"{gathered / ms / 1e9:.2f} TB/s), plain {plain:.4f}, library "
        f"torch.sparse.mm on A^T as an f32 CSR {library:.4f} (max rel diff "
        f"{lib_rel:.1e}); bound {b_ms:.4f} ms ({b_by}); op.mm_tn on the card "
        f"ran {len(names)} kernel(s), all ell_spmm, and no copy")
    return {"ms": ms, "plain_ms": plain, "library_ms": library,
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": diff}


def phase_sparse_cli() -> None:
    """The nmf and hierclust CLIs on a 30000 x 20000 .mtx with 80 draws per
    column: its f32 dense image (2.4 GB) is above the 2 GiB densify
    threshold, so run_nmf takes an EllAOp, and hierclust the EllAOp with
    its nodes gathered on the card."""
    import scipy.sparse as sp

    from smallk_torch.io.matrix_market import write_matrix_market

    m, n, k = CLI_M, CLI_N, 8
    if m * n * 4 <= 2 << 30:
        raise AssertionError("the CLI matrix would be densified")
    gs = np.random.RandomState(13)
    A = sp.csc_matrix(
        (gs.rand(n * CLI_NZ), gs.randint(0, m, n * CLI_NZ).astype(np.int32),
         np.arange(0, n * CLI_NZ + 1, CLI_NZ, dtype=np.int64)), shape=(m, n))
    A.sum_duplicates()
    with tempfile.TemporaryDirectory() as td:
        mtx = os.path.join(td, "corpus.mtx")
        write_matrix_market(mtx, A)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
        cmd = [sys.executable, "-m", "smallk_torch.cli.nmf_cli",
               "--matrixfile", mtx, "--k", str(k), "--algorithm", "BPP",
               "--maxiter", "20", "--seed", "1", "--verbose", "0"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=td, env=env, capture_output=True,
                              text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"sparse nmf CLI exited {proc.returncode}:\n"
                                 f"{proc.stdout}\n{proc.stderr}")
        W = np.loadtxt(os.path.join(td, "w.csv"), delimiter=",", ndmin=2)
        H = np.loadtxt(os.path.join(td, "h.csv"), delimiter=",", ndmin=2)
        dic = os.path.join(td, "dict.txt")
        with open(dic, "w") as f:
            f.write("".join(f"term{i}\n" for i in range(m)))
        clusters = 4
        cmd = [sys.executable, "-m", "smallk_torch.cli.hierclust_cli",
               "--matrixfile", mtx, "--dictfile", dic, "--clusters",
               str(clusters), "--flat", "1", "--device", "cuda",
               "--verbose", "0", "--seed", "1", "--outdir", td]
        t0 = time.perf_counter()
        hproc = subprocess.run(cmd, cwd=td, env=env, capture_output=True,
                               text=True, timeout=600)
        hwall = time.perf_counter() - t0
        if hproc.returncode != 0:
            raise AssertionError(f"sparse hierclust CLI exited "
                                 f"{hproc.returncode}:\n{hproc.stdout}\n"
                                 f"{hproc.stderr}")
        with open(os.path.join(td, f"tree_{clusters}.xml")) as f:
            nodes = f.read().count("<node id=")
        flat = np.loadtxt(os.path.join(td, f"assignments_flat_{clusters}.csv"),
                          delimiter=",", dtype=np.int64, ndmin=1, max_rows=1)
    if nodes != 2 * (clusters - 1) or flat.shape != (n,):
        raise AssertionError(f"sparse hierclust CLI: {nodes} tree nodes, "
                             f"flat assignments {flat.shape}")
    if W.shape != (m, k) or H.shape != (k, n):
        raise AssertionError(f"sparse CLI wrote W {W.shape}, H {H.shape}")
    if not (np.isfinite(W).all() and np.isfinite(H).all()
            and (W >= 0).all() and (H >= 0).all()):
        raise AssertionError("sparse CLI factors are not finite and >= 0")
    tail = " ".join(proc.stdout.strip().splitlines()[-2:])
    log(f"[cli] nmf_cli {m}x{n} nnz={A.nnz} (.mtx, EllAOp) k={k} BPP "
        f"--maxiter 20 --device cuda: rc 0 in {wall:.1f} s, w.csv {W.shape}, "
        f"h.csv {H.shape}; {tail}")
    tail = " ".join(hproc.stdout.strip().splitlines()[-2:])
    log(f"[cli] hierclust_cli on the same .mtx --clusters {clusters} --flat 1 "
        f"--device cuda: rc 0 in {hwall:.1f} s, tree_{clusters}.xml with "
        f"{nodes} nodes, flat assignments {flat.shape}; {tail}")


def profile_summary(prof, wall: float, label: str) -> float:
    """Device busy share of a profiled window and the kernels that took
    its device time; returns the busy share.  Read from the profiler's raw
    records (building its per-event objects takes ~70 s per million
    events on the host)."""
    import torch

    spans, by_name, host = [], {}, {}
    calls = ("cudaLaunchKernel", "cudaStreamSynchronize", "cudaMemcpyAsync")
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.duration_ns() > 0:
                spans.append((e.start_ns(), e.end_ns()))
                by_name[name] = by_name.get(name, 0) + e.duration_ns()
        elif name in calls:
            host[name] = host.get(name, 0) + 1
    spans.sort()
    busy, end = 0, -1
    for a, b in spans:  # union of the device intervals, ns
        if b > end:
            busy += b - max(a, end)
            end = b
    total = sum(by_name.values())
    share = busy / 1e9 / wall
    log(f"[profile] {label}: wall {wall:.4f} s (profiled); device busy "
        f"{busy / 1e9:.4f} s = {100 * share:.2f}% of the wall (idle "
        f"{100 - 100 * share:.2f}%); host calls {host}")
    for name, ns in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"[profile]   {ns / 1e6:10.3f} ms {100 * ns / max(total, 1):6.2f}"
            f"%  {name[:90]}")
    k3_ns = sum(ns for name, ns in by_name.items() if any(
        k in name for k in K3_KERNELS))
    log(f"[profile]   K3 (its products and their split sums): "
        f"{k3_ns / 1e6:.3f} ms, {100 * k3_ns / max(total, 1):.2f}% of the "
        "device time")
    return share


def sparse_study(card: str) -> None:
    """--sparse: at the flagship shape, AH' for each doc block of
    DOC_BLOCKS; MU with its products through ell_spmm and through
    torch.sparse.mm, alternating; two BPP runs and one MU run under
    torch.profiler."""
    import torch

    from smallk_torch import NmfAlgorithm, NmfOptions, NmfStats
    from smallk_torch.engines.nmf import run_nmf
    from smallk_torch.ops.ell import EllAOp

    A, W0, H0 = flagship_problem()
    H = torch.from_numpy(H0).cuda()
    for block in DOC_BLOCKS:
        t0 = time.perf_counter()
        op = EllAOp.from_scipy(A, "bfloat16", doc_block=block,
                               device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        ms = [back_to_back_ms(lambda: op.mm_nt(H), 5) for _ in range(2)]
        log(f"[sweep] doc_block {block}: AH' {ms[0]:.3f}, {ms[1]:.3f} ms "
            f"(k={FLAG_K}, f32 H; {len(op.row_blocks or [None])} block(s), "
            f"{ell_launches_per_iteration(op)} launches per W'A + AH', "
            f"padded entries {op.padded_nnz}; built in {build_s:.2f} s) on "
            f"{card}")
        del op
        torch.cuda.empty_cache()

    op = EllAOp.from_scipy(A, "bfloat16", device="cuda")
    # torch.sparse.mm's operands, built beforehand: A and A^T as f32 CSR
    # holding the operand's bf16-rounded values
    at_csr = transposed_csr(A)
    a_csr = at_csr.to_sparse_coo().t().coalesce().to_sparse_csr()
    del A

    def mm_tn_library(self, W):
        return torch.sparse.mm(at_csr, W).T.contiguous()

    def mm_nt_library(self, H):
        return torch.sparse.mm(a_csr, H.T.contiguous())

    W = torch.from_numpy(W0).cuda()
    for name, mine, library, F in (("W'A", op.mm_tn, mm_tn_library, W),
                                   ("AH'", op.mm_nt, mm_nt_library, H)):
        rel = float((mine(F) - library(op, F)).abs().max()
                    / mine(F).abs().max())
        lib_ms = back_to_back_ms(lambda: library(op, F), 3)
        log(f"[library] {name}: torch.sparse.mm {lib_ms:.3f} ms, ell_spmm "
            f"{back_to_back_ms(lambda: mine(F), 3):.3f} ms; max rel diff "
            f"{rel:.2e}")
        if not rel <= 1e-4:
            raise AssertionError(f"{name}: torch.sparse.mm disagrees")
    del W

    mu = NmfOptions(tol=1e-30, algorithm=NmfAlgorithm.MU, height=FLAG_M,
                    width=FLAG_N, k=FLAG_K, min_iter=1, max_iter=1,
                    verbose=False, a_dtype="bfloat16")
    run_nmf(op, W0, H0, mu, device="cuda")  # warm-up
    methods = (EllAOp.mm_tn, EllAOp.mm_nt)
    lo, hi = FLAG_MU_ITERS
    try:
        for side in ("ell_spmm", "torch.sparse.mm", "torch.sparse.mm",
                     "ell_spmm"):
            EllAOp.mm_tn, EllAOp.mm_nt = (
                methods if side == "ell_spmm"
                else (mm_tn_library, mm_nt_library))
            walls = {}
            for it in (lo, hi):
                stats = NmfStats()
                W, Hf, ok = run_nmf(op, W0, H0,
                                    dataclasses.replace(mu, max_iter=it),
                                    stats, device="cuda")
                walls[it] = stats.elapsed_us / 1e6
            log(f"[library] MU with products through {side}: "
                f"{(hi - lo) / (walls[hi] - walls[lo]):.4f} it/s ({lo}: "
                f"{walls[lo]:.3f} s, {hi}: {walls[hi]:.3f} s), rel err "
                f"{sparse_rel_err(op, W, Hf):.6f}, success {ok} on {card}")
    finally:
        EllAOp.mm_tn, EllAOp.mm_nt = methods

    profile_flagship(op, W0, H0)


def profile_flagship(op, W0, H0) -> None:
    """The solve loop alone under torch.profiler, on factors already on the
    card: BPP for 3 and 23 iterations, then MU for 25.  BPP first, so that
    the profiler's start-up lands in its longer window, not in MU's.  BPP's
    first iteration starts from an all-positive H (every entry passive,
    the dearest masked solve); the longer BPP run less the shorter one is
    the steady state."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from smallk_torch import NmfAlgorithm, NmfOptions
    from smallk_torch.solvers.solve import nmf_solve

    W, H = torch.from_numpy(W0).cuda(), torch.from_numpy(H0).cuda()
    for alg, it in (("BPP", FLAG_BPP_ITERS[0]), ("BPP", FLAG_BPP_ITERS[-1]),
                    ("MU", FLAG_MU_ITERS[-1])):
        opts = NmfOptions(tol=1e-30, algorithm=NmfAlgorithm(alg),
                          height=FLAG_M, width=FLAG_N, k=FLAG_K, min_iter=1,
                          max_iter=it, verbose=False, a_dtype="bfloat16")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            nmf_solve(op, W, H, opts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        profile_summary(prof, wall, f"flagship nmf_solve {alg}, {it} "
                        "iteration(s)")


def ell_variant(plan, L: int, variant: str) -> tuple:
    """A bucket's launch plan (vec, C, W, S) under `variant`: the plan, a
    whole warp for every row, long rows split to chains of another length
    or not split, or each entry broadcast to the whole warp (kWarp, the
    k = 128 walk) in place of a group of C lanes (kGroup)."""
    from smallk_torch.kernels import ell_spmm as kmod

    vec, C, W, S = plan
    if variant == "a warp a row":
        W = 32
    elif variant.startswith("chain ") and L > kmod.SPLIT_MIN_L:
        chain = int(variant.split()[1])
        S = min(kmod.MAX_WARPS_PER_ROW,
                kmod._pow2_at_least(-(-L // ((32 // C) * chain))))
    elif variant == "no split":
        S = 1
    elif variant == "warp broadcast":
        C = W = 32
    elif variant != "plan" and not variant.startswith("chain "):
        raise ValueError(variant)
    return vec, C, W, S


def ell_variant_product(packs, table, n_major: int, transposed: bool,
                        variant: str, only=None):
    """A product over an EllAOp family (`packs`, as its `col_packs` or
    `row_packs`) with every bucket launched under `variant`, from
    descriptors built for it (the operand's own stay as they are), through
    the wrapper's launcher: a callable returning the product.  `only`
    (block, bucket) launches that one bucket alone."""
    import torch

    from smallk_torch.kernels import ell_spmm as kmod

    k = table.shape[1]
    launches = []
    for b, (lo, hi, pack) in enumerate(packs):
        tab = table[lo:hi]
        ptr = tab.data_ptr()
        desc = pack.descriptors(k, tab.element_size(),
                                min(ptr & -ptr, 32)).copy()
        for d in desc:
            d[5:] = ell_variant(tuple(int(x) for x in d[5:]), int(d[4]),
                                variant)
        if only is not None:
            desc = desc[only[1]:only[1] + 1] if only[0] == b else desc[:0]
        if len(desc):
            launches.append((np.ascontiguousarray(desc), pack.dtype, tab,
                             b > 0))
    out = torch.zeros((k, n_major) if transposed else (n_major, k),
                      device=table.device)

    def run():
        for desc, dtype, tab, accumulate in launches:
            kmod._launch(desc, dtype, tab, out, accumulate, transposed)
        return out
    return run


def ell_study(card: str) -> None:
    """--ell: ell_spmm's checks (phase 12), then its launch plan against
    ELL_VARIANTS at the sparse hierclust root's EllAOp, k = 2, 8 and 16:
    each product under each variant timed alone on the device and back to
    back, twice in turn, and held to the plan's (bit-equal to the
    operand's own product); at k = 2 each doc block's slowest AH' launch
    and the host's enqueue of the product; and a k = 2 bucket of short
    rows with and without warps shared among rows."""
    import torch

    from smallk_torch.ops.aop import as_aop
    from smallk_torch.kernels.ell_spmm import Buckets

    timed_phase = time.perf_counter()
    phase_ell_spmm()
    log(f"[ell] phase 12 in {time.perf_counter() - timed_phase:.1f} s")
    A, _, _ = sparse_corpus(SPH_N)
    a_op = as_aop(A, dtype="bfloat16", device="cuda")
    del A
    log(f"[ell] root EllAOp W'A buckets (g, L): "
        f"{[tuple(i.shape) for _, i, _ in a_op.col_buckets]}; AH' doc block "
        f"0 of {len(a_op.row_blocks)}: "
        f"{[tuple(i.shape) for _, i, _ in a_op.row_blocks[0][1]]}")

    def compare(label, products, variants, iters):
        """Each variant's product against the plan's, then its device and
        back-to-back ms, the variants in turn forwards and backwards."""
        want = products["plan"]().clone()
        for v in variants:
            got = products[v]()
            diff = float(((got - want).abs().max()
                          / want.abs().max().clamp_min(1e-30)).item())
            if diff > 1e-4:
                raise AssertionError(f"{label} {v}: relative {diff:.2e} "
                                     "from the plan's product")
        times = {v: [] for v in variants}
        for order in (variants, variants[::-1]):
            for v in order:
                times[v].append((device_ms(products[v], iters),
                                 back_to_back_ms(products[v], iters)))
        log(f"[ell] {label}: ms (device / back to back), two turns: "
            + "; ".join(f"{v} " + ", ".join(f"{d:.4f} / {t:.4f}"
                                          for d, t in times[v])
                        for v in variants))

    gen = torch.Generator(device="cuda").manual_seed(5)
    for k, variants in ELL_VARIANTS.items():
        W = torch.rand((SPH_M, k), generator=gen, device="cuda")
        H = torch.rand((k, SPH_N), generator=gen, device="cuda")
        tables = {"W'A": (a_op.col_packs, W.contiguous(), SPH_N, True,
                          a_op.mm_tn(W)),
                  "AH'": (a_op.row_packs, H.T.contiguous(), SPH_M, False,
                          a_op.mm_nt(H))}
        for side, (packs, table, n_major, tr, own) in tables.items():
            products = {v: ell_variant_product(packs, table, n_major, tr, v)
                        for v in variants}
            if not torch.equal(products["plan"](), own):
                raise AssertionError(f"k={k} {side}: the study's plan is not "
                                     "the operand's product")
            compare(f"root EllAOp k={k} {side}", products, variants, 20)
    # where the root's AH' goes at k = 2: each launch alone (device time)
    # against the product's host enqueue
    H = torch.rand((2, SPH_N), generator=gen, device="cuda")
    table = H.T.contiguous()
    slowest = []
    for b, (_, _, pack) in enumerate(a_op.row_packs):
        times = [(device_ms(ell_variant_product(
            a_op.row_packs, table, SPH_M, False, "plan", (b, i)), 20),
            tuple(idx.shape)) for i, (_, idx, _) in enumerate(pack.buckets)]
        slowest.append((round(max(times)[0], 4), max(times)[1],
                        round(sum(t for t, _ in times), 4)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        a_op.mm_nt(H)
    enqueue = (time.perf_counter() - t0) / 5 * 1e3
    torch.cuda.synchronize()
    log(f"[ell] root EllAOp k=2 AH' per doc block: slowest launch (ms, "
        f"(g, L)) and the sum of its launches alone (ms) {slowest}; host "
        f"enqueue of the product {enqueue:.4f} ms")
    # short rows sharing a warp: the root's shortest AH' buckets' lengths
    for L in (8, 16):
        idx, vals, table = ell_inputs(20000, L, 131072, 2, "bfloat16",
                                      "float32", 0.3, seed=L)
        packs = [(0, None, Buckets([(None, idx, vals)]))]
        for tr in (False, True):
            compare(f"k=2 bucket g=20000 L={L} bf16 values"
                    f"{' transposed' if tr else ''}",
                    {v: ell_variant_product(packs, table, 20000, tr, v)
                     for v in ("plan", "a warp a row")},
                    ("plan", "a warp a row"), 50)
    log(f"[ell] on {card}")


def k2_study(card: str) -> None:
    """--k2: where a K2 step's time goes.  The cluster barrier's and a DSMEM
    load's latency (the cluster probe), the clusters the card holds at
    once, the stamped build's phase split per CTA at 256 x 256 (f32 and
    bf16 A), 888 x 888 and 992 x 992, k = 16, beside the step's device
    time with and without stamps; then the flatclust HALS path under
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from smallk_torch import NmfAlgorithm, NmfOptions, NmfProgressAlgorithm
    from smallk_torch.engines.flatclust import run_flatclust
    from smallk_torch.kernels import hals_step as k2

    for _ in range(3):
        cyc, ns, dsmem, local = k2.cluster_probe(4096)
        log(f"[k2] cluster of {k2.CLUSTER}: barrier {cyc:.1f} cycles = "
            f"{ns:.1f} ns; dependent DSMEM load {dsmem:.1f} cycles, local "
            f"shared-memory load {local:.1f} cycles")
    f32, bf16 = torch.float32, torch.bfloat16
    for side in (256, 888, 992):
        log(f"[k2] {side}x{side} k={FLAT_K}: {k2.smem_bytes(side, side, FLAT_K)} "
            f"bytes of shared memory a CTA; cudaOccupancyMaxActiveClusters "
            f"{k2.max_active_clusters(side, side, FLAT_K)}")
    for (m, n, k), a_dtype in (((256, 256, 16), f32), ((256, 256, 16), bf16),
                               ((888, 888, 16), f32), ((992, 992, 16), f32)):
        args = k2_inputs(m, n, k, a_dtype)
        plain = device_ms(lambda: k2.hals_step(*args), 200)
        stamped = device_ms(lambda: k2.hals_step(*args, stamped=True), 200)
        for _ in range(3):
            k2.hals_step(*args, stamped=True)
        st = k2.read_stamps().double()
        cyc, ns = st[..., 0], st[..., 1]
        rate = float((cyc[0, -1] - cyc[0, 0]) / (ns[0, -1] - ns[0, 0]))
        split = []
        for s in range(1, len(k2.SEAMS)):
            d_ns = ns[:, s] - ns[:, s - 1]
            d_cyc = (cyc[:, s] - cyc[:, s - 1]) / rate
            split.append(f"{k2.SEAMS[s]} {float(d_cyc.max()):.0f} ns "
                         f"(CTA 0 {float(d_cyc[0]):.0f}, globaltimer max "
                         f"{float(d_ns.max()):.0f})")
        log(f"[k2] {m}x{n} k={k} A {str(a_dtype)[6:]}: device ms per step "
            f"{plain:.4f} (stamped build {stamped:.4f}); one stamped step, "
            f"{float(ns[:, -1].max() - ns[:, 0].min()):.0f} ns first stamp to "
            f"last, SM clock {rate:.3f} GHz; per phase, slowest CTA: "
            + "; ".join(split))

    # the host's side of a step: the wrapper's cost per call (launches
    # queued back to back, nothing waited for), and launch-to-finish
    # latency (a launch, then a synchronize)
    for side in (96, 256, 888):
        args = k2_inputs(side, side, FLAT_K, f32)
        k2.hals_step(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            k2.hals_step(*args)
        host_us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        lat = []
        for _ in range(100):
            t0 = time.perf_counter()
            k2.hals_step(*args)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e6)
        log(f"[k2] {side}x{side} k={FLAT_K}: host {host_us:.1f} us per call "
            f"({k2.smem_bytes(side, side, FLAT_K)} bytes of shared memory, "
            f"opt-in {'set' if k2.smem_bytes(side, side, FLAT_K) > 48 * 1024 else 'not needed'}); "
            f"launch to finish, median {float(np.median(lat)):.1f} us")

    A, W0, H0 = flat_problem()
    opts = NmfOptions(tol=1e-30, algorithm=NmfAlgorithm.HALS,
                      prog_est_algorithm=NmfProgressAlgorithm.PG_RATIO,
                      height=FLAT_M, width=FLAT_N, k=FLAT_K, min_iter=5,
                      max_iter=200, tolcount=1, verbose=False,
                      normalize=True, dtype="float32")
    run_flatclust(A, W0, H0, opts, device="cuda")  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_flatclust(A, W0, H0, opts, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    profile_summary(prof, wall, "flatclust HALS, 200 iterations")
    log(f"[k2] on {card}")


# ---------------------------------------------------------------------------
# sparse hierclust (ops/ell_cols.py, ops/aop.MaskedAOp) and the CG tier


@contextlib.contextmanager
def patched(module, name: str, value):
    """module.name set to value inside the block."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def sparse_corpus(n: int):
    """The planted term-doc corpus at SPH_M terms and n documents, seed 11
    (hierclust's bench corpus widened), with its generator's host
    seconds."""
    from smallk_torch.engines.corpus import synthetic_term_doc_corpus

    t0 = time.perf_counter()
    A, labels = synthetic_term_doc_corpus(SPH_M, n, SPH_TOPICS, seed=11)
    return A, labels, time.perf_counter() - t0


def chunk_operand(chunks, idx):
    """The static operand (ChunkColsAOp) of the documents `idx` (a tensor
    on the card) at their chunk width, loaded, with its build's host ms
    (one build timed, the buffers allocated before)."""
    from smallk_torch.engines.hierclust import bucket_for
    from smallk_torch.ops.ell_cols import ChunkColsAOp

    sub = idx.cpu().numpy()
    wc = bucket_for(max(len(sub), chunks.subset_chunk_count(sub)))
    op = ChunkColsAOp(chunks, wc)
    plan = chunks.gather_host(sub, wc)
    ms = wall_ms(lambda: op.load(*plan[1:]), 1)
    return op, ms


def subset_entries(op, w: int) -> dict:
    """A column subset's nonzeros on the card, from its loaded static
    operand `op` (w documents): `terms`, `local` columns and `vals` in f32,
    in column order; `order` their stable sort by term, `lens` the entries
    a column and `row_lens` a term, `nnz` their count: what the torch-ops
    products, torch.sparse.mm and index_add_ read."""
    import torch

    L0 = op.chunks.L0
    chunks = int(op.starts[-1])
    n = chunks * L0
    rows = op.rows[:n].long()
    live = (torch.arange(L0, device=rows.device)[None, :]
            < op.lens[:chunks, None]).reshape(-1)
    slot = torch.repeat_interleave(torch.arange(op.wc, device=rows.device),
                                   op.starts.diff().long(),
                                   output_size=chunks)
    local = slot.repeat_interleave(L0)[live]
    terms = rows[live]
    return {"terms": terms, "local": local, "vals": op.vals[:n][live].float(),
            "order": torch.argsort(terms, stable=True),
            "lens": torch.bincount(local, minlength=w),
            "row_lens": torch.bincount(terms, minlength=op.m),
            "nnz": int(live.sum()), "w": w}


def torch_ops_products(e):
    """The reference's XLA formulation of the subset products in torch ops
    (smallk_tpu/ops/ell_cols.py:186-198): a gather of factor rows, then a
    sorted segment sum (torch.segment_reduce), never a scatter-add."""
    import torch

    local_r, vals_r = e["local"][e["order"]], e["vals"][e["order"]]

    def mm_tn(W):
        g = W.index_select(0, e["terms"]) * e["vals"][:, None]
        return torch.segment_reduce(g, "sum", lengths=e["lens"], axis=0).T

    def mm_nt(H):
        g = H.T.index_select(0, local_r) * vals_r[:, None]
        return torch.segment_reduce(g, "sum", lengths=e["row_lens"], axis=0)

    return mm_tn, mm_nt


def library_products(e, m: int, w: int):
    """torch.sparse.mm on the subset as f32 CSRs (A_sub^T for W'A, A_sub
    for AH'), built beforehand."""
    import torch

    def crow(lens):
        return torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)])

    at = torch.sparse_csr_tensor(crow(e["lens"]), e["terms"], e["vals"],
                                 (w, m))
    a = torch.sparse_csr_tensor(crow(e["row_lens"]), e["local"][e["order"]],
                                e["vals"][e["order"]], (m, w))
    return (lambda W: torch.sparse.mm(at, W).T,
            lambda H: torch.sparse.mm(a, H.T.contiguous()))


def wall_ms(fn, iters: int = 3) -> float:
    """Median host-clock ms of fn() between synchronizes (for work that
    syncs inside, or builds)."""
    import torch

    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def entry_sums(e, x, side: str, m: int):
    """A subset's k = 2 product of side `side` ("tn": W'A with x = W;
    "nt": AH' with x = H at the subset's width) evaluated in f64 from its
    entries `e` (`subset_entries`), each output entry's sum of
    |val * factor|, and its segment's entries (a column's for W'A, a
    term's for AH'), in the product's layout."""
    import torch

    tn = side == "tn"
    keys, rows = (e["local"], e["terms"]) if tn else (e["terms"], e["local"])
    table = (x if tn else x.T).double()
    part = e["vals"].double()[:, None] * table[rows]
    n_out = e["w"] if tn else m
    want, rowsum = (torch.zeros((n_out, table.shape[1]), dtype=torch.float64,
                                device=part.device).index_add_(0, keys, p)
                    for p in (part, part.abs()))
    rowlen = (e["lens"] if tn else e["row_lens"]).double()[:, None]
    return (want.T, rowsum.T, rowlen.T) if tn else (want, rowsum, rowlen)


def node_products(op, e, label: str, root_op=None, idx=None,
                  build_ms=None) -> dict:
    """One node's k = 2 products (f32 factors on the bf16 corpus) through
    `op` (the root's EllAOp or a static operand; `e` the subset's entries,
    `subset_entries`), held with the plain version, the torch-ops
    formulation and torch.sparse.mm to the product evaluated in f64, entry
    by entry (`within_rows` at ELL_TOL's f32 value), and timed (CUDA events over calls back to back; the plain version once,
    between synchronizes), with the kernel launches a product makes, its
    bound and, for a static operand, index_add_ (the contributions made
    beforehand) as its library call; given the root's operand and the
    subset `idx`, also the masked view's time at this subset."""
    import torch

    from smallk_torch.kernels import ell_spmm as kmod
    from smallk_torch.kernels import seg_spmm as smod
    from smallk_torch.ops.aop import MaskedAOp
    from smallk_torch.ops.ell_cols import ChunkColsAOp

    m, w, nnz = op.shape[0], e["w"], e["nnz"]
    static = isinstance(op, ChunkColsAOp)
    out = {"nnz": nnz, "w": op.shape[1]}
    if build_ms is not None:
        out["build_ms"] = build_ms
    gen = torch.Generator(device="cuda").manual_seed(w)
    W = torch.rand((m, 2), generator=gen, device="cuda")
    H = torch.zeros((2, op.shape[1]), device="cuda")
    H[:, :w] = torch.rand((2, w), generator=gen, device="cuda")
    tops, lib = torch_ops_products(e), library_products(e, m, w)
    for side, x, fn in (("tn", W, op.mm_tn), ("nt", H, op.mm_nt)):
        cut = (lambda y: y[:, :w]) if side == "tn" else (lambda y: y)
        xw = x if side == "tn" else x[:, :w]
        before = (kmod.launches, smod.launches)
        got = cut(fn(x))
        launches = {"ell_spmm": kmod.launches - before[0],
                    "seg_spmm": smod.launches - before[1]}
        with plain_ell():
            want = cut(fn(x))
            plain_ms = wall_ms(lambda: fn(x), 1)
        err = float((got - want).abs().max())
        exact = entry_sums(e, xw, side, m)
        held = {name: within_rows(y, *exact, ELL_TOL["float32"], True)
                for name, y in (("kernel", got), ("plain", want),
                                ("torch ops", tops[side == "nt"](xw)),
                                ("library", lib[side == "nt"](xw)))}
        del exact
        if not (all(ok for ok, _ in held.values())
                and bool(torch.isfinite(got).all())):
            worst = ", ".join(f"{k} {v[1]:.2e}" for k, v in held.items())
            raise AssertionError(
                f"{label} {side}: worst entry of each against the product "
                f"in f64, as a share of its sum of |val * factor|: {worst} "
                f"(tolerance {ELL_TOL['float32']:g}, grown by the entry's "
                f"segment); max|kernel - plain| {err}")
        n_out = w * 2 if side == "tn" else m * 2
        n_tab = m * 2 if side == "tn" else w * 2
        b_ms, b_by = bound(2.0 * nnz * 2, nnz * (4 + 2) + 4 * (n_tab + n_out))
        out[side] = {"ms": back_to_back_ms(lambda: fn(x), 5),
                     "plain_ms": plain_ms,
                     "ops_ms": back_to_back_ms(
                         lambda: tops[side == "nt"](xw), 3),
                     "sparse_mm_ms": back_to_back_ms(
                         lambda: lib[side == "nt"](xw), 5),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "launches": launches, "err": err}
        if static:
            # index_add_ of the contributions, made beforehand, at the keys
            # (local column for W'A, term for AH')
            keys, src = ((e["local"], e["vals"][:, None] * W[e["terms"]])
                         if side == "tn" else
                         (e["terms"], e["vals"][:, None] * xw.T[e["local"]]))
            dst = torch.zeros((w if side == "tn" else m, 2), device="cuda")
            out[side]["library_ms"] = back_to_back_ms(
                lambda: dst.index_add_(0, keys, src), 5)
            out[side]["device_ms"] = device_ms(lambda: fn(x), 20)
            if side == "nt":
                # the term pass reading H's transposed view in place of the
                # contiguous copy mm_nt makes
                dst = torch.empty((m, 2), device="cuda")
                out[side]["strided_ms"] = device_ms(
                    lambda: smod.seg_spmm(op.t_ptr, op.t_gather, op.t_vals,
                                          x.T, dst, carries=op.carries), 20)
        else:
            out[side]["library_ms"] = out[side]["sparse_mm_ms"]
    if root_op is not None:
        mask = torch.zeros(root_op.shape[1], device="cuda")
        mask[idx] = 1.0
        masked = MaskedAOp(root_op, mask)
        Hf = torch.zeros((2, root_op.shape[1]), device="cuda")
        Hf[:, idx] = H[:, :w]
        out["masked_ms"] = back_to_back_ms(
            lambda: (masked.mm_tn(W), masked.mm_nt(Hf)), 3)
    t, n_ = out["tn"], out["nt"]
    kern = "seg_spmm" if static else "ell_spmm"
    log(f"[cols] {label}: w={w} (operand width {op.shape[1]}) nnz={nnz}"
        + (f", operand built in {out['build_ms']:.2f} ms"
           if "build_ms" in out else "")
        + f"; ms per product (W'A / AH'): {kern} {t['ms']:.4f} / "
        f"{n_['ms']:.4f} ({t['launches'][kern]} / {n_['launches'][kern]} "
        f"launches, max|kernel - plain| {t['err']:.2e} / {n_['err']:.2e})"
        + (f", device {t['device_ms']:.4f} / {n_['device_ms']:.4f} (AH' "
           f"with H^T copied; read strided "
           f"{n_.get('strided_ms', float('nan')):.4f}), index_add_ "
           f"{t['library_ms']:.4f} / {n_['library_ms']:.4f}" if static
           else "")
        + f", plain {t['plain_ms']:.2f} / {n_['plain_ms']:.2f}, torch ops "
        f"{t['ops_ms']:.4f} / {n_['ops_ms']:.4f}, torch.sparse.mm "
        f"{t['sparse_mm_ms']:.4f} / {n_['sparse_mm_ms']:.4f}, bound "
        f"{t['bound_ms']:.4f} / {n_['bound_ms']:.4f} ({t['bound_by']})"
        + (f"; masked view of the root, both products {out['masked_ms']:.4f}"
           if root_op is not None else ""))
    return out


def cols_study(card: str) -> None:
    """The node operand's products at k = 2 on the 50,000 x 1,000,000
    corpus: at the root the EllAOp and the full-width static operand (the
    measurement that routes a root with a chunk table to the static
    operand, engines/hierclust.py); the static operand
    against the masked view of the root at every share of CUT_SHARES
    (hierclust.MASKED_SHARE); the chunk length sweep over COLS_L0 at the
    root and a 1/SPH_NODE node (product ms, padding, table bytes), and
    sparse hierclust's wall at each L0 of COLS_L0_WALL, two runs each in
    turns (ell_cols.MEDIAN_PER_CHUNK)."""
    import torch

    from smallk_torch import Random
    from smallk_torch.engines import hier_chain
    from smallk_torch.engines import hierclust as hc
    from smallk_torch.engines.scoring import nmi
    from smallk_torch.ops import ell_cols
    from smallk_torch.ops.aop import as_aop
    from smallk_torch.ops.ell_cols import CscChunks

    A, labels, gen_s = sparse_corpus(SPH_N)
    t0 = time.perf_counter()
    a_op = as_aop(A, dtype="bfloat16", device="cuda")
    ell_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    chunks = CscChunks.from_scipy(A, "bfloat16", device="cuda")
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t0
    lens = chunks.lens
    log(f"[cols] corpus {SPH_M}x{SPH_N}, {A.nnz} nonzeros, median column "
        f"length {int(np.median(lens[lens > 0]))}: generator {gen_s:.2f} s, "
        f"EllAOp build {ell_s:.2f} s, chunk table build {chunk_s:.2f} s (host "
        f"seconds; L0 {chunks.L0}, {chunks.C} chunks, "
        f"{chunks.table_bytes / 1e9:.3f} GB, padding {chunks.padding:.3f}) "
        f"on {card}")
    everything = torch.arange(SPH_N, device="cuda")
    perm = np.random.RandomState(3).permutation(SPH_N)
    op, ms = chunk_operand(chunks, everything)
    e = subset_entries(op, SPH_N)
    node_products(a_op, e, "root, the EllAOp")
    node_products(op, e, "root, static operand", build_ms=ms)
    del op, e
    for share in CUT_SHARES:
        idx = torch.from_numpy(np.sort(perm[:int(share * SPH_N)])).cuda()
        op, ms = chunk_operand(chunks, idx)
        node_products(op, subset_entries(op, len(idx)),
                      f"node of {share:g} of the documents, static operand",
                      root_op=a_op, idx=idx, build_ms=ms)
        del op
        torch.cuda.empty_cache()
    del chunks
    idx = torch.from_numpy(np.sort(perm[:SPH_N // SPH_NODE])).cuda()
    for L0 in COLS_L0:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ch = CscChunks.from_scipy(A, "bfloat16", L0=L0, device="cuda")
        torch.cuda.synchronize()
        log(f"[cols] L0 {L0}: {ch.C} chunks, table {ch.table_bytes / 1e9:.3f}"
            f" GB, padding {ch.padding:.3f}, built in "
            f"{time.perf_counter() - t0:.2f} s")
        for label, sub in (("root", everything),
                           (f"1/{SPH_NODE} node", idx)):
            op, ms = chunk_operand(ch, sub)
            node_products(op, subset_entries(op, len(sub)),
                          f"L0 {L0}, {label}, static operand", build_ms=ms)
            del op
        del ch
    torch.cuda.empty_cache()
    opts = hier_opts(HIER_K, "float32", a_dtype="bfloat16")
    walls = {}
    for rnd in range(2):
        for L0 in (COLS_L0_WALL if rnd == 0 else COLS_L0_WALL[::-1]):
            with patched(ell_cols, "chunk_length", lambda lens, L0=L0: L0):
                if rnd == 0:  # warm-up
                    hc.clust_hier(a_op, opts, Random(1), host_A=A)
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tree, stats = hc.clust_hier(a_op, opts, Random(2), host_A=A)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            c = read_counts()
            walls.setdefault(L0, []).append(wall)
            log(f"[cols] sparse hierclust at L0 {L0}: wall {wall:.4f} s, "
                f"graphs {c['captures']}, solves {c['solves']}, steps "
                f"{c['steps']}, seg_spmm {c['seg_spmm']}, NMI "
                f"{nmi(tree.assignments, labels):.4f}, chain "
                f"{hier_chain.LAST_STATS} on {card}")
            torch.cuda.empty_cache()
    for L0, ws in walls.items():
        log(f"[cols] sparse hierclust at L0 {L0}: walls "
            f"{', '.join(f'{w:.4f}' for w in ws)} s")


def phase_sparse_hierclust(card: str) -> dict:
    """Hierclust on the planted 50,000 x 1,000,000 corpus (bf16 A, above
    the densify threshold), f32 factors, HIER_K clusters, as the
    Reuters-shape phase runs it: a warm-up run with another seed, the
    timed run with the launches gated exactly against each solve's operand
    and steps (sparse_launch_gate), and the node products timed at the
    root (its EllAOp and its static operand) and at a 1/SPH_NODE node.
    (The device's busy share on this path comes from the loop phase's
    profile in a process of its own.)"""
    import torch

    from smallk_torch import ClustStats, Random
    from smallk_torch.engines import hier_chain
    from smallk_torch.engines import hierclust as hc
    from smallk_torch.engines.scoring import nmi
    from smallk_torch.engines.tree import _host
    from smallk_torch.ops.aop import as_aop
    from smallk_torch.ops.ell_cols import CscChunks

    A, labels, gen_s = sparse_corpus(SPH_N)
    t0 = time.perf_counter()
    a_op = as_aop(A, dtype="bfloat16", device="cuda")
    ell_s = time.perf_counter() - t0
    opts = hier_opts(HIER_K, "float32", a_dtype="bfloat16")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hc.clust_hier(a_op, opts, Random(1), host_A=A)  # warm-up
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0

    stats = ClustStats()
    reset_counts()
    hc.gathered_operands = hc.masked_operands = 0
    with recorded_solves() as solves:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree, stats = hc.clust_hier(a_op, opts, Random(2), stats, host_A=A)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = read_counts()
    tiers = (hc.gathered_operands, hc.masked_operands)
    leaves = sum(tree.is_leaf)
    score = nmi(tree.assignments, labels)
    log(f"[sparse hierclust] {SPH_M}x{SPH_N} ({A.nnz} nonzeros) bf16 A, f32 "
        f"factors, {HIER_K} clusters: generator {gen_s:.2f} s, EllAOp build "
        f"{ell_s:.2f} s (host); wall {wall:.4f} s (its chunk table build "
        f"included), nmf_count {stats.nmf_count}, converged "
        f"{stats.nmf_count - stats.max_count}, iter_count {stats.iter_count},"
        f" {stats.iter_count / wall:.1f} rank-2 it/s, NMI {score:.4f}, leaves "
        f"{leaves}, outliers {len(tree.outliers)}, seg_spmm launches "
        f"{counts['seg_spmm']}, ell_spmm launches {counts['ell_spmm']} "
        f"(transposed {counts['ell_spmm_transposed']}), node operands "
        f"static/masked {tiers[0]}/{tiers[1]}, graphs {counts['captures']}, "
        f"chain {hier_chain.LAST_STATS}; warm-up wall {warm:.4f} s; on "
        f"{card}")
    # TrialSplit may drop outlier documents, which stay unassigned as the
    # reference leaves them (printed above)
    if leaves != HIER_K:
        raise AssertionError(f"sparse hierclust: {leaves} leaves")
    for q, node in enumerate(tree.nodes):
        if node.topic_vector is not None:
            tv = _host(node.topic_vector)
            if not np.isfinite(tv).all() or (tv < 0).any():
                raise AssertionError(f"node {q}: topic vector not finite "
                                     "and nonnegative")
    sparse_launch_gate("sparse hierclust", counts, solves)
    if not counts["seg_spmm"] or round(score, 3) != SPH_NMI:
        raise AssertionError(f"sparse hierclust: no seg_spmm launch or NMI "
                             f"{score}, not {SPH_NMI}: {counts}")

    # the node products at the root and at a 1/SPH_NODE node
    chunks = CscChunks.from_scipy(A, "bfloat16", device="cuda")
    everything = torch.arange(SPH_N, device="cuda")
    op, ms = chunk_operand(chunks, everything)
    e = subset_entries(op, SPH_N)
    root = node_products(a_op, e, "sparse hierclust root, the EllAOp")
    root_static = node_products(op, e, "sparse hierclust root, static "
                                "operand", build_ms=ms)
    del op
    idx = torch.from_numpy(np.sort(np.random.RandomState(3).permutation(
        SPH_N)[:SPH_N // SPH_NODE])).cuda()
    op, ms = chunk_operand(chunks, idx)
    node = node_products(op, subset_entries(op, len(idx)),
                         f"sparse hierclust 1/{SPH_NODE} node, static "
                         "operand", build_ms=ms)
    del op, chunks
    torch.cuda.empty_cache()
    return {"launches": counts["seg_spmm"], "wall": wall, "root": root,
            "root_static": root_static, "node": node, "nmi": score,
            "corpus": (A, labels), "op": a_op}


def phase_sparse_dense(card: str) -> None:
    """The planted 50,000 x 40,000 corpus (above the densify threshold, so
    sparse on its own) against the same matrix as a prebuilt DenseAOp on
    the card: in f64 initdir mode the trees are equal (assignments, and
    topic vectors to HIER_PRIORITY_TOL); in f32 random mode the sparse
    run's NMI trails the dense run's by at most HIER_NMI_MARGIN."""
    import torch

    from smallk_torch import Random
    from smallk_torch.engines import hierclust as hc
    from smallk_torch.engines.scoring import nmi
    from smallk_torch.engines.tree import _host
    from smallk_torch.ops.aop import as_aop

    A, labels, _ = sparse_corpus(SVD_N)
    everything = 1 << 40
    rng = np.random.RandomState(9)
    with tempfile.TemporaryDirectory() as initdir:
        for i in range(1, SVD_INIT_FILES + 1):
            np.savetxt(os.path.join(initdir, f"Winit_{i}.csv"),
                       rng.rand(SPH_M, 2), delimiter=",", fmt="%.17g")
            np.savetxt(os.path.join(initdir, f"Hinit_{i}.csv"),
                       rng.rand(2, SVD_N), delimiter=",", fmt="%.17g")
        opts = hier_opts(SVD_INITDIR_K, "float64", initdir)
        trees = {}
        for kind in ("sparse", "dense"):
            src = A if kind == "sparse" else as_aop(
                A, "float64", device="cuda", densify_threshold_bytes=everything)
            hc.masked_operands = 0
            trees[kind] = hc.clust_hier(src, opts, Random(1), host_A=A)
            trees[kind] += (hc.masked_operands,)
            del src
            torch.cuda.empty_cache()
    (ts, ss, ms_), (td, sd, _) = trees["sparse"], trees["dense"]
    worst = 0.0
    for a, b in zip(ts.nodes, td.nodes):
        if (a.topic_vector is None) != (b.topic_vector is None):
            raise AssertionError("sparse and dense trees differ in shape")
        if a.topic_vector is not None:
            worst = max(worst, float(np.abs(_host(a.topic_vector)
                                            - _host(b.topic_vector)).max()))
    same = np.array_equal(ts.assignments, td.assignments)
    log(f"[sparse vs dense f64] {SPH_M}x{SVD_N} initdir, {SVD_INITDIR_K} "
        f"clusters: assignments equal {same}, max|d topic vector| "
        f"{worst:.3e} (tolerance {HIER_PRIORITY_TOL:g}), iterations "
        f"{ss.iter_count}/{sd.iter_count}, masked node operands {ms_}")
    if not same or worst > HIER_PRIORITY_TOL or not ms_:
        raise AssertionError("sparse and dense f64 initdir trees differ")

    opts = hier_opts(HIER_K, "float32")
    scores = {}
    for kind in ("sparse", "dense"):
        src = A if kind == "sparse" else as_aop(
            A, "float32", device="cuda", densify_threshold_bytes=everything)
        reset_counts()
        hc.gathered_operands = 0
        tree, stats = hc.clust_hier(src, opts, Random(2))
        counts = read_counts()
        scores[kind] = (nmi(tree.assignments, labels), stats.iter_count,
                        counts, hc.gathered_operands, tree.assignments)
        del src
        torch.cuda.empty_cache()
    (ns, its, cs, gs, asg), (nd, itd, cd, _, adn) = (scores["sparse"],
                                                     scores["dense"])
    log(f"[sparse vs dense f32] {SPH_M}x{SVD_N} random mode, {HIER_K} "
        f"clusters: NMI sparse {ns:.4f} (seg_spmm launches "
        f"{cs['seg_spmm']}, ell_spmm {cs['ell_spmm']}, static node operands "
        f"{gs}), dense {nd:.4f} "
        f"(K3 launches {cd['K3']}); iterations {its}/{itd}, assignments "
        f"agree on {100 * np.mean(asg == adn):.2f}% of the documents")
    if ns < nd - HIER_NMI_MARGIN or not gs or cs["matmul_products"] \
            or cd["matmul_products"] or not cd["K3"]:
        raise AssertionError("sparse f32 hierclust trails the dense run or "
                             "took the wrong products")


def phase_bpp_wide(card: str) -> dict:
    """BPP at k = BPP_WIDE_K (> 128, the CG tier's) on the main path's
    Reuters-shape operand: BPP_WIDE_ITERS fixed iterations on the card at
    the auto U, captured (every CG loop a WHILE node) and eager, bit for
    bit, with the CG solves and steps counted (the captured ones settled
    from the card at the loop's host reads), no K1 launch; and f64 on a
    slice, 3 iterations, the card against the CPU with the CG tier
    forced."""
    from smallk_torch import (NmfAlgorithm, NmfOptions, NmfStats, Random,
                              random_matrix, random_sparse_matrix)
    from smallk_torch.engines.nmf import run_nmf
    from smallk_torch.solvers import graph, nnls

    k = BPP_WIDE_K
    rng = Random(2024)
    A = random_sparse_matrix(rng, M, N, nz_per_col=NZ_PER_COL,
                             dtype=np.float32)
    W0 = random_matrix(M, k, rng, dtype=np.float32)
    H0 = random_matrix(k, N, rng, dtype=np.float32)
    opts = NmfOptions(tol=1e-30, algorithm=NmfAlgorithm.BPP, height=M,
                      width=N, k=k, min_iter=1, max_iter=BPP_WIDE_ITERS,
                      verbose=False, a_dtype="bfloat16")
    W1, H1, ok1 = run_nmf(A, W0, H0, dataclasses.replace(opts, max_iter=1),
                          device="cuda")
    runs = {}
    for capture in (True, False):
        stats = NmfStats()
        with patched(graph, "CAPTURE", capture):
            reset_counts()
            W, H, ok = run_nmf(A, W0, H0, opts, stats, device="cuda")
            counts = read_counts()
        runs[capture] = (W, H, ok, stats, counts)
        its = stats.iteration_count / (stats.elapsed_us / 1e6)
        log(f"[bpp k={k}] {M}x{N} bf16 A, f32 factors, {BPP_WIDE_ITERS} "
            f"iterations, {'captured' if capture else 'eager'} (graphs "
            f"{counts['captures']}, {graph.last_nodes if capture else 0} "
            f"nodes): success={ok}, {its:.3f} it/s, pivot rounds "
            f"{stats.pivot_rounds}, CG solves {counts['cg_solves']}, CG "
            f"steps {counts['cg_steps']}, K1 launches {counts['K1']} on "
            f"{card}")
        if not (ok and ok1) or stats.iteration_count != BPP_WIDE_ITERS:
            raise AssertionError("BPP through the CG tier failed")
        if not cg_gate(counts) or counts["captures"] != capture:
            raise AssertionError(f"BPP k={k}: {counts}")
    W, H, _, stats, counts = runs[True]
    We, He, _, estats, ecounts = runs[False]
    same = (np.array_equal(W, We) and np.array_equal(H, He)
            and stats.pivot_rounds == estats.pivot_rounds)
    A64 = A.toarray()
    rel, rel1 = rel_err(A64, W, H), rel_err(A64, W1, H1)
    its = stats.iteration_count / (stats.elapsed_us / 1e6)
    log(f"[bpp k={k}] captured W and H {'equal' if same else 'DIFFERENT'} "
        f"to eager's bits; rel err {rel:.6f} (after 1 iteration "
        f"{rel1:.6f})")
    for name, F in (("W", W), ("H", H)):
        if not np.isfinite(F).all() or (F < 0).any():
            raise AssertionError(f"{name} is not finite and nonnegative")
    if not (same and rel < rel1) or counts["cg_solves"] != \
            ecounts["cg_solves"] or counts["cg_steps"] > ecounts["cg_steps"]:
        raise AssertionError(f"BPP k={k}: rel err {rel} (1 iteration "
                             f"{rel1}), captured {counts}, eager {ecounts}")
    solves, steps = counts["cg_solves"], counts["cg_steps"]

    m, n = BPP_WIDE_SLICE
    A_s = A64[:m, :n]
    opts64 = dataclasses.replace(opts, height=m, width=n, max_iter=3,
                                 dtype="float64", a_dtype=None)
    runs = {}
    for device in ("cuda", "cpu"):
        nnls.set_masked_solver("cg" if device == "cpu" else "auto")
        try:
            runs[device] = run_nmf(A_s, W0[:m].astype(np.float64),
                                   H0[:, :n].astype(np.float64), opts64,
                                   device=device)
        finally:
            nnls.set_masked_solver("auto")
    (Wc, Hc, okc), (Wh, Hh, okh) = runs["cuda"], runs["cpu"]
    dW = float(np.abs(Wc - Wh).max() / np.abs(Wh).max())
    dH = float(np.abs(Hc - Hh).max() / np.abs(Hh).max())
    log(f"[bpp k={k} f64] {m}x{n} slice, 3 iterations: cuda (CG by the rank "
        f"rule) vs cpu (CG forced) max relative |dW| {dW:.3e}, |dH| "
        f"{dH:.3e} (tolerance {BPP_CG_RTOL:g})")
    if not (okc and okh) or max(dW, dH) > BPP_CG_RTOL:
        raise AssertionError("f64 CG BPP differs between the card and CPU")
    return {"it_per_s": its, "cg_solves": solves, "cg_steps": steps}


def cg_study(card: str) -> None:
    """The card's GJ/CG crossover: one full-width pivot round, K1 against
    the CG tier cold and warm-started from the previous round's X, at
    CG_SWEEP_K x CG_SWEEP_N, on synthetic systems (LHS = B B' + 0.1 I,
    half the entries passive, then 2% of them toggled as a pivot round
    toggles them), f32."""
    import torch

    from smallk_torch.kernels import masked_gj
    from smallk_torch.solvers import nnls

    log(f"[cg] one full-width round, f32, ms (host clock between "
        f"synchronizes, median of 3; CG syncs every {nnls._CG_CHECK_EVERY} "
        f"steps) on {card}")
    for k in CG_SWEEP_K:
        for n in CG_SWEEP_N:
            gen = torch.Generator(device="cuda").manual_seed(k * n)
            B = torch.rand((k, 2 * k), generator=gen, device="cuda")
            LHS = B @ B.T + 0.1 * torch.eye(k, device="cuda")
            RHS = B @ torch.rand((2 * k, n), generator=gen, device="cuda")
            p0 = torch.rand((k, n), generator=gen, device="cuda") > 0.5
            p1 = p0 ^ (torch.rand((k, n), generator=gen, device="cuda")
                       < 0.02)
            X0 = masked_gj.masked_gj_solve(LHS, RHS, p0)
            gj = masked_gj.masked_gj_solve(LHS, RHS, p1)
            t_gj = wall_ms(lambda: masked_gj.masked_gj_solve(LHS, RHS, p1))
            row = {}
            for start, x0 in (("cold", None), ("warm", X0)):
                before = nnls.cg_steps
                x = nnls._cg_solve_block(LHS, RHS, p1, x0)
                steps = nnls.cg_steps - before
                err = float((x - gj).abs().max() / gj.abs().max())
                row[start] = (wall_ms(
                    lambda: nnls._cg_solve_block(LHS, RHS, p1, x0)), steps,
                    err)
            (c_ms, c_st, c_err), (w_ms, w_st, w_err) = row["cold"], row["warm"]
            log(f"[cg] k={k} n={n}: K1 {t_gj:.3f}, CG cold {c_ms:.3f} "
                f"({c_st} steps, max rel diff to K1 {c_err:.1e}), CG warm "
                f"{w_ms:.3f} ({w_st} steps, {w_err:.1e}); K1/CG cold "
                f"{t_gj / c_ms:.2f}x, K1/CG warm {t_gj / w_ms:.2f}x")
            del B, LHS, RHS, p0, p1, X0, gj
            torch.cuda.empty_cache()


def quiet(fn, *args, **kwargs):
    """fn(*args, **kwargs) with its standard output captured; returns
    (result, output)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return out, buf.getvalue()


def files_of(outdir: str) -> dict:
    return {name: Path(outdir, name).read_bytes()
            for name in sorted(os.listdir(outdir))}


def timed_call(fn, *args, **kwargs):
    """(fn's result with its standard output captured, its output, its
    wall seconds between two synchronizes)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, text = quiet(fn, *args, **kwargs)
    torch.cuda.synchronize()
    return out, text, time.perf_counter() - t0


def facade_nmf(card: str) -> dict:
    """The facade's Nmf(8) (BPP, its defaults: tol 0.005, PG_RATIO, f32) on
    the main path's operand, between two direct run_nmf calls from the
    same random_matrix draws on the same card: equal bits, K1 = 2 x steps
    run + pivot rounds run (at its auto U, captured, the steps after
    convergence run frozen), w.csv and h.csv written."""
    import smallk_torch as smallk
    from smallk_torch.engines.nmf import run_nmf

    A = random_sparse_matrix_main()
    W0, H0 = random_matrix_pair(smallk.Random(FACADE_SEED), M, N, K)
    opts = smallk.NmfOptions(
        tol=0.005, algorithm=smallk.NmfAlgorithm.BPP,
        prog_est_algorithm=smallk.NmfProgressAlgorithm.PG_RATIO, height=M,
        width=N, k=K, min_iter=5, max_iter=5000, tolcount=1,
        max_threads=smallk.GetMaxThreads(), verbose=True, normalize=True,
        dtype="float32")

    def direct():
        stats = smallk.NmfStats()
        reset_counts()
        out, _, wall = timed_call(run_nmf, A, W0, H0, opts, stats,
                                  device="cuda")
        return out, stats, read_counts(), wall

    (Wd, Hd, ok), stats, dcounts, wall0 = direct()
    with tempfile.TemporaryDirectory() as td:
        smallk.Initialize()
        smallk.SetOutputDir(td)
        smallk.SeedRNG(FACADE_SEED)
        smallk.LoadMatrix(matrix=A)
        reset_counts()
        _, out, wall = timed_call(smallk.Nmf, K, smallk.Algorithm.BPP)
        counts = read_counts()
        W, H = smallk.LockedBufferW(), smallk.LockedBufferH()
        Wf = np.loadtxt(os.path.join(td, "w.csv"), delimiter=",", ndmin=2)
        Hf = np.loadtxt(os.path.join(td, "h.csv"), delimiter=",", ndmin=2)
        smallk.Finalize()
    _, _, _, wall1 = direct()
    its_printed = int(out.strip().splitlines()[-1].split()[0])
    its, rounds = stats.iteration_count, stats.pivot_rounds
    equal = np.array_equal(W, Wd) and np.array_equal(H, Hd)
    log(f"[facade] Nmf({K}, BPP) {M}x{N} nnz/col={NZ_PER_COL} (f32 A, tol "
        f"0.005): {its} iterations, {rounds} pivot rounds, K1 launches "
        f"{counts['K1']} (direct run_nmf {dcounts['K1']}); W and H "
        f"{'equal' if equal else 'DIFFERENT'} to the direct run's bits; "
        f"w.csv {Wf.shape}, h.csv {Hf.shape}; wall: facade {wall:.4f} s, "
        f"direct run_nmf before and after {wall0:.4f} s, {wall1:.4f} s on "
        f"{card}")
    if not ok or its_printed != its:
        raise AssertionError(f"facade Nmf: success {ok}, printed "
                             f"{its_printed} iterations, direct {its}")
    if not equal:
        raise AssertionError("facade Nmf factors differ from run_nmf's")
    if not k1_gate(counts) or dcounts != counts \
            or counts["steps"] - counts["frozen"] != its:
        raise AssertionError(f"facade Nmf: {counts} for {its} iterations "
                             f"and {rounds} rounds; direct {dcounts}")
    if Wf.shape != (M, K) or Hf.shape != (K, N):
        raise AssertionError(f"facade wrote w.csv {Wf.shape}, h.csv "
                             f"{Hf.shape}")
    if not np.allclose(Wf, W, rtol=1e-5, atol=1e-6):
        raise AssertionError("w.csv does not hold LockedBufferW()")
    return {"wall": wall, "direct_wall": (wall0, wall1), "its": its}


def random_sparse_matrix_main():
    """The main path's operand (phase_main_path), made from its seed."""
    from smallk_torch import Random, random_sparse_matrix

    return random_sparse_matrix(Random(2024), M, N, nz_per_col=NZ_PER_COL,
                                dtype=np.float32)


def random_matrix_pair(rng, m: int, n: int, k: int):
    """W0 (m, k) then H0 (k, n) from `rng`, as the facade and the API draw
    them."""
    from smallk_torch import random_matrix

    return random_matrix(m, k, rng), random_matrix(k, n, rng)


def facade_hier(card: str) -> dict:
    """The facade's HierNmf2WithFlat(12) on the Reuters-shape hierclust
    corpus, between two direct run_hier_nmf2 calls with the facade's
    options and seed on the card: equal result files and launch counts,
    K3 exact against the steps run (k3_want).  The flat refinement is
    NNLS-HALS in torch ops (clust_flat): its W'A at k = 12 is the one
    product that is not K3's."""
    import smallk_torch as smallk
    from smallk_torch.engines.flatclust import (
        run_hier_nmf2, write_flatclust_results)
    from smallk_torch.io.writers import make_hierclust_writer

    A, _ = hier_corpus()
    words = [f"term{i}" for i in range(HIER_M)]
    k = HIER_K
    m, n = A.shape
    opts = smallk.ClustOptions(
        nmf_opts=smallk.NmfOptions(
            tol=1e-4, algorithm=smallk.NmfAlgorithm.RANK2,
            prog_est_algorithm=smallk.NmfProgressAlgorithm.PG_RATIO,
            height=m, width=n, k=2, min_iter=5, max_iter=5000, tolcount=1,
            max_threads=smallk.GetMaxThreads(), verbose=True,
            normalize=True, dtype="float32"),
        maxterms=5, unbalanced=0.1, trial_allowance=3, num_clusters=k,
        verbose=True, flat=True)

    def direct():
        stats = smallk.ClustStats()
        reset_counts()
        out, _, wall = timed_call(run_hier_nmf2, A, opts,
                                  smallk.Random(FACADE_SEED), stats,
                                  device="cuda")
        return out, read_counts(), wall

    with tempfile.TemporaryDirectory() as td:
        fdir, ddir = os.path.join(td, "facade"), os.path.join(td, "direct")
        os.makedirs(fdir)
        os.makedirs(ddir)
        (tree, stats, flat), dcounts, wall0 = direct()
        fmt = smallk.OutputFormat.JSON
        tree.write_assignments(os.path.join(ddir, f"assignments_{k}.csv"))
        tree.write_tree(make_hierclust_writer(fmt),
                        os.path.join(ddir, f"tree_{k}.json"), words)
        write_flatclust_results(ddir, flat["assignments"], flat["fuzzy"],
                                flat["W"], words, 5, fmt, k,
                                assignments_prefix="assignments_flat_")
        smallk.Initialize()
        smallk.SetOutputDir(fdir)
        smallk.SeedRNG(FACADE_SEED)
        smallk.LoadMatrix(matrix=A)
        smallk.LoadDictionary(words)
        reset_counts()
        _, _, wall = timed_call(smallk.HierNmf2WithFlat, k)
        counts = read_counts()
        smallk.Finalize()
        got, want = files_of(fdir), files_of(ddir)
    *_, wall1 = direct()
    names = [f"assignments_{k}.csv", f"tree_{k}.json",
             f"assignments_flat_{k}.csv"]
    same = [name for name in names if got.get(name) == want[name]]
    leaves = sum(tree.is_leaf)
    log(f"[facade] HierNmf2WithFlat({k}) {HIER_M}x{HIER_N} (f32 A): "
        f"{stats.nmf_count} factorizations, iter_count {stats.iter_count}, "
        f"{leaves} leaves, K3 launches {counts['K3']} (direct "
        f"{dcounts['K3']}), products to torch.matmul "
        f"{counts['matmul_products']} (the flat refinement's); files equal "
        f"to the direct run_hier_nmf2's: {same} of {sorted(got)}; wall: "
        f"facade {wall:.4f} s, direct before and after {wall0:.4f} s, "
        f"{wall1:.4f} s on {card}")
    if same != names or sorted(got) != sorted(want):
        raise AssertionError(f"facade HierNmf2WithFlat files differ: only "
                             f"{same} equal")
    if leaves != k or not flat["success"]:
        raise AssertionError(f"facade hierclust: {leaves} leaves, flat "
                             f"success {flat['success']}")
    if counts != dcounts or counts["K3"] < stats.iter_count \
            or (counts["K3"], counts["kernel_products"]) != k3_want(counts) \
            or counts["matmul_products"] > 3:
        raise AssertionError(f"facade hierclust bypassed K3: {counts}, "
                             f"direct {dcounts}")
    return {"wall": wall, "direct_wall": (wall0, wall1)}


def api_flatclust(card: str) -> dict:
    """api.Flatclust.cluster(16, algorithm="HALS") on the flatclust
    problem, between two direct run_flatclust calls from the same draws:
    one K2 launch per iteration, equal factors and assignments."""
    from smallk_torch import NmfAlgorithm, NmfOptions, NmfProgressAlgorithm
    from smallk_torch import NmfStats, Random
    from smallk_torch.api import Flatclust
    from smallk_torch.engines.flatclust import run_flatclust

    A, _, _ = flat_problem()
    W0, H0 = random_matrix_pair(Random(FACADE_SEED), FLAT_M, FLAT_N, FLAT_K)
    opts = NmfOptions(tol=1e-4, algorithm=NmfAlgorithm.HALS,
                      prog_est_algorithm=NmfProgressAlgorithm.PG_RATIO,
                      height=FLAT_M, width=FLAT_N, k=FLAT_K, min_iter=5,
                      max_iter=5000, tolcount=1, max_threads=8,
                      verbose=False, normalize=True, dtype="float32")

    def direct():
        stats = NmfStats()
        out, _, wall = timed_call(run_flatclust, np.asarray(A, np.float64),
                                  W0, H0, opts, stats, device="cuda")
        return out, stats, wall

    (W, H, assign, _, dok), stats, wall0 = direct()
    fc = Flatclust()
    fc.seed(FACADE_SEED)
    fc.load_matrix(matrix=A)
    fc.load_dictionary(dictionary=[f"term{i}" for i in range(FLAT_M)])
    reset_counts()
    ok, _, wall = timed_call(fc.cluster, FLAT_K, algorithm="HALS",
                             verbose=False)
    counts = read_counts()
    its = fc._stats.iteration_count
    *_, wall1 = direct()
    equal = (np.array_equal(fc.W, W) and np.array_equal(fc.H, H)
             and np.array_equal(fc.assignments, assign))
    log(f"[facade] api.Flatclust.cluster({FLAT_K}, HALS) {FLAT_M}x{FLAT_N}: "
        f"{its} iterations, {counts['steps']} steps run, K2 launches "
        f"{counts['K2']}, K1 {counts['K1']}; "
        f"factors and assignments {'equal' if equal else 'DIFFERENT'} to a "
        f"direct run_flatclust ({stats.iteration_count} iterations); wall "
        f"{wall:.4f} s, direct before and after {wall0:.4f} s, "
        f"{wall1:.4f} s on {card}")
    if not (ok and dok and equal):
        raise AssertionError("api.Flatclust differs from run_flatclust")
    if counts["K2"] != counts["steps"] or counts["steps"] < its \
            or counts["K1"] or its != stats.iteration_count:
        raise AssertionError(f"api.Flatclust HALS: {counts} in {its} "
                             "iterations")
    terms = fc.get_top_terms()
    if len(terms) != 5 * FLAT_K:
        raise AssertionError(f"{len(terms)} top terms")
    return {"wall": wall, "direct_wall": (wall0, wall1)}


def api_hierclust_sparse(card: str, sparse: dict) -> dict:
    """api.Hierclust.cluster(12) (its defaults: f32 A, min_iter 5) on the
    50,000 x 1,000,000 corpus of phase_sparse_hierclust, with its seed:
    12 leaves, NMI within FACADE_NMI_MARGIN of that phase's run, the
    products through seg_spmm and ell_spmm and none dense."""
    from smallk_torch.api import Hierclust
    from smallk_torch.engines.scoring import nmi

    A, labels = sparse["corpus"]
    hc = Hierclust()
    hc.seed(2)
    hc.load_matrix(matrix=A)
    hc.load_dictionary(dictionary=[f"t{i}" for i in range(SPH_M)])
    reset_counts()
    *_, wall = timed_call(hc.cluster, HIER_K, verbose=False)
    counts = read_counts()
    stats = hc._stats
    leaves = sum(hc.tree.is_leaf)
    score = nmi(hc.get_assignments(), labels)
    log(f"[facade] api.Hierclust.cluster({HIER_K}) {SPH_M}x{SPH_N} (f32 "
        f"EllAOp): wall {wall:.4f} s (sparse hierclust phase, bf16: "
        f"{sparse['wall']:.4f} s), nmf_count {stats.nmf_count}, iter_count "
        f"{stats.iter_count}, leaves {leaves}, NMI {score:.4f} (phase "
        f"{sparse['nmi']:.4f}), ell_spmm launches {counts['ell_spmm']}, "
        f"seg_spmm launches {counts['seg_spmm']}, plain calls on cuda "
        f"{counts['ell_plain_cuda'] + counts['seg_plain_cuda']}, dense products "
        f"{counts['kernel_products']} + {counts['matmul_products']} on {card}")
    if leaves != HIER_K:
        raise AssertionError(f"api.Hierclust: {leaves} leaves")
    if abs(score - sparse["nmi"]) > FACADE_NMI_MARGIN:
        raise AssertionError(f"api.Hierclust NMI {score} against the "
                             f"phase's {sparse['nmi']}")
    if counts["ell_spmm"] + counts["seg_spmm"] < 2 * stats.iter_count \
            or counts["ell_plain_cuda"] or counts["seg_plain_cuda"]:
        raise AssertionError(f"api.Hierclust bypassed its kernels: {counts}")
    if counts["kernel_products"] or counts["matmul_products"]:
        raise AssertionError(f"api.Hierclust made dense products: {counts}")
    return {"wall": wall, "nmi": score}


def topk_check(name: str, got, scores, k: int, exclude=None) -> float:
    """A port top-k (indices, values) against the f64 scores of every
    row: the same indices as the f64 top-k except where two scores lie
    within EMB_TIE of each other, values within EMB_RTOL relative.
    Returns the largest relative value error."""
    idx, vals = got
    s = scores.copy()
    if exclude is not None:
        s[exclude] = -np.inf
    want = np.argpartition(-s, k)[:k]
    want = want[np.argsort(-s[want], kind="stable")]
    if len(set(idx.tolist())) != k or (exclude is not None
                                       and exclude in idx):
        raise AssertionError(f"{name}: indices {idx}")
    gap = np.abs(s[idx] - s[want])
    if not (gap <= EMB_TIE).all():
        raise AssertionError(f"{name}: indices {idx} against {want}, "
                             f"score gaps {gap}")
    err = np.abs(vals - s[idx]) / np.abs(s[idx])
    if not (err <= EMB_RTOL).all():
        raise AssertionError(f"{name}: values off by {err.max()} relative")
    return float(err.max())


def facade_embeddings(card: str, W, H) -> dict:
    """NmfEmbeddings on the flagship's MU factors (W 50,000 x 128, H 128 x
    1,000,000; the doc table 512 MB on the card): top docs and terms for
    EMB_QUERIES topics, similar docs for as many docs, and search for as
    many term-weight queries, against f64 on the host; ms per call."""
    import torch

    from smallk_torch.engines.embeddings import NmfEmbeddings

    emb = NmfEmbeddings(W, H)
    table = emb.docs.table
    doc_bytes = table.numel() * table.element_size()
    if not table.is_cuda or doc_bytes != FLAG_N * FLAG_K * 4:
        raise AssertionError(f"doc table {table.device} {doc_bytes} bytes")
    rs = np.random.RandomState(17)
    topics = np.arange(EMB_QUERIES) * (FLAG_K // EMB_QUERIES)
    docs = rs.choice(FLAG_N, EMB_QUERIES, replace=False)
    queries = np.zeros((EMB_QUERIES, FLAG_M))
    for q in queries:
        q[rs.choice(FLAG_M, 20, replace=False)] = rs.rand(20)
    W64, H64 = W.astype(np.float64), H.astype(np.float64)
    Hn = H64.T / np.maximum(np.linalg.norm(H64.T, axis=1, keepdims=True),
                            1e-12)
    k = EMB_TOPK
    worst = 0.0
    for t in topics:
        worst = max(worst, topk_check("top_docs_for_topic",
                                      emb.top_docs_for_topic(int(t), k),
                                      H64[t], k),
                    topk_check("top_terms_for_topic",
                               emb.top_terms_for_topic(int(t), k),
                               W64[:, t], k))
    sim = Hn @ Hn[docs].T                                # (n, queries)
    for j, d in enumerate(docs):
        worst = max(worst, topk_check("similar_docs",
                                      emb.similar_docs(int(d), k),
                                      sim[:, j], k, exclude=int(d)))
    del sim
    qe = queries @ W64
    qn = qe / np.maximum(np.linalg.norm(qe, axis=1, keepdims=True), 1e-12)
    found = Hn @ qn.T
    for j, q in enumerate(queries):
        worst = max(worst, topk_check("search", emb.search(q, k),
                                      found[:, j], k))
    del found, Hn
    ms = {"top_docs_for_topic": back_to_back_ms(
              lambda: emb.top_docs_for_topic(3, k), 20),
          "top_terms_for_topic": back_to_back_ms(
              lambda: emb.top_terms_for_topic(3, k), 20),
          "similar_docs": back_to_back_ms(
              lambda: emb.similar_docs(int(docs[0]), k), 20),
          "search": back_to_back_ms(lambda: emb.search(queries[0], k), 20),
          f"topk_cosine, {EMB_QUERIES} queries": back_to_back_ms(
              lambda: emb.docs.topk_cosine(qe, k), 20)}
    log(f"[facade] NmfEmbeddings on the flagship's MU factors (W "
        f"{W.shape}, H {H.shape}; doc table {doc_bytes / 1e6:.0f} MB on the "
        f"card): {EMB_QUERIES} queries each of top_docs_for_topic, "
        f"top_terms_for_topic, similar_docs and search, top {k}, equal to "
        f"f64 on the host (ties within {EMB_TIE:g}), values within "
        f"{worst:.2e} relative (tolerance {EMB_RTOL:g}); ms per call: "
        + ", ".join(f"{name} {v:.4f}" for name, v in ms.items())
        + f" on {card}")
    del emb
    torch.cuda.empty_cache()
    return {"ms": ms, "worst": worst}


def trace_child() -> int:
    """--trace: TRACE_CALLS K1 calls at the main path's W-side shape and a
    torch.mm under profiling.device_trace, in a process of its own; the
    trace's event, kernel and K1 kernel counts as one JSON line last."""
    import torch

    from smallk_torch.common.device import setup
    from smallk_torch.common.profiling import device_trace
    from smallk_torch.kernels.masked_gj import masked_gj_solve

    setup("cuda")
    LHS, RHS, passive = k1_inputs(*MAIN_SHAPES[-1], torch.float32, "cuda")
    masked_gj_solve(LHS, RHS, passive)
    with tempfile.TemporaryDirectory() as td:
        with device_trace(td):
            for _ in range(TRACE_CALLS):
                masked_gj_solve(LHS, RHS, passive)
            torch.mm(LHS, RHS)
        with open(os.path.join(td, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events
               if e.get("cat") == "kernel"]
    print(json.dumps({"events": len(events), "kernels": len(kernels),
                      "k1": sum("masked_gj_kernel" in k for k in kernels)}))
    return 0


def facade_profiling(card: str) -> dict:
    """profiling.block_and_time on a K1 call at the main path's W-side
    shape against device_ms of the same call, and a device_trace of such
    calls in which K1's kernel appears.  The trace is taken in a process
    of its own: in this one, after earlier profiles, a trace lost most
    launches' records (1 of 20 kept after the sparse hierclust phase's
    ~900k launches, 0 of 1 in another run), and a profile taken first
    left the flagship's later one with none."""
    import torch

    from smallk_torch.common.profiling import block_and_time
    from smallk_torch.kernels.masked_gj import masked_gj_solve

    k, n = MAIN_SHAPES[-1]
    LHS, RHS, passive = k1_inputs(k, n, torch.float32, "cuda")

    def fn():
        return masked_gj_solve(LHS, RHS, passive)

    secs, out = block_and_time(fn, warmup=3, reps=200)
    dev_ms = device_ms(fn, 200)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           "--trace"], env=env, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"the trace child exited {proc.returncode}:\n"
                             f"{proc.stdout}\n{proc.stderr}")
    trace = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"[facade] profiling.block_and_time on K1 ({k}, {n}): "
        f"{secs * 1e3:.5f} ms a call (CUDA events, back to back), "
        f"device_ms {dev_ms:.5f} ms; device_trace of {TRACE_CALLS} K1 calls "
        f"and a torch.mm (a process of its own): {trace['events']} events, "
        f"{trace['kernels']} kernels, {trace['k1']} of masked_gj_kernel, on "
        f"{card}")
    if not (out.is_cuda and 0 < dev_ms and secs * 1e3 >= 0.5 * dev_ms):
        raise AssertionError(f"block_and_time {secs} s against device_ms "
                             f"{dev_ms} ms")
    if not trace["k1"]:
        raise AssertionError(f"device_trace holds no K1 kernel: {trace}")
    return {"ms": secs * 1e3, "device_ms": dev_ms, "trace": trace}


def phase_facade(card: str, sparse: dict, mu_factors) -> dict:
    """The user-facing entry points over the kernels: the facade's Nmf and
    HierNmf2WithFlat, the API's Flatclust and Hierclust, the embedding
    tables, and the profiling utilities."""
    return {"nmf": facade_nmf(card), "hier": facade_hier(card),
            "flat": api_flatclust(card),
            "sparse": api_hierclust_sparse(card, sparse),
            "embeddings": facade_embeddings(card, *mu_factors),
            "profiling": facade_profiling(card)}


def phase_cli_chain() -> None:
    """The matrixgen, preprocessor, nmf and hierclust CLIs chained in
    subprocesses: a CLI_M x CLI_N sparse .mtx of term counts, reduced by
    preprocess_tf, then factored and clustered on the card."""
    from smallk_torch.io.matrix_market import load_matrix_market

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH")) if p)

    def run(td, *cmd):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", *cmd], cwd=td, env=env,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"{cmd[0]} exited {proc.returncode}:\n"
                                 f"{proc.stdout}\n{proc.stderr}")
        return time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as td:
        indir, outdir = os.path.join(td, "in"), os.path.join(td, "out")
        os.makedirs(indir)
        os.makedirs(outdir)
        mtx = os.path.join(indir, "matrix.mtx")
        secs = [run(td, "smallk_torch.cli.matrixgen_cli", "--height",
                    str(CLI_M), "--width", str(CLI_N), "--filename", mtx,
                    "--type", "SPARSE", "--nz_per_col", str(CLI_NZ),
                    "--rng_center", "5", "--rng_radius", "4", "--seed",
                    "13")]
        with open(os.path.join(indir, "dictionary.txt"), "w") as f:
            f.write("".join(f"term{i}\n" for i in range(CLI_M)))
        with open(os.path.join(indir, "documents.txt"), "w") as f:
            f.write("".join(f"doc{i}\n" for i in range(CLI_N)))
        A = load_matrix_market(mtx)
        secs.append(run(td, "smallk_torch.cli.preprocessor_cli", "--indir",
                        indir, "--outdir", outdir))
        R = load_matrix_market(os.path.join(outdir, "reduced_matrix.mtx"))
        with open(os.path.join(outdir, "reduced_dictionary.txt")) as f:
            terms = f.read().splitlines()
        with open(os.path.join(outdir, "reduced_documents.txt")) as f:
            docs = f.read().splitlines()
        reduced = os.path.join(outdir, "reduced_matrix.mtx")
        secs.append(run(td, "smallk_torch.cli.nmf_cli", "--matrixfile",
                        reduced, "--k", "8", "--maxiter", "20", "--seed",
                        "1", "--verbose", "0", "--device", "cuda"))
        W = np.loadtxt(os.path.join(td, "w.csv"), delimiter=",", ndmin=2)
        H = np.loadtxt(os.path.join(td, "h.csv"), delimiter=",", ndmin=2)
        clusters = 4
        secs.append(run(td, "smallk_torch.cli.hierclust_cli", "--matrixfile",
                        reduced, "--dictfile",
                        os.path.join(outdir, "reduced_dictionary.txt"),
                        "--clusters", str(clusters), "--flat", "1",
                        "--device", "cuda", "--verbose", "0", "--seed", "1",
                        "--outdir", td))
        with open(os.path.join(td, f"tree_{clusters}.xml")) as f:
            nodes = f.read().count("<node id=")
        flat = np.loadtxt(os.path.join(td, f"assignments_flat_{clusters}.csv"),
                          delimiter=",", dtype=np.int64, ndmin=1, max_rows=1)
    m, n = R.shape
    if A.shape != (CLI_M, CLI_N) or not A.nnz:
        raise AssertionError(f"matrixgen wrote {A.shape}, {A.nnz} nonzeros")
    if (m, n) != (len(terms), len(docs)) or not 0 < m <= CLI_M \
            or not 0 < n <= CLI_N:
        raise AssertionError(f"preprocessor wrote {R.shape}, {len(terms)} "
                             f"terms, {len(docs)} documents")
    norms = np.sqrt(np.asarray(R.power(2).sum(axis=0)).ravel())
    if np.abs(norms - 1).max() > 1e-3:
        raise AssertionError("reduced columns are not unit norm")
    if W.shape != (m, 8) or H.shape != (8, n):
        raise AssertionError(f"nmf_cli wrote W {W.shape}, H {H.shape}")
    if nodes != 2 * (clusters - 1) or flat.shape != (n,):
        raise AssertionError(f"hierclust_cli: {nodes} tree nodes, flat "
                             f"assignments {flat.shape}")
    log(f"[cli] chain: matrixgen_cli --type SPARSE {CLI_M}x{CLI_N} "
        f"({A.nnz} nonzeros) {secs[0]:.1f} s -> preprocessor_cli {m}x{n} "
        f"({R.nnz} nonzeros) {secs[1]:.1f} s -> nmf_cli k=8 --device cuda "
        f"{secs[2]:.1f} s (w.csv {W.shape}, h.csv {H.shape}) -> "
        f"hierclust_cli --clusters {clusters} --flat 1 --device cuda "
        f"{secs[3]:.1f} s ({nodes} tree nodes, flat assignments "
        f"{flat.shape}); every exit code 0")


def flagship_mu_factors():
    """The flagship's MU factors after FLAG_MU_ITERS[-1] iterations, as
    phase_flagship leaves them (for --facade, which skips that phase)."""
    from smallk_torch import NmfAlgorithm, NmfOptions
    from smallk_torch.engines.nmf import run_nmf
    from smallk_torch.ops.ell import EllAOp

    A, W0, H0 = flagship_problem()
    op = EllAOp.from_scipy(A, "bfloat16", device="cuda")
    del A
    opts = NmfOptions(tol=1e-30, algorithm=NmfAlgorithm.MU, height=FLAG_M,
                      width=FLAG_N, k=FLAG_K, min_iter=1,
                      max_iter=FLAG_MU_ITERS[-1], verbose=False,
                      a_dtype="bfloat16")
    W, H, ok = run_nmf(op, W0, H0, opts, device="cuda")
    if not ok:
        raise AssertionError("flagship MU failed")
    return W, H


def facade_study(card: str) -> None:
    """--facade: the inputs the facade phase reuses, made on their own
    (sparse hierclust's run and corpus, the flagship's MU factors), then
    the facade phase and the CLI chain."""
    sparse = phase_sparse_hierclust(card)
    phase_facade(card, sparse, flagship_mu_factors())
    phase_cli_chain()


def times_child(tree: str) -> int:
    """--times TREE: the numbers `--pair` compares, with smallk_torch
    imported from TREE (this tree's or an archived parent's), through entry
    points both designs have; one JSON line last."""
    import hashlib

    sys.path.insert(0, tree)
    import torch

    import smallk_torch
    from smallk_torch import NmfAlgorithm, NmfOptions, NmfProgressAlgorithm
    from smallk_torch import (NmfStats, Random, random_matrix,
                              random_sparse_matrix)
    from smallk_torch.common.device import setup
    from smallk_torch.engines.flatclust import run_flatclust
    from smallk_torch.engines.nmf import run_nmf
    from smallk_torch.kernels import ell_spmm as kmod
    from smallk_torch.kernels import hals_step as k2
    from smallk_torch.ops.ell import EllAOp
    from smallk_torch.solvers.solve import nmf_solve

    if not smallk_torch.__file__.startswith(str(Path(tree).resolve())):
        raise AssertionError(f"smallk_torch from {smallk_torch.__file__}")
    setup("cuda")
    res = {"tree": tree}
    f32, bf16 = torch.float32, torch.bfloat16
    for (m, n, k), a_dtype in (((256, 256, 16), f32), ((256, 256, 16), bf16),
                               ((888, 888, 16), f32)):
        args = k2_inputs(m, n, k, a_dtype)
        res[f"K2 {m} {str(a_dtype)[6:]} ms"] = device_ms(
            lambda: k2.hals_step(*args), 200)
    A, W0, H0 = flat_problem()
    opts = NmfOptions(tol=1e-30, algorithm=NmfAlgorithm.HALS,
                      prog_est_algorithm=NmfProgressAlgorithm.PG_RATIO,
                      height=FLAT_M, width=FLAT_N, k=FLAT_K, min_iter=5,
                      max_iter=FLAT_ITERS, tolcount=1, verbose=False,
                      normalize=True, dtype="float32")
    run_flatclust(A, W0, H0, dataclasses.replace(opts, max_iter=200),
                  device="cuda")
    stats = NmfStats()
    run_flatclust(A, W0, H0, opts, stats, device="cuda")
    res["flatclust HALS it/s"] = stats.iteration_count / (
        stats.elapsed_us / 1e6)
    # the BPP main path (phase_main_path): a warm-up, then two timed runs
    rng = Random(2024)
    A = random_sparse_matrix(rng, M, N, nz_per_col=NZ_PER_COL,
                             dtype=np.float32)
    W0 = random_matrix(M, K, rng, dtype=np.float32)
    H0 = random_matrix(K, N, rng, dtype=np.float32)
    opts = NmfOptions(tol=1e-30, algorithm=NmfAlgorithm.BPP, height=M,
                      width=N, k=K, min_iter=1, max_iter=ITERS,
                      verbose=False, a_dtype="bfloat16")
    run_nmf(A, W0, H0, opts, device="cuda")
    res["Reuters BPP it/s"] = []
    for _ in range(2):
        stats = NmfStats()
        run_nmf(A, W0, H0, opts, stats, device="cuda")
        res["Reuters BPP it/s"].append(stats.iteration_count / (
            stats.elapsed_us / 1e6))
    for name, (G, L, B, k, vt, tt) in ELL_PROBES.items():
        idx, vals, table = ell_inputs(G, L, B, k, vt, tt, 0.0, seed=7)
        out = torch.empty((G, k), device="cuda")
        res[f"{name} ms"] = device_ms(
            lambda: kmod.ell_spmm(idx, vals, table, out), 50)

    A, W0, H0 = flagship_problem()
    op = EllAOp.from_scipy(A, "bfloat16", device="cuda")
    del A
    W, H = torch.from_numpy(W0).cuda(), torch.from_numpy(H0).cuda()
    for name, fn, F in (("W'A", op.mm_tn, W), ("AH'", op.mm_nt, H)):
        got = fn(F)
        res[f"{name} sha256"] = hashlib.sha256(
            got.cpu().numpy().tobytes()).hexdigest()[:16]
        res[f"{name} shape"] = list(got.shape)
        del got
        res[f"{name} ms"] = back_to_back_ms(lambda: fn(F), 5)
    # the solve loop alone on factors already on the card, from a
    # synchronize to a synchronize: no host copy of the factors in the
    # window (run_nmf's own timer holds W's and H's pageable copies, 0.54
    # GB).  A 1-iteration warm-up, then each window `reps` times; the fit takes each window's median, as MU's
    # short window can jump.  U: the loop's auto value, and for MU also
    # U = 1 (a tree whose loop ignores loop_unroll runs the same loop)
    for alg, iters, reps, unroll in (("MU", FLAG_MU_ITERS, 3, 0),
                                     ("MU", FLAG_MU_ITERS, 3, 1),
                                     ("BPP", FLAG_BPP_ITERS, 1, 0)):
        walls = {it: [] for it in (1, *iters)}
        for it in (1, *iters * reps):
            W1, H1 = W.clone(), H.clone()
            opts = NmfOptions(tol=1e-30, algorithm=NmfAlgorithm(alg),
                              height=FLAG_M, width=FLAG_N, k=FLAG_K,
                              min_iter=1, max_iter=it, verbose=False,
                              a_dtype="bfloat16", loop_unroll=unroll)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = nmf_solve(op, W1, H1, opts)
            torch.cuda.synchronize()
            walls[it].append(round(time.perf_counter() - t0, 6))
            if out.iterations != it:
                raise AssertionError(f"{alg}: {out.iterations} iterations")
            if alg == "BPP":
                res[f"BPP {it} rounds, rel err"] = [
                    int(out.pivot_rounds),
                    round(sparse_rel_err(op, out.W, out.H), 6)]
            del out, W1, H1
        lo, hi = iters
        name = alg + (f" U={unroll}" if unroll else "")
        res[f"{name} s per run of {tuple(walls)} iterations"] = walls
        res[f"{name} it/s"] = (hi - lo) / (float(np.median(walls[hi]))
                                           - float(np.median(walls[lo])))
    del op, W, H
    torch.cuda.empty_cache()
    res.update(sparse_hier_times())
    print(json.dumps(res), flush=True)
    return 0


def sparse_hier_times() -> dict:
    """The sparse hierclust numbers `--pair` compares: the k = 2 products
    (f32 factors on the bf16 50,000 x 1,000,000 corpus) at the root's
    static operand (what the run's root solves on), at the root's EllAOp
    and at a 1/SPH_NODE node's gathered operand, back to back, and the
    clustering's wall (after a warm-up run with another seed) with its
    iterations, leaves and NMI."""
    import torch

    from smallk_torch import ClustStats, Random
    from smallk_torch.engines import hierclust as hc
    from smallk_torch.engines.scoring import nmi
    from smallk_torch.ops import ell_cols
    from smallk_torch.ops.aop import as_aop

    A, labels, _ = sparse_corpus(SPH_N)
    a_op = as_aop(A, dtype="bfloat16", device="cuda")
    idx = torch.from_numpy(np.sort(np.random.RandomState(3).permutation(
        SPH_N)[:SPH_N // SPH_NODE])).cuda()
    cols = ell_cols.CscChunks.from_scipy(A, "bfloat16", device="cuda")
    ops = {"root static": chunk_operand(
        cols, torch.arange(SPH_N, device="cuda"))[0],
        "root EllAOp": a_op,
        f"1/{SPH_NODE} node": chunk_operand(cols, idx)[0]}
    res = {}
    gen = torch.Generator(device="cuda").manual_seed(5)
    for label, op in ops.items():
        W = torch.rand((SPH_M, 2), generator=gen, device="cuda")
        H = torch.rand((2, op.shape[1]), generator=gen, device="cuda")
        res[f"k=2 {label} W'A ms"] = back_to_back_ms(lambda: op.mm_tn(W), 5)
        res[f"k=2 {label} AH' ms"] = back_to_back_ms(lambda: op.mm_nt(H), 5)
    del cols, ops
    torch.cuda.empty_cache()
    opts = hier_opts(HIER_K, "float32", a_dtype="bfloat16")
    hc.clust_hier(a_op, opts, Random(1), host_A=A)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree, stats = hc.clust_hier(a_op, opts, Random(2), ClustStats(),
                                host_A=A)
    torch.cuda.synchronize()
    res["sparse hierclust wall s"] = time.perf_counter() - t0
    res["sparse hierclust iter_count, leaves, NMI"] = [
        stats.iter_count, int(sum(tree.is_leaf)),
        round(nmi(tree.assignments, labels), 4)]
    return res


def pair(parent: str, card: str) -> None:
    """--pair DIR: the kernels' and the loops' numbers (`--times`: K2,
    P1, P2, the flagship's products, flatclust HALS, Reuters BPP and
    flagship MU and BPP it/s, sparse hierclust) from an archived parent
    tree at DIR and from this tree, in the order parent, change, change,
    parent, each in a process of its own, on one card; the flagship's
    products must be bit-equal across the two."""
    runs = []
    for tree in (parent, str(ROOT), str(ROOT), parent):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--times", tree],
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"--times {tree} failed ({proc.returncode}):"
                               f"\n{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        log(f"[pair] {'parent' if tree == parent else 'change'} in "
            f"{time.perf_counter() - t0:.1f} s: {json.dumps(runs[-1])}")
    par, chg = (runs[0], runs[3]), (runs[1], runs[2])
    for key in runs[0]:
        if key == "tree":
            continue
        log(f"[pair] {key}: parent {par[0][key]}, {par[1][key]}; change "
            f"{chg[0][key]}, {chg[1][key]}")
    for key in ("W'A sha256", "AH' sha256"):
        if len({r[key] for r in runs}) != 1:
            raise AssertionError(f"{key} differs between the trees")
    for r in runs:
        if r["sparse hierclust iter_count, leaves, NMI"][1] != HIER_K:
            raise AssertionError(f"sparse hierclust in {r['tree']}: not "
                                 f"{HIER_K} leaves")
    log(f"[pair] the flagship's products are bit-equal in both trees; on "
        f"{card}")


def loop_flatclust_cell():
    """The flatclust HALS cell (K2): run_flatclust on the reference's
    flatclust configuration, to its tol of 1e-4."""
    from smallk_torch import (NmfAlgorithm, NmfOptions, NmfProgressAlgorithm,
                              NmfStats)
    from smallk_torch.engines.flatclust import run_flatclust

    A, W0, H0 = flat_problem()
    opts = NmfOptions(tol=1e-4, algorithm=NmfAlgorithm.HALS,
                      prog_est_algorithm=NmfProgressAlgorithm.PG_RATIO,
                      height=FLAT_M, width=FLAT_N, k=FLAT_K, min_iter=5,
                      max_iter=5000, tolcount=1, verbose=False)

    def run(unroll=0):
        stats = NmfStats()
        W, H, assign, _, ok = run_flatclust(
            A, W0, H0, dataclasses.replace(opts, loop_unroll=unroll), stats,
            device="cuda")
        if not ok:
            raise AssertionError("loop: flatclust HALS failed")
        return {"iterations": stats.iteration_count, "bits": (W, H, assign)}

    def gate(counts, out):
        # one K2 launch a step run, frozen steps included
        if counts["K2"] != counts["steps"] or counts["K1"] \
                or counts["steps"] < out["iterations"]:
            raise AssertionError(f"loop flatclust: {counts}")

    return run, gate


def product_launches(op) -> tuple[int, int, int, int, int]:
    """ell_spmm launches of one W'A, of them the transposed ones, and of
    one AH' of a node operand, then seg_spmm's of one W'A and one AH': an
    EllAOp's from its buckets (a bucket with no rows launches nothing), a
    masked view's from its base, a ChunkColsAOp's one seg_spmm a
    product."""
    from smallk_torch.ops.aop import MaskedAOp
    from smallk_torch.ops.ell import EllAOp
    from smallk_torch.ops.ell_cols import ChunkColsAOp

    if isinstance(op, MaskedAOp):
        return product_launches(op.base)
    if isinstance(op, ChunkColsAOp):
        return 0, 0, 0, 1, 1
    if not isinstance(op, EllAOp):
        raise TypeError(f"no launch count for {type(op)}")
    tn = sum(p.launching for _, _, p in op.col_packs)
    return tn, tn, sum(p.launching for _, _, p in op.row_packs), 0, 0


def sparse_launch_gate(label: str, counts: dict, solves) -> dict:
    """The launches a sparse hierclust run must count, from the operand
    and the steps of each of its solves (recorded by wrapping
    hierclust.nmf_solve): a solve runs W'A once and then one W'A and one AH'
    a step, each at its operand's launches (product_launches); nothing
    through a plain version or a dense product.  Returns the expected
    counts."""
    want = {"ell_spmm": sum(tn * (s + 1) + nt * s
                            for (tn, _, nt, _, _), s in solves),
            "ell_spmm_transposed": sum(tn_t * (s + 1)
                                       for (_, tn_t, _, _, _), s in solves),
            "seg_spmm": sum(a * (s + 1) + b * s
                            for (_, _, _, a, b), s in solves),
            "solves": len(solves), "steps": sum(s for _, s in solves)}
    if any(counts[k] != v for k, v in want.items()) \
            or counts["ell_plain_cuda"] or counts["seg_plain_cuda"] \
            or counts["kernel_products"] or counts["matmul_products"]:
        raise AssertionError(f"{label}: {counts}, expected {want}")
    return want


@contextlib.contextmanager
def recorded_solves():
    """hierclust.nmf_solve wrapped for the block: yields the list of
    (product_launches(op), steps run) of each solve, in order."""
    from smallk_torch.engines import hierclust as hc
    from smallk_torch.solvers import solve

    solves = []

    def recorded(op, *args, **kwargs):
        before = solve.steps_run
        res = solve.nmf_solve(op, *args, **kwargs)
        solves.append((product_launches(op), solve.steps_run - before))
        return res

    with patched(hc, "nmf_solve", recorded):
        yield solves


def loop_hier_cell(a_op, labels, host_A=None):
    """A hierclust cell: clust_hier to HIER_K clusters with seed 2, as the
    hierclust phases run it (dense bf16 A through K3, or the sparse
    corpus's EllAOp and gathered node operands through ell_spmm: each
    solve's operand and steps recorded for the gate)."""
    from smallk_torch import Random
    from smallk_torch.engines import hierclust as hc
    from smallk_torch.engines.scoring import nmi

    opts = hier_opts(HIER_K, "float32", a_dtype="bfloat16")
    sparse = host_A is not None

    def run(unroll=0):
        o = dataclasses.replace(opts, nmf_opts=dataclasses.replace(
            opts.nmf_opts, loop_unroll=unroll))
        solves = []
        with recorded_solves() if sparse else contextlib.nullcontext([]) \
                as solves:
            tree, stats = hc.clust_hier(a_op, o, Random(2), host_A=host_A)
        leaves = sum(tree.is_leaf)
        # the splits: every node's documents
        splits = tuple(np.asarray(n.docs) for n in tree.nodes
                       if n.is_valid)
        return {"iterations": stats.iter_count, "leaves": leaves,
                "nmi": nmi(tree.assignments, labels), "solves": solves,
                "bits": (tree.assignments,) + splits}

    def gate(counts, out):
        if out["leaves"] != HIER_K:
            raise AssertionError(f"loop hierclust: {out['leaves']} leaves")
        if sparse:
            sparse_launch_gate("loop sparse hierclust", counts,
                               out["solves"])
            if round(out["nmi"], 3) != SPH_NMI:
                raise AssertionError(f"loop sparse hierclust: NMI "
                                     f"{out['nmi']}, not {SPH_NMI}")
            return
        want = k3_want(counts)
        if (counts["K3"], counts["kernel_products"]) != want \
                or counts["matmul_products"]:
            raise AssertionError(f"loop hierclust: {counts}, K3 expected "
                                 f"{want}")

    return run, gate


def loop_flagship_cell(flag):
    """The flagship MU cell (ell_spmm at k = 128): FLAG_MU_ITERS[-1] fixed
    iterations on the uncut 50,000 x 1,000,000 bf16 EllAOp, as the
    flagship phase runs them, through nmf_solve on factors already on the
    card (run_nmf's pageable copies of the 512 MB factors would take most
    of the wall), at the auto U: 1, so no graph in either mode."""
    import torch

    from smallk_torch import NmfAlgorithm, NmfOptions
    from smallk_torch.solvers.solve import nmf_solve

    op = flag["op"]
    # contiguous, as run_nmf copies them (random_matrix fills in column
    # order): the factors then equal the flagship phase's bit for bit
    W0, H0 = (torch.from_numpy(np.ascontiguousarray(F)).cuda()
              for F in (flag["W0"], flag["H0"]))
    iters = FLAG_MU_ITERS[-1]
    tn_per = sum(p.launching for _, _, p in op.col_packs)
    nt_per = sum(p.launching for _, _, p in op.row_packs)
    opts = NmfOptions(tol=1e-30, algorithm=NmfAlgorithm.MU, height=FLAG_M,
                      width=FLAG_N, k=FLAG_K, min_iter=1, max_iter=iters,
                      verbose=False, a_dtype="bfloat16")

    def run(unroll=0):
        r = nmf_solve(op, W0, H0, dataclasses.replace(opts,
                                                      loop_unroll=unroll))
        if not r.success or r.iterations != iters:
            raise AssertionError("loop: flagship MU failed")
        return {"iterations": iters, "bits": (r.W, r.H)}

    def gate(counts, out):
        steps = counts["steps"]
        if counts["ell_spmm"] != nt_per * steps + tn_per * (steps + 1) \
                or counts["ell_spmm_transposed"] != tn_per * (steps + 1) \
                or counts["ell_plain_cuda"] or counts["K1"]:
            raise AssertionError(f"loop flagship MU: {counts}")

    return run, gate


def loop_bpp_cell(k: int = K, tol_at=None):
    """The main path's cell, Reuters BPP (K1): ITERS fixed iterations on
    the 12411 x 7984 bf16 operand through nmf_solve on factors already on
    the card, at k = K (the main path's draws) or another k (draws from
    Random(k)).  `tol_at`: to a tol instead, the PG ratio after that many
    iterations of a fixed run at U = 1, with checks from that iteration
    on, so that every run converges there.  Gated exactly on K1 (on the
    CG solves above K1's rank limit)."""
    import torch

    from smallk_torch import NmfAlgorithm, NmfOptions, Random
    from smallk_torch.kernels import masked_gj
    from smallk_torch.ops.aop import as_aop
    from smallk_torch.solvers.solve import nmf_solve

    A, W0, H0 = main_problem()
    if k != K:
        W0, H0 = random_matrix_pair(Random(k), M, N, k)
    op = as_aop(A, "bfloat16", device="cuda")
    W0, H0 = (torch.from_numpy(np.ascontiguousarray(F, np.float32)).cuda()
              for F in (W0, H0))
    opts = NmfOptions(tol=1e-30, algorithm=NmfAlgorithm.BPP, height=M,
                      width=N, k=k, min_iter=1, max_iter=tol_at or ITERS,
                      verbose=False, a_dtype="bfloat16")
    if tol_at:
        tol = float(nmf_solve(op, W0, H0, dataclasses.replace(
            opts, loop_unroll=1)).metric)
        opts = dataclasses.replace(opts, tol=tol, min_iter=tol_at - 1,
                                   max_iter=4 * tol_at)
    want = tol_at or ITERS

    def run(unroll=0):
        r = nmf_solve(op, W0, H0, dataclasses.replace(opts,
                                                      loop_unroll=unroll))
        if not r.success or r.iterations != want:
            raise AssertionError(f"loop: Reuters BPP k={k} stopped after "
                                 f"{r.iterations}, not {want}")
        return {"iterations": r.iterations, "rounds": r.pivot_rounds,
                "bits": (r.W, r.H, np.asarray(r.pivot_rounds))}

    def gate(counts, out):
        solves = k1_gate if k <= masked_gj.MAX_K else cg_gate
        if not solves(counts) or counts["K2"] or counts["K3"] \
                or counts["steps"] < out["iterations"] \
                or counts["rounds_run"] < out["rounds"]:
            raise AssertionError(f"loop Reuters BPP k={k}: {counts}")

    return run, gate


def loop_f64_parity() -> None:
    """MU, HALS and RANK2 in f64 on the card (the torch-ops steps and
    ell_spmm's f64 pair), captured against eager: bit for bit."""
    import scipy.sparse as sp
    import torch

    from smallk_torch import NmfAlgorithm, NmfOptions
    from smallk_torch.ops.aop import DenseAOp
    from smallk_torch.ops.ell import EllAOp
    from smallk_torch.solvers import graph, solve

    rng = np.random.RandomState(21)
    dense = DenseAOp(torch.tensor(rng.rand(800, 600), device="cuda"))
    ell = EllAOp.from_scipy(sp.random(SP_M, SP_N, density=0.02,
                                      random_state=rng, format="csc"),
                            "float64", device="cuda")
    for alg, op, k in (("HALS", dense, 16), ("RANK2", dense, 2),
                       ("MU", ell, SP_K)):
        m, n = op.shape
        W0 = torch.tensor(rng.rand(m, k), device="cuda")
        H0 = torch.tensor(rng.rand(k, n), device="cuda")
        opts = NmfOptions(tol=1e-6, algorithm=NmfAlgorithm(alg), height=m,
                          width=n, k=k, max_iter=300, verbose=False,
                          dtype="float64", stall_patience=50)
        res = {}
        for capture in LOOP_ORDER[:2]:
            with patched(graph, "CAPTURE", capture):
                reset_counts()
                r = solve.nmf_solve(op, W0, H0, opts)
                res[capture] = (r, read_counts())
        (e, ce), (c, cc) = res[False], res[True]
        same = (torch.equal(e.W, c.W) and torch.equal(e.H, c.H)
                and (e.iterations, e.converged) == (c.iterations,
                                                    c.converged))
        log(f"[loop f64] {alg} {m}x{n} k={k}: {c.iterations} iterations, "
            f"{cc['steps']} steps run, captured "
            f"{'equal' if same else 'DIFFERENT'} to eager bit for bit, "
            f"graphs {cc['captures']}")
        if not same or cc["captures"] != 1 or ce["captures"]:
            raise AssertionError(f"loop f64 {alg}: captured differs from "
                                 "eager")


def bits_equal(a, b) -> bool:
    """Every array (or tensor) of a equal to b's, bit for bit."""
    import torch

    return len(a) == len(b) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor)
        else np.array_equal(x, y) for x, y in zip(a, b))


def loop_cell(name: str, run, gate, card: str) -> dict:
    """One cell of the loop phase: `run` eager and captured in the order
    LOOP_ORDER, each run gated; captured equal to eager bit for bit, with
    the same counts.  Returns the walls and the captured run's counts."""
    import torch

    from smallk_torch.solvers import graph

    walls = {False: [], True: []}
    first, captures_ms = {}, []
    torch.cuda.empty_cache()  # no cell pays for an earlier one's cache
    for capture in LOOP_ORDER:
        with patched(graph, "CAPTURE", capture):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
            seconds = graph_seconds()
        gate(counts, out)
        walls[capture].append(wall)
        if capture:
            captures_ms.append(1e3 * seconds[0])
        if capture not in first:
            first[capture] = (out, counts, seconds)
        elif not bits_equal(out["bits"], first[capture][0]["bits"]):
            raise AssertionError(f"loop {name}: two runs differ")
    (e, ce, _), (c, cc, (capture_s, replay_s)) = first[False], first[True]
    keys = [key for key in ce if key not in ("captures", "replays")]
    same_counts = {key: ce[key] for key in keys} == {key: cc[key]
                                                     for key in keys}
    same = bits_equal(e["bits"], c["bits"]) and e["iterations"] == \
        c["iterations"] and e.get("nmi") == c.get("nmi")
    its = c["iterations"]
    kernel = max(("K1", "K2", "K3", "ell_spmm"), key=lambda key: cc[key])
    log(f"[loop] {name}: wall eager "
        f"{', '.join(f'{w:.4f}' for w in walls[False])} s, captured "
        f"{', '.join(f'{w:.4f}' for w in walls[True])} s; {its} iterations, "
        f"{cc['steps']} steps run in {cc['solves']} solves, "
        f"{cc['frozen']} wasted to the freeze; {kernel} launches "
        f"{cc[kernel]} ({cc[kernel] / its:.2f} an iteration); host reads "
        f"{cc['host_reads']} ({cc['host_reads'] / its:.4f} an iteration); "
        f"{cc['captures']} graphs, capture + instantiate "
        f"{1e3 * capture_s / max(cc['captures'], 1):.3f} ms a solve "
        f"(all captures of each captured run: "
        f"{', '.join(f'{t:.3f}' for t in captures_ms)} ms); "
        f"{cc['replays']} replays, host "
        f"{1e6 * replay_s / max(cc['replays'], 1):.2f} us a replay"
        + (f"; NMI {c['nmi']:.4f}, leaves {c['leaves']}" if "nmi" in c
           else "")
        + (f"; pivot rounds run {cc['rounds_run']}, K1 = 2 x steps + "
           f"rounds run: {k1_gate(cc)}" if cc["rounds_run"] else "")
        + f"; captured {'equal' if same else 'DIFFERENT'} to eager bit for "
        f"bit, counts {'equal' if same_counts else 'DIFFERENT'} on {card}")
    if not (same and same_counts):
        raise AssertionError(f"loop {name}: captured {cc} against eager "
                             f"{ce}")
    # a graph a solve at most, and none in the eager runs
    if cc["captures"] > cc["solves"] or ce["captures"]:
        raise AssertionError(f"loop {name}: {cc['captures']} graphs in "
                             f"{cc['solves']} solves")
    return {"walls": walls, "counts": cc, "iterations": its,
            "capture_s": capture_s, "replay_s": replay_s, "outs": (e, c)}


def phase_loop(card: str, flag: dict, sparse: dict) -> dict:
    """The solve loop at the four cells, eager against captured, the f64
    parity, and the device's busy share from a child process."""
    import torch

    cells = {"flatclust HALS": loop_flatclust_cell()}
    a_op, labels = hier_problem()
    cells["hierclust Reuters"] = loop_hier_cell(a_op, labels)
    A, slabels = sparse["corpus"]
    cells["sparse hierclust 50k x 1M"] = loop_hier_cell(sparse["op"],
                                                        slabels, host_A=A)
    cells["flagship MU k=128"] = loop_flagship_cell(flag)
    cells["Reuters BPP"] = loop_bpp_cell()
    loop_f64_parity()
    out = {name: loop_cell(name, run, gate, card)
           for name, (run, gate) in cells.items()}
    # graphs where the auto U is above 1; none at the flagship (U = 1)
    for name, cell in out.items():
        if (cell["counts"]["captures"] > 0) == name.startswith("flagship"):
            raise AssertionError(f"loop {name}: {cell['counts']['captures']}"
                                 " graphs captured")
    # flagship MU's factors, eager and captured, are the flagship phase's
    # after as many iterations, bit for bit, so its relative error is the
    # one recorded there
    Wp, Hp = flag["mu_factors"]
    same = [np.array_equal(W.cpu().numpy(), Wp)
            and np.array_equal(H.cpu().numpy(), Hp)
            for W, H in (o["bits"]
                         for o in out["flagship MU k=128"].pop("outs"))]
    log(f"[loop] flagship MU factors, eager and captured, "
        f"{'equal' if all(same) else 'DIFFERENT'} to the flagship phase's "
        f"after {FLAG_MU_ITERS[-1]} iterations (rel err "
        f"{flag['mu_rel'][FLAG_MU_ITERS[-1]]:.9f})")
    if not all(same):
        raise AssertionError("loop flagship MU: factors differ from the "
                             "flagship phase's")
    for cell in out.values():
        cell.pop("outs", None)
    del cells, a_op
    torch.cuda.empty_cache()
    return out


def loop_problems(only=None) -> dict:
    """The loop cells built from their seeds (`only="sparse"`: the sparse
    hierclust cell alone), for the processes of their own (--loop-busy,
    --loop)."""
    from smallk_torch.ops.aop import as_aop
    from smallk_torch.ops.ell import EllAOp

    cells = {}
    if only is None:
        cells["flatclust HALS"] = loop_flatclust_cell()
        a_op, labels = hier_problem()
        cells["hierclust Reuters"] = loop_hier_cell(a_op, labels)
        cells["Reuters BPP"] = loop_bpp_cell()
    A, slabels, _ = sparse_corpus(SPH_N)
    cells["sparse hierclust 50k x 1M"] = loop_hier_cell(
        as_aop(A, dtype="bfloat16", device="cuda"), slabels, host_A=A)
    return cells


def loop_busy_child(only=None) -> int:
    """--loop-busy: each loop cell once eager and once captured inside one
    torch.profiler session, in this process of its own (a second session
    in a process loses kernel records: PERF.md §7); the hierclust cells
    also on the other engines (captured only).  For each run: the device's
    busy share of its wall (the union of kernel intervals) and the host's
    launch calls (kernels and graphs).  `only="sparse"`: the sparse cell
    and its engines alone.  `only="lean"` (the full run's, whose time
    limit it keeps): every cell, the hierclust cells captured only and on
    the chain alone (the profiler's stop and its reading, most of this
    child's time, grow with the runs' kernel records).  Prints LOOP_BUSY
    {json}."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from smallk_torch.common.device import setup
    from smallk_torch.ops.ell import EllAOp
    from smallk_torch.solvers import graph

    setup("cuda")
    t0 = time.perf_counter()
    sparse = "sparse hierclust 50k x 1M"
    lean = only == "lean"
    cells = loop_problems(None if lean else only)
    # the hierclust cells on the sequential engine, capturing a graph a
    # solve and keeping one a width, beside the chain's (captured runs only)
    engines = []
    for cell in ("hierclust Reuters", sparse):
        if cell not in cells or lean:
            continue
        run_chain, gate = cells[cell]
        for mode in CHAIN_MODES:
            if mode != "chain":
                engines.append(f"{cell}, {mode}")
                cells[engines[-1]] = (lambda *a, mode=mode, r=run_chain:
                                      chain_mode(mode, r, *a), gate)
    if only != "sparse":
        FA, W0, H0 = flagship_problem()
        op = EllAOp.from_scipy(FA, "bfloat16", device="cuda")
        del FA
        cells["flagship MU k=128"] = loop_flagship_cell(
            {"op": op, "W0": W0, "H0": H0})
    for name in ("flatclust HALS", "hierclust Reuters", "Reuters BPP",
                 *engines):
        if name in cells:  # warm-ups
            cells[name][0]()
    torch.cuda.synchronize()
    stamps = [("problems and warm-ups", time.perf_counter() - t0)]
    walls = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for name, (run, _) in cells.items():
            once = name in engines or (lean and "hierclust" in name)
            for capture in ((True,) if once else (False, True)):
                label = f"loop|{name}|{'captured' if capture else 'eager'}"
                time.sleep(0.25)  # windows apart on either clock
                with patched(graph, "CAPTURE", capture), \
                        record_function(label):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = run()
                    torch.cuda.synchronize()
                    walls[label] = (time.perf_counter() - t0,
                                    out["iterations"])
        t0 = time.perf_counter()
    stamps.append(("the profiler's stop", time.perf_counter() - t0))
    t0 = time.perf_counter()
    windows, gpu = {}, []
    launch_calls = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                    "cudaGraphLaunch")
    calls = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # the windows' own ranges are mirrored on the device's
            # timeline, each spanning its window: not device work
            if e.duration_ns() > 0 and name not in walls:
                gpu.append((e.start_ns(), e.end_ns(),
                            SEG_KERNEL in name))
        elif name in walls:
            windows[name] = (e.start_ns(), e.end_ns())
        elif name in launch_calls:
            calls.append((e.start_ns(), name))
    gpu.sort()
    slack = 100_000_000  # ns: less than the gap between two windows
    result = {}
    for label, (lo, hi) in windows.items():
        spans = [(a, b, s) for a, b, s in gpu
                 if lo - slack <= a <= hi + slack]
        busy, end = 0, -1
        for a, b, _ in spans:
            if b > end:
                busy += b - max(a, end)
                end = b
        # seg_spmm's kernels' device time (they never overlap each other)
        seg = sum(b - a for a, b, s in spans if s)
        wall, its = walls[label]
        n = {c: sum(1 for t, nm in calls if nm == c and lo <= t <= hi)
             for c in launch_calls}
        _, cell, mode = label.split("|")
        result.setdefault(cell, {})[mode] = {
            "wall": wall, "busy": busy / 1e9 / wall, "iterations": its,
            "device_events": len(spans), "launch_calls": n,
            "launches_per_iteration": sum(n.values()) / max(its, 1),
            "seg_ms": seg / 1e6, "seg_share": seg / max(busy, 1)}
        log(f"[loop busy] {cell}, {mode}: wall {wall:.4f} s (profiled), "
            f"device busy {100 * busy / 1e9 / wall:.2f}%, {len(spans)} "
            f"device events, host launch calls {n} "
            f"({sum(n.values()) / max(its, 1):.2f} an iteration); seg_spmm "
            f"{seg / 1e6:.3f} device ms, {100 * seg / max(busy, 1):.2f}% of "
            f"the device time")
    stamps.append(("reading its events", time.perf_counter() - t0))
    log("[loop busy] host seconds: " + ", ".join(f"{k} {v:.1f}"
                                                 for k, v in stamps))
    if len(result) != len(cells) or not all(
            r["busy"] > 0 for c in result.values() for r in c.values()):
        raise AssertionError(f"the profile lost runs or kernels: {result}")
    print("LOOP_BUSY " + json.dumps(result), flush=True)
    return 0


def loop_busy(card: str, only=None) -> dict:
    """Runs --loop-busy (with `only`) in a process of its own; returns its
    shares."""
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           "--loop-busy", *([only] if only else [])],
                          capture_output=True, text=True, timeout=900,
                          cwd=ROOT)
    lines = proc.stdout.splitlines()
    for line in lines:
        if not line.startswith("LOOP_BUSY "):
            log(line)
    if proc.returncode != 0:
        log(proc.stderr[-4000:])
        raise AssertionError(f"--loop-busy exited {proc.returncode}")
    busy = json.loads(next(line for line in lines
                           if line.startswith("LOOP_BUSY "))[10:])
    for cell, modes in busy.items():
        log(f"[loop] {cell}: " + "; ".join(
            f"{mode}: device busy {100 * r['busy']:.2f}%, host launch calls "
            f"an iteration {r['launches_per_iteration']:.2f}"
            for mode, r in modes.items()) + f" on {card}")
        for mode, r in modes.items():
            if r["seg_ms"]:
                log(f"[loop] {cell}, {mode}: seg_spmm {r['seg_ms']:.3f} "
                    f"device ms in the run, {100 * r['seg_share']:.2f}% of "
                    f"its device time ({card})")
    return busy


def loop_mu_cell(op, W0, H0):
    """A MU cell that converges: nmf_solve on the EllAOp `op` from W0, H0
    (host arrays, made contiguous on the card as run_nmf makes them) with
    tol set, at the first run, to the PG ratio after LOOP_MU_FIXED
    iterations of a fixed run at U = 1, and checks from that iteration on
    (min_iter), so that every run converges there; gated exactly on its
    ell_spmm launches."""
    import torch

    from smallk_torch import NmfAlgorithm, NmfOptions
    from smallk_torch.solvers.solve import nmf_solve

    m, n = op.shape
    k = W0.shape[1]
    W0, H0 = (torch.from_numpy(np.ascontiguousarray(F, np.float32)).cuda()
              for F in (W0, H0))
    tn, tn_t, nt, _, _ = product_launches(op)
    fixed = LOOP_MU_FIXED
    opts = NmfOptions(tol=1e-30, algorithm=NmfAlgorithm.MU, height=m,
                      width=n, k=k, min_iter=1, max_iter=fixed,
                      verbose=False, a_dtype="bfloat16", loop_unroll=1)
    tol = []

    def run(unroll=0):
        if not tol:
            tol.append(float(nmf_solve(op, W0, H0, opts).metric))
        r = nmf_solve(op, W0, H0, dataclasses.replace(
            opts, tol=tol[0], min_iter=fixed - 1, max_iter=4 * fixed,
            loop_unroll=unroll))
        if not (r.success and r.converged and r.iterations == fixed):
            raise AssertionError(f"loop: MU {m}x{n} k={k} stopped after "
                                 f"{r.iterations}, not {fixed}")
        return {"iterations": r.iterations, "bits": (r.W, r.H)}

    def gate(counts, out):
        steps = counts["steps"]
        if counts["ell_spmm"] != nt * steps + tn * (steps + 1) \
                or counts["ell_spmm_transposed"] != tn_t * (steps + 1) \
                or counts["ell_plain_cuda"] or counts["K1"]:
            raise AssertionError(f"loop MU {m}x{n}: {counts}")

    return run, gate


def loop_study(card: str) -> None:
    """--loop: the U sweep.  At flatclust HALS, Reuters hierclust, sparse
    hierclust and three MU solves that converge (the main path's operand
    at k = 8, the flagship's at k = 16 and at k = 128, each a bf16
    EllAOp), eager at U = 1 and captured (one step a graph, replayed U
    times) at each U > 1 of LOOP_UNROLLS: wall, steps run, steps wasted,
    host reads, graph replays and the host's us a replay."""
    import torch

    from smallk_torch import Random
    from smallk_torch.ops.ell import EllAOp
    from smallk_torch.solvers import graph

    cells = loop_problems()
    A = random_sparse_matrix_main()
    cells[f"MU {M}x{N} k={K}"] = loop_mu_cell(
        EllAOp.from_scipy(A, "bfloat16", device="cuda"),
        *random_matrix_pair(Random(FACADE_SEED), M, N, K))
    FA, FW0, FH0 = flagship_problem()
    flag = EllAOp.from_scipy(FA, "bfloat16", device="cuda")
    del FA
    for k in (16, FLAG_K):
        cells[f"flagship MU k={k}"] = loop_mu_cell(flag, FW0[:, :k],
                                                   FH0[:k])
    cells["Reuters BPP to a tol"] = loop_bpp_cell(tol_at=LOOP_BPP_FIXED)
    best = {}
    for name, (run, gate) in cells.items():
        reps = 1 if name.startswith("sparse") else 2
        run()  # warm-up
        for unroll, capture in [(1, False)] + [(u, True)
                                               for u in LOOP_UNROLLS
                                               if u > 1]:
            walls = []
            for _ in range(reps):
                with patched(graph, "CAPTURE", capture):
                    reset_counts()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = run(unroll)
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                    c = read_counts()
                    capture_s, replay_s = graph_seconds()
                gate(c, out)
            log(f"[loop sweep] {name}, U={unroll}, "
                f"{'captured' if capture else 'eager'}: wall "
                f"{', '.join(f'{w:.4f}' for w in walls)} s, "
                f"{out['iterations']} iterations, {c['steps']} steps run, "
                f"{c['frozen']} wasted, {c['host_reads']} host reads, "
                f"{c['replays']} replays at "
                f"{1e6 * replay_s / max(c['replays'], 1):.2f} us, "
                f"capture + instantiate "
                f"{1e3 * capture_s / max(c['captures'], 1):.3f} ms a "
                f"solve on {card}")
            best.setdefault(name, []).append((min(walls), unroll))
    for name, rows in best.items():
        rows.sort()
        log(f"[loop sweep] {name}: fastest "
            + "; ".join(f"U={u} {w:.4f} s" for w, u in rows[:4]))
    del cells, flag
    torch.cuda.empty_cache()
    bpp_rank_sweep(card)


def bpp_study(card: str) -> None:
    """--bpp: phases 6 and 18, then the BPP sweep of --loop."""
    phase_main_path(card)
    phase_bpp_wide(card)
    bpp_rank_sweep(card)


def bpp_rank_sweep(card: str) -> None:
    """Reuters BPP (ITERS fixed iterations) at each k of LOOP_BPP_KS, eager
    at U = 1 and captured at BPP's auto U, in turns E, C, C, E: walls, each
    graph's nodes (its WHILE bodies' included), capture and instantiation
    ms, and the peak device memory of the run (what graph.bpp_captures's
    rule is set from); then the short solve (bpp_short_cell) the same
    way."""
    import torch

    from smallk_torch.common.options import NmfAlgorithm
    from smallk_torch.solvers import graph, solve

    unroll = solve.AUTO_UNROLL[NmfAlgorithm.BPP]

    def turns(label, run, gate):
        run(1)  # warm-up
        rows = {False: [], True: []}
        for capture in LOOP_ORDER:
            with patched(graph, "CAPTURE", capture):
                reset_counts()
                graph.last_nodes = None
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                out = run(unroll if capture else 1)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                c = read_counts()
                capture_s, _ = graph_seconds()
            gate(c, out)
            if c["captures"] != capture:
                raise AssertionError(f"{label}: {c['captures']} graphs")
            rows[capture].append((wall, 1e3 * capture_s,
                                  torch.cuda.max_memory_allocated() / 2**20,
                                  graph.last_nodes))
        log(f"[loop sweep] {label}, {out['iterations']} iterations, "
            f"{out['rounds']} pivot rounds: eager U=1 wall "
            + ", ".join(f"{w:.4f}" for w, _, _, _ in rows[False])
            + f" s; captured U={unroll} wall "
            + ", ".join(f"{w:.4f}" for w, _, _, _ in rows[True])
            + " s, capture + instantiate "
            + ", ".join(f"{t:.1f}" for _, t, _, _ in rows[True])
            + " ms, nodes "
            + ", ".join(str(n) for _, _, _, n in rows[True])
            + "; peak memory eager "
            + ", ".join(f"{p:.0f}" for _, _, p, _ in rows[False])
            + " MiB, captured "
            + ", ".join(f"{p:.0f}" for _, _, p, _ in rows[True])
            + f" MiB on {card}")

    for k in LOOP_BPP_KS:
        run, gate = loop_bpp_cell(k)
        turns(f"Reuters BPP k={k}", run, gate)
        del run, gate
        torch.cuda.empty_cache()
    turns("short BPP: k={2}, {3} iterations on the {0}x{1} "
          "EllAOp".format(*MESH_ELL), *bpp_short_cell())
    torch.cuda.empty_cache()


def bpp_short_cell():
    """BPP at k = 16, 10 fixed iterations (MESH_ELL) on phase 23b's sparse
    50,000 x 40,000 EllAOp (bf16 A, f32 factors from MESH_SEED): a short
    solve, in which a graph's capture weighs the most.  (run, gate) as
    loop_bpp_cell's; K1 gated exactly."""
    import torch

    from smallk_torch.ops.aop import as_aop
    from smallk_torch.solvers.solve import nmf_solve

    me, ne, ke, ie = MESH_ELL
    A, _, _ = sparse_corpus(ne)
    rng = np.random.RandomState(MESH_SEED)
    op = as_aop(A, "bfloat16", device="cuda")
    W = torch.from_numpy(rng.rand(me, ke).astype(np.float32)).cuda()
    H = torch.from_numpy(rng.rand(ke, ne).astype(np.float32)).cuda()
    opts = dataclasses.replace(mesh_nmf_opts("BPP", me, ne, "float32", ie),
                               k=ke, a_dtype="bfloat16")
    if type(op).__name__ != "EllAOp":
        raise AssertionError("the short BPP cell is not on EllAOp")

    def run(unroll=0):
        r = nmf_solve(op, W, H, dataclasses.replace(opts, loop_unroll=unroll))
        if not r.success or r.iterations != ie:
            raise AssertionError(f"short BPP stopped after {r.iterations}")
        return {"iterations": r.iterations, "rounds": r.pivot_rounds}

    def gate(counts, out):
        if not k1_gate(counts) or counts["steps"] < out["iterations"]:
            raise AssertionError(f"short BPP: {counts}")

    return run, gate


def trees_identical(a, sa, b, sb) -> str | None:
    """None when two hierclust results are one tree (tests/
    test_torch_hier_chain.py's _assert_identical), else what differs."""
    if not np.array_equal(a.assignments, b.assignments):
        return "assignments"
    if list(a.is_leaf) != list(b.is_leaf):
        return "leaves"
    for q, (x, y) in enumerate(zip(a.nodes, b.nodes)):
        if (x.priority, x.pop_priority, x.parent_index) != (
                y.priority, y.pop_priority, y.parent_index):
            return f"node {q}: priority or parent"
        for f in ("docs", "term_indices"):
            u, v = getattr(x, f), getattr(y, f)
            if (u is None) != (v is None) or (
                    u is not None and not np.array_equal(u, v)):
                return f"node {q}: {f}"
    if (sa.nmf_count, sa.iter_count, sa.max_count) != (
            sb.nmf_count, sb.iter_count, sb.max_count):
        return "solve counts"
    return None


@contextlib.contextmanager
def engine(mode: str):
    """The hierclust engine of `mode` (CHAIN_MODES): hier_chain.CHAIN and
    hierclust.KEEP_GRAPHS set for the block."""
    from smallk_torch.engines import hier_chain, hierclust

    with contextlib.ExitStack() as stack:
        for name, value in CHAIN_MODES[mode].items():
            mod = hier_chain if name == "CHAIN" else hierclust
            stack.enter_context(patched(mod, name, value))
        yield


def chain_mode(mode: str, fn, *args):
    """fn(*args) with the hierclust engine of `mode` (CHAIN_MODES)."""
    with engine(mode):
        return fn(*args)


def chain_runs(a_op, labels, opts, order, seed=2, warm=True) -> dict:
    """clust_hier on `a_op` with the engines of CHAIN_MODES in `order`,
    after a warm-up of each (with `warm`): per mode, each run's wall,
    counts, graph seconds, NMI, tree and the chain's telemetry; K3 gated
    exactly against the steps run."""
    import torch

    from smallk_torch import Random
    from smallk_torch.engines import hier_chain
    from smallk_torch.engines.hierclust import clust_hier
    from smallk_torch.engines.scoring import nmi

    for mode in dict.fromkeys(order) if warm else ():
        chain_mode(mode, clust_hier, a_op, opts, Random(1))
    runs = {mode: [] for mode in order}
    for mode in order:
        with engine(mode):
            chain = hier_chain.CHAIN
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tree, stats = clust_hier(a_op, opts, Random(seed))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
            seconds = graph_seconds()
        if a_op.A.dtype != torch.float64 and \
                (counts["K3"], counts["kernel_products"]) != k3_want(counts):
            raise AssertionError(f"{mode}: K3 {counts}, expected "
                                 f"{k3_want(counts)}")
        runs[mode].append({
            "wall": wall, "counts": counts, "capture_s": seconds[0],
            "tree": tree, "stats": stats,
            "nmi": None if labels is None else nmi(tree.assignments,
                                                   labels),
            "last": dict(hier_chain.LAST_STATS) if chain else None,
            "bails": dict(hier_chain.LAST_BAILS) if chain else None})
    return runs


def phase_chain(card: str, busy: dict) -> dict:
    """The multi-split chain (engines/hier_chain.py) against the sequential
    engine: the Reuters-shape hierclust (bf16 A, f32 factors) on each
    engine of CHAIN_MODES in the order CHAIN_ORDER, walls, graphs,
    replays and host reads a split, the busy shares from the loop's busy
    child, NMI, and the trees, which must all be the first run's; then the
    f64 dense CHAIN_F64 problem, where they must be one too."""
    import torch

    from smallk_torch.engines.corpus import synthetic_term_doc_corpus
    from smallk_torch.ops.aop import as_aop

    a_op, labels = hier_problem()
    opts = hier_opts(HIER_K, "float32", a_dtype="bfloat16")
    runs = chain_runs(a_op, labels, opts, CHAIN_ORDER)
    first = runs[CHAIN_ORDER[0]][0]
    out, splits = {}, HIER_K - 1
    for mode, rs in runs.items():
        diffs = [trees_identical(first["tree"], first["stats"], r["tree"],
                                 r["stats"]) for r in rs]
        c = rs[0]["counts"]
        name = ("hierclust Reuters" if mode == "chain"
                else f"hierclust Reuters, {mode}")
        b = busy.get(name, {}).get("captured")
        out[mode] = {"walls": [r["wall"] for r in rs], "counts": c,
                     "nmi": rs[0]["nmi"], "busy": b and b["busy"],
                     "capture_s": rs[0]["capture_s"],
                     "same": all(d is None for d in diffs)}
        walls = ", ".join(f"{r['wall']:.4f}" for r in rs)
        log(f"[chain] Reuters hierclust {HIER_M}x{HIER_N} bf16 A, "
            f"{HIER_K} clusters, {mode}: wall {walls} s; graphs "
            f"{c['captures']} (capture + instantiate "
            f"{1e3 * rs[0]['capture_s']:.1f} ms in all), replays "
            f"{c['replays']}, host reads {c['host_reads']} "
            f"({c['host_reads'] / splits:.1f} a split), solves "
            f"{c['solves']}, K3 launches {c['K3']}; device busy "
            + (f"{100 * b['busy']:.2f}%" if b else "not measured")
            + f"; NMI {rs[0]['nmi']:.4f}; tree "
            + ("identical to" if out[mode]["same"] else "DIFFERENT from")
            + f" the {CHAIN_ORDER[0]} engine's"
            + (f"; LAST_STATS {rs[0]['last']}, bails {rs[0]['bails']}"
               if rs[0]["last"] else "") + f" on {card}")
        if not out[mode]["same"]:
            raise AssertionError(f"Reuters {mode}: tree differs from the "
                                 f"{CHAIN_ORDER[0]} engine's: {diffs}")
    last = runs["chain"][0]["last"]
    if not last["committed"]:
        raise AssertionError(f"the chain committed no split: {last}")
    if abs(out["chain"]["nmi"] - HIER_NMI) > CHAIN_NMI_MARGIN:
        raise AssertionError(f"chain NMI {out['chain']['nmi']} is not "
                             f"{HIER_NMI} +- {CHAIN_NMI_MARGIN}")
    del a_op
    torch.cuda.empty_cache()

    m, n, k, seed = CHAIN_F64
    A, flabels = synthetic_term_doc_corpus(m, n, k, seed=seed)
    f64 = chain_runs(as_aop(A, dtype="float64", device="cuda"), flabels,
                     hier_opts(k, "float64"), tuple(CHAIN_MODES))
    ref = f64[CHAIN_ORDER[0]][0]
    for mode in CHAIN_MODES:
        r = f64[mode][0]
        diff = trees_identical(ref["tree"], ref["stats"], r["tree"],
                               r["stats"])
        log(f"[chain] f64 dense {m}x{n} to {k} clusters on the card, {mode}:"
            f" tree {'identical' if diff is None else 'DIFFERENT (' + diff + ')'}"
            f" to the {CHAIN_ORDER[0]} engine's, walls {CHAIN_ORDER[0]} "
            f"{ref['wall']:.4f} s, {mode} {r['wall']:.4f} s, graphs "
            f"{r['counts']['captures']}, LAST_STATS {r['last']}, NMI "
            f"{r['nmi']:.4f}")
        if diff is not None or (r["last"] and not r["last"]["committed"]):
            raise AssertionError(f"f64 {mode} tree differs ({diff}) or the "
                                 "chain committed nothing")
    torch.cuda.empty_cache()
    return out


def sparse_chain_runs(a_op, A, labels, opts, order, seed=2,
                      warm=True) -> dict:
    """clust_hier on the sparse `a_op` (its host matrix `A`) with the
    engines of `order`, after a warm-up of each (with `warm`): per mode,
    each run's wall, counts (gated by sparse_launch_gate), graph seconds,
    host ms in node operand builds, the root's steps, NMI, tree and the
    chain's telemetry."""
    import torch

    from smallk_torch import Random
    from smallk_torch.engines import hier_chain
    from smallk_torch.engines.hierclust import clust_hier
    from smallk_torch.engines.scoring import nmi
    from smallk_torch.ops import ell_cols

    build = [0.0]

    def timed(fn):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            build[0] += time.perf_counter() - t0
            return out
        return wrapped

    for mode in dict.fromkeys(order) if warm else ():
        chain_mode(mode, clust_hier, a_op, opts, Random(1), None, None, A)
    runs = {mode: [] for mode in order}
    for mode in order:
        with engine(mode), recorded_solves() as solves, \
                patched(ell_cols.ChunkColsAOp, "load",
                        timed(ell_cols.ChunkColsAOp.load)):
            chain = hier_chain.CHAIN
            build[0] = 0.0
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tree, stats = clust_hier(a_op, opts, Random(seed), host_A=A)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
            seconds = graph_seconds()
        sparse_launch_gate(f"sparse {mode}", counts, solves)
        runs[mode].append({
            "wall": wall, "counts": counts, "capture_s": seconds[0],
            "build_ms": 1e3 * build[0], "root_steps": solves[0][1],
            "tree": tree, "stats": stats,
            "nmi": None if labels is None else nmi(tree.assignments,
                                                   labels),
            "last": dict(hier_chain.LAST_STATS) if chain else None,
            "bails": dict(hier_chain.LAST_BAILS) if chain else None})
    return runs


def phase_sparse_chain(card: str, busy: dict, sparse=None) -> dict:
    """The sparse hierclust cell on each engine of CHAIN_MODES in the order
    CHAIN_ORDER (the corpus and operand of phase_sparse_hierclust when
    given): walls,
    graphs and capture ms, replays, host reads a split, node-build ms, the
    root's steps, NMI and the busy shares (the loop's busy child runs the
    sparse cell on each engine), the trees of S, G and C one and NMI at
    least SPARSE_CHAIN_NMI; then the f64 SPARSE_F64 problem on the card,
    where S, G and C must give one tree too."""
    import torch

    from smallk_torch.engines.corpus import synthetic_term_doc_corpus
    from smallk_torch.ops.aop import as_aop

    if sparse is None:
        A, labels, _ = sparse_corpus(SPH_N)
        a_op = as_aop(A, dtype="bfloat16", device="cuda")
    else:
        (A, labels), a_op = sparse["corpus"], sparse["op"]
    opts = hier_opts(HIER_K, "float32", a_dtype="bfloat16")
    runs = sparse_chain_runs(a_op, A, labels, opts, CHAIN_ORDER)
    first = runs[CHAIN_ORDER[0]][0]
    out, splits = {}, HIER_K - 1
    for mode, rs in runs.items():
        diffs = [trees_identical(first["tree"], first["stats"], r["tree"],
                                 r["stats"]) for r in rs]
        c = rs[0]["counts"]
        b = busy.get(f"sparse hierclust 50k x 1M, {mode}"
                     if mode != "chain" else "sparse hierclust 50k x 1M",
                     {}).get("captured")
        out[mode] = {"walls": [r["wall"] for r in rs], "counts": c,
                     "nmi": rs[0]["nmi"], "busy": b and b["busy"],
                     "capture_s": rs[0]["capture_s"],
                     "build_ms": [r["build_ms"] for r in rs],
                     "same": all(d is None for d in diffs)}
        walls = ", ".join(f"{r['wall']:.4f}" for r in rs)
        builds = ", ".join(f"{r['build_ms']:.1f}" for r in rs)
        log(f"[sparse chain] {SPH_M}x{SPH_N} bf16 A, {HIER_K} clusters, "
            f"{mode}: wall {walls} s;"
            f" graphs {c['captures']} (capture + instantiate "
            f"{1e3 * rs[0]['capture_s']:.1f} ms in all), replays "
            f"{c['replays']}, host reads {c['host_reads']} "
            f"({c['host_reads'] / splits:.1f} a split), solves {c['solves']},"
            f" steps {c['steps']}, root steps {rs[0]['root_steps']}, node "
            f"builds {builds} host ms, seg_spmm {c['seg_spmm']}, ell_spmm {c['ell_spmm']}; "
            f"device busy "
            + (f"{100 * b['busy']:.2f}%" if b else "not measured")
            + f"; NMI {rs[0]['nmi']:.4f}; tree "
            + ("identical to" if out[mode]["same"] else "DIFFERENT from")
            + f" the {CHAIN_ORDER[0]} engine's"
            + (f"; LAST_STATS {rs[0]['last']}, bails {rs[0]['bails']}"
               if rs[0]["last"] else "") + f" on {card}")
        if not out[mode]["same"] or rs[0]["nmi"] < SPARSE_CHAIN_NMI:
            raise AssertionError(f"sparse {mode}: tree differs from the "
                                 f"{CHAIN_ORDER[0]} engine's ({diffs}) or "
                                 f"NMI {rs[0]['nmi']} is below "
                                 f"{SPARSE_CHAIN_NMI}")
    last = runs["chain"][0]["last"]
    if not last["committed"]:
        raise AssertionError(f"the sparse chain committed no split: {last}")
    del runs
    torch.cuda.empty_cache()

    m, n, k, seed = SPARSE_F64
    A, flabels = synthetic_term_doc_corpus(m, n, k, seed=seed)
    op = as_aop(A, dtype="float64", device="cuda", densify_threshold_bytes=0)
    f64 = sparse_chain_runs(op, A, flabels, hier_opts(k, "float64"),
                            tuple(CHAIN_MODES), warm=False)
    ref = f64[CHAIN_ORDER[0]][0]
    for mode in CHAIN_MODES:
        r = f64[mode][0]
        diff = trees_identical(ref["tree"], ref["stats"], r["tree"],
                               r["stats"])
        log(f"[sparse chain] f64 sparse {m}x{n} to {k} clusters on the card,"
            f" {mode}: tree "
            f"{'identical' if diff is None else 'DIFFERENT (' + diff + ')'}"
            f" to the {CHAIN_ORDER[0]} engine's, walls {ref['wall']:.4f} / "
            f"{r['wall']:.4f} s, graphs {r['counts']['captures']}, seg_spmm "
            f"{r['counts']['seg_spmm']}, LAST_STATS {r['last']}, NMI "
            f"{r['nmi']:.4f}")
        if diff is not None or (r["last"] and not r["last"]["committed"]):
            raise AssertionError(f"f64 sparse {mode} tree differs ({diff}) "
                                 "or the chain committed nothing")
    torch.cuda.empty_cache()
    return out


def sparse_chain_study(card: str) -> None:
    """--sparse-chain: phase `sparse chain` alone, with the busy shares of
    its runs from `--loop-busy sparse` (the sparse cell on each engine)."""
    phase_sparse_chain(card, loop_busy(card, "sparse"))


def phase_fp8(card: str) -> dict:
    """e4m3 A-storage: each kernel's e4m3 load against its plain version
    and timed (K3's products at the hierclust root shape, K2 at the
    flatclust shape, ell_spmm at P2's shape with e4m3 values), and a path
    through each with its launches counted: Reuters hierclust (K3), HALS
    at the flatclust shape (K2) and BPP on the large-corpus demo's blocked
    EllAOp (ell_spmm), all with a_dtype float8_e4m3fn."""
    import torch

    from smallk_torch import (ClustStats, NmfAlgorithm, NmfOptions, Random,
                              random_matrix)
    from smallk_torch.engines.hierclust import clust_hier
    from smallk_torch.engines.scoring import nmi
    from smallk_torch.kernels import ell_spmm as kell
    from smallk_torch.kernels import hals_step as k2
    from smallk_torch.kernels import rank2_loop as k3
    from smallk_torch.ops.aop import as_aop
    from smallk_torch.ops.ell import EllAOp
    from smallk_torch.solvers.solve import nmf_solve

    f8 = "float8_e4m3fn"
    rows = {}
    # K3: one rank-2 iteration's products at the root shape
    m, w = HIER_M, HIER_N
    A, Wt, H = k3_inputs(m, w, f8)
    got = (k3.wt_a(A, Wt), k3.h_at(A, H))
    want = (k3.wt_a_plain(A, Wt), k3.h_at_plain(A, H))
    rel = max(float((g - p).abs().max() / p.abs().max())
              for g, p in zip(got, want))
    err = max(float((g - p).abs().max()) for g, p in zip(got, want))
    if not (rel <= K3_TOL["product"]
            and all(bool(torch.isfinite(g).all()) for g in got)):
        raise AssertionError(f"K3 e4m3 products: relative {rel}")
    one = bound(4.0 * m * w, A.numel() + 8 * (m + w))
    rows["K3"] = {
        "max_abs_err": err,
        "ms": device_ms(lambda: (k3.wt_a(A, Wt), k3.h_at(A, H)), 20),
        "plain_ms": device_ms(lambda: (k3.wt_a_plain(A, Wt),
                                       k3.h_at_plain(A, H)), 10),
        "library_ms": device_ms(lambda: (
            torch.matmul(Wt, A.float()), torch.matmul(H, A.float().T)), 10),
        "bound_ms": 2 * one[0], "bound_by": one[1]}
    k3_side_times(f"m={m} w={w} A {f8}", A, Wt, H)
    for k in k3.ROWS[1:]:
        _, Wt, H = lane_inputs(m, w, k // 2, f8)
        for side, g, p in (("wt_a", k3.wt_a(A, Wt), k3.wt_a_plain(A, Wt)),
                           ("h_at", k3.h_at(A, H), k3.h_at_plain(A, H))):
            rel = float((g - p).abs().max() / p.abs().max())
            if not (rel <= K3_TOL["product"]
                    and bool(torch.isfinite(g).all())):
                raise AssertionError(f"K3 e4m3 {side} k={k}: relative {rel}")
        k3_side_times(f"m={m} w={w} A {f8}", A, Wt, H)
    # K2: one HALS step at the flatclust shape
    args = k2_inputs(FLAT_M, FLAT_N, FLAT_K, torch.float8_e4m3fn)
    out = k2.hals_step(*args)
    plain64 = k2.hals_step_reference(*(t.double() for t in args))
    for name, a, b, tol in zip(K2_OUTPUTS, out[:6], plain64[:6], K2_TOL):
        torch.testing.assert_close(a, b.float(), **tol,
                                   msg=lambda s, name=name: f"{name}: {s}")
    mm, nn, kk = FLAT_M, FLAT_N, FLAT_K
    k2b = bound(4 * mm * nn * kk + 2 * kk * kk * (3 * mm + 3 * nn),
                mm * nn + 4 * 2 * (2 * mm * kk + 2 * kk * nn + kk * kk))
    rows["K2"] = {
        "max_abs_err": max(float((a.double() - b).abs().max())
                           for a, b in zip(out[:6], plain64[:6])),
        "ms": device_ms(lambda: k2.hals_step(*args), 200),
        "plain_ms": device_ms(lambda: k2.hals_step_reference(*args), 20),
        "library_ms": None, "bound_ms": k2b[0], "bound_by": k2b[1]}
    # ell_spmm: P2's shape, e4m3 values, an f32 table
    G, L, B, k, _, _ = ELL_PROBES["P2"]
    idx, vals, table = ell_inputs(G, L, B, k, f8, "float32", 0.0, seed=102)
    buf = torch.empty((G, k), dtype=torch.float32, device="cuda")
    got = kell.ell_spmm(idx, vals, table, buf).clone()
    want = kell.ell_spmm_reference(idx, vals, table, buf.clone())
    rel = float((got - want).abs().max() / want.abs().max())
    if not (rel <= ELL_TOL["float32"] and bool(torch.isfinite(got).all())):
        raise AssertionError(f"ell_spmm e4m3: relative {rel}")
    csr = torch.sparse_coo_tensor(
        torch.stack([torch.arange(G, device="cuda").repeat_interleave(L),
                     idx.reshape(-1).long()]),
        vals.reshape(-1).float(), (G, B)).coalesce().to_sparse_csr()
    eb = bound(2.0 * G * L * k, idx.numel() * 4 + vals.numel()
               + table.numel() * 4 + G * k * 4)
    rows["ell_spmm"] = {
        "max_abs_err": float((got - want).abs().max()),
        "ms": device_ms(lambda: kell.ell_spmm(idx, vals, table, buf), 50),
        "plain_ms": device_ms(lambda: kell.ell_spmm_reference(
            idx, vals, table, buf), 5),
        "library_ms": back_to_back_ms(lambda: torch.sparse.mm(csr, table),
                                      20),
        "bound_ms": eb[0], "bound_by": eb[1]}
    del A, Wt, H, idx, vals, table, csr

    # the paths, launches counted
    Ah, labels = hier_corpus()
    a_op = as_aop(Ah, dtype=f8, device="cuda")
    reset_counts()
    tree, stats = clust_hier(a_op, hier_opts(HIER_K, "float32", a_dtype=f8),
                             Random(2), ClustStats())
    counts = read_counts()
    score = nmi(tree.assignments, labels)
    if sum(tree.is_leaf) != HIER_K or \
            (counts["K3"], counts["kernel_products"]) != k3_want(counts) \
            or counts["matmul_products"]:
        raise AssertionError(f"e4m3 hierclust: {sum(tree.is_leaf)} leaves, "
                             f"{counts}")
    rows["K3"]["launches"] = counts["K3"]
    del a_op
    Af = torch.rand((FLAT_M, FLAT_N), generator=torch.Generator(
        device="cuda").manual_seed(3), device="cuda").to(torch.float8_e4m3fn)
    rng = Random(4)
    W0 = torch.tensor(random_matrix(FLAT_M, FLAT_K, rng), dtype=torch.float32,
                      device="cuda")
    H0 = torch.tensor(random_matrix(FLAT_K, FLAT_N, rng), dtype=torch.float32,
                      device="cuda")
    from smallk_torch.ops.aop import DenseAOp

    hopts = NmfOptions(tol=1e-4, algorithm=NmfAlgorithm.HALS, height=FLAT_M,
                       width=FLAT_N, k=FLAT_K, max_iter=500, verbose=False,
                       dtype="float32", a_dtype=f8)
    reset_counts()
    hres = nmf_solve(DenseAOp(Af), W0, H0, hopts)
    hcounts = read_counts()
    if not hres.success or hcounts["K2"] != hcounts["steps"]:
        raise AssertionError(f"e4m3 HALS: success {hres.success}, {hcounts}")
    rows["K2"]["launches"] = hcounts["K2"]
    import scipy.sparse as sp

    gs = np.random.RandomState(7)
    dm, dn, dk, nz = 3000, 4000, 16, 30
    S = sp.csc_matrix((gs.rand(dn * nz), gs.randint(0, dm, dn * nz),
                       np.arange(0, dn * nz + 1, nz)), shape=(dm, dn))
    S.sum_duplicates()
    op = EllAOp.from_scipy(S, f8, doc_block=1024, term_block=1024,
                           device="cuda")
    rng = Random(42)
    W0 = torch.tensor(random_matrix(dm, dk, rng), dtype=torch.float32,
                      device="cuda")
    H0 = torch.tensor(random_matrix(dk, dn, rng), dtype=torch.float32,
                      device="cuda")
    bopts = NmfOptions(tol=1e-9, algorithm=NmfAlgorithm.BPP, height=dm,
                       width=dn, k=dk, min_iter=1, max_iter=10,
                       verbose=False, dtype="float32", a_dtype=f8)
    reset_counts()
    bres = nmf_solve(op, W0, H0, bopts)
    bcounts = read_counts()
    if not bres.success or not bcounts["ell_spmm"] or \
            bcounts["ell_plain_cuda"] or not bcounts["K1"]:
        raise AssertionError(f"e4m3 BPP on the EllAOp: {bcounts}")
    rows["ell_spmm"]["launches"] = bcounts["ell_spmm"]
    log(f"[fp8] e4m3 A: Reuters hierclust {stats.nmf_count} factorizations,"
        f" NMI {score:.4f}, K3 launches {counts['K3']}; HALS "
        f"{FLAT_M}x{FLAT_N} k={FLAT_K} {hres.iterations} iterations, K2 "
        f"launches {hcounts['K2']}; BPP on the blocked {dm}x{dn} EllAOp, 10 "
        f"iterations, ell_spmm launches {bcounts['ell_spmm']}, K1 "
        f"{bcounts['K1']}; kernels against plain: " + "; ".join(
            f"{name} err {r['max_abs_err']:.3e}, ms {r['ms']:.4f}, plain "
            f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} ({r['bound_by']})"
            + (f", library {r['library_ms']:.4f}" if r["library_ms"]
               else "") for name, r in rows.items()) + f" on {card}")
    return rows


def phase_demo(card: str) -> dict:
    """examples/torch_drivers/large_corpus_demo.py on the card (blocked
    bf16 EllAOp, BPP through ell_spmm and K1, the checkpoint driver in
    segments of 10 and its resume), launches and solves counted; the resume
    must run no solve."""
    import runpy

    from smallk_torch.solvers import solve

    demo = runpy.run_path(str(ROOT / "examples" / "torch_drivers"
                              / "large_corpus_demo.py"), run_name="demo")
    reset_counts()
    calls = []
    real = solve.nmf_solve

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    t0 = time.perf_counter()
    with patched(solve, "nmf_solve", counted):
        W, H, total, success = demo["main"](device="cuda")
    wall = time.perf_counter() - t0
    counts = read_counts()
    log(f"[demo] large_corpus_demo on the card: {total} iterations, success "
        f"{success}, {len(calls)} segment solves (the resume none), "
        f"ell_spmm launches {counts['ell_spmm']}, K1 launches "
        f"{counts['K1']}, wall {wall:.2f} s on {card}")
    if not (success and total == 40 and len(calls) == 4
            and counts["ell_spmm"] and counts["K1"]
            and not counts["ell_plain_cuda"]):
        raise AssertionError(f"large_corpus_demo: {total} {success} "
                             f"{len(calls)} {counts}")
    return {"wall": wall}


def phase_two_traces(card: str) -> dict:
    """Two profiling.device_trace blocks in this process, after the
    profiles of the phases before: each trace holds the K3 kernels
    launched inside it, or device_trace warns that it lost some (its
    docstring's contract); a trace that loses kernels silently fails."""
    import warnings

    import torch

    from smallk_torch.common.profiling import device_trace
    from smallk_torch.kernels import rank2_loop as k3

    A, Wt, _ = k3_inputs(512, 256, "float32")
    k3.wt_a(A, Wt)
    found, warned = [], []
    with tempfile.TemporaryDirectory() as td:
        for block, calls in (("first", TRACE_CALLS), ("second", 7)):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always", RuntimeWarning)
                with device_trace(os.path.join(td, block)):
                    for _ in range(calls):
                        k3.wt_a(A, Wt)
            warned.append(any(issubclass(w.category, RuntimeWarning)
                              and "device_trace" in str(w.message)
                              for w in caught))
            with open(os.path.join(td, block, "trace.json")) as f:
                events = json.load(f)["traceEvents"]
            found.append(sum("wt_a_kernel" in e.get("name", "")
                             for e in events if e.get("cat") == "kernel"))
    torch.cuda.synchronize()
    log(f"[trace] two device_trace blocks in this process (after its "
        f"earlier profiles): wt_a kernels {found[0]} of {TRACE_CALLS}, "
        f"then {found[1]} of 7; warned {warned}, on {card}")
    for got, want, warn in zip(found, (TRACE_CALLS, 7), warned):
        if got != want and not warn:
            raise AssertionError(f"device_trace kept {found} of "
                                 f"[{TRACE_CALLS}, 7] kernels and warned "
                                 f"{warned}")
    return {"kernels": found, "warned": warned}


def ladder_study(card: str) -> None:
    """--ladder: the Reuters-shape hierclust under the chain at each bucket
    ladder of LADDERS, the settings run twice in turns; walls, graphs, the
    padded node columns and NMI."""
    from smallk_torch.engines import hierclust as hc

    a_op, labels = hier_problem()
    opts = hier_opts(HIER_K, "float32", a_dtype="bfloat16")
    walls, warm = {}, True
    for rnd in range(2):
        for ladder in (LADDERS if rnd == 0 else LADDERS[::-1]):
            with patched(hc, "BUCKET_MIN", ladder[0]), \
                    patched(hc, "BUCKET_POW2_MAX", ladder[1]), \
                    patched(hc, "BUCKET_STEP", ladder[2]):
                r = chain_runs(a_op, labels, opts, ("chain",),
                               warm=warm)["chain"][0]
                padded = sum(hc.bucket_width(len(q.docs), HIER_N)
                             or len(q.docs) for q in r["tree"].nodes
                             if q.is_valid)
            warm = False
            c = r["counts"]
            walls.setdefault(ladder, []).append(r["wall"])
            log(f"[ladder] {ladder}: wall {r['wall']:.4f} s, graphs "
                f"{c['captures']} ({1e3 * r['capture_s']:.1f} ms), solves "
                f"{c['solves']}, K3 {c['K3']}, steps {c['steps']}, host "
                f"reads {c['host_reads']}, padded node columns {padded}, "
                f"NMI {r['nmi']:.4f}, bails {r['bails']} on {card}")
    for ladder, ws in walls.items():
        log(f"[ladder] {ladder}: walls {', '.join(f'{w:.4f}' for w in ws)} s")


def slice_study(card: str) -> None:
    """--slice: the phases this slice added, alone: the e4m3 loads and
    paths, the large-corpus demo, the chain against the
    sequential engine (busy shares not measured here), two device_trace
    blocks after a profile of this process, and the facade walkthrough."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from smallk_torch.kernels import rank2_loop as k3

    phase_fp8(card)
    phase_demo(card)
    phase_chain(card, {})
    phase_sparse_chain(card, {})
    A, Wt, _ = k3_inputs(512, 256, "float32")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(50):
            k3.wt_a(A, Wt)
        torch.cuda.synchronize()
    phase_two_traces(card)
    phase_smallk_example()


def phase_smallk_example() -> None:
    """examples/torch_drivers/smallk_example.py --synthetic on the card, as
    a subprocess (the facade walkthrough: BPP k=32, RANK2 with
    initializers, HALS, HierNmf2WithFlat(5))."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_drivers"
                             / "smallk_example.py"), "--synthetic"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    if proc.returncode != 0 or "W factor: (1200, 32)" not in proc.stdout \
            or "HierNmf2" not in proc.stdout:
        raise AssertionError(f"smallk_example exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    log(f"[cli] examples/torch_drivers/smallk_example.py --synthetic on the "
        f"card: rc 0 in {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------- phase mesh
def tree_arrays(tree) -> dict:
    """A tree as arrays: structure, documents, priorities, assignments and
    the leaves' top terms."""
    nodes = tree.nodes
    terms = [np.asarray(nd.term_indices) for q, nd in enumerate(nodes)
             if tree.is_leaf[q] and nd.is_valid]
    return {
        "structure": np.array([[nd.is_valid, nd.parent_index,
                                nd.left_child_index, nd.right_child_index,
                                nd.is_left_child] for nd in nodes]),
        "is_leaf": np.asarray(tree.is_leaf, dtype=bool),
        "docs": np.concatenate([np.sort(np.asarray(
            nd.docs if nd.docs is not None else [], np.int64))
            for nd in nodes]),
        "priority": np.array([nd.priority for nd in nodes], np.float64),
        "assignments": np.asarray(tree.assignments),
        "leaf_terms": np.stack(terms)}


def tree_difference(a: dict, b: dict) -> str | None:
    """None when two tree_arrays are one tree (equal structure, documents,
    assignments and top terms, priorities within HIER_PRIORITY_TOL), else
    what differs."""
    for key in ("structure", "is_leaf", "docs", "assignments", "leaf_terms"):
        if a[key].shape != b[key].shape or not np.array_equal(a[key],
                                                              b[key]):
            return key
    if not np.allclose(a["priority"], b["priority"], rtol=HIER_PRIORITY_TOL,
                       atol=HIER_PRIORITY_TOL):
        return "priority"
    return None


def reset_mesh_counts() -> None:
    from smallk_torch.parallel import mesh as pm

    pm.all_reduces = pm.all_reduce_bytes = pm.gathers = 0


def mesh_counts() -> dict:
    from smallk_torch.parallel import mesh as pm

    return {"all_reduces": pm.all_reduces,
            "all_reduce_bytes": pm.all_reduce_bytes, "gathers": pm.gathers}


def mesh_turns(runs: dict, order) -> dict:
    """Each run of `runs` ({name: fn}) once as a warm-up, then in `order`,
    timed between two synchronizes with every count reset before it:
    {name: [(result, wall, counts), ...]}."""
    import torch

    for fn in runs.values():
        fn()
    out = {name: [] for name in runs}
    for name in order:
        reset_counts()
        reset_mesh_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = runs[name]()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[name].append((res, wall, {**read_counts(), **mesh_counts()}))
    return out


def mesh_f64_problem():
    """The f64 problems of legs (a) and (b), at CHAIN_F64's shape: the
    chain's corpus (the trees; dense on the card), and for the solvers a
    uniform dense matrix (HALS on the corpus can empty a column, whose
    rescue turns on differences in the last bit) with factor starts, all
    from seeded generators."""
    from smallk_torch.engines.corpus import synthetic_term_doc_corpus

    m, n, k, seed = CHAIN_F64
    A, labels = synthetic_term_doc_corpus(m, n, k, seed=seed)
    rng = np.random.RandomState(MESH_SEED)
    return (A, labels, rng.rand(m, n), rng.rand(m, MESH_K),
            rng.rand(MESH_K, n))


def mesh_nmf_opts(alg: str, m: int, n: int, dtype="float64", iters=None,
                  **kw):
    from smallk_torch import NmfAlgorithm, NmfOptions

    k = 2 if alg == "RANK2" else MESH_K
    return NmfOptions(tol=1e-30, algorithm=NmfAlgorithm(alg), height=m,
                      width=n, k=k, min_iter=1,
                      max_iter=iters or MESH_ITERS, verbose=False,
                      dtype=dtype, **kw)


def mesh_hier_opts():
    opts = hier_opts(MESH_HIER_K, "float64")
    return dataclasses.replace(opts, nmf_opts=dataclasses.replace(
        opts.nmf_opts, max_iter=MESH_HIER_MAX_ITER))


def mesh_one_rank(card: str, refs: str) -> dict:
    """Leg (a): a mesh of one rank over NCCL at full width.  Reuters BPP
    and the sparse EllAOp bit-equal to nmf_solve on the same operand with
    the same K1 (and ell_spmm) launches; HierNmf2WithFlat(12, mesh=) on
    the Reuters corpus with K3 exact; the f64 CHAIN_F64 tree equal to the
    unsharded one.  Writes the one-rank f64 results (leg (b)'s reference)
    to `refs`."""
    import torch

    import smallk_torch as smallk
    from smallk_torch import (Random, random_matrix, random_sparse_matrix)
    from smallk_torch.engines.hierclust import clust_hier
    from smallk_torch.engines.scoring import nmi
    from smallk_torch.ops.aop import as_aop
    from smallk_torch.parallel import mesh as pm
    from smallk_torch.solvers.solve import nmf_solve

    mesh = pm.make_mesh((1, 1), device="cuda")
    if mesh.backend != "nccl":
        raise AssertionError(f"a CUDA mesh runs {mesh.backend}, not nccl")
    out = {}

    def bit_equal_pair(label, op, sop, W, H, opts, kernels):
        runs = mesh_turns(
            {"unsharded": lambda: nmf_solve(op, W, H, opts),
             "sharded": lambda: pm.sharded_nmf_solve(sop, W, H, opts,
                                                     mesh)},
            ("unsharded", "sharded", "sharded", "unsharded"))
        (u, _, cu), (s, _, cs) = runs["unsharded"][0], runs["sharded"][0]
        same = (torch.equal(u.W, s.W) and torch.equal(u.H, s.H)
                and (u.iterations, u.pivot_rounds) == (s.iterations,
                                                       s.pivot_rounds))
        walls = {name: [r[1] for r in rs] for name, rs in runs.items()}
        its = {name: [u.iterations / w for w in ws]
               for name, ws in walls.items()}
        launches = {kern: (cu[kern], cs[kern]) for kern in kernels}
        log(f"[mesh] (a) {label}: unsharded "
            + ", ".join(f"{v:.2f}" for v in its["unsharded"]) + " it/s (walls "
            + ", ".join(f"{v:.4f}" for v in walls["unsharded"])
            + " s), sharded 1x1 " + ", ".join(f"{v:.2f}" for v in
                                             its["sharded"])
            + " it/s (walls " + ", ".join(f"{v:.4f}" for v in
                                          walls["sharded"])
            + f" s); W, H, iterations ({s.iterations}) and pivot rounds "
            f"({s.pivot_rounds}) bit-equal: {same}; launches unsharded / "
            f"sharded {launches}; all-reduces an iteration "
            f"{cs['all_reduces'] / s.iterations:.1f}, "
            f"{cs['all_reduce_bytes'] / s.iterations:.0f} bytes on {card}")
        if not same or any(a != b or b == 0 for a, b in launches.values()):
            raise AssertionError(f"(a) {label}: sharded 1x1 differs from "
                                 f"nmf_solve (bits {same}, {launches})")
        return {"its": its, "walls": walls, "launches": launches,
                "all_reduces": cs["all_reduces"] / s.iterations,
                "bytes": cs["all_reduce_bytes"] / s.iterations,
                "W": s.W.cpu().numpy()}

    # (a1) the main path: Reuters-shape BPP, bf16 A, 100 iterations
    rng = Random(2024)
    A = random_sparse_matrix(rng, M, N, nz_per_col=NZ_PER_COL,
                             dtype=np.float32)
    W = torch.from_numpy(random_matrix(M, K, rng, dtype=np.float32)).cuda()
    H = torch.from_numpy(random_matrix(K, N, rng, dtype=np.float32)).cuda()
    opts = mesh_nmf_opts("BPP", M, N, "float32", ITERS, a_dtype="bfloat16")
    opts = dataclasses.replace(opts, k=K)
    out["bpp"] = bit_equal_pair(
        f"Reuters BPP {M}x{N} k={K} bf16 A, {ITERS} iterations",
        as_aop(A, "bfloat16", device="cuda"),
        pm.shard_operand(A, mesh, "bfloat16"), W, H, opts, ("K1",))
    del A, W, H
    torch.cuda.empty_cache()
    out["collective_us"] = mesh_collective_us(mesh, card)

    # (a2) the facade's HierNmf2WithFlat(12) on the Reuters corpus, with
    # and without the mesh: every node on the masked view, K3 exact
    A, labels = hier_corpus()
    words = [f"term{i}" for i in range(HIER_M)]
    runs = {}
    with tempfile.TemporaryDirectory() as td:
        for name, arg in (("unsharded", None), ("sharded", mesh)):
            d = os.path.join(td, name)
            os.makedirs(d)
            smallk.Initialize()
            smallk.SetOutputDir(d)
            smallk.SeedRNG(FACADE_SEED)
            smallk.LoadMatrix(matrix=A)
            smallk.LoadDictionary(words)
            reset_counts()
            reset_mesh_counts()
            *_, wall = timed_call(smallk.HierNmf2WithFlat, HIER_K, mesh=arg)
            counts = {**read_counts(), **mesh_counts()}
            smallk.Finalize()
            files = files_of(d)
            assign = np.array(files[f"assignments_{HIER_K}.csv"].decode()
                              .split(","), dtype=np.int64)
            runs[name] = (wall, counts, files, nmi(assign, labels))
    (wu, cu, fu, nu), (ws, cs, fs, ns) = runs["unsharded"], runs["sharded"]
    same = [f for f in (f"assignments_{HIER_K}.csv", f"tree_{HIER_K}.json",
                        f"assignments_flat_{HIER_K}.csv")
            if fu.get(f) == fs.get(f)]
    log(f"[mesh] (a) HierNmf2WithFlat({HIER_K}, mesh=1x1) {HIER_M}x{HIER_N} "
        f"(f32 A): wall {ws:.4f} s (unsharded {wu:.4f} s, kept graphs), "
        f"{cs['solves']} solves, {cs['steps']} steps run (eager: no graph "
        f"under a mesh, {cs['captures']} captured), K3 launches {cs['K3']} "
        f"(2 x steps + solves = {k3_want(cs)[0]}), all-reduces "
        f"{cs['all_reduces']} ({cs['all_reduces'] / max(1, cs['steps']):.1f}"
        f" a step), gathers {cs['gathers']}; NMI {ns:.4f} (unsharded "
        f"{nu:.4f}; the Reuters cell's {HIER_NMI}); result files equal to "
        f"the unsharded run's: {same} on {card}")
    if (cs["K3"], cs["kernel_products"]) != k3_want(cs) or cs["captures"]:
        raise AssertionError(f"(a) sharded hierclust: K3 {cs}")
    if ns < nu - HIER_NMI_MARGIN:
        raise AssertionError(f"(a) sharded hierclust NMI {ns} against {nu}")
    out["hier"] = {"wall": ws, "unsharded_wall": wu, "nmi": ns,
                   "unsharded_nmi": nu, "same": same, "counts": cs}
    del A
    torch.cuda.empty_cache()

    # (a3) f64: the CHAIN_F64 corpus to MESH_HIER_K clusters, one rank
    # against unsharded; the four solvers' one-rank results for leg (b)
    A, labels, D, W0, H0 = mesh_f64_problem()
    m, n = A.shape
    opts = mesh_hier_opts()
    tu, _ = clust_hier(A, opts, Random(2), device="cuda")
    t0 = time.perf_counter()
    ts, _ = clust_hier(A, opts, Random(2), mesh=mesh)
    wall = time.perf_counter() - t0
    diff = tree_difference(tree_arrays(tu), tree_arrays(ts))
    log(f"[mesh] (a) f64 dense {m}x{n} to {MESH_HIER_K} clusters, mesh 1x1:"
        f" tree {'equal' if diff is None else 'DIFFERENT (' + diff + ')'} to"
        f" the unsharded one, wall {wall:.4f} s, NMI "
        f"{nmi(ts.assignments, labels):.4f}")
    if diff is not None:
        raise AssertionError(f"(a) f64 tree differs: {diff}")
    ref = {f"tree.{k}": v for k, v in tree_arrays(ts).items()}
    for alg in ("BPP", "MU", "HALS", "RANK2"):
        o = mesh_nmf_opts(alg, m, n)
        r = pm.sharded_nmf_solve(D, W0[:, :o.k], H0[:o.k], o, mesh)
        ref[f"{alg}.W"], ref[f"{alg}.H"] = r.W.cpu().numpy(), \
            r.H.cpu().numpy()
    np.savez(refs, **ref)

    # (a4) a sparse EllAOp at MESH_ELL: BPP bit-equal, ell_spmm launched
    me, ne, ke, ie = MESH_ELL
    A, _, _ = sparse_corpus(ne)
    rng = np.random.RandomState(MESH_SEED)
    op = as_aop(A, "bfloat16", device="cuda")
    sop = pm.shard_operand(A, mesh, "bfloat16")
    if type(op).__name__ != "EllAOp" or type(sop.local).__name__ != "EllAOp":
        raise AssertionError("(a) the sparse leg is not on EllAOp")
    o = dataclasses.replace(mesh_nmf_opts("BPP", me, ne, "float32", ie),
                            k=ke, a_dtype="bfloat16")
    out["ell"] = bit_equal_pair(
        f"sparse EllAOp {me}x{ne} ({A.nnz} nonzeros) BPP k={ke}, {ie} "
        "iterations", op, sop,
        torch.from_numpy(rng.rand(me, ke).astype(np.float32)).cuda(),
        torch.from_numpy(rng.rand(ke, ne).astype(np.float32)).cuda(), o,
        ("K1", "ell_spmm"))
    mesh.close()
    return out


def mesh_collective_us(mesh, card: str) -> dict:
    """What one collective costs: MESH_CALLS calls back to back on a 0-d
    f32 tensor, host microseconds a call between two synchronizes, through
    Mesh.all_reduce and through torch.distributed.all_reduce itself, on
    the terms axis's group, beside a clone (the wrapper's copy)."""
    import torch
    import torch.distributed as dist

    x = torch.ones((), device=mesh.device)
    group = mesh.group("terms")

    def per_call(fn):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MESH_CALLS):
            fn()
        torch.cuda.synchronize()
        return 1e6 * (time.perf_counter() - t0) / MESH_CALLS

    out = {"mesh": per_call(lambda: mesh.all_reduce(x, "terms", "sum")),
           "dist": per_call(lambda: dist.all_reduce(x, group=group)),
           "clone": per_call(x.clone)}
    log(f"[mesh] (a) one collective over {mesh.backend} on a group of one "
        f"rank, a 0-d f32 tensor, {MESH_CALLS} calls back to back: "
        f"Mesh.all_reduce {out['mesh']:.1f} us a call, "
        f"torch.distributed.all_reduce {out['dist']:.1f} us, a clone "
        f"{out['clone']:.1f} us (host, between two synchronizes) on {card}")
    return out


def mesh_rank(rank: int, world: int, port: int, shapes, device: str,
              backend: str, refs: str, outdir: str) -> None:
    """A rank of leg (b) (one card shared, gloo) or (c) (a card a rank,
    NCCL): for each mesh of `shapes` over the world, the cases of
    mesh_cases; its results to outdir/rank<rank>.npz."""
    import torch

    from smallk_torch.parallel import distributed
    from smallk_torch.parallel import mesh as pm

    dev = f"cuda:{rank}" if device == "cuda" else device
    distributed.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                       backend=backend, device=dev)
    results = {}
    for shape in shapes:
        mesh = pm.make_mesh(shape, device=dev, backend=backend)
        tag = f"{shape[0]}x{shape[1]}"
        cases = mesh_cases if refs else mesh_card_cases
        for key, value in cases(mesh, refs).items():
            results[f"{tag}/{key}"] = value
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **results)
    torch.distributed.destroy_process_group()


def _solve_counted(fn):
    """fn()'s result, wall, counts and mesh counts, counted from 0."""
    import torch

    reset_counts()
    reset_mesh_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0, {**read_counts(), **mesh_counts()}


def mesh_cases(mesh, refs: str) -> dict:
    """Leg (b) on one mesh: the four solvers in f64 against the one-rank
    results (relative max error), the MESH_HIER_K-cluster f64 tree against
    the one-rank tree, and in f32 a RANK2 solve (K3) and BPP on an EllAOp
    block (ell_spmm), every count on this rank."""
    from smallk_torch import Random
    from smallk_torch.engines.hierclust import clust_hier
    from smallk_torch.parallel import mesh as pm

    A, _, D, W0, H0 = mesh_f64_problem()
    m, n = A.shape
    out = {}
    with np.load(refs) as z:
        ref = {k: z[k] for k in z.files}
    for alg in ("BPP", "MU", "HALS", "RANK2"):
        o = mesh_nmf_opts(alg, m, n)
        r, wall, c = _solve_counted(lambda: pm.sharded_nmf_solve(
            D, W0[:, :o.k], H0[:o.k], o, mesh))
        for f in ("W", "H"):
            got, want = getattr(r, f).cpu().numpy(), ref[f"{alg}.{f}"]
            out[f"{alg}.{f}_ok"] = np.allclose(got, want, **MESH_TOL)
            out[f"{alg}.{f}_err"] = np.abs(got - want).max() / np.abs(
                want).max()
        out[f"{alg}.wall"] = wall
        out[f"{alg}.K1"] = c["K1"]
        out[f"{alg}.all_reduces"] = c["all_reduces"] / r.iterations
    (tree, _), wall, c = _solve_counted(
        lambda: clust_hier(A, mesh_hier_opts(), Random(2), mesh=mesh))
    diff = tree_difference(tree_arrays(tree), {
        k[5:]: v for k, v in ref.items() if k.startswith("tree.")})
    out["tree"] = "equal" if diff is None else f"DIFFERENT ({diff})"
    out["tree.wall"] = wall
    r, _, c = _solve_counted(lambda: pm.sharded_nmf_solve(
        D, W0[:, :2], H0[:2], mesh_nmf_opts("RANK2", m, n, "float32"), mesh))
    out["K3"], out["K3_want"] = c["K3"], k3_want(c)[0]
    out["rank2_f32_finite"] = bool(np.isfinite(r.W.cpu().numpy()).all())
    ell = pm.shard_operand(A, mesh, "float32", densify_threshold_bytes=0)
    r, _, c = _solve_counted(lambda: pm.sharded_nmf_solve(
        ell, W0, H0, mesh_nmf_opts("BPP", m, n, "float32", 5), mesh))
    out["ell_kind"] = type(ell.local).__name__
    out["ell.K1"], out["ell.ell_spmm"] = c["K1"], c["ell_spmm"]
    out["ell_finite"] = bool(np.isfinite(r.W.cpu().numpy()).all())
    return out


def mesh_card_cases(mesh, refs) -> dict:
    """Leg (c) on one mesh, a card a rank: Reuters BPP (100 iterations)
    timed after a warm-up, and its launches on this rank."""
    import torch

    from smallk_torch import Random, random_matrix, random_sparse_matrix
    from smallk_torch.parallel import mesh as pm

    rng = Random(2024)
    A = random_sparse_matrix(rng, M, N, nz_per_col=NZ_PER_COL,
                             dtype=np.float32)
    W0 = random_matrix(M, K, rng, dtype=np.float32)
    H0 = random_matrix(K, N, rng, dtype=np.float32)
    opts = dataclasses.replace(
        mesh_nmf_opts("BPP", M, N, "float32", ITERS, a_dtype="bfloat16"),
        k=K)
    op = pm.shard_operand(A, mesh, "bfloat16")
    pm.sharded_nmf_solve(op, W0, H0, opts, mesh)
    r, wall, c = _solve_counted(
        lambda: pm.sharded_nmf_solve(op, W0, H0, opts, mesh))
    mesh.barrier()
    return {"wall": wall, "its": r.iterations / wall, "K1": c["K1"],
            "all_reduces": c["all_reduces"] / r.iterations,
            "W": r.W.cpu().numpy(), "device": str(torch.cuda.current_device())}


def spawn_mesh(world: int, shapes, device: str, backend: str, refs: str,
               outdir: str) -> list[dict]:
    """mesh_rank on a world of `world` ranks; each rank's results."""
    from smallk_torch.parallel.distributed import _free_port, spawn_ranks

    spawn_ranks(mesh_rank, (world, _free_port(), shapes, device, backend,
                            refs, outdir), world, MESH_TIMEOUT)
    out = []
    for rank in range(world):
        with np.load(os.path.join(outdir, f"rank{rank}.npz")) as z:
            out.append({k: z[k] for k in z.files})
    return out


def mesh_shared_card(card: str, refs: str, td: str) -> dict:
    """Leg (b): MESH_SHAPES over gloo, every rank on cuda:0: (1, 2) and
    (2, 1) as two meshes of one world of two, (2, 2) a world of four."""
    out = {}
    for world, shapes in ((2, ((1, 2), (2, 1))), (4, ((2, 2),))):
        d = os.path.join(td, f"b{world}")
        os.makedirs(d)
        ranks = spawn_mesh(world, shapes, "cuda:0", "gloo", refs, d)
        for shape in shapes:
            tag = f"{shape[0]}x{shape[1]}"
            for rank, r in enumerate(ranks):
                g = {k[len(tag) + 1:]: r[k] for k in r if k.startswith(tag)}
                errs = {alg: max(float(g[f"{alg}.W_err"]),
                                 float(g[f"{alg}.H_err"]))
                        for alg in ("BPP", "MU", "HALS", "RANK2")}
                ok = all(bool(g[f"{alg}.{f}_ok"]) for alg in errs
                         for f in "WH")
                log(f"[mesh] (b) mesh {tag} rank {rank} (gloo, cuda:0 "
                    f"shared): f64 {CHAIN_F64[0]}x{CHAIN_F64[1]} within "
                    f"{MESH_TOL} of the one-rank run: {ok} (max rel err "
                    + ", ".join(f"{a} {e:.3e}" for a, e in errs.items())
                    + "); walls " + ", ".join(
                        f"{a} {float(g[f'{a}.wall']):.3f}" for a in errs)
                    + f" s ({MESH_ITERS} iterations); BPP all-reduces an "
                    f"iteration {float(g['BPP.all_reduces']):.1f}; tree to "
                    f"{MESH_HIER_K} clusters {g['tree']} "
                    f"({float(g['tree.wall']):.2f} s); launches K1 "
                    f"{int(g['BPP.K1'])} (f64 BPP), K3 {int(g['K3'])} (f32 "
                    f"RANK2; 2 x steps + solves = {int(g['K3_want'])}), "
                    f"ell_spmm {int(g['ell.ell_spmm'])} and K1 "
                    f"{int(g['ell.K1'])} (f32 BPP on its {g['ell_kind']} "
                    f"block) on {card}")
                if not ok or str(g["tree"]) != "equal" \
                        or int(g["K3"]) != int(g["K3_want"]) \
                        or not int(g["K3"]) or not int(g["BPP.K1"]) \
                        or not int(g["ell.ell_spmm"]) \
                        or not bool(g["rank2_f32_finite"]) \
                        or not bool(g["ell_finite"]):
                    raise AssertionError(f"(b) mesh {tag} rank {rank}: "
                                         f"{g}")
                out[(tag, rank)] = g
    return out


def mesh_multi_card(card: str, one: dict, td: str) -> None:
    """Leg (c): NCCL, a card a rank, where the machine has two cards or
    more: (1, 2), and with four (2, 2), at the Reuters shape against leg
    (a)'s one-rank run."""
    import torch

    cards = torch.cuda.device_count()
    if cards < 2:
        log(f"[mesh] (c) not run: this machine has {cards} card(s), and "
            "NCCL across cards needs two or more")
        return
    for world, shape in ((2, (1, 2)), (4, (2, 2))):
        if world > cards:
            break
        d = os.path.join(td, f"c{world}")
        os.makedirs(d)
        ranks = spawn_mesh(world, (shape,), "cuda", "nccl", "", d)
        tag = f"{shape[0]}x{shape[1]}"
        W1 = one["bpp"]["W"]
        for rank, r in enumerate(ranks):
            err = float(np.abs(r[f"{tag}/W"] - W1).max() / np.abs(W1).max())
            log(f"[mesh] (c) mesh {tag} rank {rank} (nccl, a card a rank): "
                f"Reuters BPP {float(r[f'{tag}/its']):.2f} it/s (wall "
                f"{float(r[f'{tag}/wall']):.4f} s; one rank "
                f"{one['bpp']['its']['sharded'][0]:.2f} it/s), K1 "
                f"{int(r[f'{tag}/K1'])}, all-reduces an iteration "
                f"{float(r[f'{tag}/all_reduces']):.1f}, W against one "
                f"rank's max rel diff {err:.3e} on {card}")


def mesh_child() -> int:
    """--mesh-child: phase `mesh` in a process of its own, so that no
    process group outlives it in the main run."""
    from smallk_torch.common.device import setup

    setup("cuda")
    card = card_line()
    with tempfile.TemporaryDirectory() as td:
        refs = os.path.join(td, "refs.npz")
        one = mesh_one_rank(card, refs)
        mesh_shared_card(card, refs, td)
        mesh_multi_card(card, one, td)
    return 0


def phase_mesh(card: str) -> None:
    """Phase `mesh` (the sharded solve): `--mesh-child` as a process of
    its own, whose lines are printed here."""
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           "--mesh-child"], capture_output=True, text=True,
                          timeout=2 * MESH_TIMEOUT + 300, cwd=ROOT)
    for line in proc.stdout.splitlines():
        log(line)
    if proc.returncode != 0:
        log(proc.stderr[-6000:])
        raise AssertionError(f"--mesh-child exited {proc.returncode}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--times"] and len(sys.argv) == 3:
        return times_child(sys.argv[2])
    if sys.argv[1:] == ["--trace"]:
        return trace_child()
    sys.path.insert(0, str(ROOT))
    if sys.argv[1:] == ["--mesh-child"]:
        return mesh_child()
    if sys.argv[1:2] == ["--loop-busy"] and sys.argv[2:] in ([], ["sparse"],
                                                             ["lean"]):
        return loop_busy_child(*sys.argv[2:])
    from smallk_torch.common.device import setup
    from smallk_torch.kernels import (ell_spmm, hals_step, masked_gj,
                                      rank2_loop, seg_spmm)

    setup("cuda")
    card = card_line()
    log(f"[device] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    log(while_node_line())
    secs = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        secs[name] = time.perf_counter() - t0
        return out

    timed("build", phase_build)
    if sys.argv[1:] == ["--profile"]:
        profile_hierclust()
        return 0
    studies = {"--k1": k1_study, "--sparse": sparse_study,
               "--ell": ell_study, "--k2": k2_study, "--cols": cols_study,
               "--cg": cg_study, "--facade": facade_study,
               "--loop": loop_study, "--ladder": ladder_study,
               "--slice": slice_study, "--sparse-chain": sparse_chain_study,
               "--mesh": phase_mesh, "--graph": graph_study,
               "--k3": k3_study, "--bpp": bpp_study}
    if len(sys.argv) == 2 and sys.argv[1] in studies:
        timed(f"{sys.argv[1][2:]} study", studies[sys.argv[1]], card)
        log("[time] " + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
        return 0
    if sys.argv[1:2] == ["--pair"] and len(sys.argv) == 3:
        timed("pair", pair, sys.argv[2], card)
        log("[time] " + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
        return 0
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}", file=sys.stderr)
        return 2
    k1 = timed("K1", phase_kernel)
    k2 = timed("K2", phase_k2)
    k3 = timed("K3", phase_k3)
    ell = timed("ell_spmm", phase_ell_spmm)
    seg = timed("seg_spmm", phase_seg_spmm)
    timed("slice", phase_slice_parity)
    timed("nnls parity", phase_nnls_parity)
    timed("sparse parity", phase_sparse_parity)
    main_path = timed("main", phase_main_path, card)
    flat_path = timed("flatclust", phase_flatclust, card)
    timed("beside", phase_beside, card)
    timed("hier parity", phase_hier_parity)
    hier_path = timed("hierclust", phase_hierclust, card)
    flagship = timed("flagship", phase_flagship, card)
    timed("sparse vs dense", phase_sparse_dense, card)
    sparse_hier = timed("sparse hierclust", phase_sparse_hierclust, card)
    timed("facade", phase_facade, card, sparse_hier, flagship["mu_factors"])
    timed("loop", phase_loop, card, flagship, sparse_hier)
    del flagship["op"], flagship["mu_factors"]
    torch.cuda.empty_cache()
    busy = timed("loop busy", loop_busy, card, "lean")
    timed("chain", phase_chain, card, busy)
    timed("sparse chain", phase_sparse_chain, card, busy, sparse_hier)
    del sparse_hier["corpus"], sparse_hier["op"]
    torch.cuda.empty_cache()
    fp8 = timed("fp8", phase_fp8, card)
    timed("demo", phase_demo, card)
    timed("two traces", phase_two_traces, card)
    timed("bpp wide", phase_bpp_wide, card)
    graph = timed("graph", phase_graph, card)
    # the CLI processes side by side, and beside them phase mesh's child
    # (its walls are taken beside the CLIs here; `--mesh` runs it alone)
    with ThreadPoolExecutor(7) as pool:
        t0 = time.perf_counter()
        for job in [pool.submit(phase_mesh, card), pool.submit(phase_cli),
                    pool.submit(phase_flat_cli), pool.submit(phase_hier_cli),
                    pool.submit(phase_sparse_cli),
                    pool.submit(phase_cli_chain),
                    pool.submit(phase_smallk_example)]:
            job.result()
        secs["cli and mesh"] = time.perf_counter() - t0
    log("[time] " + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))

    ms, plain_ms, library_ms, bound_ms, bound_by = k1["times"][
        MAIN_SHAPES[-1]]
    print(json.dumps({"kernels": [{
        "name": "masked_gj_solve",
        "route": "cuda",
        "source": masked_gj.SOURCE,
        "replaces": masked_gj.REPLACES,
        "launches": main_path["launches"],
        "max_abs_err": k1["max_abs_err"],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }, {
        # the wide device kernel at the flagship's W-side round
        "name": f"masked_gj_solve (wide, k={FLAG_K} n={FLAG_M})",
        "route": "cuda",
        "source": masked_gj.SOURCE,
        "replaces": masked_gj.REPLACES,
        "launches": flagship["k1_launches"],
        "max_abs_err": max(k1["max_abs_err"],
                           *(r["err"] for r in flagship["k1_rounds"].values())),
        "ms": flagship["k1_rounds"]["W"]["ms"],
        "plain_ms": flagship["k1_rounds"]["W"]["plain_ms"],
        "bound_ms": flagship["k1_rounds"]["W"]["bound_ms"],
        "bound_by": flagship["k1_rounds"]["W"]["bound_by"],
        "library_ms": flagship["k1_rounds"]["W"]["library_ms"],
    }, {
        "name": "hals_step",
        "route": "cuda",
        "source": hals_step.SOURCE,
        "replaces": hals_step.REPLACES,
        "launches": flat_path["launches"],
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "library_ms": None,
    }, {
        "name": "rank2_loop",
        "route": "cuda",
        "source": rank2_loop.SOURCE,
        "replaces": rank2_loop.REPLACES,
        "launches": hier_path["launches"],
        "max_abs_err": k3["max_abs_err"],
        "ms": k3["ms"],
        "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"],
        "library_ms": k3["library_ms"],
    }] + [{
        # K3 on the graph path: one step's two products, W'A and AH', of R
        # lanes (2R rows; the graph preset's best-of-3) at the community
        # root, and of one start at the north-star root (e4m3 A)
        "name": f"rank2_loop ({label}, m=w={m}, A {dt}, wt_a + h_at)",
        "route": "cuda",
        "source": rank2_loop.SOURCE,
        "replaces": rank2_loop.REPLACES,
        "launches": graph[cell]["launches"],
        "max_abs_err": graph["k3"]["max_abs_err"],
        **{key: graph["k3"]["rows"][(m, m, dt, lanes)][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    } for label, cell, m, dt, lanes in (
        ("graph lanes R=3, community cell", "community", GRAPH_COMM[0],
         "float32", 3),
        ("graph R=1, north-star cell", "star", GRAPH_STAR[0],
         "float8_e4m3fn", 1))] + [{
        # each kernel's e4m3 load of A
        "name": f"{name} (e4m3 A, {shape})",
        "route": "cuda",
        "source": mod.SOURCE,
        "replaces": (mod.REPLACES["P2"] if isinstance(mod.REPLACES, dict)
                     else mod.REPLACES),
        **{key: fp8[row][key] for key in (
            "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")},
    } for name, mod, row, shape in (
        ("rank2_loop", rank2_loop, "K3", f"root products m={HIER_M} "
         f"w={HIER_N}"),
        ("hals_step", hals_step, "K2", f"m={FLAT_M} n={FLAT_N} k={FLAT_K}"),
        ("ell_spmm", ell_spmm, "ell_spmm", "P2 shape, f32 table"))] + [{
        "name": f"ell_spmm ({probe})",
        "route": "cuda",
        "source": ell_spmm.SOURCE,
        "replaces": ell_spmm.REPLACES[probe],
        "launches": flagship["launches"],
        "max_abs_err": max(ell["max_abs_err"], flagship["max_abs_err"]),
        **ell["probes"][probe],
    } for probe in ELL_PROBES] + [{
        # the flagship's W'A: its one bucket, written transposed
        "name": f"ell_spmm (flagship W'A, g={FLAG_N} L=80 k={FLAG_K}, "
                "transposed)",
        "route": "cuda",
        "source": ell_spmm.SOURCE,
        "replaces": ell_spmm.REPLACES["P2"],
        "launches": flagship["wta_launches"],
        "max_abs_err": flagship["wta"]["max_abs_err"],
        **{key: flagship["wta"][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    }] + [{
        # the sparse hierclust products at k = 2 on the static operand
        # (seg_spmm) at the root and at a 1/SPH_NODE node; launches: every
        # product of the run's static operands (device ms; library:
        # index_add_)
        "name": f"seg_spmm (sparse hierclust {where} {side}, k=2, static "
                f"operand, m={SPH_M})",
        "route": "cuda",
        "source": seg_spmm.SOURCE,
        "replaces": seg_spmm.REPLACES,
        "launches": sparse_hier["launches"],
        "max_abs_err": max(seg["max_abs_err"], sparse_hier[key][side]["err"]),
        "ms": sparse_hier[key][side]["device_ms"],
        "plain_ms": sparse_hier[key][side]["plain_ms"],
        "bound_ms": sparse_hier[key][side]["bound_ms"],
        "bound_by": sparse_hier[key][side]["bound_by"],
        "library_ms": sparse_hier[key][side]["library_ms"],
    } for where, key in (("root", "root_static"),
                         (f"1/{SPH_NODE} node", "node"))
        for side in ("tn", "nt")]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
