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
     nnz per column, k = 8, bf16 A, f32 factors, 100 fixed iterations,
     with K1's launches counted over that run;
  7. the flatclust HALS path at full width: the reference's flatclust
     configuration (dense 256 x 256 UNIFORM, k = 16, tol 1e-4) through
     run_flatclust, with K2's launches counted over that run; HALS it/s
     over 2000 fixed iterations; f32 on the card against f32 on the CPU;
  8. MU and RANK2 on a dense 800 x 600 operand and flatclust BPP at
     256 x 256, k = 16 beside it;
  9. K3, the rank-2 products and loop, against its plain version at the
     shapes of P3 (scripts/tpu_batch60.py) and small ragged shapes, and its
     two products alone at the hierclust root shape (12411 x 7984 bf16);
     kernel, plain and library times;
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
     1,000,000 corpus (bf16 A, f32 factors, 12 clusters) through the root's
     EllAOp and the nodes' operands gathered on the card, a warm-up run
     and the timed run with ell_spmm's launches counted; the root's and a 1/8 node's products timed against
     their plain version, the torch-ops formulation and torch.sparse.mm;
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
 18. BPP at k = 160 (the masked CG tier's) on the main path's operand, the
     CG solves and steps counted, and f64 on a slice against the CPU;
 19. the nmf, flatclust and hierclust CLIs as subprocesses, the nmf and
     hierclust CLIs on a 30000 x 20000 .mtx above the densify threshold
     (EllAOp), and the five CLIs chained: matrixgen -> preprocess_tf ->
     nmf and hierclust on the card;
 20. the solve loop (loop): flatclust HALS, Reuters hierclust, sparse
     hierclust at 50,000 x 1,000,000 (phase 16's operand) and flagship MU
     at 25 iterations (phase 14's operand, through nmf_solve), each run
     with solvers/graph.CAPTURE off and on, in turns (on, the loop
     replays its steps as a CUDA graph at U > 1; flagship MU's auto U is
     1, eager in both, solve.MU_ONE_STEP_ENTRIES): equal
     bits and counts, launch gates exact against the steps run, the walls,
     host reads, graphs, capture and replay times and steps wasted to the
     freeze; f64 captured-against-eager runs of HALS, RANK2 and MU; then
     (--loop-busy, a process of its own) each run once more inside one
     profiler session for the device's busy share and the host's launch
     calls;
 21. the kernel table as one JSON line, the card line, and last the result
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
1,000,000 corpus, the root's EllAOp, the gathered operand (long slices cut
and uncut), the torch-ops formulation and torch.sparse.mm at the root and
at a 1/8 node, then the gathered operand against the masked view of the
root at shares 1/8 to 7/8 of the documents.

    python3 chip_smoke.py --cg

runs only the GJ/CG crossover: one full-width pivot round through K1 and
through the CG tier (cold and warm-started), k = 32..128, n = 12,411,
50,000 and 1,000,000.

    python3 chip_smoke.py --facade

runs only phases 16, 17 and the CLI chain of 19, with the flagship's MU
factors made on their own.

    python3 chip_smoke.py --loop

runs only the U sweep of the solve loop: flatclust HALS, Reuters
hierclust, sparse hierclust and three MU solves that converge (the main
path's operand at k = 8, the flagship's at k = 16 and 128), eager at
U = 1 and with one step replayed U times at U = 2, 4, 8, 16, 32 (what
solvers/solve.AUTO_UNROLL and MU_ONE_STEP_ENTRIES are set from).

    python3 chip_smoke.py --pair DIR

times K2, P1, P2, the flatclust HALS path, the Reuters BPP path, the
flagship (products, MU, BPP) and sparse hierclust at 50,000 x 1,000,000 (the k = 2 products at
the root's EllAOp and at a 1/8 node, and the clustering's wall) with the
package of an archived tree at DIR and of this one, in the order DIR,
this, this, DIR, each in a process of its own (`--times TREE`), and
fails unless the flagship's products are bit-equal and every sparse
hierclust run has 12 leaves.

There is no CPU fallback: without a card the script exits 1.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
HIER_M, HIER_N, HIER_TOPICS, HIER_K = 12411, 7984, 16, 12  # bench.py:60-79
HIER_NMI_MARGIN = 0.05   # f32 card run's NMI may trail the CPU run's by this
HIER_PRIORITY_TOL = 1e-10

# ell_spmm against its plain version: max |kernel - plain| / max |plain|.
# f32 sums of up to 128 terms in other orders; f64 the same sums.
ELL_TOL = {"float32": 2e-5, "float64": 1e-12}
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
# --cols: shares of the documents at which the gathered operand is set
# against the masked view of the root
CUT_SHARES = (1 / 8, 1 / 4, 1 / 2, 3 / 4, 7 / 8)
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
# the --loop sweep's MU cells converge after these many iterations
LOOP_MU_FIXED = 91
SPH_NMI = 0.912

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
    captured and replayed) to 0, just before a path is driven."""
    from smallk_torch.kernels import ell_spmm, hals_step, masked_gj, rank2_loop
    from smallk_torch.ops import aop
    from smallk_torch.solvers import graph, solve

    masked_gj.launches = 0
    masked_gj.columns = 0
    hals_step.launches = 0
    rank2_loop.launches = 0
    ell_spmm.launches = 0
    ell_spmm.transposed_launches = 0
    ell_spmm.plain_cuda_calls = 0
    aop.kernel_products = 0
    aop.matmul_products = 0
    solve.steps_run = solve.host_reads = solve.frozen_steps = 0
    solve.solves = 0
    graph.captures = graph.replays = 0
    graph.capture_seconds = graph.replay_seconds = 0.0


def read_counts() -> dict:
    """Launches of K1, K2, K3 and ell_spmm (and ell_spmm's transposed
    ones), the columns K1 solved, ell_spmm's plain-version calls on CUDA
    tensors, the dense products that went to K3 and to torch.matmul, and
    the solve loop's counts, since the last reset_counts().  Launches
    replayed from a CUDA graph count once a replay (solvers/graph.py)."""
    from smallk_torch.kernels import ell_spmm, hals_step, masked_gj, rank2_loop
    from smallk_torch.ops import aop
    from smallk_torch.solvers import graph, solve

    return {"K1": masked_gj.launches, "K1_columns": masked_gj.columns,
            "K2": hals_step.launches,
            "K3": rank2_loop.launches, "ell_spmm": ell_spmm.launches,
            "ell_spmm_transposed": ell_spmm.transposed_launches,
            "ell_plain_cuda": ell_spmm.plain_cuda_calls,
            "kernel_products": aop.kernel_products,
            "matmul_products": aop.matmul_products,
            "steps": solve.steps_run, "host_reads": solve.host_reads,
            "frozen": solve.frozen_steps, "solves": solve.solves,
            "captures": graph.captures, "replays": graph.replays}


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
            runs[device] = (X.cpu(), Y.cpu(), bool(ok), rounds,
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


def phase_main_path(card: str) -> dict:
    import torch

    from smallk_torch import (NmfAlgorithm, NmfOptions, NmfStats, Random,
                              random_matrix, random_sparse_matrix)
    from smallk_torch.engines.nmf import run_nmf
    from smallk_torch.ops.aop import as_aop
    from smallk_torch.ops.dense import relative_fnorm

    rng = Random(2024)
    A = random_sparse_matrix(rng, M, N, nz_per_col=NZ_PER_COL,
                             dtype=np.float32)
    W0 = random_matrix(M, K, rng, dtype=np.float32)
    H0 = random_matrix(K, N, rng, dtype=np.float32)
    opts = NmfOptions(tol=1e-30, algorithm=NmfAlgorithm.BPP, height=M,
                      width=N, k=K, min_iter=1, max_iter=ITERS,
                      verbose=False, a_dtype="bfloat16")

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
    launches, k2_launches = counts["K1"], counts["K2"]

    rel = rel_err(W, H)
    its = stats.iteration_count / (stats.elapsed_us / 1e6)
    log(f"[main] BPP {M}x{N} nnz/col={NZ_PER_COL} k={K} bf16 A: "
        f"success={ok}, iterations={stats.iteration_count}, "
        f"pivot rounds={stats.pivot_rounds}, K1 launches={launches}, "
        f"rel err {rel:.6f} (after 1 iteration {rel1:.6f})")
    log(f"[main] {its:.2f} it/s (solve {stats.elapsed_us / 1e6:.4f} s, "
        f"run_nmf wall {wall:.4f} s) on {card}")
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
    return {"launches": launches, "it_per_s": its}


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


def phase_k3() -> dict:
    """K3 against its plain version at P3's shapes and ragged ones; times of
    the loop at P3's shapes and of one iteration's two products at the
    hierclust root shape."""
    import torch

    from smallk_torch.kernels import rank2_loop as k3

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

    # one rank-2 iteration's A-products at the hierclust root shape
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


def hier_problem():
    """bench.py's Reuters-shape hierclust corpus, made from its seed, as a
    bf16 operand on the card (built once, outside the timing)."""
    from smallk_torch.engines.corpus import synthetic_term_doc_corpus
    from smallk_torch.ops.aop import as_aop

    A, labels = synthetic_term_doc_corpus(HIER_M, HIER_N, HIER_TOPICS,
                                          seed=11)
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
    # two K3 products a step run (frozen steps too) and W'A once a solve
    want = 2 * counts["steps"] + counts["solves"]
    if counts["K3"] != want or counts["kernel_products"] != want:
        raise AssertionError(f"K3 launched {counts['K3']} times for "
                             f"{counts['steps']} steps run in "
                             f"{counts['solves']} solves (expected {want})")
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
    """EllAOp's and GatheredColsAOp's products through ell_spmm's plain
    version, bucket by bucket and block by block as the kernel runs them
    (ell_spmm_reference on the card, counted as plain calls).  Each entry
    point an operand module imports is swapped for its plain version, so
    an archived tree's package (`--times`) is swapped too."""
    from smallk_torch.kernels import ell_spmm as kmod
    from smallk_torch.ops import ell, ell_cols

    plain = {"ell_spmm": kmod.ell_spmm_reference,
             "ell_spmm_buckets": getattr(kmod, "ell_spmm_buckets_reference",
                                         None)}
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
            log(f"[nnls sweep f32] k={k} n={n}: {rn} rounds, wall ms per "
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


def subset_entries(cols, idx) -> dict:
    """A column subset's nonzeros on the card (CscColumns.entries) with
    their values in f32 and their count: what the torch-ops products and
    torch.sparse.mm read."""
    e = cols.entries(idx)
    e["vals"] = cols.data[e["pos"]].float()
    e["nnz"] = int(e["pos"].numel())
    return e


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


def long_sum_tol(op, side: str) -> float:
    """Relative tolerance between two f32 sums of a product's longest
    chain of terms taken in other orders: ELL_TOL's f32 value (sums of up
    to 128 terms), grown as the square root of the chain's length past
    128, as the rounding of a long sum of positive terms grows."""
    from smallk_torch.ops.ell_cols import GatheredColsAOp

    if isinstance(op, GatheredColsAOp):
        buckets, split = op.cols if side == "tn" else op.rows
        longest = [idx.shape[1] for _, idx, _ in buckets]
        if split is not None:
            longest += [split[0].shape[1], split[3].shape[1]]
    else:
        fam = ((op.col_buckets, op.col_blocks) if side == "tn"
               else (op.row_buckets, op.row_blocks))
        buckets = fam[0] or [b for _, bk in fam[1] for b in bk]
        longest = [idx.shape[1] for _, idx, _ in buckets]
    return ELL_TOL["float32"] * max(1.0, (max(longest, default=1) / 128)
                                    ** 0.5)


def node_products(cols, idx, label: str, op=None, root_op=None) -> dict:
    """One node's k = 2 products (f32 factors on the bf16 corpus) through
    `op`'s ell_spmm launches (by default the gathered operand, whose build
    is timed), held to their plain version, the torch-ops formulation and
    torch.sparse.mm, and timed (CUDA events over calls back to back; the
    plain version once, between synchronizes), with the launches a product
    makes and its bound; given the root's operand, also the masked view's
    time at this subset."""
    import torch

    from smallk_torch.kernels import ell_spmm as kmod
    from smallk_torch.ops.aop import MaskedAOp

    m, w = cols.shape[0], len(idx)
    out = {}
    if op is None:
        out["build_ms"] = wall_ms(lambda: cols.gathered(idx))
        op = cols.gathered(idx)
    e = subset_entries(cols, idx)
    out["nnz"] = e["nnz"]
    gen = torch.Generator(device="cuda").manual_seed(w)
    W = torch.rand((m, 2), generator=gen, device="cuda")
    H = torch.rand((2, w), generator=gen, device="cuda")
    tops, lib = torch_ops_products(e), library_products(e, m, w)
    for side, x, fn in (("tn", W, op.mm_tn), ("nt", H, op.mm_nt)):
        before = kmod.launches
        got = fn(x)
        launches = kmod.launches - before
        with plain_ell():
            want = fn(x)
            plain_ms = wall_ms(lambda: fn(x), 1)
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        others = max(float((tops[side == "nt"](x) - want).abs().max()),
                     float((lib[side == "nt"](x) - want).abs().max()))
        tol = long_sum_tol(op, side) * scale
        if not (err <= tol and others <= tol
                and bool(torch.isfinite(got).all())):
            raise AssertionError(f"{label} {side}: kernel {err}, torch ops "
                                 f"and library {others} from the plain "
                                 f"version (tolerance {tol})")
        n_out = w * 2 if side == "tn" else m * 2
        n_tab = m * 2 if side == "tn" else w * 2
        b_ms, b_by = bound(2.0 * e["nnz"] * 2,
                           e["nnz"] * (4 + 2) + 4 * (n_tab + n_out))
        out[side] = {"ell_ms": back_to_back_ms(lambda: fn(x), 5),
                     "plain_ms": plain_ms,
                     "ops_ms": back_to_back_ms(
                         lambda: tops[side == "nt"](x), 3),
                     "library_ms": back_to_back_ms(
                         lambda: lib[side == "nt"](x), 5),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "launches": launches, "err": err}
    if root_op is not None:
        mask = torch.zeros(cols.shape[1], device="cuda")
        mask[idx] = 1.0
        masked = MaskedAOp(root_op, mask)
        Hf = torch.zeros((2, cols.shape[1]), device="cuda")
        Hf[:, idx] = H
        out["masked_ms"] = back_to_back_ms(
            lambda: (masked.mm_tn(W), masked.mm_nt(Hf)), 3)
    t, n_ = out["tn"], out["nt"]
    log(f"[cols] {label}: w={w} nnz={e['nnz']}"
        + (f", gathered operand built in {out['build_ms']:.2f} ms"
           if "build_ms" in out else "")
        + f"; ms per product (W'A / AH'): ell_spmm {t['ell_ms']:.4f} / "
        f"{n_['ell_ms']:.4f} ({t['launches']} / {n_['launches']} launches, "
        f"max|kernel - plain| {t['err']:.2e} / {n_['err']:.2e}), plain "
        f"{t['plain_ms']:.2f} / {n_['plain_ms']:.2f}, torch ops "
        f"{t['ops_ms']:.4f} / {n_['ops_ms']:.4f}, torch.sparse.mm "
        f"{t['library_ms']:.4f} / {n_['library_ms']:.4f}, bound "
        f"{t['bound_ms']:.4f} / {n_['bound_ms']:.4f} ({t['bound_by']})"
        + (f"; masked view of the root, both products {out['masked_ms']:.4f}"
           if root_op is not None else ""))
    return out


def cols_study(card: str) -> None:
    """The node operand's products at k = 2 on the 50,000 x 1,000,000
    corpus: the root's EllAOp; at the root and at a node of 1/SPH_NODE of
    the documents the gathered operand (its long slices cut, and uncut),
    the torch-ops formulation and torch.sparse.mm (how ops/ell_cols chose
    its formulation); then the gathered operand against the masked view of
    the root across shares of the documents (why hierclust gathers every
    node)."""
    import torch

    from smallk_torch.ops import ell_cols
    from smallk_torch.ops.aop import as_aop
    from smallk_torch.ops.ell_cols import CscColumns

    A, _, gen_s = sparse_corpus(SPH_N)
    t0 = time.perf_counter()
    a_op = as_aop(A, dtype="bfloat16", device="cuda")
    ell_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cols = CscColumns.from_scipy(A, "bfloat16", device="cuda")
    torch.cuda.synchronize()
    csc_s = time.perf_counter() - t0
    log(f"[cols] corpus {SPH_M}x{SPH_N}, {A.nnz} nonzeros: generator "
        f"{gen_s:.2f} s, EllAOp build {ell_s:.2f} s, CSC copy {csc_s:.2f} s "
        f"(host seconds) on {card}")
    everything = torch.arange(SPH_N, device="cuda")
    perm = torch.from_numpy(np.random.RandomState(3).permutation(SPH_N)).cuda()
    node_products(cols, everything, "root, the EllAOp", op=a_op)
    for label, idx in (("root", everything),
                       (f"1/{SPH_NODE} node", perm[:SPH_N // SPH_NODE])):
        node_products(cols, idx, f"{label}, gathered")
        # the same operand with no slice cut into pieces
        with patched(ell_cols, "_MAX_LEN", 1 << 30):
            node_products(cols, idx, f"{label}, gathered, slices uncut")
    for share in CUT_SHARES:
        idx = perm[:int(share * SPH_N)]
        node_products(cols, idx, f"node of {share:g} of the documents",
                      root_op=a_op)


def phase_sparse_hierclust(card: str) -> dict:
    """Hierclust on the planted 50,000 x 1,000,000 corpus (bf16 A, above
    the densify threshold), f32 factors, HIER_K clusters, as the
    Reuters-shape phase runs it: a warm-up run with another seed, the
    timed run with the launches counted, and the node products timed at
    the root and at a 1/SPH_NODE node.  (The device's busy share on this
    path comes from the loop phase's profile in a process of its own.)"""
    import torch

    from smallk_torch import ClustStats, Random
    from smallk_torch.engines import hierclust as hc
    from smallk_torch.engines.scoring import nmi
    from smallk_torch.engines.tree import _host
    from smallk_torch.ops.aop import as_aop
    from smallk_torch.ops.ell_cols import CscColumns

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
        f"{ell_s:.2f} s (host); wall {wall:.4f} s (its CSC copy included), "
        f"nmf_count {stats.nmf_count}, converged "
        f"{stats.nmf_count - stats.max_count}, iter_count {stats.iter_count},"
        f" {stats.iter_count / wall:.1f} rank-2 it/s, NMI {score:.4f}, leaves "
        f"{leaves}, outliers {len(tree.outliers)}, ell_spmm launches "
        f"{counts['ell_spmm']} (transposed "
        f"{counts['ell_spmm_transposed']}), node operands gathered/masked "
        f"{tiers[0]}/{tiers[1]}, dense products {counts['kernel_products']} "
        f"+ {counts['matmul_products']}; warm-up wall {warm:.4f} s; on "
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
    if counts["ell_spmm"] < 2 * counts["steps"] or counts["ell_plain_cuda"]:
        raise AssertionError(f"sparse hierclust bypassed ell_spmm: {counts}")
    if counts["matmul_products"] or counts["kernel_products"]:
        raise AssertionError(f"sparse hierclust made dense products: {counts}")

    # the node products at the root and at a 1/SPH_NODE node
    cols = CscColumns.from_scipy(A, "bfloat16", device="cuda")
    root = node_products(cols, torch.arange(SPH_N, device="cuda"),
                         "sparse hierclust root, the EllAOp", op=a_op)
    idx = torch.from_numpy(np.random.RandomState(3).permutation(SPH_N)[
        :SPH_N // SPH_NODE]).cuda()
    node = node_products(cols, idx, f"sparse hierclust 1/{SPH_NODE} node")
    transposed = counts["ell_spmm_transposed"]
    return {"launches": {"tn": transposed,
                         "nt": counts["ell_spmm"] - transposed},
            "wall": wall, "root": root, "node": node, "nmi": score,
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
        f"clusters: NMI sparse {ns:.4f} (ell_spmm launches "
        f"{cs['ell_spmm']}, gathered node operands {gs}), dense {nd:.4f} "
        f"(K3 launches {cd['K3']}); iterations {its}/{itd}, assignments "
        f"agree on {100 * np.mean(asg == adn):.2f}% of the documents")
    if ns < nd - HIER_NMI_MARGIN or not gs or cs["matmul_products"] \
            or cd["matmul_products"] or not cd["K3"]:
        raise AssertionError("sparse f32 hierclust trails the dense run or "
                             "took the wrong products")


def phase_bpp_wide(card: str) -> dict:
    """BPP at k = BPP_WIDE_K (> 128, the CG tier's) on the main path's
    Reuters-shape operand: BPP_WIDE_ITERS fixed iterations on the card
    with the CG solves and steps counted, no K1 launch; and f64 on a slice,
    3 iterations, the card against the CPU with the CG tier forced."""
    from smallk_torch import (NmfAlgorithm, NmfOptions, NmfStats, Random,
                              random_matrix, random_sparse_matrix)
    from smallk_torch.engines.nmf import run_nmf
    from smallk_torch.solvers import nnls

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
    stats = NmfStats()
    reset_counts()
    nnls.cg_solves = nnls.cg_steps = 0
    W, H, ok = run_nmf(A, W0, H0, opts, stats, device="cuda")
    counts = read_counts()
    solves, steps = nnls.cg_solves, nnls.cg_steps
    A64 = A.toarray()
    rel, rel1 = rel_err(A64, W, H), rel_err(A64, W1, H1)
    its = stats.iteration_count / (stats.elapsed_us / 1e6)
    log(f"[bpp k={k}] {M}x{N} bf16 A, f32 factors, {BPP_WIDE_ITERS} "
        f"iterations: success={ok}, {its:.3f} it/s, pivot rounds "
        f"{stats.pivot_rounds}, CG solves {solves}, CG steps {steps}, K1 "
        f"launches {counts['K1']}, rel err {rel:.6f} (after 1 iteration "
        f"{rel1:.6f}) on {card}")
    if not (ok and ok1) or stats.iteration_count != BPP_WIDE_ITERS:
        raise AssertionError("BPP through the CG tier failed")
    for name, F in (("W", W), ("H", H)):
        if not np.isfinite(F).all() or (F < 0).any():
            raise AssertionError(f"{name} is not finite and nonnegative")
    if not rel < rel1 or counts["K1"] or solves < 2 * BPP_WIDE_ITERS:
        raise AssertionError(f"BPP k={k}: rel err {rel} (1 iteration "
                             f"{rel1}), K1 {counts['K1']}, CG solves {solves}")

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
    same random_matrix draws on the same card: equal bits, K1 = 2 x
    iterations + pivot rounds, w.csv and h.csv written."""
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
    if counts["K1"] != 2 * its + rounds or dcounts != counts:
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
    K3 >= 2 x iter_count.  The flat refinement is NNLS-HALS in torch ops
    (clust_flat): its W'A at k = 12 is the one product that is not K3's."""
    import smallk_torch as smallk
    from smallk_torch.engines.corpus import synthetic_term_doc_corpus
    from smallk_torch.engines.flatclust import (
        run_hier_nmf2, write_flatclust_results)
    from smallk_torch.io.writers import make_hierclust_writer

    A, _ = synthetic_term_doc_corpus(HIER_M, HIER_N, HIER_TOPICS, seed=11)
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
    if counts != dcounts or counts["K3"] < 2 * stats.iter_count \
            or counts["K3"] != counts["kernel_products"] \
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
    products through ell_spmm and none dense."""
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
        f"plain calls on cuda {counts['ell_plain_cuda']}, dense products "
        f"{counts['kernel_products']} + {counts['matmul_products']} on {card}")
    if leaves != HIER_K:
        raise AssertionError(f"api.Hierclust: {leaves} leaves")
    if abs(score - sparse["nmi"]) > FACADE_NMI_MARGIN:
        raise AssertionError(f"api.Hierclust NMI {score} against the "
                             f"phase's {sparse['nmi']}")
    if counts["ell_spmm"] < 2 * stats.iter_count or counts["ell_plain_cuda"]:
        raise AssertionError(f"api.Hierclust bypassed ell_spmm: {counts}")
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
    EllAOp and at a 1/SPH_NODE node's gathered operand, back to back, and
    the clustering's wall (after a warm-up run with another seed) with its
    iterations, leaves and NMI."""
    import torch

    from smallk_torch import ClustStats, Random
    from smallk_torch.engines import hierclust as hc
    from smallk_torch.engines.scoring import nmi
    from smallk_torch.ops.aop import as_aop
    from smallk_torch.ops.ell_cols import CscColumns

    A, labels, _ = sparse_corpus(SPH_N)
    a_op = as_aop(A, dtype="bfloat16", device="cuda")
    cols = CscColumns.from_scipy(A, "bfloat16", device="cuda")
    idx = torch.from_numpy(np.random.RandomState(3).permutation(SPH_N)[
        :SPH_N // SPH_NODE]).cuda()
    res = {}
    gen = torch.Generator(device="cuda").manual_seed(5)
    for label, op in (("root", a_op), (f"1/{SPH_NODE} node",
                                       cols.gathered(idx))):
        W = torch.rand((SPH_M, 2), generator=gen, device="cuda")
        H = torch.rand((2, op.shape[1]), generator=gen, device="cuda")
        res[f"k=2 {label} W'A ms"] = back_to_back_ms(lambda: op.mm_tn(W), 5)
        res[f"k=2 {label} AH' ms"] = back_to_back_ms(lambda: op.mm_nt(H), 5)
    del cols
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


def product_launches(op) -> tuple[int, int, int]:
    """ell_spmm launches of one W'A, of them the transposed ones, and of
    one AH' of an EllAOp or a GatheredColsAOp, from its buckets (a bucket
    with no rows launches nothing; a gathered operand's split long slices
    launch a partial product and a transposed or row-mode fold)."""
    from smallk_torch.ops.ell import EllAOp
    from smallk_torch.ops.ell_cols import GatheredColsAOp

    if isinstance(op, EllAOp):
        tn = sum(p.launching for _, _, p in op.col_packs)
        return tn, tn, sum(p.launching for _, _, p in op.row_packs)
    if not isinstance(op, GatheredColsAOp):
        raise TypeError(f"no ell_spmm launch count for {type(op)}")

    def split(family):
        parts = getattr(op, family)[1]
        if parts is None:
            return 0, 0
        p_idx, _, _, refs, _ = parts
        return int(p_idx.shape[0] > 0), int(refs.shape[0] > 0)

    (tn_part, tn_fold), (nt_part, nt_fold) = split("cols"), split("rows")
    tn_t = op._packs["cols"].launching + tn_fold
    return (tn_t + tn_part, tn_t,
            op._packs["rows"].launching + nt_part + nt_fold)


def loop_hier_cell(a_op, labels, host_A=None):
    """A hierclust cell: clust_hier to HIER_K clusters with seed 2, as the
    hierclust phases run it (dense bf16 A through K3, or the sparse
    corpus's EllAOp and gathered node operands through ell_spmm: each
    solve's operand and steps recorded for the gate)."""
    from smallk_torch import Random
    from smallk_torch.engines import hierclust as hc
    from smallk_torch.engines.scoring import nmi
    from smallk_torch.solvers import solve

    opts = hier_opts(HIER_K, "float32", a_dtype="bfloat16")
    sparse = host_A is not None

    def run(unroll=0):
        o = dataclasses.replace(opts, nmf_opts=dataclasses.replace(
            opts.nmf_opts, loop_unroll=unroll))
        solves = []

        def recorded(op, *args, **kwargs):
            before = solve.steps_run
            res = solve.nmf_solve(op, *args, **kwargs)
            solves.append((product_launches(op), solve.steps_run - before))
            return res

        with patched(hc, "nmf_solve", recorded) if sparse \
                else contextlib.nullcontext():
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
            # a solve on an operand: W'A once and then one W'A and one AH'
            # a step run, each at that operand's launches
            solves = out["solves"]
            want = sum(tn * (s + 1) + nt * s for (tn, _, nt), s in solves)
            want_t = sum(tn_t * (s + 1) for (_, tn_t, _), s in solves)
            if len(solves) != counts["solves"] \
                    or sum(s for _, s in solves) != counts["steps"] \
                    or counts["ell_spmm"] != want \
                    or counts["ell_spmm_transposed"] != want_t \
                    or counts["ell_plain_cuda"] or counts["kernel_products"] \
                    or counts["matmul_products"]:
                raise AssertionError(f"loop sparse hierclust: {counts}, "
                                     f"ell_spmm expected {want}, "
                                     f"transposed {want_t}")
            if round(out["nmi"], 3) != SPH_NMI:
                raise AssertionError(f"loop sparse hierclust: NMI "
                                     f"{out['nmi']}, not {SPH_NMI}")
            return
        # two K3 products a step run and W'A once a solve
        want = 2 * counts["steps"] + counts["solves"]
        if counts["K3"] != want or counts["kernel_products"] != want \
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


def loop_problems() -> dict:
    """The four loop cells built from their seeds, for the processes of
    their own (--loop-busy, --loop)."""
    from smallk_torch.ops.aop import as_aop
    from smallk_torch.ops.ell import EllAOp

    cells = {"flatclust HALS": loop_flatclust_cell()}
    a_op, labels = hier_problem()
    cells["hierclust Reuters"] = loop_hier_cell(a_op, labels)
    A, slabels, _ = sparse_corpus(SPH_N)
    cells["sparse hierclust 50k x 1M"] = loop_hier_cell(
        as_aop(A, dtype="bfloat16", device="cuda"), slabels, host_A=A)
    return cells


def loop_busy_child() -> int:
    """--loop-busy: each loop cell once eager and once captured inside one
    torch.profiler session, in this process of its own (a second session
    in a process loses kernel records: PERF.md §7).  For each run: the
    device's busy share of its wall (the union of kernel intervals) and the
    host's launch calls (kernels and graphs).  Prints LOOP_BUSY {json}."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from smallk_torch.common.device import setup
    from smallk_torch.ops.ell import EllAOp
    from smallk_torch.solvers import graph

    setup("cuda")
    t0 = time.perf_counter()
    cells = loop_problems()
    FA, W0, H0 = flagship_problem()
    op = EllAOp.from_scipy(FA, "bfloat16", device="cuda")
    del FA
    cells["flagship MU k=128"] = loop_flagship_cell(
        {"op": op, "W0": W0, "H0": H0})
    for name in ("flatclust HALS", "hierclust Reuters"):  # warm-ups
        cells[name][0]()
    torch.cuda.synchronize()
    stamps = [("problems and warm-ups", time.perf_counter() - t0)]
    walls = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for name, (run, _) in cells.items():
            for capture in (False, True):
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
                gpu.append((e.start_ns(), e.end_ns()))
        elif name in walls:
            windows[name] = (e.start_ns(), e.end_ns())
        elif name in launch_calls:
            calls.append((e.start_ns(), name))
    gpu.sort()
    slack = 100_000_000  # ns: less than the gap between two windows
    result = {}
    for label, (lo, hi) in windows.items():
        spans = [(a, b) for a, b in gpu if lo - slack <= a <= hi + slack]
        busy, end = 0, -1
        for a, b in spans:
            if b > end:
                busy += b - max(a, end)
                end = b
        wall, its = walls[label]
        n = {c: sum(1 for t, nm in calls if nm == c and lo <= t <= hi)
             for c in launch_calls}
        _, cell, mode = label.split("|")
        result.setdefault(cell, {})[mode] = {
            "wall": wall, "busy": busy / 1e9 / wall, "iterations": its,
            "device_events": len(spans), "launch_calls": n,
            "launches_per_iteration": sum(n.values()) / max(its, 1)}
        log(f"[loop busy] {cell}, {mode}: wall {wall:.4f} s (profiled), "
            f"device busy {100 * busy / 1e9 / wall:.2f}%, {len(spans)} "
            f"device events, host launch calls {n} "
            f"({sum(n.values()) / max(its, 1):.2f} an iteration)")
    stamps.append(("reading its events", time.perf_counter() - t0))
    log("[loop busy] host seconds: " + ", ".join(f"{k} {v:.1f}"
                                                 for k, v in stamps))
    if len(result) != len(cells) or not all(
            r["busy"] > 0 for c in result.values() for r in c.values()):
        raise AssertionError(f"the profile lost runs or kernels: {result}")
    print("LOOP_BUSY " + json.dumps(result), flush=True)
    return 0


def loop_busy(card: str) -> dict:
    """Runs --loop-busy in a process of its own; returns its shares."""
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           "--loop-busy"], capture_output=True, text=True,
                          timeout=900, cwd=ROOT)
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
        log(f"[loop] {cell}: device busy eager "
            f"{100 * modes['eager']['busy']:.2f}%, captured "
            f"{100 * modes['captured']['busy']:.2f}%; host launch calls an "
            f"iteration eager {modes['eager']['launches_per_iteration']:.2f}"
            f", captured {modes['captured']['launches_per_iteration']:.2f} "
            f"on {card}")
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
    tn, tn_t, nt = product_launches(op)
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
    if sys.argv[1:] == ["--loop-busy"]:
        return loop_busy_child()
    from smallk_torch.common.device import setup
    from smallk_torch.kernels import ell_spmm, hals_step, masked_gj, rank2_loop

    setup("cuda")
    card = card_line()
    log(f"[device] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
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
               "--loop": loop_study}
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
    del sparse_hier["corpus"], sparse_hier["op"], flagship["op"], \
        flagship["mu_factors"]
    torch.cuda.empty_cache()
    timed("loop busy", loop_busy, card)
    timed("bpp wide", phase_bpp_wide, card)
    with ThreadPoolExecutor(5) as pool:  # the CLI processes side by side
        t0 = time.perf_counter()
        for job in [pool.submit(phase_cli), pool.submit(phase_flat_cli),
                    pool.submit(phase_hier_cli), pool.submit(phase_sparse_cli),
                    pool.submit(phase_cli_chain)]:
            job.result()
        secs["cli"] = time.perf_counter() - t0
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
        # the sparse hierclust root's products at k = 2 (an entry a lane,
        # long rows shared by warps); launches: that run's transposed (W'A)
        # or row-mode (AH') ones, at every node
        "name": f"ell_spmm (sparse hierclust root {side}, k=2, m={SPH_M} "
                f"n={SPH_N})",
        "route": "cuda",
        "source": ell_spmm.SOURCE,
        "replaces": ell_spmm.REPLACES["P2"],
        "launches": sparse_hier["launches"][side],
        "max_abs_err": sparse_hier["root"][side]["err"],
        "ms": sparse_hier["root"][side]["ell_ms"],
        "plain_ms": sparse_hier["root"][side]["plain_ms"],
        "bound_ms": sparse_hier["root"][side]["bound_ms"],
        "bound_by": sparse_hier["root"][side]["bound_by"],
        "library_ms": sparse_hier["root"][side]["library_ms"],
    } for side in ("tn", "nt")] + [{
        # the same products at a 1/SPH_NODE node's gathered operand
        "name": f"ell_spmm (sparse hierclust 1/{SPH_NODE} node {side}, k=2, "
                f"gathered operand)",
        "route": "cuda",
        "source": ell_spmm.SOURCE,
        "replaces": ell_spmm.REPLACES["P2"],
        "launches": sparse_hier["launches"][side],
        "max_abs_err": sparse_hier["node"][side]["err"],
        "ms": sparse_hier["node"][side]["ell_ms"],
        "plain_ms": sparse_hier["node"][side]["plain_ms"],
        "bound_ms": sparse_hier["node"][side]["bound_ms"],
        "bound_by": sparse_hier["node"][side]["bound_by"],
        "library_ms": sparse_hier["node"][side]["library_ms"],
    } for side in ("tn", "nt")]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
