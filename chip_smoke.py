#!/usr/bin/env python3
"""Smoke run of the PyTorch port (smallk_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths through their user entry points on the card and
fails (nonzero exit, no result line) on any fault:

  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles the CUDA kernels from smallk_torch/csrc/, one nvcc
     per library, all started together;
  3. K1, the masked Gauss-Jordan kernel, against its plain torch version
     on the card, f32 and f64, at the BPP path's shapes and up to k = 128,
     plus the dead-pivot case; kernel and plain times at the BPP shapes;
  4. K2, the whole-step HALS kernel, against its plain version at the
     flatclust shape (f32 and bf16 A), small and ragged shapes, the
     largest square shape the kernel admits at k = 16 and the zero-column
     rescue; kernel and plain times at 256 x 256, k = 16;
  5. slice parity in f64: run_nmf with BPP, MU, HALS and RANK2 on the card
     against the same calls on the CPU (f64 runs the torch-ops steps);
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
     accumulate) and at the shapes of P1 (scripts/tpu_batch29.py) and P2
     (scripts/tpu_batch33.py); kernel, plain and torch.sparse.mm times;
 13. sparse parity in f64: run_nmf BPP and MU on a blocked EllAOp and on
     a SparseAOp, the card against the CPU;
 14. the flagship at full width: rank-128 MU and BPP on the uncut 50,000 x
     1,000,000 bf16 EllAOp (bench.py:164-195), timed as bench.py times
     the reference (two-point fits), with the operand's host build time;
     its two products (ell_spmm) and K1's full-width round, each timed
     and held against its plain version at these shapes; the sparse-side
     relative error (from plain products) and ell_spmm's launches
     counted;
 15. the nmf, flatclust and hierclust CLIs as subprocesses, and the nmf
     CLI on a 30000 x 20000 .mtx above the densify threshold (EllAOp);
 16. the kernel table as one JSON line, the card line, and last the result
     line {"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile

runs only the full-width hierclust path: once under torch.profiler, to
print where the device time goes, then with its rank-2 products through
K3 and through torch.matmul, alternating, to time what K3 moves end to
end.

    python3 chip_smoke.py --sparse

runs only the studies of the flagship operand: AH' for each doc block of
DOC_BLOCKS (how ops/ell._DOC_BLOCK was chosen), MU with its products
through ell_spmm and through torch.sparse.mm, alternating, and one MU and
one BPP run under torch.profiler.

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
SLICE_ATOL = 1e-9
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
SP_M, SP_N, SP_K = 600, 3000, 8        # f64 sparse parity, blocked EllAOp
# the flagship: rank-128 NMF on a 50,000-term x 1,000,000-document corpus
# with 80 draws per column, bf16 A, f32 factors (bench.py:164-195), uncut
FLAG_M, FLAG_N, FLAG_K, FLAG_NZ = 50_000, 1_000_000, 128, 80
FLAG_MU_ITERS, FLAG_BPP_ITERS = (5, 25), (1, 3)  # two-point fits
FLAG_K1_CHECK = 65536   # columns of a full-width K1 round held to plain
DOC_BLOCKS = (0, 32768, 65536, 131072)           # the --sparse sweep
CLI_M, CLI_N, CLI_NZ = 30000, 20000, 80   # f32 dense image 2.4 GB > 2 GiB

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
    """Every kernel's launch count, and the product branch counts, to 0,
    just before a path is driven."""
    from smallk_torch.kernels import ell_spmm, hals_step, masked_gj, rank2_loop
    from smallk_torch.ops import aop

    masked_gj.launches = 0
    hals_step.launches = 0
    rank2_loop.launches = 0
    ell_spmm.launches = 0
    ell_spmm.plain_cuda_calls = 0
    aop.kernel_products = 0
    aop.matmul_products = 0


def read_counts() -> dict:
    """Launches of K1, K2, K3 and ell_spmm, ell_spmm's plain-version calls
    on CUDA tensors, and the dense products that went to K3 and to
    torch.matmul, since the last reset_counts()."""
    from smallk_torch.kernels import ell_spmm, hals_step, masked_gj, rank2_loop
    from smallk_torch.ops import aop

    return {"K1": masked_gj.launches, "K2": hals_step.launches,
            "K3": rank2_loop.launches, "ell_spmm": ell_spmm.launches,
            "ell_plain_cuda": ell_spmm.plain_cuda_calls,
            "kernel_products": aop.kernel_products,
            "matmul_products": aop.matmul_products}


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


def phase_kernel() -> dict:
    import torch

    from smallk_torch.kernels.masked_gj import (
        masked_gj_solve, masked_gj_solve_reference)

    worst = 0.0
    for name, tol in TOL.items():
        dtype = getattr(torch, name)
        cases = [(f"k={k} n={n}", k1_inputs(k, n, dtype, "cuda"))
                 for k, n in K1_SHAPES]
        cases.append(("dead-pivot k=16 n=64", dead_pivot_inputs(dtype,
                                                                 "cuda")))
        for label, (LHS, RHS, passive) in cases:
            X = masked_gj_solve(LHS, RHS, passive)
            Xr = masked_gj_solve_reference(LHS, RHS, passive)
            torch.cuda.synchronize()
            err = float((X - Xr).abs().max())
            log(f"[K1 {name}] {label}: max|kernel - plain| = {err:.3e} "
                f"(rtol = atol = {tol:g})")
            torch.testing.assert_close(X, Xr, rtol=tol, atol=tol)
            if label.startswith("dead"):
                if not bool(torch.isfinite(X).all()):
                    raise AssertionError("dead-pivot solve is not finite")
                torch.testing.assert_close(X[3], torch.zeros_like(X[3]),
                                           rtol=0, atol=tol)
            worst = max(worst, err)

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
    (q divisions per pivot row, 2 (q-1)(q+1) per elimination), and each
    input and output moved once."""
    k, n = passive.shape
    q = passive.sum(dim=0).double()
    flop = float((q * (q + 1) + 2 * q * (q - 1) * (q + 1)).sum())
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
    from smallk_torch.kernels import hals_step

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
        f"success={ok}, iterations={its}, K2 launches={launches}, rel err "
        f"{rel:.6f}, {its / (stats.elapsed_us / 1e6):.1f} it/s to "
        f"convergence")
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
    if launches != its:
        raise AssertionError(f"K2 launched {launches} times in {its} "
                             "iterations: a step took another route")
    if k1_launches:
        raise AssertionError(f"K1 launched {k1_launches} times in a HALS run")

    # HALS it/s over a fixed number of iterations, after one warm-up
    fixed = dataclasses.replace(opts, tol=1e-30, max_iter=FLAT_ITERS)
    run_flatclust(A, W0, H0, dataclasses.replace(fixed, max_iter=200),
                  device="cuda")
    stats2 = NmfStats()
    before = hals_step.launches
    *_, ok2 = run_flatclust(A, W0, H0, fixed, stats2, device="cuda")
    fixed_its = stats2.iteration_count / (stats2.elapsed_us / 1e6)
    log(f"[flatclust] HALS {FLAT_ITERS} fixed iterations: {fixed_its:.1f} "
        f"it/s (solve {stats2.elapsed_us / 1e6:.4f} s) on {card}")
    if not ok2 or stats2.iteration_count != FLAT_ITERS or \
            hals_step.launches - before != FLAT_ITERS:
        raise AssertionError("fixed-iteration HALS run failed")

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
    # the pair reads A once at the least (each input once), and does
    # 2 x 4 m w operations
    b_ms, b_by = bound(8.0 * HIER_M * HIER_N,
                       A.numel() * A.element_size() + 16 * (HIER_M + HIER_N))
    log(f"[K3 time] root products m={HIER_M} w={HIER_N} A bfloat16: device "
        f"ms wt_a + h_at {ms:.4f} (wt_a {parts[0]:.4f}, h_at {parts[1]:.4f}), "
        f"plain {plain:.4f}, library (torch.matmul after the upcast) "
        f"{library:.4f}; bound {b_ms:.4f} ms ({b_by}; two separate reads of "
        f"A: {2 * b_ms:.4f} ms)")
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
        f"{stats.iter_count}, {stats.iter_count / wall:.1f} rank-2 it/s, K3 "
        f"launches {counts['K3']}, k=2 products to torch.matmul "
        f"{counts['matmul_products']}, leaves {leaves}, outliers "
        f"{len(tree.outliers)}, NMI {score:.4f} on {card}")
    if leaves != HIER_K:
        raise AssertionError(f"{leaves} leaves, expected {HIER_K}")
    if (tree.assignments < 0).any():
        raise AssertionError(f"{len(tree.outliers)} documents unassigned")
    if counts["K3"] < 2 * stats.iter_count:
        raise AssertionError(f"K3 launched {counts['K3']} times in "
                             f"{stats.iter_count} rank-2 iterations")
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


def phase_ell_spmm() -> dict:
    """ell_spmm against its plain version on ragged buckets (store and
    accumulate, every dtype pair) and at P1's and P2's shapes; times of
    the kernel, the plain version and torch.sparse.mm at the probes'."""
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

    for i, (g, L, B, k, vt, tt) in enumerate(ELL_RAGGED):
        idx, vals, table = ell_inputs(g, L, B, k, vt, tt, 0.3, seed=i)
        acc = torch.float64 if vt == "float64" else torch.float32
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1000 + i)
        rows = torch.randperm(g + 7, generator=gen, device="cuda")[:g].to(
            torch.int32)
        out0 = torch.rand((g + 7, k), generator=gen, dtype=acc, device="cuda")
        for accumulate in (False, True):
            before = kmod.launches
            got = kmod.ell_spmm(idx, vals, table, out0.clone(), rows,
                                accumulate)
            want = kmod.ell_spmm_reference(idx, vals, table, out0.clone(),
                                           rows, accumulate)
            torch.cuda.synchronize()
            if kmod.launches != before + 1:
                raise AssertionError("ell_spmm did not launch its kernel")
            check(f"g={g} L={L} B={B} k={k} vals {vt} table {tt} "
                  f"{'accumulate' if accumulate else 'store'}", got, want,
                  ELL_TOL[vt if vt == "float64" else "float32"])

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
            f" Gnnz/s, {nnz * k * table.element_size() / ms / 1e9:.1f} TB/s "
            f"of gathered rows; back to back {ms_b2b:.4f}), plain {plain:.4f}, "
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
    """EllAOp's products through ell_spmm's plain version, bucket by bucket
    and block by block as the kernel runs them (ell_spmm_reference on the
    card, counted as plain calls)."""
    from smallk_torch.kernels.ell_spmm import ell_spmm_reference
    from smallk_torch.ops import ell

    kernel = ell.ell_spmm
    ell.ell_spmm = ell_spmm_reference
    try:
        yield
    finally:
        ell.ell_spmm = kernel


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


def k1_round_ms(op, W0: np.ndarray, H0: np.ndarray) -> dict:
    """K1's device ms for one full-width round of each BPP side at the
    flagship shape, and its bound: (k, n) for H, (k, m) for W, with the
    real Grams and right-hand sides and half the entries passive (CUDA
    events, one warm-up, three timed calls).  The round's first
    FLAG_K1_CHECK columns are held against the plain version on the same
    columns (the columns are independent systems), to TOL."""
    import torch

    from smallk_torch.kernels.masked_gj import (
        masked_gj_solve, masked_gj_solve_reference)

    W = torch.from_numpy(W0).cuda()
    H = torch.from_numpy(H0).cuda()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    sides = {"H": (W.T @ W, op.mm_tn(W)), "W": (H @ H.T, op.mm_nt(H).T)}
    out = {}
    for side, (LHS, RHS) in sides.items():
        RHS = RHS.contiguous()
        passive = torch.rand(RHS.shape, generator=gen, device="cuda") < 0.5
        X = masked_gj_solve(LHS, RHS, passive)[:, :FLAG_K1_CHECK]
        c = X.shape[1]
        Xr = masked_gj_solve_reference(LHS, RHS[:, :c].contiguous(),
                                       passive[:, :c].contiguous())
        err = float((X - Xr).abs().max())
        log(f"[flagship K1] {side} side (k={LHS.shape[0]}, first {c} of "
            f"{RHS.shape[1]} columns): max|kernel - plain| = {err:.3e}, "
            f"relative {err / float(Xr.abs().max()):.3e} (rtol = atol = "
            f"{TOL['float32']:g})")
        torch.testing.assert_close(X, Xr, rtol=TOL["float32"],
                                   atol=TOL["float32"])
        del X, Xr
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            masked_gj_solve(LHS, RHS, passive)
        stop.record()
        torch.cuda.synchronize()
        out[side] = (start.elapsed_time(stop) / 3, *k1_bound(passive), err)
    return out


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
    del A
    per_iter = ell_launches_per_iteration(op)
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
    log(f"[flagship] products at k={FLAG_K}: W'A {tn_ms:.3f} ms, AH' "
        f"{nt_ms:.3f} ms ({nnz / ((tn_ms + nt_ms) / 2) / 1e6:.3f} Gnnz/s "
        f"each on average)")
    del W, H
    rounds = k1_round_ms(op, W0, H0)
    log(f"[flagship] K1 device ms per full-width round at k={FLAG_K}, half "
        f"the entries passive: H side (k, {FLAG_N}) {rounds['H'][0]:.2f} "
        f"(bound {rounds['H'][1]:.3f}, {rounds['H'][2]}), W side (k, "
        f"{FLAG_M}) {rounds['W'][0]:.2f} (bound {rounds['W'][1]:.3f}, "
        f"{rounds['W'][2]})")

    launches = 0
    rates = {}
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
            rounds_txt = (f", pivot rounds {stats.pivot_rounds} "
                          f"({stats.pivot_rounds / it:.1f} per iteration)"
                          if alg == "BPP" else "")
            log(f"[flagship] {alg} {it} iteration(s): solve {walls[it]:.3f} "
                f"s, rel err {rel[it]:.6f}, ell_spmm launches "
                f"{counts['ell_spmm']}, K1 launches {counts['K1']}, plain "
                f"calls on cuda {counts['ell_plain_cuda']}{rounds_txt}")
            if counts["ell_spmm"] < per_iter * it or counts["ell_plain_cuda"]:
                raise AssertionError(f"flagship {alg}: products bypassed "
                                     f"ell_spmm ({counts})")
            want_k1 = 2 * it if alg == "BPP" else 0
            if counts["K1"] < want_k1 or (not want_k1 and counts["K1"]):
                raise AssertionError(f"flagship {alg}: K1 launches {counts}")
            if it in iters:
                launches += counts["ell_spmm"]
        lo, hi = iters[0], iters[-1]
        if not rel[hi] < rel[1]:
            raise AssertionError(f"flagship {alg}: rel err {rel[hi]} after "
                                 f"{hi} iterations not below the "
                                 f"1-iteration {rel[1]}")
        rates[alg] = (hi - lo) / max(walls[hi] - walls[lo], 1e-9)
        log(f"[flagship] {alg} k={FLAG_K}: {rates[alg]:.4f} it/s "
            f"(({hi} - {lo}) iterations / ({walls[hi]:.3f} - {walls[lo]:.3f}) "
            f"s) on {card}")
    log(f"[flagship] peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB")
    del op
    torch.cuda.empty_cache()
    return {"launches": launches, "rates": rates, "max_abs_err": worst_abs}


def phase_sparse_cli() -> None:
    """The nmf CLI on a 30000 x 20000 .mtx with 80 draws per column: its
    f32 dense image (2.4 GB) is above the 2 GiB densify threshold, so
    run_nmf takes an EllAOp."""
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
    if W.shape != (m, k) or H.shape != (k, n):
        raise AssertionError(f"sparse CLI wrote W {W.shape}, H {H.shape}")
    if not (np.isfinite(W).all() and np.isfinite(H).all()
            and (W >= 0).all() and (H >= 0).all()):
        raise AssertionError("sparse CLI factors are not finite and >= 0")
    tail = " ".join(proc.stdout.strip().splitlines()[-2:])
    log(f"[cli] nmf_cli {m}x{n} nnz={A.nnz} (.mtx, EllAOp) k={k} BPP "
        f"--maxiter 20 --device cuda: rc 0 in {wall:.1f} s, w.csv {W.shape}, "
        f"h.csv {H.shape}; {tail}")


def profile_summary(prof, wall: float, label: str) -> None:
    """Device busy share of a profiled window and the kernels that took
    its device time."""
    events = [e for e in prof.events()
              if e.device_type.name == "CUDA" and e.device_time_total > 0]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, -1.0
    for a, b in spans:  # union of the device intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    total = sum(by_name.values())
    host = {e.key: e.count for e in prof.key_averages()
            if e.key in ("cudaLaunchKernel", "cudaStreamSynchronize",
                         "cudaMemcpyAsync")}
    log(f"[profile] {label}: wall {wall:.4f} s (profiled); device busy "
        f"{busy / 1e6:.4f} s = {100 * busy / 1e6 / wall:.2f}% of the wall "
        f"(idle {100 - 100 * busy / 1e6 / wall:.2f}%); host calls {host}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"[profile]   {us / 1e3:10.3f} ms {100 * us / max(total, 1e-9):6.2f}"
            f"%  {name[:90]}")


def sparse_study(card: str) -> None:
    """--sparse: at the flagship shape, AH' for each doc block of
    DOC_BLOCKS; MU with its products through ell_spmm and through
    torch.sparse.mm, alternating; one MU and one BPP run under
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from smallk_torch import NmfAlgorithm, NmfOptions, NmfStats
    from smallk_torch.engines.nmf import run_nmf
    from smallk_torch.ops.ell import EllAOp
    from smallk_torch.solvers.solve import nmf_solve

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
    vals = torch.from_numpy(A.data.astype(np.float32)).to(
        torch.bfloat16).float()
    at_csr = torch.sparse_csr_tensor(
        torch.from_numpy(A.indptr.astype(np.int64)),
        torch.from_numpy(A.indices.astype(np.int64)), vals,
        (FLAG_N, FLAG_M)).cuda()
    a_csr = at_csr.to_sparse_coo().t().coalesce().to_sparse_csr()
    del A, vals

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

    # the solve loop alone, on factors already on the card; BPP first, so
    # that the profiler's start-up lands in its 30 s window, not in MU's
    W, H = torch.from_numpy(W0).cuda(), torch.from_numpy(H0).cuda()
    for alg, it in (("BPP", 1), ("MU", hi)):
        opts = dataclasses.replace(mu, algorithm=NmfAlgorithm(alg),
                                   max_iter=it)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            nmf_solve(op, W, H, opts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        profile_summary(prof, wall, f"flagship nmf_solve {alg}, {it} "
                        "iteration(s)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
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
    if sys.argv[1:] == ["--sparse"]:
        timed("sparse study", sparse_study, card)
        log("[time] " + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
        return 0
    k1 = timed("K1", phase_kernel)
    k2 = timed("K2", phase_k2)
    k3 = timed("K3", phase_k3)
    ell = timed("ell_spmm", phase_ell_spmm)
    timed("slice", phase_slice_parity)
    timed("sparse parity", phase_sparse_parity)
    main_path = timed("main", phase_main_path, card)
    flat_path = timed("flatclust", phase_flatclust, card)
    timed("beside", phase_beside, card)
    timed("hier parity", phase_hier_parity)
    hier_path = timed("hierclust", phase_hierclust, card)
    flagship = timed("flagship", phase_flagship, card)
    with ThreadPoolExecutor(4) as pool:  # the CLI processes side by side
        t0 = time.perf_counter()
        for job in [pool.submit(phase_cli), pool.submit(phase_flat_cli),
                    pool.submit(phase_hier_cli), pool.submit(phase_sparse_cli)]:
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
    } for probe in ELL_PROBES]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
