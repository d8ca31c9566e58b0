#!/usr/bin/env python3
"""Smoke run of the PyTorch port (smallk_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, library NMF-BPP, through its user entry
points on the card and fails (nonzero exit, no result line) on any fault:

  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles the CUDA kernels from smallk_torch/csrc/;
  3. the masked Gauss-Jordan kernel against its plain torch version on the
     card, f32 and f64, at the main path's shapes and up to k = 128, plus
     the dead-pivot case; kernel and plain times at the main path's shapes;
  4. slice parity in f64: run_nmf on the card against the same call on the
     CPU (plain versions throughout);
  5. the main path at full width: the 12411 x 7984 Reuters shape, 80 nnz
     per column, k = 8, bf16 A, f32 factors, 100 fixed iterations, with
     the kernel's launches counted over that run;
  6. the nmf CLI as a subprocess;
  7. the kernel table as one JSON line, the card line, and last the result
     line {"ok": true, "device": {...}}.

There is no CPU fallback: without a card the script exits 1.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
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


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, iters: int) -> float:
    """Device time of one fn() call in ms, with the host out of the way.

    fn is captured once in a CUDA graph, so a call is one launch however
    many kernels it runs; `iters` replays are queued behind a sleep kernel,
    and the events around them time the device alone.  The run fails if
    the sleep ended before the last replay was queued.
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
    sleep_s = back_to_back_ms(graph.replay, iters) * iters / 1e3 * 2 + 0.01
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
    path = _build.build("masked_gj")
    _build.load_library("masked_gj")
    secs = time.perf_counter() - t0
    log(f"[build] {path.relative_to(ROOT)} in {secs:.2f} s")


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
        times[(k, n)] = (ms, plain)
        log(f"[K1 time f32] k={k} n={n}: device ms per call: kernel "
            f"{ms:.4f}, plain {plain:.4f}; back-to-back with host launch "
            f"cost: kernel {ms_host:.4f}, plain {plain_host:.4f}")
    return {"max_abs_err": worst, "times": times}


def phase_slice_parity() -> None:
    from smallk_torch import NmfOptions, NmfStats, Random, random_matrix
    from smallk_torch.engines.nmf import run_nmf
    from smallk_torch.kernels import masked_gj

    m, n, k = 300, 200, 8
    rng = Random(7)
    A = rng.uniform((m, n))
    W0 = random_matrix(m, k, rng)
    H0 = random_matrix(k, n, rng)
    opts = NmfOptions(tol=1e-30, height=m, width=n, k=k, min_iter=1,
                      max_iter=30, verbose=False, dtype="float64")
    runs = {}
    for device in ("cuda", "cpu"):
        stats = NmfStats()
        before = masked_gj.launches
        W, H, ok = run_nmf(A, W0, H0, opts, stats, device=device)
        runs[device] = (W, H, ok, stats, masked_gj.launches - before)
    (Wc, Hc, okc, sc, lc), (Wh, Hh, okh, sh, lh) = runs["cuda"], runs["cpu"]
    dW, dH = float(np.abs(Wc - Wh).max()), float(np.abs(Hc - Hh).max())
    log(f"[slice f64] run_nmf {m}x{n} k={k}: cuda vs cpu max|dW| = {dW:.3e}, "
        f"max|dH| = {dH:.3e}, iterations {sc.iteration_count}/"
        f"{sh.iteration_count}, pivot rounds {sc.pivot_rounds}/"
        f"{sh.pivot_rounds}, kernel launches {lc}/{lh}")
    np.testing.assert_allclose(Wc, Wh, rtol=0, atol=SLICE_ATOL)
    np.testing.assert_allclose(Hc, Hh, rtol=0, atol=SLICE_ATOL)
    if not (okc and okh and okc == okh):
        raise AssertionError(f"slice run success cuda={okc} cpu={okh}")
    if (sc.iteration_count, sc.pivot_rounds) != (sh.iteration_count,
                                                 sh.pivot_rounds):
        raise AssertionError("slice runs differ in iterations or rounds")
    if lc < 2 * sc.iteration_count or lh != 0:
        raise AssertionError(f"kernel launches: cuda {lc}, cpu {lh}")


def phase_main_path(card: str) -> dict:
    import torch

    from smallk_torch import (NmfAlgorithm, NmfOptions, NmfStats, Random,
                              random_matrix, random_sparse_matrix)
    from smallk_torch.engines.nmf import run_nmf
    from smallk_torch.kernels import masked_gj
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
    masked_gj.launches = 0
    t0 = time.perf_counter()
    W, H, ok = run_nmf(A, W0, H0, opts, stats, device="cuda")
    wall = time.perf_counter() - t0
    launches = masked_gj.launches

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
    return {"launches": launches, "it_per_s": its}


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from smallk_torch.common.device import setup
    from smallk_torch.kernels import masked_gj

    setup("cuda")
    card = card_line()
    log(f"[device] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    phase_build()
    k1 = phase_kernel()
    phase_slice_parity()
    main_path = phase_main_path(card)
    phase_cli()

    ms, plain_ms = k1["times"][MAIN_SHAPES[-1]]
    print(json.dumps({"kernels": [{
        "name": "masked_gj_solve",
        "route": "cuda",
        "source": masked_gj.SOURCE,
        "replaces": masked_gj.REPLACES,
        "launches": main_path["launches"],
        "max_abs_err": k1["max_abs_err"],
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
