"""NMF engine facade — port of smallk_tpu/engines/nmf.py.

`run_nmf` resolves A into an operand on the given device, validates the
shapes, runs the solve loop and returns host factors.  The reference's
relay dispatch budget (segmented solves under a device watchdog) is not
ported: a CUDA device has no execution watchdog.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..common.device import setup, torch_dtype
from ..common.options import NmfOptions, NmfStats
from ..ops.aop import as_aop
from ..solvers.solve import nmf_solve

_initialized = False


def initialize() -> None:
    """API-parity shim for NmfInitialize (PyTorch needs no runtime boot)."""
    global _initialized
    _initialized = True


def finalize() -> None:
    global _initialized
    _initialized = False


def is_initialized() -> bool:
    return _initialized


def run_nmf(A, W0: np.ndarray, H0: np.ndarray, opts: NmfOptions,
            stats: Optional[NmfStats] = None, *, device="cuda"):
    """Factor A ~= W H on `device` ("cuda", "cuda:1", "cpu"; the card
    unless the caller asks for the CPU).

    A: ndarray (dense), scipy sparse, or a prebuilt operand.
    W0/H0: host initializer arrays (m x k, k x n).
    Returns (W, H, success) as host arrays; fills `stats` if given.
    """
    opts.validate()
    dev = setup(device)
    dtype = torch_dtype(opts.dtype)

    a_op = as_aop(A, dtype=opts.a_dtype or opts.dtype, device=dev)
    m, n = a_op.shape
    if (m, n) != (opts.height, opts.width):
        raise ValueError(
            f"nmf: matrix is {m}x{n} but options say "
            f"{opts.height}x{opts.width}"
        )
    if W0.shape != (m, opts.k):
        raise ValueError(f"nmf: W initializer must be {m}x{opts.k}")
    if H0.shape != (opts.k, n):
        raise ValueError(f"nmf: H initializer must be {opts.k}x{n}")

    W_dev = torch.from_numpy(np.ascontiguousarray(W0)).to(dtype).to(dev)
    H_dev = torch.from_numpy(np.ascontiguousarray(H0)).to(dtype).to(dev)

    t0 = time.perf_counter()
    result = nmf_solve(a_op, W_dev, H_dev, opts)
    W = result.W.cpu().numpy()
    H = result.H.cpu().numpy()
    elapsed = time.perf_counter() - t0

    if stats is not None:
        stats.elapsed_us = int(elapsed * 1e6)
        stats.iteration_count = int(result.iterations)
        stats.pivot_rounds = int(result.pivot_rounds)

    return W, H, bool(result.success)
