"""Checkpoint / resume for long factorizations and hierclust runs.

The reference has no checkpointing (SURVEY.md §5.4): the closest hooks are
resume-by-initializer (--infile_W/--infile_H) and unused RNG state
accessors.  This module adds preemption-safe checkpointing: checkpoint =
(W, H, iteration, RNG state, options fingerprint), and for hierclust
additionally the serialized tree.

Format: a single .npz per checkpoint (atomic rename), host-side.  The
port's copy of smallk_tpu/common/checkpoint.py, the same files byte for
byte, so either package reads the other's checkpoints; the segmented solve
driver, `run_nmf_with_checkpointing`, runs the port's solve on `device`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import tempfile

import numpy as np

from .options import NmfOptions
from .rng import Random

FORMAT_VERSION = 1


def atomic_savez(path: str, payload: dict, suffix=".ckpt.tmp") -> None:
    """Write an .npz atomically: tempfile in the target dir + rename, so
    a preemption mid-write never leaves a torn checkpoint behind."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=suffix)
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _options_fingerprint(opts: NmfOptions) -> str:
    d = dataclasses.asdict(opts)
    for key, val in d.items():
        if hasattr(val, "value"):
            d[key] = val.value
    return json.dumps(d, sort_keys=True, default=str)


def save_nmf_checkpoint(
    path: str,
    W: np.ndarray,
    H: np.ndarray,
    iteration: int,
    rng: Random | None = None,
    opts: NmfOptions | None = None,
) -> None:
    """Atomically write an NMF checkpoint."""
    payload = {
        "format_version": FORMAT_VERSION,
        "W": np.asarray(W),
        "H": np.asarray(H),
        "iteration": np.int64(iteration),
    }
    if opts is not None:
        payload["opts_fingerprint"] = np.frombuffer(
            _options_fingerprint(opts).encode(), dtype=np.uint8
        )
    if rng is not None:
        payload["rng_state"] = np.frombuffer(
            pickle.dumps(rng.get_state()), dtype=np.uint8
        )
    atomic_savez(path, payload)


def load_nmf_checkpoint(path: str, opts: NmfOptions | None = None):
    """Load a checkpoint.  Returns dict with W, H, iteration, rng (or None).

    If `opts` is given, raises ValueError when the checkpoint was written
    with different options (shape/algorithm mismatch guard).
    """
    with np.load(path, allow_pickle=False) as z:
        if int(z["format_version"]) != FORMAT_VERSION:
            raise ValueError("unsupported checkpoint format")
        out = {
            "W": z["W"],
            "H": z["H"],
            "iteration": int(z["iteration"]),
            "rng": None,
        }
        if opts is not None and "opts_fingerprint" in z:
            saved = bytes(z["opts_fingerprint"]).decode()
            if saved != _options_fingerprint(opts):
                raise ValueError(
                    "checkpoint was written with different options"
                )
        if "rng_state" in z:
            rng = Random(0)
            rng.set_state(pickle.loads(bytes(z["rng_state"])))
            out["rng"] = rng
    return out


def run_nmf_with_checkpointing(
    A,
    W0: np.ndarray,
    H0: np.ndarray,
    opts: NmfOptions,
    checkpoint_path: str,
    checkpoint_every: int = 100,
    resume: bool = True,
    *,
    device="cuda",
):
    """Chunked NMF driver with periodic checkpoints, on `device` (the card
    unless the caller asks for the CPU; a prebuilt operand keeps its own).

    Runs the solve loop in segments of `checkpoint_every` iterations,
    writing a checkpoint after each segment; on restart with resume=True
    it continues from the last checkpoint, and one written at max_iter
    returns without solving.  Convergence semantics match a single long
    run for PG_RATIO up to the min_iter warm-up of the first segment (the
    pg0 anchor is recomputed per segment for later segments, a strictly
    more conservative criterion).

    Returns (W, H, total_iterations, success), W and H host arrays.
    """
    import torch

    from ..ops.aop import as_aop
    from ..solvers.solve import nmf_solve
    from .device import setup, torch_dtype

    start_iter = 0
    W_cur, H_cur = np.asarray(W0), np.asarray(H0)
    if resume and os.path.exists(checkpoint_path):
        ck = load_nmf_checkpoint(checkpoint_path, opts)
        W_cur, H_cur = ck["W"], ck["H"]
        start_iter = ck["iteration"]

    dtype = torch_dtype(opts.dtype)
    a_op = as_aop(A, dtype=dtype, device=device)
    dev = setup(a_op.device)

    def on_device(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dtype).to(dev)

    total = start_iter
    success = True
    while total < opts.max_iter:
        seg = min(checkpoint_every, opts.max_iter - total)
        seg_opts = dataclasses.replace(
            opts, max_iter=seg, min_iter=min(opts.min_iter, seg)
        )
        res = nmf_solve(a_op, on_device(W_cur), on_device(H_cur), seg_opts)
        W_cur = res.W.cpu().numpy()
        H_cur = res.H.cpu().numpy()
        total += int(res.iterations)
        success = bool(res.success)
        save_nmf_checkpoint(checkpoint_path, W_cur, H_cur, total, opts=opts)
        if bool(res.converged) or not success:
            break
    return W_cur, H_cur, total, success
