"""Checkpoint / resume for long factorizations and hierclust runs.

The reference has no checkpointing (SURVEY.md §5.4): the closest hooks are
resume-by-initializer (--infile_W/--infile_H) and unused RNG state
accessors.  This module adds preemption-safe checkpointing: checkpoint =
(W, H, iteration, RNG state, options fingerprint), and for hierclust
additionally the serialized tree.

Format: a single .npz per checkpoint (atomic rename), host-side.  The
port's copy of smallk_tpu/common/checkpoint.py, the same files byte for
byte; the reference's segmented solve driver (run_nmf_with_checkpointing)
is not carried over.
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
