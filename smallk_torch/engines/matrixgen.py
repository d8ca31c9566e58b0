"""Matrix generation engine.

Reference: matrixgen/src/main.cpp:49-116 (seven generator types) and
common/include/matrix_generator.hpp (RandomMatrix / RandomSparseMatrix).
Generator type names/semantics follow the reference CLI docs
(sphinx/source/pages_commandLineTools.rst:168-175).

The port's own copy of smallk_tpu/engines/matrixgen.py, byte-equal in what it
returns and writes.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..common.rng import Random, random_matrix

GENERATOR_TYPES = (
    "UNIFORM",
    "DENSE_DIAG",
    "SPARSE_DIAG",
    "IDENTITY",
    "ONES",
    "ZEROS",
    "SPARSE",
)


def generate(
    height: int,
    width: int,
    kind: str = "UNIFORM",
    rng: Random | None = None,
    center: float = 0.5,
    radius: float = 0.5,
    nz_per_col: int = 1,
    dtype=np.float64,
):
    """Generate a matrix of the requested type.

    Returns an ndarray for dense types, scipy CSC for sparse types.
    """
    kind = kind.upper()
    if kind not in GENERATOR_TYPES:
        raise ValueError(f"matrixgen: unknown type {kind!r}")
    rng = rng or Random()

    if kind == "UNIFORM":
        return random_matrix(height, width, rng, center, radius, dtype)
    if kind == "DENSE_DIAG":
        d = min(height, width)
        out = np.zeros((height, width), dtype=dtype)
        out[np.arange(d), np.arange(d)] = rng.uniform(d, center, radius, dtype)
        return out
    if kind == "SPARSE_DIAG":
        d = min(height, width)
        vals = rng.uniform(d, center, radius, dtype)
        return sp.csc_matrix(
            (vals, (np.arange(d), np.arange(d))), shape=(height, width), dtype=dtype
        )
    if kind == "IDENTITY":
        out = np.zeros((height, width), dtype=dtype)
        d = min(height, width)
        out[np.arange(d), np.arange(d)] = 1.0
        return out
    if kind == "ONES":
        return np.ones((height, width), dtype=dtype)
    if kind == "ZEROS":
        return np.zeros((height, width), dtype=dtype)

    # SPARSE: nz_per_col random nonzeros in each column.  Drawn from the
    # live engine stream — the reference's RandomSparseMatrix advances the
    # ongoing Random engine (sparse_matrix_ops.hpp:317), so two calls on
    # the same Random instance must produce different matrices.
    nz_per_col = max(1, min(int(nz_per_col), height))
    cols = np.repeat(np.arange(width, dtype=np.int64), nz_per_col)

    if nz_per_col * 2 >= height:
        # dense-ish columns: per-column sampling without replacement (the
        # rejection sampler below would coupon-collector crawl here)
        rows = np.empty(nz_per_col * width, dtype=np.int64)
        for c in range(width):
            rows[c * nz_per_col:(c + 1) * nz_per_col] = rng.choice(
                height, size=nz_per_col, replace=False
            )
    else:
        # Vectorized rejection sampling: draw all row indices at once,
        # then redraw intra-column duplicates until none remain.  This is
        # the reference's own algorithm (RandomSparseMatrix inserts
        # `rand() % height` and retries on collision,
        # sparse_matrix_ops.hpp:317-355) done in whole-matrix passes —
        # the per-column `choice(height, ..., replace=False)` it replaces
        # builds an O(height) permutation per column (877 s for a
        # 50k x 1M / 80M-nnz corpus; this path: ~10 s).
        rows2d = rng._rs.randint(0, height, size=(width, nz_per_col))
        active = np.arange(width)  # columns still possibly holding dups
        while active.size:
            sub = rows2d[active]
            order = np.argsort(sub, axis=1, kind="stable")
            srt = np.take_along_axis(sub, order, axis=1)
            dup_sorted = np.zeros_like(srt, dtype=bool)
            dup_sorted[:, 1:] = srt[:, 1:] == srt[:, :-1]
            bad = dup_sorted.any(axis=1)
            if not bad.any():
                break
            # stable argsort keeps the first original occurrence; only
            # later duplicates are redrawn (from the live stream, so
            # determinism under the seed is preserved)
            dup = np.zeros_like(dup_sorted)
            np.put_along_axis(dup, order, dup_sorted, axis=1)
            sub[dup] = rng._rs.randint(0, height, size=int(dup.sum()))
            rows2d[active] = sub
            active = active[bad]  # later passes touch offenders only
        rows = rows2d.reshape(-1)

    vals = rng.uniform(nz_per_col * width, center, radius, dtype)
    return sp.csc_matrix((vals, (rows, cols)), shape=(height, width), dtype=dtype)


def random_sparse_matrix(
    rng: Random,
    height: int,
    width: int,
    nz_per_col: int,
    dtype=np.float64,
) -> sp.csc_matrix:
    """Library-level random sparse generator (reference RandomSparseMatrix)."""
    return generate(
        height, width, "SPARSE", rng=rng, nz_per_col=nz_per_col, dtype=dtype
    )
