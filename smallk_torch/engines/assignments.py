"""Cluster assignments from the H factor.

Reference: common/include/assignments.hpp
  - ComputeAssignments (:58-113): per-column argmax of H
  - ComputeFuzzyAssignments (:17-56): column-normalized H as probabilities

The port's own copy of smallk_tpu/engines/assignments.py, byte-equal in what it
returns and writes.
"""

from __future__ import annotations

import numpy as np


def compute_assignments(H: np.ndarray) -> np.ndarray:
    """Per-column argmax of H -> int labels (n,)."""
    return np.argmax(H, axis=0).astype(np.int32)


def compute_fuzzy_assignments(H: np.ndarray) -> np.ndarray:
    """Column-normalized H: probability of each cluster per column (k, n)."""
    sums = H.sum(axis=0, keepdims=True)
    sums = np.where(sums == 0, 1.0, sums)
    return H / sums


def top_terms(w_col: np.ndarray, maxterms: int) -> np.ndarray:
    """Indices of the `maxterms` largest entries, descending.

    Reference: TopTerms (common/include/terms.hpp:11-60).  Ties broken by
    lower index first (stable sort on negated values).
    """
    order = np.argsort(-w_col, kind="stable")
    return order[:maxterms].astype(np.int32)


def top_terms_matrix(W: np.ndarray, maxterms: int) -> np.ndarray:
    """Top terms for every column of W: (maxterms, k) row-index matrix."""
    order = np.argsort(-W, axis=0, kind="stable")
    return order[:maxterms, :].astype(np.int32)
