"""Clustering quality scoring: NMI and F1 against ground truth.

The reference publishes no in-repo scoring code — quality on the dblp15
community-detection dataset is the north-star metric (reference README.md:
9-27 describes the dataset; BASELINE.json: "match ... dblp15 NMI/F1 within
run-to-run variance").  This module provides the scoring harness.

Works with either label vectors (hard assignments, -1 = unassigned) or
membership matrices (n x k indicator/weight matrices, e.g. the reference's
dblp15_ground_truth.mtx layout).

The port's own copy of smallk_tpu/engines/scoring.py, byte-equal in what it
returns and writes.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def _contingency(labels_a: np.ndarray, labels_b: np.ndarray):
    """Joint count matrix over the two labelings (ignores negatives)."""
    mask = (labels_a >= 0) & (labels_b >= 0)
    a = labels_a[mask]
    b = labels_b[mask]
    ka = int(a.max()) + 1 if a.size else 0
    kb = int(b.max()) + 1 if b.size else 0
    C = np.zeros((ka, kb), dtype=np.int64)
    np.add.at(C, (a, b), 1)
    return C


def nmi(labels_a, labels_b) -> float:
    """Normalized mutual information (arithmetic normalization)."""
    labels_a = np.asarray(labels_a, dtype=np.int64)
    labels_b = np.asarray(labels_b, dtype=np.int64)
    C = _contingency(labels_a, labels_b)
    n = C.sum()
    if n == 0:
        return 0.0
    pij = C / n
    pi = pij.sum(axis=1, keepdims=True)
    pj = pij.sum(axis=0, keepdims=True)
    nz = pij > 0
    mi = float((pij[nz] * np.log(pij[nz] / (pi @ pj)[nz])).sum())

    def entropy(p):
        p = p[p > 0]
        return float(-(p * np.log(p)).sum())

    ha, hb = entropy(pi.ravel()), entropy(pj.ravel())
    denom = 0.5 * (ha + hb)
    return mi / denom if denom > 0 else 0.0


def pairwise_f1(labels_a, labels_b) -> float:
    """Pairwise F1: precision/recall over same-cluster node pairs."""
    labels_a = np.asarray(labels_a, dtype=np.int64)
    labels_b = np.asarray(labels_b, dtype=np.int64)
    C = _contingency(labels_a, labels_b).astype(np.float64)

    def pairs(x):
        return (x * (x - 1) / 2).sum()

    tp = pairs(C)
    pairs_a = pairs(C.sum(axis=1))
    pairs_b = pairs(C.sum(axis=0))
    if pairs_a == 0 or pairs_b == 0:
        return 0.0
    precision = tp / pairs_b
    recall = tp / pairs_a
    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


def best_match_f1(labels_pred, labels_true) -> float:
    """Average best-match F1: for each true community, the best F1 over
    predicted clusters, weighted by community size (and symmetrized)."""
    labels_pred = np.asarray(labels_pred, dtype=np.int64)
    labels_true = np.asarray(labels_true, dtype=np.int64)
    C = _contingency(labels_true, labels_pred).astype(np.float64)
    if C.size == 0:
        return 0.0
    sizes_t = C.sum(axis=1)  # true community sizes
    sizes_p = C.sum(axis=0)  # predicted cluster sizes

    with np.errstate(divide="ignore", invalid="ignore"):
        prec = C / sizes_p[None, :]
        rec = C / sizes_t[:, None]
        f1 = np.where(prec + rec > 0, 2 * prec * rec / (prec + rec), 0.0)

    # symmetrized weighted average (Yang-Leskovec style)
    s1 = (sizes_t * f1.max(axis=1)).sum() / sizes_t.sum()
    s2 = (sizes_p * f1.max(axis=0)).sum() / sizes_p.sum()
    return 0.5 * (s1 + s2)


def membership_to_labels(M) -> np.ndarray:
    """(n x k) membership matrix -> label vector by per-row argmax; empty
    rows map to -1.  Handles the ground-truth .mtx indicator layout."""
    if sp.issparse(M):
        M = M.tocsr()
        labels = np.full(M.shape[0], -1, dtype=np.int64)
        nz = np.diff(M.indptr) > 0
        dense_rows = np.asarray(M[nz].toarray())
        labels[nz] = np.argmax(dense_rows, axis=1)
        return labels
    M = np.asarray(M)
    labels = np.where(M.sum(axis=1) > 0, np.argmax(M, axis=1), -1)
    return labels.astype(np.int64)


def score_clustering(labels_pred, ground_truth) -> dict:
    """Full report: NMI, pairwise F1, best-match F1.

    ground_truth: label vector or (n x k) membership matrix.
    """
    gt = np.asarray(ground_truth) if not sp.issparse(ground_truth) else (
        ground_truth
    )
    if sp.issparse(gt) or (
        isinstance(gt, np.ndarray) and gt.ndim == 2
    ):
        gt = membership_to_labels(gt)
    labels_pred = np.asarray(labels_pred, dtype=np.int64)
    return {
        "nmi": nmi(labels_pred, gt),
        "pairwise_f1": pairwise_f1(labels_pred, gt),
        "best_match_f1": best_match_f1(labels_pred, gt),
    }
