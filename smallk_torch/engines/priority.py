"""Node priority scoring for hierarchical clustering (modified NDCG) —
port of smallk_tpu/engines/priority.py.

Reference: hierclust/include/clust_hier_util.hpp
  - compute_priority (:105-173): score a candidate split by comparing the
    parent topic vector's term ranking against both children's rankings,
    log-discounted (NDCG-style).  Returns -3 when the parent has <= 1
    nonzero terms.
  - NDCG_part (:62-99).

Two implementations with identical semantics:
  - compute_priority: host numpy f64, a copy of the JAX package's
    transcription (used by the initdir path and as the parity oracle);
  - compute_priority_device: torch on W's device, so a split is scored
    without copying W to the host.  Stable descending argsorts keep the
    reference's tie rule (lower index first); the sentinel -3 comes back
    exactly.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _desc_ordered(values: np.ndarray) -> np.ndarray:
    """Indices sorting values descending, ties by lower index first
    (reference desc_ordered, clust_hier_util.hpp:46-57)."""
    # stable sort on negated values preserves index order within ties
    return np.argsort(-values, kind="stable")


def _inverse_permutation(p: np.ndarray) -> np.ndarray:
    inv = np.empty_like(p)
    inv[p] = np.arange(len(p))
    return inv


def _ndcg_part(ground: np.ndarray, test: np.ndarray, weight: np.ndarray,
               weight_part: np.ndarray) -> float:
    """Reference NDCG_part (clust_hier_util.hpp:62-99).

    ground/test: permutations (rank -> term index).
    weight/weight_part: per-parent-rank weights.
    """
    n = len(test)
    # per-term weight: weight_part at the parent rank of each term
    seq_idx = _inverse_permutation(ground)  # term -> parent rank
    temp_weight_part = weight_part[seq_idx]  # per-term

    uncum = temp_weight_part[test].astype(np.float64)
    i = np.arange(n)
    disc = np.ones(n)
    disc[1:] = np.log2(i[1:] + 1)
    uncum = uncum / disc
    cum_score = np.cumsum(uncum)

    ideal = np.sort(weight)[::-1].astype(np.float64)
    ideal = ideal / disc
    cum_ideal = np.cumsum(ideal)

    return float(cum_score[-1] / cum_ideal[-1])


def compute_priority(w_parent: np.ndarray, w_child: np.ndarray) -> float:
    """Score a split of the node with topic vector `w_parent` (m,) into the
    two children given by the columns of `w_child` (m, 2).

    Reference: compute_priority (clust_hier_util.hpp:105-173).
    """
    w_parent = np.asarray(w_parent).reshape(-1)
    n = len(w_parent)
    n_part = int(np.count_nonzero(w_parent))
    if n_part <= 1:
        return -3.0

    idx_parent = _desc_ordered(w_parent)
    idx_child1 = _desc_ordered(np.asarray(w_child[:, 0]).reshape(-1))
    idx_child2 = _desc_ordered(np.asarray(w_child[:, 1]).reshape(-1))

    # weight[i] = log(n - i); positions at/after the first zero-parent-value
    # rank get weight 1
    weight = np.log(np.arange(n, 0, -1).astype(np.float64))
    sorted_parent_vals = w_parent[idx_parent]
    zeros = np.where(sorted_parent_vals == 0)[0]
    if len(zeros) > 0:
        weight[zeros[0]:] = 1.0

    weight_part = np.zeros(n)
    weight_part[:n_part] = np.log(
        np.arange(n_part, 0, -1).astype(np.float64)
    )

    # per-term worst rank across the two children
    rank1 = _inverse_permutation(idx_child1)
    rank2 = _inverse_permutation(idx_child2)
    max_pos = np.maximum(rank1, rank2)

    discount = np.log((n - max_pos[idx_parent]).astype(np.float64))
    discount[discount == 0] = np.log(2.0)
    weight = weight / discount
    weight_part = weight_part / discount

    return (
        _ndcg_part(idx_parent, idx_child1, weight, weight_part)
        * _ndcg_part(idx_parent, idx_child2, weight, weight_part)
    )


def _desc_order(x):
    """Stable descending argsort, ties by lower index; `+ 0.0` folds -0.0
    into +0.0 so that the two zeros tie, as they do in the reference."""
    return torch.argsort(x + 0.0, descending=True, stable=True)


def _inverse(p, i):
    """The inverse of permutation `p` (rank -> index): index -> rank."""
    return torch.empty_like(p).scatter_(0, p, i)


def compute_priority_device(w_parent, w_child):
    """torch transcription of compute_priority on the tensors' device: a
    0-d tensor in w_parent's float dtype.

    Only the totals of the reference's cumulative NDCG scores are used
    (cum_score[-1] == sum), so the device version skips the cumsums, as
    the JAX package's does (priority.py:107-167).
    """
    w_parent = w_parent.reshape(-1)
    n = w_parent.shape[0]
    fl, dev = w_parent.dtype, w_parent.device
    i = torch.arange(n, device=dev)

    n_part = torch.count_nonzero(w_parent)
    idx_parent = _desc_order(w_parent)
    idx_c1 = _desc_order(w_child[:, 0])
    idx_c2 = _desc_order(w_child[:, 1])

    # weight[i] = log(n - i); ranks at/after the first zero parent value
    # get weight 1 (topic vectors are nonnegative, so "first zero onward"
    # is a cumulative condition on the descending sort)
    weight = torch.log((n - i).to(fl))
    sorted_vals = w_parent[idx_parent]
    zero_seen = torch.cumsum((sorted_vals == 0).to(torch.int32), 0) > 0
    weight = torch.where(zero_seen, 1.0, weight)
    weight_part = torch.where(
        i < n_part, torch.log(torch.clamp(n_part - i, min=1).to(fl)), 0.0)

    # per-term worst rank across the two children
    max_pos = torch.maximum(_inverse(idx_c1, i), _inverse(idx_c2, i))
    discount = torch.log((n - max_pos[idx_parent]).to(fl))
    discount = torch.where(discount == 0, math.log(2.0), discount)
    weight = weight / discount
    weight_part = weight_part / discount

    # NDCG_part totals (clust_hier_util.hpp:62-99)
    temp_wp = weight_part[_inverse(idx_parent, i)]
    disc = torch.where(i >= 1, torch.log2((i + 1).to(fl)), 1.0)
    ideal_sum = torch.sum(torch.sort(weight, descending=True).values / disc)

    def part(test):
        return torch.sum(temp_wp[test] / disc) / ideal_sum

    pr = part(idx_c1) * part(idx_c2)
    return torch.where(n_part <= 1, -3.0, pr)
