"""Graph community-detection workflow helpers.

The reference has no graph-specific code — its dblp15 community-recovery
workflow (reference README.md:9-27) runs hierclust on the adjacency
matrix as a generic sparse operand.  What the reference DOES prescribe
for every operand is its preprocessing normalization: term-doc matrices
get tf-idf row weighting + unit-L2 columns before clustering
(preprocessor/src/preprocess.cpp:193-230).  This module provides the
graph analogue of that step plus the recommended engine options.

Why normalization decides recovery quality: on a raw 0/1 adjacency the
rank-2 NMF objective is dominated by high-degree vertices, and on
near-regular planted-partition graphs its local optima are frequently
community-misaligned (measured: median NMI 0.13-0.60 over seeds
depending on priority/restart options).  The symmetric degree
normalization D^-1/2 A D^-1/2 re-weights edges so the dominant
singular subspace aligns with the partition (the spectral-clustering
normalization); with it the same engine recovers median NMI ~0.9 on the
same graphs — the full ablation lives in ROUND_NOTES.md (round 3).

The port's own copy of smallk_tpu/engines/graph.py, byte-equal in what it
returns and writes.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def normalized_adjacency(A, kind: str = "sym"):
    """Degree-normalize a (sparse or dense) adjacency matrix.

    kind="sym": D^-1/2 A D^-1/2  (symmetric / spectral normalization —
                the default; keeps the operand symmetric)
    kind="rw":  D^-1 A           (random-walk / column-stochastic-like)

    Zero-degree vertices are left untouched (divide by 1).
    """
    if kind not in ("sym", "rw"):
        raise ValueError("normalized_adjacency: kind must be 'sym' or 'rw'")
    if sp.issparse(A):
        deg = np.asarray(A.sum(axis=1)).ravel()
    else:
        A = sp.csr_matrix(np.asarray(A))
        deg = np.asarray(A.sum(axis=1)).ravel()
    deg = np.maximum(deg, 1.0)
    if kind == "sym":
        dinv = sp.diags(1.0 / np.sqrt(deg))
        return (dinv @ A @ dinv).tocsc()
    return (sp.diags(1.0 / deg) @ A).tocsc()


def graph_clust_options(num_clusters: int, **overrides):
    """ClustOptions preset for community detection on graph adjacency.

    Differences from the text defaults, each measured on planted-partition
    graphs (scripts/probe_nmi*.py, ROUND_NOTES.md round 3):
      - priority_method="size_ndcg": NDCG is term-ranking coherence —
        near-noise on adjacency columns — and a pure-NDCG pop can starve
        a half-corpus leaf while re-splitting slivers (NMI 0.12).
      - restarts=3: rank-2 NMF on spectrally degenerate operands is a
        seed lottery; best-of-3 by reconstruction objective stabilizes
        split quality (runs batched in one device program).
      - on_node_failure="leaf": graphs routinely contain duplicate-
        neighborhood node groups that no rank-2 solve can split
        (structurally singular systems on every retry); such nodes
        become permanent leaves instead of aborting the run.

    Feed the operand through `normalized_adjacency` first.
    """
    from ..common.options import (
        ClustOptions, NmfAlgorithm, NmfOptions, NmfProgressAlgorithm,
    )

    nmf_opts = overrides.pop("nmf_opts", None) or NmfOptions(
        tol=1e-4, algorithm=NmfAlgorithm.RANK2,
        prog_est_algorithm=NmfProgressAlgorithm.PG_RATIO, k=2,
        min_iter=1, max_iter=5000, verbose=False, dtype="float32",
        stall_patience=100,
    )
    kw = dict(
        nmf_opts=nmf_opts, num_clusters=num_clusters, verbose=False,
        priority_method="size_ndcg", restarts=3,
        on_node_failure="leaf",
    )
    kw.update(overrides)
    return ClustOptions(**kw)
