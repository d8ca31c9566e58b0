"""Flat clustering by direct NMF — port of smallk_tpu/engines/flatclust.py.

`run_flatclust` factors A with HALS, RANK2 or BPP (the reference excludes
MU) through `run_nmf`, then derives the argmax assignments and the fuzzy
(column-normalized) assignments from H.
`write_flatclust_results` writes the reference's result files.  Both sit
on the reference package's numpy-only `engines.assignments` and
`io.writers`.

Not ported here: the sharded solve (`mesh`, ROADMAP slice 15) and
`run_hier_nmf2`, which needs hierclust (slice 9).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from smallk_tpu.common.options import (
    NmfAlgorithm,
    NmfOptions,
    NmfStats,
    OutputFormat,
)
from smallk_tpu.engines.assignments import (
    compute_assignments,
    compute_fuzzy_assignments,
    top_terms_matrix,
)
from smallk_tpu.io.writers import make_flatclust_writer

from .nmf import run_nmf

_FLATCLUST_ALGORITHMS = (
    NmfAlgorithm.HALS, NmfAlgorithm.RANK2, NmfAlgorithm.BPP
)


def run_flatclust(A, W0: np.ndarray, H0: np.ndarray, opts: NmfOptions,
                  stats: Optional[NmfStats] = None, *, device):
    """Factor A on `device` ("cuda", "cuda:1", "cpu") and derive the flat
    clustering.

    Returns (W, H, assignments, fuzzy, success) as host arrays; top terms
    are derived by the caller via assignments.top_terms_matrix(W, maxterms).
    """
    if opts.algorithm not in _FLATCLUST_ALGORITHMS:
        raise ValueError(
            "flatclust: algorithm must be HALS, RANK2, or BPP "
            "(reference flat_clust.cpp:38-70 excludes MU)"
        )
    W, H, ok = run_nmf(A, W0, H0, opts, stats, device=device)
    assignments = compute_assignments(H)
    fuzzy = compute_fuzzy_assignments(H).astype(np.float32)
    return W, H, assignments, fuzzy, ok


def write_flatclust_results(
    outdir: str,
    assignments: np.ndarray,
    fuzzy: np.ndarray,
    W: np.ndarray,
    dictionary,
    maxterms: int,
    fmt: OutputFormat,
    num_clusters: int,
    assignments_prefix: str = "assignments_",
):
    """Write clusters_N.{xml,json}, <prefix>N.csv and assignments_fuzzy_N.csv,
    byte for byte as the reference package writes them."""
    n = len(assignments)
    k = num_clusters
    ext = "xml" if fmt == OutputFormat.XML else "json"

    apath = os.path.join(outdir, f"{assignments_prefix}{k}.csv")
    with open(apath, "w") as f:
        f.write(",".join(str(int(a)) for a in assignments))
        f.write("\n")

    fpath = os.path.join(outdir, f"assignments_fuzzy_{k}.csv")
    with open(fpath, "w") as f:
        for c in range(n):
            f.write(",".join(f"{fuzzy[r, c]:.3e}" for r in range(k)))
            f.write("\n")

    terms = top_terms_matrix(W, maxterms)  # (maxterms, k)
    term_lists = [list(terms[:, c]) for c in range(k)]
    doc_counts = {}
    for a in assignments:
        doc_counts[int(a)] = doc_counts.get(int(a), 0) + 1

    rpath = os.path.join(outdir, f"clusters_{k}.{ext}")
    writer = make_flatclust_writer(fmt)
    with open(rpath, "w") as f:
        writer.write(f, n, doc_counts, term_lists, dictionary)
    return apath, fpath, rpath
