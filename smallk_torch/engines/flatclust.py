"""Flat clustering by direct NMF — port of smallk_tpu/engines/flatclust.py.

`run_flatclust` factors A with HALS, RANK2 or BPP (the reference excludes
MU) through `run_nmf`, then derives the argmax assignments and the fuzzy
(column-normalized) assignments from H.
`write_flatclust_results` writes the reference's result files.  Both sit
on the port's copies of the numpy-only `engines.assignments` and
`io.writers`.

`run_hier_nmf2` is the whole hierarchical workload: the tree, then the
optional flat refinement.

With `mesh` (parallel/mesh.Mesh) each runs sharded over the mesh's ranks:
the operand is built once from the rank's block and every rank gets the
same host results.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import scipy.sparse as sp

from ..common.options import (
    ClustOptions,
    ClustStats,
    NmfAlgorithm,
    NmfOptions,
    NmfStats,
    OutputFormat,
)
from ..io.writers import make_flatclust_writer
from ..ops.aop import as_aop
from .assignments import (
    compute_assignments,
    compute_fuzzy_assignments,
    top_terms_matrix,
)
from ..parallel.mesh import check_mesh, shard_operand, sharded_nmf_solve
from .nmf import run_nmf

_FLATCLUST_ALGORITHMS = (
    NmfAlgorithm.HALS, NmfAlgorithm.RANK2, NmfAlgorithm.BPP
)


def run_flatclust(A, W0: np.ndarray, H0: np.ndarray, opts: NmfOptions,
                  stats: Optional[NmfStats] = None, mesh=None, *,
                  device="cuda"):
    """Factor A on `device` ("cuda", "cuda:1", "cpu"; the card unless the
    caller asks for the CPU) and derive the flat clustering.  With `mesh`,
    A, W and H are sharded over its ranks, on its device
    (parallel/mesh.sharded_nmf_solve).

    Returns (W, H, assignments, fuzzy, success) as host arrays; top terms
    are derived by the caller via assignments.top_terms_matrix(W, maxterms).
    """
    if opts.algorithm not in _FLATCLUST_ALGORITHMS:
        raise ValueError(
            "flatclust: algorithm must be HALS, RANK2, or BPP "
            "(reference flat_clust.cpp:38-70 excludes MU)"
        )
    if check_mesh(mesh, "run_flatclust") is None:
        W, H, ok = run_nmf(A, W0, H0, opts, stats, device=device)
    else:
        W, H, ok = _sharded_nmf(A, W0, H0, opts, stats, mesh)
    assignments = compute_assignments(H)
    fuzzy = compute_fuzzy_assignments(H).astype(np.float32)
    return W, H, assignments, fuzzy, ok


def _sharded_nmf(A, W0, H0, opts: NmfOptions, stats, mesh):
    """`run_nmf` over a mesh: (W, H, success) on every rank."""
    opts.validate()
    t0 = time.perf_counter()
    res = sharded_nmf_solve(A, W0, H0, opts, mesh)
    W, H = res.W.cpu().numpy(), res.H.cpu().numpy()
    if stats is not None:
        stats.elapsed_us = int((time.perf_counter() - t0) * 1e6)
        stats.iteration_count = int(res.iterations)
        stats.pivot_rounds = int(res.pivot_rounds)
    return W, H, bool(res.success)


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


def run_hier_nmf2(A, opts: ClustOptions, rng, stats=None,
                  checkpoint_path=None, mesh=None, *, device="cuda"):
    """Full hierarchical workload on `device` (the card unless the caller
    asks for the CPU): tree + optional flat refinement.  With `mesh`, both
    phases run sharded over its ranks, on its device.

    Reference: RunHierNmf2 (hierclust/include/run_hier_nmf2.hpp:17-76).
    Returns (tree, stats, flat) where flat is None or a dict with
    W, H, assignments, fuzzy, success.  `checkpoint_path` makes the tree
    phase preemption-safe (resumes from an existing checkpoint).
    """
    from .hierclust import clust_flat, clust_hier

    stats = stats if stats is not None else ClustStats()
    # one operand for both phases; the host matrix rides along for the
    # tree's node operands and initdir row support
    host_A = A if sp.issparse(A) or isinstance(A, np.ndarray) else None
    a_dtype = opts.nmf_opts.a_dtype or opts.nmf_opts.dtype
    if check_mesh(mesh, "run_hier_nmf2") is None:
        a_op = as_aop(A, dtype=a_dtype, device=device)
    else:
        a_op = shard_operand(A, mesh, a_dtype)
    tree, stats = clust_hier(a_op, opts, rng, stats, mesh=mesh,
                             checkpoint_path=checkpoint_path, host_A=host_A,
                             device=device)

    flat = None
    if opts.flat:
        W, H, ok = clust_flat(a_op, tree, opts, rng, mesh=mesh,
                              device=device)
        flat = {
            "W": W,
            "H": H,
            "assignments": compute_assignments(H),
            "fuzzy": compute_fuzzy_assignments(H).astype(np.float32),
            "success": ok,
        }
    return tree, stats, flat
