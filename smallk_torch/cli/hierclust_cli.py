"""hierclust command-line tool — port of smallk_tpu/cli/hierclust_cli.py.

Same flags, defaults, output files and exit codes, plus `--device`
(default cuda).  The reference's `--mesh` (a sharded run) and
`--compile-cache` (an XLA setting) have no counterpart here.

    python -m smallk_torch.cli.hierclust_cli --matrixfile A.mtx \\
        --dictfile dict.txt --clusters 12
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hierclust",
        description="Hierarchical clustering via recursive rank-2 NMF",
    )
    p.add_argument("--matrixfile", required=True)
    p.add_argument("--dictfile", required=True)
    p.add_argument("--clusters", required=True, type=int)
    p.add_argument("--initdir", default="")
    p.add_argument("--tol", type=float, default=0.0001)
    p.add_argument("--outdir", default="")
    p.add_argument("--miniter", type=int, default=5)
    p.add_argument("--maxiter", type=int, default=5000)
    p.add_argument("--maxterms", type=int, default=5)
    p.add_argument("--maxthreads", type=int, default=8)
    p.add_argument("--unbalanced", type=float, default=0.1)
    p.add_argument("--trial_allowance", type=int, default=3)
    p.add_argument("--flat", type=int, default=0)
    p.add_argument("--verbose", type=int, default=1)
    p.add_argument("--format", default="XML", choices=["XML", "JSON"])
    p.add_argument("--treefile", default="")
    p.add_argument("--assignfile", default="")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--dtype", default="float32")
    # extensions beyond the reference CLI, as the JAX package's tool has
    # them: node initializer policy, checkpoint/resume, best-of-R
    # restarts, leaf-pop policy and the graph preset
    p.add_argument("--init", default="random",
                   choices=["random", "spectral"])
    p.add_argument("--checkpoint", default="", metavar="PATH",
                   help="checkpoint file: save engine state after every "
                        "split and resume from it if it exists "
                        "(preemption-safe runs)")
    p.add_argument("--restarts", type=int, default=1, metavar="R",
                   help="best-of-R random restarts per node "
                        "factorization (R>1 recommended for graphs)")
    p.add_argument("--priority", default="ndcg",
                   choices=["ndcg", "size_ndcg"],
                   help="leaf pop policy: raw NDCG (reference) or "
                        "size-scaled NDCG (graph workloads)")
    p.add_argument("--graph", action="store_true",
                   help="treat the input as a graph adjacency matrix: "
                        "symmetric D^-1/2 A D^-1/2 normalization + the "
                        "graph clustering presets (size_ndcg pop, "
                        "best-of-3 restarts) unless overridden")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:N, cpu)")
    return p


def main(argv=None) -> int:
    from ..common.options import (
        ClustOptions, ClustStats, NmfAlgorithm, NmfOptions,
        NmfProgressAlgorithm, OutputFormat,
    )
    from ..common.rng import Random
    from ..engines.flatclust import run_hier_nmf2, write_flatclust_results
    from ..io.loader import load_matrix, load_strings
    from ..io.writers import make_hierclust_writer

    parser = build_parser()
    args = parser.parse_args(argv)

    A = load_matrix(args.matrixfile)
    dictionary = load_strings(args.dictfile)

    restarts = args.restarts
    priority = args.priority
    if args.graph:
        # graph preset (engines/graph.py): symmetric degree
        # normalization + size-scaled pop + best-of-3 restarts, unless
        # the user set those flags explicitly
        from ..engines.graph import normalized_adjacency

        A = normalized_adjacency(A)
        if restarts == parser.get_default("restarts"):
            restarts = 3
        if priority == parser.get_default("priority"):
            priority = "size_ndcg"

    m, n = A.shape
    k = args.clusters

    fmt = OutputFormat(args.format)
    ext = "xml" if fmt == OutputFormat.XML else "json"
    outdir = args.outdir or "."
    treefile = args.treefile or f"tree_{k}.{ext}"
    assignfile = args.assignfile or f"assignments_{k}.csv"

    opts = ClustOptions(
        nmf_opts=NmfOptions(
            tol=args.tol,
            algorithm=NmfAlgorithm.RANK2,
            prog_est_algorithm=NmfProgressAlgorithm.PG_RATIO,
            height=m, width=n, k=2,
            min_iter=args.miniter, max_iter=args.maxiter,
            tolcount=1, max_threads=args.maxthreads,
            verbose=bool(args.verbose), normalize=True, dtype=args.dtype,
        ),
        maxterms=args.maxterms,
        unbalanced=args.unbalanced,
        trial_allowance=args.trial_allowance,
        num_clusters=k,
        verbose=bool(args.verbose),
        flat=bool(args.flat),
        initdir=args.initdir or None,
        init_method=args.init,
        restarts=restarts,
        priority_method=priority,
    )

    stats = ClustStats()
    t0 = time.perf_counter()
    tree, stats, flat = run_hier_nmf2(
        A, opts, Random(args.seed), stats,
        checkpoint_path=args.checkpoint or None, device=args.device,
    )
    elapsed = time.perf_counter() - t0
    converged = stats.nmf_count - stats.max_count
    print(f"{converged}/{stats.nmf_count} factorizations converged.")
    print(f"Elapsed wall clock time: {elapsed:.3f} sec.")

    tree.write_assignments(os.path.join(outdir, assignfile))
    tree.write_tree(
        make_hierclust_writer(fmt), os.path.join(outdir, treefile),
        dictionary,
    )
    if flat is not None:
        write_flatclust_results(
            outdir, flat["assignments"], flat["fuzzy"], flat["W"],
            dictionary, args.maxterms, fmt, k,
            assignments_prefix="assignments_flat_",
        )
    return 0


def entry(argv=None) -> int:
    """Console entry point: main() behind the Result exit-code boundary."""
    from . import run_cli

    return run_cli(main, argv)


if __name__ == "__main__":
    sys.exit(entry())
