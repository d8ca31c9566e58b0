"""flatclust command-line tool — port of smallk_tpu/cli/flatclust_cli.py.

Same flags, defaults, output files, renames and exit codes, plus
`--device` (default cuda).  The reference's `--mesh` (a sharded solve) and
`--compile-cache` (an XLA setting) have no counterpart here.

    python -m smallk_torch.cli.flatclust_cli --matrixfile A.mtx \
        --dictfile dict.txt --clusters 16 --algorithm HALS
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="flatclust", description="Flat clustering via NMF",
    )
    p.add_argument("--matrixfile", required=True)
    p.add_argument("--dictfile", required=True)
    p.add_argument("--clusters", required=True, type=int)
    p.add_argument("--algorithm", default="BPP",
                   choices=["HALS", "RANK2", "BPP"])
    p.add_argument("--infile_W", default="")
    p.add_argument("--infile_H", default="")
    p.add_argument("--tol", type=float, default=0.0001)
    p.add_argument("--outdir", default="")
    p.add_argument("--miniter", type=int, default=5)
    p.add_argument("--maxiter", type=int, default=5000)
    p.add_argument("--maxterms", type=int, default=5)
    p.add_argument("--maxthreads", type=int, default=8)
    p.add_argument("--verbose", type=int, default=1)
    p.add_argument("--format", default="XML", choices=["XML", "JSON"])
    p.add_argument("--clustfile", default="")
    p.add_argument("--assignfile", default="")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:N, cpu)")
    return p


def main(argv=None) -> int:
    from ..common.options import (
        NmfAlgorithm, NmfOptions, NmfProgressAlgorithm, NmfStats,
        OutputFormat,
    )
    from ..common.rng import Random, random_matrix
    from ..engines.flatclust import run_flatclust, write_flatclust_results
    from ..io.delimited import load_delimited
    from ..io.loader import load_matrix, load_strings

    args = build_parser().parse_args(argv)

    A = load_matrix(args.matrixfile)
    dictionary = load_strings(args.dictfile)
    m, n = A.shape
    k = args.clusters

    rng = Random(args.seed)
    W0 = (load_delimited(args.infile_W) if args.infile_W
          else random_matrix(m, k, rng))
    H0 = (load_delimited(args.infile_H) if args.infile_H
          else random_matrix(k, n, rng))

    opts = NmfOptions(
        tol=args.tol,
        algorithm=NmfAlgorithm(args.algorithm),
        prog_est_algorithm=NmfProgressAlgorithm.PG_RATIO,
        height=m, width=n, k=k,
        min_iter=args.miniter, max_iter=args.maxiter,
        tolcount=1, max_threads=args.maxthreads,
        verbose=bool(args.verbose), normalize=True, dtype=args.dtype,
    )

    stats = NmfStats()
    W, H, assignments, fuzzy, ok = run_flatclust(A, W0, H0, opts, stats,
                                                 device=args.device)
    if not ok:
        print("flatclust: solver failure", file=sys.stderr)
        return 1

    fmt = OutputFormat(args.format)
    outdir = args.outdir or "."
    write_flatclust_results(
        outdir, assignments, fuzzy, W, dictionary, args.maxterms, fmt, k,
    )
    # honor custom filenames by renaming if requested
    ext = "xml" if fmt == OutputFormat.XML else "json"
    if args.clustfile:
        os.replace(os.path.join(outdir, f"clusters_{k}.{ext}"),
                   os.path.join(outdir, args.clustfile))
    if args.assignfile:
        os.replace(os.path.join(outdir, f"assignments_{k}.csv"),
                   os.path.join(outdir, args.assignfile))
    print(f"{stats.iteration_count} iterations; "
          f"{stats.elapsed_us / 1e6:.3f} sec.")
    return 0


def entry(argv=None) -> int:
    """Console entry point: main() behind the Result exit-code boundary."""
    from . import run_cli

    return run_cli(main, argv)


if __name__ == "__main__":
    sys.exit(entry())
