"""nmf command-line tool — port of smallk_tpu/cli/nmf_cli.py.

Same flags, defaults, option dump, output files and exit codes, plus
`--device` (default cuda).  The reference's `--compile-cache` is an XLA
setting and has no counterpart here.

    python -m smallk_torch.cli.nmf_cli --matrixfile A.mtx --k 8
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nmf",
                                description="Nonnegative matrix factorization")
    p.add_argument("--matrixfile", required=True,
                   help="matrix to factor (.csv dense / .mtx sparse)")
    p.add_argument("--k", required=True, type=int,
                   help="inner dimension for factors W and H")
    p.add_argument("--algorithm", default="BPP",
                   choices=["MU", "HALS", "RANK2", "BPP"])
    p.add_argument("--stopping", default="PG_RATIO",
                   choices=["PG_RATIO", "DELTA"])
    p.add_argument("--tol", type=float, default=0.005)
    p.add_argument("--tolcount", type=int, default=1)
    p.add_argument("--infile_W", default="")
    p.add_argument("--infile_H", default="")
    p.add_argument("--outfile_W", default="w.csv")
    p.add_argument("--outfile_H", default="h.csv")
    p.add_argument("--miniter", type=int, default=5)
    p.add_argument("--maxiter", type=int, default=5000)
    p.add_argument("--outprecision", type=int, default=6)
    p.add_argument("--maxthreads", type=int, default=8)
    p.add_argument("--normalize", type=int, default=1)
    p.add_argument("--verbose", type=int, default=1)
    p.add_argument("--seed", type=int, default=None,
                   help="RNG seed for random initializers")
    p.add_argument("--dtype", default="float32",
                   help="device dtype (float32/float64)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:N, cpu)")
    return p


def main(argv=None) -> int:
    from ..common.options import (
        NmfAlgorithm, NmfOptions, NmfProgressAlgorithm, NmfStats,
    )
    from ..common.rng import Random, random_matrix
    from ..engines.nmf import run_nmf
    from ..io.delimited import load_delimited, write_delimited
    from ..io.loader import load_matrix

    args = build_parser().parse_args(argv)

    if args.verbose:
        # option dump, as the reference tools print before each run
        print("\n      Command line options:\n")
        for name in ("matrixfile", "k", "algorithm", "stopping", "tol",
                     "tolcount", "infile_W", "infile_H", "outfile_W",
                     "outfile_H", "miniter", "maxiter", "outprecision",
                     "maxthreads", "normalize", "verbose"):
            print(f"{name:>20}: {getattr(args, name)}")
        print()

    A = load_matrix(args.matrixfile)
    m, n = A.shape
    k = args.k

    rng = Random(args.seed)
    W0 = (load_delimited(args.infile_W) if args.infile_W
          else random_matrix(m, k, rng))
    H0 = (load_delimited(args.infile_H) if args.infile_H
          else random_matrix(k, n, rng))

    prog = (NmfProgressAlgorithm.PG_RATIO if args.stopping == "PG_RATIO"
            else NmfProgressAlgorithm.DELTA_FNORM)
    opts = NmfOptions(
        tol=args.tol,
        algorithm=NmfAlgorithm(args.algorithm),
        prog_est_algorithm=prog,
        height=m, width=n, k=k,
        min_iter=args.miniter, max_iter=args.maxiter,
        tolcount=args.tolcount, max_threads=args.maxthreads,
        verbose=bool(args.verbose), normalize=bool(args.normalize),
        dtype=args.dtype,
    )

    stats = NmfStats()
    W, H, ok = run_nmf(A, W0, H0, opts, stats, device=args.device)
    if not ok:
        print("NMF solver failure.", file=sys.stderr)
        return 1

    write_delimited(args.outfile_W, W, args.outprecision)
    write_delimited(args.outfile_H, H, args.outprecision)
    print(f"Elapsed wall clock time: {stats.elapsed_us / 1.0e6:.3f} sec.")
    print(f"{stats.iteration_count} iterations.")
    return 0


def entry(argv=None) -> int:
    """Console entry point: main() behind the Result exit-code boundary."""
    from . import run_cli

    return run_cli(main, argv)


if __name__ == "__main__":
    sys.exit(entry())
