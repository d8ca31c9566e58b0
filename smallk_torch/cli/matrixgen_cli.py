"""matrixgen command-line tool — port of smallk_tpu/cli/matrixgen_cli.py.

Reference: matrixgen/src/main.cpp + command_line.cpp; flags per
sphinx/source/pages_commandLineTools.rst:160-200.  Host-only (numpy and
scipy), so it takes no `--device`; the same flags, files and exit codes
as the JAX package's tool, without its `--compile-cache` (an XLA
setting).

    python -m smallk_torch.cli.matrixgen_cli --height 300 --width 200 \
        --filename A.mtx --type SPARSE --nz_per_col 20 --seed 1
"""

from __future__ import annotations

import argparse
import sys

import scipy.sparse as sp


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="matrixgen",
                                description="Matrix generator")
    p.add_argument("--height", required=True, type=int)
    p.add_argument("--width", required=True, type=int)
    p.add_argument("--filename", required=True)
    p.add_argument("--type", default="UNIFORM",
                   choices=["UNIFORM", "DENSE_DIAG", "SPARSE_DIAG",
                            "IDENTITY", "ONES", "ZEROS", "SPARSE"])
    p.add_argument("--rng_center", type=float, default=0.5)
    p.add_argument("--rng_radius", type=float, default=0.5)
    p.add_argument("--precision", type=int, default=6)
    p.add_argument("--nz_per_col", type=int, default=1)
    p.add_argument("--seed", type=int, default=None)
    return p


def main(argv=None) -> int:
    from ..common.rng import Random
    from ..engines.matrixgen import generate
    from ..io.delimited import write_delimited
    from ..io.matrix_market import write_matrix_market

    args = build_parser().parse_args(argv)

    M = generate(
        args.height, args.width, args.type, rng=Random(args.seed),
        center=args.rng_center, radius=args.rng_radius,
        nz_per_col=args.nz_per_col,
    )
    if sp.issparse(M):
        write_matrix_market(args.filename, M, precision=args.precision)
    else:
        write_delimited(args.filename, M, precision=args.precision)
    print(f"Wrote {args.height}x{args.width} {args.type} matrix to "
          f"{args.filename}")
    return 0


def entry(argv=None) -> int:
    """Console entry point: main() behind the Result exit-code boundary
    (reference mains return Result ints, common/include/nmf.hpp:17-26)."""
    from . import run_cli

    return run_cli(main, argv)


if __name__ == "__main__":
    sys.exit(entry())
