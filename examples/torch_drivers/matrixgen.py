"""Command-line driver for the Matrixgen class.

Port of reference pysmallk/tests/matrixgen.py.

The PyTorch port's copy of examples/drivers/matrixgen.py: the same
flow through smallk_torch.api (host-only: numpy and scipy).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from smallk_torch.api import Matrixgen  # noqa: E402


def main():
    mg = Matrixgen()
    args = mg.parser()
    h, w = int(args.height), int(args.width)
    kind = args.type.upper()
    if kind == "UNIFORM":
        mg.uniform(h, w, float(args.rng_center), float(args.rng_radius))
    elif kind == "DENSE_DIAG":
        mg.densediag(h, w, float(args.rng_center), float(args.rng_radius))
    elif kind == "SPARSE_DIAG":
        mg.sparsediag(h, float(args.rng_center), float(args.rng_radius))
    elif kind == "IDENTITY":
        mg.identity(h, w)
    elif kind == "ONES":
        mg.ones(h, w)
    elif kind == "ZEROS":
        mg.zeros(h, w)
    elif kind == "SPARSE":
        mg.sparse(h, w, int(args.nz_per_col))
    else:
        raise SystemExit(f"unknown type {args.type}")
    mg.write_output(args.filename, precision=int(args.precision))
    print(f"wrote {args.filename}")


if __name__ == "__main__":
    main()
