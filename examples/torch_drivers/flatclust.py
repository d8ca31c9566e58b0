"""Command-line driver for the Flatclust class.

Port of reference pysmallk/tests/flatclust.py.

The PyTorch port's copy of examples/drivers/flatclust.py: the same
flow through smallk_torch.api, on --device (default cuda).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from smallk_torch.api import Flatclust  # noqa: E402


def main():
    args = Flatclust().parser()
    fc = Flatclust(device=args.device)
    fc.load_matrix(filepath=args.matrixfile)
    fc.load_dictionary(filepath=args.dictfile)
    fc.cluster(
        int(args.clusters), infile_W=args.infile_W, infile_H=args.infile_H,
        algorithm=args.algorithm, maxterms=int(args.maxterms),
        verbose=bool(int(args.verbose)), min_iter=int(args.miniter),
        max_iter=int(args.maxiter), tol=float(args.tol),
        max_threads=int(args.maxthreads),
    )
    fc.write_output(outdir=args.outdir, format=args.format)
    print("assignments:", fc.get_assignments().shape)


if __name__ == "__main__":
    main()
