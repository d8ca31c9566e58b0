"""Command-line driver for the Hierclust class.

Port of reference pysmallk/tests/hierclust.py.

The PyTorch port's copy of examples/drivers/hierclust.py: the same
flow through smallk_torch.api, on --device (default cuda).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from smallk_torch.api import Hierclust  # noqa: E402


def main():
    args = Hierclust().parser()
    hc = Hierclust(device=args.device)
    hc.load_matrix(filepath=args.matrixfile)
    hc.load_dictionary(filepath=args.dictfile)
    hc.cluster(
        int(args.clusters), initdir=args.initdir, maxterms=int(args.maxterms),
        unbalanced=float(args.unbalanced),
        trial_allowance=int(args.trial_allowance),
        verbose=bool(int(args.verbose)), flat=int(args.flat),
        min_iter=int(args.miniter), max_iter=int(args.maxiter),
        tol=float(args.tol), max_threads=int(args.maxthreads),
    )
    hc.write_output(outdir=args.outdir, format=args.format)
    print("assignments:", hc.get_assignments().shape)


if __name__ == "__main__":
    main()
