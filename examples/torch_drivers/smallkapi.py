"""Command-line driver for the SmallkAPI class.

Port of reference pysmallk/tests/smallkapi.py: load a matrix (and
optionally a dictionary), run NMF or HierNMF2, write outputs.  The
reference driver's --hiernmf2 path reads `args.format` (a flag its own
parser never defines) and passes `hiernmf2tolerance=` (a keyword its
hiernmf2() doesn't accept) — both pysmallk bugs; this port runs the
invocation the reference documents (`--hiernmf2 1`) correctly.

The PyTorch port's copy of examples/drivers/smallkapi.py: the same
flow through smallk_torch.api, on --device (default cuda).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from smallk_torch.api import SmallkAPI  # noqa: E402


def main(argv=None):
    # the parser is an instance method, as pysmallk's; the instance that
    # runs takes the parsed --device
    args = SmallkAPI().parser(argv)
    api = SmallkAPI(device=args.device)
    api.load_matrix(filepath=args.matrixfile)
    if args.dictfile:
        api.load_dictionary(filepath=args.dictfile)

    if args.hiernmf2:
        api.hiernmf2(int(args.k), format=args.format,
                     maxterms=int(args.maxterms), tol=float(args.tol))
    else:
        api.nmf(
            int(args.k), args.algorithm,
            infile_W=args.infile_W, infile_H=args.infile_H,
            precision=int(args.outprecision), min_iter=int(args.miniter),
            max_iter=int(args.maxiter), tol=float(args.tol),
            max_threads=int(args.maxthreads),
        )
        print("W:", api.get_W().shape, "H:", api.get_H().shape)
    api.finalize()


if __name__ == "__main__":
    main()
