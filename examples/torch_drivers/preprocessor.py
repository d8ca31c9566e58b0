"""Command-line driver for the Preprocessor class.

Port of reference pysmallk/tests/preprocessor.py.

The PyTorch port's copy of examples/drivers/preprocessor.py: the same
flow through smallk_torch.api (host-only: numpy and scipy).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from smallk_torch.api import Preprocessor  # noqa: E402


def main():
    pre = Preprocessor()
    args = pre.parser()
    indir = args.indir
    pre.load_matrix(filepath=os.path.join(indir, "matrix.mtx"))
    pre.load_dictionary(filepath=os.path.join(indir, "dictionary.txt"))
    pre.load_documents(filepath=os.path.join(indir, "documents.txt"))
    pre.preprocess(
        maxiter=int(args.maxiter), docsperterm=int(args.docs_per_term),
        termsperdoc=int(args.terms_per_doc),
        boolean_mode=int(args.boolean_mode),
    )
    outdir = args.outdir
    pre.write_output(
        os.path.join(outdir, "reduced_matrix.mtx"),
        os.path.join(outdir, "reduced_dictionary.txt"),
        os.path.join(outdir, "reduced_documents.txt"),
        precision=int(args.precision),
    )
    print("reduced matrix:", pre.result.matrix.shape)


if __name__ == "__main__":
    main()
