"""preprocess_tf command-line tool — port of
smallk_tpu/cli/preprocessor_cli.py.

Reference: preprocessor/src/main.cpp + command_line.cpp; flags per
sphinx/source/pages_commandLineTools.rst:80-110.  Fixed input filenames
matrix.mtx / dictionary.txt / documents.txt; outputs reduced_*.
Host-only (numpy and scipy), so it takes no `--device`; the same flags,
files and exit codes as the JAX package's tool, without its
`--compile-cache` (an XLA setting).

    python -m smallk_torch.cli.preprocessor_cli --indir IN --outdir OUT
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="preprocess_tf",
        description="Term-frequency matrix preprocessor (prune + tf-idf)",
    )
    p.add_argument("--indir", required=True,
                   help="folder containing matrix.mtx, dictionary.txt, "
                        "documents.txt")
    p.add_argument("--outdir", default=".")
    p.add_argument("--docs_per_term", type=int, default=3)
    p.add_argument("--terms_per_doc", type=int, default=5)
    p.add_argument("--maxiter", type=int, default=1000)
    p.add_argument("--precision", type=int, default=4)
    p.add_argument("--boolean_mode", type=int, default=0)
    return p


def main(argv=None) -> int:
    from ..engines.preprocess import preprocess_tf
    from ..io.loader import load_strings
    from ..io.matrix_market import load_matrix_market, write_matrix_market

    args = build_parser().parse_args(argv)

    print("\n      Command line options:\n")
    print(f"            indir: {args.indir}")
    print(f"           outdir: {args.outdir}")
    print(f"    docs_per_term: {args.docs_per_term}")
    print(f"    terms_per_doc: {args.terms_per_doc}")
    print(f"         max_iter: {args.maxiter}")
    print(f"        precision: {args.precision}")
    print(f"     boolean_mode: {args.boolean_mode}\n")

    mtx = os.path.join(args.indir, "matrix.mtx")
    dct = os.path.join(args.indir, "dictionary.txt")
    docs = os.path.join(args.indir, "documents.txt")

    print(f"Loading input matrix {mtx}")
    t0 = time.time()
    A = load_matrix_market(mtx)
    print(f"\tInput file load time: {time.time() - t0:.3f}s.")
    dictionary = load_strings(dct)
    documents = load_strings(docs)

    t0 = time.time()
    res = preprocess_tf(
        A,
        max_iter=args.maxiter,
        docs_per_term=args.docs_per_term,
        terms_per_doc=args.terms_per_doc,
        boolean_mode=bool(args.boolean_mode),
    )
    print(f"Processing time: {time.time() - t0:.3f}s.")

    t0 = time.time()
    out_mtx = os.path.join(args.outdir, "reduced_matrix.mtx")
    write_matrix_market(out_mtx, res.matrix, precision=args.precision)
    with open(os.path.join(args.outdir, "reduced_dictionary.txt"), "w") as f:
        for r in res.term_indices:
            f.write(dictionary[r] + "\n")
    with open(os.path.join(args.outdir, "reduced_documents.txt"), "w") as f:
        for c in res.doc_indices:
            f.write(documents[c] + "\n")
    print(f"Result file write time: {time.time() - t0:.3f}s.")
    return 0


def entry(argv=None) -> int:
    """Console entry point: main() behind the Result exit-code boundary
    (reference mains return Result ints, common/include/nmf.hpp:17-26)."""
    from . import run_cli

    return run_cli(main, argv)


if __name__ == "__main__":
    sys.exit(entry())
