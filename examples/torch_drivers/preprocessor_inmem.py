"""In-memory Preprocessor driver.

Port of reference pysmallk/tests/preprocessor_inmem.py: builds the sparse
term-doc matrix from raw CSC buffers (data / row_indices / col_offsets),
preprocesses in memory, and reads the reduced dataset back as buffers —
no files anywhere.

The PyTorch port's copy of examples/drivers/preprocessor_inmem.py: the same
flow through smallk_torch.api (host-only: numpy and scipy).
"""

import os
import sys

import numpy as np
import scipy.sparse as sp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from smallk_torch.api import Preprocessor  # noqa: E402


def main():
    rng = np.random.RandomState(0)
    m, n = 500, 300
    A = sp.random(m, n, density=0.04, random_state=rng, format="csc")
    A.data = np.ceil(A.data * 9)
    terms = [f"term{i}" for i in range(m)]
    docids = [f"doc{i}" for i in range(n)]

    p = Preprocessor()
    # the reference driver passes the raw CSC constituents
    p.load_matrix(height=m, width=n, nz=A.nnz, buffer=A.data,
                  row_indices=A.indices, col_offsets=A.indptr)
    p.load_dictionary(dictionary=terms)
    p.load_documents(documents=docids)

    p.preprocess(maxiter=8, docsperterm=3, termsperdoc=5, boolean_mode=0)

    reduced_docs = p.get_reduced_documents()
    reduced_dict = p.get_reduced_dictionary()
    reduced_scores = p.get_reduced_scores()
    reduced_row_indices = p.get_reduced_row_indices()
    reduced_col_offsets = p.get_reduced_col_offsets()

    reduced = sp.csc_matrix(
        (reduced_scores, reduced_row_indices, reduced_col_offsets),
        shape=(len(reduced_dict), len(reduced_docs)), dtype=float,
    )
    print(f"reduced: {reduced.shape[0]} terms x {reduced.shape[1]} docs, "
          f"{reduced.nnz} nonzeros")
    norms = np.sqrt(np.asarray(reduced.power(2).sum(axis=0)).ravel())
    print("columns tf-idf unit-normalized:",
          bool(np.allclose(norms[norms > 0], 1.0, atol=1e-6)))


if __name__ == "__main__":
    main()
