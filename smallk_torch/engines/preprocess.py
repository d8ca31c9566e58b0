"""Term-frequency preprocessor: prune + dedupe + tf-idf.

Reference: preprocessor/src/preprocess.cpp (preprocess_tf :81-253,
PruneRows :279-365, PrunableCols/PruneCols :370-445, UniqueCols :631-724,
TermOccurrenceHistogram :253-276) and common/src/term_frequency_matrix.cpp.

Semantics preserved exactly:
  - row kept iff (sum of counts >= docs_per_term) AND (doc frequency < n)
    — terms appearing in every document are pruned too (:305-310)
  - column kept iff nonzero count >= terms_per_doc (:385-388)
  - duplicate columns (identical sorted (row, count) pairs) reduced to the
    max-index survivor, "to match Matlab's current behavior" (:612-626)
  - loop until fixpoint or max_iter
  - tf-idf: score = (1 + log(count)) * log(n / df_r), columns L2-normalized
    (:193-230)

Host-side: this is one pass over the nonzeros (reference: 877K nz in 63 ms)
— not a device workload.

The port's own copy of smallk_tpu/engines/preprocess.py, equal in what it
returns: the reference's pure-Python path, which it runs when its native
extension (smallk_tpu/native/) is not built.  The native branches are not
ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass
class PreprocessResult:
    matrix: sp.csc_matrix          # tf-idf scored, pruned, deduped
    tf_matrix: sp.csc_matrix       # pruned term-frequency counts
    term_indices: np.ndarray       # surviving row -> original row index
    doc_indices: np.ndarray        # surviving col -> original col index


def term_occurrence_histogram(M: sp.csc_matrix):
    """Per-term statistics over the nonzeros (reference
    TermOccurrenceHistogram, preprocess.cpp:253-276).

    Returns (histogram, histogram_nz):
      histogram[r]    — sum of counts for term r across all documents
      histogram_nz[r] — number of documents containing term r (the
                        document frequency feeding the idf score,
                        preprocess.cpp:191-197)
    """
    m = M.shape[0]
    histogram = np.bincount(M.indices, weights=M.data, minlength=m)
    histogram_nz = np.bincount(M.indices, minlength=m)
    return histogram.astype(np.int64), histogram_nz.astype(np.int64)


def _unique_col_mask(M: sp.csc_matrix) -> np.ndarray:
    """Boolean mask of surviving columns after duplicate removal.

    Columns are identical iff their sorted (row, count) sequences match;
    each duplicate group keeps only its maximum column index (reference
    UniqueCols + ResolveFalsePositives, preprocess.cpp:575-724).
    """
    n = M.shape[1]
    indptr, indices, data = M.indptr, M.indices, M.data
    seen: dict[bytes, int] = {}
    for c in range(n):
        lo, hi = indptr[c], indptr[c + 1]
        key = indices[lo:hi].tobytes() + data[lo:hi].tobytes()
        prev = seen.get(key)
        if prev is None or c > prev:
            seen[key] = c
    mask = np.zeros(n, dtype=bool)
    mask[list(seen.values())] = True
    return mask


def preprocess_tf(
    A,
    max_iter: int = 1000,
    docs_per_term: int = 3,
    terms_per_doc: int = 5,
    boolean_mode: bool = False,
    verbose: bool = True,
) -> PreprocessResult:
    """Prune/dedupe a term-frequency matrix and compute tf-idf scores.

    A: scipy sparse (m x n) of nonnegative term counts.
    Returns a PreprocessResult; raises ValueError if everything is pruned.
    """
    M = sp.csc_matrix(A, copy=True)
    M.sort_indices()
    M.data = np.asarray(np.round(M.data), dtype=np.int64)
    if boolean_mode:
        M.data = np.ones_like(M.data)
    M.eliminate_zeros()

    m, n = M.shape
    term_indices = np.arange(m, dtype=np.int64)
    doc_indices = np.arange(n, dtype=np.int64)

    it = 0
    if verbose:
        print("\nStarting iterations...")
    while it < max_iter:
        # --- PruneRows -----------------------------------------------------
        width = M.shape[1]
        counts, df = term_occurrence_histogram(M)
        row_keep = (counts >= docs_per_term) & (df < width)
        if not row_keep.all():
            M = M[row_keep, :].tocsc()
            term_indices = term_indices[row_keep]

        # --- PrunableCols / PruneCols --------------------------------------
        col_nnz = np.diff(M.indptr)
        col_keep = col_nnz >= terms_per_doc
        pruned_cols = not col_keep.all()
        if pruned_cols:
            if not col_keep.any():
                raise ValueError("Preprocessor: all columns were pruned.")
            M = M[:, col_keep]
            doc_indices = doc_indices[col_keep]

        # --- UniqueCols ----------------------------------------------------
        width = M.shape[1]
        uniq = _unique_col_mask(M)
        deduped = not uniq.all()
        if deduped:
            M = M[:, uniq]
            doc_indices = doc_indices[uniq]

        if verbose:
            print(f"\t[{it + 1}] height: {M.shape[0]}, width: {M.shape[1]}, "
                  f"nonzeros: {M.nnz}")
        it += 1

        # Fixpoint test matches the reference (preprocess.cpp:139-149):
        # stop when no columns were pruned and no duplicates were found.
        # (Row removals don't alter the surviving rows' statistics, so a
        # round with only row prunes is already stable.)
        if not pruned_cols and not deduped:
            break

    if verbose:
        # reference end-of-loop summary (preprocess.cpp:179-185)
        print("Iterations finished.")
        print(f"\tNew height: {M.shape[0]}")
        print(f"\tNew width: {M.shape[1]}")
        print(f"\tNew nonzero count: {M.nnz}")
    return _finish_tfidf(M, term_indices, doc_indices)


def _finish_tfidf(M, term_indices, doc_indices) -> PreprocessResult:
    """tf-idf scoring + column normalization (preprocess.cpp:193-230)."""
    height, width = M.shape
    _, df = term_occurrence_histogram(M)
    idf = np.log(width / df.astype(np.float64))
    scores = (1.0 + np.log(M.data.astype(np.float64))) * idf[M.indices]

    S = sp.csc_matrix((scores, M.indices.copy(), M.indptr.copy()),
                      shape=M.shape)
    norms = np.sqrt(np.asarray(S.power(2).sum(axis=0)).ravel())
    col_scale = np.where(norms > 0, 1.0 / norms, 1.0)
    S = S @ sp.diags(col_scale)

    return PreprocessResult(
        matrix=sp.csc_matrix(S),
        tf_matrix=M,
        term_indices=term_indices,
        doc_indices=doc_indices,
    )
