"""MatrixMarket file IO.

Reference: common/src/matrix_market_file.cpp (typecode parsing, banner
handling, symmetric/skew expansion) and common/include/sparse_matrix_io.hpp
(LoadMatrixMarketFile -> SparseMatrix, WriteMatrixMarketFile).

Parse into a scipy CSC matrix host-side (IO is a host concern; the device
operand is built later by ops.aop).  The port's copy of
smallk_tpu/io/matrix_market.py: the same numpy bulk parser and writer; the
reference's optional native C++ fast path is not carried over.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


class MatrixMarketError(ValueError):
    pass


def _parse_banner(line: str):
    parts = line.strip().lower().split()
    if len(parts) != 5 or parts[0] != "%%matrixmarket" or parts[1] != "matrix":
        raise MatrixMarketError(f"invalid MatrixMarket banner: {line!r}")
    fmt, field, symmetry = parts[2], parts[3], parts[4]
    if fmt not in ("coordinate", "array"):
        raise MatrixMarketError(f"unsupported MM format: {fmt}")
    if field not in ("real", "integer", "pattern", "double"):
        raise MatrixMarketError(f"unsupported MM field: {field}")
    if symmetry not in ("general", "symmetric", "skew-symmetric"):
        raise MatrixMarketError(f"unsupported MM symmetry: {symmetry}")
    return fmt, field, symmetry


def load_matrix_market(filename: str, dtype=np.float64) -> sp.csc_matrix:
    """Load a MatrixMarket file as a scipy CSC matrix.

    Handles coordinate and array formats; real/integer/pattern fields;
    general/symmetric/skew-symmetric symmetry (expanded to general), matching
    the reference reader's capabilities (matrix_market_file.cpp:72-260).
    """
    with open(filename, "rb") as f:
        banner = f.readline().decode("ascii", errors="replace")
        fmt, field, symmetry = _parse_banner(banner)

        # skip comments; readline() returns b"" at EOF, which must stop
        # the loop (a truncated file would otherwise spin forever)
        line = f.readline()
        while line and (line.startswith(b"%") or not line.strip()):
            line = f.readline()
        if not line:
            raise MatrixMarketError("unexpected EOF before size line")

        size_parts = line.split()
        if fmt == "coordinate":
            if len(size_parts) != 3:
                raise MatrixMarketError("bad coordinate size line")
            m, n, nnz = (int(p) for p in size_parts)
            has_values = field != "pattern"
            body = np.loadtxt(f, ndmin=2, dtype=np.float64)
            if body.size == 0:
                body = body.reshape(0, 3 if has_values else 2)
            if body.shape[0] != nnz:
                raise MatrixMarketError(
                    f"expected {nnz} entries, found {body.shape[0]}"
                )
            rows = body[:, 0].astype(np.int64) - 1
            cols = body[:, 1].astype(np.int64) - 1
            if field == "pattern":
                vals = np.ones(nnz, dtype=dtype)
            else:
                vals = body[:, 2].astype(dtype)
        else:  # array (dense, column-major)
            if len(size_parts) != 2:
                raise MatrixMarketError("bad array size line")
            m, n = (int(p) for p in size_parts)
            data = np.loadtxt(f, dtype=np.float64).reshape(-1)
            if symmetry in ("symmetric", "skew-symmetric"):
                # spec: only the lower triangle (column-major) is stored
                want = m * (m + 1) // 2 if symmetry == "symmetric" \
                    else m * (m - 1) // 2
                if m != n or data.size != want:
                    raise MatrixMarketError("array body size mismatch")
                dense = np.zeros((m, n), dtype=np.float64)
                tri = (np.tril_indices(m) if symmetry == "symmetric"
                       else np.tril_indices(m, -1))
                # column-major triangle order == row-major of the upper
                # triangle of the transpose; fill via sorted (col, row)
                order = np.lexsort((tri[0], tri[1]))
                dense[tri[0][order], tri[1][order]] = data
                dense = dense + dense.T * (
                    -1.0 if symmetry == "skew-symmetric" else 1.0
                )
                if symmetry == "symmetric":
                    dense[np.diag_indices(m)] /= 2.0
                return sp.csc_matrix(dense.astype(dtype))
            if data.size != m * n:
                raise MatrixMarketError("array body size mismatch")
            dense = data.reshape((n, m)).T.astype(dtype)
            return sp.csc_matrix(dense)

    if symmetry in ("symmetric", "skew-symmetric"):
        off = rows != cols
        extra_r, extra_c = cols[off], rows[off]
        extra_v = vals[off]
        if symmetry == "skew-symmetric":
            extra_v = -extra_v
        rows = np.concatenate([rows, extra_r])
        cols = np.concatenate([cols, extra_c])
        vals = np.concatenate([vals, extra_v])

    mat = sp.coo_matrix((vals, (rows, cols)), shape=(m, n), dtype=dtype)
    # duplicate entries are summed by scipy on conversion, matching the
    # triplet-compress behavior of the reference loader
    return mat.tocsc()


def write_matrix_market(
    filename: str,
    mat,
    precision: int = 6,
    comment: str | None = None,
) -> None:
    """Write a sparse matrix in MatrixMarket coordinate/real/general format.

    Mirrors reference WriteMatrixMarketFile (sparse_matrix_io.hpp:71):
    column-major entry order, 1-based indices.
    """
    csc = sp.csc_matrix(mat)
    csc.sort_indices()
    m, n = csc.shape
    coo = csc.tocoo()
    # tocoo from csc yields column-major ordering already; enforce it anyway
    order = np.lexsort((coo.row, coo.col))
    rows = coo.row[order] + 1
    cols = coo.col[order] + 1
    vals = coo.data[order]
    with open(filename, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        if comment:
            for c in comment.splitlines():
                f.write(f"%{c}\n")
        f.write(f"{m} {n} {csc.nnz}\n")
        fmt = f"%d %d %.{precision}g\n"
        for r, c, v in zip(rows, cols, vals):
            f.write(fmt % (r, c, v))
