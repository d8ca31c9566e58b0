"""Delimited (CSV) dense matrix IO.

Reference: common/include/delimited_file.hpp + common/src/delimited_file.cpp.
Conventions preserved:
  - one matrix row per line, comma-separated (row-major lines "to match
    Matlab", delimited_file.hpp:66)
  - scientific notation with configurable precision on write
  - leading blank/comment lines skipped on read (comment chars '#', '%')

The port's own copy of smallk_tpu/io/delimited.py, byte-equal in what it
returns and writes.
"""

from __future__ import annotations

import numpy as np

_COMMENT_CHARS = ("#", "%")


def is_delimited_file(filename: str) -> bool:
    """Extension check (reference IsDelimitedFile, delimited_file.cpp)."""
    return filename.lower().endswith(".csv")


def load_delimited(filename: str, delim: str = ",", dtype=np.float64) -> np.ndarray:
    """Load a dense matrix from a delimited file.

    Returns an (m, n) ndarray.  Skips initial blank and comment lines like
    the reference SkipBlankLinesAndComments.
    """
    with open(filename, "r") as f:
        lines = f.read().splitlines()

    start = 0
    while start < len(lines):
        stripped = lines[start].strip()
        if stripped and not stripped.startswith(_COMMENT_CHARS):
            break
        start += 1
    rows = [ln for ln in lines[start:] if ln.strip()]
    if not rows:
        raise ValueError(f"empty delimited file: {filename}")

    data = [np.array(ln.split(delim), dtype=np.float64) for ln in rows]
    width = len(data[0])
    for i, row in enumerate(data):
        if len(row) != width:
            raise ValueError(
                f"{filename}: row {start + i} has {len(row)} fields, expected {width}"
            )
    return np.vstack(data).astype(dtype)


def write_delimited(
    filename: str,
    matrix: np.ndarray,
    precision: int = 6,
    delim: str = ",",
) -> None:
    """Write a dense matrix one row per line in scientific notation.

    Matches the reference writer's formatting (delimited_file.hpp:48-76:
    std::scientific with 'precision' digits).
    """
    mat = np.asarray(matrix)
    if mat.ndim == 1:
        mat = mat.reshape(-1, 1)
    np.savetxt(filename, mat, fmt=f"%.{precision}e", delimiter=delim)


def write_delimited_ints(filename: str, values, delim: str = ",") -> None:
    """Integer writer (reference WriteDelimitedFile int specialization)."""
    arr = np.asarray(values, dtype=np.int64)
    if arr.ndim == 1:
        arr = arr.reshape(-1, 1)
    np.savetxt(filename, arr, fmt="%d", delimiter=delim)
