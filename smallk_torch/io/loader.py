"""File-type sniffing loader.

Reference: common/include/file_loader.hpp:10-40 (IsDense/IsSparse dispatch by
extension).  Sparse files (.mtx) load as scipy CSC; dense files (.csv) as
numpy arrays.

The port's own copy of smallk_tpu/io/loader.py, byte-equal in what it
returns and writes.
"""

from __future__ import annotations

import numpy as np

from .delimited import is_delimited_file, load_delimited
from .matrix_market import load_matrix_market


def is_sparse_file(filename: str) -> bool:
    return filename.lower().endswith(".mtx")


def is_dense_file(filename: str) -> bool:
    return is_delimited_file(filename)


def load_matrix(filename: str, dtype=np.float64):
    """Load a matrix from file; returns scipy CSC for .mtx, ndarray for .csv."""
    if is_sparse_file(filename):
        return load_matrix_market(filename, dtype=dtype)
    if is_dense_file(filename):
        return load_delimited(filename, dtype=dtype)
    raise ValueError(f"unsupported matrix file type: {filename}")


def load_strings(filename: str) -> list[str]:
    """Load newline-separated strings (reference LoadStringsFromFile)."""
    with open(filename, "r") as f:
        return [line.rstrip("\n") for line in f if line.strip()]
