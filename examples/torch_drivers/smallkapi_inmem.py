"""In-memory SmallkAPI driver.

Port of reference pysmallk/tests/smallkapi_inmem.py: numpy/scipy matrices
straight into NMF without touching disk.

The PyTorch port's copy of examples/drivers/smallkapi_inmem.py: the same
flow through smallk_torch.api, on --device (default cuda).
"""

import argparse
import os
import sys
import tempfile

import numpy as np
import scipy.sparse as sp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from smallk_torch.api import SmallkAPI  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    outdir = tempfile.mkdtemp(prefix="smallkapi_inmem_")
    rng = np.random.RandomState(0)

    api = SmallkAPI(device=args.device)

    # dense numpy matrix
    api.load_matrix(matrix=rng.rand(100, 80))
    api.nmf(8, "BPP", outdir=outdir)
    print("dense W:", api.get_W().shape)

    # scipy sparse matrix
    A = sp.random(200, 150, density=0.05, random_state=rng, format="csc")
    api.load_matrix(matrix=A)
    api.nmf(6, "HALS", outdir=outdir, tol=0.01)
    print("sparse W:", api.get_W().shape)

    # raw CSC buffers (reference sparse-buffer overload)
    csc = A.tocsc()
    api.load_matrix(
        buffer=csc.data, row_indices=csc.indices, col_offsets=csc.indptr,
        height=200, width=150, nz=csc.nnz,
    )
    api.nmf(4, "MU", outdir=outdir, max_iter=200)
    print("buffer W:", api.get_W().shape)
    api.finalize()


if __name__ == "__main__":
    main()
