"""In-memory Flatclust driver.

Port of reference pysmallk/tests/flatclust_inmem.py: loads a dense matrix
as a numpy array (no file round trip for the matrix itself) and clusters
via the Flatclust class with fixed W/H initializers when provided.

The PyTorch port's copy of examples/drivers/flatclust_inmem.py: the same
flow through smallk_torch.api, on --device (default cuda).
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from smallk_torch.api import Flatclust  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    rng = np.random.RandomState(0)
    m, n, k = 256, 256, 16
    matrix = rng.uniform(0.0, 1.0, size=(m, n))
    dictionary = [f"term{i}" for i in range(m)]

    f = Flatclust(device=args.device)
    f.seed(42)
    f.load_matrix(matrix=matrix, column_major=False)
    f.load_dictionary(dictionary=dictionary)
    f.cluster(k, algorithm="HALS", min_iter=1, max_iter=5000,
              verbose=False)

    assign = f.get_assignments()
    print("clusters found:", sorted(set(int(x) for x in assign)))
    terms = f.get_top_indices()
    print("top terms per cluster:")
    for c in range(terms.shape[1]):
        print(f"  cluster {c}:", [dictionary[t] for t in terms[:, c]])


if __name__ == "__main__":
    main()
