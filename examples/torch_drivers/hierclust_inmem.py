"""In-memory Hierclust driver.

Port of reference pysmallk/tests/hierclust_inmem.py: builds the matrix and
dictionary in memory (no files) and clusters via the Hierclust class.

The PyTorch port's copy of examples/drivers/hierclust_inmem.py: the same
flow through smallk_torch.api, on --device (default cuda).
"""

import argparse
import os
import sys

import numpy as np
import scipy.sparse as sp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from smallk_torch.api import Hierclust  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    rng = np.random.RandomState(0)
    m, n, k = 300, 400, 6
    A = sp.random(m, n, density=0.05, random_state=rng, format="csc")
    A.data = np.ceil(A.data * 9)
    dictionary = [f"term{i}" for i in range(m)]

    hc = Hierclust(device=args.device)
    hc.seed(42)
    hc.load_matrix(matrix=A)
    hc.load_dictionary(dictionary=dictionary)
    hc.cluster(k, verbose=False, flat=1)

    labels = hc.get_assignments()
    print("clusters found:", sorted(set(int(x) for x in labels if x >= 0)))
    print("outliers:", int((labels < 0).sum()))
    print("top terms per leaf:")
    terms = hc.get_top_indices()
    for c in range(terms.shape[1]):
        print(f"  leaf {c}:", [dictionary[t] for t in terms[:, c]])


if __name__ == "__main__":
    main()
