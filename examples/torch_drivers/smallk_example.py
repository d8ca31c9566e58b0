"""End-to-end walkthrough of the smallk_torch facade API.

The PyTorch port's copy of examples/smallk_example.py (itself a port of
the reference examples/smallk_example.cpp): loads a term-doc matrix, runs
NMF (BPP, then rank-2 with fixed initializers, then HALS with a custom
tolerance), then hierarchical clustering with flat results, on --device
(default cuda).

Usage:
    python examples/torch_drivers/smallk_example.py <path_to_data_dir>
        [--device cpu]
    python examples/torch_drivers/smallk_example.py --synthetic

The data dir should contain reuters.mtx + reuters_dictionary.txt (from
the smallk_data distribution), or pass --synthetic to generate a stand-in
corpus so the example is runnable without external data.
"""

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import smallk_torch as smallk  # noqa: E402

FILENAME_W = "nmf_rank2_init_w.csv"
FILENAME_H = "nmf_rank2_init_h.csv"
FILENAME_MATRIX = "reuters.mtx"
FILENAME_DICT = "reuters_dictionary.txt"


def msg_box(msg):
    print("\n" + "*" * 40)
    print(f"*  {msg}")
    print("*" * 40 + "\n")


def make_synthetic(data_dir):
    """Generate a stand-in corpus when smallk_data is unavailable."""
    import scipy.sparse as sp

    from smallk_torch.io.delimited import write_delimited
    from smallk_torch.io.matrix_market import write_matrix_market

    rng = np.random.RandomState(0)
    m, n = 1200, 800
    A = sp.random(m, n, density=0.02, random_state=rng, format="csc")
    A.data = np.ceil(A.data * 9)
    write_matrix_market(os.path.join(data_dir, FILENAME_MATRIX), A)
    with open(os.path.join(data_dir, FILENAME_DICT), "w") as f:
        for i in range(m):
            f.write(f"term{i}\n")
    write_delimited(os.path.join(data_dir, FILENAME_W), rng.rand(m, 2), 15)
    write_delimited(os.path.join(data_dir, FILENAME_H), rng.rand(2, n), 15)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("data_dir", nargs="?",
                   help="a directory with reuters.mtx and "
                   "reuters_dictionary.txt")
    p.add_argument("--synthetic", action="store_true",
                   help="generate a stand-in corpus instead")
    p.add_argument("--device", default="cuda",
                   help="cuda (default), cuda:N or cpu")
    args = p.parse_args(argv)
    if (args.data_dir is None) == (not args.synthetic):
        p.error("give a data directory or --synthetic")

    if args.synthetic:
        data_dir = tempfile.mkdtemp(prefix="smallk_example_")
        make_synthetic(data_dir)
    else:
        data_dir = args.data_dir

    smallk.Initialize(device=args.device)
    assert smallk.IsInitialized()

    print("Smallk major version:", smallk.GetMajorVersion())
    print("Smallk minor version:", smallk.GetMinorVersion())
    print("Smallk patch level:  ", smallk.GetPatchLevel())
    print("Smallk version string:", smallk.GetVersionString())

    smallk.SetOutputDir(data_dir)
    smallk.LoadMatrix(os.path.join(data_dir, FILENAME_MATRIX))
    assert smallk.IsMatrixLoaded()

    msg_box("Running NMF-BPP with k=32")
    smallk.SeedRNG(42)
    smallk.Nmf(32, smallk.Algorithm.BPP)
    W = smallk.LockedBufferW()
    print("W factor:", W.shape)

    msg_box("Running NMF-RANK2 with W and H initializers")
    smallk.Nmf(
        2, smallk.Algorithm.RANK2,
        os.path.join(data_dir, FILENAME_W),
        os.path.join(data_dir, FILENAME_H),
    )

    msg_box("Running NMF-HALS with k=16, tol=1e-5")
    smallk.SetNmfTolerance(1.0e-5)
    smallk.Nmf(16, smallk.Algorithm.HALS)

    msg_box("Running HierNmf2 with 5 clusters, JSON format")
    smallk.SetNmfTolerance(0.005)
    smallk.LoadDictionary(os.path.join(data_dir, FILENAME_DICT))
    smallk.SetOutputFormat(smallk.OutputFormat.JSON)
    smallk.HierNmf2WithFlat(5)
    print("'assignments_5.csv', 'tree_5.json', flat results written to",
          data_dir)

    smallk.Finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
