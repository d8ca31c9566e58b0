"""Large-corpus NMF demonstration: the flagship-scale flow, downscaled.

The PyTorch port's copy of examples/large_corpus_demo.py, on --device
(default cuda).  Shows the pieces a production run at 50k terms x 1M docs
uses:

  - bucketed-ELL operand with doc/term locality blocking
    (`EllAOp.from_scipy`; blocks force-enabled here so the demo
    exercises the blocked gather paths at toy size); on the card every
    product is the ell_spmm kernel
  - bf16 A-storage (halves the product streams; factor math stays f32)
  - BPP, whose masked solves go to the K1 kernel on the card
  - periodic checkpointing with resume
    (`common.checkpoint.run_nmf_with_checkpointing`)

Run:  python examples/torch_drivers/large_corpus_demo.py [--device cpu]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np  # noqa: E402
import scipy.sparse as sp  # noqa: E402

from smallk_torch.common.checkpoint import (  # noqa: E402
    run_nmf_with_checkpointing,
)
from smallk_torch.common.options import NmfAlgorithm, NmfOptions  # noqa: E402
from smallk_torch.common.rng import Random, random_matrix  # noqa: E402
from smallk_torch.ops.ell import EllAOp  # noqa: E402


def main(m=3000, n=4000, k=16, nz_per_col=30, iters=40, device="cuda"):
    # bulk corpus sampler (matrixgen's exact rejection sampler is the
    # fidelity path; at demo scale either works)
    gs = np.random.RandomState(7)
    A = sp.csc_matrix(
        (gs.rand(n * nz_per_col).astype(np.float32),
         gs.randint(0, m, n * nz_per_col).astype(np.int32),
         np.arange(0, n * nz_per_col + 1, nz_per_col, dtype=np.int64)),
        shape=(m, n))
    A.sum_duplicates()

    # blocked bucketed-ELL: doc_block/term_block default to "auto"
    # (128k+ axes); forced small here so the demo runs the same blocked
    # gather code the 1M-doc benchmark uses
    op = EllAOp.from_scipy(A, dtype="bfloat16", doc_block=1024,
                           term_block=1024, device=device)
    print(f"operand: {m}x{n}, {A.nnz} nnz, "
          f"{len(op.row_blocks)} doc-blocks x "
          f"{len(op.col_blocks)} term-blocks on {op.device}")

    rng = Random(42)
    W0 = random_matrix(m, k, rng, dtype=np.float64)
    H0 = random_matrix(k, n, rng, dtype=np.float64)
    opts = NmfOptions(
        tol=1e-9, algorithm=NmfAlgorithm.BPP, height=m, width=n, k=k,
        min_iter=1, max_iter=iters, verbose=False, a_dtype="bfloat16",
        dtype="float32",
    )

    with tempfile.TemporaryDirectory() as td:
        ckpt = os.path.join(td, "nmf.npz")
        # the run executes in segments of `checkpoint_every` iterations
        # with an atomic checkpoint (W, H, iteration, options
        # fingerprint) after each — a preempted process restarts from
        # the last segment boundary instead of iteration 0
        W, H, total, success = run_nmf_with_checkpointing(
            op, W0, H0, opts, ckpt, checkpoint_every=10)
        print(f"run:    {total} iterations, success={success} "
              f"(checkpoint at {ckpt})")

        # a restart after completion resumes from the checkpoint and
        # returns immediately — no recomputation
        W, H, total, success = run_nmf_with_checkpointing(
            op, W0, H0, opts, ckpt, checkpoint_every=10)
        print(f"resume: returns at iteration {total} without re-solving")
    assert (W >= 0).all() and (H >= 0).all()
    rel = (sp.linalg.norm(A - sp.csc_matrix(W.astype(np.float64)
                                            @ H.astype(np.float64))) /
           sp.linalg.norm(A))
    print(f"relative reconstruction error: {rel:.4f}")
    return W, H, total, success


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default), cuda:N or cpu")
    main(device=p.parse_args().device)
