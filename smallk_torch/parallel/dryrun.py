"""A dry run of every sharded path at tiny shapes — the port of the JAX
package's `__graft_entry__.dryrun_multichip` on torch.distributed.

`dryrun_multichip(n)` starts n ranks (one process each, on cuda:rank, or
all on an explicit `device`, e.g. "cpu" or "cuda:0" with gloo), lays them
out as a (2, n/2) mesh when n is even, else (1, n), and runs on it:

  - dense BPP to convergence (30 iterations at most);
  - the COO (`SparseAOp`), bucketed-ELL and blocked-ELL operands;
  - hierclust (3 splits), and a checkpoint resume on the mesh that gives
    the uninterrupted tree;
  - flatclust (direct NMF with assignments);
  - preprocess -> sharded NMF.

A rank that fails fails the run (the exception is raised here).

    python -m smallk_torch.parallel.dryrun 2 --device cpu
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import scipy.sparse as sp


def mesh_shape(n: int) -> tuple[int, int]:
    """(2, n/2) for an even n > 1 (terms and docs split), else (1, n)."""
    return (2, n // 2) if n > 1 and n % 2 == 0 else (1, n)


def _rank(rank, world, port, device, backend):
    import torch

    from ..common.options import (
        ClustOptions,
        NmfAlgorithm,
        NmfOptions,
        NmfProgressAlgorithm,
    )
    from ..common.rng import Random
    from ..engines.flatclust import run_flatclust
    from ..engines.hierclust import clust_hier
    from ..engines.preprocess import preprocess_tf
    from ..ops.ell import EllAOp
    from . import distributed
    from .mesh import make_mesh, shard_operand, sharded_nmf_solve

    torch.set_num_threads(1)
    dev = f"cuda:{rank}" if device == "cuda" else device
    distributed.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                       backend=backend, device=dev)
    shape = mesh_shape(world)
    mesh = make_mesh(shape, device=dev)
    try:
        m, n, k = 64, 48, 4
        rng = np.random.RandomState(0)
        A = rng.rand(m, n).astype(np.float32)
        W0 = rng.rand(m, k).astype(np.float32)
        H0 = rng.rand(k, n).astype(np.float32)
        opts = NmfOptions(tol=0.005, algorithm=NmfAlgorithm.BPP, height=m,
                          width=n, k=k, min_iter=1, max_iter=30,
                          verbose=False)
        res = sharded_nmf_solve(A, W0, H0, opts, mesh)
        assert res.W.shape == (m, k) and res.H.shape == (k, n)
        assert not bool(torch.isnan(res.W).any())
        assert res.success and res.iterations > 1

        # the sparse operands, a block a rank: COO, bucketed ELL, and ELL
        # blocked by documents and terms at tiny block sizes
        A_sp = sp.csc_matrix(A * (A > 0.5))
        for op in (
                shard_operand(A_sp, mesh, densify_threshold_bytes=0,
                              sparse_format="coo"),
                shard_operand(A_sp, mesh, densify_threshold_bytes=0),
                shard_operand(EllAOp.from_scipy(A_sp, doc_block=16,
                                                term_block=16, device=dev),
                              mesh, host_A=A_sp)):
            r = sharded_nmf_solve(op, W0, H0, opts, mesh)
            assert not bool(torch.isnan(r.W).any()), type(op.local).__name__
        assert op.local.row_blocks is not None

        # hierclust: 3 splits, then interrupted after one and resumed
        Ab = A * 0.05
        for b in range(4):
            Ab[b * (m // 4):(b + 1) * (m // 4),
               b * (n // 4):(b + 1) * (n // 4)] += 1.0
        copts = ClustOptions(
            nmf_opts=NmfOptions(
                tol=1e-4, algorithm=NmfAlgorithm.RANK2,
                prog_est_algorithm=NmfProgressAlgorithm.PG_RATIO, k=2,
                min_iter=1, max_iter=100, verbose=False),
            num_clusters=4, verbose=False)
        tree, cstats = clust_hier(sp.csc_matrix(Ab), copts, Random(7),
                                  mesh=mesh)
        assert tree.assignments.shape == (n,) and cstats.nmf_count >= 3
        # the coordinator writes the checkpoint and every rank reads it:
        # one path for all
        ck = os.path.join(tempfile.gettempdir(),
                          f"smallk_dryrun_{port}.ckpt.npz")
        try:
            clust_hier(sp.csc_matrix(Ab), copts, Random(7), mesh=mesh,
                       checkpoint_path=ck, _interrupt_after=1)
        except KeyboardInterrupt:
            pass
        assert os.path.exists(ck)
        resumed, _ = clust_hier(sp.csc_matrix(Ab), copts, Random(7),
                                mesh=mesh, checkpoint_path=ck)
        assert (resumed.assignments == tree.assignments).all()
        mesh.barrier()
        if mesh.is_coordinator:
            os.remove(ck)

        # flatclust
        fopts = NmfOptions(tol=1e-3, algorithm=NmfAlgorithm.BPP, height=m,
                           width=n, k=4, min_iter=1, max_iter=30,
                           verbose=False)
        _, _, assigns, fuzzy, ok = run_flatclust(sp.csc_matrix(Ab), W0, H0,
                                                 fopts, mesh=mesh)
        assert ok and assigns.shape == (n,) and fuzzy.shape == (4, n)

        # preprocess -> sharded NMF
        counts = sp.csc_matrix((Ab * 6).astype(np.int64))
        pre = preprocess_tf(counts, docs_per_term=2, terms_per_doc=2,
                            verbose=False)
        mr, nr = pre.matrix.shape
        popts = NmfOptions(tol=1e-3, algorithm=NmfAlgorithm.BPP, height=mr,
                           width=nr, k=4, min_iter=1, max_iter=20,
                           verbose=False)
        rp = np.random.RandomState(3)
        r5 = sharded_nmf_solve(pre.matrix.toarray(), rp.rand(mr, 4),
                               rp.rand(4, nr), popts, mesh)
        assert not bool(torch.isnan(r5.W).any())
        if mesh.is_coordinator:
            print(f"dryrun_multichip OK: mesh {shape} over {world} ranks "
                  f"({mesh.backend}, {dev}): {res.iterations}-iteration BPP "
                  f"(converged={res.converged}) dense + COO + ELL + blocked "
                  f"ELL, 3-split sharded hierclust ({cstats.nmf_count} node "
                  f"factorizations) + checkpoint resume, sharded "
                  f"flatclust, preprocess -> sharded NMF", flush=True)
        mesh.barrier()
    finally:
        torch.distributed.destroy_process_group()


def dryrun_multichip(n_devices: int, device="cuda", backend=None,
                     timeout: float = 600.0) -> None:
    """Run the dry run on a world of `n_devices` ranks (see the module's
    docstring); raises if a rank fails or the run outlives `timeout`."""
    from .distributed import _free_port, spawn_ranks

    spawn_ranks(_rank, (n_devices, _free_port(), device, backend),
                n_devices, timeout)


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_devices", type=int)
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default=None)
    a = p.parse_args()
    dryrun_multichip(a.n_devices, a.device, a.backend)
    sys.exit(0)
