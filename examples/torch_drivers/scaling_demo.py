"""Multi-rank scaling demonstration — the port of examples/scaling_demo.py.

Runs the same sharded NMF-BPP solve over increasing meshes of ranks and
prints iterations/sec for each, beside one rank's.  One process a rank,
started here; on the card each rank takes cuda:rank (NCCL), so the meshes
grow up to the cards present.  With --device cpu (or one named card, e.g.
--device cuda:0 --backend gloo) the ranks share that device and the
meshes grow up to --ranks.  The layout is the terms x docs mesh of
smallk_torch.parallel.mesh: each rank holds a block of A, the k x k Grams
and the contracted products are all-reduced.

Run:  python examples/torch_drivers/scaling_demo.py [--device cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np  # noqa: E402


def _rank(rank, world, port, shape, device, backend, size, iters):
    import torch

    from smallk_torch.common.options import NmfAlgorithm, NmfOptions
    from smallk_torch.common.rng import Random, random_matrix
    from smallk_torch.parallel import distributed
    from smallk_torch.parallel.mesh import (make_mesh, shard_factors,
                                            shard_operand)
    from smallk_torch.solvers.solve import nmf_solve

    dev = f"cuda:{rank}" if device == "cuda" else device
    if dev == "cpu":   # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    distributed.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                       backend=backend, device=dev)
    mesh = make_mesh(shape, device=dev)
    m = n = size
    k = 16
    rng = Random(0)
    A = np.abs(random_matrix(m, n, rng, dtype=np.float32))
    W0 = random_matrix(m, k, rng, dtype=np.float32)
    H0 = random_matrix(k, n, rng, dtype=np.float32)
    opts = NmfOptions(tol=1e-30, algorithm=NmfAlgorithm.BPP, height=m,
                      width=n, k=k, min_iter=1, max_iter=iters,
                      verbose=False)
    a_op = shard_operand(A, mesh)

    def run():
        W, H = shard_factors(W0, H0, mesh, torch.float32)
        return nmf_solve(a_op, W, H, opts)

    run()                                   # warm-up (kernel builds)
    mesh.barrier()
    t0 = time.perf_counter()
    r = run()
    if dev != "cpu":
        torch.cuda.synchronize(dev)
    mesh.barrier()
    rate = r.iterations / (time.perf_counter() - t0)
    if mesh.is_coordinator:
        print(f"mesh {shape}: {rate:.1f} iters/sec", flush=True)
    torch.distributed.destroy_process_group()


def main(device="cuda", backend=None, ranks=None, size=4096, iters=50):
    import torch

    from smallk_torch.parallel.distributed import _free_port, spawn_ranks

    if ranks is None:
        ranks = torch.cuda.device_count() if device == "cuda" else 2
    print(f"up to {ranks} rank(s) on {device}")
    shapes = [(1, 1)] + [s for s in ((1, 2), (2, 2), (2, 4), (1, 8))
                         if s[0] * s[1] <= ranks]
    for shape in shapes:
        world = shape[0] * shape[1]
        spawn_ranks(_rank, (world, _free_port(), shape, device, backend,
                            size, iters), world, timeout=900)


if __name__ == "__main__":
    p = argparse.ArgumentParser(description="sharded BPP over meshes")
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default=None)
    p.add_argument("--ranks", type=int, default=None)
    p.add_argument("--size", type=int, default=4096)
    p.add_argument("--iters", type=int, default=50)
    a = p.parse_args()
    main(a.device, a.backend, a.ranks, a.size, a.iters)
