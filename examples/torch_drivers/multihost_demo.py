"""Multi-process (multi-host) NMF demonstration — the port of
examples/multihost_demo.py.

Validates the distributed path end to end on one machine by running two
"hosts" as two OS processes joined into one world by
`initialize_distributed`, laid out as a 2 x 1 (terms x docs) mesh: each
process moves only its block of the host matrix (`shard_host_matrix`)
and its blocks of the factors.  On real hosts, launch the worker body on
every host with torchrun instead (it sets the coordinator, the world size
and the ranks), one process a card:

    torchrun --nnodes=2 --nproc-per-node=4 ... your_script.py
        initialize_distributed()                   # from the launcher
        mesh = make_mesh((2, 4))                   # hosts x cards
        a_op = shard_host_matrix(A, mesh)          # this rank's block
        res  = nmf_solve(a_op, *shard_factors(W0, H0, mesh), opts)

Run:  python examples/torch_drivers/multihost_demo.py [--device cpu]
"""

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def worker(pid: int, port: int, device: str, backend) -> None:
    import numpy as np
    import torch

    from smallk_torch.common.options import NmfAlgorithm, NmfOptions
    from smallk_torch.common.rng import Random, random_matrix
    from smallk_torch.parallel.distributed import (initialize_distributed,
                                                   shard_host_matrix)
    from smallk_torch.parallel.mesh import make_mesh, shard_factors
    from smallk_torch.solvers.solve import nmf_solve

    dev = f"cuda:{pid}" if device == "cuda" else device
    initialize_distributed(f"127.0.0.1:{port}", 2, pid, backend=backend,
                           device=dev)
    mesh = make_mesh((2, 1), device=dev)   # hosts x local ranks
    print(f"[p{pid}] rank {mesh.rank} of {mesh.size} at {mesh.coords} on "
          f"{mesh.device} ({mesh.backend})", flush=True)
    rng = Random(0)
    m, n, k = 64, 48, 4
    A = np.abs(random_matrix(m, n, rng, dtype=np.float32))
    W0 = random_matrix(m, k, rng, dtype=np.float32)
    H0 = random_matrix(k, n, rng, dtype=np.float32)
    a_op = shard_host_matrix(A, mesh, dtype=torch.float32)
    W, H = shard_factors(W0, H0, mesh, torch.float32)
    opts = NmfOptions(tol=0.005, algorithm=NmfAlgorithm.BPP, height=m,
                      width=n, k=k, min_iter=2, max_iter=20, verbose=False)
    res = nmf_solve(a_op, W, H, opts)
    print(f"[p{pid}] OK: {res.iterations} BPP iterations on the 2x1 mesh "
          f"(W rows {a_op.rows}, H columns {a_op.cols})", flush=True)
    torch.distributed.destroy_process_group()


def main(device="cuda", backend=None) -> None:
    from smallk_torch.parallel.distributed import _free_port

    port = _free_port()
    extra = ["--device", device] + (["--backend", backend] if backend
                                    else [])
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--worker", str(pid), "--port", str(port),
                               *extra])
             for pid in range(2)]
    try:
        codes = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(codes):
        raise SystemExit(f"worker failures: {codes}")
    print("multihost demo OK")


if __name__ == "__main__":
    p = argparse.ArgumentParser(description="two-process sharded NMF")
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default=None)
    p.add_argument("--worker", type=int, default=None)
    p.add_argument("--port", type=int, default=None)
    a = p.parse_args()
    if a.worker is None:
        main(a.device, a.backend)
    else:
        worker(a.worker, a.port, a.device, a.backend)
