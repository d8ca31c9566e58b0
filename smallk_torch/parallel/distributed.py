"""Multi-process execution — port of smallk_tpu/parallel/distributed.py on
torch.distributed.

One process a rank, every rank running the same program, as the JAX
package runs one process a host of a pod.  `initialize_distributed` joins
the world's process group: NCCL for a CUDA device, gloo for the CPU, or
the backend the caller names (gloo on CUDA lets ranks share one card).
Nothing picks a backend or a device on its own beyond that rule.

Launched by torchrun (it sets MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK
and LOCAL_RANK), every process runs:

    from smallk_torch.parallel import mesh
    m = mesh.make_mesh((2, 2))          # joins the world on cuda:LOCAL_RANK
    res = mesh.sharded_nmf_solve(A, W0, H0, opts, m)

Without a launcher, pass the coordinator's address, the world size and the
rank; with neither, a world of one.
"""

from __future__ import annotations

import os
import socket
import time
from typing import Optional

import torch
import torch.distributed as dist

from ..common.device import setup


def default_backend(device) -> str:
    """nccl on a CUDA device, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launcher_world() -> int:
    """The world size the launcher set (WORLD_SIZE), else 1."""
    return int(os.environ.get("WORLD_SIZE", 1))


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           backend: Optional[str] = None,
                           device="cuda") -> None:
    """Join the world's process group (once a process, before the mesh).

    `coordinator_address` ("host:port"), `num_processes` and `process_id`
    default to the launcher's MASTER_ADDR:MASTER_PORT, WORLD_SIZE and RANK;
    with no launcher, a world of one on a free local port.  `backend`
    defaults to `default_backend(device)`; NCCL needs a CUDA device, and a
    CUDA device needs a card (no fallback to the CPU)."""
    dev = setup(device)
    backend = backend or default_backend(dev)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"backend nccl needs a CUDA device, not {device!r}")
    env = os.environ
    if coordinator_address is None:
        if "MASTER_ADDR" in env and "MASTER_PORT" in env:
            coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        elif launcher_world() == 1:
            coordinator_address = f"127.0.0.1:{_free_port()}"
        else:
            raise ValueError("WORLD_SIZE is set but MASTER_ADDR and "
                             "MASTER_PORT are not")
    world = num_processes if num_processes is not None else launcher_world()
    rank = process_id if process_id is not None else int(env.get("RANK", 0))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank)


def shard_host_matrix(A, mesh, dtype=None):
    """The canonical sharded operand from the host matrix every process
    holds: each rank moves only its block to its device, densified (the
    JAX package's `make_array_from_process_local_data` layout)."""
    from .mesh import shard_operand

    return shard_operand(A, mesh, dtype or torch.float32,
                         densify_threshold_bytes=float("inf"))


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    """Rank 0 of the world, or a process outside any world."""
    return not dist.is_initialized() or dist.get_rank() == 0


def spawn_ranks(fn, args, nprocs: int, timeout: float) -> None:
    """Run fn(rank, *args) in `nprocs` fresh processes (spawned, so each
    imports fn's module anew) and wait for all: a rank that raises fails
    the call, and ranks still running after `timeout` seconds are killed
    and the call raises TimeoutError."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{nprocs} ranks still running after "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
