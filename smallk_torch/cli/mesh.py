"""`--mesh TxD` of the flatclust and hierclust tools: the run sharded over
a terms x docs mesh of T*D ranks (parallel/mesh.py), one process a rank,
each on its card (cuda:LOCAL_RANK), launched by torchrun:

    torchrun --nproc-per-node=4 -m smallk_torch.cli.hierclust_cli ... \\
        --mesh 2x2

Without a launcher's variables, 1x1 runs a world of one.  A T*D other than
the world's size is a usage error (ValueError: exit code 2).
"""

from __future__ import annotations

import contextlib


def add_mesh_argument(parser) -> None:
    parser.add_argument("--mesh", default="", metavar="TxD",
                        help="shard the run over a (terms, docs) mesh of "
                             "T*D ranks, e.g. 2x2 under torchrun "
                             "--nproc-per-node=4")


@contextlib.contextmanager
def mesh_from_args(args):
    """The mesh `--mesh` asks for on `--device` (None without it), left
    when the block ends."""
    if not args.mesh:
        yield None
        return
    from ..parallel.mesh import make_mesh

    try:
        shape = tuple(int(v) for v in args.mesh.lower().split("x"))
    except ValueError:
        shape = ()
    if len(shape) != 2:
        raise ValueError(f"--mesh {args.mesh!r}: expected TxD, e.g. 2x2")
    mesh = make_mesh(shape, device=args.device)
    try:
        yield mesh
    finally:
        mesh.close()
