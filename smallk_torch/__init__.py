"""smallk_torch — the PyTorch/CUDA port of smallk_tpu for NVIDIA Hopper.

The JAX package `smallk_tpu` is the reference; this package mirrors its
layout module for module.  Framework-free host code (options, the seeded
RNG, matrix generation, file IO, the CLI exit-code boundary) is shared by
import, not copied, and is re-exported here so that callers of the port
need not name the reference package.  Those modules import only numpy
and scipy.

Library entry points: `smallk_torch.engines.nmf.run_nmf(A, W0, H0, opts,
device=...)` and `smallk_torch.engines.flatclust.run_flatclust(...)`.
"""

from __future__ import annotations

from smallk_tpu.common.options import (  # noqa: F401
    NmfAlgorithm,
    NmfOptions,
    NmfProgressAlgorithm,
    NmfStats,
    Result,
)
from smallk_tpu.common.rng import Random, random_matrix  # noqa: F401
from smallk_tpu.engines.matrixgen import (  # noqa: F401
    generate,
    random_sparse_matrix,
)

__version__ = "0.1.0"
