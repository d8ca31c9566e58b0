"""smallk_torch — the PyTorch/CUDA port of smallk_tpu for NVIDIA Hopper.

The JAX package `smallk_tpu` is the reference; this package mirrors its
layout module for module and never imports it.  The framework-free host
code (options, the seeded RNG, matrix and corpus generation, file IO,
checkpoint files, scoring, the CLI exit-code boundary) is the port's own
copy of the reference's numpy/scipy modules, and is re-exported here.
Option objects of the reference map onto the port's with
`interop.options_from_reference`.

Library entry points, all on the card unless `device="cpu"` is passed:
`engines.nmf.run_nmf`, `engines.flatclust.run_flatclust`,
`engines.flatclust.run_hier_nmf2` and `engines.hierclust.clust_hier`.
"""

from __future__ import annotations

from .common.options import (  # noqa: F401
    ClustOptions,
    ClustStats,
    NmfAlgorithm,
    NmfOptions,
    NmfProgressAlgorithm,
    NmfStats,
    OutputFormat,
    Result,
)
from .common.rng import Random, random_matrix  # noqa: F401
from .engines.matrixgen import (  # noqa: F401
    generate,
    random_sparse_matrix,
)

__version__ = "0.1.0"
