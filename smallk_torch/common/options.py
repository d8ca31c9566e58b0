"""Options, enums, result codes, and stats of the port.

The port's own copy of smallk_tpu/common/options.py (same classes, fields
and defaults; the port never imports the JAX package).  The option
structs mirror the reference's:
  - NmfOptions      (reference: common/include/nmf.hpp:55-69)
  - ClustOptions    (reference: hierclust/include/clust.hpp:37-47)
  - NmfStats        (reference: common/include/nmf.hpp:43-53)
  - ClustStats      (reference: hierclust/include/clust.hpp:26-35)
  - enums           (reference: common/include/nmf.hpp:17-41)

These are frozen (hashable) dataclasses; all runtime state lives in
tensors, never in options.  The enums are this package's own classes: an
option object of the JAX package compares unequal to the port's enums, so
hand one to the port through `interop.options_from_reference`.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class NmfAlgorithm(enum.Enum):
    """NMF update algorithms (reference: common/include/nmf.hpp:28-34)."""

    MU = "MU"
    HALS = "HALS"
    RANK2 = "RANK2"
    BPP = "BPP"


class NmfProgressAlgorithm(enum.Enum):
    """Convergence metrics (reference: common/include/nmf.hpp:36-41)."""

    PG_RATIO = "PG_RATIO"
    DELTA_FNORM = "DELTA_FNORM"


class Result(enum.IntEnum):
    """Result codes (reference: common/include/nmf.hpp:17-26)."""

    OK = 0
    FAILURE = 1
    BAD_PARAM = 2
    NOTINITIALIZED = 3
    INITIALIZE_ERROR = 4
    SIZE_TOO_LARGE = 5


class OutputFormat(enum.Enum):
    """Clustering result file formats (reference: smallk/include/smallk.hpp)."""

    XML = "XML"
    JSON = "JSON"


# Default values mirror the reference smallk facade defaults
# (reference: smallk/include/smallk.hpp:102-311).
DEFAULT_TOL = 0.005
DEFAULT_HIER_TOL = 1.0e-4
DEFAULT_MAX_ITER = 5000
DEFAULT_MIN_ITER = 5
DEFAULT_TOL_COUNT = 1
DEFAULT_PRECISION = 6
DEFAULT_MAX_TERMS = 5
DEFAULT_UNBALANCED = 0.1
DEFAULT_TRIAL_ALLOWANCE = 3


@dataclasses.dataclass(frozen=True)
class NmfOptions:
    """Canonical NMF run configuration.

    Mirrors the reference NmfOptions (common/include/nmf.hpp:55-69) with the
    same field names and defaults; adds TPU-specific `dtype` (the reference
    hardwires double, common/src/nmf.cpp:33) and `check_interval` (how often
    the on-device while-loop evaluates the progress metric; 1 == reference
    behavior).
    """

    tol: float = DEFAULT_TOL
    algorithm: NmfAlgorithm = NmfAlgorithm.BPP
    prog_est_algorithm: NmfProgressAlgorithm = NmfProgressAlgorithm.PG_RATIO
    height: int = 0  # m, rows of A
    width: int = 0  # n, cols of A
    k: int = 0
    min_iter: int = DEFAULT_MIN_ITER
    max_iter: int = DEFAULT_MAX_ITER
    tolcount: int = DEFAULT_TOL_COUNT
    max_threads: int = 8  # kept for API parity; maps to nothing on TPU
    verbose: bool = True
    normalize: bool = True
    dtype: str = "float32"
    check_interval: int = 1
    # Storage dtype for the A operand only (None = same as `dtype`).
    # "bfloat16" halves HBM traffic of the dominant W'A / AH' streams with
    # f32 accumulation; factors, Grams and solves stay in `dtype`.
    a_dtype: Optional[str] = None
    # Stop after this many consecutive progress checks without >1% metric
    # improvement (None = reference behavior: run to max_iter).  Useful in
    # float32, where the progress metric can floor above a tight tolerance
    # and the reference semantics would burn the full iteration budget.
    stall_patience: Optional[int] = None
    # Solver steps executed per while-loop trip (0 = auto).  The loop
    # machinery costs a fixed floor per trip on the device; small/thin
    # problems are floor-bound, and running U steps per trip amortizes
    # it U-fold.  Semantics are IDENTICAL to unroll=1: every step still
    # runs its own progress check and the converged/failed freeze makes
    # overshoot steps no-ops (<= U-1 wasted step-executions at the
    # end).  Auto picks U from the per-step work estimate.
    loop_unroll: int = 0

    def validate(self) -> None:
        """Raise ValueError for invalid combinations.

        Mirrors reference NmfOptions::IsValid (common/src/nmf_options.cpp).
        """
        if self.height <= 0 or self.width <= 0:
            raise ValueError("nmf: matrix dimensions must be positive")
        if self.k <= 0:
            raise ValueError("nmf: k must be positive")
        if self.k > min(self.height, self.width):
            raise ValueError(
                "nmf: k must satisfy k <= min(m, n); "
                f"k={self.k}, m={self.height}, n={self.width}"
            )
        if self.algorithm == NmfAlgorithm.RANK2 and self.k != 2:
            raise ValueError("nmf: RANK2 algorithm requires k == 2")
        if self.tol <= 0.0 or self.tol >= 1.0:
            raise ValueError("nmf: tolerance must be in (0, 1)")
        if self.min_iter < 1:
            raise ValueError("nmf: min_iter must be >= 1")
        if self.max_iter < self.min_iter:
            raise ValueError("nmf: max_iter must be >= min_iter")
        if self.tolcount < 1:
            raise ValueError("nmf: tolcount must be >= 1")


@dataclasses.dataclass(frozen=True)
class ClustOptions:
    """Hierarchical clustering configuration.

    Mirrors reference ClustOptions (hierclust/include/clust.hpp:37-47).
    """

    nmf_opts: NmfOptions = dataclasses.field(
        default_factory=lambda: NmfOptions(
            tol=DEFAULT_HIER_TOL,
            algorithm=NmfAlgorithm.RANK2,
            prog_est_algorithm=NmfProgressAlgorithm.PG_RATIO,
            k=2,
        )
    )
    maxterms: int = DEFAULT_MAX_TERMS
    unbalanced: float = DEFAULT_UNBALANCED
    trial_allowance: int = DEFAULT_TRIAL_ALLOWANCE
    num_clusters: int = 0
    verbose: bool = True
    flat: bool = False
    initdir: Optional[str] = None
    # Node-initializer policy (extension beyond the reference, which only
    # has uniform random, clust_hier_generic.hpp:548-566):
    #   "random"   — reference behavior (default).  Different seeds explore
    #     different local optima, which matters on spectrally-degenerate
    #     operands (e.g. balanced community graphs, sigma2 ~= sigma3).
    #   "spectral" — rank-2 init from the node's top-2 singular pair
    #     (solvers/rank2.spectral_init_rank2); cuts iteration counts on
    #     text-like corpora, but is deterministic — it always lands in the
    #     same basin, so prefer "random" when split quality on degenerate
    #     data matters more than speed.  Retries and initdir runs always
    #     use the reference's random/file initializers.
    init_method: str = "random"
    # Leaf-pop priority policy (extension beyond the reference, which
    # always pops the max-NDCG leaf, clust_hier_generic.hpp:165-178):
    #   "ndcg"      — reference behavior (default): pop the leaf whose
    #     split scored the highest term-ranking NDCG.  Right for text,
    #     where NDCG measures topic coherence.
    #   "size_ndcg" — pop priority = NDCG * |docs|.  On graph adjacency
    #     operands NDCG is near-noise (columns are not ranked term
    #     vectors), and a pure-NDCG pop can starve a leaf holding half
    #     the corpus while re-splitting tiny slivers (measured: NMI 0.12
    #     on a planted-partition graph).  Size-scaling makes starvation
    #     impossible while preserving NDCG's ordering among equal-size
    #     leaves.  The outlier-drop gate (TrialSplit) still compares raw
    #     NDCG values — only the pop order changes.
    priority_method: str = "ndcg"
    # Best-of-R node restarts (extension; the reference restarts only on
    # hard solver FAILURE, clust_hier_generic.hpp:435-472).  When > 1,
    # every node factorization runs `restarts` random initializations
    # batched in one device program and keeps the one with the lowest
    # rank-2 reconstruction objective.  Rank-2 NMF on spectrally
    # degenerate operands (balanced community graphs) has many local
    # optima whose split quality varies wildly between seeds; best-of-R
    # turns the seed lottery into a max over R draws.  Costs R x device
    # work per node; leave at 1 for text corpora.
    restarts: int = 1
    # What to do when a node factorization fails every retry (singular
    # 2x2 systems on structurally degenerate subsets, e.g. duplicate
    # columns):
    #   "abort" — reference behavior (default): the whole clustering
    #     run errors out (clust_hier_generic.hpp:123-151 returns false).
    #   "leaf"  — production behavior: the unsplittable node becomes a
    #     permanent leaf (priority -2, like an exhausted TrialSplit)
    #     and the run continues.  The graph preset uses this: planted
    #     and real-world graphs routinely contain duplicate-neighborhood
    #     node groups that no rank-2 solve can split.
    on_node_failure: str = "abort"

    def validate(self) -> None:
        """Mirrors reference ClustOptions::IsValid (hierclust/src/clust_options.cpp)."""
        if self.init_method not in ("spectral", "random"):
            raise ValueError(
                "clust: init_method must be 'spectral' or 'random'"
            )
        if self.on_node_failure not in ("abort", "leaf"):
            raise ValueError(
                "clust: on_node_failure must be 'abort' or 'leaf'"
            )
        if self.priority_method not in ("ndcg", "size_ndcg"):
            raise ValueError(
                "clust: priority_method must be 'ndcg' or 'size_ndcg'"
            )
        if self.restarts < 1:
            raise ValueError("clust: restarts must be >= 1")
        if self.num_clusters < 2:
            raise ValueError("clust: number of clusters must be >= 2")
        if self.maxterms < 1:
            raise ValueError("clust: maxterms must be >= 1")
        if self.unbalanced < 0.0 or self.unbalanced > 1.0:
            raise ValueError("clust: unbalanced must be in [0, 1]")
        if self.trial_allowance < 1:
            raise ValueError("clust: trial_allowance must be >= 1")


@dataclasses.dataclass
class NmfStats:
    """Timing/iteration stats (reference: common/include/nmf.hpp:43-53)."""

    elapsed_us: int = 0
    iteration_count: int = 0
    # beyond the reference: cumulative NNLS pivot rounds across the solve
    # (BPP only; 0 for MU/HALS/RANK2).  pivot_rounds / iteration_count is
    # the wide-matrix solve-tier telemetry: each round is one masked
    # solve + sign-test pass over the active slab.
    pivot_rounds: int = 0


@dataclasses.dataclass
class ClustStats:
    """Hier clustering stats (reference: hierclust/include/clust.hpp:26-35)."""

    nmf_count: int = 0  # number of rank-2 factorizations performed
    max_count: int = 0  # factorizations that hit the iteration limit
    iter_count: int = 0  # total rank-2 iterations across factorizations
    # (beyond the reference's ClustStats: supports iterations/sec
    # reporting for the hierclust benchmarks)
