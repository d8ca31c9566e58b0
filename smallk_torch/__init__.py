"""smallk_torch — the PyTorch/CUDA port of smallk_tpu for NVIDIA Hopper.

The JAX package `smallk_tpu` is the reference; this package mirrors its
layout module for module and never imports it.  The framework-free host
code (options, the seeded RNG, matrix and corpus generation, file IO,
checkpoint files, scoring, the CLI exit-code boundary) is the port's own
copy of the reference's numpy/scipy modules, and is re-exported here.
Option objects of the reference map onto the port's with
`interop.options_from_reference`.

Top-level facade mirroring the reference `smallk` namespace API
(reference: smallk/include/smallk.hpp:60-332, smallk/src/smallk.cpp),
ported from smallk_tpu/__init__.py: stateful module-level functions
(Initialize/LoadMatrix/Nmf/HierNmf2/...) with the same names, defaults,
validation and output files.  The state adds one field, the device,
set by `Initialize(device="cuda")`; the facade runs on the card unless
it is initialized with `device="cpu"`.

Library entry points, all on the card unless `device="cpu"` is passed:
`engines.nmf.run_nmf`, `engines.flatclust.run_flatclust`,
`engines.flatclust.run_hier_nmf2` and `engines.hierclust.clust_hier`.

`HierNmf2(..., mesh=)` and `HierNmf2WithFlat(..., mesh=)` run sharded over
a `parallel.mesh.Mesh` of ranks, every rank in the same program; only the
mesh's coordinator writes the output files.

Not ported: the reference's persistent XLA compile cache has no
counterpart.
"""

from __future__ import annotations

import enum
import os as _os

import numpy as _np

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
VERSION_MAJOR, VERSION_MINOR, VERSION_PATCH = (
    int(x) for x in __version__.split(".")
)


class Algorithm(enum.Enum):
    """Reference: smallk::Algorithm (smallk.hpp:34-43)."""

    MU = "MU"
    HALS = "HALS"
    RANK2 = "RANK2"
    BPP = "BPP"


# ---------------------------------------------------------------------------
# module state (reference: statics in smallk.cpp:46-71)
# ---------------------------------------------------------------------------
class _State:
    def __init__(self, device="cuda"):
        self.initialized = False
        self.matrix = None          # ndarray or scipy sparse
        self.W = None
        self.H = None
        self.dictionary = None
        self.rng = Random()
        self.output_precision = 6
        self.nmf_tolerance = 0.005
        self.max_iter = 5000
        self.min_iter = 5
        self.max_threads = _os.cpu_count() or 8
        self.hier_tolerance = 1.0e-4
        self.max_terms = 5
        self.output_dir = "."
        self.output_format = OutputFormat.JSON
        self.dtype = "float32"
        self.device = device        # the engines' device


_state = _State()


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------
def Initialize(*args, device="cuda") -> None:
    """Reference: smallk::Initialize (smallk.cpp:114).  Resets the facade
    state; `device` ("cuda", "cuda:N", "cpu") is where every later call
    runs."""
    global _state
    _state = _State(device)
    _state.initialized = True


def IsInitialized() -> bool:
    return _state.initialized


def Finalize() -> None:
    global _state
    _state = _State()


def Reset() -> None:
    """Restore all defaults (reference smallk::Reset); the device stays."""
    init = _state.initialized
    Initialize(device=_state.device)
    _state.initialized = init


def GetMajorVersion() -> int:
    return VERSION_MAJOR


def GetMinorVersion() -> int:
    return VERSION_MINOR


def GetPatchLevel() -> int:
    return VERSION_PATCH


def GetVersionString() -> str:
    return __version__


def SeedRNG(seed: int) -> None:
    _state.rng.seed_from_int(seed)


# ---------------------------------------------------------------------------
# getters / setters (reference smallk.hpp:97-311, same defaults)
# ---------------------------------------------------------------------------
def GetOutputPrecision() -> int:
    return _state.output_precision


def SetOutputPrecision(num_digits: int = 6) -> None:
    _state.output_precision = int(num_digits)


def GetNmfTolerance() -> float:
    return _state.nmf_tolerance


def SetNmfTolerance(tol: float = 0.005) -> None:
    if not (0.0 < tol < 1.0):
        raise ValueError("smallk error (SetNmfTolerance): invalid tolerance")
    _state.nmf_tolerance = float(tol)


def GetMaxIter() -> int:
    return _state.max_iter


def SetMaxIter(max_iterations: int = 5000) -> None:
    _state.max_iter = int(max_iterations)


def GetMinIter() -> int:
    return _state.min_iter


def SetMinIter(min_iterations: int = 5) -> None:
    _state.min_iter = int(min_iterations)


def GetMaxThreads() -> int:
    return _state.max_threads


def SetMaxThreads(max_threads: int) -> None:
    _state.max_threads = int(max_threads)


def GetHierNmf2Tolerance() -> float:
    return _state.hier_tolerance


def SetHierNmf2Tolerance(tol: float = 0.0001) -> None:
    if not (0.0 < tol < 1.0):
        raise ValueError(
            "smallk error (SetHierNmf2Tolerance): invalid tolerance"
        )
    _state.hier_tolerance = float(tol)


def GetMaxTerms() -> int:
    return _state.max_terms


def SetMaxTerms(max_terms: int = 5) -> None:
    _state.max_terms = int(max_terms)


def GetOutputDir() -> str:
    return _state.output_dir


def SetOutputDir(outdir: str) -> None:
    _state.output_dir = outdir or "."


def GetOutputFormat() -> OutputFormat:
    return _state.output_format


def SetOutputFormat(fmt: OutputFormat = OutputFormat.JSON) -> None:
    _state.output_format = fmt


# ---------------------------------------------------------------------------
# matrix loading (reference smallk.cpp:170-334)
# ---------------------------------------------------------------------------
def _require_init():
    if not _state.initialized:
        raise RuntimeError("smallk error: call smallk.Initialize() first")


def LoadMatrix(*args, **kwargs) -> None:
    """Load the input matrix.

    Forms (mirroring the three reference overloads):
      LoadMatrix(filepath)                      — .mtx or .csv file
      LoadMatrix(buffer, ldim, height, width)   — dense column-major buffer
      LoadMatrix(height, width, nz, data, row_indices, col_offsets) — CSC
      LoadMatrix(matrix=ndarray_or_scipy)       — direct object
    """
    _require_init()
    import scipy.sparse as sp

    if "matrix" in kwargs:
        _state.matrix = kwargs["matrix"]
        return
    if len(args) == 1 and isinstance(args[0], str):
        from .io.loader import load_matrix

        _state.matrix = load_matrix(args[0])
        return
    if len(args) == 1:
        _state.matrix = args[0]
        return
    if len(args) == 4:
        buffer, ldim, height, width = args
        buf = _np.asarray(buffer, dtype=_np.float64).reshape(-1)
        cols = [buf[c * ldim: c * ldim + height] for c in range(width)]
        _state.matrix = _np.stack(cols, axis=1)
        return
    if len(args) == 6:
        height, width, nz, data, row_indices, col_offsets = args
        _state.matrix = sp.csc_matrix(
            (
                _np.asarray(data, dtype=_np.float64),
                _np.asarray(row_indices, dtype=_np.int64),
                _np.asarray(col_offsets, dtype=_np.int64),
            ),
            shape=(height, width),
        )
        return
    raise TypeError("LoadMatrix: unrecognized argument form")


def IsMatrixLoaded() -> bool:
    return _state.matrix is not None


def LoadDictionary(arg) -> None:
    """Reference: smallk.cpp:675-706.  Path or list of terms."""
    _require_init()
    if isinstance(arg, str):
        from .io.loader import load_strings

        _state.dictionary = load_strings(arg)
    else:
        _state.dictionary = list(arg)


# ---------------------------------------------------------------------------
# NMF (reference smallk::Nmf, smallk.cpp:471-651)
# ---------------------------------------------------------------------------
def Nmf(k: int, algorithm: Algorithm = Algorithm.BPP,
        initfile_w: str = "", initfile_h: str = "") -> None:
    """Factor the loaded matrix as W*H on the facade's device; writes
    w.csv / h.csv in the output dir.  MU is forced to DELTA_FNORM
    stopping (smallk.cpp:574-582)."""
    _require_init()
    if _state.matrix is None:
        raise RuntimeError("smallk error (Nmf): no matrix loaded")

    from .engines.nmf import run_nmf
    from .io.delimited import load_delimited, write_delimited

    A = _state.matrix
    m, n = A.shape

    if initfile_w:
        W0 = load_delimited(initfile_w)
    else:
        W0 = random_matrix(m, k, _state.rng)
    if initfile_h:
        H0 = load_delimited(initfile_h)
    else:
        H0 = random_matrix(k, n, _state.rng)

    alg = NmfAlgorithm(algorithm.value)
    prog = (
        NmfProgressAlgorithm.DELTA_FNORM
        if alg == NmfAlgorithm.MU
        else NmfProgressAlgorithm.PG_RATIO
    )
    opts = NmfOptions(
        tol=_state.nmf_tolerance,
        algorithm=alg,
        prog_est_algorithm=prog,
        height=m, width=n, k=k,
        min_iter=_state.min_iter,
        max_iter=_state.max_iter,
        tolcount=1,
        max_threads=_state.max_threads,
        verbose=True,
        normalize=True,
        dtype=_state.dtype,
    )
    # option dump before the run (reference PrintNmfOpts, smallk.cpp:872-920)
    print("\n             parameters: \n")
    print(f"\t         algorithm: {alg.value}")
    print(f"\tstopping criterion: {prog.value}")
    print(f"\t            height: {m}")
    print(f"\t             width: {n}")
    print(f"\t                 k: {k}")
    print(f"\t           miniter: {opts.min_iter}")
    print(f"\t           maxiter: {opts.max_iter}")
    print(f"\t               tol: {opts.tol}")
    print(f"\t        outputdir: {_state.output_dir}")

    stats = NmfStats()
    W, H, ok = run_nmf(A, W0, H0, opts, stats, device=_state.device)
    if not ok:
        raise RuntimeError("smallk error (Nmf): NMF solver failure")
    _state.W, _state.H = W, H

    outdir = _state.output_dir.rstrip("/")
    write_delimited(f"{outdir}/w.csv", W, _state.output_precision)
    write_delimited(f"{outdir}/h.csv", H, _state.output_precision)
    print(f"Elapsed wall clock time: {stats.elapsed_us / 1.0e6:.3f} sec.")
    print(f"{stats.iteration_count} iterations.")


def LockedBufferW():
    """Most recent W factor (reference smallk.cpp:653-662)."""
    if _state.W is None:
        raise RuntimeError("smallk error (LockedBufferW): no factors yet")
    return _state.W


def LockedBufferH():
    if _state.H is None:
        raise RuntimeError("smallk error (LockedBufferH): no factors yet")
    return _state.H


# ---------------------------------------------------------------------------
# Hierarchical clustering (reference smallk.cpp:737-868)
# ---------------------------------------------------------------------------
def _hier_nmf2_internal(generate_flat: bool, num_clusters: int,
                        checkpoint_path=None, mesh=None, restarts=1,
                        priority_method="ndcg") -> None:
    _require_init()
    from .parallel.mesh import check_mesh

    check_mesh(mesh, "HierNmf2")
    if _state.matrix is None:
        raise RuntimeError("smallk error (HierNmf2): no matrix loaded")
    if _state.dictionary is None:
        raise RuntimeError("smallk error (HierNmf2): no dictionary loaded")

    from .engines.flatclust import run_hier_nmf2, write_flatclust_results
    from .io.writers import make_hierclust_writer

    A = _state.matrix
    m, n = A.shape

    # hardcoded per reference HierNmf2Internal (smallk.cpp:766-782)
    opts = ClustOptions(
        nmf_opts=NmfOptions(
            tol=_state.hier_tolerance,
            algorithm=NmfAlgorithm.RANK2,
            prog_est_algorithm=NmfProgressAlgorithm.PG_RATIO,
            height=m, width=n, k=2,
            min_iter=_state.min_iter,
            max_iter=_state.max_iter,
            tolcount=1,
            max_threads=_state.max_threads,
            verbose=True,
            normalize=True,
            dtype=_state.dtype,
        ),
        maxterms=_state.max_terms,
        unbalanced=0.1,
        trial_allowance=3,
        num_clusters=num_clusters,
        verbose=True,
        flat=generate_flat,
        restarts=restarts,
        priority_method=priority_method,
    )

    tree, stats, flat = run_hier_nmf2(A, opts, _state.rng, mesh=mesh,
                                      checkpoint_path=checkpoint_path,
                                      device=_state.device)
    num_converged = stats.nmf_count - stats.max_count
    print(f"{num_converged}/{stats.nmf_count} factorizations converged.\n")
    if mesh is not None and not mesh.is_coordinator:
        return

    outdir = _state.output_dir.rstrip("/")
    fmt = _state.output_format
    ext = "xml" if fmt == OutputFormat.XML else "json"
    print("Writing output files...")
    tree.write_assignments(f"{outdir}/assignments_{num_clusters}.csv")
    tree.write_tree(
        make_hierclust_writer(fmt),
        f"{outdir}/tree_{num_clusters}.{ext}",
        _state.dictionary,
    )
    if generate_flat and flat is not None:
        write_flatclust_results(
            outdir,
            flat["assignments"],
            flat["fuzzy"],
            flat["W"],
            _state.dictionary,
            _state.max_terms,
            fmt,
            num_clusters,
            assignments_prefix="assignments_flat_",
        )


def HierNmf2(num_clusters: int, checkpoint_path=None, mesh=None,
             restarts=1, priority_method="ndcg") -> None:
    """Reference signature is HierNmf2(num_clusters) (smallk.hpp); the
    keyword extensions surface the engine's features — preemption-safe
    checkpointing, best-of-R restarts, the size_ndcg pop policy, and a
    sharded run over `mesh` (a parallel.mesh.Mesh)."""
    _hier_nmf2_internal(False, num_clusters,
                        checkpoint_path=checkpoint_path, mesh=mesh,
                        restarts=restarts,
                        priority_method=priority_method)


def HierNmf2WithFlat(num_clusters: int, checkpoint_path=None, mesh=None,
                     restarts=1, priority_method="ndcg") -> None:
    _hier_nmf2_internal(True, num_clusters,
                        checkpoint_path=checkpoint_path, mesh=mesh,
                        restarts=restarts,
                        priority_method=priority_method)
