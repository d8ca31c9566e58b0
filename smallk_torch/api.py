"""pysmallk-compatible Python API — port of smallk_tpu/api.py.

Reference: pysmallk/interface/smallk_lib.pyx — classes SmallkAPI (:634),
Clustering (:924), Flatclust (:1081), Hierclust (:1240), Matrixgen (:1440),
Preprocessor (:1643), with the same class/method names and argparse
`parser()` helpers.  The Cython marshalling layer disappears: the framework
is already Python, so these classes call the engines directly.

SmallkAPI, Flatclust and Hierclust take `device="cuda"` in their
constructors and run there unless the caller asks for the CPU; their
parsers gain `--device` (default cuda), as the port's CLIs have.
Matrixgen and Preprocessor are host-only (numpy and scipy).  `mesh=` (a
parallel.mesh.Mesh) runs Flatclust and Hierclust sharded over its ranks,
every rank in the same program; only the coordinator writes output files.
"""

from __future__ import annotations

import argparse
import numpy as np
import scipy.sparse as sp

from .common.options import (
    ClustOptions,
    ClustStats,
    NmfAlgorithm,
    NmfOptions,
    NmfProgressAlgorithm,
    NmfStats,
    OutputFormat,
)
from .common.rng import Random, random_matrix


def _load_any_matrix(filepath="", height=0, width=0, delim=",", buffer=None,
                     matrix=None, row_indices=None, col_offsets=None,
                     nz=0, column_major=False):
    """Shared matrix-load logic (pysmallk _load_matrix_internal, pyx:510)."""
    if filepath:
        from .io.loader import load_matrix

        return load_matrix(filepath)
    if matrix is not None:
        if sp.issparse(matrix):
            return matrix.tocsc()
        m = np.asarray(matrix, dtype=np.float64)
        return m.T if column_major else m
    if buffer is not None and row_indices is not None:
        return sp.csc_matrix(
            (np.asarray(buffer, dtype=np.float64),
             np.asarray(row_indices, dtype=np.int64),
             np.asarray(col_offsets, dtype=np.int64)),
            shape=(height, width),
        )
    if buffer is not None:
        buf = np.asarray(buffer, dtype=np.float64).reshape(-1)
        return buf.reshape((width, height)).T
    raise ValueError("load_matrix: no matrix source given")


class SmallkAPI:
    """Mirror of pysmallk.SmallkAPI (smallk_lib.pyx:634)."""

    def __init__(self, device="cuda"):
        import smallk_torch as _facade

        self._facade = _facade
        _facade.Initialize(device=device)

    def parser(self, argv=None):
        """Full reference flag surface (smallk_lib.pyx:647-688), plus
        `--format` (default XML): the reference's own smallkapi.py driver
        reads `args.format` on the --hiernmf2 path but its parser never
        defines the flag (pysmallk/tests/smallkapi.py:32 vs pyx:647-688)
        — defining it here makes the documented invocation actually run.
        `argv` defaults to sys.argv (reference behavior); tests pass an
        explicit list."""
        p = argparse.ArgumentParser(
            description="Run NMF via python binding")
        p.add_argument("--matrixfile", action="store", required=True)
        p.add_argument("--k", action="store", required=True, type=int)
        p.add_argument("--dictfile", action="store", required=False,
                       default="")
        p.add_argument("--hiernmf2", action="store", required=False,
                       type=int, default=0, choices=[0, 1])
        p.add_argument("--algorithm", action="store", required=False,
                       default="BPP",
                       choices=["MU", "HALS", "RANK2", "BPP"])
        p.add_argument("--stopping", action="store", required=False,
                       default="PG_RATIO", choices=["PG_RATIO", "DELTA"])
        p.add_argument("--tol", action="store", required=False, type=float,
                       default=0.005)
        p.add_argument("--tolcount", action="store", required=False,
                       type=int, default=1)
        p.add_argument("--infile_W", action="store", required=False,
                       default="")
        p.add_argument("--infile_H", action="store", required=False,
                       default="")
        p.add_argument("--outfile_W", action="store", required=False,
                       default="w.csv")
        p.add_argument("--outfile_H", action="store", required=False,
                       default="h.csv")
        p.add_argument("--outprecision", action="store", required=False,
                       type=int, default=6)
        p.add_argument("--maxiter", action="store", required=False,
                       type=int, default=5000)
        p.add_argument("--miniter", action="store", required=False,
                       type=int, default=5)
        p.add_argument("--maxthreads", action="store", required=False,
                       type=int, default=8)
        p.add_argument("--maxterms", action="store", required=False,
                       type=int, default=5)
        p.add_argument("--normalize", action="store", required=False,
                       type=int, default=1)
        p.add_argument("--verbose", action="store", required=False,
                       type=int, default=1)
        p.add_argument("--format", action="store", required=False,
                       default="XML")
        p.add_argument("--device", action="store", required=False,
                       default="cuda")
        return p.parse_args(argv)

    def get_major_version(self):
        return self._facade.GetMajorVersion()

    def get_minor_version(self):
        return self._facade.GetMinorVersion()

    def get_patch_level(self):
        return self._facade.GetPatchLevel()

    def get_version_string(self):
        return self._facade.GetVersionString()

    def load_matrix(self, filepath="", height=0, width=0, delim=",",
                    buffer=None, matrix=None, row_indices=None,
                    col_offsets=None, nz=0, column_major=False):
        A = _load_any_matrix(filepath, height, width, delim, buffer, matrix,
                             row_indices, col_offsets, nz, column_major)
        self._facade.LoadMatrix(matrix=A)

    def is_matrix_loaded(self):
        return self._facade.IsMatrixLoaded()

    def get_inputs(self):
        """Current facade settings (pysmallk get_inputs, pyx:774-783)."""
        f = self._facade
        return {
            "precision": f.GetOutputPrecision(),
            "min_iter": f.GetMinIter(),
            "max_iter": f.GetMaxIter(),
            "tol": f.GetNmfTolerance(),
            "max_threads": f.GetMaxThreads(),
            "outdir": f.GetOutputDir(),
            "format": f.GetOutputFormat().value,
        }

    def nmf(self, k, algorithm, infile_W="", infile_H="", precision=4,
            min_iter=5, max_iter=5000, tol=0.005, max_threads=8,
            outdir="."):
        f = self._facade
        f.SetOutputPrecision(precision)
        f.SetMinIter(min_iter)
        f.SetMaxIter(max_iter)
        f.SetNmfTolerance(tol)
        f.SetMaxThreads(max_threads)
        f.SetOutputDir(outdir)
        alg = (algorithm if isinstance(algorithm, f.Algorithm)
               else f.Algorithm(str(algorithm).upper()))
        f.Nmf(k, alg, infile_W, infile_H)

    def get_W(self):
        return np.array(self._facade.LockedBufferW())

    def get_H(self):
        return np.array(self._facade.LockedBufferH())

    def load_dictionary(self, filepath="", dictionary=None):
        self._facade.LoadDictionary(filepath or list(dictionary))

    def hiernmf2(self, k, format="XML", maxterms=5, tol=0.0001):
        f = self._facade
        f.SetOutputFormat(OutputFormat(format))
        f.SetMaxTerms(maxterms)
        f.SetHierNmf2Tolerance(tol)
        f.HierNmf2(k)

    def finalize(self):
        self._facade.Finalize()


class Clustering:
    """Shared state/helpers (pysmallk Clustering base, pyx:924)."""

    def __init__(self, device="cuda"):
        self.device = device
        self.A = None
        self.dictionary = None
        self.assignments = None
        self.fuzzy = None
        self.W = None
        self.H = None
        self.term_indices = None
        self.rng = Random()

    def seed(self, seed):
        self.rng.seed_from_int(seed)

    def load_matrix(self, **kwargs):
        self.A = _load_any_matrix(**kwargs)

    def load_dictionary(self, filepath="", dictionary=None):
        if filepath:
            from .io.loader import load_strings

            self.dictionary = load_strings(filepath)
        else:
            self.dictionary = list(dictionary)

    def finalize(self):
        """API parity with pysmallk Clustering.finalize (pyx:953)."""
        self.A = None
        self.assignments = None

    def get_assignments(self):
        return np.array(self.assignments)

    def get_top_indices(self):
        return np.array(self.term_indices)

    def get_top_terms(self, filepath="", dictionary=None):
        """Top terms as strings; optionally resolve against a dictionary
        file or list instead of the loaded one (pysmallk get_top_terms,
        pyx:1032)."""
        if filepath:
            with open(filepath) as f:
                dictionary = [ln for ln in f.read().split("\n") if ln]
        if dictionary is None:
            dictionary = self.dictionary
        if self.term_indices is None or dictionary is None:
            raise RuntimeError("no top terms computed")
        return [dictionary[int(i)] for i in
                np.asarray(self.term_indices).ravel()]

    @staticmethod
    def _get_alg(alg_name):
        return NmfAlgorithm(str(alg_name).upper())


class Flatclust(Clustering):
    """Mirror of pysmallk.Flatclust (pyx:1081)."""

    def parser(self):
        p = argparse.ArgumentParser()
        p.add_argument("--matrixfile", action="store", required=True)
        p.add_argument("--dictfile", action="store", required=True)
        p.add_argument("--clusters", action="store", required=True, type=int)
        p.add_argument("--algorithm", action="store", default="BPP")
        p.add_argument("--infile_W", action="store", default="")
        p.add_argument("--infile_H", action="store", default="")
        p.add_argument("--tol", action="store", type=float, default=0.0001)
        p.add_argument("--outdir", action="store", default="./")
        p.add_argument("--miniter", action="store", type=int, default=5)
        p.add_argument("--maxiter", action="store", type=int, default=5000)
        p.add_argument("--maxterms", action="store", type=int, default=5)
        p.add_argument("--maxthreads", action="store", type=int, default=8)
        p.add_argument("--verbose", action="store", type=int, default=1)
        p.add_argument("--format", action="store", default="XML")
        p.add_argument("--device", action="store", default="cuda")
        return p.parse_args()

    def cluster(self, k, infile_W="", infile_H="", algorithm="BPP",
                maxterms=5, verbose=True, min_iter=5, max_iter=5000,
                tol=0.0001, max_threads=8, dtype="float32", mesh=None):
        from .engines.assignments import top_terms_matrix
        from .engines.flatclust import run_flatclust
        from .io.delimited import load_delimited

        m, n = self.A.shape
        W0 = (load_delimited(infile_W) if infile_W
              else random_matrix(m, k, self.rng))
        H0 = (load_delimited(infile_H) if infile_H
              else random_matrix(k, n, self.rng))
        opts = NmfOptions(
            tol=tol, algorithm=self._get_alg(algorithm),
            prog_est_algorithm=NmfProgressAlgorithm.PG_RATIO,
            height=m, width=n, k=k, min_iter=min_iter, max_iter=max_iter,
            tolcount=1, max_threads=max_threads, verbose=verbose,
            normalize=True, dtype=dtype,
        )
        self._stats = NmfStats()
        self.W, self.H, self.assignments, self.fuzzy, ok = run_flatclust(
            self.A, W0, H0, opts, self._stats, mesh=mesh, device=self.device
        )
        self.maxterms = maxterms
        self.term_indices = top_terms_matrix(self.W, maxterms)
        return ok

    def write_output(self, assignfile=None, fuzzyfile=None, treefile=None,
                     outdir="./", format="XML"):
        import os

        from .engines.flatclust import write_flatclust_results
        from .parallel.distributed import is_coordinator

        if not is_coordinator():   # a sharded run: rank 0 writes
            return

        k = self.H.shape[0]
        fmt = OutputFormat(format)
        apath, fpath, rpath = write_flatclust_results(
            outdir, self.assignments, self.fuzzy, self.W, self.dictionary,
            self.maxterms, fmt, k,
        )
        if assignfile:
            os.replace(apath, os.path.join(outdir, assignfile))
        if fuzzyfile:
            os.replace(fpath, os.path.join(outdir, fuzzyfile))
        if treefile:
            os.replace(rpath, os.path.join(outdir, treefile))


class Hierclust(Clustering):
    """Mirror of pysmallk.Hierclust (pyx:1240)."""

    def parser(self):
        p = argparse.ArgumentParser()
        p.add_argument("--matrixfile", action="store", required=True)
        p.add_argument("--dictfile", action="store", required=True)
        p.add_argument("--clusters", action="store", required=True, type=int)
        p.add_argument("--initdir", action="store", default="")
        p.add_argument("--tol", action="store", type=float, default=0.0001)
        p.add_argument("--outdir", action="store", default="./")
        p.add_argument("--miniter", action="store", type=int, default=5)
        p.add_argument("--maxiter", action="store", type=int, default=5000)
        p.add_argument("--maxterms", action="store", type=int, default=5)
        p.add_argument("--maxthreads", action="store", type=int, default=8)
        p.add_argument("--unbalanced", action="store", type=float,
                       default=0.1)
        p.add_argument("--trial_allowance", action="store", type=int,
                       default=3)
        p.add_argument("--flat", action="store", type=int, default=0)
        p.add_argument("--verbose", action="store", type=int, default=1)
        p.add_argument("--format", action="store", default="XML")
        p.add_argument("--device", action="store", default="cuda")
        return p.parse_args()

    def cluster(self, k, initdir="", maxterms=5, unbalanced=0.1,
                trial_allowance=3, verbose=True, flat=0, min_iter=5,
                max_iter=5000, tol=0.0001, max_threads=8, dtype="float32",
                mesh=None, init_method="random", restarts=1,
                priority_method="ndcg", checkpoint_path=None,
                graph=False):
        """`graph=True` applies the graph preset: symmetric D^-1/2 A
        D^-1/2 normalization plus size_ndcg pop + best-of-3 restarts
        unless overridden (engines/graph.py).  `checkpoint_path` makes
        the run preemption-safe; `mesh` shards A over a (terms, docs)
        mesh of ranks."""
        from .engines.flatclust import run_hier_nmf2

        A = self.A
        if graph:
            from .engines.graph import normalized_adjacency

            A = normalized_adjacency(A)
            if restarts == 1:
                restarts = 3
            if priority_method == "ndcg":
                priority_method = "size_ndcg"

        m, n = A.shape
        opts = ClustOptions(
            nmf_opts=NmfOptions(
                tol=tol, algorithm=NmfAlgorithm.RANK2,
                prog_est_algorithm=NmfProgressAlgorithm.PG_RATIO,
                height=m, width=n, k=2, min_iter=min_iter,
                max_iter=max_iter, tolcount=1, max_threads=max_threads,
                verbose=verbose, normalize=True, dtype=dtype,
            ),
            maxterms=maxterms, unbalanced=unbalanced,
            trial_allowance=trial_allowance, num_clusters=k,
            verbose=verbose, flat=bool(flat), initdir=initdir or None,
            init_method=init_method, restarts=restarts,
            priority_method=priority_method,
        )
        self._stats = ClustStats()
        self.tree, self._stats, self.flat_results = run_hier_nmf2(
            A, opts, self.rng, self._stats, mesh=mesh,
            checkpoint_path=checkpoint_path, device=self.device,
        )
        self.num_clusters = k
        self.maxterms = maxterms
        self.assignments = self.tree.assignments
        leaf_terms = [
            node.term_indices for q, node in enumerate(self.tree.nodes)
            if self.tree.is_leaf[q]
        ]
        self.term_indices = np.stack(leaf_terms, axis=1)
        return True

    def write_output(self, assignfile=None, treefile=None, fuzzyfile=None,
                     outdir="./", format="XML"):
        import os

        from .engines.flatclust import write_flatclust_results
        from .io.writers import make_hierclust_writer
        from .parallel.distributed import is_coordinator

        if not is_coordinator():   # a sharded run: rank 0 writes
            return

        fmt = OutputFormat(format)
        ext = "xml" if fmt == OutputFormat.XML else "json"
        # file names use the requested cluster count, as the reference does,
        # even if splitting stopped early with fewer leaves
        k = getattr(self, "num_clusters",
                    len([1 for leaf in self.tree.is_leaf if leaf]))
        apath = os.path.join(outdir, assignfile or f"assignments_{k}.csv")
        tpath = os.path.join(outdir, treefile or f"tree_{k}.{ext}")
        self.tree.write_assignments(apath)
        self.tree.write_tree(make_hierclust_writer(fmt), tpath,
                             self.dictionary)
        if self.flat_results is not None:
            write_flatclust_results(
                outdir, self.flat_results["assignments"],
                self.flat_results["fuzzy"], self.flat_results["W"],
                self.dictionary, self.maxterms, fmt, k,
                assignments_prefix="assignments_flat_",
            )


class Matrixgen:
    """Mirror of pysmallk.Matrixgen (pyx:1440)."""

    def __init__(self):
        self.rng = Random()
        self.M = None

    def parser(self):
        p = argparse.ArgumentParser()
        p.add_argument("--height", action="store", required=True, type=int)
        p.add_argument("--width", action="store", required=True, type=int)
        p.add_argument("--filename", action="store", required=True)
        p.add_argument("--type", action="store", default="UNIFORM")
        p.add_argument("--rng_center", action="store", type=float,
                       default=0.5)
        p.add_argument("--rng_radius", action="store", type=float,
                       default=0.5)
        p.add_argument("--precision", action="store", type=int, default=6)
        p.add_argument("--nz_per_col", action="store", type=int, default=1)
        return p.parse_args()

    def seed(self, seed):
        self.rng.seed_from_int(seed)

    def uniform(self, m, n, center=0.5, radius=0.5):
        from .engines.matrixgen import generate

        self.M = generate(m, n, "UNIFORM", self.rng, center, radius)
        return self.M

    def densediag(self, m, n, center=0.5, radius=0.5):
        from .engines.matrixgen import generate

        self.M = generate(m, n, "DENSE_DIAG", self.rng, center, radius)
        return self.M

    def sparsediag(self, n, center=0.5, radius=0.5):
        from .engines.matrixgen import generate

        self.M = generate(n, n, "SPARSE_DIAG", self.rng, center, radius)
        return self.M

    def identity(self, m, n):
        from .engines.matrixgen import generate

        self.M = generate(m, n, "IDENTITY", self.rng)
        return self.M

    def ones(self, m, n):
        from .engines.matrixgen import generate

        self.M = generate(m, n, "ONES", self.rng)
        return self.M

    def zeros(self, m, n):
        from .engines.matrixgen import generate

        self.M = generate(m, n, "ZEROS", self.rng)
        return self.M

    def sparse(self, m, n, nz):
        from .engines.matrixgen import generate

        self.M = generate(m, n, "SPARSE", self.rng, nz_per_col=nz)
        return self.M

    def write_output(self, filename, precision=6):
        from .io.delimited import write_delimited
        from .io.matrix_market import write_matrix_market

        if sp.issparse(self.M):
            write_matrix_market(filename, self.M, precision=precision)
        else:
            write_delimited(filename, self.M, precision=precision)


class Preprocessor:
    """Mirror of pysmallk.Preprocessor (pyx:1643)."""

    def __init__(self):
        self.A = None
        self.dictionary = None
        self.documents = None
        self.result = None

    def parser(self):
        p = argparse.ArgumentParser()
        p.add_argument("--indir", action="store", required=True)
        p.add_argument("--outdir", action="store", default="./")
        p.add_argument("--docs_per_term", action="store", type=int,
                       default=3)
        p.add_argument("--terms_per_doc", action="store", type=int,
                       default=5)
        p.add_argument("--maxiter", action="store", type=int, default=1000)
        p.add_argument("--precision", action="store", type=int, default=4)
        p.add_argument("--boolean_mode", action="store", type=int,
                       default=0)
        return p.parse_args()

    def load_matrix(self, **kwargs):
        self.A = _load_any_matrix(**kwargs)

    def load_dictionary(self, filepath="", dictionary=None):
        if filepath:
            from .io.loader import load_strings

            self.dictionary = load_strings(filepath)
        else:
            self.dictionary = list(dictionary)

    def load_documents(self, filepath="", documents=None):
        if filepath:
            from .io.loader import load_strings

            self.documents = load_strings(filepath)
        else:
            self.documents = list(documents)

    def preprocess(self, maxiter=1000, docsperterm=3, termsperdoc=5,
                   boolean_mode=0):
        from .engines.preprocess import preprocess_tf

        self.result = preprocess_tf(
            self.A, max_iter=maxiter, docs_per_term=docsperterm,
            terms_per_doc=termsperdoc, boolean_mode=bool(boolean_mode),
            verbose=False,
        )
        return self.result

    def get_reduced_scores(self):
        return np.asarray(self.result.matrix.data)

    def get_reduced_row_indices(self):
        return np.asarray(self.result.matrix.indices)

    def get_reduced_col_offsets(self):
        return np.asarray(self.result.matrix.indptr)

    def get_reduced_dictionary(self):
        return [self.dictionary[int(i)] for i in self.result.term_indices]

    def get_reduced_documents(self):
        return [self.documents[int(i)] for i in self.result.doc_indices]

    def get_reduced_field(self, filepath="", values=None):
        """Project any per-document field list onto the surviving docs
        (pysmallk get_reduced_field, pyx:1812-1816)."""
        if filepath:
            with open(filepath) as f:
                values = f.read().split("\n")
        return [values[int(i)] for i in self.result.doc_indices]

    def write_output(self, matrix_filepath, dict_filepath, docs_filepath,
                     precision=4):
        from .io.matrix_market import write_matrix_market

        write_matrix_market(matrix_filepath, self.result.matrix,
                            precision=precision)
        with open(dict_filepath, "w") as f:
            for t in self.get_reduced_dictionary():
                f.write(t + "\n")
        with open(docs_filepath, "w") as f:
            for d in self.get_reduced_documents():
                f.write(d + "\n")
