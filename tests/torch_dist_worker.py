"""Ranks of the port's sharded solve on the CPU, over gloo, for
tests/test_torch_parallel.py and tests/test_torch_parallel_hier.py.

pytest does not collect this file (no test_ prefix) and it imports no
JAX.  `spawn(shape, cases, out, data)` starts T*D ranks with
torch.multiprocessing; each joins a gloo world, lays it out as a mesh of
`shape` and runs the named cases of CASES, writing each case's arrays to
out/rank<r>.npz under "<case>/<key>".  A rank that raises fails the
spawn; a spawn that outlives its timeout kills its ranks and raises.  The
problems are built here and in the tests from the same functions.
"""

from __future__ import annotations

import os
import socket

import numpy as np
import scipy.sparse as sp
import torch

SPAWN_TIMEOUT = 240.0


# ----------------------------------------------------------------- problems
def dense_problem(m=64, n=48, k=4, seed=0):
    """tests/test_parallel.py's _problem, on numpy's generator."""
    rng = np.random.RandomState(seed)
    return rng.rand(m, n), rng.rand(m, k), rng.rand(k, n)


def nmf_opts(topt, alg, m, n, k, **kw):
    base = dict(tol=1e-4, algorithm=topt.NmfAlgorithm(alg), height=m,
                width=n, k=k, min_iter=2, max_iter=50, verbose=False,
                dtype="float64")
    base.update(kw)
    return topt.NmfOptions(**base)


def sparse_problem(m, n, density, seed):
    rng = np.random.RandomState(seed)
    A = sp.random(m, n, density=density, random_state=rng, format="csc")
    A.data = np.abs(A.data) + 0.1
    return A


def blocks_problem(seed, m=64, n=48, blocks=4):
    """tests/test_parallel.py's planted block matrix."""
    rng = np.random.RandomState(seed)
    A = np.abs(rng.rand(m, n)) * 0.05
    for b in range(blocks):
        A[b * (m // blocks):(b + 1) * (m // blocks),
          b * (n // blocks):(b + 1) * (n // blocks)] += 1.0
    return sp.csc_matrix(A)


def restarts_problem(topt):
    """(A, options) of the sharded restarts case: a small planted block
    matrix, 3 clusters, best-of-3 restarts, node solves capped at 30
    steps (each step's collectives cost the ranks ~1 ms apiece)."""
    import dataclasses

    opts = clust_opts(topt, 3, restarts=3)
    return (blocks_problem(4, m=24, n=18, blocks=3),
            dataclasses.replace(opts, nmf_opts=dataclasses.replace(
                opts.nmf_opts, max_iter=30)))


def clust_opts(topt, k, initdir=None, flat=False, **kw):
    return topt.ClustOptions(
        nmf_opts=topt.NmfOptions(
            tol=1e-4, algorithm=topt.NmfAlgorithm.RANK2,
            prog_est_algorithm=topt.NmfProgressAlgorithm.PG_RATIO, k=2,
            min_iter=1, max_iter=100, verbose=False, dtype="float64"),
        num_clusters=k, verbose=False, initdir=initdir, flat=flat, **kw)


def tree_record(tree) -> dict:
    """A tree as arrays: structure, documents, priorities, assignments and
    the leaves' top terms (either package's tree)."""
    nodes = tree.nodes
    docs = [np.asarray(nd.docs if nd.docs is not None else [], np.int64)
            for nd in nodes]
    terms = [np.asarray(nd.term_indices) for q, nd in enumerate(nodes)
             if tree.is_leaf[q] and nd.is_valid]
    return {
        "structure": np.array([[nd.is_valid, nd.parent_index,
                                nd.left_child_index, nd.right_child_index,
                                nd.is_left_child] for nd in nodes],
                              dtype=np.int64),
        "is_leaf": np.asarray(tree.is_leaf, dtype=bool),
        "docs": np.concatenate([np.sort(d) for d in docs]),
        "docs_offsets": np.cumsum([0] + [len(d) for d in docs]),
        "priority": np.array([nd.priority for nd in nodes], np.float64),
        "assignments": np.asarray(tree.assignments),
        "leaf_terms": (np.stack(terms) if terms
                       else np.zeros((0, 0), np.int64)),
    }


# -------------------------------------------------------------------- cases
def _solve(mesh, a, W0, H0, opts):
    from smallk_torch.parallel.mesh import sharded_nmf_solve

    r = sharded_nmf_solve(a, W0, H0, opts, mesh)
    return {"W": r.W.numpy(), "H": r.H.numpy(),
            "W_local": r.W_local.numpy(), "H_local": r.H_local.numpy(),
            "iterations": np.int64(r.iterations),
            "success": np.bool_(r.success),
            "pivot_rounds": np.int64(r.pivot_rounds)}


def case_dense(mesh, data):
    """Dense BPP (tests/test_parallel.py::test_sharded_matches_single_
    device), the rank's blocks and its operand's block."""
    from smallk_torch.common import options as topt
    from smallk_torch.parallel.mesh import nmf_blocks, shard_operand

    A, W0, H0 = dense_problem()
    out = _solve(mesh, A, W0, H0, nmf_opts(topt, "BPP", 64, 48, 4))
    op = shard_operand(A, mesh, torch.float64)
    (r0, r1), (c0, c1) = nmf_blocks(mesh, 64, 48)
    out.update(bounds=np.array([r0, r1, c0, c1]), block=op.local.A.numpy(),
               kind=np.array(type(op.local).__name__))
    # a matrix with fewer rows or columns than an axis has ranks: every
    # rank refuses it, before any collective
    try:
        shard_operand(np.ones((1, 1)), mesh)
        out["tiny_refused"] = np.bool_(False)
    except ValueError:
        out["tiny_refused"] = np.bool_(True)
    return out


def case_algorithms(mesh, data):
    """MU, HALS, BPP and RANK2 (test_all_algorithms_shard,
    test_rank2_shards)."""
    from smallk_torch.common import options as topt

    A, W0, H0 = dense_problem()
    out = {}
    for alg in ("MU", "HALS", "BPP", "RANK2"):
        k = 2 if alg == "RANK2" else 4
        r = _solve(mesh, A, W0[:, :k], H0[:k], nmf_opts(topt, alg, 64, 48,
                                                        k))
        out.update({f"{alg}.{key}": v for key, v in r.items()
                    if key in ("W", "H", "iterations", "success")})
    return out


def case_coo(mesh, data):
    """A SparseAOp block each rank (test_sparse_operand_shards)."""
    from smallk_torch.common import options as topt
    from smallk_torch.parallel.mesh import shard_operand

    A = sparse_problem(64, 48, 0.2, 0)
    W0, H0 = dense_problem(64, 48, 4, 1)[1:]
    op = shard_operand(A, mesh, torch.float64, densify_threshold_bytes=0,
                       sparse_format="coo")
    out = _solve(mesh, op, W0, H0, nmf_opts(topt, "MU", 64, 48, 4,
                                            max_iter=30))
    out["kind"] = np.array(type(op.local).__name__)
    return out


def case_ell(mesh, data):
    """An EllAOp block each rank, built from the host matrix, and a
    prebuilt EllAOp of a shape no axis divides, sharded by its host
    matrix with no padding (test_ell_operand_shards,
    test_ell_shard_requires_padding)."""
    from smallk_torch.common import options as topt
    from smallk_torch.ops.ell import EllAOp
    from smallk_torch.parallel.mesh import shard_operand

    A = sparse_problem(96, 80, 0.12, 5)
    _, W0, H0 = dense_problem(96, 80, 4, 2)
    op = shard_operand(A, mesh, torch.float64, densify_threshold_bytes=0)
    out = _solve(mesh, op, W0, H0, nmf_opts(topt, "BPP", 96, 80, 4))
    out["kind"] = np.array(type(op.local).__name__)
    B = sparse_problem(41, 31, 0.2, 6)
    prebuilt = EllAOp.from_scipy(B, dtype=torch.float64, device="cpu")
    odd = shard_operand(prebuilt, mesh, host_A=B)
    _, W1, H1 = dense_problem(41, 31, 3, 7)
    r = _solve(mesh, odd, W1, H1, nmf_opts(topt, "MU", 41, 31, 3,
                                           max_iter=20))
    out.update({f"odd.{key}": r[key] for key in ("W", "H", "iterations")})
    out["odd.kind"] = np.array(type(odd.local).__name__)
    out["odd.shape"] = np.array(odd.local.shape)
    return out


def case_cg(mesh, data):
    """BPP through the masked CG tier (test_cg_solve_tier_shards)."""
    from smallk_torch.common import options as topt
    from smallk_torch.solvers import nnls

    A, W0, H0 = dense_problem(96, 64, 8, 0)
    nnls.set_masked_solver("cg")
    try:
        return _solve(mesh, A, W0, H0, nmf_opts(topt, "BPP", 96, 64, 8))
    finally:
        nnls.set_masked_solver("auto")


def case_narrow(mesh, data):
    """BPP with narrowed pivot rounds: a rank whose columns are all
    optimal takes the round's floor with the others and solves nothing."""
    from smallk_torch.common import options as topt
    from smallk_torch.solvers import nnls

    A, W0, H0 = dense_problem(64, 48, 4, 3)
    saved = nnls._NARROW_MIN_ENTRIES
    nnls._NARROW_MIN_ENTRIES = 1
    try:
        return _solve(mesh, A, W0, H0, nmf_opts(topt, "BPP", 64, 48, 4))
    finally:
        nnls._NARROW_MIN_ENTRIES = saved


def case_host_matrix(mesh, data):
    """The JAX package's multi-process worker (scripts/dist_worker.py):
    every process holds the host matrix, `shard_host_matrix` moves only
    its block, and the solve runs on the rank's factor blocks."""
    from smallk_torch.common import options as topt
    from smallk_torch.parallel import distributed
    from smallk_torch.parallel.mesh import gather_factors, shard_factors
    from smallk_torch.solvers.solve import nmf_solve

    A, W0, H0 = dense_problem(64, 96, 8, 42)
    op = distributed.shard_host_matrix(sp.csr_matrix(A), mesh,
                                       torch.float64)
    W, H = shard_factors(W0, H0, mesh, torch.float64)
    r = nmf_solve(op, W, H, nmf_opts(topt, "BPP", 64, 96, 8, tol=1e-30,
                                     min_iter=1, max_iter=30))
    Wg, Hg = gather_factors(r.W, r.H, mesh, 64, 96)
    return {"W": Wg.numpy(), "H": Hg.numpy(), "success": np.bool_(r.success),
            "count": np.int64(distributed.process_count()),
            "coordinator": np.bool_(distributed.is_coordinator()),
            "kind": np.array(type(op.local).__name__)}


def case_embeddings(mesh, data):
    """Row-sharded embedding tables: top-k, similar documents, search."""
    from smallk_torch.engines.embeddings import EmbeddingTable, NmfEmbeddings

    _, W, H = dense_problem(40, 37, 5, 9)
    W[3] = W[5]              # a tie across terms
    emb = NmfEmbeddings(W, H, mesh=mesh)
    out = {}
    for t in range(5):
        out[f"docs{t}"], out[f"docs{t}.v"] = emb.top_docs_for_topic(t, 7)
        out[f"terms{t}"], out[f"terms{t}.v"] = emb.top_terms_for_topic(t, 7)
    out["similar"], out["similar.v"] = emb.similar_docs(4, 6)
    q = np.zeros(40)
    q[[1, 7, 30]] = 1.0
    out["search"], out["search.v"] = emb.search(q, 5)
    docs = EmbeddingTable(H.T, mesh, shard_axis=mesh.axis_names[1])
    out["by_docs"], out["by_docs.v"] = docs.topk_cosine(H.T[:3], 4)
    path = data["out"] + "/emb.npz"
    emb.save(path)
    with np.load(path) as z:
        out["saved_W"], out["saved_Ht"] = z["W"], z["Ht"]
    return out


def case_hier_initdir(mesh, data):
    """Initdir hierclust (test_hierclust_sharded_matches_single_device)."""
    from smallk_torch.common import options as topt
    from smallk_torch.common.rng import Random
    from smallk_torch.engines.hierclust import clust_hier

    A = np.load(data["planted"])["A"]
    tree, stats = clust_hier(A, clust_opts(topt, 4, data["initdir"]),
                             Random(7), mesh=mesh)
    return {**tree_record(tree), "nmf_count": np.int64(stats.nmf_count)}


def case_hier_random(mesh, data):
    from smallk_torch.common import options as topt
    from smallk_torch.common.rng import Random
    from smallk_torch.engines.hierclust import clust_hier

    tree, _ = clust_hier(blocks_problem(4), clust_opts(topt, 4), Random(7),
                         mesh=mesh)
    return tree_record(tree)


def case_hier_restarts(mesh, data):
    """Random mode with best-of-3 restarts: every node a solve of 3 lanes
    on the masked view of the rank's block."""
    from smallk_torch.common import options as topt
    from smallk_torch.common.rng import Random
    from smallk_torch.engines.hierclust import clust_hier

    tree, _ = clust_hier(*restarts_problem(topt), Random(7), mesh=mesh)
    return tree_record(tree)


def case_hier_ell(mesh, data):
    """A prebuilt EllAOp and its host matrix (test_hierclust_sharded_ell_
    operand)."""
    from smallk_torch.common import options as topt
    from smallk_torch.common.rng import Random
    from smallk_torch.engines.hierclust import clust_hier
    from smallk_torch.ops.ell import EllAOp

    A = blocks_problem(12)
    op = EllAOp.from_scipy(A, dtype=torch.float64, device="cpu")
    tree, _ = clust_hier(op, clust_opts(topt, 4), Random(7), mesh=mesh,
                         host_A=A)
    return tree_record(tree)


def case_hier_flat(mesh, data):
    """run_hier_nmf2 with the flat refinement and run_flatclust
    (test_flatclust_and_refinement_shard)."""
    from smallk_torch.common import options as topt
    from smallk_torch.common.rng import Random
    from smallk_torch.engines.flatclust import run_flatclust, run_hier_nmf2

    A = blocks_problem(9)
    tree, _, flat = run_hier_nmf2(A, clust_opts(topt, 4, flat=True),
                                  Random(3), mesh=mesh)
    out = {**tree_record(tree), "flat.W": flat["W"], "flat.H": flat["H"],
           "flat.assignments": flat["assignments"],
           "flat.success": np.bool_(flat["success"])}
    rng = np.random.RandomState(9)
    W0, H0 = rng.rand(64, 4), rng.rand(4, 48)
    W, H, assign, fuzzy, ok = run_flatclust(
        A, W0, H0, nmf_opts(topt, "BPP", 64, 48, 4, max_iter=100), mesh=mesh)
    out.update({"fc.W": W, "fc.H": H, "fc.assign": assign, "fc.fuzzy": fuzzy,
                "fc.ok": np.bool_(ok)})
    return out


def case_hier_checkpoint(mesh, data):
    """Interrupted after one split, resumed from the checkpoint on the
    mesh: the uninterrupted tree (the JAX package's dryrun leg)."""
    from smallk_torch.common import options as topt
    from smallk_torch.common.rng import Random
    from smallk_torch.engines.hierclust import clust_hier

    A = blocks_problem(4)
    whole, _ = clust_hier(A, clust_opts(topt, 4), Random(7), mesh=mesh)
    ck = os.path.join(data["out"], "hier.ckpt.npz")
    try:
        clust_hier(A, clust_opts(topt, 4), Random(7), mesh=mesh,
                   checkpoint_path=ck, _interrupt_after=1)
    except KeyboardInterrupt:
        pass
    written = os.path.exists(ck)
    resumed, _ = clust_hier(A, clust_opts(topt, 4), Random(7), mesh=mesh,
                            checkpoint_path=ck)
    return {**{f"whole.{k}": v for k, v in tree_record(whole).items()},
            **{f"resumed.{k}": v for k, v in tree_record(resumed).items()},
            "written": np.bool_(written)}


def case_entry_points(mesh, data):
    """mesh= through api.Hierclust and api.Flatclust, the facade's
    HierNmf2WithFlat and the flatclust CLI's --mesh: every rank runs, the
    coordinator alone writes."""
    import smallk_torch as smallk
    from smallk_torch import api
    from smallk_torch.cli.flatclust_cli import entry as flat_entry

    rank = mesh.rank
    A = blocks_problem(4)
    out = {}
    hc = api.Hierclust(device="cpu")
    hc.seed(1)
    hc.load_matrix(matrix=A)
    hc.load_dictionary(dictionary=[f"t{i}" for i in range(64)])
    hc.cluster(4, verbose=False, dtype="float64", max_iter=100, mesh=mesh)
    d = os.path.join(data["out"], f"api{rank}")
    os.makedirs(d)
    hc.write_output(outdir=d)
    out["api.assignments"] = np.asarray(hc.get_assignments())
    out["api.files"] = np.array(sorted(os.listdir(d)))
    fc = api.Flatclust(device="cpu")
    fc.seed(1)
    fc.load_matrix(matrix=A)
    fc.cluster(4, verbose=False, dtype="float64", max_iter=60, mesh=mesh)
    out["fc.W"] = fc.W

    smallk.Initialize(device="cpu")
    smallk.LoadMatrix(matrix=A.toarray())
    smallk.LoadDictionary([f"t{i}" for i in range(64)])
    d = os.path.join(data["out"], f"facade{rank}")
    os.makedirs(d)
    smallk.SetOutputDir(d)
    smallk.SetMaxIter(100)
    smallk.HierNmf2WithFlat(4, mesh=mesh)
    out["facade.files"] = np.array(sorted(os.listdir(d)))
    smallk.Finalize()

    d = os.path.join(data["out"], f"cli{rank}")
    os.makedirs(d)
    base = ["--matrixfile", data["mtx"], "--dictfile", data["dict"],
            "--clusters", "3", "--outdir", d, "--verbose", "0", "--seed",
            "2", "--device", "cpu", "--maxiter", "30", "--dtype", "float64"]
    t, dd = mesh.shape
    out["cli.rc"] = np.int64(flat_entry(base + ["--mesh", f"{t}x{dd}"]))
    out["cli.bad_rc"] = np.int64(flat_entry(base + ["--mesh",
                                                    f"{t}x{dd + 1}"]))
    out["cli.files"] = np.array(sorted(os.listdir(d)))
    return out


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


# ---------------------------------------------------------------- the ranks
def _rank_main(rank, world, port, shape, cases, out, data, env):
    torch.set_num_threads(1)
    from smallk_torch.parallel import distributed
    from smallk_torch.parallel.mesh import make_mesh

    if env:
        # torchrun's variables, read by initialize_distributed
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                          WORLD_SIZE=str(world), RANK=str(rank),
                          LOCAL_RANK="0")
        distributed.initialize_distributed(device="cpu")
    else:
        distributed.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                           device="cpu")
    mesh = make_mesh(shape, device="cpu")
    results = {}
    for name in cases:
        for key, value in CASES[name](mesh, {**data, "out": out}).items():
            results[f"{name}/{key}"] = value
    np.savez(os.path.join(out, f"rank{rank}.npz"), **results)
    mesh.barrier()
    torch.distributed.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(shape, cases, out, data=None, env=False,
          timeout=SPAWN_TIMEOUT) -> list[dict]:
    """Run `cases` on a gloo mesh of `shape`, one process a rank; returns
    each rank's results ({"case/key": array}), rank order."""
    from smallk_torch.parallel.distributed import spawn_ranks

    world = shape[0] * shape[1]
    spawn_ranks(_rank_main, (world, free_port(), tuple(shape), tuple(cases),
                             str(out), dict(data or {}), env), world,
                timeout)
    results = []
    for rank in range(world):
        with np.load(os.path.join(out, f"rank{rank}.npz")) as z:
            results.append({k: z[k] for k in z.files})
    return results
