"""Graph community detection in the port with best-of-R restarts as one
lane solve: the node solve `engines/hierclust._solve_from_draw` against
the JAX package's (restarts = 3, the same starts, f64 on the CPU), a
failed lane, a small planted-partition graph through the graph preset
(`engines/graph.graph_clust_options`) against the JAX package's NMI.  (The sharded masked views with restarts:
tests/test_torch_parallel_hier.py.)

Tolerances: the best lane's factors within 1e-10 relative to their largest
entry (f64, other summation orders), equal success, iterations and chosen
lane; the graph's NMI at least the JAX package's less 0.05, as
tests/test_torch_hierclust.py's random-mode test (the two draw their
starts from different generators).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smallk_tpu.common.options as jopt
from smallk_tpu.common.rng import Random as JRandom
from smallk_tpu.engines.graph import graph_clust_options as jgraph_opts
from smallk_tpu.engines.hierclust import _solve_from_draw as j_solve_from_draw
from smallk_tpu.engines.hierclust import clust_hier as jclust_hier
from smallk_tpu.ops.aop import DenseAOp as JDenseAOp
from smallk_tpu.ops.aop import MaskedAOp as JMaskedAOp
from smallk_tpu.solvers.solve import _nmf_solve_impl
from smallk_torch.common import options as topt
from smallk_torch.common.rng import Random
from smallk_torch.engines import hierclust
from smallk_torch.engines.corpus import planted_partition_graph
from smallk_torch.engines.graph import graph_clust_options
from smallk_torch.engines.graph import normalized_adjacency
from smallk_torch.engines.scoring import score_clustering
from smallk_torch.ops.aop import DenseAOp, MaskedAOp
from smallk_torch.solvers.solve import nmf_solve

torch.set_num_threads(1)

M, N, R = 60, 50, 3
TOL = 1e-10


def _opts(pkg):
    return pkg.NmfOptions(k=2, dtype="float64", verbose=False, tol=1e-5,
                          max_iter=300, min_iter=1, loop_unroll=1,
                          algorithm=pkg.NmfAlgorithm.RANK2,
                          prog_est_algorithm=pkg.NmfProgressAlgorithm.PG_RATIO)


def _operands(kind, seed):
    rng = np.random.RandomState(seed + 20)
    A = rng.rand(M, N)
    top, jop = DenseAOp(torch.from_numpy(A)), JDenseAOp(jnp.asarray(A))
    if kind == "masked":
        mask = (rng.rand(N) > 0.4).astype(np.float64)
        return (MaskedAOp(top, torch.from_numpy(mask)),
                JMaskedAOp(jop, jnp.asarray(mask)))
    return top, jop


def _draw(key):
    kw, kh = jax.random.split(key)
    return (jax.random.uniform(kw, (M, 2), jnp.float64),
            jax.random.uniform(kh, (2, N), jnp.float64))


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape and np.isfinite(a).all()
    assert np.abs(a - b).max() <= TOL * np.abs(b).max()


@pytest.mark.parametrize("kind,seed", [("dense", 0), ("masked", 1)])
def test_solve_from_draw_matches_jax(kind, seed):
    """restarts = 3: the JAX package's starts (its vmapped draw) handed to
    the port in order; the best lane's W and H, success, iterations and
    the chosen lane are the JAX package's."""
    top, jop = _operands(kind, seed)
    root = jax.random.PRNGKey(seed)
    W0s, H0s = (np.array(x) for x in
                jax.vmap(_draw)(jax.random.split(root, R)))
    jopts, topts = _opts(jopt), _opts(topt)
    jW, jH, jok, jit = j_solve_from_draw(
        jop, jnp.ones(N, bool), _draw, root, jnp.ones(M), jopts, "random",
        R)[:4]
    lanes = jax.vmap(lambda w0, h0: _nmf_solve_impl(jop, w0, h0, jopts,
                                                    False, None))(
        jnp.asarray(W0s), jnp.asarray(H0s))
    jlane = [lane for lane in range(R)
             if np.array_equal(np.asarray(lanes.W[lane]), np.asarray(jW))]

    starts = iter(zip(W0s, H0s))

    def draw():
        return tuple(torch.from_numpy(x) for x in next(starts))

    W, H, ok, iters = hierclust._solve_from_draw(top, draw, topts, "random",
                                                 R)
    res = nmf_solve(top, torch.from_numpy(W0s), torch.from_numpy(H0s),
                    topts)
    tlane = [lane for lane in range(R) if torch.equal(res.W[lane], W)]
    assert len(jlane) == 1 and tlane == jlane
    # the lanes' iterations differ, so the winner's are the ones returned
    assert len(set(np.asarray(lanes.iterations).tolist())) > 1
    assert (ok, iters) == (bool(jok), int(jit))
    _close(W.numpy(), jW)
    _close(H.numpy(), jH)


@pytest.mark.parametrize("failing", [(0,), (0, 2), (0, 1, 2)])
def test_node_fails_only_if_every_lane_fails(failing):
    """A failed lane (a singular start: W0's columns equal) scores +inf and
    never wins; the node fails only when every lane fails, so the retry
    ladder and on_node_failure="leaf" see what they saw with one start."""
    top, _ = _operands("dense", 3)
    rng = np.random.RandomState(3)
    W0, H0 = rng.rand(R, M, 2), rng.rand(R, 2, N)
    for lane in failing:
        W0[lane, :, 1] = W0[lane, :, 0]
    starts = iter(zip(W0, H0))
    W, H, ok, iters = hierclust._solve_from_draw(
        top, lambda: tuple(torch.from_numpy(x) for x in next(starts)),
        _opts(topt), "random", R)
    assert ok is (len(failing) < R)
    if ok:
        assert torch.isfinite(W).all() and torch.isfinite(H).all()
        assert iters > 1


def test_graph_preset_nmi_matches_jax(monkeypatch):
    """A small planted-partition graph, degree-normalized, through the
    graph preset (size_ndcg pop, best-of-3 restarts, leaves on failure):
    every node is one solve of 3 lanes, and the NMI reaches the JAX
    package's less 0.05."""
    G, labels = planted_partition_graph(300, 6, 5, 3, seed=7)
    Gn = normalized_adjacency(G)
    jtree, _ = jclust_hier(Gn, jgraph_opts(6), JRandom(3))

    lanes = []

    def recorded(op, W0, H0, *args, **kwargs):
        lanes.append(tuple(W0.shape[:-2]))
        return nmf_solve(op, W0, H0, *args, **kwargs)

    monkeypatch.setattr(hierclust, "nmf_solve", recorded)
    opts = graph_clust_options(6)
    assert opts.restarts == 3
    tree, stats = hierclust.clust_hier(Gn, opts, Random(3), device="cpu")
    assert lanes and set(lanes) == {(3,)}
    assert stats.nmf_count >= 5
    leaves = [q for q, leaf in enumerate(tree.is_leaf) if leaf]
    assert len(leaves) == 6 and (tree.assignments >= 0).all()
    got = score_clustering(tree.assignments, labels)["nmi"]
    ref = score_clustering(jtree.assignments, labels)["nmi"]
    assert got >= ref - 0.05, (got, ref)
