"""Best-of-R restarts as one lane-batched rank-2 solve: the port's lane
solve (solvers/solve.nmf_solve with W0 (R, m, 2), H0 (R, 2, n)) against the
JAX package's `jax.vmap(_nmf_solve_impl)` (smallk_tpu/solvers/solve.py:146,
as smallk_tpu/engines/hierclust.py:238-241 runs it), one lane against the
unbatched solve, the lane products of every operand against their single
products, K3's plain lane products and dispatch rule, the kept graphs'
key, and the lane kernel against its plain version on a card (marked
`cuda`).  tests/test_torch_graph.py holds the node solve that picks the
best lane.

Tolerances:
  - lanes against the JAX package, f64 on the CPU: factors within 1e-10
    relative to the largest entry (the two sum products in other orders;
    the rank-2 solves keep that at the f64 rounding of a step), equal
    iterations, convergence and success per lane;
  - R = 1 lanes against the unbatched solve: bit for bit (on a factor
    without lanes every op is the unbatched one; with one lane the
    products are the same products);
  - lane products against single products, f64: 1e-12 relative;
  - K3's plain lane products: against an f64 product of the same rounded
    inputs, 1e-6 relative (f32 sums); lane by lane against the k = 2 plain
    version, 1e-6 (the same sums, blocked by another width);
  - the kernel against its plain version on the card: 2e-5 relative (f32
    sums in another order), as tests/test_torch_rank2_loop.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import smallk_tpu.common.options as jopt
from smallk_tpu.ops import ell as jell
from smallk_tpu.ops.aop import DenseAOp as JDenseAOp
from smallk_tpu.ops.aop import MaskedAOp as JMaskedAOp
from smallk_tpu.solvers.solve import _nmf_solve_impl
from smallk_torch.common import options as topt
from smallk_torch.engines import hierclust
from smallk_torch.kernels import rank2_loop as k3
from smallk_torch.ops import aop
from smallk_torch.ops.aop import DenseAOp, MaskedAOp, SparseAOp
from smallk_torch.ops.ell import EllAOp
from smallk_torch.ops.ell_cols import ChunkColsAOp, CscChunks
from smallk_torch.solvers import graph, solve
from smallk_torch.solvers.solve import nmf_solve

torch.set_num_threads(1)

M, N, R = 60, 50, 3
TOL = 1e-10


def _opts(pkg, **kw):
    base = dict(k=2, dtype="float64", verbose=False, tol=1e-5,
                max_iter=300, min_iter=1, loop_unroll=1,
                algorithm=pkg.NmfAlgorithm.RANK2,
                prog_est_algorithm=pkg.NmfProgressAlgorithm.PG_RATIO)
    base.update(kw)
    return pkg.NmfOptions(**base)


CASES = {
    # lanes converge at different iterations; the third fails at its first
    # step (W0's columns equal: W'W singular)
    "tol": dict(tol=1e-5),
    # a tol no lane reaches: a lane stops by stall or at max_iter (before
    # the metric falls to the rounding's level, where a stall would be
    # decided by the order of the sums)
    "stall": dict(tol=1e-14, stall_patience=3, max_iter=100),
    "delta": dict(tol=1e-6, prog="DELTA_FNORM"),
}


def _case_opts(pkg, name):
    kw = dict(CASES[name])
    prog = kw.pop("prog", "PG_RATIO")
    return _opts(pkg, prog_est_algorithm=pkg.NmfProgressAlgorithm(prog),
                 **kw)


def _starts(seed=0, m=M, n=N, fail=True):
    rng = np.random.RandomState(seed)
    W0 = rng.rand(R, m, 2)
    H0 = rng.rand(R, 2, n)
    if fail:
        W0[2, :, 1] = W0[2, :, 0]
    return W0, H0


def _operands(kind, seed=0):
    """(port operand, JAX operand) of one f64 A."""
    rng = np.random.RandomState(seed + 10)
    if kind == "ell":
        A = sp.random(M, N, density=0.4, random_state=rng, format="csc")
        A.data += 0.1
        jop = jell.EllAOp.from_scipy(A, jnp.float64)
        return EllAOp.from_scipy(A, torch.float64, device="cpu"), jop
    A = rng.rand(M, N)
    top, jop = DenseAOp(torch.from_numpy(A)), JDenseAOp(jnp.asarray(A))
    if kind == "masked":
        mask = (rng.rand(N) > 0.4).astype(np.float64)
        return (MaskedAOp(top, torch.from_numpy(mask)),
                JMaskedAOp(jop, jnp.asarray(mask)))
    return top, jop


def _jax_lanes(jop, W0, H0, opts):
    res = jax.vmap(lambda w0, h0: _nmf_solve_impl(jop, w0, h0, opts, False,
                                                  None))(
        jnp.asarray(W0), jnp.asarray(H0))
    return jax.tree.map(np.asarray, res)


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    fin = np.isfinite(b)
    np.testing.assert_array_equal(np.isfinite(a), fin)
    if fin.any():
        scale = np.abs(b[fin]).max()
        assert np.abs(a[fin] - b[fin]).max() <= TOL * max(scale, 1e-300)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kind", ["dense", "ell", "masked"])
def test_lanes_match_jax_vmap(kind, case):
    top, jop = _operands(kind)
    W0, H0 = _starts()
    j = _jax_lanes(jop, W0, H0, _case_opts(jopt, case))
    r = nmf_solve(top, torch.from_numpy(W0), torch.from_numpy(H0),
                  _case_opts(topt, case)).to_numpy()
    assert r.W.shape == (R, M, 2) and r.H.shape == (R, 2, N)
    np.testing.assert_array_equal(r.iterations, j.iterations)
    np.testing.assert_array_equal(r.converged, j.converged)
    np.testing.assert_array_equal(r.success, j.success)
    for lane in range(R):
        if j.success[lane]:
            _close(r.W[lane], j.W[lane])
            _close(r.H[lane], j.H[lane])
    # the singular lane fails at its first step; the others succeed
    assert list(j.success) == [True, True, False]
    assert j.iterations[2] == 1
    if case == "tol":
        assert j.iterations[0] != j.iterations[1]
    if case == "stall":
        assert min(j.iterations[:2]) < 100 == max(j.iterations[:2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["dense", "ell", "masked"])
def test_one_lane_is_the_unbatched_solve(kind, dtype):
    """R = 1 lanes are bit-equal to the unbatched solve."""
    top, _ = _operands(kind)
    if kind == "ell":
        top = EllAOp.from_scipy(sp.csc_matrix(_operands("dense")[1].A),
                                dtype, device="cpu")
    elif kind == "dense":
        top = DenseAOp(top.A.to(dtype))
    else:
        top = MaskedAOp(DenseAOp(top.base.A.to(dtype)), top.mask)
    W0, H0 = (torch.from_numpy(x[0]).to(dtype) for x in _starts(4))
    opts = _opts(topt, dtype=str(dtype).split(".")[1], stall_patience=20)
    one = nmf_solve(top, W0[None], H0[None], opts)
    ref = nmf_solve(top, W0, H0, opts)
    assert torch.equal(one.W[0], ref.W) and torch.equal(one.H[0], ref.H)
    assert (int(one.iterations[0]), bool(one.success[0]),
            bool(one.converged[0])) == (ref.iterations, ref.success,
                                        ref.converged)
    assert one.metric[0] == ref.metric


def _lane_operands():
    rng = np.random.RandomState(5)
    A = sp.random(M, N, density=0.3, random_state=rng, format="csc")
    A.data += 0.1
    dense = DenseAOp(torch.from_numpy(A.toarray()))
    mask = torch.from_numpy((rng.rand(N) > 0.5).astype(np.float64))
    chunks = CscChunks.from_scipy(A, dtype=torch.float64, device="cpu",
                                  L0=4)
    idx = np.sort(rng.choice(N, 20, replace=False))
    wc = hierclust.bucket_for(max(len(idx), chunks.subset_chunk_count(idx)))
    _, idx_chunks, slot = chunks.gather_host(idx, wc)
    return {
        "dense": dense,
        "ell": EllAOp.from_scipy(A, torch.float64, device="cpu"),
        "coo": SparseAOp.from_scipy(A, torch.float64, device="cpu"),
        "masked": MaskedAOp(dense, mask),
        "chunks": ChunkColsAOp(chunks, wc).load(idx_chunks, slot),
    }


@pytest.mark.parametrize("kind", ["dense", "ell", "coo", "masked", "chunks"])
def test_lane_products_match_single_products(kind):
    op = _lane_operands()[kind]
    m, n = op.shape
    rng = np.random.RandomState(1)
    W = torch.from_numpy(rng.rand(R, m, 2))
    H = torch.from_numpy(rng.rand(R, 2, n))
    tn, nt = op.mm_tn_lanes(W), op.mm_nt_lanes(H)
    assert tn.shape == (R, 2, n) and nt.shape == (R, m, 2)
    for lane in range(R):
        for got, want in ((tn[lane], op.mm_tn(W[lane])),
                          (nt[lane], op.mm_nt(H[lane]))):
            scale = want.abs().max()
            assert float((got - want).abs().max()) <= 1e-12 * float(scale)


A_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
            "e4m3": torch.float8_e4m3fn}


@pytest.mark.parametrize("lanes", [1, 2, 3, 8])
@pytest.mark.parametrize("a_dtype", sorted(A_DTYPES))
def test_plain_lane_products(a_dtype, lanes):
    """K3's plain lane products at 2R rows: against an f64 product of the
    same (rounded) A, and lane by lane against the k = 2 plain version."""
    rng = np.random.RandomState(lanes)
    m, w = 70, 45
    A = torch.from_numpy(rng.rand(m, w).astype(np.float32)).to(
        A_DTYPES[a_dtype])
    A64 = A.to(torch.float64)
    Wt = torch.from_numpy(rng.rand(2 * lanes, m).astype(np.float32))
    H = torch.from_numpy(rng.rand(2 * lanes, w).astype(np.float32))
    tn, nt = k3.wt_a(A, Wt), k3.h_at(A, H)
    assert tn.dtype == nt.dtype == torch.float32
    assert tn.shape == (2 * lanes, w) and nt.shape == (2 * lanes, m)
    for got, want in ((tn, Wt.double() @ A64), (nt, H.double() @ A64.T)):
        assert float((got.double() - want).abs().max()) \
            <= 1e-6 * float(want.abs().max())
    for lane in range(lanes):
        rows = slice(2 * lane, 2 * lane + 2)
        for got, want in ((tn[rows], k3.wt_a_plain(A, Wt[rows])),
                          (nt[rows], k3.h_at_plain(A, H[rows]))):
            assert float((got - want).abs().max()) \
                <= 1e-6 * float(want.abs().max())


def test_lane_rows_refused():
    """The products take 2, 4, ..., 16 rows: odd counts and more than 8
    lanes are refused."""
    A = torch.rand(8, 5)
    for rows in (3, 18):
        with pytest.raises(ValueError):
            k3.wt_a(A, torch.rand(rows, 8))
        with pytest.raises(ValueError):
            k3.h_at(A, torch.rand(rows, 5))


def _fake(device, dtype):
    from types import SimpleNamespace

    return SimpleNamespace(is_cuda=device == "cuda", dtype=dtype)


@pytest.mark.parametrize("k,lanes,kernel", [
    (2, 1, True), (6, 3, True), (16, 8, True), (18, 9, False),
    (8, 1, False), (6, 2, False), (16, 1, False),
])
def test_lane_dispatch_rule(k, lanes, kernel):
    """Only the lane step's stacked products, 2 rows a lane, reach K3 past
    k = 2; a product of k = 8 outside a lane step (BPP's) does not."""
    assert aop._kernel_product_ok(_fake("cuda", torch.bfloat16),
                                  _fake("cuda", torch.float32), k,
                                  lanes=lanes) is kernel


class _KeptStep:
    """A stand-in for graph.StepGraph on the CPU: runs the step eagerly
    and records its loads."""

    made = []

    def __init__(self, step, carry):
        self.step, self.carry, self.loads = step, carry, 0
        self.lanes = tuple(carry.it.shape)
        _KeptStep.made.append(self)

    def load(self, carry):
        assert tuple(carry.it.shape) == self.lanes
        self.carry, self.loads = carry, self.loads + 1

    def run(self, n):
        for _ in range(n):
            self.carry = self.step(self.carry, out=None)
        return n

    def close(self):
        pass


def test_kept_graphs_are_keyed_by_lanes(monkeypatch):
    """A kept graph of R lanes is replayed only for R lanes: one graph a
    lane count, and a later solve of that count loads the kept one."""
    monkeypatch.setattr(graph, "applies", lambda *a, **k: True)
    monkeypatch.setattr(graph, "StepGraph", _KeptStep)
    _KeptStep.made = []
    top, _ = _operands("dense")
    graphs = {}
    opts = _opts(topt, loop_unroll=2)
    W0, H0 = (torch.from_numpy(x) for x in _starts(6, fail=False))
    for w0, h0 in ((W0, H0), (W0[0], H0[0]), (W0[:2], H0[:2]), (W0, H0),
                   (W0[1], H0[1])):
        res = nmf_solve(top, w0, h0, opts, graphs=graphs)
        assert np.all(res.success)
    assert sorted(k[2] for k in graphs) == [(), (2,), (3,)]
    assert [g.lanes for g in _KeptStep.made] == [(3,), (), (2,)]
    assert [g.loads for g in _KeptStep.made] == [1, 1, 0]
    # the kept solves give the bits of solves that keep nothing
    want = nmf_solve(top, W0, H0, opts)
    got = nmf_solve(top, W0, H0, opts, graphs=graphs)
    assert torch.equal(got.W, want.W) and torch.equal(got.H, want.H)


def test_lanes_refuse_other_solvers():
    top, _ = _operands("dense")
    W0, H0 = (torch.from_numpy(x) for x in _starts(fail=False))
    with pytest.raises(ValueError, match="lanes"):
        nmf_solve(top, W0, H0, _opts(topt, algorithm=topt.NmfAlgorithm.MU))
    with pytest.raises(ValueError, match="lanes"):
        nmf_solve(top, W0, H0, _opts(topt), pg0_hint=1.0)


def test_lane_loop_counts():
    """One host read a step at U = 1 whatever R is, and the steps run are
    those of the last lane to stop."""
    top, _ = _operands("dense")
    W0, H0 = (torch.from_numpy(x) for x in _starts())
    before = (solve.host_reads, solve.steps_run, solve.frozen_steps)
    res = nmf_solve(top, W0, H0, _opts(topt))
    reads, steps, frozen = (a - b for a, b in zip(
        (solve.host_reads, solve.steps_run, solve.frozen_steps), before))
    assert steps == int(res.iterations.max()) and frozen == 0
    assert reads == steps


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", range(1, k3.MAX_LANES + 1))
@pytest.mark.parametrize("a_dtype", sorted(A_DTYPES))
def test_cuda_lane_kernel_matches_plain(a_dtype, lanes):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.RandomState(lanes)
    for m, w in ((257, 130), (3000, 3000), (3000, 1024), (100, 3)):
        A = torch.from_numpy(rng.rand(m, w).astype(np.float32)).to(
            A_DTYPES[a_dtype]).cuda()
        Wt = torch.rand((2 * lanes, m), device="cuda")
        H = torch.rand((2 * lanes, w), device="cuda")
        before = (k3.launches, k3.lane_launches)
        pairs = [(k3.wt_a(A, Wt), k3.wt_a_plain(A, Wt)),
                 (k3.h_at(A, H), k3.h_at_plain(A, H))]
        torch.cuda.synchronize()
        assert k3.launches == before[0] + 2
        assert k3.lane_launches == before[1] + (2 if lanes > 1 else 0)
        for got, want in pairs:
            assert float((got - want).abs().max()) \
                <= 2e-5 * float(want.abs().max())
