"""e4m3 A-storage (NmfOptions.a_dtype = "float8_e4m3fn") in the port
against the JAX package, and the three kernels' e4m3 loads against their
plain versions on a card (marked `cuda`, skipped without one).

e4m3 is an A-storage dtype only: its products come out in the factor dtype
(the reference's regression test, tests/test_ops.py:288), and no factor is
ever e4m3 (`torch_dtype` keeps refusing it).

Tolerances:
  - f64 factors on the CPU: the two packages quantize A to the same e4m3
    values (checked exactly) and then run the same f64 solve, so W and H
    agree to 1e-9 relative to their largest entry (a BPP solve of 30
    iterations; f64 sums in another order);
  - on the card, each kernel's e4m3 instantiation against its plain
    version on the same e4m3 values: 2e-5 relative (f32 sums in another
    order; K2: the HALS tolerances of tests/test_torch_hals.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from smallk_tpu.common.options import NmfAlgorithm as JAlg
from smallk_tpu.common.options import NmfOptions as JOpts
from smallk_tpu.common.rng import Random as JRandom
from smallk_tpu.common.rng import random_matrix as jrandom_matrix
from smallk_tpu.engines.nmf import run_nmf as jrun_nmf
from smallk_tpu.ops.aop import as_aop as jas_aop
from smallk_torch.common.device import storage_dtype, torch_dtype
from smallk_torch.common.options import NmfAlgorithm, NmfOptions
from smallk_torch.engines.nmf import run_nmf
from smallk_torch.ops.aop import DenseAOp, as_aop
from smallk_torch.ops.ell import EllAOp
from smallk_torch.solvers.solve import nmf_solve

torch.set_num_threads(1)

F8 = torch.float8_e4m3fn


def _problem(m=60, n=50, k=4, seed=3):
    rng = np.random.RandomState(seed)
    A = rng.rand(m, k) @ rng.rand(k, n) + 0.05 * rng.rand(m, n)
    W0 = jrandom_matrix(m, k, JRandom(1))
    H0 = jrandom_matrix(k, n, JRandom(2))
    return A, W0, H0


def _opts(cls, alg, m, n, k, **kw):
    return cls(tol=1e-9, algorithm=alg, height=m, width=n, k=k, min_iter=1,
               max_iter=30, verbose=False, dtype="float64",
               a_dtype="float8_e4m3fn", **kw)


def test_e4m3_is_a_storage_dtype_only():
    assert storage_dtype("float8_e4m3fn") == F8
    assert storage_dtype("bfloat16") == torch.bfloat16
    for name in ("float8_e4m3fn", "float8"):
        with pytest.raises(ValueError):
            torch_dtype(name)
    with pytest.raises(ValueError):
        storage_dtype("float8")


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_quantized_a_equals_reference(sparse):
    A, _, _ = _problem()
    host = sp.csc_matrix(A) if sparse else A
    mine = as_aop(host, dtype="float8_e4m3fn", device="cpu")
    ref = jas_aop(host, dtype=jnp.float8_e4m3fn)
    assert isinstance(mine, DenseAOp) and mine.A.dtype == F8
    np.testing.assert_array_equal(mine.A.double().numpy(),
                                  np.asarray(ref.A).astype(np.float64))


@pytest.mark.parametrize("alg", ["BPP", "MU", "HALS", "RANK2"])
def test_run_nmf_e4m3_matches_reference_f64(alg):
    k = 2 if alg == "RANK2" else 4
    A, W0, H0 = _problem(k=k)
    m, n = A.shape
    W0, H0 = W0[:, :k], H0[:k]
    Wr, Hr, okr = jrun_nmf(A, W0, H0, _opts(JOpts, getattr(JAlg, alg),
                                            m, n, k))
    W, H, ok = run_nmf(A, W0, H0, _opts(NmfOptions,
                                        getattr(NmfAlgorithm, alg), m, n,
                                        k), device="cpu")
    assert ok and bool(okr)
    assert W.dtype == np.float64 and np.all(np.isfinite(W))
    for got, want in ((W, Wr), (H, Hr)):
        want = np.asarray(want)
        err = np.max(np.abs(got - want)) / np.max(np.abs(want))
        assert err <= 1e-9, err


@pytest.mark.parametrize("storage", ["bfloat16", "float8_e4m3fn"])
def test_ell_low_precision_storage_solver_parity(storage):
    """The port of tests/test_ops.py:288: quantized ELL storage keeps the
    products in the factor dtype, and BPP stays healthy on it."""
    rng = np.random.RandomState(11)
    A = sp.random(300, 400, density=0.1, random_state=rng, format="csc")
    W0 = torch.from_numpy(jrandom_matrix(300, 8, JRandom(1))).float()
    H0 = torch.from_numpy(jrandom_matrix(8, 400, JRandom(2))).float()
    opts = NmfOptions(tol=1e-9, algorithm=NmfAlgorithm.BPP, height=300,
                      width=400, k=8, min_iter=1, max_iter=10, verbose=False,
                      dtype="float32", a_dtype=storage)
    for blocks in ({}, {"doc_block": 128, "term_block": 128}):
        op = EllAOp.from_scipy(A, storage, device="cpu", **blocks)
        assert op.dtype == storage_dtype(storage)
        assert op.mm_tn(W0).dtype == torch.float32
        assert op.mm_nt(H0).dtype == torch.float32
        out = nmf_solve(op, W0, H0, opts)
        assert out.success
        assert float(out.W.max()) > 0.0 and float(out.H.max()) > 0.0


# --- the kernels' e4m3 loads on the card ------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


def _rel(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-300)


@pytest.mark.cuda
@pytest.mark.parametrize("m,w", [(257, 130), (12411, 512), (100, 3)])
def test_cuda_k3_e4m3_matches_plain(m, w):
    from smallk_torch.kernels import rank2_loop as k3

    _cuda()
    g = torch.Generator().manual_seed(m + w)
    A = torch.rand((m, w), generator=g).to(F8).cuda()
    Wt = torch.rand((2, m), generator=g).cuda()
    H = torch.rand((2, w), generator=g).cuda()
    before = k3.launches
    got = (k3.wt_a(A, Wt), k3.h_at(A, H))
    want = (k3.wt_a_plain(A, Wt), k3.h_at_plain(A, H))
    torch.cuda.synchronize()
    assert k3.launches == before + 2
    for x, y in zip(got, want):
        assert _rel(x, y) <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(256, 256, 16), (96, 80, 8),
                                   (1140, 1140, 16)])
def test_cuda_k2_e4m3_matches_plain(m, n, k):
    from smallk_torch.kernels import hals_step as k2

    _cuda()
    g = torch.Generator().manual_seed(m + n + k)
    A = torch.rand((m, n), generator=g).to(F8).cuda()
    W = torch.rand((m, k), generator=g).cuda()
    H = torch.rand((k, n), generator=g).cuda()
    HHt = H @ H.T
    AHt = A.float() @ H.T
    before = k2.launches
    got = k2.hals_step(A, W, H, HHt, AHt)
    want = k2.hals_step_reference(A.double(), W.double(), H.double(),
                                  HHt.double(), AHt.double())
    torch.cuda.synchronize()
    assert k2.launches == before + 1
    assert bool(got[-1])
    for x, y in zip(got[:4], want[:4]):
        assert _rel(x.double(), y) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 8, 128])
def test_cuda_ell_spmm_e4m3_matches_plain(k):
    from smallk_torch.kernels import ell_spmm as kmod

    _cuda()
    rng = np.random.RandomState(k)
    g_pad, L, B = 300, 40, 500
    idx = rng.randint(0, B + 1, size=(g_pad, L)).astype(np.int32)
    vals = torch.from_numpy(rng.rand(g_pad, L)).to(F8).cuda()
    table = torch.from_numpy(rng.rand(B, k)).float().cuda()
    idx = torch.from_numpy(idx).cuda()
    out = torch.zeros((g_pad, k), device="cuda")
    before = kmod.launches
    got = kmod.ell_spmm(idx, vals, table, out.clone())
    want = kmod.ell_spmm_reference(idx, vals, table, out.clone())
    torch.cuda.synchronize()
    assert kmod.launches == before + 1
    assert _rel(got, want) <= 2e-5


def test_gather_columns_pads_e4m3_with_zeros():
    """A dense e4m3 node operand: the subset's columns byte for byte, and
    the padding's columns +0.0."""
    from smallk_torch.engines.hierclust import gather_columns

    A = torch.rand((5, 9), generator=torch.Generator().manual_seed(1))
    A8 = A.to(F8)
    idx = torch.tensor([1, 4, 7])
    got = gather_columns(A8, idx, 6)
    assert got.dtype == F8 and got.shape == (5, 6)
    assert torch.equal(got[:, :3].view(torch.uint8),
                       A8[:, idx].view(torch.uint8))
    assert not got[:, 3:].float().any()
    out = torch.full((5, 6), 1.0).to(F8)
    gather_columns(A8, idx, 6, out=out)
    assert torch.equal(out.view(torch.uint8), got.view(torch.uint8))


def test_hierclust_e4m3_chain_and_reference():
    """Hierclust on e4m3 A (f32 factors): the chain's tree is the
    sequential engine's, and its NMI against the planted labels is the
    JAX package's within 0.02."""
    from smallk_torch.common.options import (ClustOptions,
                                             NmfProgressAlgorithm)
    from smallk_torch.common.rng import Random
    from smallk_torch.engines import hier_chain
    from smallk_torch.engines.corpus import synthetic_term_doc_corpus
    from smallk_torch.engines.hierclust import clust_hier
    from smallk_torch.engines.scoring import nmi
    from smallk_tpu.common.options import ClustOptions as JC
    from smallk_tpu.common.options import NmfProgressAlgorithm as JP
    from smallk_tpu.engines.hierclust import clust_hier as jclust_hier

    A, labels = synthetic_term_doc_corpus(700, 1400, 10, seed=5)
    kw = dict(tol=1e-4, k=2, min_iter=1, max_iter=5000, verbose=False,
              dtype="float32", a_dtype="float8_e4m3fn")
    opts = ClustOptions(nmf_opts=NmfOptions(
        algorithm=NmfAlgorithm.RANK2,
        prog_est_algorithm=NmfProgressAlgorithm.PG_RATIO, **kw),
        num_clusters=10, verbose=False)
    trees = []
    for chain in (False, True):
        hier_chain.CHAIN = chain
        try:
            trees.append(clust_hier(A, opts, Random(21), device="cpu")[0])
        finally:
            hier_chain.CHAIN = True
    np.testing.assert_array_equal(trees[0].assignments, trees[1].assignments)
    assert [n.priority for n in trees[0].nodes] == \
        [n.priority for n in trees[1].nodes]
    assert hier_chain.LAST_STATS["committed"] >= 5
    jopts = JC(nmf_opts=JOpts(algorithm=JAlg.RANK2,
                              prog_est_algorithm=JP.PG_RATIO, **kw),
               num_clusters=10, verbose=False)
    ref = nmi(labels, jclust_hier(A, jopts, JRandom(21))[0].assignments)
    mine = nmi(labels, trees[1].assignments)
    assert sum(trees[1].is_leaf) == 10
    assert abs(mine - ref) <= 0.02, (mine, ref)
