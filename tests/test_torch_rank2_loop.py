"""K3, the rank-2 products and loop (kernels/rank2_loop.py): the plain
versions against P3 itself (scripts/tpu_batch60.py's Pallas kernel in
interpret mode, and its xla_loop) and against torch.matmul in f64; the
dispatch rule of DenseAOp and its branch counters; and the kernel against
its plain version on a card (marked `cuda`, skipped without one).

Tolerances, relative to the largest |value| of the reference side:
  - the plain loop against P3, f32: 2e-5.  Both sum in f32 in another
    order; over 200 normalized iterations the difference stays at the
    f32 rounding of one iteration (measured up to 6e-6 on the CPU);
  - the plain products against torch.matmul in f64: 1e-12;
  - the kernel against its plain version on the card: 2e-5 for one
    product and 1e-4 for the 200-iteration loop (f32 sums in another
    order; the loop compounds them).
"""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from smallk_torch.kernels import rank2_loop as k3
from smallk_torch.ops import aop

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(64, 32), (257, 130), (100, 37), (31, 7)]


def _p3():
    """scripts/tpu_batch60.py, imported by path (scripts/ is no package)."""
    spec = importlib.util.spec_from_file_location(
        "tpu_batch60", ROOT / "scripts" / "tpu_batch60.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _p3_interpret(mod, A, Wt):
    """P3's pallas_loop with its VMEM BlockSpecs, in interpret mode."""
    m = A.shape[0]
    call = pl.pallas_call(
        mod.kernel,
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((2, m), jnp.float32),
        interpret=True,
    )
    return np.asarray(call(A, Wt))


def _inputs(m, w, seed=0):
    """A >= 0 and a random Wt with both signs (with P3's constant 0.5 the
    two rows are equal and the second tests nothing)."""
    rng = np.random.RandomState(seed + m + w)
    A = rng.rand(m, w).astype(np.float32)
    Wt = (rng.rand(2, m) - 0.3).astype(np.float32)
    return A, Wt


def _rel(a, b):
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(np.asarray(a, np.float64) - b).max()
                 / np.abs(b).max())


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("m,w", SHAPES)
def test_plain_loop_matches_p3(m, w, bf16):
    mod = _p3()
    A, Wt = _inputs(m, w)
    jA = jnp.asarray(A).astype(jnp.bfloat16 if bf16 else jnp.float32)
    tA = torch.from_numpy(A).to(torch.bfloat16 if bf16 else torch.float32)
    plain = k3.rank2_loop_plain(tA, torch.from_numpy(Wt), mod.ITERS)
    assert plain.dtype == torch.float32 and plain.shape == (2, m)
    assert np.isfinite(plain.numpy()).all()
    interp = _p3_interpret(mod, jA, jnp.asarray(Wt))
    xla = np.asarray(mod.xla_loop(jA, jnp.asarray(Wt)))
    assert _rel(plain.numpy(), interp) <= 2e-5
    assert _rel(plain.numpy(), xla) <= 2e-5
    # the wrapper on CPU tensors is the plain version, bit for bit
    np.testing.assert_array_equal(
        k3.rank2_loop(tA, torch.from_numpy(Wt)).numpy(), plain.numpy())


@pytest.mark.parametrize("m,w", SHAPES)
def test_plain_products_match_matmul_f64(m, w):
    A, Wt = _inputs(m, w, seed=1)
    H = np.random.RandomState(m).rand(2, w)
    tA = torch.from_numpy(A.astype(np.float64))
    tW, tH = torch.from_numpy(Wt.astype(np.float64)), torch.from_numpy(H)
    assert _rel(k3.wt_a_plain(tA, tW).numpy(), Wt.astype(np.float64) @ A) \
        <= 1e-12
    assert _rel(k3.h_at_plain(tA, tH).numpy(), H @ A.T.astype(np.float64)) \
        <= 1e-12
    # on CPU tensors the wrappers take the plain versions
    np.testing.assert_array_equal(k3.wt_a(tA, tW).numpy(),
                                  k3.wt_a_plain(tA, tW).numpy())
    np.testing.assert_array_equal(k3.h_at(tA, tH).numpy(),
                                  k3.h_at_plain(tA, tH).numpy())


@pytest.mark.parametrize("m,w,slabs,rows", [
    (12411, 512, 194, 64), (12411, 7984, 17, 731), (20000, 512, 264, 76),
    (12411, 2048, 66, 189), (1, 1, 1, 1), (100, 3, 2, 50), (64, 600, 1, 64),
])
def test_slab_plan(m, w, slabs, rows):
    """The row cut covers every row once, leaves no slab empty, and puts
    about four blocks on each SM where the rows allow it."""
    got = k3.slab_plan(m, w)
    assert got == (slabs, rows)
    assert (slabs - 1) * rows < m <= slabs * rows


def _fake(device, dtype):
    return SimpleNamespace(is_cuda=device == "cuda", dtype=dtype)


@pytest.mark.parametrize("device,a_dtype,f_dtype,k,kernel", [
    ("cuda", torch.float32, torch.float32, 2, True),
    ("cuda", torch.bfloat16, torch.float32, 2, True),
    ("cuda", torch.float64, torch.float64, 2, False),
    ("cuda", torch.float32, torch.float64, 2, False),
    ("cuda", torch.bfloat16, torch.float32, 8, False),
    ("cuda", torch.float16, torch.float32, 2, False),
    ("cpu", torch.float32, torch.float32, 2, False),
    ("cpu", torch.bfloat16, torch.float32, 2, False),
])
def test_dispatch_rule(device, a_dtype, f_dtype, k, kernel):
    """K3 takes a product when A is on CUDA in f32 or bf16, the factor is
    f32 and k = 2; everything else is torch.matmul."""
    assert aop._kernel_product_ok(_fake(device, a_dtype),
                                  _fake(device, f_dtype), k) is kernel


@pytest.mark.parametrize("k", [2, 3])
def test_dense_aop_branches_and_counters(k, monkeypatch):
    """Each product bumps the counter of the branch it took and returns
    the factor-dtype product either way.  The kernel branch is forced here
    (a stand-in rule that accepts CPU tensors); on CPU tensors the K3
    wrappers take their plain versions, so no kernel launches."""
    rng = np.random.RandomState(k)
    A = torch.from_numpy(rng.rand(20, 15).astype(np.float32))
    W = torch.from_numpy(rng.rand(20, k).astype(np.float32))
    H = torch.from_numpy(rng.rand(k, 15).astype(np.float32))
    op = aop.DenseAOp(A)
    monkeypatch.setattr(aop, "kernel_products", 0)
    monkeypatch.setattr(aop, "matmul_products", 0)
    monkeypatch.setattr(k3, "launches", 0)
    plain = (op.mm_tn(W), op.mm_nt(H))
    assert (aop.kernel_products, aop.matmul_products) == (0, 2)
    monkeypatch.setattr(aop, "_kernel_product_ok",
                        lambda A, F, k: F.dtype == torch.float32 and k == 2)
    out = (op.mm_tn(W), op.mm_nt(H))
    want = (2, 2) if k == 2 else (0, 4)
    assert (aop.kernel_products, aop.matmul_products) == want
    assert k3.launches == 0
    for a, b in zip(out, plain):
        assert a.shape == b.shape and a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_wrappers_refuse_bad_shapes():
    A = torch.rand(8, 5)
    with pytest.raises(ValueError):
        k3.wt_a(A, torch.rand(2, 7))
    with pytest.raises(ValueError):
        k3.h_at(A, torch.rand(3, 5))
    with pytest.raises(ValueError):
        k3.rank2_loop(A, torch.rand(2, 8), iters=-1)
    with pytest.raises(ValueError):
        k3.wt_a(torch.rand(0, 5), torch.rand(2, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("m,w", [(257, 130), (12411, 512), (100, 3)])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_cuda_kernel_matches_plain(m, w, bf16):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    A, Wt = _inputs(m, w)
    dt = torch.bfloat16 if bf16 else torch.float32
    tA = torch.from_numpy(A).to(dt).cuda()
    tW = torch.from_numpy(Wt).cuda()
    H = torch.rand((2, w), device="cuda")
    before = k3.launches
    pairs = [(k3.wt_a(tA, tW), k3.wt_a_plain(tA, tW), 2e-5),
             (k3.h_at(tA, H), k3.h_at_plain(tA, H), 2e-5),
             (k3.rank2_loop(tA, tW), k3.rank2_loop_plain(tA, tW), 1e-4)]
    torch.cuda.synchronize()
    assert k3.launches == before + 3
    for got, want, tol in pairs:
        assert _rel(got.cpu().numpy(), want.cpu().numpy()) <= tol
