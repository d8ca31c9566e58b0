"""K3, the rank-2 products and loop (kernels/rank2_loop.py): the plain
versions against P3 itself (scripts/tpu_batch60.py's Pallas kernel in
interpret mode, and its xla_loop) and against torch.matmul in f64; the
launch plans (`wt_a_plan`, `h_at_plan`) and the vector rule
(`vector_path`); the dispatch rule of DenseAOp and its branch counters;
and the kernel against its plain version on a card (marked `cuda`,
skipped without one): every factor row count, each A dtype, a
misaligned view and exact widths (the kernels' scalar path) and
bucket-width nodes.

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


@pytest.mark.parametrize("m,w,dtype,slabs,rows", [
    (12411, 512, torch.bfloat16, 97, 128),
    (12411, 7984, torch.bfloat16, 31, 401),
    (20000, 512, torch.bfloat16, 132, 152),
    (12411, 2048, torch.bfloat16, 33, 377),
    (1, 1, torch.float32, 1, 1),
    (100, 3, torch.bfloat16, 1, 100),
    (64, 600, torch.float32, 1, 64),
])
def test_slab_plan(m, w, dtype, slabs, rows):
    """wt_a's row cut at k = 2: the blocks stay within the target (one for
    each BLOCK_BYTES of A, at least two an SM), no slab under MIN_ROWS
    rows, every row covered once and no slab empty.  E.g. 12411 x 7984
    bf16: 32 column blocks of 256, 198 MB / 192 KiB = 1008 blocks, so 31
    slabs of 401 rows."""
    plan = k3.wt_a_plan(m, w, 2, dtype)
    assert (plan.grid[1], plan.rows_per_slab) == (slabs, rows)
    assert (slabs - 1) * rows < m <= slabs * rows


# the path's shapes (the Reuters root and a bucket width, the community
# cell's root and widths, the north-star root and widths) and ragged ones
PLAN_SHAPES = [(12411, 512), (12411, 7984), (3000, 512), (3000, 2048),
               (3000, 3000), (20000, 512), (20000, 8192), (20000, 20000),
               (1, 1), (100, 3), (257, 130)]
PLAN_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
               "e4m3": torch.float8_e4m3fn}


@pytest.mark.parametrize("m,w", PLAN_SHAPES)
@pytest.mark.parametrize("k", k3.ROWS)
@pytest.mark.parametrize("dtype", sorted(PLAN_DTYPES))
def test_plans_cover_the_operand(dtype, k, m, w):
    """Both launch plans cover every row and column once, leave no split
    empty, fill the card with about two blocks an SM or more where the
    shape allows, and size the scratch as the wrapper allocates it."""
    dt = PLAN_DTYPES[dtype]
    item = dt.itemsize
    tn, nt = k3.wt_a_plan(m, w, k, dt), k3.h_at_plan(m, w, k, dt)
    # wt_a: 32 C columns a block, 16 bytes a lane at most, k x C sums
    cols, (col_blocks, slabs) = tn.lane_cols, tn.grid
    assert cols * item <= 16 and k * cols <= 64 and cols % 4 == 0
    assert (col_blocks - 1) * 32 * cols < w <= col_blocks * 32 * cols
    assert (slabs - 1) * tn.rows_per_slab < m <= slabs * tn.rows_per_slab
    # the target is at least two blocks an SM; a plan misses it by less
    # than one column block's slabs, or has every slab MIN_ROWS rows
    target = k3.target_blocks(m, w, dt)
    assert target >= 2 * k3.SMS
    most = col_blocks * -(-m // k3.MIN_ROWS)
    assert min(target - col_blocks + 1, most) <= col_blocks * slabs
    assert col_blocks * slabs <= max(target, col_blocks)
    assert tn.scratch == (slabs * k * w if slabs > 1 else 0)
    out = torch.empty((k, w))
    buf = k3._partial(tn, out)
    assert buf is out if slabs == 1 else buf.numel() == tn.scratch
    # h_at: 32 rows a block, whole steps of 32 V columns a split, at most
    # MAX_SPLITS splits (one cluster), no scratch
    cols, (row_blocks, splits) = nt.lane_cols, nt.grid
    step = 32 * cols
    assert cols >= 4 and cols * item <= 16 and k * cols <= max(128, 4 * k)
    assert (row_blocks - 1) * nt.block_rows < m <= row_blocks * nt.block_rows
    assert nt.cols_per_split % step == 0 and 1 <= splits <= k3.MAX_SPLITS
    assert (splits - 1) * nt.cols_per_split < w <= splits * nt.cols_per_split
    target = k3.target_blocks(m, w, dt, 4 if k == 2 else 2)
    assert target >= 2 * k3.SMS
    # whole steps a split may round the splits down, but never below one
    # block an SM where the shape allows it
    most = row_blocks * min(-(-w // step), k3.MAX_SPLITS)
    assert min(k3.SMS, most) <= row_blocks * splits
    assert row_blocks * splits <= max(target, row_blocks)


def _views(dtype):
    """(A, takes the vector path): an aligned A, a contiguous view one
    element (an odd byte offset for e4m3) past an aligned allocation, and
    rows of 24 bytes."""
    base = torch.zeros(64 * 48 + 1).to(dtype)
    item = dtype.itemsize
    return [(base[:64 * 48].view(64, 48), True),
            (base[1:].view(64, 48), False),
            (torch.zeros(8, 24 // item).to(dtype), False)]


@pytest.mark.parametrize("dtype", sorted(PLAN_DTYPES))
def test_vector_rule(dtype):
    """The 16-byte loads need A's pointer and its rows' bytes to be
    multiples of 16; any other A takes the scalar path of the same
    plan."""
    for A, vec in _views(PLAN_DTYPES[dtype]):
        assert A.is_contiguous()
        assert k3.vector_path(A) is vec
        assert (A.data_ptr() % 16 == 0
                and A.shape[1] * A.element_size() % 16 == 0) is vec
    # every bucket width of the hierclust ladder takes the vector path
    for w in (512, 1024, 2048, 4096, 8192, 9216):
        A = torch.zeros((4, w), dtype=PLAN_DTYPES[dtype])
        assert k3.vector_path(A)


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


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


def _cuda_inputs(m, w, k, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed + m + w + k)
    A = torch.rand((m, w), generator=g, device="cuda").to(dtype)
    Wt = torch.rand((k, m), generator=g, device="cuda") - 0.3
    H = torch.rand((k, w), generator=g, device="cuda")
    return A, Wt, H


def _close(got, want, tol=2e-5):
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("m,w", [(3000, 1024), (257, 130), (12411, 512)])
@pytest.mark.parametrize("k", k3.ROWS)
@pytest.mark.parametrize("dtype", sorted(PLAN_DTYPES))
def test_cuda_products_every_k(dtype, k, m, w):
    """Both products at every factor row count, each A dtype, at a bucket
    width, a ragged shape and a P3 shape, against the plain version."""
    _cuda_or_skip()
    A, Wt, H = _cuda_inputs(m, w, k, PLAN_DTYPES[dtype])
    _close(k3.wt_a(A, Wt), k3.wt_a_plain(A, Wt))
    _close(k3.h_at(A, H), k3.h_at_plain(A, H))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(PLAN_DTYPES))
def test_cuda_misaligned_view(dtype):
    """A view whose rows are not 16-byte aligned takes the kernels'
    scalar path (not the plain version): it launches, agrees with the
    plain version, and gives the vector path's bits on an aligned copy."""
    _cuda_or_skip()
    dt = PLAN_DTYPES[dtype]
    m, w = 3000, 1024
    base = torch.rand(m * w + 1, device="cuda").to(dt)
    A = base[1:].view(m, w)
    assert not k3.vector_path(A) and k3.vector_path(A.clone())
    for k in (2, 6, 16):
        _, Wt, H = _cuda_inputs(m, w, k, dt)
        before = k3.launches
        got = (k3.wt_a(A, Wt), k3.h_at(A, H))
        assert k3.launches == before + 2
        _close(got[0], k3.wt_a_plain(A, Wt))
        _close(got[1], k3.h_at_plain(A, H))
        assert torch.equal(got[0], k3.wt_a(A.clone(), Wt))
        assert torch.equal(got[1], k3.h_at(A.clone(), H))
    if dt != torch.float8_e4m3fn:
        _, Wt, _ = _cuda_inputs(m, w, 2, dt)
        _close(k3.rank2_loop(A, Wt), k3.rank2_loop_plain(A, Wt), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("m,w,dtype,lanes", [
    (3000, 1024, torch.float32, 3), (20000, 4096, torch.float8_e4m3fn, 1)])
def test_cuda_bucket_width_nodes(m, w, dtype, lanes):
    """The graph cells' bucket-width node operands, twice: the same bits
    on every call (deterministic splits), within K3_TOL of plain."""
    _cuda_or_skip()
    A, Wt, H = _cuda_inputs(m, w, 2 * lanes, dtype)
    first = (k3.wt_a(A, Wt), k3.h_at(A, H))
    again = (k3.wt_a(A, Wt), k3.h_at(A, H))
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    _close(first[0], k3.wt_a_plain(A, Wt))
    _close(first[1], k3.h_at_plain(A, H))


@pytest.mark.cuda
@pytest.mark.parametrize("m,w,dtype", [
    (3000, 2999, torch.float32), (12411, 7983, torch.bfloat16),
    (3001, 2999, torch.float8_e4m3fn), (20000, 19999, torch.float8_e4m3fn)])
def test_cuda_exact_width_nodes(m, w, dtype):
    """Exact-width node operands, each row at its own offset from 16-byte
    alignment (the scalar path), at every factor row count, against the
    plain version."""
    _cuda_or_skip()
    for k in k3.ROWS:
        A, Wt, H = _cuda_inputs(m, w, k, dtype)
        assert not k3.vector_path(A)
        _close(k3.wt_a(A, Wt), k3.wt_a_plain(A, Wt))
        _close(k3.h_at(A, H), k3.h_at_plain(A, H))
