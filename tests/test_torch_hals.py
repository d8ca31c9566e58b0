"""The port's whole-step HALS (K2) and its sweeps against the JAX package.

On the CPU the kernel's wrapper takes its plain torch version; that is
held against the Pallas kernel in interpret mode (f32, with the
reference's own Pallas-vs-XLA tolerances and its inputs) and against the
reference's XLA step (f64).  The CUDA kernel itself is held against the
plain version by the test marked `cuda` (skipped without a card) and by
chip_smoke.py on the H100.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smallk_tpu.solvers.hals as jhals
from smallk_tpu.ops.aop import DenseAOp as JDenseAOp
from smallk_tpu.solvers.hals_pallas import hals_fits as jhals_fits
from smallk_tpu.solvers.hals_pallas import hals_step_pallas
from smallk_torch.kernels import _build
from smallk_torch.kernels import hals_step as k2
from smallk_torch.ops.aop import DenseAOp
from smallk_torch.solvers import hals

torch.set_num_threads(1)

# the reference's Pallas-vs-XLA tolerances (tests/test_solvers.py:720-727):
# W, H, HH', AH' and then the two gradients
FAC_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
OUT_TOLS = (FAC_TOL, FAC_TOL, GRAD_TOL, GRAD_TOL, FAC_TOL, FAC_TOL)
RTOL, ATOL = 1e-8, 1e-9  # f64 parity with the reference's XLA step


def _inputs(m, n, k, dtype=np.float32, seed=0):
    """As tests/test_solvers.py::test_hals_pallas_step_parity makes them."""
    rs = np.random.RandomState(seed)
    return (rs.rand(m, n).astype(dtype), rs.rand(m, k).astype(dtype),
            rs.rand(k, n).astype(dtype))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _pallas_and_plain(A, W, H, bf16, rescue=False):
    """One step of the Pallas kernel (interpret mode) and of the port's
    plain version from the same state; HH' and AH' from the reference's
    init, as both receive them in a solve."""
    jA = jnp.asarray(A)
    tA = torch.from_numpy(A)
    if bf16:
        jA, tA = jA.astype(jnp.bfloat16), tA.to(torch.bfloat16)
    st = jhals.init(JDenseAOp(jA), jnp.asarray(W), jnp.asarray(H))
    HHt, AHt = np.asarray(st.HHt), np.asarray(st.AHt)
    if rescue:
        # a W column that goes all-negative is refilled with eps and
        # unit-normalized (tests/test_solvers.py:730-739)
        W = W.copy()
        W[:, 3] = 0.0
        AHt = AHt.copy()
        AHt[:, 3] = -1.0
    out = hals_step_pallas(jA, jnp.asarray(W), jnp.asarray(H),
                           jnp.asarray(HHt), jnp.asarray(AHt),
                           interpret=True)
    ref = k2.hals_step(tA, *_t(W, H, HHt, AHt))
    return [np.asarray(o) for o in out], ref


@pytest.mark.parametrize("bf16", [False, True], ids=["f32_A", "bf16_A"])
@pytest.mark.parametrize("m,n,k", [(96, 80, 8), (200, 130, 5)])
def test_plain_matches_pallas_interpret(m, n, k, bf16):
    A, W, H = _inputs(m, n, k)
    out, ref = _pallas_and_plain(A, W, H, bf16)
    assert all(t.dtype == torch.float32 for t in ref[:6])
    assert bool(ref[6])
    for t, p, tol in zip(ref[:6], out, OUT_TOLS, strict=True):
        assert t.shape == p.shape
        np.testing.assert_allclose(t.numpy(), p, **tol)


def test_zero_column_rescue_matches_pallas_interpret():
    """W, as the reference's own rescue check holds it (the other outputs
    of the rescue step are held in f64 below)."""
    A, W, H = _inputs(96, 80, 8)
    out, ref = _pallas_and_plain(A, W, H, False, rescue=True)
    np.testing.assert_allclose(ref[0].numpy(), out[0], **FAC_TOL)
    # the rescued column went through the eps fill before its new sweep
    # value; with W'A > 0 it comes back positive and unit-norm
    np.testing.assert_allclose(np.linalg.norm(ref[0][:, 3].numpy()), 1.0,
                               rtol=1e-6)


def test_rescued_column_is_uniform():
    """A column the update drives all-negative is refilled with eps and
    normalizes to 1/sqrt(m): the plain version and the reference's
    update_w agree (f64)."""
    A, W, H = _inputs(40, 30, 4, np.float64, seed=3)
    HHt = H @ H.T
    AHt = A @ H.T
    AHt[:, 2] = -1.0
    Wj = np.asarray(jhals.update_w(jnp.asarray(W), jnp.asarray(HHt),
                                   jnp.asarray(AHt)))
    Wt = hals.update_w(*_t(W, HHt, AHt)).numpy()
    np.testing.assert_allclose(Wt[:, 2], np.full(40, 1 / np.sqrt(40)),
                               rtol=1e-12)
    np.testing.assert_allclose(Wt, Wj, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("m,n,k,rescue", [(60, 40, 6, False),
                                           (200, 130, 5, False),
                                           (96, 80, 8, True)])
def test_plain_matches_xla_step_f64(m, n, k, rescue):
    """Three steps of the port's plain version against the reference's XLA
    step body (the Pallas gate is closed for f64 on the CPU); `rescue`
    starts from a state whose column 3 sweeps to all zeros."""
    A, W, H = _inputs(m, n, k, np.float64, seed=m)
    ja = JDenseAOp(jnp.asarray(A))
    js = jhals.init(ja, jnp.asarray(W), jnp.asarray(H))
    if rescue:
        W[:, 3] = 0.0
        js = jhals.HalsState(HHt=js.HHt, AHt=js.AHt.at[:, 3].set(-1.0))
    Wj, Hj = jnp.asarray(W), jnp.asarray(H)
    tA, tW, tH = _t(A, W, H)
    HHt, AHt = _t(js.HHt, js.AHt)
    for _ in range(3):
        Wj, Hj, gWj, gHj, js, okj = jhals.step(ja, Wj, Hj, js)
        tW, tH, gW, gH, HHt, AHt, ok = k2.hals_step(tA, tW, tH, HHt, AHt)
        assert bool(ok) and bool(okj)
        for t, j in ((tW, Wj), (tH, Hj), (gW, gWj), (gH, gHj),
                     (HHt, js.HHt), (AHt, js.AHt)):
            assert t.dtype == torch.float64
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                                       atol=ATOL)


def test_update_w_and_update_h_match_reference():
    A, W, H = _inputs(50, 35, 7, np.float64, seed=11)
    HHt, AHt = H @ H.T, A @ H.T
    Wj = np.asarray(jhals.update_w(*map(jnp.asarray, (W, HHt, AHt))))
    Wt = hals.update_w(*_t(W, HHt, AHt))
    np.testing.assert_allclose(Wt.numpy(), Wj, rtol=RTOL, atol=ATOL)
    WtW, WtA = Wj.T @ Wj, Wj.T @ A
    Hj = np.asarray(jhals.update_h(*map(jnp.asarray, (H, WtW, WtA))))
    Ht = hals.update_h(*_t(H, WtW, WtA))
    np.testing.assert_allclose(Ht.numpy(), Hj, rtol=RTOL, atol=ATOL)


def test_sweeps_leave_their_inputs_alone():
    """The sweeps update a copy: a caller's W (the DELTA_FNORM progress
    state is the previous W itself) must not change under it."""
    A, W, H = _inputs(30, 20, 4, np.float64, seed=2)
    tW, tH = _t(W, H)
    hals.update_w(tW, *_t(H @ H.T, A @ H.T))
    hals.update_h(tH, *_t(W.T @ W, W.T @ A))
    np.testing.assert_array_equal(tW.numpy(), W)
    np.testing.assert_array_equal(tH.numpy(), H)


def test_zero_diagonal_follows_the_clamp():
    """HH'_cc = 0 divides by zero: NaN clamps to 0, +Inf stays and the
    norm then turns it into NaN, as in the reference; the step reports
    failure through `ok`."""
    A, W, H = _inputs(20, 15, 3, np.float64, seed=4)
    HHt, AHt = H @ H.T, A @ H.T
    HHt[1, 1] = 0.0
    Wj = np.asarray(jhals.update_w(*map(jnp.asarray, (W, HHt, AHt))))
    Wt = hals.update_w(*_t(W, HHt, AHt)).numpy()
    np.testing.assert_array_equal(np.isnan(Wt), np.isnan(Wj))
    np.testing.assert_allclose(Wt, Wj, rtol=RTOL, atol=ATOL, equal_nan=True)
    out = k2.hals_step(*_t(A, W, H, HHt, AHt))
    assert not bool(out[6])


def test_hals_fits_derivation():
    """The kernel's per-CTA shared-memory layout (a cluster of 8: a CTA's
    rows of W^T, its columns of H, and its rows of AH'^T or columns of W'A
    in one slot, in f32 at odd strides; four k x k f64 Grams and 32
    reduction doubles; the other CTAs' slices are read through DSMEM),
    bounded by the reference's envelope: never a shape that the TPU would
    not have sent to its kernel."""
    assert k2.CLUSTER == 8
    # 256 x 256, k = 16: slices of 32 rows and columns at stride 33
    assert k2.smem_bytes(256, 256, 16) == 4 * 16 * 3 * 33 + 8 * (4 * 256 + 32)
    # 3000 x 10, k = 4: strides 375 and 3
    assert k2.smem_bytes(3000, 10, 4) == 4 * 4 * (375 + 3 + 375) + 8 * (
        4 * 16 + 32)
    assert k2.hals_fits(256, 256, 16) and k2.hals_fits(256, 256, 16, 2)
    # k = 16: the envelope binds, at 992 x 992 in f32 (as the reference's
    # own) and 1140 x 1140 in bf16; shared memory has room
    assert k2.hals_fits(992, 992, 16) and not k2.hals_fits(993, 993, 16)
    assert jhals_fits(992, 992, 16) and not jhals_fits(993, 993, 16)
    assert k2.smem_bytes(992, 992, 16) <= 48 * 1024
    side16 = max(s for s in range(1, 1400) if jhals_fits(s, s, 16, 2))
    assert side16 == 1140 and k2.hals_fits(side16, side16, 16, 2)
    assert not k2.hals_fits(side16 + 1, side16 + 1, 16, 2)
    for m, n, k, isz in [(96, 80, 8, 4), (200, 130, 5, 2), (3000, 10, 4, 4),
                         (10, 3000, 4, 4), (1200, 1200, 2, 4),
                         (2000, 900, 4, 2), (64, 64, 40, 4),
                         (888, 888, 16, 2), (1, 1, 1, 4)]:
        if k2.hals_fits(m, n, k, isz):
            assert jhals_fits(m, n, k, isz)
            assert k2.smem_bytes(m, n, k) <= k2.MAX_SMEM
    # shared memory refuses what the envelope would allow: at k = 100 the
    # four f64 Grams alone are 320 KB
    assert jhals_fits(64, 64, 100) and not k2.hals_fits(64, 64, 100)
    # the envelope alone refuses (1200, 1200): A and its upcast are 11.5 MB
    assert not jhals_fits(1200, 1200, 2) and not k2.hals_fits(1200, 1200, 2)
    assert not k2.hals_fits(0, 10, 2)


@pytest.mark.parametrize("k", [1, 2, 5, 16, 40, 64])
def test_hals_fits_never_leaves_the_envelope(k):
    """Over a grid of shapes and both A dtypes, every shape the kernel
    admits is inside the reference's envelope and its shared memory."""
    sides = sorted({1, 2, 7, 8, 9, 63, 64, 65, 255, 256, 500, 888, 992,
                    993, 1140, 1141, 1500, 3000, 9000, 20000})
    admitted = 0
    for m in sides:
        for n in sides:
            for isz in (4, 2):
                if k2.hals_fits(m, n, k, isz):
                    admitted += 1
                    assert jhals_fits(m, n, k, isz), (m, n, k, isz)
                    assert k2.smem_bytes(m, n, k) <= k2.MAX_SMEM
    assert admitted > 0


def test_gate_stays_closed_off_the_card():
    """The kernel gate needs dense f32/bf16 A, f32 W, CUDA tensors and a
    fitting shape; on the CPU the torch-ops step runs."""
    A, W, H = _inputs(96, 80, 8)
    tA, tW, tH = _t(A, W, H)
    assert not hals._kernel_step_ok(DenseAOp(tA), tW, tH)
    assert not hals._kernel_step_ok(DenseAOp(tA.double()), tW.double(),
                                    tH.double())
    before = k2.launches
    st = hals.init(DenseAOp(tA), tW, tH)
    out = hals.step(DenseAOp(tA), tW, tH, st)
    assert k2.launches == before
    ref = k2.hals_step_reference(tA, tW, tH, *st)
    for a, b in zip(out[:4], ref[:4], strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["A_ndim", "W_rows", "H_shape", "HHt_shape",
                                  "AHt_shape", "meta_device"])
def test_wrapper_rejects_bad_inputs(case):
    A, W, H = _t(*_inputs(12, 10, 3))
    HHt, AHt = H @ H.T, A @ H.T
    args = dict(A=A, W=W, H=H, HHt=HHt, AHt=AHt)
    if case == "A_ndim":
        args["A"] = A[0]
    elif case == "W_rows":
        args["W"] = W[:-1]
    elif case == "H_shape":
        args["H"] = H[:, :-1]
    elif case == "HHt_shape":
        args["HHt"] = HHt[:-1]
    elif case == "AHt_shape":
        args["AHt"] = AHt[:, :-1]
    else:
        args["W"] = W.to("meta")
    with pytest.raises(ValueError):
        k2.hals_step(**args)


def test_build_targets_hopper():
    src = _build.CSRC / "hals_step.cu"
    assert src.is_file()
    cmd = _build.nvcc_command("nvcc", [src], _build.BUILD_DIR / "x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert not any("fast_math" in c or "fast-math" in c for c in cmd)
    path = _build.library_path("hals_step")
    assert path.parent == _build.BUILD_DIR
    assert path != _build.library_path("masked_gj")
    for fn in ("smallk_hals_step_f32", "smallk_hals_step_bf16"):
        argtypes, restype = _build.SIGNATURES["hals_step"][fn]
        assert argtypes[:12] == (_build._P,) * 12
        assert argtypes[15] == _build._P and restype == _build._I
    # the kernel calls no library: no cuBLAS, no torch headers
    text = src.read_text()
    for banned in ("cublas", "torch/", "ATen", "cutlass"):
        assert banned not in text
    # the clamp keeps +Inf: a select, never a max
    assert "smem_bytes" in text and "fmaxf(" not in text
    # a cluster launch; the shared-memory opt-in on every launch that needs
    # it, never cached per process; no atomics, no early return
    assert "cudaLaunchAttributeClusterDimension" in text
    assert "cudaLaunchKernelEx" in text
    assert "static size_t" not in text and "opted_in" not in text
    assert "atomicAdd" not in text
    kernel = text[text.index("hals_step_kernel(const TA*"):
                  text.index("// cluster barrier and DSMEM latency")]
    assert "return;" not in kernel


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,bf16,rescue", [
    (256, 256, 16, False, False), (256, 256, 16, True, False),
    (96, 80, 8, False, False), (200, 130, 5, False, False),
    (888, 888, 16, False, False),
    # the largest admitted squares at k = 16, f32 and bf16 A
    (992, 992, 16, False, False), (1140, 1140, 16, True, False),
    # slices wider than a CTA's threads; CTAs with no rows or columns
    (3000, 10, 4, False, False), (10, 3000, 4, False, False),
    (20000, 10, 4, False, False), (5, 3, 2, False, False),
    # k not a multiple of 8 past one tile
    (64, 64, 40, False, False),
    (96, 80, 8, False, True)])
def test_cuda_kernel_matches_plain(m, n, k, bf16, rescue):
    """The kernel against the plain version evaluated in f64 on the same
    inputs (chip_smoke.py says why f64), with the reference's tolerances;
    `rescue` drives W's column 3 to all zeros (the eps fill).  A second
    launch gives the same bits (fixed summation order, no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    A, W, H = (t.cuda() for t in _t(*_inputs(m, n, k)))
    if bf16:
        A = A.to(torch.bfloat16)
    HHt, AHt = hals.init(DenseAOp(A), W, H)
    if rescue:
        W[:, 3] = 0.0
        AHt[:, 3] = -1.0
    assert k2.hals_fits(m, n, k, A.element_size())
    before = k2.launches
    out = k2.hals_step(A, W, H, HHt, AHt)
    assert k2.launches == before + 1
    ref = k2.hals_step_reference(*(t.double() for t in (A, W, H, HHt, AHt)))
    assert bool(out[6]) == bool(ref[6])
    for a, b, tol in zip(out[:6], ref[:6], OUT_TOLS, strict=True):
        torch.testing.assert_close(a, b.float(), **tol)
    again = k2.hals_step(A, W, H, HHt, AHt)
    for a, b in zip(out, again, strict=True):
        assert torch.equal(a, b)
