"""The port's masked Gauss-Jordan solve (K1) against the JAX package.

On the CPU the wrapper takes its plain torch version; it is held against
the Pallas kernel in interpret mode and against the reference's XLA
`_gj_solve_block`.  The wide-rank kernel's specification in torch ops (a
compact Gauss-Jordan per column) is held to the plain version with
tolerance 0.  The CUDA kernels themselves are held against the plain
version by the tests marked `cuda` (skipped without a card) and by
chip_smoke.py on the H100.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smallk_tpu.solvers.nnls as jnnls
from smallk_tpu.solvers.pallas_kernels import masked_gj_solve_pallas
from smallk_torch.kernels import _build, masked_gj
from smallk_torch.kernels.masked_gj import (
    masked_gj_solve,
    masked_gj_solve_compact_reference,
    masked_gj_solve_reference,
)

torch.set_num_threads(1)

F32_TOL = 1e-5   # the reference's own Pallas-vs-XLA tolerance
F64_ATOL = 1e-12


def _inputs(k, n, dtype=np.float32, seed=None):
    """As tests/test_solvers.py makes the kernel parity inputs."""
    rng = np.random.RandomState(k if seed is None else seed)
    B = rng.rand(k, 2 * k).astype(dtype)
    LHS = (B @ B.T + 0.1 * np.eye(k)).astype(dtype)
    RHS = (B @ rng.rand(2 * k, n)).astype(dtype)
    passive = rng.rand(k, n) > 0.6
    return LHS, RHS, passive


def _dead_pivot_inputs(dtype):
    k, n = 16, 64
    rng = np.random.RandomState(0)
    W = rng.rand(3 * k, k)
    W[:, 3] = 0.0  # dead topic -> ~0 Gram diagonal
    return ((W.T @ W).astype(dtype), (W.T @ rng.rand(3 * k, n)).astype(dtype),
            np.ones((k, n), dtype=bool))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("k,n", [(8, 300), (32, 257), (64, 100), (128, 130)])
def test_reference_matches_pallas_interpret(k, n):
    LHS, RHS, passive = _inputs(k, n)
    Xp = masked_gj_solve_pallas(jnp.asarray(LHS), jnp.asarray(RHS),
                                jnp.asarray(passive), interpret=True)
    Xt = masked_gj_solve_reference(*_t(LHS, RHS, passive))
    assert Xt.dtype == torch.float32 and Xt.shape == (k, n)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xp),
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("k,n", [(4, 50), (8, 300), (32, 257), (48, 90)])
def test_reference_matches_xla_gj_f64(k, n):
    LHS, RHS, passive = _inputs(k, n, np.float64)
    Xj = jnnls._gj_solve_block(jnp.asarray(LHS), jnp.asarray(RHS),
                               jnp.asarray(passive))
    Xt = masked_gj_solve_reference(*_t(LHS, RHS, passive))
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=0,
                               atol=F64_ATOL)
    # passive-subsystem solution, zeros elsewhere
    X = Xt.numpy()
    assert (X[~passive] == 0).all()
    j = int(np.argmax(passive.sum(0)))
    p = passive[:, j]
    np.testing.assert_allclose(LHS[np.ix_(p, p)] @ X[p, j], RHS[p, j],
                               rtol=1e-10)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5),
                                       (np.float64, 1e-12)])
def test_dead_pivot_guard(dtype, tol):
    LHS, RHS, passive = _dead_pivot_inputs(dtype)
    X = masked_gj_solve_reference(*_t(LHS, RHS, passive)).numpy()
    assert np.isfinite(X).all()
    np.testing.assert_allclose(X[3], 0.0, atol=tol)
    Xj = jnnls._gj_solve_block(jnp.asarray(LHS), jnp.asarray(RHS),
                               jnp.asarray(passive))
    np.testing.assert_allclose(X, np.asarray(Xj), rtol=0, atol=tol)


def test_reference_chunking_is_exact(monkeypatch):
    LHS, RHS, passive = _t(*_inputs(8, 301, np.float64))
    whole = masked_gj_solve_reference(LHS, RHS, passive)
    # a budget of 40 columns: 8 chunks, the last one ragged
    monkeypatch.setattr(masked_gj, "_REF_BYTES_BUDGET", 40 * 8 * 9 * 8)
    chunked = masked_gj_solve_reference(LHS, RHS, passive)
    assert torch.equal(whole, chunked)


def test_wrapper_takes_plain_version_on_cpu():
    LHS, RHS, passive = _t(*_inputs(16, 70))
    before = masked_gj.launches, masked_gj.columns
    X = masked_gj_solve(LHS, RHS, passive)
    assert (masked_gj.launches, masked_gj.columns) == before  # no kernel ran
    assert torch.equal(X, masked_gj_solve_reference(LHS, RHS, passive))


def _bad_inputs(case):
    LHS, RHS, passive = _t(*_inputs(6, 20))
    if case == "lhs_shape":
        LHS = LHS[:5, :5]
    elif case == "rhs_ndim":
        RHS = RHS[:, 0]
    elif case == "passive_dtype":
        passive = passive.to(torch.uint8)
    elif case == "passive_shape":
        passive = passive[:, :10]
    elif case == "dtype_mismatch":
        RHS = RHS.double()
    elif case == "meta_device":
        LHS, RHS, passive = (t.to("meta") for t in (LHS, RHS, passive))
    return LHS, RHS, passive


@pytest.mark.parametrize("case", ["lhs_shape", "rhs_ndim", "passive_dtype",
                                  "passive_shape", "dtype_mismatch",
                                  "meta_device"])
def test_wrapper_rejects_bad_inputs(case):
    with pytest.raises(ValueError):
        masked_gj_solve(*_bad_inputs(case))


def test_build_targets_hopper():
    cmd = _build.nvcc_command("nvcc", [_build.CSRC / "masked_gj.cu"],
                              _build.BUILD_DIR / "x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    for flag in ("-shared", "-fPIC", "-O3", "-std=c++17"):
        assert flag in cmd
    path = _build.library_path("masked_gj")
    assert path.parent == _build.BUILD_DIR
    assert path == _build.library_path("masked_gj")  # keyed, stable
    assert (_build.CSRC / "masked_gj.cu").is_file()
    sig = _build.SIGNATURES["masked_gj"]["smallk_masked_gj_f32"][0]
    assert sig[:4] == (_build._P,) * 4 and sig[6] == _build._P


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-10)])
def test_cuda_kernel_matches_plain(dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    cases = [_inputs(k, n, np_dtype) for k, n in
             [(8, 7984), (16, 300), (64, 100), (128, 130)]]
    cases.append(_dead_pivot_inputs(np_dtype))
    for LHS, RHS, passive in cases:
        L, R, P = (t.cuda() for t in _t(LHS, RHS, passive))
        before = masked_gj.launches
        X = masked_gj_solve(L, R, P)
        assert masked_gj.launches == before + 1
        torch.testing.assert_close(X, masked_gj_solve_reference(L, R, P),
                                   rtol=tol, atol=tol)


def _compact_case(case, dtype):
    if case == "dead_pivot":
        return _dead_pivot_inputs(dtype)
    k, n = {"random_k16": (16, 60), "random_k24": (24, 40),
            "random_k48": (48, 20), "k1": (1, 9), "edges_k12": (12, 8)}[case]
    LHS, RHS, passive = _inputs(k, n, dtype, seed=100 + k)
    if case == "edges_k12":
        passive[:, 0] = True    # an all-passive column
        passive[:, 1] = False   # a none-passive column
        passive[:, 2] = False
        passive[5, 2] = True    # a single passive row
    if case == "k1":
        passive[0, :] = np.arange(n) % 2 == 0
    return LHS, RHS, passive


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["random_k16", "random_k24", "random_k48",
                                  "k1", "edges_k12", "dead_pivot"])
def test_compact_reference_equals_plain(case, dtype):
    """The per-column Gauss-Jordan on the gathered passive system is the
    full masked one, rounding for rounding: max|diff| == 0."""
    LHS, RHS, passive = _t(*_compact_case(case, dtype))
    Xc = masked_gj_solve_compact_reference(LHS, RHS, passive)
    Xr = masked_gj_solve_reference(LHS, RHS, passive)
    assert Xc.dtype == Xr.dtype and Xc.shape == Xr.shape
    assert bool(torch.isfinite(Xr).all())
    assert float((Xc - Xr).abs().max()) == 0.0
    assert bool((Xc[~passive] == 0).all())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_compact_reference_keeps_nonfinite_columns(dtype):
    """An Inf in rhs on a non-passive row poisons its column in the plain
    version (rhs * 0 = NaN); the compact solve must not drop it.  It is
    stricter than the plain version, a stated departure from the
    tolerance-0 equality: any non-finite value in a column's rhs makes the
    whole column NaN, also where the plain version keeps finite entries;
    only the set of non-finite columns is compared.  A NaN in
    LHS makes tiny NaN and every pivot dead, in both: zeros, left to the
    caller's gradient to report."""
    LHS, RHS, passive = _inputs(10, 12, dtype, seed=3)
    passive[4, 2] = False
    RHS[4, 2] = np.inf          # on a non-passive row
    passive[7, 5] = True
    RHS[7, 5] = np.nan          # on a passive row
    LHS, RHS, passive = _t(LHS, RHS, passive)
    Xc = masked_gj_solve_compact_reference(LHS, RHS, passive)
    Xr = masked_gj_solve_reference(LHS, RHS, passive)
    bad_plain = ~torch.isfinite(Xr).all(dim=0)
    bad_compact = ~torch.isfinite(Xc).all(dim=0)
    assert bad_plain.tolist() == [c in (2, 5) for c in range(12)]
    assert bool((bad_compact | ~bad_plain).all())   # wherever plain is
    assert bad_compact.tolist() == bad_plain.tolist()
    good = ~bad_plain
    assert float((Xc[:, good] - Xr[:, good]).abs().max()) == 0.0

    LHS = LHS.clone()
    LHS[3, 6] = float("nan")
    Xc = masked_gj_solve_compact_reference(LHS, RHS[:, good], passive[:, good])
    Xr = masked_gj_solve_reference(LHS, RHS[:, good], passive[:, good])
    assert torch.equal(Xc, Xr) and bool((Xr == 0).all())


def test_dispatch_constant_and_launchers():
    """One constant picks the device kernel by k; each device kernel has its
    own C entry point per dtype."""
    assert 1 < masked_gj.WIDE_MIN_K <= masked_gj.MAX_K
    sigs = _build.SIGNATURES["masked_gj"]
    for name in ("smallk_masked_gj_f32", "smallk_masked_gj_f64",
                 "smallk_masked_gj_wide_f32", "smallk_masked_gj_wide_f64"):
        assert sigs[name] == sigs["smallk_masked_gj_f32"]
    src = (_build.CSRC / "masked_gj.cu").read_text()
    for name in sigs:
        assert f" {name}(" in src
    # the elimination path multiplies and subtracts unfused
    assert "fma" not in src.split("namespace {")[1].lower()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_wide_kernel_equals_plain(dtype):
    """Both device kernels against the plain version with tolerance 0, and
    the wide one on non-finite right-hand sides."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    cases = [_inputs(k, n, np_dtype) for k, n in
             [(128, 130), (96, 300), (64, 500), (1, 40)]]
    cases.append(_dead_pivot_inputs(np_dtype))
    for LHS, RHS, passive in cases:
        L, R, P = (t.cuda() for t in _t(LHS, RHS, passive))
        Xr = masked_gj_solve_reference(L, R, P)
        for launcher in (masked_gj._launch_wide, masked_gj._launch_narrow):
            before = masked_gj.launches, masked_gj.columns
            X = launcher(L, R, P)
            assert (masked_gj.launches, masked_gj.columns) == (
                before[0] + 1, before[1] + R.shape[1])
            assert float((X - Xr).abs().max()) == 0.0
    LHS, RHS, passive = _inputs(64, 40, np_dtype)
    passive[4, 2] = False
    RHS[4, 2] = np.inf
    L, R, P = (t.cuda() for t in _t(LHS, RHS, passive))
    X = masked_gj._launch_wide(L, R, P)
    Xr = masked_gj_solve_reference(L, R, P)
    bad = ~torch.isfinite(Xr).all(dim=0)
    assert bad.tolist() == [c == 2 for c in range(40)]
    assert (~torch.isfinite(X).all(dim=0)).tolist() == bad.tolist()
    assert float((X[:, ~bad] - Xr[:, ~bad]).abs().max()) == 0.0
