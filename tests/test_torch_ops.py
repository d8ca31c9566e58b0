"""The port's dense ops, A-operand and device setup against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import smallk_tpu.ops.dense as jd
from smallk_tpu.ops.aop import DenseAOp as JDenseAOp
from smallk_tpu.ops.aop import as_aop as jas_aop
from smallk_torch.common import device as tdevice
from smallk_torch.interop import from_reference
from smallk_torch.ops import dense as td
from smallk_torch.ops.aop import DenseAOp, as_aop

torch.set_num_threads(1)


def _mats(seed=0):
    rng = np.random.RandomState(seed)
    W = rng.rand(30, 5) - 0.3
    H = rng.rand(5, 20) - 0.3
    return {
        "W": W, "H": H, "A": rng.rand(30, 20),
        "gW": rng.randn(30, 5), "gH": rng.randn(5, 20),
    }


OPS = {
    "gemm": lambda m, M: M.gemm(m["W"], m["H"]),
    "gemm_tn": lambda m, M: M.gemm_tn(m["W"], m["A"]),
    "gemm_nt": lambda m, M: M.gemm_nt(m["A"], m["H"]),
    "gram": lambda m, M: M.gram(m["W"]),
    "gram_t": lambda m, M: M.gram_t(m["H"]),
    "fro_norm": lambda m, M: M.fro_norm(m["A"]),
    "normalize_and_scale": lambda m, M: M.normalize_and_scale(m["W"],
                                                              m["H"]),
    "projected_gradient_norm": lambda m, M: M.projected_gradient_norm(
        m["gW"], m["gH"], m["W"], m["H"]),
    "projected_gradient_norm_single": lambda m, M:
        M.projected_gradient_norm_single(m["gH"], m["H"]),
    "zeroize_small": lambda m, M: M.zeroize_small(m["H"], 0.2),
    "relative_fnorm": lambda m, M: M.relative_fnorm(m["A"], m["W"],
                                                    m["H"]),
}


@pytest.mark.parametrize("op", sorted(OPS))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_dense_op_matches_reference(op, dtype):
    m = {k: v.astype(dtype) for k, v in _mats().items()}
    ref = OPS[op]({k: jnp.asarray(v) for k, v in m.items()}, jd)
    out = OPS[op]({k: torch.from_numpy(v) for k, v in m.items()}, td)
    refs = ref if isinstance(ref, tuple) else (ref,)
    outs = out if isinstance(out, tuple) else (out,)
    tol = 1e-12 if dtype == np.float64 else 1e-5
    for r, o in zip(refs, outs, strict=True):
        assert o.dtype == getattr(torch, np.dtype(dtype).name)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=tol,
                                   atol=tol)


def test_densify_sums_duplicates_exactly():
    rows = np.array([0, 2, 2, 5, 0, 2, 7])
    cols = np.array([1, 3, 3, 0, 1, 3, 4])
    vals = np.array([0.5, 1.25, 2.0, 3.0, 0.25, -0.5, 4.0])
    A = sp.coo_matrix((vals, (rows, cols)), shape=(8, 6))  # duplicates kept
    dense = as_aop(A, torch.float64, device="cpu").A
    expect = np.zeros((8, 6))
    np.add.at(expect, (rows, cols), vals)
    assert np.array_equal(dense.numpy(), expect)
    ref = jas_aop(A, dtype=jnp.float64).A
    assert np.array_equal(dense.numpy(), np.asarray(ref))


def test_bf16_operand_products_come_back_in_factor_dtype():
    """bf16 A storage with f32 factors: products in f32, as the reference's
    preferred_element_type contract gives them (bf16 products collapsed BPP
    to zero)."""
    m = _mats(1)
    A_bf = torch.from_numpy(m["A"].astype(np.float32)).to(torch.bfloat16)
    A_j = jnp.asarray(m["A"].astype(np.float32), jnp.bfloat16)
    W32, H32 = m["W"].astype(np.float32), m["H"].astype(np.float32)
    aop, ref = DenseAOp(A_bf), JDenseAOp(A_j)
    assert aop.dtype == torch.bfloat16 and aop.shape == (30, 20)
    for name, F in (("mm_tn", W32), ("mm_nt", H32)):
        out = getattr(aop, name)(torch.from_numpy(F))
        exp = getattr(ref, name)(jnp.asarray(F))
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), np.asarray(exp), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(aop.col_sums().float().numpy(),
                               np.asarray(ref.col_sums(), np.float32),
                               rtol=1e-2)


@pytest.mark.parametrize("kind", ["ndarray", "sparse"])
def test_as_aop_inputs(kind):
    A = _mats(2)["A"]
    src = {"ndarray": A, "sparse": sp.csc_matrix(A)}[kind]
    aop = as_aop(src, "float32", device="cpu")
    assert aop.dtype == torch.float32 and aop.A.device.type == "cpu"
    np.testing.assert_array_equal(aop.A.numpy(), A.astype(np.float32))
    assert as_aop(aop, device="cpu") is aop


def test_sparse_above_threshold_is_not_ported(monkeypatch):
    """What is still not ported above the densify threshold, hierclust on
    a sparse operand (ROADMAP slice 11), raises before any operand is
    built: a 50,000 x 20,000 f32 dense image (4 GB) exceeds 2 GiB."""
    from smallk_torch.common.options import ClustOptions
    from smallk_torch.common.rng import Random
    from smallk_torch.engines.flatclust import run_hier_nmf2
    from smallk_torch.engines.hierclust import clust_hier
    from smallk_torch.ops import aop as aop_mod

    def no_build(*args, **kw):
        raise AssertionError("a sparse operand was built")

    monkeypatch.setattr(aop_mod.EllAOp, "from_scipy", no_build)
    monkeypatch.setattr(aop_mod.SparseAOp, "from_scipy", no_build)
    A = sp.random(50_000, 20_000, density=1e-6, random_state=0, format="csc")
    opts = ClustOptions(num_clusters=3, verbose=False, flat=True)
    for call in (clust_hier, run_hier_nmf2):
        with pytest.raises(NotImplementedError, match="slice 11"):
            call(A, opts, Random(1), device="cpu")


def test_sparse_above_threshold_becomes_ell():
    """Above the densify threshold a sparse input becomes the bucketed-ELL
    operand (ROADMAP slice 10), whose products equal the dense ones in f64
    to 1e-12 (tests/test_torch_ell.py holds it to the reference)."""
    from smallk_torch.ops.ell import EllAOp

    A = sp.random(40, 30, density=0.1, random_state=0, format="csc")
    op = as_aop(A, torch.float64, device="cpu", densify_threshold_bytes=100)
    assert isinstance(op, EllAOp)
    W = np.random.RandomState(0).rand(40, 3)
    np.testing.assert_allclose(op.mm_tn(torch.from_numpy(W)).numpy(),
                               W.T @ A.toarray(), rtol=1e-12, atol=1e-12)


def test_from_reference_places_and_casts():
    m = _mats(3)
    aop, W, H = from_reference(m["A"], m["W"], m["H"], device="cpu",
                               dtype="float32", a_dtype="bfloat16")
    assert aop.dtype == torch.bfloat16
    assert W.dtype == H.dtype == torch.float32
    np.testing.assert_array_equal(W.numpy(), m["W"].astype(np.float32))


def test_setup_sets_full_precision():
    torch.backends.cuda.matmul.allow_tf32 = True
    assert tdevice.setup("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_setup_rejects_unknown_devices_and_dtypes():
    with pytest.raises(ValueError):
        tdevice.setup("meta")
    with pytest.raises(ValueError):
        tdevice.torch_dtype("float8")
    assert tdevice.torch_dtype("bfloat16") is torch.bfloat16
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tdevice.setup("cuda")
