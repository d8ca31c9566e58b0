"""Dense matrix helper ops — port of smallk_tpu/ops/dense.py.

Plain products on torch.matmul.  Each product accumulates in f32 (f64 for
f64 input, `_pet`) and casts back to the first operand's dtype, as the
reference's `preferred_element_type` + `.astype` does.  Full f32 (no TF32)
is set by `common.device.setup`.
"""

from __future__ import annotations

import torch


def _pet(x: torch.Tensor) -> torch.dtype:
    """Accumulation dtype: f32 at least, f64 for f64 input."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _mm(X, Y, like):
    pet = _pet(like)
    return torch.matmul(X.to(pet), Y.to(pet)).to(like.dtype)


def gemm_tn(X, Y):
    """X^T @ Y."""
    return _mm(X.T, Y, X)


def gemm_nt(X, Y):
    """X @ Y^T."""
    return _mm(X, Y.T, X)


def gemm(X, Y):
    return _mm(X, Y, X)


def gram(X):
    """X^T X (k x k when X is m x k)."""
    return gemm_tn(X, X)


def gram_t(X):
    """X X^T (k x k when X is k x n)."""
    return gemm_nt(X, X)


def fro_norm(X):
    return torch.sqrt(torch.sum(torch.square(X)))


def normalize_and_scale(W, H):
    """Unit-L2 columns of W, rows of H scaled to compensate.

    Returns (W, H, norms); a column norm below eps is guarded in the
    division (the caller inspects `norms`), as in the reference.
    """
    norms = torch.sqrt(torch.sum(torch.square(W), dim=0))  # (k,)
    eps = torch.finfo(W.dtype).eps
    safe = torch.clamp(norms, min=eps)
    return W / safe[None, :], H * norms[:, None], norms


def projected_gradient_norm(gradW, gradH, W, H):
    """Norm of the projected gradient over (W, H): an element counts when
    its gradient is negative or its factor entry is positive."""
    mw = (gradW < 0) | (W > 0)
    mh = (gradH < 0) | (H > 0)
    sw = torch.sum(torch.where(mw, torch.square(gradW), 0))
    sh = torch.sum(torch.where(mh, torch.square(gradH), 0))
    return torch.sqrt(sw + sh)


def projected_gradient_norm_single(gradM, M):
    m = (gradM < 0) | (M > 0)
    return torch.sqrt(torch.sum(torch.where(m, torch.square(gradM), 0)))


def zeroize_small(X, threshold=1.0e-12):
    """Set |x| < threshold to zero."""
    return torch.where(torch.abs(X) < threshold, torch.zeros_like(X), X)


def relative_fnorm(A_dense, W, H):
    """||A - WH||_F / ||A||_F."""
    diff = A_dense - gemm(W, H)
    return fro_norm(diff) / fro_norm(A_dense)
