"""Dense matrix helper ops — port of smallk_tpu/ops/dense.py.

Plain products on torch.matmul.  Each product accumulates in f32 (f64 for
f64 input, `_pet`) and casts back to the first operand's dtype, as the
reference's `preferred_element_type` + `.astype` does.  Full f32 (no TF32)
is set by `common.device.setup`.

`Unsharded` gives every operand kind the reductions a sharded solve needs
(parallel/mesh.py): a sum or max of a per-block partial over the terms
axis (W's rows, A's rows) or the docs axis (H's columns, A's columns), and
the agreement of a flag over all ranks.  On an operand that is not
sharded each is the identity on its argument, so an unsharded solve runs
exactly the ops it ran before the sharded solve existed.  A helper that
sums over a factor's sharded axis takes the operand (`a_op`, W's rows over
terms, H's columns over docs) or, where the axis depends on the caller,
the reduction itself (`total`).

A factor may carry a leading lane axis (R independent rank-2 solves, the
JAX package's vmap over restarts): every helper here takes its matrix
axes from the end and returns one value a lane, so on a factor without
lanes it runs the ops it ran before lanes existed.  `Unsharded` gives an
operand the lanes' products (`mm_tn_lanes`, `mm_nt_lanes`): one product
of the lanes' stacked factor rows, so A is read once whatever R is.
"""

from __future__ import annotations

import torch


def _pet(x: torch.Tensor) -> torch.dtype:
    """Accumulation dtype: f32 at least, f64 for f64 input."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _mm(X, Y, like):
    if X.ndim == Y.ndim == 3 and X.shape[0] == Y.shape[0] == 1:
        # one lane: its product is the unbatched one (a batched product
        # of one sums in another order on the CPU)
        return _mm(X[0], Y[0], like)[None]
    pet = _pet(like)
    return torch.matmul(X.to(pet), Y.to(pet)).to(like.dtype)


class Unsharded:
    """The reductions of an operand that is not sharded: identities.
    `ops.aop.ShardedAOp` has the same methods as collectives."""

    sharded = False

    @staticmethod
    def sum_terms(x):
        return x

    @staticmethod
    def sum_docs(x):
        return x

    @staticmethod
    def max_terms(x):
        return x

    @staticmethod
    def max_docs(x):
        return x

    @staticmethod
    def all_terms(flags):
        """Whether every entry of the bool tensor holds, on all ranks of
        the terms axis (a 0-d bool tensor)."""
        return torch.all(flags)

    @staticmethod
    def all_ranks(ok):
        """A 0-d bool tensor that holds only where it holds on every rank."""
        return ok

    def mm_tn_lanes(self, W):
        """W (R, m, k) -> W_r^T A for every lane r, (R, k, n): one product
        of the R k stacked columns (lane r's at r k .. r k + k - 1)."""
        R, m, k = W.shape
        return self.mm_tn(W.transpose(0, 1).reshape(m, R * k)).reshape(
            R, k, -1)

    def mm_nt_lanes(self, H):
        """H (R, k, n) -> A H_r^T for every lane r, (R, m, k): one product
        of the R k stacked rows."""
        R, k, n = H.shape
        return self.mm_nt(H.reshape(R * k, n)).reshape(-1, R, k).transpose(
            0, 1)


UNSHARDED = Unsharded()


def _same(x):
    return x


def gemm_tn(X, Y):
    """X^T @ Y."""
    return _mm(X.mT, Y, X)


def gemm_nt(X, Y):
    """X @ Y^T."""
    return _mm(X, Y.mT, X)


def gemm(X, Y):
    return _mm(X, Y, X)


def gram(X):
    """X^T X (k x k when X is m x k)."""
    return gemm_tn(X, X)


def gram_t(X):
    """X X^T (k x k when X is k x n)."""
    return gemm_nt(X, X)


def fro_norm(X, total=_same):
    """The Frobenius norm (a lane's own); `total` sums the block's square
    sum over the ranks that hold X's other blocks."""
    return torch.sqrt(total(torch.sum(torch.square(X), dim=(-2, -1))))


def normalize_and_scale(W, H, a_op=UNSHARDED):
    """Unit-L2 columns of W, rows of H scaled to compensate.

    Returns (W, H, norms); a column norm below eps is guarded in the
    division (the caller inspects `norms`), as in the reference.
    """
    norms = torch.sqrt(a_op.sum_terms(torch.sum(torch.square(W), dim=-2)))
    eps = torch.finfo(W.dtype).eps
    safe = torch.clamp(norms, min=eps)
    return W / safe[..., None, :], H * norms[..., :, None], norms


def projected_gradient_norm(gradW, gradH, W, H, a_op=UNSHARDED):
    """Norm of the projected gradient over (W, H) (a lane's own): an
    element counts when its gradient is negative or its factor entry is
    positive."""
    mw = (gradW < 0) | (W > 0)
    mh = (gradH < 0) | (H > 0)
    sw = a_op.sum_terms(torch.sum(torch.where(mw, torch.square(gradW), 0),
                                  dim=(-2, -1)))
    sh = a_op.sum_docs(torch.sum(torch.where(mh, torch.square(gradH), 0),
                                 dim=(-2, -1)))
    return torch.sqrt(sw + sh)


def projected_gradient_norm_single(gradM, M, total=_same):
    m = (gradM < 0) | (M > 0)
    return torch.sqrt(total(torch.sum(torch.where(m, torch.square(gradM),
                                                  0))))


def zeroize_small(X, threshold=1.0e-12):
    """Set |x| < threshold to zero."""
    return torch.where(torch.abs(X) < threshold, torch.zeros_like(X), X)


def relative_fnorm(A_dense, W, H):
    """||A - WH||_F / ||A||_F."""
    diff = A_dense - gemm(W, H)
    return fro_norm(diff) / fro_norm(A_dense)
