"""Rank-2 NMF solver (Kuang-Park), the hierclust workhorse — port of
smallk_tpu/solvers/rank2.py.

  - `_system_solve_h` / `_system_solve_w`: closed-form 2x2 solves by a fast
    Givens rotation with the reference's singularity checks, the cosine
    and sine forms both computed and one selected;
  - `_optimal_active_set_h` / `_optimal_active_set_w`: per-column/row
    optimal fix-up of nonpositive entries;
  - `step`: normalizes every iteration and rescales HH'/AH' by the norms
    instead of recomputing them.

The reference's transposed-W variants (`*_t`, `TRANSPOSE_RANK2`) work
around TPU lane padding of (m, 2) arrays and are not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.dense import gemm, gram, gram_t, normalize_and_scale


class Rank2State(NamedTuple):
    WtW: torch.Tensor  # 2 x 2
    WtA: torch.Tensor  # 2 x n


def init(a_op, W, H) -> Rank2State:
    return Rank2State(WtW=a_op.sum_terms(gram(W)), WtA=a_op.mm_tn(W))


def _givens_solve(a00, a01, a10, a11, cos_form, sin_form, eps):
    """The shared tail of both 2x2 solves: select the cosine or sine form,
    test for singularity, back-substitute.  Returns (x0, x1, ok)."""
    use_cos = torch.abs(a00) >= torch.abs(a01)
    a2, b2, d2, e2, f2 = (torch.where(use_cos, c, s)
                          for c, s in zip(cos_form, sin_form, strict=True))
    singular = (torch.abs(a00) < eps) & (torch.abs(a01) < eps)
    degenerate = torch.abs(d2 / a2) < eps
    ok = ~(singular | degenerate)
    x1 = f2 / d2
    x0 = (e2 - b2 * x1) / a2
    return x0, x1, ok


def _system_solve_h(A, B):
    """Solve A @ X = B columnwise, A 2x2, B 2xn.  Returns (X, ok), with the
    reference SystemSolveH's singularity checks."""
    eps = torch.finfo(B.dtype).eps
    a00, a01 = A[0, 0], A[0, 1]
    a10, a11 = A[1, 0], A[1, 1]

    # cosine form (t = tangent)
    t = -a10 / torch.where(a00 == 0, eps, a00)
    cos_form = (a00 - t * a10, a01 - t * a11, a11 + t * a01,
                B[0, :] - t * B[1, :], B[1, :] + t * B[0, :])
    # sine form (ct = cotangent)
    ct = -a00 / torch.where(a10 == 0, eps, a10)
    sin_form = (-a10 + ct * a00, -a11 + ct * a01, a01 + ct * a11,
                -B[1, :] + ct * B[0, :], B[0, :] + ct * B[1, :])

    x0, x1, ok = _givens_solve(a00, a01, a10, a11, cos_form, sin_form, eps)
    return torch.stack([x0, x1], dim=0), ok


def _system_solve_w(A, B):
    """Solve X @ A = B rowwise, A 2x2, B mx2.  Returns (X, ok)."""
    eps = torch.finfo(B.dtype).eps
    a00, a01 = A[0, 0], A[0, 1]
    a10, a11 = A[1, 0], A[1, 1]

    t = a01 / torch.where(a00 == 0, eps, a00)
    cos_form = (a00 + t * a01, a10 + t * a11, a11 - t * a10,
                B[:, 0] + t * B[:, 1], B[:, 1] - t * B[:, 0])
    ct = a00 / torch.where(a01 == 0, eps, a01)
    sin_form = (-a01 - ct * a00, -a11 - ct * a10, a10 - ct * a11,
                -B[:, 1] - ct * B[:, 0], B[:, 0] - ct * B[:, 1])

    x0, x1, ok = _givens_solve(a00, a01, a10, a11, cos_form, sin_form, eps)
    return torch.stack([x0, x1], dim=1), ok


def _fixup(x0, x1, r0, r1, g00, g11):
    """Where x0 or x1 is <= 0, keep the single component with the larger
    scaled value and zero the other."""
    v1 = r0 / g00
    v2 = r1 / g11
    pick1 = v1 * torch.sqrt(g00) >= v2 * torch.sqrt(g11)
    v1 = torch.where(pick1, v1, 0.0)
    v2 = torch.where(pick1, 0.0, v2)
    needs_fix = (x0 <= 0) | (x1 <= 0)
    return torch.where(needs_fix, v1, x0), torch.where(needs_fix, v2, x1)


def _optimal_active_set_h(H, WtW, WtA):
    """Columnwise optimal fix-up of nonpositive H entries."""
    h0, h1 = _fixup(H[0, :], H[1, :], WtA[0, :], WtA[1, :],
                    WtW[0, 0], WtW[1, 1])
    return torch.stack([h0, h1], dim=0)


def _optimal_active_set_w(W, HHt, AHt):
    """Rowwise optimal fix-up of nonpositive W entries."""
    w0, w1 = _fixup(W[:, 0], W[:, 1], AHt[:, 0], AHt[:, 1],
                    HHt[0, 0], HHt[1, 1])
    return torch.stack([w0, w1], dim=1)


def step(a_op, W, H, state: Rank2State):
    WtW, WtA = state

    # solve W'W H = W'A, then optimal active-set fix-up
    H, ok_h = _system_solve_h(WtW, WtA)
    H = _optimal_active_set_h(H, WtW, WtA)

    HHt = a_op.sum_docs(gram_t(H))
    AHt = a_op.mm_nt(H)

    # solve W (HH') = AH'
    W, ok_w = _system_solve_w(HHt, AHt)
    W = _optimal_active_set_w(W, HHt, AHt)

    # per-iteration normalization; rescale HH'/AH' by the factors instead of
    # recomputing them
    W, H, norms = normalize_and_scale(W, H, a_op)
    norms_ok = torch.all(norms > torch.finfo(W.dtype).eps)
    HHt = HHt * torch.outer(norms, norms)
    AHt = AHt * norms[None, :]

    gradW = gemm(W, HHt) - AHt

    WtW = a_op.sum_terms(gram(W))
    WtA = a_op.mm_tn(W)
    gradH = gemm(WtW, H) - WtA

    ok = ok_h & ok_w & norms_ok
    # isfinite, not just not-NaN: f32 overflow yields Inf without NaN
    ok = ok & torch.all(torch.isfinite(gradW)) & torch.all(torch.isfinite(gradH))
    return W, H, gradW, gradH, Rank2State(WtW=WtW, WtA=WtA), ok


# Subspace-iteration count for the spectral initializer
SPECTRAL_POWER_ITERS = 6


def spectral_init_rank2(a_op, v0, power_iters: int = SPECTRAL_POWER_ITERS):
    """Spectral rank-2 initializer from the top-2 singular pair.

    A few subspace-iteration steps start the rank-2 solver near its
    optimum; the nonnegative projection keeps both sign-sides of the
    second singular direction, w_+- = relu(s1 u1 +- s2 u2), the two
    cluster-centroid estimates of the natural bipartition.

    v0: (2, n) start block (zero columns of a masked operand must be zero
    here and stay zero throughout).
    Returns (W0 (m, 2), H0 (2, n)), both nonnegative; on a sharded operand
    the rank's rows of W0 and columns of H0, from v0's columns.
    """
    eps = torch.finfo(v0.dtype).eps

    def norm(u):
        if not a_op.sharded:
            return torch.linalg.norm(u)
        return torch.sqrt(a_op.sum_terms(torch.sum(torch.square(u))))

    def orth2(U):
        u0 = U[:, 0]
        u0 = u0 / torch.clamp(norm(u0), min=eps)
        u1 = U[:, 1] - a_op.sum_terms(torch.dot(u0, U[:, 1])) * u0
        u1 = u1 / torch.clamp(norm(u1), min=eps)
        return torch.stack([u0, u1], dim=1)

    V = v0
    for _ in range(power_iters):
        U = orth2(a_op.mm_nt(V))   # (m, 2) = A V^T, orthonormalized
        V = a_op.mm_tn(U)          # (2, n) = U^T A
    U = orth2(a_op.mm_nt(V))
    V = a_op.mm_tn(U)

    # rotate to singular pairs: eigh of the 2x2 Gram of V's rows
    evals, E = torch.linalg.eigh(a_op.sum_docs(gram_t(V)))  # ascending
    s = torch.sqrt(torch.clamp(evals.flip(0), min=0.0))  # descending
    E = E.flip(1)
    Vr = gemm(E.T, V)       # rows: s_i * v_i^T
    Ur = gemm(U, E)         # cols: u_i

    u1 = torch.abs(Ur[:, 0])   # Perron: the leading pair is sign-fixable
    v1 = torch.abs(Vr[0]) / torch.clamp(s[0], min=eps)
    u2 = Ur[:, 1]
    v2 = Vr[1] / torch.clamp(s[1], min=eps)

    w_a = torch.clamp(s[0] * u1 + s[1] * u2, min=0.0)
    w_b = torch.clamp(s[0] * u1 - s[1] * u2, min=0.0)
    h_a = torch.clamp(v1 + v2, min=0.0)
    h_b = torch.clamp(v1 - v2, min=0.0)
    return torch.stack([w_a, w_b], dim=1), torch.stack([h_a, h_b], dim=0)
