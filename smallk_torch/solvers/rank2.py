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

Lanes.  The step also takes R independent solves at once, the JAX
package's `jax.vmap(_nmf_solve_impl)` over best-of-R restarts
(smallk_tpu/engines/hierclust.py:238-241): W (R, m, 2), H (R, 2, n) and
the state's Grams and products with the same leading lane axis.  The 2x2
solves, the fix-ups and the normalization run per lane (every index is
taken from the end), `ok` is one flag a lane, and each side's A-product
is one product of the 2R stacked factor rows (`mm_tn_lanes`,
`mm_nt_lanes` of the operand), so A is read once a side whatever R is.
Without the lane axis every op is the one the unbatched step ran before
lanes existed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.dense import gemm, gram, gram_t, normalize_and_scale


class Rank2State(NamedTuple):
    WtW: torch.Tensor  # 2 x 2 (R x 2 x 2 with lanes)
    WtA: torch.Tensor  # 2 x n (R x 2 x n)


def _wta(a_op, W):
    """W^T A, a lane's own where W has a lane axis."""
    return a_op.mm_tn_lanes(W) if W.ndim == 3 else a_op.mm_tn(W)


def _aht(a_op, H):
    """A H^T, a lane's own where H has a lane axis."""
    return a_op.mm_nt_lanes(H) if H.ndim == 3 else a_op.mm_nt(H)


def init(a_op, W, H) -> Rank2State:
    return Rank2State(WtW=a_op.sum_terms(gram(W)), WtA=_wta(a_op, W))


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
    return x0, x1, ok[..., 0]


def _entries(A):
    """A 2x2 matrix's entries (a lane's own under a lane axis), each with a
    trailing axis of one that broadcasts over a row or column of B."""
    return A[..., 0, 0, None], A[..., 0, 1, None], A[..., 1, 0, None], \
        A[..., 1, 1, None]


def _system_solve_h(A, B):
    """Solve A @ X = B columnwise, A 2x2, B 2xn (a lane axis first: one
    system a lane).  Returns (X, ok), with the reference SystemSolveH's
    singularity checks."""
    eps = torch.finfo(B.dtype).eps
    a00, a01, a10, a11 = _entries(A)
    b0, b1 = B[..., 0, :], B[..., 1, :]

    # cosine form (t = tangent)
    t = -a10 / torch.where(a00 == 0, eps, a00)
    cos_form = (a00 - t * a10, a01 - t * a11, a11 + t * a01,
                b0 - t * b1, b1 + t * b0)
    # sine form (ct = cotangent)
    ct = -a00 / torch.where(a10 == 0, eps, a10)
    sin_form = (-a10 + ct * a00, -a11 + ct * a01, a01 + ct * a11,
                -b1 + ct * b0, b0 + ct * b1)

    x0, x1, ok = _givens_solve(a00, a01, a10, a11, cos_form, sin_form, eps)
    return torch.stack([x0, x1], dim=-2), ok


def _system_solve_w(A, B):
    """Solve X @ A = B rowwise, A 2x2, B mx2 (a lane axis first).  Returns
    (X, ok)."""
    eps = torch.finfo(B.dtype).eps
    a00, a01, a10, a11 = _entries(A)
    b0, b1 = B[..., :, 0], B[..., :, 1]

    t = a01 / torch.where(a00 == 0, eps, a00)
    cos_form = (a00 + t * a01, a10 + t * a11, a11 - t * a10,
                b0 + t * b1, b1 - t * b0)
    ct = a00 / torch.where(a01 == 0, eps, a01)
    sin_form = (-a01 - ct * a00, -a11 - ct * a10, a10 - ct * a11,
                -b1 - ct * b0, b0 - ct * b1)

    x0, x1, ok = _givens_solve(a00, a01, a10, a11, cos_form, sin_form, eps)
    return torch.stack([x0, x1], dim=-1), ok


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
    h0, h1 = _fixup(H[..., 0, :], H[..., 1, :], WtA[..., 0, :],
                    WtA[..., 1, :], WtW[..., 0, 0, None], WtW[..., 1, 1, None])
    return torch.stack([h0, h1], dim=-2)


def _optimal_active_set_w(W, HHt, AHt):
    """Rowwise optimal fix-up of nonpositive W entries."""
    w0, w1 = _fixup(W[..., :, 0], W[..., :, 1], AHt[..., :, 0],
                    AHt[..., :, 1], HHt[..., 0, 0, None], HHt[..., 1, 1, None])
    return torch.stack([w0, w1], dim=-1)


def _all_finite(X):
    """Whether every entry of X (of each lane's X) is finite."""
    return torch.all(torch.isfinite(X).flatten(-2), dim=-1)


def step(a_op, W, H, state: Rank2State):
    WtW, WtA = state

    # solve W'W H = W'A, then optimal active-set fix-up
    H, ok_h = _system_solve_h(WtW, WtA)
    H = _optimal_active_set_h(H, WtW, WtA)

    HHt = a_op.sum_docs(gram_t(H))
    AHt = _aht(a_op, H)

    # solve W (HH') = AH'
    W, ok_w = _system_solve_w(HHt, AHt)
    W = _optimal_active_set_w(W, HHt, AHt)

    # per-iteration normalization; rescale HH'/AH' by the factors instead of
    # recomputing them
    W, H, norms = normalize_and_scale(W, H, a_op)
    norms_ok = torch.all(norms > torch.finfo(W.dtype).eps, dim=-1)
    HHt = HHt * (norms[..., :, None] * norms[..., None, :])
    AHt = AHt * norms[..., None, :]

    gradW = gemm(W, HHt) - AHt

    WtW = a_op.sum_terms(gram(W))
    WtA = _wta(a_op, W)
    gradH = gemm(WtW, H) - WtA

    ok = ok_h & ok_w & norms_ok
    # isfinite, not just not-NaN: f32 overflow yields Inf without NaN; a
    # lane's own entries only
    ok = ok & _all_finite(gradW) & _all_finite(gradH)
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
