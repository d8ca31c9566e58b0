"""Multiplicative-update (Lee-Seung) NMF solver — port of smallk_tpu/solvers/mu.py.

    H = H .* (W'A) ./ (W'W H + eps)
    W = W .* (AH') ./ (W HH' + eps)      eps = 1e-13
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.dense import gemm, gram, gram_t

EPSILON = 1.0e-13


class MuState(NamedTuple):
    WtW: torch.Tensor  # k x k
    WtA: torch.Tensor  # k x n


def init(a_op, W, H) -> MuState:
    return MuState(WtW=gram(W), WtA=a_op.mm_tn(W))


def step(a_op, W, H, state: MuState):
    WtW, WtA = state

    # H update
    WtWH = gemm(WtW, H)
    H = H * (WtA / (WtWH + EPSILON))

    # W update
    HHt = gram_t(H)
    AHt = a_op.mm_nt(H)
    WHHt = gemm(W, HHt)
    W = W * (AHt / (WHHt + EPSILON))

    # gradients with updated factors
    WtA = a_op.mm_tn(W)
    WtW = gram(W)
    gradW = gemm(W, HHt) - AHt
    gradH = gemm(WtW, H) - WtA

    # isfinite, not just not-NaN: f32 overflow yields Inf without NaN
    ok = torch.all(torch.isfinite(gradW)) & torch.all(torch.isfinite(gradH))
    return W, H, gradW, gradH, MuState(WtW=WtW, WtA=WtA), ok
