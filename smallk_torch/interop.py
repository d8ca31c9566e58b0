"""Reference inputs -> port tensors.

The parity tests hand both packages the same numpy/scipy data; a
reference `jax.Array` is turned into numpy by the caller (this package
never imports jax).  The way back is `SolveResult.to_numpy()`.
"""

from __future__ import annotations

import numpy as np
import torch

from .common.device import setup, torch_dtype
from .ops.aop import as_aop


def from_reference(A, W0, H0, *, device, dtype="float32", a_dtype=None):
    """(A, W0, H0) as the reference takes them -> (aop, W, H) on `device`:
    A in `a_dtype` (default: `dtype`), the factors in `dtype`."""
    dev = setup(device)
    dt = torch_dtype(dtype)
    aop = as_aop(A, dtype=a_dtype or dt, device=dev)

    def factor(X):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(X))).to(
            dt).to(dev)

    return aop, factor(W0), factor(H0)
