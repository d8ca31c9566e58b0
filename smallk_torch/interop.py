"""Reference inputs -> port tensors and options.

The parity tests hand both packages the same numpy/scipy data; a
reference `jax.Array` is turned into numpy by the caller (this package
never imports jax or the JAX package).  The way back is
`SolveResult.to_numpy()`.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from .common import options
from .common.device import setup, torch_dtype
from .ops.aop import as_aop
from .solvers import bpp, hals, mu, rank2

# solver-state classes by name: the reference's and the port's share them
_STATES = {cls.__name__: cls for cls in (
    mu.MuState, hals.HalsState, rank2.Rank2State, bpp.BppState)}


def _tensor(x, dtype, device):
    """A copy of array `x` as a tensor (numpy views of jax arrays are
    read-only, so no shared memory)."""
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def from_reference(A, W0, H0, *, device="cuda", dtype="float32",
                   a_dtype=None):
    """(A, W0, H0) as the reference takes them -> (aop, W, H) on `device`:
    A in `a_dtype` (default: `dtype`), the factors in `dtype`."""
    dev = setup(device)
    dt = torch_dtype(dtype)
    aop = as_aop(A, dtype=a_dtype or dt, device=dev)
    return aop, _tensor(W0, dt, dev), _tensor(H0, dt, dev)


def options_from_reference(opts):
    """A reference `NmfOptions` or `ClustOptions` -> the port's class of the
    same name, field by field.

    The two packages' enums are distinct classes (a reference
    `NmfAlgorithm.RANK2` compares unequal to the port's), so enum fields
    map by `.name`, and `ClustOptions.nmf_opts` maps recursively.  Options
    of the port come back unchanged.
    """
    name = type(opts).__name__
    if name not in ("NmfOptions", "ClustOptions"):
        raise ValueError(f"not an options object: {name} (expected "
                         "NmfOptions or ClustOptions)")
    cls = getattr(options, name)
    if isinstance(opts, cls):
        return opts

    def value(v):
        if isinstance(v, enum.Enum):
            return getattr(options, type(v).__name__)[v.name]
        if dataclasses.is_dataclass(v):
            return options_from_reference(v)
        return v

    return cls(**{f.name: value(getattr(opts, f.name))
                  for f in dataclasses.fields(cls)})


def state_from_reference(state, device="cuda", dtype="float32"):
    """A reference solver state (MuState, HalsState, Rank2State or
    BppState, a NamedTuple whose arrays the caller turned into numpy) ->
    the port's state of the same name, its arrays on `device` in `dtype`.
    Integer fields (BPP's pivot count) stay Python ints."""
    try:
        cls = _STATES[type(state).__name__]
    except KeyError:
        raise ValueError(f"not a solver state: {type(state).__name__} "
                         f"(expected one of {sorted(_STATES)})") from None
    dev = setup(device)
    dt = torch_dtype(dtype)

    def field(v):
        a = np.asarray(v)
        if a.ndim == 0 and np.issubdtype(a.dtype, np.integer):
            return int(a)
        return _tensor(a, dt, dev)

    return cls(*(field(getattr(state, name)) for name in cls._fields))

