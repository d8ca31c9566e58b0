"""Reference inputs -> port tensors, operands and options.

The parity tests hand both packages the same numpy/scipy data; a
reference `jax.Array` is turned into numpy by the caller, and a reference
operand's arrays are read with `np.asarray` (this package never imports
jax or the JAX package).  The way back is `SolveResult.to_numpy()`.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from .common import options
from .common.device import setup, torch_dtype
from .ops.aop import DenseAOp, SparseAOp, as_aop
from .ops.ell import EllAOp
from .solvers import bpp, hals, mu, rank2

_PORT_OPERANDS = (DenseAOp, EllAOp, SparseAOp)

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
    A in `a_dtype` (default: `dtype`), the factors in `dtype`.  A reference
    sparse operand (EllAOp, SparseAOp) crosses over with its own layout and
    storage dtype (`operand_from_reference`)."""
    dev = setup(device)
    dt = torch_dtype(dtype)
    if hasattr(A, "mm_tn") and not isinstance(A, _PORT_OPERANDS):
        aop = operand_from_reference(A, device=dev)
    else:
        aop = as_aop(A, dtype=a_dtype or dt, device=dev)
    return aop, _tensor(W0, dt, dev), _tensor(H0, dt, dev)


def _host_tensor(x):
    """A reference array -> a CPU tensor of its dtype (bf16 by its bits:
    numpy has no bf16 of its own)."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.dtype.name not in ("float32", "float64", "int32"):
        raise ValueError(f"reference array of dtype {a.dtype.name}: the port "
                         "stores float32, float64 or bfloat16")
    return torch.from_numpy(np.array(a))


def _ell_family(inv, buckets, dev):
    """A reference bucket family (inv, [(idx, vals)]) -> the port's
    (inv, [(ids, idx, vals)]).  Bucket b holds the stacked positions
    [offset, offset + g_pad); its ids are the majors at those positions,
    its padding rows (no major) at the end."""
    inv = np.asarray(inv)
    sizes = [np.asarray(idx).shape[0] for idx, _ in buckets]
    major_at = np.full(sum(sizes), -1, dtype=np.int64)
    major_at[inv] = np.arange(inv.shape[0])
    out, off = [], 0
    for (idx, vals), g_pad in zip(buckets, sizes):
        ids = major_at[off:off + g_pad]
        ids = ids[ids >= 0].astype(np.int32)
        out.append((torch.from_numpy(ids).to(dev),
                    _host_tensor(idx).to(dev), _host_tensor(vals).to(dev)))
        off += g_pad
    return inv, out


def operand_from_reference(op, device="cuda"):
    """A reference EllAOp or SparseAOp -> the port's, on `device`, with the
    same layout (bucket by bucket for an EllAOp) and storage dtype.  Its
    arrays are read with np.asarray, so this module needs no jax."""
    dev = setup(device)
    if hasattr(op, "row_buckets"):  # EllAOp
        def family(inv, buckets, blocks):
            if blocks is None:
                return (*_ell_family(inv, buckets, dev), None)
            return None, None, [_ell_family(i, b, dev) for i, b in blocks]

        col_inv, cb, col_blocks = family(op.col_inv, op.col_buckets,
                                         op.col_blocks)
        row_inv, rb, row_blocks = family(op.row_inv, op.row_buckets,
                                         op.row_blocks)
        return EllAOp(op.shape, col_inv, cb, row_inv, rb,
                      row_blocks=row_blocks,
                      row_block_size=op.row_block_size,
                      col_blocks=col_blocks,
                      col_block_size=op.col_block_size)
    if hasattr(op, "c_rows"):  # SparseAOp
        return SparseAOp(op.shape, *(_host_tensor(getattr(op, name)).to(dev)
                                     for name in ("c_rows", "c_cols",
                                                  "c_vals", "r_rows",
                                                  "r_cols", "r_vals")))
    raise ValueError(f"not a reference sparse operand: {type(op).__name__} "
                     "(expected EllAOp or SparseAOp)")


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



def embeddings_from_reference(emb, device="cuda"):
    """A reference `NmfEmbeddings` -> the port's, on `device`: its term
    table W and doc table H' carried across as numpy in their own dtype
    (bf16 by its bits), so both packages serve the same factors."""
    from .engines.embeddings import NmfEmbeddings

    W = _host_tensor(emb.terms.table)
    Ht = _host_tensor(emb.docs.table)
    return NmfEmbeddings(W, Ht.T, device=device)
