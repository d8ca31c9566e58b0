"""Explicit device and precision setup.

The counterpart of `Precision.HIGHEST` in smallk_tpu/ops/dense.py: the
NNLS sign tests are meaningless under one-pass reduced-precision products
(TF32 keeps about three decimal digits), so every entry point of the port
switches TF32 off for both cuBLAS and cuDNN before it touches a tensor.
"""

from __future__ import annotations

import torch

_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
}
# A-storage dtypes (`NmfOptions.a_dtype`): the factor dtypes and e4m3, in
# which A is stored only; its products come out in the factor dtype
_STORAGE_DTYPES = {**_DTYPES, "float8_e4m3fn": torch.float8_e4m3fn}


def full_precision() -> None:
    """Full-f32 matmuls: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def setup(device) -> torch.device:
    """Validate `device` ("cpu", "cuda", "cuda:0", a torch.device) and set
    full precision.  A CUDA device without a card raises: the port never
    falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is "
                               "not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cpu or cuda)")
    full_precision()
    return dev


def torch_dtype(name) -> torch.dtype:
    """`NmfOptions` dtype string (or a torch dtype) -> torch dtype."""
    return _lookup(name, _DTYPES)


def storage_dtype(name) -> torch.dtype:
    """`NmfOptions.a_dtype` string (or a torch dtype) -> the torch dtype A
    is stored in: a factor dtype or float8_e4m3fn."""
    return _lookup(name, _STORAGE_DTYPES)


def _lookup(name, table) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    try:
        return table[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; expected one of "
                         f"{sorted(table)}") from None

