"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each library is compiled once from `smallk_torch/csrc/` into
`build/smallk_torch/` at the repository root, under a name keyed by a hash
of its sources and flags, so a fresh checkout builds at first CUDA use and
later processes load the cached file.  The sources have a plain C
interface (no PyTorch headers), which keeps a build to seconds.

Nothing here runs at import time, and a failed build raises with nvcc's
own error output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "smallk_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # each kernel's registers, shared memory and spills, kept in the
    # build's log (`build_log`)
    "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry points of each library: name -> (argtypes, restype)
SIGNATURES = {
    "masked_gj": {
        "smallk_masked_gj_f32": ((_P, _P, _P, _P, _I, _I, _P, _I), _I),
        "smallk_masked_gj_f64": ((_P, _P, _P, _P, _I, _I, _P, _I), _I),
        "smallk_masked_gj_wide_f32": ((_P, _P, _P, _P, _I, _I, _P, _I), _I),
        "smallk_masked_gj_wide_f64": ((_P, _P, _P, _P, _I, _I, _P, _I), _I),
        "smallk_cuda_error_string": ((_I,), ctypes.c_char_p),
    },
    "hals_step": {
        "smallk_hals_step_f32": ((_P,) * 12 + (_I, _I, _I, _P, _I), _I),
        "smallk_hals_step_bf16": ((_P,) * 12 + (_I, _I, _I, _P, _I), _I),
        "smallk_hals_step_f8": ((_P,) * 12 + (_I, _I, _I, _P, _I), _I),
        "smallk_hals_max_active_clusters": ((_I,) * 4, _I),
        "smallk_cluster_probe": ((_P, _I, _P, _I), _I),
        "smallk_hals_stamps": ((_P, _I, _I), _I),
        "smallk_hals_cuda_error_string": ((_I,), ctypes.c_char_p),
    },
    "rank2_loop": {
        # A, Wt, out, partial, m, w, k, slabs, rows a slab, vec, stream,
        # device
        **{f"smallk_wt_a_{t}": ((_P,) * 4 + (_I,) * 6 + (_P, _I), _I)
           for t in ("f32", "bf16", "f8")},
        # A, H, out, m, w, k, splits, cols a split, vec, stream, device
        **{f"smallk_h_at_{t}": ((_P,) * 3 + (_I,) * 6 + (_P, _I), _I)
           for t in ("f32", "bf16", "f8")},
        # A, Wt, H, Wn, wt_a's partial, maxbits, m, w, iters, slabs, rows a
        # slab, splits, cols a split, vec, stream, device
        **{f"smallk_rank2_loop_{t}": ((_P,) * 6 + (_I,) * 8 + (_P, _I), _I)
           for t in ("f32", "bf16")},
        "smallk_rank2_cuda_error_string": ((_I,), ctypes.c_char_p),
    },
    "ell_spmm": {
        # desc, n, table, out, B, k, n_out, accumulate, transposed,
        # stream, device, failed (an int written back)
        **{f"smallk_ell_spmm_{pair}": ((_P, _I, _P, _P) + (_I,) * 5
                                       + (_P, _I, _P), _I)
           for pair in ("f32_f32", "bf16_f32", "f8_f32", "f32_bf16",
                        "f64_f64")},
        "smallk_ell_cuda_error_string": ((_I,), ctypes.c_char_p),
    },
    "seg_spmm": {
        # starts, lens, rows, vals, shift, table, ld_row, ld_col, B, k,
        # pairs, out, out_row, out_col, n_slots, stream, device
        **{f"smallk_seg_chunks_{pair}": ((_P,) * 4 + (_I, _P, _L, _L)
                                         + (_I,) * 3 + (_P, _L, _L, _I, _P,
                                                        _I), _I)
           for pair in ("f32_f32", "bf16_f32", "f8_f32", "f64_f64")},
        # ptr, gather, val, table, ld_row, ld_col, B, k, pairs, out,
        # out_row, out_col, n_out, carries, carry_cap, cap, stream, device
        **{f"smallk_seg_terms_{pair}": ((_P,) * 4 + (_L, _L) + (_I,) * 3
                                        + (_P, _L, _L, _I, _P, _L, _L, _P,
                                           _I), _I)
           for pair in ("f32_f32", "bf16_f32", "f8_f32", "f64_f64")},
        "smallk_seg_max_grid": ((_I,), _I),
        "smallk_seg_cuda_error_string": ((_I,), ctypes.c_char_p),
    },
    "graph_if": {
        # from stream, pred, body stream, device, handle (written back)
        "smallk_while_begin": ((_P, _P, _P, _I,
                                ctypes.POINTER(ctypes.c_ulonglong)), _I),
        # body stream, pred, handle, device
        "smallk_while_end": ((_P, _P, ctypes.c_ulonglong, _I), _I),
        # stream, device, nodes (written back)
        "smallk_capture_nodes": ((_P, _I,
                                  ctypes.POINTER(ctypes.c_ulonglong)), _I),
        "smallk_stream_create": ((ctypes.POINTER(_P), _I), _I),
        "smallk_if_cuda_error_string": ((_I,), ctypes.c_char_p),
    },
}

_loaded: dict[tuple, ctypes.CDLL] = {}


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels of smallk_torch cannot be built")
    return found


def nvcc_command(nvcc: str, sources, out: Path, defines=()) -> list[str]:
    return [nvcc, *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", str(out),
            *(str(s) for s in sources)]


def library_path(name: str, defines=()) -> Path:
    """Where library `name` (built with the macros `defines`) lives once
    built: keyed by its sources' bytes and the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(defines)).encode())
    for src in sorted(CSRC.glob(f"{name}.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str, defines=()) -> Path:
    """Compile library `name` if its keyed file is missing; return the path.
    `defines` are macros for a study's build (the default build has none)."""
    out = library_path(name, defines)
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # compile to a private name and rename: a concurrent build never loads
    # a half-written file
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        cmd = nvcc_command(find_nvcc(), [CSRC / f"{name}.cu"], Path(tmp),
                           defines)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building {name} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stderr}{proc.stdout}")
        out.with_suffix(".log").write_text(proc.stderr + proc.stdout)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_log(name: str, defines=()) -> str:
    """nvcc's output for library `name` (ptxas's lines for each kernel),
    building it first if needed."""
    return build(name, defines).with_suffix(".log").read_text()


def load_library(name: str, defines=()) -> ctypes.CDLL:
    """Build (if needed) and load library `name` with its signatures set:
    pointers and the stream as c_void_p, so 64-bit values are not cut."""
    key = (name, tuple(defines))
    lib = _loaded.get(key)
    if lib is None:
        lib = ctypes.CDLL(str(build(name, defines)))
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = restype
        _loaded[key] = lib
    return lib
