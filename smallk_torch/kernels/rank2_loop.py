"""Rank-2 A-products and the rank-2 iteration loop: the CUDA kernel's
wrappers and their plain versions (K3).

Port of the TPU kernel scripts/tpu_batch60.py:kernel (P3), the probe of
the rank-2 solve's iteration floor: ITERS times over a resident (m, w)
slab A,

    H = Wt . A   (2, w);   Wn = H . A^T   (2, m);   Wt = Wn / (max|Wn| + 1)

Its two products are the two A-products of every rank-2 NMF step
(solvers/rank2.py: W^T A and A H^T at k = 2), so K3 exports them alone,
and `ops.aop.DenseAOp` sends every k = 2 product of an f32 factor on a
CUDA f32, bf16 or e4m3 A to them, and the lane-stacked products of a
best-of-R rank-2 solve (R lanes, k = 2R rows, R <= MAX_LANES), which read
A once whatever R is:

    wt_a(A, Wt) -> (k, w) f32       Wt (k, m) f32, k in ROWS
    h_at(A, H)  -> (k, m) f32       H (k, w) f32
    rank2_loop(A, Wt, iters) -> (2, m) f32, P3's whole function

On CUDA tensors each launches the hand-written Hopper kernel
(csrc/rank2_loop.cu) or raises; on CPU tensors it takes its plain torch
version (`wt_a_plain`, `h_at_plain`, `rank2_loop_plain`), and only there.
A is read in its own dtype (f32, bf16, or e4m3 for the products) and
every sum is in f32, as P3's preferred_element_type=jnp.float32; no f32
copy of A is made.

What bounds them: a product reads A once and does 2 k m w flops, k/2
flops a byte of A in f32, k in bf16 and 2k in e4m3, against the card's ~20
f32 flops per HBM byte; so every f32 and bf16 product, and e4m3 up to
k = 10, is bound by A's bytes, and e4m3 at k >= 12 by f32 FMA.  The design
(csrc/rank2_loop.cu's header) reads A once with 16-byte loads a lane and
stages the factor in shared memory, so that no row of A re-reads it from
memory.  Its launch plan is computed here from (m, w, k, dtype) alone; the
kernel takes only its run-time numbers (slabs and rows a slab, splits and
columns a split), computes its grid from its own widths (csrc Shape, which
the widths here copy for the plan), and refuses a plan that does not cover
A once or whose splits are not whole steps:

  - `wt_a_plan`: a block of 8 warps owns 32 C columns (C a lane: 16 bytes
    at most, and 16, 8 or 4 columns as k grows, so that a lane's k x C sums
    stay in registers) and a slab of the rows; the rows are cut into as
    many slabs as keep the blocks within `target_blocks`, no slab under
    MIN_ROWS rows; the slabs write partial sums into the plan's scratch,
    and a second launch adds them in slab order;
  - `h_at_plan`: a block owns 32 rows (8 warps x 4) and walks its columns
    in steps of 32 V (V a lane: 16 bytes, 8 above k = 8, no more than
    128 / k columns so that H's columns of a step fit in 16 KB of shared
    memory, and at least 4); where the row blocks leave room within
    `target_blocks`, the columns are split, a whole number of steps a split
    and at most MAX_SPLITS splits, which the kernel launches as one
    thread-block cluster that adds its sums in split order (no scratch);
  - `target_blocks`: one block for each BLOCK_BYTES of A, and no fewer
    than the card holds at once (two an SM; h_at at k = 2, built for 64
    registers a thread, four): a large A runs in several waves, a small one
    in one wave of blocks long enough to pay for their start;
  - no float atomics, so the same inputs give the same bits on every call;
  - `vector_path`: A takes the 16-byte loads where its pointer and its
    row's bytes are multiples of 16 (every hierclust node operand does: a
    bucket width, or an exact width gathered at whole 16-byte rows,
    `engines.hierclust.row_width`); any other A (a root whose rows are not
    16-byte aligned, a sliced view) takes the kernels' scalar path, with
    the same plan, which assembles the same words element by element: the
    same sums, bit for bit.

`launches` counts wrapper calls that launched the kernel (one or two
launches on the device), `lane_launches` those of more than 2 rows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build

SOURCE = "smallk_torch/csrc/rank2_loop.cu"
REPLACES = "scripts/tpu_batch60.py:27"
ITERS = 200               # P3's iteration count
SMS = 132                 # SMs of an H100 SXM
BLOCK_BYTES = 192 << 10   # bytes of A a product block aims at
MIN_ROWS = 128            # fewest rows a wt_a slab is cut to
MAX_SPLITS = 8            # h_at's column splits: a portable cluster
WARPS, LANES = 8, 32      # warps of a block (csrc kWarps), lanes of a warp
H_ROWS = WARPS * 4        # rows of an h_at block (csrc Shape::kHRows a warp)

# the factor rows the products take: 2R for R = 1..MAX_LANES lanes
MAX_LANES = 8
ROWS = tuple(range(2, 2 * MAX_LANES + 1, 2))

# wrapper calls that launched the kernel since the last reset, and of them
# the products of more than 2 rows (lanes); the only places they grow are
# the launches below
launches = 0
lane_launches = 0

# A's storage dtypes the products read (the loop: the first two)
A_DTYPES = (torch.float32, torch.bfloat16, torch.float8_e4m3fn)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16",
           torch.float8_e4m3fn: "f8"}


class WtAPlan(NamedTuple):
    """wt_a's launch: grid (column blocks, slabs), C columns a lane, the
    rows of a slab, and the partial sums' floats (0 with one slab)."""
    grid: tuple[int, int]
    lane_cols: int
    rows_per_slab: int
    scratch: int


class HAtPlan(NamedTuple):
    """h_at's launch: grid (row blocks, splits; a row block's splits are
    one cluster), the rows of a block, V columns a lane and the columns of
    a split (whole steps of 32 V)."""
    grid: tuple[int, int]
    block_rows: int
    lane_cols: int
    cols_per_split: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pow2_floor(x: int) -> int:
    return 1 << (x.bit_length() - 1)


def target_blocks(m: int, w: int, dtype, per_sm: int = 2) -> int:
    """Blocks a product of an (m, w) A of `dtype` aims at, where the card
    holds `per_sm` of its blocks an SM."""
    return max(per_sm * SMS, m * w * dtype.itemsize // BLOCK_BYTES)


def wt_a_plan(m: int, w: int, k: int, dtype) -> WtAPlan:
    """The launch of wt_a for an (m, w) A of `dtype` and k factor rows."""
    item = dtype.itemsize
    # csrc Shape::kWtCols
    cols = min(16 // item, 16 if k == 2 else 8 if k <= 8 and k * item <= 12
               else 4)
    col_blocks = _cdiv(w, LANES * cols)
    slabs = max(1, min(target_blocks(m, w, dtype) // col_blocks,
                       _cdiv(m, MIN_ROWS)))
    rows = _cdiv(m, slabs)
    slabs = _cdiv(m, rows)
    return WtAPlan((col_blocks, slabs), cols, rows,
                   slabs * k * w if slabs > 1 else 0)


def h_at_plan(m: int, w: int, k: int, dtype) -> HAtPlan:
    """The launch of h_at for an (m, w) A of `dtype` and k factor rows."""
    cols = max(4, min((16 if k <= 8 else 8) // dtype.itemsize,  # kHCols
                      _pow2_floor(128 // k)))
    step = LANES * cols
    row_blocks, steps = _cdiv(m, H_ROWS), _cdiv(w, step)
    per_sm = 4 if k == 2 else 2  # csrc Shape::kHBlocks
    splits = max(1, min(target_blocks(m, w, dtype, per_sm) // row_blocks,
                        steps, MAX_SPLITS))
    per = _cdiv(steps, splits)
    splits = _cdiv(steps, per)
    return HAtPlan((row_blocks, splits), H_ROWS, cols, per * step)


def vector_path(A) -> bool:
    """Whether A takes the kernels' 16-byte loads (else their scalar
    path): its pointer and its rows' bytes are multiples of 16."""
    return A.data_ptr() % 16 == 0 and A.shape[1] * A.element_size() % 16 == 0


def _partial(plan, out):
    """The buffer of wt_a's partial sums, or `out` (which the kernel then
    writes directly) where the plan has one slab."""
    return (torch.empty((plan.scratch,), dtype=torch.float32,
                        device=out.device) if plan.scratch else out)


def wt_a(A, Wt):
    """A (m, w), Wt (k, m) -> Wt . A (k, w) f32, k in ROWS."""
    m, w = _check(A, Wt, "wt_a", (_rows(Wt, "wt_a"), A.shape[0]), A_DTYPES)
    if Wt.device.type == "cpu":
        return wt_a_plain(A, Wt)
    dev, k = Wt.device, Wt.shape[0]
    plan = wt_a_plan(m, w, k, A.dtype)
    out = torch.empty((k, w), dtype=torch.float32, device=dev)
    partial = _partial(plan, out)
    lib = _build.load_library("rank2_loop")
    fn = getattr(lib, f"smallk_wt_a_{_SUFFIX[A.dtype]}")
    _raise_on(lib, fn(A.data_ptr(), Wt.data_ptr(), out.data_ptr(),
                      partial.data_ptr(), m, w, k, plan.grid[1],
                      plan.rows_per_slab, int(vector_path(A)),
                      torch.cuda.current_stream(dev).cuda_stream, dev.index),
              "wt_a", m, w)
    _count(k)
    return out


def h_at(A, H):
    """A (m, w), H (k, w) -> H . A^T (k, m) f32, k in ROWS."""
    m, w = _check(A, H, "h_at", (_rows(H, "h_at"), A.shape[1]), A_DTYPES)
    if H.device.type == "cpu":
        return h_at_plain(A, H)
    dev, k = H.device, H.shape[0]
    plan = h_at_plan(m, w, k, A.dtype)
    out = torch.empty((k, m), dtype=torch.float32, device=dev)
    lib = _build.load_library("rank2_loop")
    fn = getattr(lib, f"smallk_h_at_{_SUFFIX[A.dtype]}")
    _raise_on(lib, fn(A.data_ptr(), H.data_ptr(), out.data_ptr(), m, w, k,
                      plan.grid[1], plan.cols_per_split, int(vector_path(A)),
                      torch.cuda.current_stream(dev).cuda_stream, dev.index),
              "h_at", m, w)
    _count(k)
    return out


def _rows(F, name) -> int:
    """The factor's rows, one of ROWS (2R for R lanes)."""
    k = F.shape[0] if F.ndim == 2 else None
    if k not in ROWS:
        raise ValueError(f"{name}: factor {tuple(F.shape)} (the products "
                         f"take {ROWS} rows)")
    return k


def _count(k: int) -> None:
    global launches, lane_launches
    launches += 1
    if k > 2:
        lane_launches += 1


def rank2_loop(A, Wt, iters: int = ITERS):
    """P3: `iters` iterations of Wt <- (Wt.A).A^T / (max|.| + 1) from Wt
    (2, m); returns the last Wt (2, m) f32."""
    global launches
    m, w = _check(A, Wt, "rank2_loop", (2, A.shape[0]), A_DTYPES[:2])
    if iters < 0:
        raise ValueError(f"rank2_loop: iters={iters} < 0")
    if Wt.device.type == "cpu":
        return rank2_loop_plain(A, Wt, iters)
    dev = Wt.device
    f32 = dict(dtype=torch.float32, device=dev)
    tn, nt = wt_a_plan(m, w, 2, A.dtype), h_at_plan(m, w, 2, A.dtype)
    out = Wt.clone()
    H = torch.empty((2, w), **f32)
    Wn = torch.empty((2, m), **f32)
    partial = _partial(tn, H)
    maxbits = torch.empty((1,), dtype=torch.int32, device=dev)
    lib = _build.load_library("rank2_loop")
    fn = getattr(lib, f"smallk_rank2_loop_{_SUFFIX[A.dtype]}")
    _raise_on(lib, fn(A.data_ptr(), out.data_ptr(), H.data_ptr(),
                      Wn.data_ptr(), partial.data_ptr(), maxbits.data_ptr(),
                      m, w, iters,
                      tn.grid[1], tn.rows_per_slab, nt.grid[1],
                      nt.cols_per_split, int(vector_path(A)),
                      torch.cuda.current_stream(dev).cuda_stream, dev.index),
              "rank2_loop", m, w)
    launches += 1
    return out


def _check(A, F, name, want, a_dtypes):
    """Shapes, devices, dtypes and layout the kernel takes; (m, w)."""
    if A.ndim != 2 or tuple(F.shape) != want:
        raise ValueError(f"{name}: A {tuple(A.shape)} and factor "
                         f"{tuple(F.shape)} (expected {want})")
    if A.device != F.device:
        raise ValueError(f"{name}: operands on different devices")
    m, w = A.shape
    if m < 1 or w < 1:
        raise ValueError(f"{name}: empty A {tuple(A.shape)}")
    if F.device.type == "cpu":
        return m, w
    if F.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {F.device}")
    if A.dtype not in a_dtypes:
        raise ValueError(f"{name}: A dtype {A.dtype} (the kernel takes "
                         f"{', '.join(str(d) for d in a_dtypes)})")
    if F.dtype != torch.float32:
        raise ValueError(f"{name}: factor dtype {F.dtype} (the kernel takes "
                         "float32)")
    if not (A.is_contiguous() and F.is_contiguous()):
        raise ValueError(f"{name}: A and the factor must be contiguous")
    return m, w


def _raise_on(lib, err, name, m, w):
    if err != 0:
        msg = lib.smallk_rank2_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} "
                           f"(cudaError {err}, m={m}, w={w})")


def wt_a_plain(A, Wt):
    """Plain torch version of wt_a: A upcast to the factor's dtype, then
    one product."""
    return torch.matmul(Wt, A.to(Wt.dtype))


def h_at_plain(A, H):
    """Plain torch version of h_at."""
    return torch.matmul(H, A.to(H.dtype).T)


def rank2_loop_plain(A, Wt, iters: int = ITERS):
    """Plain torch version of P3: the body of scripts/tpu_batch60.py's
    xla_loop, op for op."""
    for _ in range(iters):
        H = wt_a_plain(A, Wt)
        Wn = h_at_plain(A, H)
        s = torch.max(torch.abs(Wn)) + 1.0
        Wt = (Wn / s).to(Wt.dtype)
    return Wt

