"""One solver step captured as a CUDA graph and replayed between the solve
loop's host reads.

It has no module of its own in the JAX package: it stands where `jax.jit`
of the loop body stands (smallk_tpu/solvers/solve.py:146-300), so that a
solve on the card costs the host one graph launch a step and not the
step's few dozen to few hundred kernel launches.

`StepGraph(step, carry)` captures `step` on the tensors of the loop's
state (solve.Carry), which become the graph's static buffers: the step
reads them and writes its frozen result back into them, so a replay
advances the state by one step.  (A block of U steps captured as one
graph was slower than one step replayed U times at every U past 2 on
an H100: PERF.md §6.)  The loop hands over a state that
nothing else holds, iteration 0's, and captures while the device still
runs that iteration (solve.nmf_solve); its launches have loaded the
libraries, made the cuBLAS handles and set K2's shared-memory opt-in.  A
solve captures its own graph and releases it, with its memory pool, when
it returns (`close`), unless its caller keeps graphs for an operand of a
fixed address and shape: dense hierclust keeps one a bucket width
(engines/hierclust.py, its sequential loop and its chain alike), and a
later solve at that width copies its state into the graph's buffers
(`load`) and replays it.

BPP's step holds two pivot loops whose trip counts are device values, as
the JAX package's lax.while_loop (smallk_tpu/solvers/nnls.py:557-590).  In
a captured step each is a nest of conditional IF nodes (`IfNest`, built by
csrc/graph_if.cu; torch 2.11 has no binding for them): round r + 1 is
captured inside the IF node of round r, up to the reference's cap of 5 k
rounds, so the node of the first round whose test fails skips every later
one.  The rounds run on a stream of the port's own (`body_stream`), and
what they allocate goes to a memory pool that the graph keeps until it is
released.

A capture or a replay that fails raises; nothing here runs the eager loop
instead.  A step that reads the host (`.item()`, `bool()` of a card
tensor, a synchronize) makes the capture raise; in an IF body torch's
sync check raises before the read reaches CUDA.

Launch counters.  A kernel wrapper's Python body runs once, at capture, so
each counter's change over the capture is undone and added once more
after every replay, except the changes inside an IF node's body, which
may not run: the body adds those to a tensor of counts on the card
(`StepGraph.counts`), and the loop adds what it holds to the counters at
its host read (`settle`).  So the counters count launches that ran.
"""

from __future__ import annotations

import contextlib
import ctypes
import time

import torch

from ..common.options import NmfAlgorithm
from ..ops.dense import UNSHARDED

# Capture the solvers' steps on the card (module switch, as the JAX
# package's hier_chain.CHAIN: chip_smoke.py times the loop with and
# without it; not an option of the user's).
CAPTURE = True

# BPP is captured up to this rank.  A captured BPP step holds 5 k nested
# rounds a side, each ~60 launches, and its capture and instantiation grow
# with them, while the rounds that run do not.  chip_smoke.py --loop on an
# NVIDIA H100 80GB HBM3, 700.00 W (PERF.md §7), Reuters BPP, 100
# iterations, eager at U = 1 against captured at U = 8 (capture +
# instantiate ms): k = 8 0.544-0.627 s against 0.361-0.399 (127-163 ms);
# k = 16 0.753-0.820 against 0.558-0.590 (294-301); k = 32 0.769-0.771
# against 0.942-1.106 (588-760); k = 64 0.826-0.851 against 1.642-1.992;
# k = 128 0.839-0.896 against 3.346-3.874 (2320-2921).
BPP_CAPTURE_MAX_K = 16

# since the last reset: graphs captured, their capture and instantiation
# seconds, replays, and the host's seconds in the replay calls
captures = 0
capture_seconds = 0.0
replays = 0
replay_seconds = 0.0

_CAPTURED = (NmfAlgorithm.MU, NmfAlgorithm.HALS, NmfAlgorithm.RANK2,
             NmfAlgorithm.BPP)
_streams: dict = {}
_bodies: dict = {}
# the StepGraph whose step is being captured
_active = None


def applies(algorithm: NmfAlgorithm, W, unroll: int,
            a_op=UNSHARDED, H=None) -> bool:
    """Whether a solve of `algorithm` on `a_op`, on W's device, U =
    `unroll` steps between host reads, is captured.  At U = 1 it is not:
    no step can be frozen there, so the eager step selects nothing, where a
    graph's step must copy the new state into its buffers (at the flagship
    on an H100, 2 GB a step, 2.6% of MU's it/s: PERF.md §6).  Nor is a
    solve on a sharded operand: its steps hold collectives (gloo's cannot
    be captured; NCCL's in a graph are not ported), so it runs eagerly.
    BPP (H its start, k x n) only where `bpp_captures`."""
    if not (CAPTURE and unroll > 1 and W.is_cuda and algorithm in _CAPTURED
            and not a_op.sharded):
        return False
    return algorithm != NmfAlgorithm.BPP or bpp_captures(W, H)


def bpp_captures(W, H) -> bool:
    """Whether a BPP step from W (m x k) and H (k x n) reads nothing from
    the host, so that it can be captured: both NNLS problems (k x n and
    k x m) take full-width rounds (nnls._NARROW_MIN_ENTRIES), their masked
    solves go to K1 (k at most its MAX_K; the CG tier above reads the host)
    and k is at most BPP_CAPTURE_MAX_K."""
    from ..kernels import masked_gj
    from . import nnls

    m, k = W.shape
    return (k <= min(masked_gj.MAX_K, BPP_CAPTURE_MAX_K)
            and k * max(m, H.shape[1]) < nnls._NARROW_MIN_ENTRIES
            and nnls.MASKED_SOLVER == "auto")


def counters():
    """(module, name) of every launch counter a captured step can move."""
    from ..kernels import ell_spmm, hals_step, masked_gj, rank2_loop, seg_spmm
    from ..ops import aop

    return ((rank2_loop, "launches"), (rank2_loop, "lane_launches"),
            (hals_step, "launches"),
            (ell_spmm, "launches"), (ell_spmm, "transposed_launches"),
            (ell_spmm, "plain_cuda_calls"), (seg_spmm, "launches"),
            (seg_spmm, "plain_cuda_calls"), (masked_gj, "launches"),
            (masked_gj, "columns"), (aop, "kernel_products"),
            (aop, "matmul_products"))


def _stream(device) -> torch.cuda.Stream:
    """The capture stream of `device` (a side stream, as torch asks)."""
    s = _streams.get(device)
    if s is None:
        s = _streams[device] = torch.cuda.Stream(device)
    return s


def _lib():
    from ..kernels import _build

    return _build.load_library("graph_if")


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: "
                           f"{lib.smallk_if_cuda_error_string(err).decode()} "
                           f"(cudaError {err})")


def body_stream(device) -> torch.cuda.ExternalStream:
    """The stream that captures IF bodies on `device`: one of the port's
    own (every stream of torch's pool may be handed out again), made once
    and before any capture, with cuBLAS's workspace for it made by a
    product on it (cuBLAS keeps one a stream and makes it at the stream's
    first product, which in a body would allocate inside the capture)."""
    s = _bodies.get(device)
    if s is None:
        lib = _lib()
        ptr = ctypes.c_void_p()
        _check(lib, lib.smallk_stream_create(ctypes.byref(ptr), device.index),
               "creating the IF bodies' stream")
        s = torch.cuda.ExternalStream(ptr.value, device=device)
        with torch.cuda.stream(s):
            for dt in (torch.float32, torch.float64):
                a = torch.ones((2, 2), dtype=dt, device=device)
                torch.matmul(a, a)
        s.synchronize()
        _bodies[device] = s
    return s


def if_nest():
    """An IfNest for a loop of the step being captured, else None."""
    return None if _active is None else IfNest(_active)


def _close_generator(device) -> None:
    """After a capture that failed: torch's capture_end raised before it
    marked the card's random generator as no longer capturing, so every
    later draw on the card (torch.rand) would raise.  A capture of one
    small op ends that state."""
    g = torch.cuda.CUDAGraph()
    g.capture_begin(capture_error_mode="thread_local")
    torch.zeros(1, device=device)
    g.capture_end()
    g.reset()


class StepGraph:
    """`step` captured on `carry`'s tensors; `run` replays it."""

    def __init__(self, step, carry):
        global captures, capture_seconds, _active
        self.carry = carry
        dev = self.device = carry.W.device
        names = self._names = counters()
        before = [getattr(mod, name) for mod, name in names]
        t0 = time.perf_counter()
        # launches in IF bodies, counted on the card as the bodies run,
        # and what the host has taken of them
        self.counts = torch.zeros(len(names), dtype=torch.int64, device=dev)
        self._settled = [0] * len(names)
        self.body_pool, self._routing = None, False
        self.graph = torch.cuda.CUDAGraph()
        side, cur = _stream(dev), torch.cuda.current_stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.graph.capture_begin(capture_error_mode="thread_local")
            _active = self
            try:
                step(self.carry, out=self.carry)
            except BaseException:
                # end the broken capture; the step's own error is the one
                # to raise
                with contextlib.suppress(RuntimeError):
                    self.graph.capture_end()
                self.graph = None
                self._end_routing()
                self._release_body_pool()
                with contextlib.suppress(RuntimeError):
                    _close_generator(dev)
                raise
            finally:
                _active = None
                self.deltas = [getattr(mod, name) - b
                               for (mod, name), b in zip(names, before)]
                for (mod, name), b in zip(names, before):
                    setattr(mod, name, b)
            try:
                self.graph.capture_end()
            except BaseException:
                self.graph = None
                self._end_routing()
                self._release_body_pool()
                raise
            self._end_routing()
        cur.wait_stream(side)
        capture_seconds += time.perf_counter() - t0
        captures += 1

    def route_body_allocations(self) -> None:
        """From now until the capture ends, what the current stream (the IF
        bodies') allocates comes from a pool of the graph's own.  The
        bodies' temporaries then reuse each other's blocks, round after
        round, where the graph's pool would match them to the capture
        stream only; the graph needs them until it is released (`close`)."""
        if self.body_pool is None:
            self.body_pool = torch.cuda.graph_pool_handle()
            torch._C._cuda_beginAllocateCurrentStreamToPool(
                self.device.index, self.body_pool)
            self._routing = True

    def _end_routing(self) -> None:
        if self._routing:
            torch._C._cuda_endAllocateToPool(self.device.index,
                                             self.body_pool)
            self._routing = False

    def _release_body_pool(self) -> None:
        if self.body_pool is not None:
            torch._C._cuda_releasePool(self.device.index, self.body_pool)
            self.body_pool = None

    def load(self, carry) -> None:
        """Copy `carry` (a state of the captured step's shapes, dtypes and
        layouts) into the graph's buffers: the next replay steps from it."""
        _copy_into(self.carry, carry)

    def run(self, n: int) -> int:
        """Replay the step n times; returns the steps run."""
        global replays, replay_seconds
        t0 = time.perf_counter()
        for _ in range(n):
            self.graph.replay()
            for (mod, name), d in zip(self._names, self.deltas):
                if d:
                    setattr(mod, name, getattr(mod, name) + d)
        replay_seconds += time.perf_counter() - t0
        replays += n
        return n

    def settle(self, counts) -> None:
        """Add to the counters what the IF bodies counted since the last
        settle: `counts`, the host's copy of `self.counts`, taken at the
        loop's host read."""
        for (mod, name), now, was in zip(self._names, counts, self._settled):
            if now != was:
                setattr(mod, name, getattr(mod, name) + int(now - was))
        self._settled = [int(v) for v in counts]

    def close(self) -> None:
        """Release the graph and its memory pools."""
        if self.graph is not None:
            self.graph.reset()
            self.graph = None
            self._release_body_pool()


class IfNest:
    """The IF nodes of one loop in the step being captured (`if_nest`):
    each call captures a round in the body of an IF node on its test, the
    node inside the body of the round before, and `close` ends the nest.
    Each body counts its own launches on the card (StepGraph.counts)."""

    def __init__(self, sg: StepGraph):
        self.sg = sg
        self.lib = _lib()
        self.outer = torch.cuda.current_stream(sg.device)
        self.body = body_stream(sg.device)
        self.depth = 0
        self._mark = None
        self._sync_mode = None

    def __call__(self, pred, step, c):
        """Round `step` of the loop's carry `c` (a NamedTuple of tensors)
        under an IF node on `pred` (a 0-d bool tensor on the card): the
        body writes the new state into `c`'s tensors, which hold the loop's
        state whether or not the round runs."""
        self._enter(pred)
        for dst, src in zip(c, step(c), strict=True):
            dst.copy_(src)
        return c

    def _enter(self, pred) -> None:
        sg = self.sg
        self._flush()
        src = self.outer if self.depth == 0 else self.body
        _check(self.lib, self.lib.smallk_if_begin(
            src.cuda_stream, pred.data_ptr(), self.body.cuda_stream,
            sg.device.index), "adding an IF node")
        if self.depth == 0:
            torch.cuda.set_stream(self.body)
            sg.route_body_allocations()
            # a host read in a body raises before it reaches CUDA: a body
            # whose capture CUDA invalidates leaves its IF node
            # unusable, and the whole graph with it
            self._sync_mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
        self.depth += 1
        self._mark = [getattr(mod, name) for mod, name in sg._names]

    def _flush(self) -> None:
        """The current body's launches, counted on the card by the body and
        taken out of the step's count of launches in every replay."""
        if self.depth == 0:
            return
        sg = self.sg
        for i, ((mod, name), b) in enumerate(zip(sg._names, self._mark)):
            d = getattr(mod, name) - b
            if d:
                sg.counts[i].add_(d)
                setattr(mod, name, b)

    def close(self, quiet: bool = False) -> None:
        """End the nest: the capture stream goes on after its first node.
        `quiet`: after a failure, end it, launching and raising nothing."""
        if self.depth == 0:
            return
        err = 0
        try:
            if not quiet:
                self._flush()
        finally:
            err = self.lib.smallk_if_end(self.body.cuda_stream,
                                         self.sg.device.index)
            torch.cuda.set_stream(self.outer)
            torch.cuda.set_sync_debug_mode(self._sync_mode)
            self.depth = 0
        if not quiet:
            _check(self.lib, err, "ending an IF nest")


def _copy_into(dst, src) -> None:
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
        return
    for d, t in zip(dst, src, strict=True):
        _copy_into(d, t)
