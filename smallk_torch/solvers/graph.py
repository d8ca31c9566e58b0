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

BPP's step holds loops whose trip counts are device values, as the JAX
package's lax.while_loop: its two pivot loops (smallk_tpu/solvers/
nnls.py:557-590, :724) and, above K1's rank limit, the masked CG loop of
every solve (:184-205).  In a captured step each is a conditional WHILE
node (`while_loop`, `WhileLoop`, built by csrc/graph_if.cu; torch 2.11 has
no binding for them): the loop's body is captured once, writes its new
state into the carry's tensors and sets the node's handle from the next
test, so the graph's size does not grow with the trips that run.  A loop
inside a body (a CG solve in a pivot round) is a WHILE node in that
body.  Each level of nesting captures on a stream of the port's own
(`body_stream`, made and warmed before the capture), and what it
allocates goes to a memory pool of its own that the graph keeps until it
is released.

A capture or a replay that fails raises; nothing here runs the eager loop
instead.  A step that reads the host (`.item()`, `bool()` of a card
tensor, a synchronize) makes the capture raise; in a WHILE body torch's
sync check raises before the read reaches CUDA.

Launch counters.  A kernel wrapper's Python body runs once, at capture, so
each counter's change over the capture is undone and added once more
after every replay, except the changes inside a WHILE body, which runs
any number of times: the body adds those to a tensor of counts on the
card (`StepGraph.counts`) each time it runs, and the loop adds what it
holds to the counters at its host read (`settle`).  So the counters count
launches that ran; the CG tier's `cg_solves` and `cg_steps` are counted
the same way.
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

# Levels of WHILE bodies a captured step can nest: a pivot loop's body,
# and a CG loop inside it (nnls._cg_solve_block in a pivot round).
BODY_LEVELS = 2

# since the last reset: graphs captured, their capture and instantiation
# seconds, replays, and the host's seconds in the replay calls
captures = 0
capture_seconds = 0.0
replays = 0
replay_seconds = 0.0
# the nodes of the last graph captured with WHILE nodes, its bodies'
# included
last_nodes = None

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
    k x m) take full-width rounds (nnls._NARROW_MIN_ENTRIES), whose pivot
    loops, and the CG loops of their masked solves above K1's rank limit,
    are WHILE nodes, so the graph does not grow with k."""
    from . import nnls

    m, k = W.shape
    return k * max(m, H.shape[1]) < nnls._NARROW_MIN_ENTRIES


def counters():
    """(module, name) of every launch counter a captured step can move,
    and the CG tier's counts of solves and steps."""
    from ..kernels import ell_spmm, hals_step, masked_gj, rank2_loop, seg_spmm
    from ..ops import aop
    from . import nnls

    return ((rank2_loop, "launches"), (rank2_loop, "lane_launches"),
            (hals_step, "launches"),
            (ell_spmm, "launches"), (ell_spmm, "transposed_launches"),
            (ell_spmm, "plain_cuda_calls"), (seg_spmm, "launches"),
            (seg_spmm, "plain_cuda_calls"), (masked_gj, "launches"),
            (masked_gj, "columns"), (aop, "kernel_products"),
            (aop, "matmul_products"), (nnls, "cg_solves"),
            (nnls, "cg_steps"))


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


def _capture_nodes(lib, stream, device) -> int:
    """The nodes captured so far into the graph that `stream` captures."""
    n = ctypes.c_ulonglong()
    _check(lib, lib.smallk_capture_nodes(stream.cuda_stream, device.index,
                                         ctypes.byref(n)),
           "counting a graph's nodes")
    return n.value


def body_stream(device, level: int = 1) -> torch.cuda.ExternalStream:
    """The stream that captures the WHILE bodies of `level` on `device`
    (1: a loop of the step; 2: a loop inside a level-1 body): one of the
    port's own (every stream of torch's pool may be handed out again),
    made once and before any capture, with cuBLAS's workspace for it made
    by a product on it (cuBLAS keeps one a stream and makes it at the
    stream's first product, which in a body would allocate inside the
    capture)."""
    s = _bodies.get((device, level))
    if s is None:
        lib = _lib()
        ptr = ctypes.c_void_p()
        _check(lib, lib.smallk_stream_create(ctypes.byref(ptr), device.index),
               f"creating the level-{level} WHILE bodies' stream")
        s = torch.cuda.ExternalStream(ptr.value, device=device)
        with torch.cuda.stream(s):
            for dt in (torch.float32, torch.float64):
                a = torch.ones((2, 2), dtype=dt, device=device)
                torch.matmul(a, a)
        s.synchronize()
        _bodies[(device, level)] = s
    return s


def capturing() -> bool:
    """Whether a step is being captured: its loops are then WHILE nodes
    (`while_loop`)."""
    return _active is not None


def while_loop(live, step, c):
    """The JAX package's lax.while_loop(live, step, c) as a WHILE node of
    the step being captured (WhileLoop.__call__)."""
    return _active.loops(live, step, c)


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
        global captures, capture_seconds, last_nodes, _active
        self.carry = carry
        dev = self.device = carry.W.device
        names = self._names = counters()
        before = [getattr(mod, name) for mod, name in names]
        t0 = time.perf_counter()
        # launches in WHILE bodies, counted on the card as the bodies run,
        # and what the host has taken of them
        self.counts = torch.zeros(len(names), dtype=torch.int64, device=dev)
        self._settled = [0] * len(names)
        self.loops = WhileLoop(self)
        self.graph = torch.cuda.CUDAGraph()
        side, cur = _stream(dev), torch.cuda.current_stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.graph.capture_begin(capture_error_mode="thread_local")
            _active = self
            try:
                step(self.carry, out=self.carry)
                if self.loops.lib is not None:
                    last_nodes = self.loops.nodes + _capture_nodes(
                        self.loops.lib, side, dev)
            except BaseException:
                # end the broken capture; the step's own error is the one
                # to raise
                with contextlib.suppress(RuntimeError):
                    self.graph.capture_end()
                self.graph = None
                self.loops.end_routing()
                self.loops.release()
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
                self.loops.end_routing()
                self.loops.release()
                raise
            self.loops.end_routing()
        cur.wait_stream(side)
        capture_seconds += time.perf_counter() - t0
        captures += 1

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
        """Add to the counters what the WHILE bodies counted since the last
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
            self.loops.release()


class WhileLoop:
    """The WHILE nodes of the step being captured (`while_loop`).  A call
    captures its loop's body once, into the body graph of a node, on the
    body stream of its level of nesting; the body counts its own launches
    on the card (StepGraph.counts) each time it runs."""

    def __init__(self, sg: StepGraph):
        self.sg = sg
        self.lib = None
        self.nodes = 0       # the nodes of the bodies captured
        self._pools = {}     # level -> the memory pool of its bodies
        self._routing = []   # pools that the capture allocates from
        self._marks = []     # the counters as each open body began
        self._sync_mode = None

    def __call__(self, live, step, c):
        """lax.while_loop(live, step, c) on `c`, a NamedTuple of tensors
        on the card that holds the loop's state: `step(c)` returns the next
        state (new tensors, which the body copies into c's) and `live(c)`
        the test, a 0-d bool tensor.  The node tests `live(c)` before every
        trip; returns `c`, which holds the final state when the node has
        run."""
        sg = self.sg
        dev = sg.device
        level = len(self._marks) + 1
        body = _bodies.get((dev, level))
        if body is None:
            raise RuntimeError(f"no level-{level} WHILE body stream on {dev}:"
                               f" body_stream(device, {level}) makes it, "
                               "before the capture")
        if self.lib is None:
            self.lib = _lib()
        lib = self.lib
        outer = torch.cuda.current_stream(dev)
        self._flush()  # the enclosing body's launches so far
        pred = _test(live(c))
        handle = ctypes.c_ulonglong()
        _check(lib, lib.smallk_while_begin(
            outer.cuda_stream, pred.data_ptr(), body.cuda_stream, dev.index,
            ctypes.byref(handle)), "adding a WHILE node")
        if level == 1:
            self._sync_mode = torch.cuda.get_sync_debug_mode()
        self._marks.append([getattr(mod, name) for mod, name in sg._names])
        ended = False
        try:
            torch.cuda.set_stream(body)
            if level == 1:
                # a host read in a body raises before it reaches CUDA: a
                # body whose capture CUDA invalidates leaves its node
                # unusable, and the whole graph with it
                torch.cuda.set_sync_debug_mode("error")
            self._route(level)
            for dst, src in zip(c, step(c), strict=True):
                dst.copy_(src)
            pred = _test(live(c))
            self._flush()
            # and the set kernel that smallk_while_end adds
            self.nodes += _capture_nodes(lib, body, dev) + 1
            err = lib.smallk_while_end(body.cuda_stream, pred.data_ptr(),
                                       handle.value, dev.index)
            ended = True
            _check(lib, err, "ending a WHILE body")
        finally:
            if not ended:
                lib.smallk_while_end(body.cuda_stream, None, 0, dev.index)
            self._marks.pop()
            torch.cuda.set_stream(outer)
            if level == 1:
                torch.cuda.set_sync_debug_mode(self._sync_mode)
        return c

    def _route(self, level: int) -> None:
        """From now until the capture ends, what the current stream (the
        level's bodies') allocates comes from a pool of the graph's own for
        that level.  The bodies' temporaries then reuse each other's
        blocks, where the graph's pool would match them to the capture
        stream only; the graph needs them until it is released."""
        if level not in self._pools:
            pool = self._pools[level] = torch.cuda.graph_pool_handle()
            torch._C._cuda_beginAllocateCurrentStreamToPool(
                self.sg.device.index, pool)
            self._routing.append(pool)

    def _flush(self) -> None:
        """The open body's launches since its mark, added to the card's
        counts by the body and taken out of the step's count of launches
        in every replay."""
        if not self._marks:
            return
        sg = self.sg
        for i, ((mod, name), b) in enumerate(zip(sg._names,
                                                 self._marks[-1])):
            d = getattr(mod, name) - b
            if d:
                sg.counts[i].add_(d)
                setattr(mod, name, b)

    def end_routing(self) -> None:
        for pool in self._routing:
            torch._C._cuda_endAllocateToPool(self.sg.device.index, pool)
        self._routing = []

    def release(self) -> None:
        for pool in self._pools.values():
            torch._C._cuda_releasePool(self.sg.device.index, pool)
        self._pools = {}


def _test(pred):
    """A loop's test as the set kernel reads it: one bool on the card."""
    if pred.dtype != torch.bool or pred.numel() != 1 or not pred.is_cuda:
        raise ValueError(f"a WHILE node's test is one bool on the card, not "
                         f"{pred.dtype} {tuple(pred.shape)} on "
                         f"{pred.device}")
    return pred


def _copy_into(dst, src) -> None:
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
        return
    for d, t in zip(dst, src, strict=True):
        _copy_into(d, t)
