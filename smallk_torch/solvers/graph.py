"""One solver step captured as a CUDA graph and replayed between the solve
loop's host reads.

It has no module of its own in the JAX package: it stands where `jax.jit`
of the loop body stands (smallk_tpu/solvers/solve.py:146-300), so that a
MU, HALS or RANK2 solve on the card costs the host one graph launch a step
and not the step's few dozen to few hundred kernel launches.

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

A capture or a replay that fails raises; nothing here runs the eager loop
instead.  A step that reads the host (`.item()`, `bool()` of a card
tensor, a synchronize) makes the capture raise.

Launch counters.  A kernel wrapper's Python body runs once, at capture, so
each counter's change over the capture is undone and added once more
after every replay: the counters count launches that ran.
"""

from __future__ import annotations

import contextlib
import time

import torch

from ..common.options import NmfAlgorithm
from ..ops.dense import UNSHARDED

# Capture MU, HALS and RANK2 steps on the card (module switch, as the JAX
# package's hier_chain.CHAIN: chip_smoke.py times the loop with and
# without it; not an option of the user's).
CAPTURE = True

# since the last reset: graphs captured, their capture and instantiation
# seconds, replays, and the host's seconds in the replay calls
captures = 0
capture_seconds = 0.0
replays = 0
replay_seconds = 0.0

_CAPTURED = (NmfAlgorithm.MU, NmfAlgorithm.HALS, NmfAlgorithm.RANK2)
_streams: dict = {}


def applies(algorithm: NmfAlgorithm, W, unroll: int,
            a_op=UNSHARDED) -> bool:
    """Whether a solve of `algorithm` on `a_op`, on W's device, U =
    `unroll` steps between host reads, is captured.  At U = 1 it is not:
    no step can be frozen there, so the eager step selects nothing, where a
    graph's step must copy the new state into its buffers (at the flagship
    on an H100, 2 GB a step, 2.6% of MU's it/s: PERF.md §6).  Nor is a
    solve on a sharded operand: its steps hold collectives (gloo's cannot
    be captured; NCCL's in a graph are not ported), so it runs eagerly."""
    return (CAPTURE and unroll > 1 and W.is_cuda and algorithm in _CAPTURED
            and not a_op.sharded)


def counters():
    """(module, name) of every launch counter a captured step can move."""
    from ..kernels import ell_spmm, hals_step, masked_gj, rank2_loop, seg_spmm
    from ..ops import aop

    return ((rank2_loop, "launches"), (hals_step, "launches"),
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
        global captures, capture_seconds
        self.carry = carry
        dev = carry.W.device
        names = counters()
        before = [getattr(mod, name) for mod, name in names]
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        side, cur = _stream(dev), torch.cuda.current_stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                step(self.carry, out=self.carry)
            except BaseException:
                # end the broken capture; the step's own error is the one
                # to raise
                with contextlib.suppress(RuntimeError):
                    self.graph.capture_end()
                self.graph = None
                with contextlib.suppress(RuntimeError):
                    _close_generator(dev)
                raise
            finally:
                self.deltas = [getattr(mod, name) - b
                               for (mod, name), b in zip(names, before)]
                for (mod, name), b in zip(names, before):
                    setattr(mod, name, b)
            self.graph.capture_end()
        cur.wait_stream(side)
        capture_seconds += time.perf_counter() - t0
        captures += 1
        self._names = names

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

    def close(self) -> None:
        """Release the graph and its memory pool."""
        if self.graph is not None:
            self.graph.reset()
            self.graph = None


def _copy_into(dst, src) -> None:
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
        return
    for d, t in zip(dst, src, strict=True):
        _copy_into(d, t)
