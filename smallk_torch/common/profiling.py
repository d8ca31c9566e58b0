"""Tracing / profiling utilities — port of smallk_tpu/common/profiling.py.

`Timer` and `timed` are the reference's wall-clock surface, copied.
`device_trace` captures a `torch.profiler` trace (host and CUDA
activities) as a Chrome trace file; `debug_nans` scopes autograd's anomaly
detection; `block_and_time` times a callable with CUDA events when its
output lies on the card and with the host clock when it lies on the CPU.
"""

from __future__ import annotations

import contextlib
import os
import time


class Timer:
    """Wall-clock timer (reference common/include/timer.hpp)."""

    def __init__(self):
        self._start = None
        self._elapsed = 0.0

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self) -> None:
        if self._start is not None:
            self._elapsed += time.perf_counter() - self._start
            self._start = None

    def reset(self) -> None:
        self._start = None
        self._elapsed = 0.0

    def report_seconds(self) -> float:
        return self._elapsed

    def report_milliseconds(self) -> float:
        return self._elapsed * 1e3

    def report_microseconds(self) -> int:
        return int(self._elapsed * 1e6)


@contextlib.contextmanager
def timed(label: str, sink=None):
    """Context manager printing (or collecting) a phase duration."""
    t = Timer()
    t.start()
    try:
        yield t
    finally:
        t.stop()
        if sink is not None:
            sink[label] = sink.get(label, 0.0) + t.report_seconds()
        else:
            print(f"{label}: {t.report_seconds():.3f}s")


# the host calls that enqueue one device kernel each, as torch.profiler
# names them (a graph launch, cudaGraphLaunch, enqueues many)
_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a torch.profiler trace of the block, host and CUDA
    activities, into `logdir`/trace.json (Chrome trace format: open in
    chrome://tracing or Perfetto).  Yields the profiler.

    On an H100 a trace can hold fewer kernel records than the block
    launched: with torch 2.11 a block of 20 launches after four earlier
    sessions kept 18, and one in chip_smoke.py's process after its other
    phases kept none (PERF.md §7).  So when a trace holds fewer kernel
    records than the host's kernel launch calls in it, or than the port's
    own launch counters (the kernels' wrappers count every launch, a graph
    replay its kernels' launches) moved across the block, or none beside a
    graph launch, a RuntimeWarning says that its device timeline is
    incomplete.  The counters are the check that does not depend on the
    profiler: a trace that lost its launch calls as well as its kernels
    still warns.  A block that must see every kernel runs in a process of
    its own."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    os.makedirs(logdir, exist_ok=True)
    before = _port_launches()
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    launched = _port_launches() - before
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    if cuda:
        _warn_on_lost_kernels(path, launched)


def _port_launches() -> int:
    """The launches the port's kernel wrappers have counted so far."""
    from ..kernels import ell_spmm, hals_step, masked_gj, rank2_loop

    return sum(mod.launches
               for mod in (ell_spmm, hals_step, masked_gj, rank2_loop))


def _warn_on_lost_kernels(path: str, launched: int = 0) -> None:
    """Warn when the trace at `path` holds fewer kernel records than its
    launch calls or than `launched`, the port's kernel launches in its
    block, or none beside a graph launch."""
    import json
    import warnings

    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = sum(e.get("cat") == "kernel" for e in events)
    calls = sum(e.get("name") in _LAUNCH_CALLS for e in events)
    graphs = sum(e.get("name") == "cudaGraphLaunch" for e in events)
    if kernels < max(calls, launched) or (graphs and not kernels):
        warnings.warn(
            f"device_trace: {path} holds {kernels} kernel records for "
            f"{calls} kernel launch calls, {graphs} graph launches and "
            f"{launched} launches of the port's kernels: its device "
            "timeline is incomplete", RuntimeWarning, stacklevel=3)


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Scoped autograd anomaly detection (NaN and Inf produced in a
    backward pass raise), the previous setting restored on exit."""
    import torch

    prev = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(enable)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(prev)


def _outputs_on_card(out) -> bool:
    """Whether any tensor in `out` (a tensor or a tuple/list of them)
    lies on a CUDA device."""
    import torch

    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, (tuple, list)):
        return any(_outputs_on_card(o) for o in out)
    return False


def block_and_time(fn, *args, warmup: int = 1, reps: int = 5):
    """Measure the steady-state time of fn(*args).

    Returns (seconds_per_call, last_output).  When the output lies on the
    card, the `reps` calls run between two CUDA events after a
    synchronize, so the asynchronous launch queue does not skew the
    result; when it lies on the CPU, the host clock times them.  With
    warmup=0 one untimed call still runs, to see where the output lies.
    """
    import torch

    for _ in range(max(warmup, 1)):
        out = fn(*args)
    if not _outputs_on_card(out):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        return (time.perf_counter() - t0) / reps, out
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn(*args)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / 1e3 / reps, out
