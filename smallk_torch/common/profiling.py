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


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a torch.profiler trace of the block, host and CUDA
    activities, into `logdir`/trace.json (Chrome trace format: open in
    chrome://tracing or Perfetto).  Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


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
