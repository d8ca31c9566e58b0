"""The port's profiling utilities (common/profiling.py): the four cases of
tests/test_profiling.py, the timer against the reference's, and the
trace file.  On the CPU, block_and_time uses the host clock; the CUDA
event path is held against chip_smoke.device_ms on the card."""

import json
import os
import time

import numpy as np
import pytest
import torch

from smallk_tpu.common.profiling import Timer as JTimer
from smallk_torch.common.profiling import (
    Timer,
    block_and_time,
    debug_nans,
    device_trace,
    timed,
)


@pytest.mark.parametrize("cls", [Timer, JTimer], ids=["port", "jax"])
def test_timer(cls):
    t = cls()
    t.start()
    time.sleep(0.01)
    t.stop()
    assert 0.005 < t.report_seconds() < 1.0
    assert t.report_microseconds() > 5000
    assert t.report_milliseconds() == pytest.approx(
        t.report_seconds() * 1e3)
    t.stop()  # a stop without a start changes nothing
    assert t.report_microseconds() == int(t.report_seconds() * 1e6)
    t.reset()
    assert t.report_seconds() == 0.0


def test_timed_sink(capsys):
    sink = {}
    with timed("phase", sink):
        time.sleep(0.005)
    with timed("phase", sink):
        pass
    assert sink["phase"] > 0.001 and list(sink) == ["phase"]
    with timed("printed"):
        pass
    assert capsys.readouterr().out.startswith("printed: ")


def test_block_and_time_on_the_cpu():
    calls = []

    def f(x):
        calls.append(1)
        return x * 2.0

    secs, out = block_and_time(f, torch.ones((8, 8)), warmup=2, reps=3)
    assert secs >= 0 and len(calls) == 5
    np.testing.assert_allclose(out.numpy(), 2.0)
    calls.clear()
    block_and_time(f, torch.ones(2), warmup=0, reps=2)
    assert len(calls) == 3  # one untimed call sees where the output lies


def test_debug_nans_scoped():
    before = torch.is_anomaly_enabled()
    with debug_nans(True):
        assert torch.is_anomaly_enabled() is True
        with debug_nans(False):
            assert torch.is_anomaly_enabled() is False
        assert torch.is_anomaly_enabled() is True
    assert torch.is_anomaly_enabled() == before


def test_device_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace"
    with device_trace(str(logdir)):
        torch.mm(torch.ones(16, 16), torch.ones(16, 16))
    path = logdir / "trace.json"
    assert os.path.getsize(path) > 0
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


@pytest.mark.cuda
def test_block_and_time_uses_cuda_events():
    """On the card: the events' time of a product against the host clock
    around the same calls between two synchronizes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.ones((2048, 2048), device="cuda")
    secs, out = block_and_time(torch.mm, x, x, reps=10)
    assert out.is_cuda and secs > 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        torch.mm(x, x)
    torch.cuda.synchronize()
    assert secs <= 2 * (time.perf_counter() - t0) / 10


@pytest.mark.cuda
def test_two_device_traces_in_one_process_hold_their_kernels(tmp_path):
    """Two device_trace blocks in one process: each trace holds the K3
    kernels launched inside it, or device_trace warns that it lost some,
    as its docstring says; none loses kernels silently."""
    import warnings

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from smallk_torch.kernels import rank2_loop as k3

    A = torch.rand((512, 256), device="cuda")
    Wt = torch.rand((2, 512), device="cuda")
    k3.wt_a(A, Wt)
    for block, calls in (("first", 20), ("second", 7)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always", RuntimeWarning)
            with device_trace(str(tmp_path / block)):
                for _ in range(calls):
                    k3.wt_a(A, Wt)
        warned = any("device_trace" in str(w.message) for w in caught)
        with open(tmp_path / block / "trace.json") as f:
            events = json.load(f)["traceEvents"]
        names = [e.get("name", "") for e in events
                 if e.get("cat") == "kernel"]
        found = sum("wt_a_kernel" in k for k in names)
        assert found == calls or warned, (block, found, names)


def test_lost_kernels_warn(tmp_path):
    """The check behind the warning, on traces written by hand: fewer
    kernel records than launch calls warns, as does a graph launch with
    none, and fewer than the port's launch counters moved, even where the
    trace lost its launch calls too; a full trace does not."""
    from smallk_torch.common.profiling import _warn_on_lost_kernels

    def trace(*names):
        path = tmp_path / f"t{len(names)}.json"
        path.write_text(json.dumps({"traceEvents": [
            {"name": n, "cat": "kernel" if n == "k" else "cuda_runtime"}
            for n in names]}))
        return str(path)

    with pytest.warns(RuntimeWarning, match="incomplete"):
        _warn_on_lost_kernels(trace("cudaLaunchKernel", "cudaLaunchKernel",
                                    "k"))
    with pytest.warns(RuntimeWarning, match="incomplete"):
        _warn_on_lost_kernels(trace("cudaGraphLaunch"))
    with pytest.warns(RuntimeWarning, match="incomplete"):
        _warn_on_lost_kernels(trace(), launched=3)
    with pytest.warns(RuntimeWarning, match="incomplete"):
        _warn_on_lost_kernels(trace("cudaLaunchKernel", "k", "k"),
                              launched=3)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _warn_on_lost_kernels(trace("cudaLaunchKernel", "k",
                                    "cudaGraphLaunch", "k", "k"))
        _warn_on_lost_kernels(trace("cudaLaunchKernel", "k",
                                    "cudaGraphLaunch", "k", "k", "k"),
                              launched=4)
