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
