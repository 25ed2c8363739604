"""The trace's reduction: busy time as the union of device intervals, idle
gaps labelled by the host span they fall in, device time by name."""

from types import SimpleNamespace

import pytest

from port_bench.core import trace


def ev(name, dev, s, e):
    return SimpleNamespace(name=name, device_type=f"DeviceType.{dev}",
                           time_range=SimpleNamespace(start=s, end=e))


def test_reduce_events():
    events = [ev("bench.window", "CPU", 0, 100),
              ev("bench.forward", "CPU", 0, 40), ev("bench.nms", "CPU", 40, 100),
              ev("k1", "CUDA", 5, 30), ev("k2", "CUDA", 20, 35),   # overlap: one interval
              ev("copy", "CUDA", 60, 70), ev("bench.nms", "CUDA", 40, 100),
              ev("late", "CUDA", 95, 120)]                          # cut at the window
    r = trace.reduce_events(events)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx((30 + 10 + 5) * 1e-6)
    assert dict((k, v) for k, v in r["device_ops"]) == pytest.approx(
        {"k1": 25e-6, "k2": 15e-6, "copy": 10e-6, "late": 5e-6})
    idle = dict((k, v) for k, v in r["idle_gaps"])
    # gaps 0-5 (in forward), 35-60 and 70-95 (mid-points in nms)
    assert idle == pytest.approx({"forward": 5e-6, "nms": 50e-6})


def test_no_window_no_reading():
    assert trace.reduce_events([ev("k1", "CUDA", 0, 1)]) is None


def test_untraced_spans_record_nothing():
    rec = trace.Recorder(traced=False)
    with rec.span("forward"):
        pass
    rec.start()
    rec.stop()
    assert not rec.profiled and rec.reduce() is None
