"""The trace reductions on synthetic events."""

import pytest

from benchmarks import run as bench_run
from benchmarks import trace as tr
from types import SimpleNamespace


def _trace():
    return tr.DeviceTrace(
        device=[("k5", 1.0, 3.0), ("copy", 2.5, 4.0), ("k1", 6.0, 6.5), ("k5", 8.0, 9.0)],
        spans=[("window", 0.0, 10.0), ("stack", 0.5, 9.5), ("build", 0.5, 2.0), ("search", 2.0, 5.0),
               ("build", 5.5, 7.0), ("search", 7.0, 9.2)],
    )


def test_union_seconds():
    assert tr.union_seconds([(0, 2), (1, 3), (5, 6)]) == 4
    assert tr.union_seconds([(0, 2), (1, 3), (5, 6)], lo=1.5, hi=5.5) == 2.0
    assert tr.union_seconds([]) == 0


def test_busy_and_span_device_time():
    t = _trace()
    assert tr.busy_seconds(t) == pytest.approx(3.0 + 0.5 + 1.0)
    assert tr.device_seconds_in(t, "search") == (pytest.approx(2.0 + 1.0), 2)
    assert tr.device_seconds_in(t, "build") == (pytest.approx(1.0 + 0.5), 2)


def test_breakdown():
    b = tr.breakdown(_trace(), top=2)
    assert b["device_ops"] == [["k5", 3.0], ["copy", 1.5]]
    # Idle: [0, 1] in build, [4, 6] and [6.5, 8] in search, [9, 10] in stack.
    assert b["idle_gaps"] == [["search", pytest.approx(2.0)], ["search", pytest.approx(1.5)]]


def test_device_readers():
    ctx = SimpleNamespace(trace=_trace(), device_name="NVIDIA H100 80GB HBM3")
    assert bench_run.reader("device_idle_pct")(ctx) == pytest.approx(100 * (1 - 4.5 / 10))
    assert bench_run.reader("device_idle_pct")(SimpleNamespace(trace=None)) is None
