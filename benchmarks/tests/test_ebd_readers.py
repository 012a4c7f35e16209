"""The readers of the reprojection's spans and counters
(``benchmarks/metrics/{reproject_s,coords_s,resample_s,resample_roofline,
reproject_uploaded_gib}.py``)
on synthetic tracer records, a synthetic device trace and a stand-in
``ctx``; each reads nothing from a program without those spans."""

from types import SimpleNamespace

import pytest

from benchmarks import program_spans
from benchmarks import run as bench_run
from benchmarks import trace as tr
from benchmarks.metrics import resample_roofline
from benchmarks.peaks import peaks
from kbmod_tpu_torch.tracing import Record

CELL = "ebd_reflex.four_nights"
TRAFFIC = {"stack": {"height": 128, "width": 1024}}


def _rec(name, start, end, counts=None):
    return Record(name, 0, 0, start, end, int(start * 1e9), counts or {})


def _work_unit(t, images=3):
    """One WorkUnit's records from time t: a reprojection of two layers over
    ``images`` CCDs (49 taps each), then the search."""
    recs = [_rec("reproject", t, t + 4.0, {"reproject.images": images, "reproject.layers": 2})]
    for i in range(images):
        recs += [_rec("reproject.coords", t + i, t + i + 0.25),
                 _rec("reproject.resample", t + i + 0.25, t + i + 0.75, {"reproject.taps": 49}),
                 _rec("reproject.upload", t + i + 0.3, t + i + 0.5, {"reproject.bytes_h2d": 100})]
    return recs + [_rec("search", t + 4.5, t + 5.0)]


def _ctx(*starts, trace=None):
    return SimpleNamespace(records=[{"spans": [("stack", t, t + 6.0)]} for t in starts], trace=trace,
                           traffic=TRAFFIC, device_name="NVIDIA H100 80GB HBM3")


@pytest.fixture
def records(monkeypatch):
    recs = _work_unit(100.0) + _work_unit(110.0, images=5)
    monkeypatch.setattr(program_spans, "program_records", lambda: recs)
    return recs


@pytest.mark.parametrize("quantity, expected", [
    ("reproject_s", 4.0),
    ("coords_s", (3 + 5) * 0.25 / 2),
    ("resample_s", (3 + 5) * 0.5 / 2),
    ("reproject_uploaded_gib", (3 + 5) * 100 / 2 / 2**30),
])
def test_span_readers_take_the_mean_over_work_units(records, quantity, expected):
    assert bench_run.reader(f"{quantity}.{CELL}")(_ctx(100.0, 110.0)) == pytest.approx(expected)


def test_resample_roofline_by_hand(records):
    trace = tr.DeviceTrace(device=[("copy", 100.3, 100.5), ("k", 101.0, 101.1), ("copy", 110.3, 110.6)],
                           spans=[("window", 99.0, 117.0), ("reproject", 100.0, 104.0), ("reproject", 110.0, 114.0)])
    got = bench_run.reader(f"resample_roofline.{CELL}")(_ctx(100.0, 110.0, trace=trace))
    pixels = 128 * 1024
    ops, nbytes = resample_roofline.OPS_PER_TAP * pixels * 49 * 8, 16 * pixels * 8
    assert resample_roofline.work(TRAFFIC, 49 * 8, 8) == (ops, nbytes)
    table = peaks("H100")
    assert got == pytest.approx(100.0 * max(ops / table["fp32_flops"], nbytes / table["hbm_bytes"]) / 0.6)


@pytest.mark.parametrize("quantity", ["reproject_s", "coords_s", "resample_s", "resample_roofline",
                                      "reproject_uploaded_gib"])
def test_a_program_without_the_spans_reads_nothing(monkeypatch, quantity):
    monkeypatch.setattr(program_spans, "program_records", lambda: [_rec("search", 100.5, 101.0)])
    trace = tr.DeviceTrace(device=[("k", 100.6, 100.7)], spans=[("window", 99.0, 107.0), ("reproject", 100.0, 100.4)])
    assert bench_run.reader(f"{quantity}.{CELL}")(_ctx(100.0, trace=trace)) is None
