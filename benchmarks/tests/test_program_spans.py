"""The readers of the program's own spans and counters
(``benchmarks/metrics/{upload_s,search_host_s,load_results_s,listed_rows,
uploaded_gib}.py``) on synthetic tracer records and a stand-in ``ctx``,
and the idle attribution of ``benchmarks.span_report``."""

from types import SimpleNamespace

import pytest
from torch.profiler import ProfilerActivity, profile

from benchmarks import program_spans, span_report
from benchmarks import run as bench_run
from benchmarks import trace as tr
from benchmarks.tests.conftest import tiny_run
from kbmod_tpu_torch import tracing
from kbmod_tpu_torch.tracing import Record

CELL = "survey_u8.band256"


def _rec(name, start, end, counts=None, rid=0, parent=0):
    return Record(name, rid, parent, start, end, int(start * 1e9), counts or {})


def _stack_records(t):
    """One stack's records from time t: a build of two passes, a search whose
    top-K launches a kernel 0.5 s in and waits 3 s for it, and the results."""
    return [
        _rec("build.stage", t + 0.0, t + 0.3), _rec("build.upload", t + 0.3, t + 0.5, {"bytes.h2d": 2**29}),
        _rec("build.stage", t + 0.6, t + 0.9), _rec("build.upload", t + 0.9, t + 1.1, {"bytes.h2d": 2**29}),
        _rec("search", t + 2.0, t + 7.0, {"rows.listed": 1000 + int(t)}),
        _rec("search.topk", t + 2.1, t + 5.6), _rec("kernel.K5.search_grouped", t + 2.6, t + 2.7),
        _rec("load_and_filter_results", t + 7.5, t + 8.5),
    ]


def _ctx(*starts):
    return SimpleNamespace(records=[{"spans": [("build", t, t + 1.2), ("stack", t, t + 9.0)]} for t in starts])


@pytest.fixture
def records(monkeypatch):
    recs = _stack_records(100.0) + _stack_records(110.0) + [_rec("search", 50.0, 60.0, {"rows.listed": 7})]
    monkeypatch.setattr(program_spans, "program_records", lambda: recs)
    return recs


@pytest.mark.parametrize("quantity, expected", [
    ("upload_s", 1.0),  # two passes of 0.3 s staging and 0.2 s copy
    ("search_host_s", 2.0),  # 5 s of search less 3 s from the launch to the end of search.topk
    ("load_results_s", 1.0),
    ("listed_rows", 1105.0),  # (1100 + 1110) / 2: the record outside both stacks is not counted
    ("uploaded_gib", 1.0),
])
def test_each_reader_takes_the_mean_over_window_stacks(records, quantity, expected):
    value = bench_run.reader(f"{quantity}.{CELL}")(_ctx(100.0, 110.0))
    assert value == pytest.approx(expected)


@pytest.mark.parametrize("quantity", ["upload_s", "search_host_s", "load_results_s", "listed_rows", "uploaded_gib"])
def test_no_records_read_nothing(monkeypatch, quantity):
    monkeypatch.setattr(program_spans, "program_records", lambda: [])
    assert bench_run.reader(f"{quantity}.{CELL}")(_ctx(100.0)) is None


def test_records_go_to_the_stack_that_holds_their_start(records):
    stacks = program_spans.per_stack(_ctx(100.0, 110.0, 200.0))
    assert [len(s) for s in stacks] == [8, 8, 0]
    assert {r.start for r in stacks[1]} >= {110.0, 117.5}


def test_search_host_without_a_kernel_counts_all_of_the_top_k_as_waiting(monkeypatch):
    recs = [_rec("search", 1.0, 4.0), _rec("search.topk", 1.5, 3.5)]
    monkeypatch.setattr(program_spans, "program_records", lambda: recs)
    assert bench_run.reader(f"search_host_s.{CELL}")(_ctx(0.0)) == pytest.approx(1.0)


def test_idle_goes_to_the_innermost_span():
    spans = [("search", 0.0, 10.0), ("search.assemble", 2.0, 6.0), ("search.fetch", 2.0, 3.0)]
    idle = span_report.idle_by_span([(1.0, 4.0), (9.0, 12.0)], spans)
    assert idle == pytest.approx({"search": 2.0, "search.fetch": 1.0, "search.assemble": 1.0,
                                  span_report.OUTSIDE: 2.0})
    assert span_report.idle_gaps([("k", 1.0, 2.0), ("k", 1.5, 3.0), ("c", 5.0, 6.0)], 0.0, 7.0) == [
        (0.0, 1.0), (3.0, 5.0), (6.0, 7.0)]


def test_report_of_a_tiny_window():
    """The report on a tiny band window on the CPU, where the device runs
    nothing: the whole window is idle, every record found its range."""
    _, _, loop = tiny_run(CELL, traced=True)
    loop.setup()
    tracing.reset()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    window_s, _ = loop.window(0.0)
    prof.stop()
    out = span_report.report(loop, tr.collect(prof), list(prof.profiler.kineto_results.events()), tracing.records(),
                             window_s)
    loop.release()
    (stack,) = out["per_stack"]
    assert out["stacks"] == 1 and stack["spans"] == out["records"] >= 30
    assert out["idle_s"] == pytest.approx(out["window_trace_s"])
    assert 0.0 < out["idle_below_top_share"] <= 1.0
    assert out["range_offsets"]["matched"] == out["records"] and out["range_offsets"]["worst_s"] < 1e-3
    assert stack["stages"]["search"]["counts"]["rows.listed"] == len(loop.records[0]["raw"]["x"])
