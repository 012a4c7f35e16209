"""The port's tracer (``kbmod_tpu_torch.tracing``): spans and counters kept
while a torch profiler runs, on the profiler's clock, and nothing at all
while none does; the stage timings and phase times it serves; the spans
and counters of a whole pipeline run on the CPU, float and uint8."""

import collections
import glob
import json
import os
import pathlib
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kbmod_tpu_torch import tracing
from kbmod_tpu_torch.configuration import SearchConfiguration
from kbmod_tpu_torch.fake_data.fake_data_creator import FakeDataSet, create_fake_times
from kbmod_tpu_torch.ops import _build
from kbmod_tpu_torch.ops import search as search_ops
from kbmod_tpu_torch.run_search import SearchRunner
from kbmod_tpu_torch.search import StackSearch, Trajectory

PORT = pathlib.Path(tracing.__file__).resolve().parent
GENERATOR = {"name": "KBMODV1SearchConfig", "v_arr": [2.0, 6.0, 7], "ang_arr": [0.6, 0.2, 7], "average_angle": 0.0}
BASE = dict(generator_config=GENERATOR, num_obs=5, lh_level=2.0, near_dup_thresh=3, cluster_eps=1.5, save_config=False)


@pytest.fixture(autouse=True)
def clean_tracer():
    tracing.reset()
    yield
    tracing.reset()


def _profiler():
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    return prof


def _ranges(prof):
    return [ev for ev in prof.profiler.kineto_results.events() if ev.name().startswith(tracing.PREFIX)]


def _stack():
    times = create_fake_times(10, t0=57130.2, obs_per_day=2, intra_night_gap=0.05)
    ds = FakeDataSet(48, 40, times, psf_val=1.0, mask_fraction=0.03, use_seed=7)
    ds.insert_object(Trajectory(x=17, y=21, vx=4.0, vy=-1.5, flux=300.0))
    return ds.stack_py


def test_nesting_and_parent_ids():
    prof = _profiler()
    try:
        with tracing.span("a"):
            with tracing.span("b"):
                with tracing.span("c"):
                    pass
            with tracing.span("d"):
                pass
        with tracing.span("e"):
            pass
    finally:
        prof.stop()
    by = {r.name: r for r in tracing.records()}
    assert [r.name for r in tracing.records()] == ["c", "b", "d", "a", "e"]  # added as they end
    assert by["a"].parent == 0 and by["e"].parent == 0
    assert by["b"].parent == by["a"].id and by["d"].parent == by["a"].id and by["c"].parent == by["b"].id
    assert len({r.id for r in by.values()}) == 5
    assert all(r.start <= r.end for r in by.values())
    assert by["a"].start <= by["b"].start <= by["c"].end <= by["b"].end <= by["d"].start <= by["a"].end <= by["e"].start


def test_off_keeps_nothing_and_opens_no_range():
    assert not tracing.enabled()
    held = tracing.span("held open")
    held.__enter__()
    with tracing.span("off") as sp:
        tracing.count("rows.listed", 5)
    assert sp is tracing.span("another")  # one shared do-nothing span
    prof = _profiler()
    try:
        torch.ones(4).sum()
        held.__exit__(None, None, None)
    finally:
        prof.stop()
    assert tracing.records() == [] and tracing.totals() == {}
    assert _ranges(prof) == []


def test_records_sit_on_the_profilers_clock():
    prof = _profiler()
    try:
        for i in range(5):
            with tracing.span(f"s{i}"):
                with tracing.span("inner"):
                    torch.ones(64).cumsum(0)
                time.sleep(0.002)
    finally:
        prof.stop()
    recs = tracing.records()
    ranges = [ev for ev in _ranges(prof) if ev.device_type() == torch.autograd.DeviceType.CPU]
    assert len(ranges) == len(recs) == 10
    starts = collections.defaultdict(list)
    for ev in ranges:
        starts[ev.name()[len(tracing.PREFIX):]].append(ev.start_ns())
    for r in recs:
        assert min(abs(s - r.unix_ns) for s in starts[r.name]) < 1_000_000, r


def test_counts_attach_to_the_innermost_span():
    prof = _profiler()
    try:
        tracing.count("bytes.h2d", 7)  # no span open: the totals only
        with tracing.span("outer"):
            tracing.count("rows.listed", 3)
            with tracing.span("inner"):
                tracing.count("rows.listed", 2)
                tracing.count("bytes.h2d")
    finally:
        prof.stop()
    by = {r.name: r for r in tracing.records()}
    assert by["inner"].counts == {"rows.listed": 2, "bytes.h2d": 1}
    assert by["outer"].counts == {"rows.listed": 3}
    assert tracing.totals() == {"bytes.h2d": 8, "rows.listed": 5}
    tracing.reset()
    assert tracing.records() == [] and tracing.totals() == {}


@pytest.mark.parametrize("traced", [False, True])
def test_a_span_writes_its_milliseconds_on_and_off(traced):
    timings = {}
    prof = _profiler() if traced else None
    try:
        t0 = time.perf_counter()
        with tracing.span("stage", into=timings, key="stage_ms", sync=torch.device("cpu")):
            time.sleep(0.01)
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        if prof is not None:
            prof.stop()
    assert 10.0 <= timings["stage_ms"] <= wall
    assert len(tracing.records()) == int(traced)


def test_records_are_bounded(monkeypatch):
    monkeypatch.setattr(tracing, "_records", collections.deque(maxlen=3))
    prof = _profiler()
    try:
        for i in range(5):
            with tracing.span(f"s{i}"):
                pass
    finally:
        prof.stop()
    assert [r.name for r in tracing.records()] == ["s2", "s3", "s4"]


def test_stages_count_self_seconds():
    R = tracing.Record
    recs = [R("child", 2, 1, 1.0, 2.0, 0, {"rows.listed": 4}), R("child", 3, 1, 1.5, 3.0, 0, {"rows.listed": 1}),
            R("parent", 1, 0, 0.0, 4.0, 0, {}), R("parent", 4, 0, 5.0, 6.0, 0, {"bytes.h2d": 8})]
    st = tracing.stages(recs)
    assert st["parent"]["count"] == 2 and st["parent"]["seconds"] == pytest.approx(5.0)
    assert st["parent"]["self_seconds"] == pytest.approx(3.0)  # 4 s less the children's union of 2 s, plus 1 s
    assert st["child"] == {"count": 2, "seconds": pytest.approx(2.5), "self_seconds": pytest.approx(2.5),
                           "counts": {"rows.listed": 5}}


def test_one_place_opens_profiler_ranges():
    users = sorted(str(p.relative_to(PORT)) for p in PORT.rglob("*.py") if "record_function" in p.read_text())
    assert users == ["tracing.py"]


def test_stack_search_timings_keep_their_keys():
    st = _stack()
    search = StackSearch(st.sci, st.var, st.psfs, st.zeroed_times, device="cpu")
    assert set(search.timings) == {"psi_phi_ms"}
    search.search_all([Trajectory(vx=4.0, vy=-1.5), Trajectory(vx=1.0, vy=0.0)], True)
    assert set(search.timings) == {"psi_phi_ms", "search_ms", "assemble_ms"}
    assert all(v > 0 for v in search.timings.values())


def test_phase_times_keep_their_api_on_the_monotonic_clock():
    runner = SearchRunner(device="cpu")
    before = time.time()
    runner.run_search(SearchConfiguration(dict(BASE, do_clustering=False)), _stack())
    after = time.time()
    times = runner.phase_times
    assert set(runner.phase_memory) == set(times) >= {"KBMOD", "do_core_search", "grid search",
                                                       "load_and_filter_results", "write results"}
    for start, end in times.values():
        assert isinstance(start, float) and before - 1.0 <= start <= end <= after + 1.0
    assert times["KBMOD"][0] <= times["do_core_search"][0] <= times["grid search"][0] <= times["grid search"][1]
    assert times["grid search"][1] <= times["load_and_filter_results"][0] <= times["do_core_search"][1]
    assert times["do_core_search"][1] <= times["write results"][0] <= times["KBMOD"][1]
    assert runner._phase_spans == {}


def test_a_failing_run_closes_its_phases(monkeypatch):
    def fail(*args, **kwargs):
        raise RuntimeError("planted")

    monkeypatch.setattr(search_ops, "core_search", fail)
    runner = SearchRunner(device="cpu")
    prof = _profiler()
    try:
        with pytest.raises(RuntimeError, match="planted"):
            runner.run_search(SearchConfiguration(dict(BASE)), _stack())
        with tracing.span("after"):
            pass
    finally:
        prof.stop()
    by = {r.name: r for r in tracing.records()}
    assert {"KBMOD", "do_core_search", "grid search", "search"} <= set(by)
    assert by["after"].parent == 0 and runner._phase_spans == {}


SPANS = {"runner.qa", "runner.memory_check", "KBMOD", "do_core_search", "grid search", "build", "build.stage",
         "build.upload", "build.conv", "build.encode", "search", "search.offsets", "search.topk", "search.fetch",
         "search.assemble", "search.list", "load_and_filter_results", "near duplicate removal", "results.batch",
         "results.curves", "results.sigmag", "results.filter", "results.extend", "clustering", "stamp generation",
         "appending co-adds", "write results"}
COUNTERS = {"rows.listed", "rows.searched", "rows.near_dup", "rows.sigmag", "rows.final", "bytes.h2d", "bytes.d2h"}
CASES = {
    "float": (dict(), 1, {"route.float"}, set()),
    # gpu_filter: the in-search sigma-G pool, re-ranked in the assembly.
    "uint8": (dict(encode_num_bytes=1, gpu_filter=True), 2, {"route.grouped"},
              {"build.scale", "search.plan", "search.rerank"}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_profiled_run_has_every_stage(case, tmp_path, monkeypatch):
    """A run under KB_PROFILE_DIR: its Chrome trace and stage file, every
    span of the pipeline and the build, and the counters equal to what the
    run did."""
    extra, passes, more_counters, more_spans = CASES[case]
    listed = []

    def core_search(*args, **kwargs):
        out = core(*args, **kwargs)
        listed.append(len(out["x"]))
        return out

    core = search_ops.core_search
    monkeypatch.setattr(search_ops, "core_search", core_search)
    monkeypatch.setenv("KB_PROFILE_DIR", str(tmp_path))
    stack = _stack()
    keep = SearchRunner(device="cpu").run_search(SearchConfiguration(dict(BASE, **extra)), stack)
    assert not tracing.enabled()

    (trace,) = glob.glob(os.path.join(tmp_path, "kbmod_trace_*.json"))
    (stage_file,) = glob.glob(os.path.join(tmp_path, "kbmod_stages_*.json"))
    with open(stage_file) as f:
        stages = json.load(f)
    assert SPANS | more_spans <= set(stages)
    assert stages["KBMOD"]["count"] == 1 and stages["KBMOD"]["self_seconds"] <= stages["KBMOD"]["seconds"]
    with open(trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {tracing.PREFIX + s for s in SPANS} <= names

    totals = tracing.totals()
    assert COUNTERS | more_counters <= set(totals)
    if case == "uint8":  # a plan cache hits where an earlier search planned the same grid
        assert {p for k in totals if k.startswith("cache.") for p in [k.rsplit(".", 1)[0]]} == {"cache.dedup",
                                                                                                "cache.group"}
    assert totals["rows.listed"] == sum(listed) and len(listed) == 1
    assert totals["rows.final"] == len(keep)
    T, (H, W) = len(stack.sci), np.shape(stack.sci[0])
    assert totals["bytes.h2d"] == passes * 2 * T * H * W * 4
    by_id = {r.id: r for r in tracing.records()}
    (upload,) = {by_id[r.parent].name for r in tracing.records() if r.name == "build.upload"}
    assert upload == "build"
    (topk,) = [r for r in tracing.records() if r.name == "search.topk"]
    assert by_id[topk.parent].name == "search" and by_id[by_id[topk.parent].parent].name == "grid search"


def test_a_compile_is_counted(tmp_path, monkeypatch):
    """``native.build`` counts each nvcc run (a stand-in compiler here)."""
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\ntouch "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    prof = _profiler()
    try:
        _build.build(["psi_phi_conv", "search_topk"])
        _build.build(["psi_phi_conv"])  # built already: no compile
    finally:
        prof.stop()
    assert tracing.totals() == {"native.build": 2}
