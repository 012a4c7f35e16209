"""BENCHMARK.json against the benchmark's contract, and every file a cell,
configuration or metric needs found by its name."""

import json
import re

import pytest

from benchmarks import run as bench_run
from benchmarks.loops.stack_search import StackSearchCell

ROOT = bench_run.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
NUMBERS = ("search_lh_gap", "search_rank_gap", "rescore_gap", "obs_flips", "coadd_gap", "violations", "missed")
METRIC_KEYS = {"name", "unit", "better", "source", "bound"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves", "workloads"}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_run_seconds_fits_a_full_check_at_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmarks/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"] and "source" in data and "assumed" in data


def test_workloads_find_their_files_and_limits():
    pairs = set()
    four = 0
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and _line(w["why"])
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
        four += w["chips"] == 4
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        _, cell, config, traffic = bench_run.load_cell(w["name"])
        assert bench_run.loop_class(traffic) is StackSearchCell
        assert set(traffic["limits"]) == set(NUMBERS)
        assert all(isinstance(v, (int, float)) and v >= 0 for v in traffic["limits"].values())
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= METRIC_KEYS | {"workloads"} and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= LAYER_KEYS and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m["workloads"]) <= cells
        assert callable(bench_run.reader(m["name"]))
    shares = [m for m in BENCH["per_layer"] if bench_run.quantity(m["name"]).endswith("_roofline") or "mfu" in m["name"]]
    assert shares and all(m["unit"] == "%" for m in shares)  # split names read by their quantity
    reports = {m["name"]: set(m.get("workloads", cells)) for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= reports[m["moves"]]  # each cell reports what it moves
    for w in cells:
        assert any(w in m.get("workloads", cells) for m in BENCH["per_layer"])
        assert w in reports["setup_s"] and sum(w in r for r in reports.values()) >= 2


def test_throughput_is_one_metric_that_every_cell_reports():
    """``stack_evals_per_s`` lists no cells, as ``setup_s`` does, so a cell
    added later reports it with no end-to-end entry of its own."""
    throughput = [m for m in BENCH["end_to_end"] if m["name"] == "stack_evals_per_s"]
    assert len(throughput) == 1 and "workloads" not in throughput[0]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_one_throughput(cell):
    reported = [m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])]
    assert [n for n in reported if bench_run.quantity(n) == "stack_evals_per_s"] == ["stack_evals_per_s"]
