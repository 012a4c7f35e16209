"""BENCHMARK.json against the benchmark's contract, and every file a cell,
configuration, loop or metric needs found by its name. Each check is a
function of a checkout's root and its BENCHMARK.json, so that
``test_extend.py`` runs them on a copy with files and entries added."""

import inspect
import json
import re

import pytest

from benchmarks import run as bench_run

ROOT = bench_run.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves", "workloads"}
KINDS = ("configs", "workloads", "end_to_end", "per_layer")
# What run.measure, benchmarks.control and benchmarks.faults call on a
# loop's Cell, and what they read of it once it is constructed.
CELL_METHODS = ("setup", "window", "end_to_end", "memory_peak", "release", "reference_stacks", "numbers",
                "stack_summary")
CELL_ATTRIBUTES = ("records", "failed", "evals", "settings", "traffic", "device")


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def check_top_level_keys_and_sizes(root, bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len((root / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16 and all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) for p in bench["paths"])
    assert len(bench["command"]) <= 32 and all(_line(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51


def check_run_seconds_fits_a_full_check_at_24_cells(root, bench):
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def check_names_are_unique_and_well_formed(root, bench, kinds=KINDS):
    for kind in kinds:
        names = [e["name"] for e in bench[kind]]
        assert len(names) == len(set(names)), kind
        assert all(NAME.match(n) for n in names), kind


def check_configs(root, bench):
    used = {w["config"] for w in bench["workloads"]}
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmarks/") and (root / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        data = json.loads((root / c["file"]).read_text())
        assert data["reduced"] == c["reduced"] and "source" in data and "assumed" in data


def check_workloads_find_their_files_and_limits(root, bench):
    pairs = set()
    four = 0
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and _line(w["why"])
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
        four += w["chips"] == 4
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        _, cell, config, traffic = bench_run.load_cell(w["name"], root=root)
        assert all(isinstance(v, (int, float)) and v >= 0 for v in traffic["limits"].values())
    assert four <= max(1, len(bench["workloads"]) // 4)


def check_loops(root, bench):
    """Each cell's loop module lies under ``benchmarks/loops/`` and declares
    what the harness asks of it: ``Cell`` with every method and attribute
    that run.measure, benchmarks.control and benchmarks.faults use,
    ``NUMBERS`` (the traffic file limits exactly these), ``control_readings``
    and its faults."""
    for w in bench["workloads"]:
        _, cell, config, traffic = bench_run.load_cell(w["name"], root=root)
        loop = bench_run.loop_module(traffic)
        assert loop.__name__ == f"benchmarks.loops.{traffic['loop']}", loop.__name__
        assert (root / "benchmarks" / "loops" / f"{traffic['loop']}.py").is_file()
        assert isinstance(loop.NUMBERS, tuple) and len(set(loop.NUMBERS)) == len(loop.NUMBERS) > 0
        assert set(traffic["limits"]) == set(loop.NUMBERS), w["name"]
        assert callable(loop.control_readings) and list(inspect.signature(loop.control_readings).parameters)[:2] == [
            "run", "seconds"]
        assert loop.FAULTS and all(callable(f) for f in loop.FAULTS.values())
        assert all(callable(f) for f in loop.CELL_SIZE_FAULTS.values())
        assert not set(loop.FAULTS) & set(loop.CELL_SIZE_FAULTS)
        run = loop.Cell(cell, config, traffic, 2**31 + 1, "cpu")
        assert all(callable(getattr(run, m, None)) for m in CELL_METHODS), [m for m in CELL_METHODS if not hasattr(run, m)]
        assert all(hasattr(run, a) for a in CELL_ATTRIBUTES), [a for a in CELL_ATTRIBUTES if not hasattr(run, a)]
        assert "warm" in inspect.signature(run.setup).parameters  # control and faults set up with warm=False
        assert run.traffic["limits"] == traffic["limits"] and run.evals > 0


def check_metrics(root, bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) <= METRIC_KEYS | {"workloads"} and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= LAYER_KEYS and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m["workloads"]) <= cells
        assert callable(bench_run.reader(m["name"], root))
    shares = [m for m in bench["per_layer"] if bench_run.quantity(m["name"]).endswith("_roofline") or "mfu" in m["name"]]
    assert shares and all(m["unit"] == "%" for m in shares)  # split names read by their quantity
    reports = {m["name"]: set(m.get("workloads", cells)) for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= reports[m["moves"]]  # each cell reports what it moves
    for w in cells:
        assert any(w in m.get("workloads", cells) for m in bench["per_layer"])
        assert w in reports["setup_s"] and sum(w in r for r in reports.values()) >= 2


def check_throughput_is_one_metric_that_every_cell_reports(root, bench):
    throughput = [m for m in bench["end_to_end"] if m["name"] == "stack_evals_per_s"]
    assert len(throughput) == 1 and "workloads" not in throughput[0]


def check_each_cell_reports_one_throughput(root, bench):
    for w in bench["workloads"]:
        reported = [m["name"] for m in bench["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert [n for n in reported if bench_run.quantity(n) == "stack_evals_per_s"] == ["stack_evals_per_s"], w


CONTRACT = (check_top_level_keys_and_sizes, check_run_seconds_fits_a_full_check_at_24_cells,
            check_names_are_unique_and_well_formed, check_configs, check_workloads_find_their_files_and_limits,
            check_loops, check_metrics, check_throughput_is_one_metric_that_every_cell_reports,
            check_each_cell_reports_one_throughput)


def check_all(root, bench):
    for check in CONTRACT:
        check(root, bench)


def test_top_level_keys_and_sizes():
    check_top_level_keys_and_sizes(ROOT, BENCH)


def test_run_seconds_fits_a_full_check_at_24_cells():
    check_run_seconds_fits_a_full_check_at_24_cells(ROOT, BENCH)


@pytest.mark.parametrize("kind", KINDS)
def test_names_are_unique_and_well_formed(kind):
    check_names_are_unique_and_well_formed(ROOT, BENCH, (kind,))


def test_configs():
    check_configs(ROOT, BENCH)


def test_workloads_find_their_files_and_limits():
    check_workloads_find_their_files_and_limits(ROOT, BENCH)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_has_a_loop_that_declares_what_the_harness_asks(cell):
    check_loops(ROOT, dict(BENCH, workloads=[w for w in BENCH["workloads"] if w["name"] == cell]))


def test_the_stack_search_loop_compares_its_seven_numbers():
    """The stack-search cells' limits cover exactly these seven, so that no
    number leaves the comparison unnoticed."""
    from benchmarks.loops import stack_search

    assert stack_search.NUMBERS == ("search_lh_gap", "search_rank_gap", "rescore_gap", "obs_flips", "coadd_gap",
                                    "violations", "missed")
    for w in BENCH["workloads"]:
        _, _, _, traffic = bench_run.load_cell(w["name"])
        if traffic["loop"] == "stack_search":
            assert set(traffic["limits"]) == set(stack_search.NUMBERS)


def test_metrics():
    check_metrics(ROOT, BENCH)


def test_throughput_is_one_metric_that_every_cell_reports():
    """``stack_evals_per_s`` lists no cells, as ``setup_s`` does, so a cell
    added later reports it with no end-to-end entry of its own."""
    check_throughput_is_one_metric_that_every_cell_reports(ROOT, BENCH)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_one_throughput(cell):
    check_each_cell_reports_one_throughput(ROOT, dict(BENCH, workloads=[w for w in BENCH["workloads"]
                                                                         if w["name"] == cell]))
