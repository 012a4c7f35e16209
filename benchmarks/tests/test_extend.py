"""A later change adds a cell, a configuration, a per-layer metric, or a
whole new loop, as new files and new BENCHMARK.json entries, editing no
file that is there and adding no end-to-end metric: shown on a temporary
copy, which the benchmark's contract checks as it checks the repository."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

from benchmarks import run as bench_run
from benchmarks.tests.conftest import StandIn
from benchmarks.tests.test_contract import check_all


def _copy(tmp_path):
    """A checkout of the benchmark alone, and the bytes of each of its files."""
    root = tmp_path / "checkout"
    shutil.copytree(bench_run.ROOT / "benchmarks", root / "benchmarks", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(bench_run.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root, {p: p.read_bytes() for p in (root / "benchmarks").rglob("*") if p.is_file()}


def _nothing_edited(root, before):
    assert {p: p.read_bytes() for p in before} == before  # no file that was there changed
    written, original = (json.loads((r / "BENCHMARK.json").read_text()) for r in (root, bench_run.ROOT))
    assert written["end_to_end"] == original["end_to_end"]  # no end-to-end metric added


def test_add_a_cell_a_configuration_and_a_metric(tmp_path):
    root, before = _copy(tmp_path)

    config = json.loads((root / "benchmarks/configs/survey_u8.json").read_text())
    config["search"]["encode_num_bytes"] = -1
    config["reduced"] = []
    (root / "benchmarks/configs/survey_float.json").write_text(json.dumps(config))
    traffic = json.loads((root / "benchmarks/traffic/survey_u8.band256.json").read_text())
    traffic["grid"]["velocities"][2] = 65
    (root / "benchmarks/traffic/survey_float.band256.json").write_text(json.dumps(traffic))
    (root / "benchmarks/metrics/stacks_per_window.py").write_text(
        '"""stacks_per_window: stacks completed in the window."""\n\n\ndef read(ctx):\n    return len(ctx.records)\n')

    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "survey_float", "source": "https://example.org/config", "reduced": [],
                             "file": "benchmarks/configs/survey_float.json", "why": "float planes on the band"})
    bench["workloads"].append({"name": "survey_float.band256", "config": "survey_float", "traffic": "band256",
                               "chips": 1, "why": "the band searched as float planes"})
    # A new reader, and a quantity split by cell that reads through its quantity's file.
    for name, unit in (("stacks_per_window", "stacks"), ("build_s.survey_float.band256", "s")):
        bench["per_layer"].append({"name": name, "unit": unit, "better": "lower", "source": "host_clock",
                                   "layer": "pipeline", "moves": "stack_evals_per_s",
                                   "workloads": ["survey_float.band256"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    _nothing_edited(root, before)
    check_all(root, bench)
    _, cell, config, traffic = bench_run.load_cell("survey_float.band256", root=root)
    assert config["search"]["encode_num_bytes"] == -1 and traffic["grid"]["velocities"][2] == 65
    assert bench_run.loop_class(traffic).__name__ == "StackSearchCell"
    ctx = type("Ctx", (), {"records": [{"timings": {"psi_phi_ms": 500.0}}] * 3})()
    got = bench_run.per_layer_metrics(bench, "survey_float.band256", ctx, root=root)
    assert got == {"stacks_per_window": {"value": 3, "unit": "stacks"}, "build_s.survey_float.band256": {"value": 0.5, "unit": "s"}}
    # The new cell reports the throughput and the set-up time with no end-to-end entry of its own.
    result = bench_run.measure(StandIn(), bench, cell, 2.0, False)
    assert set(result["metrics"]) == {"stack_evals_per_s", "setup_s"} and result["correct"]


# A loop of its own: sums of seeded float32 rows, judged against float64
# sums. Its control sums in float16; its fault drops every other row.
TALLY = '''"""A loop that sums seeded rows: the window sums them in float32, the
reference in float64."""

import contextlib
import time

import numpy as np
import torch

from benchmarks.trace import SPAN_PREFIX

NUMBERS = ("sum_gap", "lost_rows")
ROWS, WIDTH = 64, 256


def rows(seed, dtype):
    return np.random.default_rng(seed).standard_normal((ROWS, WIDTH)).astype(dtype)


class TallyCell:
    def __init__(self, cell, config, traffic, seed, device, traced=False):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.device, self.traced = int(seed), torch.device(device), traced
        self.settings = dict(config["settings"])
        self.evals = ROWS * WIDTH
        self.records, self.failed = [], 0

    def sums(self, data):
        return data.sum(axis=1)

    def setup(self, warm=True):
        self.data = rows(self.seed, self.settings["dtype"])
        if warm:
            self.sums(self.data)

    def window(self, seconds):
        span = torch.profiler.record_function(SPAN_PREFIX + "window") if self.traced else contextlib.nullcontext()
        t0 = time.perf_counter()
        with span:
            while True:
                self.records.append({"sums": self.sums(self.data)})
                t1 = time.perf_counter()
                if t1 - t0 >= seconds:
                    break
        return t1 - t0, len(self.records)

    def end_to_end(self, window_s):
        return {"stack_evals_per_s": self.evals * len(self.records) / window_s}

    def stack_summary(self):
        return {"rows": [len(r["sums"]) for r in self.records]}

    def memory_peak(self):
        return 0

    def release(self):
        self.data = None

    def reference_stacks(self):
        return rows(self.seed, np.float64).sum(axis=1)

    def numbers(self, refs, records=None):
        gap, lost = 0.0, 0
        for record in self.records if records is None else records:
            got = record["sums"]
            lost = max(lost, len(refs) - len(got))
            n = min(len(got), len(refs))
            gap = max(gap, float(np.max(np.abs(got[:n] - refs[:n]) / np.maximum(np.abs(refs[:n]), 1.0))))
        return {"sum_gap": gap, "lost_rows": lost}


Cell = TallyCell


def control_readings(run, seconds=0.0):
    run.setup(warm=False)
    run.window(seconds)
    run.release()
    refs = run.reference_stacks()
    low = rows(run.seed, np.float64).astype(np.float16).sum(axis=1, dtype=np.float16)
    return run.numbers(refs), run.numbers(refs, records=[{"sums": low}])


def _every_other_row_dropped(monkeypatch):
    sums = TallyCell.sums
    monkeypatch.setattr(TallyCell, "sums", lambda self, data: sums(self, data[::2]))


FAULTS = {"every other row dropped": _every_other_row_dropped}
CELL_SIZE_FAULTS = {}
'''

DRIVE = '''import contextlib, io, json, sys
from pathlib import Path

from benchmarks import control, faults
from benchmarks import run as R
from benchmarks.tests.test_contract import check_all

bench = json.loads(Path("BENCHMARK.json").read_text())
check_all(Path(".").resolve(), bench)
_, cell, config, traffic = R.load_cell("tally.rows64")
out = {"loop": R.loop_module(traffic).__file__}
for traced in (False, True):
    run = R.loop_class(traffic)(cell, config, traffic, 2**31 + 5, "cpu", traced=traced)
    out[f"traced={traced}"] = R.measure(run, bench, cell, 0.2, traced)
for name, main in (("control", control.main), ("faults", faults.main)):
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        main(["--workload", "tally.rows64", "--seeds", "7"] + (["--device", "cpu"] if name == "control" else []))
    out[name] = [json.loads(line) for line in text.getvalue().splitlines()]
print(json.dumps(out))
'''


def test_add_a_cell_on_a_new_loop(tmp_path):
    root, before = _copy(tmp_path)
    (root / "benchmarks/loops/tally.py").write_text(TALLY)
    (root / "benchmarks/configs/tally.json").write_text(json.dumps(
        {"source": "https://example.org/tally", "reduced": [], "assumed": [], "settings": {"dtype": "float32"}}))
    (root / "benchmarks/traffic/tally.rows64.json").write_text(json.dumps(
        {"why": "64 seeded rows summed", "loop": "tally", "limits": {"sum_gap": 1e-5, "lost_rows": 0}}))
    (root / "benchmarks/metrics/rows_summed.py").write_text(
        '"""rows_summed: rows summed per pass."""\n\n\ndef read(ctx):\n'
        '    return len(ctx.records[0]["sums"]) if ctx.records else None\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tally", "source": "https://example.org/tally", "reduced": [],
                             "file": "benchmarks/configs/tally.json", "why": "seeded rows"})
    bench["workloads"].append({"name": "tally.rows64", "config": "tally", "traffic": "rows64", "chips": 1,
                               "why": "a loop of its own, with its own numbers, control and fault"})
    bench["per_layer"].append({"name": "rows_summed.tally.rows64", "unit": "rows", "better": "higher",
                               "source": "program_counter", "layer": "tally", "moves": "stack_evals_per_s",
                               "workloads": ["tally.rows64"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    _nothing_edited(root, before)

    # The copy's own harness, run from its root, finds the loop by the traffic file's name.
    out = subprocess.run([sys.executable, "-c", DRIVE], cwd=root, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert Path(got["loop"]).resolve() == (root / "benchmarks/loops/tally.py").resolve()
    plain, traced = got["traced=False"], got["traced=True"]
    assert set(plain["metrics"]) == {"stack_evals_per_s", "setup_s"} and plain["correct"]
    assert set(plain["checks"]) == {"sum_gap", "lost_rows"} and plain["checks"]["lost_rows"] == {"value": 0, "limit": 0}
    assert traced["correct"] and traced["metrics"] == {"rows_summed.tally.rows64": {"value": 64, "unit": "rows"}}
    (line,) = got["control"]
    assert line["program"]["sum_gap"] <= 1e-5 < line["control"]["sum_gap"]  # the control fails, the program passes
    (line,) = got["faults"]
    assert line["fault"] == "every other row dropped" and line["program"]["lost_rows"] == 32
