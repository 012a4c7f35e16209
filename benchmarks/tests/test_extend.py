"""A later change adds a cell, a configuration and a per-layer metric as
new files and new BENCHMARK.json entries, editing no file that is there
and adding no end-to-end metric: shown on a temporary copy."""

import json
import shutil

from benchmarks import run as bench_run
from benchmarks.tests.conftest import StandIn


def test_add_a_cell_a_configuration_and_a_metric(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(bench_run.ROOT / "benchmarks", root / "benchmarks", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(bench_run.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (root / "benchmarks").rglob("*") if p.is_file()}

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

    after = {p: p.read_bytes() for p in before}
    assert after == before  # no file that was there changed
    written, original = (json.loads((r / "BENCHMARK.json").read_text()) for r in (root, bench_run.ROOT))
    assert written["end_to_end"] == original["end_to_end"]  # no end-to-end metric added
    _, cell, config, traffic = bench_run.load_cell("survey_float.band256", root=root)
    assert config["search"]["encode_num_bytes"] == -1 and traffic["grid"]["velocities"][2] == 65
    assert bench_run.loop_class(traffic).__name__ == "StackSearchCell"
    ctx = type("Ctx", (), {"records": [{"timings": {"psi_phi_ms": 500.0}}] * 3})()
    got = bench_run.per_layer_metrics(bench, "survey_float.band256", ctx, root=root)
    assert got == {"stacks_per_window": {"value": 3, "unit": "stacks"}, "build_s.survey_float.band256": {"value": 0.5, "unit": "s"}}
    # The new cell reports the throughput and the set-up time with no end-to-end entry of its own.
    result = bench_run.measure(StandIn(), bench, cell, 2.0, False)
    assert set(result["metrics"]) == {"stack_evals_per_s", "setup_s"} and result["correct"]
