"""Each cell's code path on the CPU at a tiny size: the whole run (set-up,
window, judgement) comes out correct, traced and not, and leaves no module
of JAX or the JAX package loaded."""

import json
import subprocess
import sys

import pytest

from benchmarks import run as bench_run
from benchmarks.tests.conftest import tiny_run

CELLS = ["survey_u8.band256", "regression_float.regression"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_tiny_cell_is_correct(name, traced):
    bench, cell, run = tiny_run(name, traced=traced)
    result = bench_run.measure(run, bench, cell, 0.0, traced)
    bad = {k: v for k, v in result["checks"].items() if v["value"] > v["limit"]}
    assert result["correct"], bad
    assert result["attempted"] == 1 and len(run.records) == 1
    if traced:
        names = {m["name"] for m in bench["per_layer"]}
        assert {f"{q}.{name}" for q in ("results_path_s", "build_s", "assemble_s")} <= set(result["metrics"]) <= names
        assert f"search_roofline.{name}" not in result["metrics"]  # no device events on the CPU
        assert result["device"]["window_s"] > 0
    else:
        assert set(result["metrics"]) == {"stack_evals_per_s", "setup_s"}


@pytest.mark.parametrize("name", CELLS)
def test_no_jax_after_a_tiny_pass(name):
    """In a fresh interpreter, as a run is: a tiny pass of the cell, then the
    top-level names of every loaded module."""
    code = (
        "import json, sys\n"
        "from benchmarks import run as R\n"
        "from benchmarks.tests.conftest import tiny_run\n"
        f"bench, cell, run = tiny_run({name!r})\n"
        "result = R.measure(run, bench, cell, 0.0, False)\n"
        "print(json.dumps({'correct': result['correct'], 'found': R.forbidden_modules(),"
        " 'tops': sorted({m.split('.')[0] for m in sys.modules})}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=bench_run.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["found"] == [] and not {"jax", "jaxlib", "flax", "kbmod_tpu"} & set(line["tops"])
    assert "kbmod_tpu_torch" in line["tops"] and line["correct"]


def test_the_check_sees_a_loaded_jax_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "kbmod_tpu.search", object())
    assert bench_run.forbidden_modules() == ["kbmod_tpu"]


def test_the_command_refuses_to_run_without_a_card():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is here")
    out = subprocess.run([sys.executable, "-m", "benchmarks.run", "--workload", CELLS[1], "--seed", "5",
                          "--seconds", "1", "--trace", "0"], cwd=bench_run.ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
