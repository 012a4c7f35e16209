"""On the card: the command runs a short window of a cell and prints a
correct result line, traced and not. Run there with
``python -m pytest -m gpu benchmarks/tests/test_card.py``."""

import json
import subprocess
import sys

import pytest

from benchmarks import run as bench_run


CELL = "regression_float.regression"


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_short_window_on_the_card(card, trace):
    cmd = [sys.executable, "-m", "benchmarks.run", "--workload", CELL,
           "--seed", str(2**33 + trace), "--seconds", "3", "--trace", str(trace)]
    out = subprocess.run(cmd, cwd=bench_run.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        roofline = f"search_roofline.{CELL}"
        assert result["breakdown"]["device_ops"] and roofline in result["metrics"]
        assert result["metrics"][roofline]["value"] <= 100
    else:
        assert set(result["metrics"]) == {"stack_evals_per_s", "setup_s"}
