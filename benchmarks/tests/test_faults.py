"""A whole run of each tiny cell with the timed path broken underneath, past
the look for a card: each fault a cell can have makes ``correct`` false.
(One card a cell: no exchange between cards to leave out.)"""

import pytest
import torch

from benchmarks import run as bench_run
from benchmarks.loops.stack_search import FAULTS
from benchmarks.tests.conftest import tiny_run

CELLS = ["survey_u8.band256", "regression_float.regression"]


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_fault_makes_correct_false(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    bench, cell, run = tiny_run(name)
    try:
        result = bench_run.measure(run, bench, cell, 0.0, False)
    except ValueError as exc:
        # The program raises writing a results file with no rows and stamp
        # columns (its table writer), so a fault that leaves no row ends the
        # run with no result, which counts as failed.
        assert "reshape" in str(exc)
        return
    failing = [k for k, v in result["checks"].items() if v["value"] > v["limit"]]
    assert result["correct"] is False and failing, result["checks"]


def test_the_sound_run_beside_them_is_correct():
    bench, cell, run = tiny_run(CELLS[1])
    assert bench_run.measure(run, bench, cell, 0.0, False)["correct"]
    assert torch.cuda.is_available() or run.device.type == "cpu"


def test_the_patcher_puts_back_what_it_planted():
    from benchmarks import faults
    from kbmod_tpu_torch import run_search

    before = run_search.apply_clustering
    patcher = faults.Patcher()
    FAULTS["clustering left out"](patcher)
    assert run_search.apply_clustering is not before
    patcher.undo()
    assert run_search.apply_clustering is before
