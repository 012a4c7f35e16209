"""The control (the reference one precision below the configuration's, in
the program's place) fails at least one of each tiny cell's limits, on
seeds where the program passes every one. ``python3 -m
benchmarks.control`` reads the same at the cells' own size on the card,
through the loop module's ``control_readings``."""

import types

import pytest
import torch

from benchmarks import control
from benchmarks import run as bench_run
from benchmarks.loops import stack_search
from benchmarks.tests.conftest import tiny_run

CELLS = ["survey_u8.band256", "regression_float.regression"]


@pytest.mark.parametrize("seed", [7, 2**31 + 3, 2**40 + 1])
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_passes(name, seed):
    _, _, run = tiny_run(name, seed=seed)
    program, ctl = stack_search.control_readings(run)
    limits = run.traffic["limits"]
    assert all(program[k] <= limits[k] for k in limits), program
    assert any(ctl[k] > limits[k] for k in limits), ctl


def test_control_precisions():
    assert stack_search.control_precision({"encode_num_bytes": 1}) == {"plane_bits": 4, "sci_dtype": torch.bfloat16}
    assert stack_search.control_precision({"encode_num_bytes": -1}) == {"plane_dtype": torch.bfloat16, "sci_dtype": torch.bfloat16}
    with pytest.raises(ValueError):
        stack_search.control_precision({"encode_num_bytes": 2})


def test_a_loop_without_a_control_is_refused(monkeypatch):
    bare = types.ModuleType("benchmarks.loops.bare")
    monkeypatch.setattr(bench_run, "loop_module", lambda traffic: bare)
    with pytest.raises(SystemExit, match="defines no control_readings"):
        control.main(["--workload", CELLS[1], "--seeds", "1", "--device", "cpu"])
