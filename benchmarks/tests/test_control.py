"""The control (the reference one precision below the configuration's, in
the program's place) fails at least one of each tiny cell's limits, on
seeds where the program passes every one. ``python3 -m
benchmarks.control`` reads the same at the cells' own size on the card."""

import pytest
import torch

from benchmarks import control
from benchmarks.tests.conftest import tiny_run

CELLS = ["survey_u8.band256", "regression_float.regression"]


@pytest.mark.parametrize("seed", [7, 2**31 + 3, 2**40 + 1])
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_passes(name, seed):
    _, _, run = tiny_run(name, seed=seed)
    program, ctl = control.readings(run)
    limits = run.traffic["limits"]
    assert all(program[k] <= limits[k] for k in limits), program
    assert any(ctl[k] > limits[k] for k in limits), ctl


def test_control_precisions():
    assert control.control_precision({"encode_num_bytes": 1}) == {"plane_bits": 4, "sci_dtype": torch.bfloat16}
    assert control.control_precision({"encode_num_bytes": -1}) == {"plane_dtype": torch.bfloat16, "sci_dtype": torch.bfloat16}
    with pytest.raises(ValueError):
        control.control_precision({"encode_num_bytes": 2})
