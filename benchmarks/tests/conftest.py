"""Shared pieces of the benchmark's own tests: the ``gpu`` marker, a fixture
that skips without a card, and the cells cut to a size the CPU runs in
seconds (the same configurations, limits and traffic keys, smaller
stacks and grids)."""

import copy

import pytest
import torch

from benchmarks import generator
from benchmarks import run as bench_run


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips elsewhere")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: run on the card")
    return torch.device("cuda")


def tiny_cell(name):
    """(benchmark, cell, configuration, traffic) of a cell cut for the CPU."""
    bench, cell, config, traffic = bench_run.load_cell(name)
    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    stack = traffic["stack"]
    if name == "survey_u8.band256":
        stack.update(height=40, width=160, times={"linspace": [57130.0, 0.3, 10]})
        traffic["objects"]["random"].update(tiers=[[2, 350.0], [1, 220.0]], speed=[95.0, 140.0], min_separation=30.0)
        traffic["grid"].update(velocities=[92.0, 148.0, 5], angles=[-0.2, 0.2, 3])
    else:
        stack.update(height=128, width=96, times=stack["times"][:8])
        traffic["grid"].update(velocities=[10.0, 30.0, 5], angles=[traffic["grid"]["angles"][0], traffic["grid"]["angles"][1], 5])
        # Objects on grid points.
        vxs, vys = generator.candidate_grid(traffic["grid"])
        traffic["objects"]["fixed"] = [[x, y, float(vxs[c]), float(vys[c]), 500.0]
                                       for x, y, c in ((20, 110, 3), (70, 60, 12), (90, 120, 4))]
    config["height"], config["width"] = stack["height"], stack["width"]
    config["search"]["num_obs"] = 6  # below the few exposures, so sigma-G may clip one
    traffic["check"] = {"listed_pixels": 8, "any_pixels": 4}
    return bench, cell, config, traffic


def tiny_run(name, seed=2**31 + 11, traced=False):
    from benchmarks.loops.stack_search import StackSearchCell

    bench, cell, config, traffic = tiny_cell(name)
    return bench, cell, StackSearchCell(cell, config, traffic, seed, "cpu", traced=traced)
