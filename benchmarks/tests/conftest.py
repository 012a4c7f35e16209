"""Shared pieces of the benchmark's own tests: the ``gpu`` marker, a fixture
that skips without a card, the cells cut to a size the CPU runs in
seconds (the same configurations, limits and traffic keys, smaller
stacks and grids), and a stand-in loop for ``run.measure``."""

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
    bench, cell, config, traffic = tiny_cell(name)
    return bench, cell, bench_run.loop_class(traffic)(cell, config, traffic, seed, "cpu", traced=traced)


class StandIn:
    """A loop that does no work: its window takes 2 s for 3 stacks."""

    def __init__(self, failed=0, numbers=None):
        self.device = torch.device("cpu")
        self.records, self.failed, self.evals = [], failed, 1000
        self.settings, self.traffic = {}, {"limits": {"gap": 1.0}}
        self._numbers = numbers or {"gap": 0.5}

    def setup(self):
        pass

    def window(self, seconds):
        self.records = [{} for _ in range(3)]
        return 2.0, 3 + self.failed

    def end_to_end(self, window_s):
        return {"stack_evals_per_s": self.evals * len(self.records) / window_s}

    def stack_summary(self):
        return {}

    def memory_peak(self):
        return 0

    def release(self):
        pass

    def reference_stacks(self):
        return None

    def numbers(self, refs):
        return self._numbers
