"""The work counts against hand counts at tiny shapes, and the window's
arithmetic through ``run.measure`` with a stand-in loop."""

import itertools
import json
from types import SimpleNamespace

import numpy as np
import pytest

from benchmarks import generator
from benchmarks import run as bench_run
from benchmarks.tests.conftest import StandIn

GRID = {"name": "EclipticCenteredSearch", "velocities": [1.0, 4.0, 3], "angles": [-0.5, 0.5, 2],
        "angle_units": "radian", "given_ecliptic": 0.3}


def _traffic(times, sigmas=(1.0,)):
    return {"stack": {"height": 5, "width": 6, "times": times, "psf_sigmas": list(sigmas)}, "grid": GRID}


@pytest.mark.parametrize("buffer", [None, 2])
def test_evals_per_stack(buffer):
    settings = {"x_pixel_buffer": buffer, "y_pixel_buffer": buffer}
    extra = 2 * (buffer or 0)
    assert generator.evals_per_stack(settings, _traffic([0.0, 1.0])) == (6 + extra) * (5 + extra) * 6


def test_candidate_grid_is_angle_major():
    vxs, vys = generator.candidate_grid(GRID)
    angles = [0.3 - 0.5, 0.3 + 0.5]
    want = [(np.cos(a) * v, np.sin(a) * v) for a in angles for v in (1.0, 2.5, 4.0)]
    assert np.array_equal(vxs, np.float32([w[0] for w in want])) and np.array_equal(vys, np.float32([w[1] for w in want]))


@pytest.mark.parametrize("buffer", [None, 1])
def test_search_samples_against_a_loop(buffer):
    rooflines = pytest.importorskip("benchmarks.metrics.search_roofline")
    traffic = _traffic([0.0, 0.4, 1.1])
    settings = {"x_pixel_buffer": buffer, "y_pixel_buffer": buffer}
    vxs, vys = generator.candidate_grid(GRID)
    (x0, x1), (y0, y1) = generator.start_bounds(settings, 5, 6)
    count = 0
    for (vx, vy), t, x, y in itertools.product(zip(vxs, vys), [0.0, 0.4, 1.1], range(x0, x1), range(y0, y1)):
        px = x + int(np.floor(np.float64(vx) * t + 0.5))
        py = y + int(np.floor(np.float64(vy) * t + 0.5))
        count += 0 <= px < 6 and 0 <= py < 5
    assert rooflines.samples(traffic, settings) == count
    ops, nbytes, key = rooflines.work(traffic, dict(settings, encode_num_bytes=1, results_per_pixel=2))
    assert ops == 2 * count and key == "int8_ops"
    assert nbytes == 3 * 5 * 6 * 2 + 2 * (x1 - x0) * (y1 - y0) * 8
    _, nbytes, key = rooflines.work(traffic, dict(settings, encode_num_bytes=-1, results_per_pixel=2))
    assert key == "fp32_flops" and nbytes == 3 * 5 * 6 * 8 + 2 * (x1 - x0) * (y1 - y0) * 8


def test_build_work_by_hand():
    from benchmarks.metrics import build_roofline

    traffic = _traffic([0.0, 1.0, 2.0], sigmas=(1.0, 0.5))  # 7 x 7, 3 x 3, 7 x 7 kernels
    ops, nbytes = build_roofline.work(traffic, {"encode_num_bytes": 1})
    assert ops == 2 * 2 * (49 + 9 + 49) * 30 and nbytes == 3 * 30 * (8 + 2)
    assert build_roofline.work(traffic, {"encode_num_bytes": -1})[1] == 3 * 30 * 16


BENCH = json.loads((bench_run.ROOT / "BENCHMARK.json").read_text())
CELL = {"name": "regression_float.regression"}
E2E = "stack_evals_per_s"


def test_window_arithmetic():
    result = bench_run.measure(StandIn(), BENCH, CELL, 2.0, False)
    m = result["metrics"]
    assert set(m) == {E2E, "setup_s"}
    assert m[E2E]["value"] == 1000 * 3 / 2.0 and m[E2E]["unit"] == "evals/s"
    assert m["setup_s"]["value"] > 0
    assert result["correct"] and result["attempted"] == 3 and result["failed"] == 0
    assert list(result)[-1] == "checks" and result["checks"] == {"gap": {"value": 0.5, "limit": 1.0}}


@pytest.mark.parametrize("case", ["a stack failed", "a number past its limit", "a number without a limit"])
def test_window_that_is_not_correct(case):
    run = {"a stack failed": StandIn(failed=1), "a number past its limit": StandIn(numbers={"gap": 1.5}),
           "a number without a limit": StandIn(numbers={"gap": 0.5, "other": 0.0})}[case]
    result = bench_run.measure(run, BENCH, CELL, 2.0, False)
    assert result["correct"] is False


def test_spans_reader_arithmetic():
    ctx = SimpleNamespace(records=[{"spans": [("stack", 0.0, 5.0), ("build", 0.5, 1.5), ("search", 1.5, 4.0)],
                                    "timings": {"psi_phi_ms": 1000.0, "assemble_ms": 300.0}},
                                   {"spans": [("stack", 5.0, 9.0), ("build", 5.0, 6.0), ("search", 6.0, 8.0)],
                                    "timings": {"psi_phi_ms": 800.0, "assemble_ms": 100.0}}],
                          peak_bytes=3 * 2**30)
    assert bench_run.reader("results_path_s")(ctx) == pytest.approx((1.5 + 1.0) / 2)
    assert bench_run.reader("build_s")(ctx) == pytest.approx(0.9)
    assert bench_run.reader("assemble_s")(ctx) == pytest.approx(0.2)
    assert bench_run.reader("device_peak_gib")(ctx) == 3.0
    # A quantity split by cell reads through its quantity's file.
    assert bench_run.reader("build_s.regression_float.regression")(ctx) == pytest.approx(0.9)
