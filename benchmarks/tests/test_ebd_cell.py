"""The reflex-corrected WorkUnit cell on the CPU at a tiny size
(``ebd_cases.tiny_cell``): the whole run comes out correct, traced and
not, with no module of JAX or the JAX package loaded; the control (float32
coordinates, bfloat16 planes) fails at least one limit where the program
passes every one; each of the loop's faults makes ``correct`` false; and
the judge's own pieces: the reference's results path, the components of
its clustering, and the inputs it reads left as they were."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmarks import run as bench_run
from benchmarks.loops import ebd_search
from benchmarks.reference import ebd, judge
from benchmarks.tests.ebd_cases import CELL, tiny_run

QUANTITIES = ("reproject_s", "coords_s", "resample_s", "build_s", "load_results_s", "uploaded_gib")


@pytest.mark.parametrize("traced", [False, True])
def test_tiny_cell_is_correct(traced):
    bench, cell, run = tiny_run(traced=traced)
    result = bench_run.measure(run, bench, cell, 0.0, traced)
    bad = {k: v for k, v in result["checks"].items() if v["value"] > v["limit"]}
    assert result["correct"], bad
    assert set(result["checks"]) == set(ebd_search.NUMBERS)
    assert result["attempted"] == 1 and len(run.records) == 1
    (record,) = run.records
    assert len(record["layers"][0]) == 6 and len(record["ebd_wcs"]) > 6  # every exposure a mosaic
    if traced:
        assert {f"{q}.{CELL}" for q in QUANTITIES} <= set(result["metrics"])
        assert f"resample_roofline.{CELL}" not in result["metrics"]  # no device events on the CPU
    else:
        assert set(result["metrics"]) == {"stack_evals_per_s", "setup_s"}


@pytest.mark.parametrize("seed", [7, 2**31 + 3, 2**40 + 1])
def test_control_fails_where_the_program_passes(seed):
    _, _, run = tiny_run(seed=seed)
    program, control = ebd_search.control_readings(run)
    limits = run.traffic["limits"]
    assert all(program[k] <= limits[k] for k in limits), program
    assert any(control[k] > limits[k] for k in limits), control
    assert not all(control[k] > limits[k] for k in limits), control


@pytest.mark.parametrize("fault", list(ebd_search.FAULTS))
def test_a_fault_makes_correct_false(fault, monkeypatch):
    ebd_search.FAULTS[fault](monkeypatch)
    bench, cell, run = tiny_run()
    result = bench_run.measure(run, bench, cell, 0.0, False)
    failing = [k for k, v in result["checks"].items() if v["value"] > v["limit"]]
    assert result["correct"] is False and failing, result["checks"]


def test_no_jax_after_a_tiny_pass():
    code = (
        "import json, sys\n"
        "from benchmarks import run as R\n"
        "from benchmarks.tests.ebd_cases import tiny_run\n"
        "bench, cell, run = tiny_run()\n"
        "result = R.measure(run, bench, cell, 0.0, False)\n"
        "print(json.dumps({'correct': result['correct'], 'found': R.forbidden_modules()}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=bench_run.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line == {"correct": True, "found": []}


def test_the_traffic_and_the_configuration_agree():
    _, _, config, traffic = bench_run.load_cell(CELL)
    assert (config["patch_rows"], config["patch_columns"]) == (traffic["stack"]["height"], traffic["stack"]["width"])
    assert len(traffic["stack"]["times"]) == 100 and traffic["grid"]["given_ecliptic"] is not None
    # The grid and the objects are about the prograde ecliptic direction at
    # the patch's centre, as the reference computes it.
    spec = traffic["stack"]
    centre = (torch.tensor((spec["width"] - 1) / 2.0, dtype=torch.float64),
              torch.tensor((spec["height"] - 1) / 2.0, dtype=torch.float64))
    ecl = ebd.ecliptic_angle(ebd_search.common_tan(traffic), *centre)
    assert ecl == pytest.approx(traffic["grid"]["given_ecliptic"], abs=1e-6)
    lo, hi = traffic["objects"]["random"]["angle"]
    assert (lo + hi) / 2 == pytest.approx(ecl, abs=1e-6)
    with pytest.raises(ValueError, match="patch"):
        ebd_search.Cell({"name": CELL}, dict(config, patch_rows=64), traffic, 1, "cpu")


def test_the_reference_results_path_keeps_the_programs_final_rows():
    """``missed`` stands on the reference's results path: at this size it
    keeps the program's final rows, row for row, from the listed rows."""
    _, _, run = tiny_run()
    run.setup(warm=False)
    run.window(0.0)
    run.release()
    ref = run.reference_stacks()[0]
    (record,) = run.records
    kept = ebd_search.reference_rows(ref, record["raw"], run.settings)
    rows = lambda table: sorted(zip(*(np.asarray(table[k]).tolist() for k in ("x", "y", "vx", "vy"))))
    assert rows(kept) == rows(record["final"]) and len(kept["x"]) >= 1
    assert judge.missed_objects(kept, ref.objects, run.settings, ref.zeroed) == 0


def test_the_window_leaves_the_judged_arrays_as_they_were():
    """The judge reads the host arrays the window searched, so the program
    must not write into them."""
    _, _, run = tiny_run()
    run.setup(warm=False)
    before = [[a.copy() for a in unit.sci + unit.var] for unit in run.units]
    run.window(0.0)
    run.release()
    assert run.stacks is None and run.units is not None
    for unit, copies in zip(run.units, before):
        assert all(np.array_equal(a, b) for a, b in zip(unit.sci + unit.var, copies))


@pytest.mark.parametrize("n, eps", [(1, 1.0), (40, 3.0), (400, 6.0), (400, 12.0)])
def test_components_are_those_of_the_distance_graph(n, eps):
    points = np.random.default_rng(n).uniform(0.0, 40.0, size=(n, 4))
    got = ebd_search.components(points, eps, torch.device("cpu"))
    near = np.sqrt(((points[:, None] - points[None]) ** 2).sum(-1)) <= eps
    want = np.full(n, -1)
    for start in range(n):  # a breadth-first labelling by the smallest index
        if want[start] >= 0:
            continue
        want[start], todo = start, [start]
        while todo:
            for j in np.flatnonzero(near[todo.pop()] & (want < 0)):
                want[j] = start
                todo.append(j)
    assert np.array_equal(got, want)
