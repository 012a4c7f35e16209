"""The port's entry-point scripts (``kbmod_tpu_torch/scripts/``) against the
JAX package's (``scripts/``), on the CPU.

- Helpers: each port script keeps its own copy of the JAX script's numpy
  helpers; they are held equal, exactly, to the JAX script's, loaded by
  path (not as a package): ``default_grid``, ``make_objects``,
  ``inject_objects``, ``recovered``, the miss-rate script's
  ``build_stack``, and the snap class counts of each ``KB_SNAP_ROW_ERROR``
  against the JAX package's ``snap_vy_rows``. ``regression_tpu.py`` runs its pipeline when loaded, so
  its objects and cadence are taken out of the file with ``ast``.
- Mains: every script's ``main`` at a rehearsal size with ``--device cpu``
  (the kernels' plain twins), passing its own assertion; each defaults to
  CUDA and raises without a card.
- The pipeline gate's final rows at a rehearsal size equal the JAX
  package's runner's with the script's configuration on the same stack:
  x, y, vx, vy, obs_count and the order exactly, likelihood and flux within
  1e-5 * max(1, |value|) (ROADMAP Queue 3, the encoded routes).
- ``survey_full_grid`` resumes after a SIGKILL of its worker (a ``python
  -m`` child) with rows equal to an uninterrupted worker's.
"""

import ast
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from kbmod_tpu.configuration import SearchConfiguration as JConfig
from kbmod_tpu.core.image_stack_py import ImageStackPy as JImageStackPy
from kbmod_tpu.ops.search import snap_vy_rows as j_snap_vy_rows
from kbmod_tpu.run_search import SearchRunner as JSearchRunner

from kbmod_tpu_torch.results import Results as TResults
from kbmod_tpu_torch.scripts import (
    _common, coadd_bench, e2e, long_t, prewarm, psi_phi_bench, regression, scale_gate, sigmag_miss_rate, snap_sweep,
    steady_state, survey_full_grid, survey_pipeline_gate, survey_scale, twin_forms,
)

REPO = Path(__file__).resolve().parents[1]
JAX_SCRIPTS = REPO / "scripts"
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs: the suite runs several
    workers on the host's cores, and PyTorch's default of one thread a core
    each oversubscribes them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _load_jax_script(name, monkeypatch, **env):
    """A JAX script as a fresh module (its module-level sizes read from
    ``env``), loaded from its file; sys.path is restored after the test."""
    for key, value in env.items():
        monkeypatch.setenv(key, str(value))
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", JAX_SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ----------------------------------------------------------------------
# Helpers against the JAX scripts'
# ----------------------------------------------------------------------

def test_default_grid_matches_jax(monkeypatch):
    ref = _load_jax_script("survey_full_grid", monkeypatch)
    want, got = ref.default_grid(), _common.default_grid()
    assert len(got[0]) == 257 * 129
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hw", [512, 4096])
def test_make_objects_matches_jax(monkeypatch, hw):
    ref = _load_jax_script("survey_pipeline_gate", monkeypatch, KB_GATE_HW=hw)
    assert ref.CLUSTER_EPS == survey_pipeline_gate.cluster_eps(hw)
    want = ref.make_objects(np.random.default_rng(17))
    got = survey_pipeline_gate.make_objects(np.random.default_rng(17), hw)
    assert len(got) == 20 and got == want


def test_inject_objects_matches_jax(monkeypatch):
    hw, T = 512, 6
    ref = _load_jax_script("survey_pipeline_gate", monkeypatch, KB_GATE_HW=hw)
    objects = ref.make_objects(np.random.default_rng(17))
    zeroed = np.linspace(0.0, survey_pipeline_gate.SPAN_DAYS, T)
    psf = np.outer(np.hanning(5), np.hanning(5)).astype(np.float32)
    want = [np.zeros((hw, hw), np.float32) for _ in range(T)]
    got = [np.zeros((hw, hw), np.float32) for _ in range(T)]
    ref.inject_objects(want, zeroed, psf, objects)
    survey_pipeline_gate.inject_objects(got, zeroed, psf, objects, hw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert sum(float(a.sum()) for a in got) > 0


def test_recovered_matches_jax(monkeypatch):
    ref = _load_jax_script("survey_pipeline_gate", monkeypatch, KB_GATE_HW=512)
    rng = np.random.default_rng(5)
    objects = ref.make_objects(np.random.default_rng(17))
    zeroed = np.linspace(0.0, survey_pipeline_gate.SPAN_DAYS, 8)
    # Rows near the objects (some within the tolerances, some not).
    base = np.array([o[:4] for o in objects] * 3, float)
    table = {k: base[:, i] + rng.normal(0.0, s, len(base))
             for i, (k, s) in enumerate((("x", 4.0), ("y", 4.0), ("vx", 3.0), ("vy", 3.0)))}
    checked = 0
    for tol_end, eps in ((4.0, 0.0), (10.0, 5.0), (2.0, 3.0)):
        for obj in objects:
            want = ref.recovered(table, obj, zeroed, tol_end, cluster_eps=eps)
            assert survey_pipeline_gate.recovered(table, obj, zeroed, tol_end, cluster_eps=eps) == want
            checked += want
    assert 0 < checked < 3 * len(objects)


@pytest.mark.parametrize("frac", [0.0, 0.01])
def test_miss_rate_stack_matches_jax(monkeypatch, frac):
    ref = _load_jax_script("sigmag_miss_rate", monkeypatch)
    want = ref.build_stack(frac, seed=42)
    got = sigmag_miss_rate.build_stack(frac, seed=42)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got[2], want[2]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[3], want[3])
    assert [(o.x, o.y, o.vx, o.vy, o.flux) for o in got[4]] == [(o.x, o.y, o.vx, o.vy, o.flux) for o in want[4]]


@pytest.mark.parametrize("C", [300, 257 * 129])
def test_twelve_day_lattice_matches_jax_scripts(C):
    """survey_scale's default grid and snap_sweep's lattice (both from
    ``_common.twelve_day_lattice``) against the JAX scripts' formulas:
    survey_scale's in float64, snap_sweep's whole lattice in float32."""
    vel, ang = np.meshgrid(np.linspace(92.0, 526.0, 257) / 8.0,
                           np.linspace(-np.pi / 15, np.pi / 15, 129)[: max(1, min(129, -(-C // 257)))],
                           indexing="ij")
    vel, ang = vel.ravel(), ang.ravel()
    vxs, vys, n = survey_scale.make_grid(C, "default", None)
    assert n == len(vel) and vxs.dtype == np.float64
    np.testing.assert_array_equal(vxs, np.cos(ang) * vel)
    np.testing.assert_array_equal(vys, np.sin(ang) * vel)
    fx, fy = snap_sweep.lattice(C)
    np.testing.assert_array_equal(fx, (np.cos(ang) * vel).astype(np.float32))
    np.testing.assert_array_equal(fy, (np.sin(ang) * vel).astype(np.float32))


@pytest.mark.parametrize("snap", [0.0, 0.5, 0.75, 1.0])
def test_snap_classes_match_jax(snap):
    """Class counts of the 12-day lattice per KB_SNAP_ROW_ERROR, as the JAX
    script counts them (its unsnapped count is the distinct rounded-row
    sequences)."""
    times = np.linspace(0, 12, 100)
    vxs, vys = snap_sweep.lattice()
    vel, ang = np.meshgrid(np.linspace(92.0, 526.0, 257) / 8.0, np.linspace(-np.pi / 15, np.pi / 15, 129),
                           indexing="ij")
    np.testing.assert_array_equal(vys, (np.sin(ang.ravel()) * vel.ravel()).astype(np.float32))
    got_vys, got_n = snap_sweep.classes(vys, times, snap)
    if snap > 0:
        want_vys, want_n = j_snap_vy_rows(vys, times, snap)
    else:
        want_vys = vys
        want_n = len(np.unique(np.floor(vys[:, None] * times[None, :] + 0.5).astype(np.int64), axis=0))
    np.testing.assert_array_equal(got_vys, np.asarray(want_vys))
    assert got_n == want_n


def test_regression_objects_match_jax_script():
    """The JAX regression script's objects and cadence, taken out of its
    module body with ast (it runs its pipeline when loaded)."""
    path = JAX_SCRIPTS / "regression_tpu.py"
    tree = ast.parse(path.read_text(), filename=str(path))

    class Trajectory:
        def __init__(self, x, y, vx, vy, flux):
            self.row = (x, y, vx, vy, flux)

    wanted = {"FLUX", "TRJS", "num_times", "times", "psf_vals", "seen", "day"}

    def names(target):
        return {n.id for n in ast.walk(target) if isinstance(n, ast.Name)}

    keep = [node for node in tree.body
            if (isinstance(node, ast.Assign) and set().union(*map(names, node.targets)) <= wanted)
            or (isinstance(node, ast.For) and names(node.target) == {"i"})]
    assert len(keep) == 6, [ast.dump(n)[:60] for n in keep]
    ns = {"np": np, "Trajectory": Trajectory}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(path), "exec"), ns)
    assert ns["FLUX"] == regression.FLUX
    assert [t.row for t in ns["TRJS"]] == [(x, y, vx, vy, regression.FLUX) for x, y, vx, vy in regression.TRJS]
    times, sigmas = regression.times_and_psf_sigmas(ns["num_times"])
    assert ns["times"] == times and ns["psf_vals"] == sigmas


# ----------------------------------------------------------------------
# Each script's main at a rehearsal size
# ----------------------------------------------------------------------

# (module, argv, environment, a line its output must hold)
MAINS = {
    "e2e": (e2e, [], {}, "E2E OK"),
    "steady_state": (steady_state, ["--grid", "4,12"], {}, "best: 256 512 -40.0 -120.0"),
    "scale_gate": (scale_gate, ["--t", "12", "--hw", "96", "--c", "64"], {}, "WINDOW EXACT"),
    "survey_scale": (survey_scale, [], dict(KB_SURVEY_T=12, KB_SURVEY_HW=96, KB_SURVEY_C=64), "WINDOW EXACT"),
    "survey_scale_default_grid": (survey_scale, [], dict(KB_SURVEY_T=12, KB_SURVEY_HW=160, KB_SURVEY_C=300,
                                                        KB_SURVEY_GRID="default", KB_SURVEY_SNAP="0.75"),
                                  "WINDOW EXACT"),
    "snap_sweep": (snap_sweep, [], dict(KB_SWEEP_T=12, KB_SWEEP_HW=64, KB_SWEEP_C=300, KB_SWEEP_SNAPS="0,0.75"),
                   "| 0.75 |"),
    "sigmag_miss_rate": (sigmag_miss_rate, ["--fracs", "0.01", "--factors", "1", "--hw", "64"], {}, "0.01 |"),
    "long_t": (long_t, ["--t", "20", "--hw", "96", "--c", "32"], {}, "T=20 WINDOW EXACT"),
    "psi_phi_bench": (psi_phi_bench, ["--t", "4", "--hw", "128"], {}, "Gpix/s"),
    "coadd_bench": (coadd_bench, ["--rows", "500", "--hw", "128"], {}, "stamps/s"),
    "prewarm": (prewarm, [], {}, "prewarm total"),
    "twin_forms": (twin_forms, ["--shapes", "3", "--reps", "1"], {}, "TWIN FORMS EQUAL"),
}


@pytest.mark.parametrize("name", sorted(MAINS))
def test_main_at_a_rehearsal_size(capsys, monkeypatch, name):
    module, argv, env, marker = MAINS[name]
    for key, value in env.items():
        monkeypatch.setenv(key, str(value))
    assert module.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert marker in out
    assert "'psi_phi_conv': 0" in out or "launches" not in out  # no kernel on the host


@pytest.mark.parametrize("name", sorted(set(MAINS) - {"survey_scale_default_grid"})
                         + ["survey_full_grid", "survey_pipeline_gate"])
def test_main_defaults_to_the_card(monkeypatch, name):
    module = {"survey_full_grid": survey_full_grid, "survey_pipeline_gate": survey_pipeline_gate}.get(name)
    module = module or MAINS[name][0]
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main([])


# ----------------------------------------------------------------------
# The pipeline gate against the JAX package's runner
# ----------------------------------------------------------------------

def test_pipeline_gate_rows_equal_jax(tmp_path, monkeypatch, capsys):
    """The gate's main at a rehearsal size (20 x 512 x 512, the grid thinned
    to 32 x 16), then the JAX package's runner with the script's
    configuration on the same stack."""
    T, hw, thin = 20, 512, 8
    path = tmp_path / "port.ecsv"
    for key, value in dict(KB_GATE_T=T, KB_GATE_HW=hw, KB_GATE_GRID_SCALE=thin, KB_GATE_RESULTS=path).items():
        monkeypatch.setenv(key, str(value))
    assert survey_pipeline_gate.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "PIPELINE GATE PASSED" in out and '"recovered": 20' in out and "'search_topk_encoded_shift': 1" in out
    got = TResults.read_table(str(path))

    stack, objects, zeroed = survey_pipeline_gate.make_stack(T, hw)
    jstack = JImageStackPy(stack.times, [np.array(s) for s in stack.sci], [np.array(v) for v in stack.var],
                           psfs=[np.asarray(p) for p in stack.psfs])
    config = survey_pipeline_gate.make_config(hw, thin, tmp_path / "jax.ecsv")
    ref = JSearchRunner().run_search(JConfig.from_dict(dict(config._params)), jstack)
    assert len(got) == len(ref) > 20
    for k in ("x", "y", "vx", "vy", "obs_count"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)
    for k in ("likelihood", "flux"):
        a, b = np.asarray(ref[k], np.float64), np.asarray(got[k], np.float64)
        assert np.all(np.abs(a - b) <= TOL * np.maximum(1.0, np.abs(a))), k
    n_vel, _ = survey_pipeline_gate.grid_steps(thin)
    tol_end = max(4.0, 0.55 * (526.0 - 92.0) / (n_vel - 1) * float(zeroed[-1]))
    assert all(survey_pipeline_gate.recovered(ref, o, zeroed, tol_end, survey_pipeline_gate.cluster_eps(hw))
               for o in objects)


# ----------------------------------------------------------------------
# survey_full_grid: a kill and a resume
# ----------------------------------------------------------------------

def test_survey_full_grid_resumes_after_sigkill(tmp_path, monkeypatch):
    # A 256 frame: the slowest candidates (124 px over the span) stay inside.
    # The worker children take two intra-op threads, as this file does.
    env = dict(KB_GATE_T="10", KB_GATE_HW="256", KB_GATE_TILE_ROWS="96", KB_GATE_GRID_SCALE="8",
               OMP_NUM_THREADS="2")
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    resumed, whole = tmp_path / "resumed.npz", tmp_path / "whole.npz"
    done = survey_full_grid.parent(type("Args", (), dict(dir=str(tmp_path / "ckpt"), device="cpu",
                                                          rows_out=str(resumed)))())
    assert done["tiles_total"] == 3 and done["tiles_computed"] == 2
    # An uninterrupted worker, as a child too.
    proc = subprocess.run(
        [sys.executable, "-m", "kbmod_tpu_torch.scripts.survey_full_grid", "--worker", "--device", "cpu",
         "--dir", str(tmp_path / "whole"), "--rows-out", str(whole)],
        capture_output=True, text=True, env=dict(os.environ), timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    with np.load(resumed) as a, np.load(whole) as b:
        assert set(a.files) == set(b.files) and len(a["lh"]) > 0
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
