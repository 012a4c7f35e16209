"""kbmod_tpu_torch stands alone: it imports and runs a CPU search (float
and uint8) and the WorkUnit path (write, read, reproject, search with sky
positions) and the discovery path (exposures on disk to a collection, a
region search, reprojection, injection, search, recovery and refinement)
with ``jax``, ``flax`` and ``kbmod_tpu`` blocked, and the whole
``SearchRunner`` pipeline (ECSV output, the default clustering, then CNN,
brightness and known-object vetting of its rows) with scikit-learn,
PyYAML, pandas, pyarrow, psutil and h5py blocked too, and the command-line
tools' chain (create test data, search, strip, filter with the curves
rebuilt from the WorkUnit, stamps, stats, the Visualizer's stamps) with
matplotlib, pyarrow, scikit-learn and pandas blocked; every module of the
JAX package but its two Pallas files has a counterpart in the port, and
every script of the JAX side's ``scripts/`` a counterpart in
``kbmod_tpu_torch/scripts/`` or a place in a named list of TPU-only
scripts with its reason; no module of the port (``scripts/`` included) nor
``chip_smoke.py`` imports JAX, flax or the JAX package at any depth of its
code, no port script imports the JAX side's ``scripts``, and an entry point
left to its default device (CUDA) raises on a host without a card."""

import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = textwrap.dedent(
    """
    import sys
    sys.modules["jax"] = None
    sys.modules["flax"] = None
    sys.modules["kbmod_tpu"] = None
    import numpy as np
    import kbmod_tpu_torch
    from kbmod_tpu_torch.fake_data.fake_data_creator import FakeDataSet, create_fake_times
    from kbmod_tpu_torch.search import StackSearch, Trajectory
    from kbmod_tpu_torch.trajectory_generator import VelocityGridSearch

    times = create_fake_times(6, t0=57130.2, obs_per_day=3)
    ds = FakeDataSet(32, 30, times, use_seed=3, mask_fraction=0.02)
    ds.insert_object(Trajectory(x=9, y=14, vx=3.0, vy=1.0, flux=300.0))
    st = ds.stack_py
    s = StackSearch(st.sci, st.var, st.psfs, st.zeroed_times, -1, device="cpu")
    s.set_min_obs(4)
    s.search_all(list(VelocityGridSearch(5, 1.0, 5.0, 5, -1.0, 3.0)), True)
    best = s.get_results(0, 1)[0]
    assert (best.x, best.y) == (9, 14), best
    q = StackSearch(st.sci, st.var, st.psfs, st.zeroed_times, 1, device="cpu")
    q.set_min_obs(4)
    q.search_all(list(VelocityGridSearch(5, 1.0, 5.0, 5, -1.0, 3.0)), True)
    best_q = q.get_results(0, 1)[0]
    assert (best_q.x, best_q.y) == (9, 14), best_q

    # The WorkUnit path: make one, write it (RICE_1 through the native
    # codec) and read it, reproject it, search it with sky positions.
    import os, tempfile
    from kbmod_tpu_torch import native
    from kbmod_tpu_torch.reprojection import reproject_work_unit
    from kbmod_tpu_torch.run_search import SearchRunner
    from kbmod_tpu_torch.wcs_utils import make_fake_wcs
    from kbmod_tpu_torch.work_unit import WorkUnit
    work = ds.get_work_unit(dict(generator_config={"name": "VelocityGridSearch", "vx_steps": 5, "min_vx": 1.0,
                                                   "max_vx": 5.0, "vy_steps": 5, "min_vy": -1.0, "max_vy": 3.0},
                                 num_obs=4, lh_level=5.0))
    for i in range(len(times)):
        work.org_img_meta["per_image_wcs"][i] = make_fake_wcs(200.0, -7.0, 30, 32, 1.0 / 3600.0)
    path = os.path.join(tempfile.mkdtemp(), "wu.fits")
    work.to_fits(path, compression_type="RICE_1")
    back = WorkUnit.from_fits(path)
    assert back.config == work.config and back.im_stack.num_times == len(times) and native.available()
    common = make_fake_wcs(200.0, -7.0, 30, 32, 1.0 / 3600.0)
    common.crpix = common.crpix + np.array([0.3, 0.2])
    keep = SearchRunner(device="cpu").run_search_from_work_unit(reproject_work_unit(back, common, device="cpu"))
    assert "global_ra" in keep.colnames and abs(keep["x"][0] - 9) <= 1 and abs(keep["y"][0] - 14) <= 1, keep["x"]
    assert not any(m in ("jax", "flax") or m.startswith(("jax.", "flax.", "kbmod_tpu.")) for m in sys.modules
                   if sys.modules[m] is not None)
    print("OK", best, best_q)
    """
)


# The pipeline as the card's machine has it: no JAX, no JAX package, and
# none of the host libraries the JAX package's pipeline imports that are
# missing there.
_PIPELINE_SCRIPT = textwrap.dedent(
    """
    import sys
    for name in ("jax", "flax", "kbmod_tpu", "sklearn", "yaml", "pandas", "pyarrow", "psutil", "h5py"):
        sys.modules[name] = None
    import os, tempfile
    import numpy as np
    from kbmod_tpu_torch.configuration import SearchConfiguration
    from kbmod_tpu_torch.fake_data.fake_data_creator import FakeDataSet, create_fake_times
    from kbmod_tpu_torch.results import Results
    from kbmod_tpu_torch.run_search import SearchRunner
    from kbmod_tpu_torch.search import Trajectory

    times = create_fake_times(8, t0=57130.2, obs_per_day=2, intra_night_gap=0.05)
    ds = FakeDataSet(40, 36, times, use_seed=11, mask_fraction=0.02)
    ds.insert_object(Trajectory(x=12, y=20, vx=3.0, vy=1.0, flux=300.0))
    out = os.path.join(tempfile.mkdtemp(), "results.ecsv")
    config = SearchConfiguration(dict(
        generator_config={"name": "KBMODV1SearchConfig", "v_arr": [2.0, 4.0, 5], "ang_arr": [0.5, 0.5, 5],
                          "average_angle": 0.3217505543966422},
        num_obs=4, lh_level=5.0, result_filename=out, save_config=False, coadds=["mean", "median"],
    ))
    assert config["cluster_type"] == "all" and config["do_clustering"]
    keep = SearchRunner().run_search(config, ds.stack_py, device="cpu")
    back = Results.read_table(out)
    assert len(back) == len(keep) > 0
    assert (back["x"] == keep["x"]).all() and (back["coadd_sum"] == keep["coadd_sum"]).all()
    best = int(np.argmax(keep["likelihood"]))
    assert abs(keep["x"][best] - 12) <= 1 and abs(keep["y"][best] - 20) <= 1, (keep["x"][best], keep["y"][best])

    # Vetting of the pipeline's rows: a seeded resnet18 state_dict file,
    # the brightness filter and a catalog made from the best row's path.
    import torch
    from kbmod_tpu_torch.filters.brightness_filters import apply_brightness_search_filter
    from kbmod_tpu_torch.filters.known_object_filters import KnownObjsMatcher
    from kbmod_tpu_torch.filters.stamp_filters import filter_stamps_by_cnn
    from kbmod_tpu_torch.models.cnn import StampClassifier
    from kbmod_tpu_torch.trajectory_utils import trajectory_predict_skypos
    from kbmod_tpu_torch.wcs_utils import make_fake_wcs
    weights = os.path.join(os.path.dirname(out), "resnet18.pt")
    torch.save(StampClassifier("resnet18", 21, seed=0, device="cpu").model.state_dict(), weights)
    filter_stamps_by_cnn(keep, weights, coadd_type="mean", stamp_radius=10, coadd_radius=10, device="cpu")
    assert keep["prob_real"].shape == (len(keep),)
    apply_brightness_search_filter(keep, ds.stack_py, device="cpu")
    wcs = make_fake_wcs(200.0, -7.0, 36, 40, 1.0 / 3600.0)
    trj = keep.make_trajectory_list()[int(np.argmax(keep["likelihood"]))]
    sky = trajectory_predict_skypos(trj, wcs, np.asarray(ds.stack_py.times))
    from kbmod_tpu_torch.table import Table
    catalog = Table({"Name": np.array(["obj"] * len(times), dtype=object), "RA": sky.ra_deg, "DEC": sky.dec_deg,
                     "mjd_mid": np.asarray(ds.stack_py.times)})
    matcher = KnownObjsMatcher(catalog, np.asarray(ds.stack_py.times), "ko", sep_thresh=0.5)
    matcher.match(keep, wcs)
    assert "obj" in keep["ko"][int(np.argmax(keep["likelihood"]))]

    bad = [m for m in ("jax", "flax", "kbmod_tpu", "sklearn", "yaml", "pandas", "pyarrow", "psutil", "h5py")
           if sys.modules.get(m) is not None]
    assert not bad, bad
    print("OK", len(keep))
    """
)


# The discovery path with JAX and the JAX package blocked: two KBMODV1
# exposures on disk -> fromDir -> RegionSearch -> toWorkUnit ->
# reproject_work_unit -> inject_sources_into_work_unit ->
# run_search_from_work_unit -> match_injection_results -> refine_all_results.
_DISCOVERY_SCRIPT = textwrap.dedent(
    """
    import sys
    for name in ("jax", "flax", "kbmod_tpu"):
        sys.modules[name] = None
    import os, tempfile
    import numpy as np
    from kbmod_tpu_torch.geom.time_utils import mjd_to_datetime
    from kbmod_tpu_torch.image_collection import ImageCollection
    from kbmod_tpu_torch.injection import generate_injection_catalog, inject_sources_into_work_unit, match_injection_results
    from kbmod_tpu_torch.io import fits_io
    from kbmod_tpu_torch.region_search import Ephems, RegionSearch
    from kbmod_tpu_torch.reprojection import reproject_work_unit
    from kbmod_tpu_torch.run_search import SearchRunner
    from kbmod_tpu_torch.table import Table
    from kbmod_tpu_torch.trajectory_explorer import refine_all_results
    from kbmod_tpu_torch.wcs_utils import make_fake_wcs

    # Two exposures of one field, KBMODV1 files; times through DATE-AVG.
    tmp, rng, H, W = tempfile.mkdtemp(), np.random.default_rng(0), 40, 48
    for i, mjd in enumerate((57130.0, 57130.5)):
        start = mjd - (30.0 + 0.5) / 2.0 / 86400.0
        primary = fits_io.ImageHDU(name="PRIMARY")
        primary.header.update({"ZTENSION": "IMAGE", "ZPCOUNT": 0, "ZGCOUNT": 1, "CCDNUM": 1, "EXPREQ": 30.0,
                               "DATE-AVG": mjd_to_datetime(start).strftime("%Y-%m-%dT%H:%M:%S.%f"), "FILTER": "r"})
        image = fits_io.ImageHDU(rng.normal(0, 1, (H, W)).astype(np.float32), name="IMAGE")
        image.header.update(make_fake_wcs(200.0, -7.0, H, W, 1.0 / 3600.0).to_header())
        fits_io.write_fits(os.path.join(tmp, f"e{i}.fits"), [primary, image,
                           fits_io.ImageHDU(np.zeros((H, W), np.int32), name="MASK"),
                           fits_io.ImageHDU(np.ones((H, W), np.float32), name="VARIANCE")])
    ic = ImageCollection.fromDir(tmp, config={"grow_mask": False})
    assert len(ic) == 2 and abs(ic["mjd_mid"][1] - 57130.5) < 1e-8, ic["mjd_mid"]
    rs = RegionSearch(ic)
    half = 0.35 / 60.0
    rs.generate_patches(0.7, pixel_scale=1.0, ra_range=(200.0 - half, 200.0 + half), dec_range=(-7.0 - half, -7.0 + half))
    eph = Ephems(Table({"ra": [200.0], "dec": [-7.0], "mjd": [57130.0]}), "ra", "dec", "mjd")
    assert rs.search_patches_by_ephems(eph) == [0]
    patch = rs.get_patch(0)
    sub = rs.get_image_collection_from_patch(patch)
    config = {"generator_config": {"name": "VelocityGridSearch", "vx_steps": 9, "min_vx": -8.0, "max_vx": 8.0,
                                   "vy_steps": 9, "min_vy": -8.0, "max_vy": 8.0},
              "num_obs": 2, "lh_level": 5.0, "do_clustering": False, "sigmaG_filter": False}
    wu = reproject_work_unit(sub.toWorkUnit(config), patch.to_wcs(), device="cpu")
    catalog = generate_injection_catalog(1, 200.0, -7.0, 57130.0, ra_spread_deg=0.001, dec_spread_deg=0.001,
                                         vel_min=2.0, vel_max=4.0, mag_min=20.5, mag_max=20.6, seed=3)
    inject_sources_into_work_unit(wu, catalog)
    keep = SearchRunner().run_search_from_work_unit(wu, device="cpu")
    match = match_injection_results(catalog, keep, wu)
    assert bool(match["recovered"][0]), (keep["x"][:3], keep["y"][:3])
    refined = refine_all_results(keep[[int(match["match_idx"][0])]], wu.im_stack, wu.config, pixel_radius=3,
                                 max_dv=2.0, dv_steps=5, device="cpu")
    assert len(refined) == 1
    print("OK", len(keep), refined["x"][0], refined["y"][0])
    """
)


# The command-line tools' chain, each tool through its main(argv) with
# --device cpu where its work reaches the card, with JAX, the JAX package
# and the host libraries that no chip phase may need blocked (PyYAML stays:
# the WorkUnit file carries its configuration as YAML).
_TOOLS_SCRIPT = textwrap.dedent(
    """
    import sys
    BLOCKED = ("jax", "flax", "kbmod_tpu", "matplotlib", "pyarrow", "sklearn", "pandas")
    for name in BLOCKED:
        sys.modules[name] = None
    import os, tempfile
    import numpy as np
    from kbmod_tpu_torch.cmdline import (kbmod_create_test_data, kbmod_filter, kbmod_search, kbmod_stamps,
                                         kbmod_stats, kbmod_strip_results)
    from kbmod_tpu_torch.configuration import SearchConfiguration
    from kbmod_tpu_torch.results import Results

    tmp = tempfile.mkdtemp()
    path = lambda name: os.path.join(tmp, name)
    kbmod_create_test_data.main([f"--outfile={path('wu.fits')}", "--num_times=8", "--width=48", "--height=40",
                                 "--num_objects=1", "--flux=600", "--seed=5"])
    SearchConfiguration.from_dict({
        "generator_config": {"name": "EclipticCenteredSearch", "velocities": [0.0, 60.0, 9],
                             "angles": [-3.2, 3.2, 9], "angle_units": "radian", "given_ecliptic": 0.0},
        "num_obs": 4, "lh_level": 8.0, "compute_ra_dec": False}).to_file(path("cfg.yaml"))
    kbmod_search.main(["--workunit", path("wu.fits"), "--outfile", path("found.ecsv"), "--config", path("cfg.yaml"),
                       "--device", "cpu"])
    found = Results.read_table(path("found.ecsv"))
    kbmod_strip_results.main([f"--input={path('found.ecsv')}", f"--outfile={path('stripped.ecsv')}",
                              "--cols=psi_curve,phi_curve"])
    kbmod_filter.main([f"--input={path('stripped.ecsv')}", f"--outfile={path('filtered.ecsv')}",
                       f"--workunit={path('wu.fits')}", "--sigma_g_bnds=25,75", "--device", "cpu"])
    filtered = Results.read_table(path("filtered.ecsv"))
    assert len(filtered) == len(found) > 0
    for col in ("psi_curve", "phi_curve"):
        assert np.array_equal(np.asarray(filtered[col]), np.asarray(found[col])), col
    kbmod_stamps.main([f"--input={path('filtered.ecsv')}", f"--outfile={path('stamps.ecsv')}",
                       f"--workunit={path('wu.fits')}", "--coadds=mean,median,sum", "--device", "cpu"])
    stamps = Results.read_table(path("stamps.ecsv"))
    assert np.asarray(stamps["coadd_median"]).shape == (len(found), 21, 21)
    kbmod_stats.main([f"--input={path('stamps.ecsv')}"])
    from kbmod_tpu_torch.analysis.visualizer import Visualizer
    from kbmod_tpu_torch.work_unit import WorkUnit
    Visualizer(WorkUnit.from_fits(path("wu.fits")).im_stack, stamps, device="cpu").generate_all_stamps()
    assert np.asarray(stamps["all_stamps"]).shape == (len(found), 8, 21, 21)
    bad = [m for m in BLOCKED if sys.modules.get(m) is not None]
    assert not bad, bad
    print("OK", len(found))
    """
)


def test_tools_chain_runs_without_jax_or_host_libraries():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [REPO_ROOT, os.environ.get("PYTHONPATH")])))
    out = subprocess.run(
        [sys.executable, "-c", _TOOLS_SCRIPT], capture_output=True, text=True, env=env, cwd=REPO_ROOT, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert "Rows: " in out.stdout and out.stdout.strip().splitlines()[-1].startswith("OK")


def test_discovery_path_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [REPO_ROOT, os.environ.get("PYTHONPATH")])))
    out = subprocess.run(
        [sys.executable, "-c", _DISCOVERY_SCRIPT], capture_output=True, text=True, env=env, cwd=REPO_ROOT, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK")


def test_pipeline_runs_without_jax_or_missing_host_libraries():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [REPO_ROOT, os.environ.get("PYTHONPATH")])))
    out = subprocess.run(
        [sys.executable, "-c", _PIPELINE_SCRIPT], capture_output=True, text=True, env=env, cwd=REPO_ROOT, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK")


def test_imports_and_searches_without_jax():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [REPO_ROOT, os.environ.get("PYTHONPATH")])))
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT], capture_output=True, text=True, env=env, cwd=REPO_ROOT, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK")


def _imported_modules(path):
    """Every module an ``import`` or ``from ... import`` in the file names,
    at any depth (functions included)."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_chip_smoke_imports_no_jax():
    names = _imported_modules(os.path.join(REPO_ROOT, "chip_smoke.py"))
    assert any(n.startswith("kbmod_tpu_torch") for n in names)
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "flax", "kbmod_tpu")]
    assert not bad, f"chip_smoke.py imports {bad}"


_PORT_FILES = sorted(
    os.path.relpath(os.path.join(root, name), REPO_ROOT)
    for root, _, files in os.walk(os.path.join(REPO_ROOT, "kbmod_tpu_torch"))
    for name in files
    if name.endswith(".py")
)


def test_port_walk_finds_every_package():
    assert "kbmod_tpu_torch/scripts/exactrow_microbench.py" in _PORT_FILES
    assert "kbmod_tpu_torch/ops/search_kernel.py" in _PORT_FILES
    for new in ("models/cnn.py", "filters/brightness_filters.py", "filters/known_object_filters.py",
                "geom/wcs.py", "geom/ecliptic.py", "wcs_utils.py", "native/__init__.py", "io/rice.py",
                "io/comp_image.py", "io/fits_bintable.py", "io/fits_io.py", "work_unit.py", "reprojection.py",
                "reprojection_utils.py", "ops/reproject.py", "cmdline/kbmod_search.py", "geom/geodesy.py",
                "constants.py", "standardizers/__init__.py", "standardizers/standardizer.py",
                "standardizers/fits_standardizer.py", "standardizers/kbmodv1.py", "standardizers/kbmodv05.py",
                "standardizers/butler_standardizer.py", "image_collection.py", "region_search.py", "injection.py",
                "trajectory_explorer.py", "core/shift_and_stack.py", "cmdline/kbmod_build_ic.py",
                "cmdline/region_searcher.py", "fake_data/demo_helper.py", "fake_data/fake_result_creator.py",
                "analysis/__init__.py", "analysis/plotting.py", "analysis/visualizer.py",
                "analysis/analyze_fakes.py", "analysis/results_rater.py", "cmdline/kbmod_filter.py",
                "cmdline/kbmod_stamps.py", "cmdline/kbmod_version.py", "examples/01_kbmod_demo.py",
                "examples/13_checkpoint_resume.py", "scripts/gen_api_docs.py", "scripts/gen_notebooks.py"):
        assert f"kbmod_tpu_torch/{new}" in _PORT_FILES
    assert len(_PORT_FILES) >= 25


def test_every_jax_module_has_a_counterpart():
    """The JAX package's modules missing from the port are exactly its two
    Pallas files, whose kernels (K1-K5) the port's CUDA sources replace."""
    jax_root = os.path.join(REPO_ROOT, "kbmod_tpu")
    jax_files = {os.path.relpath(os.path.join(root, name), jax_root)
                 for root, _, files in os.walk(jax_root) for name in files if name.endswith(".py")}
    port = {os.path.relpath(p, "kbmod_tpu_torch") for p in _PORT_FILES}
    assert sorted(jax_files - port) == ["ops/conv_pallas.py", "ops/search_pallas.py"]


# The JAX side's scripts/ and their counterparts in kbmod_tpu_torch/scripts/.
PORTED_SCRIPTS = {
    "regression_tpu.py": "regression.py", "e2e_tpu.py": "e2e.py", "steady_state.py": "steady_state.py",
    "scale_gate.py": "scale_gate.py", "survey_scale.py": "survey_scale.py",
    "survey_pipeline_gate.py": "survey_pipeline_gate.py", "survey_full_grid.py": "survey_full_grid.py",
    "snap_sweep.py": "snap_sweep.py", "sigmag_miss_rate.py": "sigmag_miss_rate.py", "long_t.py": "long_t.py",
    "psi_phi_bench.py": "psi_phi_bench.py", "coadd_bench.py": "coadd_bench.py", "prewarm.py": "prewarm.py",
    "exactrow_microbench.py": "exactrow_microbench.py", "gen_api_docs.py": "gen_api_docs.py",
    "gen_notebooks.py": "gen_notebooks.py",
}
# The JAX side's scripts with no counterpart, each with its reason.
UNPORTED_SCRIPTS = {
    "pallas_bench.py": "times the float Pallas kernel on the TPU; chip_smoke.py's kernel checks and "
                       "scripts/grouped_timing.py time K2",
    "pallas_bench_encoded.py": "times the encoded Pallas kernel on the TPU; chip_smoke.py and "
                               "scripts/grouped_timing.py time K3-K5",
    "pallas_tpu_trial.py": "a first trial of the Pallas kernels on the TPU; chip_smoke.py checks K1-K6",
    "pallas_tpu_only.py": "runs the Pallas kernels on the TPU alone; chip_smoke.py checks K1-K6",
    "pallas_bisect.py": "bisects the TPU kernel's lane and sublane rolls, a TPU mechanism",
    "pallas_tile_sweep.py": "sweeps VMEM row tiles, a TPU mechanism",
    "grouped_th_sweep.py": "sweeps the grouped kernel's VMEM row tiles, a TPU mechanism",
}
_JAX_SCRIPTS = sorted(name for name in os.listdir(os.path.join(REPO_ROOT, "scripts")) if name.endswith(".py"))


@pytest.mark.parametrize("name", _JAX_SCRIPTS)
def test_every_jax_script_has_a_counterpart_or_a_reason(name):
    assert (name in PORTED_SCRIPTS) != (name in UNPORTED_SCRIPTS), name
    if name in PORTED_SCRIPTS:
        assert f"kbmod_tpu_torch/scripts/{PORTED_SCRIPTS[name]}" in _PORT_FILES
    else:
        assert UNPORTED_SCRIPTS[name]


def test_port_scripts_are_listed():
    port_scripts = {os.path.basename(p) for p in _PORT_FILES if p.startswith("kbmod_tpu_torch/scripts/")}
    assert set(PORTED_SCRIPTS.values()) | {"__init__.py", "_common.py", "grouped_timing.py", "twin_forms.py"} == port_scripts


_JAX_EXAMPLES = sorted(name for name in os.listdir(os.path.join(REPO_ROOT, "docs", "examples"))
                       if name.endswith(".py"))


@pytest.mark.parametrize("name", _JAX_EXAMPLES)
def test_every_jax_example_has_a_counterpart(name):
    """Each of the JAX package's worked examples has the port's, under the
    same name, with the same percent-format cells, kind for kind."""
    assert f"kbmod_tpu_torch/examples/{name}" in _PORT_FILES

    def kinds(path):
        with open(path) as f:
            return [line.strip() for line in f if line.startswith("# %%")]

    assert kinds(os.path.join(REPO_ROOT, "kbmod_tpu_torch", "examples", name)) == kinds(
        os.path.join(REPO_ROOT, "docs", "examples", name))


@pytest.mark.parametrize("path", _PORT_FILES)
def test_port_module_imports_no_jax(path):
    """Every module of the port, at any depth of its code, imports neither
    JAX, flax nor the JAX package (relative imports stay inside the port)."""
    names = _imported_modules(os.path.join(REPO_ROOT, path))
    banned = ("jax", "jaxlib", "flax", "kbmod_tpu") + (("scripts",) if "/scripts/" in path else ())
    bad = [n for n in names if n.split(".")[0] in banned]
    assert not bad, f"{path} imports {bad}"


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present, so the default device is valid here")
    from kbmod_tpu_torch import resolve_device
    from kbmod_tpu_torch.search import StackSearch

    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    img = [torch.zeros(4, 4).numpy()]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StackSearch(img, img, [torch.ones(1, 1).numpy()], [0.0], -1)
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")
