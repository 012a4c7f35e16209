"""kbmod_tpu_torch stands alone: it imports and runs a CPU search (float
and uint8) with ``jax``, ``flax`` and ``kbmod_tpu`` blocked, and the whole
``SearchRunner`` pipeline (ECSV output, the default clustering, then CNN,
brightness and known-object vetting of its rows) with scikit-learn,
PyYAML, pandas, pyarrow, psutil and h5py blocked too; no module of the
port (``scripts/`` included) nor ``chip_smoke.py`` imports JAX, flax or
the JAX package at any depth of its code, and an entry point left to its
default device (CUDA) raises on a host without a card."""

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
                "geom/wcs.py", "geom/ecliptic.py", "wcs_utils.py"):
        assert f"kbmod_tpu_torch/{new}" in _PORT_FILES
    assert len(_PORT_FILES) >= 25


@pytest.mark.parametrize("path", _PORT_FILES)
def test_port_module_imports_no_jax(path):
    """Every module of the port, at any depth of its code, imports neither
    JAX, flax nor the JAX package (relative imports stay inside the port)."""
    names = _imported_modules(os.path.join(REPO_ROOT, path))
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "flax", "kbmod_tpu")]
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
