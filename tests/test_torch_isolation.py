"""kbmod_tpu_torch stands alone: it imports and runs a CPU search (float
and uint8) with ``jax`` and ``kbmod_tpu`` blocked, no module of the port
(``scripts/`` included) nor ``chip_smoke.py`` imports either at any depth
of its code, and an entry point left to its default device (CUDA) raises
on a host without a card."""

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
    assert not any(m == "jax" or m.startswith(("jax.", "kbmod_tpu.")) for m in sys.modules
                   if sys.modules[m] is not None)
    print("OK", best, best_q)
    """
)


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
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "kbmod_tpu")]
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
    assert len(_PORT_FILES) >= 25


@pytest.mark.parametrize("path", _PORT_FILES)
def test_port_module_imports_no_jax(path):
    """Every module of the port, at any depth of its code, imports neither
    JAX nor the JAX package (relative imports stay inside the port)."""
    names = _imported_modules(os.path.join(REPO_ROOT, path))
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "kbmod_tpu")]
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
