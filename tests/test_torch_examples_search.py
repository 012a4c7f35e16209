"""The port's search examples against the JAX package's, on the CPU.

Each case runs the JAX package's worked example (``docs/examples/``) as
tests/test_examples.py does and the port's counterpart
(``kbmod_tpu_torch/examples/``) with ``DEVICE = "cpu"``, both through
``runpy.run_path`` in one process, and compares the globals that carry the
example's outputs (``OUTPUTS``):

- result rows: x, y, vx, vy, obs_count, every index and count, and the row
  order exactly, up to ROADMAP Queue 3's tie at the top-K boundary: in a
  core search's per-pixel lists a slot may hold another velocity than the
  reference's only where the two candidates read the same samples (the
  same pixel, or none, at every time), and so score the same lh and flux;
  the reference keeps the later of such candidates, the port the earlier;
- likelihood, lh and flux within 1e-5 * max(1, |value|), ROADMAP Queue 3's
  bound for the port against the reference (the psi/phi builds round apart
  by up to 2 float32 ulps);
- other floats (curves, coadds, sky positions) within ``FLOAT_RTOL`` and
  ``FLOAT_ATOL``; booleans, strings and other values exactly;
- FITS files the two examples write, byte for byte;
- what each prints, line for line, where it prints no temporary path.

The search examples here: 01 (the pipeline from a WorkUnit), 03 (the
explorer), 05 (StackSearch, sigma-G, clustering, stamps), 12 (the sharded
search, two shards on the host) and 13 (checkpoint and resume).
tests/test_torch_examples_tools.py holds the other eight.
"""

import contextlib
import io
import os
import pathlib
import runpy
import shutil

import matplotlib
import numpy as np
import pytest
import torch
from kbmod_tpu.ops.search import trajectory_offsets

matplotlib.use("Agg")

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_EXAMPLES = REPO / "docs" / "examples"
PORT_EXAMPLES = REPO / "kbmod_tpu_torch" / "examples"

LH_RTOL = 1e-5
FLOAT_RTOL = 1e-5
FLOAT_ATOL = 1e-5
# Columns that hold a likelihood or a flux, held to ROADMAP Queue 3's bound.
LH_KEYS = ("likelihood", "lh", "flux")
# Columns each package fills with fresh random values.
RANDOM_KEYS = ("uuid",)


def run_example(path, **init):
    """(globals, stdout) of the example at ``path``, run as a script."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        env = runpy.run_path(str(path), init_globals=init, run_name="__main__")
    return env, out.getvalue()


def run_pair(name):
    """The JAX example and the port's, each run once on the CPU."""
    torch.set_num_threads(2)
    ref = run_example(JAX_EXAMPLES / name)
    got = run_example(PORT_EXAMPLES / name, DEVICE="cpu")
    return ref, got


def assert_values_match(ref, got, key):
    """One output: arrays by kind (see the module docstring), containers
    element by element."""
    leaf = key.split(".")[-1].split("[")[0]
    if isinstance(ref, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(ref), key
        for k in ref:
            assert_values_match(ref[k], got[k], f"{key}[{k!r}]")
        return
    if isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), key
        for i, (r, g) in enumerate(zip(ref, got)):
            assert_values_match(r, g, f"{key}[{i}]")
        return
    r, g = np.asarray(ref), np.asarray(got)
    assert g.shape == r.shape, f"{key}: shape {g.shape} != {r.shape}"
    if r.dtype.kind == "O":
        for i, (a, b) in enumerate(zip(r.ravel(), g.ravel())):
            assert_values_match(a, b, f"{key}[{i}]")
    elif r.dtype.kind == "f" and leaf in LH_KEYS:
        tol = LH_RTOL * np.maximum(1.0, np.abs(r.astype(np.float64)))
        diff = np.abs(g.astype(np.float64) - r.astype(np.float64))
        same = np.isfinite(r) == np.isfinite(g)
        assert same.all() and np.all(diff[np.isfinite(r)] <= tol[np.isfinite(r)]), f"{key}: {g} != {r}"
    elif r.dtype.kind in "fc":
        np.testing.assert_allclose(g, r, rtol=FLOAT_RTOL, atol=FLOAT_ATOL, err_msg=key)
    else:
        np.testing.assert_array_equal(g, r, err_msg=key)


def assert_tables_match(ref, got, key):
    """A Results (or Table): the same columns in the same order, each
    matched by kind; the per-row random ``uuid`` is skipped."""
    ref_t, got_t = getattr(ref, "table", ref), getattr(got, "table", got)
    assert list(got_t.colnames) == list(ref_t.colnames), key
    assert len(got_t) == len(ref_t), key
    for col in ref_t.colnames:
        if col not in RANDOM_KEYS:
            assert_values_match(ref_t[col], got_t[col], f"{key}.{col}")


def assert_trajectories_match(ref, got, key):
    assert len(got) == len(ref), key
    for i, (r, g) in enumerate(zip(ref, got)):
        for attr in ("x", "y", "vx", "vy", "obs_count", "lh", "flux"):
            assert_values_match(np.float64(getattr(r, attr)), np.float64(getattr(g, attr)), f"{key}[{i}].{attr}")


def assert_files_equal(ref_path, got_path):
    with open(ref_path, "rb") as a, open(got_path, "rb") as b:
        assert a.read() == b.read(), f"{got_path} differs from {ref_path}"


def cleanup(*dirs):
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)


def check_01(ref, got):
    assert_files_equal(ref["wu_file"], got["wu_file"])
    assert_tables_match(ref["results"], got["results"], "results")
    assert len(got["results"]) >= 1 and ref["best"] == got["best"]
    row = got["results"][int(got["best"])]
    assert (row["x"], row["y"], row["vx"], row["vy"]) == (50, 40, 10.0, 0.0)
    cleanup(ref["workdir"], got["workdir"])


def check_03(ref, got):
    for name in ("row", "grid", "refined"):
        assert_tables_match(ref[name], got[name], name)
    assert ref["best"] == got["best"] and ref["b"] == got["b"]


def check_05(ref, got):
    assert_trajectories_match(ref["trjs"], got["trjs"], "trjs")
    assert_values_match(ref["curves"], np.asarray(got["curves"]), "curves")
    assert_tables_match(ref["results"], got["results"], "results")
    assert_tables_match(ref["back"], got["back"], "back")
    assert dict(ref["results"].filtered_stats) == dict(got["results"].filtered_stats)
    cleanup(ref["workdir"], got["workdir"])


def _samples(x, y, vx, vy, times, valid):
    """(n, T, 2) pixels each (start, velocity) samples at each time, -1
    where the sample is off the image or masked
    (``kbmod_tpu.ops.search.trajectory_offsets``)."""
    dxs, dys = trajectory_offsets(vx, vy, times)
    px, py = x[:, None] + dxs, y[:, None] + dys
    T, H, W = valid.shape
    inside = (px >= 0) & (px < W) & (py >= 0) & (py < H)
    ok = inside & valid[np.arange(T)[None, :], np.clip(py, 0, H - 1), np.clip(px, 0, W - 1)]
    return np.where(ok[..., None], np.stack([px, py], axis=-1), -1)


def assert_search_dicts_match(ref, got, times, valid, key):
    """Two core searches' pixel-major result dicts: every column matched by
    kind, but vx and vy, which may differ only where the two slots'
    candidates tie, reading the same samples at every time."""
    assert sorted(got) == sorted(ref), key
    for k in ref:
        if k not in ("vx", "vy"):
            assert_values_match(np.asarray(ref[k]), np.asarray(got[k]), f"{key}.{k}")
    x, y = np.asarray(ref["x"]), np.asarray(ref["y"])
    swapped = np.flatnonzero((np.asarray(ref["vx"]) != np.asarray(got["vx"]))
                             | (np.asarray(ref["vy"]) != np.asarray(got["vy"])))
    at = (x[swapped], y[swapped])
    np.testing.assert_array_equal(
        _samples(*at, np.asarray(got["vx"])[swapped], np.asarray(got["vy"])[swapped], times, valid),
        _samples(*at, np.asarray(ref["vx"])[swapped], np.asarray(ref["vy"])[swapped], times, valid),
        err_msg=f"{key}: slots {swapped} hold candidates that do not tie")


def check_search_dicts(*names):
    def check(ref, got):
        for name in names:
            assert_search_dicts_match(ref[name], got[name], ref["times"], ref["valid"], name)
    return check


# Per example: the check of its outputs, and whether what it prints holds no
# temporary path or device list (and so must be the same).
OUTPUTS = {
    "01_kbmod_demo.py": (check_01, False),
    "03_trajectory_explorer.py": (check_03, True),
    "05_results_and_filtering.py": (check_05, True),
    "12_multichip_sharding.py": (check_search_dicts("res_sharded", "res_single", "res_pix"), False),
    "13_checkpoint_resume.py": (check_search_dicts("res1", "res2", "res3"), True),
}


@pytest.mark.parametrize("name", sorted(OUTPUTS))
def test_search_example_matches_jax(name):
    check, same_stdout = OUTPUTS[name]
    (ref, ref_out), (got, got_out) = run_pair(name)
    check(ref, got)
    if same_stdout:
        assert got_out.splitlines() == ref_out.splitlines()
    else:
        # The last line: the example ran to its end.
        assert got_out.splitlines()[-1].split()[0] == ref_out.splitlines()[-1].split()[0]


def test_sharded_example_uses_two_shards_on_the_host():
    env, out = run_example(PORT_EXAMPLES / "12_multichip_sharding.py", DEVICE="cpu")
    assert env["mesh"].size == 2 and all(d.type == "cpu" for d in env["mesh"].devices)
    assert out.splitlines()[0] == "mesh: 2 shards on ['cpu', 'cpu']"


def test_checkpoint_example_cleans_up():
    env, _ = run_example(PORT_EXAMPLES / "13_checkpoint_resume.py", DEVICE="cpu")
    assert not os.path.exists(env["ckpt_dir"])
    assert env["psi"].device.type == "cpu" and env["valid"].dtype == torch.uint8


@pytest.mark.parametrize("name", ["12_multichip_sharding.py", "13_checkpoint_resume.py"])
def test_chip_smoke_row_check(name):
    """chip_smoke.py's examples phase holds the card's rows to a host run's:
    two host runs agree, and a row moved or an lh pushed past the bound
    fails (the check run on the host alone, twice)."""
    import chip_smoke as cs

    a, b = (cs.run_example(name, "cpu") for _ in range(2))
    got = cs.example_rows(name, a)
    for label, rows in cs.example_rows(name, b).items():
        T, sums = cs.example_sums(name, b, label, rows)
        assert cs.rows_agree(label, got[label], rows, T, sums) == (len(rows["x"]), 0, 0.0)
        bound = np.max([cs._row_bounds(rows, T, s)[0] for s in sums], axis=0)
        filled = rows["lh"] > -1e30
        far = dict(got[label], lh=got[label]["lh"] + np.where(filled, 3 * bound, 0.0))
        with pytest.raises(AssertionError, match="lh apart"):
            cs.rows_agree(label, far, rows, T, sums)
        moved = dict(got[label], x=np.roll(got[label]["x"], 1))
        with pytest.raises(AssertionError, match="differ"):
            cs.rows_agree(label, moved, rows, T, sums)
