"""The port's search limits and the JAX package's environment switches.

- K: the search wrappers have no cap on K (K2-K5 keep lists past 64 in the
  maps on the card); the only limit is the (K, SH, SW) maps' memory: when
  the card cannot hold them the wrappers raise an error that names the
  size (tested here with a faked out-of-memory allocator). The K =
  128 twin equals the JAX package's ``search_topk_shift`` (XLA): both
  sides' lh within the float64 bound of tests/test_torch_search_kernel.py,
  indices equal except where two candidates' lh tie within it at the pixel
  (the documented tie rule, ROADMAP Queue 3).
- switches: the five search switches the JAX package reads that change
  results are honoured: set or at its default, each gives the JAX
  package's ``StackSearch`` results. The two pipeline switches are
  honoured too: set, ``KB_SEARCH_CKPT_DIR`` leaves the search's tiles and
  manifest in its directory (with the rows of a run without it) and
  ``KB_PROFILE_DIR`` a Chrome trace in its; at their default nothing is
  written. Switches that only pick a TPU route are ignored on one device.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbmod_tpu.ops.search import search_topk_shift, trajectory_offsets
from kbmod_tpu.search import StackSearch as JStackSearch
from kbmod_tpu.trajectory_generator import KBMODV1Search

from kbmod_tpu_torch.configuration import SearchConfiguration
from kbmod_tpu_torch.fake_data.fake_data_creator import FakeDataSet, create_fake_times
from kbmod_tpu_torch.ops import search_encoded_kernel, search_kernel
from kbmod_tpu_torch.run_search import SearchRunner, configure_kb_search_stack
from kbmod_tpu_torch.search import StackSearch, Trajectory
from test_torch_search_kernel import assert_lh_match, f64_lh
from test_torch_stack_search import OBJ, _assert_rows_match, _pair, candidates, stack  # noqa: F401

CSRC = Path(search_kernel.__file__).resolve().parent.parent / "csrc"
K = 128

# name -> (a non-default value, the default value)
SEARCH_SWITCHES = {
    "KB_SNAP_ROW_ERROR": ("0.5", "0"),
    "KB_COMPACT_RESULTS": ("0", "1"),
    "KB_SIGMAG_MODE": ("exact", "overprovision"),
    "KB_SIGMAG_TOPK_FACTOR": ("8", "4"),
    "KB_SIGMAG_AUTO": ("0", "1"),
}
PIPELINE_SWITCHES = {
    "KB_SEARCH_CKPT_DIR": ("ckpt", ""),
    "KB_PROFILE_DIR": ("profile", ""),
}
ROUTE_SWITCHES = {"KB_SEARCH_KERNEL": "xla", "KB_SHARDED": "1", "KB_SHARD_MODE": "pixels", "KB_TIMING": "1"}


def test_no_k_cap_left():
    assert not hasattr(search_kernel, "MAX_K")
    assert not hasattr(search_encoded_kernel, "MAX_K")
    # Every search kernel has the instantiation that keeps a list in the maps.
    assert "CALL(kb_encoded::kMapList)" in (CSRC / "encoded_common.cuh").read_text()
    for src in ("search_topk.cu", "search_topk_grouped.cu", "search_topk_encoded.cu", "search_topk_encoded_grouped.cu"):
        text = (CSRC / src).read_text()
        assert "KB == kb_encoded::kMapList" in text, src
        assert "K_out <= 64," not in text, src


def test_map_memory_is_the_limit(monkeypatch):
    lh, idx = search_kernel.allocate_maps(K, 3, 5, "cpu", "search_topk")
    assert lh.shape == idx.shape == (K, 3, 5) and lh.dtype == torch.float32 and idx.dtype == torch.int32
    # A card that cannot hold the maps: its allocator's out-of-memory error
    # becomes one that names the maps' size.
    real_empty = torch.empty

    def full_card(shape, **kw):
        if int(np.prod(shape)) * 4 > 1 << 30:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return real_empty(shape, **kw)

    monkeypatch.setattr(torch, "empty", full_card)
    search_kernel.allocate_maps(K, 256, 2048, "cpu", "search_topk")  # 2 x 256 MiB fit
    with pytest.raises(ValueError, match=r"search_grouped: the \(K=128, 2048, 2048\) top-K maps need 4294967296 bytes"):
        search_kernel.allocate_maps(K, 2048, 2048, "cpu", "search_grouped")


@pytest.mark.parametrize("wrapper", ["search_encoded", "search_paired", "search_grouped"])
def test_cpu_wrappers_take_long_lists(wrapper):
    """On the CPU each wrapper runs its twin at any K."""
    rng = np.random.default_rng(2)
    T, H, W, C = 5, 12, 16, 140
    psi = torch.as_tensor(rng.integers(0, 256, (T, H, W)).astype(np.uint8))
    phi = torch.as_tensor(rng.integers(1, 256, (T, H, W)).astype(np.uint8))
    from kbmod_tpu_torch.ops.search import EncodedPlanes
    from kbmod_tpu_torch.ops.search_plan import grouped_plan

    planes = EncodedPlanes(psi, phi, np.array([-6.0, 12.0 / 254, 0.1, 4.0 / 254], np.float32))
    dxs, dys = trajectory_offsets(rng.uniform(-3, 3, C), rng.uniform(-3, 3, C), np.linspace(0, 1, T))
    kw = dict(x_min=0, x_max=W, y_min=0, y_max=H, k_results=K)
    extra = dict(plan=grouped_plan(dys)[0]) if wrapper == "search_grouped" else {}
    lh, idx = getattr(search_encoded_kernel, wrapper)(planes, torch.as_tensor(dxs), torch.as_tensor(dys), 1.0, 0.0,
                                                      **kw, **extra)
    assert lh.shape == (K, H, W) and int((idx[-1] >= 0).sum()) > 0


def test_k128_twin_matches_jax():
    rng = np.random.default_rng(128)
    T, H, W, C = 5, 20, 24, 160
    times = np.arange(T) * 0.35
    valid = (rng.uniform(size=(T, H, W)) > 0.07).astype(np.uint8)
    psi = np.where(valid, rng.normal(0, 1, (T, H, W)), 0).astype(np.float32)
    phi = np.where(valid, rng.uniform(0.5, 2.0, (T, H, W)), 0).astype(np.float32)
    dxs, dys = trajectory_offsets(rng.uniform(-6, 6, C), rng.uniform(-6, 6, C), times)
    kw = dict(x_min=-2, x_max=W, y_min=0, y_max=H + 1, k_results=K)
    ref_lh, ref_idx = (np.asarray(a) for a in search_topk_shift(
        jnp.asarray(psi), jnp.asarray(phi), jnp.asarray(valid), jnp.asarray(dxs), jnp.asarray(dys),
        jnp.float32(2.0), jnp.float32(0.0), **kw))
    args = [torch.as_tensor(a) for a in (psi, phi, valid, dxs, dys)]
    lh, idx = (a.numpy() for a in search_kernel.search_topk(*args, 2.0, 0.0, **kw))
    assert lh.shape == (K, H + 1, W + 2) and int((idx[-1] >= 0).sum()) > 0
    one = dict(kw, k_results=1)
    own = [search_kernel.search_topk(*args[:3], args[3][c : c + 1], args[4][c : c + 1], 2.0, 0.0, **one)[0][0].numpy()
           for c in range(C)]
    assert_lh_match((lh, idx), (ref_lh, ref_idx), own, *f64_lh(psi, phi, valid, dxs, dys, -2, W, 0, H + 1))


def _small_search():
    times = create_fake_times(6, t0=57130.2, obs_per_day=3)
    ds = FakeDataSet(20, 18, times, use_seed=3)
    ds.insert_object(Trajectory(x=9, y=8, vx=3.0, vy=1.0, flux=300.0))
    st = ds.stack_py
    s = StackSearch(st.sci, st.var, st.psfs, st.zeroed_times, -1, device="cpu")
    s.set_min_obs(3)
    return s, st


@pytest.mark.parametrize("default", [False, True], ids=["set", "default"])
@pytest.mark.parametrize("name", sorted(SEARCH_SWITCHES))
def test_search_switches_honoured(monkeypatch, stack, candidates, name, default):
    """Each search switch, set or at its default, gives the JAX package's
    results: the two searches run on the JAX package's planes of the stack
    of tests/test_torch_stack_search.py, with the in-kernel sigma-G filter
    over its 36 candidates at 2 results a pixel (the pool of 8 or 16 is
    smaller than the grid)."""
    monkeypatch.setenv(name, SEARCH_SWITCHES[name][1 if default else 0])
    ref, got = _pair(stack)
    for s in (ref, got):
        s.set_min_obs(5)
        s.set_results_per_pixel(2)
        s.enable_gpu_sigmag_filter([0.25, 0.75], 0.7413, 3.0)
        s.search_all(candidates, True)
    _assert_rows_match(ref.results, got.results, got)
    best = got.get_results(0, 1)[0]
    assert (best.x, best.y) == (OBJ["x"], OBJ["y"])
    if name == "KB_SNAP_ROW_ERROR" and not default:
        q = 2 * 0.5 / float(stack.zeroed_times[-1])
        vy = got.results.get_arrays()["vy"].astype(np.float64)
        assert np.allclose(vy, np.round(vy / q) * q, atol=1e-5)


def test_sigmag_refinement_flag_on_a_rounding(monkeypatch):
    """Where the clipping keeps every sample, a pixel's kept clipped lh and
    its pool's unclipped floor are the same number, and the reference's
    boundary-inversion flag (kept floor < pool floor) turns on a rounding.
    On this stack (8 offset classes among 30 candidates, so every pool
    ties) the port's K2 rounds the pool 1 ulp above its host re-score and
    refines pixel (6, 1) to the exact mode's answer (lh 3.0862); the JAX
    package, with the same flag on its own roundings, returns either that
    or its unrefined pool (lh 2.8545; XLA on the CPU here rounds the two
    equal). ROADMAP Queue 3."""
    _, st = _small_search()
    cands = list(KBMODV1Search(5, 1.0, 4.0, 6, -0.2, 0.6))

    def rows_at(search_cls, **kw):
        s = search_cls(st.sci, st.var, st.psfs, st.zeroed_times, -1, **kw)
        s.set_min_obs(3)
        s.set_results_per_pixel(2)
        s.enable_gpu_sigmag_filter([0.25, 0.75], 0.7413, 1.0)
        s.search_all(cands, True)
        a = s.results.get_arrays()
        at = (a["x"] == 6) & (a["y"] == 1)
        return sorted(zip(a["vx"][at].tolist(), a["lh"][at].tolist()))

    port, ref = rows_at(StackSearch, device="cpu"), rows_at(JStackSearch)
    monkeypatch.setenv("KB_SIGMAG_AUTO", "0")
    unrefined = rows_at(JStackSearch)
    monkeypatch.setenv("KB_SIGMAG_MODE", "exact")
    exact = rows_at(JStackSearch)
    assert [vx for vx, _ in port] == [vx for vx, _ in exact] != [vx for vx, _ in unrefined]
    np.testing.assert_allclose([lh for _, lh in port], [lh for _, lh in exact], rtol=1e-5)
    assert max(lh for _, lh in unrefined) < min(lh for _, lh in exact) - 0.2
    assert [vx for vx, _ in ref] in ([vx for vx, _ in exact], [vx for vx, _ in unrefined])


@pytest.mark.parametrize("default", [False, True], ids=["set", "default"])
@pytest.mark.parametrize("name", sorted(PIPELINE_SWITCHES))
def test_pipeline_switches_honoured(monkeypatch, tmp_path, name, default):
    s, st = _small_search()
    config = SearchConfiguration(dict(
        generator_config={"name": "SingleVelocitySearch", "vx": 3.0, "vy": 1.0}, num_obs=3, lh_level=1.0,
        do_clustering=False, save_config=False,
    ))
    plain = SearchRunner().run_search(config, st, device="cpu")
    value = PIPELINE_SWITCHES[name][1 if default else 0]
    monkeypatch.setenv(name, str(tmp_path / value) if value else "")
    monkeypatch.setenv("KB_SEARCH_CKPT_TILE_ROWS", "7")
    configure_kb_search_stack(s, config)
    keep = SearchRunner().run_search(config, st, device="cpu")
    assert len(keep) > 0
    for col in ("x", "y", "vx", "vy", "likelihood", "flux", "obs_count"):
        np.testing.assert_array_equal(keep[col], plain[col], err_msg=col)
    written = sorted(p.relative_to(tmp_path).as_posix() for p in tmp_path.rglob("*") if p.is_file())
    if default:
        assert s._checkpoint_dir is None
        assert written == []
    elif name == "KB_SEARCH_CKPT_DIR":
        assert s._checkpoint_dir == str(tmp_path / "ckpt") and s._checkpoint_tile_rows == 7
        # 18 rows in tiles of 7.
        assert written == ["ckpt/manifest.json", "ckpt/tile_0_7.npz", "ckpt/tile_14_18.npz", "ckpt/tile_7_14.npz"]
    else:
        assert len(written) == 1 and written[0].startswith("profile/kbmod_trace_"), written
        with open(tmp_path / written[0]) as f:
            trace = json.load(f)
        assert trace["traceEvents"]


def test_route_switches_ignored(monkeypatch):
    # KB_SHARDED takes effect only with more than one shard: a search on the
    # CPU has none unless a mesh of CPU devices is given (test_torch_sharded).
    s, _ = _small_search()
    for name, value in ROUTE_SWITCHES.items():
        monkeypatch.setenv(name, value)
    s.search_all([Trajectory(vx=3.0, vy=1.0)], True)
    assert s.get_results(0, 1)[0].x == 9
