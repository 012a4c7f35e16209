"""The port's search limits and the JAX package's environment switches.

- K: the search wrappers have no cap on K (K2-K5 keep lists past 64 in the
  maps on the card); the only limit is the (K, SH, SW) maps' memory: when
  the card cannot hold them the wrappers raise an error that names the
  size (tested here with a faked out-of-memory allocator). The K =
  128 twin equals the JAX package's ``search_topk_shift`` (XLA): lh within
  2 float32 ulps, indices equal except where two candidates' lh tie that
  closely at the pixel (the documented tie rule, ROADMAP Queue 3).
- switches: each of the seven switches the JAX package reads that changes
  results, set to a value other than its default, raises
  NotImplementedError naming it (the five search switches in
  ``StackSearch.search_all``, the two pipeline switches in
  ``SearchRunner.run_search`` and ``configure_kb_search_stack``); set to its
  default it does not. Switches that only pick a TPU route are ignored.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbmod_tpu.ops.search import search_topk_shift, trajectory_offsets

from kbmod_tpu_torch.configuration import SearchConfiguration
from kbmod_tpu_torch.fake_data.fake_data_creator import FakeDataSet, create_fake_times
from kbmod_tpu_torch.ops import search_encoded_kernel, search_kernel
from kbmod_tpu_torch.run_search import SearchRunner, configure_kb_search_stack
from kbmod_tpu_torch.search import StackSearch, Trajectory

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


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


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
    assert np.all(np.sign(lh) == np.sign(ref_lh)) and _ulps(lh, ref_lh).max() <= 2
    one = dict(kw, k_results=1)
    own = [search_kernel.search_topk(*args[:3], args[3][c : c + 1], args[4][c : c + 1], 2.0, 0.0, **one)[0][0].numpy()
           for c in range(C)]
    for k, i, j in np.argwhere(idx != ref_idx):
        a, b = idx[k, i, j], ref_idx[k, i, j]
        assert a >= 0 and b >= 0 and _ulps(own[a][i, j], own[b][i, j]) <= 2, (k, i, j)


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
def test_search_switches_refused(monkeypatch, name, default):
    s, _ = _small_search()
    monkeypatch.setenv(name, SEARCH_SWITCHES[name][1 if default else 0])
    cands = [Trajectory(vx=3.0, vy=1.0), Trajectory(vx=0.0, vy=0.0)]
    if default:
        s.search_all(cands, True)
        assert s.get_results(0, 1)[0].x == 9
    else:
        with pytest.raises(NotImplementedError, match=name):
            s.search_all(cands, True)


@pytest.mark.parametrize("default", [False, True], ids=["set", "default"])
@pytest.mark.parametrize("name", sorted(PIPELINE_SWITCHES))
def test_pipeline_switches_refused(monkeypatch, tmp_path, name, default):
    s, st = _small_search()
    value = PIPELINE_SWITCHES[name][1 if default else 0]
    monkeypatch.setenv(name, str(tmp_path / value) if value else "")
    config = SearchConfiguration(dict(
        generator_config={"name": "SingleVelocitySearch", "vx": 3.0, "vy": 1.0}, num_obs=3, lh_level=1.0,
        do_clustering=False, save_config=False,
    ))
    if default:
        configure_kb_search_stack(s, config)
        assert len(SearchRunner().run_search(config, st, device="cpu")) > 0
    else:
        with pytest.raises(NotImplementedError, match=name):
            configure_kb_search_stack(s, config)
        with pytest.raises(NotImplementedError, match=name):
            SearchRunner().run_search(config, st, device="cpu")


def test_route_switches_ignored(monkeypatch):
    s, _ = _small_search()
    for name, value in ROUTE_SWITCHES.items():
        monkeypatch.setenv(name, value)
    s.search_all([Trajectory(vx=3.0, vy=1.0)], True)
    assert s.get_results(0, 1)[0].x == 9
