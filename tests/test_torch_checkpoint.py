"""Per-tile checkpoint/resume of the port's core search
(kbmod_tpu_torch/search/checkpoint.py), mirroring every case of
tests/test_search_checkpoint.py on the port: the tiled output equals the
un-tiled search exactly, a resume reuses the finished tiles, a stale
directory is discarded.

New cases: the fingerprint sees a one-pixel change in any plane, also in a
plane the JAX package's 8-row sample skips (its fingerprint is shown to
miss it); a writer that fails mid-run leaves only complete tiles, which a
resume loads; the port's checkpointed ``StackSearch`` equals the JAX
package's on the same float and uint8 planes, within ROADMAP Queue 3's
tolerances (the row helpers of tests/test_torch_stack_search.py and
tests/test_torch_stack_search_quantized.py).
"""

import os

import numpy as np
import pytest
import torch

from kbmod_tpu.fake_data.fake_data_creator import FakeDataSet, create_fake_times
from kbmod_tpu.ops.psi_phi import generate_psi_phi_from_image_stack
from kbmod_tpu.search import Trajectory
from kbmod_tpu.search.checkpoint import _fingerprint as jax_fingerprint
from kbmod_tpu.trajectory_generator import KBMODV1Search, VelocityGridSearch

import kbmod_tpu_torch.search.checkpoint as ckmod
from kbmod_tpu_torch.ops.psi_phi import PsiPhiArray, fill_psi_phi_array
from kbmod_tpu_torch.ops.search import EncodedPlanes, core_search
from kbmod_tpu_torch.parallel import build_mesh
from kbmod_tpu_torch.search import StackSearch
from kbmod_tpu_torch.search.checkpoint import _fingerprint, checkpointed_core_search
import test_torch_stack_search as float_pair
import test_torch_stack_search_quantized as quant_pair

H, W = 48, 56


@pytest.fixture(scope="module")
def setup():
    times = create_fake_times(6, t0=57130.0, obs_per_day=3)
    ds = FakeDataSet(H, W, times, use_seed=21)
    ds.insert_object(Trajectory(x=20, y=30, vx=4.0, vy=-2.0, flux=350.0))
    stack = ds.stack_py
    psi, phi = (np.asarray(a) for a in generate_psi_phi_from_image_stack(stack))
    ok = np.isfinite(psi) & np.isfinite(phi)
    vxg, vyg = np.meshgrid(np.linspace(2.0, 6.0, 4).astype(np.float32), np.linspace(-4.0, 0.0, 4).astype(np.float32))
    return dict(
        psi=torch.as_tensor(np.where(ok, psi, 0.0).astype(np.float32)),
        phi=torch.as_tensor(np.where(ok, phi, 0.0).astype(np.float32)),
        valid=torch.as_tensor(ok.astype(np.uint8)),
        times=np.asarray(stack.zeroed_times, dtype=np.float32),
        vxs=vxg.ravel(), vys=vyg.ravel(), stack=stack,
    )


def _args(s, rpp=2, vxs=None, vys=None, phi=None, valid=None):
    return (s["psi"], s["phi"] if phi is None else phi, s["valid"] if valid is None else valid, s["times"],
            s["vxs"] if vxs is None else vxs, s["vys"] if vys is None else vys, 0, W, 0, H, rpp)


def _assert_equal(out, ref):
    assert set(out) == set(ref)
    for key in ref:
        np.testing.assert_array_equal(out[key], ref[key], err_msg=key)


def _tiles(ck):
    return sorted(f for f in os.listdir(ck) if f.startswith("tile_"))


class TestCheckpointedSearch:
    def test_matches_untiled(self, setup, tmp_path):
        kwargs = dict(min_obs=3, min_lh=0.0, gate_min_obs=True)
        ref = core_search(*_args(setup, 3), **kwargs)
        out = checkpointed_core_search(*_args(setup, 3), checkpoint_dir=str(tmp_path / "ck"), tile_rows=13, **kwargs)
        _assert_equal(out, ref)
        # ceil(48 / 13) = 4 files.
        assert _tiles(tmp_path / "ck") == ["tile_0_13.npz", "tile_13_26.npz", "tile_26_39.npz", "tile_39_48.npz"]

    def test_resume_uses_tiles(self, setup, tmp_path, monkeypatch):
        ck = str(tmp_path / "ck2")
        first = checkpointed_core_search(*_args(setup), checkpoint_dir=ck, tile_rows=16)

        def boom(*a, **k):
            raise AssertionError("core_search called on full resume")

        monkeypatch.setattr(ckmod.search_ops, "core_search", boom)
        timings = {}
        second = checkpointed_core_search(*_args(setup), checkpoint_dir=ck, tile_rows=16, timings=timings)
        _assert_equal(second, first)
        assert timings["tiles_loaded"] == 3 and timings["search_ms"] == 0.0

    def test_partial_resume(self, setup, tmp_path):
        ck = str(tmp_path / "ck3")
        full = checkpointed_core_search(*_args(setup), checkpoint_dir=ck, tile_rows=16)
        # A crash that lost one tile: it is recomputed, the others reused.
        os.remove(os.path.join(ck, "tile_16_32.npz"))
        timings = {}
        again = checkpointed_core_search(*_args(setup), checkpoint_dir=ck, tile_rows=16, timings=timings)
        _assert_equal(again, full)
        assert timings["tiles_loaded"] == 2 and "tile_16_32.npz" in _tiles(ck)

    def test_stale_checkpoint_discarded(self, setup, tmp_path):
        ck = str(tmp_path / "ck4")
        checkpointed_core_search(*_args(setup), checkpoint_dir=ck, tile_rows=16)
        # Another candidate set: the fingerprint differs, the search is fresh.
        vxs, vys = setup["vxs"][:5], setup["vys"][:5]
        timings = {}
        out = checkpointed_core_search(*_args(setup, vxs=vxs, vys=vys), checkpoint_dir=ck, tile_rows=16,
                                       timings=timings)
        _assert_equal(out, core_search(*_args(setup, vxs=vxs, vys=vys)))
        assert timings["tiles_loaded"] == 0

    def test_cleanup(self, setup, tmp_path):
        ck = str(tmp_path / "ck5")
        checkpointed_core_search(*_args(setup), checkpoint_dir=ck, tile_rows=24, cleanup=True)
        assert os.listdir(ck) == []

    def test_stack_search_integration(self, setup, tmp_path):
        stack = setup["stack"]
        cands = [Trajectory(vx=vx, vy=vy) for vx, vy in zip(setup["vxs"], setup["vys"])]

        def run(ck=None):
            s = StackSearch(stack.sci, stack.var, stack.psfs, stack.zeroed_times, -1, device="cpu")
            s.set_min_obs(3)
            if ck:
                s.enable_search_checkpointing(ck, tile_rows=16)
            s.search_all(cands, True)
            return s.results.get_arrays(), s.timings

        plain, _ = run()
        ck = str(tmp_path / "ck6")
        tiled, t_tiled = run(ck)
        resumed, t_resumed = run(ck)  # every tile on disk
        _assert_equal(tiled, plain)
        _assert_equal(resumed, plain)
        assert t_tiled["tiles_loaded"] == 0 and t_tiled["search_ms"] > 0 and t_tiled["fingerprint_ms"] > 0
        # The stack is 56 rows high: 4 tiles.
        assert t_resumed["tiles_loaded"] == 4


class TestFingerprintCoverage:
    def test_phi_only_change_rejects_checkpoint(self, setup, tmp_path):
        ck = str(tmp_path / "ck_phi")
        checkpointed_core_search(*_args(setup), checkpoint_dir=ck, tile_rows=16)
        phi2 = setup["phi"] * 1.7
        out = checkpointed_core_search(*_args(setup, phi=phi2), checkpoint_dir=ck, tile_rows=16)
        _assert_equal(out, core_search(*_args(setup, phi=phi2)))

    def test_valid_only_change_rejects_checkpoint(self, setup, tmp_path):
        ck = str(tmp_path / "ck_valid")
        checkpointed_core_search(*_args(setup), checkpoint_dir=ck, tile_rows=16)
        valid2 = setup["valid"].clone()
        valid2[:, ::3, ::3] = 0
        # psi and phi are unchanged; the validity plane itself trips it.
        out = checkpointed_core_search(*_args(setup, valid=valid2), checkpoint_dir=ck, tile_rows=16)
        _assert_equal(out, core_search(*_args(setup, valid=valid2)))

    def test_callable_kwargs_fingerprint(self, setup, tmp_path):
        """Callable keyword arguments hash by presence, and a search_fn that
        takes one still checkpoints."""
        s = setup
        bounds = (0, W, 0, H)
        fp1 = _fingerprint(s["psi"], s["phi"], s["valid"], s["times"], s["vxs"], s["vys"], bounds, 2,
                           {"provider": lambda: None, "min_obs": 3})
        fp2 = _fingerprint(s["psi"], s["phi"], s["valid"], s["times"], s["vxs"], s["vys"], bounds, 2,
                           {"provider": lambda: "different body", "min_obs": 3})
        assert fp1 == fp2

        def tile_search(psi_, phi_, valid_, times_, vxs_, vys_, x0, x1, y0, y1, rpp, **kw):
            kw.pop("provider")
            return core_search(psi_, phi_, valid_, times_, vxs_, vys_, x0, x1, y0, y1, rpp, **kw)

        out = checkpointed_core_search(*_args(setup), checkpoint_dir=str(tmp_path / "ck_callable"), tile_rows=16,
                                       search_fn=tile_search, provider=lambda: None)
        _assert_equal(out, core_search(*_args(setup)))

    def test_sharded_stack_search_checkpointing(self, setup, tmp_path, monkeypatch):
        """Checkpointing composes with the mesh-sharded search path (a mesh
        of four CPU shards)."""
        import kbmod_tpu_torch.parallel.sharded as sharded
        import kbmod_tpu_torch.search.stack_search as stack_search

        stack = setup["stack"]
        cands = [Trajectory(vx=vx, vy=vy) for vx, vy in zip(setup["vxs"], setup["vys"])]

        def run(ck=None):
            s = StackSearch(stack.sci, stack.var, stack.psfs, stack.zeroed_times, -1, device="cpu")
            s.set_min_obs(3)
            if ck:
                s.enable_search_checkpointing(ck, tile_rows=16)
            s.search_all(cands, True)
            return s.results.get_arrays()

        plain = run()
        monkeypatch.setenv("KB_SHARDED", "1")
        monkeypatch.setattr(sharded, "build_mesh", lambda: build_mesh(devices=["cpu"] * 4))
        used = []
        real = stack_search.sharded_core_search
        monkeypatch.setattr(stack_search, "sharded_core_search", lambda *a, **k: used.append(1) or real(*a, **k))
        ck = str(tmp_path / "ck_sharded")
        tiled = run(ck)
        assert _tiles(ck) == ["tile_0_16.npz", "tile_16_32.npz", "tile_32_48.npz", "tile_48_56.npz"]
        assert len(used) == 4
        resumed = run(ck)
        assert len(used) == 4
        _assert_equal(tiled, plain)
        _assert_equal(resumed, plain)


@pytest.fixture(scope="module")
def long_stack():
    """T = 20 planes: the JAX package's sample takes every second one."""
    rng = np.random.default_rng(8)
    T, h, w = 20, 16, 16
    psi = rng.normal(0, 1, (T, h, w)).astype(np.float32)
    phi = rng.uniform(0.5, 2.0, (T, h, w)).astype(np.float32)
    valid = (rng.uniform(size=(T, h, w)) > 0.05).astype(np.uint8)
    return psi * valid, phi * valid, valid, np.arange(T) * 0.3


@pytest.mark.parametrize("plane", ["psi", "phi", "valid", "codes"])
def test_one_pixel_outside_jax_sample_detected(long_stack, tmp_path, plane):
    """A one-pixel change in plane 3 (skipped by the JAX package's sample of
    every second plane) of any plane set: the JAX fingerprint misses it, the
    port's sees it and discards the directory."""
    psi, phi, valid, times = long_stack
    vxs = np.array([0.0, 1.0, -2.0], np.float32)
    vys = np.array([0.5, -1.0, 2.0], np.float32)
    bounds = (0, 16, 0, 16)
    changed = {"psi": psi.copy(), "phi": phi.copy(), "valid": valid.copy()}
    if plane == "codes":
        arr, arr2 = PsiPhiArray(), PsiPhiArray()
        fill_psi_phi_array(arr, 1, list(psi), list(phi), times, device="cpu")
        fill_psi_phi_array(arr2, 1, list(psi), list(phi), times, device="cpu")
        pairs = arr2.code_pairs()
        pairs[3, 9, 11, 1] = pairs[3, 9, 11, 1] % 254 + 1
        before = (EncodedPlanes(arr.psi, arr.phi, arr.encode_meta(), arr.code_pairs()), None, None)
        after = (EncodedPlanes(arr2.psi, arr2.phi, arr2.encode_meta(), pairs), None, None)
        j_before = (np.asarray(arr.psi), np.asarray(arr.phi), None)
        j_after = (np.asarray(arr2.psi), np.asarray(arr2.phi), None)
        assert not np.array_equal(j_before[1], j_after[1])
    else:
        changed[plane][3, 9, 11] = 1 - changed[plane][3, 9, 11] if plane == "valid" else changed[plane][3, 9, 11] + 0.5
        j_before = (psi, phi, valid)
        j_after = (changed["psi"], changed["phi"], changed["valid"])
        before = tuple(torch.as_tensor(a) for a in j_before)
        after = tuple(torch.as_tensor(a) for a in j_after)
    assert jax_fingerprint(*j_before, times, vxs, vys, bounds, 2, {}) == jax_fingerprint(
        *j_after, times, vxs, vys, bounds, 2, {})
    assert _fingerprint(*before, times, vxs, vys, bounds, 2, {}) != _fingerprint(
        *after, times, vxs, vys, bounds, 2, {})
    ck = str(tmp_path / "ck")
    checkpointed_core_search(*before, times, vxs, vys, *bounds, 2, ck, tile_rows=8)
    timings = {}
    out = checkpointed_core_search(*after, times, vxs, vys, *bounds, 2, ck, tile_rows=8, timings=timings)
    assert timings["tiles_loaded"] == 0
    _assert_equal(out, core_search(*after, times, vxs, vys, *bounds, 2))


def test_failed_write_leaves_only_complete_tiles(setup, tmp_path, monkeypatch):
    """A writer that dies on its second tile, halfway through the file: the
    search raises, the directory holds the first tile complete and no
    other ``tile_*.npz``; a resume loads that tile (and not the hidden
    partial file) and computes the rest, equal to the un-tiled search."""
    ck = str(tmp_path / "ck_kill")
    real = np.savez
    calls = []

    def dying(path, **arrays):
        calls.append(path)
        if len(calls) == 2:
            with open(path, "wb") as f:
                f.write(b"PK\x03\x04 partial")
            raise OSError("killed mid-write")
        real(path, **arrays)

    monkeypatch.setattr(ckmod.np, "savez", dying)
    with pytest.raises(OSError, match="killed mid-write"):
        checkpointed_core_search(*_args(setup), checkpoint_dir=ck, tile_rows=16)
    monkeypatch.setattr(ckmod.np, "savez", real)
    assert _tiles(ck) == ["tile_0_16.npz"]
    assert ".tile_16_32.npz.tmp.npz" in os.listdir(ck)
    timings = {}
    out = checkpointed_core_search(*_args(setup), checkpoint_dir=ck, tile_rows=16, timings=timings)
    assert timings["tiles_loaded"] == 1
    _assert_equal(out, core_search(*_args(setup)))
    assert _tiles(ck) == ["tile_0_16.npz", "tile_16_32.npz", "tile_32_48.npz"]


@pytest.mark.parametrize("num_bytes", [-1, 1], ids=["float", "uint8"])
def test_checkpointed_stack_search_matches_jax(tmp_path, monkeypatch, num_bytes):
    """The port's checkpointed StackSearch, fresh and resumed, against the
    JAX package's checkpointed StackSearch on the JAX package's planes."""
    if num_bytes == -1:
        # The stack and grid of tests/test_torch_stack_search.py.
        mod = float_pair
        times = create_fake_times(8, t0=57130.2, obs_per_day=2, intra_night_gap=0.05)
        ds = FakeDataSet(44, 38, times, psf_val=1.0, mask_fraction=0.04, use_seed=77)
        ds.insert_object(Trajectory(**float_pair.OBJ))
        cands = list(KBMODV1Search(6, 2.0, 6.0, 6, -0.6, 0.2))
        ref, got = mod._pair(ds.stack_py)
    else:
        # The stack and grid of tests/test_torch_stack_search_quantized.py.
        mod = quant_pair
        monkeypatch.setenv("KB_SEARCH_KERNEL", "pallas")
        times = create_fake_times(6, t0=57130.2, obs_per_day=3)
        ds = FakeDataSet(32, 30, times, use_seed=3, mask_fraction=0.02)
        ds.insert_object(Trajectory(**quant_pair.OBJ))
        cands = list(VelocityGridSearch(7, 0.5, 5.0, 6, -1.0, 3.0))
        ref, got = mod._pair(ds.stack_py, num_bytes)
    for side, s in (("jax", ref), ("port", got)):
        s.set_results_per_pixel(3)
        s.set_min_obs(4)
        s.enable_search_checkpointing(str(tmp_path / side), tile_rows=7)
        s.search_all(cands, True)
    mod._assert_rows_match(ref.results, got.results, got)
    first = got.results.get_arrays()
    got.search_all(cands, True)
    assert got.timings["tiles_loaded"] == len(_tiles(tmp_path / "port")) > 1
    _assert_equal(got.results.get_arrays(), first)
    assert _tiles(tmp_path / "port") == _tiles(tmp_path / "jax")
