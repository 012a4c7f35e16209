"""Port parity for the exact sigma-G mode and the search's result-changing
switches: kbmod_tpu_torch against the JAX package on the CPU.

- ``_clipped_scores`` (torch) against the JAX package's
  ``_clipped_scores_jnp`` and the port's host ``clipped_sigmag_scores``.
- ``search_topk_sigmag_exact`` against the JAX one (XLA) on float, uint8
  and uint16 planes (each side decoding its own codes).
- ``snap_vy_rows`` bit for bit; the exact mode and the pool switches
  through ``core_search``, ``StackSearch`` and ``SearchRunner``; the memory
  budget's terms under the switches. The counterparts of
  tests/test_search_sigmag.py, test_snap_rows.py and
  test_core_search_exact.py.

Tolerances. The kept samples of a clipped score are compared exactly
(a sample kept on one side and not the other moves lh by far more than a
rounding); the kept sums are float32 sums in another order, so two clipped
lh may differ by twice the float64 bound of ROADMAP Queue 3, taken over the
valid samples: (T + 1) u sum|psi| / sqrt(kept phi) + 2 u |lh|, u = 2**-24.
Exact-search lh: 1e-5 * max(1, |lh|) against the JAX package (whose XLA
build may fuse the decode's multiply-add and sums in its own order).
Indices are equal except where the two candidates' own clipped lh tie
within that tolerance (ROADMAP Queue 3, "Tie at the top-K boundary").
Result rows compare as in tests/test_torch_stack_search.py and
tests/test_torch_run_search.py.
"""

from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kbmod_tpu.ops import search as jax_ops
from kbmod_tpu.ops.psi_phi import PsiPhiArray, fill_psi_phi_array
from kbmod_tpu.search import StackSearch
from kbmod_tpu.fake_data.fake_data_creator import FakeDataSet, create_fake_times
from kbmod_tpu.search import Trajectory
from kbmod_tpu.trajectory_generator import KBMODV1Search

import kbmod_tpu_torch.run_search as port_run_search
from kbmod_tpu_torch.configuration import SearchConfiguration as TSearchConfiguration
from kbmod_tpu_torch.ops import psi_phi as port_psi_phi
from kbmod_tpu_torch.ops import search as ops
from kbmod_tpu_torch.search import StackSearch as TStackSearch
from kbmod_tpu_torch.search import psi_phi_array_from_numpy
from test_torch_run_search import BASE, _HandedOver, _assert_tables_match, _jax_stack, _port_stack
from test_torch_stack_search import _assert_rows_match

U = 2.0 ** -24
TOL = 1e-5
COEFF = 0.7413
FLT_MIN = -float(np.finfo(np.float32).max)


def _curves(seed, N=600, T=11):
    """(N, T) curves with spikes of both signs and masked samples, rows of
    every validity count (none, one, all) included."""
    rng = np.random.default_rng(seed)
    psi = rng.normal(1.0, 0.5, (N, T)).astype(np.float32)
    hit = rng.random((N, T)) < 0.1
    psi[hit] = rng.choice([-40.0, 40.0], int(hit.sum()))
    phi = rng.uniform(0.5, 2.0, (N, T)).astype(np.float32)
    ok = rng.random((N, T)) > 0.15
    ok[0], ok[1], ok[2] = False, False, True
    ok[1, 3] = True
    phi[5, :] = 0.0  # valid samples with phi 0 (lc 0)
    return np.where(ok, psi, 0).astype(np.float32), np.where(ok, phi, 0).astype(np.float32), ok


def _clipped_bound(psi_v, ok, new_phi, lh):
    """Twice the Queue 3 float64 bound of a clipped lh, over the valid
    samples' |psi| and the kept phi sum."""
    T = psi_v.shape[1]
    good = new_phi > 0
    root = np.sqrt(np.where(good, new_phi.astype(np.float64), 1.0))
    b = (T + 1) * U * np.abs(np.where(ok, psi_v, 0)).astype(np.float64).sum(axis=1) / root + 2 * U * np.abs(lh)
    return 2 * np.where(good, b, 0.0)


@pytest.mark.parametrize("lims", [(0.25, 0.75), (0.16, 0.84), (0.0, 1.0)], ids=["25-75", "16-84", "clamped"])
def test_clipped_scores_match(lims):
    psi_v, phi_v, ok = _curves(sum(int(100 * q) for q in lims))
    got_lh, got_flux = (a.numpy() for a in ops._clipped_scores(
        torch.as_tensor(psi_v), torch.as_tensor(phi_v), torch.as_tensor(ok), *lims, COEFF))
    host_lh, host_flux, _, host_phi = ops.clipped_sigmag_scores(psi_v, phi_v, ok, *lims, COEFF)
    ref_lh, ref_flux = (np.asarray(a) for a in jax_ops._clipped_scores_jnp(
        jnp.asarray(psi_v), jnp.asarray(phi_v), jnp.asarray(ok), *lims, COEFF))
    assert got_lh.dtype == np.float32 and got_lh.shape == (len(psi_v),)
    bound = _clipped_bound(psi_v, ok, host_phi, host_lh)
    for want_lh, want_flux in ((host_lh, host_flux), (ref_lh, ref_flux)):
        assert np.all((got_lh == -1) == (want_lh == -1))
        assert np.all(np.abs(got_lh.astype(np.float64) - want_lh) <= bound)
        np.testing.assert_allclose(got_flux, want_flux, rtol=TOL, atol=TOL)
    assert got_lh[0] == -1.0 and got_flux[0] == -1.0  # no valid sample


def _codes(psi, phi, num_bytes):
    """The JAX package's code planes and decode vector of NaN-masked
    (T, H, W) float planes."""
    arr = PsiPhiArray()
    fill_psi_phi_array(arr, num_bytes, list(psi), list(phi), np.arange(len(psi), dtype=np.float64))
    m = arr.meta
    em = np.array([m.psi_min_val, m.psi_scale, m.phi_min_val, m.phi_scale], dtype=np.float32)
    return np.asarray(arr.psi), np.asarray(arr.phi), em


def _port_codes(pc, fc, em):
    """The port's EncodedPlanes over numpy uint8 or uint16 code planes."""
    def tensor(c):
        return torch.as_tensor(c.view(np.int16)).view(torch.uint16) if c.dtype == np.uint16 else torch.as_tensor(c)

    return ops.EncodedPlanes(tensor(pc), tensor(fc), em)


def _planes(seed, num_bytes, T=9, H=14, W=16):
    """Float planes with masked samples and spikes, or the JAX package's
    codes of them: (port planes, JAX planes), each (psi, phi, valid)."""
    rng = np.random.default_rng(seed)
    valid = (rng.uniform(size=(T, H, W)) > 0.05).astype(np.uint8)
    psi = rng.normal(1.0, 0.5, (T, H, W))
    hit = rng.random((T, H, W)) < 0.05
    psi[hit] = rng.choice([-30.0, 30.0], int(hit.sum()))
    psi = np.where(valid, psi, np.nan).astype(np.float32)
    phi = np.where(valid, rng.uniform(0.5, 2.0, (T, H, W)), np.nan).astype(np.float32)
    if num_bytes == -1:
        planes = (np.nan_to_num(psi), np.nan_to_num(phi), valid)
        return tuple(torch.as_tensor(a) for a in planes), planes
    pc, fc, em = _codes(psi, phi, num_bytes)
    ref = jax_ops.EncodedPlanes(jnp.asarray(pc), jnp.asarray(fc), jnp.asarray(em)).decode_full()
    port = _port_codes(pc, fc, em).decode_full()
    return port, tuple(np.asarray(a) for a in ref)


@pytest.mark.parametrize("num_bytes", [-1, 1, 2], ids=["float", "uint8", "uint16"])
def test_exact_search_matches_jax(num_bytes):
    port, ref = _planes(5 + num_bytes, num_bytes)
    np.testing.assert_array_equal(port[2].numpy(), ref[2])
    for a, b in zip(port[:2], ref[:2]):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-6)
    T, H, W = ref[0].shape
    rng = np.random.default_rng(num_bytes + 40)
    C = 14
    vx, vy = rng.uniform(-3, 3, C).astype(np.float32), rng.uniform(-3, 3, C).astype(np.float32)
    vy[3] = vy[5]  # a duplicate trajectory: exact ties in index order
    vx[3] = vx[5]
    dxs, dys = jax_ops.trajectory_offsets(vx, vy, np.arange(T) * 0.3)
    kw = dict(x_min=-1, x_max=W, y_min=0, y_max=H + 1, k_results=4, sgl_L=0.25, sgl_H=0.75)
    gates = (4.0, 0.5, COEFF)
    r_lh, r_idx = jax_ops.search_topk_sigmag_exact(*ref, dxs, dys, *gates, row_tile=6, **kw)
    g_lh, g_idx = (a.numpy() for a in ops.search_topk_sigmag_exact(*port, dxs, dys, *gates, row_tile=6, **kw))
    assert g_lh.shape == (4, H + 1, W + 1) and g_lh.dtype == np.float32 and g_idx.dtype == np.int32
    assert np.array_equal(g_idx < 0, r_idx < 0)
    assert np.all(g_lh[g_idx < 0] == FLT_MIN)
    filled = g_idx >= 0
    assert filled.sum() > 0.5 * filled.size
    assert np.all(np.abs(g_lh[filled] - r_lh[filled]) <= TOL * np.maximum(1.0, np.abs(r_lh[filled])))
    own = [ops.search_topk_sigmag_exact(*port, dxs[c:c + 1], dys[c:c + 1], *gates, **dict(kw, k_results=1))[0][0]
           for c in range(C)]
    for k, i, j in np.argwhere(g_idx != r_idx):
        a, b = g_idx[k, i, j], r_idx[k, i, j]
        assert abs(float(own[a][i, j]) - float(own[b][i, j])) <= 2 * TOL * max(1.0, abs(float(own[a][i, j])))
    # The duplicate pair ties exactly wherever it is kept: lower index first.
    for i, j in zip(*np.nonzero((g_idx == 3).any(axis=0) & (g_idx == 5).any(axis=0))):
        col = list(g_idx[:, i, j])
        assert col.index(3) < col.index(5)


def test_exact_tiles_and_chunks_change_nothing(monkeypatch):
    port, _ = _planes(11, -1)
    T, H, W = port[0].shape
    rng = np.random.default_rng(12)
    dxs, dys = jax_ops.trajectory_offsets(rng.uniform(-2, 2, 9), rng.uniform(-2, 2, 9), np.arange(T) * 0.3)
    kw = dict(x_min=0, x_max=W, y_min=0, y_max=H, k_results=3, sgl_L=0.25, sgl_H=0.75)
    whole = ops.search_topk_sigmag_exact(*port, dxs, dys, 3.0, 0.0, COEFF, **kw)
    monkeypatch.setattr(ops, "EXACT_CHUNK_SAMPLES", 1)
    tiled = ops.search_topk_sigmag_exact(*port, dxs, dys, 3.0, 0.0, COEFF, row_tile=4, cand_offset=7, **kw)
    assert torch.equal(whole[0], tiled[0])
    assert torch.equal(torch.where(whole[1] >= 0, whole[1] + 7, -1).to(torch.int32), tiled[1])


def test_snap_vy_rows_matches_jax():
    rng = np.random.default_rng(5)
    vys = rng.uniform(-110, 110, 4096).astype(np.float32)
    times = np.sort(rng.uniform(0.0, 3.0, 24))
    times[0] = 0.0
    for err in (0.5, 0.75, 1.5, 0.0, -1.0):
        got, n = ops.snap_vy_rows(vys, times, err)
        want, m = jax_ops.snap_vy_rows(vys, times, err)
        assert got.dtype == np.float32 and n == m
        np.testing.assert_array_equal(got, want)
    got, n = ops.snap_vy_rows(vys[:3], np.zeros(4), 0.75)
    np.testing.assert_array_equal(got, vys[:3])
    assert n == 3


class TestCoreSearch:
    """The port's ``core_search`` under the switches, against a brute force
    of every (pixel, candidate) and the JAX package's ``core_search``
    (tests/test_search_sigmag.py)."""

    def setup_method(self):
        rng = np.random.default_rng(31)
        self.T, self.H, self.W = 8, 12, 14
        self.times = np.arange(self.T) * 0.3
        psi = rng.normal(1.0, 0.4, (self.T, self.H, self.W)).astype(np.float32)
        for t in range(0, self.T, 3):
            psi[t, rng.integers(0, self.H), rng.integers(0, self.W)] = 60.0
        self.psi = psi
        self.phi = rng.uniform(0.5, 2.0, (self.T, self.H, self.W)).astype(np.float32)
        self.valid = np.ones((self.T, self.H, self.W), np.uint8)
        self.vxs = np.array([0.0, 1.5, -2.0], dtype=np.float32)
        self.vys = np.array([0.5, -1.0, 2.0], dtype=np.float32)

    def _port(self, *args, **kw):
        planes = [torch.as_tensor(a) for a in args[:3]]
        return ops.core_search(*planes, *args[3:], **kw)

    def test_exact_mode_matches_brute_force_and_jax(self, monkeypatch):
        monkeypatch.setenv("KB_SIGMAG_MODE", "exact")
        min_obs, min_lh = 4, 0.5
        args = (self.psi, self.phi, self.valid, self.times, self.vxs, self.vys, 0, self.W, 0, self.H, 2)
        kw = dict(min_obs=min_obs, min_lh=min_lh, do_sigmag=True, sgl_L=0.25, sgl_H=0.75, sigmag_coeff=COEFF)
        got = self._port(*args, **kw)
        ref = jax_ops.core_search(*args, **kw)
        for key in ("x", "y", "vx", "vy", "obs_count"):
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
        np.testing.assert_allclose(got["lh"], ref["lh"], rtol=TOL, atol=TOL)
        # Brute force: the host clipped score of every (pixel, candidate)
        # with the reference's gates, sorted.
        C = len(self.vxs)
        xs = np.tile(np.arange(self.W), self.H)
        ys = np.repeat(np.arange(self.H), self.W)
        lh_all = np.full((self.H * self.W, C), FLT_MIN, np.float32)
        planes = [torch.as_tensor(a) for a in (self.psi, self.phi, self.valid)]
        for c in range(C):
            psi_v, phi_v, ok, st = ops._curves_and_stats(
                *planes, self.times, xs, ys, np.full(len(xs), self.vxs[c]), np.full(len(xs), self.vys[c]))
            new_lh, _, _, _ = ops.clipped_sigmag_scores(psi_v, phi_v, ok, 0.25, 0.75, COEFF)
            passed = (st["obs_count"] >= min_obs) & (st["lh"] >= min_lh)
            final = np.where(passed, new_lh, st["lh"])
            lh_all[:, c] = np.where((st["obs_count"] >= min_obs) & (final >= min_lh), final, FLT_MIN)
        want = -np.sort(-lh_all, axis=1)[:, :2].reshape(-1)
        np.testing.assert_allclose(np.where(got["lh"] <= FLT_MIN / 2, FLT_MIN, got["lh"]), want, rtol=TOL, atol=TOL)

    def _promotion(self):
        """Clipping a negative outlier lifts candidate 0 (vy 1) above six
        candidates that beat it unclipped (tests/test_search_sigmag.py)."""
        T, H, W = 8, 64, 4
        psi = np.full((T, H, W), 0.01, dtype=np.float32)
        for t in range(T):
            psi[t, t, 0] = 3.0
        psi[T - 1, T - 1, 0] = -15.0
        for vy in range(2, 8):
            for t in range(1, T):
                psi[t, vy * t, 0] = 2.5
        args = (psi, np.ones((T, H, W), np.float32), np.ones((T, H, W), np.uint8), np.arange(T, dtype=np.float64),
                np.zeros(7, np.float32), np.arange(1, 8).astype(np.float32), 0, 1, 0, 1, 1)
        kw = dict(min_obs=4, min_lh=0.0, do_sigmag=True, sgl_L=0.25, sgl_H=0.75, sigmag_coeff=COEFF)
        return args, kw

    @pytest.mark.parametrize(
        "env,caught",
        [({"KB_SIGMAG_MODE": "exact"}, True), ({}, True), ({"KB_SIGMAG_AUTO": "0"}, False),
         ({"KB_SIGMAG_AUTO": "0", "KB_SIGMAG_TOPK_FACTOR": "8"}, True)],
        ids=["exact", "auto", "auto-off", "auto-off-factor-8"],
    )
    def test_clip_promotion(self, monkeypatch, env, caught):
        for name in ("KB_SIGMAG_MODE", "KB_SIGMAG_AUTO", "KB_SIGMAG_TOPK_FACTOR"):
            monkeypatch.delenv(name, raising=False)
        for name, value in env.items():
            monkeypatch.setenv(name, value)
        args, kw = self._promotion()
        got, ref = self._port(*args, **kw), jax_ops.core_search(*args, **kw)
        assert (got["vy"][0] == 1.0) == caught == (ref["vy"][0] == 1.0)
        np.testing.assert_allclose(got["lh"], ref["lh"], rtol=TOL)
        if caught:
            assert got["lh"][0] > 7.5

    def test_exact_on_codes_decodes_the_planes(self, monkeypatch):
        """On an EncodedPlanes the exact mode searches its decoded planes
        and re-scores the winners over the codes."""
        monkeypatch.setenv("KB_SIGMAG_MODE", "exact")
        pc, fc, em = _codes(self.psi, self.phi, 1)
        codes = _port_codes(pc, fc, em)
        rest = (self.times, self.vxs, self.vys, 0, self.W, 0, self.H, 2)
        kw = dict(min_obs=4, min_lh=0.5, do_sigmag=True, sgl_L=0.25, sgl_H=0.75, sigmag_coeff=COEFF)
        got = ops.core_search(codes, None, None, *rest, **kw)
        ref = jax_ops.core_search(jax_ops.EncodedPlanes(jnp.asarray(pc), jnp.asarray(fc), jnp.asarray(em)),
                                  None, None, *rest, **kw)
        for key in ("x", "y", "vx", "vy", "obs_count"):
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
        np.testing.assert_allclose(got["lh"], ref["lh"], rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def stack():
    times = create_fake_times(8, t0=57130.2, obs_per_day=2, intra_night_gap=0.05)
    ds = FakeDataSet(30, 26, times, psf_val=1.0, mask_fraction=0.03, use_seed=21)
    ds.insert_object(Trajectory(x=12, y=14, vx=4.0, vy=-1.5, flux=400.0))
    return ds.stack_py


@pytest.mark.parametrize("num_bytes", [-1, 1, 2], ids=["float", "uint8", "uint16"])
def test_stack_search_exact_mode_matches(stack, monkeypatch, num_bytes):
    """``StackSearch.search_all`` with ``KB_SIGMAG_MODE=exact`` against the
    JAX package's on its own planes or codes, and the object first."""
    monkeypatch.setenv("KB_SIGMAG_MODE", "exact")
    ref = StackSearch(stack.sci, stack.var, stack.psfs, stack.zeroed_times, num_bytes)
    got = TStackSearch(stack.sci, stack.var, stack.psfs, stack.zeroed_times, num_bytes, device="cpu")
    arr = ref.psi_phi_array
    valid = None if num_bytes in (1, 2) else np.asarray(arr.valid)
    got.psi_phi_array = psi_phi_array_from_numpy(
        np.asarray(arr.psi), np.asarray(arr.phi), valid, arr.times, arr.meta, device="cpu")
    cands = list(KBMODV1Search(5, 2.0, 6.0, 5, -0.6, 0.2))
    for s in (ref, got):
        s.set_results_per_pixel(2)
        s.set_min_obs(5)
        s.enable_gpu_sigmag_filter([0.25, 0.75], COEFF, 3.0)
        s.search_all(cands, True)
    _assert_rows_match(ref.results, got.results, got)
    best = got.get_results(0, 1)[0]
    assert abs(best.x - 12) <= 1 and abs(best.y - 14) <= 1  # the object's angle is off the grid


SWITCH_RUNS = {
    "snap_float": ({"KB_SNAP_ROW_ERROR": "0.75"}, dict()),
    "compact_off_float": ({"KB_COMPACT_RESULTS": "0"}, dict()),
    "exact_u8": ({"KB_SIGMAG_MODE": "exact"}, dict(encode_num_bytes=1, gpu_filter=True)),
    "factor_8_u8": ({"KB_SIGMAG_TOPK_FACTOR": "8"}, dict(encode_num_bytes=1, gpu_filter=True)),
    "auto_off_float": ({"KB_SIGMAG_AUTO": "0"}, dict(gpu_filter=True)),
}


@pytest.mark.parametrize("case", sorted(SWITCH_RUNS))
def test_run_search_under_switches_matches(tmp_path, monkeypatch, case):
    """``SearchRunner.run_search`` under each switch against the JAX
    package's runner under the same switch (the harness of
    tests/test_torch_run_search.py: the port searches the JAX package's
    planes, its raw rows are held to the JAX search's)."""
    from kbmod_tpu.configuration import SearchConfiguration
    from kbmod_tpu.run_search import SearchRunner

    env, over = SWITCH_RUNS[case]
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setenv("KB_SEARCH_KERNEL", "pallas")
    monkeypatch.setattr(port_run_search, "StackSearch", _HandedOver)
    config = dict(BASE, do_clustering=False, **over)
    st = _jax_stack(False)
    ref = SearchRunner().run_search(SearchConfiguration(dict(config, result_filename=str(tmp_path / "a.ecsv"))), st)
    got = port_run_search.SearchRunner().run_search(
        TSearchConfiguration(dict(config, result_filename=str(tmp_path / "b.ecsv"))), _port_stack(st), device="cpu")
    _assert_tables_match(ref, got)
    best = int(np.argmax(got["likelihood"]))
    assert abs(got["x"][best] - 17) <= 1 and abs(got["y"][best] - 21) <= 1
    if case == "snap_float":
        q = 2 * 0.75 / float(st.zeroed_times[-1])
        vy = np.asarray(got["vy"], dtype=np.float64)
        assert np.allclose(vy, np.round(vy / q) * q, atol=1e-5)


def test_memory_budget_under_switches(monkeypatch):
    """The pool factor comes from KB_SIGMAG_TOPK_FACTOR; the exact mode
    searches K deep and budgets the decoded planes (quantized) and one
    chunk's curves over a row tile."""
    st = _port_stack(_jax_stack(False))
    T, H, W = st.num_times, st.height, st.width
    dev = torch.device("cpu")

    def budget(**over):
        return port_run_search.search_memory_budget(TSearchConfiguration(dict(BASE, **over)), st, 49, dev)

    base = budget(gpu_filter=True)
    assert base["exact"] == 0
    monkeypatch.setenv("KB_SIGMAG_TOPK_FACTOR", "8")
    assert budget(gpu_filter=True)["maps"] == base["maps"] // 32 * 49  # 8 x 8 clamped to the 49 candidates
    monkeypatch.setenv("KB_SIGMAG_TOPK_FACTOR", "5")
    assert budget(gpu_filter=True)["maps"] == base["maps"] // 32 * 40
    monkeypatch.setenv("KB_SIGMAG_MODE", "exact")
    flt, u8 = budget(gpu_filter=True), budget(gpu_filter=True, encode_num_bytes=1)
    assert flt["maps"] == base["maps"] // 4
    tile = H * W
    assert flt["exact"] == ops.EXACT_BYTES_PER_SAMPLE * 49 * tile * T + 24 * (8 + 49) * tile
    assert u8["exact"] == flt["exact"] + 9 * T * H * W
    assert budget()["exact"] == 0  # no in-kernel sigma-G: the mode does not apply


def test_memory_budget_exact_on_a_card(monkeypatch):
    """On a card the exact mode runs K7, so its term counts K7's (C, T)
    offset pairs, percentile table and counter, and a quantized stack's
    decoded planes, not the twin's row tile and candidate chunk; the other
    terms are the CPU's. Arithmetic on the device type: no card needed."""
    st = _port_stack(_jax_stack(False))
    T, H, W = st.num_times, st.height, st.width
    monkeypatch.setattr(port_psi_phi, "_conv_batch_budget", lambda device: 2 * 2**30)  # the host's
    monkeypatch.delenv("KB_SHARDED", raising=False)
    monkeypatch.setenv("KB_SIGMAG_MODE", "exact")

    def budget(dev, **over):
        config = TSearchConfiguration(dict(BASE, gpu_filter=True, **over))
        return port_run_search.search_memory_budget(config, st, 49, torch.device(dev))

    k7 = 8 * 49 * T + 12 * (T + 1) + 8
    for over, decoded in (({}, 0), ({"encode_num_bytes": 1}, 9 * T * H * W)):
        card, cpu = budget("cuda", **over), budget("cpu", **over)
        assert card["exact"] == k7 + decoded
        assert cpu["exact"] == ops.EXACT_BYTES_PER_SAMPLE * 49 * H * W * T + 24 * (8 + 49) * H * W + decoded
        assert {t: v for t, v in card.items() if t not in ("exact", "total")} == {
            t: v for t, v in cpu.items() if t not in ("exact", "total")}
        assert card["total"] - card["exact"] == cpu["total"] - cpu["exact"]
    assert ops.exact_bytes("cuda", False, 1352, 20, 1024, 512, 8, 1044, 532) == 8 * 1352 * 20 + 12 * 21 + 8


@pytest.mark.parametrize(
    "env,do_sigmag,depth",
    [({}, False, ("", 1, False)), ({}, True, ("overprovision", 4, True)),
     ({"KB_SIGMAG_TOPK_FACTOR": "7"}, True, ("overprovision", 7, False)),
     ({"KB_SIGMAG_MODE": "exact"}, True, ("exact", 1, False))],
    ids=["off", "pool-4", "pool-7", "exact"],
)
def test_search_depth_is_one_rule(monkeypatch, env, do_sigmag, depth):
    """``core_search`` and the memory budget take the sigma-G mode, the
    depth K' and the refinement from ``search_depth``: K = 1 over 7
    candidates, a pool of 4 (refined: it holds fewer than every candidate)
    or of 7 (every candidate, so exact as it is)."""
    for name in ("KB_SIGMAG_MODE", "KB_SIGMAG_TOPK_FACTOR", "KB_SIGMAG_AUTO", "KB_SHARDED"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    T, H, W, C = 6, 9, 8, 7
    assert tuple(ops.search_depth(do_sigmag, 1, C)) == depth
    seen = {}

    def topk_fn(*args, **kw):
        seen["mode"], seen["k_search"] = kw["sigmag_mode"], kw["k_results"]
        return ops._local_topk(*args, **kw)

    assemble = ops.assemble_core_results

    def assembled(*args, **kw):
        seen["assemble_k_search"], seen["refine"] = kw["k_search"], kw["refine_fn"] is not None
        return assemble(*args, **kw)

    monkeypatch.setattr(ops, "assemble_core_results", assembled)
    rng = np.random.default_rng(5)
    psi = torch.as_tensor(rng.normal(1.0, 1.0, (T, H, W)).astype(np.float32))
    ops.core_search(psi, torch.ones_like(psi), torch.ones((T, H, W), dtype=torch.uint8), np.arange(T, dtype=np.float64),
                    np.linspace(-1.0, 1.0, C).astype(np.float32), np.zeros(C, np.float32), 0, W, 0, H, 1,
                    min_obs=3, min_lh=-10.0, do_sigmag=do_sigmag, sigmag_coeff=COEFF, topk_fn=topk_fn)
    mode, k_search, refine = depth
    assert seen == dict(mode=mode, k_search=k_search, assemble_k_search=k_search, refine=refine)
    config = TSearchConfiguration(dict(BASE, gpu_filter=do_sigmag, results_per_pixel=1))
    got = port_run_search.search_memory_budget(config, SimpleNamespace(num_times=T, height=H, width=W), C,
                                               torch.device("cpu"))
    assert got["maps"] == ops.maps_bytes(k_search, H, W)
    assert (got["exact"] > 0) == (mode == "exact")
