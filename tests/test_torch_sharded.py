"""The port's sharded search (kbmod_tpu_torch/parallel/sharded.py) on meshes
of CPU shards, mirroring tests/test_sharded_search.py and
tests/test_sharded_stack_search.py.

Against the port's single-device search: candidates and pixels modes are
bit-equal (also for a shard count that does not divide the candidates);
time mode's lh lie within the float64 bound of
tests/test_torch_search_kernel.py (its sums run in another order), with
indices equal except where two candidates tie within it. Against the JAX
package's ``sharded_search_topk`` and ``sharded_core_search`` on its
8-device CPU mesh (tests/conftest.py), with the same inputs: ROADMAP Queue
3's tolerances (the float64 bound for float planes; 1e-5 x max(1, |lh|)
for codes, an index swap only between candidates that close).
"""

import numpy as np
import pytest
import torch

from kbmod_tpu.core.psf import PSF
from kbmod_tpu.fake_data.fake_data_creator import FakeDataSet, create_fake_times
from kbmod_tpu.ops.psi_phi import PsiPhiArray as JPsiPhiArray
from kbmod_tpu.ops.psi_phi import fill_psi_phi_array as jfill
from kbmod_tpu.ops.search import core_search as jcore_search
from kbmod_tpu.ops.search import trajectory_offsets
from kbmod_tpu.parallel import build_mesh as jbuild_mesh
from kbmod_tpu.parallel import sharded_core_search as jsharded_core_search
from kbmod_tpu.parallel import sharded_psi_phi_build as jsharded_psi_phi_build
from kbmod_tpu.parallel import sharded_search_topk as jsharded_search_topk
from kbmod_tpu.search import Trajectory

import kbmod_tpu_torch.parallel.sharded as sharded
from kbmod_tpu_torch.filters.sigma_g_filter import SigmaGClipping
from kbmod_tpu_torch.ops import search as search_ops
from kbmod_tpu_torch.ops.search import EncodedPlanes, core_search, search_topk_sigmag_exact
from kbmod_tpu_torch.ops.search_encoded import search_topk_encoded
from kbmod_tpu_torch.ops.search_kernel import search_topk
from kbmod_tpu_torch.parallel import (
    assign_patches_to_hosts,
    build_mesh,
    is_distributed,
    sharded_core_search,
    sharded_psi_phi_build,
    sharded_search_topk,
    sharded_sigmag_exact_topk,
)
from kbmod_tpu_torch.search import StackSearch
import test_torch_stack_search_quantized as quant_pair
from test_torch_search_kernel import _lh_of, assert_lh_match

TOL = 1e-5
K = 3


def cpu_mesh(n):
    return build_mesh(devices=["cpu"] * n)


@pytest.fixture(scope="module")
def data():
    """The inputs of tests/test_sharded_search.py: the JAX package's
    zero-filled planes of a 5 x 24 x 20 random stack with 5% masked."""
    rng = np.random.default_rng(77)
    T, H, W = 5, 24, 20
    times = np.arange(T) * 0.4
    psi = [rng.normal(0, 1, (H, W)).astype(np.float32) for _ in range(T)]
    phi = [rng.uniform(0.5, 2.0, (H, W)).astype(np.float32) for _ in range(T)]
    for t in range(T):
        bad = rng.uniform(size=(H, W)) < 0.05
        psi[t][bad] = np.nan
        phi[t][bad] = np.nan
    arr = JPsiPhiArray()
    jfill(arr, -1, psi, phi, times)
    psi_z, phi_z, valid = (np.asarray(a) for a in arr.decoded_psi_phi())
    arr8 = JPsiPhiArray()
    jfill(arr8, 1, [np.asarray(p) for p in psi_z], [np.asarray(p) for p in phi_z], times)
    m = arr8.meta
    em = np.array([m.psi_min_val, m.psi_scale, m.phi_min_val, m.phi_scale], np.float32)
    vxs = np.array([0.0, 1.5, -2.0, 3.3, 0.7, 2.2, -1.1], dtype=np.float32)
    vys = np.array([0.0, -1.0, 2.5, 0.4, -3.1, 1.8, 0.9], dtype=np.float32)
    dxs, dys = trajectory_offsets(vxs, vys, times)
    codes = (np.asarray(arr8.psi), np.asarray(arr8.phi))
    return dict(psi=psi_z, phi=phi_z, valid=valid, times=times, vxs=vxs, vys=vys, dxs=dxs, dys=dys,
                codes=codes, em=em, shape=(T, H, W))


def _planes(d):
    return torch.as_tensor(d["psi"]), torch.as_tensor(d["phi"]), torch.as_tensor(d["valid"])


def _encoded(d):
    from kbmod_tpu_torch.ops.psi_phi import interleave_code_pairs, code_pair_views

    pc, fc = (torch.as_tensor(c) for c in d["codes"])
    pairs = interleave_code_pairs(pc, fc)
    views = code_pair_views(pairs, pc.shape[2])
    return EncodedPlanes(views[0], views[1], d["em"], pairs)


def _bounds(d):
    _, H, W = d["shape"]
    return dict(x_min=0, x_max=W, y_min=0, y_max=H, k_results=K)


def _single(d):
    p, f, v = _planes(d)
    return search_topk(p, f, v, torch.as_tensor(d["dxs"]), torch.as_tensor(d["dys"]), 0.0, 0.0, **_bounds(d))


def _single_encoded(d):
    return search_topk_encoded(_encoded(d), d["dxs"], d["dys"], 0.0, 0.0, **_bounds(d))


def _assert_same(got, ref):
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def _assert_codes_close(got, ref, own):
    """Encoded maps within 1e-5 x max(1, |lh|); an index may differ only
    where the two candidates' own lh are that close at the pixel."""
    (g_lh, g_idx), (r_lh, r_idx) = (np.asarray(a) for a in got), (np.asarray(a) for a in ref)
    assert np.array_equal(g_idx < 0, r_idx < 0)
    assert np.all(np.abs(g_lh - r_lh) <= TOL * np.maximum(1.0, np.abs(r_lh)))
    for k, i, j in np.argwhere(g_idx != r_idx):
        a, b = own[g_idx[k, i, j]][i, j], own[r_idx[k, i, j]][i, j]
        assert abs(a - b) <= TOL * max(1.0, abs(a)), f"index mismatch at {(k, i, j)} without a tie"


def _own_encoded(d):
    """Each candidate's own encoded lh map (K = 1)."""
    pl = _encoded(d)
    kw = dict(_bounds(d), k_results=1)
    return [np.asarray(search_topk_encoded(pl, d["dxs"][c:c + 1], d["dys"][c:c + 1], 0.0, 0.0, **kw)[0][0])
            for c in range(len(d["dxs"]))]


def test_mesh():
    mesh = cpu_mesh(4)
    assert mesh.size == 4 and mesh.root == torch.device("cpu") and (mesh.rank, mesh.world_size) == (0, 1)
    assert [g for g, _ in mesh.local_shards()] == [0, 1, 2, 3]
    assert build_mesh(2, devices=["cpu"] * 4).size == 2
    # With no devices given: every visible card.
    assert build_mesh().size == torch.cuda.device_count()


@pytest.mark.parametrize("n", [3, 4], ids=["3-shards", "4-shards"])
@pytest.mark.parametrize("shard_mode", ["candidates", "pixels"])
def test_matches_single_device(data, shard_mode, n):
    """Bit-equal to the one-device K2 twin; 7 candidates split over 3 or 4
    shards (padded to 9 or 8 with invalid candidates)."""
    got = sharded_search_topk(*_planes(data), data["dxs"], data["dys"], cpu_mesh(n), shard_mode=shard_mode,
                              **_bounds(data))
    _assert_same(got, _single(data))


def test_time_mode_within_f64_bound(data):
    got = sharded_search_topk(*_planes(data), data["dxs"], data["dys"], cpu_mesh(4), shard_mode="time",
                              **_bounds(data))
    ref = _single(data)
    own = _lh_of(data["psi"], data["phi"], data["valid"], data["dxs"], data["dys"], 0.0, 0.0, _bounds(data))
    assert_lh_match(tuple(np.asarray(a) for a in got), tuple(np.asarray(a) for a in ref), *own)


@pytest.mark.parametrize("encoded", [False, True], ids=["float", "uint8"])
def test_time_mode_chunks(data, monkeypatch, encoded):
    """Time mode over candidate chunks of two (the last one short) equals
    one chunk of every candidate bit for bit: the chunks merge into the
    top-K by (lh desc, index asc)."""
    planes = (_encoded(data), None, None) if encoded else _planes(data)
    args = (*planes, data["dxs"], data["dys"], cpu_mesh(3))
    whole = sharded_search_topk(*args, shard_mode="time", **_bounds(data))
    b = _bounds(data)
    monkeypatch.setattr(sharded, "TIME_CHUNK_ELEMENTS", 2 * (b["y_max"] - b["y_min"]) * (b["x_max"] - b["x_min"]))
    _assert_same(sharded_search_topk(*args, shard_mode="time", **b), whole)


@pytest.mark.parametrize("shard_mode", ["candidates", "pixels", "time"])
def test_matches_jax_sharded(data, shard_mode):
    """The port's sharded maps against the JAX package's sharded_search_topk
    (XLA) on its 8-device mesh."""
    ref = jsharded_search_topk(data["psi"], data["phi"], data["valid"], data["dxs"], data["dys"], jbuild_mesh(8),
                               shard_mode=shard_mode, **_bounds(data))
    got = sharded_search_topk(*_planes(data), data["dxs"], data["dys"], cpu_mesh(4), shard_mode=shard_mode,
                              **_bounds(data))
    own = _lh_of(data["psi"], data["phi"], data["valid"], data["dxs"], data["dys"], 0.0, 0.0, _bounds(data))
    assert_lh_match(tuple(np.asarray(a) for a in got), tuple(np.asarray(a) for a in ref), *own)


@pytest.mark.parametrize("kernel", ["pallas", "xla"])
@pytest.mark.parametrize("shard_mode", ["candidates", "pixels"])
def test_encoded_matches_single_device(data, monkeypatch, shard_mode, kernel):
    """uint8 codes: bit-equal to the one-device dispatcher, each of the
    three shards through the dispatcher on its own slice (K5 where the
    slice's plan fills); KB_SEARCH_KERNEL, the JAX package's Pallas or XLA
    choice, changes nothing."""
    monkeypatch.setenv("KB_SEARCH_KERNEL", kernel)
    routes = []
    real = sharded.search_topk_encoded

    def spy(*a, **k):
        out = real(*a, **k)
        routes.append(real.last_route)
        return out

    monkeypatch.setattr(sharded, "search_topk_encoded", spy)
    got = sharded_search_topk(_encoded(data), None, None, data["dxs"], data["dys"], cpu_mesh(3),
                              shard_mode=shard_mode, **_bounds(data))
    _assert_same(got, _single_encoded(data))
    assert len(routes) == 3


def test_time_shard_encoded_codes(data):
    """Time sharding of uint8 codes: within the codes' tolerance of the
    one-device encoded search and of the JAX package's time mode."""
    got = sharded_search_topk(_encoded(data), None, None, data["dxs"], data["dys"], cpu_mesh(4),
                              shard_mode="time", **_bounds(data))
    own = _own_encoded(data)
    _assert_codes_close(got, _single_encoded(data), own)
    ref = jsharded_search_topk(None, None, None, data["dxs"], data["dys"], jbuild_mesh(8), shard_mode="time",
                               psi_codes=data["codes"][0], phi_codes=data["codes"][1], encode_meta=data["em"],
                               **_bounds(data))
    _assert_codes_close(got, ref, own)


def _core_kwargs(sigmag):
    if not sigmag:
        return {}
    return dict(min_obs=3, min_lh=0.2, do_sigmag=True, sgl_L=0.25, sgl_H=0.75,
                sigmag_coeff=SigmaGClipping.find_sigma_g_coeff(25, 75))


def _assert_results_equal(got, ref):
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


@pytest.mark.parametrize("sigmag", [False, True], ids=["plain", "sigmag"])
@pytest.mark.parametrize("shard_mode", ["candidates", "pixels"])
def test_sharded_core_search_matches(data, shard_mode, sigmag):
    """Bit-equal to the port's core_search (the over-provisioned sigma-G
    pool per shard included); lh, flux and obs within tolerance of the JAX
    package's sharded_core_search."""
    _, H, W = data["shape"]
    args = (data["times"], data["vxs"], data["vys"])
    kw = _core_kwargs(sigmag)
    got = sharded_core_search(*_planes(data), *args, cpu_mesh(4), x_min=0, x_max=W, y_min=0, y_max=H,
                              results_per_pixel=2, shard_mode=shard_mode, **kw)
    _assert_results_equal(got, core_search(*_planes(data), *args, 0, W, 0, H, 2, **kw))
    ref = jsharded_core_search(data["psi"], data["phi"], data["valid"], *args, jbuild_mesh(8), x_min=0, x_max=W,
                               y_min=0, y_max=H, results_per_pixel=2, shard_mode=shard_mode, **kw)
    np.testing.assert_allclose(got["lh"], ref["lh"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["flux"], ref["flux"], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got["obs_count"], ref["obs_count"])


def test_sharded_core_search_time_mode(data):
    _, H, W = data["shape"]
    args = (data["times"], data["vxs"], data["vys"])
    got = sharded_core_search(*_planes(data), *args, cpu_mesh(4), x_min=0, x_max=W, y_min=0, y_max=H,
                              results_per_pixel=2, shard_mode="time")
    ref = core_search(*_planes(data), *args, 0, W, 0, H, 2)
    np.testing.assert_allclose(got["lh"], ref["lh"], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got["obs_count"], ref["obs_count"])


def test_sharded_sigmag_exact_matches_single_device(data, monkeypatch):
    """KB_SIGMAG_MODE=exact: the candidate-sharded exact search equals the
    one-device one, through sharded_core_search and alone at a row tile of
    8 (several tiles); within tolerance of the JAX package's core_search."""
    monkeypatch.setenv("KB_SIGMAG_MODE", "exact")
    _, H, W = data["shape"]
    args = (data["times"], data["vxs"], data["vys"])
    kw = _core_kwargs(True)
    got = sharded_core_search(*_planes(data), *args, cpu_mesh(3), x_min=0, x_max=W, y_min=0, y_max=H,
                              results_per_pixel=2, **kw)
    _assert_results_equal(got, core_search(*_planes(data), *args, 0, W, 0, H, 2, **kw))
    ref = jcore_search(data["psi"], data["phi"], data["valid"], *args, 0, W, 0, H, 2, **kw)
    np.testing.assert_allclose(got["lh"], ref["lh"], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got["obs_count"], ref["obs_count"])
    exact = dict(x_min=0, x_max=W, y_min=0, y_max=H, k_results=2, sgl_L=0.25, sgl_H=0.75, row_tile=8)
    one = search_topk_sigmag_exact(*_planes(data), torch.as_tensor(data["dxs"]), torch.as_tensor(data["dys"]), 3,
                                   0.2, kw["sigmag_coeff"], **exact)
    two = sharded_sigmag_exact_topk(*_planes(data), data["dxs"], data["dys"], cpu_mesh(3), min_obs=3, min_lh=0.2,
                                    sigmag_coeff=kw["sigmag_coeff"], **exact)
    _assert_same(two, one)


def test_sharded_psi_phi_build():
    """The time-sharded K1 build equals the one-shard build bit for bit,
    NaN masks included, and the JAX package's sharded build within 1e-5."""
    rng = np.random.default_rng(5)
    T, H, W = 6, 16, 16
    sci = rng.normal(0, 1, (T, H, W)).astype(np.float32)
    var = np.full((T, H, W), 4.0, dtype=np.float32)
    sci[0, 3, 3] = np.nan
    psf = PSF.make_gaussian_kernel(0.5)
    got = sharded_psi_phi_build(sci, var, psf, cpu_mesh(4))
    one = sharded_psi_phi_build(sci, var, psf, cpu_mesh(1))
    for a, b in zip(got, one):
        assert torch.equal(a, b)
    assert got[2][0, 3, 3] == 0
    ref = jsharded_psi_phi_build(sci, var, psf, jbuild_mesh(8))
    ok = np.asarray(ref[2]).astype(bool)
    np.testing.assert_array_equal(got[2].numpy().astype(bool), ok)
    for a, b in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(a.numpy()[ok], np.asarray(b)[ok], rtol=TOL, atol=1e-6)


def test_sharded_gather_equals_one_device(data):
    p, f, v = _planes(data)
    rng = np.random.default_rng(1)
    n = 11
    xs = torch.as_tensor(rng.integers(-2, 22, n))
    ys = torch.as_tensor(rng.integers(-2, 26, n))
    dxs = torch.as_tensor(data["dxs"][rng.integers(0, 7, n)]).to(torch.int64)
    dys = torch.as_tensor(data["dys"][rng.integers(0, 7, n)]).to(torch.int64)
    gather = sharded.make_sharded_evaluators(cpu_mesh(4))
    for planes in ((p, f, v), (_encoded(data), None, None)):
        got = gather(*planes, xs, ys, dxs, dys)
        ref = search_ops._gather_curves(*planes, xs, ys, dxs, dys)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


class TestDistributedHelpers:
    def test_assign_patches_round_robin(self):
        a0 = assign_patches_to_hosts(10, num_hosts=3, host_id=0)
        a1 = assign_patches_to_hosts(10, num_hosts=3, host_id=1)
        a2 = assign_patches_to_hosts(10, num_hosts=3, host_id=2)
        assert (a0, a1, a2) == ([0, 3, 6, 9], [1, 4, 7], [2, 5, 8])
        with pytest.raises(ValueError):
            assign_patches_to_hosts(4, num_hosts=2, host_id=5)

    def test_single_process_defaults(self):
        assert not is_distributed()
        assert assign_patches_to_hosts(3) == [0, 1, 2]


@pytest.fixture(scope="module")
def stack():
    """The stack and grid of tests/test_sharded_stack_search.py."""
    times = create_fake_times(8, t0=57130.0, obs_per_day=4)
    ds = FakeDataSet(64, 64, times, use_seed=77)
    ds.insert_object(Trajectory(x=30, y=30, vx=6.0, vy=-3.0, flux=400.0))
    cands = [Trajectory(vx=vx, vy=vy) for vx in np.linspace(4.0, 8.0, 5) for vy in np.linspace(-5.0, -1.0, 5)]
    return ds.stack_py, cands


@pytest.mark.parametrize("num_bytes", [-1, 1], ids=["float", "uint8"])
@pytest.mark.parametrize("shard_mode", ["candidates", "pixels", "time"])
def test_stack_search_sharded(stack, monkeypatch, shard_mode, num_bytes):
    """StackSearch with KB_SHARDED=1 over a 4-shard CPU mesh against
    KB_SHARDED=0: equal rows; in time mode, whose lh round differently,
    rows equal up to the tie rule of tests/test_torch_stack_search_quantized.py
    (lh within 1e-5 x max(1, |lh|), swaps only inside runs that close). The
    object is on top."""
    st, cands = stack

    def run():
        s = StackSearch(st.sci, st.var, st.psfs, st.zeroed_times, num_bytes, device="cpu")
        s.set_min_obs(5)
        s.set_min_lh(1.0)
        s.search_all(cands, True)
        return s

    monkeypatch.setenv("KB_SHARDED", "0")
    single = run()
    meshes = []
    monkeypatch.setattr(sharded, "build_mesh", lambda: meshes.append(cpu_mesh(4)) or meshes[-1])
    monkeypatch.setenv("KB_SHARDED", "1")
    monkeypatch.setenv("KB_SHARD_MODE", shard_mode)
    got = run()
    assert len(meshes) == 1
    if shard_mode == "time":
        quant_pair._assert_rows_match(single.results, got.results, single)
    else:
        _assert_results_equal(got.results.get_arrays(), single.results.get_arrays())
    best = got.get_results(0, 1)[0]
    assert (best.x, best.y) == (30, 30)


def test_stack_search_auto_stays_on_one_device(stack, monkeypatch):
    """KB_SHARDED=auto (the default) shards only a CUDA search over more
    than one card: a CPU search never asks for a mesh."""
    st, cands = stack
    monkeypatch.delenv("KB_SHARDED", raising=False)
    monkeypatch.setattr(sharded, "build_mesh", lambda: pytest.fail("a CPU search asked for a mesh"))
    s = StackSearch(st.sci, st.var, st.psfs, st.zeroed_times, -1, device="cpu")
    s.set_min_obs(5)
    s.search_all(cands[:3], True)
    assert len(s.results) > 0
