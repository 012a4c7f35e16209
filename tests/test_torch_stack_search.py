"""Port parity for the whole slice: the JAX package's ``StackSearch(..., -1)``
against kbmod_tpu_torch's ``StackSearch(..., -1, device="cpu")`` on the same
fake stack, with masked pixels and an injected object.

Result rows must match in (x, y, vx, vy, obs_count) and order, with lh and
flux to rtol 1e-5; rows may swap only inside runs whose lh agree to 1e-5
relative (exact ties reorder differently in the two insertions, and the
last ulps of lh differ), and a row may name another candidate only where
the two candidates tie exactly at that pixel. The searches compare on identical psi/phi planes,
handed over with ``psi_phi_array_from_numpy``, so that the convolution's
rounding does not enter; the build itself is compared separately.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from kbmod_tpu.fake_data.fake_data_creator import FakeDataSet, create_fake_times
from kbmod_tpu.ops import search as jax_search_ops
from kbmod_tpu.search import StackSearch, Trajectory
from kbmod_tpu.trajectory_generator import KBMODV1Search

from kbmod_tpu_torch.ops import search as search_ops
from kbmod_tpu_torch.search import StackSearch as TStackSearch
from kbmod_tpu_torch.search import Trajectory as TTrajectory
from kbmod_tpu_torch.search import psi_phi_array_from_numpy

RTOL = 1e-5
OBJ = dict(x=17, y=21, vx=4.0, vy=-1.5, flux=350.0)
KEY = ("x", "y", "vx", "vy", "obs_count")


@pytest.fixture(scope="module")
def stack():
    times = create_fake_times(8, t0=57130.2, obs_per_day=2, intra_night_gap=0.05)
    ds = FakeDataSet(44, 38, times, psf_val=1.0, mask_fraction=0.04, use_seed=77)
    ds.insert_object(Trajectory(**OBJ))
    return ds.stack_py


@pytest.fixture(scope="module")
def candidates():
    return list(KBMODV1Search(6, 2.0, 6.0, 6, -0.6, 0.2))


def _pair(stack):
    ref = StackSearch(stack.sci, stack.var, stack.psfs, stack.zeroed_times, -1)
    got = TStackSearch(stack.sci, stack.var, stack.psfs, stack.zeroed_times, -1, device="cpu")
    arr = ref.psi_phi_array
    got.psi_phi_array = psi_phi_array_from_numpy(
        np.asarray(arr.psi), np.asarray(arr.phi), np.asarray(arr.valid), arr.times, arr.meta, device="cpu"
    )
    return ref, got


def _tie_groups(lh):
    """Index runs of consecutive rows whose lh agree to RTOL relative."""
    cuts = np.nonzero(np.abs(np.diff(lh)) > RTOL * np.maximum(np.abs(lh[1:]), 1.0))[0] + 1
    return np.split(np.arange(len(lh)), cuts)


def _assert_rows_match(ref, got, search):
    """Rows equal in KEY and order up to swaps inside tie runs. A row may
    also hold another candidate than the reference's where the two tie
    exactly at that pixel (both trajectories score the same lh there): at
    the top-K boundary the reference's bubble insertion keeps the later of
    two equal candidates and the rank-insert the earlier one."""
    a, b = ref.get_arrays(), got.get_arrays()
    assert len(a["x"]) == len(b["x"]) > 0
    np.testing.assert_allclose(b["lh"], a["lh"], rtol=RTOL)
    for rows in _tie_groups(a["lh"]):
        ka = Counter(zip(*(a[k][rows].tolist() for k in KEY)))
        kb = Counter(zip(*(b[k][rows].tolist() for k in KEY)))
        only_a = sorted((ka - kb).elements(), key=lambda r: (r[0], r[1], r[4]))
        only_b = sorted((kb - ka).elements(), key=lambda r: (r[0], r[1], r[4]))
        assert len(only_a) == len(only_b)
        for ra, rb in zip(only_a, only_b):
            assert (ra[0], ra[1], ra[4]) == (rb[0], rb[1], rb[4]), f"rows {rows[0]}..{rows[-1]} differ"
            la = search.search_linear_trajectory(ra[0], ra[1], ra[2], ra[3]).lh
            lb = search.search_linear_trajectory(rb[0], rb[1], rb[2], rb[3]).lh
            assert la == lb, f"rows {rows[0]}..{rows[-1]}: {ra} and {rb} do not tie"
        np.testing.assert_allclose(np.sort(b["flux"][rows]), np.sort(a["flux"][rows]), rtol=RTOL, atol=1e-6)


def _configure(s, bounds, sigmag, rpp):
    s.set_results_per_pixel(rpp)
    s.set_min_obs(5)
    if bounds is not None:
        s.set_start_bounds_x(*bounds[:2])
        s.set_start_bounds_y(*bounds[2:])
    if sigmag:
        s.enable_gpu_sigmag_filter([0.25, 0.75], 0.7413, 3.0)
    else:
        s.set_min_lh(1.0)


@pytest.mark.parametrize(
    "on_gpu,bounds,sigmag,rpp",
    [
        (True, None, False, 4),
        (False, None, False, 4),
        (True, None, True, 2),
        (True, (6, 30, 9, 33), False, 3),
        (True, (-5, 50, -4, 41), False, 2),
        (False, (-5, 50, -4, 41), False, 3),
        (True, (-5, 50, -4, 41), True, 2),
    ],
    ids=["gpu", "cpu", "gpu-sigmag", "gpu-reduced", "gpu-extended", "cpu-extended", "gpu-extended-sigmag"],
)
def test_search_all_matches(stack, candidates, on_gpu, bounds, sigmag, rpp):
    ref, got = _pair(stack)
    for s in (ref, got):
        _configure(s, bounds, sigmag, rpp)
        s.search_all(candidates, on_gpu)
    _assert_rows_match(ref.results, got.results, got)
    best = got.get_results(0, 1)[0]
    if bounds is None or bounds[0] <= OBJ["x"] < bounds[1]:
        assert (best.x, best.y) == (OBJ["x"], OBJ["y"])


def test_psi_phi_build_matches(stack):
    """The port's own build (the twin of K1) against the JAX build: planes to
    rtol 1e-5, validity exact, metadata equal."""
    ref = StackSearch(stack.sci, stack.var, stack.psfs, stack.zeroed_times, -1).psi_phi_array
    got = TStackSearch(stack.sci, stack.var, stack.psfs, stack.zeroed_times, -1, device="cpu").psi_phi_array
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_allclose(got.psi.numpy(), np.asarray(ref.psi), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(got.phi.numpy(), np.asarray(ref.phi), rtol=RTOL, atol=1e-6)
    for name in vars(ref.meta):
        assert getattr(got.meta, name) == getattr(ref.meta, name), name
    assert got.psi.device.type == "cpu" and got.valid.dtype == torch.uint8
    assert not got.on_gpu
    for t, r, c in ((0, 3, 4), (2, 37, 43), (1, 40, 0), (0, -1, 2)):
        a, b = ref.read_psi_phi(t, r, c), got.read_psi_phi(t, r, c)
        np.testing.assert_allclose([b.psi, b.phi], [a.psi, a.phi], rtol=RTOL, equal_nan=True)


def test_search_on_port_built_planes_recovers_object(stack, candidates):
    """End to end on the port alone, its own planes included."""
    s = TStackSearch(stack.sci, stack.var, stack.psfs, stack.zeroed_times, -1, device="cpu")
    s.set_min_obs(6)
    s.search_all(candidates, True)
    best = s.get_results(0, 1)[0]
    assert (best.x, best.y) == (OBJ["x"], OBJ["y"]) and best.obs_count >= 6
    assert s.get_number_total_results() == len(s.get_all_results())
    assert set(s.timings) == {"psi_phi_ms", "search_ms", "assemble_ms"}


@pytest.mark.parametrize("use_kernel", [False, True])
def test_evaluate_single_trajectory(stack, use_kernel):
    ref, got = _pair(stack)
    for s in (ref, got):
        s.enable_gpu_sigmag_filter([0.25, 0.75], 0.7413, 1.0)
    for x, y, vx, vy in ((17, 21, 4.0, -1.5), (3, 5, -2.0, 1.0), (43, 37, 6.0, 2.0), (-2, 40, 1.0, -3.0)):
        a, b = Trajectory(x=x, y=y, vx=vx, vy=vy), TTrajectory(x=x, y=y, vx=vx, vy=vy)
        ref.evaluate_single_trajectory(a, use_kernel)
        got.evaluate_single_trajectory(b, use_kernel)
        assert b.obs_count == a.obs_count
        np.testing.assert_allclose([b.lh, b.flux], [a.lh, a.flux], rtol=RTOL, atol=1e-6)
    c = got.search_linear_trajectory(17, 21, 4.0, -1.5, use_kernel)
    assert c.obs_count > 0 and c.lh > 0


def test_get_all_psi_phi_curves(stack, candidates):
    ref, got = _pair(stack)
    trjs = [(5, 6, 1.0, 2.0), (17, 21, 4.0, -1.5), (40, 1, -3.0, 0.5), (0, 37, 2.0, -6.0)]
    a = ref.get_all_psi_phi_curves([Trajectory(x=x, y=y, vx=vx, vy=vy) for x, y, vx, vy in trjs])
    b = got.get_all_psi_phi_curves([TTrajectory(x=x, y=y, vx=vx, vy=vy) for x, y, vx, vy in trjs])
    assert b.shape == a.shape == (4, 2 * len(stack.zeroed_times))
    np.testing.assert_array_equal(b, a)
    got.search_all(candidates, True)
    c = got.get_all_psi_phi_curves(got.results)
    assert c.shape == (len(got.results), 2 * len(stack.zeroed_times))


def test_api_checks_and_result_access(stack):
    s = TStackSearch(stack.sci, stack.var, stack.psfs, stack.zeroed_times, -1, device="cpu")
    assert (s.num_images, s.height, s.width) == (len(stack.sci), 38, 44)
    with pytest.raises(RuntimeError):
        s.set_min_obs(len(stack.sci) + 1)
    with pytest.raises(RuntimeError):
        s.set_start_bounds_x(5, 5)
    with pytest.raises(RuntimeError):
        s.enable_gpu_sigmag_filter([0.75, 0.25], 0.7, 1.0)
    with pytest.raises(RuntimeError):
        s.set_results_per_pixel(0)
    with pytest.raises(RuntimeError):
        TStackSearch(stack.sci[:2], stack.var, stack.psfs, stack.zeroed_times, -1, device="cpu")
    with pytest.raises(RuntimeError, match="encoding size"):
        TStackSearch(stack.sci, stack.var, stack.psfs, stack.zeroed_times, 3, device="cpu")
    with pytest.raises(RuntimeError):
        s.search_all([], True)
    s.enable_gpu_sigmag_filter([0.25, 0.75], 0.7413, 2.0)
    s.disable_gpu_sigmag_filter()
    assert not s.params.do_sigmag_filter
    s.preload_psi_phi_array()
    assert s.psi_phi_array_on_gpu()
    s.unload_psi_phi_array()
    trjs = [TTrajectory(x=1, y=2, vx=0.5, vy=0.5, lh=3.0, flux=1.0, obs_count=4)]
    s.set_results(trjs)
    assert s.get_all_results() == trjs and s.get_results(0, 5) == trjs
    with pytest.raises(RuntimeError):
        s.get_results(0, 0)
    s.clear_results()
    assert s.get_number_total_results() == 0


def test_evaluate_trajectories_matches(stack):
    ref, got = _pair(stack)
    rng = np.random.default_rng(21)
    xs, ys = rng.integers(-3, 47, 30), rng.integers(-3, 41, 30)
    vxs, vys = rng.uniform(-6, 6, 30).astype(np.float32), rng.uniform(-6, 6, 30).astype(np.float32)
    times = stack.zeroed_times
    a = jax_search_ops.evaluate_trajectories(*ref.psi_phi_array.decoded_psi_phi(), times, xs, ys, vxs, vys)
    b = search_ops.evaluate_trajectories(*got.psi_phi_array.decoded_psi_phi(), times, xs, ys, vxs, vys, chunk=7)
    np.testing.assert_array_equal(b["obs_count"], a["obs_count"])
    for k in ("psi_sum", "phi_sum", "lh", "flux"):
        np.testing.assert_allclose(b[k], a[k], rtol=RTOL, atol=1e-6)


def test_sigmag_helpers_match():
    """The host-side sigma-G pieces are numpy in both packages: equal."""
    rng = np.random.default_rng(5)
    psi_v = rng.normal(1, 2, (40, 9)).astype(np.float32)
    phi_v = rng.uniform(0.2, 1.5, (40, 9)).astype(np.float32)
    psi_v[::7, 3] = 60.0  # outliers for the clip to remove
    ok = rng.uniform(size=(40, 9)) > 0.15
    ok[5] = False
    for a, b in zip(
        jax_search_ops.clipped_sigmag_scores(psi_v, phi_v, ok, 0.25, 0.75, 0.7413),
        search_ops.clipped_sigmag_scores(psi_v, phi_v, ok, 0.25, 0.75, 0.7413),
    ):
        np.testing.assert_array_equal(b, a)
    for n in (1, 2, 7, 20):
        assert search_ops.sigmag_bounds_indices(n, 0.25, 0.75) == jax_search_ops.sigmag_bounds_indices(n, 0.25, 0.75)
        vals = rng.normal(0, 1, n)
        vals[0] = 9.0
        np.testing.assert_array_equal(
            search_ops.sigmag_filtered_indices(vals, 0.25, 0.75, 0.7413, 2.0),
            jax_search_ops.sigmag_filtered_indices(vals, 0.25, 0.75, 0.7413, 2.0),
        )
