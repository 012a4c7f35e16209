"""Port parity for the quantized search as a whole: the JAX package's
``StackSearch(..., 1)`` and ``(..., 2)`` against kbmod_tpu_torch's on
``device="cpu"``, on a 6 x 32 x 30 fake stack with masked pixels and one
injected object.

The port searches the JAX package's own code planes and decode metadata,
handed over with ``psi_phi_array_from_numpy``, so the convolution's rounding
does not enter. The JAX side runs its TPU dispatcher (``KB_SEARCH_KERNEL=
pallas``, kernels in interpret mode), whose dedup, grouping and tie order
the port follows. Result rows must match in (x, y, vx, vy, obs_count) and
order, lh and flux within 1e-5 * max(1, |value|) (the decode's rounding,
see tests/test_torch_search_encoded.py); rows may swap only inside runs of
lh equal to that tolerance, and a row may name another candidate only where
the two score the same lh at that pixel.
"""

from collections import Counter

import numpy as np
import pytest

from kbmod_tpu.fake_data.fake_data_creator import FakeDataSet, create_fake_times
from kbmod_tpu.search import StackSearch, Trajectory
from kbmod_tpu.trajectory_generator import VelocityGridSearch

from kbmod_tpu_torch.ops.search_encoded import search_topk_encoded
from kbmod_tpu_torch.search import StackSearch as TStackSearch
from kbmod_tpu_torch.search import Trajectory as TTrajectory
from kbmod_tpu_torch.search import psi_phi_array_from_numpy

TOL = 1e-5
OBJ = dict(x=9, y=14, vx=3.0, vy=1.0, flux=300.0)
KEY = ("x", "y", "vx", "vy", "obs_count")


@pytest.fixture(scope="module")
def stack():
    times = create_fake_times(6, t0=57130.2, obs_per_day=3)
    ds = FakeDataSet(32, 30, times, use_seed=3, mask_fraction=0.02)
    ds.insert_object(Trajectory(**OBJ))
    return ds.stack_py


@pytest.fixture(scope="module")
def candidates():
    return list(VelocityGridSearch(7, 0.5, 5.0, 6, -1.0, 3.0))


@pytest.fixture
def pallas(monkeypatch):
    monkeypatch.setenv("KB_SEARCH_KERNEL", "pallas")


def _pair(stack, num_bytes):
    ref = StackSearch(stack.sci, stack.var, stack.psfs, stack.zeroed_times, num_bytes)
    got = TStackSearch(stack.sci, stack.var, stack.psfs, stack.zeroed_times, num_bytes, device="cpu")
    arr = ref.psi_phi_array
    got.psi_phi_array = psi_phi_array_from_numpy(
        np.asarray(arr.psi), np.asarray(arr.phi), None, arr.times, arr.meta, device="cpu"
    )
    return ref, got


def _close(a, b):
    return abs(a - b) <= TOL * max(1.0, abs(a))


def _tie_runs(lh):
    """Index runs of consecutive rows whose lh agree to the tolerance."""
    cuts = np.nonzero(np.abs(np.diff(lh)) > TOL * np.maximum(np.abs(lh[1:]), 1.0))[0] + 1
    return np.split(np.arange(len(lh)), cuts)


def _assert_rows_match(ref, got, search):
    a, b = ref.get_arrays(), got.get_arrays()
    assert len(a["x"]) == len(b["x"]) > 0
    for name in ("lh", "flux"):
        assert all(_close(x, y) for x, y in zip(a[name], b[name])), name
    for rows in _tie_runs(a["lh"]):
        ka = Counter(zip(*(a[k][rows].tolist() for k in KEY)))
        kb = Counter(zip(*(b[k][rows].tolist() for k in KEY)))
        only_a = sorted((ka - kb).elements(), key=lambda r: (r[0], r[1], r[4]))
        only_b = sorted((kb - ka).elements(), key=lambda r: (r[0], r[1], r[4]))
        assert len(only_a) == len(only_b)
        for ra, rb in zip(only_a, only_b):
            assert (ra[0], ra[1], ra[4]) == (rb[0], rb[1], rb[4]), f"rows {rows[0]}..{rows[-1]} differ"
            la = search.search_linear_trajectory(ra[0], ra[1], ra[2], ra[3]).lh
            lb = search.search_linear_trajectory(rb[0], rb[1], rb[2], rb[3]).lh
            assert _close(la, lb), f"rows {rows[0]}..{rows[-1]}: {ra} and {rb} do not tie"


@pytest.mark.parametrize(
    "num_bytes,on_gpu,bounds,sigmag",
    [
        (1, True, None, False),
        (2, True, None, False),
        (1, False, None, False),
        (1, True, None, True),
        (2, True, None, True),
        (1, True, (-4, 36, 3, 33), False),
    ],
    ids=["u8", "u16", "u8-cpu-path", "u8-sigmag", "u16-sigmag", "u8-extended"],
)
def test_search_all_matches(stack, candidates, pallas, num_bytes, on_gpu, bounds, sigmag):
    ref, got = _pair(stack, num_bytes)
    for s in (ref, got):
        s.set_results_per_pixel(3)
        s.set_min_obs(4)
        if bounds is not None:
            s.set_start_bounds_x(*bounds[:2])
            s.set_start_bounds_y(*bounds[2:])
        if sigmag:
            s.enable_gpu_sigmag_filter([0.25, 0.75], 0.7413, 2.0)
        else:
            s.set_min_lh(1.0)
        s.search_all(candidates, on_gpu)
    assert search_topk_encoded.last_route is not None
    _assert_rows_match(ref.results, got.results, got)
    best = got.get_results(0, 1)[0]
    assert (best.x, best.y) == (OBJ["x"], OBJ["y"])


@pytest.mark.parametrize("num_bytes", [1, 2])
def test_port_build_recovers_object(stack, candidates, num_bytes):
    """End to end on the port alone: its own streaming build, code planes
    on the device, the encoded dispatcher, the code gathers."""
    s = TStackSearch(stack.sci, stack.var, stack.psfs, stack.zeroed_times, num_bytes, device="cpu")
    arr = s.psi_phi_array
    assert arr.meta.num_bytes == num_bytes and arr.valid is None
    assert s.params.encode_num_bytes == num_bytes
    s.set_min_obs(5)
    s.search_all(candidates, True)
    best = s.get_results(0, 1)[0]
    assert (best.x, best.y) == (OBJ["x"], OBJ["y"]) and best.obs_count >= 5
    assert abs(best.vx - OBJ["vx"]) < 0.8 and abs(best.vy - OBJ["vy"]) < 0.8
    assert set(s.timings) == {"psi_phi_ms", "search_ms", "assemble_ms"}


@pytest.mark.parametrize("num_bytes", [1, 2])
def test_single_trajectory_and_curves_on_codes(stack, num_bytes):
    ref, got = _pair(stack, num_bytes)
    for s in (ref, got):
        s.enable_gpu_sigmag_filter([0.25, 0.75], 0.7413, 1.0)
    trjs = ((9, 14, 3.0, 1.0), (3, 5, -2.0, 1.0), (31, 29, 6.0, 2.0), (-2, 27, 1.0, -3.0))
    for use_kernel in (False, True):
        for x, y, vx, vy in trjs:
            a, b = Trajectory(x=x, y=y, vx=vx, vy=vy), TTrajectory(x=x, y=y, vx=vx, vy=vy)
            ref.evaluate_single_trajectory(a, use_kernel)
            got.evaluate_single_trajectory(b, use_kernel)
            assert b.obs_count == a.obs_count
            assert _close(a.lh, b.lh) and _close(a.flux, b.flux)
    a = ref.get_all_psi_phi_curves([Trajectory(x=x, y=y, vx=vx, vy=vy) for x, y, vx, vy in trjs])
    b = got.get_all_psi_phi_curves([TTrajectory(x=x, y=y, vx=vx, vy=vy) for x, y, vx, vy in trjs])
    assert b.shape == a.shape == (4, 12)
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(b == 0, a == 0)
