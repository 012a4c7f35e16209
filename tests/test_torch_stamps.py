"""The port's coadd stamps against the JAX package's, on the CPU.

``batched_coadds`` gathers the stamp windows on the host and reduces them
with torch (here on ``device="cpu"``); the JAX package gathers and reduces
with XLA. Inputs: images with NaN pixels and zero variances, centres that
put stamps partly and wholly off the image, rows with no valid time, an
``obs_valid`` mask. Sum, median and all_stamps must be exact (the sums add
one time step after another from +0.0, as the JAX package's reductions do
on the host); mean and weighted within 1e-6 relative. Then
``append_coadds`` (nightly too) and ``append_all_stamps`` on Results, and
the host stamp helpers of core/stamp_utils.
"""

import numpy as np
import pytest

from kbmod_tpu.core import stamp_utils as jstamp
from kbmod_tpu.core.image_stack_py import ImageStackPy
from kbmod_tpu.filters.stamp_filters import append_all_stamps, append_coadds
from kbmod_tpu.ops.stamps import batched_coadds
from kbmod_tpu.results import Results
from kbmod_tpu.search import Trajectory

from kbmod_tpu_torch.core import stamp_utils as tstamp
from kbmod_tpu_torch.core.image_stack_py import ImageStackPy as TImageStackPy
from kbmod_tpu_torch.filters.stamp_filters import append_all_stamps as t_append_all_stamps
from kbmod_tpu_torch.filters.stamp_filters import append_coadds as t_append_coadds
from kbmod_tpu_torch.filters.stamp_filters import filter_stamps_by_cnn
from kbmod_tpu_torch.ops.stamps import batched_coadds as t_batched_coadds
from kbmod_tpu_torch.results import Results as TResults

EXACT = ("sum", "median", "all_stamps")
RTOL = 1e-6


def _images(seed=3, T=11, H=40, W=48):
    rng = np.random.default_rng(seed)
    sci = rng.normal(0, 3, (T, H, W)).astype(np.float32)
    var = rng.uniform(0.5, 2, (T, H, W)).astype(np.float32)
    sci[rng.uniform(size=sci.shape) < 0.05] = np.nan
    var[rng.uniform(size=sci.shape) < 0.02] = np.nan
    var[rng.uniform(size=sci.shape) < 0.02] = 0.0
    times = np.sort(rng.uniform(0, 3, T))
    times[0] = 0.0
    return sci, var, times


def _trajectories(seed, R, H=40, W=48):
    rng = np.random.default_rng(seed)
    xs, ys = rng.integers(-8, W + 8, R), rng.integers(-8, H + 8, R)
    vx, vy = rng.normal(0, 4, R), rng.normal(0, 4, R)
    xs[:2], ys[:2] = [-40, W + 40], [H + 40, -40]  # wholly off the image
    return xs, ys, vx, vy


def _assert_coadds(ref, got):
    for kind, r in ref.items():
        if kind in EXACT:
            np.testing.assert_array_equal(got[kind], r, err_msg=kind)
        else:
            np.testing.assert_allclose(got[kind], r, rtol=RTOL, atol=0, err_msg=kind)


@pytest.mark.parametrize("masked", [False, True], ids=["all-times", "obs_valid"])
@pytest.mark.parametrize("radius", [1, 5, 10])
def test_batched_coadds_match(masked, radius):
    sci, var, times = _images()
    R = 150
    xs, ys, vx, vy = _trajectories(radius, R)
    obs_valid = None
    if masked:
        obs_valid = np.random.default_rng(radius).uniform(size=(R, len(times))) < 0.7
        obs_valid[2:5] = False  # rows without a valid time
    kinds = ["sum", "mean", "median", "weighted", "all_stamps"]
    ref = batched_coadds(sci, var, times, xs, ys, vx, vy, radius, kinds, obs_valid=obs_valid)
    got = t_batched_coadds(list(sci), list(var), times, xs, ys, vx, vy, radius, kinds, obs_valid=obs_valid,
                           device="cpu")
    _assert_coadds(ref, got)
    S = 2 * radius + 1
    assert got["sum"].shape == (R, S, S) and got["all_stamps"].shape == (R, len(times), S, S)
    assert not got["sum"][:2].any() and not got["all_stamps"][:2].any()  # off the image: zeros
    if masked:
        assert not got["mean"][2:5].any() and not got["weighted"][2:5].any()


def test_batched_coadds_chunks_and_stacked_input():
    """The result does not depend on the chunk size or on whether the images
    come as a list or as one (T, H, W) array."""
    sci, var, times = _images(seed=8)
    xs, ys, vx, vy = _trajectories(8, 70)
    kinds = ["sum", "mean", "median", "weighted"]
    whole = t_batched_coadds(sci, var, times, xs, ys, vx, vy, 4, kinds, device="cpu")
    chunked = t_batched_coadds(list(sci), list(var), times, xs, ys, vx, vy, 4, kinds, chunk=16, device="cpu")
    for k in kinds:
        np.testing.assert_array_equal(chunked[k], whole[k], err_msg=k)


def _stacks(seed=5):
    sci, var, _ = _images(seed=seed, T=8)
    # Two nights of four visits (MJD 60000.1.. and 60001.1..).
    times = np.array([60000.10, 60000.12, 60000.14, 60000.16, 60001.10, 60001.12, 60001.14, 60001.16])
    psfs = [np.ones((1, 1), np.float32)] * len(times)
    ref = ImageStackPy(times=list(times), sci=[s.copy() for s in sci], var=[v.copy() for v in var], psfs=psfs)
    got = TImageStackPy(times=list(times), sci=[s.copy() for s in sci], var=[v.copy() for v in var], psfs=psfs)
    return ref, got


def _results(n=30, T=8, with_valid=True):
    rng = np.random.default_rng(n)
    data = dict(x=rng.integers(0, 48, n), y=rng.integers(0, 40, n), vx=rng.normal(0, 3, n), vy=rng.normal(0, 3, n),
                likelihood=rng.normal(10, 1, n), flux=rng.normal(5, 1, n), obs_count=np.full(n, T))
    ref, got = Results({k: v.copy() for k, v in data.items()}), TResults({k: v.copy() for k, v in data.items()})
    if with_valid:
        valid = rng.uniform(size=(n, T)) < 0.8
        ref.table["obs_valid"] = valid.copy()
        got.table["obs_valid"] = valid.copy()
    return ref, got


@pytest.mark.parametrize("nightly", [False, True])
@pytest.mark.parametrize("with_valid", [False, True])
def test_append_coadds_matches(nightly, with_valid):
    ref_stack, got_stack = _stacks()
    ref, got = _results(with_valid=with_valid)
    kinds = ["sum", "mean", "median", "weighted"]
    append_coadds(ref, ref_stack, kinds, 4, nightly=nightly)
    t_append_coadds(got, got_stack, kinds, 4, nightly=nightly, device="cpu")
    assert set(got.colnames) == set(ref.colnames)
    cols = [c for c in ref.colnames if c.startswith("coadd_")]
    assert len(cols) == (12 if nightly else 4)
    for c in cols:
        if c.startswith(("coadd_sum", "coadd_median")):
            np.testing.assert_array_equal(got[c], ref[c], err_msg=c)
        else:
            np.testing.assert_allclose(got[c], ref[c], rtol=RTOL, err_msg=c)


def test_append_all_stamps_and_empty_results():
    ref_stack, got_stack = _stacks(seed=6)
    ref, got = _results()
    append_all_stamps(ref, ref_stack, 3)
    t_append_all_stamps(got, got_stack, 3, device="cpu")
    np.testing.assert_array_equal(got["all_stamps"], ref["all_stamps"])
    empty = TResults()
    t_append_coadds(empty, got_stack, ["sum"], 3, device="cpu")
    assert empty["coadd_sum"].shape == (0, 7, 7)
    with pytest.raises(ValueError, match="coadd type"):  # no coadd_mean column to vet
        filter_stamps_by_cnn(got, "model.pt", device="cpu")


def test_host_stamp_helpers_match():
    sci, var, times = _images(seed=9, T=6)
    trj = Trajectory(x=3, y=38, vx=-2.5, vy=1.5)
    for to_include in (None, [0, 2, 5]):
        xv, yv = jstamp.predict_stamp_centers(trj, times)
        ref = jstamp.extract_stamp_stack(sci, xv, yv, 4, to_include=to_include)
        np.testing.assert_array_equal(tstamp.predict_stamp_centers(trj, times)[0], xv)
        np.testing.assert_array_equal(tstamp.extract_stamp_stack(sci, xv, yv, 4, to_include=to_include), ref)
    stack = np.stack([jstamp.extract_stamp(s, 10, 7, 3) for s in sci])
    vstack = np.stack([jstamp.extract_stamp(v, 10, 7, 3) for v in var])
    for name in ("coadd_sum", "coadd_mean", "coadd_median"):
        np.testing.assert_array_equal(getattr(tstamp, name)(stack), getattr(jstamp, name)(stack), err_msg=name)
    np.testing.assert_array_equal(tstamp.coadd_weighted(stack, vstack), jstamp.coadd_weighted(stack, vstack))
    xs, ys = np.array([[1, 60, 4, 5, -1, 7], [0] * 6]), np.array([[2, 3, 39, 40, 5, 6], [1] * 6])
    np.testing.assert_array_equal(tstamp.extract_curve_values(sci, xs, ys), jstamp.extract_curve_values(sci, xs, ys))
