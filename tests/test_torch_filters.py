"""The port's filters against the JAX package's, on the CPU.

- sigma-G: ``compute_clipped_sigma_g_matrix`` (torch.nanquantile on the
  clipper's device) against the JAX package's (``jnp.nanquantile``) on
  curves with NaNs, negative values and all-NaN rows, clip_negative on and
  off, several percentile pairs. A clipped sample may flip only where it lies
  within 2 float32 ulps of a clip bound (the two libraries interpolate a
  percentile by different formulas); on these inputs none does (the count
  is asserted). ``apply_clipped_sigma_g`` on Results alike.
- the near-duplicate grid: ``grid_keep_indices`` (numpy lexsort) keeps the
  JAX package's rows in its order, against both of the JAX module's paths
  (its native hash map, and numpy with the native helper unavailable). The
  JAX helper is built by its own loader into a private directory
  (``private_jax_native``), so that no other test process can be writing
  the shared library while this one loads it.
- clustering: every ``cluster_type`` of ``apply_clustering`` keeps the JAX
  package's rows in order (scikit-learn's DBSCAN there; connected components
  of the eps graph here), with points exactly eps apart, and the SNS
  filters on the same table.
"""

import numpy as np
import pytest
import torch

import kbmod_tpu.native as jax_native
from kbmod_tpu.filters import clustering_grid as jgrid
from kbmod_tpu.filters.clustering_filters import apply_clustering
from kbmod_tpu.filters.sigma_g_filter import SigmaGClipping, apply_clipped_sigma_g
from kbmod_tpu.filters.sns_filters import peak_offset_filter, predictive_line_cluster
from kbmod_tpu.results import Results

from kbmod_tpu_torch.filters import clustering_grid as tgrid
from kbmod_tpu_torch.filters.clustering_filters import apply_clustering as t_apply_clustering
from kbmod_tpu_torch.filters.clustering_filters import dbscan_min1_labels
from kbmod_tpu_torch.filters.sigma_g_filter import SigmaGClipping as TSigmaGClipping
from kbmod_tpu_torch.filters.sigma_g_filter import apply_clipped_sigma_g as t_apply_clipped_sigma_g
from kbmod_tpu_torch.filters.sns_filters import peak_offset_filter as t_peak_offset_filter
from kbmod_tpu_torch.filters.sns_filters import predictive_line_cluster as t_predictive_line_cluster
from kbmod_tpu_torch.results import Results as TResults


@pytest.fixture(scope="module")
def private_jax_native(tmp_path_factory):
    """The JAX package's native helper, built by its own ``_build`` from its
    own source into a directory of this module's, and loaded by its own
    ``_load``. Its loader writes the library in place, where it is shared:
    a process that loads it while another process's compiler is still
    writing it gets a truncated file and keeps the helper off. The loader's
    path and state are restored afterwards."""
    saved = jax_native._LIB, jax_native._lib, jax_native._tried
    jax_native._LIB = str(tmp_path_factory.mktemp("jax_native") / "libkbmod_native.so")
    jax_native._lib, jax_native._tried = None, False
    try:
        yield jax_native
    finally:
        jax_native._LIB, jax_native._lib, jax_native._tried = saved


CLUSTER_TYPES = ["all", "pos_vel", "position", "start_position", "mid_position", "start_end_position",
                 "nn_start_end", "nn_start", "grid_start_end", "grid_start"]


def _curves(seed, n=3000, t=11):
    rng = np.random.default_rng(seed)
    lh = rng.normal(0.5, 3.0, (n, t)).astype(np.float32)
    lh[rng.uniform(size=lh.shape) < 0.1] = np.nan
    lh[:3] = np.nan  # rows with no sample
    lh[3:6, 1:] = np.nan  # rows with one sample
    lh[6:20] = np.abs(lh[6:20])  # rows without a negative value
    lh[20:30] = -np.abs(lh[20:30])  # rows without a positive value
    lh[30:40, :5] = 100.0  # outliers
    return lh


@pytest.mark.parametrize("clip_negative", [False, True])
@pytest.mark.parametrize("lims,n_sigma", [((25, 75), 2), ((10, 90), 2), ((15, 85), 3)])
def test_sigma_g_matrix_matches(clip_negative, lims, n_sigma):
    lh = _curves(sum(lims) + n_sigma)
    ref_clip = SigmaGClipping(*lims, n_sigma, clip_negative)
    got_clip = TSigmaGClipping(*lims, n_sigma, clip_negative, device="cpu")
    assert got_clip.coeff == ref_clip.coeff
    ref = ref_clip.compute_clipped_sigma_g_matrix(lh)
    got = got_clip.compute_clipped_sigma_g_matrix(lh)
    flips = np.argwhere(ref != got)
    if len(flips):
        # Each flip must sit within 2 float32 ulps of its row's bound.
        q = torch.tensor([lims[0] / 100, 0.5, lims[1] / 100], dtype=torch.float32)
        t = torch.as_tensor(lh)
        masked = torch.where(t > 0, t, torch.nan) if clip_negative else t
        lo, med, hi = torch.nanquantile(masked, q, dim=1).numpy()
        half = np.float32(n_sigma * got_clip.coeff) * np.maximum(hi - lo, np.float32(1e-5))
        for i, j in flips:
            gap = min(abs(lh[i, j] - (med[i] - half[i])), abs(lh[i, j] - (med[i] + half[i])))
            assert gap <= 2 * np.spacing(np.abs(lh[i, j])), (i, j)
    assert len(flips) == 0
    assert ref.sum() > 0.5 * np.isfinite(lh).sum()


def test_single_curve_and_results_clipping():
    lh = _curves(4, n=40)
    ref_clip, got_clip = SigmaGClipping(25, 75, 2, False), TSigmaGClipping(25, 75, 2, False, device="cpu")
    for row in lh[40 - 5 :]:
        finite = row[np.isfinite(row)]
        np.testing.assert_array_equal(got_clip.compute_clipped_sigma_g(finite), ref_clip.compute_clipped_sigma_g(finite))
    rng = np.random.default_rng(6)
    n, t = 25, 9
    data = dict(x=np.arange(n), y=np.arange(n), vx=np.zeros(n), vy=np.zeros(n), likelihood=np.zeros(n),
                flux=np.zeros(n), obs_count=np.zeros(n, dtype=int))
    psi = rng.normal(1, 1, (n, t)).astype(np.float32)
    psi[:4, :2] = 40.0
    phi = rng.uniform(0.5, 1.5, (n, t)).astype(np.float32)
    ref, got = Results(dict(data)), TResults(dict(data))
    for r in (ref, got):
        r.add_psi_phi_data(psi, phi)
    apply_clipped_sigma_g(ref_clip, ref)
    t_apply_clipped_sigma_g(got_clip, got)
    for k in ("obs_valid", "obs_count", "likelihood", "flux"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert not got["obs_valid"][:4, :2].any()


def _trajectories(seed, n=400):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.integers(-5, 80, n).astype(np.int32), y=rng.integers(0, 60, n).astype(np.int32),
        vx=rng.normal(0, 20, n).astype(np.float32), vy=rng.normal(0, 20, n).astype(np.float32),
        lh=np.round(rng.normal(10, 3, n), 1).astype(np.float32),  # rounded: exact lh ties
    )


@pytest.mark.parametrize("native", [True, False], ids=["jax-native", "jax-numpy"])
@pytest.mark.parametrize("bin_width,max_dt", [(3, 2.0), (10, 15.0), (1, 0.5)])
def test_grid_keep_indices_matches(request, monkeypatch, native, bin_width, max_dt):
    if native:
        request.getfixturevalue("private_jax_native")
        assert jax_native.available(), "the JAX package's native helper did not build"
    else:
        monkeypatch.setattr(jax_native, "available", lambda: False)
    tr = _trajectories(bin_width)
    ref = jgrid.grid_keep_indices(tr["x"], tr["y"], tr["vx"], tr["vy"], tr["lh"], bin_width, max_dt)
    got = tgrid.grid_keep_indices(tr["x"], tr["y"], tr["vx"], tr["vy"], tr["lh"], bin_width, max_dt)
    np.testing.assert_array_equal(got, ref)
    kept, idx = tgrid.apply_trajectory_grid_filter(tr, bin_width, max_dt)
    np.testing.assert_array_equal(idx, ref)
    np.testing.assert_array_equal(kept["x"], tr["x"][ref])


def _table(seed, n):
    rng = np.random.default_rng(seed)
    t = 9
    data = dict(
        x=rng.integers(0, 40, n), y=rng.integers(0, 40, n),
        vx=rng.integers(-3, 4, n).astype(float), vy=np.round(rng.normal(0, 2, n), 2),
        likelihood=np.round(rng.normal(10, 3, n), 1), flux=rng.normal(5, 1, n), obs_count=rng.integers(3, t, n),
    )
    # Rows exactly eps (5) apart in x, and exactly sqrt(3^2 + 4^2) = 5 in (x, y).
    data["x"][:3], data["y"][:3], data["vx"][:3], data["vy"][:3] = [0, 5, 10], [50, 50, 50], 0.0, 0.0
    data["x"][3:5], data["y"][3:5], data["vx"][3:5], data["vy"][3:5] = [60, 63], [60, 64], 1.0, 1.0
    psi = rng.normal(2, 1, (n, t)).astype(np.float32)
    phi = rng.uniform(0.5, 1.5, (n, t)).astype(np.float32)
    stamps = rng.normal(0, 1, (n, 11, 11)).astype(np.float32)
    stamps[: n // 2, 5, 5] = 50.0  # half the rows peak at the centre
    return data, psi, phi, stamps


@pytest.mark.parametrize("n", [9, 300])
@pytest.mark.parametrize("cluster_type", CLUSTER_TYPES)
def test_apply_clustering_matches(cluster_type, n):
    data, _, _, _ = _table(n, n)
    ref, got = Results({k: v.copy() for k, v in data.items()}), TResults({k: v.copy() for k, v in data.items()})
    params = dict(cluster_type=cluster_type, cluster_eps=5.0, cluster_v_scale=1.0,
                  times=np.linspace(60000.0, 60003.0, 9))
    apply_clustering(ref, dict(params))
    t_apply_clustering(got, dict(params))
    assert 0 < len(got) <= n
    for k in data:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got.filtered_stats == ref.filtered_stats


def test_dbscan_labels_join_points_exactly_eps_apart():
    pts = np.array([[0, 0], [5, 0], [10, 0], [13, 4], [30, 0], [30, 5.0001]], dtype=np.float32)
    np.testing.assert_array_equal(dbscan_min1_labels(pts, 5.0), [0, 0, 0, 0, 1, 2])
    from sklearn.cluster import DBSCAN

    np.testing.assert_array_equal(DBSCAN(eps=5.0, min_samples=1).fit(pts).labels_, [0, 0, 0, 0, 1, 2])


def test_sns_filters_match():
    data, psi, phi, stamps = _table(7, 120)
    ref, got = Results({k: v.copy() for k, v in data.items()}), TResults({k: v.copy() for k, v in data.items()})
    for r in (ref, got):
        r.add_psi_phi_data(psi, phi)
        r.table["coadd_mean"] = stamps
    peak_offset_filter(ref, peak_offset_max=3)
    t_peak_offset_filter(got, peak_offset_max=3)
    np.testing.assert_array_equal(got["x"], ref["x"])
    predictive_line_cluster(ref, np.linspace(0, 3, 9), 4.0, 2, 60)
    t_predictive_line_cluster(got, np.linspace(0, 3, 9), 4.0, 2, 60)
    assert len(got) > 0
    for k in ("x", "y", "vx", "vy"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
