"""The port's Results against the JAX package's on the same rows: building
from trajectories, the psi/phi statistics, obs_valid, filtering with
tracking and revert, batch extension, sorting, and the files (ECSV, parquet,
HDF5; side files of the destructive writer), each written by one package and
read by the other. Equality is exact: both run the same numpy steps."""

import numpy as np
import pytest

from kbmod_tpu.results import Results, write_results_to_files_destructive
from kbmod_tpu.search import Trajectory
from kbmod_tpu.search.trajectory_list import TrajectoryList

from kbmod_tpu_torch.results import Results as TResults
from kbmod_tpu_torch.results import write_results_to_files_destructive as t_write_destructive
from kbmod_tpu_torch.search import Trajectory as TTrajectory
from kbmod_tpu_torch.search import TrajectoryList as TTrajectoryList

N, T = 12, 7
REQUIRED = ("x", "y", "vx", "vy", "likelihood", "flux", "obs_count")


def _rows(seed=5):
    rng = np.random.default_rng(seed)
    arrays = dict(
        x=rng.integers(0, 50, N).astype(np.int32), y=rng.integers(0, 40, N).astype(np.int32),
        vx=rng.normal(0, 3, N).astype(np.float32), vy=rng.normal(0, 3, N).astype(np.float32),
        lh=rng.normal(10, 4, N).astype(np.float32), flux=rng.normal(5, 1, N).astype(np.float32),
        obs_count=rng.integers(1, T + 1, N).astype(np.int32),
    )
    psi = rng.normal(1, 2, (N, T)).astype(np.float32)
    phi = rng.uniform(0.1, 2, (N, T)).astype(np.float32)
    phi[2] = 0.0  # a row whose phi sums to zero
    valid = rng.uniform(size=(N, T)) < 0.8
    valid[4] = False  # a row with no valid observation
    return arrays, psi, phi, valid


def _pair(track=False):
    arrays, psi, phi, valid = _rows()
    ref = Results.from_trajectories(TrajectoryList(dict(arrays)), track_filtered=track)
    got = TResults.from_trajectories(TTrajectoryList(dict(arrays)), track_filtered=track)
    got.table["uuid"] = ref.table["uuid"].copy()
    return ref, got, psi, phi, valid


def _assert_same(ref, got, cols=None):
    assert len(ref) == len(got)
    cols = cols or ref.colnames
    assert set(ref.colnames) == set(got.colnames)
    for k in cols:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)


def test_from_trajectory_objects_and_list():
    arrays, _, _, _ = _rows()
    trjs = [Trajectory(x=int(x), y=int(y), vx=float(vx), vy=float(vy), lh=float(lh), flux=float(f), obs_count=int(o))
            for x, y, vx, vy, lh, f, o in zip(*(arrays[k] for k in ("x", "y", "vx", "vy", "lh", "flux", "obs_count")))]
    t_trjs = [TTrajectory(x=t.x, y=t.y, vx=t.vx, vy=t.vy, lh=t.lh, flux=t.flux, obs_count=t.obs_count) for t in trjs]
    ref, got = Results.from_trajectories(trjs), TResults.from_trajectories(t_trjs)
    _assert_same(ref, got, REQUIRED)
    back = got.make_trajectory_list()
    assert [(t.x, t.y, t.obs_count) for t in back] == [(t.x, t.y, t.obs_count) for t in trjs]
    assert len(got["uuid"]) == N and len(set(got["uuid"])) == N


def test_psi_phi_obs_valid_and_curves():
    ref, got, psi, phi, valid = _pair()
    ref.add_psi_phi_data(psi, phi)
    got.add_psi_phi_data(psi, phi)
    _assert_same(ref, got)
    ref.update_obs_valid(valid)
    got.update_obs_valid(valid)
    _assert_same(ref, got)
    assert len(got) == N - 1 and got.filtered_stats["no valid observations"] == 1
    np.testing.assert_array_equal(
        got.compute_likelihood_curves(filter_obs=True, mask_value=np.nan),
        ref.compute_likelihood_curves(filter_obs=True, mask_value=np.nan),
    )


def test_filter_track_revert_extend_sort():
    ref, got, psi, phi, valid = _pair(track=True)
    for r in (ref, got):
        r.add_psi_phi_data(psi, phi, obs_valid=valid)
        r.filter_rows(np.asarray(r["likelihood"]) > 1.0, "lh")
        r.filter_rows([0, 2, 3], "first")
    _assert_same(ref, got)
    _assert_same(ref.get_filtered("lh"), got.get_filtered("lh"))
    assert got.filtered_stats == ref.filtered_stats
    for r in (ref, got):
        r.revert_filter(label="first", add_column="filtered_reason")
    _assert_same(ref, got)

    batches_ref, batches_got = [], []
    for lo in range(0, N, 5):
        sub = {k: v[lo : lo + 5] for k, v in _rows(seed=9)[0].items()}
        a, b = Results.from_trajectories(TrajectoryList(sub), True), TResults.from_trajectories(TTrajectoryList(sub), True)
        b.table["uuid"] = a.table["uuid"].copy()
        for r in (a, b):
            r.filter_rows(np.asarray(r["obs_count"]) > 2, "obs")
        batches_ref.append(a)
        batches_got.append(b)
    er, eg = Results(track_filtered=True).extend_batches(batches_ref), TResults(track_filtered=True).extend_batches(batches_got)
    _assert_same(er, eg)
    assert eg.filtered_stats == er.filtered_stats
    _assert_same(er.get_filtered("obs"), eg.get_filtered("obs"))
    er.sort("likelihood", descending=True)
    eg.sort("likelihood", descending=True)
    _assert_same(er, eg)
    eg.sort("x", descending=False)
    assert list(eg["x"]) == sorted(eg["x"])


@pytest.mark.parametrize("suffix", [".ecsv", ".parquet", ".hdf5"])
def test_files_cross_read(tmp_path, suffix):
    ref, got, psi, phi, valid = _pair()
    stamps = np.random.default_rng(2).normal(size=(N, 5, 5)).astype(np.float32)
    for r in (ref, got):
        r.add_psi_phi_data(psi, phi, obs_valid=valid)
        r.table["coadd_sum"] = stamps
        r.set_mjd_utc_mid(np.linspace(60000.0, 60003.0, T))
    ref.write_table(tmp_path / f"ref{suffix}", extra_meta={"num_img": T})
    got.write_table(tmp_path / f"got{suffix}", extra_meta={"num_img": T})
    for name in ("ref", "got"):
        back = TResults.read_table(tmp_path / f"{name}{suffix}")
        _assert_same(ref, back)
        np.testing.assert_array_equal(back.mjd_utc_mid, ref.mjd_utc_mid)
        again = Results.read_table(tmp_path / f"{name}{suffix}")
        _assert_same(again, back)


def test_destructive_write_side_files(tmp_path):
    ref, got, psi, phi, valid = _pair()
    cube = np.random.default_rng(3).normal(size=(N, T, 3, 3)).astype(np.float32)
    for r in (ref, got):
        r.add_psi_phi_data(psi, phi, obs_valid=valid)
        r.table["all_stamps"] = cube
    write_results_to_files_destructive(tmp_path / "ref.ecsv", ref, separate_col_files=["all_stamps"],
                                       drop_columns=["phi_curve", "x"])
    t_write_destructive(tmp_path / "got.ecsv", got, separate_col_files=["all_stamps"], drop_columns=["phi_curve", "x"])
    _assert_same(ref, got)
    assert "all_stamps" not in got.colnames and "phi_curve" not in got.colnames and "x" in got.colnames
    for name in ("ref", "got"):
        back = TResults.read_table(tmp_path / f"{name}.ecsv", load_aux_files=True)
        np.testing.assert_array_equal(back["all_stamps"], cube)
        np.testing.assert_array_equal(back["psi_curve"], got["psi_curve"])


def test_wcs_waits_for_the_port(tmp_path):
    """The port's WCS (once a deferral) serializes with the table: a file
    the port writes reads back in the JAX package with an equal WCS, and
    the other way round."""
    from kbmod_tpu.results import Results as JResults
    from kbmod_tpu.wcs_utils import make_fake_wcs as j_fake_wcs, wcs_fits_equal as j_equal
    from kbmod_tpu_torch.wcs_utils import make_fake_wcs, wcs_fits_equal

    got = TResults.from_trajectories(TTrajectoryList(dict(_rows()[0])))
    got.wcs = make_fake_wcs(200.5, -10.25, 300, 400, deg_per_pixel=0.27 / 3600)
    got.write_table(tmp_path / "w.ecsv")
    back = JResults.read_table(tmp_path / "w.ecsv")
    assert j_equal(back.wcs, j_fake_wcs(200.5, -10.25, 300, 400, deg_per_pixel=0.27 / 3600))
    back.write_table(tmp_path / "j.ecsv")
    again = TResults.read_table(tmp_path / "j.ecsv")
    assert wcs_fits_equal(again.wcs, got.wcs)
    np.testing.assert_allclose(again.wcs.pixel_to_world_values(12.0, 34.0), got.wcs.pixel_to_world_values(12.0, 34.0))
