"""The port's TrajectoryExplorer against the JAX package's, on the CPU.

The cases of tests/test_trajectory_explorer.py run again against
kbmod_tpu_torch.trajectory_explorer with ``device="cpu"``, each held to the
JAX package's explorer on the same seeded stack; then ``evaluate_around``
over a pencil of more than 64 candidates (a list that K2 keeps in its
output maps on a card), and ``refine_all_results`` over several rows with
deduplication, building psi/phi once (K1's twin counted).

Tolerances: x, y, vx, vy and obs_count exact. lh and flux within Queue 3's
bound (ROADMAP.md): the port's lh within its float64 recomputation from its
own psi/phi samples, (T+1) u sum|psi| / sqrt(sum phi) + 2 u |lh64| with
u = 2^-24 (flux likewise over sum phi), and the JAX package's lh and flux
within 1e-5 * max(1, |value|) of the port's (the two psi/phi builds agree
to 1e-5, tests/test_torch_convolve.py). Coadds and stamps within 1e-6
relative (atol 1e-6) of the JAX package's; sigma_g_res equal.
"""

import numpy as np

from kbmod_tpu.configuration import SearchConfiguration as JConfig
from kbmod_tpu.fake_data.fake_data_creator import FakeDataSet as JFakeDataSet
from kbmod_tpu.results import Results as JResults
from kbmod_tpu.search import Trajectory as JTrajectory
from kbmod_tpu.trajectory_explorer import TrajectoryExplorer as JExplorer
from kbmod_tpu.trajectory_explorer import refine_all_results as j_refine_all_results
from kbmod_tpu.wcs_utils import make_fake_wcs as j_make_fake_wcs

from kbmod_tpu_torch.configuration import SearchConfiguration
from kbmod_tpu_torch.fake_data.fake_data_creator import FakeDataSet, create_fake_times
from kbmod_tpu_torch.ops.conv_kernel import psi_phi_conv_plain
from kbmod_tpu_torch.results import Results
from kbmod_tpu_torch.search import Trajectory
from kbmod_tpu_torch.trajectory_explorer import TrajectoryExplorer, refine_all_results
from kbmod_tpu_torch.wcs_utils import make_fake_wcs

U = 2.0**-24
REL = 1e-5
EXACT_COLS = ("x", "y", "vx", "vy", "obs_count")


def _stacks(width=96, height=96, n=8, seed=91, objects=(Trajectory(x=40, y=50, vx=8.0, vy=-4.0, flux=400.0),)):
    """The same fake stack in both packages (each package's FakeDataSet
    from one seed, held equal)."""
    times = create_fake_times(n, t0=57130.0, obs_per_day=4)
    t_ds = FakeDataSet(width, height, times, use_seed=seed)
    j_ds = JFakeDataSet(width, height, times, use_seed=seed)
    for trj in objects:
        t_ds.insert_object(Trajectory(x=trj.x, y=trj.y, vx=trj.vx, vy=trj.vy, flux=trj.flux))
        j_ds.insert_object(JTrajectory(x=trj.x, y=trj.y, vx=trj.vx, vy=trj.vy, flux=trj.flux))
    for a, b in zip(t_ds.stack_py.sci, j_ds.stack_py.sci):
        assert np.array_equal(a, b, equal_nan=True)
    return t_ds.stack_py, j_ds.stack_py


def _f64_check(explorer, res):
    """Each row's lh and flux within the float64 recomputation of its own
    samples from the port's psi/phi planes (Queue 3's bound)."""
    psi, phi, valid = (np.asarray(a.cpu()) for a in explorer.search.psi_phi_array.decoded_psi_phi())
    T, H, W = psi.shape
    times = explorer.im_stack.zeroed_times
    for i in range(len(res)):
        xs = np.floor(res["x"][i] + np.float32(res["vx"][i]) * times + 0.5).astype(int)
        ys = np.floor(res["y"][i] + np.float32(res["vy"][i]) * times + 0.5).astype(int)
        ok = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
        t = np.nonzero(ok)[0]
        ok[t] &= valid[t, ys[t], xs[t]] > 0
        t = np.nonzero(ok)[0]
        p = psi[t, ys[t], xs[t]].astype(np.float64)
        f = phi[t, ys[t], xs[t]].astype(np.float64)
        assert len(t) == res["obs_count"][i]
        if f.sum() <= 0:
            continue
        lh64, flux64 = p.sum() / np.sqrt(f.sum()), p.sum() / f.sum()
        lh_bound = (T + 1) * U * np.abs(p).sum() / np.sqrt(f.sum()) + 2 * U * abs(lh64)
        flux_bound = (T + 1) * U * (np.abs(p).sum() / f.sum() + abs(flux64)) + 2 * U * abs(flux64)
        assert abs(res["likelihood"][i] - lh64) <= lh_bound, (i, res["likelihood"][i], lh64)
        assert abs(res["flux"][i] - flux64) <= flux_bound, (i, res["flux"][i], flux64)


def _assert_rows_match(t_res, j_res, explorer):
    """Rows in the same order: exact positions, velocities and counts; lh
    and flux within the bounds at the top of this file."""
    assert len(t_res) == len(j_res)
    for col in EXACT_COLS:
        np.testing.assert_array_equal(np.asarray(t_res[col]), np.asarray(j_res[col]), err_msg=col)
    for col in ("likelihood", "flux"):
        a, b = np.asarray(t_res[col], np.float64), np.asarray(j_res[col], np.float64)
        assert np.all(np.abs(a - b) <= REL * np.maximum(1.0, np.abs(b))), col
    _f64_check(explorer, t_res)


def _assert_close_images(t_res, j_res, cols):
    for col in cols:
        np.testing.assert_allclose(np.asarray(t_res[col]), np.asarray(j_res[col]), rtol=1e-6, atol=1e-6,
                                   err_msg=col)


class TestTrajectoryExplorer:
    def setup_method(self):
        self.stack, self.j_stack = _stacks()
        self.trj = Trajectory(x=40, y=50, vx=8.0, vy=-4.0, flux=400.0)
        self.explorer = TrajectoryExplorer(self.stack, config=SearchConfiguration.from_dict({"num_obs": 5}),
                                           device="cpu")
        self.j_explorer = JExplorer(self.j_stack, config=JConfig.from_dict({"num_obs": 5}))

    def test_evaluate_linear_trajectory(self):
        result = self.explorer.evaluate_linear_trajectory(40, 50, 8.0, -4.0)
        assert len(result) == 1
        assert result["likelihood"][0] > 20.0
        assert result["obs_count"][0] == 8
        assert "psi_curve" in result.colnames
        assert "coadd_mean" in result.colnames
        assert "all_stamps" in result.colnames
        assert "sigma_g_res" in result.colnames
        assert result["all_stamps"].shape[1] == 8
        j_result = self.j_explorer.evaluate_linear_trajectory(40, 50, 8.0, -4.0)
        _assert_rows_match(result, j_result, self.explorer)
        _assert_close_images(result, j_result, ("psi_curve", "phi_curve", "coadd_sum", "coadd_mean",
                                                "coadd_median", "all_stamps"))
        np.testing.assert_array_equal(np.asarray(result["sigma_g_res"]), np.asarray(j_result["sigma_g_res"]))

    def test_evaluate_angle_trajectory(self):
        from kbmod_tpu_torch.trajectory_utils import trajectory_predict_skypos

        wcs = make_fake_wcs(200.0, -7.0, 96, 96, 1.0 / 3600.0)
        coords = trajectory_predict_skypos(self.trj, wcs, [57130.0, 57131.0])
        v_ra = coords.ra_deg[1] - coords.ra_deg[0]
        v_dec = coords.dec_deg[1] - coords.dec_deg[0]
        result = self.explorer.evaluate_angle_trajectory(coords.ra_deg[0], coords.dec_deg[0], v_ra, v_dec, wcs)
        assert result["likelihood"][0] > 20.0
        j_wcs = j_make_fake_wcs(200.0, -7.0, 96, 96, 1.0 / 3600.0)
        j_result = self.j_explorer.evaluate_angle_trajectory(coords.ra_deg[0], coords.dec_deg[0], v_ra, v_dec,
                                                             j_wcs)
        _assert_rows_match(result, j_result, self.explorer)

    def test_evaluate_around(self):
        kw = dict(pixel_radius=2, max_ang_offset=0.1, ang_step=0.1, max_vel_offset=2.0, vel_step=2.0)
        result = self.explorer.evaluate_around_linear_trajectory(40, 50, 8.0, -4.0, **kw)
        assert len(result) > 0
        best = int(np.argmax(result["likelihood"]))
        assert abs(result["x"][best] - 40) <= 2
        assert abs(result["y"][best] - 50) <= 2
        j_result = self.j_explorer.evaluate_around_linear_trajectory(40, 50, 8.0, -4.0, **kw)
        _assert_same_row_sets(result, j_result, self.explorer)

    def test_refine(self):
        kw = dict(pixel_radius=4, max_dv=3.0, dv_steps=7, max_results=1)
        refined = self.explorer.refine_linear_trajectory(41, 49, 7.0, -5.0, **kw)
        assert len(refined) == 1
        assert abs(refined["x"][0] - 40) <= 1
        assert abs(refined["y"][0] - 50) <= 1
        assert abs(refined["vx"][0] - 8.0) < 1.1
        assert abs(refined["vy"][0] + 4.0) < 1.1
        _assert_rows_match(refined, self.j_explorer.refine_linear_trajectory(41, 49, 7.0, -5.0, **kw),
                           self.explorer)

    def test_refine_all_results(self):
        kw = dict(pixel_radius=4, max_dv=2.0, dv_steps=5)
        rough = Results.from_trajectories([Trajectory(x=41, y=49, vx=7.5, vy=-4.5, lh=10.0)])
        refined = refine_all_results(rough, self.stack, SearchConfiguration.from_dict({"num_obs": 5}),
                                     device="cpu", **kw)
        assert len(refined) == 1
        assert refined["likelihood"][0] > 20.0
        j_rough = JResults.from_trajectories([JTrajectory(x=41, y=49, vx=7.5, vy=-4.5, lh=10.0)])
        j_refined = j_refine_all_results(j_rough, self.j_stack, JConfig.from_dict({"num_obs": 5}), **kw)
        for col in EXACT_COLS:
            assert refined[col][0] == j_refined[col][0]


def _assert_same_row_sets(t_res, j_res, explorer):
    """The same (x, y, vx, vy) rows (evaluate_around keeps every candidate
    at every pixel, so equal lh may order them differently), matched rows
    within the bounds, and the same best row."""
    assert len(t_res) == len(j_res)
    keys = lambda r: np.lexsort([np.asarray(r[c]) for c in ("vy", "vx", "y", "x")])  # noqa: E731
    ti, ji = keys(t_res), keys(j_res)
    for col in EXACT_COLS:
        np.testing.assert_array_equal(np.asarray(t_res[col])[ti], np.asarray(j_res[col])[ji], err_msg=col)
    for col in ("likelihood", "flux"):
        a, b = np.asarray(t_res[col], np.float64)[ti], np.asarray(j_res[col], np.float64)[ji]
        assert np.all(np.abs(a - b) <= REL * np.maximum(1.0, np.abs(b))), col
    assert np.all(np.diff(np.asarray(t_res["likelihood"])) <= 0)
    for col in ("x", "y", "vx", "vy"):
        assert t_res[col][0] == j_res[col][0]
    _f64_check(explorer, t_res)


def test_evaluate_around_long_pencil():
    """A pencil of more than 64 candidates (a list kept in K2's maps on a
    card): every candidate at every pixel of a 5 x 5 window, as in the JAX
    package."""
    stack, j_stack = _stacks()
    kw = dict(pixel_radius=2, max_ang_offset=0.2, ang_step=0.05, max_vel_offset=3.0, vel_step=0.5)
    explorer = TrajectoryExplorer(stack, device="cpu")
    t_res = explorer.evaluate_around_linear_trajectory(40, 50, 8.0, -4.0, **kw)
    j_res = JExplorer(j_stack).evaluate_around_linear_trajectory(40, 50, 8.0, -4.0, **kw)
    from kbmod_tpu_torch.trajectory_generator import PencilSearch

    num_trj = len(PencilSearch(8.0, -4.0, 0.2, 0.05, 3.0, 0.5))
    assert num_trj > 64 and explorer.search.params.results_per_pixel == num_trj
    assert len(t_res) == 25 * num_trj
    _assert_same_row_sets(t_res, j_res, explorer)
    assert (t_res["x"][0], t_res["y"][0]) == (40, 50)


def test_refine_all_results_dedup_and_one_build():
    """Several rough rows around two objects, refined with deduplication:
    one row an object, the same rows as the JAX package's, and psi/phi
    built once (one call of K1's twin) for every row."""
    objs = (Trajectory(x=30, y=30, vx=6.0, vy=2.0, flux=500.0), Trajectory(x=70, y=64, vx=-5.0, vy=3.0, flux=450.0))
    stack, j_stack = _stacks(width=112, height=96, n=10, seed=7, objects=objs)
    rough = [(31, 29, 5.5, 2.5), (29, 31, 6.5, 1.5), (30, 30, 6.0, 2.0), (71, 65, -4.5, 3.5), (69, 63, -5.5, 2.5)]
    config = {"num_obs": 6}
    kw = dict(pixel_radius=6, max_dv=2.0, dv_steps=9)
    psi_phi_conv_plain.calls = 0
    refined = refine_all_results(
        Results.from_trajectories([Trajectory(x=x, y=y, vx=vx, vy=vy, lh=5.0) for x, y, vx, vy in rough]),
        stack, SearchConfiguration.from_dict(config), device="cpu", **kw)
    assert psi_phi_conv_plain.calls == 1
    j_refined = j_refine_all_results(
        JResults.from_trajectories([JTrajectory(x=x, y=y, vx=vx, vy=vy, lh=5.0) for x, y, vx, vy in rough]),
        j_stack, JConfig.from_dict(config), **kw)
    assert len(refined) == len(j_refined) == 2
    for col in EXACT_COLS:
        np.testing.assert_array_equal(np.asarray(refined[col]), np.asarray(j_refined[col]), err_msg=col)
    for col in ("likelihood", "flux"):
        a, b = np.asarray(refined[col], np.float64), np.asarray(j_refined[col], np.float64)
        assert np.all(np.abs(a - b) <= REL * np.maximum(1.0, np.abs(b))), col
    found = sorted((int(x), int(y)) for x, y in zip(refined["x"], refined["y"]))
    assert found == [(30, 30), (70, 64)]
