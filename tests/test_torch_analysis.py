"""The port's analysis/ (plotting, Visualizer, analyze_fakes, the results
rater) against the JAX package's, on the Agg backend.

Every class of tests/test_analysis.py is re-run against the port
(``Visualizer`` with ``device="cpu"``, which cuts the stamps with the plain
twin of the card's path). Then the two packages are held to each other on
the same seeded inputs: the recovery tables and scalars of
``compute_recovery_rates``/``recovery_report`` exactly, ``FakeInfo``'s
join with a WorkUnit (pixel positions, fit, stamps) exactly, and the
Visualizer's ``all_stamps`` column exactly (both cut the same float32
pixels; no arithmetic).
"""

import matplotlib

matplotlib.use("Agg")

import numpy as np
import pytest

from kbmod_tpu_torch.analysis.analyze_fakes import compute_recovery_rates, recovery_report
from kbmod_tpu_torch.analysis.plotting import (
    plot_image,
    plot_multiple_images,
    plot_time_series,
    plot_result_row,
    plot_image_bounds,
)
from kbmod_tpu_torch.analysis.visualizer import Visualizer
from kbmod_tpu_torch.fake_data.fake_data_creator import FakeDataSet, create_fake_times
from kbmod_tpu_torch.fake_data.fake_result_creator import make_fake_results, add_fake_coadds_to_results
from kbmod_tpu_torch.results import Results
from kbmod_tpu_torch.search import Trajectory
from kbmod_tpu_torch.wcs_utils import make_fake_wcs


class TestPlotting:
    def test_plot_image_and_grid(self):
        rng = np.random.default_rng(1)
        img = rng.normal(size=(20, 20))
        ax = plot_image(img, title="test")
        assert ax.get_title() == "test"
        fig = plot_multiple_images([img, img, img], labels=["a", "b", "c"], columns=2)
        assert len(fig.axes) == 3

    def test_plot_time_series(self):
        values = np.array([1.0, 2.0, np.nan, 3.0])
        ax = plot_time_series(values, times=[0, 1, 2, 3], indices=[True, True, False, True])
        assert ax is not None

    def test_plot_result_row(self):
        results = make_fake_results(6, 100, 100, 2, rng=np.random.default_rng(3))
        add_fake_coadds_to_results(results, 5, ["mean"], rng=np.random.default_rng(3))
        results.table["stamp"] = results.table["coadd_mean"]
        fig = plot_result_row(results.table[0], times=np.arange(6) * 0.1)
        assert fig is not None

    def test_plot_image_bounds(self):
        wcs_list = [make_fake_wcs(200.0 + 0.01 * i, -7.0, 64, 64) for i in range(3)]
        ax = plot_image_bounds(wcs_list, [(64, 64)] * 3, labels=["a", "b", "c"])
        assert ax is not None


class TestVisualizer:
    def test_stamps_and_summary(self):
        ds = FakeDataSet(64, 64, create_fake_times(4, 57130.0), use_seed=5)
        trj = Trajectory(x=30, y=30, vx=5.0, vy=0.0, flux=300.0)
        ds.insert_object(trj)
        results = Results.from_trajectories([trj])
        vis = Visualizer(ds.stack_py, results, device="cpu")
        vis.generate_all_stamps(radius=5)
        assert "all_stamps" in results.colnames
        assert vis.count_num_days() >= 1
        fig = vis.plot_stamps(0, columns=2)
        assert fig is not None


class TestAnalyzeFakes:
    def test_recovery_rates(self):
        fakes = [
            Trajectory(x=10, y=10, vx=1.0, vy=0.0, flux=100.0),
            Trajectory(x=50, y=50, vx=-2.0, vy=1.0, flux=100.0),
        ]
        found = Results.from_trajectories([Trajectory(x=10, y=10, vx=1.0, vy=0.0, lh=20.0)])
        rate = compute_recovery_rates(fakes, found, times=np.array([0.0, 1.0]), threshold=3.0)
        assert rate == 0.5
        by_group = compute_recovery_rates(
            fakes, found, times=np.array([0.0, 1.0]), threshold=3.0, by=np.array(["a", "b"])
        )
        assert by_group["a"] == 1.0
        assert by_group["b"] == 0.0
        mask = recovery_report(fakes, found, times=np.array([0.0, 1.0]), threshold=3.0)
        assert mask.tolist() == [True, False]


class TestResultsRater:
    def _make(self, tmp_path=None, n=3):
        from kbmod_tpu_torch.analysis.results_rater import ResultsRater

        rng = np.random.default_rng(11)
        results = make_fake_results(6, 100, 100, n, rng=rng)
        add_fake_coadds_to_results(results, 5, ["mean", "sum"], rng=rng)
        return ResultsRater(results, outfile=str(tmp_path / "rated.ecsv") if tmp_path else None)

    def test_navigation_and_labels(self, tmp_path):
        rater = self._make(tmp_path)
        assert rater.idx == 0
        rater.next_result()
        assert rater.idx == 1
        rater.set_class(1)
        assert rater.results["user_class"][1] == "Valid (1)"
        rater.previous_result()
        assert rater.idx == 0
        rater.goto_index(2)
        assert rater.idx == 2
        rater.set_notes("maybe")
        assert rater.results["notes"][2] == "maybe"

    def test_key_events(self, tmp_path):
        rater = self._make(tmp_path)

        class Ev:
            def __init__(self, key):
                self.key = key

        rater._on_key_press(Ev("right"))
        assert rater.idx == 1
        rater._on_key_press(Ev("2"))
        assert rater.results["user_class"][1] == "Noise (2)"
        rater._on_key_press(Ev("left"))
        assert rater.idx == 0
        rater._on_key_press(Ev("escape"))
        assert not rater.is_running

    def test_save_and_reload(self, tmp_path):
        rater = self._make(tmp_path)
        rater.set_class(3)
        out = str(tmp_path / "rated.ecsv")
        rater.save_to_file(out)
        from kbmod_tpu_torch.analysis.results_rater import ResultsRater

        again = ResultsRater.from_file(out)
        assert again.results["user_class"][0] == "Unknown (3)"
        assert again.outfile == out

    def test_scalar_extraction(self, tmp_path):
        from kbmod_tpu_torch.analysis.results_rater import extract_results_row_scalars

        rater = self._make(tmp_path)
        vals = extract_results_row_scalars(rater.results, 0)
        assert "likelihood" in vals and "x" in vals
        # Array-valued columns are excluded.
        assert "coadd_mean" not in vals
        import pytest as _pytest

        with _pytest.raises(IndexError):
            extract_results_row_scalars(rater.results, 99)


class TestPlottingExtras:
    def test_transform_rect(self):
        from kbmod_tpu_torch.analysis.plotting import transform_rect

        # Axis-aligned unit square, clockwise from top-left.
        pts = [(0, 1), (1, 1), (1, 0), (0, 0)]
        xy, width, height, angle = transform_rect(pts)
        assert xy == (0, 1)
        assert width == 1.0 and height == -1.0

    def test_field_bbox_footprint(self):
        import matplotlib.pyplot as plt
        from kbmod_tpu_torch.analysis.plotting import (
            plot_field, plot_bbox, plot_bboxes, plot_footprint, plot_footprints,
        )

        fig, ax = plt.subplots()
        plot_field(ax, (10.0, -5.0), 1.1)
        plot_bbox(ax, [(0, 1), (1, 1), (1, 0), (0, 0)])
        plot_bboxes(ax, [[(0, 1), (1, 1), (1, 0), (0, 0)]])
        wcs = make_fake_wcs(200.0, -7.0, 64, 64)
        plot_footprint(ax, wcs, shape=(64, 64))
        plot_footprints(ax, [wcs], shapes=[(64, 64)])
        plt.close(fig)

    def test_iter_over_obj_and_all_objs(self):
        import matplotlib.pyplot as plt
        from kbmod_tpu_torch.analysis.plotting import iter_over_obj, plot_all_objs
        from kbmod_tpu_torch.table import Table

        objs = Table({
            "Name": ["b", "a", "b", "a"],
            "epoch": [2.0, 1.0, 1.0, 2.0],
            "RA": [10.0, 20.0, 11.0, 21.0],
            "DEC": [0.0, 1.0, 0.5, 1.5],
        })
        grouped = list(iter_over_obj(objs))
        assert len(grouped) == 2
        assert list(grouped[0]["epoch"]) == [1.0, 2.0]
        fig, ax = plt.subplots()
        plot_all_objs(ax, objs, count=0)
        plot_all_objs(ax, objs, count=2, show_field=True, center=(15.0, 1.0), radius=1.0)
        plt.close(fig)

    def test_cutouts_and_histogram(self):
        import matplotlib.pyplot as plt
        from kbmod_tpu_torch.analysis.plotting import compute_lightcurve_histogram, plot_cutouts

        fig, axes = plt.subplots(2, 3)
        rng = np.random.default_rng(0)
        cuts = [rng.normal(size=(9, 9)) for _ in range(4)]
        plot_cutouts(axes, cuts)
        import pytest as _pytest

        with _pytest.raises(ValueError):
            fig2, axes2 = plt.subplots(1, 2)
            plot_cutouts(axes2, cuts)
        plt.close("all")

        row = {"psi_curve": np.array([1.0, 2.0, 0.0, 3.0]),
               "phi_curve": np.array([1.0, 1.0, 0.0, 1.0])}
        hist, edges = compute_lightcurve_histogram(row, bins=5)
        assert hist.sum() == 3

    def test_search_trajectories_plot(self):
        from kbmod_tpu_torch.analysis.plotting import plot_search_trajectories
        from kbmod_tpu_torch.trajectory_generator import VelocityGridSearch

        gen = VelocityGridSearch(3, 0.0, 2.0, 3, -1.0, 1.0)
        fig, ax = plot_search_trajectories(gen)
        assert ax.get_xlabel().startswith("vx")

    def test_wcs_on_sky(self):
        from kbmod_tpu_torch.analysis.plotting import plot_wcs_on_sky

        wcs_list = [make_fake_wcs(200.0 + i, -7.0, 32, 32) for i in range(2)]
        fig, ax = plot_wcs_on_sky(wcs_list, labels=["a", "b"])
        assert fig is not None


class TestFakeInfo:
    """The reference's per-fake analysis object (analyze_fakes.py:13-282):
    WorkUnit join, trajectory fit, stamps, and the fakes-file loader."""

    def _workunit(self, T=6, H=40, W=48):
        import matplotlib

        matplotlib.use("Agg")
        from kbmod_tpu_torch.fake_data.fake_data_creator import FakeDataSet, create_fake_times
        from kbmod_tpu_torch.wcs_utils import make_fake_wcs

        times = create_fake_times(T, t0=57130.0, obs_per_day=3)
        ds = FakeDataSet(H, W, times, use_seed=5)
        wu = ds.get_work_unit()
        wu.wcs = make_fake_wcs(25.0, -10.0, H, W, deg_per_pixel=0.01)
        return wu

    def _fake_on_trajectory(self, wu, x0=10.0, y0=12.0, vx=3.0, vy=-1.0):
        import numpy as np

        times = np.asarray(wu.get_all_obstimes())
        zeroed = times - times[0]
        xs = x0 + vx * zeroed
        ys = y0 + vy * zeroed
        ra, dec = wu.wcs.pixel_to_world_values(xs, ys)
        from kbmod_tpu_torch.analysis.analyze_fakes import FakeInfo

        return FakeInfo(times, ra, dec, mag=np.full(len(times), 22.5), name="fk1"), (xs, ys)

    def test_join_with_workunit(self):
        import numpy as np

        wu = self._workunit()
        fake, (xs, ys) = self._fake_on_trajectory(wu)
        fake.join_with_workunit(wu, radius=3)
        np.testing.assert_allclose(fake.x_pos_fakes, xs, atol=1e-6)
        np.testing.assert_allclose(fake.y_pos_fakes, ys, atol=1e-6)
        assert fake.num_times_seen == len(fake)
        assert abs(fake.trj.vx - 3.0) < 0.05
        assert abs(fake.trj.vy - (-1.0)) < 0.05
        assert fake.compute_fit_mse() < 0.5
        assert fake.xy_stamps.shape == (len(fake), 7, 7)
        assert fake.trj_stamps.shape == (len(fake), 7, 7)

    def test_out_of_bounds_counted(self):
        import numpy as np

        wu = self._workunit()
        fake, _ = self._fake_on_trajectory(wu, x0=44.0, vx=5.0)  # walks off chip
        fake.join_with_workunit(wu, radius=0)
        assert fake.num_times_seen < len(fake)
        assert fake.xy_stamps is None  # radius=0 skips stamps

    def test_duplicate_times_dropped_and_sorted(self):
        import numpy as np
        from kbmod_tpu_torch.analysis.analyze_fakes import FakeInfo

        f = FakeInfo(
            times=[57131.0, 57130.0, 57131.0],
            ra=[10.1, 10.0, 10.1],
            dec=[5.1, 5.0, 5.1],
        )
        assert len(f) == 2
        assert f.times[0] == 57130.0

    def test_load_fake_info_from_ecsv(self, tmp_path):
        import numpy as np
        from kbmod_tpu_torch.analysis.analyze_fakes import load_fake_info_from_ecsv

        path = tmp_path / "fakes.ecsv"
        path.write_text(
            "# comment line\n"
            "ORBITID RA DEC mjd_mid MAG\n"
            "101 10.0 5.0 57130.0 22.0\n"
            "101 10.1 5.1 57131.0 22.1\n"
            "202 50.0 -5.0 57130.0 23.0\n"
        )
        fakes = load_fake_info_from_ecsv(str(path), time_adjust=0.0)
        assert len(fakes) == 2
        by_name = {f.name: f for f in fakes}
        assert len(by_name["101"]) == 2
        np.testing.assert_allclose(by_name["101"].mag, [22.0, 22.1])
        assert len(by_name["202"]) == 1

    def test_plot_methods_run(self):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        wu = self._workunit()
        fake, _ = self._fake_on_trajectory(wu)
        fake.join_with_workunit(wu, radius=2)
        fake.plot_summary()
        fake.compare_stamps(inds=[0, 1])
        plt.close("all")


class TestResultRowPlots:
    def _row(self, with_coadds=True):
        import matplotlib

        matplotlib.use("Agg")
        rng = np.random.default_rng(9)
        from kbmod_tpu_torch.fake_data.fake_result_creator import make_fake_results

        res = make_fake_results(6, 64, 64, 3, rng=rng)
        res.table["stamp"] = rng.normal(0, 1, (3, 9, 9)).astype(np.float32)
        res.table["all_stamps"] = rng.normal(0, 1, (3, 6, 9, 9)).astype(np.float32)
        if with_coadds:
            for name in ("coadd_sum", "coadd_mean", "coadd_median", "coadd_weighted"):
                res.table[name] = rng.normal(0, 1, (3, 9, 9)).astype(np.float32)
        return res

    def test_plot_result_row_with_all_stamps(self):
        import matplotlib.pyplot as plt
        from kbmod_tpu_torch.analysis.plotting import plot_result_row

        res = self._row()
        fig = plot_result_row(res.table[0], times=np.arange(6) * 0.1)
        assert fig is not None
        plt.close("all")

    def test_plot_result_row_summary_both_signatures(self):
        import matplotlib.pyplot as plt
        from kbmod_tpu_torch.analysis.plotting import plot_result_row_summary

        res = self._row()
        fig1 = plot_result_row_summary(res.table[1], times=np.arange(6) * 0.1)
        fig2 = plot_result_row_summary(res, 1, times=np.arange(6) * 0.1)
        assert fig1 is not None and fig2 is not None
        plt.close("all")


# ----------------------------------------------------------------------
# The port against the JAX package on the same inputs
# ----------------------------------------------------------------------

def _random_fakes(pkg_search, rng, n):
    return [pkg_search.Trajectory(x=int(x), y=int(y), vx=float(vx), vy=float(vy), flux=100.0)
            for x, y, vx, vy in zip(rng.integers(0, 200, n), rng.integers(0, 200, n), rng.normal(0, 5, n),
                                    rng.normal(0, 5, n))]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_recovery_tables_equal_jax(seed):
    """compute_recovery_rates (overall and by group) and recovery_report on
    the same fakes and found rows: equal scalars, tables and masks."""
    import kbmod_tpu.analysis.analyze_fakes as j_af
    import kbmod_tpu.results as j_results
    import kbmod_tpu.search as j_search
    import kbmod_tpu_torch.search as t_search

    rng = np.random.default_rng(seed)
    n = 30
    state = rng.bit_generator.state
    fakes = {}
    for name, pkg in (("jax", j_search), ("torch", t_search)):
        rng.bit_generator.state = state
        fakes[name] = _random_fakes(pkg, rng, n)
    # Found rows: every other fake, nudged by up to 2 pixels, and noise.
    jitter = rng.uniform(-2.0, 2.0, (n, 2))
    noise = rng.uniform(0, 200, (10, 2))
    found = {}
    for name, pkg, res in (("jax", j_search, j_results.Results), ("torch", t_search, Results)):
        rows = [pkg.Trajectory(x=int(f.x + jitter[i, 0]), y=int(f.y + jitter[i, 1]), vx=f.vx, vy=f.vy, lh=20.0)
                for i, f in enumerate(fakes[name]) if i % 2 == 0]
        rows += [pkg.Trajectory(x=int(x), y=int(y), vx=0.0, vy=0.0, lh=5.0) for x, y in noise]
        found[name] = res.from_trajectories(rows)
    times = np.linspace(0.0, 3.0, 8)
    groups = np.array(["a", "b", "c"])[rng.integers(0, 3, n)]
    for threshold in (1.0, 3.0, 6.0):
        args = dict(times=times, threshold=threshold)
        got = compute_recovery_rates(fakes["torch"], found["torch"], **args)
        ref = j_af.compute_recovery_rates(fakes["jax"], found["jax"], **args)
        assert got == ref
        got = compute_recovery_rates(fakes["torch"], found["torch"], by=groups, **args)
        ref = j_af.compute_recovery_rates(fakes["jax"], found["jax"], by=groups, **args)
        assert got == ref
        got = recovery_report(fakes["torch"], found["torch"], **args)
        ref = j_af.recovery_report(fakes["jax"], found["jax"], **args)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_fake_info_join_equals_jax():
    """FakeInfo.join_with_workunit on one WorkUnit from each package (the
    same seeded stack and WCS): pixel positions, bounds, fit, MSE and both
    stamp stacks equal."""
    from kbmod_tpu.analysis.analyze_fakes import FakeInfo as JFakeInfo
    from kbmod_tpu.fake_data.fake_data_creator import FakeDataSet as JFakeDataSet
    from kbmod_tpu.fake_data.fake_data_creator import create_fake_times as j_times
    from kbmod_tpu.wcs_utils import make_fake_wcs as j_wcs
    from kbmod_tpu_torch.analysis.analyze_fakes import FakeInfo

    T, H, W = 7, 40, 48
    wus = []
    for ds_cls, times_fn, wcs_fn in ((JFakeDataSet, j_times, j_wcs), (FakeDataSet, create_fake_times, make_fake_wcs)):
        ds = ds_cls(H, W, times_fn(T, t0=57130.0, obs_per_day=3), use_seed=5)
        wu = ds.get_work_unit()
        wu.wcs = wcs_fn(25.0, -10.0, H, W, deg_per_pixel=0.01)
        wus.append(wu)
    for a, b in zip(wus[0].im_stack.sci, wus[1].im_stack.sci):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    times = np.asarray(wus[1].get_all_obstimes())
    zeroed = times - times[0]
    # A path that walks off the chip part way, rounding near pixel edges.
    xs, ys = 30.3 + 9.7 * zeroed, 12.6 - 1.3 * zeroed
    ra, dec = wus[1].wcs.pixel_to_world_values(xs, ys)
    mag = np.linspace(22.0, 22.6, T)
    ref = JFakeInfo(times, ra, dec, mag=mag, name="fk")
    got = FakeInfo(times, ra, dec, mag=mag, name="fk")
    ref.join_with_workunit(wus[0], radius=3)
    got.join_with_workunit(wus[1], radius=3)
    for attr in ("image_inds", "x_pos_fakes", "y_pos_fakes", "in_image_bnds", "xy_stamps", "trj_stamps"):
        np.testing.assert_array_equal(getattr(got, attr), getattr(ref, attr), err_msg=attr)
    for attr in ("x", "y", "vx", "vy"):
        assert getattr(got.trj, attr) == getattr(ref.trj, attr), attr
    assert got.num_times_seen == ref.num_times_seen < T
    assert got.compute_fit_mse() == ref.compute_fit_mse()


def test_visualizer_stamps_equal_jax():
    """Visualizer(device="cpu").generate_all_stamps against the JAX
    package's Visualizer on the same stack and rows: all_stamps equal."""
    from kbmod_tpu.analysis.visualizer import Visualizer as JVisualizer
    from kbmod_tpu.fake_data.fake_data_creator import FakeDataSet as JFakeDataSet
    from kbmod_tpu.fake_data.fake_data_creator import create_fake_times as j_times
    from kbmod_tpu.results import Results as JResults
    from kbmod_tpu.search import Trajectory as JTrajectory

    rng = np.random.default_rng(17)
    rows = [(int(x), int(y), float(vx), float(vy)) for x, y, vx, vy in
            zip(rng.integers(-3, 67, 12), rng.integers(-3, 59, 12), rng.normal(0, 6, 12), rng.normal(0, 6, 12))]
    out = []
    for ds_cls, times_fn, res_cls, trj_cls, vis_cls, kw in (
            (JFakeDataSet, j_times, JResults, JTrajectory, JVisualizer, {}),
            (FakeDataSet, create_fake_times, Results, Trajectory, Visualizer, {"device": "cpu"})):
        ds = ds_cls(64, 56, times_fn(5, 57130.0), use_seed=8, mask_fraction=0.05)
        res = res_cls.from_trajectories([trj_cls(x=x, y=y, vx=vx, vy=vy) for x, y, vx, vy in rows])
        vis = vis_cls(ds.stack_py, res, **kw)
        vis.generate_all_stamps(radius=4)
        out.append(np.asarray(res["all_stamps"]))
    assert out[1].shape == (12, 5, 9, 9)
    np.testing.assert_array_equal(out[1], out[0])


def test_visualizer_defaults_to_cuda():
    """Without a card, a Visualizer that is not asked for the CPU raises."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    ds = FakeDataSet(16, 16, create_fake_times(3, 57130.0), use_seed=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        Visualizer(ds.stack_py, Results.from_trajectories([Trajectory(x=3, y=3)]))
