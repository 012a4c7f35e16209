"""The port's injection against the JAX package's, on the CPU.

The cases of tests/test_injection.py run again against
kbmod_tpu_torch.injection (the Butler path through tests/utils/mock_butler.py
and tests/utils/mock_injection.py); then both packages side by side: equal
catalogs for the same seed, equal injected stacks, and a search of each
package's injected WorkUnit (the port's ``run_search_from_work_unit`` with
``device="cpu"``) that recovers the objects with equal
``match_injection_results`` tables.

Tolerances: none. Catalogs, injected pixels and recovery tables are equal
(host float64 and float32 arithmetic, the same in both packages); the
matched rows' x, y, vx and vy are equal.
"""

import numpy as np
import pytest

from kbmod_tpu_torch.fake_data.fake_data_creator import FakeDataSet, create_fake_times
from kbmod_tpu_torch.injection import (
    generate_injection_catalog,
    inject_sources_into_work_unit,
    match_injection_results,
)
from kbmod_tpu_torch.results import Results
from kbmod_tpu_torch.wcs_utils import make_fake_wcs


class TestInjection:
    def test_generate_catalog(self):
        catalog = generate_injection_catalog(
            20, 200.0, -7.0, 57130.0, vel_min=10.0, vel_max=100.0, seed=11
        )
        assert len(catalog) == 20
        assert np.all(np.abs(np.asarray(catalog["ra"]) - 200.0) < 0.2)
        speeds = np.hypot(catalog["v_ra"], catalog["v_dec"]) * 3600.0
        assert np.all(speeds >= 9.99)
        assert np.all(speeds <= 100.01)

    def test_generate_catalog_with_ebd(self):
        plain = generate_injection_catalog(5, 200.0, -7.0, 57130.0, seed=3)
        ebd = generate_injection_catalog(5, 200.0, -7.0, 57130.0, seed=3, barycentric_distance=40.0)
        # The inverse-EBD correction shifts the positions.
        assert not np.allclose(np.asarray(plain["ra"]), np.asarray(ebd["ra"]))

    def test_inject_and_recover(self):
        times = create_fake_times(8, t0=57130.0, obs_per_day=4)
        ds = FakeDataSet(128, 128, times, use_seed=21)
        work = ds.get_work_unit()
        work.wcs = make_fake_wcs(200.0, -7.0, 128, 128, 1.0 / 3600.0)

        catalog = generate_injection_catalog(
            3,
            200.0,
            -7.0,
            57130.0,
            ra_spread_deg=0.005,
            dec_spread_deg=0.005,
            vel_min=20.0,
            vel_max=60.0,
            mag_min=18.0,
            mag_max=19.0,
            seed=7,
        )
        injected = inject_sources_into_work_unit(work, catalog, zero_point=27.0)
        assert len(injected) == 3
        # The injections brightened the images.
        assert np.nanmax(work.im_stack.sci[0]) > 20.0

        # A perfect result set (the injected trajectories) matches fully.
        results = Results.from_trajectories(injected)
        match = match_injection_results(catalog, results, work, threshold_pixels=3.0)
        assert np.all(np.asarray(match["recovered"]))

        # An empty result set recovers nothing.
        empty_match = match_injection_results(catalog, Results(), work)
        assert not np.any(np.asarray(empty_match["recovered"]))


class TestInjectSourcesIntoIC:
    """The reference's Butler/ImageCollection injection path
    (injection.py:204-322), exercised against the mock LSST stack."""

    def _butler_ic(self, n=3):
        from tests.utils.mock_butler import MockButler, MockDatasetRef, MockExposure, install_mock_lsst

        install_mock_lsst()
        from kbmod_tpu_torch.image_collection import ImageCollection
        from kbmod_tpu_torch.standardizers.butler_standardizer import ButlerStandardizer

        butler = MockButler()
        stds = []
        for i in range(n):
            exp = MockExposure(mjd=57130.5 + 0.1 * i, seed=i)
            stds.append(ButlerStandardizer(MockDatasetRef(exp), butler=butler))
        return ImageCollection.fromStandardizers(stds), butler

    def test_inject_into_ic(self):
        from tests.utils.mock_injection import MockVisitInjectTask
        from kbmod_tpu_torch.injection import inject_sources_into_ic
        from kbmod_tpu_torch.table import Table

        ic, butler = self._butler_ic()
        assert "dataId" in ic.data.colnames

        obstimes = np.asarray(ic["mjd_mid"], dtype=float)
        # One bright source per epoch near the chip center (200.0, -7.0).
        catalog = Table({
            "injection_id": np.arange(len(obstimes)),
            "ra": np.full(len(obstimes), 200.0),
            "dec": np.full(len(obstimes), -7.0),
            "mag": np.full(len(obstimes), 20.0),
            "obj_ids": np.zeros(len(obstimes), dtype=int),
            "obstime": obstimes,
            "source_type": np.array(["Star"] * len(obstimes), dtype=object),
        })
        before = [np.array(ic.get_standardizer(i, butler=butler)["std"].exposure.image.array)
                  for i in range(len(ic))]
        new_ic, injected = inject_sources_into_ic(
            ic, catalog, butler, inject_task=MockVisitInjectTask()
        )
        assert len(new_ic) == len(ic)
        assert len(injected) == len(obstimes)
        # Every rebuilt exposure gained flux; the originals are untouched.
        for i in range(len(new_ic)):
            std = new_ic.get_standardizer(i, butler=butler)["std"]
            after = np.array(std.exposure.image.array)
            assert after.sum() > before[i].sum() + 50.0
            orig = np.array(ic.get_standardizer(i, butler=butler)["std"].exposure.image.array)
            np.testing.assert_array_equal(orig, before[i])
        # The rebuilt collection standardizes into a usable WorkUnit.
        wu = new_ic.toWorkUnit()
        assert wu.im_stack.num_times == len(ic)

    def test_epoch_without_sources_keeps_exposure(self):
        from tests.utils.mock_injection import MockVisitInjectTask
        from kbmod_tpu_torch.injection import inject_sources_into_ic
        from kbmod_tpu_torch.table import Table

        ic, butler = self._butler_ic(n=2)
        obstimes = np.asarray(ic["mjd_mid"], dtype=float)
        catalog = Table({
            "injection_id": np.array([0]),
            "ra": np.array([200.0]),
            "dec": np.array([-7.0]),
            "mag": np.array([20.0]),
            "obj_ids": np.array([0]),
            "obstime": obstimes[:1],
            "source_type": np.array(["Star"], dtype=object),
        })
        before1 = np.array(ic.get_standardizer(1, butler=butler)["std"].exposure.image.array)
        new_ic, injected = inject_sources_into_ic(
            ic, catalog, butler, inject_task=MockVisitInjectTask()
        )
        after1 = np.array(new_ic.get_standardizer(1, butler=butler)["std"].exposure.image.array)
        np.testing.assert_array_equal(after1, before1)
        assert len(injected) == 1

    def test_out_of_bounds_warns(self):
        import warnings as _warnings

        from tests.utils.mock_injection import MockVisitInjectTask
        from kbmod_tpu_torch.injection import inject_sources_into_ic
        from kbmod_tpu_torch.table import Table

        ic, butler = self._butler_ic(n=1)
        obstimes = np.asarray(ic["mjd_mid"], dtype=float)
        catalog = Table({
            "injection_id": np.array([0]),
            "ra": np.array([10.0]),  # nowhere near the chip
            "dec": np.array([80.0]),
            "mag": np.array([20.0]),
            "obj_ids": np.array([0]),
            "obstime": obstimes[:1],
            "source_type": np.array(["Star"], dtype=object),
        })
        with _warnings.catch_warnings(record=True) as caught:
            _warnings.simplefilter("always")
            new_ic, injected = inject_sources_into_ic(
                ic, catalog, butler, inject_task=MockVisitInjectTask()
            )
        assert any("rendered within bounds" in str(w.message) for w in caught)
        assert len(injected) == 0

    def test_missing_columns_raises(self):
        from kbmod_tpu_torch.injection import inject_sources_into_ic
        from kbmod_tpu_torch.image_collection import ImageCollection
        from kbmod_tpu_torch.table import Table

        ic = ImageCollection(Table({
            "mjd_mid": np.array([57130.0]),
            "location": np.array(["f"], dtype=object),
            "std_idx": np.array([0]),
            "ext_idx": np.array([0]),
            "std_name": np.array(["KBMODV1"], dtype=object),
            "ra": np.array([200.0]),
            "dec": np.array([-7.0]),
        }))
        with pytest.raises(ValueError, match="dataId"):
            inject_sources_into_ic(ic, Table({}), butler=None, inject_task=object())


class TestGenerateICInjectionCatalog:
    def test_catalog_schema_and_motion(self):
        from tests.utils.mock_butler import MockButler, MockDatasetRef, MockExposure, install_mock_lsst

        install_mock_lsst()
        from kbmod_tpu_torch.configuration import SearchConfiguration
        from kbmod_tpu_torch.image_collection import ImageCollection
        from kbmod_tpu_torch.injection import generate_ic_injection_catalog
        from kbmod_tpu_torch.standardizers.butler_standardizer import ButlerStandardizer
        from kbmod_tpu_torch.wcs_utils import make_fake_wcs

        butler = MockButler()
        stds = [
            ButlerStandardizer(MockDatasetRef(MockExposure(mjd=57130.5 + 0.2 * i, seed=i)), butler=butler)
            for i in range(3)
        ]
        ic = ImageCollection.fromStandardizers(stds)
        wcs = make_fake_wcs(200.0, -7.0, 256, 256, deg_per_pixel=0.001)
        config = SearchConfiguration()
        config.set("generator_config", {
            "name": "VelocityGridSearch",
            "vx_steps": 5, "min_vx": -2.0, "max_vx": 2.0,
            "vy_steps": 5, "min_vy": -2.0, "max_vy": 2.0,
        })
        cat = generate_ic_injection_catalog(ic, config, wcs, n_objs_per_ic=4, seed=7)
        n_epochs = len(np.unique(np.asarray(ic["mjd_mid"])))
        assert len(cat) == 4 * n_epochs
        for col in ("injection_id", "ra", "dec", "mag", "obj_ids", "obstime",
                    "plot_x", "plot_y", "source_type"):
            assert col in cat.colnames
        # Straight-line pixel motion: per-object plot_x is linear in time.
        for oid in range(4):
            sel = np.asarray(cat["obj_ids"]) == oid
            xs = np.asarray(cat["plot_x"])[sel]
            ts = np.asarray(cat["obstime"])[sel]
            resid = xs - np.polyval(np.polyfit(ts, xs, 1), ts)
            assert np.max(np.abs(resid)) < 1e-8


# ----------------------------------------------------------------------
# Parity with the JAX package
# ----------------------------------------------------------------------

from kbmod_tpu import injection as j_inj  # noqa: E402
from kbmod_tpu.configuration import SearchConfiguration as JConfig  # noqa: E402
from kbmod_tpu.fake_data.fake_data_creator import FakeDataSet as JFakeDataSet  # noqa: E402
from kbmod_tpu.image_collection import ImageCollection as JImageCollection  # noqa: E402
from kbmod_tpu.run_search import SearchRunner as JSearchRunner  # noqa: E402
from kbmod_tpu.wcs_utils import make_fake_wcs as j_make_fake_wcs  # noqa: E402

from kbmod_tpu_torch import injection as t_inj  # noqa: E402
from kbmod_tpu_torch.configuration import SearchConfiguration  # noqa: E402
from kbmod_tpu_torch.image_collection import ImageCollection  # noqa: E402
from kbmod_tpu_torch.run_search import SearchRunner  # noqa: E402
from test_torch_standardizers import _assert_same_tables, write_rubin_style_fits  # noqa: E402


@pytest.mark.parametrize("kw", [dict(seed=11), dict(seed=3, barycentric_distance=40.0),
                                dict(seed=5, vel_min=10.0, vel_max=100.0, mag_min=21.0, mag_max=22.0,
                                     angle_jitter=0.3, ra_spread_deg=0.01, dec_spread_deg=0.02)],
                         ids=["plain", "ebd", "options"])
def test_generate_injection_catalog_same_seed(kw):
    t = t_inj.generate_injection_catalog(12, 200.0, -7.0, 57130.0, **kw)
    j = j_inj.generate_injection_catalog(12, 200.0, -7.0, 57130.0, **kw)
    _assert_same_tables(t, j)


@pytest.mark.parametrize("guess_distance", [None, 30.0])
def test_generate_ic_injection_catalog_same_seed(tmp_path, guess_distance):
    """The per-epoch catalog of a KBMODV1 collection (which carries the
    observatory) in both packages, the search's generator the same."""
    paths = [write_rubin_style_fits(str(tmp_path / f"c{i}.fits"), seed=i, mjd=57130.5 + 0.2 * i) for i in range(3)]
    gen = {"name": "VelocityGridSearch", "vx_steps": 5, "min_vx": -2.0, "max_vx": 2.0,
           "vy_steps": 5, "min_vy": -2.0, "max_vy": 2.0}
    t = t_inj.generate_ic_injection_catalog(
        ImageCollection.fromTargets(paths), SearchConfiguration({"generator_config": gen}),
        make_fake_wcs(200.0, -7.0, 256, 256, deg_per_pixel=0.001), n_objs_per_ic=4, seed=7,
        guess_distance=guess_distance)
    j = j_inj.generate_ic_injection_catalog(
        JImageCollection.fromTargets(paths), JConfig({"generator_config": gen}),
        j_make_fake_wcs(200.0, -7.0, 256, 256, deg_per_pixel=0.001), n_objs_per_ic=4, seed=7,
        guess_distance=guess_distance)
    _assert_same_tables(t, j)


_RECOVERY_CONFIG = {
    "generator_config": {"name": "EclipticCenteredSearch", "velocities": [15.0, 45.0, 31],
                         "angles": [-0.3, 0.3, 25], "angle_units": "radian"},
    "num_obs": 6, "lh_level": 10.0, "do_clustering": True, "cluster_type": "all",
}


def test_inject_and_recover_both_packages():
    """Objects injected into the same fake WorkUnit by both packages, the
    WorkUnit searched by each package's runner (the port's on the CPU):
    equal injected pixels and equal recovery tables, every object found."""
    times = create_fake_times(10, t0=57130.0, obs_per_day=4)
    t_ds = FakeDataSet(128, 128, times, use_seed=21, mask_fraction=0.01)
    j_ds = JFakeDataSet(128, 128, times, use_seed=21, mask_fraction=0.01)
    t_wu, j_wu = t_ds.get_work_unit(dict(_RECOVERY_CONFIG)), j_ds.get_work_unit(dict(_RECOVERY_CONFIG))
    t_wu.wcs = make_fake_wcs(200.0, -7.0, 128, 128, 1.0 / 3600.0)
    j_wu.wcs = j_make_fake_wcs(200.0, -7.0, 128, 128, 1.0 / 3600.0)
    # Objects start near x = 95 and move about 20-30 pixels a day towards
    # x = 0 (the ecliptic's direction in this WCS), so they stay in frame.
    ra0, dec0 = (float(v) for v in t_wu.wcs.pixel_to_world_values(95.0, 64.0))
    kw = dict(ra_spread_deg=0.002, dec_spread_deg=0.012, vel_min=20.0, vel_max=30.0, mag_min=19.0,
              mag_max=19.5, angle_jitter=0.05, seed=18)
    t_cat = t_inj.generate_injection_catalog(3, ra0, dec0, 57130.0, **kw)
    j_cat = j_inj.generate_injection_catalog(3, ra0, dec0, 57130.0, **kw)
    t_trj = t_inj.inject_sources_into_work_unit(t_wu, t_cat)
    j_trj = j_inj.inject_sources_into_work_unit(j_wu, j_cat)
    assert [(a.x, a.y, a.vx, a.vy, a.flux) for a in t_trj] == [(b.x, b.y, b.vx, b.vy, b.flux) for b in j_trj]
    # The seed puts the objects more than the clustering's 20 pixels apart.
    assert min(np.hypot(a.x - b.x, a.y - b.y) for a in t_trj for b in t_trj if a is not b) > 30
    for i in range(len(times)):
        assert np.array_equal(t_wu.im_stack.sci[i], j_wu.im_stack.sci[i], equal_nan=True)

    t_res = SearchRunner().run_search_from_work_unit(t_wu, device="cpu")
    j_res = JSearchRunner().run_search_from_work_unit(j_wu)
    t_match = t_inj.match_injection_results(t_cat, t_res, t_wu)
    j_match = j_inj.match_injection_results(j_cat, j_res, j_wu)
    _assert_same_tables(t_match, j_match)
    assert np.all(np.asarray(t_match["recovered"]))
    for i in np.asarray(t_match["match_idx"]):
        for col in ("x", "y", "vx", "vy"):
            assert t_res[col][i] == j_res[col][i]
