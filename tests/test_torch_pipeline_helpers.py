"""The host helpers the port's pipeline brings, against the JAX package's:
every trajectory generator (the candidates exactly, from a config dict and
from a SearchConfiguration), the trajectory utilities, the ImageStackPy
methods ``run_search`` and the stamps use, ``mjd_to_day`` and the
DebugTimer. Exact equality: the two run the same numpy and math."""

import numpy as np
import pytest

from kbmod_tpu import trajectory_generator as jgen
from kbmod_tpu import trajectory_utils as jtu
from kbmod_tpu.configuration import SearchConfiguration
from kbmod_tpu.core.image_stack_py import ImageStackPy
from kbmod_tpu.search import Trajectory
from kbmod_tpu.util_functions import mjd_to_day

from kbmod_tpu_torch import trajectory_generator as tgen
from kbmod_tpu_torch import trajectory_utils as ttu
from kbmod_tpu_torch.configuration import SearchConfiguration as TSearchConfiguration
from kbmod_tpu_torch.core.image_stack_py import ImageStackPy as TImageStackPy
from kbmod_tpu_torch.core.image_stack_py import LayeredImagePy as TLayeredImagePy
from kbmod_tpu_torch.search import Trajectory as TTrajectory
from kbmod_tpu_torch.util_functions import mjd_to_day as t_mjd_to_day
from kbmod_tpu_torch.utils import DebugTimer

GENERATORS = {
    "single": {"name": "SingleVelocitySearch", "vx": 1.5, "vy": -2.0},
    "grid": {"name": "VelocityGridSearch", "vx_steps": 5, "min_vx": -3.0, "max_vx": 4.0, "vy_steps": 4,
             "min_vy": -1.0, "max_vy": 2.0},
    "pencil": {"name": "PencilSearch", "vx": 10.0, "vy": 3.0},
    "kbmodv1": {"name": "KBMODV1Search", "vel_steps": 7, "min_vel": 5.0, "max_vel": 45.0, "ang_steps": 6,
                "min_ang": -0.5, "max_ang": 0.5},
    "kbmodv1_config": {"name": "KBMODV1SearchConfig", "v_arr": [5.0, 45.0, 41], "ang_arr": [0.5, 0.5, 41],
                       "average_angle": 0.0},
    "ecliptic_default": None,
    "ecliptic_degrees": {"name": "EclipticCenteredSearch", "velocities": [10.0, 20.0, 5], "angles": [-10.0, 10.0, 7],
                         "angle_units": "degree", "velocity_units": "pix / h", "given_ecliptic": 12.0},
    "random": {"name": "RandomVelocitySearch", "min_vx": -5.0, "max_vx": 5.0, "min_vy": 0.0, "max_vy": 3.0,
               "max_samples": 50, "seed": 4},
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_match(name):
    cfg = GENERATORS[name]
    if cfg is None:  # the configuration's default, EclipticCenteredSearch
        ref, got = jgen.create_trajectory_generator(SearchConfiguration()), \
            tgen.create_trajectory_generator(TSearchConfiguration())
    else:
        ref, got = jgen.create_trajectory_generator(dict(cfg)), tgen.create_trajectory_generator(dict(cfg))
    assert type(got).__name__ == type(ref).__name__ and len(got) == len(ref)
    for a, b in zip(got.velocity_arrays(), ref.velocity_arrays()):
        np.testing.assert_array_equal(a, b)
    assert str(got) == str(ref)
    table = got.to_table()
    assert len(table) == len(ref.to_table())


def test_generator_registry_and_work_unit_deferred():
    """The registry, and the ecliptic angle a generator takes from a
    WorkUnit's WCS (no longer deferred), equal to the JAX package's."""
    from kbmod_tpu.wcs_utils import make_fake_wcs as j_make_fake_wcs
    from kbmod_tpu.work_unit import WorkUnit as JWorkUnit
    from kbmod_tpu_torch.wcs_utils import make_fake_wcs
    from kbmod_tpu_torch.work_unit import WorkUnit

    assert set(jgen.TrajectoryGenerator.generators) <= set(tgen.TrajectoryGenerator.generators)
    with pytest.raises(KeyError):
        tgen.create_trajectory_generator({"name": "NoSuchSearch"})
    st = ImageStackPy(times=[0.0], sci=[np.zeros((30, 40), np.float32)], var=[np.ones((30, 40), np.float32)])
    tst = TImageStackPy(times=[0.0], sci=[np.zeros((30, 40), np.float32)], var=[np.ones((30, 40), np.float32)])
    jwu = JWorkUnit(im_stack=st, wcs=j_make_fake_wcs(200.0, -7.0, 30, 40, 1.0 / 3600.0))
    twu = WorkUnit(im_stack=tst, wcs=make_fake_wcs(200.0, -7.0, 30, 40, 1.0 / 3600.0))
    cfg = {"name": "EclipticCenteredSearch", "velocities": [1.0, 2.0, 2], "angles": [0.0, 1.0, 2]}
    got = tgen.create_trajectory_generator(cfg, work_unit=twu)
    ref = jgen.create_trajectory_generator(cfg, work_unit=jwu)
    assert got.ecliptic_angle == ref.ecliptic_angle != 0.0
    np.testing.assert_array_equal(got.velocity_arrays()[0], ref.velocity_arrays()[0])
    got = tgen.KBMODV1SearchConfig([1.0, 2.0, 2], [0.1, 0.1, 2], work_unit=twu)
    ref = jgen.KBMODV1SearchConfig([1.0, 2.0, 2], [0.1, 0.1, 2], work_unit=jwu)
    np.testing.assert_array_equal(got.velocity_arrays()[1], ref.velocity_arrays()[1])
    with pytest.raises(ValueError):
        tgen.KBMODV1SearchConfig([1.0, 2.0, 2], [0.1, 0.1, 2])
    assert tgen.angle_to_radians(180.0, "degree") == jgen.angle_to_radians(180.0, "degree")
    assert tgen.velocity_to_pix_per_day(2.0, "pix / h") == jgen.velocity_to_pix_per_day(2.0, "pix / h")


def test_trajectory_utils_match():
    rng = np.random.default_rng(8)
    times = np.array([0.0, 0.5, 1.25, 2.0, 3.5])
    n = 9
    xs, vxs = rng.integers(0, 50, n), rng.normal(0, 5, n)
    ys, vys = rng.integers(0, 50, n), rng.normal(0, 5, n)
    for centered in (True, False):
        for as_int in (True, False):
            np.testing.assert_array_equal(ttu.predict_pixel_locations(times, xs, vxs, centered, as_int),
                                          jtu.predict_pixel_locations(times, xs, vxs, centered, as_int))
    px = 3.0 + 2.0 * times + rng.normal(0, 0.1, len(times))
    py = 7.0 - 1.0 * times + rng.normal(0, 0.1, len(times))
    a, b = ttu.fit_trajectory_from_pixels(px, py, times), jtu.fit_trajectory_from_pixels(px, py, times)
    assert (a.x, a.y, a.vx, a.vy) == (b.x, b.y, b.vx, b.vy)
    assert ttu.evaluate_trajectory_mse(a, px, py, times) == jtu.evaluate_trajectory_mse(b, px, py, times)
    t_list = [TTrajectory(x=int(x), y=int(y), vx=vx, vy=vy) for x, y, vx, vy in zip(xs, ys, vxs, vys)]
    j_list = [Trajectory(x=int(x), y=int(y), vx=vx, vy=vy) for x, y, vx, vy in zip(xs, ys, vxs, vys)]
    assert ttu.find_closest_trajectory(t_list[3], t_list, times) == jtu.find_closest_trajectory(j_list[3], j_list, times)
    assert ttu.find_closest_velocity(t_list[5], t_list) == jtu.find_closest_velocity(j_list[5], j_list)
    np.testing.assert_array_equal(ttu.match_trajectory_sets(t_list[:4], t_list[2:], 5.0, times),
                                  jtu.match_trajectory_sets(j_list[:4], j_list[2:], 5.0, times))
    results = {"x": xs, "y": ys, "vx": vxs, "vy": vys}
    for got, ref in zip(ttu.trajectory_results_best_match(t_list[:3], results, times),
                        jtu.trajectory_results_best_match(j_list[:3], results, times)):
        np.testing.assert_array_equal(got, ref)


def _stacks():
    rng = np.random.default_rng(12)
    T, H, W = 6, 10, 12
    times = [60002.3, 60000.1, 60001.7, 60000.9, 60003.0, 60002.0]
    sci = rng.normal(0, 1, (T, H, W)).astype(np.float32)
    var = rng.uniform(0.5, 1, (T, H, W)).astype(np.float32)
    mask = (rng.uniform(size=(T, H, W)) < 0.1).astype(np.int32)
    mask[2, :, 2:] = 1  # an image mostly masked
    args = dict(times=times, sci=sci, var=var, mask=mask, psfs=[np.ones((1, 1))] * T)
    return ImageStackPy(**{k: np.copy(v) if k != "psfs" else v for k, v in args.items()}), \
        TImageStackPy(**{k: np.copy(v) if k != "psfs" else v for k, v in args.items()})


def _assert_stacks_equal(ref, got):
    assert got.num_times == ref.num_times and (got.height, got.width) == (ref.height, ref.width)
    np.testing.assert_array_equal(got.times, ref.times)
    np.testing.assert_array_equal(got.zeroed_times, ref.zeroed_times)
    for a, b in zip(got.sci, ref.sci):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.var, ref.var):
        np.testing.assert_array_equal(a, b)


def test_image_stack_methods_match():
    ref, got = _stacks()
    np.testing.assert_array_equal(got.num_masked_pixels(), ref.num_masked_pixels())
    np.testing.assert_array_equal(got.get_masked_fractions(), ref.get_masked_fractions())
    assert got.get_obstime(3) == ref.get_obstime(3)
    np.testing.assert_array_equal(got.sort_by_time(), ref.sort_by_time())
    _assert_stacks_equal(ref, got)
    copy = got.copy()
    copy.sci[0][0, 0] = 99.0
    assert got.sci[0][0, 0] != 99.0
    keep = ref.get_masked_fractions() <= 0.5
    ref.filter_images(keep)
    got.filter_images(keep)
    _assert_stacks_equal(ref, got)
    assert got.num_times == 5
    img = got.get_single_image(1)
    assert isinstance(img, TLayeredImagePy) and img.time == ref.get_single_image(1).time
    np.testing.assert_array_equal(img.sci, ref.get_single_image(1).sci)
    new_sci, new_var = np.ones((10, 12), np.float32), np.full((10, 12), 2.0, np.float32)
    new_mask = np.zeros((10, 12))
    new_mask[0, :3] = 1
    ref.append_image(60004.0, new_sci.copy(), new_var.copy(), mask=new_mask)
    got.append_image(60004.0, new_sci.copy(), new_var.copy(), mask=new_mask)
    _assert_stacks_equal(ref, got)
    assert got.validate(masked_fraction=0.5) == ref.validate(masked_fraction=0.5)
    got.append_layered_image(img)
    assert got.num_times == ref.num_times + 1
    np.testing.assert_array_equal(got.stacked_sci()[-1], img.sci)


def test_mjd_to_day_and_timer():
    for mjd in (60000.0, 60676.999, 51544.5):
        assert t_mjd_to_day(mjd) == mjd_to_day(mjd)
    timer = DebugTimer("test")
    assert timer.read() >= 0.0
    timer.stop()
    assert timer.read() == timer.read()


def test_util_functions_match(tmp_path):
    """The rest of util_functions against the JAX package's: time matching
    and grouping, magnitudes, the legacy DECam loader, and the tracklet
    tables made from a Results table with sky positions."""
    from kbmod_tpu import util_functions as juf
    from kbmod_tpu_torch import util_functions as tuf
    from kbmod_tpu_torch.io import fits_io
    from kbmod_tpu_torch.results import Results

    obstimes = np.array([57000.0, 57000.0004, 57000.5, 57001.0, 57001.0009])
    queries = [57000.0003, 57000.9995, 57002.0, 56999.0]
    np.testing.assert_array_equal(tuf.get_matched_obstimes(obstimes, queries),
                                  juf.get_matched_obstimes(obstimes, queries))
    assert list(tuf.get_matched_obstimes(obstimes, queries)) == [1, 3, -1, -1]
    st = TImageStackPy(times=list(obstimes), sci=[np.zeros((2, 2), np.float32)] * 5,
                       var=[np.ones((2, 2), np.float32)] * 5)
    np.testing.assert_array_equal(st.get_matched_obstimes(queries), juf.get_matched_obstimes(obstimes, queries))
    assert tuf.unique_obstimes_and_indices(obstimes) == juf.unique_obstimes_and_indices(obstimes)
    t_u, t_g = tuf.get_unique_obstimes(obstimes[[0, 2, 0]])
    j_u, j_g = juf.get_unique_obstimes(obstimes[[0, 2, 0]])
    np.testing.assert_array_equal(t_u, j_u)
    assert [list(map(int, g)) for g in t_g] == [list(map(int, g)) for g in j_g]
    np.testing.assert_array_equal(tuf.get_magnitude(np.array([10.0, 1e4]), 31.0),
                                  juf.get_magnitude(np.array([10.0, 1e4]), 31.0))

    rng = np.random.default_rng(4)
    primary = fits_io.ImageHDU(name="PRIMARY")
    primary.header["MJD"] = 57123.25
    path = str(tmp_path / "decam.fits")
    fits_io.write_fits(path, [primary, fits_io.ImageHDU(rng.normal(size=(6, 5)).astype(np.float32)),
                              fits_io.ImageHDU((rng.uniform(size=(6, 5)) < 0.2).astype(np.float32)),
                              fits_io.ImageHDU(rng.uniform(1, 2, (6, 5)).astype(np.float32))])
    psf = np.ones((3, 3), np.float32) / 9
    got, ref = tuf.load_deccam_layered_image(path, psf), juf.load_deccam_layered_image(path, psf)
    assert got.time == ref.time == 57123.25
    for name in ("sci", "var", "mask"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    with pytest.raises(FileNotFoundError):
        tuf.load_deccam_layered_image(str(tmp_path / "none.fits"), psf)

    pytest.importorskip("pandas")
    from kbmod_tpu.results import Results as JResults

    arrays = dict(x=np.array([3, 8]), y=np.array([4, 1]), vx=np.array([1.0, 0.5], np.float32),
                  vy=np.array([0.0, 2.0], np.float32), likelihood=np.array([9.0, 7.0], np.float32),
                  flux=np.array([50.0, 20.0], np.float32), obs_count=np.array([3, 2]))
    tables = []
    for cls in (Results, JResults):
        res = cls(arrays)
        res.table["img_ra"] = np.arange(6, dtype=float).reshape(2, 3) + 200.0
        res.table["img_dec"] = np.arange(6, dtype=float).reshape(2, 3) - 7.0
        res.table["obs_valid"] = np.array([[True, True, True], [True, False, True]])
        res.set_mjd_utc_mid(obstimes[:3])
        tables.append(res)
    for first_and_last in (False, True):
        got = tuf.unravel_results(tables[0], batch_id=2, first_and_last=first_and_last)
        ref = juf.unravel_results(tables[1], batch_id=2, first_and_last=first_and_last)
        assert got.equals(ref) and len(got) == (4 if first_and_last else 5)
        assert tuf.make_manual_tracklets(got).equals(juf.make_manual_tracklets(ref))
