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
    assert set(jgen.TrajectoryGenerator.generators) <= set(tgen.TrajectoryGenerator.generators)
    with pytest.raises(KeyError):
        tgen.create_trajectory_generator({"name": "NoSuchSearch"})
    with pytest.raises(NotImplementedError, match="WCS"):
        tgen.create_trajectory_generator({"name": "EclipticCenteredSearch", "velocities": [1.0, 2.0, 2],
                                          "angles": [0.0, 1.0, 2]}, work_unit=object())
    with pytest.raises(NotImplementedError, match="WCS"):
        tgen.KBMODV1SearchConfig([1.0, 2.0, 2], [0.1, 0.1, 2], work_unit=object())
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
