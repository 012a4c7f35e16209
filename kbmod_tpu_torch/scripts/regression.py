"""The reference's regression configuration (its tests/test_regression_test.py:131)
through the port's pipeline: a 20 x 1024 x 512 stack, 20 known
trajectories (2 starting off the chip, ``x/y_pixel_buffer`` 10),
EclipticCenteredSearch on a 26 x 52 grid, the in-kernel sigma-G pool with
``clip_negative``, median stamps, through ``run_search_from_work_unit``.
Every injected object must be recovered, and the results file's metadata
must read back.

    python -m kbmod_tpu_torch.scripts.regression [--device cuda|cpu]
        [--velocities 92,550,52] [--results FILE]

The port of the JAX package's scripts/regression_tpu.py. On the card the
float path runs kernels K1 (the psi/phi build) and K2 (the search); with
``--device cpu`` their plain twins. ``--velocities`` trims the speed axis
(the CPU tests run the lattice-identical 16-step subset); ``--results``
keeps the results file (by default it is written to a temporary
directory). Prints the
pipeline's wall and phase walls, the launches and the card.
"""

import argparse
import os
import tempfile
import time

import numpy as np

FLUX = 500.0
# (x, y, vx, vy) of the reference's 20 objects; the last two start off the
# chip (y = 1026 past the 1024 rows, x = 514 past the 512 columns).
TRJS = [
    (357, 997, -15.814404, -172.098450),
    (477, 777, -70.858154, -117.137817),
    (408, 533, -53.721024, -106.118118),
    (425, 740, -32.865086, -132.898575),
    (515, 881, -73.831688, -93.251732),
    (412, 980, -79.985207, -192.813080),
    (443, 923, -36.977375, -103.556976),
    (368, 1015, -43.644382, -176.487488),
    (510, 1011, -125.422997, -166.863983),
    (398, 939, -51.037308, -107.434616),
    (491, 925, -74.266739, -104.155556),
    (366, 824, -18.041782, -153.808197),
    (477, 870, -45.608849, -90.093689),
    (447, 993, -38.152031, -196.087646),
    (481, 882, -96.767357, -143.192352),
    (423, 912, -104.900154, -125.859169),
    (409, 803, -99.066856, -173.469589),
    (328, 797, -33.212299, -196.984467),
    (466, 1026, -67.892105, -118.881493),
    (514, 795, -20.134245, -171.646683),
]
NUM_TIMES = 20
HEIGHT, WIDTH = 1024, 512
FULL_VELOCITIES = (92.0, 550.0, 52)
# The lattice-identical subset of the speed axis that the CPU tests search:
# the same spacing and grid points, covering every object's speed.
TRIMMED_VELOCITIES = (92.0, 92.0 + 458.0 * 15 / 51, 16)


def trajectories():
    from kbmod_tpu_torch.search import Trajectory

    return [Trajectory(x, y, vx, vy, FLUX) for x, y, vx, vy in TRJS]


def times_and_psf_sigmas(num_times=NUM_TIMES):
    """Four visits a night 0.01 d apart from MJD 57130.2, and PSF sigmas
    cycling 0.95, 1.05, 1.15."""
    times, sigmas = [], []
    seen, day = 0, 0
    for i in range(num_times):
        times.append(57130.2 + day + seen * 0.01)
        seen += 1
        if seen == 4:
            seen, day = 0, day + 1
        sigmas.append(1.05 - 0.1 + 0.1 * (i % 3))
    return times, sigmas


def make_stack(seed=1001):
    """The regression stack: noise 4.0 from ``default_rng(seed)`` and the
    20 objects added through the PSF of each image."""
    from kbmod_tpu_torch.core.psf import PSF
    from kbmod_tpu_torch.fake_data.fake_data_creator import image_stack_add_fake_object, make_fake_image_stack

    times, sigmas = times_and_psf_sigmas()
    psfs = [PSF.make_gaussian_kernel(v) for v in sigmas]
    stack = make_fake_image_stack(HEIGHT, WIDTH, times, noise_level=4.0, psfs=psfs, rng=np.random.default_rng(seed))
    for x, y, vx, vy in TRJS:
        image_stack_add_fake_object(stack, x, y, vx, vy, flux=FLUX)
    return stack


def config_dict(velocities=FULL_VELOCITIES):
    """The reference's regression configuration."""
    return {
        "psf_val": 1.05,
        "generator_config": {
            "name": "EclipticCenteredSearch",
            "angles": [np.pi - np.pi / 10.0, np.pi + np.pi / 10.0, 26],
            "velocities": list(velocities),
            "angle_units": "radian",
            "given_ecliptic": 1.1901106654050821,
        },
        "num_obs": 15,
        "lh_level": 25.0,
        "sigmaG_lims": [25, 75],
        "stamp_type": "median",
        "cluster_eps": 20.0,
        "gpu_filter": True,
        "clip_negative": True,
        "x_pixel_buffer": 10,
        "y_pixel_buffer": 10,
    }


def run(stack, result_path, velocities=FULL_VELOCITIES, device=None):
    """Search ``stack`` as a WorkUnit with the regression configuration,
    writing ``result_path``. Returns (runner, results, the file read back)."""
    from kbmod_tpu_torch.configuration import SearchConfiguration
    from kbmod_tpu_torch.results import Results
    from kbmod_tpu_torch.run_search import SearchRunner
    from kbmod_tpu_torch.work_unit import WorkUnit

    config = SearchConfiguration.from_dict(config_dict(velocities))
    config.set("result_filename", str(result_path))
    wu = WorkUnit(im_stack=stack, config=config)
    wu.org_img_meta["visit"] = [f"img_{i}" for i in range(stack.num_times)]
    runner = SearchRunner(device=device)
    results = runner.run_search_from_work_unit(wu)
    return runner, results, Results.read_table(str(result_path))


def check(loaded, stack, times):
    """The metadata that must read back, and the objects matched: returns
    the indices of the objects no row recovers."""
    from kbmod_tpu_torch.trajectory_utils import match_trajectory_sets

    if loaded.table.meta["num_img"] != len(times):
        raise AssertionError(f"num_img {loaded.table.meta['num_img']} != {len(times)}")
    if tuple(loaded.table.meta["dims"]) != (stack.width, stack.height):
        raise AssertionError(f"dims {loaded.table.meta['dims']} != {(stack.width, stack.height)}")
    if not np.allclose(loaded.table.meta["mjd_mid"], times):
        raise AssertionError("mjd_mid does not read back")
    if list(loaded.table.meta["visit"]) != [f"img_{i}" for i in range(len(times))]:
        raise AssertionError("the visit names do not read back")
    matches = match_trajectory_sets(trajectories(), loaded.make_trajectory_list(), 3.0, [0.0, 2.0])
    return [int(i) for i in np.where(np.asarray(matches) == -1)[0]]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--velocities", default=",".join(str(v) for v in FULL_VELOCITIES),
                    help="the speed axis: low,high,steps (default: the reference's 92,550,52)")
    ap.add_argument("--results", default=None, help="where to write the results file")
    args = ap.parse_args(argv)
    from kbmod_tpu_torch.device import resolve_device
    from kbmod_tpu_torch.scripts._common import device_line, phase_walls, read_counts, reset_counts

    dev = resolve_device(args.device)
    lo, hi, steps = args.velocities.split(",")
    velocities = (float(lo), float(hi), int(steps))
    stack = make_stack()
    times, _ = times_and_psf_sigmas()
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        t0 = time.perf_counter()
        path = args.results or os.path.join(tmp, "results.ecsv")
        runner, results, loaded = run(stack, path, velocities, dev)
        wall = time.perf_counter() - t0
        launches, twins = read_counts()
        missing = check(loaded, stack, times)
    print(f"regression: pipeline {wall:.2f} s, {len(results)} rows, 26 x {velocities[2]} grid; "
          f"launches {launches}, twin calls {twins}; {device_line(dev)}", flush=True)
    for phase, dt in sorted(phase_walls(runner).items(), key=lambda kv: -kv[1]):
        print(f"  phase {phase}: {dt:.2f} s", flush=True)
    if missing:
        raise AssertionError(f"{len(missing)} objects not recovered: {[TRJS[i] for i in missing]}")
    print(f"REGRESSION OK: all {len(TRJS)} recovered", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
