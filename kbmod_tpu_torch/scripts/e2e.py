"""The whole pipeline on a 512 x 512 float stack: a fake dataset with one
object, ``SearchRunner.run_search`` with host sigma-G, clustering and sum,
mean and median coadds, and the object recovered.

    python -m kbmod_tpu_torch.scripts.e2e [--device cuda|cpu]

The port of the JAX package's scripts/e2e_tpu.py (the same stack, object,
11 x 11 velocity grid and settings). On the card the float path runs K1 and
K2; ``--device cpu`` runs their twins. Prints the wall, the best row, the
launches and the card.
"""

import argparse
import time

import numpy as np

OBJECT = dict(x=300, y=200, vx=10.0, vy=-5.0, flux=500.0)


def make_dataset():
    from kbmod_tpu_torch.fake_data.fake_data_creator import FakeDataSet, create_fake_times
    from kbmod_tpu_torch.search import Trajectory

    times = create_fake_times(10, t0=57130.0, obs_per_day=5)
    ds = FakeDataSet(512, 512, times, use_seed=1)
    ds.insert_object(Trajectory(**OBJECT))
    return ds


def make_config():
    from kbmod_tpu_torch.configuration import SearchConfiguration

    config = SearchConfiguration()
    config.set("generator_config", {
        "name": "VelocityGridSearch",
        "vx_steps": 11, "min_vx": 5.0, "max_vx": 15.0,
        "vy_steps": 11, "min_vy": -10.0, "max_vy": 0.0,
    })
    config.set("num_obs", 8)
    config.set("lh_level", 9.0)
    config.set("do_clustering", True)
    config.set("cluster_type", "all")
    config.set("coadds", ["sum", "mean", "median"])
    config.set("cnn_filter", False)
    config.set("save_all_stamps", False)
    return config


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    from kbmod_tpu_torch.device import resolve_device
    from kbmod_tpu_torch.run_search import SearchRunner
    from kbmod_tpu_torch.scripts._common import device_line, read_counts, reset_counts, sync

    dev = resolve_device(args.device)
    ds = make_dataset()
    reset_counts()
    t0 = time.perf_counter()
    results = SearchRunner(device=dev).run_search(make_config(), ds.stack_py)
    sync(dev)
    wall = time.perf_counter() - t0
    launches, twins = read_counts()
    print(f"e2e: pipeline {wall:.2f} s; {len(results)} results; launches {launches}, twin calls {twins}; "
          f"{device_line(dev)}", flush=True)
    if len(results) == 0:
        raise AssertionError("no results")
    best = results.table
    i = int(np.argmax(best["likelihood"]))
    print(f"best: x={best['x'][i]} y={best['y'][i]} vx={best['vx'][i]} vy={best['vy'][i]} "
          f"lh={best['likelihood'][i]}", flush=True)
    if abs(best["x"][i] - OBJECT["x"]) > 1 or abs(best["y"][i] - OBJECT["y"]) > 1:
        raise AssertionError("the best row is not the object")
    if "coadd_mean" not in results.colnames:
        raise AssertionError("no coadd_mean column")
    print("E2E OK", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
