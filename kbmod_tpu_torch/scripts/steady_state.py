"""Repeated searches on one StackSearch, as a production loop runs them: a
20 x 1024 x 512 float stack with one object, 26 x 52 velocity candidates,
psi/phi built once and searched four times.

    python -m kbmod_tpu_torch.scripts.steady_state [--device cuda|cpu]
        [--grid 26,52]

The port of the JAX package's scripts/steady_state.py (the same stack,
object and candidates; ``--grid`` takes fewer vx and vy steps over the same
ranges for a rehearsal, ``4,12`` holding the object's own velocity). On the card each search runs K2 over the planes K1
built once; ``--device cpu`` runs the twins. Prints each search's wall,
result count and evals/s (host clock, synchronised), the best row and the
card.
"""

import argparse
import time

import numpy as np

OBJECT = dict(x=256, y=512, vx=-40.0, vy=-120.0, flux=500.0)


def make_search(device):
    from kbmod_tpu_torch.fake_data.fake_data_creator import FakeDataSet, create_fake_times
    from kbmod_tpu_torch.search import StackSearch, Trajectory

    ds = FakeDataSet(512, 1024, create_fake_times(20, 57130.0, obs_per_day=4), use_seed=3)
    ds.insert_object(Trajectory(**OBJECT))
    stack = ds.stack_py
    search = StackSearch(stack.sci, stack.var, stack.psfs, stack.zeroed_times, -1, device=device)
    search.set_min_obs(15)
    search.set_min_lh(10.0)
    return search


def candidates(n_vx=26, n_vy=52):
    from kbmod_tpu_torch.search import Trajectory

    return [Trajectory(vx=vx, vy=vy) for vx in np.linspace(-120, 0, n_vx) for vy in np.linspace(-200, -90, n_vy)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--grid", default="26,52", help="vx steps, vy steps")
    args = ap.parse_args(argv)
    from kbmod_tpu_torch.device import resolve_device
    from kbmod_tpu_torch.scripts._common import device_line, read_counts, reset_counts, sync

    dev = resolve_device(args.device)
    search = make_search(dev)
    cands = candidates(*(int(n) for n in args.grid.split(",")))
    print(f"{len(cands)} candidates, 20x1024x512 float stack; {device_line(dev)}", flush=True)
    reset_counts()
    search.preload_psi_phi_array()
    rows = []
    for i in range(4):
        t0 = time.perf_counter()
        search.search_all(cands, True)
        n = search.get_number_total_results()
        sync(dev)
        dt = time.perf_counter() - t0
        evals = len(cands) * search.width * search.height
        rows.append(search.get_results(0, 1)[0])
        print(f"search {i}: {dt:.3f} s  {n} results  {evals / dt:.4e} evals/s", flush=True)
    launches, twins = read_counts()
    best = rows[-1]
    print(f"best: {best.x} {best.y} {best.vx} {best.vy}; launches {launches}, twin calls {twins}", flush=True)
    if any((r.x, r.y, r.vx, r.vy) != (best.x, best.y, best.vx, best.vy) for r in rows):
        raise AssertionError("the repeated searches disagree")
    if (best.x, best.y) != (OBJECT["x"], OBJECT["y"]):
        raise AssertionError(f"the best row {best} is not the object")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
