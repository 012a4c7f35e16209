"""Row-class snapping (``KB_SNAP_ROW_ERROR``) at survey scale: for each snap
value, the number of rounded-row classes of the 12-day default lattice
(257 speeds x 129 angles, 33,153 candidates), the route the encoded
dispatcher takes and its full-frame rate on a 100 x 4096 x 4096 uint8
stack.

    python -m kbmod_tpu_torch.scripts.snap_sweep [--device cuda|cpu]

The port of the JAX package's scripts/snap_sweep.py, with its environment:
``KB_SWEEP_T`` (100), ``KB_SWEEP_HW`` (4096), ``KB_SWEEP_SNAPS``
(``0,0.5,0.75,1.0``) and, for rehearsals, ``KB_SWEEP_C`` (whole angle rows
of the lattice, all of it by default). Snapping (``ops.search.snap_vy_rows``)
moves each candidate's row at most the snap value at the last observation,
so that rows fall into fewer classes. The JAX script packs one TPU word
stream for the sweep and asserts its guards; the port's dispatcher reads
the code pairs directly. Random codes from ``default_rng(11)``; K = 8,
min_obs 10. A rate measurement: exactness is the tests' and the survey
gates' (``last_route`` names the route).
"""

import argparse
import os
import time

import numpy as np


def lattice(C=257 * 129):
    """The 12-day lattice (``_common.twelve_day_lattice``) in float32, as
    the JAX script searches it: (vxs, vys)."""
    from kbmod_tpu_torch.scripts._common import twelve_day_lattice

    return tuple(v.astype(np.float32) for v in twelve_day_lattice(C))


def classes(vys, times, snap):
    """(searched vys, class count): snapped vy and its distinct values for
    ``snap`` > 0; else vy itself and its distinct rounded-row sequences."""
    from kbmod_tpu_torch.ops.search import snap_vy_rows

    if snap > 0:
        return snap_vy_rows(vys, times, snap)
    rr = np.floor(vys[:, None] * times[None, :] + 0.5).astype(np.int64)
    return vys, len(np.unique(rr, axis=0))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    from kbmod_tpu_torch.device import resolve_device
    from kbmod_tpu_torch.ops.search import EncodedPlanes, trajectory_offsets
    from kbmod_tpu_torch.ops.search_encoded import search_topk_encoded
    from kbmod_tpu_torch.scripts._common import EM, device_line, random_codes, timed

    dev = resolve_device(args.device)
    T = int(os.environ.get("KB_SWEEP_T", 100))
    H = W = int(os.environ.get("KB_SWEEP_HW", 4096))
    snaps = [float(s) for s in os.environ.get("KB_SWEEP_SNAPS", "0,0.5,0.75,1.0").split(",")]
    psi, phi = random_codes(11, T, H, W)
    times = np.linspace(0, 12, T)
    vxs, vys_f = lattice(int(os.environ.get("KB_SWEEP_C", 257 * 129)))
    t0 = time.perf_counter()
    planes = EncodedPlanes.from_codes(psi, phi, EM, dev)
    del psi, phi
    print(f"stack: T={T} {H}x{W} u8, C={len(vxs)}; staged {time.perf_counter() - t0:.1f}s; {device_line(dev)}",
          flush=True)
    kw = dict(x_min=0, x_max=W, y_min=0, y_max=H, k_results=8)
    rows = []
    for snap in snaps:
        vys_s, n_classes = classes(vys_f, times, snap)
        dxs, dys = trajectory_offsets(vxs, vys_s, times)
        _, t_first = timed(dev, lambda: search_topk_encoded(planes, dxs, dys, 10.0, 0.0, **kw))
        _, dt = timed(dev, lambda: search_topk_encoded(planes, dxs, dys, 10.0, 0.0, **kw))
        rate = H * W * len(vxs) / dt
        route = search_topk_encoded.last_route
        rows.append((snap, n_classes, route, rate))
        print(f"snap={snap:<5} classes={n_classes:<6} route={route} first={t_first:7.2f}s "
              f"steady={dt:7.3f}s rate={rate / 1e9:.3f}e9 evals/s", flush=True)
    print("\n| snap err (px) | vy classes | route | steady rate (e9 evals/s) |", flush=True)
    print("|---|---|---|---|", flush=True)
    for snap, n_classes, route, rate in rows:
        print(f"| {snap} | {n_classes} | {route} | {rate / 1e9:.3f} |", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
