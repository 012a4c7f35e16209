"""The survey-scale search on one card: a 100 x 4096 x 4096 uint8 stack,
the full frame of starting pixels, through the encoded dispatcher; its rate
(evals/s) and a 64 x 64 window of starting pixels held against the
kernels' plain twin bit for bit.

    python -m kbmod_tpu_torch.scripts.survey_scale [--device cuda|cpu]

The port of the JAX package's scripts/survey_scale.py, with its environment:
``KB_SURVEY_T`` (100), ``KB_SURVEY_HW`` (4096), ``KB_SURVEY_C`` (1,024),
``KB_SURVEY_GRID`` (``random``: C random speeds and angles; ``default``:
whole angle rows of the reference's default 257 x 129 lattice scaled to the
12-day cadence, all 33,153 at C = 33,153) and ``KB_SURVEY_SNAP`` (row-class
snapping, ``ops.search.snap_vy_rows``). The JAX script packs a TPU word
stream with guards; the port's dispatcher reads the code pairs as a
PsiPhiArray holds them and picks K3, K4 or K5 (``last_route``). Random
codes from ``default_rng(11)``; K = 8, min_obs 10.
"""

import argparse
import os

import numpy as np
import torch


def make_grid(C, grid, rng):
    """(vxs, vys, C) of the JAX script: ``grid`` "default" takes whole angle
    rows of the 257 x 129 lattice at 1/8 of the reference's px/day (a
    12-day span), "random" C draws of speed in [1, 60) and angle in
    [-0.4, 0.4)."""
    if grid == "default":
        from kbmod_tpu_torch.scripts._common import twelve_day_lattice

        vxs, vys = twelve_day_lattice(C)
        return vxs, vys, len(vxs)
    vel = rng.uniform(1, 60, C).astype(np.float32)
    ang = rng.uniform(-0.4, 0.4, C).astype(np.float32)
    return np.cos(ang) * vel, np.sin(ang) * vel, C


def run(T=100, HW=4096, C=1024, grid="random", snap=0.0, device=None, window=64, log=print):
    """Build the codes on ``device``, search the full frame twice (the
    first call and the timed one), hold the centre window against the twin.
    Returns a dict of the numbers it printed."""
    from kbmod_tpu_torch.device import resolve_device
    from kbmod_tpu_torch.ops.search import EncodedPlanes, snap_vy_rows, trajectory_offsets
    from kbmod_tpu_torch.ops.search_encoded import search_topk_encoded
    from kbmod_tpu_torch.scripts._common import EM, check_window, device_line, read_counts, \
        reset_counts, timed

    dev = resolve_device(device)
    rng = np.random.default_rng(11)
    psi = rng.integers(0, 256, (T, HW, HW), dtype=np.uint8)
    phi = rng.integers(1, 256, (T, HW, HW), dtype=np.uint8)
    times = np.linspace(0, 12, T)
    vxs, vys, C = make_grid(C, grid, rng)
    if snap > 0:
        vys, n_classes = snap_vy_rows(vys, times, snap)
        log(f"snap {snap}px: {len(vys)} candidates -> {n_classes} vy classes")
    dxs, dys = trajectory_offsets(vxs, vys, times)
    planes, stage_s = timed(dev, lambda: EncodedPlanes.from_codes(psi, phi, EM, dev))
    del psi, phi
    log(f"stack: T={T} {HW}x{HW} u8, C={C} ({grid} grid); codes staged in {stage_s:.2f} s")
    kw = dict(x_min=0, x_max=HW, y_min=0, y_max=HW, k_results=8)
    reset_counts()
    _, first = timed(dev, lambda: search_topk_encoded(planes, dxs, dys, 10.0, 0.0, **kw))
    (lh, idx), dt = timed(dev, lambda: search_topk_encoded(planes, dxs, dys, 10.0, 0.0, **kw))
    launches, twins = read_counts()
    route = search_topk_encoded.last_route
    evals = HW * HW * C / dt
    log(f"survey scale: route {route}; first {first:.3f} s, run {dt:.3f} s, {evals:.4e} evals/s; "
        f"launches {launches}, twin calls {twins}; {device_line(dev)}")
    w = min(window, HW)
    x0 = y0 = min(HW // 2, HW - w)
    twin_s = check_window(planes, dxs, dys, 10.0, 0.0, lh, idx, (x0, x0 + w, y0, y0 + w), 8)
    filled = int((idx[:, y0:y0 + w, x0:x0 + w] >= 0).sum())
    if not bool(torch.isfinite(lh[idx >= 0]).all()):
        raise AssertionError("the search's filled slots are not all finite")
    log(f"WINDOW EXACT ({w}x{w} at ({x0}, {y0}), {filled} slots filled; twin {twin_s:.2f} s)")
    return dict(route=route, first_s=first, run_s=dt, evals_per_s=evals, launches=launches, twin_s=twin_s,
                C=C, stage_s=stage_s, filled=filled, twin_calls=twins)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    run(T=int(os.environ.get("KB_SURVEY_T", 100)), HW=int(os.environ.get("KB_SURVEY_HW", 4096)),
        C=int(os.environ.get("KB_SURVEY_C", 1024)), grid=os.environ.get("KB_SURVEY_GRID", "random"),
        snap=float(os.environ.get("KB_SURVEY_SNAP", "0") or 0), device=args.device,
        log=lambda msg: print(msg, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
