"""Time the two gather forms of the kernels' plain twins
(``ops.search_kernel.twin_window_sums``) on one device: one indexing op a
time step over a chunk of candidates ("batched"), or one slice add a
candidate and step ("slices"). ``TWIN_BATCHED`` picks the form a device
runs; this measures both, and holds their sums equal.

    python -m kbmod_tpu_torch.scripts.twin_forms [--device cuda|cpu] [--reps N]

The shapes are (T, window rows, window columns, C, the origins' reach in
rows and columns, sum type) of the twin calls in the port's CPU tests, from
the smallest to the largest: the checkpoint tests' tiles, the search tests'
small stacks, the injection test, the script rehearsals (survey_scale's
default grid, the README's quick-start stack, the regression configuration's
trimmed grid, survey_pipeline_gate) and the regression test. Planes and
window origins are random from ``default_rng(0)``; the origins of a
candidate move monotonically over the steps, as a trajectory's do. Prints
the best of ``--reps`` walls of each form in milliseconds and their ratio.
"""

import argparse
import time

import numpy as np
import torch

# (T, SH, SW, C, reach_y, reach_x, dtype)
SHAPES = [
    (6, 16, 56, 16, 4, 6, "float32"),
    (8, 38, 44, 36, 10, 16, "float32"),
    (10, 40, 48, 49, 14, 22, "float32"),
    (10, 128, 128, 775, 57, 90, "float32"),
    (12, 160, 160, 514, 163, 772, "int32"),
    (10, 512, 512, 441, 84, 127, "float32"),
    (20, 1024, 512, 48, 806, 484, "float32"),
    (20, 1044, 532, 416, 912, 585, "float32"),
    (20, 512, 512, 512, 296, 710, "int32"),
]


def make_inputs(T, SH, SW, C, reach_y, reach_x, dtype, rng):
    """The twin's (T, rows, cols, 3) samples over the windows' reach and
    (C, T) int64 window origins within it."""
    Hr, Wr = SH + reach_y, SW + reach_x
    if dtype == "float32":
        plane = torch.as_tensor(rng.standard_normal((T, Hr, Wr, 3)).astype(np.float32))
    else:
        plane = torch.as_tensor(rng.integers(0, 255, (T, Hr, Wr, 3)).astype(np.int32))
    frac = np.arange(T) / max(1, T - 1)
    oy = np.floor(rng.uniform(0, reach_y, C)[:, None] * frac[None, :] + 0.5).astype(np.int64)
    ox = np.floor(rng.uniform(0, reach_x, C)[:, None] * frac[None, :] + 0.5).astype(np.int64)
    return plane, oy, ox


def sums(plane, oy, ox, SH, SW, dev):
    from kbmod_tpu_torch.ops.search_kernel import twin_window_sums

    T, Hr, Wr, nval = plane.shape
    return [s for _, _, s in twin_window_sums(lambda r, c: plane[:, r, c], oy, ox, Hr, Wr, SH, SW, nval,
                                              plane.dtype, dev)]


def time_form(batched, plane, oy, ox, SH, SW, dev, reps):
    """(best seconds of ``reps``, the sums) of one form."""
    from kbmod_tpu_torch.ops import search_kernel
    from kbmod_tpu_torch.scripts._common import sync

    prev = search_kernel.TWIN_BATCHED[dev.type]
    search_kernel.TWIN_BATCHED[dev.type] = batched
    try:
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            out = sums(plane, oy, ox, SH, SW, dev)
            sync(dev)
            best = min(best, time.perf_counter() - t0)
    finally:
        search_kernel.TWIN_BATCHED[dev.type] = prev
    return best, out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--shapes", type=int, default=len(SHAPES), help="time the first N shapes")
    args = ap.parse_args(argv)
    from kbmod_tpu_torch.device import resolve_device
    from kbmod_tpu_torch.ops.search_kernel import TWIN_BATCHED
    from kbmod_tpu_torch.scripts._common import device_line

    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    print(f"twin forms on {device_line(dev)}, {torch.get_num_threads()} threads; this device runs "
          f"{'batched' if TWIN_BATCHED[dev.type] else 'slices'}", flush=True)
    print("| T | SH x SW | C | reach | sums | batched ms | slices ms | batched / slices |")
    print("|---|---|---|---|---|---|---|---|")
    for T, SH, SW, C, reach_y, reach_x, dtype in SHAPES[: args.shapes]:
        plane, oy, ox = make_inputs(T, SH, SW, C, reach_y, reach_x, dtype, rng)
        plane = plane.to(dev)
        tb, ob = time_form(True, plane, oy, ox, SH, SW, dev, args.reps)
        ts, os_ = time_form(False, plane, oy, ox, SH, SW, dev, args.reps)
        if not all(torch.equal(a, b) for a, b in zip(ob, os_)):
            raise AssertionError(f"T={T} {SH}x{SW} C={C}: the two forms' sums differ")
        print(f"| {T} | {SH} x {SW} | {C} | {reach_y} x {reach_x} | {dtype} | {tb * 1e3:.1f} | {ts * 1e3:.1f} "
              f"| {tb / ts:.2f} |", flush=True)
    print("TWIN FORMS EQUAL", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
