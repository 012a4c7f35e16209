"""Stamp-coadd throughput: 50,000 trajectories x 20 times x 21 x 21
stamps, mean, median and sum coadds (``ops.stamps.batched_coadds``).

    python -m kbmod_tpu_torch.scripts.coadd_bench [--device cuda|cpu]
        [--rows 50000] [--hw 1024]

The port of the JAX package's scripts/coadd_bench.py (the same inputs from
``default_rng(7)``). The stamps are cut and reduced on the device; the
second call is timed on the host clock with the device synchronised.
"""

import argparse
import time

import numpy as np


def make_inputs(T, HW, R):
    rng = np.random.default_rng(7)
    sci = rng.normal(10, 2, (T, HW, HW)).astype(np.float32)
    var = rng.uniform(1, 4, (T, HW, HW)).astype(np.float32)
    times = np.linspace(0, 4, T).astype(np.float32)
    xs = rng.integers(20, HW - 20, R).astype(np.int32)
    ys = rng.integers(20, HW - 20, R).astype(np.int32)
    vxs = rng.uniform(-5, 5, R).astype(np.float32)
    vys = rng.uniform(-5, 5, R).astype(np.float32)
    return sci, var, times, xs, ys, vxs, vys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--rows", type=int, default=50000)
    ap.add_argument("--hw", type=int, default=1024)
    args = ap.parse_args(argv)
    from kbmod_tpu_torch.device import resolve_device
    from kbmod_tpu_torch.ops.stamps import batched_coadds
    from kbmod_tpu_torch.scripts._common import device_line, sync

    dev = resolve_device(args.device)
    inputs = make_inputs(20, args.hw, args.rows)
    types = ["mean", "median", "sum"]
    t0 = time.perf_counter()
    out = batched_coadds(*inputs, 10, types, device=dev)
    sync(dev)
    print(f"first call {time.perf_counter() - t0:.3f} s", flush=True)
    t0 = time.perf_counter()
    out = batched_coadds(*inputs, 10, types, device=dev)
    sync(dev)
    dt = time.perf_counter() - t0
    shapes = {k: tuple(np.shape(v)) for k, v in out.items()}
    print(f"run {dt:.3f}s  {args.rows / dt:.0f} stamps/s (3 coadds each); {shapes}; {device_line(dev)}", flush=True)
    if any(not np.isfinite(np.asarray(out[k])).all() for k in types):
        raise AssertionError("non-finite coadds")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
