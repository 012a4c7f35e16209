"""A long uint8 stack (T = 256, past the reference's 200-image cap)
through the encoded dispatcher over a 1024 x 1024 frame, timed, and a
64 x 64 window of starting pixels held against the kernels' plain twin,
bit for bit.

    python -m kbmod_tpu_torch.scripts.long_t [--device cuda|cpu] [--t 256]
        [--hw 1024] [--c 256]

The port of the JAX package's scripts/long_t.py (its codes from
``default_rng(2)``, 256 random candidates over ``linspace(0, 30, T)``, K =
8, min_obs 100). The JAX script calls its TPU kernel
(``search_topk_pallas_encoded``); the port's dispatcher picks K3, K4 or K5
and names it in ``last_route``.
"""

import argparse

import numpy as np


def make_inputs(T, HW, C):
    from kbmod_tpu_torch.ops.search import trajectory_offsets

    rng = np.random.default_rng(2)
    psi = rng.integers(1, 256, (T, HW, HW), dtype=np.uint8)
    phi = rng.integers(1, 256, (T, HW, HW), dtype=np.uint8)
    times = np.linspace(0, 30, T)
    vel = rng.uniform(0.5, 30, C).astype(np.float32)
    ang = rng.uniform(-0.4, 0.4, C).astype(np.float32)
    dxs, dys = trajectory_offsets(np.cos(ang) * vel, np.sin(ang) * vel, times)
    return psi, phi, dxs, dys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--t", type=int, default=256)
    ap.add_argument("--hw", type=int, default=1024)
    ap.add_argument("--c", type=int, default=256)
    args = ap.parse_args(argv)
    from kbmod_tpu_torch.device import resolve_device
    from kbmod_tpu_torch.ops.search import EncodedPlanes
    from kbmod_tpu_torch.ops.search_encoded import search_topk_encoded
    from kbmod_tpu_torch.scripts._common import EM, check_window, device_line, read_counts, \
        reset_counts, timed

    dev = resolve_device(args.device)
    T, HW, C, K = args.t, args.hw, args.c, 8
    psi, phi, dxs, dys = make_inputs(T, HW, C)
    planes = EncodedPlanes.from_codes(psi, phi, EM, dev)
    del psi, phi
    kw = dict(x_min=0, x_max=HW, y_min=0, y_max=HW, k_results=K)
    min_obs = min(100.0, float(T))
    reset_counts()
    _, first = timed(dev, lambda: search_topk_encoded(planes, dxs, dys, min_obs, 0.0, **kw))
    (lh, idx), dt = timed(dev, lambda: search_topk_encoded(planes, dxs, dys, min_obs, 0.0, **kw))
    launches, twins = read_counts()
    print(f"T={T} {HW}x{HW} u8, C={C}: route {search_topk_encoded.last_route}; first {first:.3f} s, run {dt:.3f} s, "
          f"{HW * HW * C / dt:.4e} evals/s; launches {launches}, twin calls {twins}; {device_line(dev)}", flush=True)
    w = min(64, HW)
    x0 = min(500, HW - w)
    twin_s = check_window(planes, dxs, dys, min_obs, 0.0, lh, idx, (x0, x0 + w, x0, x0 + w), K)
    print(f"T={T} WINDOW EXACT ({w}x{w}; twin {twin_s:.2f} s)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
