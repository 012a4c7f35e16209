"""A 64 x 2048 x 2048 uint8 search through the encoded dispatcher, timed,
then a 128 x 128 window of starting pixels held against the kernels' plain
twin bit for bit (a pixel's top-K depends on its own path only, so a
window is a sound check at any frame).

    python -m kbmod_tpu_torch.scripts.scale_gate [--device cuda|cpu]
        [--t 64] [--hw 2048] [--c 4096]

The port of the JAX package's scripts/scale_gate.py: the same random codes
(``default_rng(3)``), 4,096 random candidates over ``linspace(0, 8, T)``,
K = 8, min_obs 10. The JAX script calls its TPU kernel
(``search_topk_pallas_encoded``); the port calls its dispatcher
(``ops.search_encoded.search_topk_encoded``), which picks K3, K4 or K5 and
says which in ``last_route``. Smaller sizes rehearse it on the host.
"""

import argparse

import numpy as np
import torch


def make_inputs(T, H, W, C):
    """The JAX script's codes and candidates: (psi, phi, dxs, dys)."""
    from kbmod_tpu_torch.ops.search import trajectory_offsets

    rng = np.random.default_rng(3)
    psi = rng.integers(0, 256, (T, H, W), dtype=np.uint8)
    phi = rng.integers(1, 256, (T, H, W), dtype=np.uint8)
    times = np.linspace(0, 8, T)
    vel = rng.uniform(2, 100, C).astype(np.float32)
    ang = rng.uniform(-0.4, 0.4, C).astype(np.float32)
    dxs, dys = trajectory_offsets(np.cos(ang) * vel, np.sin(ang) * vel, times)
    return psi, phi, dxs, dys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--t", type=int, default=64)
    ap.add_argument("--hw", type=int, default=2048)
    ap.add_argument("--c", type=int, default=4096)
    args = ap.parse_args(argv)
    from kbmod_tpu_torch.device import resolve_device
    from kbmod_tpu_torch.ops.search import EncodedPlanes
    from kbmod_tpu_torch.ops.search_encoded import search_topk_encoded
    from kbmod_tpu_torch.scripts._common import EM, check_window, device_line, read_counts, \
        reset_counts, timed

    dev = resolve_device(args.device)
    T, H, W, C, K = args.t, args.hw, args.hw, args.c, 8
    psi, phi, dxs, dys = make_inputs(T, H, W, C)
    planes = EncodedPlanes.from_codes(psi, phi, EM, dev)
    del psi, phi
    kw = dict(x_min=0, x_max=W, y_min=0, y_max=H, k_results=K)
    reset_counts()
    _, first = timed(dev, lambda: search_topk_encoded(planes, dxs, dys, 10.0, 0.0, **kw))
    (lh, idx), dt = timed(dev, lambda: search_topk_encoded(planes, dxs, dys, 10.0, 0.0, **kw))
    launches, twins = read_counts()
    print(f"scale gate: T={T} {H}x{W} u8, C={C}, route {search_topk_encoded.last_route}; first {first:.3f} s, "
          f"run {dt:.3f} s, {H * W * C / dt:.4e} evals/s; launches {launches}, twin calls {twins}; "
          f"{device_line(dev)}", flush=True)
    w = min(128, H, W)
    x0 = y0 = min(512, H - w)
    twin_s = check_window(planes, dxs, dys, 10.0, 0.0, lh, idx, (x0, x0 + w, y0, y0 + w), K)
    filled = int((idx[:, y0:y0 + w, x0:x0 + w] >= 0).sum())
    if filled == 0 or not bool(torch.isfinite(lh[idx >= 0]).all()):
        raise AssertionError("the window holds no finite results")
    print(f"WINDOW EXACT ({w}x{w} pixels, {filled} slots filled; twin {twin_s:.2f} s)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
