"""The miss rate of the default sigma-G approximation: the search ranks a
pool of ``KB_SIGMAG_TOPK_FACTOR`` x K per pixel by unclipped likelihood and
re-ranks it by clipped likelihood, so a candidate that clipping would
promote past the pool's edge is missed; ``KB_SIGMAG_MODE=exact`` clips
every candidate.

    python -m kbmod_tpu_torch.scripts.sigmag_miss_rate [--device cuda|cpu]
        [--fracs 0,0.001,0.01,0.05] [--factors 1,2,4,8] [--hw 200]

The port of the JAX package's scripts/sigmag_miss_rate.py: fake 20 x 200 x
200 surveys with 25 moving objects and bright one-epoch outliers at each
outlier fraction; miss rate = the share of the exact mode's result rows
whose (pixel, candidate) is absent from the pool mode's, over all rows and
over the strong rows (lh >= 15), and the objects each mode recovers. A
statistic of the search's semantics, the same on every device.
"""

import argparse

import numpy as np


def _injected(rng, W, H):
    from kbmod_tpu_torch.search import Trajectory

    return Trajectory(
        x=int(rng.uniform(20, W - 20)),
        y=int(rng.uniform(20, H - 20)),
        vx=float(rng.uniform(-12, 12)),
        vy=float(rng.uniform(-12, 12)),
        flux=float(rng.uniform(120, 350)),
    )


def build_stack(outlier_frac, seed, hw=200):
    """A fake survey slice: noise, 25 moving objects and bright one-epoch
    outliers at ``outlier_frac`` of each image's pixels, on a 20 x hw x hw
    stack (the JAX script's is 200). Returns (sci, var, psfs, zeroed times,
    objects)."""
    from kbmod_tpu_torch.fake_data.fake_data_creator import FakeDataSet, create_fake_times

    rng = np.random.default_rng(seed)
    T, H, W = 20, hw, hw
    times = create_fake_times(T, 57130.0, 5, 0.01, 1)
    ds = FakeDataSet(W, H, times, noise_level=2.0, psf_val=0.8, use_seed=seed)
    objects = [_injected(rng, W, H) for _ in range(25)]
    for trj in objects:
        ds.insert_object(trj)
    stack = ds.stack_py
    sci = np.array(stack.sci)
    if outlier_frac > 0:
        n_out = int(outlier_frac * H * W)
        for t in range(T):
            yy = rng.integers(0, H, n_out)
            xx = rng.integers(0, W, n_out)
            sci[t, yy, xx] += rng.uniform(50, 400, n_out)
    return sci, np.array(stack.var), [np.asarray(p) for p in stack.psfs], np.asarray(stack.zeroed_times), objects


def run_mode(sci, var, psfs, times, mode, factor, device):
    """core_search with the in-kernel sigma-G under ``mode`` and pool
    ``factor`` on planes built with the search facade's psi/phi."""
    import torch

    from kbmod_tpu_torch.filters.sigma_g_filter import SigmaGClipping
    from kbmod_tpu_torch.ops.search import core_search
    from kbmod_tpu_torch.scripts._common import scoped_env
    from kbmod_tpu_torch.search import generate_phi, generate_psi

    with scoped_env(KB_SIGMAG_MODE=mode, KB_SIGMAG_TOPK_FACTOR=factor):
        T, H, W = sci.shape
        psi = torch.stack([torch.as_tensor(generate_psi(sci[t], var[t], psfs[t], device=device)) for t in range(T)])
        phi = torch.stack([torch.as_tensor(generate_phi(var[t], psfs[t], device=device)) for t in range(T)])
        psi, phi = psi.to(device), phi.to(device)
        valid = torch.as_tensor((np.isfinite(sci) & np.isfinite(var)).astype(np.uint8), device=device)
        psi = torch.where(torch.isnan(psi), 0.0, psi)
        phi = torch.where(torch.isnan(phi), 0.0, phi)
        n_v = 15
        vel = np.linspace(-14, 14, n_v)
        vxs = np.repeat(vel, n_v).astype(np.float32)
        vys = np.tile(vel, n_v).astype(np.float32)
        coeff = SigmaGClipping.find_sigma_g_coeff(25, 75)
        return core_search(
            psi, phi, valid, times, vxs, vys, 0, W, 0, H, 8,
            min_obs=10, min_lh=10.0, do_sigmag=True, sgl_L=0.25, sgl_H=0.75, sigmag_coeff=coeff,
        )


def result_keys(res, lh_min=-1e30):
    """Set of (pixel, candidate) identities of the kept rows above lh_min."""
    keep = res["lh"] > lh_min
    return set(
        zip(
            (res["y"][keep].astype(np.int64) << 20 | res["x"][keep].astype(np.int64)).tolist(),
            np.round(res["vx"][keep], 3).tolist(),
            np.round(res["vy"][keep], 3).tolist(),
        )
    )


def recovered(res, objects):
    """How many injected objects appear in the rows (start within 2 px,
    velocity within max(2, 20%))."""
    keep = res["lh"] > -1e30
    x, y = res["x"][keep], res["y"][keep]
    vx, vy = res["vx"][keep], res["vy"][keep]
    n = 0
    for trj in objects:
        close = (np.abs(x - trj.x) <= 2) & (np.abs(y - trj.y) <= 2)
        vok = (np.abs(vx - trj.vx) <= max(2.0, 0.2 * abs(trj.vx))) & (
            np.abs(vy - trj.vy) <= max(2.0, 0.2 * abs(trj.vy))
        )
        n += bool(np.any(close & vok))
    return n


def sweep(fracs, factors, device, hw=200, log=print):
    """The table: a row (fraction, exact rows, objects exact recovers,
    [(miss, strong miss, objects) per factor]) per outlier fraction."""
    log(f"{'outliers':>9} | {'rows(exact)':>11} | {'objs':>5} | "
        + " | ".join(f"F={f} miss/strong/objs" for f in factors))
    rows = []
    for frac in fracs:
        sci, var, psfs, times, objects = build_stack(frac, seed=42, hw=hw)
        exact = run_mode(sci, var, psfs, times, "exact", 4, device)
        ek, ek_strong = result_keys(exact), result_keys(exact, lh_min=15.0)
        rec_e = recovered(exact, objects)
        cells = []
        for f in factors:
            dflt = run_mode(sci, var, psfs, times, "overprovision", f, device)
            dk = result_keys(dflt)
            cells.append((len(ek - dk) / max(len(ek), 1), len(ek_strong - dk) / max(len(ek_strong), 1),
                          recovered(dflt, objects)))
        rows.append((frac, len(ek), rec_e, cells))
        log(f"{frac:>9} | {len(ek):>11} | {rec_e:>5} | "
            + " | ".join(f"{m:7.3%}/{ms:7.3%}/{r:2d}" for m, ms, r in cells))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--fracs", default="0,0.001,0.01,0.05", help="outlier fractions")
    ap.add_argument("--factors", default="1,2,4,8", help="KB_SIGMAG_TOPK_FACTOR values")
    ap.add_argument("--hw", type=int, default=200, help="the frame's side (a smaller one rehearses)")
    args = ap.parse_args(argv)
    from kbmod_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    sweep([float(f) for f in args.fracs.split(",")], [int(f) for f in args.factors.split(",")], dev, args.hw,
          log=lambda msg: print(msg, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
