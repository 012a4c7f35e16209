"""Time the search kernels (K2, K5, K3 and K4) at the main path's shapes,
on random data, and K6's three modes at NG = 64 and 3,015, for one
checkout of the port.

    python kbmod_tpu_torch/scripts/grouped_timing.py [--root DIR]

``--root`` names the directory that holds the ``kbmod_tpu_torch`` package
to time (default: the one this script belongs to), so two checkouts can be
compared on the same card: run it for each, in turns (A, B, B, A). The shapes are those of ``chip_smoke.py``'s main paths: T = 64 times of
16 nights of 4 visits, a 2048 x 2048 frame, the 41 x 41 KBMODV1Search grid
(1,681 candidates); K2 over the full frame at K = 8 and over a 256-row band
at K = 32, K5 (uint8) over the full frame at K = 8, K3 (uint16) over the
band at K = 8, K4 (uint8) over the band and the main path's sparse list
(every 26th candidate and the object's, 66) at K = 8 and K = 32, each with
min_obs 32 and the min_lh gate at 10; K6 in modes A, B and C at the JAX
script's sizes with NG = 64 and 3,015 (midscale's group count); a kernel the
checkout lacks is skipped with a note. K5 also at the band cell's shapes
(``survey_u8.band256``: 100 x 256 x 4096 random uint8 codes over 1.35 days,
the 257 x 129 EclipticCenteredSearch grid, K = 8, min_obs 10, the min_lh
gate at 10), on the main frame's sigma-G band at K = 32 and through the
dispatcher at the JAX package's midscale shapes (T = 64, 2048 x 2048, the
default survey grid, K = 8), each with the kernel alone by torch.profiler.
Prints one line of median milliseconds (3 launches each, 5 for K6, CUDA
events).
Needs a card.
Run it as a file, not with -m, so that the package is imported from
``--root``.
"""

import argparse
import sys
import time
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="directory holding the kbmod_tpu_torch package to time")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("grouped_timing: no CUDA device available", file=sys.stderr)
        return 1
    import kbmod_tpu_torch

    if Path(kbmod_tpu_torch.__file__).resolve().parents[1] != Path(args.root).resolve():
        print(f"grouped_timing: kbmod_tpu_torch came from {kbmod_tpu_torch.__file__}, not {args.root}", file=sys.stderr)
        return 1
    from kbmod_tpu_torch.fake_data.fake_data_creator import create_fake_times
    from kbmod_tpu_torch.ops import _build
    from kbmod_tpu_torch.ops import search_encoded_kernel as ek
    from kbmod_tpu_torch.ops.psi_phi import code_pair_views, interleave_code_pairs
    from kbmod_tpu_torch.ops.search import EncodedPlanes, trajectory_offsets
    from kbmod_tpu_torch.ops.search_kernel import search_topk
    from kbmod_tpu_torch.ops.search_plan import grouped_plan
    from kbmod_tpu_torch.trajectory_generator import KBMODV1Search

    t0 = time.perf_counter()
    sources = sorted(p.stem for p in _build.SRC_DIR.glob("*.cu") if p.stem != "psi_phi_conv")
    _build.build(sources)
    print(f"grouped_timing {args.root}: built {sources} in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    T, H, W = 64, 2048, 2048
    times = np.asarray(create_fake_times(T, t0=57130.2, obs_per_day=4, intra_night_gap=0.01, inter_night_gap=1))
    cands = list(KBMODV1Search(41, 5.0, 45.0, 41, -0.5, 0.5))
    vxs = np.array([c.vx for c in cands], np.float32)
    vys = np.array([c.vy for c in cands], np.float32)
    dxs, dys = trajectory_offsets(vxs, vys, times - times[0])
    dx, dy = torch.as_tensor(dxs, device=dev), torch.as_tensor(dys, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            out.append(a.elapsed_time(b))
        return float(np.median(out))

    full = dict(x_min=0, x_max=W, y_min=0, y_max=H)
    band = dict(x_min=0, x_max=W, y_min=896, y_max=1152)
    gates = dict(gate_min_lh=True)
    valid = (torch.rand((T, H, W), device=dev, generator=gen) > 0.01).to(torch.uint8)
    psi = torch.randn((T, H, W), device=dev, generator=gen) * valid
    phi = (torch.rand((T, H, W), device=dev, generator=gen) + 0.5) * valid
    k2 = ms(lambda: search_topk(psi, phi, valid, dx, dy, 32.0, 10.0, k_results=8, **gates, **full))
    k2b = ms(lambda: search_topk(psi, phi, valid, dx, dy, 32.0, 10.0, k_results=32, **gates, **band))
    del psi, phi, valid

    def planes(bits, em):
        if bits == 8:
            codes = [torch.randint(0, 256, (T, H, W), device=dev, generator=gen, dtype=torch.uint8) for _ in range(2)]
        else:
            codes = [torch.randint(-32768, 32768, (T, H, W), device=dev, generator=gen, dtype=torch.int16)
                     .view(torch.uint16) for _ in range(2)]
        pairs = interleave_code_pairs(*codes)
        return EncodedPlanes(*code_pair_views(pairs, W), em, pairs)

    p8 = planes(8, np.array([-6.0, 12.0 / 254, 0.1, 4.0 / 254], np.float32))
    plan = grouped_plan(dys)[0]
    k5_run = lambda: ek.search_grouped(p8, dx, dy, 32.0, 10.0, plan=plan, k_results=8, **gates, **full)  # noqa: E731
    k5 = ms(k5_run)
    k5_alone = kernel_ms(k5_run, "grouped_kernel")
    k5b_run = lambda: ek.search_grouped(p8, dx, dy, 32.0, 10.0, plan=plan, k_results=32, **gates, **band)  # noqa: E731
    k5b = ms(k5b_run)
    k5b_alone = kernel_ms(k5b_run, "grouped_kernel")
    del p8
    p16 = planes(16, np.array([-6.0, 12.0 / 65534, 0.1, 4.0 / 65534], np.float32))
    k3 = ms(lambda: ek.search_encoded(p16, dx, dy, 32.0, 10.0, k_results=8, **gates, **band))
    del p16
    line = (f"K2 full {k2:.3f} ms, K2 band K=32 {k2b:.3f} ms, K5 full {k5:.3f} ms (kernel alone {k5_alone}), "
            f"K5 band K=32 {k5b:.3f} ms (kernel alone {k5b_alone}), " + time_k5_cells(ek, ms, dev)
            + f", K3 u16 band {k3:.3f} ms, "
            + time_k4(ek, planes(8, np.array([-6.0, 12.0 / 254, 0.1, 4.0 / 254], np.float32)), dxs, dys, band, ms, dev)
            + ", " + time_k6(ms, dev))
    print(f"grouped_timing {args.root}: {line} ({torch.cuda.get_device_name(0)})", flush=True)
    return 0


def time_k5_cells(ek, ms, dev):
    """K5 at the band cell's shapes, and through the dispatcher at the
    midscale shapes."""
    import numpy as np
    import torch

    from kbmod_tpu_torch.ops.psi_phi import code_pair_views, interleave_code_pairs
    from kbmod_tpu_torch.ops.search import EncodedPlanes, trajectory_offsets
    from kbmod_tpu_torch.ops.search_encoded import search_topk_encoded
    from kbmod_tpu_torch.ops.search_plan import grouped_plan
    from kbmod_tpu_torch.trajectory_generator import EclipticCenteredSearch

    em = np.array([-6.0, 12.0 / 254, 0.1, 4.0 / 254], np.float32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    out = []
    for tag, (T, H, W), times, cands in (
        ("band cell", (100, 256, 4096), np.linspace(0.0, 1.35, 100),
         EclipticCenteredSearch(velocities=[92.0, 526.0, 257], angles=[-np.pi / 15, np.pi / 15, 129],
                                angle_units="radian", given_ecliptic=0.0)),
        ("midscale", (64, 2048, 2048), np.linspace(0.0, 4.0, 64), None),
    ):
        codes = [torch.randint(0, 256, (T, H, W), device=dev, generator=gen, dtype=torch.uint8) for _ in range(2)]
        pairs = interleave_code_pairs(*codes)
        del codes
        p8 = EncodedPlanes(*code_pair_views(pairs, W), em, pairs)
        if cands is None:
            n_vel, n_ang = 257, 129
            vel = np.linspace(92.0, 526.0, n_vel) / 86.0
            ang = np.linspace(-np.pi / 15, np.pi / 15, n_ang)
            vv, aa = np.meshgrid(vel, ang)
            vxs, vys = (np.cos(aa) * vv).ravel().astype(np.float32), (np.sin(aa) * vv).ravel().astype(np.float32)
        else:
            cands = list(cands)
            vxs = np.array([c.vx for c in cands], np.float32)
            vys = np.array([c.vy for c in cands], np.float32)
        dxs, dys = trajectory_offsets(vxs, vys, times)
        kw = dict(x_min=0, x_max=W, y_min=0, y_max=H, k_results=8)
        if cands is None:
            run = lambda: search_topk_encoded(p8, dxs, dys, 10.0, 0.0, **kw)  # noqa: E731
        else:
            dx, dy = torch.as_tensor(dxs, device=dev), torch.as_tensor(dys, device=dev)
            plan = grouped_plan(dys)[0]
            run = lambda: ek.search_grouped(p8, dx, dy, 10.0, 10.0, plan=plan, gate_min_lh=True, **kw)  # noqa: E731
        out.append(f"K5 {tag} {ms(run):.3f} ms (kernel alone {kernel_ms(run, 'grouped_kernel')})")
        del p8, pairs
        torch.cuda.empty_cache()
    return ", ".join(out)


def time_k4(ek, p8, dxs, dys, band, ms, dev):
    """K4 on the band over the main path's sparse candidates (every 26th of
    the grid and the object's, 25 x 41 + 20), at K = 8 and 32."""
    import torch

    sel = list(range(0, len(dxs), 26)) + [25 * 41 + 20]
    dx, dy = (torch.as_tensor(a[sel], device=dev) for a in (dxs, dys))
    out = []
    for K in (8, 32):
        run = lambda: ek.search_paired(p8, dx, dy, 32.0, 10.0, k_results=K, gate_min_lh=True, **band)  # noqa: E731
        out.append(f"K4 sparse band ({len(sel)} candidates) K={K} {ms(run):.3f} ms "
                   f"(kernel alone {kernel_ms(run, 'paired_kernel')})")
    return ", ".join(out)


def kernel_ms(fn, name):
    """Device milliseconds of the kernels whose name holds ``name`` in one
    call of ``fn``, from torch.profiler's trace, or "not measured"."""
    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages() if name in e.key)
    return f"{us / 1e3:.3f} ms" if us > 0 else "not measured"


def time_k6(ms, dev):
    """K6's three modes at the JAX script's sizes with NG = 64 (its default)
    and 3,015 groups."""
    try:
        from kbmod_tpu_torch.ops.exactrow_kernel import MODES, exactrow_accumulate
        from kbmod_tpu_torch.scripts.exactrow_microbench import make_inputs
    except ImportError as e:
        return f"K6 skipped ({e})"
    out = []
    for ng in (64, 3015):
        tbl, buf = make_inputs(ng=ng, device=dev)
        exactrow_accumulate(tbl, buf, "A", 8, 32)  # checks the table once
        out += [f"K6 mode {m} NG={ng} "
                f"{ms(lambda: exactrow_accumulate(tbl, buf, m, 8, 32, check=False), reps=5):.3f} ms" for m in MODES]
    return ", ".join(out)


if __name__ == "__main__":
    sys.exit(main())
