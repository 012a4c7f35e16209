"""Time the grouped search kernels (K2, K5 and K3) at the main path's
shapes, on random data, for one checkout of the port.

    python kbmod_tpu_torch/scripts/grouped_timing.py [--root DIR]

``--root`` names the directory that holds the ``kbmod_tpu_torch`` package
to time (default: the one this script belongs to), so two checkouts can be
compared on the same card: run it for each, in turns (A, B, B, A). The shapes are those of ``chip_smoke.py``'s main paths: T = 64 times of
16 nights of 4 visits, a 2048 x 2048 frame, the 41 x 41 KBMODV1Search grid
(1,681 candidates); K2 over the full frame at K = 8 and over a 256-row band
at K = 32, K5 (uint8) over the full frame at K = 8, K3 (uint16) over the
band at K = 8, each with min_obs 32 and the min_lh gate at 10. Prints one
line of median milliseconds (3 launches each, CUDA events). Needs a card.
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
    sources = sorted(p.stem for p in _build.SRC_DIR.glob("search_topk*.cu"))
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
    k5 = ms(lambda: ek.search_grouped(p8, dx, dy, 32.0, 10.0, plan=plan, k_results=8, **gates, **full))
    del p8
    p16 = planes(16, np.array([-6.0, 12.0 / 65534, 0.1, 4.0 / 65534], np.float32))
    k3 = ms(lambda: ek.search_encoded(p16, dx, dy, 32.0, 10.0, k_results=8, **gates, **band))
    print(f"grouped_timing {args.root}: K2 full {k2:.3f} ms, K2 band K=32 {k2b:.3f} ms, K5 full {k5:.3f} ms, "
          f"K3 u16 band {k3:.3f} ms ({torch.cuda.get_device_name(0)})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
