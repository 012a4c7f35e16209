"""Throughput of the psi/phi build (kernel K1): a 50 x 2048 x 2048 float32
stack with a 1.4-sigma Gaussian PSF, in GB/s of input and output and in
Gpixel/s.

    python -m kbmod_tpu_torch.scripts.psi_phi_bench [--device cuda|cpu]
        [--t 50] [--hw 2048]

The port of the JAX package's scripts/psi_phi_bench.py (sci from normal(10,
2), var from uniform(1, 4), ``default_rng(1)``). Each run is timed by CUDA
events on the card (the host clock on the CPU, where no device rate is
taken). The first call builds K1's tap table.
"""

import argparse
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--t", type=int, default=50)
    ap.add_argument("--hw", type=int, default=2048)
    args = ap.parse_args(argv)
    from kbmod_tpu_torch.core.psf import PSF
    from kbmod_tpu_torch.device import resolve_device
    from kbmod_tpu_torch.ops.psi_phi import _psi_phi_from_sci_var
    from kbmod_tpu_torch.scripts._common import device_line, sync

    dev = resolve_device(args.device)
    T, H, W = args.t, args.hw, args.hw
    rng = np.random.default_rng(1)
    sci = torch.as_tensor(rng.normal(10, 2, (T, H, W)).astype(np.float32), device=dev)
    var = torch.as_tensor(rng.uniform(1, 4, (T, H, W)).astype(np.float32), device=dev)
    psf = torch.as_tensor(PSF.make_gaussian_kernel(1.4), dtype=torch.float32)
    print(f"psf {tuple(psf.shape)}; {device_line(dev)}", flush=True)
    t0 = time.perf_counter()
    _psi_phi_from_sci_var(sci, var, psf)
    sync(dev)
    print(f"first call {time.perf_counter() - t0:.3f} s", flush=True)
    io_bytes = T * H * W * 4 * 4  # sci, var in; psi, phi out
    for _ in range(3):
        if dev.type == "cuda":
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            _psi_phi_from_sci_var(sci, var, psf)
            b.record()
            torch.cuda.synchronize(dev)
            dt = a.elapsed_time(b) / 1e3
        else:
            t0 = time.perf_counter()
            _psi_phi_from_sci_var(sci, var, psf)
            dt = time.perf_counter() - t0
        print(f"run {dt:.4f}s  io {io_bytes / dt / 1e9:.1f} GB/s  {T * H * W / dt / 1e9:.2f} Gpix/s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
