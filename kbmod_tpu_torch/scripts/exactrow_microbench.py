"""Design micro-benchmark of K5's packed inner loop on the card (kernel K6).

    python -m kbmod_tpu_torch.scripts.exactrow_microbench [A B C] [--th 32]
        [--w4 512] [--g 8] [--t 64] [--ng 64] [--reps 5]

The port of the JAX package's scripts/exactrow_microbench.py: the same
inputs (``tbl`` from ``numpy.random.default_rng(0)`` in 0..7, ``buf`` from
``default_rng(1)``), the same modes, the same report per mode (ms, eval-steps
per second, ns per candidate-slot), timed with CUDA events after a warm-up,
plus the card's name and power limit. Mode A rolls and extracts per
candidate, B extracts once per staged word and rolls the three fields per
candidate, C rolls the row once per slot and extracts per candidate
(``csrc/exactrow_microbench.cu``). Runs on CUDA and raises without a card.
"""

import argparse

import numpy as np
import torch

from kbmod_tpu_torch.device import resolve_device
from kbmod_tpu_torch.ops.exactrow_kernel import MODES, exactrow_accumulate
from kbmod_tpu_torch.scripts._common import card_line


def make_inputs(th=32, w4=512, t=64, ng=64, device=None):
    """The JAX script's inputs: tbl (NG, 3T) int32 in 0..7 and buf
    (2 (TH + 16), W4) int32 in [0, 2^31 - 1), on ``device``."""
    tbl = np.random.default_rng(0).integers(0, 8, (ng, 3 * t), dtype=np.int32)
    buf = np.random.default_rng(1).integers(0, 2**31 - 1, (2 * (th + 16), w4), dtype=np.int32)
    return torch.as_tensor(tbl, device=device), torch.as_tensor(buf, device=device)


def time_mode(tbl, buf, mode, group=8, th=32, reps=5):
    """Milliseconds of one launch in ``mode``: the mean over ``reps``
    launches between two CUDA events, after one warm-up launch that also
    checks ``tbl`` (the timed launches skip that check, which waits for the
    card)."""
    exactrow_accumulate(tbl, buf, mode, group, th)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        exactrow_accumulate(tbl, buf, mode, group, th, check=False)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("modes", nargs="*", choices=MODES, help="modes to time (default: all)")
    ap.add_argument("--th", type=int, default=32, help="output rows TH")
    ap.add_argument("--w4", type=int, default=512, help="words per row W4 (two pixels a word)")
    ap.add_argument("--g", type=int, default=8, help="members per group G")
    ap.add_argument("--t", type=int, default=64, help="time steps T")
    ap.add_argument("--ng", type=int, default=64, help="groups NG")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    dev = resolve_device()
    print(card_line(), flush=True)
    tbl, buf = make_inputs(args.th, args.w4, args.t, args.ng, dev)
    slots = args.ng * args.t * args.g
    for mode in args.modes or MODES:
        dt = time_mode(tbl, buf, mode, args.g, args.th, args.reps) / 1e3
        evsteps = slots * args.th * args.w4 * 2  # 2 pixels per word
        print(
            f"mode {mode}: {dt * 1e3:.3f} ms  {evsteps / dt / 1e11:.3f}e11 eval-steps/s "
            f"({dt / slots * 1e9:.1f} ns/cand-slot)",
            flush=True,
        )


if __name__ == "__main__":
    main()
