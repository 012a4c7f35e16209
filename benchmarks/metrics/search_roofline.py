"""search_roofline: the grid search's least time on the card over the
device time of every operation that ran inside the benchmark's spans
around ``StackSearch.search_all``, whatever it is named, in percent.

The least time counts the algorithm's work from the inputs and shapes, not
any kernel's: two additions (psi and phi) for each in-frame, unmasked
(start pixel, candidate, time) sample, against the int8 rate for uint8
codes (which bounds any packing of them) or the float32 rate for float
planes; and the planes read once (2 bytes a pixel and time for uint8 code
pairs, 8 for float psi and phi) with the K-deep top-K maps (4-byte lh and
4-byte index) written once, against the memory's bandwidth. The larger of
the two is the least time.
"""

import numpy as np

from benchmarks import generator
from benchmarks import trace as tr
from benchmarks.peaks import peaks

PLANE_BYTES = {1: 2, -1: 8, 4: 8}  # per pixel and time, by encode_num_bytes
PEAK = {1: "int8_ops", -1: "fp32_flops", 4: "fp32_flops"}


def samples(traffic, settings):
    """In-frame (start pixel, candidate, time) samples of one stack: for each
    candidate and time, the start pixels in the bounds whose shifted pixel
    lies on the frame (the generator's stacks have no masked pixels)."""
    spec = traffic["stack"]
    H, W = int(spec["height"]), int(spec["width"])
    t = generator.exposure_times(spec["times"])
    t = t - t[0]
    vxs, vys = generator.candidate_grid(traffic["grid"])
    dx = np.floor(vxs.astype(np.float64)[:, None] * t[None] + 0.5)
    dy = np.floor(vys.astype(np.float64)[:, None] * t[None] + 0.5)
    (x0, x1), (y0, y1) = generator.start_bounds(settings, H, W)
    nx = np.clip(np.minimum(x1, W - dx) - np.maximum(x0, -dx), 0, None)
    ny = np.clip(np.minimum(y1, H - dy) - np.maximum(y0, -dy), 0, None)
    return int((nx.astype(np.int64) * ny.astype(np.int64)).sum())


def work(traffic, settings):
    """(operations, bytes, peak key) of one stack's grid search."""
    nb = int(settings.get("encode_num_bytes", -1))
    spec = traffic["stack"]
    T = len(generator.exposure_times(spec["times"]))
    H, W = int(spec["height"]), int(spec["width"])
    (x0, x1), (y0, y1) = generator.start_bounds(settings, H, W)
    k = int(settings.get("results_per_pixel", 8))
    planes = T * H * W * PLANE_BYTES[nb]
    maps = k * (x1 - x0) * (y1 - y0) * 8
    return 2 * samples(traffic, settings), planes + maps, PEAK[nb]


def least_seconds(traffic, settings, table):
    ops, nbytes, key = work(traffic, settings)
    return max(ops / table[key], nbytes / table["hbm_bytes"])


def read(ctx):
    table = peaks(ctx.device_name)
    if ctx.trace is None or table is None or int(ctx.settings.get("encode_num_bytes", -1)) not in PLANE_BYTES:
        return None
    busy, spans = tr.device_seconds_in(ctx.trace, "search")
    if busy <= 0:
        return None
    return 100.0 * least_seconds(ctx.traffic, ctx.settings, table) * spans / busy
