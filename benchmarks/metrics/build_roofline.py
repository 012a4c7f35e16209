"""build_roofline: the psi/phi build's least time on the card over the
device time of every operation (kernels, the sci/var uploads, sets) that
ran inside the benchmark's spans around the ``StackSearch`` constructor,
in percent.

The least time counts the algorithm's work: k^2 multiply-adds (2
operations) per output pixel for psi and for phi, k the exposure's PSF
width, against the float32 rate; and sci and var read once (8 bytes a
pixel) with psi and phi written once (8 bytes a pixel as float, 2 as uint8
codes), against the memory's bandwidth. The larger of the two is the least
time.
"""

from benchmarks import generator
from benchmarks import trace as tr
from benchmarks.peaks import peaks

OUT_BYTES = {1: 2, -1: 8, 4: 8}  # psi and phi per pixel, by encode_num_bytes


def work(traffic, settings):
    """(operations, bytes) of one stack's build."""
    spec = traffic["stack"]
    T = len(generator.exposure_times(spec["times"]))
    hw = int(spec["height"]) * int(spec["width"])
    sigmas = spec["psf_sigmas"]
    taps = sum(generator.gaussian_psf(float(sigmas[t % len(sigmas)])).size for t in range(T))
    out = OUT_BYTES[int(settings.get("encode_num_bytes", -1))]
    return 2 * 2 * taps * hw, T * hw * (8 + out)


def read(ctx):
    table = peaks(ctx.device_name)
    if ctx.trace is None or table is None or int(ctx.settings.get("encode_num_bytes", -1)) not in OUT_BYTES:
        return None
    busy, spans = tr.device_seconds_in(ctx.trace, "build")
    if busy <= 0:
        return None
    ops, nbytes = work(ctx.traffic, ctx.settings)
    least = max(ops / table["fp32_flops"], nbytes / table["hbm_bytes"])
    return 100.0 * least * spans / busy
