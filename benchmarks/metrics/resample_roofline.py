"""resample_roofline: the adaptive resample's least time on the card over
the device time of every operation (kernels, copies, sets) that ran inside
the benchmark's ``reproject`` spans around ``reproject_work_unit``, in
percent.

The least time counts the algorithm's work from the patch, the WorkUnit's
constituents and the program's counter ``reproject.taps`` (the (2R+1)^2
stencil taps of each resampled CCD, summed): ``OPS_PER_TAP`` float32
operations for every tap of every patch pixel, against the float32 rate;
and for every constituent its science and variance under the patch read
once (as many source pixels as patch pixels at the common frame's scale)
and its resampled science and variance written once, 16 bytes a patch
pixel, against the memory's bandwidth. The larger of the two is the least
time.
"""

from benchmarks import trace as tr
from benchmarks.peaks import peaks
from benchmarks.program_spans import counted, per_stack

# A tap: its offset (2), the quadratic form (8), the Gaussian's argument
# (1), the validity product (1), two planes' multiply-adds (4) and the two
# weight sums (2); the exp and the truncation test not counted.
OPS_PER_TAP = 18
BYTES_PER_PIXEL = 16  # science and variance, float32, read and written


def work(traffic, taps, images):
    """(operations, bytes) of resampling ``images`` CCDs with ``taps``
    stencil taps in all onto the patch."""
    pixels = int(traffic["stack"]["height"]) * int(traffic["stack"]["width"])
    return OPS_PER_TAP * pixels * taps, BYTES_PER_PIXEL * pixels * images


def read(ctx):
    table = peaks(ctx.device_name)
    if ctx.trace is None or table is None:
        return None
    stacks = [rs for rs in per_stack(ctx) if rs]
    taps = sum(counted(rs, "reproject.taps") for rs in stacks)
    images = sum(counted(rs, "reproject.images") for rs in stacks)
    busy, _ = tr.device_seconds_in(ctx.trace, "reproject")
    if busy <= 0 or taps <= 0:
        return None
    ops, nbytes = work(ctx.traffic, taps, images)
    return 100.0 * max(ops / table["fp32_flops"], nbytes / table["hbm_bytes"]) / busy
