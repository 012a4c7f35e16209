"""resample_s: the seconds per WorkUnit of the reprojection's resampling,
from the program's spans ``reproject.resample``: the stencil radius, the
CCD's staging and copy to the device (``reproject.upload``), the adaptive
resample and the copy back. Mean over the window's WorkUnits; nothing
where the program opened no such span."""

from benchmarks.metrics.reproject_s import span_mean


def read(ctx):
    return span_mean(ctx, "reproject.resample")
