"""coords_s: the seconds per WorkUnit that the reprojection spends on the
host computing source coordinates (float64 TAN both ways for every patch
pixel of every CCD), from the program's spans ``reproject.coords``. Mean
over the window's WorkUnits; nothing where the program opened no such
span."""

from benchmarks.metrics.reproject_s import span_mean


def read(ctx):
    return span_mean(ctx, "reproject.coords")
