"""reproject_uploaded_gib: the bytes the reprojection copies from the host
to the card per WorkUnit, in GiB, from the program's counter
``reproject.bytes_h2d`` (each source CCD's science and variance and its
float32 source coordinates). Mean over the window's WorkUnits; nothing
where the program keeps no such counter."""

from benchmarks.program_spans import counted, per_stack


def read(ctx):
    per = [counted(rs, "reproject.bytes_h2d") / 2**30 for rs in per_stack(ctx)
           if any("reproject.bytes_h2d" in r.counts for r in rs)]
    return sum(per) / len(per) if per else None
