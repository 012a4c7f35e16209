"""reproject_s: the seconds per WorkUnit of ``reproject_work_unit``, from
the program's span ``reproject``: the EBD WCS fits, and each layer's
source coordinates, resampling and mosaic. Mean over the window's
WorkUnits; nothing where the program opened no such span."""

from benchmarks.program_spans import per_stack, seconds


def span_mean(ctx, name):
    """The mean over the window's stacks that hold a span ``name`` of its
    seconds in each, or None when none does."""
    per = [seconds(rs, name) for rs in per_stack(ctx) if any(r.name == name for r in rs)]
    return sum(per) / len(per) if per else None


def read(ctx):
    return span_mean(ctx, "reproject")
