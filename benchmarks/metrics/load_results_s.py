"""load_results_s: the seconds per stack of the runner's
``load_and_filter_results`` phase, from the program's span of that name:
the raw rows' near-duplicate filter, their curves, host sigma-G and the
lh/obs filters, batch by batch. Mean over the window's stacks."""

from benchmarks.program_spans import mean_per_stack, seconds


def read(ctx):
    return mean_per_stack(ctx, lambda rs: seconds(rs, "load_and_filter_results"))
