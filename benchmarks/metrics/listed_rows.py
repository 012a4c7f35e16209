"""listed_rows: the rows the core search returns per stack, from the
program's counter ``rows.listed`` (before ``search_all``'s lh and obs
filters, which ``rows.searched`` counts after). Mean over the window's
stacks."""

from benchmarks.program_spans import counted, mean_per_stack


def read(ctx):
    return mean_per_stack(ctx, lambda rs: counted(rs, "rows.listed"))
