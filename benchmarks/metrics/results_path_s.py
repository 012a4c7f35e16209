"""results_path_s: the seconds per stack spent outside the build and the
grid search, on the benchmark's host clock: the stack's span less its
``StackSearch`` constructor and ``search_all`` spans. That is the
SearchRunner's own work: the QA cut, the raw rows' near-duplicate filter,
curves and sigma-G, the lh and obs filters, clustering, coadds, positions
and the results file."""


def _seconds(record, name):
    return sum(e - s for n, s, e in record.get("spans", []) if n == name)


def read(ctx):
    per_stack = [_seconds(r, "stack") - _seconds(r, "build") - _seconds(r, "search") for r in ctx.records]
    return sum(per_stack) / len(per_stack) if per_stack else None
