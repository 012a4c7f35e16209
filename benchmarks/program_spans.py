"""The program's own spans and counters in a traced window, stack by stack:
what the per-layer readers of ``kbmod_tpu_torch.tracing`` share.

The tracer keeps a record per span (name, id, parent, start and end on
``time.perf_counter()``, start on the Unix clock, counts) while a profiler
runs, so only the traced window leaves records. A record belongs to the
window stack whose ``stack`` span (the benchmark's, on the same clock) holds
its start. A reader returns the mean over the window's stacks, or None where
the program left no records: tracing off, or a program without the tracer.
"""

# The spans of the runner and of StackSearch that hold the others.
TOP_LEVEL = ("KBMOD", "do_core_search", "grid search", "build", "search")


def program_records():
    """The tracer's records, or [] for a program that has no tracer."""
    try:
        from kbmod_tpu_torch import tracing
    except ImportError:
        return []
    return tracing.records()


def per_stack(ctx, records=None):
    """[records of each window stack], in the order of ``ctx.records``."""
    records = program_records() if records is None else records
    out = []
    for rec in ctx.records:
        bounds = [(s, e) for n, s, e in rec.get("spans", []) if n == "stack"]
        out.append([r for r in records if any(s <= r.start <= e for s, e in bounds)])
    return out


def mean_per_stack(ctx, value):
    """The mean of ``value(records of a stack)`` over the window's stacks
    that left records, or None when none did."""
    stacks = [rs for rs in per_stack(ctx) if rs]
    return sum(value(rs) for rs in stacks) / len(stacks) if stacks else None


def seconds(records, *names):
    """Seconds of the records named ``names``."""
    return sum(r.end - r.start for r in records if r.name in names)


def counted(records, name):
    """The counter ``name`` summed over ``records``."""
    return sum(r.counts.get(name, 0) for r in records)
