"""search_host_s: the seconds per stack that ``search_all`` spends on the
host around the top-K search, from the program's spans: the ``search``
span less, in each of its ``search.topk`` spans, the time from the first
kernel launch (a ``kernel.*`` span) to the span's end, where the host waits
for the kernel at its synchronize (all of ``search.topk`` where no kernel is
launched: the exact sigma-G search runs as PyTorch operations). What is left
is the offsets, the plans, the assembly (fetch, compaction, re-scoring
gathers, sigma-G) and the listed rows' filters and sort. Mean over the
window's stacks."""

from benchmarks.program_spans import mean_per_stack, seconds


def _host(records):
    wait = 0.0
    for topk in (r for r in records if r.name == "search.topk"):
        launches = [r.start for r in records if r.name.startswith("kernel.") and topk.start <= r.start <= topk.end]
        wait += topk.end - (min(launches) if launches else topk.start)
    return seconds(records, "search") - wait


def read(ctx):
    return mean_per_stack(ctx, _host)
