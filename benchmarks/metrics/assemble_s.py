"""assemble_s: the assembly's seconds per stack (compaction, the winners'
re-scoring gathers, sigma-G), the mean of the program's own
``StackSearch.timings["assemble_ms"]`` over the window's stacks."""


def read(ctx):
    ms = [r["timings"]["assemble_ms"] for r in ctx.records if "assemble_ms" in r.get("timings", {})]
    return sum(ms) / len(ms) / 1e3 if ms else None
