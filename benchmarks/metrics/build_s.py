"""build_s: the psi/phi build's seconds per stack, the mean of the
program's own ``StackSearch.timings["psi_phi_ms"]`` (host clock around the
build, synchronised at its end) over the window's stacks."""


def read(ctx):
    ms = [r["timings"]["psi_phi_ms"] for r in ctx.records if "psi_phi_ms" in r.get("timings", {})]
    return sum(ms) / len(ms) / 1e3 if ms else None
