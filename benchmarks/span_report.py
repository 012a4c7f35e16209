"""Where a traced window's device-idle time falls among the program's own
spans, stack by stack.

    python3 -m benchmarks.span_report --workload <name> --seed <n> --seconds <s> [--out <file>]

Runs the cell's set-up and one window under ``torch.profiler``, as a
``--trace 1`` run of ``benchmarks.run`` does, without the judgement, and
prints one JSON line: the window's stacks and ``stack_evals_per_s``; per
stack the spans the program opened and the device-idle seconds by the
innermost program span around them (``kbmod_tpu_torch.tracing`` records,
placed on the profiler's clock by their Unix start); the share of idle
seconds inside a span below the top level (``program_spans.TOP_LEVEL``);
each span's seconds and self seconds per stack; and how far each record's
start lies from its ``kbmod:`` range's on the profiler's timeline. Needs a
CUDA card; :func:`report` takes a window run elsewhere (the tests run a tiny
cell on the CPU).
"""

import argparse
import json
import sys

from benchmarks import program_spans
from benchmarks import run as bench_run
from benchmarks import trace as tr

PREFIX = "kbmod:"
OUTSIDE = "(no program span)"


def on_profiler_clock(records):
    """(name, start, end) of each record in seconds on the Unix clock."""
    return [(r.name, r.unix_ns / 1e9, r.unix_ns / 1e9 + (r.end - r.start)) for r in records]


def idle_gaps(device, lo, hi):
    """The (start, end) intervals in [lo, hi] in which no device event ran."""
    busy = sorted((max(s, lo), min(e, hi)) for _, s, e in device if min(e, hi) > max(s, lo))
    gaps, cur = [], lo
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        gaps.append((cur, hi))
    return gaps


def idle_by_span(gaps, spans):
    """{innermost span name: idle seconds}: each gap cut at the boundaries of
    the ``spans`` (name, start, end) inside it, each piece given to the
    shortest span around it, or to OUTSIDE."""
    out = {}
    for g0, g1 in gaps:
        around = [sp for sp in spans if sp[1] < g1 and sp[2] > g0]
        cuts = sorted({g0, g1} | {t for _, s, e in around for t in (s, e) if g0 < t < g1})
        for a, b in zip(cuts, cuts[1:]):
            mid = (a + b) / 2
            inner = [(e - s, n) for n, s, e in around if s <= mid <= e]
            name = min(inner)[1] if inner else OUTSIDE
            out[name] = out.get(name, 0.0) + (b - a)
    return out


def range_offsets(events, records):
    """How far each record's Unix start lies from the start of the nearest
    host-side ``kbmod:<name>`` range of the same name: {"worst_s",
    "over_1ms", "matched", "signed_s": [least, median, most] of range start
    less record start, "worst_name"}."""
    starts = {}
    for ev in events:
        if ev.name().startswith(PREFIX) and not str(ev.device_type()).endswith("CUDA"):
            starts.setdefault(ev.name()[len(PREFIX):], []).append(ev.start_ns())
    signed = sorted(((min(starts[r.name], key=lambda c: abs(c - r.unix_ns)) - r.unix_ns) / 1e9, r.name)
                    for r in records if r.name in starts)
    if not signed:
        return {"worst_s": None, "over_1ms": 0, "matched": 0, "signed_s": None, "worst_name": None}
    worst = max(signed, key=lambda o: abs(o[0]))
    return {"worst_s": abs(worst[0]), "over_1ms": sum(abs(o) > 1e-3 for o, _ in signed), "matched": len(signed),
            "signed_s": [signed[0][0], signed[len(signed) // 2][0], signed[-1][0]], "worst_name": worst[1]}


def _below_top(idle):
    """The share of idle seconds inside a program span below the top level."""
    total = sum(idle.values())
    below = sum(v for k, v in idle.items() if k not in program_spans.TOP_LEVEL and k != OUTSIDE)
    return below / total if total else None


def report(loop, trace, events, records, window_s):
    """The report's dictionary (see the module's docstring)."""
    from kbmod_tpu_torch import tracing

    lo, hi = trace.window()
    gaps = idle_gaps(trace.device, lo, hi)
    inside = [r for r in records if lo <= r.unix_ns / 1e9 <= hi]
    idle = idle_by_span(gaps, on_profiler_clock(inside))
    stacks = []
    for rec, rs in zip(loop.records, program_spans.per_stack(loop, inside)):
        (b0, b1), = [(tracing.unix_seconds(s), tracing.unix_seconds(e)) for n, s, e in rec["spans"] if n == "stack"]
        here = [(max(a, b0), min(b, b1)) for a, b in gaps if min(b, b1) > max(a, b0)]
        by_span = idle_by_span(here, on_profiler_clock(rs))
        stacks.append({"spans": len(rs), "seconds": b1 - b0, "idle_s": sum(by_span.values()),
                       "idle_below_top_share": _below_top(by_span),
                       "idle_by_span": dict(sorted(by_span.items(), key=lambda kv: -kv[1])),
                       "stages": tracing.stages(rs)})
    return {"stacks": len(loop.records), "window_s": window_s,
            "stack_evals_per_s": loop.evals * len(loop.records) / window_s,
            "idle_s": sum(idle.values()), "window_trace_s": hi - lo,
            "idle_below_top_share": _below_top(idle),
            "idle_by_span": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
            "records": len(inside), "range_offsets": range_offsets(events, inside), "per_stack": stacks}


def main(argv=None):
    ap = argparse.ArgumentParser(description="Idle device time by program span in one traced window.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", help="also write the report to this file")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from kbmod_tpu_torch import tracing

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    _, cell, config, traffic = bench_run.load_cell(args.workload)
    loop = bench_run.loop_class(traffic)(cell, config, traffic, args.seed, "cuda", traced=True)
    loop.setup()
    tracing.reset()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    window_s, _ = loop.window(args.seconds)
    prof.stop()
    events = list(prof.profiler.kineto_results.events())
    out = report(loop, tr.collect(prof), events, tracing.records(), window_s)
    loop.release()
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
