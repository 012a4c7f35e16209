"""The traced run's view of the device: torch.profiler's events kept in
memory (no trace file), the benchmark's own spans among them, and the
reductions the per-layer readers share (busy time, device time inside a
span, the breakdown of device operations and idle gaps).

Spans are ``torch.profiler.record_function`` ranges named ``bench:<name>``
that the benchmark opens around the calls it makes into the program; device
events are every operation the profiler saw on the card (kernels, copies,
sets). All times are seconds on the profiler's clock.
"""

from dataclasses import dataclass, field

SPAN_PREFIX = "bench:"


@dataclass
class DeviceTrace:
    """What one traced window left: device events and spans, as (name,
    start, end) in seconds."""

    device: list = field(default_factory=list)
    spans: list = field(default_factory=list)

    def spans_named(self, name):
        return [(s, e) for n, s, e in self.spans if n == name]

    def window(self):
        (w,) = self.spans_named("window")
        return w


def collect(prof):
    """A DeviceTrace from a stopped ``torch.profiler.profile``, read from
    the profiler's raw events (``kineto_results``)."""
    out = DeviceTrace()
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns() / 1e9
        end = start + ev.duration_ns() / 1e9
        name = ev.name()
        on_card = str(ev.device_type()).endswith("CUDA")
        if _annotation(ev):
            # A record_function range, which the profiler also draws on the
            # device's timeline: a span, not device work.
            if name.startswith(SPAN_PREFIX) and not on_card:
                out.spans.append((name[len(SPAN_PREFIX):], start, end))
        elif on_card:
            out.device.append((name, start, end))
    return out


def _annotation(ev):
    """Whether a raw profiler event is a record_function range (on the host
    or drawn on the device), not an operation."""
    flag = getattr(ev, "is_user_annotation", None)
    if callable(flag) and flag():
        return True
    kind = getattr(ev, "activity_type", None)
    return "annotation" in str(kind() if callable(kind) else "") or ev.name().startswith(SPAN_PREFIX)


def union_seconds(intervals, lo=None, hi=None):
    """Seconds covered by the union of (start, end) intervals, each clipped
    to [lo, hi] when given."""
    clipped = []
    for s, e in intervals:
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e > s:
            clipped.append((s, e))
    clipped.sort()
    total, cur_s, cur_e = 0.0, None, None
    for s, e in clipped:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_seconds_in(trace, span_name):
    """(device seconds inside every ``span_name`` span, number of spans)."""
    spans = trace.spans_named(span_name)
    busy = [(s, e) for _, s, e in trace.device]
    return sum(union_seconds(busy, lo, hi) for lo, hi in spans), len(spans)


def busy_seconds(trace):
    lo, hi = trace.window()
    return union_seconds([(s, e) for _, s, e in trace.device], lo, hi)


def breakdown(trace, top=10):
    """{"device_ops": [[name, seconds]], "idle_gaps": [[label, seconds]]}:
    the device operations that took most time in the window, summed by
    name, and the longest gaps in which the device ran nothing, each
    labelled by the innermost benchmark span around its midpoint."""
    lo, hi = trace.window()
    by_name = {}
    for name, s, e in trace.device:
        d = min(e, hi) - max(s, lo)
        if d > 0:
            by_name[name] = by_name.get(name, 0.0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = sorted((max(s, lo), min(e, hi)) for _, s, e in trace.device if min(e, hi) > max(s, lo))
    gaps, cur = [], lo
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        gaps.append((cur, hi))
    inner = [sp for sp in trace.spans if sp[0] != "window"]

    def label(mid):
        around = [(e - s, n) for n, s, e in inner if s <= mid <= e]
        return min(around)[1] if around else "between stacks"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, d] for n, d in ops],
            "idle_gaps": [[label((s + e) / 2), e - s] for s, e in longest]}
