"""One tracer for the port: named spans and counters, kept in memory, on the
profiler's clock.

Tracing is on exactly while a torch profiler runs in the process
(``KB_PROFILE_DIR`` around ``SearchRunner.run_search``, or a caller's own
``torch.profiler.profile``). Then each span keeps one :class:`Record` (name,
id, parent, start and end on ``time.perf_counter()``, start on
``time.time_ns()``, counts) and opens
``torch.profiler.record_function("kbmod:" + name)``, so its range sits on the
trace beside the device's kernels and copies: the profiler's events are on
the Unix clock, which ``unix_ns`` reads. The parent of a span is the
innermost span open on the same thread. Off, a span costs one check and
creates nothing, and :func:`count` does nothing.

A span never synchronises the device on its own: it is a host interval, and
the device's time comes from the device trace. A span asked for its
milliseconds (``into``, a dict) writes them whether tracing is on or off;
with ``sync`` (a device) it first waits for that device, as the stage
timings of ``StackSearch.timings`` always have.

The records stay after the profiler stops, until :func:`reset`; only the
last ``MAX_RECORDS`` are kept.
"""

import collections
import itertools
import threading
import time
from typing import NamedTuple

import torch

PREFIX = "kbmod:"
MAX_RECORDS = 1 << 16

enabled = torch._C._autograd._profiler_enabled

# time.time() - time.perf_counter(), once: a perf_counter reading on the
# Unix clock.
_UNIX_OFFSET = time.time() - time.perf_counter()
_ids = itertools.count(1)
_lock = threading.Lock()
_records = collections.deque(maxlen=MAX_RECORDS)
_totals = {}
_local = threading.local()


class Record(NamedTuple):
    """One finished span. ``parent`` is 0 at the top level; ``start`` and
    ``end`` are ``time.perf_counter()`` seconds; ``unix_ns`` is the start on
    the Unix clock (``time.time_ns()``), the profiler's."""

    name: str
    id: int
    parent: int
    start: float
    end: float
    unix_ns: int
    counts: dict


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Off:
    """The span of a block that nobody traces or times."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "traced", "into", "key", "sync", "id", "parent", "start", "end", "unix_ns", "counts",
                 "_range")

    def __init__(self, name, traced, into, key, sync):
        self.name, self.traced, self.into, self.key, self.sync = name, traced, into, key, sync
        self.counts = {}

    def __enter__(self):
        if self.traced:
            stack = _stack()
            self.parent = stack[-1].id if stack else 0
            self.id = next(_ids)
            stack.append(self)
            self._range = torch.profiler.record_function(PREFIX + self.name)
            self._range.__enter__()
            # Read just after the range starts: no Python work (a collection
            # of garbage, say) can fall between the two.
            self.unix_ns = time.time_ns()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync is not None and self.sync.type == "cuda":
            torch.cuda.synchronize(self.sync)
        self.end = time.perf_counter()
        if self.into is not None:
            self.into[self.key] = (self.end - self.start) * 1e3
        if self.traced:
            self._range.__exit__(*exc)
            stack = _stack()
            if stack and stack[-1] is self:
                stack.pop()
            elif self in stack:  # closed out of order (a phase left open by an error)
                stack.remove(self)
            record = Record(self.name, self.id, self.parent, self.start, self.end, self.unix_ns, self.counts)
            with _lock:
                _records.append(record)
        return False


def span(name, into=None, key=None, sync=None):
    """A context manager around one stage named ``name``: a record and a
    ``kbmod:<name>`` profiler range while tracing is on. With ``into`` (a
    dict) the stage's milliseconds go to ``into[key]`` at its end, tracing
    on or off, after waiting for the device ``sync`` when it is a card."""
    if enabled():
        return _Span(name, True, into, key, sync)
    if into is None:
        return _OFF
    return _Span(name, False, into, key, sync)


def count(name, n=1):
    """Add ``n`` to counter ``name`` on the innermost open span and to the
    process totals, while tracing is on."""
    if not enabled():
        return
    stack = _stack()
    if stack:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + n
    with _lock:
        _totals[name] = _totals.get(name, 0) + n


def records():
    """The kept records, oldest first (each is added when its span ends)."""
    with _lock:
        return list(_records)


def totals():
    """{counter: total} over the process since the last :func:`reset`."""
    with _lock:
        return dict(_totals)


def reset():
    """Drop every record and counter total."""
    with _lock:
        _records.clear()
        _totals.clear()


def unix_seconds(perf_seconds):
    """A ``time.perf_counter()`` reading as seconds on the Unix clock."""
    return _UNIX_OFFSET + perf_seconds


def covered_seconds(intervals):
    """Seconds covered by the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total if cur_e is None else total + cur_e - cur_s


def stages(recs):
    """{name: {"count", "seconds", "self_seconds", "counts"}} over the
    records ``recs``: a span's self seconds are its duration less the time
    its child spans cover."""
    children = collections.defaultdict(list)
    for r in recs:
        children[r.parent].append((r.start, r.end))
    out = {}
    for r in recs:
        st = out.setdefault(r.name, {"count": 0, "seconds": 0.0, "self_seconds": 0.0, "counts": {}})
        inside = [(max(s, r.start), min(e, r.end)) for s, e in children.get(r.id, ())
                  if min(e, r.end) > max(s, r.start)]
        st["count"] += 1
        st["seconds"] += r.end - r.start
        st["self_seconds"] += r.end - r.start - covered_seconds(inside)
        for k, v in r.counts.items():
            st["counts"][k] = st["counts"].get(k, 0) + v
    return out
