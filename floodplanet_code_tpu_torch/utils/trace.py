"""The port's tracer: spans and counters at the layer boundaries, kept in
memory, on the clock of torch.profiler's chrome traces.

    from floodplanet_code_tpu_torch.utils import trace

    with trace.span("serve.request") as request:   # a root: nothing is open
        with trace.span("request.dataset"):        # its child
            ...
        trace.count("h2d_bytes", tensor.nbytes)     # totalled, and the root's
    request.seconds, trace.summary(request)

- A span records its name, start and end (``time.time_ns()``), thread, id,
  the id of its parent and that of its root: the outermost span of the
  request or step that caused it. Spans nest through a stack per thread;
  work handed to another thread passes the span it serves
  (``span(name, parent=...)``, ``count(..., parent=...)``), so that the
  work of one request shares one root id wherever it runs.
- ``count(name, n)`` adds to a total and to the current root's counts,
  which the root carries (``Span.counts``) once it closes. The port counts
  ``h2d_bytes`` and ``d2h_bytes`` at the calls that move data between the
  host and the device on the request path and in the scene cache (on the
  CPU too, where the move costs nothing).
- Closed spans go to one ring of ``RING_SIZE`` records: the oldest drop out,
  so a daemon that runs for weeks holds no more. ``records()`` and
  ``counters()`` read them out, ``clear()`` empties both, ``summary(span)``
  totals what ran under one span.
- The cost: no CUDA call, no synchronize, no event; a span takes the
  clock twice, one record and a lock around its append (a few
  microseconds of host time on an H100 machine's CPU). ``set_enabled(False)`` (tests, and measuring
  that cost) leaves a span reading the clock only: its ``seconds`` stay
  right, nothing is recorded or counted.
- The clock: the stamps are unix-epoch nanoseconds, the clock torch.profiler
  stamps its host and (converted) device events with. Its chrome traces give
  each ``ts`` in microseconds less the file's ``baseTimeNanoseconds``,
  which libkineto floors to a 7 889 238 s boundary: ``to_trace_us(ns,
  base_ns)`` puts a stamp on that time base, and ``trace_base_ns()`` is
  that base by the same rule when no file is at hand. So each idle gap of a
  device-only trace can be placed inside the host span open at the time.
"""

from __future__ import annotations

import collections
import itertools
import json
import threading
import time

RING_SIZE = 65536
# libkineto's ChromeTraceBaseTime: the unix time floored to this many seconds.
TRIMESTER_S = 7889238

_time_ns = time.time_ns


class _Stack(list):
    """A thread's open spans, with the thread's id."""

    __slots__ = ("thread",)


class Span:
    """One span: a context manager, and the record it leaves in the ring."""

    __slots__ = ("name", "start_ns", "end_ns", "thread", "id", "parent", "root", "counts",
                 "_tracer", "_stack", "_seq")

    def __init__(self, tracer: Tracer, name: str, parent: Span | None):
        self._tracer = tracer
        self.name = name
        self.parent = parent
        self.id = self.root = self.end_ns = self.counts = None

    def __enter__(self) -> Span:
        tracer = self._tracer
        if tracer.enabled:
            try:
                stack = tracer._local.stack
            except AttributeError:
                stack = tracer._local.stack = _Stack()
                stack.thread = threading.get_ident()
            parent = self.parent or (stack[-1] if stack else None)
            self.id = span_id = next(tracer._ids)
            if parent is None or parent.id is None:
                self.parent = None
                self.root = span_id
                tracer._open[span_id] = {}
            else:
                self.parent = parent.id
                self.root = parent.root
            self.thread = stack.thread
            self._stack = stack
            self._seq = tracer._appended
            stack.append(self)
        else:
            self.parent = None
        self.start_ns = _time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = _time_ns()
        if self.id is not None:
            tracer, stack = self._tracer, self._stack
            if stack[-1] is self:
                stack.pop()
            else:  # closed out of order (a generator left open): drop it alone
                stack.remove(self)
            with tracer._lock:
                if self.root == self.id:
                    self.counts = tracer._open.pop(self.id, None) or {}
                tracer._ring.append(self)
                tracer._appended += 1
        return False

    @property
    def seconds(self) -> float:
        """Its duration; while it is open, the time since it started."""
        end = self.end_ns if self.end_ns is not None else _time_ns()
        return (end - self.start_ns) / 1e9


class Tracer:
    """A ring of closed spans and the counters; the module's functions use
    one of these for the whole process."""

    def __init__(self, size: int = RING_SIZE):
        self.enabled = True
        self._ring: collections.deque = collections.deque(maxlen=size)
        self._appended = 0  # spans ever appended
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._totals: dict = {}
        self._open: dict = {}  # root id -> its counts while it is open

    def span(self, name: str, parent: Span | None = None) -> Span:
        """A span named ``name``, the child of ``parent`` when given (work
        on another thread), else of the span open on this thread."""
        return Span(self, name, parent)

    def current(self) -> Span | None:
        """The innermost span open on this thread (None when none is, or
        the tracer is off)."""
        stack = getattr(self._local, "stack", None)
        return stack[-1] if stack else None

    def count(self, name: str, n: int, parent: Span | None = None) -> None:
        """Add ``n`` to counter ``name``: to its total, and to the counts
        of the root of ``parent`` or of this thread's open span."""
        if not self.enabled:
            return
        if parent is None:
            parent = self.current()
        root = parent.root if parent is not None else None
        with self._lock:
            self._totals[name] = self._totals.get(name, 0) + n
            counts = self._open.get(root)
            if counts is not None:
                counts[name] = counts.get(name, 0) + n

    def records(self) -> list[Span]:
        """The closed spans in the ring, in the order they closed."""
        with self._lock:
            return list(self._ring)

    def counters(self) -> dict:
        with self._lock:
            return dict(self._totals)

    def clear(self) -> None:
        """Empty the ring and the totals (the open roots keep their
        counts)."""
        with self._lock:
            self._ring.clear()
            self._totals.clear()

    def spans_under(self, span: Span) -> list[Span]:
        """The closed spans of ``span``'s root that ran inside it (it may
        still be open), on every thread, newest first."""
        if span.id is None:
            return []
        with self._lock:
            n = min(self._appended - span._seq, len(self._ring))
            newer = list(itertools.islice(reversed(self._ring), n))
        end = span.end_ns if span.end_ns is not None else _time_ns()
        return [rec for rec in newer if rec.root == span.root and rec is not span
                and span.start_ns <= rec.start_ns and rec.end_ns <= end]

    def summary(self, span: Span) -> dict:
        """``{"seconds": {name: total}, "counts": {name: n}}``: the seconds
        of the spans under ``span`` by name, and the counts of ``span``
        when it is a closed root."""
        seconds: dict = {}
        for rec in self.spans_under(span):
            seconds[rec.name] = seconds.get(rec.name, 0.0) + (rec.end_ns - rec.start_ns) / 1e9
        return {"seconds": seconds, "counts": dict(span.counts or {})}


def trace_base_ns(now_ns: int | None = None) -> int:
    """The ``baseTimeNanoseconds`` a chrome trace exported at ``now_ns``
    (default now) carries: the unix time floored to ``TRIMESTER_S``."""
    now_s = (_time_ns() if now_ns is None else now_ns) // 1_000_000_000
    return (now_s // TRIMESTER_S) * TRIMESTER_S * 1_000_000_000


def to_trace_us(ns: int, base_ns: int) -> float:
    """A stamp of this tracer on a chrome trace's time base: microseconds
    since ``base_ns``."""
    return (ns - base_ns) / 1e3


def add_to_chrome_trace(path: str, spans) -> int:
    """Write ``spans`` into the chrome trace at ``path`` as complete events
    (category ``program_span``, on the file's ``baseTimeNanoseconds``);
    returns how many."""
    with open(path) as handle:
        data = json.load(handle)
    base = int(data.get("baseTimeNanoseconds", 0))
    events = data.setdefault("traceEvents", [])
    spans = list(spans)
    for rec in spans:
        events.append({"ph": "X", "cat": "program_span", "name": rec.name, "pid": "program spans",
                       "tid": rec.thread, "ts": to_trace_us(rec.start_ns, base),
                       "dur": (rec.end_ns - rec.start_ns) / 1e3,
                       "args": {"id": rec.id, "parent": rec.parent, "root": rec.root,
                                **({"counts": rec.counts} if rec.counts else {})}})
    with open(path, "w") as handle:
        json.dump(data, handle)
    return len(spans)


TRACER = Tracer()
span = TRACER.span
current = TRACER.current
count = TRACER.count
records = TRACER.records
counters = TRACER.counters
clear = TRACER.clear
spans_under = TRACER.spans_under
summary = TRACER.summary


def set_enabled(on: bool) -> None:
    """Record (the default) or not; for tests and for measuring the cost."""
    TRACER.enabled = bool(on)
