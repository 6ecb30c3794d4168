"""What the per-layer metrics of the port's own spans and counters share.

The port records spans and byte counters in memory
(``floodplanet_code_tpu_torch/utils/trace.py``); a reader reads them out
in the process that served or stepped, after the run, with whatever the
process did: the set-up's warm-up, the window, and the traced requests or
steps. A program without that tracer gives None, never an error.
"""

from __future__ import annotations


def tracer():
    """The port's tracer module, or None when the program has none."""
    try:
        from floodplanet_code_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def records() -> list | None:
    """The closed spans the ring holds, or None (no tracer, or no span)."""
    trace = tracer()
    if trace is None:
        return None
    return trace.records() or None


def roots(recs: list, name: str) -> list:
    """The root spans named ``name`` whose whole tree the ring still holds:
    once the ring is full, those that started after its oldest span ended."""
    out = [r for r in recs if r.name == name and r.parent is None]
    trace = tracer()
    if len(recs) >= trace.RING_SIZE:
        out = [r for r in out if r.start_ns > recs[0].end_ns]
    return out


def per_root_ms(root_name: str, span_name: str) -> float | None:
    """Milliseconds of the spans named ``span_name`` per root named
    ``root_name`` (summed within a root, on every thread), mean over the
    roots; None without such roots."""
    recs = records()
    if not recs:
        return None
    tops = roots(recs, root_name)
    if not tops:
        return None
    wanted = {r.id for r in tops}
    total = sum(r.end_ns - r.start_ns for r in recs if r.name == span_name and r.root in wanted)
    return total / len(tops) / 1e6


def per_root_count(root_name: str, counter: str) -> float | None:
    """Counter ``counter`` per root named ``root_name``, mean over the
    roots; None without such roots."""
    recs = records()
    if not recs:
        return None
    tops = roots(recs, root_name)
    if not tops:
        return None
    return sum((r.counts or {}).get(counter, 0) for r in tops) / len(tops)


def union(intervals) -> list:
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    out: list = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1][1] = end
        else:
            out.append([start, end])
    return out


def covered(intervals: list, by: list) -> float:
    """How much of the disjoint sorted ``intervals`` the disjoint sorted
    ``by`` covers."""
    total, j = 0.0, 0
    for start, end in intervals:
        while j < len(by) and by[j][1] <= start:
            j += 1
        k = j
        while k < len(by) and by[k][0] < end:
            total += min(end, by[k][1]) - max(start, by[k][0])
            k += 1
    return total


def idle_intervals(trace_out: dict) -> list:
    """The device-idle intervals of a reduced trace (``harness.reduce_trace``):
    from the window's first event to its last kernel's end, where no kernel
    ran; microseconds on the trace's time base."""
    kernels = sorted((s, s + d) for _, s, d in trace_out["kernels"])
    end = max(e for _, e in kernels)
    cursor, out = end - trace_out["window_us"], []
    for s, e in kernels:
        if s > cursor:
            out.append([cursor, s])
        cursor = max(cursor, e)
    return out


def idle_named_share(ctx: dict) -> float | None:
    """The share of the traced window's device-idle time during which the
    host was inside a program span, in percent; a root's own time (outside
    its children) counts as unnamed when it has children. The spans go onto
    the trace's time base by the rule of ``trace_base_ns`` (or the one
    before it, or none, whichever puts them over the kernels). None when
    there is no trace, no span, or the two do not overlap."""
    trace_out = ctx.get("trace")
    recs = records()
    if not trace_out or not trace_out.get("kernels") or not recs:
        return None
    trace = tracer()
    idle = idle_intervals(trace_out)
    total = sum(e - s for s, e in idle)
    if total <= 0:
        return None
    parents = {r.parent for r in recs}
    named = [(r.start_ns, r.end_ns) for r in recs
             if not (r.parent is None and r.id in parents)]
    lo, hi = idle[0][0], max(s + d for _, s, d in trace_out["kernels"])
    now = trace.trace_base_ns()

    def overlap(base):
        spans = union((trace.to_trace_us(s, base), trace.to_trace_us(e, base))
                      for s, e in named)
        return covered([[lo, hi]], spans), spans

    best, spans = max((overlap(b) for b in (now, now - trace.TRIMESTER_S * 10**9, 0)),
                      key=lambda o: o[0])
    if best <= 0:
        return None
    return 100.0 * covered(idle, spans) / total
