"""The port's tracer (``floodplanet_code_tpu_torch/utils/trace.py``): spans
nest per thread under one root per request or step, counters add to their
root, the ring keeps a bounded number of spans, several threads record at
once without losing an update, and its stamps sit on the clock of
torch.profiler's chrome traces."""

import json
import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from floodplanet_code_tpu_torch.utils import trace
from floodplanet_code_tpu_torch.utils.trace import Tracer


def test_nesting_parent_and_root_ids():
    t = Tracer()
    with t.span("request") as root:
        with t.span("load") as load:
            with t.span("read") as read:
                pass
        with t.span("write") as write:
            assert t.current() is write
    assert t.current() is None
    assert (root.parent, root.root) == (None, root.id)
    assert (load.parent, load.root) == (root.id, root.id)
    assert (read.parent, read.root) == (load.id, root.id)
    assert (write.parent, write.root) == (root.id, root.id)
    # closed in order: children before their parents
    assert [r.name for r in t.records()] == ["read", "load", "write", "request"]
    assert len({r.thread for r in t.records()}) == 1
    with t.span("next") as other:
        pass
    assert other.root == other.id != root.id


def test_self_time_and_summary():
    t = Tracer()
    with t.span("request") as root:
        time.sleep(0.02)  # the root's own time
        with t.span("child"):
            time.sleep(0.03)
        with t.span("child"):
            time.sleep(0.01)
    seconds = t.summary(root)["seconds"]
    assert set(seconds) == {"child"}
    assert 0.04 <= seconds["child"] < root.seconds
    own = root.seconds - seconds["child"]  # its self time: the first sleep and the rest
    assert 0.02 <= own < root.seconds - 0.04
    # a span that is still open reads the time since it started
    with t.span("open") as open_span:
        time.sleep(0.005)
        assert open_span.seconds >= 0.005 and open_span.end_ns is None
    assert open_span.end_ns is not None


def test_counters_add_to_their_root():
    t = Tracer()
    with t.span("request") as first:
        t.count("h2d_bytes", 100)
        with t.span("copy"):
            t.count("h2d_bytes", 20)
            t.count("d2h_bytes", 7)
    with t.span("request") as second:
        t.count("h2d_bytes", 5)
    t.count("h2d_bytes", 1)  # no span open: the total only
    assert first.counts == {"h2d_bytes": 120, "d2h_bytes": 7}
    assert second.counts == {"h2d_bytes": 5}
    assert t.summary(first)["counts"] == first.counts
    assert t.counters() == {"h2d_bytes": 126, "d2h_bytes": 7}
    t.clear()
    assert t.records() == [] and t.counters() == {}


def test_work_on_another_thread_keeps_the_root():
    t = Tracer()
    with t.span("request") as root:
        with t.span("load") as load:
            def work(k):
                with t.span("read", parent=load):
                    t.count("h2d_bytes", k, parent=load)
            threads = [threading.Thread(target=work, args=(k,)) for k in (1, 2, 3)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=30)
            assert not any(th.is_alive() for th in threads)
    reads = [r for r in t.records() if r.name == "read"]
    assert len(reads) == 3 and {r.root for r in reads} == {root.id}
    assert {r.parent for r in reads} == {load.id}
    assert len({r.thread for r in reads} | {root.thread}) > 1
    assert root.counts == {"h2d_bytes": 6}
    assert t.summary(root)["seconds"].keys() == {"load", "read"}


def test_the_ring_is_bounded():
    t = Tracer(size=8)
    for k in range(20):
        with t.span(f"s{k}"):
            pass
    assert [r.name for r in t.records()] == [f"s{k}" for k in range(12, 20)]


def test_many_threads_record_at_once():
    """More threads than cores, a short switch interval: every span lands,
    each under its own thread's root, and no count is lost."""
    t = Tracer()
    n_threads, n_requests, n_children = 16, 20, 5
    roots: dict = {}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def client(k):
            mine = []
            for _ in range(n_requests):
                with t.span("request") as root:
                    for _ in range(n_children):
                        with t.span("child"):
                            t.count("bytes", 1)
                mine.append(root)
            roots[k] = mine

        threads = [threading.Thread(target=client, args=(k,)) for k in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    recs = t.records()
    assert len(recs) == n_threads * n_requests * (n_children + 1)
    assert t.counters() == {"bytes": n_threads * n_requests * n_children}
    by_id = {r.id: r for r in recs}
    for mine in roots.values():
        for root in mine:
            assert root.counts == {"bytes": n_children}
            kids = [r for r in recs if r.root == root.id and r is not root]
            assert len(kids) == n_children
            assert all(r.parent == root.id and r.thread == root.thread for r in kids)
    assert len(by_id) == len(recs)


def test_disabled_records_nothing_and_still_times():
    t = Tracer()
    t.enabled = False
    with t.span("request") as root:
        time.sleep(0.005)
        t.count("bytes", 3)
        assert t.current() is None
    assert root.seconds >= 0.005 and root.id is None
    assert t.records() == [] and t.counters() == {}
    assert t.summary(root) == {"seconds": {}, "counts": {}}
    trace.set_enabled(False)
    try:
        assert not trace.TRACER.enabled
    finally:
        trace.set_enabled(True)


def test_span_cost_enabled_and_disabled():
    """The cost of one span, reported (a host clock here: no assert on it)."""
    n = 20000
    costs = {}
    for on in (True, False):
        t = Tracer()
        t.enabled = on
        start = time.perf_counter()
        for _ in range(n):
            with t.span("s"):
                pass
        costs[on] = (time.perf_counter() - start) / n * 1e6
    print(f"span cost on this host: {costs[True]:.2f} us enabled, "
          f"{costs[False]:.2f} us disabled")
    assert all(0 < c < float("inf") for c in costs.values())


def test_trace_base_follows_the_trimester_rule():
    day = 86400 * 10**9
    now = 1_790_857_026 * 10**9 + 5 * day
    base = trace.trace_base_ns(now)
    assert base % (trace.TRIMESTER_S * 10**9) == 0 and 0 <= now - base < trace.TRIMESTER_S * 10**9
    assert trace.to_trace_us(base + 1_500, base) == 1.5


def test_spans_align_with_the_profilers_chrome_trace(tmp_path):
    """Under a CPU-activity profiler, a span and a record_function around the
    same 20 ms sleep agree within 200 us on the exported file's time base."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(3):  # the first record_function pays the profiler's set-up
            with record_function(f"sleep{k}"), trace.span(f"test.sleep{k}") as sp:
                time.sleep(0.02)
    path = str(tmp_path / "cpu_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as handle:
        data = json.load(handle)
    base = int(data["baseTimeNanoseconds"])
    assert base == trace.trace_base_ns()
    event = next(e for e in data["traceEvents"] if e.get("name") == "sleep2")
    start, end = float(event["ts"]), float(event["ts"]) + float(event["dur"])
    assert abs(trace.to_trace_us(sp.start_ns, base) - start) < 200
    assert abs(trace.to_trace_us(sp.end_ns, base) - end) < 200


def test_spans_go_into_a_chrome_trace(tmp_path):
    t = Tracer()
    with t.span("request") as root:
        with t.span("child"):
            t.count("h2d_bytes", 4)
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"baseTimeNanoseconds": trace.trace_base_ns(),
                                "traceEvents": [{"ph": "X", "name": "kernel", "ts": 1.0,
                                                 "dur": 2.0}]}))
    assert trace.add_to_chrome_trace(str(path), t.records()) == 2
    events = json.loads(path.read_text())["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "program_span"}
    assert set(spans) == {"request", "child"} and len(events) == 3
    assert spans["child"]["args"]["parent"] == root.id
    assert spans["request"]["args"]["counts"] == {"h2d_bytes": 4}
    assert spans["request"]["ts"] == pytest.approx(
        trace.to_trace_us(root.start_ns, trace.trace_base_ns()))


def test_no_cuda_call_inside_a_span(monkeypatch):
    """A span touches no CUDA state: no event, no synchronize."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA call inside a span")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    t = Tracer()
    with t.span("request"), t.span("child"):
        t.count("bytes", 1)
    assert len(t.records()) == 2
