"""The readers of the port's own spans and counters (``program_trace`` and
``metrics/*``) on synthetic records and kernels; their silence on a program
without a tracer; and, on a card, the tracer's stamps against a device-only
profiler trace."""

import sys
import time
from types import SimpleNamespace

import pytest

from portbench import harness, program_trace
from floodplanet_code_tpu_torch.utils import trace

MS = 1_000_000  # ns


def _rec(name, start_ms, end_ms, id_, parent=None, root=None, counts=None, base=0):
    return SimpleNamespace(name=name, start_ns=base + int(start_ms * MS),
                           end_ns=base + int(end_ms * MS), id=id_, parent=parent,
                           root=root if root is not None else id_, counts=counts, thread=1)


def _requests():
    """Two requests: 100 ms and 60 ms, their children, their bytes."""
    return [
        _rec("scene_cache.read", 1, 9, 3, parent=2, root=1),
        _rec("scene_cache.load", 0, 10, 2, parent=1, root=1),
        _rec("scene_cache.copy", 10, 30, 4, parent=1, root=1),
        _rec("stitch.add", 40, 50, 5, parent=1, root=1),
        _rec("stitch.add", 60, 70, 6, parent=1, root=1),
        _rec("mask.write", 80, 95, 7, parent=1, root=1),
        _rec("serve.request", 0, 100, 1, counts={"h2d_bytes": 3e6, "d2h_bytes": 1e6}),
        _rec("scene_cache.load", 200, 220, 9, parent=8, root=8),
        _rec("stitch.fetch", 220, 250, 10, parent=8, root=8),
        _rec("serve.request", 200, 260, 8, counts={"h2d_bytes": 1e6}),
    ]


@pytest.fixture
def records(monkeypatch):
    def use(recs):
        monkeypatch.setattr(program_trace, "records", lambda: recs)
    return use


def test_per_request_readers(records):
    records(_requests())
    ctx = {}
    assert harness.reader("cache_load_ms.serve")(ctx) == pytest.approx((10 + 20) / 2)
    assert harness.reader("cache_copy_ms.serve")(ctx) == pytest.approx(20 / 2)
    assert harness.reader("stitch_ms.serve")(ctx) == pytest.approx(20 / 2)
    assert harness.reader("scene_fetch_ms.serve")(ctx) == pytest.approx(30 / 2)
    assert harness.reader("mask_write_ms.serve")(ctx) == pytest.approx(15 / 2)
    assert harness.reader("h2d_mb.serve")(ctx) == pytest.approx(2.0)
    assert harness.reader("d2h_mb.serve")(ctx) == pytest.approx(0.5)
    # own time: 100 - (10 + 20 + 10 + 10 + 15) and 60 - (20 + 30)
    assert harness.reader("request_self_ms.serve")(ctx) == pytest.approx((35 + 10) / 2)


def test_step_host_reader(records):
    records([_rec("train.forward", 0, 5, 2, parent=1, root=1),
             _rec("train.step", 0, 12, 1), _rec("train.step", 20, 28, 3)])
    assert harness.reader("step_host_ms.train")({}) == pytest.approx(10.0)


def test_idle_named_share_on_the_trace_base(records):
    base = trace.trace_base_ns()
    # kernels (us on the trace base): busy [1000, 2000), [5000, 6000), [9000, 9500);
    # the window opens at 500, so idle: [500, 1000), [2000, 5000), [6000, 9000).
    kernels = [("k", 1000.0, 1000.0), ("k", 5000.0, 1000.0), ("k", 9000.0, 500.0)]
    ctx = {"trace": {"kernels": kernels, "window_us": 9000.0, "busy_us": 2500.0}}
    # a root with children (its own time is unnamed), a child over [2000, 4000),
    # and a root without children over [6000, 7000)
    recs = [_rec("stitch.add", 2.0, 4.0, 2, parent=1, root=1, base=base),
            _rec("serve.request", 0.0, 8.0, 1, base=base),
            _rec("cache.gather", 6.0, 7.0, 3, base=base)]
    records(recs)
    assert program_trace.idle_intervals(ctx["trace"]) == [[500.0, 1000.0], [2000.0, 5000.0],
                                                          [6000.0, 9000.0]]
    share = harness.reader("idle_named_share.serve")(ctx)
    assert share == pytest.approx(100 * (2000 + 1000) / (500 + 3000 + 3000))
    assert harness.reader("idle_named_share.train")(ctx) == share
    # spans an hour away from the kernels: no overlap, no value
    records([_rec("cache.gather", 3.6e6, 3.6e6 + 1, 1, base=base)])
    assert harness.reader("idle_named_share.train")(ctx) is None


def test_interval_arithmetic():
    assert program_trace.union([(5, 6), (0, 2), (1, 3), (3, 4)]) == [[0, 4], [5, 6]]
    assert program_trace.covered([[0, 10], [20, 30]], [[5, 25]]) == 10
    assert program_trace.covered([[0, 10]], []) == 0


def test_nothing_to_read_gives_none(monkeypatch):
    ctx = {"trace": None}
    monkeypatch.setattr(program_trace, "records", lambda: None)
    for name in ("cache_load_ms.serve", "h2d_mb.serve", "request_self_ms.serve",
                 "step_host_ms.train", "idle_named_share.serve"):
        assert harness.reader(name)(ctx) is None
    monkeypatch.undo()
    # a program without the tracer (the parent of the change that added it)
    import floodplanet_code_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, "floodplanet_code_tpu_torch.utils.trace", None)
    assert program_trace.tracer() is None and program_trace.records() is None
    assert harness.reader("d2h_mb.serve")({}) is None


def test_real_spans_are_read(monkeypatch):
    """The readers on the port's own tracer, filled by real spans."""
    t = trace.Tracer()
    monkeypatch.setattr(program_trace, "records", t.records)
    for _ in range(3):
        with t.span("serve.request"):
            with t.span("stitch.add"):
                time.sleep(0.002)
            t.count("h2d_bytes", 2_000_000)
    assert harness.reader("h2d_mb.serve")({}) == pytest.approx(2.0)
    assert harness.reader("stitch_ms.serve")({}) >= 2.0


@pytest.mark.card
def test_a_span_covers_the_device_gap_it_causes(tmp_path):
    """On a card: a span around two kernels and a 20 ms sleep between them
    holds the device's idle gap between the kernels, each end within 100 us
    (the first kernel's launch and run, the second's launch latency), once
    the stamps are on the device-only trace's time base."""
    import json

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    x = torch.ones(1 << 20, device="cuda")
    for _ in range(3):
        x.mul_(1.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):  # the first pays the profiler's set-up
            torch.cuda.synchronize()
            with trace.span("test.gap") as sp:
                x.mul_(1.0)  # on an idle device: it ends microseconds after its launch
                time.sleep(0.02)
                x.add_(1.0)
        torch.cuda.synchronize()
    path = str(tmp_path / "device.json")
    prof.export_chrome_trace(path)
    with open(path) as handle:
        data = json.load(handle)
    base = int(data.get("baseTimeNanoseconds", 0))
    kernels = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in data["traceEvents"] if e.get("cat") == "kernel")
    gap_start, gap_end = kernels[-2][1], kernels[-1][0]  # the last sleep's gap
    start, end = trace.to_trace_us(sp.start_ns, base), trace.to_trace_us(sp.end_ns, base)
    print(f"torch {torch.__version__}, base {base} (rule {trace.trace_base_ns()}): the gap "
          f"starts {gap_start - start:+.1f} us after the span, ends {gap_end - end:+.1f} us "
          f"after it; gap {gap_end - gap_start:.1f} us")
    assert 0 <= gap_start - start < 100 and abs(gap_end - end) < 100
