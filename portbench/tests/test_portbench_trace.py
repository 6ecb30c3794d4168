"""The reduction of a profiler trace and the readers' arithmetic on a small
synthetic chrome trace, and the result line's schema."""

import json

import pytest

from portbench import harness


def _trace(tmp_path):
    us = [  # (category, name, ts, dur)
        ("user_annotation", "portbench.gather", 0, 100),
        ("user_annotation", "portbench.step", 100, 900),
        ("kernel", "sm90_xmma_fprop_implicit_gemm_bf16_cudnn", 10, 40),
        ("kernel", "void at::native::vectorized_elementwise_kernel<4>", 30, 40),  # overlaps
        ("kernel", "sm90_xmma_dgrad_implicit_gemm_cudnn", 150, 100),
        ("kernel", "void at::native::reduce_kernel<128>", 450, 50),
        ("kernel", "conv_bf16_wgmma_kernel<64, 2>", 700, 100),
    ]
    events = [{"ph": "X", "cat": c, "name": n, "ts": t, "dur": d} for c, n, t, d in us]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return harness.reduce_trace(str(path))


def test_busy_idle_and_gaps(tmp_path):
    t = _trace(tmp_path)
    # kernels cover [10, 70), [150, 250), [450, 500), [700, 800): 310 us of 800
    assert t["busy_us"] == 310 and t["window_us"] == 800
    assert t["gaps"] == [("portbench.step", 200), ("portbench.step", 200),
                         ("portbench.gather", 80)]
    idle = harness.reader("device_idle_share.train")({"trace": t})
    assert idle == pytest.approx(100 * (1 - 310 / 800))


def test_roofline_and_mfu_readers(tmp_path):
    t = _trace(tmp_path)
    # conv kernels: 40 + 100 + 100 us (not the elementwise or reduce ones)
    ctx = {"trace": t, "trace_steps": 2, "conv_bound_s_per_step": 60e-6}
    assert harness.reader("conv_roofline.train")(ctx) == pytest.approx(100 * 120 / 240)
    ctx = {"trace": t, "trace_forwards": 3, "conv_bound_s_per_batch": 40e-6}
    assert harness.reader("conv_roofline.serve")(ctx) == pytest.approx(100 * 120 / 240)
    ctx = {"window": {"steps": 50, "seconds": 2.0}, "train_flops_per_step": 3.4e12,
           "peak_flops": 989e12}
    assert harness.reader("step_mfu.train")(ctx) == pytest.approx(100 * 50 * 3.4e12 / 2 / 989e12)
    ctx = {"window": {"model_forwards": 10, "seconds": 1.0}, "forward_flops_per_batch": 2e12,
           "peak_flops": 989e12}
    assert harness.reader("forward_mfu.serve")(ctx) == pytest.approx(100 * 20e12 / 989e12)
    # nothing to read: nothing returned, never 0
    assert harness.reader("conv_roofline.train")({"trace": None}) is None
    assert harness.reader("gather_ms.train")({"events": None}) is None
    assert harness.reader("request_host_s.serve")({"requests": [
        {"wall_s": 0.5, "forward_s": 0.1}, {"wall_s": 0.3, "forward_s": 0.1}]}) == pytest.approx(0.3)


def test_breakdown_has_classes_names_and_labelled_gaps(tmp_path):
    b = harness.breakdown(_trace(tmp_path))
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    assert b["device_ops"][0] == ["class: cuDNN conv", pytest.approx(140e-6)]
    assert ["class: fused conv kernel", pytest.approx(100e-6)] in b["device_ops"]
    assert b["idle_gaps"][0] == ["portbench.step", pytest.approx(200e-6)]


def test_result_line_schema():
    line = harness.result_line(
        True, 400, 0, {"train_tiles_per_s": {"value": 212.4071, "unit": "tiles/s"}},
        {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
         "memory_peak_bytes": 5}, {"loss": {"value": 1e-3, "limit": 1e-2}},
        {"device_ops": [["x", 1.0]], "idle_gaps": []})
    d = json.loads(line)
    assert list(d) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                       "checks"]
    assert d["metrics"]["train_tiles_per_s"] == {"value": 212.4071, "unit": "tiles/s"}
    assert harness.checks_text(d["checks"]) == ["check loss: 0.001 limit 0.01"]
