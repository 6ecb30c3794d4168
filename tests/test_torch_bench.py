"""The port's root entry points on the CPU, at a tiny size: bench_torch.py
(bench.py's keys, its FLOP count against torch's own counter) and
Batch_infer_torch.sh (its command line through batch_infer's parser)."""

import json
import os
import shlex

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import bench_torch
from floodplanet_code_tpu_torch.inference import batch_infer as batch_infer_mod
from floodplanet_code_tpu_torch.models import build_model
from floodplanet_code_tpu_torch.train import init_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(device="cpu", tile=32, batch=2, base_feat_channels=8, steps=2)
KEYS = {"metric", "value", "unit", "vs_baseline", "augmented_recipe_value",
        "augmented_recipe_vs_baseline", "inference_value", "flops", "mfu",
        "inference_flops", "inference_mfu"}


@pytest.fixture(scope="module")
def results():
    return {c: bench_torch.main(conv_impl=c, **SMALL) for c in ("xla", "pallas_fused")}


def _conv_count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return sum(v for k, v in counter.get_flop_counts()["Global"].items()
               if "convolution" in str(k))


@pytest.mark.parametrize("conv_impl", ["xla", "pallas_fused"])
def test_prints_bench_keys(results, capsys, conv_impl):
    out = bench_torch.main(conv_impl=conv_impl, **SMALL)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == out
    assert set(out) == KEYS
    assert out["unit"] == "tiles/s/chip" and "cpu" in out["metric"]
    assert f"conv_impl={conv_impl}" in out["metric"]
    for key in ("value", "augmented_recipe_value", "inference_value"):
        assert np.isfinite(out[key]) and out[key] > 0
    assert out["vs_baseline"] == round(out["value"] / bench_torch.REF_GPU_TILES_PER_SEC, 3)
    assert out["mfu"] is None and out["inference_mfu"] is None  # no device peak on the CPU


def test_flops_match_torch_flop_counter(results):
    assert results["xla"]["flops"] == results["pallas_fused"]["flops"]
    assert results["xla"]["inference_flops"] == results["pallas_fused"]["inference_flops"]
    model = build_model("ef_model", {"ms_image": 4}, 3, dtype=torch.bfloat16, device="cpu",
                        conv_impl="xla", base_feat_channels=8)
    init_weights(model, 0)
    x = torch.randn(2, 4, 32, 32)
    model.eval()
    with torch.no_grad():
        forward = _conv_count(lambda: model({"image": x}))
    assert results["xla"]["inference_flops"] == forward
    # The train step: forward, then both gradients of every conv but the
    # first's input gradient (the input needs none).
    model.train()
    train = _conv_count(lambda: model({"image": x}).sum().backward())
    assert results["xla"]["flops"] == train


def test_batch_infer_script_parses(monkeypatch):
    """The python line of Batch_infer_torch.sh, with its shell variables
    filled in, through inference/batch_infer.py::main's parser."""
    with open(os.path.join(REPO, "Batch_infer_torch.sh")) as handle:
        line = next(s for s in handle if s.startswith("python "))
    argv = shlex.split(line.replace('"$CKPT"', "/ckpt/entry").replace('"$@"', "/r1 /r2"))
    assert argv[:3] == ["python", "-m", "floodplanet_code_tpu_torch.inference.batch_infer"]
    calls = []
    monkeypatch.setattr(batch_infer_mod, "batch_infer",
                        lambda *args, **kwargs: calls.append((args, kwargs)))
    batch_infer_mod.main(argv[3:])
    assert calls == [(("/ckpt/entry", "floodplanet", ["/r1", "/r2"]),
                      {"split": "all", "save_dir": None, "n_workers": None,
                       "device": "cuda"})]
