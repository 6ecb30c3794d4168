"""chip_smoke.py's phases, rehearsed on the CPU at a small size.

The card runs them at 512^2 tiles over scenes thousands of pixels a side;
here the same control flow runs on 64^2 tiles, where a CPU tensor must
count no kernel launch:
- the slice (serving): scenes written by the port's TIFF writer, the
  weights bridge, three ``infer`` requests on one warm full-width model,
  the overlapping pass, the unfused comparison and every check;
- shear parity: the shear against its plain version over both axes,
  orders and types;
- training: augmentation + train steps through the loader at batch 2 and a
  cut base width, the steps on one fixed batch, the evals before and after
  the updates, the fused-vs-unfused eval and the f32 fused-vs-plain step;
- fit: the fit CLI, a resume, a no-op re-run, the host loader and serving
  the best checkpoint;
- evaluation: ``predict`` (artifacts, per-crop stats, TTA, the unfused
  comparison; late fusion on Sen1Floods11 through both input paths), the
  HTTP daemon and ``batch_infer`` against ``infer``;
- model tools: the two-fold cross-validation with ``--soup`` and its
  re-run, the soup's re-scoring checks, the ensemble of two seeds (and
  across folds, refused), the export with and without TTA against the live
  step, the daemon on the artifact, and reference-schema checkpoints
  imported and served;
- data tools and options: global normalization (the parameters, cache
  parity, fits through both input paths), the non-square fit and augment
  check, fused_bn=false against fused_bn=true, debug_nans fits clean and
  poisoned, the data tools and the example transformer;
- more than one device: two CPU ranks (gloo) against one rank, one rank
  through the launcher, the 2-rank fits with the replicated and the
  pod-sharded cache and the resume, infer over two replicas;
- spatial partitioning, in the same two ranks: the steps on a 1 x 2 data x
  space mesh against one rank, the halo-extended fused conv (its plain
  version here) and the spatial fit;
- the root entry points: bench_torch.py under both conv_impl values and
  Batch_infer_torch.sh on what the evaluation phase keeps;
- scripts/torch_relu_flips.py, which explains the f64 witness's readings.
"""

import importlib.util
import os

import pytest
import torch

import chip_smoke
from floodplanet_code_tpu_torch.ops import LAUNCHES


def test_slice_phase_runs_on_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(chip_smoke, "TILE", 64)
    monkeypatch.setattr(chip_smoke, "BATCH", 4)
    monkeypatch.setattr(chip_smoke, "SCENES", [(150, 200), (150, 200), (100, 170)])
    monkeypatch.setattr(chip_smoke, "WORK", str(tmp_path / "work"))
    torch.manual_seed(0)
    result = chip_smoke.run_slice("cpu", device="cpu")
    assert result["launches"] == 0
    assert result["agree"] == 1.0  # one code path on the CPU: identical
    assert not (tmp_path / "work").exists()


def test_shear_parity_phase_runs_on_the_cpu(monkeypatch):
    monkeypatch.setattr(chip_smoke, "SHEAR_SHAPES", [(2, 64), (1, 30)])
    before = LAUNCHES["shear"]
    worst = chip_smoke.shear_parity("cpu")
    assert LAUNCHES["shear"] == before
    # One code path on the CPU: identical.
    assert worst[torch.float32] == worst[torch.bfloat16] == (0.0, 0.0)


def test_training_phase_runs_on_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(chip_smoke, "TILE", 64)
    monkeypatch.setattr(chip_smoke, "TRAIN_BATCH", 2)
    monkeypatch.setattr(chip_smoke, "TRAIN_STEPS", 4)
    monkeypatch.setattr(chip_smoke, "BASE", 8)
    monkeypatch.setattr(chip_smoke, "TRAIN_SCENES", [(150, 200)] * 5)
    monkeypatch.setattr(chip_smoke, "WORK", str(tmp_path / "work"))
    torch.manual_seed(0)
    result = chip_smoke.run_training("cpu", device="cpu")
    assert result["launches"] == {"relu_affine_conv3x3": 0, "shear": 0}
    assert len(result["losses"]) == 4 and len(result["fixed_losses"]) == 10
    assert result["eval_confusion_differ"] <= 1e-3
    assert len(result["upsample"]["levels"]) == 5  # four bf16 levels and one f32
    assert not (tmp_path / "work").exists()


def test_no_card_exits_non_zero_without_a_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_fit_phase_runs_on_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(chip_smoke, "TILE", 64)
    monkeypatch.setattr(chip_smoke, "TRAIN_BATCH", 2)
    monkeypatch.setattr(chip_smoke, "BASE", 8)
    monkeypatch.setattr(chip_smoke, "TRAIN_SCENES", [(150, 200)] * 5)
    monkeypatch.setattr(chip_smoke, "FIT_LIMIT_TRAIN", 3)
    monkeypatch.setattr(chip_smoke, "FIT_LOG_IMAGE_ITER", 2)
    monkeypatch.setattr(chip_smoke, "WORK", str(tmp_path / "work"))
    result = chip_smoke.run_fit("cpu", device="cpu")
    assert set(result["launches"].values()) == {0}
    assert result["epochs"] == [0, 1, 2, 3]
    assert result["steady_train_tiles_per_s"]["cache"] > 0
    assert result["reproduction"]["pallas_fused"]["runs"] == ["first", "again", "resumed"]
    assert result["reproduction"]["xla"]["runs"] == ["first", "again"]
    assert not (tmp_path / "work").exists()


def test_evaluation_phase_runs_on_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(chip_smoke, "TILE", 64)
    monkeypatch.setattr(chip_smoke, "BATCH", 4)
    monkeypatch.setattr(chip_smoke, "BASE", 8)
    monkeypatch.setattr(chip_smoke, "SCENES", [(150, 200), (100, 170)])
    monkeypatch.setattr(chip_smoke, "EVAL_CHIPS", 2)
    monkeypatch.setattr(chip_smoke, "WORK", str(tmp_path / "work"))
    result = chip_smoke.run_evaluation("cpu", device="cpu")
    assert set(result["launches"].values()) == {0}
    assert result["fused_vs_xla"]["argmax_agree"] == 1.0  # one code path on the CPU
    assert result["late_fusion"]["max_dprob"] <= chip_smoke.PROB_TOL
    assert result["predict"]["scenes"] == 2 and result["serve_s"]["warm"] > 0
    assert not (tmp_path / "work").exists()


def test_entry_points_phase_runs_on_the_cpu(monkeypatch, tmp_path):
    """Phase 15 on what a small phase 10 keeps: bench_torch.py under both
    conv_impl values and Batch_infer_torch.sh against batch_infer."""
    monkeypatch.setattr(chip_smoke, "TILE", 32)
    monkeypatch.setattr(chip_smoke, "BATCH", 4)
    monkeypatch.setattr(chip_smoke, "TRAIN_BATCH", 2)
    monkeypatch.setattr(chip_smoke, "BASE", 8)
    monkeypatch.setattr(chip_smoke, "BENCH_STEPS", 2)
    monkeypatch.setattr(chip_smoke, "SCENES", [(100, 120), (70, 90)])
    monkeypatch.setattr(chip_smoke, "EVAL_CHIPS", 2)
    monkeypatch.setattr(chip_smoke, "WORK", str(tmp_path / "work"))
    keep = str(tmp_path / "keep")
    kept = chip_smoke.run_evaluation("cpu", device="cpu", keep_dir=keep)["kept"]
    assert len(kept["roots"]) == 2 and all(kept["masks"].values())
    result = chip_smoke.run_entry_points("cpu", kept, device="cpu")
    assert result["launches"] == {"xla": 0, "pallas_fused": 0}
    assert result["bench"]["xla"]["flops"] == result["bench"]["pallas_fused"]["flops"]
    assert result["batch_infer_script_masks"] == sum(len(v) for v in kept["masks"].values())
    assert not os.path.exists(keep) and not (tmp_path / "work").exists()


def test_tools_phase_runs_on_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(chip_smoke, "TILE", 64)
    monkeypatch.setattr(chip_smoke, "BATCH", 4)
    monkeypatch.setattr(chip_smoke, "BASE", 8)
    monkeypatch.setattr(chip_smoke, "SCENES", [(150, 200), (100, 170)])
    monkeypatch.setattr(chip_smoke, "TOOLS_SCENES", [(150, 200), (130, 170)])
    monkeypatch.setattr(chip_smoke, "TOOLS_CROP", 64)
    monkeypatch.setattr(chip_smoke, "TOOLS_BATCH", 4)
    monkeypatch.setattr(chip_smoke, "TOOLS_LIMIT_TRAIN", 2)
    monkeypatch.setattr(chip_smoke, "TOOLS_LIMIT_VAL", 2)
    monkeypatch.setattr(chip_smoke, "WORK", str(tmp_path / "work"))
    result = chip_smoke.run_tools("cpu", device="cpu")
    assert set(result["launches"].values()) == {0}
    assert set(result["cv"]) == {"RegionA", "RegionB"}
    assert result["ensemble"]["confusion_moved"] == 0.0  # one code path on the CPU
    assert result["serve_artifact"]["masks_equal"]
    assert all(r["max_dprob"] == 0.0 and r["argmax_equal"] for r in result["export"].values())
    assert set(result["import"]) == {"ef", "lf"}
    assert not (tmp_path / "work").exists()


def test_data_tools_phase_runs_on_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(chip_smoke, "TILE", 64)
    monkeypatch.setattr(chip_smoke, "BATCH", 4)
    monkeypatch.setattr(chip_smoke, "TRAIN_BATCH", 2)
    monkeypatch.setattr(chip_smoke, "BASE", 8)
    monkeypatch.setattr(chip_smoke, "SCENES", [(150, 200), (150, 200), (100, 170)])
    monkeypatch.setattr(chip_smoke, "DATA_CROP", (48, 64))
    monkeypatch.setattr(chip_smoke, "DATA_LIMIT_TRAIN", 3)
    monkeypatch.setattr(chip_smoke, "DATA_LIMIT_VAL", 1)
    monkeypatch.setattr(chip_smoke, "TRANSFORMER", {"d_model": 32, "n_layers": 1, "patch": 16})
    monkeypatch.setattr(chip_smoke, "WORK", str(tmp_path / "work"))
    result = chip_smoke.run_data_tools("cpu", device="cpu")
    assert result["launches"] == {"relu_affine_conv3x3": 0, "shear": 0}
    assert result["debug_nans"]["loss_gap_on_off"] == 0.0  # one code path on the CPU
    assert "after train step 2 of epoch 0" in result["debug_nans"]["raised"]
    assert result["non_square"]["augment_max_abs_err"] == 0.0
    assert result["fused_bn_false"]["loss_rel"] <= 1e-4
    assert "phase12/nans_poisoned" in result["tools"]["gc_listed"]
    assert not (tmp_path / "work").exists()


def test_multi_device_phase_runs_on_the_cpu(monkeypatch, tmp_path):
    """Phases 13 and 14 with two CPU ranks (gloo): the data-parallel steps
    against one rank, one rank through the launcher, the 2-rank fits with
    both caches and the resume, the one-rank fit, infer over two replicas;
    the spatial steps against one rank at an even and an uneven crop, and
    the spatial fit at the uneven crop."""
    monkeypatch.setattr(chip_smoke, "TILE", 64)
    monkeypatch.setattr(chip_smoke, "SP_TILE", 50)  # blocks 25/25, 13/12, 7/5, 4/2, 2/1
    monkeypatch.setattr(chip_smoke, "TRAIN_BATCH", 4)
    monkeypatch.setattr(chip_smoke, "BASE", 8)
    monkeypatch.setattr(chip_smoke, "TRAIN_SCENES", [(150, 200)] * 5)
    monkeypatch.setattr(chip_smoke, "MD_BATCH", 4)
    monkeypatch.setattr(chip_smoke, "MD_PAD", 1)
    monkeypatch.setattr(chip_smoke, "MD_LIMIT_TRAIN", 2)
    monkeypatch.setattr(chip_smoke, "MD_LIMIT_VAL", 1)
    monkeypatch.setattr(chip_smoke, "WORK", str(tmp_path / "work"))
    result = chip_smoke.run_multi_device("cpu", device="cpu")
    assert result["launches"] == {"conv": 0, "shear": 0}
    assert result["nccl_one_rank"]["backend"] == "gloo"  # one CPU rank
    assert result["fit"]["pod_batches_equal"][0] > 0
    assert len(result["fit"]["losses"]) == 4
    assert result["infer"]["argmax_agree"] >= 0.999
    assert result["two_cards"] is None
    spatial = result["spatial"]
    assert spatial["launches"] == {"conv": 0, "shear": 0}
    # 22 exchanges forward (two per DoubleConv, one per upsample), one
    # fewer backward: the image's needs no gradient.
    assert [c["halo"]["count"] for c in spatial["collectives_per_rank"]] == [43, 43]
    assert set(spatial["halo_parity"].values()) == {0.0}  # one code path on the CPU
    # At 50 rows the pools out of levels 0, 1 and 2 split a window: three
    # more exchanges each way.
    crop = spatial["crop"]
    assert [c["halo"]["count"] for c in crop["collectives_per_rank"]] == [49, 49]
    assert set(crop["halo_parity"].values()) == {0.0}
    assert crop["halo_parity_blocks"] == {"level2": [7, 5], "level3": [4, 2], "bottleneck": [2, 1]}
    assert [r["block_rows"] for r in crop["pack_reuse"]] == [7, 5]
    assert len(crop["f64_witness"]["spatial"]) == 2
    assert all(v <= chip_smoke.SP_F64_TOL for w in crop["f64_spatial"] for v in w)
    # The f32 steps with the one-rank step's ReLU decisions in both.
    assert crop["matched_relu"]["rel_norm"] <= chip_smoke.SP_MATCHED_TOL
    assert "matched_relu" not in spatial  # the even crop runs no f64 or matched step
    assert len(spatial["fit"]["losses"]) == 2 and spatial["fit"]["crop"] == 50
    assert not (tmp_path / "work").exists()


def _relu_flips_script():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "scripts", "torch_relu_flips.py")
    spec = importlib.util.spec_from_file_location("torch_relu_flips", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("tile", [48, 50])
def test_relu_flips_separate_rounding_from_relu_decisions(tile):
    """The f32 step's gradients against the f64 step's on the phase-14
    rehearsal's batches: rounding alone (below 1e-5 of their norm) where
    every ReLU is decided alike, more where one is decided the other way."""
    out = _relu_flips_script().main(["--tile", str(tile), "--base", "8", "--batch", "4",
                                     "--scenes", "150x200", "--device", "cpu"])
    assert set(out["flipped_layer_elements"]) == set(out["relu_flips"])
    assert out["relu_elements"] > 0
    if out["relu_flips"]:
        assert 1e-5 < out["grad_gap_global"] < 1e-2
    else:
        assert out["grad_gap_global"] < 1e-5
