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
  the updates, the fused-vs-unfused eval and the f32 fused-vs-plain step.
"""

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
    assert not (tmp_path / "work").exists()
