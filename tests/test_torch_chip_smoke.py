"""chip_smoke.py's slice phase, rehearsed on the CPU at a small size.

The card runs it at 512^2 tiles and batch 16 over scenes thousands of
pixels a side; here the same control flow (scenes written by the port's
TIFF writer, the weights bridge, three ``infer`` requests on one warm
full-width model, the overlapping pass, the unfused comparison and every
check) runs on 64^2 tiles, where a CPU tensor must count no kernel launch.
"""

import torch

import chip_smoke


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


def test_no_card_exits_non_zero_without_a_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out
