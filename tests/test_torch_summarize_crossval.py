"""The port's cross-validation summarizer (tools/summarize_crossval.py)
against the JAX package's on the arm fixtures of
tests/test_summarize_crossval.py: the pivot, the markdown and the CLI's
output and JSON file must be equal."""

import json

import pytest

from floodplanet_code_tpu.tools import summarize_crossval as jax_summarize
from floodplanet_code_tpu_torch.tools import summarize_crossval
from test_summarize_crossval import _write_arm


def _arms(root, case):
    """(arm dirs, ensemble dirs) of the JAX tests' two fixtures."""
    if case == "partial_and_soup":
        full = _write_arm(root, "arm_full", [
            {"sensor": "S1", "region": "A", "best_val_iou": 0.50},
            {"sensor": "S1", "region": "B", "best_val_iou": 0.70},
            {"sensor": "L8", "region": "A", "best_val_iou": 0.60},
        ], soup={"S1_A": 0.55})
        partial = _write_arm(root, "arm_partial", [
            {"sensor": "S1", "region": "A", "best_val_iou": 0.52, "soup_val_iou": 0.58},
            {"sensor": "S1", "region": "B", "best_val_iou": None},
        ])
        return [full, partial], []
    arm = _write_arm(root, "arm", [
        {"sensor": "S1", "region": "A", "best_val_iou": 0.50},
        {"sensor": "S1", "region": "B", "best_val_iou": 0.70},
    ])
    ens = root / "ensemble"
    ens.mkdir()
    with open(ens / "S1_A.json", "w") as handle:
        json.dump({"fold": {"sensor": "S1", "eval_region": "A"}, "ensemble_iou": 0.61}, handle)
    with open(ens / "notes.json", "w") as handle:
        json.dump({"unrelated": True}, handle)
    return [arm], [str(ens)]


CASES = ["partial_and_soup", "ensemble"]


@pytest.mark.parametrize("case", CASES)
def test_pivot_and_markdown_match_jax(tmp_path, case):
    arms, ensembles = _arms(tmp_path, case)
    want = jax_summarize.build_pivot(arms, ensembles)
    got = summarize_crossval.build_pivot(arms, ensembles)
    assert got == want
    assert summarize_crossval.format_markdown(got) == jax_summarize.format_markdown(want)


@pytest.mark.parametrize("case", CASES)
def test_main_matches_jax(tmp_path, capsys, case):
    arms, ensembles = _arms(tmp_path, case)
    extra = [a for e in ensembles for a in ("--ensemble_dir", e)]
    outputs = {}
    for name, main in (("jax", jax_summarize.main), ("port", summarize_crossval.main)):
        path = str(tmp_path / f"{name}.json")
        capsys.readouterr()
        main([*arms, *extra, "--json", path])
        with open(path) as handle:
            outputs[name] = (capsys.readouterr().out, json.load(handle))
    assert outputs["port"] == outputs["jax"]
    assert "| fold |" in outputs["port"][0]


def test_missing_directory_is_a_usage_error(tmp_path):
    for main in (jax_summarize.main, summarize_crossval.main):
        with pytest.raises(SystemExit) as exc:
            main([str(tmp_path / "absent")])
        assert exc.value.code == 2
