"""The port's cross-validation tools (tools/{soup_checkpoints,eval_ensemble,
run_crossval}.py) against the JAX package's, on the CPU.

One module-scoped fixture runs a tiny JAX ``fit_model`` (f32, base 8, 32^2
crops, 3 epochs with top-3 retention, so three ingredients) and bridges
every retained orbax entry (JAX ``load_model_for_eval`` +
``state_dict_from_flax``) into a port experiment directory with the same
``index.json`` entries and config snapshot. The port's copy runs the fused
conv (``tpu.conv_impl=pallas_fused``: its plain version on the CPU), the
JAX package the unfused one; both compute the same function. Then:
- the port's ``average_state_dicts`` is JAX's ``average_trees`` within 1e-7;
- greedy and uniform soups pick the same ingredients and score them within
  1e-4, and the written soup reloads to its own metrics;
- the ensemble of two entries: member and ensemble metrics within 1e-4;
- ``run_fold`` composes the recipe JAX composes;
- the port's ``run_crossval.main`` runs two folds with ``--soup`` and skips
  both on a second call.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from floodplanet_code_tpu.config import compose as jax_compose
from floodplanet_code_tpu.config import load_experiment_config as jax_load_config
from floodplanet_code_tpu.data import build_dataset as jax_build_dataset
from floodplanet_code_tpu.data import generate_image_slice_object as jax_slices
from floodplanet_code_tpu.inference.predict import load_model_for_eval as jax_load_for_eval
from floodplanet_code_tpu.tools import eval_ensemble as jax_ensemble
from floodplanet_code_tpu.tools import run_crossval as jax_crossval
from floodplanet_code_tpu.tools import soup_checkpoints as jax_soup
from floodplanet_code_tpu.train.fit import fit_model as jax_fit_model
from floodplanet_code_tpu_torch.config import load_experiment_config, save_config
from floodplanet_code_tpu_torch.inference.infer import load_model_for_eval
from floodplanet_code_tpu_torch.tools import eval_ensemble, run_crossval, soup_checkpoints
from floodplanet_code_tpu_torch.tools.import_jax_params import state_dict_from_flax
from floodplanet_code_tpu_torch.train import checkpoint as ckpt
from floodplanet_code_tpu_torch.train.fit import resolve_ignore_index

TOL = 1e-4
METRIC_KEYS = ("val_MulticlassJaccardIndex", "val_MulticlassF1Score", "val_water_IoU",
               "valid_loss")


def _overrides(root, *extra):
    return [
        "dataset.sensor=PS", "eval_region=RegionA", "crop_height=32", "crop_width=32",
        "crop_stride=32", "batch_size=8", "n_workers=2", "n_epochs=3", "lr=1e-3",
        "limit_train_batches=3", "limit_val_batches=2", "save_topk_models=3",
        "tpu.resume_every=1", "ignore_index=-1", "tpu.n_devices=1", "tpu.compute_dtype=float32",
        "model.model_kwargs.base_feat_channels=8", "transforms.rotate.active=false",
        f"dataset.dataset_kwargs.root_dir={root}", *extra,
    ]


def _flax_to_numpy(variables):
    return jax.tree.map(lambda v: np.array(v, np.float32), variables)


@pytest.fixture(scope="module")
def exps(synthetic_csdap_root, tmp_path_factory):
    """(JAX experiment dir, its port copy, the valid dataset, the entries'
    flax variables by name)."""
    base = tmp_path_factory.mktemp("cv_tools")
    jax_exp, port_exp = str(base / "jax"), str(base / "port")
    jcfg = jax_compose(overrides=_overrides(synthetic_csdap_root))
    jax_fit_model(jcfg, overwrite_exp_dir=jax_exp)
    valid = jax_build_dataset("floodplanet", "valid", jax_slices(32, 32, 32), sensor="PS",
                              eval_region="RegionA", ignore_index=-1, seed_num=0,
                              root_dir=synthetic_csdap_root)
    with open(os.path.join(jax_exp, "checkpoints", "index.json")) as handle:
        index = json.load(handle)
    variables = {}
    for entry in index["entries"]:
        src = os.path.join(jax_exp, "checkpoints", entry["name"])
        _, variables[entry["name"]] = jax_load_for_eval(jcfg, src, valid)
        dst = os.path.join(port_exp, "checkpoints", entry["name"])
        os.makedirs(dst)
        sd = state_dict_from_flax(_flax_to_numpy(variables[entry["name"]]))
        torch.save({"model": sd, "step": 0, "ema_params": None},
                   os.path.join(dst, ckpt.CHECKPOINT_FILE))
        shutil.copy(os.path.join(src, "metrics.json"), dst)
    shutil.copy(os.path.join(jax_exp, "checkpoints", "index.json"),
                os.path.join(port_exp, "checkpoints", "index.json"))
    pcfg = load_experiment_config(jax_exp)
    pcfg.tpu.conv_impl = "pallas_fused"
    save_config(pcfg, port_exp)
    assert len(index["entries"]) == 3
    return {"jax": jax_exp, "port": port_exp, "valid": valid, "variables": variables,
            "entries": sorted(index["entries"], key=lambda e: -e["metric"])}


def _close(got: dict, want: dict, keys=METRIC_KEYS):
    for key in keys:
        assert abs(got[key] - want[key]) <= TOL, (key, got[key], want[key])


def test_average_state_dicts_matches_jax(exps):
    trees = [_flax_to_numpy(exps["variables"][e["name"]]) for e in exps["entries"]]
    want = state_dict_from_flax(_flax_to_numpy(jax_soup.average_trees(trees)))
    got = soup_checkpoints.average_state_dicts([state_dict_from_flax(t) for t in trees])
    assert got.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(), rtol=1e-7, atol=1e-7,
                                   err_msg=key)
    one = state_dict_from_flax(trees[0])
    assert all(torch.equal(v, one[k]) for k, v in
               soup_checkpoints.average_state_dicts([one]).items())


@pytest.mark.parametrize("mode", ["greedy", "uniform"])
def test_soup_matches_jax(exps, mode):
    want = jax_soup.soup_experiment(exps["jax"], mode=mode)
    got = soup_checkpoints.soup_experiment(exps["port"], mode=mode, device="cpu")
    assert got["ingredients_used"] == want["ingredients_used"]
    assert [p["name"] for p in got["per_ingredient"]] == [p["name"] for p in
                                                          want["per_ingredient"]]
    assert got["n_ingredients_available"] == want["n_ingredients_available"] == 3
    _close(got["soup_val_metrics"], want["soup_val_metrics"])
    if mode == "greedy":
        assert abs(got["base_val_iou"] - want["base_val_iou"]) <= TOL
        assert got["soup_val_iou"] >= got["base_val_iou"]
    # The soup is a checkpoint directory of its own, outside the index.
    assert got["checkpoint"] == os.path.join(exps["port"], "checkpoints", f"soup-{mode}")
    with open(os.path.join(exps["port"], "checkpoints", "index.json")) as handle:
        assert {e["name"] for e in json.load(handle)["entries"]}.isdisjoint(
            {"soup-greedy", "soup-uniform"})
    with open(os.path.join(got["checkpoint"], "soup.json")) as handle:
        assert json.load(handle)["mode"] == mode
    with open(os.path.join(got["checkpoint"], "metrics.json")) as handle:
        assert json.load(handle)["val_MulticlassJaccardIndex"] == got["soup_val_iou"]


def test_soup_reloads_to_its_metrics(exps):
    """The greedy soup, loaded through load_model_for_eval, scores what the
    soup recorded; re-scoring ingredients on one model equals fresh models."""
    summary = soup_checkpoints.soup_experiment(exps["port"], mode="greedy", device="cpu")
    cfg = load_experiment_config(exps["port"])
    from floodplanet_code_tpu_torch.data import build_dataset, generate_image_slice_object

    ds = build_dataset("floodplanet", "valid", generate_image_slice_object(32, 32, 32),
                       sensor="PS", eval_region="RegionA", ignore_index=-1, seed_num=0,
                       root_dir=cfg.dataset.dataset_kwargs.root_dir)
    ignore = resolve_ignore_index(cfg.ignore_index, ds.n_classes)

    def evaluator(path):
        model = load_model_for_eval(cfg, path, ds, "cpu")
        return model, soup_checkpoints.make_val_evaluator(cfg, ds, model, ignore, "cpu")

    _, evaluate = evaluator(summary["checkpoint"])
    soup_sd = ckpt.eval_state_dict(ckpt.read_checkpoint(summary["checkpoint"]))
    assert evaluate(soup_sd) == summary["soup_val_metrics"]
    paths = [os.path.join(exps["port"], "checkpoints", e["name"]) for e in exps["entries"][:2]]
    _, shared = evaluator(paths[0])
    for path in (paths[0], paths[1], paths[0]):
        sd = ckpt.eval_state_dict(ckpt.read_checkpoint(path))
        assert shared(sd) == evaluator(path)[1](sd)


def _port_members(exps) -> list:
    return [os.path.join(exps["port"], "checkpoints", e["name"]) for e in exps["entries"][:2]]


@pytest.fixture(scope="module")
def port_ensemble(exps):
    """The port's ensemble of the two best entries on one CPU device."""
    return eval_ensemble.evaluate_ensemble(_port_members(exps), split="valid", device="cpu")


def test_ensemble_matches_jax(exps, port_ensemble):
    names = [e["name"] for e in exps["entries"][:2]]
    want = jax_ensemble.evaluate_ensemble(
        [os.path.join(exps["jax"], "checkpoints", n) for n in names], split="valid")
    got = port_ensemble
    assert got["fold"] == want["fold"] and got["split"] == "valid"
    for g, w in zip(got["members"], want["members"]):
        assert os.path.basename(g["checkpoint"]) == os.path.basename(w["checkpoint"])
        assert abs(g["iou"] - w["iou"]) <= TOL
    _close(got["ensemble_metrics"], want["ensemble_metrics"], METRIC_KEYS[:3])
    assert got["ensemble_iou"] == got["ensemble_metrics"]["val_MulticlassJaccardIndex"]
    assert got["best_member_iou"] == max(m["iou"] for m in got["members"])


def test_ensemble_over_two_replicas_equals_one_device(exps, port_ensemble):
    """evaluate_ensemble(devices=[cpu, cpu]): every member replicated, each
    batch split over the replicas and gathered (inference/sliding.py's
    ``replicate`` and ``split_apply``). The same pixels are counted, each
    logit computed at another batch size: the metrics within TOL."""
    one = port_ensemble
    two = eval_ensemble.evaluate_ensemble(_port_members(exps), split="valid", device="cpu",
                                          devices=["cpu", "cpu"])
    _close(two["ensemble_metrics"], one["ensemble_metrics"], METRIC_KEYS[:3])
    for a, b in zip(two["members"], one["members"]):
        assert abs(a["iou"] - b["iou"]) <= TOL


@pytest.mark.parametrize("package", ["jax", "port"])
def test_ensemble_refuses_other_folds(tmp_path, package):
    tool, load, save = (
        (jax_ensemble, jax_load_config, None) if package == "jax"
        else (eval_ensemble, load_experiment_config, save_config))
    from floodplanet_code_tpu.config import save_config as jax_save_config

    dirs = []
    for k, region in enumerate(("RegionA", "RegionB")):
        cfg = jax_compose(overrides=["dataset.sensor=PS", f"eval_region={region}",
                                     f"seed_num={k}"])
        (save or jax_save_config)(cfg, str(tmp_path / region))
        dirs.append(str(tmp_path / region))
    assert load(dirs[1]).eval_region == "RegionB"
    with pytest.raises(ValueError, match="different fold"):
        tool.evaluate_ensemble(dirs, split="valid")
    with pytest.raises(ValueError, match="at least 2"):
        tool.evaluate_ensemble(dirs[:1], split="valid")


def test_run_fold_composes_the_jax_recipe(tmp_path, monkeypatch):
    captured = {}

    def capture(name):
        def fit(cfg, overwrite_exp_dir=None, **kwargs):
            captured[name] = (cfg.to_dict(), overwrite_exp_dir)
            return ""
        return fit

    import floodplanet_code_tpu.train.fit as jax_fit

    monkeypatch.setattr(jax_fit, "fit_model", capture("jax"))
    monkeypatch.setattr(run_crossval, "fit_model", capture("port"))
    extra = ["limit_train_batches=2", "seed_num=3"]
    records = {
        "jax": jax_crossval.run_fold("S1", "RegionB", 4, str(tmp_path / "jax"), 2, extra),
        "port": run_crossval.run_fold("S1", "RegionB", 4, str(tmp_path / "port"), 2, extra,
                                      device="cpu"),
    }
    assert captured["port"][0] == captured["jax"][0]
    assert captured["port"][0]["crop_height"] == 300 and captured["port"][0]["ignore_index"] == -1
    for r in records.values():
        r.pop("wall_seconds")
    assert records["port"] == records["jax"]
    assert captured["port"][1] == str(tmp_path / "port" / "S1_RegionB")


def test_main_runs_two_folds_and_resumes(synthetic_csdap_root, tmp_path, monkeypatch, capsys):
    # The dataset root comes from dataset_dirs.json in the working directory.
    monkeypatch.chdir(tmp_path)
    with open("dataset_dirs.json", "w") as handle:
        json.dump({"floodplanet": synthetic_csdap_root}, handle)
    out_dir = str(tmp_path / "cv")
    argv = ["--sensor", "PS", "--regions", "RegionA", "RegionB", "--batch_size", "8",
            "--n_epochs", "1", "--out_dir", out_dir, "--soup", "--device", "cpu"]
    for o in ("crop_height=32", "crop_width=32", "crop_stride=32", "n_workers=2",
              "limit_train_batches=2", "limit_val_batches=2", "tpu.compute_dtype=float32",
              "model.model_kwargs.base_feat_channels=8", "tpu.conv_impl=pallas_fused",
              "transforms.rotate.active=false"):
        argv += ["--override", o]
    summary = run_crossval.main(argv)
    with open(os.path.join(out_dir, "crossval_PS.json")) as handle:
        assert json.load(handle) == summary
    assert [f["region"] for f in summary["folds"]] == ["RegionA", "RegionB"]
    assert summary["mean_best_val_iou"] is not None
    for fold in summary["folds"]:
        assert os.path.isfile(os.path.join(fold["best_checkpoint"], ckpt.CHECKPOINT_FILE))
        with open(os.path.join(out_dir, f"PS_{fold['region']}", "checkpoints",
                               "index.json")) as handle:
            best = max(json.load(handle)["entries"], key=lambda e: e["metric"])
        assert fold["best_val_iou"] == best["metric"] and fold["best_epoch"] == 0
        assert fold["soup_val_iou"] >= fold["soup_base_val_iou"]
        assert fold["soup_n_ingredients"] == 1 and os.path.isdir(fold["soup_checkpoint"])
        assert fold["timing"]["n_epochs_run"] == 1

    capsys.readouterr()
    assert run_crossval.main(argv) == summary
    out = capsys.readouterr().out
    assert out.count("already done, skipping") == 2
    assert json.loads(out[out.index("{"):]) == summary


def test_tools_need_a_card_unless_cpu(exps, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        soup_checkpoints.soup_experiment(exps["port"])
    names = [os.path.join(exps["port"], "checkpoints", e["name"]) for e in exps["entries"][:2]]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        eval_ensemble.evaluate_ensemble(names)
