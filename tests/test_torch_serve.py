"""The port's serving daemon (inference/serve.py) and multi-root driver
(inference/batch_infer.py) on the CPU, from a checkpoint directory of the
port's CheckpointManager.

Both keep one model warm across requests or roots and must write, for
every root, exactly the masks a cold ``infer`` call writes for it. The
daemon answers as the JAX package's does: 200 with the written paths, 400
for a body that is not JSON or lacks ``root``, 404 for an unknown path or
root, 500 with the exception's text. On a program exported by
tools/export_model.py (``artifact_path``) it runs at the program's frozen
batch and tile and writes the masks ``infer`` writes from the checkpoint.
"""

import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from conftest import make_synthetic_csdap
from floodplanet_code_tpu_torch.config import compose, load_experiment_config, save_config
from floodplanet_code_tpu_torch.geo import tiff
from floodplanet_code_tpu_torch.inference import batch_infer, infer as infer_mod, serve
from floodplanet_code_tpu_torch.inference.infer import build_infer_dataset, infer
from floodplanet_code_tpu_torch.models import build_model
from floodplanet_code_tpu_torch.tools import export_model
from floodplanet_code_tpu_torch.tools.import_jax_params import (
    seeded_flax_variables,
    state_dict_from_flax,
)
from floodplanet_code_tpu_torch.train import create_train_state
from floodplanet_code_tpu_torch.train.checkpoint import MONITOR_KEY, CheckpointManager

BASE = 8


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Two scene roots and an experiment with one checkpoint entry."""
    base = tmp_path_factory.mktemp("serve")
    roots = []
    for k, regions in enumerate((("RegionA",), ("RegionB", "RegionC"))):
        root = str(base / f"root{k}")
        make_synthetic_csdap(root, regions=regions, sensors=("PS",), scene_hw=(70, 90),
                             scenes_per_region=1, seed=k)
        roots.append(root)
    exp = str(base / "exp")
    cfg = compose(overrides=["dataset.sensor=PS", "crop_height=32", "crop_width=32",
                             "n_workers=2", f"model.model_kwargs.base_feat_channels={BASE}",
                             "tpu.conv_impl=pallas_fused", "tpu.compute_dtype=float32",
                             "tpu.inference_batch_size=8", "eval_region=RegionA"])
    save_config(cfg, exp)
    model = build_model("ef_model", {"ms_image": 4}, 3, base_feat_channels=BASE, device="cpu")
    model.load_state_dict(state_dict_from_flax(seeded_flax_variables(4, 3, BASE, seed=2)))
    manager = CheckpointManager(exp, save_top_k=1)
    entry = manager.save(create_train_state(model, None, 1e-3), 0, {MONITOR_KEY: 0.5})
    manager.wait_until_finished()
    return {"roots": roots, "exp": exp, "entry": entry, "base": base}


def _cold_masks(setup, root, out):
    """What one cold ``infer`` writes for ``root`` (no held-out region)."""
    cfg = load_experiment_config(setup["exp"])
    cfg.eval_region = None
    ds = build_infer_dataset(cfg, "floodplanet", "all", root_dir=root)
    return _read(infer(cfg, setup["entry"], "floodplanet", "all", out, dataset=ds,
                       device="cpu"))


def _read(paths):
    return {os.path.relpath(p, os.path.dirname(os.path.dirname(p))): tiff.imread(p)
            for p in paths}


def _same(got, want):
    assert got.keys() == want.keys() and got
    for key, mask in want.items():
        np.testing.assert_array_equal(got[key], mask, err_msg=key)


def _call(url, body=None):
    data = None if body is None else (body if isinstance(body, bytes) else
                                      json.dumps(body).encode())
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def test_daemon_serves_infers_masks(setup):
    server = serve.serve(setup["entry"], "127.0.0.1", 0, device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        status, health = _call(url + "/healthz")
        assert status == 200 and health["status"] == "ok"
        assert health["device"] == "cpu" and health["devices"] == 1
        assert health["model_loaded"] is False and health["checkpoint"] == setup["entry"]
        root = setup["roots"][1]
        want = _cold_masks(setup, root, str(setup["base"] / "cold"))
        warm = None
        for k in range(2):
            status, reply = _call(url + "/infer", {"root": root,
                                                   "save_dir": str(setup["base"] / f"req{k}")})
            assert status == 200 and reply["root"] == root and reply["seconds"] > 0
            _same(_read(reply["written"]), want)
            if warm is None:
                warm = server.service._warm
            assert server.service._warm is warm  # the second request reuses the model
        assert _call(url + "/healthz")[1]["model_loaded"] is True
        assert _call(url + "/infer", b"{not json")[0] == 400
        assert _call(url + "/infer", {"split": "all"}) == (400, {"error": "missing field: 'root'"})
        assert _call(url + "/nope")[0] == 404
        assert _call(url + "/nope", {"root": root})[0] == 404
        status, reply = _call(url + "/infer", {"root": str(setup["base"] / "absent")})
        assert status == 404 and "does not exist" in reply["error"]
        os.makedirs(setup["base"] / "empty", exist_ok=True)
        status, reply = _call(url + "/infer", {"root": str(setup["base"] / "empty")})
        assert status == 500 and reply["error"].startswith("ValueError: No regions found")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def test_batch_infer_keeps_one_model(setup, monkeypatch):
    loads = []
    load = infer_mod.load_model_for_eval

    def counting(*args, **kwargs):
        loads.append(args[1])
        return load(*args, **kwargs)

    monkeypatch.setattr(batch_infer, "load_model_for_eval", counting)
    out = str(setup["base"] / "batch")
    results = batch_infer.main([setup["entry"], "floodplanet", "--roots", *setup["roots"],
                                "--save_dir", out, "--device", "cpu"])
    assert loads == [setup["entry"]]
    assert list(results) == setup["roots"]
    for k, root in enumerate(setup["roots"]):
        # batch_infer keeps the experiment's eval_region, as infer does.
        cfg = load_experiment_config(setup["exp"])
        ds = build_infer_dataset(cfg, "floodplanet", "all", root_dir=root)
        want = _read(infer(cfg, setup["entry"], "floodplanet", "all",
                           str(setup["base"] / f"cold_batch{k}"), dataset=ds, device="cpu"))
        _same(_read(results[root]), want)
        assert all(p.startswith(os.path.join(out, f"root{k}")) for p in results[root])


def test_entry_points_need_a_card_unless_cpu(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        serve.serve(setup["entry"], port=0)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        batch_infer.batch_infer(setup["entry"], "floodplanet", setup["roots"])


@pytest.fixture(scope="module")
def artifacts(setup):
    """The entry exported at the daemon's batch and tile (8, 32^2), with and
    without TTA, to a directory outside the experiment. The export reads
    the channels and classes from a dataset found through dataset_dirs.json
    in the working directory."""
    with open(setup["base"] / "dataset_dirs.json", "w") as handle:
        json.dump({"floodplanet": setup["roots"][0]}, handle)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(setup["base"])
        return {tta: export_model.export_checkpoint(
            setup["entry"], str(setup["base"] / "anywhere" / f"model_tta{int(tta)}"),
            batch_size=8, tta=tta, device="cpu") for tta in (False, True)}


@pytest.mark.parametrize("tta", [False, True], ids=["plain", "tta"])
def test_artifact_daemon_serves_infers_masks(setup, artifacts, tta):
    """The daemon on an exported program: no checkpoint is read, and its
    masks equal a cold ``infer``'s from the checkpoint at the same batch and
    tile."""
    manifest = artifacts[tta]
    server = serve.serve(artifact_path=manifest["artifact"], port=0, device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        status, health = _call(url + "/healthz")
        assert status == 200 and health["artifact"] == manifest["artifact"]
        assert health["checkpoint"] is None and health["model_loaded"] is False
        assert server.service.tta is tta
        assert server.service.experiment_dir == setup["exp"]
        root = setup["roots"][1]
        cfg = load_experiment_config(setup["exp"])
        cfg.eval_region = None
        ds = build_infer_dataset(cfg, "floodplanet", "all", root_dir=root)
        want = _read(infer(cfg, setup["entry"], "floodplanet", "all",
                           str(setup["base"] / f"cold_art{int(tta)}"), dataset=ds, tta=tta,
                           device="cpu"))
        status, reply = _call(url + "/infer", {"root": root,
                                               "save_dir": str(setup["base"] / f"art{int(tta)}")})
        assert status == 200, reply
        _same(_read(reply["written"]), want)
        # The default save directory is the manifest's experiment's.
        status, reply = _call(url + "/infer", {"root": root})
        assert status == 200 and all(p.startswith(os.path.join(setup["exp"], "serve_inference"))
                                     for p in reply["written"])
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def test_artifact_service_checks_its_sources(setup, artifacts):
    with pytest.raises(ValueError, match="exactly one"):
        serve.InferenceService(device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        serve.InferenceService(setup["entry"], artifact_path=artifacts[False]["artifact"],
                               device="cpu")
    with pytest.raises(ValueError, match="--tta requested"):
        serve.InferenceService(artifact_path=artifacts[False]["artifact"], tta=True,
                               device="cpu")
    # TTA comes from the artifact; the manifest is found without the suffix.
    service = serve.InferenceService(artifact_path=artifacts[True]["artifact"][:-4],
                                     device="cpu")
    assert service.tta is True


def test_artifact_refuses_other_shapes(setup, artifacts):
    service = serve.InferenceService(artifact_path=artifacts[False]["artifact"], device="cpu")
    cfg = load_experiment_config(setup["exp"])
    step = service._warm_model(build_infer_dataset(cfg, "floodplanet", "all",
                                                   root_dir=setup["roots"][0]))
    ok = torch.zeros(8, 32, 32, 4)
    assert step({"image": ok.permute(0, 3, 1, 2)}).shape == (8, 32, 32, 3)
    with pytest.raises(ValueError, match=r"artifact expects image \[8, 32, 32, 4\], request "
                                         r"produced \[4, 32, 32, 4\]"):
        step({"image": torch.zeros(4, 4, 32, 32)})
