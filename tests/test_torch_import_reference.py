"""The port's reference-checkpoint importer (tools/import_torch_checkpoint.py)
against the JAX package's, on the CPU.

The state dicts come from tests/test_torch_import.py: the reference UNet's
key schema filled from a seed (``build_reference_state_dict``) and the
torch late-fusion oracle (``_TorchLF``); the schema's kernels are
rescaled to std sqrt(1/fan_in) so the logits stay O(1). The port maps
them straight onto its modules; the mapping must equal the JAX importer's
flax trees carried through the weights bridge exactly, and the written
experiment must load and give the JAX model's logits within 1e-4.
"""

import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodplanet_code_tpu.models import build_model as jax_build_model
from floodplanet_code_tpu.tools import import_torch_checkpoint as jax_import
from floodplanet_code_tpu_torch.config import load_experiment_config
from floodplanet_code_tpu_torch.inference.infer import load_model_for_eval
from floodplanet_code_tpu_torch.tools import import_torch_checkpoint
from floodplanet_code_tpu_torch.tools.import_jax_params import state_dict_from_flax
from test_torch_import import _randomize_bn, _TorchLF, build_reference_state_dict

LF_CHANNELS = {"ms_image": 4, "dem": 1}


def _reference(kind):
    """(torch state dict as saved by the reference, its numpy copy)."""
    if kind == "ef":
        state = build_reference_state_dict(np.random.default_rng(0))
        # Its kernels have std 0.1 at every fan-in, which grows the logits
        # to ~1e7 over nine blocks; std sqrt(1/fan_in) keeps them O(1).
        for key, value in state.items():
            if value.ndim == 4:
                state[key] = value / np.float32(0.1 * np.sqrt(np.prod(value.shape[1:])))
        return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}, state
    torch.manual_seed(7)
    oracle = _TorchLF(LF_CHANNELS, 3)
    _randomize_bn(oracle, None)
    state = {k: v.detach().clone() for k, v in oracle.state_dict().items()}
    return state, {k: v.numpy() for k, v in state.items()}


def _jax_converted(kind, numpy_state):
    """JAX's importer: (flax variables, in_channels dict, n_classes)."""
    if kind == "ef":
        params, stats, c_in, n_classes = jax_import.convert_unet_state_dict(numpy_state)
        c_in = {"ms_image": c_in}
    else:
        params, stats, c_in, n_classes = jax_import.convert_lf_state_dict(numpy_state)
    return {"params": params, "batch_stats": stats}, c_in, n_classes


@pytest.mark.parametrize("kind", ["ef", "lf"])
def test_mapping_equals_the_jax_importer(kind):
    state, numpy_state = _reference(kind)
    variables, want_in, want_classes = _jax_converted(kind, numpy_state)
    want = state_dict_from_flax(variables)
    if kind == "ef":
        got, c_in, n_classes = import_torch_checkpoint.convert_unet_state_dict(state)
        c_in = {"ms_image": c_in}
    else:
        got, c_in, n_classes = import_torch_checkpoint.convert_lf_state_dict(state)
    assert (c_in, n_classes) == (want_in, want_classes)
    assert list(c_in) == list(want_in)  # the encoders' order
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert got[key].dtype == torch.float32 and torch.equal(got[key], value), key


@pytest.mark.parametrize("kind", ["ef", "lf"])
def test_imported_experiment_matches_jax_logits(kind, tmp_path):
    state, numpy_state = _reference(kind)
    src = tmp_path / "model-epoch=05-val_MulticlassJaccardIndex=0.6077.ckpt"
    torch.save({"state_dict": state, "epoch": 5}, str(src))
    exp = str(tmp_path / "imported")
    path = import_torch_checkpoint.main([str(src), "--exp_dir", exp, "--sensor", "PS",
                                         "--override", "tpu.compute_dtype=float32",
                                         "--device", "cpu"])
    assert os.path.basename(path) == "model-epoch=05-val_MulticlassJaccardIndex=0.6077"
    with open(os.path.join(exp, "checkpoints", "index.json")) as handle:
        index = json.load(handle)
    assert [e["name"] for e in index["entries"]] == [os.path.basename(path)]
    with open(os.path.join(path, "metrics.json")) as handle:
        assert json.load(handle)["imported_from"] == str(src)
    cfg = load_experiment_config(exp)
    assert cfg.model.name == f"{kind}_model" and cfg.model.model_kwargs["align_corners"] is True

    variables, c_in, n_classes = _jax_converted(kind, numpy_state)
    model = load_model_for_eval(cfg, path, SimpleNamespace(n_channels=c_in, n_classes=n_classes),
                                "cpu")
    rng = np.random.default_rng(11)
    batch = {"image": rng.standard_normal((2, 32, 32, 4)).astype(np.float32)}
    if kind == "lf":
        batch["dem"] = rng.standard_normal((2, 32, 32, 1)).astype(np.float32)
    jmodel = jax_build_model(f"{kind}_model", c_in, n_classes, dtype=jnp.float32,
                             align_corners=True)
    want = np.asarray(jmodel.apply(jax.tree.map(jnp.asarray, variables),
                                   {k: jnp.asarray(v) for k, v in batch.items()}, train=False))
    with torch.inference_mode():
        got = model({k: torch.from_numpy(v).permute(0, 3, 1, 2) for k, v in batch.items()})
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-4)


def test_not_a_reference_checkpoint_raises():
    state, _ = _reference("ef")
    del state["model.up2.conv.double_conv.3.bias"]
    with pytest.raises(KeyError, match="is this a reference"):
        import_torch_checkpoint.convert_unet_state_dict(state)
    with pytest.raises(KeyError, match="unrecognized late-fusion modalities"):
        import_torch_checkpoint.convert_lf_state_dict({"encoders.radar.inc.x": state[
            "model.inc.double_conv.0.weight"]})
