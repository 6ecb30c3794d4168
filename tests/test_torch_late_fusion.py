"""The port's late-fusion UNet (models/water_seg.py::LateFusionModel)
against the JAX package's, on the CPU in f32.

Weights cross through tools/import_jax_params.state_dict_from_flax, which
reads flax's own names for the tree (``encoder_<modality>``,
``concat_conv_<level>``, ``UNetDecoder_0``). Tolerances: eval logits 1e-4
absolute (the frameworks sum convolutions in different orders); one train
step's gradients 2e-4 + 2e-3*|g|, the bound the early-fusion step is held
to (tests/test_torch_train_step.py); running statistics 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodplanet_code_tpu.data.augment import TransformParams as JParams
from floodplanet_code_tpu.models import build_model as jax_build_model
from floodplanet_code_tpu.train.fit import make_train_step as jax_train_step
from floodplanet_code_tpu.train.state import create_train_state as jax_state
from floodplanet_code_tpu_torch.data.augment import TransformParams
from floodplanet_code_tpu_torch.models import LateFusionModel, build_model
from floodplanet_code_tpu_torch.tools.import_jax_params import (
    seeded_flax_variables,
    state_dict_from_flax,
)
from floodplanet_code_tpu_torch.train import create_train_state, init_weights, make_train_step

BASE = 8
MODALITIES = {
    "one": {"ms_image": 2},
    "two": {"ms_image": 2, "dem": 1},
}


def _np_tree(tree):
    return jax.tree.map(lambda v: np.array(v, np.float32), tree)


def _batch(rng, in_channels, b=2, hw=32):
    keys = {"ms_image": "image"}
    return {keys.get(m, m): rng.standard_normal((b, hw, hw, c)).astype(np.float32)
            for m, c in in_channels.items()}


def _nchw(batch):
    return {k: torch.from_numpy(v).permute(0, 3, 1, 2) for k, v in batch.items()}


def _flax_init(in_channels, base=BASE, shapes_only=False):
    """flax's variables for the late-fusion model (zeros of their shapes
    with ``shapes_only``: tracing without compiling is enough there)."""
    jmodel = jax_build_model("lf_model", in_channels, 3, base_feat_channels=base)
    batch = {k: jnp.asarray(v) for k, v in _batch(np.random.default_rng(0), in_channels,
                                                  1, 16).items()}
    if shapes_only:
        tree = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), batch)
        return jax.tree.map(lambda s: np.zeros(s.shape, np.float32), tree)
    return _np_tree(jax.jit(jmodel.init)(jax.random.PRNGKey(0), batch))


_LOGITS = {}


def _flax_logits(modalities):
    """(weights, batch, flax eval logits), once per modality set."""
    if modalities not in _LOGITS:
        in_channels = MODALITIES[modalities]
        variables = seeded_flax_variables(in_channels, 3, BASE, seed=4)
        jmodel = jax_build_model("lf_model", in_channels, 3, base_feat_channels=BASE)
        batch = _batch(np.random.default_rng(1), in_channels)
        want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
            variables, {k: jnp.asarray(v) for k, v in batch.items()}))
        _LOGITS[modalities] = variables, batch, want
    return _LOGITS[modalities]


@pytest.mark.parametrize("conv_impl", ["xla", "pallas_fused"])
@pytest.mark.parametrize("modalities", sorted(MODALITIES))
def test_eval_logits_match_flax(modalities, conv_impl):
    in_channels = MODALITIES[modalities]
    variables, batch, want = _flax_logits(modalities)
    model = build_model("lf_model", in_channels, 3, base_feat_channels=BASE, device="cpu",
                        conv_impl=conv_impl, feat_fusion="concat_conv")
    assert isinstance(model, LateFusionModel) and list(model.encoders) == list(in_channels)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    with torch.inference_mode():
        got = model(_nchw(batch))
    assert got.dtype == torch.float32 and got.shape == (2, 3, 32, 32)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("modalities", sorted(MODALITIES))
def test_seeded_tree_has_flax_structure(modalities):
    in_channels = MODALITIES[modalities]
    init = _flax_init(in_channels, shapes_only=True)
    seeded = seeded_flax_variables(in_channels, 3, BASE, seed=1)
    shapes = lambda tree: jax.tree.map(lambda v: tuple(np.shape(v)), tree)  # noqa: E731
    assert shapes(seeded) == shapes(init)
    model = build_model("lf_model", in_channels, 3, base_feat_channels=BASE, device="cpu")
    assert model.state_dict().keys() == state_dict_from_flax(init).keys()


def test_one_train_step_matches_jax():
    """One SGD step at lr 1 through both packages' make_train_step: the
    parameters move by exactly -gradient (the momentum buffer starts at the
    gradient in both), so the step's gradients are compared."""
    in_channels = MODALITIES["two"]
    batch = _batch(np.random.default_rng(2), in_channels)
    target = np.random.default_rng(3).choice([0, 1, 2], (2, 32, 32), p=[0.2, 0.4, 0.4])
    target = target.astype(np.int32)
    jmodel = jax_build_model("lf_model", in_channels, 3, base_feat_channels=BASE,
                             conv_impl="pallas_fused")
    jstate = jax_state(jmodel, batch, lr=1.0, optimizer_name="sgd")
    start = state_dict_from_flax(_np_tree({"params": jstate.params,
                                           "batch_stats": jstate.batch_stats}))
    jstep = jax_train_step(jmodel, 0, JParams(False, 0, False, 0, False, 0))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch["target"] = jnp.asarray(target)
    jstate, jlogs = jstep(jstate, jbatch, jax.random.key(0))
    after = state_dict_from_flax(_np_tree({"params": jstate.params,
                                           "batch_stats": jstate.batch_stats}))

    model = build_model("lf_model", in_channels, 3, base_feat_channels=BASE, device="cpu",
                        conv_impl="pallas_fused")
    state = create_train_state(model, start, 1.0, "sgd")
    step = make_train_step(model, 0, TransformParams(False, 0, False, 0, False, 0))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbatch["target"] = torch.from_numpy(target)
    _, logs = step(state, tbatch)
    np.testing.assert_allclose(logs["loss"].item(), float(jlogs["loss"]), rtol=1e-5)
    params = dict(model.named_parameters())
    assert any(name.startswith("concat_convs.") for name in params)
    for name, p in params.items():
        g = (start[name] - p.detach()).numpy()
        w = (start[name] - after[name]).numpy()
        assert (np.abs(g - w) <= 2e-4 + 2e-3 * np.abs(w)).all(), name
    for name, buf in model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), after[name].numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=name)


def test_init_matches_jax_statistics():
    """Base 32, two modalities: every conv kernel's std within 5% of flax's
    initial one where it has >= 2304 elements (two draws' stds differ by
    ~2%), within 25% below that; BatchNorm values and biases exact (the
    fusing convs' biases start at zero, as flax's nn.Conv does)."""
    in_channels = MODALITIES["two"]
    init = _flax_init(in_channels, base=32)
    want = state_dict_from_flax(init)
    model = init_weights(build_model("lf_model", in_channels, 3, base_feat_channels=32,
                                     device="cpu"), 0)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for name, value in got.items():
        w = want[name]
        if value.dim() == 4:
            ratio = value.std().item() / w.std().item()
            assert abs(ratio - 1) <= (0.05 if value.numel() >= 2304 else 0.25), (name, ratio)
            assert value.abs().max() <= 2 * w.abs().max()  # truncated at 2 stds
        else:
            assert torch.equal(value, w), name


def test_errors_match_jax():
    with pytest.raises(NotImplementedError, match="No fusion method"):
        build_model("lf_model", {"ms_image": 2}, 3, base_feat_channels=BASE, device="cpu",
                    feat_fusion="sum")
    model = build_model("lf_model", MODALITIES["two"], 3, base_feat_channels=BASE,
                        device="cpu")
    with pytest.raises(KeyError, match='modality "dem" missing'):
        model({"image": torch.zeros(1, 2, 16, 16)})
