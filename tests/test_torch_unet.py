"""The port's EF-UNet (floodplanet_code_tpu_torch.models) against flax.

Shared weights cross through tools/import_jax_params.state_dict_from_flax;
eval-mode logits are compared in f32 at an absolute tolerance of 1e-4 (the
two frameworks sum the convolutions in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from floodplanet_code_tpu.models import build_model as jax_build_model
from floodplanet_code_tpu.models.unet import _upsample2x
from floodplanet_code_tpu_torch.models import build_model
from floodplanet_code_tpu_torch.models.unet import _upsample2x as torch_upsample2x
from floodplanet_code_tpu_torch.tools.import_jax_params import (
    seeded_flax_variables,
    state_dict_from_flax,
)

ATOL = 1e-4


def _randomize_bn(variables, rng):
    """Move BN params and running stats away from their 1/0 init."""

    def visit(params, stats):
        for name, node in params.items():
            if name.startswith("BatchNorm"):
                c = node["scale"].shape
                node["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                node["bias"] = rng.normal(0, 0.2, c).astype(np.float32)
                stats[name]["mean"] = rng.normal(0, 0.2, c).astype(np.float32)
                stats[name]["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
            elif isinstance(node, dict) and name in stats:
                visit(node, stats[name])

    visit(variables["params"], variables["batch_stats"])
    return variables


def _numpy_tree(tree):
    return jax.tree.map(lambda v: np.array(v, np.float32), tree)


_INITS = {}


def _flax_variables(base):
    """flax init for the given base width, once per process (the variable
    tree does not depend on conv_impl or on the input's spatial size)."""
    if base not in _INITS:
        jmodel = jax_build_model("ef_model", {"ms_image": 4}, 3, base_feat_channels=base)
        _INITS[base] = _numpy_tree(
            jax.jit(lambda x: jmodel.init(jax.random.PRNGKey(0), {"image": x}))(
                jnp.zeros((1, 16, 16, 4))
            )
        )
    return jax.tree.map(np.copy, _INITS[base])


def _models(rng, base, hw, conv_impl, torch_conv_impl):
    jmodel = jax_build_model(
        "ef_model", {"ms_image": 4}, 3, base_feat_channels=base, conv_impl=conv_impl
    )
    x = rng.standard_normal((2, *hw, 4)).astype(np.float32)
    variables = _randomize_bn(_flax_variables(base), rng)
    tmodel = build_model(
        "ef_model", {"ms_image": 4}, 3, base_feat_channels=base, device="cpu",
        conv_impl=torch_conv_impl,
    )
    tmodel.load_state_dict(state_dict_from_flax(variables), strict=True)
    return jmodel, variables, tmodel, x


def _flax_logits(jmodel, variables, x):
    return np.asarray(
        jax.jit(lambda v, x: jmodel.apply(v, {"image": x}, train=False))(
            variables, jnp.asarray(x)
        )
    )


@pytest.mark.parametrize("torch_conv_impl", ["xla", "pallas_fused"])
@pytest.mark.parametrize("conv_impl", ["xla", "pallas_fused"])
def test_eval_logits_match_flax(rng, conv_impl, torch_conv_impl):
    # Base 32 at 64^2 puts the deep levels at C1 >= 256, so the JAX
    # package's Pallas kernel engages (interpret mode on the CPU).
    jmodel, variables, tmodel, x = _models(
        rng, 32, (64, 64), conv_impl, torch_conv_impl
    )
    want = _flax_logits(jmodel, variables, x)
    with torch.inference_mode():
        got = tmodel({"image": torch.from_numpy(x).permute(0, 3, 1, 2)})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=ATOL, rtol=0)


def test_odd_input_pads_to_match(rng):
    # 40x44 pools to 5x5 / 2x2 at the deepest levels: exercises flooring
    # max pools and _pad_to_match on both axes.
    jmodel, variables, tmodel, x = _models(rng, 8, (40, 44), "xla", "pallas_fused")
    want = _flax_logits(jmodel, variables, x)
    with torch.inference_mode():
        got = tmodel({"image": torch.from_numpy(x).permute(0, 3, 1, 2)})
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("align_corners", [False, True])
def test_upsample_matches_jax(rng, align_corners):
    x = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
    want = np.asarray(_upsample2x(jnp.asarray(x), align_corners))
    got = torch_upsample2x(torch.from_numpy(x).permute(0, 3, 1, 2), align_corners)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-6, rtol=0)


def test_seeded_tree_has_flax_structure():
    init = _flax_variables(8)
    seeded = seeded_flax_variables(4, 3, base_feat_channels=8, seed=1)
    shapes = lambda tree: jax.tree.map(lambda v: tuple(np.shape(v)), tree)  # noqa: E731
    assert shapes(seeded) == shapes(init)


def test_train_mode_bn_raises():
    # Train mode runs (batch statistics); only the running-statistics fold,
    # which is eval-only, raises there.
    model = build_model("ef_model", {"ms_image": 4}, 3, base_feat_channels=8,
                        device="cpu", conv_impl="pallas_fused")
    model.train()
    out = model({"image": torch.randn(2, 4, 16, 16)})
    assert out.shape == (2, 3, 16, 16) and torch.isfinite(out).all()
    with pytest.raises(RuntimeError, match="eval-mode"):
        model.unet.encoder.inc.bn0.fold()


def test_build_model_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build_model("ef_model", {"ms_image": 4}, 3, base_feat_channels=8)


def test_bf16_fold_rounds_like_the_jax_path(rng):
    # The fold (a, b) is computed in f32 and cast to bf16 before the apply,
    # as FusedBatchNormReLU does; F.batch_norm rounds differently.
    from floodplanet_code_tpu_torch.models.unet import BatchNormReLU

    bn = BatchNormReLU(6).eval()
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 6)))
        bn.var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, 6)))
        bn.mean.copy_(torch.from_numpy(rng.normal(0, 0.3, 6)))
    x = torch.from_numpy(rng.standard_normal((2, 6, 4, 4)).astype(np.float32))
    inv = torch.rsqrt(bn.var + 1e-5)
    a = (inv * bn.scale).bfloat16().view(1, -1, 1, 1)
    b = (bn.bias - bn.mean * inv * bn.scale).bfloat16().view(1, -1, 1, 1)
    want = F.relu(x.bfloat16() * a + b)
    assert torch.equal(bn(x.bfloat16()), want)


@pytest.mark.parametrize("update", ["adam_fused", "adam_foreach", "sgd", "train_forward",
                                    "load_state_dict"])
def test_pack_key_moves_on_every_update(update):
    # The eval pack cache (used on a card under inference mode) re-packs
    # when its key moves. Adam(fused=True) updates in place without moving
    # the parameters' _version; the optimizer-step count catches it.
    from floodplanet_code_tpu_torch.models.unet import DoubleConv

    dc = DoubleConv(3, 4, conv_impl="pallas_fused")
    x = torch.randn(2, 3, 8, 8)
    dc(x).sum().backward()  # gradients for the optimizers
    dc.eval()
    y = torch.randn(2, 4, 8, 8)
    key = dc._pack_key(y)
    assert dc._pack_key(y) == key
    if update == "train_forward":
        dc.train()(x)
    elif update == "load_state_dict":
        dc.load_state_dict(dc.state_dict())
    else:
        opt = {"adam_fused": lambda p: torch.optim.Adam(p, fused=True),
               "adam_foreach": lambda p: torch.optim.Adam(p, foreach=True),
               "sgd": lambda p: torch.optim.SGD(p, lr=0.1)}[update](dc.parameters())
        opt.step()
    assert dc._pack_key(y) != key
