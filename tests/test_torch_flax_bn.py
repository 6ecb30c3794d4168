"""``fused_bn=false``: the port's flax-rounding BatchNorm
(models/unet.py::FlaxBatchNormReLU) against the JAX package's
``nn.BatchNorm`` build, for the plain, early- and late-fusion models at base
8 and 32^2, on the CPU.

Weights cross through tools/import_jax_params.state_dict_from_flax (the
parameter tree is the fused build's). Tolerances: eval logits 1e-4
absolute; one train step's loss 1e-6 relative, gradients 2e-4 + 2e-3*|g|
(the convolutions sum in other orders, as in tests/test_torch_train_step.py)
and running statistics 1e-6; the bf16 forward 1e-2 of max|ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodplanet_code_tpu.models import build_model as jax_build_model
from floodplanet_code_tpu.ops.losses import cross_entropy_ignore as jax_ce
from floodplanet_code_tpu_torch.models import build_model
from floodplanet_code_tpu_torch.models.unet import DoubleConv, FlaxBatchNormReLU
from floodplanet_code_tpu_torch.ops.losses import cross_entropy_ignore
from floodplanet_code_tpu_torch.tools.export_model import PredictStep
from floodplanet_code_tpu_torch.tools.import_jax_params import (
    seeded_flax_variables,
    state_dict_from_flax,
)

BASE = 8
HW = 32
MODELS = {
    "ms_model": {"ms_image": 4},
    "ef_model": {"ms_image": 4},
    "lf_model": {"ms_image": 2, "dem": 1},
}


def _np_tree(tree):
    return jax.tree.map(lambda v: np.array(v, np.float32), tree)


def _batch(in_channels, seed=1):
    rng = np.random.default_rng(seed)
    keys = {"ms_image": "image"}
    return {keys.get(m, m): rng.standard_normal((2, HW, HW, c)).astype(np.float32)
            for m, c in in_channels.items()}


def _variables(name):
    in_channels = MODELS[name]
    return seeded_flax_variables(in_channels if name == "lf_model" else 4, 3, BASE, seed=6)


def _port(name, dtype=torch.float32, conv_impl="xla", fused_bn=False):
    return build_model(name, MODELS[name], 3, dtype=dtype, device="cpu",
                       base_feat_channels=BASE, conv_impl=conv_impl, fused_bn=fused_bn)


def _nchw(batch, dtype=torch.float32):
    return {k: torch.from_numpy(v).permute(0, 3, 1, 2).to(dtype) for k, v in batch.items()}


def _flax(name, dtype=jnp.float32):
    return jax_build_model(name, MODELS[name], 3, dtype=dtype, base_feat_channels=BASE,
                           fused_bn=False)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_eval_logits_match_flax(name):
    variables, batch = _variables(name), _batch(MODELS[name])
    jmodel = _flax(name)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, {k: jnp.asarray(v) for k, v in batch.items()}))
    # Under pallas_fused the fused pair is off (JAX models/unet.py:137): the
    # same modules as the xla build.
    for conv_impl in ("xla", "pallas_fused"):
        model = _port(name, conv_impl=conv_impl)
        assert not any(m.fused_pair for m in model.modules() if isinstance(m, DoubleConv))
        model.load_state_dict(state_dict_from_flax(variables), strict=True)
        with torch.inference_mode():
            got = model(_nchw(batch))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_one_train_step_matches_flax(name):
    variables, batch = _variables(name), _batch(MODELS[name])
    target = np.random.default_rng(3).choice([0, 1, 2], (2, HW, HW), p=[0.2, 0.4, 0.4])
    target = target.astype(np.int32)
    jmodel = _flax(name)

    def loss_fn(params):
        logits, upd = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            {k: jnp.asarray(v) for k, v in batch.items()}, train=True, mutable=["batch_stats"],
        )
        return jax_ce(logits, jnp.asarray(target), 0), upd

    (loss, upd), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    want = state_dict_from_flax(_np_tree({"params": grads, "batch_stats": upd["batch_stats"]}))

    model = _port(name)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    model.train()
    got_loss = cross_entropy_ignore(model(_nchw(batch)), torch.from_numpy(target), 0)
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(loss), rtol=1e-6)
    for pname, p in model.named_parameters():
        g, w = p.grad.numpy(), want[pname].numpy()
        assert (np.abs(g - w) <= 2e-4 + 2e-3 * np.abs(w)).all(), pname
    for bname, buf in model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want[bname].numpy(), atol=1e-6, rtol=1e-6,
                                   err_msg=bname)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_bf16_forward_matches_flax(name):
    variables, batch = _variables(name), _batch(MODELS[name], seed=2)
    jmodel = _flax(name, jnp.bfloat16)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, {k: jnp.asarray(v) for k, v in batch.items()}), np.float32)
    model = _port(name, torch.bfloat16)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    with torch.inference_mode():
        got = model(_nchw(batch)).permute(0, 2, 3, 1).float().numpy()
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_parameter_tree_equals_the_fused_build(name):
    """The same names and shapes as the fused build's, and JAX's
    ``fused_bn=False`` tree loads through the importer unchanged."""
    flax_bn, fused = _port(name), _port(name, fused_bn=True)
    assert {k: v.shape for k, v in flax_bn.state_dict().items()} == {
        k: v.shape for k, v in fused.state_dict().items()}
    assert any(isinstance(m, FlaxBatchNormReLU) for m in flax_bn.modules())
    jax_batch = {k: jnp.asarray(v[:1, :16, :16]) for k, v in _batch(MODELS[name]).items()}
    tree = jax.eval_shape(_flax(name).init, jax.random.PRNGKey(0), jax_batch)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), tree)
    flax_bn.load_state_dict(state_dict_from_flax(zeros), strict=True)


def test_export_carries_no_custom_op():
    """Under conv_impl=pallas_fused, a fused_bn=false model exports plain
    convolutions only; the fused build carries the custom op."""
    x = {"image": torch.rand(1, 16, 16, 4)}
    counts = {}
    for fused_bn in (False, True):
        model = _port("ef_model", conv_impl="pallas_fused", fused_bn=fused_bn)
        if fused_bn:
            for m in model.modules():
                if isinstance(m, DoubleConv):
                    m.freeze_fused_operands(torch.float32)
        with torch.no_grad():
            program = torch.export.export(PredictStep(model).eval(), (x,))
        ops = [n.target for n in program.graph.nodes if n.op == "call_function"]
        counts[fused_bn] = ops.count(torch.ops.floodplanet.relu_affine_conv3x3.default)
        if not fused_bn:
            assert torch.equal(program.module()(x), PredictStep(model).eval()(x))
    assert counts == {False: 0, True: 9}
