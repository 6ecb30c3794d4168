"""The port's train and eval steps (floodplanet_code_tpu_torch/train/)
against the JAX package's on the CPU, in f32, from the same weights and
batches (weights cross through tools/import_jax_params.py).

Tolerances, and why:
- one fused step (base 32, where the JAX Pallas conv engages at the deep
  levels in interpret mode): loss 1e-5 relative; gradients within
  2e-4 + 2e-3*|g|, the bound tests/test_conv_fused.py holds JAX's fused
  and unfused gradients to (the convolutions sum in other orders);
  running statistics 1e-5.
- several optimizer steps: loss 1e-4 relative per step, confusion equal or
  within 0.1% of the pixels (an argmax near a tie may flip), running
  statistics 1e-4. Adam divides each gradient element by its own RMS, so an
  element whose gradient is rounding noise can move by up to lr per step
  in either package: 99.9% of all parameter elements are held to
  1e-5 + 1e-3*|p| and every one of them to 2*lr*steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodplanet_code_tpu.data.augment import TransformParams as JParams
from floodplanet_code_tpu.models import build_model as jax_build_model
from floodplanet_code_tpu.ops.losses import cross_entropy_ignore as jax_ce
from floodplanet_code_tpu.train.fit import make_eval_step as jax_eval_step
from floodplanet_code_tpu.train.fit import make_train_step as jax_train_step
from floodplanet_code_tpu.train.state import create_train_state as jax_state
from floodplanet_code_tpu_torch.data.augment import TransformParams
from floodplanet_code_tpu_torch.models import build_model
from floodplanet_code_tpu_torch.ops.losses import cross_entropy_ignore
from floodplanet_code_tpu_torch.tools.import_jax_params import (
    seeded_flax_variables,
    state_dict_from_flax,
)
from floodplanet_code_tpu_torch.train import (
    create_train_state,
    make_eval_step,
    make_train_step,
    resolve_ignore_index,
)

J_NO_AUG = JParams(False, 0, False, 0, False, 0)
T_NO_AUG = TransformParams(False, 0, False, 0, False, 0)
LR = 1e-3


def _np_tree(tree):
    return jax.tree.map(lambda v: np.array(v, np.float32), tree)


def _batch(rng, b, hw):
    image = rng.standard_normal((b, hw, hw, 4)).astype(np.float32)
    target = rng.choice([0, 1, 2], (b, hw, hw), p=[0.2, 0.4, 0.4]).astype(np.int32)
    return image, target


def _torch_batch(image, target, valid=None):
    out = {"image": torch.from_numpy(image), "target": torch.from_numpy(target)}
    if valid is not None:
        out["valid"] = torch.from_numpy(valid)
    return out


def _port_model(base, conv_impl):
    return build_model("ef_model", {"ms_image": 4}, 3, base_feat_channels=base,
                       device="cpu", conv_impl=conv_impl)


def test_one_fused_step_matches_jax():
    # The bound sits at the edge of f32 noise for the 64^2-level weight
    # gradients (sums over 8192 positions with cancellation). On one input
    # tried, XLA's own f32 gradient of inc.conv1 lay 1.9x the bound away
    # from a float64 run of the same step, while the port's lay 0.84x
    # away; this fixed input keeps both within it.
    variables = seeded_flax_variables(4, 3, 32, seed=5)
    image, target = _batch(np.random.default_rng(1), 2, 64)
    jmodel = jax_build_model("ef_model", {"ms_image": 4}, 3, base_feat_channels=32,
                             conv_impl="pallas_fused")

    def loss_fn(params):
        logits, upd = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            {"image": jnp.asarray(image)}, train=True, mutable=["batch_stats"],
        )
        return jax_ce(logits, jnp.asarray(target), 0), upd

    (loss, upd), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"]
    )
    want = state_dict_from_flax(_np_tree({"params": grads, "batch_stats": upd["batch_stats"]}))

    model = _port_model(32, "pallas_fused")
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    model.train()
    logits = model({"image": torch.from_numpy(image).permute(0, 3, 1, 2)})
    got_loss = cross_entropy_ignore(logits, torch.from_numpy(target), 0)
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(loss), rtol=1e-5)
    for name, p in model.named_parameters():
        g, w = p.grad.numpy(), want[name].numpy()
        assert (np.abs(g - w) <= 2e-4 + 2e-3 * np.abs(w)).all(), name
    for name, buf in model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want[name].numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=name)


def _assert_params_close(got: dict, want: dict, steps: int):
    """>= 99.9% of all parameter elements within 1e-5 + 1e-3*|p|, every
    element within 2*lr*steps."""
    close = []
    for name, w in want.items():
        d = np.abs(got[name].detach().numpy() - w.numpy())
        close.append((d <= 1e-5 + 1e-3 * np.abs(w.numpy())).ravel())
        assert (d <= 2 * LR * steps).all(), name
    share = np.concatenate(close).mean()
    assert share >= 0.999, share


def _run_both(conv_impl, steps, optimizer="adam", schedule="constant", ema=False,
              ema_decay=0.0, ema_warmup=True, total_steps=0, warmup_steps=0):
    # Fixed batches (see the module docstring): after a few Adam steps the
    # element-wise criteria sit at the edge of what f32 reproduces across
    # the two frameworks, and test_step_gradients_match_at_identical_params
    # holds the step's gradient itself on the same data.
    batches = [_batch(np.random.default_rng(i), 2, 32) for i in range(steps)]
    jmodel = jax_build_model("ef_model", {"ms_image": 4}, 3, base_feat_channels=8)
    jstate = jax_state(jmodel, {"image": batches[0][0]}, lr=LR, optimizer_name=optimizer,
                       schedule=schedule, total_steps=total_steps,
                       warmup_steps=warmup_steps, ema=ema)
    start = state_dict_from_flax(_np_tree({"params": jstate.params,
                                           "batch_stats": jstate.batch_stats}))
    jstep = jax_train_step(jmodel, 0, J_NO_AUG, ema_decay=ema_decay, ema_warmup=ema_warmup)

    model = _port_model(8, conv_impl)
    tstate = create_train_state(model, start, LR, optimizer, schedule=schedule,
                                total_steps=total_steps, warmup_steps=warmup_steps, ema=ema)
    tstep = make_train_step(model, 0, T_NO_AUG, ema_decay=ema_decay, ema_warmup=ema_warmup)
    for image, target in batches:
        jstate, jlogs = jstep(jstate, {"image": jnp.asarray(image),
                                       "target": jnp.asarray(target)}, jax.random.key(0))
        tstate, tlogs = tstep(tstate, _torch_batch(image, target))
        np.testing.assert_allclose(tlogs["loss"].item(), float(jlogs["loss"]), rtol=1e-4)
        cj, ct = np.asarray(jlogs["confusion"]), tlogs["confusion"].numpy()
        assert np.abs(cj - ct).sum() / 2 <= 1e-3 * cj.sum()
    assert tstate.step == int(jstate.step) == steps
    return jmodel, jstate, tstate, batches


@pytest.mark.parametrize("conv_impl", ["xla", "pallas_fused"])
def test_three_adam_steps_match_jax(conv_impl):
    _, jstate, tstate, _ = _run_both(conv_impl, steps=3)
    want = state_dict_from_flax(_np_tree({"params": jstate.params,
                                          "batch_stats": jstate.batch_stats}))
    params = dict(tstate.model.named_parameters())
    _assert_params_close(params, {k: want[k] for k in params}, 3)
    for name, buf in tstate.model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want[name].numpy(), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


def test_step_gradients_match_at_identical_params():
    # After two steps in JAX, the port's gradient on the third batch from
    # JAX's parameters: the per-step function, free of the divergence that
    # Adam's per-element normalization builds up over steps.
    jmodel, jstate, _, _ = _run_both("pallas_fused", steps=2)
    image, target = _batch(np.random.default_rng(2), 2, 32)

    def loss_fn(params):
        logits, _ = jmodel.apply({"params": params, "batch_stats": jstate.batch_stats},
                                 {"image": jnp.asarray(image)}, train=True,
                                 mutable=["batch_stats"])
        return jax_ce(logits, jnp.asarray(target), 0)

    grads = jax.grad(loss_fn)(jstate.params)
    want = state_dict_from_flax(_np_tree({"params": grads, "batch_stats": jstate.batch_stats}))
    model = _port_model(8, "pallas_fused")
    model.load_state_dict(state_dict_from_flax(
        _np_tree({"params": jstate.params, "batch_stats": jstate.batch_stats})))
    model.train()
    logits = model({"image": torch.from_numpy(image).permute(0, 3, 1, 2)})
    cross_entropy_ignore(logits, torch.from_numpy(target), 0).backward()
    for name, p in model.named_parameters():
        g, w = p.grad.numpy(), want[name].numpy()
        assert (np.abs(g - w) <= 2e-4 + 2e-3 * np.abs(w)).all(), name


@pytest.mark.parametrize(
    "kw",
    [
        dict(optimizer="adamw", steps=1),
        dict(optimizer="sgd", steps=1),
        dict(schedule="cosine", total_steps=6, warmup_steps=2, steps=3),
        dict(ema=True, ema_decay=0.999, steps=1),
        dict(ema=True, ema_decay=0.9, ema_warmup=False, steps=2),
    ],
    ids=["adamw", "sgd", "cosine-warmup", "ema-warmup", "ema-no-warmup"],
)
def test_optimizer_variants_match_jax(kw):
    _, jstate, tstate, _ = _run_both("pallas_fused", **kw)
    steps = kw["steps"]
    want = state_dict_from_flax(_np_tree({"params": jstate.params,
                                          "batch_stats": jstate.batch_stats}))
    params = dict(tstate.model.named_parameters())
    _assert_params_close(params, {k: want[k] for k in params}, steps)
    if kw.get("ema"):
        want_ema = state_dict_from_flax(_np_tree({"params": jstate.ema_params,
                                                  "batch_stats": jstate.batch_stats}))
        _assert_params_close(tstate.ema_params, {k: want_ema[k] for k in params}, steps)


@pytest.mark.parametrize("ema", [False, True])
def test_eval_step_masks_padded_rows_like_jax(rng, ema):
    jmodel, jstate, tstate, _ = _run_both("pallas_fused", steps=1, ema=ema, ema_decay=0.9)
    image, target = _batch(rng, 3, 32)
    valid = np.asarray([True, False, True])
    want = jax_eval_step(jmodel, 0)(jstate, {"image": jnp.asarray(image),
                                             "target": jnp.asarray(target),
                                             "valid": jnp.asarray(valid)})
    assert tstate.model.training
    got = make_eval_step(tstate.model, 0)(tstate, _torch_batch(image, target, valid))
    assert tstate.model.training  # the eval step restores the mode
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-5)
    cj, ct = np.asarray(want["confusion"]), got["confusion"].numpy()
    assert cj.sum() == ct.sum() == (target[valid] != 0).sum()
    assert np.abs(cj - ct).sum() / 2 <= 1e-3 * cj.sum()


def test_train_step_augments_when_fused():
    model = _port_model(8, "xla")
    state = create_train_state(model, state_dict_from_flax(seeded_flax_variables(4, 3, 8)), LR)
    tp = TransformParams(rotate_impl="shear_pallas", rotate_likelihood=1.0)
    step = make_train_step(model, 0, tp)
    image, target = _batch(np.random.default_rng(0), 2, 32)
    state, logs = step(state, _torch_batch(image, target), torch.Generator().manual_seed(0))
    assert torch.isfinite(logs["loss"]) and state.step == 1
    assert resolve_ignore_index(-1, 3) == 2 and resolve_ignore_index(0, 3) == 0


WEIGHTS = [0.2, 1.0, 3.0]


@pytest.mark.parametrize(
    "cfg",
    [None, {"name": "ce"}, {"name": "weighted_ce", "class_weights": WEIGHTS},
     {"name": "ce_dice", "dice_weight": 0.3}, {"name": "ce_dice", "class_weights": WEIGHTS}],
    ids=["default", "ce", "weighted_ce", "ce_dice", "weighted-ce_dice"],
)
def test_loss_fn_matches_jax(rng, cfg):
    from floodplanet_code_tpu.train.fit import make_loss_fn as jax_loss_fn
    from floodplanet_code_tpu_torch.train import make_loss_fn

    logits = (rng.standard_normal((2, 9, 11, 3)) * 2).astype(np.float32)
    target = rng.choice([0, 1, 2], (2, 9, 11)).astype(np.int32)
    want = jax_loss_fn(cfg, 0)(jnp.asarray(logits), jnp.asarray(target))
    got = make_loss_fn(cfg, 0)(torch.from_numpy(np.ascontiguousarray(logits.transpose(0, 3, 1, 2))),
                               torch.from_numpy(target))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)


def test_loss_fn_rejects_what_jax_rejects():
    from floodplanet_code_tpu_torch.train import make_loss_fn

    with pytest.raises(ValueError, match="class_weights"):
        make_loss_fn({"name": "weighted_ce"}, 0)
    with pytest.raises(NotImplementedError, match="focal"):
        make_loss_fn({"name": "focal"}, 0)


@pytest.mark.parametrize("warmup", [0, 3])
def test_schedule_matches_optax(warmup):
    import optax

    from floodplanet_code_tpu_torch.train import make_schedule

    want = optax.warmup_cosine_decay_schedule(0.0 if warmup else LR, LR, warmup, 10)
    got = make_schedule(LR, "cosine", total_steps=10, warmup_steps=warmup)
    for count in range(13):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6, atol=1e-12)
    assert make_schedule(LR)(7) == LR
    with pytest.raises(NotImplementedError):
        make_schedule(LR, "step")
