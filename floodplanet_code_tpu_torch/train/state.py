"""Train state: the port of ``floodplanet_code_tpu/train/state.py``.

The JAX package keeps params, BatchNorm statistics and the optax state in
one immutable pytree. Here the model holds its parameters and running
statistics, the optimizer its moments; ``TrainState`` bundles them with
the update count, the learning-rate schedule and the optional EMA copy of
the parameters, and the train step updates all of it in place.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]  # update count (from 0) -> learning rate
    step: int = 0  # completed optimizer updates
    # Exponential moving average of the parameters (name -> tensor), or
    # None; evaluation prefers it when present.
    ema_params: dict[str, torch.Tensor] | None = None


def ema_decay_at(step, decay: float) -> torch.Tensor:
    """Horizon-warmed EMA decay ``min(decay, (1 + t) / (10 + t))`` in f32;
    ``step`` counts completed updates (1 at the first) (state.py:31-51)."""
    t = torch.tensor(float(step), dtype=torch.float32)
    return torch.minimum(torch.tensor(decay, dtype=torch.float32), (1.0 + t) / (10.0 + t))


def make_schedule(
    lr: float, schedule: str = "constant", total_steps: int = 0, warmup_steps: int = 0
) -> Callable[[int], float]:
    """``'constant'``, or optax's ``warmup_cosine_decay_schedule`` (linear
    warmup from 0 over ``warmup_steps``, cosine decay to 0 at
    ``total_steps``) as state.py:69-78 builds it. The update with count t
    (from 0) uses schedule(t)."""
    if schedule == "constant":
        return lambda count: lr
    if schedule != "cosine":
        raise NotImplementedError(f"No implementation for lr schedule of name: {schedule}")
    if total_steps <= 0:
        raise ValueError("cosine schedule needs total_steps > 0")
    init = 0.0 if warmup_steps else lr
    decay_steps = max(total_steps, warmup_steps + 1) - warmup_steps

    def rate(count: int) -> float:
        if warmup_steps > 0 and count < warmup_steps:
            return (init - lr) * (1 - count / warmup_steps) + lr
        c = min(count - warmup_steps, decay_steps)
        return lr * 0.5 * (1 + math.cos(math.pi * c / decay_steps))

    return rate


def build_optimizer(
    params,
    optimizer_name: str,
    lr: float,
    schedule: str = "constant",
    total_steps: int = 0,
    warmup_steps: int = 0,
) -> tuple[torch.optim.Optimizer, Callable[[int], float]]:
    """(optimizer, schedule) as state.py:54-91 builds the optax chain:
    adam -> Adam, adamw -> AdamW(weight_decay=1e-4) (optax's default),
    sgd -> SGD(momentum=0.9), with optax's betas and eps; Adam is the fused
    CUDA one when every parameter is on a card. The train step sets each
    update's learning rate from the schedule."""
    params = list(params)
    rate = make_schedule(lr, schedule, total_steps, warmup_steps)
    if optimizer_name == "adam":
        fused = all(p.is_cuda for p in params) or None
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, fused=fused)
    elif optimizer_name == "adamw":
        opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4)
    elif optimizer_name == "sgd":
        opt = torch.optim.SGD(params, lr=lr, momentum=0.9)
    else:
        raise NotImplementedError(
            f"No implementation for optimizer of name: {optimizer_name}"
        )
    return opt, rate


# flax's truncated-normal variance scaling divides by the standard
# deviation of a unit normal truncated to [-2, 2] (jax.nn.initializers).
_TRUNCATED_STD = 0.87962566103423978


def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Set ``model`` to the JAX package's initial values and return it.

    Every conv kernel is flax's ``lecun_normal``: a unit normal truncated to
    [-2, 2], times ``sqrt(1 / fan_in) / 0.8796...`` (models/unet.py:108
    there); BatchNorm scale 1, bias 0, mean 0, var 1 (:52-58); the head's
    bias 0. The draws come from a CPU ``torch.Generator`` seeded with
    ``seed``, in ``named_parameters`` order, so a seed gives the same
    weights on every device; they are not ``jax.random``'s draws.
    """
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 4:  # conv kernel [out, in, kh, kw]
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
                w = torch.empty(p.shape, dtype=torch.float32)
                nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
                p.copy_(w * (math.sqrt(1.0 / fan_in) / _TRUNCATED_STD))
            elif name.endswith(".scale"):
                p.fill_(1.0)
            else:  # BatchNorm and head biases
                p.zero_()
        for name, b in model.named_buffers():
            if name.endswith(".var"):
                b.fill_(1.0)
            else:
                b.zero_()
    return model


def create_train_state(
    model: nn.Module,
    state_dict: dict | None,
    lr: float,
    optimizer_name: str = "adam",
    schedule: str = "constant",
    total_steps: int = 0,
    warmup_steps: int = 0,
    ema: bool = False,
) -> TrainState:
    """Wrap ``model`` for training (put in train mode).

    ``state_dict`` (the weights bridge's, ``tools/import_jax_params.py``)
    is loaded strictly first when given; otherwise the model keeps the
    weights it has (``init_weights`` sets the JAX package's initial
    values). ``ema=True`` seeds ``ema_params`` with a copy of the
    parameters.
    """
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    model.train()
    optimizer, rate = build_optimizer(
        model.parameters(), optimizer_name, lr, schedule, total_steps, warmup_steps
    )
    ema_params = (
        {n: p.detach().clone() for n, p in model.named_parameters()} if ema else None
    )
    return TrainState(model=model, optimizer=optimizer, schedule=rate,
                      ema_params=ema_params)
