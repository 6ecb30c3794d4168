"""What every model's plain reference shares, and nothing of any one model:
float32 arithmetic on a card, the masked cross entropy, the optimizer's
steps, the served probabilities (with the eight dihedral transforms), and
the two roundings that stand for narrower types.

``torch`` operations only; no kernel, cache or batching of the system runs
here.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def no_tf32():
    """float32 matmuls and convolutions in float32 (not TF32) inside."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn


def cross_entropy(logits, target, ignore_index: int):
    """Mean cross entropy over the pixels whose target is a class other than
    ``ignore_index`` (targets outside [0, n_classes) count for nothing)."""
    n_classes = logits.shape[1]
    valid = (target != ignore_index) & (target >= 0) & (target < n_classes)
    logp = torch.log_softmax(logits, dim=1)
    picked = logp.gather(1, target.clamp(0, n_classes - 1).long()[:, None])[:, 0]
    return -(picked * valid).sum() / valid.sum().clamp_min(1)


def adam_steps(forward, config: dict, weights: dict, stats: set, batches: list,
               ignore_index: int) -> dict:
    """Steps of the masked cross entropy, one per (image NCHW, target) of
    ``batches``, from ``weights``, under the configuration's ``optimizer``
    at its ``lr``: ``adam`` (betas 0.9, 0.999, eps 1e-8, bias-corrected,
    no weight decay); any other optimizer raises.

    ``forward(tensors, image) -> (logits, running)``: the network in train
    mode over the parameters and the running statistics, and the running
    statistics' new values. ``stats``: the names in ``weights`` that are
    running statistics, not parameters. Returns each step's loss, the first
    step's gradients, and the parameters and running statistics after the
    last step."""
    optimizer, lr = config["optimizer"], float(config["lr"])
    if optimizer != "adam":
        raise ValueError(f"no reference for optimizer {optimizer!r}")
    params = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()
              if k not in stats}
    running = {k: weights[k].detach().clone() for k in stats}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first_grads = [], None
    for t, (image, target) in enumerate(batches, start=1):
        logits, new_running = forward({**params, **running}, image)
        loss = cross_entropy(logits, target, ignore_index)
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        running.update(new_running)
        with torch.no_grad():
            if first_grads is None:
                first_grads = {k: g.clone() for k, g in zip(params, grads)}
            for (k, p), g in zip(params.items(), grads):
                m[k].mul_(0.9).add_(g, alpha=0.1)
                v2[k].mul_(0.999).addcmul_(g, g, value=0.001)
                step = lr / (1 - 0.9 ** t)
                denom = (v2[k] / (1 - 0.999 ** t)).sqrt().add_(1e-8)
                p.addcdiv_(m[k], denom, value=-step)
    after = {k: v.detach() for k, v in params.items()}
    after.update(running)
    return {"losses": losses, "first_grads": first_grads, "after": after}


def probabilities(net, image, tta: bool):
    """Softmax [B, H, W, n_classes] of ``net(image)`` (logits NCHW);
    ``tta``: the mean over the eight dihedral transforms of a square input,
    each mapped back."""
    if not tta:
        return torch.softmax(net(image), dim=1).permute(0, 2, 3, 1)
    total = 0
    for t in (False, True):
        for fh in (False, True):
            for fw in (False, True):
                x = image.transpose(2, 3) if t else image
                x = x.flip(2) if fh else x
                x = x.flip(3) if fw else x
                p = torch.softmax(net(x), dim=1)
                p = p.flip(2) if fh else p
                p = p.flip(3) if fw else p
                total = total + (p.transpose(2, 3) if t else p)
    return (total / 8).permute(0, 2, 3, 1)


def bf16_round(x):
    """Round to bfloat16 and back; gradients pass straight through."""
    return x + (x.to(torch.bfloat16).to(x.dtype) - x).detach()


def fp8_quant(x):
    """Round to float8 e4m3 with one scale per tensor (its largest magnitude
    to 448, e4m3's largest finite value), back to float32."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / 448.0
    q = (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()  # the rounding passes gradients straight through
