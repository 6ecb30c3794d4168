"""Weights bridge: the JAX package's flax variables -> the port's state dict.

``state_dict_from_flax(variables)`` takes the ``{"params", "batch_stats"}``
tree of a flax ``WaterSegModel``/``EarlyFusionModel`` (as ``model.init``
or ``load_model_for_eval`` return it, leaves as numpy arrays) and returns a
state dict that the port's model of the same configuration loads with
``strict=True``:

- 3x3 conv kernels HWIO -> OIHW (bias-free, models/unet.py:152);
- BatchNorm ``scale``/``bias`` params and ``mean``/``var`` statistics, 1:1;
- the 1x1 head's ``kernel`` (HWIO -> OIHW) and ``bias``.

``save_weights``/``load_weights`` keep such a dict in one ``torch.save``
file, the weights file that ``inference/infer.py`` reads. Reading an orbax
checkpoint needs JAX, so a JAX-trained model crosses over as: restore with
the JAX package, ``state_dict_from_flax``, ``save_weights``.

``seeded_flax_variables`` makes a flax-layout tree from a numpy seed (the
same structure and shapes ``model.init`` gives), for runs that need
full-width weights without JAX.
"""

from __future__ import annotations

import numpy as np
import torch

# (flax path under the UNet root, port module path under ``unet.``, and the
# block's (in, mid, out) widths in units of the base width; None = input).
_BLOCKS = [
    ("encoder/DoubleConv_0", "encoder.inc", (None, 1, 1)),
    ("encoder/Down_0/DoubleConv_0", "encoder.down1.double_conv", (1, 2, 2)),
    ("encoder/Down_1/DoubleConv_0", "encoder.down2.double_conv", (2, 4, 4)),
    ("encoder/Down_2/DoubleConv_0", "encoder.down3.double_conv", (4, 8, 8)),
    ("encoder/Down_3/DoubleConv_0", "encoder.down4.double_conv", (8, 8, 8)),
    ("decoder/Up_0/DoubleConv_0", "decoder.up1.double_conv", (16, 8, 4)),
    ("decoder/Up_1/DoubleConv_0", "decoder.up2.double_conv", (8, 4, 2)),
    ("decoder/Up_2/DoubleConv_0", "decoder.up3.double_conv", (4, 2, 1)),
    ("decoder/Up_3/DoubleConv_0", "decoder.up4.double_conv", (2, 1, 1)),
]
# Within a DoubleConv: flax conv, flax BN -> port conv, port BN.
_PAIRS = [("Conv_0", "BatchNorm_0", "conv0", "bn0"),
          ("Conv_1", "BatchNorm_1", "conv1", "bn1")]
_HEAD = ("decoder/Conv_0", "decoder.outc")


def _node(tree: dict, path: str):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def _tensor(value, transpose=None) -> torch.Tensor:
    arr = np.asarray(value, dtype=np.float32)
    if transpose is not None:
        arr = arr.transpose(transpose)
    return torch.from_numpy(np.ascontiguousarray(arr))


def state_dict_from_flax(
    variables: dict, root: str = "UNet_0", prefix: str = "unet."
) -> dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` -> the port's UNet state dict."""
    params = variables["params"][root]
    stats = variables["batch_stats"][root]
    state = {}
    for fpath, tpath, _ in _BLOCKS:
        p, s = _node(params, fpath), _node(stats, fpath)
        for conv, bn, tconv, tbn in _PAIRS:
            state[f"{prefix}{tpath}.{tconv}.weight"] = _tensor(
                p[conv]["kernel"], (3, 2, 0, 1)
            )
            state[f"{prefix}{tpath}.{tbn}.scale"] = _tensor(p[bn]["scale"])
            state[f"{prefix}{tpath}.{tbn}.bias"] = _tensor(p[bn]["bias"])
            state[f"{prefix}{tpath}.{tbn}.mean"] = _tensor(s[bn]["mean"])
            state[f"{prefix}{tpath}.{tbn}.var"] = _tensor(s[bn]["var"])
    head = _node(params, _HEAD[0])
    state[f"{prefix}{_HEAD[1]}.weight"] = _tensor(head["kernel"], (3, 2, 0, 1))
    state[f"{prefix}{_HEAD[1]}.bias"] = _tensor(head["bias"])
    return state


def seeded_flax_variables(
    in_channels: int,
    n_classes: int,
    base_feat_channels: int = 64,
    seed: int = 0,
    root: str = "UNet_0",
) -> dict:
    """A flax-layout variable tree of numpy f32 arrays from ``seed``.

    Kernels are lecun-normal (std sqrt(1/fan_in)), the head bias is small,
    and the BatchNorm parameters and running statistics are drawn away from
    their 1/0 init so the fold is exercised.
    """
    rng = np.random.default_rng(seed)
    bfc = base_feat_channels
    params: dict = {}
    stats: dict = {}

    def put(tree, path, value):
        node = tree
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value.astype(np.float32)

    def kernel(k, c_in, c_out):
        return rng.standard_normal((k, k, c_in, c_out)) / np.sqrt(k * k * c_in)

    for fpath, _, widths in _BLOCKS:
        c_in, mid, out = (in_channels if w is None else w * bfc for w in widths)
        for (conv, bn, _, _), (ci, co) in zip(_PAIRS, ((c_in, mid), (mid, out))):
            put(params, f"{root}/{fpath}/{conv}/kernel", kernel(3, ci, co))
            put(params, f"{root}/{fpath}/{bn}/scale", rng.uniform(0.8, 1.2, co))
            put(params, f"{root}/{fpath}/{bn}/bias", 0.1 * rng.standard_normal(co))
            put(stats, f"{root}/{fpath}/{bn}/mean", 0.1 * rng.standard_normal(co))
            put(stats, f"{root}/{fpath}/{bn}/var", rng.uniform(0.5, 1.5, co))
    put(params, f"{root}/{_HEAD[0]}/kernel", kernel(1, bfc, n_classes))
    put(params, f"{root}/{_HEAD[0]}/bias", 0.1 * rng.standard_normal(n_classes))
    return {"params": params, "batch_stats": stats}


def save_weights(state_dict: dict, path: str) -> None:
    """Write a state dict (CPU copies) to ``path`` with ``torch.save``."""
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path)


def load_weights(path: str) -> dict[str, torch.Tensor]:
    """Read a weights file written by ``save_weights`` (tensors only)."""
    return torch.load(path, map_location="cpu", weights_only=True)
