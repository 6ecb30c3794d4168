"""Weights bridge: the JAX package's flax variables -> the port's state dict.

``state_dict_from_flax(variables)`` takes the ``{"params", "batch_stats"}``
tree of a flax ``WaterSegModel``/``EarlyFusionModel``/``LateFusionModel``
(as ``model.init`` or ``load_model_for_eval`` return it, leaves as numpy
arrays) and returns a state dict that the port's model of the same
configuration loads with ``strict=True``:

- 3x3 conv kernels HWIO -> OIHW (bias-free, models/unet.py:152);
- BatchNorm ``scale``/``bias`` params and ``mean``/``var`` statistics, 1:1;
- the 1x1 head's ``kernel`` (HWIO -> OIHW) and ``bias``;
- late fusion: ``encoder_<modality>/...`` -> ``encoders.<modality>.``,
  ``concat_conv_<level>/{kernel,bias}`` -> ``concat_convs.<level>.`` and
  ``UNetDecoder_0/...`` -> ``decoder.`` (flax's names, models/water_seg.py
  there).

``save_weights``/``load_weights`` keep such a dict in one ``torch.save``
file, the weights file that ``inference/infer.py`` reads. Reading an orbax
checkpoint needs JAX, so a JAX-trained model crosses over as: restore with
the JAX package, ``state_dict_from_flax``, ``save_weights``.

``seeded_flax_variables`` makes a flax-layout tree from a numpy seed (the
same structure and shapes ``model.init`` gives), for runs that need
full-width weights without JAX.

``example_transformer_state_dict(params)`` carries the flax
``ExampleTileTransformer``'s ``params`` to the port's
``models/example_transformer.py``.
"""

from __future__ import annotations

import numpy as np
import torch

# (flax path under the encoder or decoder, port module path under it, and
# the block's (in, mid, out) widths in units of the base width; None =
# input).
_ENCODER_BLOCKS = [
    ("DoubleConv_0", "inc", (None, 1, 1)),
    ("Down_0/DoubleConv_0", "down1.double_conv", (1, 2, 2)),
    ("Down_1/DoubleConv_0", "down2.double_conv", (2, 4, 4)),
    ("Down_2/DoubleConv_0", "down3.double_conv", (4, 8, 8)),
    ("Down_3/DoubleConv_0", "down4.double_conv", (8, 8, 8)),
]
_DECODER_BLOCKS = [
    ("Up_0/DoubleConv_0", "up1.double_conv", (16, 8, 4)),
    ("Up_1/DoubleConv_0", "up2.double_conv", (8, 4, 2)),
    ("Up_2/DoubleConv_0", "up3.double_conv", (4, 2, 1)),
    ("Up_3/DoubleConv_0", "up4.double_conv", (2, 1, 1)),
]
# Within a DoubleConv: flax conv, flax BN -> port conv, port BN.
_PAIRS = [("Conv_0", "BatchNorm_0", "conv0", "bn0"),
          ("Conv_1", "BatchNorm_1", "conv1", "bn1")]
_HEAD = ("Conv_0", "outc")  # under the decoder
# The late-fusion model's per-level fused widths, in units of the base width.
_LEVEL_WIDTHS = (1, 2, 4, 8, 8)
_LF_DECODER = "UNetDecoder_0"


def _node(tree: dict, path: str):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def _tensor(value, transpose=None) -> torch.Tensor:
    arr = np.asarray(value, dtype=np.float32)
    if transpose is not None:
        arr = arr.transpose(transpose)
    return torch.from_numpy(np.ascontiguousarray(arr))


def _blocks_to_state(state: dict, params: dict, stats: dict, blocks, prefix: str) -> None:
    for fpath, tpath, _ in blocks:
        p, s = _node(params, fpath), _node(stats, fpath)
        for conv, bn, tconv, tbn in _PAIRS:
            state[f"{prefix}{tpath}.{tconv}.weight"] = _tensor(p[conv]["kernel"], (3, 2, 0, 1))
            state[f"{prefix}{tpath}.{tbn}.scale"] = _tensor(p[bn]["scale"])
            state[f"{prefix}{tpath}.{tbn}.bias"] = _tensor(p[bn]["bias"])
            state[f"{prefix}{tpath}.{tbn}.mean"] = _tensor(s[bn]["mean"])
            state[f"{prefix}{tpath}.{tbn}.var"] = _tensor(s[bn]["var"])


def _decoder_to_state(state: dict, params: dict, stats: dict, prefix: str) -> None:
    _blocks_to_state(state, params, stats, _DECODER_BLOCKS, prefix)
    head = params[_HEAD[0]]
    state[f"{prefix}{_HEAD[1]}.weight"] = _tensor(head["kernel"], (3, 2, 0, 1))
    state[f"{prefix}{_HEAD[1]}.bias"] = _tensor(head["bias"])


def state_dict_from_flax(
    variables: dict, root: str = "UNet_0", prefix: str = "unet."
) -> dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` -> the port's state dict.

    A tree with ``concat_conv_*`` entries at its top is a late-fusion
    model's (``root`` and ``prefix`` unused); any other is a UNet's under
    ``root``, mapped under ``prefix``.
    """
    params, stats = variables["params"], variables["batch_stats"]
    state: dict[str, torch.Tensor] = {}
    if any(name.startswith("concat_conv_") for name in params):
        for name in params:
            if name.startswith("encoder_"):
                modality = name[len("encoder_"):]
                _blocks_to_state(state, params[name], stats[name], _ENCODER_BLOCKS,
                                 f"encoders.{modality}.")
        for level in range(len(_LEVEL_WIDTHS)):
            conv = params[f"concat_conv_{level}"]
            state[f"concat_convs.{level}.weight"] = _tensor(conv["kernel"], (3, 2, 0, 1))
            state[f"concat_convs.{level}.bias"] = _tensor(conv["bias"])
        _decoder_to_state(state, params[_LF_DECODER], stats[_LF_DECODER], "decoder.")
        return state
    params, stats = params[root], stats[root]
    _blocks_to_state(state, params["encoder"], stats["encoder"], _ENCODER_BLOCKS,
                     f"{prefix}encoder.")
    _decoder_to_state(state, params["decoder"], stats["decoder"], f"{prefix}decoder.")
    return state


def seeded_flax_variables(
    in_channels,
    n_classes: int,
    base_feat_channels: int = 64,
    seed: int = 0,
    root: str = "UNet_0",
) -> dict:
    """A flax-layout variable tree of numpy f32 arrays from ``seed``.

    ``in_channels``: an int gives a UNet's tree under ``root`` (the plain
    and early-fusion models); a modality -> channel-count dict gives the
    late-fusion model's (one encoder per modality, in its order). Kernels
    are lecun-normal (std sqrt(1/fan_in)), the biases small, and the
    BatchNorm parameters and running statistics are drawn away from their
    1/0 init so the fold is exercised.
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

    def blocks(base_path, block_list, c_first):
        for fpath, _, widths in block_list:
            c_in, mid, out = (c_first if w is None else w * bfc for w in widths)
            for (conv, bn, _, _), (ci, co) in zip(_PAIRS, ((c_in, mid), (mid, out))):
                path = f"{base_path}/{fpath}"
                put(params, f"{path}/{conv}/kernel", kernel(3, ci, co))
                put(params, f"{path}/{bn}/scale", rng.uniform(0.8, 1.2, co))
                put(params, f"{path}/{bn}/bias", 0.1 * rng.standard_normal(co))
                put(stats, f"{path}/{bn}/mean", 0.1 * rng.standard_normal(co))
                put(stats, f"{path}/{bn}/var", rng.uniform(0.5, 1.5, co))

    def decoder(base_path):
        blocks(base_path, _DECODER_BLOCKS, None)
        put(params, f"{base_path}/{_HEAD[0]}/kernel", kernel(1, bfc, n_classes))
        put(params, f"{base_path}/{_HEAD[0]}/bias", 0.1 * rng.standard_normal(n_classes))

    if isinstance(in_channels, dict):
        for modality, c in in_channels.items():
            blocks(f"encoder_{modality}", _ENCODER_BLOCKS, c)
        for level, w in enumerate(_LEVEL_WIDTHS):
            width = w * bfc
            put(params, f"concat_conv_{level}/kernel",
                kernel(1, width * len(in_channels), width))
            put(params, f"concat_conv_{level}/bias", 0.1 * rng.standard_normal(width))
        decoder(_LF_DECODER)
    else:
        blocks(f"{root}/encoder", _ENCODER_BLOCKS, in_channels)
        decoder(f"{root}/decoder")
    return {"params": params, "batch_stats": stats}


def example_transformer_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """The flax ``ExampleTileTransformer``'s ``params`` -> the port's state
    dict: the patch conv HWIO -> OIHW; Dense kernels [in, out] -> Linear
    [out, in]; the attention's ``DenseGeneral`` kernels [d, heads, head_dim]
    (query, key, value) and [heads, head_dim, d] (out) flattened over the
    heads first; LayerNorm ``scale`` -> ``weight``."""
    state = {"special_token": _tensor(params["special_token"]),
             "embed.weight": _tensor(params["Conv_0"]["kernel"], (3, 2, 0, 1)),
             "embed.bias": _tensor(params["Conv_0"]["bias"])}
    n_layers = sum(1 for name in params if name.startswith("EncoderBlock_"))
    for i in range(n_layers):
        block, prefix = params[f"EncoderBlock_{i}"], f"blocks.{i}."
        for flax_name, port in (("LayerNorm_0", "norm0"), ("LayerNorm_1", "norm1")):
            state[prefix + port + ".weight"] = _tensor(block[flax_name]["scale"])
            state[prefix + port + ".bias"] = _tensor(block[flax_name]["bias"])
        for flax_name, port in (("Dense_0", "mlp0"), ("Dense_1", "mlp1")):
            state[prefix + port + ".weight"] = _tensor(block[flax_name]["kernel"], (1, 0))
            state[prefix + port + ".bias"] = _tensor(block[flax_name]["bias"])
        attn = block["MultiHeadDotProductAttention_0"]
        for name in ("query", "key", "value"):
            kernel = np.asarray(attn[name]["kernel"], np.float32)
            state[f"{prefix}{name}.weight"] = _tensor(kernel.reshape(kernel.shape[0], -1), (1, 0))
            state[f"{prefix}{name}.bias"] = _tensor(np.asarray(attn[name]["bias"]).reshape(-1))
        kernel = np.asarray(attn["out"]["kernel"], np.float32)
        state[prefix + "out.weight"] = _tensor(kernel.reshape(-1, kernel.shape[-1]), (1, 0))
        state[prefix + "out.bias"] = _tensor(attn["out"]["bias"])
    return state


def save_weights(state_dict: dict, path: str) -> None:
    """Write a state dict (CPU copies) to ``path`` with ``torch.save``."""
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path)


def load_weights(path: str) -> dict[str, torch.Tensor]:
    """Read a weights file written by ``save_weights`` (tensors only)."""
    return torch.load(path, map_location="cpu", weights_only=True)
