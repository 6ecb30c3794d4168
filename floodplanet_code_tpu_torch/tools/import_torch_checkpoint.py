"""Import a reference (torch / PyTorch-Lightning) checkpoint (port of
``floodplanet_code_tpu/tools/import_torch_checkpoint.py``).

The reference publishes its trained models as Lightning ``.ckpt`` files
whose ``state_dict`` holds the torch UNet weights (``model.inc.double_conv
...``); late-fusion checkpoints (``encoders.<modality>...`` +
``concat_convs`` + ``decoder``) are detected from their ``encoders.`` keys.
This tool maps the state dict straight onto the port's modules and writes a
complete experiment directory: the config snapshot
(``hydra/config.yaml``), ``checkpoints/<name>/{checkpoint.pt,
metrics.json}`` and ``index.json``, so ``predict``, ``infer``, ``serve``
and the tools load an imported model exactly as a trained one.

Weight-mapping notes:
- torch and the port both keep conv kernels OIHW: they copy as they are.
- The reference's 3x3 convs carry biases; the port's are bias-free (BN
  follows at once). A conv bias ``b`` shifts BN's input by a constant, so
  it folds exactly into the BN running mean (``mean' = running_mean - b``)
  for eval.
- BatchNorm ``weight``/``bias``/``running_mean``/``running_var`` become the
  port's ``scale``/``bias``/``mean``/``var``; ``num_batches_tracked`` is
  dropped.
- The reference upsamples with ``nn.Upsample(align_corners=True)``; the
  written config pins ``model.model_kwargs.align_corners=true`` so every
  rebuild of the model reproduces it.

Usage:
    python -m floodplanet_code_tpu_torch.tools.import_torch_checkpoint \\
        path/to/model-epoch=05-val_MulticlassJaccardIndex=0.6077.ckpt \\
        --exp_dir outputs/imported_bgd --sensor S1 --eval_region Bangladesh [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import re

import torch

from floodplanet_code_tpu_torch.config import compose, save_config
from floodplanet_code_tpu_torch.models import AUX_FEATURE_KEYS, build_model
from floodplanet_code_tpu_torch.train.checkpoint import MONITOR_KEY, CheckpointManager
from floodplanet_code_tpu_torch.train.state import create_train_state

# Reference block prefix -> port module path, in reference layer order.
_ENC_BLOCKS = [
    ("inc.double_conv", "inc"),
    ("down1.maxpool_conv.1.double_conv", "down1.double_conv"),
    ("down2.maxpool_conv.1.double_conv", "down2.double_conv"),
    ("down3.maxpool_conv.1.double_conv", "down3.double_conv"),
    ("down4.maxpool_conv.1.double_conv", "down4.double_conv"),
]
_DEC_BLOCKS = [
    ("up1.conv.double_conv", "up1.double_conv"),
    ("up2.conv.double_conv", "up2.double_conv"),
    ("up3.conv.double_conv", "up3.double_conv"),
    ("up4.conv.double_conv", "up4.double_conv"),
]
# Within a reference DoubleConv Sequential: [0]=conv, [1]=bn, [3]=conv, [4]=bn.
_PAIRS = [("0", "1", "conv0", "bn0"), ("3", "4", "conv1", "bn1")]


def load_state_dict(ckpt_path: str) -> dict:
    """Raw torch state dict (f32 CPU tensors) from a Lightning .ckpt or a
    bare torch save, read as the JAX package's tool reads it."""
    blob = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    state = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    return {k: v.detach().cpu() for k, v in state.items()}


def _make_get(state: dict, what: str):
    prefix = "model." if any(k.startswith("model.") for k in state) else ""

    def get(key: str) -> torch.Tensor:
        try:
            return state[prefix + key]
        except KeyError:
            raise KeyError(
                f'checkpoint key "{prefix + key}" not found — is this a reference {what} '
                "checkpoint?"
            )

    return get, prefix


def _convert_double_conv(get, out: dict, tprefix: str, pprefix: str) -> None:
    """One reference DoubleConv Sequential -> the port's DoubleConv."""
    for conv_i, bn_i, conv, bn in _PAIRS:
        out[f"{pprefix}.{conv}.weight"] = get(f"{tprefix}.{conv_i}.weight").float()
        out[f"{pprefix}.{bn}.scale"] = get(f"{tprefix}.{bn_i}.weight").float()
        out[f"{pprefix}.{bn}.bias"] = get(f"{tprefix}.{bn_i}.bias").float()
        # Fold the conv bias into the BN running mean (see module doc).
        out[f"{pprefix}.{bn}.mean"] = (get(f"{tprefix}.{bn_i}.running_mean").float()
                                       - get(f"{tprefix}.{conv_i}.bias").float())
        out[f"{pprefix}.{bn}.var"] = get(f"{tprefix}.{bn_i}.running_var").float()


def _convert_decoder(get, out: dict, tprefix: str, pprefix: str) -> int:
    for tblock, pblock in _DEC_BLOCKS:
        _convert_double_conv(get, out, tprefix + tblock, pprefix + pblock)
    head = get(f"{tprefix}outc.conv.weight").float()  # [n_classes, 64, 1, 1]
    out[f"{pprefix}outc.weight"] = head
    out[f"{pprefix}outc.bias"] = get(f"{tprefix}outc.conv.bias").float()
    return int(head.shape[0])


def convert_unet_state_dict(state: dict) -> tuple[dict, int, int]:
    """Reference UNet state dict -> (the port's early-fusion state dict,
    in_channels, n_classes). Keys with or without the Lightning wrapper's
    ``model.`` prefix."""
    get, _ = _make_get(state, "WaterSegmentationModel/UNet")
    out: dict = {}
    for tblock, pblock in _ENC_BLOCKS:
        _convert_double_conv(get, out, tblock, f"unet.encoder.{pblock}")
    n_classes = _convert_decoder(get, out, "", "unet.decoder.")
    return out, int(get("inc.double_conv.0.weight").shape[1]), n_classes


def convert_lf_state_dict(state: dict) -> tuple[dict, dict, int]:
    """Reference LateFusionModel state dict -> (the port's state dict,
    in_channels dict, n_classes).

    Reference tree: ``encoders.<modality>`` UNetEncoders, ``concat_convs.<i>``
    1x1 fusing convs, ``decoder``. The port's LateFusionModel has the same
    names; its encoders go in ``ms_image``-then-``AUX_FEATURE_KEYS`` order,
    the reference's concatenation order.
    """
    get, prefix = _make_get(state, "LateFusionModel")
    present = {
        k[len(prefix) + len("encoders."):].split(".")[0]
        for k in state
        if k.startswith(prefix + "encoders.")
    }
    modalities = [m for m in ("ms_image", *AUX_FEATURE_KEYS) if m in present]
    unknown = present - set(modalities)
    if unknown:
        raise KeyError(f"unrecognized late-fusion modalities: {sorted(unknown)}")

    out: dict = {}
    in_channels: dict = {}
    for mod in modalities:
        for tblock, pblock in _ENC_BLOCKS:
            _convert_double_conv(get, out, f"encoders.{mod}.{tblock}", f"encoders.{mod}.{pblock}")
        in_channels[mod] = int(get(f"encoders.{mod}.inc.double_conv.0.weight").shape[1])
    n_fuse = len([k for k in state
                  if k.startswith(prefix + "concat_convs.") and k.endswith(".weight")])
    for i in range(n_fuse):
        out[f"concat_convs.{i}.weight"] = get(f"concat_convs.{i}.weight").float()
        out[f"concat_convs.{i}.bias"] = get(f"concat_convs.{i}.bias").float()
    n_classes = _convert_decoder(get, out, "decoder.", "decoder.")
    return out, in_channels, n_classes


def import_checkpoint(
    ckpt_path: str,
    exp_dir: str,
    sensor: str = "S1",
    eval_region: str | None = None,
    model_name: str = "ef_model",
    overrides: list[str] | None = None,
    device="cuda",
) -> str:
    """Write a full experiment dir from a reference checkpoint; returns the
    checkpoint entry's path (feed it to predict/infer). Raises without a
    card unless ``device="cpu"``."""
    state_dict = load_state_dict(ckpt_path)
    if any(k.split("model.", 1)[-1].startswith("encoders.") for k in state_dict):
        converted, in_channels, n_classes = convert_lf_state_dict(state_dict)
        model_name = "lf_model"
    else:
        converted, c_in, n_classes = convert_unet_state_dict(state_dict)
        in_channels = {"ms_image": c_in}

    cfg = compose(overrides=[
        f"dataset.sensor={sensor}",
        f"model={model_name}",
        *([f"eval_region={eval_region}"] if eval_region else []),
        *(overrides or []),
    ])
    # Pin the reference's upsampling convention for every later rebuild.
    kwargs = dict(cfg.model.get("model_kwargs") or {})
    kwargs["align_corners"] = True
    cfg.model["model_kwargs"] = kwargs

    # Built as every later load builds it, from the written model_kwargs.
    model = build_model(model_name, in_channels, n_classes, dtype=torch.float32, device=device,
                        **kwargs)
    expect = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in converted.items()}
    if expect != got:
        raise ValueError(
            "converted state dict does not match the model's: "
            f"expected {expect}\ngot {got}"
        )
    model.load_state_dict(converted, strict=True)
    state = create_train_state(model, None, lr=cfg.lr, optimizer_name=cfg.optimizer)

    os.makedirs(exp_dir, exist_ok=True)
    save_config(cfg, exp_dir)
    # Carry the source checkpoint's epoch/metric through to the entry's name.
    m = re.search(r"epoch=(\d+)", os.path.basename(ckpt_path))
    epoch = int(m.group(1)) if m else 0
    m = re.search(r"=(\d*\.\d+)", os.path.basename(ckpt_path))
    metric = float(m.group(1)) if m else 0.0
    manager = CheckpointManager(exp_dir, save_top_k=1, async_save=False)
    path = manager.save(state, epoch,
                        {MONITOR_KEY: metric, "imported_from": os.path.abspath(ckpt_path)})
    print(f"imported: {path}")
    return path


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("ckpt_path")
    parser.add_argument("--exp_dir", required=True)
    parser.add_argument("--sensor", default="S1")
    parser.add_argument("--eval_region", default=None)
    parser.add_argument("--model", default="ef_model")
    parser.add_argument("--override", action="append", default=[], help="extra cfg overrides")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    return import_checkpoint(
        args.ckpt_path,
        args.exp_dir,
        sensor=args.sensor,
        eval_region=args.eval_region,
        model_name=args.model,
        overrides=args.override,
        device=args.device,
    )


if __name__ == "__main__":
    main()
