"""Export a trained checkpoint's predict step as a self-contained program
(port of ``floodplanet_code_tpu/tools/export_model.py``).

``torch.export`` traces the sliding-window predict step (forward +
softmax, optionally dihedral TTA; ``inference/sliding.py::predict_probs``)
of the restored model into an ``ExportedProgram`` with the weights inside,
written with ``torch.export.save``. The fused conv runs in it as the
custom op ``floodplanet::relu_affine_conv3x3`` (ops/conv_fused.py), with
its folded and packed operands frozen from the loaded weights into the
program (``models/unet.py::DoubleConv.freeze_fused_operands``), as the JAX
artifact carries its weights as constants.

The program takes the JAX artifact's inputs, a dict of NHWC f32 ``image``
plus any auxiliary planes at a fixed batch and tile, and returns the
softmax probabilities [batch, height, width, n_classes] the stitcher
expects. A program exported on the card holds card tensors: export on the
device it is to run on (``--device``).

Layout: ``<out>.pt2`` (the program) plus the ``<out>.json`` manifest
(input names/shapes/dtypes, n_classes, provenance, conv_impl) so a server
can validate feeds without loading the program.

Usage:
    python -m floodplanet_code_tpu_torch.tools.export_model <checkpoint> \\
        [--batch_size 8] [--height H] [--width W] [--tta] [--out PATH] [--device cpu]

Reload with :func:`load_exported`; its call matches
``inference.sliding.make_predict_step``'s output.
"""

from __future__ import annotations

import argparse
import json
import os

import torch
from torch import nn

from floodplanet_code_tpu_torch.config import load_experiment_config
from floodplanet_code_tpu_torch.device import resolve_device
from floodplanet_code_tpu_torch.inference.infer import (
    build_experiment_dataset,
    load_model_for_eval,
)
from floodplanet_code_tpu_torch.inference.sliding import predict_probs
from floodplanet_code_tpu_torch.models import resolve_compute_dtype, resolve_conv_impl
from floodplanet_code_tpu_torch.models.unet import DoubleConv

ARTIFACT_SUFFIX = ".pt2"


def _batch_key(channel_key: str) -> str:
    return "image" if channel_key == "ms_image" else channel_key


class PredictStep(nn.Module):
    """The predict step as a module: a dict of NHWC inputs -> [B, H, W,
    n_classes] probabilities (``predict_probs`` on their NCHW views)."""

    def __init__(self, model: nn.Module, tta: bool = False):
        super().__init__()
        self.model = model
        self.tta = tta

    def forward(self, batch: dict) -> torch.Tensor:
        return predict_probs(self.model, {k: v.permute(0, 3, 1, 2) for k, v in batch.items()},
                             self.tta)


def export_checkpoint(
    checkpoint_path: str,
    out_path: str | None = None,
    batch_size: int = 8,
    height: int | None = None,
    width: int | None = None,
    tta: bool = False,
    eval_dataset_name: str | None = None,
    eval_dataset_split: str = "test",
    device="cuda",
) -> dict:
    """Export ``checkpoint_path``; returns the manifest dict.

    Tile height/width default to the experiment's crop size. The dataset
    (its split under the experiment's config) gives the input channels and
    classes. Raises without a card unless ``device="cpu"``.
    """
    device = resolve_device(device)
    experiment_dir = os.path.dirname(os.path.dirname(os.path.normpath(checkpoint_path)))
    cfg = load_experiment_config(experiment_dir)
    height = int(height or cfg.crop_height)
    width = int(width or cfg.crop_width)
    dataset = build_experiment_dataset(cfg, eval_dataset_split, eval_dataset_name)
    model = load_model_for_eval(cfg, checkpoint_path, dataset, device)
    conv_impl = resolve_conv_impl(cfg)
    for module in model.modules():
        if isinstance(module, DoubleConv) and module.fused_pair:
            module.freeze_fused_operands(resolve_compute_dtype(cfg))

    inputs = {
        _batch_key(key): torch.zeros((batch_size, height, width, ch), dtype=torch.float32,
                                     device=device)
        for key, ch in dataset.n_channels.items()
    }
    with torch.no_grad():
        program = torch.export.export(PredictStep(model, tta).eval(), (inputs,))
    # Not the tracing inputs: saved, a batch of 16 512^2 tiles would add
    # 67 MB of zeros to the archive.
    program.example_inputs = None

    if out_path is None:
        ckpt_name = os.path.basename(os.path.normpath(checkpoint_path))
        out_path = os.path.join(experiment_dir, "export", ckpt_name)
    if out_path.endswith(ARTIFACT_SUFFIX):
        out_path = out_path[: -len(ARTIFACT_SUFFIX)]
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    artifact = out_path + ARTIFACT_SUFFIX
    torch.export.save(program, artifact)

    manifest = {
        "artifact": artifact,
        "bytes": os.path.getsize(artifact),
        "inputs": {
            k: {"shape": list(v.shape), "dtype": str(v.dtype).removeprefix("torch.")}
            for k, v in inputs.items()
        },
        "output": "softmax probabilities [batch, height, width, n_classes]",
        "n_classes": int(dataset.n_classes),
        "platforms": [device.type],
        "tta": bool(tta),
        "model": cfg.model.name,
        "checkpoint": os.path.normpath(checkpoint_path),
        "conv_impl": conv_impl,
    }
    with open(out_path + ".json", "w") as handle:
        json.dump(manifest, handle, indent=2)
    return manifest


def load_exported(artifact_path: str):
    """Load a ``.pt2`` program -> callable(batch dict) -> probabilities,
    run under inference mode on the device it was exported on."""
    # The program calls the fused op: it must be registered before loading.
    from floodplanet_code_tpu_torch.ops import conv_fused  # noqa: F401

    program = torch.export.load(artifact_path).module()

    @torch.inference_mode()
    def call(batch: dict) -> torch.Tensor:
        return program(batch)

    return call


def main(argv=None):
    parser = argparse.ArgumentParser(description="Export a checkpoint's predict step.")
    parser.add_argument("checkpoint_path", type=str)
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--height", type=int, default=None)
    parser.add_argument("--width", type=int, default=None)
    parser.add_argument("--tta", action="store_true")
    parser.add_argument("--eval_dataset_name", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="the device the program is exported on and runs on")
    args = parser.parse_args(argv)
    manifest = export_checkpoint(
        args.checkpoint_path,
        out_path=args.out,
        batch_size=args.batch_size,
        height=args.height,
        width=args.width,
        tta=args.tta,
        eval_dataset_name=args.eval_dataset_name,
        device=args.device,
    )
    print(json.dumps(manifest, indent=2))
    return manifest


if __name__ == "__main__":
    main()
