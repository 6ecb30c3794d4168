"""Where the f32 train step's gradients part from the f64 step's.

One train step of chip_smoke.py's seeded ef_model (xla convs, TF32 off)
from the same weights on one batch of chip_smoke's synthetic scenes, in f32
and in f64 (f64 activations and BatchNorm, the loss on f32 logits, as the
model computes it). Prints, per BatchNorm + ReLU layer, the elements whose
ReLU decision differs between the two steps (their input lies within
rounding of zero), and the gradients' distance: global (of the norm of all
gradients) and the worst tensor's (max and norm forms, as chip_smoke.py's
``grad_rels``). A ReLU's derivative jumps at zero, so one element decided
the other way moves the gradient by that element's share of it, about
1 / sqrt(elements of the layer), whatever the rounding was.

    python scripts/torch_relu_flips.py --tile 50 --base 8 --batch 4 \
        --scenes 150x200 --device cpu        # chip_smoke's CPU rehearsal
    python scripts/torch_relu_flips.py      # phase 14's 300^2 batch, on a card
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from floodplanet_code_tpu_torch.data import (  # noqa: E402
    BatchLoader,
    build_dataset,
    generate_image_slice_object,
)
from floodplanet_code_tpu_torch.data.augment import TransformParams  # noqa: E402
from floodplanet_code_tpu_torch.models.unet import BatchNormReLU  # noqa: E402
from floodplanet_code_tpu_torch.train import make_train_step  # noqa: E402


def batch_of(tile: int, batch: int, scenes, work: str) -> dict:
    """The first shuffled batch of ``tile``^2 crops of chip_smoke's scenes
    (written with seed 1, as phase 13 writes them)."""
    cs.write_scenes(work, scenes, seed=1)
    ds = build_dataset("floodplanet", "train", generate_image_slice_object(tile, tile, stride=tile),
                       sensor="PS", channels="ALL", root_dir=work, ignore_index=0,
                       seed_num=0, train_split_pct=0.8)
    b = next(iter(BatchLoader(ds, batch, shuffle=True, n_workers=1)))
    return {k: torch.from_numpy(b[k]) for k in ("image", "target")}


def step(dtype, base: int, block: dict, device: str):
    """One train step: {layer: ReLU mask} and {parameter: gradient}."""
    model, state = cs._md_model({"base": base}, dtype, device, conv_impl="xla")
    masks = {}
    for name, m in model.named_modules():
        if isinstance(m, BatchNormReLU):
            m.register_forward_hook(
                lambda mod, i, o, name=name: masks.__setitem__(name, o.detach() > 0))
    train = make_train_step(model, 0, TransformParams(False, 0, False, 0, False, 0),
                            fuse_augmentation=False)
    train(state, {k: v.to(device) for k, v in block.items()})
    return masks, {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tile", type=int, default=cs.SP_TILE)
    p.add_argument("--base", type=int, default=cs.BASE)
    p.add_argument("--batch", type=int, default=cs.MD_BATCH)
    p.add_argument("--scenes", default=None,
                   help="HxW of each of 5 scenes (default: chip_smoke's TRAIN_SCENES)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    scenes = cs.TRAIN_SCENES
    if args.scenes:
        scenes = [tuple(int(v) for v in args.scenes.split("x"))] * 5
    cs._md_tf32_off()
    work = tempfile.mkdtemp(prefix="relu_flips_")
    try:
        block = batch_of(args.tile, args.batch, scenes, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    m32, g32 = step(torch.float32, args.base, block, args.device)
    m64, g64 = step(torch.float64, args.base, block, args.device)
    flips = {k: int((m32[k] != m64[k]).sum()) for k in m64}
    total = torch.cat([g.flatten() for g in g64.values()]).norm()
    gap = torch.cat([(g32[k] - g64[k]).flatten() for k in g64]).norm() / total
    rels = cs.grad_rels(g32, g64)
    out = {"tile": args.tile, "base": args.base, "batch": args.batch, "device": args.device,
           "relu_elements": sum(m.numel() for m in m64.values()),
           "relu_flips": {k: v for k, v in flips.items() if v},
           "flipped_layer_elements": {k: m64[k].numel() for k, v in flips.items() if v},
           "grad_gap_global": gap.item(),
           "grad_gap_worst": [max(v[i] for v in rels.values()) for i in (0, 1)]}
    if torch.device(args.device).type == "cuda":
        out["card"] = cs.card_line()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
