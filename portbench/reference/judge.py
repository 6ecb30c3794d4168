"""What decides ``correct``: the reference run on the same generated inputs,
and the numbers that hold the system's outputs to it.

Training (the first steps of the run, through the window's own call and
feed): each step's loss; the first gradient as the optimizer holds it
(Adam's first moment after one step over 1 - beta1); the change of every
parameter over the steps; the change of every BatchNorm running
statistic (for a model that has them). Each but the loss by the worst leaf
and by the median leaf: the gap between the two norms, over the larger of
the reference's norm of that leaf and of the median leaf. Parameters whose
reference gradient is under a thousandth of the median leaf's move by
round-off alone and are left out of the change.

Serving (requests of the window, sampled from the seed, the largest among
them): the served mask against the reference's probabilities. The mask is
argmax clipped to {0, 1} (class 0 against the better of classes 1 and 2);
the numbers are the widest gap, over every pixel, by which the reference's
probability of the served side lies below its best side, its mean, and the
share of pixels served the other side.

A cell's ``limits/<cell>.json`` names the numbers it compares; the others
are printed.

Nothing here imports the system under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import harness, inputs
from portbench.reference import common
from portbench.reference import data as rdata


def _norms(tensors: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def _gaps(prog: dict, ref: dict, keys) -> list[float]:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's."""
    keys = list(keys)
    median = float(np.median([ref[k] for k in keys])) if keys else 0.0
    return [abs(prog[k] - ref[k]) / max(ref[k], median) for k in keys
            if max(ref[k], median) > 0]


def train_numbers(program: dict, reference: dict, before: dict) -> dict:
    """The training numbers of the module docstring: ``loss``, ``grad``,
    ``change``, ``stats`` by the worst leaf (the loss by the worst step),
    ``loss_first`` (the first step's), and ``grad_median``,
    ``change_median``, ``stats_median`` by the median leaf; the two of
    ``stats`` only where there are running statistics. ``program`` and
    ``reference`` hold ``losses``, ``first_grads`` (name -> tensor) and
    ``after`` (name -> tensor, parameters and running statistics);
    ``before`` the common starting point."""
    losses = [abs(p - r) / max(abs(r), 1e-12)
              for p, r in zip(program["losses"], reference["losses"])]
    g_ref = _norms(reference["first_grads"])
    grads = _gaps(_norms(program["first_grads"]), g_ref, g_ref)
    g_median = float(np.median(list(g_ref.values())))
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * g_median]
    stats = [k for k in reference["after"] if k not in g_ref]
    d_ref = _norms({k: reference["after"][k] - before[k] for k in moved + stats})
    d_prog = _norms({k: program["after"][k].to(before[k].device) - before[k]
                     for k in moved + stats})
    changes = _gaps(d_prog, d_ref, moved)
    stat_gaps = _gaps(d_prog, d_ref, stats)
    numbers = {"loss": max(losses), "grad": max(grads), "change": max(changes),
               "stats": max(stat_gaps, default=None), "loss_first": losses[0],
               "grad_median": float(np.median(grads)),
               "change_median": float(np.median(changes)),
               "stats_median": float(np.median(stat_gaps)) if stat_gaps else None}
    return {k: v for k, v in numbers.items() if v is not None}


class Scenes:
    """The raw scenes of a run, made again from the seed on demand."""

    def __init__(self, config: dict, seed: int, device):
        self.config, self.seed, self.device = config, seed, device
        self._held: dict = {}

    def get(self, index: int, hw) -> tuple[np.ndarray, np.ndarray]:
        """(normalized image [H, W, C] f32, class labels [H, W] int32)."""
        if index not in self._held:
            image, label = inputs.scene(self.config, self.seed, index, hw, self.device)
            c = self.config
            self._held[index] = (rdata.normalize(image, c["sensor"]),
                                 rdata.binarize(label, c["dataset"], c["ignore_index"]))
        return self._held[index]


def train_reference(config: dict, seed: int, weights: dict, scenes: list, steps: list,
                    u_draws: list, transforms: dict, ignore_index: int, device,
                    quant=None, keep_rows=None) -> dict:
    """The reference's first steps: ``steps`` holds each step's example
    indices into the dataset that ``scenes`` (the run's (index, region,
    name, (h, w)) list, in the dataset's order) tiles; ``u_draws`` each
    step's augmentation uniforms [4, B]. ``keep_rows``: a planted fault, the
    batch's first rows only."""
    crop, stride = config["crop"], config["stride"]
    examples = []
    for index, _, _, hw in scenes:
        examples += [(index, hw, w) for w in rdata.crop_slices(hw[0], hw[1], crop, stride)]
    held = Scenes(config, seed, device)
    batches = []
    for idx, u in zip(steps, u_draws):
        images, labels = [], []
        for i in idx:
            index, hw, window = examples[i]
            image, label = held.get(index, hw)
            img, lbl = rdata.crop(image, label, window, crop, config["ignore_index"])
            images.append(img)
            labels.append(lbl)
        image = torch.from_numpy(np.stack(images)).to(device)
        label = torch.from_numpy(np.stack(labels)).to(device)
        image, label = rdata.augment(image, label, u.to(device), transforms)
        image = image.permute(0, 3, 1, 2).contiguous()
        if keep_rows is not None:
            image, label = image[:keep_rows], label[:keep_rows]
        batches.append((image, label))
    with common.no_tf32():
        return harness.reference(config).train_steps(config, weights, batches, ignore_index,
                                                     quant=quant)


def scene_probabilities(config: dict, weights: dict, image: np.ndarray, tile: int,
                        batch: int, tta: bool, device, quant=None) -> np.ndarray:
    """The reference's probabilities [H, W, n_classes] of one normalized
    scene: non-overlapping tiles, zero-padded at the ragged edges, each
    tile's inside placed back."""
    h, w, _ = image.shape
    windows = rdata.crop_slices(h, w, tile, tile)
    out = np.zeros((h, w, config["n_classes"]), np.float32)
    label = np.zeros((h, w), np.int32)
    ref = harness.reference(config)
    with common.no_tf32(), torch.no_grad():
        for start in range(0, len(windows), batch):
            part = windows[start:start + batch]
            tiles = np.stack([rdata.crop(image, label, win, tile, 0)[0] for win in part])
            x = torch.from_numpy(tiles).to(device).permute(0, 3, 1, 2).contiguous()
            probs = ref.probabilities(config, weights, x, tta, quant).cpu().numpy()
            for (h0, w0, hh, ww), p in zip(part, probs):
                out[h0:h0 + hh, w0:w0 + ww] = p[:hh, :ww]
    return out


def mask_numbers(mask: np.ndarray | None, probs: np.ndarray) -> dict:
    """Of one scene: the gap of every pixel, by which the reference's
    probability of the served side (0: class 0; 1: the better of classes 1
    and 2) lies below its best side; its largest (``mask_gap``), its mean
    (``mask_mean_gap``) and the share of pixels served another side than
    the reference's best (``mask_flips``). A mask that is missing or of
    another shape reads 1 on each."""
    if mask is None or mask.shape != probs.shape[:2]:
        return {"mask_gap": 1.0, "mask_mean_gap": 1.0, "mask_flips": 1.0}
    s0, s1 = probs[..., 0], probs[..., 1:].max(axis=-1)
    gap = np.maximum(s0, s1) - np.where(mask, s1, s0)
    return {"mask_gap": float(gap.max()), "mask_mean_gap": float(gap.mean(dtype=np.float64)),
            "mask_flips": float((gap > 0).mean(dtype=np.float64))}


def worst(numbers: list[dict]) -> dict:
    """The largest of each number over scenes."""
    return {k: max(n[k] for n in numbers) for k in numbers[0]} if numbers else {}


def within(numbers: dict, limits: dict) -> dict:
    """{name: {value, limit}} of the numbers that have a limit; a number
    that is not finite, or a limit with no number, fails."""
    out = {}
    for name in limits:
        value = numbers.get(name, float("nan"))
        v = float(value)
        out[name] = {"value": v if math.isfinite(v) else str(v), "limit": limits[name]}
    return out


def passes(checks: dict) -> bool:
    return all(isinstance(c["value"], float) and c["value"] <= c["limit"]
               for c in checks.values())
