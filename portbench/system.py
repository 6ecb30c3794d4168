"""The system under test, set up as its users run it: the port's composed
configuration with the cell's settings, the scenes written in their
dataset's layout, the model built by the port with the benchmark's
weights. Both drivers use it; nothing here measures."""

from __future__ import annotations

import os
import shutil

from portbench import inputs

# Sen1Floods11 v1.1's eleven hand-labelled flood events (Bonafilia et al.).
S1F11_EVENTS = ("Bolivia", "Ghana", "India", "Mekong", "Nigeria", "Pakistan", "Paraguay",
                "Somalia", "Spain", "Sri-Lanka", "USA")


def program_config(config: dict, tile: int | None = None, batch: int | None = None):
    """The port's configuration (``config.yaml`` and its groups) with the
    configuration file's model, dataset and recipe, then its
    ``overrides`` (port keys such as ``tpu.conv_impl=pallas_fused``);
    ``tile`` and ``batch``: a serving cell's tile and
    ``tpu.inference_batch_size``."""
    from floodplanet_code_tpu_torch.config import compose

    crop = tile or config["crop"]
    overrides = [f"model={config['model']}", f"dataset={config['dataset']}",
                 f"dataset.sensor={config['sensor']}", f"dataset.channels={config['channels']}",
                 f"ignore_index={config['ignore_index']}", f"crop_height={crop}",
                 f"crop_width={crop}", f"crop_stride={config['stride']}",
                 f"batch_size={config['batch_size']}", f"lr={config['lr']}",
                 f"tpu.compute_dtype={config['compute_dtype']}", "n_workers=4",
                 "norm_mode=null"]
    overrides += [f"model.model_kwargs.{k}={v}" for k, v in config["model_kwargs"].items()]
    overrides.append(f"model.model_kwargs.optimizer_name={config['optimizer']}")
    t = config["transforms"]
    for name in ("hflip", "vflip", "rotate"):
        overrides += [f"transforms.{name}.active=true",
                      f"transforms.{name}.likelihood={t[name]}"]
    overrides += [f"transforms.rotate.min_rot_angle={t['min_angle']}",
                  f"transforms.rotate.max_rot_angle={t['max_angle']}",
                  "transforms.rotate.fill_ignore=false"]
    if batch is not None:
        overrides.append(f"tpu.inference_batch_size={batch}")
    return compose(overrides=overrides + list(config.get("overrides", [])))


def scene_list(config: dict, sizes: list, region: str | None = None) -> list:
    """[(index, region, name, (h, w))] in the order the port's dataset
    holds them (regions sorted, then names, which sort as the indices):
    FloodPlanet scenes in one region; Sen1Floods11 chips dealt to the
    events in turn, or all to ``region``."""
    out = []
    for i, hw in enumerate(sizes):
        if config["dataset"] == "sen1floods11":
            r = region or S1F11_EVENTS[i % len(S1F11_EVENTS)]
        else:
            r = region or "RegionA"
        out.append((i, r, f"{i:05d}", tuple(hw)))
    return sorted(out, key=lambda s: (s[1], s[2]))


def write_scenes(config: dict, root: str, scenes: list, seed: int, device) -> None:
    """Write ``scenes`` ([(index, region, name, (h, w))]) under ``root``
    with the port's TIFF writer, each made from (seed, index)."""
    from floodplanet_code_tpu_torch.geo import tiff

    for index, region, name, hw in scenes:
        image, label = inputs.scene(config, seed, index, hw, device)
        inputs.write_scene(config, root, name, image, label, region, tiff.imwrite)


def fresh_dir(path: str) -> str:
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def dataset(cfg, root: str, split_regions: list, tile: int, stride: int):
    """The port's dataset over ``root``: every region (split "all" with the
    regions named, so scenes keep their sorted order)."""
    from floodplanet_code_tpu_torch.data import build_dataset, generate_image_slice_object

    return build_dataset(
        cfg.dataset.name, "all", generate_image_slice_object(tile, tile, stride),
        root_dir=root, sensor=cfg.dataset.sensor, channels=cfg.dataset.channels,
        norm_mode=cfg.norm_mode, eval_region=sorted(set(split_regions)),
        ignore_index=cfg.ignore_index, seed_num=cfg.seed_num,
        train_split_pct=cfg.train_split_pct)


def model(cfg, config: dict, device, weights: dict):
    """The port's model for ``cfg`` with ``weights`` loaded (strict)."""
    from floodplanet_code_tpu_torch.models import (
        build_model, resolve_compute_dtype, resolve_conv_impl)

    net = build_model(cfg.model.name, {"ms_image": config["in_channels"]}, config["n_classes"],
                      dtype=resolve_compute_dtype(cfg), device=device,
                      conv_impl=resolve_conv_impl(cfg), **(cfg.model.get("model_kwargs") or {}))
    net.load_state_dict(weights, strict=True)
    return net
