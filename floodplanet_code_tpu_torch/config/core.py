"""Minimal Hydra-like configuration system.

The reference drives everything through Hydra + OmegaConf
(st_water_seg/conf/config.yaml composed with conf/{dataset,model,experiment}
group files, CLI dotted overrides, and a per-run config snapshot). Neither
library is a dependency here; this module re-implements the subset of that
surface the pipeline needs, keeping the *same key layout* so reference
configs read naturally:

- ``Config``: a dict subclass with attribute access (``cfg.dataset.sensor``).
- ``compose(...)``: loads ``config.yaml``, resolves its ``defaults`` list
  entries (``- dataset: floodplanet`` -> merge ``dataset/floodplanet.yaml``
  under ``cfg.dataset``), applies an optional ``# @package _global_``
  experiment overlay at the root, then applies CLI-style dotted overrides
  (``crop_height=512`` / ``dataset.sensor=S1`` / ``eval_region=[A,B]``).
- ``save_config``/``load_config``: YAML snapshot written to
  ``<exp_dir>/hydra/config.yaml`` — the same fallback path the reference's
  predict.py:46-49 looks for, so experiment directories stay compatible.
"""

from __future__ import annotations

import copy
import functools
import os
import re
from typing import Any, Iterable


@functools.lru_cache(maxsize=None)
def _yaml_loader():
    """SafeLoader with a YAML-1.2-style float resolver.

    Stock PyYAML follows YAML 1.1 and parses ``1e-4`` (no dot) as a string;
    Hydra/OmegaConf treat it as a float and the reference configs rely on
    that (conf/config.yaml:21 ``lr: 1e-4``). ``yaml`` is imported here, not
    at module import, so a ``Config`` built from a Python dict needs no
    PyYAML.
    """
    import yaml

    class _YamlLoader(yaml.SafeLoader):
        pass

    _YamlLoader.add_implicit_resolver(
        "tag:yaml.org,2002:float",
        re.compile(
            r"""^(?:
                [-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
               |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
               |\.[0-9_]+(?:[eE][-+]?[0-9]+)?
               |[-+]?\.(?:inf|Inf|INF)
               |\.(?:nan|NaN|NAN)
            )$""",
            re.X,
        ),
        list("-+0123456789."),
    )
    return _YamlLoader


def _yaml_load(stream) -> Any:
    import yaml

    return yaml.load(stream, Loader=_yaml_loader())


class Config(dict):
    """Nested dict with attribute access, akin to an OmegaConf DictConfig."""

    def __init__(self, data: dict | None = None):
        super().__init__()
        if data:
            for key, value in data.items():
                self[key] = value

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, Config):
            return value
        if isinstance(value, dict):
            return Config(value)
        if isinstance(value, (list, tuple)):
            return [Config._wrap(v) for v in value]
        return value

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, Config._wrap(value))

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as exc:
            raise AttributeError(key) from exc

    def __delattr__(self, key: str) -> None:
        try:
            del self[key]
        except KeyError as exc:
            raise AttributeError(key) from exc

    def __deepcopy__(self, memo: dict) -> "Config":
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    # -- helpers -----------------------------------------------------------

    def merge(self, other: dict) -> "Config":
        """Recursively merge ``other`` into self (``other`` wins)."""
        for key, value in other.items():
            if (
                key in self
                and isinstance(self[key], Config)
                and isinstance(value, dict)
            ):
                self[key].merge(value)
            else:
                self[key] = value
        return self

    def select(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def set_dotted(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], Config):
                node[part] = Config()
            node = node[part]
        node[parts[-1]] = value

    def to_dict(self) -> dict:
        def unwrap(value: Any) -> Any:
            if isinstance(value, Config):
                return {k: unwrap(v) for k, v in value.items()}
            if isinstance(value, list):
                return [unwrap(v) for v in value]
            return value

        return unwrap(self)

    def to_yaml(self) -> str:
        import yaml

        return yaml.safe_dump(self.to_dict(), sort_keys=False)


def _parse_override_value(raw: str) -> Any:
    """Parse a CLI override value string with YAML semantics.

    ``"null"`` -> None, ``"0.5"`` -> float, ``"[A,B]"`` -> list, else str.
    """
    import yaml

    try:
        return _yaml_load(raw)
    except yaml.YAMLError:
        return raw


DEFAULT_CONFIG_DIR = os.path.join(os.path.dirname(__file__), "conf")


def load_yaml(path: str) -> Config:
    with open(path, "r") as handle:
        data = _yaml_load(handle)
    return Config(data or {})


def compose(
    config_dir: str | None = None,
    config_name: str = "config",
    overrides: Iterable[str] = (),
) -> Config:
    """Compose the full config from the primary file + groups + overrides.

    Mirrors the reference's Hydra composition (conf/config.yaml defaults
    list, reference conf/config.yaml:1-5) without the Hydra dependency.

    Override grammar:
      - ``group=name``       swap a config group file (``model=lf_model``)
      - ``+experiment=name`` apply a root-level experiment overlay
      - ``a.b.c=value``      set a dotted key (YAML-parsed value)
    """
    config_dir = config_dir or DEFAULT_CONFIG_DIR
    primary = load_yaml(os.path.join(config_dir, config_name + ".yaml"))

    defaults = primary.pop("defaults", [])
    group_choices: dict[str, str] = {}
    for entry in defaults:
        if isinstance(entry, dict):
            for group, name in entry.items():
                if str(group).startswith("override ") or group == "_self_":
                    continue
                group_choices[str(group)] = str(name)

    overrides = list(overrides)
    remaining: list[str] = []
    experiment_name: str | None = None
    for override in overrides:
        if "=" not in override:
            raise ValueError(f"Malformed override (expected key=value): {override}")
        key, _, raw_value = override.partition("=")
        key = key.strip()
        if key.startswith("+experiment") or key == "experiment":
            experiment_name = raw_value.strip()
        elif key in group_choices:
            group_choices[key] = raw_value.strip()
        else:
            remaining.append(override)

    cfg = Config()
    for group, name in group_choices.items():
        group_path = os.path.join(config_dir, group, name + ".yaml")
        if not os.path.exists(group_path):
            raise FileNotFoundError(
                f'Config group file not found for {group}={name}: "{group_path}"'
            )
        cfg[group] = load_yaml(group_path)
    cfg.merge(primary)

    if experiment_name is not None:
        exp_path = os.path.join(config_dir, "experiment", experiment_name + ".yaml")
        overlay = load_yaml(exp_path)
        overlay.pop("defaults", None)  # group swaps in overlays unsupported/stale
        cfg.merge(overlay)

    for override in remaining:
        key, _, raw_value = override.partition("=")
        cfg.set_dotted(key.strip(), _parse_override_value(raw_value.strip()))

    return cfg


def save_config(cfg: Config, exp_dir: str) -> str:
    """Snapshot the composed config into ``<exp_dir>/hydra/config.yaml``.

    The path matches the reference's non-dot fallback (predict.py:48,
    infer.py:43) so downstream CLIs can rediscover the training config.
    """
    cfg_dir = os.path.join(exp_dir, "hydra")
    os.makedirs(cfg_dir, exist_ok=True)
    path = os.path.join(cfg_dir, "config.yaml")
    with open(path, "w") as handle:
        handle.write(cfg.to_yaml())
    return path


def load_config(path: str) -> Config:
    return load_yaml(path)


def load_experiment_config(experiment_dir: str) -> Config:
    """Find a training-config snapshot inside an experiment directory.

    Checks ``.hydra/config.yaml`` then ``hydra/config.yaml`` then a bare
    ``config.yaml`` (reference: predict.py:46-49, infer.py:41-44).
    """
    for sub in (".hydra", "hydra", ""):
        path = os.path.join(experiment_dir, sub, "config.yaml")
        if os.path.exists(path):
            return load_yaml(path)
    raise FileNotFoundError(
        f'No config snapshot found under experiment dir "{experiment_dir}"'
    )


def get_dataset_root(dset_name: str, base_dir: str | None = None) -> str:
    """Resolve a dataset root from ``dataset_dirs.json`` at the repo root.

    Mirrors st_water_seg/datasets/utils.py:10-19 (the reference's path
    indirection file, rewritten in place by its Batch_infer.sh driver).
    """
    import json

    if base_dir is None:
        base_dir = os.getcwd()
    candidates = [os.path.join(base_dir, "dataset_dirs.json")]
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(__file__)))
    candidates.append(os.path.join(repo_root, "dataset_dirs.json"))
    for path in candidates:
        if os.path.exists(path):
            with open(path, "r") as handle:
                roots = json.load(handle)
            if dset_name not in roots:
                raise KeyError(
                    f'Dataset "{dset_name}" not found in {path}; '
                    f"available: {sorted(roots)}"
                )
            return roots[dset_name]
    raise FileNotFoundError(
        f"dataset_dirs.json not found (searched {candidates})"
    )
