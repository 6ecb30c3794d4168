from floodplanet_code_tpu_torch.config.core import (
    Config,
    compose,
    get_dataset_root,
    load_config,
    load_experiment_config,
    save_config,
)

__all__ = [
    "Config",
    "compose",
    "get_dataset_root",
    "load_config",
    "load_experiment_config",
    "save_config",
]
