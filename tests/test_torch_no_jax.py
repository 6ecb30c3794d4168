"""The port, chip_smoke.py and bench_torch.py load no JAX and nothing of
the JAX package.

Runs the imports in a fresh interpreter: this test process has JAX loaded
already (tests/conftest.py), so only a subprocess can see what the port
itself pulls in.
"""

import os
import pkgutil
import subprocess
import sys

import floodplanet_code_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = r"""
import importlib, json, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
from chip_smoke import (build_all, kernel_parity, kernel_timing, run_slice, shear_parity,
                        shear_timing, run_training, cache_parity, run_fit, run_evaluation,
                        run_tools, run_data_tools, run_multi_device, run_entry_points, main)
import bench_torch
bad = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax")
    or m == "floodplanet_code_tpu" or m.startswith("floodplanet_code_tpu.")
)
print(json.dumps(bad))
"""


def _port_modules():
    pkg = floodplanet_code_tpu_torch
    return [pkg.__name__] + [
        m.name
        for m in pkgutil.walk_packages(pkg.__path__, prefix=pkg.__name__ + ".")
    ]


def test_port_modules_are_all_listed():
    names = _port_modules()
    for expected in (
        "floodplanet_code_tpu_torch.ops.conv_fused",
        "floodplanet_code_tpu_torch.models.unet",
        "floodplanet_code_tpu_torch.inference.infer",
        "floodplanet_code_tpu_torch.tools.import_jax_params",
        "floodplanet_code_tpu_torch.geo.tiff",
        "floodplanet_code_tpu_torch.ops.cuda_build",
        "floodplanet_code_tpu_torch.ops.batchnorm",
        "floodplanet_code_tpu_torch.ops.losses",
        "floodplanet_code_tpu_torch.ops.metrics",
        "floodplanet_code_tpu_torch.ops.rotate",
        "floodplanet_code_tpu_torch.data.augment",
        "floodplanet_code_tpu_torch.train.state",
        "floodplanet_code_tpu_torch.train.fit",
        "floodplanet_code_tpu_torch.train.checkpoint",
        "floodplanet_code_tpu_torch.train.logging",
        "floodplanet_code_tpu_torch.data.device_cache",
        "floodplanet_code_tpu_torch.utils.image",
        "floodplanet_code_tpu_torch.utils.trace",
        "floodplanet_code_tpu_torch.fit",
        "floodplanet_code_tpu_torch.data.sen1floods11",
        "floodplanet_code_tpu_torch.inference.predict",
        "floodplanet_code_tpu_torch.inference.serve",
        "floodplanet_code_tpu_torch.inference.batch_infer",
        "floodplanet_code_tpu_torch.tools.summarize_crossval",
        "floodplanet_code_tpu_torch.tools.soup_checkpoints",
        "floodplanet_code_tpu_torch.tools.eval_ensemble",
        "floodplanet_code_tpu_torch.tools.run_crossval",
        "floodplanet_code_tpu_torch.tools.export_model",
        "floodplanet_code_tpu_torch.tools.import_torch_checkpoint",
        "floodplanet_code_tpu_torch.tools.compute_norm_params",
        "floodplanet_code_tpu_torch.tools.compute_feature_stats",
        "floodplanet_code_tpu_torch.tools.generate_dataset_visualizations",
        "floodplanet_code_tpu_torch.tools.test_image_transforms",
        "floodplanet_code_tpu_torch.tools.delete_failed_experiments",
        "floodplanet_code_tpu_torch.models.example_transformer",
        "floodplanet_code_tpu_torch.parallel.mesh",
        "floodplanet_code_tpu_torch.parallel.multihost",
        "floodplanet_code_tpu_torch.parallel.collectives",
        "floodplanet_code_tpu_torch.parallel.launch",
        "floodplanet_code_tpu_torch.parallel.shard_step",
        "floodplanet_code_tpu_torch.parallel.halo",
        "floodplanet_code_tpu_torch.parallel.rows",
    ):
        assert expected in names


def test_port_and_chip_smoke_import_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    result = subprocess.run(
        [sys.executable, "-c", _CHECK, *_port_modules()],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip().splitlines()[-1] == "[]"
