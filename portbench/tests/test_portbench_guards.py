"""The start-up guards: no JAX and no JAX package in a run's process, none
of the JAX-era benchmark files read, no run without a card."""

import os
import subprocess
import sys

from portbench import harness

ROOT = os.path.dirname(harness.HERE)


def test_top_level_names_are_compared_whole():
    modules = dict.fromkeys(["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "orbax",
                             "floodplanet_code_tpu", "floodplanet_code_tpu.models",
                             "floodplanet_code_tpu_torch", "floodplanet_code_tpu_torch.models",
                             "jaxtyping", "flaxen", "orbaxish", "numpy"])
    assert harness.forbidden_modules(modules) == sorted([
        "floodplanet_code_tpu", "floodplanet_code_tpu.models", "flax.linen", "jax",
        "jax.numpy", "jaxlib.xla_client", "orbax"])


def test_a_run_process_imports_no_jax():
    """Everything a run imports (the harness, both drivers with the port's
    modules they call into, the reference, the calibration) leaves no
    forbidden module behind."""
    probe = (
        "import sys; sys.path.insert(0, '.')\n"
        "import portbench.run, portbench.calibrate\n"
        "from portbench import harness, system\n"
        "from portbench.drivers import train_loop, serve_requests\n"
        "import floodplanet_code_tpu_torch.inference.serve, floodplanet_code_tpu_torch.train.fit\n"
        "import floodplanet_code_tpu_torch.data.device_cache, floodplanet_code_tpu_torch.geo.tiff\n"
        "for m in harness.metrics_for(harness.manifest('.'), 'ef_ps.train', 'per_layer'):\n"
        "    harness.reader(m['name'])\n"
        "print(harness.forbidden_modules())\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHONPATH")}
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_file_reads_the_jax_era_benchmark_files():
    """No file of the benchmark names the JAX-era benchmark files, or
    imports the port's root benchmark script."""
    names = ["bench" + ".py", "BENCH" + "_", "BASELINE" + ".json", "MULTICHIP" + "_",
             "import bench" + "_torch", "from bench" + "_torch"]
    for folder, _, files in os.walk(harness.HERE):
        for name in files:
            if name.endswith((".py", ".json")):
                with open(os.path.join(folder, name)) as handle:
                    text = handle.read()
                assert not [n for n in names if n in text], os.path.join(folder, name)


def test_run_refuses_without_a_card():
    """No card (this machine's torch is built for the CPU, or the card is
    hidden): a non-zero exit and no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "ef_ps.train",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "refused" in out.stderr
