"""The port's offline data tools (floodplanet_code_tpu_torch/tools/) and
its example transformer against the JAX package's, on the CPU.

On ``synthetic_csdap_root``: the norm parameters and feature statistics
equal the JAX tools' dicts (counts exactly, floats within 1e-6 relative);
the transform and dataset visualizations write the same file names, with
every GIF frame within one uint8 step of JAX's; the experiment GC deletes
and lists the same directories. The example transformer, with flax's
parameters imported, gives the flax outputs within 1e-4 (f32) at d_model
64 and one layer (tests/test_misc_components.py's shape).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageSequence

from floodplanet_code_tpu.models.example_transformer import (
    ExampleTileTransformer as JaxTransformer,
)
from floodplanet_code_tpu.tools import compute_feature_stats as jax_feature_stats
from floodplanet_code_tpu.tools import compute_norm_params as jax_norm_params
from floodplanet_code_tpu.tools import delete_failed_experiments as jax_gc
from floodplanet_code_tpu.tools import generate_dataset_visualizations as jax_viz
from floodplanet_code_tpu.tools import test_image_transforms as jax_transforms
from floodplanet_code_tpu_torch.models.example_transformer import ExampleTileTransformer
from floodplanet_code_tpu_torch.tools import (
    compute_feature_stats,
    compute_norm_params,
    delete_failed_experiments,
    generate_dataset_visualizations,
    test_image_transforms,
)
from floodplanet_code_tpu_torch.tools.import_jax_params import example_transformer_state_dict

TOOLS = {
    "compute_norm_params": (compute_norm_params, jax_norm_params),
    "compute_feature_stats": (compute_feature_stats, jax_feature_stats),
    "generate_dataset_visualizations": (generate_dataset_visualizations, jax_viz),
    "test_image_transforms": (test_image_transforms, jax_transforms),
    "delete_failed_experiments": (delete_failed_experiments, jax_gc),
}


def _assert_same(got, want):
    """Dicts and lists alike; ints exact, floats within 1e-6 relative."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for key in want:
            _assert_same(got[key], want[key])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, float):
        assert isinstance(got, float)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        assert got == want


@pytest.mark.parametrize("pct_sample", [0.25, 1.0])
def test_norm_params_match_jax(synthetic_csdap_root, tmp_path, pct_sample):
    args = ["--sensor", "PS", "--root_dir", synthetic_csdap_root, "--pct_sample",
            str(pct_sample)]
    want = jax_norm_params.main(args + ["--out", str(tmp_path / "jax.json")])
    got = compute_norm_params.main(args + ["--out", str(tmp_path / "port.json")])
    _assert_same(got, want)
    # The file norm_mode=global reads, through the port's loader.
    from floodplanet_code_tpu_torch.data.normalize import load_global_norm_params

    saved = load_global_norm_params("floodplanet", str(tmp_path / "port.json"))
    _assert_same(saved, {"PS": {"mean": want["mean"], "std": want["std"]}})


@pytest.mark.parametrize("sensor,features", [("S1", "image"), ("PS", "image|target")])
def test_feature_stats_match_jax(synthetic_csdap_root, sensor, features):
    args = ["--sensor", sensor, "--root_dir", synthetic_csdap_root, "--feature_names",
            features]
    want = jax_feature_stats.main(args)
    assert want
    _assert_same(compute_feature_stats.main(args), want)


def _gif_frames(path):
    with Image.open(path) as gif:
        return [np.asarray(f.convert("RGB"), np.int16) for f in ImageSequence.Iterator(gif)]


def _assert_same_gifs(got: list, want: list, got_dir, want_dir):
    assert [os.path.relpath(p, got_dir) for p in got] == [
        os.path.relpath(p, want_dir) for p in want]
    assert got
    for g, w in zip(got, want):
        fg, fw = _gif_frames(g), _gif_frames(w)
        assert len(fg) == len(fw) == 2
        for a, b in zip(fg, fw):
            assert a.shape == b.shape and np.abs(a - b).max() <= 1, g


def test_visualize_transforms_matches_jax(synthetic_csdap_root, tmp_path):
    kw = dict(root_dir=synthetic_csdap_root, n_examples=3, crop=64, angle=30.0)
    want = jax_transforms.visualize_transforms("floodplanet", "PS", str(tmp_path / "jax"), **kw)
    got = test_image_transforms.visualize_transforms("floodplanet", "PS", str(tmp_path / "port"),
                                                     device="cpu", **kw)
    _assert_same_gifs(got, want, tmp_path / "port", tmp_path / "jax")


def test_dataset_visualizations_match_jax(synthetic_csdap_root, tmp_path):
    args = ["--sensor", "PS", "--root_dir", synthetic_csdap_root]
    want = jax_viz.main(args + ["--out", str(tmp_path / "jax")])
    got = generate_dataset_visualizations.main(args + ["--out", str(tmp_path / "port")])
    _assert_same_gifs(got, want, tmp_path / "port", tmp_path / "jax")


def _experiments(root):
    """Two failed runs (one empty, one with only hydra/), a healthy one and
    one with few entries but a checkpoint, under two dates."""
    layout = {
        "2026-01-01/failed": ["hydra"],
        "2026-01-01/healthy": ["hydra", "tensorboard_logs", "checkpoints/model-x"],
        "2026-01-02/empty": [],
        "2026-01-02/small_with_ckpt": ["checkpoints/model-y"],
    }
    for exp, dirs in layout.items():
        os.makedirs(os.path.join(root, exp), exist_ok=True)
        for d in dirs:
            os.makedirs(os.path.join(root, exp, d))
    with open(os.path.join(root, "2026-01-01", "stray_file"), "w") as handle:
        handle.write("not an experiment")


@pytest.mark.parametrize("dry_run", [True, False])
def test_delete_failed_experiments_matches_jax(tmp_path, dry_run):
    results = {}
    for name, tool in (("jax", jax_gc), ("port", delete_failed_experiments)):
        root = str(tmp_path / name)
        _experiments(root)
        argv = ["--outputs_dir", root] + (["--dry_run"] if dry_run else [])
        deleted = [os.path.relpath(p, root) for p in tool.main(argv)]
        left = sorted(os.path.relpath(os.path.join(d, n), root)
                      for d, subdirs, _ in os.walk(root) for n in subdirs)
        results[name] = (deleted, left)
    assert results["port"] == results["jax"]
    assert results["port"][0] == ["2026-01-01/failed", "2026-01-02/empty"]


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_cli_takes_the_jax_arguments(name, capsys):
    """``--help`` of each port tool lists the JAX tool's options; the port
    adds ``--device`` where the tool runs on a device."""
    options = {}
    for side, module in zip(("port", "jax"), TOOLS[name]):
        with pytest.raises(SystemExit) as exit_info:
            module.main(["--help"])
        assert exit_info.value.code == 0
        options[side] = set(re.findall(r"--\w+", capsys.readouterr().out))
    extra = {"--device"} if name == "test_image_transforms" else set()
    assert options["port"] == options["jax"] | extra


def test_example_transformer_matches_flax():
    x = np.random.default_rng(0).standard_normal((2, 64, 64, 4)).astype(np.float32)
    jmodel = JaxTransformer(d_model=64, n_layers=1)
    variables = jmodel.init(jax.random.key(0), jnp.asarray(x))
    # Away from the init (zero biases, unit LayerNorm scales).
    noise = np.random.default_rng(1)
    variables = jax.tree.map(
        lambda v: np.asarray(v) + 0.05 * noise.standard_normal(v.shape).astype(np.float32),
        variables)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    model = ExampleTileTransformer(in_channels=4, d_model=64, n_layers=1)
    model.load_state_dict(example_transformer_state_dict(variables["params"]), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 64)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
