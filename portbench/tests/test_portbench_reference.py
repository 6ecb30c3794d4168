"""The model behind one interface: each configuration's reference module
gives the same weights and counts as before the interface existed; a
configuration's ``overrides`` reach the port; a model that is not a UNet
joins a copy of the benchmark as new files alone, trains and is judged."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import counts, harness

ROOT = os.path.dirname(harness.HERE)
SEED = 2**33 + 17
TOY = os.path.join(harness.HERE, "tests", "toy")

# Recorded from the tree before the reference interface (inputs.weights of
# the UNet's tensor shapes on the CPU at SEED; the drivers' work sums).
WEIGHT_DIGESTS = {
    "ef_unet_ps": "3d5e3159d6abcdeab19cb2d37947b07d42bd3667be58ee0dd1afe1a0b374c057",
    "lf_unet_s1f11": "4b8254c8efe8cb97f35fab7e37749b129f9115faf661b512fa12979011984a7c",
}
# cell: (flops per step or batch, conv bound seconds per step or batch)
WORK = {
    "ef_ps.train": (3265018122240.0, 0.0034832049334947114),
    "lf_s1.train": (9855943311360.0, 0.011370851457833175),
    "ef_ps.infer": (1743554838528.0, 0.0018771692945205617),
    "lf_s1.infer_tta": (5259724324864.0, 0.0061192983357995865),
}


@pytest.fixture(scope="module")
def bench():
    return harness.manifest(ROOT)


@pytest.mark.parametrize("name", sorted(WEIGHT_DIGESTS))
def test_weights_are_the_recorded_draw(bench, name):
    entry = {c["name"]: c for c in bench["configs"]}[name]
    config = harness.load_json(os.path.join(ROOT, entry["file"]))
    weights = harness.reference(config).weights(config, SEED, "cpu")
    digest = hashlib.sha256()
    for key in sorted(weights):
        digest.update(key.encode())
        digest.update(weights[key].contiguous().numpy().tobytes())
    assert digest.hexdigest() == WEIGHT_DIGESTS[name]


@pytest.mark.parametrize("cell", sorted(WORK))
def test_work_sums_are_the_recorded_counts(bench, cell):
    """The values the drivers put in ``ctx``, to the last digit."""
    spec = harness.cell_files(bench, cell)
    config, traffic = spec["config"], spec["traffic"]
    train = traffic["kind"] == "train_loop"
    batch, size = ((config["batch_size"], config["crop"]) if train
                   else (traffic["batch"], traffic["tile"]))
    ops = harness.reference(config).work(config, int(batch), size, size)
    flops = counts.train_flops(ops) if train else counts.forward_flops(ops)
    work = counts.by_kind(ops, config["compute_dtype"], train)
    assert (flops, work["conv"]["bound_s"]) == WORK[cell]
    assert set(work) == {"conv"} and work["conv"]["flops"] == flops


@pytest.mark.parametrize("overrides,impl", [([], "xla"),
                                            (["tpu.conv_impl=pallas_fused"], "pallas_fused")])
def test_a_configuration_overrides_reach_the_port(bench, overrides, impl):
    from floodplanet_code_tpu_torch.models import resolve_conv_impl
    from portbench import system

    config = dict(harness.cell_files(bench, "ef_ps.train")["config"], overrides=overrides)
    cfg = system.program_config(config)
    assert resolve_conv_impl(cfg) == impl
    assert cfg.model.model_kwargs.optimizer_name == config["optimizer"]


def test_a_model_added_as_new_files_alone_trains_and_is_judged(tmp_path, bench):
    """A copy of the benchmark gains the toy model (``tests/toy``: not a
    UNet, no BatchNorm) as a configuration, a reference module, a
    traffic mix and limits, each a new file, and a cell as new entries. The
    training driver runs it on the CPU (the port given the toy model by a
    monkeypatch in that process alone): a sound run is correct, a run with
    half of each batch left out is not."""
    from floodplanet_code_tpu_torch.config import core

    pb = tmp_path / "bench" / "portbench"
    shutil.copytree(harness.HERE, pb, ignore=shutil.ignore_patterns("__pycache__"))
    for source, target in (("toy.py", "reference/toy.py"), ("toy_seg.json", "configs/toy_seg.json"),
                           ("train_toy.json", "traffic/train_toy.json"),
                           ("toy.train.json", "limits/toy.train.json")):
        assert not (pb / target).exists()
        shutil.copy(os.path.join(TOY, source), pb / target)
    conf = tmp_path / "conf"
    shutil.copytree(core.DEFAULT_CONFIG_DIR, conf)
    shutil.copy(os.path.join(TOY, "toy_seg.yaml"), conf / "model" / "toy_seg.yaml")
    bench = json.loads(json.dumps(bench))
    bench["configs"].append({"name": "toy_seg", "source": "x", "reduced": [],
                             "file": "portbench/configs/toy_seg.json", "why": "x"})
    bench["workloads"].append({"name": "toy.train", "config": "toy_seg",
                               "traffic": "train_toy", "chips": 1, "why": "x"})
    (pb.parent / "BENCHMARK.json").write_text(json.dumps(bench))
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHONPATH")}
    env.update(PYTHONPATH=ROOT, TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, str(pb / "tests" / "toy" / "run_cell.py"), "toy.train",
                          str(conf), str(tmp_path / "work")], cwd=pb.parent, capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    runs = json.loads(out.stdout.strip().splitlines()[-1])
    sound, half = runs["sound"], runs["half_batch"]
    assert sound["correct"], sound
    assert not half["correct"], half
    assert "stats" not in sound["numbers"]  # no running statistics to compare
    work = sound["work_by_kind"]
    assert set(work) == {"conv", "matmul"}
    assert sound["train_flops_per_step"] == work["conv"]["flops"] + work["matmul"]["flops"]
