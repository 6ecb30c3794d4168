"""BENCHMARK.json and the files it names: every piece found by name, the
contract's shapes, and a cell added as new files alone."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import harness

ROOT = os.path.dirname(harness.HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# What a configuration's reference module exposes (portbench/reference/__init__.py).
REFERENCE_FUNCTIONS = ("tensor_shapes", "weights", "train_steps", "probabilities",
                       "batch_statistics", "work")


@pytest.fixture(scope="module")
def bench():
    return harness.manifest(ROOT)


def test_every_cell_finds_its_files_by_name(bench):
    for cell in bench["workloads"]:
        spec = harness.cell_files(bench, cell["name"])
        reference = harness.reference(spec["config"])
        assert all(callable(getattr(reference, f)) for f in REFERENCE_FUNCTIONS)
        assert harness.driver(spec["traffic"]["kind"]).run
        assert spec["limits"], cell["name"]
    for metric in bench["per_layer"]:
        assert callable(harness.reader(metric["name"]))


def test_manifest_keeps_the_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"] and bench["command"][1] == "portbench/run.py"
    assert 1 <= bench["run_seconds"] <= 51
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("portbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as handle:
            assert json.load(handle)["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for section in ("end_to_end", "per_layer"):
        for m in bench[section]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in (
                "lower", "higher")
            assert set(m.get("workloads", cells)) <= cells
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
    for cell in cells:
        reported = {m["name"] for m in harness.metrics_for(bench, cell, "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        layer = harness.metrics_for(bench, cell, "per_layer")
        assert layer and all(m["moves"] in reported for m in layer)


def test_a_variant_reads_as_its_base(bench):
    """A metric ``<base>.<variant>`` with no value or reader of its own
    reads its base's; no cell reports both a metric and a variant of it."""
    assert harness.variant_value({"train_tiles_per_s": 2.0}, "train_tiles_per_s.host_paced") == 2.0
    assert harness.variant_value({"a": 1.0, "a.b": 3.0}, "a.b") == 3.0
    assert harness.variant_value({"a": 1.0}, "b.c") is None
    ctx = {"window": {"steps": 10, "seconds": 2.0}, "train_flops_per_step": 1e12,
           "peak_flops": 1e15}
    assert harness.reader("step_mfu.train.host_paced")(ctx) == harness.reader("step_mfu.train")(ctx)
    with pytest.raises(FileNotFoundError):
        harness.reader("no_such_metric.train")
    for cell in (w["name"] for w in bench["workloads"]):
        for section in ("end_to_end", "per_layer"):
            names = [m["name"] for m in harness.metrics_for(bench, cell, section)]
            assert not [n for n in names for b in names if n.startswith(b + ".")], (cell, names)


def test_a_cell_added_as_new_files_alone_is_picked_up(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, limits
    and a per-layer metric as new files, and a cell and a metric as new
    entries; its own harness finds them all."""
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.manifest(ROOT)
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "ef_unet_ps.json").read_text())
    cfg["crop"] = 512
    (pb / "configs" / "ef_unet_ps_512.json").write_text(json.dumps(cfg))
    traffic = json.loads((pb / "traffic" / "serve_ps_scenes.json").read_text())
    traffic["tile"] = 512
    (pb / "traffic" / "serve_ps_512.json").write_text(json.dumps(traffic))
    (pb / "limits" / "ef_ps.infer_512.json").write_text(json.dumps({"mask_gap": 0.5}))
    (pb / "metrics" / "requests.serve.py").write_text(
        "def read(ctx):\n    return float(ctx['window']['requests'])\n")
    bench["configs"].append({"name": "ef_unet_ps_512", "source": "x", "reduced": [],
                             "file": "portbench/configs/ef_unet_ps_512.json", "why": "x"})
    bench["workloads"].append({"name": "ef_ps.infer_512", "config": "ef_unet_ps_512",
                               "traffic": "serve_ps_512", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "requests.serve", "unit": "1", "better": "higher",
                               "source": "program_counter", "layer": "request path",
                               "moves": "infer_tiles_per_s", "workloads": ["ef_ps.infer_512"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    probe = (
        "import sys; sys.path.insert(0, '.'); from portbench import harness\n"
        "b = harness.manifest('.')\n"
        "s = harness.cell_files(b, 'ef_ps.infer_512')\n"
        "names = [m['name'] for m in harness.metrics_for(b, 'ef_ps.infer_512', 'per_layer')]\n"
        "r = harness.reader('requests.serve')({'window': {'requests': 7}})\n"
        "print(s['config']['crop'], s['traffic']['tile'], s['limits'], 'requests.serve' in names,"
        " r, harness.driver(s['traffic']['kind']).__name__)\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120, check=True).stdout.split()
    assert out == ["512", "512", "{'mask_gap':", "0.5}", "True", "7.0",
                   "portbench.drivers.serve_requests"]
