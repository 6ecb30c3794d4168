"""``correct`` against broken runs, on the CPU at a size a test run holds
(base 8, 32^2 tiles, float32 so that a sound run meets the reference to
rounding): the harness without its look for a card drives the rest of a
run with the timed path broken underneath, under each cell's own limits,
and ``correct`` comes out false; the control (the reference in fp8, in the
system's place) fails as well. No cell runs on more than one chip, so
there is no exchange between chips to leave out."""

import copy
import os
import time

import numpy as np
import pytest
import torch

from portbench import calibrate, harness
from portbench.reference import judge

SEED = 2**33 + 17  # wider than 32 bits, as the driver's seeds are
CPU = torch.device("cpu")


def _spec(cell: str) -> dict:
    spec = harness.cell_files(harness.manifest(os.path.dirname(harness.HERE)), cell)
    c = spec["config"] = copy.deepcopy(spec["config"])
    c["model_kwargs"]["base_feat_channels"] = 8
    c["crop"], c["batch_size"], c["compute_dtype"] = 32, 4, "float32"
    c["stride"] = 16 if c["dataset"] == "floodplanet" else 32
    t = spec["traffic"]
    if t["kind"] == "train_loop":
        t["scenes"] = [[64, 80, 2]] if c["dataset"] == "floodplanet" else [[32, 32, 12]]
    else:
        t.update(tile=32, batch=4, check_requests=2)
        t["roots"] = ([[[70, 90]], [[40, 50]]] if c["dataset"] == "floodplanet"
                      else [[[32, 32, 3]], [[32, 32, 2]]])
    return spec


def _run(spec, tmp_path) -> dict:
    os.environ["TMPDIR"] = str(tmp_path)
    driver = harness.driver(spec["traffic"]["kind"])
    return driver.run(spec, SEED, 0.3, False, CPU, time.perf_counter(), str(tmp_path / "w"))


def _unchanged(step):
    """A train step that returns its state as it found it."""

    def unchanged(state, batch):
        saved = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
        state, logs = step(state, batch)
        state.model.load_state_dict(saved)
        state.optimizer.state.clear()
        return state, logs

    return unchanged


def _half_batch(step):
    """Half of the batch left out, the mean taken over the rest."""

    def half(state, batch):
        n = batch["image"].shape[0] // 2
        return step(state, {k: v[:n] for k, v in batch.items()})

    return half


def _no_update(step):
    """The optimizer's update skipped: the parameters stay, the BatchNorm
    running statistics still move."""

    def no_update(state, batch):
        state.optimizer.step = lambda *args, **kwargs: None
        try:
            return step(state, batch)
        finally:
            del state.optimizer.step

    return no_update


def _plant(monkeypatch, fault):
    """Every train step that ``make_train_step`` builds from now on is
    ``fault`` around the port's own."""
    from floodplanet_code_tpu_torch.train import fit

    make = fit.make_train_step
    monkeypatch.setattr(fit, "make_train_step", lambda *a, **k: fault(make(*a, **k)))


@pytest.mark.parametrize("cell", ["ef_ps.train", "lf_s1.train"])
def test_training_faults_fail(cell, tmp_path, monkeypatch):
    spec = _spec(cell)
    assert judge.passes(_run(spec, tmp_path)["checks"])  # a sound run meets the limits
    for fault in (_unchanged, _half_batch, _no_update):
        with monkeypatch.context() as patch:
            _plant(patch, fault)
            out = _run(spec, tmp_path)
        assert not judge.passes(out["checks"]), (fault.__name__, out["checks"])
        if fault is not _half_batch:  # no parameter moves: 1 by the measure itself
            assert out["numbers"]["change"] == 1.0, out["numbers"]
            assert out["checks"]["change"]["value"] > out["checks"]["change"]["limit"]


@pytest.mark.parametrize("cell", ["ef_ps.infer", "lf_s1.infer_tta"])
def test_an_altered_mask_fails(cell, tmp_path, monkeypatch):
    from floodplanet_code_tpu_torch.geo import tiff

    spec = _spec(cell)
    assert judge.passes(_run(spec, tmp_path)["checks"])
    write = tiff.imwrite

    def imwrite(path, array, *args, **kwargs):
        array = np.array(array)
        array[:16, :16] = 255 - array[:16, :16]  # one corner of each mask flipped
        return write(path, array, *args, **kwargs)

    monkeypatch.setattr(tiff, "imwrite", imwrite)
    out = _run(spec, tmp_path)
    assert not judge.passes(out["checks"]), out["checks"]


@pytest.mark.parametrize("cell", ["ef_ps.train", "lf_s1.train", "ef_ps.infer",
                                  "lf_s1.infer_tta"])
def test_the_control_fails(cell):
    """The reference in fp8 in the system's place, against the float32
    reference, is not correct under the cell's limits. (At base 8 the
    late-fusion model's TTA output has no pixel near a tie on some seeds,
    and then no precision flips one; seed 5 is not such a seed.)"""
    spec = _spec(cell)
    upper = (calibrate.train_upper if spec["traffic"]["kind"] == "train_loop"
             else calibrate.serve_upper)(spec, 5, CPU)
    assert not judge.passes(judge.within(upper["control"], spec["limits"])), upper
