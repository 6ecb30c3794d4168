"""The UNet reference's operation counts (``reference/unet.py::work``,
summed by ``portbench/counts.py``) against a count by hand at the
configurations' real widths, and against torch's FLOP counter on the plain
reference model."""

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import counts
from portbench.reference import unet as runet

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as handle:
        return json.load(handle)


def _hand(c_in, base, n_classes, batch, h, late):
    """Every conv written out: (H, W, C_in, C_out, k) by level, H // 2**l."""
    c = base
    s = [(h >> l, h >> l) for l in range(5)]
    rows = [(*s[0], c_in, c, 3), (*s[0], c, c, 3),            # inc
            (*s[1], c, 2 * c, 3), (*s[1], 2 * c, 2 * c, 3),   # down1
            (*s[2], 2 * c, 4 * c, 3), (*s[2], 4 * c, 4 * c, 3),
            (*s[3], 4 * c, 8 * c, 3), (*s[3], 8 * c, 8 * c, 3),
            (*s[4], 8 * c, 8 * c, 3), (*s[4], 8 * c, 8 * c, 3)]  # down4
    if late:
        rows += [(*s[0], c, c, 1), (*s[1], 2 * c, 2 * c, 1), (*s[2], 4 * c, 4 * c, 1),
                 (*s[3], 8 * c, 8 * c, 1), (*s[4], 8 * c, 8 * c, 1)]
    rows += [(*s[3], 16 * c, 8 * c, 3), (*s[3], 8 * c, 4 * c, 3),  # up1
             (*s[2], 8 * c, 4 * c, 3), (*s[2], 4 * c, 2 * c, 3),
             (*s[1], 4 * c, 2 * c, 3), (*s[1], 2 * c, c, 3),
             (*s[0], 2 * c, c, 3), (*s[0], c, c, 3),            # up4
             (*s[0], c, n_classes, 1)]                          # head
    return [2.0 * batch * hh * ww * ci * co * k * k for hh, ww, ci, co, k in rows]


@pytest.mark.parametrize("name,late", [("ef_unet_ps", False), ("lf_unet_s1f11", True)])
def test_counts_match_a_hand_count_at_the_real_widths(name, late):
    cfg = _config(name)
    base, crop, batch = cfg["model_kwargs"]["base_feat_channels"], cfg["crop"], cfg["batch_size"]
    ops = runet.work(cfg, batch, crop, crop)
    hand = _hand(cfg["in_channels"], base, cfg["n_classes"], batch, crop, late)
    assert [op.flops["fwd"] for op in ops] == hand and {op.kind for op in ops} == {"conv"}
    assert counts.forward_flops(ops) == sum(hand)
    assert counts.train_flops(ops) == 3 * sum(hand) - hand[0]
    # the EF forward of one 300^2 tile is 0.113 TFLOP (bench_torch.py's
    # 0.33 TFLOP a 512^2 tile, scaled by the pixels, less the odd levels)
    if name == "ef_unet_ps":
        assert 0.10e12 < sum(hand) / batch < 0.12e12


@pytest.mark.parametrize("name", ["ef_unet_ps", "lf_unet_s1f11"])
def test_counts_match_torch_flop_counter_on_the_reference(name):
    cfg = _config(name)
    p = {n: torch.zeros(s, device="meta") for n, s, _ in runet.tensor_shapes(cfg)}
    x = torch.zeros((2, cfg["in_channels"], cfg["crop"], cfg["crop"]), device="meta")
    with FlopCounterMode(display=False) as counter:
        runet.UNet(cfg["model"], p, train=False)(x)
    got = counter.get_flop_counts()["Global"][torch.ops.aten.convolution]
    assert got == counts.forward_flops(runet.work(cfg, 2, cfg["crop"], cfg["crop"]))


def test_bytes_and_bound_of_one_conv():
    c = counts.conv("x", 10, 300, 300, 64, 64, 3, 2)
    x = y = 10 * 300 * 300 * 64 * 2
    w = 64 * 64 * 9 * 2
    assert c.bytes == {"fwd": x + w + y, "dgrad": y + w + x, "wgrad": x + y + w}
    flops = 2 * 10 * 300 * 300 * 64 * 64 * 9
    one = max(flops / 989e12, (x + w + y) / 3.35e12)
    forward = counts.by_kind([c], "bfloat16", False)
    assert forward == {"conv": {"flops": flops, "bytes": x + w + y, "bound_s": one}}
    assert counts.by_kind([c], "bfloat16", True)["conv"]["bound_s"] == pytest.approx(3 * one)
    # training: an input that needs no gradient has no dgrad
    first = counts.conv("x", 10, 300, 300, 64, 64, 3, 2, dgrad=False)
    assert counts.by_kind([first], "bfloat16", True)["conv"]["bound_s"] == pytest.approx(2 * one)
