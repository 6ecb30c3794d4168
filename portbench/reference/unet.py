"""The FloodPlanet UNet in plain PyTorch, float32, written from the
reference's description (st_water_seg models/unet.py, ef_model.py,
lf_model.py): DoubleConv (3x3 conv, BatchNorm, ReLU, twice), four 2x2 max
pools down to 8·base channels, four bilinear 2x upsamples (align_corners
False) with pad-to-match and the skip concatenated first, a 1x1 head with a
bias. The late-fusion model runs one encoder per modality and a biased 1x1
conv per level over the concatenated pyramids before the shared decoder.

The reference module of the configurations whose file says ``"reference":
"unet"`` (``model`` ``ef_model``, ``lf_model`` or ``ms_model``, and
``model_kwargs.base_feat_channels``): the six functions of the interface
(``portbench/reference/__init__.py``), everything UNet-specific of the
benchmark.

Everything is a function of a flat dict of named tensors; the names are the
ones the system under test loads (``load_state_dict``), so one dict of
weights made by the benchmark serves both sides. No kernel, cache or
batching of the system runs here: ``torch`` operations only. TF32 must be
off on a card (``common.no_tf32``) for this to be float32.

``quant`` (optional): a rounding applied wherever a network computed in a
narrower type would store a value: the input, every conv's weight, bias
and output, every BatchNorm-ReLU's output and every upsample's output.
With ``common.bf16_round`` that is the system's own bfloat16 arithmetic (a
witness); with ``common.fp8_quant`` the next precision below it (the
control of ``judge.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench import counts, inputs
from portbench.reference import common

EPS = 1e-5
MOMENTUM = 0.9  # running = MOMENTUM * running + (1 - MOMENTUM) * batch


def _prefixes(model: str) -> tuple[list[str], str]:
    """(encoder prefixes, decoder prefix) of a model's parameter names."""
    if model == "lf_model":
        return ["encoders.ms_image."], "decoder."
    if model in ("ef_model", "ms_model"):
        return ["unet.encoder."], "unet.decoder."
    raise ValueError(f"no reference for model {model!r}")


def _double_conv_shapes(prefix: str, c_in: int, c_mid: int, c_out: int) -> list:
    return [(prefix + "conv0.weight", (c_mid, c_in, 3, 3), "conv"),
            *[(prefix + f"bn0.{k}", (c_mid,), k) for k in ("scale", "bias", "mean", "var")],
            (prefix + "conv1.weight", (c_out, c_mid, 3, 3), "conv"),
            *[(prefix + f"bn1.{k}", (c_out,), k) for k in ("scale", "bias", "mean", "var")]]


def tensor_shapes(config: dict) -> list:
    """[(name, shape, kind)] of every parameter and running statistic, kind
    one of conv (3x3 or 1x1 weight), conv_bias, scale, bias, mean, var."""
    model, in_channels, n_classes = config["model"], config["in_channels"], config["n_classes"]
    encoders, dec = _prefixes(model)
    c = config["model_kwargs"]["base_feat_channels"]
    out = []
    for enc in encoders:
        out += _double_conv_shapes(enc + "inc.", in_channels, c, c)
        for i, (ci, co) in enumerate([(c, 2 * c), (2 * c, 4 * c), (4 * c, 8 * c),
                                      (8 * c, 8 * c)]):
            out += _double_conv_shapes(enc + f"down{i + 1}.double_conv.", ci, co, co)
    if model == "lf_model":
        n = len(encoders)
        for i, w in enumerate((c, 2 * c, 4 * c, 8 * c, 8 * c)):
            out += [(f"concat_convs.{i}.weight", (w, w * n, 1, 1), "conv"),
                    (f"concat_convs.{i}.bias", (w,), "conv_bias")]
    for i, (ci, cm, co) in enumerate([(16 * c, 8 * c, 4 * c), (8 * c, 4 * c, 2 * c),
                                      (4 * c, 2 * c, c), (2 * c, c, c)]):
        out += _double_conv_shapes(dec + f"up{i + 1}.double_conv.", ci, cm, co)
    out += [(dec + "outc.weight", (n_classes, c, 1, 1), "conv"),
            (dec + "outc.bias", (n_classes,), "conv_bias")]
    return out


class UNet:
    """The network over a dict ``p`` of named float32 tensors.

    ``train``: BatchNorm over the batch's statistics (biased variance), the
    new running statistics written into ``self.running``; else the running
    statistics in ``p``.
    """

    def __init__(self, model: str, p: dict, train: bool, quant=None):
        self.encoders, self.dec = _prefixes(model)
        self.late = model == "lf_model"
        self.p, self.train, self.quant = p, train, quant
        self.running: dict = {}
        self.batch: dict = {}

    def q(self, x):
        return x if self.quant is None else self.quant(x)

    def conv(self, x, name: str, padding: int, bias: str | None = None):
        b = None if bias is None else self.q(self.p[bias])
        return self.q(F.conv2d(x, self.q(self.p[name]), b, padding=padding))

    def bn_relu(self, y, prefix: str):
        scale, bias = self.p[prefix + "scale"], self.p[prefix + "bias"]
        if self.train:
            mean = y.mean(dim=(0, 2, 3))
            var = y.var(dim=(0, 2, 3), unbiased=False)
            for key, batch in (("mean", mean), ("var", var)):
                old = self.p[prefix + key].detach()
                self.running[prefix + key] = MOMENTUM * old + (1 - MOMENTUM) * batch.detach()
                self.batch[prefix + key] = batch.detach()
        else:
            mean, var = self.p[prefix + "mean"], self.p[prefix + "var"]
        inv = torch.rsqrt(var + EPS) * scale
        return self.q(F.relu((y - mean.view(1, -1, 1, 1)) * inv.view(1, -1, 1, 1)
                             + bias.view(1, -1, 1, 1)))

    def double_conv(self, x, prefix: str):
        y = self.bn_relu(self.conv(x, prefix + "conv0.weight", 1), prefix + "bn0.")
        return self.bn_relu(self.conv(y, prefix + "conv1.weight", 1), prefix + "bn1.")

    def encoder(self, x, enc: str) -> list:
        feats = [self.double_conv(x, enc + "inc.")]
        for i in range(1, 5):
            feats.append(self.double_conv(F.max_pool2d(feats[-1], 2),
                                          enc + f"down{i}.double_conv."))
        return feats

    def up(self, low, skip, prefix: str):
        up = self.q(F.interpolate(low, scale_factor=2, mode="bilinear", align_corners=False))
        dh, dw = skip.shape[2] - up.shape[2], skip.shape[3] - up.shape[3]
        up = F.pad(up, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        return self.double_conv(torch.cat([skip, up], dim=1), prefix + "double_conv.")

    def __call__(self, image):
        """image [B, C, H, W] float32 -> logits [B, n_classes, H, W]."""
        image = self.q(image)
        pyramids = [self.encoder(image, enc) for enc in self.encoders]
        if self.late:
            feats = [self.conv(torch.cat([p[i] for p in pyramids], dim=1),
                               f"concat_convs.{i}.weight", 0, f"concat_convs.{i}.bias")
                     for i in range(5)]
        else:
            feats = pyramids[0]
        x = feats[4]
        for i, skip in zip(range(1, 5), (feats[3], feats[2], feats[1], feats[0])):
            x = self.up(x, skip, self.dec + f"up{i}.")
        return self.conv(x, self.dec + "outc.weight", 0, self.dec + "outc.bias")


def weights(config: dict, seed: int, device) -> dict:
    """``inputs.weights`` of ``tensor_shapes``: He-normal convs, BatchNorm
    scale 1 + 0.1 n and bias 0.1 n, running mean 0 and variance 1."""
    return inputs.weights(tensor_shapes(config), seed, device)


def train_steps(config: dict, weights: dict, batches: list, ignore_index: int,
                quant=None) -> dict:
    """``common.adam_steps`` of the network in train mode: BatchNorm over
    each batch's statistics, the running statistics moved."""

    def forward(p, image):
        net = UNet(config["model"], p, train=True, quant=quant)
        return net(image), net.running

    stats = {k for k in weights if k.endswith((".mean", ".var"))}
    return common.adam_steps(forward, config, weights, stats, batches, ignore_index)


def probabilities(config: dict, weights: dict, image, tta: bool, quant=None):
    """Eval-mode softmax [B, H, W, n_classes] (``common.probabilities``)."""
    return common.probabilities(UNet(config["model"], weights, train=False, quant=quant),
                                image, tta)


def batch_statistics(config: dict, weights: dict, image) -> dict:
    """Every BatchNorm's mean and variance over ``image``'s batch in train
    mode: running statistics under which the eval forward normalizes such
    inputs as training would."""
    net = UNet(config["model"], weights, train=True)
    with torch.no_grad():
        net(image)
    return net.batch


def work(config: dict, batch: int, height: int, width: int) -> list:
    """Every conv of one forward, in order (``counts.conv``): the nine
    DoubleConvs' eighteen 3x3 convs and the 1x1 head; the late-fusion
    model's per-level 1x1 fusion convs. A 2x2 max pool floors odd sizes and
    the decoder pads each upsample to the skip's size, so level l of an
    input H is H // 2**l. Nothing needs the first conv's input gradient."""
    model, c = config["model"], config["model_kwargs"]["base_feat_channels"]
    size = counts.DTYPE_BYTES[config["compute_dtype"]]
    hw = [(height >> level, width >> level) for level in range(5)]
    out = []

    def add(name, level, c_in, c_out, k):
        out.append(counts.conv(name, batch, *hw[level], c_in, c_out, k, size, dgrad=bool(out)))

    def double(name, level, c_in, c_mid, c_out):
        add(name + ".conv0", level, c_in, c_mid, 3)
        add(name + ".conv1", level, c_mid, c_out, 3)

    if model not in ("ef_model", "lf_model", "ms_model"):
        raise ValueError(f"no conv count for model {model!r}")
    double("inc", 0, config["in_channels"], c, c)
    for level, (ci, co) in enumerate([(c, 2 * c), (2 * c, 4 * c), (4 * c, 8 * c),
                                      (8 * c, 8 * c)], start=1):
        double(f"down{level}", level, ci, co, co)
    if model == "lf_model":
        for level, w in enumerate((c, 2 * c, 4 * c, 8 * c, 8 * c)):
            add(f"concat{level}", level, w, w, 1)
    for i, (level, ci, cm, co) in enumerate([(3, 16 * c, 8 * c, 4 * c), (2, 8 * c, 4 * c, 2 * c),
                                             (1, 4 * c, 2 * c, c), (0, 2 * c, c, c)], start=1):
        double(f"up{i}", level, ci, cm, co)
    add("outc", 0, c, config["n_classes"], 1)
    return out
