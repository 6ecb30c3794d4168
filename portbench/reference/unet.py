"""The FloodPlanet UNet in plain PyTorch, float32, written from the
reference's description (st_water_seg models/unet.py, ef_model.py,
lf_model.py): DoubleConv (3x3 conv, BatchNorm, ReLU, twice), four 2x2 max
pools down to 8·base channels, four bilinear 2x upsamples (align_corners
False) with pad-to-match and the skip concatenated first, a 1x1 head with a
bias. The late-fusion model runs one encoder per modality and a biased 1x1
conv per level over the concatenated pyramids before the shared decoder.

Everything is a function of a flat dict of named tensors; the names are the
ones the system under test loads (``load_state_dict``), so one dict of
weights made by the benchmark serves both sides. No kernel, cache or
batching of the system runs here: ``torch`` operations only. TF32 must be
off on a card (``no_tf32``) for this to be float32.

``quant`` (optional): a rounding applied wherever a network computed in a
narrower type would store a value: the input, every conv's weight, bias
and output, every BatchNorm-ReLU's output and every upsample's output.
With ``bf16_round`` that is the system's own bfloat16 arithmetic (a
witness); with ``fp8_quant`` the next precision below it (the control of
``judge.py``).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

EPS = 1e-5
MOMENTUM = 0.9  # running = MOMENTUM * running + (1 - MOMENTUM) * batch


@contextlib.contextmanager
def no_tf32():
    """float32 matmuls and convolutions in float32 (not TF32) inside."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn


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


def tensor_shapes(model: str, in_channels: int, n_classes: int, base: int) -> list:
    """[(name, shape, kind)] of every parameter and running statistic, kind
    one of conv (3x3 or 1x1 weight), conv_bias, scale, bias, mean, var."""
    encoders, dec = _prefixes(model)
    c = base
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


def cross_entropy(logits, target, ignore_index: int):
    """Mean cross entropy over the pixels whose target is a class other than
    ``ignore_index`` (targets outside [0, n_classes) count for nothing)."""
    n_classes = logits.shape[1]
    valid = (target != ignore_index) & (target >= 0) & (target < n_classes)
    logp = torch.log_softmax(logits, dim=1)
    picked = logp.gather(1, target.clamp(0, n_classes - 1).long()[:, None])[:, 0]
    return -(picked * valid).sum() / valid.sum().clamp_min(1)


def train_steps(model: str, weights: dict, batches: list, ignore_index: int, lr: float,
                quant=None) -> dict:
    """Adam (betas 0.9, 0.999, eps 1e-8, bias-corrected) steps of the masked
    cross entropy, one per (image NCHW, target) of ``batches``, from
    ``weights``. Returns each step's loss, the first step's gradients, and
    the parameters and running statistics after the last step."""
    stats = {k for k in weights if k.endswith((".mean", ".var"))}
    params = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()
              if k not in stats}
    running = {k: weights[k].detach().clone() for k in stats}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first_grads = [], None
    for t, (image, target) in enumerate(batches, start=1):
        net = UNet(model, {**params, **running}, train=True, quant=quant)
        loss = cross_entropy(net(image), target, ignore_index)
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        running.update(net.running)
        with torch.no_grad():
            if first_grads is None:
                first_grads = {k: g.clone() for k, g in zip(params, grads)}
            for (k, p), g in zip(params.items(), grads):
                m[k].mul_(0.9).add_(g, alpha=0.1)
                v2[k].mul_(0.999).addcmul_(g, g, value=0.001)
                step = lr / (1 - 0.9 ** t)
                denom = (v2[k] / (1 - 0.999 ** t)).sqrt().add_(1e-8)
                p.addcdiv_(m[k], denom, value=-step)
    after = {k: v.detach() for k, v in params.items()}
    after.update(running)
    return {"losses": losses, "first_grads": first_grads, "after": after}


def d4_probabilities(model: str, weights: dict, image, tta: bool, quant=None):
    """Eval-mode softmax [B, H, W, n_classes]; ``tta``: the mean over the
    eight dihedral transforms of a square input, each mapped back."""
    net = UNet(model, weights, train=False, quant=quant)
    if not tta:
        return torch.softmax(net(image), dim=1).permute(0, 2, 3, 1)
    total = 0
    for t in (False, True):
        for fh in (False, True):
            for fw in (False, True):
                x = image.transpose(2, 3) if t else image
                x = x.flip(2) if fh else x
                x = x.flip(3) if fw else x
                p = torch.softmax(net(x), dim=1)
                p = p.flip(2) if fh else p
                p = p.flip(3) if fw else p
                total = total + (p.transpose(2, 3) if t else p)
    return (total / 8).permute(0, 2, 3, 1)


def batch_statistics(model: str, weights: dict, image) -> dict:
    """Every BatchNorm's mean and variance over ``image``'s batch in train
    mode: running statistics under which the eval forward normalizes such
    inputs as training would."""
    net = UNet(model, weights, train=True)
    with torch.no_grad():
        net(image)
    return net.batch


def bf16_round(x):
    """Round to bfloat16 and back; gradients pass straight through."""
    return x + (x.to(torch.bfloat16).to(x.dtype) - x).detach()


def fp8_quant(x):
    """Round to float8 e4m3 with one scale per tensor (its largest magnitude
    to 448, e4m3's largest finite value), back to float32."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / 448.0
    q = (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()  # the rounding passes gradients straight through
