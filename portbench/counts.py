"""Work of the UNet's convolutions, from the configuration's shapes alone.

Extended from the repository's ``bench_torch.py::conv_flops`` (which reads
the same shapes from a model's forward): every conv at the height and width
it runs at, 2·N·H·W·C_in·C_out·k² operations. The count is the algorithm's,
so it is the same whichever implementation runs a conv (cuDNN or the
hand-written fused kernel):

- the early- and late-fusion UNets' nine DoubleConvs (eighteen 3x3 convs)
  and the 1x1 head; the late-fusion model's per-level 1x1 fusion convs;
- a training step is the forward, each conv's input gradient (dgrad) and
  weight gradient (wgrad), each as much work as its forward, less the first
  conv's input gradient, which nothing needs: 3 x forward - that dgrad;
- bytes: each conv's inputs read once and its output written once, in the
  compute dtype: forward x, w -> y; dgrad dy, w -> dx; wgrad x, dy -> dw.

A 2x2 max pool floors odd sizes, and the decoder pads each upsample to the
skip's size, so level l of an input H is H // 2**l.
"""

from __future__ import annotations

from dataclasses import dataclass

# Published dense peaks of one NVIDIA H100 SXM (data sheet, 700 W, no
# sparsity): FLOP/s by compute dtype, and HBM3 bytes/s.
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


@dataclass(frozen=True)
class Conv:
    name: str
    n: int
    h: int
    w: int
    c_in: int
    c_out: int
    k: int

    @property
    def flops(self) -> float:
        return 2.0 * self.n * self.h * self.w * self.c_in * self.c_out * self.k * self.k

    def bytes(self, size: int) -> dict:
        """Bytes of the forward, dgrad and wgrad at ``size`` bytes a value."""
        x = self.n * self.h * self.w * self.c_in * size
        y = self.n * self.h * self.w * self.c_out * size
        w = self.c_in * self.c_out * self.k * self.k * size
        return {"fwd": x + w + y, "dgrad": y + w + x, "wgrad": x + y + w}


def convs(model: str, in_channels: int, n_classes: int, base: int, batch: int,
          height: int, width: int) -> list[Conv]:
    """Every conv of one forward, in order."""
    c = base
    hw = [(height >> level, width >> level) for level in range(5)]
    out = []

    def double(name, level, c_in, c_mid, c_out):
        h, w = hw[level]
        out.append(Conv(name + ".conv0", batch, h, w, c_in, c_mid, 3))
        out.append(Conv(name + ".conv1", batch, h, w, c_mid, c_out, 3))

    double("inc", 0, in_channels, c, c)
    for level, (ci, co) in enumerate([(c, 2 * c), (2 * c, 4 * c), (4 * c, 8 * c),
                                      (8 * c, 8 * c)], start=1):
        double(f"down{level}", level, ci, co, co)
    if model == "lf_model":
        for level, w in enumerate((c, 2 * c, 4 * c, 8 * c, 8 * c)):
            out.append(Conv(f"concat{level}", batch, *hw[level], w, w, 1))
    elif model not in ("ef_model", "ms_model"):
        raise ValueError(f"no conv count for model {model!r}")
    for i, (level, ci, cm, co) in enumerate([(3, 16 * c, 8 * c, 4 * c), (2, 8 * c, 4 * c, 2 * c),
                                             (1, 4 * c, 2 * c, c), (0, 2 * c, c, c)], start=1):
        double(f"up{i}", level, ci, cm, co)
    out.append(Conv("outc", batch, *hw[0], c, n_classes, 1))
    return out


def forward_flops(cs: list[Conv]) -> float:
    return sum(c.flops for c in cs)


def train_flops(cs: list[Conv]) -> float:
    """3 x forward, less the first conv's input gradient."""
    return 3.0 * forward_flops(cs) - cs[0].flops


def bound_seconds(cs: list[Conv], dtype: str, train: bool) -> float:
    """The least time the card could take for these convs: per conv and
    pass, the larger of operations over the peak and bytes over the
    bandwidth, summed (a forward; with ``train`` also every dgrad but the
    first conv's, and every wgrad)."""
    peak, size = PEAK_FLOPS[dtype], DTYPE_BYTES[dtype]
    total = 0.0
    for i, c in enumerate(cs):
        passes = ("fwd", "dgrad", "wgrad") if train else ("fwd",)
        for p in passes:
            if p == "dgrad" and i == 0:
                continue
            total += max(c.flops / peak, c.bytes(size)[p] / PEAK_BYTES)
    return total
