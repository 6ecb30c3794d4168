"""The toy model as the port would hold it (``toy.py`` is its plain
reference), for tests that register it with the port's ``MODELS`` through
``monkeypatch``: built by ``build_model`` by its name, called with the
batch dict, parameters under the reference's names."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class ToySeg(nn.Module):
    def __init__(self, in_channels: int, n_classes: int, width: int = 8,
                 dtype: torch.dtype = torch.float32, conv_impl: str = "xla"):
        super().__init__()
        self.dtype = dtype
        self.stem = nn.Conv2d(in_channels, width, 3, stride=2, padding=1)
        self.norm = nn.LayerNorm(width, eps=1e-6)
        self.fc1 = nn.Linear(width, 2 * width)
        self.fc2 = nn.Linear(2 * width, width)
        self.head = nn.Conv2d(width, n_classes, 1)

    def forward(self, batch: dict) -> torch.Tensor:
        t = self.stem(batch["image"].to(self.dtype)).permute(0, 2, 3, 1)
        t = t + self.fc2(F.gelu(self.fc1(self.norm(t))))
        x = F.interpolate(t.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
                          align_corners=False)
        return self.head(x)
