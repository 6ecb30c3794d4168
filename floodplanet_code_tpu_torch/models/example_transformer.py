"""Standalone example: a small ViT-style transformer for tile encoding. The
port of ``floodplanet_code_tpu/models/example_transformer.py``.

Parity note: the reference carries ``models/example_transformer.py`` — a
never-imported scratch demo of nn.TransformerEncoder with sinusoidal feature
encoding and a learned special token (example_transformer.py:5-57). Like
the JAX package's, this one is a standalone demo that nothing imports:
patchify -> positional encoding -> pre-LN encoder blocks -> special-token
readout, with flax's arithmetic (``nn.LayerNorm`` at eps 1e-6, the tanh
``gelu``, and ``MultiHeadDotProductAttention``: q, k and v projections with
bias, the query scaled by 1/sqrt(head_dim), softmax, an output projection).
``tools/import_jax_params.py::example_transformer_state_dict`` carries
flax parameters across. Plain PyTorch: the JAX module has no kernel of its
own.

Run: python -m floodplanet_code_tpu_torch.models.example_transformer [--device cpu]
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from floodplanet_code_tpu_torch.device import resolve_device

_LN_EPS = 1e-6  # flax nn.LayerNorm's default


def sinusoidal_positions(n_positions: int, d_model: int) -> torch.Tensor:
    """Fixed sinusoidal positional features (reference feature_encoding:5)."""
    position = np.arange(n_positions)[:, None]
    div = np.exp(np.arange(0, d_model, 2) * (-np.log(10000.0) / d_model))
    table = np.zeros((n_positions, d_model), np.float32)
    table[:, 0::2] = np.sin(position * div)
    table[:, 1::2] = np.cos(position * div)
    return torch.from_numpy(table)


class EncoderBlock(nn.Module):
    """Pre-LN block: x + attention(LN(x)), then x + MLP(LN(x))."""

    def __init__(self, d_model: int, n_heads: int = 4, mlp_ratio: int = 4):
        super().__init__()
        self.n_heads = n_heads
        self.norm0 = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.mlp0 = nn.Linear(d_model, d_model * mlp_ratio)
        self.mlp1 = nn.Linear(d_model * mlp_ratio, d_model)

    def attention(self, h: torch.Tensor) -> torch.Tensor:
        b, n, d = h.shape
        heads = (b, n, self.n_heads, d // self.n_heads)
        q = self.query(h).view(heads) / math.sqrt(d // self.n_heads)
        k, v = self.key(h).view(heads), self.value(h).view(heads)
        weights = torch.einsum("bqhd,bkhd->bhqk", q, k).softmax(dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, n, d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(self.norm0(x))
        h = F.gelu(self.mlp0(self.norm1(x)), approximate="tanh")
        return x + self.mlp1(h)


class ExampleTileTransformer(nn.Module):
    """Patchify a tile and encode it with a learned special token.

    ``forward`` takes [B, H, W, C] (the JAX module's layout) and returns
    the special token's features [B, d_model].
    """

    def __init__(self, in_channels: int = 4, d_model: int = 128, n_layers: int = 2,
                 patch: int = 16):
        super().__init__()
        self.patch = patch
        self.embed = nn.Conv2d(in_channels, d_model, patch, stride=patch)
        # Learned special token (reference special_token:23).
        self.special_token = nn.Parameter(0.02 * torch.randn(1, 1, d_model))
        self.blocks = nn.ModuleList(EncoderBlock(d_model) for _ in range(n_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch
        pad_h, pad_w = -x.shape[1] % p, -x.shape[2] % p  # flax's SAME padding
        x = F.pad(x.permute(0, 3, 1, 2),
                  (pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2))
        tokens = self.embed(x).flatten(2).transpose(1, 2)  # [B, ph*pw, d], row-major
        b, n, d = tokens.shape
        tokens = tokens + sinusoidal_positions(n, d).to(tokens.device)[None]
        tokens = torch.cat([self.special_token.expand(b, 1, d), tokens], dim=1)
        for block in self.blocks:
            tokens = block(tokens)
        return tokens[:, 0]  # special-token readout


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    model = ExampleTileTransformer().to(device)
    x = torch.zeros((2, 64, 64, 4), device=device)
    with torch.no_grad():
        out = model(x)
    print(f"Input shape: {tuple(x.shape)}")
    print(f"Output shape: {tuple(out.shape)}")


if __name__ == "__main__":
    main()
