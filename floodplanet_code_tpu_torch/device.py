"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names an absent card.

    The entry points default to ``"cuda"``. Without a card they refuse
    rather than carry on on the CPU: a caller that wants the CPU says so.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f'device "{device}" requested but no CUDA device is available; '
            'pass device="cpu" to run on the CPU'
        )
    return device


# Published dense peaks of a card, by a part of its name: (bf16 FLOP/s,
# HBM bytes/s), NVIDIA's data sheets (SXM parts, 700 W), without sparsity.
PEAKS = {"H100": (989e12, 3.35e12), "H200": (989e12, 4.8e12)}


def peaks(name: str) -> tuple[float, float]:
    """``PEAKS``' entry for a card named ``name`` (``torch.cuda.
    get_device_name``); raises for a card with none recorded."""
    for key, value in PEAKS.items():
        if key in name:
            return value
    raise RuntimeError(f"no published peaks recorded for {name!r}")
