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
