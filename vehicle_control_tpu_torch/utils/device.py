"""Where the port runs: the card, unless the caller asks for the CPU."""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def require_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``; raise if it is the card and the
    machine has none (no fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card unless the caller "
                           "passes device='cpu'")
    return device
