"""The device an entry point runs on.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
There is no fallback: asking for the card where there is none raises.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` → the card.  Raises if a CUDA device is asked for and none
    is visible, or for a device type the port has no path for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible (torch.cuda.is_available() is "
            "false); the port has no CPU fallback — pass device='cpu' to "
            "run the kernels' plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no path for device {dev}")
    return dev
