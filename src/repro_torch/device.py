"""The device an entry point runs on, and the device copies of a layout's
static arrays.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
There is no fallback: asking for the card where there is none raises.

``table_builds`` counts the device tables built for layouts (a static
layout array here, a kernel's schedule or work table in ``kernels/``): a
rung that keeps its layout must build none.
"""
from __future__ import annotations

import numpy as np
import torch

table_builds = 0     # device tables built for layouts so far


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


def layout_tensor(layout, name, device, arr, dtype) -> torch.Tensor:
    """A static layout array as a tensor on ``device``, built once per
    (layout, name, device) and kept on the layout instance, so the hot
    path copies no layout data per call.  Built as a normal tensor even
    when first asked for under ``inference_mode``, so that training may
    save it for backward."""
    global table_builds
    cache = layout.__dict__.setdefault("_device_cache", {})
    key = (name, str(torch.device(device)))
    if key not in cache:
        table_builds += 1
        with torch.inference_mode(False):
            cache[key] = torch.as_tensor(np.asarray(arr), dtype=dtype,
                                         device=device)
    return cache[key]
