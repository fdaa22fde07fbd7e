"""Kernel-launch counters and the serving path's launch budget.

Each kernel wrapper (``kernels/fused_input.py``, ``fused_layer.py``,
``infer_head.py``) keeps a plain integer ``launches`` that it raises by one
where it launches its CUDA kernel; on a CPU tensor the dispatch layer
(``kernels/ops.py``) counts the plain version's calls in the same counter.
So the budget below is checked the same way on either device.
"""
from __future__ import annotations

from repro_torch.kernels import fused_input, fused_layer, infer_head

_KERNELS = {"fused_input": fused_input, "fused_layer": fused_layer,
            "infer_head": infer_head}


def kernel_launches() -> dict[str, int]:
    """{kernel name: launches counted so far}."""
    return {name: mod.launches for name, mod in _KERNELS.items()}


def reset_kernel_launches():
    """Set every kernel's counter to 0."""
    for mod in _KERNELS.values():
        mod.launches = 0


def fused_infer_budget(depth: int) -> dict:
    """The forward-only serving path (``forward(infer=True)`` with fused
    routing): input + (depth−1) mid layers + infer head = depth+1 launches
    per request batch, independent of batch size."""
    return {"fwd": depth + 1, "total": depth + 1}
