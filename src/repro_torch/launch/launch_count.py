"""Kernel-launch counters and the launch budgets of the two paths.

Each kernel wrapper (``kernels/fused_input.py``, ``fused_layer.py``,
``infer_head.py``, ``loss_head.py``, ``block_diag.py``, ``seg_act.py``,
``m3_matmul.py``, ``flash_attn.py``, ``grouped_gemm.py``) keeps plain integer
counters that it raises by one where it launches a
CUDA kernel; on a CPU tensor the dispatch layer (``kernels/ops.py``)
counts the plain version's calls in the same counter.  So the budgets below are checked the same way on either
device.  The training forwards (the kernels with g' in their epilogue)
count under the serving forwards' names: they are the same kernels.  The
int8 serving kernels count under names of their own (``*_int8``), so a run
shows which weights it served, and so do the bf16 instances of the bf16
compute policy (``*_bf16``: the fused input and mid layers, both
directions, the two heads, the unfused route's block-diagonal GEMM and
dW, the three M3 kernels; ``*_int8_bf16``: the int8 kernels on bf16
activations), so a run shows which policy it ran.  The segmented
activation keeps its f32 names under the policy, which hands it f32; its
bf16 instances (``seg_act_bf16``, ``seg_act_bwd_bf16``) count the kernel
API's calls on bf16 h.  The
unfused route's backward dh is the forward block-diagonal kernel on
transposed tiles, and counts as ``block_diag_fwd`` (``_bf16``), as in the
JAX package.  ``flash_attention`` counts its
forwards only: its backward recomputes through the dense plain version and
launches nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (block_diag, flash_attn, fused_input,
                                 fused_layer, grouped_gemm, infer_head,
                                 loss_head, m3_matmul, seg_act)

# kernel name → (module, counter attribute)
_COUNTERS = {
    "fused_input": (fused_input, "launches"),
    "fused_input_int8": (fused_input, "int8_launches"),
    "fused_input_int8_bf16": (fused_input, "bf16_int8_launches"),
    "fused_input_bwd": (fused_input, "bwd_launches"),
    "fused_input_bf16": (fused_input, "bf16_launches"),
    "fused_input_bwd_bf16": (fused_input, "bf16_bwd_launches"),
    "fused_layer": (fused_layer, "launches"),
    "fused_layer_int8": (fused_layer, "int8_launches"),
    "fused_layer_int8_bf16": (fused_layer, "bf16_int8_launches"),
    "fused_layer_dx_dw": (fused_layer, "dx_dw_launches"),
    "fused_layer_bf16": (fused_layer, "bf16_launches"),
    "fused_layer_dx_dw_bf16": (fused_layer, "bf16_dx_dw_launches"),
    "infer_head": (infer_head, "launches"),
    "infer_head_int8": (infer_head, "int8_launches"),
    "infer_head_int8_bf16": (infer_head, "bf16_int8_launches"),
    "infer_head_bf16": (infer_head, "bf16_launches"),
    "loss_head_fwd": (loss_head, "fwd_launches"),
    "loss_head_bwd": (loss_head, "bwd_launches"),
    "loss_head_fwd_bf16": (loss_head, "bf16_fwd_launches"),
    "loss_head_bwd_bf16": (loss_head, "bf16_bwd_launches"),
    "block_diag_fwd": (block_diag, "fwd_launches"),
    "block_diag_dw": (block_diag, "dw_launches"),
    "block_diag_fwd_bf16": (block_diag, "bf16_fwd_launches"),
    "block_diag_dw_bf16": (block_diag, "bf16_dw_launches"),
    "seg_act": (seg_act, "launches"),
    "seg_act_bwd": (seg_act, "bwd_launches"),
    "seg_act_bf16": (seg_act, "bf16_launches"),
    "seg_act_bwd_bf16": (seg_act, "bf16_bwd_launches"),
    "m3_matmul_fwd": (m3_matmul, "fwd_launches"),
    "m3_matmul_dh": (m3_matmul, "dh_launches"),
    "m3_matmul_dw": (m3_matmul, "dw_launches"),
    "m3_matmul_fwd_bf16": (m3_matmul, "bf16_fwd_launches"),
    "m3_matmul_dh_bf16": (m3_matmul, "bf16_dh_launches"),
    "m3_matmul_dw_bf16": (m3_matmul, "bf16_dw_launches"),
    "flash_attention": (flash_attn, "launches"),
    "moe_gemm": (grouped_gemm, "launches"),
}


def kernel_launches() -> dict[str, int]:
    """{kernel name: launches counted so far}."""
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _COUNTERS.items()}


def reset_kernel_launches():
    """Set every kernel's counter to 0."""
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)


def fused_infer_budget(depth: int) -> dict:
    """The forward-only serving path (``forward(infer=True)`` with fused
    routing, f32 or int8 weights): input + (depth−1) mid layers + infer
    head = depth+1 launches per request batch, independent of batch
    size."""
    return {"fwd": depth + 1, "total": depth + 1}


def _suffix(compute_dtype=None, weights_dtype=None) -> str:
    """The counter names' suffix of a policy: "" (f32), "_bf16" (the bf16
    compute policy), "_int8" (the int8 serve copy) or "_int8_bf16" (the
    int8 copy under the bf16 policy)."""
    bf = "_bf16" if compute_dtype in ("bfloat16", torch.bfloat16) else ""
    return ("_int8" if weights_dtype == "int8" else "") + bf


def fused_infer_kernels(depth: int, compute_dtype=None,
                        weights_dtype=None) -> dict:
    """``fused_infer_budget`` kernel by kernel, under the names of the
    policy's instances: a bf16 forward launches ``*_bf16`` kernels only, an
    int8 one ``*_int8`` only."""
    sfx = _suffix(compute_dtype, weights_dtype)
    out = {"fused_input" + sfx: 1, "fused_layer" + sfx: depth - 1,
           "infer_head" + sfx: 1}
    return {k: v for k, v in out.items() if v}


def fused_step_kernels(depth: int, compute_dtype=None) -> dict:
    """``fused_step_budget`` kernel by kernel (the training forwards count
    under the serving names), under the names of the compute policy's
    instances: a bf16 step launches ``*_bf16`` kernels only."""
    sfx = _suffix(compute_dtype)
    out = {"fused_input" + sfx: 1, "fused_input_bwd" + sfx: 1,
           "fused_layer" + sfx: depth - 1,
           "fused_layer_dx_dw" + sfx: depth - 1,
           "loss_head_fwd" + sfx: 1, "loss_head_bwd" + sfx: 1}
    return {k: v for k, v in out.items() if v}


def fused_step_budget(depth: int) -> dict:
    """The fused training step (``bd_impl="fused"`` with default input and
    loss routing): one launch per layer per direction — input + (depth−1)
    mid layers + loss head — so 2·(depth+1) per step at any batch size."""
    per_dir = depth + 1
    return {"fwd": per_dir, "bwd": per_dir, "total": 2 * per_dir}


def m3_step_launches(compute_dtype=None) -> dict:
    """The M3 head of one training step (``m3_impl="pallas"`` on an
    unfused loss — the single-layer ``parallel_mlp`` and the layered
    engine's ``loss_impl="xla"``): one forward, then dh and dW2, under the
    names of the compute policy's instances."""
    sfx = _suffix(compute_dtype)
    return {"m3_matmul_fwd" + sfx: 1, "m3_matmul_dh" + sfx: 1,
            "m3_matmul_dw" + sfx: 1}


def unfused_infer_launches(depth: int, m3_impl: str = "bucketed",
                           compute_dtype=None) -> dict:
    """The unfused route's forward (``bd_impl="pallas"``,
    ``act_impl="pallas"``; the input projection is plain PyTorch): one
    ``seg_act`` per layer and one ``block_diag_fwd`` per mid layer, per
    request batch; with ``m3_impl="pallas"`` the head is one
    ``m3_matmul_fwd`` too (else plain PyTorch).  Under bf16 the
    projections count as ``*_bf16``, the activations (f32) as they are."""
    sfx = _suffix(compute_dtype)
    out = {"seg_act": depth, "block_diag_fwd" + sfx: depth - 1}
    if m3_impl == "pallas":
        out["m3_matmul_fwd" + sfx] = 1
    return {k: v for k, v in out.items() if v}


def unfused_step_launches(depth: int, m3_impl: str = "bucketed",
                          compute_dtype=None) -> dict:
    """The unfused route's training step: the forward's launches, then per
    layer one ``seg_act_bwd`` and per mid layer dh (a ``block_diag_fwd``
    on the transposed tiles) and one ``block_diag_dw``; with
    ``m3_impl="pallas"`` the head's ``m3_step_launches`` too.  Under bf16
    the projections' kernels count as ``*_bf16``."""
    sfx = _suffix(compute_dtype)
    out = {"seg_act": depth, "seg_act_bwd": depth,
           "block_diag_fwd" + sfx: 2 * (depth - 1),
           "block_diag_dw" + sfx: depth - 1}
    if m3_impl == "pallas":
        out.update(m3_step_launches(compute_dtype))
    return {k: v for k, v in out.items() if v}
