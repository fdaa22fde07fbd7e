"""Segmented activation: a different activation per hidden block, with the
padding mask, in one pass — forward and backward.

``seg_act_cuda`` launches ``csrc/seg_act.cu`` (entry ``seg_act_f32``, the
port of the TPU kernel ``repro/kernels/seg_act.py::seg_act``): h (B, H) f32,
one activation id per block of ``blk`` columns (H / blk,) int32 and the
mask (H,) f32 → ``act(h)·mask`` (B, H).  ``seg_act_bwd_cuda`` (entry
``seg_act_bwd_f32``, the port of ``seg_act.py::seg_act_bwd``) returns
``(dy·mask)·act'(h)``.  The activations are the fused kernels' epilogue
functions (``csrc/activations.cuh``), kinks included.

Both also take bf16 h (and dy) beside the f32 mask, as JAX's kernels do
(entries ``seg_act_bf16``, ``seg_act_bwd_bf16``): h and dy widened to f32,
the function computed in f32, each output rounded once to bf16; counted
under ``bf16_launches`` / ``bf16_bwd_launches``.

Each ``*_plain`` function is the same function in plain PyTorch, on
per-column ids expanded from the per-block ones (bf16: in f32 on the
widened values, rounded once).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.activations import (apply_activation_derivs_masked,
                                          apply_activations_masked)
from repro_torch.kernels import _build

# kernel launches (the CPU dispatch in ops counts its plain calls too):
launches = 0          # the forward
bwd_launches = 0      # the backward
bf16_launches = 0     # their bf16 instances
bf16_bwd_launches = 0

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def seg_act_plain(h, ids, mask, *, blk: int):
    """→ act(h)·mask in h's dtype (bf16: computed in f32, rounded once)."""
    hf = h.to(torch.promote_types(h.dtype, torch.float32))
    return (apply_activations_masked(hf, ids.repeat_interleave(blk))
            * mask).to(h.dtype)


def seg_act_bwd_plain(h, dy, ids, mask, *, blk: int):
    """→ (dy·mask)·act'(h) in dy's dtype (bf16: computed in f32, rounded
    once)."""
    acc = torch.promote_types(h.dtype, torch.float32)
    return ((dy.to(acc) * mask) * apply_activation_derivs_masked(
        h.to(acc), ids.repeat_interleave(blk))).to(dy.dtype)


def _check(where, h, ids, mask, blk, dy=None):
    named = [("h", h, h.dtype), ("ids", ids, torch.int32),
             ("mask", mask, torch.float32)]
    if dy is not None:
        named.append(("dy", dy, h.dtype))
    _build.check_tensors(where, h, *named)
    if h.dim() != 2 or blk < 1 or h.shape[1] % blk \
            or ids.shape != (h.shape[1] // blk,) \
            or mask.shape != (h.shape[1],) \
            or (dy is not None and dy.shape != h.shape):
        raise ValueError(f"{where}: inconsistent shapes")


def seg_act_cuda(h, ids, mask, *, blk: int):
    """One launch → act(h)·mask (B, H) in h's dtype (f32 or bf16)."""
    suffix = _build.operand_suffix("seg_act", h)
    _check("seg_act", h, ids, mask, blk)
    fn = _build.function("seg_act", "seg_act_" + suffix,
                         [_P] * 4 + [_I, _L, _I, _P])
    y = torch.empty_like(h)
    with torch.cuda.device(h.device):
        rc = fn(h.data_ptr(), ids.data_ptr(), mask.data_ptr(), y.data_ptr(),
                h.shape[0], h.shape[1], blk,
                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "seg_act")
    _build.count(globals(), "launches", h.dtype)
    return y


def seg_act_bwd_cuda(h, dy, ids, mask, *, blk: int):
    """One launch → (dy·mask)·act'(h) (B, H) in h's dtype (f32 or bf16)."""
    suffix = _build.operand_suffix("seg_act_bwd", h)
    _check("seg_act_bwd", h, ids, mask, blk, dy=dy)
    fn = _build.function("seg_act", "seg_act_bwd_" + suffix,
                         [_P] * 5 + [_I, _L, _I, _P])
    dh = torch.empty_like(h)
    with torch.cuda.device(h.device):
        rc = fn(h.data_ptr(), dy.data_ptr(), ids.data_ptr(), mask.data_ptr(),
                dh.data_ptr(), h.shape[0], h.shape[1], blk,
                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "seg_act_bwd")
    _build.count(globals(), "bwd_launches", h.dtype)
    return dh
