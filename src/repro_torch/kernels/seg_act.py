"""Segmented activation: a different activation per hidden block, with the
padding mask, in one pass — forward and backward.

``seg_act_cuda`` launches ``csrc/seg_act.cu`` (entry ``seg_act_f32``, the
port of the TPU kernel ``repro/kernels/seg_act.py::seg_act``): h (B, H) f32,
one activation id per block of ``blk`` columns (H / blk,) int32 and the
mask (H,) f32 → ``act(h)·mask`` (B, H).  ``seg_act_bwd_cuda`` (entry
``seg_act_bwd_f32``, the port of ``seg_act.py::seg_act_bwd``) returns
``(dy·mask)·act'(h)``.  The activations are the fused kernels' epilogue
functions (``csrc/activations.cuh``), kinks included.

Each ``*_plain`` function is the same function in plain PyTorch, on
per-column ids expanded from the per-block ones.
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

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def seg_act_plain(h, ids, mask, *, blk: int):
    return apply_activations_masked(h, ids.repeat_interleave(blk)) * mask


def seg_act_bwd_plain(h, dy, ids, mask, *, blk: int):
    return (dy * mask) * apply_activation_derivs_masked(
        h, ids.repeat_interleave(blk))


def _check(where, h, ids, mask, blk, dy=None):
    named = [("h", h, torch.float32), ("ids", ids, torch.int32),
             ("mask", mask, torch.float32)]
    if dy is not None:
        named.append(("dy", dy, torch.float32))
    _build.check_tensors(where, h, *named)
    if h.dim() != 2 or blk < 1 or h.shape[1] % blk \
            or ids.shape != (h.shape[1] // blk,) \
            or mask.shape != (h.shape[1],) \
            or (dy is not None and dy.shape != h.shape):
        raise ValueError(f"{where}: inconsistent shapes")


def seg_act_cuda(h, ids, mask, *, blk: int):
    """One launch → act(h)·mask (B, H)."""
    global launches
    _check("seg_act", h, ids, mask, blk)
    fn = _build.function("seg_act", "seg_act_f32", [_P] * 4 + [_I, _L, _I, _P])
    y = torch.empty_like(h)
    with torch.cuda.device(h.device):
        rc = fn(h.data_ptr(), ids.data_ptr(), mask.data_ptr(), y.data_ptr(),
                h.shape[0], h.shape[1], blk,
                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "seg_act")
    launches += 1
    return y


def seg_act_bwd_cuda(h, dy, ids, mask, *, blk: int):
    """One launch → (dy·mask)·act'(h) (B, H)."""
    global bwd_launches
    _check("seg_act_bwd", h, ids, mask, blk, dy=dy)
    fn = _build.function("seg_act", "seg_act_bwd_f32",
                         [_P] * 5 + [_I, _L, _I, _P])
    dh = torch.empty_like(h)
    with torch.cuda.device(h.device):
        rc = fn(h.data_ptr(), dy.data_ptr(), ids.data_ptr(), mask.data_ptr(),
                dh.data_ptr(), h.shape[0], h.shape[1], blk,
                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "seg_act_bwd")
    bwd_launches += 1
    return dh
