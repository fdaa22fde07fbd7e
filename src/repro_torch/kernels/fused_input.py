"""Fused input layer, forward only: ``y = act(x·Wᵀ + b)·mask``.

``fused_input_cuda`` launches the CUDA kernel ``csrc/fused_input.cu`` (the
port of the TPU kernel ``repro/kernels/fused_input.py::fused_input_fwd``
with ``with_deriv=False``); ``fused_input_plain`` is the same function in
plain PyTorch.  Both take x (B, F), w (H, F), bias and mask (H,) f32 and
per-block activation ids (H / block,) int32, and return y (B, H) f32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.activations import apply_activations_masked
from repro_torch.kernels import _build

launches = 0          # kernel launches (the CPU dispatch in ops counts too)

_P, _I = ctypes.c_void_p, ctypes.c_int


def fused_input_plain(x, w, bias, mask, act_ids, *, block: int):
    z = x @ w.t() + bias
    cols = act_ids.repeat_interleave(block)
    return apply_activations_masked(z, cols) * mask


def _lib():
    lib = _build.library("fused_input")
    fn = lib.fused_input_infer_f32
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def fused_input_cuda(x, w, bias, mask, act_ids, *, block: int):
    global launches
    b, f = x.shape
    h = w.shape[0]
    for name, t, dt in (("x", x, torch.float32), ("w", w, torch.float32),
                        ("bias", bias, torch.float32),
                        ("mask", mask, torch.float32),
                        ("act_ids", act_ids, torch.int32)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"fused_input: {name} must be on {x.device}")
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"fused_input: {name} must be contiguous {dt}, "
                             f"got {t.dtype}")
    if w.shape[1] != f or bias.shape != (h,) or mask.shape != (h,) \
            or act_ids.shape != (h // block,):
        raise ValueError("fused_input: inconsistent shapes")
    fn = _lib()
    y = torch.empty(b, h, device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w.data_ptr(), bias.data_ptr(), mask.data_ptr(),
                act_ids.data_ptr(), y.data_ptr(), b, f, h, block,
                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "fused_input")
    launches += 1
    return y
