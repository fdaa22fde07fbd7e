"""Fused input layer: ``y = act(x·Wᵀ + b)·mask`` forward, and its backward.

Forward (serving, and training with the activation derivative):
``fused_input_cuda`` / ``fused_input_train_cuda`` launch the CUDA kernel
``csrc/fused_input.cu`` (the port of the TPU kernel
``repro/kernels/fused_input.py::fused_input_fwd``, ``with_deriv`` False /
True); the training variant also returns ``g' = act'(x·Wᵀ + b)·mask``.
Both take x (B, F), w (H, F), bias and mask (H,) f32 and per-block
activation ids (H / block,) int32, and return (B, H) f32.

Int8 serving: ``fused_input_int8_cuda`` launches the same kernel with int8
weights (``csrc/fused_input.cu``, entry ``fused_input_infer_i8``; the port
of ``fused_input.py::fused_input_int8_fwd``): w_q (H, F_pad) int8 as
``quant.quantize_population`` stores it, one f32 scale per row block
(H / block,); x stays (B, F).

The forward streams W through each warp's ring of shared-memory stages
(16-byte copies, 4 int8 weights a copy, and 16-byte stores of y and g':
``"vec4"``) or, where a shape or a tensor does not allow it, with 4-byte
copies and stores (``"scalar"``, the same kernel's other instance):
``fwd_path`` says which, by the rule the C entries apply.

Backward: ``fused_input_bwd_cuda`` launches ``csrc/fused_input_bwd.cu``
(the port of ``fused_input.py::fused_input_bwd``): from dy and g' (B, H),
x and w it returns dW (H, F) and, when asked, dx (B, F).  Its dW streams
16-byte copies and stores (``"vec4"``) or, where a shape or a tensor does
not allow it, 4-byte ones (``"scalar"``, the same kernel's other
instance): ``bwd_path`` says which, by the rule the C entry applies.

Each ``*_plain`` function is the same function in plain PyTorch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.activations import (apply_activation_derivs_masked,
                                          apply_activations_masked)
from repro_torch.kernels import _build

# kernel launches (the CPU dispatch in ops counts its plain calls too):
launches = 0          # the forward, with or without g'
int8_launches = 0     # the forward over int8 weights
bwd_launches = 0      # the backward

_P, _I = ctypes.c_void_p, ctypes.c_int
DX_BATCH_TILE, DX_FEATURE_TILE = 32, 128   # fused_input_bwd.cu's BB, BF


def fused_input_plain(x, w, bias, mask, act_ids, *, block: int):
    z = x @ w.t() + bias
    cols = act_ids.repeat_interleave(block)
    return apply_activations_masked(z, cols) * mask


def fused_input_train_plain(x, w, bias, mask, act_ids, *, block: int):
    """→ (y, g'), both (B, H)."""
    z = x @ w.t() + bias
    cols = act_ids.repeat_interleave(block)
    return (apply_activations_masked(z, cols) * mask,
            apply_activation_derivs_masked(z, cols) * mask)


def fused_input_int8_plain(x, w_q, w_scale, bias, mask, act_ids, *,
                           block: int):
    """Dequantize the first F columns of w_q, then ``fused_input_plain``."""
    w = w_q[:, :x.shape[1]].to(torch.float32) \
        * w_scale.repeat_interleave(block)[:, None]
    return fused_input_plain(x, w, bias, mask, act_ids, block=block)


def fused_input_bwd_plain(dy, g, x, w, *, with_dx: bool):
    """→ (dx (B, F) or None, dW (H, F)), du = dy·g'."""
    du = dy * g
    return (du @ w if with_dx else None), du.t() @ x


def bwd_path(dy, g, x, dw) -> str:
    """The instance a ``fused_input_bwd`` launch takes: ``"vec4"`` where F
    and H are multiples of 4 and dy, g', x and dW start on a 16-byte
    boundary (a thread's 4 features are one float4 of a dW row, dy and g'
    come in 16-byte copies along H), else ``"scalar"``.
    ``csrc/fused_input_bwd.cu::fused_input_bwd_f32`` applies the same
    rule."""
    vec = x.shape[1] % 4 == 0 and dy.shape[1] % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (dy, g, x, dw))
    return "vec4" if vec else "scalar"


def fwd_path(x, w, y, g=None) -> str:
    """The instance a forward launch takes: ``"vec4"`` where F, H and w's
    row stride (F, or F_pad for int8 weights) are multiples of 4 and x, w,
    y (and g') start on a 16-byte boundary (W rows and x come in 16-byte
    copies, 4 int8 weights a copy, y and g' leave in 16-byte stores), else
    ``"scalar"``.  ``csrc/fused_input.cu::launch`` applies the same rule."""
    vec = x.shape[1] % 4 == 0 and w.shape[0] % 4 == 0 \
        and w.shape[1] % 4 == 0 and all(
            t.data_ptr() % 16 == 0 for t in (x, w, y, g) if t is not None)
    return "vec4" if vec else "scalar"


def _fwd_args(x, w, bias, mask, act_ids, block):
    b, f = x.shape
    h = w.shape[0]
    if w.shape[1] != f or bias.shape != (h,) or mask.shape != (h,) \
            or act_ids.shape != (h // block,):
        raise ValueError("fused_input: inconsistent shapes")
    _build.check_tensors(
        "fused_input", x,
        ("x", x, torch.float32),
        ("w", w, torch.float32),
        ("bias", bias, torch.float32),
        ("mask", mask, torch.float32),
        ("act_ids", act_ids, torch.int32))
    return b, f, h


def fused_input_cuda(x, w, bias, mask, act_ids, *, block: int):
    global launches
    b, f, h = _fwd_args(x, w, bias, mask, act_ids, block)
    fn = _build.function("fused_input", "fused_input_infer_f32",
                         [_P] * 6 + [_I] * 4 + [_P])
    y = torch.empty(b, h, device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w.data_ptr(), bias.data_ptr(), mask.data_ptr(),
                act_ids.data_ptr(), y.data_ptr(), b, f, h, block,
                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "fused_input")
    launches += 1
    return y


def fused_input_train_cuda(x, w, bias, mask, act_ids, *, block: int):
    """The training forward: one launch → (y, g')."""
    global launches
    b, f, h = _fwd_args(x, w, bias, mask, act_ids, block)
    fn = _build.function("fused_input", "fused_input_train_f32",
                         [_P] * 7 + [_I] * 4 + [_P])
    y = torch.empty(b, h, device=x.device, dtype=torch.float32)
    g = torch.empty_like(y)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w.data_ptr(), bias.data_ptr(), mask.data_ptr(),
                act_ids.data_ptr(), y.data_ptr(), g.data_ptr(), b, f, h,
                block, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "fused_input_train")
    launches += 1
    return y, g


def fused_input_int8_cuda(x, w_q, w_scale, bias, mask, act_ids, *,
                          block: int):
    """One launch → y (B, H); reads only the first F columns of w_q."""
    global int8_launches
    b, f = x.shape
    h, f_pad = w_q.shape
    if f_pad < f or h % block or w_scale.shape != (h // block,) \
            or bias.shape != (h,) or mask.shape != (h,) \
            or act_ids.shape != (h // block,):
        raise ValueError("fused_input_int8: inconsistent shapes")
    _build.check_tensors(
        "fused_input_int8", x,
        ("x", x, torch.float32),
        ("w_q", w_q, torch.int8),
        ("w_scale", w_scale, torch.float32),
        ("bias", bias, torch.float32),
        ("mask", mask, torch.float32),
        ("act_ids", act_ids, torch.int32))
    fn = _build.function("fused_input", "fused_input_infer_i8",
                         [_P] * 7 + [_I] * 5 + [_P])
    y = torch.empty(b, h, device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(),
                bias.data_ptr(), mask.data_ptr(), act_ids.data_ptr(),
                y.data_ptr(), b, f, f_pad, h, block,
                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "fused_input_int8")
    int8_launches += 1
    return y


def fused_input_bwd_cuda(dy, g, x, w, *, with_dx: bool):
    """One launch → (dx (B, F) or None, dW (H, F)).  The dx path sums
    partials over fixed hidden chunks in a workspace allocated here."""
    global bwd_launches
    b, h = dy.shape
    f = x.shape[1]
    _build.check_tensors(
        "fused_input_bwd", dy,
        ("dy", dy, torch.float32),
        ("g", g, torch.float32),
        ("x", x, torch.float32),
        ("w", w, torch.float32))
    if g.shape != (b, h) or x.shape[0] != b or w.shape != (h, f):
        raise ValueError("fused_input_bwd: inconsistent shapes")
    fn = _build.function("fused_input_bwd", "fused_input_bwd_f32",
                         [_P] * 8 + [_I] * 4 + [_P])
    dw = torch.empty(h, f, device=dy.device, dtype=torch.float32)
    dx = ws = tickets = None
    if with_dx:
        chunks = _build.function("fused_input_bwd", "fused_input_bwd_chunks",
                                 [_I, ctypes.POINTER(_I)])
        chunk_h = _I(0)
        n_chunks = chunks(h, ctypes.byref(chunk_h))
        dx = torch.empty(b, f, device=dy.device, dtype=torch.float32)
        ws = torch.empty(n_chunks, b, f, device=dy.device,
                         dtype=torch.float32)
        n_groups = -(-b // DX_BATCH_TILE) * -(-f // DX_FEATURE_TILE)
        tickets = torch.zeros(n_groups, device=dy.device, dtype=torch.int32)
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(dy.device):
        rc = fn(dy.data_ptr(), g.data_ptr(), x.data_ptr(), w.data_ptr(),
                dw.data_ptr(), ptr(dx), ptr(ws), ptr(tickets), b, f, h,
                int(bool(with_dx)), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "fused_input_bwd")
    bwd_launches += 1
    return dx, dw
