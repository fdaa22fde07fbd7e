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
(H / block,); x stays (B, F).  Under the bf16 compute policy x is bf16
(entry ``fused_input_infer_i8_bf16``, the same core with bf16
activations): y comes back bf16, rounded once; it counts in
``bf16_int8_launches``.

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

The bf16 compute policy (DESIGN.md §7): x and w bf16 (bias, mask f32)
launch the same kernels' bf16 instances (entries ``fused_input_infer_bf16``
/ ``fused_input_train_bf16`` and ``fused_input_bwd_bf16``): operands widened
to f32, sums in f32, y and g' (forward) and dW and dx (backward) stored in
bf16, each rounded once from its f32 value; the backward rounds du = dy·g'
to bf16 first, as the TPU kernel multiplies two bf16 tiles.  Their
``"vec4"`` instance copies 4 values (8 bytes) at a time, so a bf16 row of F
= 100 (200 bytes, 8-byte aligned) takes it.  They count in
``bf16_launches`` and ``bf16_bwd_launches``.

Each ``*_plain`` function is the same function in plain PyTorch, on f32 or
bf16 operands (widened: a product of two bf16 values is exact in f32; sums
in f32; the outputs rounded where the kernels round them).
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
bf16_launches = 0     # the forward's bf16 instance (the compute policy)
bf16_bwd_launches = 0  # the backward's bf16 instance
bf16_int8_launches = 0  # int8 weights, bf16 activations (the compute policy)

_P, _I = ctypes.c_void_p, ctypes.c_int
DX_BATCH_TILE, DX_FEATURE_TILE = 32, 128   # fused_input_bwd.cu's BB, BF
DW_BATCH_CHUNK = 32   # fused_input_bwd.cu's AB: dW's batch rows a stage


def _z(x, w, bias):
    """x·wᵀ + bias in f32 (f64 for f64 operands): bf16 operands widened."""
    acc = torch.promote_types(x.dtype, torch.float32)
    return x.to(acc) @ w.to(acc).t() + bias


def fused_input_plain(x, w, bias, mask, act_ids, *, block: int):
    """→ y (B, H) in x's dtype."""
    z = _z(x, w, bias)
    cols = act_ids.repeat_interleave(block)
    return (apply_activations_masked(z, cols) * mask).to(x.dtype)


def fused_input_train_plain(x, w, bias, mask, act_ids, *, block: int):
    """→ (y, g'), both (B, H) in x's dtype."""
    z = _z(x, w, bias)
    cols = act_ids.repeat_interleave(block)
    return ((apply_activations_masked(z, cols) * mask).to(x.dtype),
            (apply_activation_derivs_masked(z, cols) * mask).to(x.dtype))


def fused_input_int8_plain(x, w_q, w_scale, bias, mask, act_ids, *,
                           block: int):
    """Dequantize the first F columns of w_q (f32), then
    ``fused_input_plain``: y in x's dtype (f32, or bf16 rounded once)."""
    w = w_q[:, :x.shape[1]].to(torch.float32) \
        * w_scale.repeat_interleave(block)[:, None]
    return fused_input_plain(x, w, bias, mask, act_ids, block=block)


def fused_input_bwd_plain(dy, g, x, w, *, with_dx: bool):
    """→ (dx (B, F) or None, dW (H, F)) in dy's dtype, du = dy·g' (in
    dy's dtype: bf16 operands give a bf16 du, then widened)."""
    acc = torch.promote_types(dy.dtype, torch.float32)
    du = (dy * g).to(acc)
    dx = (du @ w.to(acc)).to(dy.dtype) if with_dx else None
    return dx, (du.t() @ x.to(acc)).to(dy.dtype)


def _aligned4(*tensors) -> bool:
    """Every tensor starts on a boundary of 4 of its elements (16 bytes
    for f32, 8 for bf16)."""
    return all(t.data_ptr() % (4 * t.element_size()) == 0 for t in tensors)


def bwd_path(dy, g, x, dw) -> str:
    """The instance a ``fused_input_bwd`` launch takes: ``"vec4"`` where F
    and H are multiples of 4 and dy, g', x and dW start on a boundary of 4
    of their elements (16 bytes f32, 8 bf16: dy and g' come 4 values a
    copy along H), else ``"scalar"``.  ``csrc/fused_input_bwd.cu``'s
    entries apply the same rule."""
    vec = x.shape[1] % 4 == 0 and dy.shape[1] % 4 == 0 \
        and _aligned4(dy, g, x, dw)
    return "vec4" if vec else "scalar"


def fwd_path(x, w, y, g=None) -> str:
    """The instance a forward launch takes: ``"vec4"`` where F, H and w's
    row stride (F, or F_pad for int8 weights) are multiples of 4 and x, w,
    y (and g') start on a 16-byte boundary (W rows and x come in 16-byte
    copies, 4 int8 weights a copy, y and g' leave in 16-byte stores) — an
    8-byte one for the bf16 tensors of the bf16 policy (x, y, g', and w
    where it is bf16), 4 values a copy or a store — else ``"scalar"``.
    ``csrc/fused_input.cu::launch`` applies the same rule."""
    def align(t):
        return 8 if t.dtype == torch.bfloat16 else 16
    vec = x.shape[1] % 4 == 0 and w.shape[0] % 4 == 0 \
        and w.shape[1] % 4 == 0 and all(
            t.data_ptr() % align(t) == 0 for t in (x, w, y, g)
            if t is not None)
    return "vec4" if vec else "scalar"


def _fwd_args(x, w, bias, mask, act_ids, block):
    b, f = x.shape
    h = w.shape[0]
    if w.shape[1] != f or bias.shape != (h,) or mask.shape != (h,) \
            or act_ids.shape != (h // block,):
        raise ValueError("fused_input: inconsistent shapes")
    _build.operand_suffix("fused_input", x)
    _build.check_tensors(
        "fused_input", x,
        ("x", x, x.dtype),
        ("w", w, x.dtype),
        ("bias", bias, torch.float32),
        ("mask", mask, torch.float32),
        ("act_ids", act_ids, torch.int32))
    return b, f, h


def fused_input_cuda(x, w, bias, mask, act_ids, *, block: int):
    """One launch → y (B, H) in x's dtype (f32 or bf16)."""
    b, f, h = _fwd_args(x, w, bias, mask, act_ids, block)
    fn = _build.function(
        "fused_input",
        "fused_input_infer_" + _build.operand_suffix("fused_input", x),
        [_P] * 6 + [_I] * 4 + [_P])
    y = torch.empty(b, h, device=x.device, dtype=x.dtype)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w.data_ptr(), bias.data_ptr(), mask.data_ptr(),
                act_ids.data_ptr(), y.data_ptr(), b, f, h, block,
                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "fused_input")
    _build.count(globals(), "launches", x.dtype)
    return y


def fused_input_train_cuda(x, w, bias, mask, act_ids, *, block: int):
    """The training forward: one launch → (y, g') in x's dtype."""
    b, f, h = _fwd_args(x, w, bias, mask, act_ids, block)
    fn = _build.function(
        "fused_input",
        "fused_input_train_" + _build.operand_suffix("fused_input", x),
        [_P] * 7 + [_I] * 4 + [_P])
    y = torch.empty(b, h, device=x.device, dtype=x.dtype)
    g = torch.empty_like(y)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w.data_ptr(), bias.data_ptr(), mask.data_ptr(),
                act_ids.data_ptr(), y.data_ptr(), g.data_ptr(), b, f, h,
                block, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "fused_input_train")
    _build.count(globals(), "launches", x.dtype)
    return y, g


def fused_input_int8_cuda(x, w_q, w_scale, bias, mask, act_ids, *,
                          block: int):
    """One launch → y (B, H) in x's dtype (f32, or bf16 under the compute
    policy); reads only the first F columns of w_q."""
    suffix = _build.operand_suffix("fused_input_int8", x)
    b, f = x.shape
    h, f_pad = w_q.shape
    if f_pad < f or h % block or w_scale.shape != (h // block,) \
            or bias.shape != (h,) or mask.shape != (h,) \
            or act_ids.shape != (h // block,):
        raise ValueError("fused_input_int8: inconsistent shapes")
    _build.check_tensors(
        "fused_input_int8", x,
        ("x", x, x.dtype),
        ("w_q", w_q, torch.int8),
        ("w_scale", w_scale, torch.float32),
        ("bias", bias, torch.float32),
        ("mask", mask, torch.float32),
        ("act_ids", act_ids, torch.int32))
    fn = _build.function(
        "fused_input",
        "fused_input_infer_i8" + ("_bf16" if suffix == "bf16" else ""),
        [_P] * 7 + [_I] * 5 + [_P])
    y = torch.empty(b, h, device=x.device, dtype=x.dtype)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(),
                bias.data_ptr(), mask.data_ptr(), act_ids.data_ptr(),
                y.data_ptr(), b, f, f_pad, h, block,
                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "fused_input_int8")
    _build.count(globals(), "int8_launches", x.dtype)
    return y


def fused_input_bwd_cuda(dy, g, x, w, *, with_dx: bool):
    """One launch → (dx (B, F) or None, dW (H, F)) in dy's dtype (f32 or
    bf16).  The dx path sums partials over fixed hidden chunks in a
    workspace allocated here; a bf16 dW past one 32-row batch chunk sums
    in an f32 scratch allocated here too."""
    b, h = dy.shape
    f = x.shape[1]
    bf16 = _build.operand_suffix("fused_input_bwd", dy) == "bf16"
    _build.check_tensors(
        "fused_input_bwd", dy,
        ("dy", dy, dy.dtype),
        ("g", g, dy.dtype),
        ("x", x, dy.dtype),
        ("w", w, dy.dtype))
    if g.shape != (b, h) or x.shape[0] != b or w.shape != (h, f):
        raise ValueError("fused_input_bwd: inconsistent shapes")
    fn = _build.function(
        "fused_input_bwd",
        "fused_input_bwd_bf16" if bf16 else "fused_input_bwd_f32",
        [_P] * (9 if bf16 else 8) + [_I] * 4 + [_P])
    dw = torch.empty(h, f, device=dy.device, dtype=dy.dtype)
    # a bf16 dW's f32 sums where B spans more than one batch chunk
    dws = (torch.empty(h, f, device=dy.device, dtype=torch.float32)
           if bf16 and b > DW_BATCH_CHUNK else None)
    dx = ws = tickets = None
    if with_dx:
        chunks = _build.function("fused_input_bwd", "fused_input_bwd_chunks",
                                 [_I, ctypes.POINTER(_I)])
        chunk_h = _I(0)
        n_chunks = chunks(h, ctypes.byref(chunk_h))
        dx = torch.empty(b, f, device=dy.device, dtype=dy.dtype)
        ws = torch.empty(n_chunks, b, f, device=dy.device,
                         dtype=torch.float32)
        n_groups = -(-b // DX_BATCH_TILE) * -(-f // DX_FEATURE_TILE)
        tickets = torch.zeros(n_groups, device=dy.device, dtype=torch.int32)
    ptr = (lambda t: None if t is None else t.data_ptr())
    outs = (dw.data_ptr(), ptr(dws)) if bf16 else (dw.data_ptr(),)
    with torch.cuda.device(dy.device):
        rc = fn(dy.data_ptr(), g.data_ptr(), x.data_ptr(), w.data_ptr(),
                *outs, ptr(dx), ptr(ws), ptr(tickets), b, f, h,
                int(bool(with_dx)), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "fused_input_bwd")
    _build.count(globals(), "bwd_launches", dy.dtype)
    return dx, dw
