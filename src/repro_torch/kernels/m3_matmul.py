"""Segment-blocked matmul — the paper's M3 — forward and both gradients.

``m3_matmul_fwd_cuda`` launches ``csrc/m3_matmul.cu`` (entry
``m3_fwd_f32``, the port of the TPU kernel
``repro/kernels/m3_matmul.py::m3_matmul_fwd``): h (B, H), w2 (O, H) f32
and the members' hidden-block ranges in CSR form (``infer_head.member_ptr``,
(P + 1,) int32 in units of ``block`` units) → y (B, P, O) f32,
``y[b, m, o] = Σ_{j in member m} h[b, j]·w2[o, j]``.  It is the output
heads' logits without a bias, on their streaming core
(``csrc/head_stream.cuh``, as ``infer_head.py``'s f32 kernel runs it).

``m3_matmul_dh_cuda`` (entry ``m3_dh_f32``, the port of
``m3_matmul.py::m3_matmul_dh``): dy (B, P, O), w2 and the per-block member
ids (H / block,) int32 → dh (B, H), a store stream of its own.
``m3_matmul_dw_cuda`` (entry ``m3_dw_f32``, the port of
``m3_matmul.py::m3_matmul_dw``): dy, h and the same ids → dw2 (O, H), the
loss head's backward role without dh and d_per (``csrc/head_bwd.cuh``).

The forward and dW take any class count (16 at a time inside the launch)
and H up to 2**31 − 1.  Each launch takes the vec4 or the scalar instance
of its kernel by ``kernel_path`` — ``infer_head.kernel_path``, the rule of
the C code — over the tensors it walks 4 units at a time: h and w2 for the
forward, h and dw2 for dW.

The bf16 compute policy (DESIGN.md §7; JAX's kernels on bf16 operands,
``repro/kernels/m3_matmul.py:74, :89, :109, :131-135, :156``): bf16 h, w2
(and dy) launch the three kernels' bf16 instances (entries
``m3_fwd_bf16``, ``m3_dh_bf16``, ``m3_dw_bf16``): operands widened, every
product and sum in f32, and each output — the logits y too — rounded once
to bf16.  Their ``kernel_path`` is the same rule at bf16's 8-byte
alignment.  They count in ``bf16_fwd_launches``, ``bf16_dh_launches`` and
``bf16_dw_launches``.

Each ``*_plain`` function is the same function in plain PyTorch: the
forward in the paper's scatter-add form (``index_add_`` over the
broadcast product), the two gradients as its transposes (a gather of dy by
member, then a sum over the classes or the batch); bf16 operands widened,
summed in f32 and rounded once to their dtype.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.infer_head import kernel_path

# kernel launches (the CPU dispatch in ops counts its plain calls too):
fwd_launches = 0      # the forward
dh_launches = 0       # the backward's dh
dw_launches = 0       # the backward's dW
bf16_fwd_launches = 0  # their bf16 instances (the compute policy)
bf16_dh_launches = 0
bf16_dw_launches = 0
MAX_BLOCK = 128       # widest hidden block the kernels take
MAX_HIDDEN = 2**31 - 1  # H the forward's and dW's int indices reach

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _unit_members(member_ptr, block: int, device) -> torch.Tensor:
    """CSR block ranges → the member id of every hidden unit (H,)."""
    p = member_ptr.shape[0] - 1
    widths = (member_ptr[1:] - member_ptr[:-1]).long() * block
    return torch.repeat_interleave(torch.arange(p, device=device), widths)


def m3_matmul_fwd_plain(h, w2, member_ptr, *, block: int):
    """Σ over each member's units of h[:, j]·w2[:, j] → (B, P, O) in h's
    dtype; products and sums in f32 (f64 for f64 inputs), as JAX's kernel
    accumulates."""
    p = member_ptr.shape[0] - 1
    acc = torch.promote_types(h.dtype, torch.float32)
    y = torch.zeros(h.shape[0], p, w2.shape[0], device=h.device, dtype=acc)
    return y.index_add_(1, _unit_members(member_ptr, block, h.device),
                        h.to(acc)[:, :, None] * w2.to(acc).t()[None]
                        ).to(h.dtype)


def m3_matmul_dh_plain(dy, w2, block_seg_ids, *, block: int):
    """dh[b, j] = Σ_o dy[b, seg(j), o]·w2[o, j] → (B, H) in dy's dtype;
    products and sums in f32 (f64 for f64 inputs), rounded once."""
    acc = torch.promote_types(dy.dtype, torch.float32)
    seg = block_seg_ids.long().repeat_interleave(block)
    return (dy.to(acc)[:, seg, :] * w2.to(acc).t()[None]).sum(-1).to(
        dy.dtype)


def m3_matmul_dw_plain(dy, h, block_seg_ids, *, block: int):
    """dw2[o, j] = Σ_b h[b, j]·dy[b, seg(j), o] → (O, H) in dy's dtype;
    products and sums in f32 (f64 for f64 inputs), rounded once."""
    acc = torch.promote_types(dy.dtype, torch.float32)
    seg = block_seg_ids.long().repeat_interleave(block)
    return torch.einsum("bj,bjo->oj", h.to(acc),
                        dy.to(acc)[:, seg, :]).to(dy.dtype)


def _check(where: str, ref, named, block: int, hidden: int | None = None):
    _build.check_tensors(where, ref, *named)
    if not 1 <= block <= MAX_BLOCK:
        raise ValueError(f"{where}: block {block} outside the kernel's "
                         f"[1, {MAX_BLOCK}]")
    if hidden is not None and hidden > MAX_HIDDEN:
        raise ValueError(f"{where}: H = {hidden} past the kernel's "
                         f"{MAX_HIDDEN}")


def m3_matmul_fwd_cuda(h, w2, member_ptr, *, block: int):
    """One launch → y (B, P, O) in h's dtype, P = len(member_ptr) − 1; h
    and w2 f32, or both bf16."""
    suffix = _build.operand_suffix("m3_matmul_fwd", h)
    _check("m3_matmul_fwd", h, (("h", h, h.dtype),
                                ("w2", w2, h.dtype),
                                ("member_ptr", member_ptr, torch.int32)),
           block, h.shape[-1])
    b, hh = h.shape
    o, p = w2.shape[0], member_ptr.shape[0] - 1
    if w2.dim() != 2 or w2.shape[1] != hh or hh % block or p < 1:
        raise ValueError("m3_matmul_fwd: inconsistent shapes")
    fn = _build.function("m3_matmul", "m3_fwd_" + suffix,
                         [_P] * 4 + [_I, _L, _I, _I, _I, _P])
    y = torch.empty(b, p, o, device=h.device, dtype=h.dtype)
    with torch.cuda.device(h.device):
        rc = fn(h.data_ptr(), w2.data_ptr(), member_ptr.data_ptr(),
                y.data_ptr(), b, hh, o, p, block,
                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "m3_matmul_fwd")
    _build.count(globals(), "fwd_launches", h.dtype)
    return y


def _check_grad(where, dy, w_or_h, seg, block):
    b, p, o = dy.shape
    hh = seg.shape[0] * block
    if seg.dim() != 1 or w_or_h.dim() != 2 or w_or_h.shape[1] != hh:
        raise ValueError(f"{where}: inconsistent shapes")
    return b, p, o, hh


def m3_matmul_dh_cuda(dy, w2, block_seg_ids, *, block: int):
    """One launch → dh (B, H) in dy's dtype; dy and w2 f32, or both
    bf16."""
    suffix = _build.operand_suffix("m3_matmul_dh", dy)
    _check("m3_matmul_dh", dy, (("dy", dy, dy.dtype),
                                ("w2", w2, dy.dtype),
                                ("block_seg_ids", block_seg_ids,
                                 torch.int32)), block)
    b, p, o, hh = _check_grad("m3_matmul_dh", dy, w2, block_seg_ids, block)
    if w2.shape[0] != o:
        raise ValueError("m3_matmul_dh: inconsistent shapes")
    fn = _build.function("m3_matmul", "m3_dh_" + suffix,
                         [_P] * 4 + [_I, _L, _I, _I, _I, _P])
    dh = torch.empty(b, hh, device=dy.device, dtype=dy.dtype)
    with torch.cuda.device(dy.device):
        rc = fn(dy.data_ptr(), w2.data_ptr(), block_seg_ids.data_ptr(),
                dh.data_ptr(), b, hh, o, p, block,
                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "m3_matmul_dh")
    _build.count(globals(), "dh_launches", dy.dtype)
    return dh


def m3_matmul_dw_cuda(dy, h, block_seg_ids, *, block: int):
    """One launch → dw2 (O, H) in dy's dtype; dy and h f32, or both
    bf16."""
    suffix = _build.operand_suffix("m3_matmul_dw", dy)
    _check("m3_matmul_dw", dy, (("dy", dy, dy.dtype),
                                ("h", h, dy.dtype),
                                ("block_seg_ids", block_seg_ids,
                                 torch.int32)), block, h.shape[-1])
    b, p, o, hh = _check_grad("m3_matmul_dw", dy, h, block_seg_ids, block)
    if h.shape[0] != b:
        raise ValueError("m3_matmul_dw: inconsistent shapes")
    fn = _build.function("m3_matmul", "m3_dw_" + suffix,
                         [_P] * 4 + [_I, _L, _I, _I, _I, _P])
    dw = torch.empty(o, hh, device=dy.device, dtype=dy.dtype)
    with torch.cuda.device(dy.device):
        rc = fn(h.data_ptr(), dy.data_ptr(), block_seg_ids.data_ptr(),
                dw.data_ptr(), b, hh, o, p, block,
                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "m3_matmul_dw")
    _build.count(globals(), "dw_launches", dy.dtype)
    return dw
