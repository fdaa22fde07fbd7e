"""Fused training loss head: M3 projection + per-member bias + softmax
cross-entropy, forward and backward, with the logits kept out of memory.

``loss_head_fwd_cuda`` / ``loss_head_bwd_cuda`` launch the two kernels of
``csrc/loss_head.cu`` (the ports of the TPU kernels
``repro/kernels/loss_head.py::loss_head_fwd`` and ``::loss_head_bwd``);
each ``*_plain`` function is the same function in plain PyTorch.

Forward: h (B, H), w2 (O, H), b2 (P, O) f32, targets (B,) int32 (−1 marks a
pad row) and the members' hidden-block ranges in CSR form (``member_ptr``,
P + 1, in units of ``block`` hidden units) → per-member mean NLL ``per``
(P,) and the backward's seed ``dl`` = (softmax − onehot)/B_real (B, P, O),
both f32.  ``b_real`` is the row count the mean divides by.

Backward: d_per (P,), dl (B, P, O), h, w2 and one member id per hidden
block → dh (B, H) and dW (O, H).

The bf16 compute policy (DESIGN.md §7): bf16 h and w2 (b2 f32) launch the
two kernels' bf16 instances (entries ``loss_head_fwd_bf16``,
``loss_head_bwd_bf16``): per and dl stay f32; the backward rounds dl·d_per
to bf16 before its products, as the TPU kernel casts it to the operands'
dtype, and returns dh and dW in bf16, each rounded once from its f32 sum.
They count in ``bf16_fwd_launches`` and ``bf16_bwd_launches``.

Both kernels stream h with 16-byte loads (``"vec4"``) or, where the block
or a tensor does not allow it, with 4-byte ones (``"scalar"``, the same
kernel's other instance): ``kernel_path`` says which, by the rule the C
entries apply.  ``fwd_cta_members`` is the forward's member-to-CTA rule as
the kernel applies it.  The forward shares its streaming core with the
serving head (``csrc/head_stream.cuh``), and both rules are
``infer_head.py``'s.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.infer_head import (MAX_O, infer_head_plain,
                                            kernel_path)
from repro_torch.kernels.infer_head import cta_members as fwd_cta_members

# kernel launches (the CPU dispatch in ops counts its plain calls too)
fwd_launches = 0
bwd_launches = 0
bf16_fwd_launches = 0    # the bf16 instances (the compute policy)
bf16_bwd_launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def loss_head_fwd_plain(h, w2, b2, targets, member_ptr, *, block: int,
                        b_real: int):
    z = infer_head_plain(h, w2, b2, member_ptr, block=block)   # (B, P, O)
    tgt = targets.long()
    onehot = (torch.arange(z.shape[2], device=z.device)[None]
              == tgt[:, None]).to(z.dtype)[:, None, :]         # (B, 1, O)
    valid = (tgt >= 0).to(z.dtype)[:, None]                    # (B, 1)
    lse = torch.logsumexp(z, dim=-1)
    nll = (lse - (z * onehot).sum(-1)) * valid                 # (B, P)
    dl = (torch.softmax(z, dim=-1) - onehot) * (valid / b_real)[..., None]
    return nll.sum(0) / b_real, dl


def loss_head_bwd_plain(dper, dl, h, w2, block_seg, *, block: int):
    """→ (dh, dW) in h's dtype: for bf16 h and w2, dl·d_per rounded to
    bf16 first, the sums in f32, each output rounded once."""
    acc = torch.promote_types(h.dtype, torch.float32)
    seg = block_seg.long().repeat_interleave(block)            # (H,)
    g = (dl * dper[None, :, None]).to(h.dtype).to(acc)
    dlu = g[:, seg, :]                                         # (B, H, O)
    dh = (dlu * w2.to(acc).t()[None]).sum(-1)
    dw = (dlu * h.to(acc)[:, :, None]).sum(0).t()
    return dh.to(h.dtype), dw.to(h.dtype)


def _check_o(o: int):
    if o > MAX_O:
        raise ValueError(f"loss_head: {o} classes, the kernel supports at "
                         f"most {MAX_O}")


def loss_head_fwd_cuda(h, w2, b2, targets, member_ptr, *, block: int,
                       b_real: int):
    """One launch → (per (P,), dl (B, P, O))."""
    suffix = _build.operand_suffix("loss_head_fwd", h)
    b, hh = h.shape
    o, p = w2.shape[0], b2.shape[0]
    _build.check_tensors(
        "loss_head_fwd", h,
        ("h", h, h.dtype),
        ("w2", w2, h.dtype),
        ("b2", b2, torch.float32),
        ("targets", targets, torch.int32),
        ("member_ptr", member_ptr, torch.int32))
    if w2.shape[1] != hh or b2.shape[1] != o or targets.shape != (b,) \
            or member_ptr.shape != (p + 1,):
        raise ValueError("loss_head_fwd: inconsistent shapes")
    _check_o(o)
    fn = _build.function("loss_head", "loss_head_fwd_" + suffix,
                         [_P] * 7 + [_I] * 5 + [_F, _P])
    per = torch.empty(p, device=h.device, dtype=torch.float32)
    dl = torch.empty(b, p, o, device=h.device, dtype=torch.float32)
    with torch.cuda.device(h.device):
        rc = fn(h.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                targets.data_ptr(), member_ptr.data_ptr(), per.data_ptr(),
                dl.data_ptr(), b, hh, o, p, block, 1.0 / b_real,
                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "loss_head_fwd")
    _build.count(globals(), "fwd_launches", h.dtype)
    return per, dl


def loss_head_bwd_cuda(dper, dl, h, w2, block_seg, *, block: int):
    """One launch → (dh (B, H), dW (O, H)) in h's dtype."""
    suffix = _build.operand_suffix("loss_head_bwd", h)
    b, hh = h.shape
    o = w2.shape[0]
    p = dper.shape[0]
    _build.check_tensors(
        "loss_head_bwd", h,
        ("dper", dper, torch.float32),
        ("dl", dl, torch.float32),
        ("h", h, h.dtype),
        ("w2", w2, h.dtype),
        ("block_seg", block_seg, torch.int32))
    if w2.shape[1] != hh or dl.shape != (b, p, o) \
            or block_seg.shape != (hh // block,):
        raise ValueError("loss_head_bwd: inconsistent shapes")
    _check_o(o)
    fn = _build.function("loss_head", "loss_head_bwd_" + suffix,
                         [_P] * 7 + [_I] * 5 + [_P])
    dh = torch.empty(b, hh, device=h.device, dtype=h.dtype)
    dw = torch.empty(o, hh, device=h.device, dtype=h.dtype)
    with torch.cuda.device(h.device):
        rc = fn(dper.data_ptr(), dl.data_ptr(), h.data_ptr(), w2.data_ptr(),
                block_seg.data_ptr(), dh.data_ptr(), dw.data_ptr(), b, hh, o,
                p, block, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "loss_head_bwd")
    _build.count(globals(), "bwd_launches", h.dtype)
    return dh, dw
