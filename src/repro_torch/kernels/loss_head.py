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
    seg = block_seg.long().repeat_interleave(block)            # (H,)
    dlu = (dl * dper[None, :, None])[:, seg, :]                # (B, H, O)
    dh = (dlu * w2.t()[None]).sum(-1)
    dw = (dlu * h[:, :, None]).sum(0).t()
    return dh, dw


def _check_o(o: int):
    if o > MAX_O:
        raise ValueError(f"loss_head: {o} classes, the kernel supports at "
                         f"most {MAX_O}")


def loss_head_fwd_cuda(h, w2, b2, targets, member_ptr, *, block: int,
                       b_real: int):
    """One launch → (per (P,), dl (B, P, O))."""
    global fwd_launches
    b, hh = h.shape
    o, p = w2.shape[0], b2.shape[0]
    _build.check_tensors(
        "loss_head_fwd", h,
        ("h", h, torch.float32),
        ("w2", w2, torch.float32),
        ("b2", b2, torch.float32),
        ("targets", targets, torch.int32),
        ("member_ptr", member_ptr, torch.int32))
    if w2.shape[1] != hh or b2.shape[1] != o or targets.shape != (b,) \
            or member_ptr.shape != (p + 1,):
        raise ValueError("loss_head_fwd: inconsistent shapes")
    _check_o(o)
    fn = _build.function("loss_head", "loss_head_fwd_f32",
                         [_P] * 7 + [_I] * 5 + [_F, _P])
    per = torch.empty(p, device=h.device, dtype=torch.float32)
    dl = torch.empty(b, p, o, device=h.device, dtype=torch.float32)
    with torch.cuda.device(h.device):
        rc = fn(h.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                targets.data_ptr(), member_ptr.data_ptr(), per.data_ptr(),
                dl.data_ptr(), b, hh, o, p, block, 1.0 / b_real,
                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "loss_head_fwd")
    fwd_launches += 1
    return per, dl


def loss_head_bwd_cuda(dper, dl, h, w2, block_seg, *, block: int):
    """One launch → (dh (B, H), dW (O, H))."""
    global bwd_launches
    b, hh = h.shape
    o = w2.shape[0]
    p = dper.shape[0]
    _build.check_tensors(
        "loss_head_bwd", h,
        ("dper", dper, torch.float32),
        ("dl", dl, torch.float32),
        ("h", h, torch.float32),
        ("w2", w2, torch.float32),
        ("block_seg", block_seg, torch.int32))
    if w2.shape[1] != hh or dl.shape != (b, p, o) \
            or block_seg.shape != (hh // block,):
        raise ValueError("loss_head_bwd: inconsistent shapes")
    _check_o(o)
    fn = _build.function("loss_head", "loss_head_bwd_f32",
                         [_P] * 7 + [_I] * 5 + [_P])
    dh = torch.empty(b, hh, device=h.device, dtype=torch.float32)
    dw = torch.empty(o, hh, device=h.device, dtype=torch.float32)
    with torch.cuda.device(h.device):
        rc = fn(dper.data_ptr(), dl.data_ptr(), h.data_ptr(), w2.data_ptr(),
                block_seg.data_ptr(), dh.data_ptr(), dw.data_ptr(), b, hh, o,
                p, block, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "loss_head_bwd")
    bwd_launches += 1
    return dh, dw
