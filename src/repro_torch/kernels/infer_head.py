"""Forward-only output head: per-member M3 projection + member bias
(+ optional stable log-softmax).

``infer_head_cuda`` launches the CUDA kernel ``csrc/infer_head.cu`` (the
port of the TPU kernel ``repro/kernels/infer_head.py::infer_head_fwd``);
``infer_head_plain`` is the same function in plain PyTorch (the paper's
scatter-add form, via ``index_add_``).  Both take h (B, H), w2 (O, H),
b2 (P, O) f32 and the members' hidden-block ranges in CSR form,
``member_ptr`` (P + 1,) int32 in units of ``block`` hidden units, and
return (B, P, O) f32 logits — log-probabilities under ``log_probs``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0          # kernel launches (the CPU dispatch in ops counts too)
MAX_O = 16            # classes the kernel keeps in registers (infer_head.cu)

_P, _I = ctypes.c_void_p, ctypes.c_int


def member_ptr(block_seg_ids: torch.Tensor, num_members: int) -> torch.Tensor:
    """Per-block member ids (sorted, every member contiguous) → CSR row
    pointers (P + 1,) int32 over hidden blocks.  Device ops only: no host
    round trip on the serving path."""
    counts = torch.bincount(block_seg_ids.long(), minlength=num_members)
    ptr = torch.zeros(num_members + 1, dtype=torch.int64,
                      device=block_seg_ids.device)
    ptr[1:] = torch.cumsum(counts, 0)
    return ptr.to(torch.int32)


def infer_head_plain(h, w2, b2, member_ptr, *, block: int,
                     log_probs: bool = False):
    b, p, o = h.shape[0], b2.shape[0], w2.shape[0]
    widths = (member_ptr[1:] - member_ptr[:-1]).long() * block
    seg = torch.repeat_interleave(torch.arange(p, device=h.device), widths)
    y = torch.zeros(b, p, o, device=h.device, dtype=torch.float32)
    y.index_add_(1, seg, h[:, :, None] * w2.t()[None])
    y = y + b2[None]
    return torch.log_softmax(y, dim=-1) if log_probs else y


def _lib():
    lib = _build.library("infer_head")
    fn = lib.infer_head_f32
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def infer_head_cuda(h, w2, b2, member_ptr, *, block: int,
                    log_probs: bool = False):
    global launches
    b, hh = h.shape
    o, p = w2.shape[0], b2.shape[0]
    for name, t, dt in (("h", h, torch.float32), ("w2", w2, torch.float32),
                        ("b2", b2, torch.float32),
                        ("member_ptr", member_ptr, torch.int32)):
        if not t.is_cuda or t.device != h.device:
            raise ValueError(f"infer_head: {name} must be on {h.device}")
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"infer_head: {name} must be contiguous {dt}, "
                             f"got {t.dtype}")
    if w2.shape[1] != hh or b2.shape[1] != o or member_ptr.shape != (p + 1,):
        raise ValueError("infer_head: inconsistent shapes")
    if o > MAX_O:
        raise ValueError(f"infer_head: {o} classes, the kernel supports at "
                         f"most {MAX_O}")
    fn = _lib()
    y = torch.empty(b, p, o, device=h.device, dtype=torch.float32)
    with torch.cuda.device(h.device):
        rc = fn(h.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                member_ptr.data_ptr(), y.data_ptr(), b, hh, o, p, block,
                int(bool(log_probs)), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "infer_head")
    launches += 1
    return y
