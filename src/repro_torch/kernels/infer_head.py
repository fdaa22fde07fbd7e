"""Forward-only output head: per-member M3 projection + member bias
(+ optional stable log-softmax).

``infer_head_cuda`` launches the CUDA kernel ``csrc/infer_head.cu`` (the
port of the TPU kernel ``repro/kernels/infer_head.py::infer_head_fwd``);
``infer_head_plain`` is the same function in plain PyTorch (the paper's
scatter-add form, via ``index_add_``).  Both take h (B, H), w2 (O, H),
b2 (P, O) f32 and the members' hidden-block ranges in CSR form,
``member_ptr`` (P + 1,) int32 in units of ``block`` hidden units, and
return (B, P, O) f32 logits — log-probabilities under ``log_probs``.

The f32 kernel streams h with 16-byte loads (``"vec4"``) or, where the
block or a tensor does not allow it, with 4-byte ones (``"scalar"``, the
same kernel's other instance): ``kernel_path`` says which, by the rule the
C entries apply.  ``cta_members`` is its member-to-CTA rule.  Both rules
are those of the streaming core ``csrc/head_stream.cuh``, which the
training loss head's forward (``loss_head.py``) shares.

``infer_head_int8_cuda`` launches ``csrc/infer_head.cu``'s int8 kernel (the
port of ``infer_head.py::infer_head_int8_fwd``): w2 (O, H) int8 with one
f32 scale per hidden tile (H / block,), on the same streaming core, each
thread's weights dequantized in registers once a tile; its ``kernel_path``
is the same rule, applied to an int8 w2 (4-byte alignment).
``infer_head_int8_plain`` dequantizes, then runs ``infer_head_plain``.

The bf16 compute policy (DESIGN.md §7): bf16 h and w2 (b2 f32) launch the
f32 kernel's bf16 instance (entry ``infer_head_bf16``, the streaming core's
``BF16Weights`` and bf16 h loads, widened): the logits (and log-probs) stay
f32.  Its ``kernel_path`` is the same rule at bf16's 8-byte alignment.  It
counts in ``bf16_launches``.  The int8 kernel under the policy takes bf16
h (entry ``infer_head_i8_bf16``: ``I8Weights`` with bf16 h loads); its
logits stay f32; it counts in ``bf16_int8_launches``.
"""
from __future__ import annotations

import bisect
import ctypes

import torch

from repro_torch.kernels import _build

# kernel launches (the CPU dispatch in ops counts its plain calls too):
launches = 0          # f32 weights
int8_launches = 0     # int8 weights
bf16_launches = 0     # bf16 h and weights (the compute policy)
bf16_int8_launches = 0  # int8 weights, bf16 h (the compute policy)
MAX_O = 16            # classes the kernel keeps in registers (infer_head.cu)

_P, _I = ctypes.c_void_p, ctypes.c_int


def kernel_path(block: int, *tensors) -> str:
    """The design a launch of the streaming head kernels (this module's two,
    ``loss_head.py``'s two) takes: ``"vec4"`` where ``block`` is a multiple
    of 4 (a thread's 4 units then lie in one member and share one scale)
    and every tensor the kernel walks 4 units at a time (h and w2 or w2_q;
    the loss head's backward's dh and dW too) has rows of a multiple of 4
    units and starts on a boundary of 4 of its elements (16 bytes for f32,
    4 for int8: one load of a thread's 4 units), else ``"scalar"``.
    ``csrc/head_stream.cuh::takes_vec4`` is the same rule."""
    vec = block % 4 == 0 and all(
        t.data_ptr() % (4 * t.element_size()) == 0 and t.shape[-1] % 4 == 0
        for t in tensors)
    return "vec4" if vec else "scalar"


def cta_members(member_ptr, cta: int, *, block: int, hidden: int,
                tile: int) -> range:
    """The members that CTA ``cta`` of a streaming head forward (this
    module's f32 kernel, ``loss_head_fwd``) owns, by the rule the kernels
    apply (``csrc/head_stream.cuh::cta_members``): member m belongs to the
    CTA whose ``tile`` units hold its first unit ``member_ptr[m] * block``,
    and the last CTA also takes the members that start at or past its
    tile's end.  A CTA's members run from the first member starting at or
    past its tile's first unit to the first one starting at or past the
    next tile's."""
    starts = [int(s) * block for s in member_ptr[:-1]]
    n_tiles = max(1, -(-hidden // tile))
    end = (len(starts) if cta + 1 == n_tiles
           else bisect.bisect_left(starts, (cta + 1) * tile))
    return range(bisect.bisect_left(starts, cta * tile), end)


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
    """Products and sums in f32 (f64 for f64 inputs), whatever the operands'
    dtype, as JAX's kernel accumulates; the output is f32 (f64)."""
    b, p, o = h.shape[0], b2.shape[0], w2.shape[0]
    acc = torch.promote_types(h.dtype, torch.float32)
    widths = (member_ptr[1:] - member_ptr[:-1]).long() * block
    seg = torch.repeat_interleave(torch.arange(p, device=h.device), widths)
    y = torch.zeros(b, p, o, device=h.device, dtype=acc)
    y.index_add_(1, seg, h.to(acc)[:, :, None] * w2.to(acc).t()[None])
    y = y + b2[None]
    return torch.log_softmax(y, dim=-1) if log_probs else y


def infer_head_int8_plain(h, w2_q, w2_scale, b2, member_ptr, *, block: int,
                          log_probs: bool = False):
    w2 = w2_q.to(torch.float32) * w2_scale.repeat_interleave(block)[None, :]
    return infer_head_plain(h, w2, b2, member_ptr, block=block,
                            log_probs=log_probs)


def _check(where, h, w2, b2, member_ptr, w_dtype):
    _build.operand_suffix(where, h)
    _build.check_tensors(where, h,
                         ("h", h, h.dtype), ("w2", w2, w_dtype),
                         ("b2", b2, torch.float32),
                         ("member_ptr", member_ptr, torch.int32))
    o, p = w2.shape[0], b2.shape[0]
    if w2.shape[1] != h.shape[1] or b2.shape[1] != o \
            or member_ptr.shape != (p + 1,):
        raise ValueError(f"{where}: inconsistent shapes")
    if o > MAX_O:
        raise ValueError(f"{where}: {o} classes, the kernel supports at "
                         f"most {MAX_O}")


def infer_head_cuda(h, w2, b2, member_ptr, *, block: int,
                    log_probs: bool = False):
    """One launch → (B, P, O) f32 logits (log-probs), h and w2 f32 or both
    bf16."""
    suffix = _build.operand_suffix("infer_head", h)
    _check("infer_head", h, w2, b2, member_ptr, h.dtype)
    b, hh = h.shape
    o, p = w2.shape[0], b2.shape[0]
    fn = _build.function("infer_head", "infer_head_" + suffix,
                         [_P] * 5 + [_I] * 6 + [_P])
    y = torch.empty(b, p, o, device=h.device, dtype=torch.float32)
    with torch.cuda.device(h.device):
        rc = fn(h.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                member_ptr.data_ptr(), y.data_ptr(), b, hh, o, p, block,
                int(bool(log_probs)), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "infer_head")
    _build.count(globals(), "launches", h.dtype)
    return y


def infer_head_int8_cuda(h, w2_q, w2_scale, b2, member_ptr, *, block: int,
                         log_probs: bool = False):
    """One launch → (B, P, O) f32 logits (log-probs) over int8 w2, h f32
    or bf16."""
    _check("infer_head_int8", h, w2_q, b2, member_ptr, torch.int8)
    _build.check_tensors("infer_head_int8", h,
                         ("w2_scale", w2_scale, torch.float32))
    b, hh = h.shape
    o, p = w2_q.shape[0], b2.shape[0]
    if hh % block or w2_scale.shape != (hh // block,):
        raise ValueError("infer_head_int8: one scale per hidden tile")
    fn = _build.function(
        "infer_head",
        "infer_head_i8" + ("_bf16" if h.dtype == torch.bfloat16 else ""),
        [_P] * 6 + [_I] * 6 + [_P])
    y = torch.empty(b, p, o, device=h.device, dtype=torch.float32)
    with torch.cuda.device(h.device):
        rc = fn(h.data_ptr(), w2_q.data_ptr(), w2_scale.data_ptr(),
                b2.data_ptr(), member_ptr.data_ptr(), y.data_ptr(), b, hh, o,
                p, block, int(bool(log_probs)),
                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "infer_head_int8")
    _build.count(globals(), "int8_launches", h.dtype)
    return y
