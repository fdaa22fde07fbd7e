"""Public kernel entry points of the serving path, with the JAX package's
signatures and shape checks (``repro/kernels/ops.py``).

Dispatch is on the input tensor's device: a CUDA tensor launches the
hand-written kernel (or raises — there is no fallback), a CPU tensor runs
the kernel's plain PyTorch version.  The CPU dispatch counts its calls in
the kernel's launch counter, so the ``depth + 1`` budget holds on either
device (``launch/launch_count.py``).

Static layout arrays (activation ids, masks, segment ids) may be numpy or
tensors; callers on the hot path pass tensors already on the device.
F32 only in this slice.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import fused_input as _fik
from repro_torch.kernels import fused_layer as _flk
from repro_torch.kernels import infer_head as _ihk


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def _as(a, device, dtype) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype).contiguous()
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def _require_f32(**tensors):
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the serving kernels are "
                            "float32 only (bf16/int8: see ROADMAP.md)")


def fused_input_infer(x: torch.Tensor, w_in: torch.Tensor,
                      b_in: torch.Tensor, block_act_ids, mask, *,
                      block: int) -> torch.Tensor:
    """Dense input projection + bias + per-block activation + padding mask
    in one kernel.  x (B, F), w_in (H, F), b_in (H,) → (B, H) of
    ``act(x·W_inᵀ + b_in)·mask``.  H must be block-aligned."""
    h = w_in.shape[0]
    if h % block:
        raise ValueError(f"hidden axis {h} not {block}-aligned")
    if x.shape[1] != w_in.shape[1]:
        raise ValueError(f"feature axis {x.shape[1]} != {w_in.shape[1]}")
    if tuple(b_in.shape) != (h,):
        raise ValueError(f"bias shape {tuple(b_in.shape)} != ({h},)")
    _require_f32(x=x, w_in=w_in, b_in=b_in)
    dev = x.device
    ids = _as(block_act_ids, dev, torch.int32)
    m = _as(mask, dev, torch.float32)
    if tuple(ids.shape) != (h // block,) or tuple(m.shape) != (h,):
        raise ValueError(f"{tuple(ids.shape)} activation ids / "
                         f"{tuple(m.shape)} mask for {h // block} blocks of "
                         f"{block}")
    if _on_card(x):
        return _fik.fused_input_cuda(x.contiguous(), w_in.contiguous(),
                                     b_in.contiguous(), m, ids, block=block)
    _fik.launches += 1
    return _fik.fused_input_plain(x, w_in, b_in, m, ids, block=block)


def fused_layer_infer(h: torch.Tensor, wb: torch.Tensor,
                      b_eff: torch.Tensor, layout, block_act_ids, mask
                      ) -> torch.Tensor:
    """Block-diagonal projection + gated bias + per-tile activation +
    padding mask in one kernel.  h (B, n_in_tiles·blk), wb
    (n_param_blocks, blk, blk), b_eff (n_out_tiles·blk,), ``layout`` a
    ``BlockDiagLayout``, ``block_act_ids`` / ``mask`` of the OUTPUT layer →
    (B, n_out_tiles·blk).  Pass-through members use the shared identity
    tile appended here."""
    blk = layout.block
    if h.shape[1] != layout.n_in_tiles * blk:
        raise ValueError(f"input axis {h.shape[1]} != "
                         f"{layout.n_in_tiles}×{blk}")
    if tuple(wb.shape) != (layout.n_param_blocks, blk, blk):
        raise ValueError(f"weight tiles {tuple(wb.shape)} != "
                         f"({layout.n_param_blocks}, {blk}, {blk})")
    h_out = layout.n_out_tiles * blk
    if tuple(b_eff.shape) != (h_out,):
        raise ValueError(f"bias shape {tuple(b_eff.shape)} != ({h_out},)")
    _require_f32(h=h, wb=wb, b_eff=b_eff)
    dev = h.device
    wb_aug = torch.cat([wb, torch.eye(blk, dtype=wb.dtype, device=dev)[None]])
    acts = _as(block_act_ids, dev, torch.int32)
    if tuple(acts.shape) != (layout.n_out_tiles,):
        raise ValueError(f"{tuple(acts.shape)} activation ids for "
                         f"{layout.n_out_tiles} output tiles")
    m = _as(mask, dev, torch.float32)
    if tuple(m.shape) != (h_out,):
        raise ValueError(f"mask shape {tuple(m.shape)} != ({h_out},)")
    rowptr, s_in, s_w = _flk.schedule_on(layout, dev)
    if _on_card(h):
        return _flk.fused_layer_cuda(h.contiguous(), wb_aug,
                                     b_eff.contiguous(), m, acts, rowptr,
                                     s_in, s_w, blk=blk)
    _flk.launches += 1
    return _flk.fused_layer_plain(h, wb_aug, b_eff, m, acts, rowptr, s_in,
                                  s_w, blk=blk)


def infer_head(h: torch.Tensor, w_out: torch.Tensor, b_out: torch.Tensor,
               block_seg_ids, *, block_h: int,
               log_probs: bool = False) -> torch.Tensor:
    """Forward-only output head: M3 projection + per-member bias (+ stable
    log-softmax) in one kernel.  h (B, H), w_out (O, H), b_out (P, O) →
    (B, P, O) f32 logits, or log-probabilities with ``log_probs``.  H must
    be block_h-aligned and every member's blocks contiguous (sorted
    ``block_seg_ids``)."""
    if h.shape[1] % block_h:
        raise ValueError(f"hidden axis {h.shape[1]} not {block_h}-aligned")
    if w_out.shape[1] != h.shape[1]:
        raise ValueError(f"head weight {tuple(w_out.shape)} does not match "
                         f"hidden axis {h.shape[1]}")
    if b_out.shape[1] != w_out.shape[0]:
        raise ValueError(f"bias {tuple(b_out.shape)} vs {w_out.shape[0]} "
                         "classes")
    _require_f32(h=h, w_out=w_out, b_out=b_out)
    dev = h.device
    if not isinstance(block_seg_ids, torch.Tensor) \
            and np.any(np.diff(np.asarray(block_seg_ids)) < 0):
        raise ValueError("infer_head: members' hidden blocks must be "
                         "contiguous (sorted block_seg_ids)")
    seg = _as(block_seg_ids, dev, torch.int32)
    if seg.shape[0] != h.shape[1] // block_h:
        raise ValueError(f"{seg.shape[0]} segment ids for "
                         f"{h.shape[1] // block_h} hidden blocks")
    ptr = _ihk.member_ptr(seg, b_out.shape[0])
    if _on_card(h):
        return _ihk.infer_head_cuda(h.contiguous(), w_out.contiguous(),
                                    b_out.contiguous(), ptr, block=block_h,
                                    log_probs=log_probs)
    _ihk.launches += 1
    return _ihk.infer_head_plain(h, w_out, b_out, ptr, block=block_h,
                                 log_probs=log_probs)
