"""Modified Matrix Multiplication (M3) — the paper's core operation.

For a fused hidden tensor ``h`` (B, total_hidden), a fused output weight
``w2`` (O, total_hidden) and per-unit member ids ``seg``:

    y[b, m, o] = sum_{j : seg[j] == m}  h[b, j] * w2[o, j]

  m3_scatter    — the paper's own GPU form: broadcast product + scatter-add
                  (``index_add_``); materialises (B, H, O).
  m3_onehot     — one einsum against a one-hot member selector (H, P):
                  dense, P× redundant work; small sizes only.
  m3_bucketed   — members bucketed by padded size → one batched matmul per
                  bucket.
  m3_pallas     — the segment-blocked matmul kernels (``kernels/ops
                  .m3_matmul``: one CUDA launch forward, dh and dW2
                  backward), the port of the JAX package's Pallas M3.
  m3_loss_head  — training: projection + member bias + softmax
                  cross-entropy in one CUDA kernel per direction
                  (``kernels/ops.loss_head``); the logits never materialise.
  m3_infer_head — serving: projection + member bias (+ log-softmax) in one
                  CUDA kernel (``kernels/ops.infer_head``);
                  ``m3_infer_head_int8`` the same over the int8 serve copy.

Shapes: h (B, H), w2 (O, H) → y (B, P, O).
"""
from __future__ import annotations

import torch

from repro_torch.core.population import Population
from repro_torch.device import layout_tensor


def acc_dtype(t: torch.Tensor) -> torch.dtype:
    """The accumulator dtype of operands of ``t``'s dtype: f32 for f32 and
    bf16 (a product of two bf16 values is exact in f32), f64 for f64."""
    return torch.promote_types(t.dtype, torch.float32)


def m3_scatter(h: torch.Tensor, w2: torch.Tensor, pop: Population,
               seg: torch.Tensor | None = None) -> torch.Tensor:
    """The paper's M3: S[b, j, o] = h[b, j]·w2[o, j], scatter-added over j
    by member.  ``seg``: ``pop.segment_ids`` already on h's device.  bf16
    operands: S in bf16, summed in f32 (JAX ``m3.py:51``) → f32."""
    if seg is None:
        seg = torch.as_tensor(pop.segment_ids, device=h.device)
    y = torch.zeros(h.shape[0], pop.num_members, w2.shape[0],
                    device=h.device, dtype=acc_dtype(h))
    return y.index_add_(1, seg.long(),
                        (h[:, :, None] * w2.t()[None]).to(y.dtype))


def m3_onehot(h: torch.Tensor, w2: torch.Tensor, pop: Population
              ) -> torch.Tensor:
    """y[b, m, o] = Σ_j h[b, j]·w2[o, j]·sel[j, m] with sel the one-hot
    member selector (H, P) — plain PyTorch, not a kernel.  Summed in f32
    whatever the operands' dtype (JAX: ``preferred_element_type``)."""
    acc = acc_dtype(h)
    sel = torch.nn.functional.one_hot(
        torch.as_tensor(pop.segment_ids, device=h.device).long(),
        pop.num_members).to(acc)
    return torch.einsum("bj,oj,jm->bmo", h.to(acc), w2.to(acc), sel)


def m3_bucketed(h: torch.Tensor, w2: torch.Tensor, pop: Population
                ) -> torch.Tensor:
    """Reshape each equal-size run of members to (B, n, hs) and
    batched-matmul against (n, O, hs), summed in f32 whatever the operands'
    dtype (JAX: ``preferred_element_type``)."""
    b, o = h.shape[0], w2.shape[0]
    acc = acc_dtype(h)
    h, w2 = h.to(acc), w2.to(acc)
    pieces = []
    for (m0, n, hs, col0) in pop.size_buckets():
        hh = h[:, col0: col0 + n * hs].reshape(b, n, hs)
        ww = w2[:, col0: col0 + n * hs].reshape(o, n, hs)
        pieces.append(torch.einsum("bnh,onh->bno", hh, ww))
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=1)


def block_seg_on(pop: Population, device) -> tuple:
    """The layout's per-block member ids (int32) and their CSR form
    (``kernels/infer_head.member_ptr``'s (P + 1,) row pointers: the member
    offsets in blocks) on ``device``, built once per (layout, device)."""
    return (layout_tensor(pop, "block_seg", device, pop.block_segment_ids,
                          torch.int32),
            layout_tensor(pop, "member_ptr", device, pop.offsets // pop.block,
                          torch.int32))


def m3_pallas(h: torch.Tensor, w2: torch.Tensor, pop: Population
              ) -> torch.Tensor:
    """The segment-blocked matmul kernels: one launch forward; dh and dW2
    backward (``kernels/ops.m3_matmul``)."""
    from repro_torch.kernels.ops import m3_matmul
    seg, ptr = block_seg_on(pop, h.device)
    return m3_matmul(h, w2, seg, pop.num_members, block_h=pop.block,
                     member_ptr=ptr)


M3_IMPLS = {
    "scatter": m3_scatter,
    "onehot": m3_onehot,
    "bucketed": m3_bucketed,
    "pallas": m3_pallas,
}


def m3(h: torch.Tensor, w2: torch.Tensor, pop: Population,
       impl: str = "bucketed") -> torch.Tensor:
    if impl not in M3_IMPLS:
        raise ValueError(f"unknown m3_impl {impl!r} (have {sorted(M3_IMPLS)})")
    return M3_IMPLS[impl](h, w2, pop)


def m3_loss_head(h: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                 targets: torch.Tensor, pop: Population, *,
                 seg=None) -> torch.Tensor:
    """The training-time fusion of M3: projection + per-member bias +
    softmax cross-entropy + dlogits in one kernel launch per direction.
    Returns the per-member mean NLL (P,) f32.  ``seg``: the layout's
    ``block_segment_ids``, optionally already on the device."""
    from repro_torch.kernels.ops import loss_head
    return loss_head(h, w2, b2, targets,
                     pop.block_segment_ids if seg is None else seg,
                     block_h=pop.block)


# loss-head impls that bypass logits materialisation; deep.fused_loss
# routes through this registry
LOSS_IMPLS = {
    "xla": None,          # log_softmax over forward() logits (deep.fused_loss)
    "fused": m3_loss_head,
}
FUSED_LOSS_IMPLS = frozenset(["fused"])


def m3_infer_head(h: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                  pop: Population, *, log_probs: bool = False,
                  seg=None) -> torch.Tensor:
    """Projection + per-member bias — and optionally the stable
    log-softmax — in ONE kernel launch, producing the (B, P, O)
    logits/log-probs the ensemble reductions consume.  ``seg``: the
    layout's ``block_segment_ids``, optionally already on the device."""
    from repro_torch.kernels.ops import infer_head
    return infer_head(h, w2, b2,
                      pop.block_segment_ids if seg is None else seg,
                      block_h=pop.block, log_probs=log_probs)


def m3_infer_head_int8(h: torch.Tensor, w2_q: torch.Tensor,
                       w2_scale: torch.Tensor, b2: torch.Tensor,
                       pop: Population, *, log_probs: bool = False,
                       seg=None) -> torch.Tensor:
    """``m3_infer_head`` over the int8 serve copy: the head weight stays
    int8 on the device, one f32 scale per hidden tile dequantized inside
    the kernel."""
    from repro_torch.kernels.ops import infer_head_int8
    return infer_head_int8(h, w2_q, w2_scale, b2,
                           pop.block_segment_ids if seg is None else seg,
                           block_h=pop.block, log_probs=log_probs)


# inference head impls — deep.forward(infer=True) routes through this;
# "fused_int8" serves the int8 copy (weights_dtype="int8") and only it
HEAD_IMPLS = {
    "xla": None,          # m3 logits + bias / log_softmax in deep.forward
    "fused": m3_infer_head,
    "fused_int8": m3_infer_head_int8,
}
