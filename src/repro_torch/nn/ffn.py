"""Feed-forward layers: gated and non-gated dense FFNs and the
capacity-padded Mixture-of-Experts, ported from the JAX package's
``repro/nn/ffn.py``.

The expert FFN has two routes, chosen by autograd's mode in
``_expert_ffn``.  Serving runs its three products on the grouped-GEMM
kernel, ``kernels.ops.moe_gemm`` (the port of the TPU kernel
``repro/kernels/moe_gemm.py``, which JAX's docstring names as the TPU form
of its per-expert matmuls): ``_dispatch_combine`` lays the tokens out as
the capacity-padded (E, C, D) buffer, which is the kernel's input of
tokens sorted by expert, every expert's run C rows long.  On a CUDA tensor
that is three launches per MoE layer per forward; on a CPU tensor the
kernel's plain version ``moe_gemm_dense``.  The kernel has no backward
(none in JAX either), so where autograd records the call, training takes
JAX's own route: three batched einsums over the same buffer.

JAX's sharding constraints (``_tp_inner``) and its shard_map MoE
(``moe_apply_shard_map``, ``moe_apply_tp_shard_map``) are placement over a
mesh; without a mesh JAX takes ``moe_apply_dense``, which is what the port
runs (the LM's sharding: ROADMAP Queue 1 item 9(d)).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.nn.common import FFN_ACTS, dense_init, normal_init


# --------------------------------------------------------------------- #
# dense FFN                                                             #
# --------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class FFNConfig:
    d_model: int
    d_ff: int
    act: str = "silu"       # silu|gelu|relu2|relu
    gated: bool = True      # SwiGLU/GeGLU when True
    bias: bool = False


def ffn_init(gen, cfg: FFNConfig, dtype) -> dict:
    params = {"w_up": dense_init(gen, cfg.d_model, cfg.d_ff, dtype,
                                 bias=cfg.bias)}
    if cfg.gated:
        params["w_gate"] = dense_init(gen, cfg.d_model, cfg.d_ff, dtype,
                                      bias=cfg.bias)
    params["w_down"] = dense_init(gen, cfg.d_ff, cfg.d_model, dtype,
                                  bias=cfg.bias, stddev=cfg.d_ff ** -0.5)
    return params


def ffn_apply(p, cfg: FFNConfig, x):
    act = FFN_ACTS[cfg.act]
    up = x @ p["w_up"]["w"]
    if cfg.bias:
        up = up + p["w_up"]["b"]
    if cfg.gated:
        gate = x @ p["w_gate"]["w"]
        if cfg.bias:
            gate = gate + p["w_gate"]["b"]
        h = act(gate) * up
    else:
        h = act(up)
    y = h @ p["w_down"]["w"]
    if cfg.bias:
        y = y + p["w_down"]["b"]
    return y


# --------------------------------------------------------------------- #
# MoE                                                                   #
# --------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_expert: int
    num_experts: int
    top_k: int
    num_shared: int = 0          # always-on shared experts (DeepSeek-MoE)
    renorm_topk: bool = True     # Mixtral renormalises top-k gates
    capacity_factor: float = 1.25
    act: str = "silu"
    aux_loss_coef: float = 0.01
    first_k_dense: int = 0       # leading layers use a dense FFN instead
    dense_ff: int = 0            # width of those dense layers
    sharding: str = "ep"         # JAX's expert placement over a mesh


def _shared_cfg(cfg: MoEConfig) -> FFNConfig:
    return FFNConfig(cfg.d_model, cfg.d_expert * cfg.num_shared, act=cfg.act)


def moe_init(gen, cfg: MoEConfig, dtype) -> dict:
    d, f, e = cfg.d_model, cfg.d_expert, cfg.num_experts
    params = {"router": normal_init(gen, (d, e), torch.float32, d ** -0.5)}
    std = d ** -0.5
    params["experts"] = {
        "w_gate": normal_init(gen, (e, d, f), dtype, std),
        "w_up": normal_init(gen, (e, d, f), dtype, std),
        "w_down": normal_init(gen, (e, f, d), dtype, f ** -0.5),
    }
    if cfg.num_shared:
        params["shared"] = ffn_init(gen, _shared_cfg(cfg), dtype)
    return params


def _route(router_w, cfg: MoEConfig, xf):
    """xf (T, D) -> gates (T, k), expert ids (T, k), aux load-balance
    loss."""
    logits = xf.float() @ router_w                               # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, eidx = torch.topk(probs, cfg.top_k, dim=-1)       # (T, k)
    if cfg.renorm_topk:
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True) \
            .clamp_min(1e-9)
    # Switch-style load-balancing aux loss
    me = probs.mean(0)                                           # (E,)
    ce = torch.zeros(cfg.num_experts, device=xf.device).index_add_(
        0, eidx.reshape(-1),
        torch.full((eidx.numel(),), 1.0 / eidx.numel(), device=xf.device))
    aux = cfg.num_experts * torch.sum(me * ce) * cfg.aux_loss_coef
    return gate_vals.to(xf.dtype), eidx, aux


def block_rows(capacity: int) -> int:
    """The grouped GEMM's ``block_t`` for a capacity of C rows an expert:
    the largest multiple of 8 that divides C, up to 128 (C is a multiple
    of 8: ``moe_apply_dense``)."""
    return next(b for b in range(min(capacity, 128) // 8 * 8, 0, -8)
                if capacity % b == 0)


def _expert_ffn(experts, cfg: MoEConfig, buf):
    """buf (E, C, D) -> (E, C, D), SwiGLU per expert.  Serving: three
    ``ops.moe_gemm`` calls over the (E·C, D) buffer, expert e's C rows a
    run.  Training (autograd records): the batched einsums."""
    act = FFN_ACTS[cfg.act]
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (buf, *experts.values())):
        # JAX's _expert_ffn (repro/nn/ffn.py:171-176), its only route:
        # the grouped GEMM is forward only, so training runs these
        h = act(torch.einsum("ecd,edf->ecf", buf, experts["w_gate"])) * \
            torch.einsum("ecd,edf->ecf", buf, experts["w_up"])
        return torch.einsum("ecf,efd->ecd", h, experts["w_down"])
    e, c, d = buf.shape
    bt = block_rows(c)
    ids = torch.arange(e, dtype=torch.int32, device=buf.device) \
        .repeat_interleave(c // bt)
    x = buf.reshape(e * c, d)
    h = act(ops.moe_gemm(x, experts["w_gate"], ids, block_t=bt)) * \
        ops.moe_gemm(x, experts["w_up"], ids, block_t=bt)
    return ops.moe_gemm(h, experts["w_down"], ids, block_t=bt) \
        .reshape(e, c, d)


def _dispatch_combine(p, cfg: MoEConfig, xf, capacity: int):
    """Capacity-padded dispatch -> expert FFN -> combine.  xf (T, D)."""
    t, d = xf.shape
    n = cfg.num_experts * capacity
    gates, eidx, aux = _route(p["router"], cfg, xf)
    flat_e = eidx.reshape(-1)                                     # (T*k,)
    # position of each (token, expert-slot) within its expert's buffer
    onehot = F.one_hot(flat_e, cfg.num_experts)
    pos = (torch.cumsum(onehot, dim=0) * onehot - 1).amax(dim=-1)  # (T*k,)
    dst = torch.where(pos < capacity, flat_e * capacity + pos,
                      torch.full_like(pos, n))                    # drop slot
    src = torch.arange(t, device=xf.device).repeat_interleave(cfg.top_k)
    buf = torch.zeros(n + 1, d, dtype=xf.dtype, device=xf.device)
    buf[dst] = xf[src]
    out = _expert_ffn(p["experts"], cfg,
                      buf[:-1].reshape(cfg.num_experts, capacity, d))
    out = out.reshape(-1, d)
    picked = torch.where((dst < n)[:, None], out[dst.clamp_max(n - 1)],
                         torch.zeros((), dtype=out.dtype, device=out.device))
    y = (picked.reshape(t, cfg.top_k, d) * gates[..., None]).sum(dim=1)
    return y, aux


def moe_capacity(cfg: MoEConfig, tokens: int) -> int:
    """Rows an expert's buffer holds for ``tokens`` tokens: the capacity
    factor's share, rounded up to a multiple of 8, at least 8."""
    capacity = int(np.ceil(tokens * cfg.top_k / cfg.num_experts
                           * cfg.capacity_factor))
    return max(8, -(-capacity // 8) * 8)


def moe_apply_dense(p, cfg: MoEConfig, x):
    """x (B, S, D) -> (B, S, D), plus the aux loss."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    y, aux = _dispatch_combine(p, cfg, xf, moe_capacity(cfg, b * s))
    if cfg.num_shared:
        y = y + ffn_apply(p["shared"], _shared_cfg(cfg), xf)
    return y.reshape(b, s, d), aux
