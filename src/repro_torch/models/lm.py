"""The decoder-only LM of the JAX package's ``repro/models/lm.py``: dense
GQA (qwen3, h2o-danube with sliding windows, command-r's parallel block
with LayerNorm and scaled tied logits, nemotron's relu², the qwen2-vl
backbone with M-RoPE, qkv biases and an embeddings frontend), MoE
(deepseek-moe's 64 experts top-6 with shared experts after a dense first
layer, mixtral's 8 top-2 with sliding windows), SSM (mamba2: attention-free
Mamba2 blocks, no FFN) and hybrid (hymba: attention and SSM heads in
parallel in every layer, global and sliding-window layers in one stack).

One config, one forward, one train step, prefill and a one-token decode
step.  Layers are grouped into maximal runs of one (mixer, ffn)
structure; a group's parameters are stacked on axis 0, as JAX stacks them
for its ``lax.scan``, so that weights carry across leaf for leaf
(``params_from_jax``); the scan is a Python loop over the stack here.
Each attention or hybrid layer's forward is one flash-attention call
(``nn.attention.attention``); the SSM path (``nn.ssm``, chunked SSD) is
plain PyTorch, as JAX's is einsums; an MoE layer's forward is three
grouped-GEMM calls when it serves and JAX's batched einsums when autograd
records it (``nn.ffn._expert_ffn``); decode is plain PyTorch, as in JAX,
with the caches updated in place (JAX donates them).

Training (``make_train_step``) follows JAX's step: one microbatch, or
``num_micro`` accumulated in ``accum_dtype``, then the global-norm clip
and the optimizer.  Under ``cfg.remat`` each layer's body runs under
``torch.utils.checkpoint`` with nothing saved inside it and is recomputed
in the backward (JAX: ``jax.checkpoint(..., nothing_saveable)`` around
each scanned layer), so a training step launches the flash kernel twice a
layer; serving never rematerialises.

Not here: the sharding specs and the shard_map MoE (ROADMAP Queue 1 item
9(d)): without a mesh JAX's ``_moe_dispatch`` takes ``moe_apply_dense``,
as the port always does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.device import resolve
from repro_torch.nn import attention as attn_lib
from repro_torch.nn import ffn as ffn_lib
from repro_torch.nn import hybrid as hybrid_lib
from repro_torch.nn import ssm as ssm_lib
from repro_torch.nn.attention import AttnConfig
from repro_torch.nn.common import (_device, dense_init, embed_apply,
                                   embed_init, norm_apply, norm_init)
from repro_torch.nn.ffn import FFNConfig, MoEConfig
from repro_torch.nn.hybrid import HybridConfig
from repro_torch.nn.ssm import SSMConfig

NEG = -1e30
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MIXERS = ("attn", "ssm", "hybrid")


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"     # attn | ssm | hybrid
    ffn: str = "dense"      # dense | moe | none
    window: int = 0         # 0 = full attention; >0 = SWA window


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    vocab: int
    d_model: int
    layers: tuple                      # tuple[LayerSpec]
    attn: Optional[AttnConfig] = None
    ssm: Optional[SSMConfig] = None
    ffn: Optional[FFNConfig] = None
    dense_ffn0: Optional[FFNConfig] = None  # 'dense' layers' ffn, MoE archs
    moe: Optional[MoEConfig] = None
    norm: str = "rmsnorm"
    tie_embeddings: bool = False
    logit_scale: float = 1.0           # command-r multiplies logits
    parallel_block: bool = False       # command-r: x + attn(n(x)) + ffn(n(x))
    param_dtype: str = "bfloat16"
    remat: bool = True                 # training: recompute each layer
    moe_impl: str = "dense"            # dense | shard_map (JAX's EP on a mesh)
    frontend: str = "tokens"           # tokens | embeds (vlm/audio stub)
    vocab_pad_to: int = 128

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.param_dtype]

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return ((self.vocab + m - 1) // m) * m

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    def groups(self):
        """Maximal runs of layers with identical (mixer, ffn) structure:
        ((mixer, ffn), layer specs, first layer index) each."""
        out = []
        i = 0
        while i < len(self.layers):
            j = i
            sig = (self.layers[i].mixer, self.layers[i].ffn)
            while (j + 1 < len(self.layers)
                   and (self.layers[j + 1].mixer,
                        self.layers[j + 1].ffn) == sig):
                j += 1
            out.append((sig, self.layers[i:j + 1], i))
            i = j + 1
        return out

    def hybrid_cfg(self) -> HybridConfig:
        return HybridConfig(self.attn, self.ssm)

    def num_params(self) -> int:
        """Exact parameter count (from shapes on the meta device: no
        allocation)."""
        return sum(t.numel() for t in tree_leaves(init_params(None, self)))

    def num_active_params(self) -> int:
        """Active-per-token params (MoE: top_k + shared experts only)."""
        total = self.num_params()
        if self.moe is None:
            return total
        n_moe_layers = sum(1 for l in self.layers if l.ffn == "moe")
        per_expert = 3 * self.d_model * self.moe.d_expert
        inactive = n_moe_layers * per_expert * (self.moe.num_experts
                                                - self.moe.top_k)
        return total - inactive


def _dense_cfg(cfg: LMConfig) -> FFNConfig:
    """The FFN of 'dense' layers: ``dense_ffn0`` in MoE archs."""
    if cfg.moe is not None and cfg.dense_ffn0 is not None:
        return cfg.dense_ffn0
    return cfg.ffn


# --------------------------------------------------------------------- #
# init                                                                  #
# --------------------------------------------------------------------- #

def _init_layer(gen, cfg: LMConfig, mixer: str, ffn_kind: str) -> dict:
    dev = _device(gen)
    params = {"norm1": norm_init(cfg.d_model, cfg.dtype, cfg.norm, dev)}
    if mixer == "attn":
        params["mixer"] = attn_lib.attn_init(gen, cfg.attn, cfg.dtype)
    elif mixer == "ssm":
        params["mixer"] = ssm_lib.ssm_init(gen, cfg.ssm, cfg.dtype)
    elif mixer == "hybrid":
        params["mixer"] = hybrid_lib.hybrid_init(gen, cfg.hybrid_cfg(),
                                                 cfg.dtype)
    else:
        raise ValueError(f"mixer {mixer!r}: one of {MIXERS}")
    if ffn_kind != "none":
        if not cfg.parallel_block:
            params["norm2"] = norm_init(cfg.d_model, cfg.dtype, cfg.norm, dev)
        if ffn_kind == "dense":
            params["ffn"] = ffn_lib.ffn_init(gen, _dense_cfg(cfg), cfg.dtype)
        elif ffn_kind == "moe":
            params["ffn"] = ffn_lib.moe_init(gen, cfg.moe, cfg.dtype)
        else:
            raise ValueError(ffn_kind)
    return params


def init_params(gen, cfg: LMConfig) -> dict:
    """Parameters drawn from ``gen`` (a ``torch.Generator``), on its device;
    a group's layers stacked on axis 0.  ``gen=None``: the same tree on the
    meta device (shapes and dtypes only)."""
    params = {}
    if cfg.frontend == "tokens" or cfg.tie_embeddings:
        params["embed"] = embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                     cfg.dtype)
    for gi, ((mixer, ffn_kind), layer_specs, _) in enumerate(cfg.groups()):
        layers = [_init_layer(gen, cfg, mixer, ffn_kind)
                  for _ in layer_specs]
        params[f"g{gi}"] = tree_map(lambda *xs: torch.stack(xs), *layers)
        del layers
    params["final_norm"] = norm_init(cfg.d_model, cfg.dtype, cfg.norm,
                                     _device(gen))
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                       cfg.dtype)
    return params


def params_from_jax(tree, device=None) -> dict:
    """The JAX package's parameters, as numpy arrays (``jax.tree.map(
    np.asarray, params)``), as the port's tensors on ``device`` (default
    the card).  bf16 leaves (numpy dtype ``bfloat16``) go through their raw
    bits."""
    dev = resolve(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)
                                 .copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a, copy=True))
        return t.to(dev)

    if isinstance(tree, dict):
        return {k: params_from_jax(v, dev) for k, v in tree.items()}
    return leaf(tree)


# --------------------------------------------------------------------- #
# forward                                                               #
# --------------------------------------------------------------------- #

def _vocab_mask(cfg: LMConfig, dtype, device):
    if cfg.padded_vocab == cfg.vocab:
        return None
    return torch.where(torch.arange(cfg.padded_vocab, device=device)
                       < cfg.vocab, 0.0, NEG).to(dtype)


def _layer(gp: dict, li: int) -> dict:
    """Layer ``li`` of a stacked group: views into the stack."""
    return tree_map(lambda t: t[li], gp)


def _ffn_apply(lp, cfg: LMConfig, ffn_kind: str, f):
    """The block's FFN → (y, aux)."""
    if ffn_kind == "dense":
        return (ffn_lib.ffn_apply(lp["ffn"], _dense_cfg(cfg), f),
                torch.zeros((), device=f.device))
    return ffn_lib.moe_apply_dense(lp["ffn"], cfg.moe, f)


def _block(lp, cfg: LMConfig, ffn_kind: str, x, h, mix):
    """The residual block around a mixer's output ``mix`` (h = norm1(x))
    → (x', aux)."""
    if ffn_kind == "none":
        return x + mix, torch.zeros((), device=x.device)
    if cfg.parallel_block:
        y, aux = _ffn_apply(lp, cfg, ffn_kind, h)   # command-r: shared norm
        return x + mix + y, aux
    x = x + mix
    y, aux = _ffn_apply(lp, cfg, ffn_kind, norm_apply(lp["norm2"], x))
    return x + y, aux


def _embed_in(params, cfg: LMConfig, batch):
    if cfg.frontend == "embeds":
        return batch["embeds"].to(cfg.dtype)
    return embed_apply(params["embed"], batch["tokens"])


def _positions_for(cfg: LMConfig, b: int, s: int, device):
    pos = torch.arange(s, dtype=torch.int32, device=device)[None] \
        .expand(b, s)
    if cfg.attn is not None and cfg.attn.rope_kind == "mrope":
        return pos[None].expand(3, b, s)   # text-equivalent stub
    return pos


def _readout(params, cfg: LMConfig, x):
    x = norm_apply(params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["embedding"].T
    else:
        logits = x @ params["lm_head"]["w"]
    return logits * cfg.logit_scale


def _layer_apply(lp, cfg: LMConfig, mixer: str, ffn_kind: str, x,
                 positions, window: int):
    """One transformer block (norm1, the mixer, the residual block) →
    (x', aux)."""
    h = norm_apply(lp["norm1"], x)
    if mixer == "attn":
        mix = attn_lib.attention(lp["mixer"], cfg.attn, h, positions,
                                 window=window)
    elif mixer == "ssm":
        mix = ssm_lib.ssm_apply(lp["mixer"], cfg.ssm, h)
    else:
        mix = hybrid_lib.hybrid_apply(lp["mixer"], cfg.hybrid_cfg(), h,
                                      positions, window=window)
    return _block(lp, cfg, ffn_kind, x, h, mix)


def forward(params, cfg: LMConfig, batch):
    """batch: {tokens|embeds} -> (logits (B,S,Vp), aux_loss).  Under
    ``cfg.remat`` with grad enabled each layer is checkpointed: only its
    inputs are kept, and the backward recomputes it."""
    x = _embed_in(params, cfg, batch)
    b, s = x.shape[:2]
    positions = _positions_for(cfg, b, s, x.device)
    aux = torch.zeros((), device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for gi, ((mixer, ffn_kind), layer_specs, _) in enumerate(cfg.groups()):
        for li, ls in enumerate(layer_specs):
            lp = _layer(params[f"g{gi}"], li)
            if remat:
                x, a = checkpoint(_layer_apply, lp, cfg, mixer, ffn_kind, x,
                                  positions, ls.window, use_reentrant=False)
            else:
                x, a = _layer_apply(lp, cfg, mixer, ffn_kind, x, positions,
                                    ls.window)
            aux = aux + a
    return _readout(params, cfg, x), aux


def softmax_xent(logits, labels, cfg: LMConfig, z_loss: float = 1e-4):
    """Mean NLL over tokens; pad-vocab slots masked; z-loss regulariser."""
    lf = logits.float()
    vm = _vocab_mask(cfg, torch.float32, lf.device)
    if vm is not None:
        lf = lf + vm
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    loss = (lse - gold).mean()
    if z_loss:
        loss = loss + z_loss * torch.mean(lse ** 2)
    return loss


def loss_and_metrics(params, cfg: LMConfig, batch):
    logits, aux = forward(params, cfg, batch)
    loss = softmax_xent(logits, batch["labels"], cfg)
    tokens = torch.tensor(float(batch["labels"].numel()),
                          device=loss.device)
    return loss + aux, {"loss": loss, "aux_loss": aux, "tokens": tokens}


def loss_and_grads(params, cfg: LMConfig, batch):
    """``loss_and_metrics`` and its gradient with respect to every leaf of
    ``params`` (JAX: ``jax.value_and_grad(..., has_aux=True)``) →
    (total, metrics, grads in the parameters' dtypes).  ``params`` are
    left untouched."""
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    leaves = tree_leaves(live)
    with torch.enable_grad():
        total, metrics = loss_and_metrics(live, cfg, batch)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return total.detach(), metrics, tree_unflatten(params, grads)


def make_train_step(cfg: LMConfig, optimizer, lr_fn, *, num_micro: int = 1,
                    grad_clip: float = 1.0, accum_dtype=torch.float32):
    """(params, opt_state, batch, step) -> (params, opt_state, metrics),
    JAX's ``make_train_step`` statement for statement.

    ``batch``: a dict of tensors on the parameters' device ({tokens|embeds,
    labels}, batch-major).  ``num_micro > 1`` splits the batch into that
    many microbatches along axis 0; each one's gradients are cast to
    ``accum_dtype`` and added, in order, into zeros of ``accum_dtype``; the
    sum is cast to f32 and divided by ``num_micro`` (the loss likewise, a
    f32 sum).  Then the global-norm clip at ``grad_clip``, the optimizer's
    update at ``lr_fn(step)`` and ``apply_updates``.  Metrics: "loss" (the
    NLL plus the aux term, as in JAX), "grad_norm" (before the clip),
    "lr".  The LM across ranks (JAX's ``mesh``, ``param_specs``) is ROADMAP
    Queue 1 item 9(d)."""
    from repro_torch.optim.optimizers import (apply_updates,
                                              clip_by_global_norm)

    def train_step(params, opt_state, batch, step):
        lr = lr_fn(step)
        if num_micro == 1:
            loss, _, grads = loss_and_grads(params, cfg, batch)
            grads = tree_map(lambda g: g.float(), grads)
        else:
            rows = next(iter(batch.values())).shape[0]
            if rows % num_micro:
                raise ValueError(f"num_micro {num_micro} does not divide "
                                 f"the batch of {rows} rows")
            mb = {k: v.reshape(num_micro, rows // num_micro, *v.shape[1:])
                  for k, v in batch.items()}
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                                  device=p.device), params)
            lsum = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            for i in range(num_micro):
                lo, _, g = loss_and_grads(params, cfg,
                                          {k: v[i] for k, v in mb.items()})
                for a, b in zip(tree_leaves(gsum), tree_leaves(g)):
                    a.add_(b.to(accum_dtype))
                lsum = lsum + lo
                del g
            grads = tree_map(lambda g: g.float() / num_micro, gsum)
            loss = lsum / num_micro
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        upd, opt_state = optimizer.update(grads, opt_state, params, lr)
        params = apply_updates(params, upd)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   "lr": lr}

    return train_step


# --------------------------------------------------------------------- #
# serving: cache init / prefill / decode                                #
# --------------------------------------------------------------------- #

def _group_cache_len(cfg: LMConfig, layer_specs, max_len: int) -> int:
    """A group's ring length: SWA groups hold max(window) slots (and the
    config's window bounds every attention cache, nn.attention)."""
    wins = [ls.window for ls in layer_specs]
    eff_len = min(max_len, max(wins)) if all(w > 0 for w in wins) \
        else max_len
    return attn_lib.cache_len(cfg.attn, eff_len)


def init_caches(cfg: LMConfig, batch: int, max_len: int, device=None):
    """Per-group stacked decode caches (leading axis = layers in group):
    attention {"k", "v" (L,B,C,Hkv,dh) in the params' dtype, "pos" (L,B,C)
    int32, −1 = empty}; SSM {"conv" (L,B,d_conv−1,conv_dim) in the params'
    dtype, "state" (L,B,H,P,N) f32}; hybrid {"attn": ..., "ssm": ...}, its
    ring as long as an attention group's."""
    caches = {}
    for gi, ((mixer, _), layer_specs, _) in enumerate(cfg.groups()):
        if mixer == "ssm":
            proto = ssm_lib.init_ssm_cache(cfg.ssm, batch, cfg.dtype, device)
        elif mixer == "attn":
            proto = attn_lib.init_kv_cache(
                cfg.attn, batch, _group_cache_len(cfg, layer_specs, max_len),
                cfg.dtype, device)
        elif mixer == "hybrid":
            proto = hybrid_lib.init_hybrid_cache(
                cfg.hybrid_cfg(), batch,
                _group_cache_len(cfg, layer_specs, max_len), cfg.dtype,
                device)
        else:
            raise ValueError(f"mixer {mixer!r}: one of {MIXERS}")
        caches[f"g{gi}"] = tree_map(
            lambda v: v[None].repeat(len(layer_specs), *(1,) * v.dim()),
            proto)
    return caches


def make_serve_step(cfg: LMConfig):
    """One-token decode: (params, caches, batch{tokens|embeds}, cur_pos
    (B,)) -> (logits (B,1,Vp), caches), the caches updated in place."""

    def serve_step(params, caches, batch, cur_pos):
        x = _embed_in(params, cfg, batch)          # (B,1,D)
        for gi, ((mixer, ffn_kind), layer_specs, _) in \
                enumerate(cfg.groups()):
            gcaches = caches[f"g{gi}"]
            for li, ls in enumerate(layer_specs):
                lp = _layer(params[f"g{gi}"], li)
                cache = _layer(gcaches, li)                     # views
                h = norm_apply(lp["norm1"], x)
                if mixer == "attn":
                    mix, _ = attn_lib.decode_step(lp["mixer"], cfg.attn, h,
                                                  cache, cur_pos,
                                                  window=ls.window)
                elif mixer == "ssm":
                    mix, _ = ssm_lib.ssm_decode_step(lp["mixer"], cfg.ssm, h,
                                                     cache)
                else:
                    mix, _ = hybrid_lib.hybrid_decode_step(
                        lp["mixer"], cfg.hybrid_cfg(), h, cache, cur_pos,
                        window=ls.window)
                x, _ = _block(lp, cfg, ffn_kind, x, h, mix)
        logits = _readout(params, cfg, x)
        vm = _vocab_mask(cfg, logits.dtype, logits.device)
        if vm is not None:
            logits = logits + vm
        return logits, caches

    return serve_step


def prefill(params, cfg: LMConfig, batch, max_len: int):
    """Full-prompt forward that also builds decode caches.

    Returns (last-position logits (B,1,Vp), caches positioned after S)."""
    x = _embed_in(params, cfg, batch)
    b, s = x.shape[:2]
    positions = _positions_for(cfg, b, s, x.device)
    caches = init_caches(cfg, b, max_len, x.device)
    for gi, ((mixer, ffn_kind), layer_specs, _) in enumerate(cfg.groups()):
        gcaches = caches[f"g{gi}"]
        for li, ls in enumerate(layer_specs):
            lp = _layer(params[f"g{gi}"], li)
            h = norm_apply(lp["norm1"], x)
            if mixer == "attn":
                mix, (k, v) = attn_lib.attention(
                    lp["mixer"], cfg.attn, h, positions, window=ls.window,
                    return_kv=True)
                new = _kv_to_ring(k, v, s, gcaches["k"].shape[2])
            elif mixer == "ssm":
                mix, new = ssm_lib.ssm_apply(lp["mixer"], cfg.ssm, h,
                                             return_cache=True)
            else:
                mix, (k, v), ssm_cache = hybrid_lib.hybrid_apply(
                    lp["mixer"], cfg.hybrid_cfg(), h, positions,
                    window=ls.window, return_cache=True)
                new = {"attn": _kv_to_ring(k, v, s,
                                           gcaches["attn"]["k"].shape[2]),
                       "ssm": ssm_cache}
            for dst, val in zip(tree_leaves(_layer(gcaches, li)),
                                tree_leaves(new)):
                dst.copy_(val)
            x, _ = _block(lp, cfg, ffn_kind, x, h, mix)
    logits = _readout(params, cfg, x[:, -1:])
    vm = _vocab_mask(cfg, logits.dtype, logits.device)
    if vm is not None:
        logits = logits + vm
    return logits, caches


def _kv_to_ring(k, v, s: int, clen: int) -> dict:
    """Pack prefill (B,S,hkv,dh) k/v into the decode ring-buffer layout."""
    b = k.shape[0]
    take = min(s, clen)
    pos_tail = torch.arange(s - take, s, device=k.device)
    slots = pos_tail % clen
    ck = torch.zeros((b, clen) + tuple(k.shape[2:]), dtype=k.dtype,
                     device=k.device)
    cv = torch.zeros((b, clen) + tuple(v.shape[2:]), dtype=v.dtype,
                     device=v.device)
    cpos = torch.full((b, clen), -1, dtype=torch.int32, device=k.device)
    ck[:, slots] = k[:, -take:]
    cv[:, slots] = v[:, -take:]
    cpos[:, slots] = pos_tail.to(torch.int32)[None]
    return {"k": ck, "v": cv, "pos": cpos}
