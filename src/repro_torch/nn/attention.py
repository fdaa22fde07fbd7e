"""Grouped-query attention with sliding windows, qk-norm and a ring-buffer
KV cache, ported from the JAX package's ``repro/nn/attention.py``.

``attention`` (training forward, prefill) computes its scores through the
flash-attention kernel, ``kernels.ops.flash_attention`` (the port of the
TPU kernel ``repro/kernels/flash_attn.py``, which JAX's docstring names
as the TPU form of its chunked path): q goes from (B, S, Hkv, G, dh) to a
contiguous (B, Hkv·G, S, dh), k and v to (B, Hkv, S, dh), query head
h = hkv·G + g reading kv head hkv, as JAX keeps the kv-head axis as a batch
axis; kv is never repeated.  On a CUDA tensor that is one launch per call;
on a CPU tensor the kernel's plain version ``flash_attn_dense``, JAX's
oracle, which its ``attend_dense`` and ``attend_chunked`` both equal.  The
kernel masks by positions counted from 0 on both axes, which are the
positions ``models.lm.forward`` and ``prefill`` give: causal ``q ≥ kv`` and,
for a window > 0, ``q − kv < window`` (JAX's ``_mask_bias``).

``decode_step`` stays plain PyTorch, as in JAX (einsums over the ring):
its mask reads the positions stored in the ring, which the kernel does
not take.  It updates the cache in place (JAX donates it).

JAX's sharding constraints (``_tp_cols``) are GSPMD placement and have no
counterpart on one card; cross-attention (``kv_override``, whisper) is the
encoder-decoder's (ROADMAP Queue 1 item 9(c)).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops
from repro_torch.nn.common import dense_init, rms_head_norm
from repro_torch.nn.rope import apply_mrope, apply_rope

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    qk_norm: bool = False
    bias: bool = False                  # bias on ALL projections (whisper)
    qkv_bias: bool = False              # bias on q/k/v only (qwen2-vl)
    sliding_window: int | None = None   # None = full attention
    softmax_scale: float | None = None
    rope_kind: str = "rope"             # 'rope' | 'mrope' | 'none'
    rope_theta: float = 1e4
    mrope_sections: tuple = (16, 24, 24)

    @property
    def scale(self) -> float:
        return self.softmax_scale or self.d_head ** -0.5


def _apply_pos_emb(cfg: AttnConfig, q, k, positions):
    """positions: (B,S) for rope, (3,B,S) for mrope.  q (B,S,Hkv,G,dh)."""
    if cfg.rope_kind == "none":
        return q, k
    b, s, hkv, g, dh = q.shape
    qf = q.reshape(b, s, hkv * g, dh)
    if cfg.rope_kind == "rope":
        qf, k = apply_rope(qf, k, positions, dh, cfg.rope_theta)
    elif cfg.rope_kind == "mrope":
        qf, k = apply_mrope(qf, k, positions, dh, cfg.rope_theta,
                            cfg.mrope_sections)
    else:
        raise ValueError(cfg.rope_kind)
    return qf.reshape(b, s, hkv, g, dh), k


def attn_init(gen, cfg: AttnConfig, dtype) -> dict:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    in_bias = cfg.bias or cfg.qkv_bias
    params = {name: dense_init(gen, d, od, dtype, bias=in_bias)
              for name, od in (("wq", hq * dh), ("wk", hkv * dh),
                               ("wv", hkv * dh))}
    params["wo"] = dense_init(gen, hq * dh, d, dtype, bias=cfg.bias,
                              stddev=(hq * dh) ** -0.5)
    if cfg.qk_norm:
        dev = params["wq"]["w"].device
        params["q_norm"] = torch.ones(dh, dtype=dtype, device=dev)
        params["k_norm"] = torch.ones(dh, dtype=dtype, device=dev)
    return params


def qkv_project(p, cfg: AttnConfig, x):
    """x (B,S,D) -> q (B,S,Hkv,G,dh), k, v (B,S,Hkv,dh)."""
    b, s, _ = x.shape
    g = cfg.n_heads // cfg.n_kv_heads
    q = (x @ p["wq"]["w"]).reshape(b, s, cfg.n_kv_heads, g, cfg.d_head)
    k = (x @ p["wk"]["w"]).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    v = (x @ p["wv"]["w"]).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    if cfg.bias or cfg.qkv_bias:
        q = q + p["wq"]["b"].reshape(cfg.n_kv_heads, g, cfg.d_head)
        k = k + p["wk"]["b"].reshape(cfg.n_kv_heads, cfg.d_head)
        v = v + p["wv"]["b"].reshape(cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        q = rms_head_norm(p["q_norm"], q)
        k = rms_head_norm(p["k_norm"], k)
    return q, k, v


def out_project(p, cfg: AttnConfig, o):
    """o (B,S,Hkv,G,dh) -> (B,S,D)."""
    b, s = o.shape[:2]
    y = o.reshape(b, s, cfg.n_heads * cfg.d_head) @ p["wo"]["w"]
    if cfg.bias:
        y = y + p["wo"]["b"]
    return y


_USE_CFG = object()


def attend(q, k, v, *, causal: bool, window: int, scale: float):
    """q (B,S,Hkv,G,dh), k/v (B,S,Hkv,dh) at positions 0..S−1 → o
    (B,S,Hkv,G,dh): one ``ops.flash_attention`` call."""
    b, s, hkv, g, dh = q.shape
    qh = q.reshape(b, s, hkv * g, dh).transpose(1, 2).contiguous()
    o = ops.flash_attention(qh, k.transpose(1, 2).contiguous(),
                            v.transpose(1, 2).contiguous(), scale,
                            causal=causal, window=window)
    return o.transpose(1, 2).reshape(b, s, hkv, g, dh)


def attention(p, cfg: AttnConfig, x, positions, *, causal: bool = True,
              window=_USE_CFG, return_kv: bool = False):
    """Full-sequence self-attention (training forward / prefill), one
    ``ops.flash_attention`` call.  ``positions`` are the rope positions
    ((B,S), or (3,B,S) for mrope): 0..S−1 on every row, which the kernel's
    mask assumes.  ``window`` (an int, 0 or None = full) defaults to
    cfg.sliding_window.  ``return_kv=True`` also returns the post-rope
    (k, v), which prefill turns into the decode cache."""
    if window is _USE_CFG:
        window = cfg.sliding_window
    q, k, v = qkv_project(p, cfg, x)
    q, k = _apply_pos_emb(cfg, q, k, positions)
    o = attend(q, k, v, causal=causal, window=int(window or 0),
               scale=cfg.scale)
    y = out_project(p, cfg, o)
    if return_kv:
        return y, (k, v)
    return y


# --------------------------------------------------------------------- #
# decode with KV cache                                                  #
# --------------------------------------------------------------------- #

def cache_len(cfg: AttnConfig, max_len: int) -> int:
    """Cache length: SWA layers are bounded by the window (ring buffer)."""
    return min(max_len, cfg.sliding_window) if cfg.sliding_window \
        else max_len


def init_kv_cache(cfg: AttnConfig, batch: int, max_len: int, dtype,
                  device=None) -> dict:
    clen = cache_len(cfg, max_len)
    shape = (batch, clen, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((batch, clen), -1, dtype=torch.int32,
                              device=device)}


def decode_step(p, cfg: AttnConfig, x, cache, cur_pos, window=_USE_CFG):
    """One-token decode.  x (B,1,D); cur_pos (B,) absolute position.

    Ring-buffer insert at cur_pos % cache_len, in place in ``cache``; the
    stored absolute positions drive the mask, so SWA and full attention
    share one code path.  Returns (y (B,1,D), cache)."""
    if window is _USE_CFG:
        window = cfg.sliding_window
    q, k_new, v_new = qkv_project(p, cfg, x)
    if cfg.rope_kind == "mrope":
        rope_pos = cur_pos[None, :, None].expand(3, x.shape[0], 1)
    else:
        rope_pos = cur_pos[:, None]
    q, k_new = _apply_pos_emb(cfg, q, k_new, rope_pos)
    k, v, pos = cache["k"], cache["v"], cache["pos"]
    clen = k.shape[1]
    slot = (cur_pos % clen).long()                                 # (B,)
    bidx = torch.arange(x.shape[0], device=x.device)
    k[bidx, slot] = k_new[:, 0].to(k.dtype)
    v[bidx, slot] = v_new[:, 0].to(v.dtype)
    pos[bidx, slot] = cur_pos.to(pos.dtype)
    # scores over the whole ring in f32 (JAX: the cache dtype's products
    # accumulated in f32); invalid slots have pos == −1
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * cfg.scale
    dpos = cur_pos[:, None] - pos                                  # (B,C)
    ok = (pos >= 0) & (dpos >= 0)
    if window is not None and int(window) > 0:
        ok &= dpos < int(window)
    s = s + torch.where(ok, 0.0, NEG_INF)[:, None, None, None, :]
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w.to(x.dtype), v)
    return out_project(p, cfg, o), cache

