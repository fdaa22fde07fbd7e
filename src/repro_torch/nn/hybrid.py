"""Hymba's hybrid block, ported from the JAX package's ``repro/nn/hybrid.py``:
attention heads and SSM (Mamba2) heads run in parallel on the same input
and their outputs are fused (arXiv 2411.13676 §2.1):

    y = β_attn · norm(attn_path(x)) + β_ssm · norm(ssm_path(x))

each path's output RMS-normalised, β learned per path.  The attention
sub-path is the port's ``nn.attention`` (its full-sequence forward one
flash-attention launch), the SSM sub-path ``nn.ssm`` (chunked SSD, plain
PyTorch); both caches live side by side in the layer cache.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.nn import attention as attn_lib
from repro_torch.nn import ssm as ssm_lib
from repro_torch.nn.attention import AttnConfig
from repro_torch.nn.common import _device, rms_head_norm
from repro_torch.nn.ssm import SSMConfig


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    attn: AttnConfig
    ssm: SSMConfig

    @property
    def d_model(self) -> int:
        return self.attn.d_model


def hybrid_init(gen, cfg: HybridConfig, dtype) -> dict:
    dev = _device(gen)
    return {"attn": attn_lib.attn_init(gen, cfg.attn, dtype),
            "ssm": ssm_lib.ssm_init(gen, cfg.ssm, dtype),
            "attn_out_norm": torch.ones(cfg.d_model, dtype=dtype, device=dev),
            "ssm_out_norm": torch.ones(cfg.d_model, dtype=dtype, device=dev),
            "beta": torch.ones(2, dtype=torch.float32, device=dev)}


def fuse(p, ya, ys):
    """β_attn · norm(ya) + β_ssm · norm(ys) in f32, in ya's dtype; each
    norm JAX's ``_headnorm``, an RMS norm over the last axis in f32 (the
    same function as qk-norm's, ``rms_head_norm``)."""
    beta = p["beta"].float()
    out = beta[0] * rms_head_norm(p["attn_out_norm"], ya).float() \
        + beta[1] * rms_head_norm(p["ssm_out_norm"], ys).float()
    return out.to(ya.dtype)


def hybrid_apply(p, cfg: HybridConfig, x, positions, *,
                 window=attn_lib._USE_CFG, return_cache: bool = False):
    """Full-sequence mixer.  x (B,S,D) → (B,S,D).  ``return_cache=True``
    (prefill) also returns the attention's post-rope (k, v) and the SSM's
    decode cache."""
    ya = attn_lib.attention(p["attn"], cfg.attn, x, positions, window=window,
                            return_kv=return_cache)
    ys = ssm_lib.ssm_apply(p["ssm"], cfg.ssm, x, return_cache=return_cache)
    if not return_cache:
        return fuse(p, ya, ys)
    (ya, kv), (ys, ssm_cache) = ya, ys
    return fuse(p, ya, ys), kv, ssm_cache


def init_hybrid_cache(cfg: HybridConfig, batch: int, max_len: int, dtype,
                      device=None) -> dict:
    return {"attn": attn_lib.init_kv_cache(cfg.attn, batch, max_len, dtype,
                                           device),
            "ssm": ssm_lib.init_ssm_cache(cfg.ssm, batch, dtype, device)}


def hybrid_decode_step(p, cfg: HybridConfig, x, cache, cur_pos,
                       window=attn_lib._USE_CFG):
    """One-token decode through both paths.  x (B,1,D); both caches
    updated in place."""
    ya, _ = attn_lib.decode_step(p["attn"], cfg.attn, x, cache["attn"],
                                 cur_pos, window=window)
    ys, _ = ssm_lib.ssm_decode_step(p["ssm"], cfg.ssm, x, cache["ssm"])
    return fuse(p, ya, ys), cache
