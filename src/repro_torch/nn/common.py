"""Shared NN building blocks (functional, parameter trees as nested dicts),
ported from the JAX package's ``repro/nn/common.py``.

Every init draws from a ``torch.Generator`` and returns the parameters
on the generator's device; JAX's distributions are kept (a normal
truncated to ±2 drawn in f32, then cast and scaled), the numbers are
torch's.  With ``gen=None`` an init allocates nothing: its tensors lie on
the ``meta`` device, which gives a tree's shapes and dtypes (``num_params``).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F


def _device(gen) -> torch.device:
    return torch.device("meta") if gen is None else gen.device


def truncated_normal_init(gen, shape, dtype, stddev):
    """A normal truncated to [−2, 2] in f32, cast to ``dtype``, times
    ``stddev`` (in ``dtype``, as JAX multiplies)."""
    t = torch.empty(tuple(shape), dtype=torch.float32, device=_device(gen))
    if gen is not None:
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.to(dtype) * stddev


def normal_init(gen, shape, dtype, stddev):
    """A standard normal drawn in f32, cast to ``dtype``, times ``stddev``
    (``jax.random.normal(key, shape, dtype) * stddev``)."""
    t = torch.empty(tuple(shape), dtype=torch.float32, device=_device(gen))
    if gen is not None:
        t.normal_(generator=gen)
    return t.to(dtype) * stddev


def dense_init(gen, in_dim: int, out_dim: int, dtype,
               stddev: float | None = None, bias: bool = False) -> dict:
    """Weight (in, out) + optional bias (out,)."""
    stddev = stddev if stddev is not None else in_dim ** -0.5
    params = {"w": truncated_normal_init(gen, (in_dim, out_dim), dtype,
                                         stddev)}
    if bias:
        params["b"] = torch.zeros(out_dim, dtype=dtype, device=_device(gen))
    return params


def dense_apply(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# --------------------------------------------------------------------- #
# norms                                                                 #
# --------------------------------------------------------------------- #

def norm_init(dim: int, dtype, kind: str = "rmsnorm", device=None) -> dict:
    if kind == "rmsnorm":
        return {"scale": torch.ones(dim, dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones(dim, dtype=dtype, device=device),
                "bias": torch.zeros(dim, dtype=dtype, device=device)}
    raise ValueError(kind)


def norm_apply(p, x, eps: float = 1e-6):
    """rmsnorm, or layernorm where ``p`` has a bias, computed in f32 and
    returned in x's dtype."""
    xf = x.float()
    if "bias" in p:
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)
    var = (xf ** 2).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def rms_head_norm(scale, x, eps: float = 1e-6):
    """Per-head qk-norm (Qwen3): normalise the last (head_dim) axis."""
    xf = x.float()
    y = xf * torch.rsqrt((xf ** 2).mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


# --------------------------------------------------------------------- #
# embedding                                                             #
# --------------------------------------------------------------------- #

def embed_init(gen, vocab: int, dim: int, dtype) -> dict:
    return {"embedding": truncated_normal_init(gen, (vocab, dim), dtype,
                                               1.0)}


def embed_apply(p, tokens):
    return p["embedding"][tokens.long()]


def embed_attend(p, x):
    """Tied readout: logits = x @ Eᵀ."""
    return x @ p["embedding"].T


# --------------------------------------------------------------------- #
# misc                                                                  #
# --------------------------------------------------------------------- #

def sinusoidal_positions(seq: int, dim: int, dtype=torch.float32,
                         device=None):
    pos = np.arange(seq)[:, None]
    i = np.arange(dim // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / dim)
    out = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
    return torch.as_tensor(out, dtype=dtype, device=device)


def squared_relu(x):
    r = torch.relu(x)
    return r * r


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


FFN_ACTS: dict[str, Callable] = {
    "silu": F.silu,
    "gelu": _gelu_tanh,         # jax.nn.gelu(approximate=True)
    "relu2": squared_relu,
    "relu": torch.relu,
}

