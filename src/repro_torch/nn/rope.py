"""Rotary position embeddings: standard RoPE and Qwen2-VL's M-RoPE, ported
from the JAX package's ``repro/nn/rope.py``.

M-RoPE splits the head_dim/2 frequency bands into (temporal, height,
width) sections; each section rotates by its own position stream.  For
pure text the three streams coincide and M-RoPE == RoPE.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                            / head_dim))


def _rotate(x, cos, sin):
    # x (..., d); the pairs are the two halves
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# the tables are made on the device once per (shape, device): a copy from
# host memory per call would make the host wait for the device at every
# layer

@functools.lru_cache(maxsize=None)
def _freqs(head_dim: int, theta: float, device: str) -> torch.Tensor:
    """The (d/2,) f32 frequencies on ``device``."""
    with torch.inference_mode(False):
        return torch.as_tensor(rope_frequencies(head_dim, theta),
                               dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=None)
def _section_ids(sections: tuple, device: str) -> torch.Tensor:
    """M-RoPE's (d/2,) band → position-stream ids on ``device``."""
    with torch.inference_mode(False):
        return torch.as_tensor(np.repeat(np.arange(3), sections),
                               device=device)


def apply_rope(q, k, positions, head_dim: int, theta: float = 1e4):
    """q (B,S,Hq,d), k (B,S,Hk,d), positions (B,S) int."""
    ang = positions.float()[..., None] * _freqs(head_dim, float(theta),
                                                 str(q.device))
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    return (_rotate(q.float(), cos, sin).to(q.dtype),
            _rotate(k.float(), cos, sin).to(k.dtype))


def apply_mrope(q, k, positions3, head_dim: int, theta: float = 1e6,
                sections=(16, 24, 24)):
    """Qwen2-VL M-RoPE.  positions3 (3,B,S): temporal/height/width streams.

    ``sections`` partitions the d/2 frequency bands; section j's bands take
    their rotation angle from position stream j."""
    assert sum(sections) == head_dim // 2, (sections, head_dim)
    freqs = _freqs(head_dim, float(theta), str(q.device))
    ang_streams = positions3.float()[..., None] * freqs        # (3,B,S,d/2)
    sec_id = _section_ids(tuple(sections), str(q.device))     # (d/2,)
    ang = torch.gather(ang_streams.movedim(0, -1), -1,
                       sec_id.expand(*ang_streams.shape[1:-1], -1)[..., None]
                       )[..., 0]                              # (B,S,d/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    return (_rotate(q.float(), cos, sin).to(q.dtype),
            _rotate(k.float(), cos, sin).to(k.dtype))
