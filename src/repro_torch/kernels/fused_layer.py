"""Fused block-diagonal mid layer, forward only: ragged block-diagonal GEMM
+ gated bias + per-tile activation + padding mask.

``fused_layer_cuda`` launches the CUDA kernel ``csrc/fused_layer.cu`` (the
port of the TPU kernel ``repro/kernels/fused_layer.py::fused_layer_fwd``
with ``with_deriv=False``); ``fused_layer_plain`` is the same function in
plain PyTorch.  Both take x (B, n_in_tiles·blk), the identity-augmented
tile array wb (n_param_blocks + 1, blk, blk), b_eff and mask
(n_out_tiles·blk,) f32, one activation id per output tile (int32) and the
layout's steps in CSR form (``csr_schedule``), and return
(B, n_out_tiles·blk) f32.

The TPU kernel walks the flat ``BlockDiagLayout`` steps in order on a
sequential grid axis.  Each output tile's steps are consecutive there, so
the port turns them into CSR rows once per layout: ``rowptr[o]`` ..
``rowptr[o + 1]`` are output tile o's steps, which one CTA walks privately.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.activations import apply_activations_masked
from repro_torch.kernels import _build

launches = 0          # kernel launches (the CPU dispatch in ops counts too)
MAX_BLOCK = 128       # widest tile the kernel keeps in shared memory

_P, _I = ctypes.c_void_p, ctypes.c_int


def csr_schedule(layout) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``BlockDiagLayout`` steps → (rowptr (n_out_tiles + 1,), s_in, s_w)
    int32.  Raises if an output tile's steps are not consecutive."""
    s_out = np.asarray(layout.s_out, np.int64)
    if s_out.size and np.any(np.diff(s_out) < 0):
        raise ValueError("fused_layer: layout steps are not grouped by "
                         "output tile")
    counts = np.bincount(s_out, minlength=layout.n_out_tiles)
    rowptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return (rowptr, np.asarray(layout.s_in, np.int32),
            np.asarray(layout.s_w, np.int32))


def schedule_on(layout, device) -> tuple[torch.Tensor, ...]:
    """``csr_schedule`` as int32 tensors on ``device``, built once per
    (layout, device) and kept on the layout instance."""
    cache = layout.__dict__.setdefault("_csr_cache", {})
    key = str(torch.device(device))
    if key not in cache:
        cache[key] = tuple(torch.from_numpy(a).to(device)
                           for a in csr_schedule(layout))
    return cache[key]


def fused_layer_plain(x, wb, b_eff, mask, tile_act, rowptr, s_in, s_w, *,
                      blk: int):
    b = x.shape[0]
    n_out = rowptr.shape[0] - 1
    s_out = torch.repeat_interleave(
        torch.arange(n_out, device=x.device),
        (rowptr[1:] - rowptr[:-1]).long())
    xt = x.reshape(b, -1, blk)[:, s_in.long()]                 # (B, S, blk)
    prod = torch.einsum("bsk,srk->bsr", xt, wb[s_w.long()])    # (B, S, blk)
    z = torch.zeros(b, n_out, blk, device=x.device, dtype=torch.float32)
    z.index_add_(1, s_out, prod)
    z = z.reshape(b, n_out * blk) + b_eff
    return apply_activations_masked(z, tile_act.repeat_interleave(blk)) * mask


def _lib():
    lib = _build.library("fused_layer")
    fn = lib.fused_layer_infer_f32
    fn.argtypes = [_P] * 9 + [_I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def fused_layer_cuda(x, wb, b_eff, mask, tile_act, rowptr, s_in, s_w, *,
                     blk: int):
    global launches
    b = x.shape[0]
    n_out = rowptr.shape[0] - 1
    for name, t, dt in (("x", x, torch.float32), ("wb", wb, torch.float32),
                        ("b_eff", b_eff, torch.float32),
                        ("mask", mask, torch.float32),
                        ("tile_act", tile_act, torch.int32),
                        ("rowptr", rowptr, torch.int32),
                        ("s_in", s_in, torch.int32),
                        ("s_w", s_w, torch.int32)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"fused_layer: {name} must be on {x.device}")
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"fused_layer: {name} must be contiguous {dt}, "
                             f"got {t.dtype}")
    if not 1 <= blk <= MAX_BLOCK:
        raise ValueError(f"fused_layer: block {blk} outside the kernel's "
                         f"[1, {MAX_BLOCK}]")
    if x.shape[1] % blk or wb.shape[1:] != (blk, blk) \
            or b_eff.shape != (n_out * blk,) or mask.shape != (n_out * blk,) \
            or tile_act.shape != (n_out,) or s_in.shape != s_w.shape:
        raise ValueError("fused_layer: inconsistent shapes")
    fn = _lib()
    y = torch.empty(b, n_out * blk, device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), wb.data_ptr(), b_eff.data_ptr(),
                mask.data_ptr(), tile_act.data_ptr(), rowptr.data_ptr(),
                s_in.data_ptr(), s_w.data_ptr(), y.data_ptr(), b,
                x.shape[1] // blk, n_out, blk,
                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "fused_layer")
    launches += 1
    return y
