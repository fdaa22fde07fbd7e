"""Fused block-diagonal mid layer: ragged block-diagonal GEMM + gated bias
+ per-tile activation + padding mask, forward and backward.

Forward (serving, and training with the activation derivative):
``fused_layer_cuda`` / ``fused_layer_train_cuda`` launch the CUDA kernel
``csrc/fused_layer.cu`` (the port of the TPU kernel
``repro/kernels/fused_layer.py::fused_layer_fwd``, ``with_deriv`` False /
True).  Both take x (B, n_in_tiles·blk), the identity-augmented tile array
wb (n_param_blocks + 1, blk, blk), b_eff and mask (n_out_tiles·blk,) f32,
one activation id per output tile (int32) and the layout's steps in CSR
form (``csr_schedule``), and return (B, n_out_tiles·blk) f32 — the training
variant also g' of the same shape.

Int8 serving: ``fused_layer_int8_cuda`` launches the same kernel over the
int8 serve copy (entry ``fused_layer_infer_i8``; the port of
``fused_layer.py::fused_layer_int8_fwd``): the packer's identity-augmented
int8 tile array and one f32 scale per tile, 1.0 for the identity.

Backward: ``fused_layer_dx_dw_cuda`` launches ``csrc/fused_layer_dx_dw.cu``
(the port of ``fused_layer.py::fused_layer_dx_dw``): from dy and g', x, the
per-member-transposed tiles (``transposed_tiles``) and the transposed
steps (``csr_schedule(layout, transposed=True)``) it returns dx and dWB.

Each ``*_plain`` function is the same function in plain PyTorch.

The TPU kernels walk the flat ``BlockDiagLayout`` steps in order on a
sequential grid axis.  Each output tile's steps are consecutive there, so
the port turns them into CSR rows once per layout: ``rowptr[o]`` ..
``rowptr[o + 1]`` are output tile o's steps, which one CTA walks privately.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.activations import (apply_activation_derivs_masked,
                                          apply_activations_masked)
from repro_torch.kernels import _build
from repro_torch.kernels.block_diag import (block_diag_dw_plain,
                                            block_diag_fwd_plain)

# kernel launches (the CPU dispatch in ops counts its plain calls too):
launches = 0          # the forward, with or without g'
int8_launches = 0     # the forward over int8 tiles
dx_dw_launches = 0    # the backward
MAX_BLOCK = 128       # widest tile the kernel keeps in shared memory

_P, _I = ctypes.c_void_p, ctypes.c_int


def csr_schedule(layout, transposed: bool = False
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``BlockDiagLayout`` steps → (rowptr (n_rows + 1,), s_in, s_w) int32,
    one CSR row per output tile (``transposed``: per input tile, over the
    backward's transposed steps).  Raises if a row's steps are not
    consecutive."""
    if transposed:
        s_out, s_in, s_w = layout.s_out_t, layout.s_in_t, layout.s_w_t
        n_rows = layout.n_in_tiles
    else:
        s_out, s_in, s_w = layout.s_out, layout.s_in, layout.s_w
        n_rows = layout.n_out_tiles
    s_out = np.asarray(s_out, np.int64)
    if s_out.size and np.any(np.diff(s_out) < 0):
        raise ValueError("fused_layer: layout steps are not grouped by "
                         "output tile")
    counts = np.bincount(s_out, minlength=n_rows)
    rowptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return (rowptr, np.asarray(s_in, np.int32), np.asarray(s_w, np.int32))


def schedule_on(layout, device, transposed: bool = False
                ) -> tuple[torch.Tensor, ...]:
    """``csr_schedule`` as int32 tensors on ``device``, built once per
    (layout, device, direction) and kept on the layout instance.  The
    transposed schedule also carries ``perm_t``, ``wb_out_tile`` and
    ``wb_in_tile``."""
    cache = layout.__dict__.setdefault("_csr_cache", {})
    key = (str(torch.device(device)), transposed)
    if key not in cache:
        arrs = csr_schedule(layout, transposed)
        if transposed:
            arrs += tuple(np.asarray(a, np.int32) for a in (
                layout.perm_t, layout.wb_out_tile, layout.wb_in_tile))
        cache[key] = tuple(torch.from_numpy(np.ascontiguousarray(a))
                           .to(device) for a in arrs)
    return cache[key]


def transposed_tiles(wb_aug: torch.Tensor, perm_t: torch.Tensor
                     ) -> torch.Tensor:
    """The backward's weight tiles, as the JAX package builds them
    (``ops._bd_transposed_tiles``): the identity-augmented tile array
    permuted into transposed step order, each tile transposed."""
    return wb_aug[perm_t.long()].transpose(1, 2).contiguous()


def fused_layer_plain(x, wb, b_eff, mask, tile_act, rowptr, s_in, s_w, *,
                      blk: int):
    z = block_diag_fwd_plain(x, wb, rowptr, s_in, s_w, blk=blk) + b_eff
    return apply_activations_masked(z, tile_act.repeat_interleave(blk)) * mask


def fused_layer_int8_plain(x, wb_q, wb_scale, b_eff, mask, tile_act, rowptr,
                           s_in, s_w, *, blk: int):
    """Dequantize every tile (q·s), then ``fused_layer_plain``."""
    wb = wb_q.to(torch.float32) * wb_scale[:, None, None]
    return fused_layer_plain(x, wb, b_eff, mask, tile_act, rowptr, s_in, s_w,
                             blk=blk)


def fused_layer_train_plain(x, wb, b_eff, mask, tile_act, rowptr, s_in, s_w,
                            *, blk: int):
    """→ (y, g'), both (B, n_out_tiles·blk)."""
    z = block_diag_fwd_plain(x, wb, rowptr, s_in, s_w, blk=blk) + b_eff
    cols = tile_act.repeat_interleave(blk)
    return (apply_activations_masked(z, cols) * mask,
            apply_activation_derivs_masked(z, cols) * mask)


def fused_layer_dx_dw_plain(dy, g, x, wb_t, rowptr_t, s_in_t, s_w_t,
                            wb_out_tile, wb_in_tile, *, blk: int):
    """→ (dx (B, n_in_tiles·blk), dWB (n_param_blocks, blk, blk)),
    du = dy·g'."""
    du = dy * g
    dx = block_diag_fwd_plain(du, wb_t, rowptr_t, s_in_t, s_w_t, blk=blk)
    return dx, block_diag_dw_plain(du, x, wb_out_tile, wb_in_tile, blk=blk)


def _fwd_args(x, wb, b_eff, mask, tile_act, rowptr, s_in, s_w, blk,
              w_dtype=torch.float32):
    n_out = rowptr.shape[0] - 1
    _build.check_tensors(
        "fused_layer", x,
        ("x", x, torch.float32),
        ("wb", wb, w_dtype),
        ("b_eff", b_eff, torch.float32),
        ("mask", mask, torch.float32),
        ("tile_act", tile_act, torch.int32),
        ("rowptr", rowptr, torch.int32),
        ("s_in", s_in, torch.int32),
        ("s_w", s_w, torch.int32))
    _check_block(blk)
    if x.shape[1] % blk or wb.shape[1:] != (blk, blk) \
            or b_eff.shape != (n_out * blk,) or mask.shape != (n_out * blk,) \
            or tile_act.shape != (n_out,) or s_in.shape != s_w.shape:
        raise ValueError("fused_layer: inconsistent shapes")
    return x.shape[0], n_out


def _check_block(blk: int):
    if not 1 <= blk <= MAX_BLOCK:
        raise ValueError(f"fused_layer: block {blk} outside the kernel's "
                         f"[1, {MAX_BLOCK}]")


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def fused_layer_cuda(x, wb, b_eff, mask, tile_act, rowptr, s_in, s_w, *,
                     blk: int):
    global launches
    b, n_out = _fwd_args(x, wb, b_eff, mask, tile_act, rowptr, s_in, s_w,
                         blk)
    fn = _build.function("fused_layer", "fused_layer_infer_f32",
                         [_P] * 9 + [_I] * 4 + [_P])
    y = torch.empty(b, n_out * blk, device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        rc = fn(*_ptrs(x, wb, b_eff, mask, tile_act, rowptr, s_in, s_w, y),
                b, x.shape[1] // blk, n_out, blk,
                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "fused_layer")
    launches += 1
    return y


def fused_layer_train_cuda(x, wb, b_eff, mask, tile_act, rowptr, s_in, s_w,
                           *, blk: int):
    """The training forward: one launch → (y, g')."""
    global launches
    b, n_out = _fwd_args(x, wb, b_eff, mask, tile_act, rowptr, s_in, s_w,
                         blk)
    fn = _build.function("fused_layer", "fused_layer_train_f32",
                         [_P] * 10 + [_I] * 4 + [_P])
    y = torch.empty(b, n_out * blk, device=x.device, dtype=torch.float32)
    g = torch.empty_like(y)
    with torch.cuda.device(x.device):
        rc = fn(*_ptrs(x, wb, b_eff, mask, tile_act, rowptr, s_in, s_w, y, g),
                b, x.shape[1] // blk, n_out, blk,
                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "fused_layer_train")
    launches += 1
    return y, g


def fused_layer_int8_cuda(x, wb_q, wb_scale, b_eff, mask, tile_act, rowptr,
                          s_in, s_w, *, blk: int):
    """One launch → y (B, n_out_tiles·blk) over int8 tiles."""
    global int8_launches
    b, n_out = _fwd_args(x, wb_q, b_eff, mask, tile_act, rowptr, s_in, s_w,
                         blk, w_dtype=torch.int8)
    _build.check_tensors("fused_layer_int8", x,
                         ("wb_scale", wb_scale, torch.float32))
    if wb_scale.shape != (wb_q.shape[0],):
        raise ValueError("fused_layer_int8: one scale per tile")
    fn = _build.function("fused_layer", "fused_layer_infer_i8",
                         [_P] * 10 + [_I] * 4 + [_P])
    y = torch.empty(b, n_out * blk, device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        rc = fn(*_ptrs(x, wb_q, wb_scale, b_eff, mask, tile_act, rowptr,
                       s_in, s_w, y),
                b, x.shape[1] // blk, n_out, blk,
                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "fused_layer_int8")
    int8_launches += 1
    return y


def fused_layer_dx_dw_cuda(dy, g, x, wb_t, rowptr_t, s_in_t, s_w_t,
                           wb_out_tile, wb_in_tile, *, blk: int):
    """One launch → (dx (B, n_in_tiles·blk), dWB (n_param, blk, blk))."""
    global dx_dw_launches
    b = dy.shape[0]
    n_in = rowptr_t.shape[0] - 1
    n_param = wb_out_tile.shape[0]
    _build.check_tensors(
        "fused_layer_dx_dw", dy,
        ("dy", dy, torch.float32),
        ("g", g, torch.float32),
        ("x", x, torch.float32),
        ("wb_t", wb_t, torch.float32),
        ("rowptr_t", rowptr_t, torch.int32),
        ("s_in_t", s_in_t, torch.int32),
        ("s_w_t", s_w_t, torch.int32),
        ("wb_out_tile", wb_out_tile, torch.int32),
        ("wb_in_tile", wb_in_tile, torch.int32))
    _check_block(blk)
    if g.shape != dy.shape or dy.shape[1] % blk or x.shape != (b, n_in * blk) \
            or wb_t.shape != (n_param + 1, blk, blk) \
            or s_in_t.shape != s_w_t.shape \
            or wb_in_tile.shape != (n_param,):
        raise ValueError("fused_layer_dx_dw: inconsistent shapes")
    fn = _build.function("fused_layer_dx_dw", "fused_layer_dx_dw_f32",
                         [_P] * 11 + [_I] * 5 + [_P])
    dx = torch.empty(b, n_in * blk, device=dy.device, dtype=torch.float32)
    dwb = torch.empty(n_param, blk, blk, device=dy.device,
                      dtype=torch.float32)
    with torch.cuda.device(dy.device):
        rc = fn(*_ptrs(dy, g, x, wb_t, rowptr_t, s_in_t, s_w_t, wb_out_tile,
                       wb_in_tile, dx, dwb),
                b, n_in, dy.shape[1] // blk, n_param, blk,
                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "fused_layer_dx_dw")
    dx_dw_launches += 1
    return dx, dwb
