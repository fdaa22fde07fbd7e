"""Ragged block-diagonal GEMM — the unfused mid-layer projection — forward
and weight gradient.

``block_diag_fwd_cuda`` launches ``csrc/block_diag.cu`` (entry
``block_diag_fwd_f32``, the port of the TPU kernel
``repro/kernels/block_diag.py::block_diag_fwd``): x (B, n_in_tiles·blk),
the identity-augmented tile array wb (n_param_blocks + 1, blk, blk) and a
layout's steps in CSR form (``fused_layer.csr_schedule``) → (B,
n_rows·blk) f32.  Fed dy, the per-member-transposed tiles
(``fused_layer.transposed_tiles``) and the transposed steps, the same
kernel is the backward's dh, as in the JAX package.

``block_diag_dw_cuda`` (entry ``block_diag_dw_f32``, the port of
``block_diag.py::block_diag_dw``): dy (B, n_out_tiles·blk), x and each
parameter tile's output and input tile → dWB (n_param_blocks, blk, blk).

Each ``*_plain`` function is the same function in plain PyTorch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# kernel launches (the CPU dispatch in ops counts its plain calls too):
fwd_launches = 0      # the forward, and the backward's dh
dw_launches = 0       # the weight gradient
MAX_BLOCK = 128       # widest tile the kernels keep in shared memory

_P, _I = ctypes.c_void_p, ctypes.c_int


def block_diag_fwd_plain(x, wb, rowptr, s_in, s_w, *, blk: int):
    """Σ over each CSR row's steps of x[:, s_in]·wb[s_w]ᵀ → (B, rows·blk)
    in x's dtype; products and sums in f32 (f64 for f64 inputs), as JAX's
    kernel accumulates."""
    b = x.shape[0]
    acc = torch.promote_types(x.dtype, torch.float32)
    n_rows = rowptr.shape[0] - 1
    s_out = torch.repeat_interleave(
        torch.arange(n_rows, device=x.device),
        (rowptr[1:] - rowptr[:-1]).long())
    xt = x.to(acc).reshape(b, -1, blk)[:, s_in.long()]         # (B, S, blk)
    prod = torch.einsum("bsk,srk->bsr", xt,
                        wb[s_w.long()].to(acc))                # (B, S, blk)
    z = torch.zeros(b, n_rows, blk, device=x.device, dtype=acc)
    z.index_add_(1, s_out, prod)
    return z.reshape(b, n_rows * blk).to(x.dtype)


def block_diag_dw_plain(dy, x, wb_out_tile, wb_in_tile, *, blk: int):
    """dWB[q] = Σ_b dy[:, wb_out_tile[q]]ᵀ · x[:, wb_in_tile[q]]."""
    b = dy.shape[0]
    return torch.einsum("bqr,bqc->qrc",
                        dy.reshape(b, -1, blk)[:, wb_out_tile.long()],
                        x.reshape(b, -1, blk)[:, wb_in_tile.long()])


def _check_block(where: str, blk: int):
    if not 1 <= blk <= MAX_BLOCK:
        raise ValueError(f"{where}: block {blk} outside the kernel's "
                         f"[1, {MAX_BLOCK}]")


def block_diag_fwd_cuda(x, wb, rowptr, s_in, s_w, *, blk: int):
    """One launch → (B, n_rows·blk), n_rows = len(rowptr) − 1."""
    global fwd_launches
    _build.check_tensors(
        "block_diag_fwd", x,
        ("x", x, torch.float32),
        ("wb", wb, torch.float32),
        ("rowptr", rowptr, torch.int32),
        ("s_in", s_in, torch.int32),
        ("s_w", s_w, torch.int32))
    _check_block("block_diag_fwd", blk)
    if x.dim() != 2 or x.shape[1] % blk or wb.shape[1:] != (blk, blk) \
            or s_in.shape != s_w.shape:
        raise ValueError("block_diag_fwd: inconsistent shapes")
    b, n_rows = x.shape[0], rowptr.shape[0] - 1
    fn = _build.function("block_diag", "block_diag_fwd_f32",
                         [_P] * 6 + [_I] * 4 + [_P])
    y = torch.empty(b, n_rows * blk, device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), wb.data_ptr(), rowptr.data_ptr(),
                s_in.data_ptr(), s_w.data_ptr(), y.data_ptr(),
                b, x.shape[1] // blk, n_rows, blk,
                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "block_diag_fwd")
    fwd_launches += 1
    return y


def block_diag_dw_cuda(dy, x, wb_out_tile, wb_in_tile, *, blk: int):
    """One launch → dWB (n_param, blk, blk), n_param = len(wb_out_tile)."""
    global dw_launches
    _build.check_tensors(
        "block_diag_dw", dy,
        ("dy", dy, torch.float32),
        ("x", x, torch.float32),
        ("wb_out_tile", wb_out_tile, torch.int32),
        ("wb_in_tile", wb_in_tile, torch.int32))
    _check_block("block_diag_dw", blk)
    n_param = wb_out_tile.shape[0]
    if dy.dim() != 2 or x.dim() != 2 or dy.shape[0] != x.shape[0] \
            or dy.shape[1] % blk or x.shape[1] % blk \
            or wb_in_tile.shape != (n_param,):
        raise ValueError("block_diag_dw: inconsistent shapes")
    fn = _build.function("block_diag", "block_diag_dw_f32",
                         [_P] * 5 + [_I] * 5 + [_P])
    dwb = torch.empty(n_param, blk, blk, device=dy.device,
                      dtype=torch.float32)
    with torch.cuda.device(dy.device):
        rc = fn(dy.data_ptr(), x.data_ptr(), wb_out_tile.data_ptr(),
                wb_in_tile.data_ptr(), dwb.data_ptr(), dy.shape[0],
                dy.shape[1] // blk, x.shape[1] // blk, n_param, blk,
                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "block_diag_dw")
    dw_launches += 1
    return dwb
