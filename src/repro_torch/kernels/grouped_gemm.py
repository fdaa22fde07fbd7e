"""Grouped GEMM over tokens sorted by expert — the MoE expert projection.

``moe_gemm_cuda`` launches ``csrc/moe_gemm.cu`` (entries ``moe_gemm_f32``
and ``moe_gemm_bf16``, the port of the TPU kernel
``repro/kernels/moe_gemm.py::moe_gemm``): x (T, D) and w (E, D, F) of one
dtype, f32 or bf16, and one int32 expert id per run of ``block_t`` rows
→ y (T, F) in x's dtype, ``y[t] = x[t] · w[e(t)]``, summed in f32.
``kernel_path`` names the design a launch takes, by shape: bf16 with D and F
multiples of 8 and ``block_t`` a multiple of 64 runs on the tensor cores
(``"wgmma"``: TMA-fed tiles, f32 accumulators), everything else, f32
included, on the FMA units (``"fma"``).  The C entry applies the same rule.
``fma_instance`` names the FMA kernel's instance: a register-tiled SIMT
GEMM over 128- or 64-row tiles where ``block_t`` allows, with 16-byte
loads (``"vec4"``) or element by element (``"scalar"``), else an 8-row
tiling.

``moe_gemm_dense`` is the same function in plain PyTorch, the port of the
JAX package's oracle ``repro/kernels/ref.py::moe_gemm_ref`` with
``expand_block_ids``.  The oracle gathers a (T, D, F) weight per row; the
plain version gathers one (D, F) weight per run of ``block_t`` rows and
takes one f32 batched product — the same sums, at a size the card holds at
full width.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

# kernel launches (the CPU dispatch in ops counts its plain calls too)
launches = 0
DTYPES = {torch.float32: "moe_gemm_f32", torch.bfloat16: "moe_gemm_bf16"}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def kernel_path(dtype, d: int, f: int, block_t: int) -> str:
    """The design ``moe_gemm_cuda`` launches for x (T, ``d``), w (E, ``d``,
    ``f``) of ``dtype`` in runs of ``block_t`` rows: ``"wgmma"`` (the tensor
    cores: TMA needs 16-byte row strides, wgmma 64-row tiles inside one
    expert's run) or ``"fma"``."""
    if dtype not in DTYPES:
        raise TypeError(f"moe_gemm takes float32 or bfloat16, not {dtype}")
    if dtype == torch.bfloat16 and d % 8 == 0 and f % 8 == 0 \
            and block_t % 64 == 0:
        return "wgmma"
    return "fma"


def fma_instance(d: int, f: int, block_t: int, *tensors) -> tuple[int, str]:
    """The instance of the FMA kernel a ``"fma"`` launch takes, as (tile
    rows, ``"vec4"`` or ``"scalar"``), by the rule of ``csrc/moe_gemm.cu``:
    the SIMT GEMM (``moe_gemm_simt_kernel``) over 128-row tiles where
    ``block_t`` is a multiple of 128, else over 64-row ones where it is a
    multiple of 64, with 16-byte loads where ``d`` and ``f`` are multiples
    of 4 and every tensor given (x, w, y) starts on a 16-byte boundary;
    else the 8-row tiling (``moe_gemm_kernel``), element by element."""
    if block_t % 64:
        return 8, "scalar"
    vec = d % 4 == 0 and f % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in tensors)
    return 128 if block_t % 128 == 0 else 64, "vec4" if vec else "scalar"


def expand_block_ids(block_ids, block: int) -> np.ndarray:
    """Per-block id array → per-unit id array."""
    return np.repeat(np.asarray(block_ids), block)


def moe_gemm_dense(x, w, block_expert_ids, *, block_t: int):
    """y[t] = x[t] · w[e(t)] in f32 → (T, F) in x's dtype."""
    t, d = x.shape
    ids = block_expert_ids.long()
    xb = x.float().reshape(t // block_t, block_t, d)
    return torch.bmm(xb, w[ids].float()).reshape(t, -1).to(x.dtype)


def check_shapes(x, w, ids, block_t: int):
    """Raise unless x (T, D), w (E, D, F) and ids (T / block_t,) fit and x
    and w share one dtype, f32 or bf16."""
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)}: "
                         "expected (T, D) and (E, D, F)")
    if x.shape[0] % block_t:
        raise ValueError(f"token axis {x.shape[0]} not {block_t}-aligned")
    if tuple(ids.shape) != (x.shape[0] // block_t,):
        raise ValueError(f"{tuple(ids.shape)} expert ids for "
                         f"{x.shape[0] // block_t} runs of {block_t} rows")
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise TypeError(f"x and w are {x.dtype}, {w.dtype}; the kernel "
                        "takes one dtype, float32 or bfloat16")


def moe_gemm_cuda(x, w, block_expert_ids, *, block_t: int):
    """One launch → y (T, F) in x's dtype."""
    global launches
    check_shapes(x, w, block_expert_ids, block_t)
    _build.check_tensors("moe_gemm", x, ("x", x, x.dtype), ("w", w, x.dtype),
                         ("block_expert_ids", block_expert_ids, torch.int32))
    if block_t % 8:
        raise ValueError(f"moe_gemm: block_t {block_t} is not a multiple of "
                         "8 (the kernel's row tiles)")
    t, d = x.shape
    e, _, f = w.shape
    if kernel_path(x.dtype, d, f, block_t) == "wgmma" and \
            (x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError("moe_gemm: x and w must start 16-byte aligned "
                         "(the tensor-core path loads them by TMA)")
    fn = _build.function("moe_gemm", DTYPES[x.dtype],
                         [_P] * 4 + [_L] + [_I] * 4 + [_P])
    y = torch.empty(t, f, device=x.device, dtype=x.dtype)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w.data_ptr(), block_expert_ids.data_ptr(),
                y.data_ptr(), t, d, f, e, block_t,
                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "moe_gemm")
    launches += 1
    return y
