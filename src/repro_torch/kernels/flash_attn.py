"""Flash attention, forward — masked online-softmax attention with grouped
query heads.

``flash_attention_cuda`` launches ``csrc/flash_attn.cu`` (entries
``flash_attn_fwd_f32`` and ``flash_attn_fwd_bf16``, the port of the TPU
kernel ``repro/kernels/flash_attn.py::flash_attention_fwd``): q (B, H, Sq,
dh), k and v (B, Hkv, Sk, dh) of one dtype, f32 or bf16, H a multiple of
Hkv → o (B, H, Sq, dh) in q's dtype.  Query head h reads kv head
h // (H / Hkv); kv is never repeated in memory.  ``kernel_path`` names the
design a launch takes: bf16 runs on the tensor cores (``"wgmma"``: TMA-fed
K/V tiles, p rounded to bf16 in registers as the A operand of the PV
product), f32 on the FMA units (``"fma"``).

``flash_attn_dense`` is the same function in plain PyTorch, the port of
the JAX package's oracle ``repro/kernels/ref.py::flash_attn_ref``: the
dense (Sq, Sk) scores in f32, masked with −1e30, a softmax over all Sk
columns.  It is the kernel's plain version and also the function the
backward differentiates (``ops.flash_attention``), as JAX's custom VJP
recomputes through the oracle.  One difference from the TPU kernel, none
from the oracle: columns at or beyond Sk never count, so a fully masked row
is the mean of v over Sk (the TPU kernel counts its zero kv padding there).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# kernel launches (the CPU dispatch in ops counts its plain calls too)
launches = 0
MAX_DH = 128          # widest head the kernel takes (a multiple of 8)
NEG_INF = -1e30       # the score of a masked (q, k) pair
DTYPES = {torch.float32: "flash_attn_fwd_f32",
          torch.bfloat16: "flash_attn_fwd_bf16"}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def kernel_path(dtype, dh: int) -> str:
    """The design ``flash_attention_cuda`` launches for heads of width
    ``dh`` in ``dtype``: ``"wgmma"`` for bf16, ``"fma"`` for f32."""
    if dtype not in DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, not "
                        f"{dtype}")
    if dh % 8 or not 8 <= dh <= MAX_DH:
        raise ValueError(f"flash_attention: head width {dh} is not a "
                         f"multiple of 8 in [8, {MAX_DH}]")
    return "wgmma" if dtype == torch.bfloat16 else "fma"


def attention_mask(sq: int, sk: int, *, causal: bool, window: int,
                   device=None) -> torch.Tensor:
    """(Sq, Sk) bool: True where q position i may attend k position j
    (positions from 0 on both axes)."""
    qp = torch.arange(sq, device=device)[:, None]
    kp = torch.arange(sk, device=device)[None, :]
    ok = torch.ones(sq, sk, dtype=torch.bool, device=device)
    if causal:
        ok &= qp >= kp
    if window and window > 0:
        ok &= (qp - kp) < window
    return ok


def flash_attn_dense(q, k, v, *, scale: float, causal: bool, window: int):
    """Dense masked softmax attention in f32 → (B, H, Sq, dh) in q's dtype."""
    g = q.shape[1] // k.shape[1]
    kr = k.repeat_interleave(g, dim=1).float()
    vr = v.repeat_interleave(g, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * scale
    ok = attention_mask(q.shape[2], k.shape[2], causal=causal, window=window,
                        device=q.device)
    s = torch.where(ok, s, torch.full((), NEG_INF, device=q.device))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, vr).to(q.dtype)


def check_shapes(q, k, v):
    """Raise unless q (B, H, Sq, dh), k and v (B, Hkv, Sk, dh) fit together
    and share one dtype, f32 or bf16."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: expected (B, H, Sq, dh) and two "
                         "(B, Hkv, Sk, dh)")
    b, h, _, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or k.shape[1] < 1 \
            or h % k.shape[1] or k.shape[2] < 1:
        raise ValueError(f"q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)} (H a multiple of Hkv, one dh)")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v are {q.dtype}, {k.dtype}, {v.dtype}; the "
                        "kernel takes one dtype, float32 or bfloat16")


def flash_attention_cuda(q, k, v, *, scale: float, causal: bool,
                         window: int):
    """One launch → o (B, H, Sq, dh) in q's dtype."""
    global launches
    check_shapes(q, k, v)
    _build.check_tensors("flash_attention", q, ("q", q, q.dtype),
                         ("k", k, q.dtype), ("v", v, q.dtype))
    b, h, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    kernel_path(q.dtype, dh)  # raises on a head width no kernel takes
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must start 16-byte "
                         "aligned")
    if b * h > 65535:
        raise ValueError(f"flash_attention: B·H = {b * h} above 65535")
    fn = _build.function("flash_attn", DTYPES[q.dtype],
                         [_P] * 4 + [_I] * 6 + [_F, _I, _I, _P])
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                b, h, hkv, sq, sk, dh, float(scale), int(bool(causal)),
                int(window or 0), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "flash_attention")
    launches += 1
    return o
