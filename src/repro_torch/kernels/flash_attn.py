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
product), f32 on the FMA units (``"fma"``: register-tiled SIMT products
fed by a cp.async ring, in an instance for heads up to ``fma_width(dh)``
wide, over ``fma_tiles(dh)``: 128-row q tiles and 64-column k tiles up to
dh 128, 64 and 32 at dh 192).  Both take dh up to 192 (nemotron-4-340b).
``tile_walk`` is the f32 kernel's rule for which k tiles a q tile walks
and which of them it masks per element.

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
MAX_DH = 192          # widest head the kernel takes (a multiple of 8)
NEG_INF = -1e30       # the score of a masked (q, k) pair
DTYPES = {torch.float32: "flash_attn_fwd_f32",
          torch.bfloat16: "flash_attn_fwd_bf16"}
# the f32 kernel's instances: padded head width → (q rows a CTA, k columns
# a tile); at 192, 128 × 64 tiles would not fit in a block's shared memory
FMA_TILES = {64: (128, 64), 128: (128, 64), 192: (64, 32)}

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


def fma_width(dh: int) -> int:
    """The padded head width of the f32 kernel's instance for heads of width
    ``dh``: the narrowest of ``FMA_TILES`` that holds it."""
    kernel_path(torch.float32, dh)
    return next(w for w in FMA_TILES if dh <= w)


def fma_tiles(dh: int) -> tuple[int, int]:
    """(q rows a CTA, k columns a tile) of the f32 instance for heads of
    width ``dh``: ``tile_walk``'s ``bq`` and ``bk`` for that launch."""
    return FMA_TILES[fma_width(dh)]


def tile_walk(sq: int, sk: int, bq: int, bk: int, causal: bool,
              window: int) -> list[tuple[int, int, list[bool]]]:
    """The f32 kernel's tile walk (``csrc/flash_attn.cu``, ``tile_range``
    and ``edge_tile``) for q tiles of ``bq`` rows and k tiles of ``bk``
    columns: per q tile, the k tiles [kt_lo, kt_hi) it walks and, for each
    of them, whether it masks per element (a column masked for some row of
    the tile, or past Sk).  Every tile is walked where some row of the q
    tile is fully masked (past Sk + window − 2: only a window can empty a
    row), else only the tiles with a column some row attends."""
    n_k = -(-sk // bk)
    walk = []
    for q0 in range(0, sq, bq):
        q_last = min(q0 + bq, sq) - 1
        lo, hi = 0, n_k
        if window <= 0 or q_last <= sk + window - 2:
            if causal:
                hi = min(n_k, q_last // bk + 1)
            if window > 0:
                lo = max(0, q0 - window + 1) // bk
        edge = [k0 + bk > sk or (causal and k0 + bk - 1 > q0)
                or (window > 0 and q_last - k0 >= window)
                for k0 in range(lo * bk, hi * bk, bk)]
        walk.append((lo, hi, edge))
    return walk


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
