"""Symmetric int8 quantization: the scale math and the serving plane's
weight packer (the JAX package's ``repro/quant.py``, DESIGN.md §12).

``quantize_population`` turns a population's float32 parameters into the
int8 serve copy that ``deep.forward(infer=True, weights_dtype="int8")``
consumes, laid out as the fused-dequant kernels read it:

  w_in        (H0, F_pad) int8 — stored pre-padded to ``_input_f_pad(F)``
  w_in_scale  (H0/blk,)   f32  — one scale per hidden row block
  mid[l].wb     (n_param_blocks+1, blk, blk) int8 — the packed tile array
                (``deep.pack_weight_tiles``) with the pass-through
                identity tile appended
  mid[l].scale  (n_param_blocks+1,) f32 — one scale per tile, 1.0 last
  w_out       (O, H_last) int8
  w_out_scale (H_last/blk,) f32 — one scale per hidden tile
  b_in / mid[l].b / b_out — f32, untouched

Every tile, row block and hidden tile belongs to one member, so each
scale is a per-member scale.  The tiles and scales are byte-equal to the
JAX package's ``quantize_population`` on the same parameters: the same f32
operations in the same order, rounding half to even (``torch.round``, like
``jnp.round``).  (Under ``jax.jit``, as the JAX server calls it, XLA
multiplies by 1/127 instead of dividing by 127, so the scales it holds may
differ from these by one ulp.)
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import tree_leaves


def symmetric_scale(x: torch.Tensor, dim=None) -> torch.Tensor:
    """``max|x|/127 + 1e-12`` over ``dim`` (all of ``x`` when None).  The
    1e-12 floor keeps an all-zero group finite; it quantizes to zeros."""
    a = x.abs()
    m = a.amax() if dim is None else a.amax(dim=dim)
    # On the card, PyTorch divides by a Python scalar as a product with its
    # reciprocal; a divisor tensor on m's device keeps the true division
    # the CPU and the JAX package do, so all three agree bit for bit.
    return m / torch.full((), 127.0, dtype=m.dtype, device=m.device) + 1e-12


def quantize(x: torch.Tensor, scale) -> torch.Tensor:
    """Round-to-nearest-even symmetric int8 in [-127, 127]."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def dequantize(q: torch.Tensor, scale) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _input_f_pad(f: int) -> int:
    """The feature padding of the JAX package's fused input kernel (8 when
    F ≤ 128, else 128); the packed ``w_in`` is stored at this width."""
    fmult = 8 if f <= 128 else 128
    return f + ((-f) % fmult)


def quantize_population(params, lp) -> dict:
    """The int8 serve copy of ``params`` (a float32 tree of ``lp``), on
    the parameters' device.  See the module docstring for the tree."""
    # deep imports this module (abstract_qparams), so the packer is
    # imported here, at call time
    from repro_torch.core.deep import pack_weight_tiles
    blk = lp.block
    f32 = torch.float32
    with torch.no_grad():
        w_in = params["w_in"].to(f32)
        h0, f = w_in.shape
        s_in = symmetric_scale(w_in.reshape(h0 // blk, blk * f), dim=1)
        q_in = quantize(w_in, s_in.repeat_interleave(blk)[:, None])
        f_pad = _input_f_pad(f)
        if f_pad != f:                   # zero columns are exact under int8
            q_in = torch.nn.functional.pad(q_in, (0, f_pad - f))
        out = {"w_in": q_in, "w_in_scale": s_in,
               "b_in": params["b_in"].to(f32), "mid": []}
        eye = torch.eye(blk, dtype=torch.int8, device=w_in.device)[None]
        for l in range(lp.depth - 1):
            wb = pack_weight_tiles([w.to(f32) for w in params["mid"][l]["w"]],
                                   lp, l)
            s = symmetric_scale(wb.reshape(wb.shape[0], -1), dim=1)
            q = quantize(wb, s[:, None, None])
            out["mid"].append({
                "wb": torch.cat([q, eye]),
                "scale": torch.cat([s, torch.ones(1, dtype=f32,
                                                  device=s.device)]),
                "b": params["mid"][l]["b"].to(f32)})
        w_out = params["w_out"].to(f32)
        o, h_last = w_out.shape
        s_out = symmetric_scale(w_out.reshape(o, h_last // blk, blk),
                                dim=(0, 2))
        out["w_out"] = quantize(w_out, s_out.repeat_interleave(blk)[None, :])
        out["w_out_scale"] = s_out
        out["b_out"] = params["b_out"].to(f32)
    return out


def abstract_qparams(lp) -> dict:
    """The tree of ``quantize_population`` for ``lp`` as meta tensors —
    shapes and dtypes, no storage (``deep.qparams_from_numpy``'s check)."""
    blk = lp.block
    i8, f32 = torch.int8, torch.float32

    def meta(dtype, *shape):
        return torch.empty(shape, dtype=dtype, device="meta")

    h0 = lp.layer_pop(0).total_hidden
    h_last = lp.layer_pop(lp.depth - 1).total_hidden
    mid = []
    for l in range(lp.depth - 1):
        n = lp.bd_layout(l).n_param_blocks + 1
        mid.append({"wb": meta(i8, n, blk, blk), "scale": meta(f32, n),
                    "b": meta(f32, lp.layer_pop(l + 1).total_hidden)})
    return {"w_in": meta(i8, h0, _input_f_pad(lp.in_features)),
            "w_in_scale": meta(f32, h0 // blk), "b_in": meta(f32, h0),
            "mid": mid, "w_out": meta(i8, lp.out_features, h_last),
            "w_out_scale": meta(f32, h_last // blk),
            "b_out": meta(f32, lp.num_members, lp.out_features)}


def unpack_weight_tiles(wb: torch.Tensor, lp, l: int) -> list:
    """Inverse of ``deep.pack_weight_tiles``: flat (n_param_blocks, blk,
    blk) tiles → the per-bucket (n, hout, hin) arrays."""
    blk = lp.block
    out, off = [], 0
    for (m0, n, hin, hout, off_in, off_out, real) in lp.proj_buckets(l):
        if not real:
            continue
        ob, ib = hout // blk, hin // blk
        cnt = n * ob * ib
        out.append(wb[off:off + cnt].reshape(n, ob, ib, blk, blk)
                   .permute(0, 1, 3, 2, 4).reshape(n, hout, hin))
        off += cnt
    return out


def dequantize_population(qparams, lp) -> dict:
    """The float32 parameter tree an int8 serve copy represents: the
    reference the fused-dequant kernels are held to (the f32 forward of
    this tree equals the int8 forward up to summation order)."""
    blk = lp.block
    f = lp.in_features
    w_in = dequantize(qparams["w_in"][:, :f],
                      qparams["w_in_scale"].repeat_interleave(blk)[:, None])
    out = {"w_in": w_in, "b_in": qparams["b_in"], "mid": []}
    for l in range(lp.depth - 1):
        n_p = lp.bd_layout(l).n_param_blocks
        wb = dequantize(qparams["mid"][l]["wb"][:n_p],
                        qparams["mid"][l]["scale"][:n_p, None, None])
        out["mid"].append({"w": unpack_weight_tiles(wb, lp, l),
                           "b": qparams["mid"][l]["b"]})
    out["w_out"] = dequantize(
        qparams["w_out"],
        qparams["w_out_scale"].repeat_interleave(blk)[None, :])
    out["b_out"] = qparams["b_out"]
    return out


def serve_copy_bytes(tree) -> int:
    """Device bytes a parameter tree pins (the tracked serve-copy size)."""
    return int(sum(a.numel() * a.element_size() for a in tree_leaves(tree)))
