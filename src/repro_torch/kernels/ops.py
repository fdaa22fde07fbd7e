"""Public kernel entry points, with the JAX package's signatures and shape
checks (``repro/kernels/ops.py``).

Serving: ``fused_input_infer``, ``fused_layer_infer``, ``infer_head`` —
forward-only — and their twins over the int8 serve copy
(``quant.quantize_population``), ``fused_input_infer_int8``,
``fused_layer_infer_int8`` and ``infer_head_int8``, which dequantize inside
their kernels: no f32 weight is made per call.  Training:
``fused_input``, ``fused_layer``, ``loss_head`` — each a
``torch.autograd.Function`` whose forward is one kernel launch
(the forwards also emit g' = act'(z)·mask, or the loss head its dlogits)
and whose backward is one more, as the JAX package wraps each
``pallas_call`` pair in a ``custom_vjp``.  The unfused route's two
stages, ``block_diag_gemm`` (the bare block-diagonal projection; its
backward is two launches, dh and dWB) and ``seg_act`` (the per-block
activation with the mask), are differentiable the same way, and so is
``m3_matmul``, the bare M3 projection (backward: dh, then dW2).  The bias
cotangents (``Σ_b dy·g'``, ``d_per ⊙ Σ_b dl``) are plain tensor ops
outside the kernels, as JAX leaves them to XLA.  Without a gradient to take (no input
requires one, or grad mode is off) the training entries run the serving
kernels instead, as JAX's primal does.

Dispatch is on the input tensor's device: a CUDA tensor launches the
hand-written kernel (or raises — there is no fallback), a CPU tensor runs
the kernel's plain PyTorch version.  The CPU dispatch counts its calls in
the kernel's launch counter, so the launch budgets hold on either device
(``launch/launch_count.py``).

The two kernels of the JAX package's public kernel API that no population
path runs, ``flash_attention`` (differentiable: its backward recomputes
through the dense plain version, as JAX's custom VJP recomputes through
its oracle) and ``moe_gemm`` (forward only, as in JAX), take f32 or bf16
operands of one dtype and return their result in that dtype.

Static layout arrays (activation ids, masks, segment ids) may be numpy or
tensors; callers on the hot path pass tensors already on the device.

Operands (activations and weights) are f32, or bf16 under the compute
policy (DESIGN.md §7): the fused input and mid layers, both heads and the
unfused route's ``block_diag_gemm`` and ``m3_matmul`` take either, of one
dtype, and launch the kernel's instance of that dtype (the CPU dispatch
runs the plain version on them and counts in the ``bf16_`` counters); the
int8 serving twins take f32 or bf16 activations beside their int8 weights
(counted as ``bf16_int8_*`` under bf16).  Accumulators, biases, masks,
scales, the heads' logits, losses and dlogits, and the bias cotangents
stay f32 (``Σ_b dy·g'`` sums f32 products of the bf16 values, as JAX's
``(dy.astype(f32) * gp.astype(f32)).sum(0)``); the other cotangents come
back in the operands' dtype, and so do ``block_diag_gemm``'s output and
``m3_matmul``'s logits (JAX's out dtype is the operands': under bf16 they
are rounded once to bf16).  ``seg_act`` takes f32 (the policy hands it the
f32 sum of a bf16 projection and an f32 bias).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import block_diag as _bdk
from repro_torch.kernels import flash_attn as _fak
from repro_torch.kernels import fused_input as _fik
from repro_torch.kernels import fused_layer as _flk
from repro_torch.kernels import infer_head as _ihk
from repro_torch.kernels import loss_head as _lhk
from repro_torch.kernels import m3_matmul as _m3k
from repro_torch.kernels import grouped_gemm as _moek
from repro_torch.kernels import seg_act as _sak
from repro_torch.quant import _input_f_pad


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def _as(a, device, dtype) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype).contiguous()
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def _require_f32(**tensors):
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; it is float32 under every "
                            "policy here (int8 weights: the *_int8 entries)")


def _require_operands(**tensors):
    """The compute policy's operands: f32, or bf16, all of one dtype."""
    dtypes = {t.dtype for t in tensors.values()}
    if len(dtypes) != 1 or not dtypes <= {torch.float32, torch.bfloat16}:
        raise TypeError(
            "operands " + ", ".join(f"{n} {t.dtype}"
                                    for n, t in tensors.items())
            + ": the kernels take float32, or bfloat16 (the compute "
            "policy), of one dtype")


def _count(mod, name: str, t: torch.Tensor):
    """The CPU dispatch's count of a plain call, in the kernel's counter
    (``bf16_`` for bf16 operands)."""
    _build.count(vars(mod), name, t.dtype)


def _bias_grad(dy: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Σ_b dy·g' of f32 products, whatever the operands' dtype (JAX:
    ``(dy.astype(f32) * gp.astype(f32)).sum(0)``)."""
    return (dy.float() * g.float()).sum(0)


def _require_int8(what: str, t: torch.Tensor):
    if t.dtype != torch.int8:
        raise ValueError(f"int8 serve path got {t.dtype} {what}")


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


# --------------------------------------------------------------------- #
# fused input layer                                                      #
# --------------------------------------------------------------------- #

def _input_args(x, w_in, b_in, block_act_ids, mask, block):
    if x.shape[1] != w_in.shape[1]:
        raise ValueError(f"feature axis {x.shape[1]} != {w_in.shape[1]}")
    _require_operands(x=x, w_in=w_in)
    return _input_common(x, w_in.shape[0], b_in, block_act_ids, mask, block)


def _input_common(x, h, b_in, block_act_ids, mask, block):
    """The checks shared by the f32/bf16 and int8 input layers → (ids,
    mask)."""
    if h % block:
        raise ValueError(f"hidden axis {h} not {block}-aligned")
    if tuple(b_in.shape) != (h,):
        raise ValueError(f"bias shape {tuple(b_in.shape)} != ({h},)")
    _require_f32(b_in=b_in)
    dev = x.device
    ids = _as(block_act_ids, dev, torch.int32)
    m = _as(mask, dev, torch.float32)
    if tuple(ids.shape) != (h // block,) or tuple(m.shape) != (h,):
        raise ValueError(f"{tuple(ids.shape)} activation ids / "
                         f"{tuple(m.shape)} mask for {h // block} blocks of "
                         f"{block}")
    return ids, m


def fused_input_infer(x: torch.Tensor, w_in: torch.Tensor,
                      b_in: torch.Tensor, block_act_ids, mask, *,
                      block: int) -> torch.Tensor:
    """Dense input projection + bias + per-block activation + padding mask
    in one kernel.  x (B, F), w_in (H, F) (f32, or both bf16), b_in (H,)
    f32 → (B, H) of ``act(x·W_inᵀ + b_in)·mask`` in x's dtype.  H must be
    block-aligned."""
    ids, m = _input_args(x, w_in, b_in, block_act_ids, mask, block)
    if _on_card(x):
        return _fik.fused_input_cuda(x.contiguous(), w_in.contiguous(),
                                     b_in.contiguous(), m, ids, block=block)
    _count(_fik, "launches", x)
    return _fik.fused_input_plain(x, w_in, b_in, m, ids, block=block)


def fused_input_infer_int8(x: torch.Tensor, w_q: torch.Tensor,
                           w_scale: torch.Tensor, b_in: torch.Tensor,
                           block_act_ids, mask, *, block: int
                           ) -> torch.Tensor:
    """``fused_input_infer`` over the int8 serve copy: ``w_q`` (H, F_pad)
    int8, stored pre-padded to the JAX kernel's feature tile
    (``quantize_population``), one f32 scale per hidden row block
    (H / block,).  x stays (B, F): the kernel reads only the first F
    weight columns, so no weight byte is padded or upcast per call.  x f32,
    or bf16 under the compute policy (y then bf16)."""
    h = w_q.shape[0]
    _require_int8("input weight", w_q)
    f_pad = _input_f_pad(x.shape[1])
    if w_q.shape[1] != f_pad:
        raise ValueError(
            f"int8 input weight has F={w_q.shape[1]}, expected the "
            f"pre-padded {f_pad} (quantize_population stores it padded)")
    ids, m = _input_common(x, h, b_in, block_act_ids, mask, block)
    if tuple(w_scale.shape) != (h // block,):
        raise ValueError(f"scales {tuple(w_scale.shape)} != "
                         f"({h // block},)")
    _require_operands(x=x)
    _require_f32(w_scale=w_scale)
    if _on_card(x):
        return _fik.fused_input_int8_cuda(
            x.contiguous(), w_q.contiguous(), w_scale.contiguous(),
            b_in.contiguous(), m, ids, block=block)
    _count(_fik, "int8_launches", x)
    return _fik.fused_input_int8_plain(x, w_q, w_scale, b_in, m, ids,
                                       block=block)


class _FusedInput(torch.autograd.Function):
    """Forward: one launch emitting y and g'.  Backward: one launch
    emitting dW_in (and dx, only when x needs a gradient — the trainer's x
    is data, so it never does)."""

    @staticmethod
    def forward(ctx, x, w_in, b_in, ids, m, block):
        if _on_card(x):
            y, g = _fik.fused_input_train_cuda(
                x.contiguous(), w_in.contiguous(), b_in.contiguous(), m, ids,
                block=block)
        else:
            _count(_fik, "launches", x)
            y, g = _fik.fused_input_train_plain(x, w_in, b_in, m, ids,
                                                block=block)
        ctx.save_for_backward(x, w_in, g)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w_in, g = ctx.saved_tensors
        want_dx = ctx.needs_input_grad[0]
        dy = dy.contiguous()
        if _on_card(dy):
            dx, dw = _fik.fused_input_bwd_cuda(
                dy, g, x.contiguous(), w_in.contiguous(), with_dx=want_dx)
        else:
            _count(_fik, "bwd_launches", dy)
            dx, dw = _fik.fused_input_bwd_plain(dy, g, x, w_in,
                                                with_dx=want_dx)
        db = _bias_grad(dy, g) if ctx.needs_input_grad[2] else None
        return dx, dw, db, None, None, None


def fused_input(x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor,
                block_act_ids, mask, *, block: int) -> torch.Tensor:
    """The training input layer: ``fused_input_infer``'s function, made
    differentiable through the fused one-launch backward (JAX:
    ``ops.fused_input``'s custom VJP).  Runs the serving kernel when no
    gradient is wanted."""
    if not _wants_grad(x, w_in, b_in):
        return fused_input_infer(x, w_in, b_in, block_act_ids, mask,
                                 block=block)
    ids, m = _input_args(x, w_in, b_in, block_act_ids, mask, block)
    return _FusedInput.apply(x, w_in, b_in, ids, m, block)


# --------------------------------------------------------------------- #
# fused block-diagonal mid layer                                        #
# --------------------------------------------------------------------- #

def _layer_args(h, wb, b_eff, layout, block_act_ids, mask):
    blk = layout.block
    if tuple(wb.shape) != (layout.n_param_blocks, blk, blk):
        raise ValueError(f"weight tiles {tuple(wb.shape)} != "
                         f"({layout.n_param_blocks}, {blk}, {blk})")
    _require_operands(h=h, wb=wb)
    return _layer_common(h, b_eff, layout, block_act_ids, mask)


def _layer_common(h, b_eff, layout, block_act_ids, mask):
    """The checks shared by the f32/bf16 and int8 mid layers → (acts,
    mask)."""
    blk = layout.block
    if h.shape[1] != layout.n_in_tiles * blk:
        raise ValueError(f"input axis {h.shape[1]} != "
                         f"{layout.n_in_tiles}×{blk}")
    h_out = layout.n_out_tiles * blk
    if tuple(b_eff.shape) != (h_out,):
        raise ValueError(f"bias shape {tuple(b_eff.shape)} != ({h_out},)")
    _require_f32(b_eff=b_eff)
    dev = h.device
    acts = _as(block_act_ids, dev, torch.int32)
    if tuple(acts.shape) != (layout.n_out_tiles,):
        raise ValueError(f"{tuple(acts.shape)} activation ids for "
                         f"{layout.n_out_tiles} output tiles")
    m = _as(mask, dev, torch.float32)
    if tuple(m.shape) != (h_out,):
        raise ValueError(f"mask shape {tuple(m.shape)} != ({h_out},)")
    return acts, m


def _augment(wb: torch.Tensor) -> torch.Tensor:
    """Append the shared identity tile of pass-through members (not a
    parameter)."""
    eye = torch.eye(wb.shape[1], dtype=wb.dtype, device=wb.device)
    return torch.cat([wb, eye[None]])


def fused_layer_infer(h: torch.Tensor, wb: torch.Tensor,
                      b_eff: torch.Tensor, layout, block_act_ids, mask
                      ) -> torch.Tensor:
    """Block-diagonal projection + gated bias + per-tile activation +
    padding mask in one kernel.  h (B, n_in_tiles·blk), wb
    (n_param_blocks, blk, blk) (f32, or both bf16), b_eff
    (n_out_tiles·blk,) f32, ``layout`` a ``BlockDiagLayout``,
    ``block_act_ids`` / ``mask`` of the OUTPUT layer → (B,
    n_out_tiles·blk) in h's dtype.  Pass-through members use the shared
    identity tile appended here."""
    acts, m = _layer_args(h, wb, b_eff, layout, block_act_ids, mask)
    blk = layout.block
    wb_aug = _augment(wb)
    rowptr, s_in, s_w = _flk.schedule_on(layout, h.device)
    if _on_card(h):
        return _flk.fused_layer_cuda(h.contiguous(), wb_aug,
                                     b_eff.contiguous(), m, acts, rowptr,
                                     s_in, s_w, blk=blk)
    _count(_flk, "launches", h)
    return _flk.fused_layer_plain(h, wb_aug, b_eff, m, acts, rowptr, s_in,
                                  s_w, blk=blk)


def fused_layer_infer_int8(h: torch.Tensor, wb_q: torch.Tensor,
                           wb_scale: torch.Tensor, b_eff: torch.Tensor,
                           layout, block_act_ids, mask) -> torch.Tensor:
    """``fused_layer_infer`` over the int8 serve copy: ``wb_q`` is the
    packer's tile array with the identity tile already appended
    (n_param_blocks + 1, blk, blk) int8, ``wb_scale`` one f32 scale per
    tile (1.0 for the identity).  Nothing is packed or appended per call.
    h f32, or bf16 under the compute policy (y then bf16)."""
    blk = layout.block
    _require_int8("weight tiles", wb_q)
    n_tiles = layout.n_param_blocks + 1
    if tuple(wb_q.shape) != (n_tiles, blk, blk):
        raise ValueError(
            f"weight tiles {tuple(wb_q.shape)} != ({n_tiles}, {blk}, {blk})"
            " — the int8 store is pre-augmented (identity tile appended by "
            "quantize_population)")
    if tuple(wb_scale.shape) != (n_tiles,):
        raise ValueError(f"scales {tuple(wb_scale.shape)} != ({n_tiles},)")
    _require_operands(h=h)
    _require_f32(wb_scale=wb_scale)
    acts, m = _layer_common(h, b_eff, layout, block_act_ids, mask)
    rowptr, s_in, s_w = _flk.schedule_on(layout, h.device)
    args = (h.contiguous(), wb_q.contiguous(), wb_scale.contiguous(),
            b_eff.contiguous(), m, acts, rowptr, s_in, s_w)
    if _on_card(h):
        return _flk.fused_layer_int8_cuda(*args, blk=blk)
    _count(_flk, "int8_launches", h)
    return _flk.fused_layer_int8_plain(*args, blk=blk)


class _FusedLayer(torch.autograd.Function):
    """Forward: one launch emitting y and g'.  Backward: one launch
    emitting dx and dWB, member by member (``fused_layer.dx_dw_units``)."""

    @staticmethod
    def forward(ctx, h, wb, b_eff, layout, acts, m):
        blk = layout.block
        wb_aug = _augment(wb)
        rowptr, s_in, s_w = _flk.schedule_on(layout, h.device)
        args = (h.contiguous(), wb_aug, b_eff.contiguous(), m, acts, rowptr,
                s_in, s_w)
        if _on_card(h):
            y, g = _flk.fused_layer_train_cuda(*args, blk=blk)
        else:
            _count(_flk, "launches", h)
            y, g = _flk.fused_layer_train_plain(*args, blk=blk)
        ctx.layout = layout
        ctx.save_for_backward(h, wb_aug, g)
        return y

    @staticmethod
    def backward(ctx, dy):
        h, wb_aug, g = ctx.saved_tensors
        layout = ctx.layout
        dy = dy.contiguous()
        # the parameter tiles as the forward read them (a view, no copy)
        args = (dy, g, h.contiguous(), wb_aug[:layout.n_param_blocks],
                *_flk.dx_dw_schedule_on(layout, dy.device))
        if _on_card(dy):
            dx, dwb = _flk.fused_layer_dx_dw_cuda(*args, blk=layout.block)
        else:
            _count(_flk, "dx_dw_launches", dy)
            dx, dwb = _flk.fused_layer_dx_dw_plain(*args, blk=layout.block)
        db = _bias_grad(dy, g) if ctx.needs_input_grad[2] else None
        return dx, dwb, db, None, None, None


def fused_layer(h: torch.Tensor, wb: torch.Tensor, b_eff: torch.Tensor,
                layout, block_act_ids, mask) -> torch.Tensor:
    """The training mid layer: ``fused_layer_infer``'s function, made
    differentiable through the fused one-launch backward (JAX:
    ``ops.fused_layer``'s custom VJP).  Runs the serving kernel when no
    gradient is wanted."""
    if not _wants_grad(h, wb, b_eff):
        return fused_layer_infer(h, wb, b_eff, layout, block_act_ids, mask)
    acts, m = _layer_args(h, wb, b_eff, layout, block_act_ids, mask)
    return _FusedLayer.apply(h, wb, b_eff, layout, acts, m)


# --------------------------------------------------------------------- #
# unfused mid layer: block-diagonal GEMM, then segmented activation     #
# --------------------------------------------------------------------- #

def _bd_fwd(x, wb_aug, rowptr, s_in, s_w, blk):
    if _on_card(x):
        return _bdk.block_diag_fwd_cuda(x, wb_aug, rowptr, s_in, s_w, blk=blk)
    _count(_bdk, "fwd_launches", x)
    return _bdk.block_diag_fwd_plain(x, wb_aug, rowptr, s_in, s_w, blk=blk)


class _BlockDiag(torch.autograd.Function):
    """Forward: one launch.  Backward: dh from the forward kernel on the
    transposed tiles and steps, and dWB over the parameter tiles only (the
    identity tile is not a parameter).  Under bf16 the cotangent of the
    bf16 output is bf16, and so are dh and dWB."""

    @staticmethod
    def forward(ctx, h, wb, layout):
        wb_aug = _augment(wb)
        ctx.layout = layout
        ctx.save_for_backward(h, wb_aug)
        return _bd_fwd(h.contiguous(), wb_aug,
                       *_flk.schedule_on(layout, h.device), layout.block)

    @staticmethod
    def backward(ctx, dy):
        h, wb_aug = ctx.saved_tensors
        layout, blk = ctx.layout, ctx.layout.block
        dy = dy.contiguous()
        (rowptr_t, s_in_t, s_w_t, perm_t, out_tile,
         in_tile) = _flk.schedule_on(layout, dy.device, transposed=True)
        dh = dwb = None
        if ctx.needs_input_grad[0]:
            dh = _bd_fwd(dy, _flk.transposed_tiles(wb_aug, perm_t), rowptr_t,
                         s_in_t, s_w_t, blk)
        if ctx.needs_input_grad[1]:
            args = (dy, h.contiguous(), out_tile, in_tile)
            if _on_card(dy):
                dwb = _bdk.block_diag_dw_cuda(*args, blk=blk)
            else:
                _count(_bdk, "dw_launches", dy)
                dwb = _bdk.block_diag_dw_plain(*args, blk=blk)
        return dh, dwb, None


def block_diag_gemm(h: torch.Tensor, wb: torch.Tensor, layout
                    ) -> torch.Tensor:
    """The bare block-diagonal member projection (JAX:
    ``ops.block_diag_gemm``'s custom VJP): h (B, n_in_tiles·blk), wb
    (n_param_blocks, blk, blk) (f32, or both bf16), ``layout`` a
    ``BlockDiagLayout`` → (B, n_out_tiles·blk) in h's dtype (bf16: the f32
    sum rounded once).  Pass-through members are copied through the shared
    identity tile appended here (in the tiles' dtype: exact), and get no
    weight gradient."""
    blk = layout.block
    if h.shape[1] != layout.n_in_tiles * blk:
        raise ValueError(f"input axis {h.shape[1]} != "
                         f"{layout.n_in_tiles}×{blk}")
    if tuple(wb.shape) != (layout.n_param_blocks, blk, blk):
        raise ValueError(f"weight tiles {tuple(wb.shape)} != "
                         f"({layout.n_param_blocks}, {blk}, {blk})")
    _require_operands(h=h, wb=wb)
    if _wants_grad(h, wb):
        return _BlockDiag.apply(h, wb, layout)
    return _bd_fwd(h.contiguous(), _augment(wb),
                   *_flk.schedule_on(layout, h.device), blk)


def _seg_fwd(h, ids, m, block):
    if _on_card(h):
        return _sak.seg_act_cuda(h, ids, m, blk=block)
    _count(_sak, "launches", h)
    return _sak.seg_act_plain(h, ids, m, blk=block)


class _SegAct(torch.autograd.Function):
    """Forward: one launch.  Backward: one launch of (dy·mask)·act'(h), in
    h's dtype (a bf16 h gets a bf16 gradient)."""

    @staticmethod
    def forward(ctx, h, ids, m, block):
        ctx.block = block
        ctx.save_for_backward(h, ids, m)
        return _seg_fwd(h.contiguous(), ids, m, block)

    @staticmethod
    def backward(ctx, dy):
        h, ids, m = ctx.saved_tensors
        args = (h.contiguous(), dy.to(h.dtype).contiguous(), ids, m)
        if _on_card(dy):
            dh = _sak.seg_act_bwd_cuda(*args, blk=ctx.block)
        else:
            _count(_sak, "bwd_launches", h)
            dh = _sak.seg_act_bwd_plain(*args, blk=ctx.block)
        return dh, None, None, None


def seg_act(h: torch.Tensor, block_act_ids, mask, *, block: int
            ) -> torch.Tensor:
    """One-pass per-block activation + padding mask (JAX: ``ops.seg_act``'s
    custom VJP): h (B, H) f32 or bf16, one activation id per block of
    ``block`` columns, mask (H,) f32 → ``act(h)·mask`` (B, H) in h's dtype
    (bf16: computed in f32, rounded once).  Differentiable through a
    one-launch backward."""
    hh = h.shape[1]
    if hh % block:
        raise ValueError(f"hidden axis {hh} not {block}-aligned")
    _require_operands(h=h)
    ids = _as(block_act_ids, h.device, torch.int32)
    m = _as(mask, h.device, torch.float32)
    if tuple(ids.shape) != (hh // block,) or tuple(m.shape) != (hh,):
        raise ValueError(f"{tuple(ids.shape)} activation ids / "
                         f"{tuple(m.shape)} mask for {hh // block} blocks "
                         f"of {block}")
    if _wants_grad(h):
        return _SegAct.apply(h, ids, m, block)
    return _seg_fwd(h.contiguous(), ids, m, block)


# --------------------------------------------------------------------- #
# M3: the segment-blocked output projection                             #
# --------------------------------------------------------------------- #

def _m3_fwd(h, w2, ptr, block):
    if _on_card(h):
        return _m3k.m3_matmul_fwd_cuda(h, w2, ptr, block=block)
    _count(_m3k, "fwd_launches", h)
    return _m3k.m3_matmul_fwd_plain(h, w2, ptr, block=block)


class _M3Matmul(torch.autograd.Function):
    """Forward: one launch.  Backward: dh (only when h needs a gradient),
    then dW2 (only when w2 does), one launch each; under bf16 dy, dh and
    dW2 are bf16."""

    @staticmethod
    def forward(ctx, h, w2, seg, ptr, block):
        ctx.block = block
        ctx.save_for_backward(h, w2, seg)
        return _m3_fwd(h.contiguous(), w2.contiguous(), ptr, block)

    @staticmethod
    def backward(ctx, dy):
        h, w2, seg = ctx.saved_tensors
        block, dy = ctx.block, dy.contiguous()
        dh = dw = None
        if ctx.needs_input_grad[0]:
            args = (dy, w2.contiguous(), seg)
            if _on_card(dy):
                dh = _m3k.m3_matmul_dh_cuda(*args, block=block)
            else:
                _count(_m3k, "dh_launches", dy)
                dh = _m3k.m3_matmul_dh_plain(*args, block=block)
        if ctx.needs_input_grad[1]:
            args = (dy, h.contiguous(), seg)
            if _on_card(dy):
                dw = _m3k.m3_matmul_dw_cuda(*args, block=block)
            else:
                _count(_m3k, "dw_launches", dy)
                dw = _m3k.m3_matmul_dw_plain(*args, block=block)
        return dh, dw, None, None, None


def m3_matmul(h: torch.Tensor, w2: torch.Tensor, block_seg_ids,
              num_members: int, *, block_h: int,
              member_ptr=None) -> torch.Tensor:
    """The segment-blocked matmul (JAX: ``ops.m3_matmul``'s custom VJP):
    h (B, H), w2 (O, H) (f32, or both bf16), one member id per hidden
    block of ``block_h`` units (sorted: every member's blocks contiguous) →
    y (B, P, O) in h's dtype (bf16: each f32 sum rounded once, as JAX's out
    dtype), ``y[b, m, o] = Σ_{j in member m} h[b, j]·w2[o, j]``.  Differentiable
    through two backward launches (dh, dW2).  H must already be
    block_h-aligned.  Nothing is padded: JAX pads B to its batch tile and
    O to 128 lanes for the TPU; the kernels take both as they are.
    ``member_ptr``: the ids' CSR form (``infer_head.member_ptr``) already
    on h's device, so a caller on the hot path skips its rebuild (a
    ``bincount``, which waits for the device)."""
    if h.dim() != 2 or h.shape[1] % block_h:
        raise ValueError(f"hidden axis {h.shape[-1]} not {block_h}-aligned")
    if w2.dim() != 2 or w2.shape[1] != h.shape[1]:
        raise ValueError(f"w2 {tuple(w2.shape)} does not match hidden axis "
                         f"{h.shape[1]}")
    _require_operands(h=h, w2=w2)
    if not isinstance(block_seg_ids, torch.Tensor) \
            and np.any(np.diff(np.asarray(block_seg_ids)) < 0):
        raise ValueError("m3_matmul: members' hidden blocks must be "
                         "contiguous (sorted block_seg_ids)")
    seg = _as(block_seg_ids, h.device, torch.int32)
    if tuple(seg.shape) != (h.shape[1] // block_h,):
        raise ValueError(f"{tuple(seg.shape)} segment ids for "
                         f"{h.shape[1] // block_h} hidden blocks")
    ptr = (_ihk.member_ptr(seg, num_members) if member_ptr is None
           else member_ptr)
    if tuple(ptr.shape) != (num_members + 1,):
        raise ValueError(f"member_ptr {tuple(ptr.shape)} for {num_members} "
                         "members")
    if _wants_grad(h, w2):
        return _M3Matmul.apply(h, w2, seg, ptr, block_h)
    return _m3_fwd(h.contiguous(), w2.contiguous(), ptr, block_h)


# --------------------------------------------------------------------- #
# output heads                                                          #
# --------------------------------------------------------------------- #

def _head_args(h, w_out, b_out, block_seg_ids, block_h):
    """The checks shared by the heads (the caller checks the weight's
    dtype) → the per-block segment ids on h's device."""
    if h.shape[1] % block_h:
        raise ValueError(f"hidden axis {h.shape[1]} not {block_h}-aligned")
    if w_out.shape[1] != h.shape[1]:
        raise ValueError(f"head weight {tuple(w_out.shape)} does not match "
                         f"hidden axis {h.shape[1]}")
    if b_out.shape[1] != w_out.shape[0]:
        raise ValueError(f"bias {tuple(b_out.shape)} vs {w_out.shape[0]} "
                         "classes")
    _require_f32(b_out=b_out)
    dev = h.device
    if not isinstance(block_seg_ids, torch.Tensor) \
            and np.any(np.diff(np.asarray(block_seg_ids)) < 0):
        raise ValueError("infer_head: members' hidden blocks must be "
                         "contiguous (sorted block_seg_ids)")
    seg = _as(block_seg_ids, dev, torch.int32)
    if seg.shape[0] != h.shape[1] // block_h:
        raise ValueError(f"{seg.shape[0]} segment ids for "
                         f"{h.shape[1] // block_h} hidden blocks")
    return seg


def infer_head(h: torch.Tensor, w_out: torch.Tensor, b_out: torch.Tensor,
               block_seg_ids, *, block_h: int,
               log_probs: bool = False) -> torch.Tensor:
    """Forward-only output head: M3 projection + per-member bias (+ stable
    log-softmax) in one kernel.  h (B, H), w_out (O, H) (f32, or both
    bf16), b_out (P, O) f32 → (B, P, O) f32 logits, or log-probabilities
    with ``log_probs``.  H must be block_h-aligned and every member's blocks
    contiguous (sorted ``block_seg_ids``)."""
    seg = _head_args(h, w_out, b_out, block_seg_ids, block_h)
    _require_operands(h=h, w_out=w_out)
    ptr = _ihk.member_ptr(seg, b_out.shape[0])
    if _on_card(h):
        return _ihk.infer_head_cuda(h.contiguous(), w_out.contiguous(),
                                    b_out.contiguous(), ptr, block=block_h,
                                    log_probs=log_probs)
    _count(_ihk, "launches", h)
    return _ihk.infer_head_plain(h, w_out, b_out, ptr, block=block_h,
                                 log_probs=log_probs)


def infer_head_int8(h: torch.Tensor, w_q: torch.Tensor,
                    w_scale: torch.Tensor, b_out: torch.Tensor,
                    block_seg_ids, *, block_h: int,
                    log_probs: bool = False) -> torch.Tensor:
    """``infer_head`` over the int8 serve copy: ``w_q`` (O, H) int8 with
    one f32 scale per hidden tile (H / block_h,), dequantized inside the
    kernel.  The classes are not padded (JAX pads O to 128); members are
    the same CSR ranges as in the f32 head.  h f32, or bf16 under the
    compute policy; the logits stay f32."""
    _require_int8("head weight", w_q)
    seg = _head_args(h, w_q, b_out, block_seg_ids, block_h)
    if tuple(w_scale.shape) != (h.shape[1] // block_h,):
        raise ValueError(f"scales {tuple(w_scale.shape)} != "
                         f"({h.shape[1] // block_h},)")
    _require_operands(h=h)
    _require_f32(w_scale=w_scale)
    ptr = _ihk.member_ptr(seg, b_out.shape[0])
    if _on_card(h):
        return _ihk.infer_head_int8_cuda(
            h.contiguous(), w_q.contiguous(), w_scale.contiguous(),
            b_out.contiguous(), ptr, block=block_h, log_probs=log_probs)
    _count(_ihk, "int8_launches", h)
    return _ihk.infer_head_int8_plain(h, w_q, w_scale, b_out, ptr,
                                      block=block_h, log_probs=log_probs)


class _LossHead(torch.autograd.Function):
    """Forward: one launch emitting the per-member losses and dlogits.
    Backward: one launch emitting dh and dW_out."""

    @staticmethod
    def forward(ctx, h, w_out, b_out, targets, seg, block_h):
        ptr = _ihk.member_ptr(seg, b_out.shape[0])
        args = (h.contiguous(), w_out.contiguous(), b_out.contiguous(),
                targets, ptr)
        b_real = h.shape[0]
        if _on_card(h):
            per, dl = _lhk.loss_head_fwd_cuda(*args, block=block_h,
                                              b_real=b_real)
        else:
            _count(_lhk, "fwd_launches", h)
            per, dl = _lhk.loss_head_fwd_plain(*args, block=block_h,
                                               b_real=b_real)
        ctx.block_h = block_h
        ctx.save_for_backward(h, w_out, dl, seg)
        return per

    @staticmethod
    def backward(ctx, dper):
        h, w_out, dl, seg = ctx.saved_tensors
        dper = dper.contiguous()
        args = (dper, dl, h.contiguous(), w_out.contiguous(), seg)
        if _on_card(dper):
            dh, dw = _lhk.loss_head_bwd_cuda(*args, block=ctx.block_h)
        else:
            _count(_lhk, "bwd_launches", h)
            dh, dw = _lhk.loss_head_bwd_plain(*args, block=ctx.block_h)
        db = dper[:, None] * dl.sum(0) if ctx.needs_input_grad[2] else None
        return dh, dw, db, None, None, None


def loss_head(h: torch.Tensor, w_out: torch.Tensor, b_out: torch.Tensor,
              targets, block_seg_ids, *, block_h: int) -> torch.Tensor:
    """Output projection + per-member softmax cross-entropy in one kernel,
    differentiable through a one-launch backward (JAX: ``ops.loss_head``'s
    custom VJP).  h (B, H), w_out (O, H) (f32, or both bf16: dh and dW_out
    come back bf16), b_out (P, O) f32, integer targets (B,) → per-member
    mean NLL (P,) f32; ``per.sum()`` is the training loss.  The (B, P, O)
    logits never reach device memory."""
    seg = _head_args(h, w_out, b_out, block_seg_ids, block_h)
    _require_operands(h=h, w_out=w_out)
    tgt = _as(targets, h.device, torch.int32).reshape(-1)
    if tgt.shape[0] != h.shape[0]:
        raise ValueError(f"{tgt.shape[0]} targets for {h.shape[0]} rows")
    return _LossHead.apply(h, w_out, b_out, tgt, seg, block_h)


# --------------------------------------------------------------------- #
# flash attention                                                       #
# --------------------------------------------------------------------- #

def _flash_fwd(q, k, v, scale, causal, window):
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if _on_card(q):
        return _fak.flash_attention_cuda(q, k, v, scale=scale, causal=causal,
                                         window=window)
    _fak.check_shapes(q, k, v)
    _fak.launches += 1
    return _fak.flash_attn_dense(q, k, v, scale=scale, causal=causal,
                                 window=window)


class _FlashAttention(torch.autograd.Function):
    """Forward: one launch.  Backward: no kernel — the dense plain version
    recomputed from q, k, v and differentiated by autograd, the JAX
    package's own design (``ops._flash_bwd`` takes the VJP of
    ``ref.flash_attn_ref``), not a fallback."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window):
        ctx.attn = (scale, causal, window)
        ctx.save_for_backward(q, k, v)
        return _flash_fwd(q, k, v, scale, causal, window)

    @staticmethod
    def backward(ctx, do):
        scale, causal, window = ctx.attn
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, need)]
            o = _fak.flash_attn_dense(*qkv, scale=scale, causal=causal,
                                      window=window)
            grads = iter(torch.autograd.grad(
                o, [t for t in qkv if t.requires_grad], do))
        return (*(next(grads) if n else None for n in need), None, None,
                None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, causal: bool = True, window: int = 0,
                    block_q: int = 512, block_k: int = 512) -> torch.Tensor:
    """Flash attention forward in one kernel (JAX: ``ops.flash_attention``,
    whose ``interpret`` switch has no meaning here).  q (B, H, Sq, dh), k
    and v (B, Hkv, Sk, dh), one dtype, f32 or bf16, H a multiple of Hkv →
    o (B, H, Sq, dh) in q's dtype: ``softmax(scale·q kᵀ, masked)·v`` with
    positions from 0 on both axes, ``causal`` keeping q_pos ≥ k_pos and a
    ``window`` > 0 keeping q_pos − k_pos < window.  Differentiable: the
    backward recomputes through ``flash_attn_dense`` (no backward kernel,
    as in JAX).  ``block_q`` and ``block_k`` are the TPU's tiles; they are
    accepted and do not change the result (the kernel picks its own)."""
    window = int(window or 0)
    if _wants_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, scale, causal, window)
    return _flash_fwd(q, k, v, scale, causal, window)


# --------------------------------------------------------------------- #
# grouped GEMM                                                          #
# --------------------------------------------------------------------- #

def moe_gemm(x: torch.Tensor, w: torch.Tensor, block_expert_ids, *,
             block_t: int = 128, block_d: int = 512,
             block_f: int = 512) -> torch.Tensor:
    """Tokens-sorted-by-expert grouped GEMM in one kernel (JAX:
    ``ops.moe_gemm``): x (T, D), w (E, D, F) of one dtype, f32 or bf16,
    one expert id per run of ``block_t`` rows → y (T, F) in x's dtype,
    ``y[t] = x[t]·w[e(t)]`` summed in f32.  T must be block_t-aligned
    (capacity padding upstream); D and F are taken as they are (JAX pads
    them to its tiles).  Forward only, as in JAX.  ``block_d`` and
    ``block_f`` are the TPU's tiles; they are accepted and do not change
    the result.  Raises where autograd would record the call (grad mode
    on and ``x`` or ``w`` requiring grad), on either device: the kernel's
    output has no backward, so a gradient through it would silently be
    none.  Training takes JAX's einsum route (``nn.ffn._expert_ffn``)."""
    if _wants_grad(x, w):
        raise RuntimeError(
            "moe_gemm is forward only (no backward kernel, as in JAX): "
            "autograd would record this call with no gradient for x or w; "
            "call it under torch.no_grad() or inference_mode, or train "
            "through batched einsums (nn.ffn._expert_ffn)")
    ids = _as(block_expert_ids, x.device, torch.int32)
    if _on_card(x):
        return _moek.moe_gemm_cuda(x.contiguous(), w.contiguous(), ids,
                                   block_t=block_t)
    _moek.check_shapes(x, w, ids, block_t)
    _moek.launches += 1
    return _moek.moe_gemm_dense(x, w, ids, block_t=block_t)
