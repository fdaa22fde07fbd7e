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
variant also g' of the same shape.  The product is the unfused forward's
(``csrc/block_diag_core.cuh``, walking ``block_diag.fwd_groups``; the
instance by ``block_diag.fwd_path``), with this layer's epilogue.

Int8 serving: ``fused_layer_int8_cuda`` launches the same core under its
int8 weight policy over the int8 serve copy (entry
``fused_layer_infer_i8``; the port of
``fused_layer.py::fused_layer_int8_fwd``): the packer's identity-augmented
int8 tile array and one f32 scale per tile, 1.0 for the identity, each
weight formed as q·scale; the instance by ``block_diag.fwd_path`` of the
int8 tiles.  Under the bf16 compute policy x is bf16 (entry
``fused_layer_infer_i8_bf16``: the core's ``I8BW`` policy, I8W's tiles and
landing pass with x widened as it is staged): y comes back bf16, rounded
once; it counts in ``bf16_int8_launches``.

Backward: ``fused_layer_dx_dw_cuda`` launches ``csrc/fused_layer_dx_dw.cu``
(the port of ``fused_layer.py::fused_layer_dx_dw``): from dy and g', x, the
parameter tiles wb (n_param_blocks, blk, blk) as the forward reads them
(member-major, no identity tile) and the layout's work units and jobs
(``dx_dw_units``, cached per device by ``dx_dw_schedule_on``; the
member units and job packing of ``block_diag.member_units`` /
``pack_jobs``, which the unfused dW shares) it returns dx (B,
n_in_tiles·blk) and dWB (n_param_blocks, blk, blk), member by member.  ``transposed_tiles`` (the JAX package's per-member-transposed
tiles) feeds the unfused route's dh.

The bf16 compute policy (DESIGN.md §7): bf16 x and tiles (b_eff, mask
f32) launch the same cores' bf16 instances (entries
``fused_layer_infer_bf16`` / ``fused_layer_train_bf16``: the group core's
``BF16W`` policy widens x and the tiles as it stages them, y and g' leave
rounded once to bf16; ``fused_layer_dx_dw_bf16``: du = dy·g' rounded to
bf16, dx and dWB rounded once from their f32 sums).  They count in
``bf16_launches`` and ``bf16_dx_dw_launches``.

Each ``*_plain`` function is the same function in plain PyTorch, on f32 or
bf16 operands (widened, summed in f32, rounded where the kernels round).

The TPU kernels walk the flat ``BlockDiagLayout`` steps in order on a
sequential grid axis.  Each output tile's steps are consecutive there, so
the port turns them into CSR rows once per layout: ``rowptr[o]`` ..
``rowptr[o + 1]`` are output tile o's steps, which one owner walks
privately, in order (the f32 forward: a warp owning the group of rows of
one member, ``block_diag.fwd_groups``).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.activations import (apply_activation_derivs_masked,
                                          apply_activations_masked)
from repro_torch.kernels import _build
from repro_torch.kernels.block_diag import (
    TEAM_COLS, _split, block_diag_fwd_plain, checked_groups, member_rects,
    member_units, pack_jobs, stamp_groups, unit_tiles, units_reach)

# kernel launches (the CPU dispatch in ops counts its plain calls too):
launches = 0          # the forward, with or without g'
int8_launches = 0     # the forward over int8 tiles
dx_dw_launches = 0    # the backward
bf16_launches = 0     # the forward's bf16 instance (the compute policy)
bf16_dx_dw_launches = 0  # the backward's bf16 instance
bf16_int8_launches = 0  # int8 tiles, bf16 activations (the compute policy)
MAX_BLOCK = 128       # widest tile the kernel keeps in shared memory
DX_DW_BATCH_CHUNK = 32   # member_units.cuh's BCH: the backward's rows a pass

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
    (layout, device, direction) and kept on the layout instance, its
    ``rowptr`` carrying the forward kernel's group table
    (``block_diag.stamp_groups``) for the wrappers.  The
    transposed schedule also carries ``perm_t``, ``wb_out_tile`` and
    ``wb_in_tile``.  They are ordinary tensors even under
    ``torch.inference_mode``, so that their table is kept there too."""
    cache = layout.__dict__.setdefault("_csr_cache", {})
    key = (str(torch.device(device)), transposed)
    if key not in cache:
        _device.table_builds += 1
        arrs = csr = csr_schedule(layout, transposed)
        if transposed:
            arrs += tuple(np.asarray(a, np.int32) for a in (
                layout.perm_t, layout.wb_out_tile, layout.wb_in_tile))
        with torch.inference_mode(False):
            cache[key] = tuple(torch.from_numpy(np.ascontiguousarray(a))
                               .to(device) for a in arrs)
        stamp_groups(*cache[key][:3], layout.block, arrs=csr)
    return cache[key]


def transposed_tiles(wb_aug: torch.Tensor, perm_t: torch.Tensor
                     ) -> torch.Tensor:
    """The backward's weight tiles, as the JAX package builds them
    (``ops._bd_transposed_tiles``): the identity-augmented tile array
    permuted into transposed step order, each tile transposed."""
    return wb_aug[perm_t.long()].transpose(1, 2).contiguous()


def dx_dw_units(layout) -> tuple[np.ndarray, np.ndarray]:
    """The backward kernel's work from a ``BlockDiagLayout`` → (units
    (n_units, 8) int32, job_ptr (n_jobs + 1,) int32).

    A unit is (in0, nc, out0, no, q, ld, warp, 0): dx input tiles
    [in0, in0 + nc) from output tiles [out0, out0 + no) of one member, its
    tile (r, c) the parameter tile q + r·ld + c — a real member, or a
    chunk of at most ``TEAM_COLS`` units of its input-tile columns — or,
    with q = −1, a pass-through run (dx tile in0 + k = du tile out0 + k,
    no = nc).  Each dx column and each parameter tile has exactly one unit.
    Real members are the rectangles ``wb_out_tile``/``wb_in_tile`` trace
    (tile q = base + r·ib + c), pass-through runs the transposed steps
    through the identity tile.

    Jobs are CTAs: a real unit wider than ``WARP_OUT`` output or
    ``WARP_COLS`` input units takes one CTA; the others and the
    pass-through runs (a copy) go one a warp, ``WARP_JOB`` to a CTA
    (``warp`` = 1).  The warp jobs come first, then the CTA jobs heaviest
    first: the short, latency-bound warp jobs run beside the first wave
    instead of in a tail of their own."""
    blk = layout.block
    units = member_units(member_rects(layout.wb_out_tile, layout.wb_in_tile,
                                      strict="fused_layer_dx_dw"), blk)
    per_unit = max(1, TEAM_COLS // blk)
    ident = np.asarray(layout.s_w_t, np.int64) == layout.n_param_blocks
    t_dx = np.asarray(layout.s_out_t, np.int64)[ident]
    t_du = np.asarray(layout.s_in_t, np.int64)[ident]
    cut = np.flatnonzero((np.diff(t_dx) != 1) | (np.diff(t_du) != 1)) + 1
    for run_dx, run_du in zip(np.split(t_dx, cut), np.split(t_du, cut)):
        bounds = _split(len(run_dx), per_unit) if len(run_dx) else [0]
        for c0, c1 in zip(bounds[:-1], bounds[1:]):
            units.append((run_dx[c0], c1 - c0, run_du[c0], c1 - c0, -1, 0,
                          1, 0))
    return pack_jobs(units)


def dx_dw_schedule_on(layout, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``dx_dw_units`` as int32 tensors on ``device``, built once per
    (layout, device) and kept on the layout instance; the units tensor
    carries its ``units_reach`` for the wrapper's check."""
    cache = layout.__dict__.setdefault("_csr_cache", {})
    key = (str(torch.device(device)), "dx_dw")
    if key not in cache:
        _device.table_builds += 1
        units, ptr = dx_dw_units(layout)
        cache[key] = tuple(torch.from_numpy(a).to(device)
                           for a in (units, ptr))
        cache[key][0].dx_dw_reach = units_reach(units, ptr)
    return cache[key]


def check_reach(units, job_ptr, x, dy, wb, *, blk: int):
    """Raise unless the units stay inside x's input tiles, dy's output
    tiles and wb's parameter tiles: a table built for another layout would
    send the kernel past them.  A table from ``dx_dw_schedule_on`` carries
    its reach; any other is read back once and stamped."""
    reach = getattr(units, "dx_dw_reach", None)
    if reach is None:
        reach = units_reach(units.cpu().numpy(), job_ptr.cpu().numpy())
        units.dx_dw_reach = reach
    have = (x.shape[1] // blk, dy.shape[1] // blk, wb.shape[0])
    if any(r > h for r, h in zip(reach, have)):
        raise ValueError(f"fused_layer_dx_dw: the units reach (input, "
                         f"output, parameter) tiles {reach}, the tensors "
                         f"hold {have}: built for another layout")


def kernel_stages() -> tuple[int, int, int, int]:
    """(``TEAM_COLS``, ``WARP_OUT``, ``WARP_COLS``, ``WARP_JOB``) as the
    kernel's stage shapes set them, read from its library."""
    out = (ctypes.c_int * 4)()
    _build.function("fused_layer_dx_dw", "fused_layer_dx_dw_stages",
                    [_P])(out)
    return tuple(out)


def _z(x, wb, b_eff, rowptr, s_in, s_w, blk):
    """The projection plus the bias in f32 (f64 for f64 operands)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    return block_diag_fwd_plain(x.to(acc), wb.to(acc), rowptr, s_in, s_w,
                                blk=blk) + b_eff


def fused_layer_plain(x, wb, b_eff, mask, tile_act, rowptr, s_in, s_w, *,
                      blk: int):
    """→ y in x's dtype."""
    z = _z(x, wb, b_eff, rowptr, s_in, s_w, blk)
    return (apply_activations_masked(z, tile_act.repeat_interleave(blk))
            * mask).to(x.dtype)


def fused_layer_int8_plain(x, wb_q, wb_scale, b_eff, mask, tile_act, rowptr,
                           s_in, s_w, *, blk: int):
    """Dequantize every tile (q·s, f32), then ``fused_layer_plain``: y in
    x's dtype (f32, or bf16 rounded once)."""
    wb = wb_q.to(torch.float32) * wb_scale[:, None, None]
    return fused_layer_plain(x, wb, b_eff, mask, tile_act, rowptr, s_in, s_w,
                             blk=blk)


def fused_layer_train_plain(x, wb, b_eff, mask, tile_act, rowptr, s_in, s_w,
                            *, blk: int):
    """→ (y, g'), both (B, n_out_tiles·blk) in x's dtype."""
    z = _z(x, wb, b_eff, rowptr, s_in, s_w, blk)
    cols = tile_act.repeat_interleave(blk)
    return ((apply_activations_masked(z, cols) * mask).to(x.dtype),
            (apply_activation_derivs_masked(z, cols) * mask).to(x.dtype))


def fused_layer_dx_dw_plain(dy, g, x, wb, units, job_ptr, *, blk: int):
    """→ (dx (B, n_in_tiles·blk), dWB (n_param_blocks, blk, blk)), du =
    dy·g': each real tile (r, c) of a unit adds du_r·W_rc to dx_c and owns
    dW_rc = du_rᵀ·x_c; a pass-through tile copies du into dx.  ``job_ptr``
    (the kernel's packing) does not change the function.  dx and dWB come
    in dy's dtype; bf16 operands give a bf16 du (then widened)."""
    b = dy.shape[0]
    acc = torch.promote_types(dy.dtype, torch.float32)
    du = (dy * g).to(acc).reshape(b, -1, blk)
    xt = x.to(acc).reshape(b, -1, blk)
    rt, q, o_t, i_t = unit_tiles(units)
    dx = torch.zeros_like(xt)
    du_r = du[:, o_t[rt]]
    dx.index_add_(1, i_t[rt],
                  torch.einsum("bsr,src->bsc", du_r, wb[q[rt]].to(acc)))
    dx[:, i_t[~rt]] = du[:, o_t[~rt]]
    dwb = torch.zeros(wb.shape, dtype=acc, device=wb.device)
    dwb[q[rt]] = torch.einsum("bsr,bsc->src", du_r, xt[:, i_t[rt]])
    return dx.reshape(b, -1).to(dy.dtype), dwb.to(dy.dtype)


def _fwd_args(x, wb, b_eff, mask, tile_act, rowptr, s_in, s_w, blk,
              w_dtype=None):
    n_out = rowptr.shape[0] - 1
    _build.operand_suffix("fused_layer", x)
    _build.check_tensors(
        "fused_layer", x,
        ("x", x, x.dtype),
        ("wb", wb, x.dtype if w_dtype is None else w_dtype),
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
    """One launch → y (B, n_out_tiles·blk) in x's dtype, walking the CSR's
    group table (``block_diag.groups_on``)."""
    b, n_out = _fwd_args(x, wb, b_eff, mask, tile_act, rowptr, s_in, s_w,
                         blk)
    groups = checked_groups("fused_layer", x, wb, rowptr, s_in, s_w, blk)
    fn = _build.function(
        "fused_layer",
        "fused_layer_infer_" + _build.operand_suffix("fused_layer", x),
        [_P] * 9 + [_I] * 5 + [_P])
    y = torch.empty(b, n_out * blk, device=x.device, dtype=x.dtype)
    with torch.cuda.device(x.device):
        rc = fn(*_ptrs(x, wb, b_eff, mask, tile_act, s_in, s_w, groups, y),
                b, x.shape[1] // blk, n_out, blk, groups.shape[0],
                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "fused_layer")
    _build.count(globals(), "launches", x.dtype)
    return y


def fused_layer_train_cuda(x, wb, b_eff, mask, tile_act, rowptr, s_in, s_w,
                           *, blk: int):
    """The training forward: one launch → (y, g') in x's dtype."""
    b, n_out = _fwd_args(x, wb, b_eff, mask, tile_act, rowptr, s_in, s_w,
                         blk)
    groups = checked_groups("fused_layer", x, wb, rowptr, s_in, s_w, blk)
    fn = _build.function(
        "fused_layer",
        "fused_layer_train_" + _build.operand_suffix("fused_layer", x),
        [_P] * 10 + [_I] * 5 + [_P])
    y = torch.empty(b, n_out * blk, device=x.device, dtype=x.dtype)
    g = torch.empty_like(y)
    with torch.cuda.device(x.device):
        rc = fn(*_ptrs(x, wb, b_eff, mask, tile_act, s_in, s_w, groups, y,
                       g),
                b, x.shape[1] // blk, n_out, blk, groups.shape[0],
                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "fused_layer_train")
    _build.count(globals(), "launches", x.dtype)
    return y, g


def fused_layer_int8_cuda(x, wb_q, wb_scale, b_eff, mask, tile_act, rowptr,
                          s_in, s_w, *, blk: int):
    """One launch → y (B, n_out_tiles·blk) in x's dtype (f32, or bf16
    under the compute policy) over int8 tiles, walking the CSR's group
    table (``block_diag.groups_on``)."""
    b, n_out = _fwd_args(x, wb_q, b_eff, mask, tile_act, rowptr, s_in, s_w,
                         blk, w_dtype=torch.int8)
    suffix = _build.operand_suffix("fused_layer_int8", x)
    _build.check_tensors("fused_layer_int8", x,
                         ("wb_scale", wb_scale, torch.float32))
    if wb_scale.shape != (wb_q.shape[0],):
        raise ValueError("fused_layer_int8: one scale per tile")
    groups = checked_groups("fused_layer_int8", x, wb_q, rowptr, s_in, s_w,
                            blk)
    fn = _build.function(
        "fused_layer",
        "fused_layer_infer_i8" + ("_bf16" if suffix == "bf16" else ""),
        [_P] * 10 + [_I] * 5 + [_P])
    y = torch.empty(b, n_out * blk, device=x.device, dtype=x.dtype)
    with torch.cuda.device(x.device):
        rc = fn(*_ptrs(x, wb_q, wb_scale, b_eff, mask, tile_act, s_in, s_w,
                       groups, y),
                b, x.shape[1] // blk, n_out, blk, groups.shape[0],
                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "fused_layer_int8")
    _build.count(globals(), "int8_launches", x.dtype)
    return y


def fused_layer_dx_dw_cuda(dy, g, x, wb, units, job_ptr, *, blk: int):
    """One launch → (dx (B, n_in_tiles·blk), dWB (n_param, blk, blk)) in
    dy's dtype; a bf16 dWB past one 32-row batch chunk sums in an f32
    scratch allocated here."""
    b = dy.shape[0]
    bf16 = _build.operand_suffix("fused_layer_dx_dw", dy) == "bf16"
    _build.check_tensors(
        "fused_layer_dx_dw", dy,
        ("dy", dy, dy.dtype),
        ("g", g, dy.dtype),
        ("x", x, dy.dtype),
        ("wb", wb, dy.dtype),
        ("units", units, torch.int32),
        ("job_ptr", job_ptr, torch.int32))
    _check_block(blk)
    if g.shape != dy.shape or dy.dim() != 2 or dy.shape[1] % blk \
            or x.dim() != 2 or x.shape[0] != b or x.shape[1] % blk \
            or wb.dim() != 3 or wb.shape[1:] != (blk, blk) \
            or units.dim() != 2 or units.shape[1] != 8 \
            or job_ptr.dim() != 1:
        raise ValueError("fused_layer_dx_dw: inconsistent shapes")
    check_reach(units, job_ptr, x, dy, wb, blk=blk)
    dx = torch.empty_like(x)
    dwb = torch.empty_like(wb)
    if bf16:
        fn = _build.function("fused_layer_dx_dw", "fused_layer_dx_dw_bf16",
                             [_P] * 9 + [_I] * 5 + [_P])
        dws = (torch.empty(wb.shape, device=dy.device, dtype=torch.float32)
               if b > DX_DW_BATCH_CHUNK else None)
        outs = (*_ptrs(dx, dwb), None if dws is None else dws.data_ptr())
    else:
        fn = _build.function("fused_layer_dx_dw", "fused_layer_dx_dw_f32",
                             [_P] * 8 + [_I] * 5 + [_P])
        outs = _ptrs(dx, dwb)
    with torch.cuda.device(dy.device):
        rc = fn(*_ptrs(dy, g, x, wb, units, job_ptr), *outs,
                b, x.shape[1] // blk, dy.shape[1] // blk, blk,
                job_ptr.shape[0] - 1,
                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "fused_layer_dx_dw")
    _build.count(globals(), "dx_dw_launches", dy.dtype)
    return dx, dwb
