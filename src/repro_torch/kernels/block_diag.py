"""Ragged block-diagonal GEMM — the unfused mid-layer projection — forward
and weight gradient.

``block_diag_fwd_cuda`` launches ``csrc/block_diag.cu`` (entry
``block_diag_fwd_f32``, the port of the TPU kernel
``repro/kernels/block_diag.py::block_diag_fwd``): x (B, n_in_tiles·blk),
the identity-augmented tile array wb (n_param_blocks + 1, blk, blk) and a
layout's steps in CSR form (``fused_layer.csr_schedule``) → (B,
n_rows·blk) f32.  Fed dy, the per-member-transposed tiles
(``fused_layer.transposed_tiles``) and the transposed steps, the same
kernel is the backward's dh, as in the JAX package.  The kernel walks the
CSR by the groups of ``fwd_groups`` (``csrc/block_diag_core.cuh``, which
``fused_layer``'s forward shares): each group is a run of rows with the
same input tiles — a member's output tiles, or a run of pass-through
tiles — owned by one warp.

``block_diag_dw_cuda`` (entry ``block_diag_dw_f32``, the port of
``block_diag.py::block_diag_dw``): dy (B, n_out_tiles·blk), x and each
parameter tile's output and input tile → dWB (n_param_blocks, blk, blk).
The kernel walks the member-owned units of ``dw_units``
(``csrc/member_units.cuh``, the packing ``fused_layer``'s backward
shares): a member's rectangle of parameter tiles, or a chunk of its
columns, or one tile where the list traces no rectangle.

The bf16 compute policy (DESIGN.md §7; JAX's kernels on bf16 operands,
``repro/kernels/block_diag.py:75-79, :131-135``): bf16 x (dy) and tiles
launch the kernels' bf16 instances (entries ``block_diag_fwd_bf16``, the
group core's ``BF16W`` policy, and ``block_diag_dw_bf16``, the same member
units over bf16 loads): products and sums in f32, each output rounded once
to bf16 — dWB after its sum over the whole batch.  They count in
``bf16_fwd_launches`` and ``bf16_dw_launches``.

Each ``*_plain`` function is the same function in plain PyTorch, on f32 or
bf16 operands (widened: a product of two bf16 values is exact in f32; sums
in f32; the output rounded once to the operands' dtype).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.kernels import _build

# kernel launches (the CPU dispatch in ops counts its plain calls too):
fwd_launches = 0      # the forward, and the backward's dh
dw_launches = 0       # the weight gradient
bf16_fwd_launches = 0  # their bf16 instances (the compute policy)
bf16_dw_launches = 0
MAX_BLOCK = 128       # widest tile the kernels keep in shared memory
# the group core's shapes (csrc/block_diag_core.cuh; ``core_shapes`` reads
# them from the library): a lane's register tile covers LANE_COLS columns
# of one output tile, a warp's GROUP_COLS columns
GROUP_COLS, LANE_COLS = 32, 8
GROUP_INTS = 7        # row0, nr, u0, nu, L, diag, s0
# the member-owned units' packing, the stage shapes of
# csrc/member_units.cuh (``fused_layer.kernel_stages`` reads them from the
# library): a CTA's column chunk, the largest unit a warp takes, and the
# units of a warp job (one a warp)
TEAM_COLS = 64
WARP_OUT, WARP_COLS = 8, 16
WARP_JOB = 4
UNIT_INTS = 8         # in0, nc, out0, no, q, ld, warp, 0

_P, _I = ctypes.c_void_p, ctypes.c_int


def group_rows(blk: int) -> int:
    """The most CSR rows (output tiles) one group takes at block ``blk``:
    a lane's column groups never straddle two tiles, and a warp has
    GROUP_COLS // LANE_COLS of them."""
    per_row = -(-min(blk, GROUP_COLS) // LANE_COLS)
    return max(1, GROUP_COLS // LANE_COLS // per_row)


def _split(n: int, most: int) -> list[int]:
    """[0, n) in ⌈n / most⌉ near-equal chunks → their bounds."""
    k = -(-n // most)
    return [i * n // k for i in range(k + 1)]


def fwd_groups(rowptr, s_in, blk: int) -> np.ndarray:
    """The forward kernel's work from a CSR schedule (its ``rowptr`` and
    ``s_in``) → (n_groups, 7) int32, each row (row0, nr, u0, nu, L, diag,
    s0): CSR rows [row0, row0 + nr), each of L steps starting at s0 =
    rowptr[row0] (a row's steps in CSR order), their output units [u0, u0
    + nu).  The kernel reads each step's tiles from ``s_in`` and ``s_w``.

    A group is a run of consecutive rows with the same step count and the
    same ``s_in`` sequence (a member's output tiles over its input tiles;
    in the transposed schedule its input tiles over its output tiles), or,
    with ``diag`` 1, a run of one-step rows whose input tiles are
    consecutive (pass-through tiles: row row0 + r reads input tile
    s_in[s0 + r]).  Runs longer than ``group_rows(blk)`` rows split into
    near-equal chunks; at a block over GROUP_COLS a row splits into
    GROUP_COLS-unit chunks.  Every row lies in exactly one group (every
    unit of it in one chunk).  Groups come heaviest first (nr·nu·max(L, 1)
    FMA a batch row and unit of depth), so that the first wave of CTAs
    takes the largest."""
    rowptr = np.asarray(rowptr, np.int64)
    s_in = np.asarray(s_in, np.int64)
    lens = np.diff(rowptr)
    n = lens.size
    if n == 0:
        return np.zeros((0, GROUP_INTS), np.int32)
    # same[i]: row i has row i − 1's step count and input tiles
    row_of = np.repeat(np.arange(n), lens)
    prev = np.arange(s_in.size) - lens[row_of]
    diff = np.ones(s_in.size, bool)
    ok = (row_of > 0) & (prev >= 0)
    diff[ok] = s_in[ok] != s_in[prev[ok]]
    mism = np.bincount(row_of[diff], minlength=n)
    same = np.zeros(n, bool)
    same[1:] = (lens[1:] == lens[:-1]) & (mism[1:] == 0)
    # step[i]: rows i − 1 and i have one step each, on consecutive tiles
    first = np.full(n, -2)
    first[lens > 0] = s_in[rowptr[:-1][lens > 0]]
    step = np.zeros(n, bool)
    step[1:] = (lens[1:] == 1) & (lens[:-1] == 1) & (first[1:] == first[:-1]
                                                     + 1)
    same, step = same.tolist(), step.tolist()
    runs, i = [], 0
    while i < n:
        j = i + 1
        if j < n and same[j]:
            while j < n and same[j]:
                j += 1
            runs.append((i, j - i, 0))
        else:
            # a pass-through run stops before a row that opens a group of
            # its own
            while j < n and step[j] and not (j + 1 < n and same[j + 1]):
                j += 1
            runs.append((i, j - i, int(j - i > 1)))
        i = j
    cap = group_rows(blk)
    units = [(u0, min(GROUP_COLS, blk - u0))
             for u0 in range(0, blk, GROUP_COLS)]
    out = []
    for row0, nr, diag in runs:
        length = int(lens[row0])
        bounds = _split(nr, cap)
        for r0, r1 in zip(bounds[:-1], bounds[1:]):
            s0 = int(rowptr[row0 + r0])
            for u0, nu in units:
                out.append((row0 + r0, r1 - r0, u0, nu, length,
                            diag if r1 - r0 > 1 else 0, s0))
    arr = np.asarray(out, np.int64).reshape(-1, GROUP_INTS)
    weight = arr[:, 1] * arr[:, 3] * np.maximum(arr[:, 4], 1)
    return np.ascontiguousarray(arr[np.argsort(-weight, kind="stable")],
                                np.int32)


def _versions(*tensors) -> tuple[int, ...] | None:
    """The tensors' version counters, or None where one of them is an
    inference tensor (it keeps none)."""
    if any(t.is_inference() for t in tensors):
        return None
    return tuple(t._version for t in tensors)


def _keep(owner: torch.Tensor, attr: str, others, blk: int, value):
    """Keep ``value`` on ``owner`` as ``attr``, with what it was built
    from (``attr``_src: the value, ``others``, the block and the tensors'
    version counters) for ``_kept``."""
    setattr(owner, attr, value)
    setattr(owner, attr + "_src",
            (value, tuple(others), blk, _versions(owner, *others)))
    return value


def _kept(owner: torch.Tensor, attr: str, others, blk: int, build):
    """The value kept on ``owner`` as ``attr`` where it was built from
    ``owner`` and these very ``others`` at this block and none of them has
    changed since (their version counters), else ``build()``, kept now.
    Inference tensors keep no version counters: theirs is built at every
    call."""
    value = getattr(owner, attr, None)
    src = getattr(owner, attr + "_src", None)
    versions = _versions(owner, *others)
    if versions is None or src is None or src[0] is not value \
            or any(a is not b for a, b in zip(src[1], others)) \
            or src[2:] != (blk, versions):
        _device.table_builds += 1
        value = _keep(owner, attr, others, blk, build())
    return value


def _groups_table(rowptr, s_in, s_w, blk: int, arrs=None) -> torch.Tensor:
    """The group table of the CSR schedule (rowptr, s_in, s_w), built from
    its arrays ``arrs`` where the caller holds them, else from the CSR read
    back once, as an int32 tensor on ``rowptr``'s device carrying the input
    and weight tiles the CSR names (``bd_tiles``).  Raises on arrays that
    are not a CSR schedule."""
    if arrs is None:
        arrs = [a.cpu().numpy() for a in (rowptr, s_in, s_w)]
    rp, si, sw = (np.asarray(a, np.int64) for a in arrs)
    if rp.size == 0 or rp[0] != 0 or np.any(np.diff(rp) < 0) \
            or rp[-1] != si.size or sw.shape != si.shape \
            or si.min(initial=0) < 0 or sw.min(initial=0) < 0:
        raise ValueError("block_diag_fwd: not a CSR schedule")
    t = torch.from_numpy(fwd_groups(rp, si, blk)).to(rowptr.device)
    t.bd_tiles = (int(si.max(initial=-1)) + 1, int(sw.max(initial=-1)) + 1)
    return t


def stamp_groups(rowptr: torch.Tensor, s_in: torch.Tensor,
                 s_w: torch.Tensor, blk: int, arrs=None) -> torch.Tensor:
    """The CSR's group table (``_groups_table``), built now and kept on
    ``rowptr`` for ``groups_on``."""
    return _keep(rowptr, "bd_groups", (s_in, s_w), blk,
                 _groups_table(rowptr, s_in, s_w, blk, arrs))


def groups_on(rowptr, s_in, s_w, blk: int) -> torch.Tensor:
    """The group table of a CSR schedule: the one kept on ``rowptr``
    (``fused_layer.schedule_on`` keeps one there) where it was built from
    these very ``s_in`` and ``s_w`` at this block and none of the three has
    changed since, else one built now (``_kept``)."""
    return _kept(rowptr, "bd_groups", (s_in, s_w), blk,
                 lambda: _groups_table(rowptr, s_in, s_w, blk))


def checked_groups(where: str, x, wb, rowptr, s_in, s_w,
                   blk: int) -> torch.Tensor:
    """The group table a forward launch walks (``groups_on``); raises
    unless the tiles its CSR names lie inside x and wb: a schedule built
    for another layout would send the kernel past them."""
    t = groups_on(rowptr, s_in, s_w, blk)
    have = (x.shape[1] // blk, wb.shape[0])
    if any(r > h for r, h in zip(t.bd_tiles, have)):
        raise ValueError(f"{where}: the schedule names (input, weight) "
                         f"tiles {t.bd_tiles}, the tensors hold {have}: "
                         f"built for another layout")
    return t


def fwd_path(x, wb, y, g=None) -> str:
    """The instance a forward launch takes: ``"vec4"`` where the block is
    a multiple of 4, x, y (and g') start on a 16-byte boundary and the
    tiles wb on a 16-byte one, or int8 tiles on a 4-byte one (x and f32
    tiles come in 16-byte copies, int8 tiles 4 bytes a copy, a lane's
    outputs leave in 16-byte stores; under the bf16 policy x, the tiles, y
    and g' on 8-byte boundaries, 4 values a load or a store), else
    ``"scalar"``.  ``csrc/block_diag_core.cuh::launch_groups`` applies the
    same rule."""
    bf16 = x.dtype == torch.bfloat16
    align = 4 if wb.dtype == torch.int8 else 8 if bf16 else 16
    vec = wb.shape[-1] % 4 == 0 and wb.data_ptr() % align == 0 and all(
        t.data_ptr() % (8 if bf16 else 16) == 0
        for t in (x, y, g) if t is not None)
    return "vec4" if vec else "scalar"


def dw_path(dy, x, dwb) -> str:
    """The instance a ``block_diag_dw`` launch takes: ``"vec4"`` where the
    block is a multiple of 4 and dy, x and dWB start on a boundary of 4 of
    their elements (4 values a load of dy and x, a store of dWB: 16 bytes
    in f32, 8 under the bf16 policy), else ``"scalar"``.
    ``csrc/block_diag.cu``'s ``block_diag_dw_f32`` and
    ``block_diag_dw_bf16`` apply the same rule."""
    vec = dwb.shape[-1] % 4 == 0 and all(
        t.data_ptr() % (4 * t.element_size()) == 0 for t in (dy, x, dwb))
    return "vec4" if vec else "scalar"


def member_rects(out_tile, in_tile, strict: str | None = None
                 ) -> list[tuple[int, int, int, int, int]]:
    """Each parameter tile's output and input tile → the rectangles they
    trace, (q, o0, ob, i0, ib) each: tiles q .. q + ob·ib − 1, tile q + r·ib
    + c of output tile o0 + r and input tile i0 + c (a member of the
    layout, member-major).  Every tile lies in exactly one.  A run of tiles
    that starts like a rectangle but breaks off inside it is refused where
    ``strict`` names the caller, else its first tile is a 1 × 1 rectangle
    and the scan goes on from the next."""
    out_t = np.asarray(out_tile, np.int64)
    in_t = np.asarray(in_tile, np.int64)
    n, q, rects = out_t.size, 0, []
    while q < n:
        o0, i0 = out_t[q], in_t[q]
        ib = 1
        while q + ib < n and out_t[q + ib] == o0 and in_t[q + ib] == i0 + ib:
            ib += 1
        ob = 1
        while q + ob * ib < n and out_t[q + ob * ib] == o0 + ob \
                and in_t[q + ob * ib] == i0:
            ob += 1
        r, c = np.divmod(np.arange(ob * ib), ib)
        if not (np.array_equal(out_t[q:q + ob * ib], o0 + r)
                and np.array_equal(in_t[q:q + ob * ib], i0 + c)):
            if strict:
                raise ValueError(f"{strict}: parameter tiles are not "
                                 "member-major rectangles")
            ob = ib = 1
        rects.append((q, int(o0), ob, int(i0), ib))
        q += ob * ib
    return rects


def member_units(rects, blk: int) -> list[tuple[int, ...]]:
    """Rectangles (``member_rects``) → the units that own their tiles,
    (in0, nc, out0, no, q, ld, warp, 0) each: a rectangle, or a chunk of
    at most ``TEAM_COLS`` units of its input-tile columns (near-equal),
    tile (r, c) the parameter tile q + r·ld + c; ``warp`` = 1 where it fits
    a warp's stage (at most ``WARP_OUT`` output and ``WARP_COLS`` input
    units)."""
    per_unit = max(1, TEAM_COLS // blk)
    units = []
    for q, o0, ob, i0, ib in rects:
        bounds = _split(ib, per_unit)
        for c0, c1 in zip(bounds[:-1], bounds[1:]):
            warp = ob * blk <= WARP_OUT and (c1 - c0) * blk <= WARP_COLS
            units.append((i0 + c0, c1 - c0, o0, ob, q + c0, ib, int(warp),
                          0))
    return units


def pack_jobs(units) -> tuple[np.ndarray, np.ndarray]:
    """Units → (units (n_units, 8) int32 in job order, job_ptr (n_jobs +
    1,) int32): a job is a CTA, one whole-CTA unit (``warp`` 0) or up to
    ``WARP_JOB`` warp units.  The warp jobs come first, then the CTA jobs
    heaviest first: the short, latency-bound warp jobs run beside the
    first wave instead of in a tail of their own."""
    arr = np.asarray(units, np.int64).reshape(-1, UNIT_INTS)
    warp = np.flatnonzero(arr[:, 6] == 1)
    team = np.flatnonzero(arr[:, 6] == 0)
    team = team[np.argsort(-arr[team, 3] * arr[team, 1], kind="stable")]
    ptr = list(range(0, len(warp), WARP_JOB)) + list(
        range(len(warp), len(arr) + 1))
    return (np.ascontiguousarray(arr[np.concatenate([warp, team])],
                                 np.int32),
            np.asarray(ptr, np.int32))


def units_reach(units, job_ptr) -> tuple[int, int, int]:
    """The (input tiles, output tiles, parameter tiles) a units table
    touches: each count one past the highest index any unit reads or
    writes.  Raises on a table neither ``member_units`` nor
    ``fused_layer.dx_dw_units`` gives (a negative index or extent, jobs
    out of order or past the table)."""
    u = np.asarray(units, np.int64).reshape(-1, UNIT_INTS)
    ptr = np.asarray(job_ptr, np.int64)
    in0, nc, out0, no, q, ld = u[:, :6].T
    real = q >= 0
    if np.any(u[:, [0, 2]] < 0) or np.any(nc < 1) or np.any(no < 1) \
            or np.any(ld[real] < nc[real]) or np.any(~real & (no != nc)) \
            or ptr.size < 1 or ptr[0] < 0 or ptr[-1] > len(u) \
            or np.any(np.diff(ptr) < 0):
        raise ValueError("not a units table of member units "
                         "(block_diag.dw_units, fused_layer.dx_dw_units)")
    last_q = q + (no - 1) * ld + nc
    return (int((in0 + nc).max(initial=0)), int((out0 + no).max(initial=0)),
            int(last_q[real].max(initial=0)))


def dw_units(wb_out_tile, wb_in_tile, blk: int
             ) -> tuple[np.ndarray, np.ndarray]:
    """The ``block_diag_dw`` kernel's work from each parameter tile's
    output and input tile → (units (n_units, 8) int32, job_ptr (n_jobs +
    1,) int32): ``member_rects`` (consecutive tiles that trace a
    member-major rectangle form one, any other tile is one alone, so every
    tile list runs), cut into ``member_units`` and packed into jobs
    (``pack_jobs``).  Each parameter tile has exactly one unit."""
    return pack_jobs(member_units(member_rects(wb_out_tile, wb_in_tile),
                                  blk))


def dw_units_on(wb_out_tile, wb_in_tile, blk: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``dw_units`` as int32 tensors on ``wb_out_tile``'s device, kept on
    ``wb_out_tile`` and used again for this very ``wb_in_tile`` at this
    block while neither tensor has changed (``_kept``).  The units tensor
    carries its ``units_reach``."""
    def build():
        units, ptr = dw_units(wb_out_tile.cpu().numpy(),
                              wb_in_tile.cpu().numpy(), blk)
        t = tuple(torch.from_numpy(a).to(wb_out_tile.device)
                  for a in (units, ptr))
        t[0].bd_reach = units_reach(units, ptr)
        return t

    return _kept(wb_out_tile, "bd_dw_units", (wb_in_tile,), blk, build)


def checked_dw_units(dy, x, wb_out_tile, wb_in_tile, blk: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The units a ``block_diag_dw`` launch walks (``dw_units_on``); raises
    unless they stay inside x's input tiles, dy's output tiles and the
    n_param = len(wb_out_tile) tiles of dWB."""
    units, ptr = dw_units_on(wb_out_tile, wb_in_tile, blk)
    have = (x.shape[1] // blk, dy.shape[1] // blk, wb_out_tile.shape[0])
    if any(r > h for r, h in zip(units.bd_reach, have)):
        raise ValueError(f"block_diag_dw: the units reach (input, output, "
                         f"parameter) tiles {units.bd_reach}, the tensors "
                         f"hold {have}")
    return units, ptr


def unit_tiles(units):
    """Every tile a unit owns → (real, q, out tile, in tile), one entry per
    tile: a real unit's (r, c) rectangle (q = its parameter tile), a
    pass-through run's c-th tile (real False, q < 0)."""
    u = units.long()
    in0, nc, out0, no, q0, ld = u[:, :6].unbind(1)
    real = q0 >= 0
    n = torch.where(real, no * nc, nc)
    uid = torch.repeat_interleave(torch.arange(u.shape[0],
                                               device=u.device), n)
    start = torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
    k = torch.arange(uid.shape[0], device=u.device) - start
    rt = real[uid]
    r = torch.where(rt, k // nc[uid], k)
    c = torch.where(rt, k % nc[uid], k)
    return rt, q0[uid] + r * ld[uid] + c, out0[uid] + r, in0[uid] + c


def core_shapes() -> tuple[int, int]:
    """(GROUP_COLS, LANE_COLS) as the kernel's register tiles set them,
    read from its library."""
    out = (ctypes.c_int * 2)()
    _build.function("block_diag", "block_diag_core_shapes", [_P])(out)
    return tuple(out)


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
    """dWB[q] = Σ_b dy[:, wb_out_tile[q]]ᵀ · x[:, wb_in_tile[q]] → (n_param,
    blk, blk) in dy's dtype; products and sums in f32 (f64 for f64 inputs),
    rounded once, as JAX's kernel sums every batch tile into one f32
    accumulator."""
    b = dy.shape[0]
    acc = torch.promote_types(dy.dtype, torch.float32)
    return torch.einsum("bqr,bqc->qrc",
                        dy.to(acc).reshape(b, -1, blk)[:, wb_out_tile.long()],
                        x.to(acc).reshape(b, -1, blk)[:, wb_in_tile.long()]
                        ).to(dy.dtype)


def _check_block(where: str, blk: int):
    if not 1 <= blk <= MAX_BLOCK:
        raise ValueError(f"{where}: block {blk} outside the kernel's "
                         f"[1, {MAX_BLOCK}]")


def block_diag_fwd_cuda(x, wb, rowptr, s_in, s_w, *, blk: int):
    """One launch → (B, n_rows·blk) in x's dtype, n_rows = len(rowptr) −
    1, walking the CSR's group table (``groups_on``); x and wb f32, or both
    bf16."""
    suffix = _build.operand_suffix("block_diag_fwd", x)
    _build.check_tensors(
        "block_diag_fwd", x,
        ("x", x, x.dtype),
        ("wb", wb, x.dtype),
        ("rowptr", rowptr, torch.int32),
        ("s_in", s_in, torch.int32),
        ("s_w", s_w, torch.int32))
    _check_block("block_diag_fwd", blk)
    if x.dim() != 2 or x.shape[1] % blk or wb.shape[1:] != (blk, blk) \
            or s_in.shape != s_w.shape:
        raise ValueError("block_diag_fwd: inconsistent shapes")
    groups = checked_groups("block_diag_fwd", x, wb, rowptr, s_in, s_w, blk)
    b, n_rows = x.shape[0], rowptr.shape[0] - 1
    fn = _build.function("block_diag", "block_diag_fwd_" + suffix,
                         [_P] * 6 + [_I] * 5 + [_P])
    y = torch.empty(b, n_rows * blk, device=x.device, dtype=x.dtype)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), wb.data_ptr(), s_in.data_ptr(),
                s_w.data_ptr(), groups.data_ptr(), y.data_ptr(),
                b, x.shape[1] // blk, n_rows, blk, groups.shape[0],
                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "block_diag_fwd")
    _build.count(globals(), "fwd_launches", x.dtype)
    return y


def block_diag_dw_cuda(dy, x, wb_out_tile, wb_in_tile, *, blk: int):
    """One launch → dWB (n_param, blk, blk) in dy's dtype, n_param =
    len(wb_out_tile), walking the tiles' member-owned units
    (``checked_dw_units``); dy and x f32, or both bf16."""
    suffix = _build.operand_suffix("block_diag_dw", dy)
    _build.check_tensors(
        "block_diag_dw", dy,
        ("dy", dy, dy.dtype),
        ("x", x, dy.dtype),
        ("wb_out_tile", wb_out_tile, torch.int32),
        ("wb_in_tile", wb_in_tile, torch.int32))
    _check_block("block_diag_dw", blk)
    n_param = wb_out_tile.shape[0]
    if dy.dim() != 2 or x.dim() != 2 or dy.shape[0] != x.shape[0] \
            or dy.shape[1] % blk or x.shape[1] % blk \
            or wb_in_tile.shape != (n_param,):
        raise ValueError("block_diag_dw: inconsistent shapes")
    units, ptr = checked_dw_units(dy, x, wb_out_tile, wb_in_tile, blk)
    fn = _build.function("block_diag", "block_diag_dw_" + suffix,
                         [_P] * 5 + [_I] * 5 + [_P])
    dwb = torch.empty(n_param, blk, blk, device=dy.device, dtype=dy.dtype)
    with torch.cuda.device(dy.device):
        rc = fn(dy.data_ptr(), x.data_ptr(), units.data_ptr(),
                ptr.data_ptr(), dwb.data_ptr(), dy.shape[0],
                dy.shape[1] // blk, x.shape[1] // blk, blk,
                ptr.shape[0] - 1, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "block_diag_dw")
    _build.count(globals(), "dw_launches", dy.dtype)
    return dwb
