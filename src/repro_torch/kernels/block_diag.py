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

Each ``*_plain`` function is the same function in plain PyTorch.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

# kernel launches (the CPU dispatch in ops counts its plain calls too):
fwd_launches = 0      # the forward, and the backward's dh
dw_launches = 0       # the weight gradient
MAX_BLOCK = 128       # widest tile the kernels keep in shared memory
# the group core's shapes (csrc/block_diag_core.cuh; ``core_shapes`` reads
# them from the library): a lane's register tile covers LANE_COLS columns
# of one output tile, a warp's GROUP_COLS columns
GROUP_COLS, LANE_COLS = 32, 8
GROUP_INTS = 7        # row0, nr, u0, nu, L, diag, s0

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


def stamp_groups(rowptr: torch.Tensor, s_in: torch.Tensor,
                 s_w: torch.Tensor, blk: int, arrs=None) -> torch.Tensor:
    """The group table of the CSR schedule (rowptr, s_in, s_w) — built from
    its arrays ``arrs`` where the caller holds them, else from the CSR read
    back once — as an int32 tensor on ``rowptr``'s device, kept on
    ``rowptr`` for ``groups_on`` with what it was built from and the input
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
    t.bd_src = (s_in, s_w, blk, _versions(rowptr, s_in, s_w))
    rowptr.bd_groups = t
    return t


def groups_on(rowptr, s_in, s_w, blk: int) -> torch.Tensor:
    """The group table of a CSR schedule: the one kept on ``rowptr``
    (``fused_layer.schedule_on`` keeps one there) where it was built from
    these very ``s_in`` and ``s_w`` at this block and none of the three has
    changed since, else one built now (``stamp_groups``).  A CSR of
    inference tensors keeps no version counters, so that its table is
    built at every call."""
    t = getattr(rowptr, "bd_groups", None)
    src = getattr(t, "bd_src", None)
    versions = _versions(rowptr, s_in, s_w)
    if versions is None or src is None or src[0] is not s_in \
            or src[1] is not s_w or src[2:] != (blk, versions):
        t = stamp_groups(rowptr, s_in, s_w, blk)
    return t


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
    a multiple of 4 and x, wb, y (and g') start on a 16-byte boundary (x
    and the tiles come in 16-byte copies, a lane's outputs leave in
    16-byte stores), else ``"scalar"``.  ``csrc/block_diag_core.cuh::
    launch_groups`` applies the same rule."""
    vec = wb.shape[-1] % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x, wb, y, g) if t is not None)
    return "vec4" if vec else "scalar"


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
    """One launch → (B, n_rows·blk), n_rows = len(rowptr) − 1, walking
    the CSR's group table (``groups_on``)."""
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
    groups = checked_groups("block_diag_fwd", x, wb, rowptr, s_in, s_w, blk)
    b, n_rows = x.shape[0], rowptr.shape[0] - 1
    fn = _build.function("block_diag", "block_diag_fwd_f32",
                         [_P] * 6 + [_I] * 5 + [_P])
    y = torch.empty(b, n_rows * blk, device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), wb.data_ptr(), s_in.data_ptr(),
                s_w.data_ptr(), groups.data_ptr(), y.data_ptr(),
                b, x.shape[1] // blk, n_rows, blk, groups.shape[0],
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
