"""The mid layer forward's group table (``block_diag.fwd_groups``) and its
host rules, on the CPU: each output tile in exactly one group, a group's
rows reading the same input tiles (or a run of pass-through tiles), steps
in CSR order, wide members split; the table kept for the CSR tensors it
was built from, and the tiles its CSR names refusing another layout's
tensors; and ``fwd_path`` (f32 and int8 tiles) and ``dw_path``, the
vec4 / scalar rules the C entries apply.  The kernel itself runs only on the card
(tests/test_torch_kernels.py); the plain version it is held to is held to
the JAX package's kernel in tests/test_torch_unfused.py.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.activations import ACTIVATION_ORDER
from repro_torch.core.population import LayeredPopulation
from repro_torch.kernels import block_diag as bdk
from repro_torch.kernels import fused_layer as flk

# the GPU tests' mid-layer layouts (_TRAIN_GRID and the forward's extra
# shapes), and the depth-3 population's widths, cut to 40 repeats
_LAYOUTS = [
    (((24,), (13, 5), (17, 9), (32, 16, 8)), 8),
    (((5, 3), (12, 9), (7,), (17, 9, 5), (8, 8), (5, 3), (3, 11, 2),
      (24, 16), (4,), (9, 9, 9)), 8),
    (((40, 20), (17, 33, 9), (7,)), 16),
    (((200, 130), (64, 100), (7,)), 128),
    (((512, 384), (13, 5), (7,)), 8),
    (((24,), (13, 5), (17, 9), (32, 16, 8)), 6),
    (((40, 20), (17, 33, 9), (7,)), 5),
    (((64, 32, 16), (13, 5), (7,)) * 40, 8),
]


def _population(widths, block):
    acts = tuple(ACTIVATION_ORDER[i % 10] for i in range(len(widths)))
    return LayeredPopulation(5, 3, widths, acts, block=block)


def _schedules(widths, block):
    """Every (layout, transposed, (rowptr, s_in, s_w)) of the mid layers."""
    lp = _population(widths, block)
    for l in range(lp.depth - 1):
        lay = lp.bd_layout(l)
        for transposed in (False, True):
            yield lay, transposed, flk.csr_schedule(lay, transposed)


@pytest.mark.parametrize("widths,block", _LAYOUTS)
def test_fwd_groups_cover_each_output_tile_once(widths, block):
    """Every unit of every CSR row lies in exactly one group; a group's
    rows are consecutive, of its L steps each from s0 on, in CSR order;
    diag 0: the rows read the same input tiles, diag 1: one step each on
    consecutive input tiles; no group wider than a warp's register tile;
    heaviest first."""
    for lay, transposed, (rowptr, s_in, s_w) in _schedules(widths, block):
        groups = bdk.fwd_groups(rowptr, s_in, block)
        n_rows = len(rowptr) - 1
        cover = np.zeros((n_rows, block), int)
        for row0, nr, u0, nu, length, diag, s0 in groups:
            assert nr >= 1 and 1 <= nu <= bdk.GROUP_COLS
            assert nr * -(-nu // bdk.LANE_COLS) \
                <= bdk.GROUP_COLS // bdk.LANE_COLS
            assert nr <= bdk.group_rows(block)
            cover[row0:row0 + nr, u0:u0 + nu] += 1
            rows = np.arange(row0, row0 + nr)
            np.testing.assert_array_equal(rowptr[rows], s0 + length *
                                          np.arange(nr))
            np.testing.assert_array_equal(rowptr[rows + 1] - rowptr[rows],
                                          length)
            ins = s_in[s0:s0 + nr * length].reshape(nr, length)
            if diag:
                assert length == 1 and nr > 1
                np.testing.assert_array_equal(ins[:, 0],
                                              ins[0, 0] + np.arange(nr))
            else:
                np.testing.assert_array_equal(ins, ins[:1].repeat(nr, 0))
        np.testing.assert_array_equal(cover, 1)
        weight = groups[:, 1] * groups[:, 3] * np.maximum(groups[:, 4], 1)
        assert np.all(np.diff(weight) <= 0)


def _group_product(x, wb, s_in, s_w, groups, blk):
    """The forward as the kernel walks it, in numpy (f64): each group's
    rows over their steps (diag: row r's own input tile; else every row
    the first row's input tiles), units by unit chunk, the tiles read from
    s_in and s_w."""
    b = x.shape[0]
    xt = x.reshape(b, -1, blk)
    y = np.full((b, int((groups[:, 0] + groups[:, 1]).max()), blk), np.nan)
    for row0, nr, u0, nu, length, diag, s0 in groups:
        for r in range(nr):
            acc = np.zeros((b, nu))
            for j in range(length):
                tile_in = s_in[s0 + (r if diag else j)]
                tile_w = s_w[s0 + r * length + j]
                acc += xt[:, tile_in] @ wb[tile_w, u0:u0 + nu].T
            y[:, row0 + r, u0:u0 + nu] = acc
    return y.reshape(b, -1)


def _check_walk(rowptr, s_in, s_w, n_in, n_tiles, block, rng):
    x = rng.normal(0, 1, (3, n_in * block))
    wb = rng.normal(0, 1, (n_tiles, block, block))
    wb[-1] = np.eye(block)
    groups = bdk.fwd_groups(rowptr, s_in, block)
    want = bdk.block_diag_fwd_plain(
        torch.from_numpy(x), torch.from_numpy(wb),
        *(torch.from_numpy(a) for a in (rowptr, s_in, s_w)), blk=block)
    np.testing.assert_allclose(
        _group_product(x, wb, s_in, s_w, groups, block), want.numpy(),
        rtol=1e-12, atol=1e-12)
    return groups


@pytest.mark.parametrize("widths,block", _LAYOUTS[:4] + _LAYOUTS[5:7])
def test_group_walk_is_the_forward(widths, block):
    """Walking the groups as the kernel does gives the plain version's
    forward and dh (pass-through members through the identity tile)."""
    rng = np.random.default_rng(block)
    for lay, transposed, (rowptr, s_in, s_w) in _schedules(widths, block):
        n_in = lay.n_out_tiles if transposed else lay.n_in_tiles
        _check_walk(rowptr, s_in, s_w, n_in, lay.n_param_blocks + 1, block,
                    rng)


@pytest.mark.parametrize("block", [8, 5])
def test_group_walk_reads_the_indices_of_a_general_csr(block):
    """A CSR whose tiles follow no rule of a layout (its weight tiles
    renumbered at random, and one member's input tiles reversed in its
    first row): walking its groups, reading s_in and s_w, gives the same
    forward."""
    rng = np.random.default_rng(3)
    lay = _population(_LAYOUTS[0][0], block).bd_layout(0)
    rowptr, s_in, s_w = flk.csr_schedule(lay)
    renumber = rng.permutation(lay.n_param_blocks + 1)
    s_w = renumber[s_w].astype(np.int32)
    s_in = s_in.copy()
    s_in[rowptr[0]:rowptr[1]] = s_in[rowptr[0]:rowptr[1]][::-1]
    _check_walk(rowptr, s_in, s_w, lay.n_in_tiles, lay.n_param_blocks + 1,
                block, rng)


@pytest.mark.parametrize("widths,block,member_rows", [
    (((512, 384), (13, 5), (7,)), 8, 48),     # 48 output tiles
    (((200, 130), (64, 100), (7,)), 128, 2),  # 2 output tiles of 128
])
def test_fwd_groups_split_wide_members(widths, block, member_rows):
    """A member wider than a warp's register tile splits: at block 8 into
    groups of at most 4 output tiles (near-equal), at block 128 each
    output tile into 32-unit chunks; the chunks of one member share its
    input tiles."""
    lay = _population(widths, block).bd_layout(0)
    rowptr, s_in, s_w = flk.csr_schedule(lay)
    groups = bdk.fwd_groups(rowptr, s_in, block)
    first = groups[groups[:, 0] < member_rows]
    assert first[:, 0].min() == 0 \
        and (first[:, 0] + first[:, 1]).max() == member_rows
    if block == 8:
        assert len(first) == member_rows // 4
        assert set(first[:, 1].tolist()) == {4}
    else:
        assert sorted(first[:, 2].tolist()) == sorted([0, 32, 64, 96] * 2)
        assert set(first[:, 1].tolist()) == {1}
    ins = {tuple(s_in[s0:s0 + length].tolist())
           for length, s0 in first[:, [4, 6]]}
    assert len(ins) == 1


def test_depth3_layer0_groups_are_members():
    """The depth-3 population's first mid layer (members 64→32, 13→5 and
    pass-through 7, block 8): one group a member, every pass-through run
    one diag group or a single row."""
    lay = _population(((64, 32, 16), (13, 5), (7,)) * 40, 8).bd_layout(0)
    rowptr, s_in, s_w = flk.csr_schedule(lay)
    groups = bdk.fwd_groups(rowptr, s_in, 8)
    kinds = sorted({(int(nr), int(length))
                    for nr, length in groups[:, [1, 4]]})
    assert kinds == [(1, 1), (1, 2), (4, 8)]
    assert (groups[:, 1] * groups[:, 4]).sum() == len(s_in)


@pytest.mark.parametrize("widths,block", [_LAYOUTS[0], _LAYOUTS[3],
                                          _LAYOUTS[4]])
def test_groups_reach_ties_them_to_their_layout(widths, block):
    """The table ``schedule_on`` keeps on its rowptr carries the input and
    weight tiles its CSR names, exactly its layout's; ``checked_groups``
    takes it with that layout's tensors and refuses it with a narrower
    layout's x and wb."""
    lay = _population(widths, block).bd_layout(0)
    sched = flk.schedule_on(lay, "cpu")
    groups = sched[0].bd_groups
    assert groups.bd_tiles == (lay.n_in_tiles, lay.n_param_blocks + 1)
    np.testing.assert_array_equal(groups.numpy(), bdk.fwd_groups(
        *flk.csr_schedule(lay)[:2], block))

    def x_wb(lay):
        return (torch.zeros(2, lay.n_in_tiles * block),
                torch.zeros(lay.n_param_blocks + 1, block, block))

    assert bdk.checked_groups("t", *x_wb(lay), *sched, block) is groups
    narrow = _population(((4, 3), (3,)), block).bd_layout(0)
    with pytest.raises(ValueError, match="another layout"):
        bdk.checked_groups("t", *x_wb(narrow), *sched, block)


@pytest.mark.parametrize("fault", ["rowptr0", "falls", "short", "s_w",
                                   "negative_in", "negative_w"])
def test_stamp_groups_refuses_what_is_not_a_csr(fault):
    """A rowptr that does not start at 0, falls, or ends short of s_in, an
    s_w of another length, or a negative tile index is refused before any
    table is built."""
    lay = _population(_LAYOUTS[0][0], 8).bd_layout(0)
    rowptr, s_in, s_w = (a.copy() for a in flk.csr_schedule(lay))
    if fault == "rowptr0":
        rowptr[0] = 1
    elif fault == "falls":
        rowptr[2] = rowptr[1] - 1
    elif fault == "short":
        rowptr = rowptr[:-1]
    elif fault == "s_w":
        s_w = s_w[:-1]
    elif fault == "negative_in":
        s_in[3] = -1
    else:
        s_w[3] = -1
    t = [torch.from_numpy(a) for a in (rowptr, s_in, s_w)]
    with pytest.raises(ValueError, match="not a CSR schedule"):
        bdk.stamp_groups(*t, 8)
    assert getattr(t[0], "bd_groups", None) is None


def test_groups_on_builds_and_keeps_a_table_for_a_bare_csr():
    """A bare CSR (no table kept on its rowptr) gets one built from the CSR
    and kept; a later call finds it."""
    lay = _population(_LAYOUTS[0][0], 8).bd_layout(0)
    rowptr, s_in, s_w = (torch.from_numpy(a) for a in flk.csr_schedule(lay))
    assert getattr(rowptr, "bd_groups", None) is None
    t = bdk.groups_on(rowptr, s_in, s_w, 8)
    np.testing.assert_array_equal(t.numpy(), bdk.fwd_groups(
        rowptr.numpy(), s_in.numpy(), 8))
    assert rowptr.bd_groups is t and bdk.groups_on(rowptr, s_in, s_w, 8) is t


@pytest.mark.parametrize("change", ["other_s_w", "s_w_in_place",
                                    "s_in_in_place", "rowptr_in_place",
                                    "planted", "block"])
def test_groups_on_rebuilds_for_other_or_changed_tensors(change):
    """The table kept on a rowptr serves only the s_in and s_w it was built
    from, unchanged, at its block: another s_w tensor, an in-place change
    to any of the three, a table planted from another layout or another
    block gets a table built from the CSR as it now is."""
    lay = _population(_LAYOUTS[0][0], 8).bd_layout(0)
    rowptr, s_in, s_w = (torch.from_numpy(a.copy())
                         for a in flk.csr_schedule(lay))
    blk = 8
    kept = bdk.groups_on(rowptr, s_in, s_w, blk)
    if change == "other_s_w":
        s_w = s_w + 1
    elif change == "s_w_in_place":
        s_w += 1
    elif change == "s_in_in_place":
        a, b = int(rowptr[0]), int(rowptr[1])
        s_in[a:b] = s_in[a:b].flip(0)
    elif change == "rowptr_in_place":
        rowptr[1:-1] = rowptr[1:-1].clone()
    elif change == "planted":
        wide = _population(_LAYOUTS[4][0], 8).bd_layout(0)
        rowptr.bd_groups = flk.schedule_on(wide, "cpu")[0].bd_groups
    else:
        blk = 16
    t = bdk.groups_on(rowptr, s_in, s_w, blk)
    assert t is not kept and rowptr.bd_groups is t
    np.testing.assert_array_equal(t.numpy(), bdk.fwd_groups(
        rowptr.numpy(), s_in.numpy(), blk))
    assert t.bd_tiles == (int(s_in.max()) + 1, int(s_w.max()) + 1)
    assert bdk.groups_on(rowptr, s_in, s_w, blk) is t


def test_groups_under_inference_mode():
    """A schedule made under ``torch.inference_mode`` (a server's first
    forward) is of ordinary tensors and keeps its table; a bare CSR of
    inference tensors, which keep no version counter, gets its table built
    at every call."""
    lay = _population(_LAYOUTS[0][0], 8).bd_layout(0)
    with torch.inference_mode():
        sched = flk.schedule_on(lay, "cpu")
        assert not any(t.is_inference() for t in sched)
        kept = sched[0].bd_groups
        assert bdk.groups_on(*sched, 8) is kept
        bare = [torch.from_numpy(a) for a in flk.csr_schedule(lay)]
        t = bdk.groups_on(*bare, 8)
        again = bdk.groups_on(*bare, 8)
    assert all(a.is_inference() for a in bare) and again is not t
    np.testing.assert_array_equal(again.numpy(), kept.numpy())


def _at(shape, shift: int, dtype=torch.float32) -> torch.Tensor:
    """A tensor whose storage starts ``shift`` elements past a 16-byte
    boundary."""
    n = int(np.prod(shape))
    size = torch.empty(0, dtype=dtype).element_size()
    buf = torch.zeros(n + 64, dtype=dtype)
    base = (-buf.data_ptr() % 16) // size
    return buf[base + shift:base + shift + n].view(shape)


@pytest.mark.parametrize("block,shifts,want", [
    (8, (0, 0, 0, None), "vec4"),     # the depth-3 population's block
    (128, (0, 0, 0, None), "vec4"),
    (8, (0, 0, 0, 0), "vec4"),        # the training launch's g'
    (6, (0, 0, 0, None), "scalar"),   # a block not a multiple of 4
    (5, (0, 0, 0, 0), "scalar"),
    (8, (1, 0, 0, None), "scalar"),   # x 4 bytes off
    (8, (0, 2, 0, None), "scalar"),   # wb off
    (8, (0, 0, 3, None), "scalar"),   # y off
    (8, (0, 0, 0, 1), "scalar"),      # g' off
])
def test_fwd_path_rule(block, shifts, want):
    """16-byte copies of x and the tiles and 16-byte stores of y (and g')
    need a block that is a multiple of 4 and every one of them on a
    16-byte boundary."""
    x = _at((3, 4 * block), shifts[0])
    wb = _at((5, block, block), shifts[1])
    y = _at((3, 2 * block), shifts[2])
    g = None if shifts[3] is None else _at((3, 2 * block), shifts[3])
    assert bdk.fwd_path(x, wb, y, g) == want


@pytest.mark.parametrize("block,shifts,want", [
    (8, (0, 0, 0), "vec4"),       # the depth-3 population's block
    (8, (0, 4, 0), "vec4"),       # wb_q 4 bytes past a 16-byte boundary
    (128, (0, 12, 0), "vec4"),
    (8, (0, 2, 0), "scalar"),     # wb_q 2 bytes off: not whole 4-byte pieces
    (8, (0, 1, 0), "scalar"),
    (6, (0, 0, 0), "scalar"),     # a tile row of 6 bytes
    (5, (0, 0, 0), "scalar"),
    (8, (1, 0, 0), "scalar"),     # x 4 bytes off
    (8, (0, 0, 3), "scalar"),     # y off
])
def test_fwd_path_rule_int8(block, shifts, want):
    """Over int8 tiles a copy is 4 bytes of a tile row: the block a
    multiple of 4 and wb_q on a 4-byte boundary, x and y on 16-byte ones."""
    x = _at((3, 4 * block), shifts[0])
    wb_q = _at((5, block, block), shifts[1], torch.int8)
    y = _at((3, 2 * block), shifts[2])
    assert bdk.fwd_path(x, wb_q, y) == want


@pytest.mark.parametrize("block,shifts,want", [
    (8, (0, 0, 0), "vec4"), (128, (0, 0, 0), "vec4"),
    (6, (0, 0, 0), "scalar"), (5, (0, 0, 0), "scalar"),
    (8, (1, 0, 0), "scalar"), (8, (0, 2, 0), "scalar"),
    (8, (0, 0, 3), "scalar"),
])
def test_dw_path_rule(block, shifts, want):
    """``block_diag_dw``'s 16-byte loads of dy and x and stores of dWB
    need a block that is a multiple of 4 and each on a 16-byte boundary."""
    dy = _at((3, 2 * block), shifts[0])
    x = _at((3, 4 * block), shifts[1])
    dwb = _at((5, block, block), shifts[2])
    assert bdk.dw_path(dy, x, dwb) == want


def test_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers take CUDA tensors only (the CPU runs the plain
    versions)."""
    lay = _population(_LAYOUTS[0][0], 8).bd_layout(0)
    sched = flk.schedule_on(lay, "cpu")
    x = torch.zeros(2, lay.n_in_tiles * 8)
    wb = torch.zeros(lay.n_param_blocks + 1, 8, 8)
    with pytest.raises(ValueError, match="must be on"):
        bdk.block_diag_fwd_cuda(x, wb, *sched, blk=8)
    vec = torch.zeros(lay.n_out_tiles * 8)
    ids = torch.zeros(lay.n_out_tiles, dtype=torch.int32)
    with pytest.raises(ValueError, match="must be on"):
        flk.fused_layer_cuda(x, wb, vec, vec, ids, *sched, blk=8)
    with pytest.raises(ValueError, match="must be on"):
        flk.fused_layer_train_cuda(x, wb, vec, vec, ids, *sched, blk=8)
    with pytest.raises(ValueError, match="must be on"):
        flk.fused_layer_int8_cuda(x, wb.to(torch.int8), torch.ones(len(wb)),
                                  vec, vec, ids, *sched, blk=8)
