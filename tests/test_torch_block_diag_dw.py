"""The unfused weight gradient's work table (``block_diag.dw_units``) and
its host rules, on the CPU: each parameter tile owned by exactly one unit
(a member's rectangle, a chunk of its columns, or one tile alone where the
list traces no rectangle), the table kept only for the tile tensors it was
built from, its reach refusing another layout's tensors, and the dW the
units describe equal to ``block_diag_dw_plain``.  The kernel itself runs
only on the card (tests/test_torch_kernels.py); the plain version is held
to the JAX package's kernel in tests/test_torch_unfused.py.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.activations import ACTIVATION_ORDER
from repro_torch.core.population import LayeredPopulation
from repro_torch.kernels import block_diag as bdk
from repro_torch.kernels import fused_layer as flk

# the GPU tests' _TRAIN_GRID layouts, and the depth-3 population's widths
# cut to 40 repeats
_LAYOUTS = [
    (((24,), (13, 5), (17, 9), (32, 16, 8)), 8),
    (((5, 3), (12, 9), (7,), (17, 9, 5), (8, 8), (5, 3), (3, 11, 2),
      (24, 16), (4,), (9, 9, 9)), 8),
    (((40, 20), (17, 33, 9), (7,)), 16),
    (((200, 130), (64, 100), (7,)), 128),
    (((512, 384), (13, 5), (7,)), 8),
    (((64, 32, 16), (13, 5), (7,)) * 40, 8),
]


def _layouts(widths, block):
    acts = tuple(ACTIVATION_ORDER[i % 10] for i in range(len(widths)))
    lp = LayeredPopulation(5, 3, widths, acts, block=block)
    return [lp.bd_layout(l) for l in range(lp.depth - 1)]


def _tiles(lay, shuffle: bool):
    out_t = np.asarray(lay.wb_out_tile, np.int32)
    in_t = np.asarray(lay.wb_in_tile, np.int32)
    if shuffle:
        perm = np.random.default_rng(lay.n_param_blocks).permutation(
            out_t.size)
        out_t, in_t = out_t[perm], in_t[perm]
    return out_t, in_t


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("widths,block", _LAYOUTS)
def test_dw_units_cover_each_tile_once(widths, block, shuffle):
    """Every parameter tile lies in exactly one unit, whose (r, c) tile is
    that of output tile out0 + r and input tile in0 + c.  A layout's tiles
    give its members' rectangles, the real units of ``dx_dw_units``; a
    shuffled list gives (nearly) a 1 × 1 unit a tile.  Jobs: one whole-CTA unit, or
    up to ``WARP_JOB`` warp units, warp jobs first."""
    for lay in _layouts(widths, block):
        out_t, in_t = _tiles(lay, shuffle)
        units, ptr = bdk.dw_units(out_t, in_t, block)
        cover = np.zeros(out_t.size, int)
        for in0, nc, out0, no, q, ld, warp, _ in units:
            assert q >= 0 and nc >= 1 and no >= 1 and ld >= nc
            assert warp == (no * block <= bdk.WARP_OUT
                            and nc * block <= bdk.WARP_COLS)
            r, c = np.divmod(np.arange(no * nc), nc)
            tiles = q + r * ld + c
            cover[tiles] += 1
            np.testing.assert_array_equal(out_t[tiles], out0 + r)
            np.testing.assert_array_equal(in_t[tiles], in0 + c)
        np.testing.assert_array_equal(cover, 1)
        if shuffle:  # rectangles only where neighbours happen to trace one
            assert len(units) > 0.9 * out_t.size or out_t.size < 100
        else:
            dx_dw = flk.dx_dw_units(lay)[0]
            real = dx_dw[dx_dw[:, 4] >= 0]
            assert sorted(map(tuple, real.tolist())) \
                == sorted(map(tuple, units.tolist()))
        assert ptr[0] == 0 and ptr[-1] == len(units)
        for lo, hi in zip(ptr[:-1], ptr[1:]):
            kinds = set(units[lo:hi, 6].tolist())
            assert len(kinds) == 1
            assert hi - lo == 1 if kinds == {0} \
                else 1 <= hi - lo <= bdk.WARP_JOB
        assert np.all(np.diff(units[:, 6]) <= 0)


def test_dw_units_of_a_broken_rectangle():
    """A run of tiles that starts like a rectangle and breaks off inside it
    is not refused: its first tile is a unit of its own, and the scan goes
    on from the next; ``dx_dw_units``, whose dx columns need whole members,
    refuses the same list."""
    out_t = np.array([0, 0, 1, 5, 2, 2], np.int32)
    in_t = np.array([0, 1, 0, 7, 3, 4], np.int32)
    assert bdk.member_rects(out_t, in_t) == [
        (0, 0, 1, 0, 1), (1, 0, 1, 1, 1), (2, 1, 1, 0, 1), (3, 5, 1, 7, 1),
        (4, 2, 1, 3, 2)]
    with pytest.raises(ValueError, match="member-major rectangles"):
        bdk.member_rects(out_t, in_t, strict="fused_layer_dx_dw")
    units, _ = bdk.dw_units(out_t, in_t, 8)
    assert sorted(units[:, 4].tolist()) == [0, 1, 2, 3, 4]


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("widths,block,b", [
    (_LAYOUTS[0][0], 8, 11), (_LAYOUTS[2][0], 16, 70), (_LAYOUTS[3][0], 128,
                                                         5)])
def test_dw_over_the_units_is_block_diag_dw_plain(widths, block, b,
                                                  shuffle):
    """dWB formed unit by unit from the table (each tile (r, c) of a unit:
    dy's output tile out0 + r against x's input tile in0 + c) equals the
    plain version on the whole tile list."""
    rng = np.random.default_rng(b)
    for lay in _layouts(widths, block):
        out_t, in_t = (torch.from_numpy(a) for a in _tiles(lay, shuffle))
        dy = torch.from_numpy(rng.normal(0, 1, (b, lay.n_out_tiles * block)))
        x = torch.from_numpy(rng.normal(0, 1, (b, lay.n_in_tiles * block)))
        units, _ = bdk.dw_units(out_t.numpy(), in_t.numpy(), block)
        real, q, o_t, i_t = bdk.unit_tiles(torch.from_numpy(units))
        assert bool(real.all())
        got = torch.full((out_t.shape[0], block, block), float("nan"),
                         dtype=torch.float64)
        got[q] = torch.einsum("bsr,bsc->src",
                              dy.reshape(b, -1, block)[:, o_t],
                              x.reshape(b, -1, block)[:, i_t])
        np.testing.assert_allclose(
            got.numpy(), bdk.block_diag_dw_plain(dy, x, out_t, in_t,
                                                 blk=block).numpy(),
            rtol=1e-12, atol=1e-12)


def _tile_tensors(lay):
    return tuple(torch.from_numpy(np.asarray(a, np.int32).copy())
                 for a in (lay.wb_out_tile, lay.wb_in_tile))


def test_dw_reach_refuses_another_layouts_tensors():
    """The table carries the (input, output, parameter) tiles it reaches,
    within its layout's and every parameter tile; ``checked_dw_units``
    takes it with that layout's dy and x and refuses it with a narrower
    layout's."""
    lay = _layouts(_LAYOUTS[4][0], 8)[0]
    out_t, in_t = _tile_tensors(lay)
    units, ptr = bdk.dw_units_on(out_t, in_t, 8)
    n_in, n_out, n_param = units.bd_reach
    assert units.bd_reach == bdk.units_reach(units.numpy(), ptr.numpy())
    assert n_in <= lay.n_in_tiles and n_out <= lay.n_out_tiles
    assert n_param == lay.n_param_blocks
    dy = torch.zeros(2, lay.n_out_tiles * 8)
    x = torch.zeros(2, lay.n_in_tiles * 8)
    got = bdk.checked_dw_units(dy, x, out_t, in_t, 8)
    assert got[0] is units and got[1] is ptr
    narrow = _layouts(((4, 3), (3,)), 8)[0]
    for dy_n, x_n in ((torch.zeros(2, narrow.n_out_tiles * 8), x),
                      (dy, torch.zeros(2, narrow.n_in_tiles * 8))):
        with pytest.raises(ValueError, match="block_diag_dw: the units "
                           "reach"):
            bdk.checked_dw_units(dy_n, x_n, out_t, in_t, 8)


@pytest.mark.parametrize("change", ["out_in_place", "in_in_place",
                                    "other_in", "block"])
def test_dw_units_on_keeps_and_rebuilds(change):
    """The table kept on ``wb_out_tile`` serves again only the same
    ``wb_in_tile`` at the same block, neither changed since: an in-place
    change to either, another ``wb_in_tile`` tensor or another block gets a
    table built from the tiles as they now are."""
    lay = _layouts(_LAYOUTS[0][0], 8)[0]
    out_t, in_t = _tile_tensors(lay)
    blk = 8
    kept = bdk.dw_units_on(out_t, in_t, blk)
    assert bdk.dw_units_on(out_t, in_t, blk) is kept
    if change == "out_in_place":
        out_t[:4] = out_t[:4].flip(0)
    elif change == "in_in_place":
        in_t[:4] = in_t[:4].flip(0)
    elif change == "other_in":
        in_t = in_t.clone()
    else:
        blk = 16
    got = bdk.dw_units_on(out_t, in_t, blk)
    assert got is not kept and out_t.bd_dw_units is got
    for a, b in zip(got, bdk.dw_units(out_t.numpy(), in_t.numpy(), blk)):
        np.testing.assert_array_equal(a.numpy(), b)
    assert bdk.dw_units_on(out_t, in_t, blk) is got


def test_dw_units_of_inference_tensors_are_built_at_every_call():
    """Tile tensors made under ``torch.inference_mode`` keep no version
    counter: their table is built at every call (the layout's own tensors,
    from ``schedule_on``, are ordinary tensors and keep theirs)."""
    lay = _layouts(_LAYOUTS[0][0], 8)[0]
    with torch.inference_mode():
        out_t, in_t = _tile_tensors(lay)
        first = bdk.dw_units_on(out_t, in_t, 8)
        again = bdk.dw_units_on(out_t, in_t, 8)
        sched = flk.schedule_on(lay, "cpu", transposed=True)
        kept = bdk.dw_units_on(*sched[4:], 8)
        assert bdk.dw_units_on(*sched[4:], 8) is kept
    assert again is not first
    np.testing.assert_array_equal(again[0].numpy(), first[0].numpy())
    np.testing.assert_array_equal(kept[0].numpy(), first[0].numpy())


def test_dw_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper takes CUDA tensors only (the CPU runs the plain
    version)."""
    lay = _layouts(_LAYOUTS[0][0], 8)[0]
    out_t, in_t = _tile_tensors(lay)
    with pytest.raises(ValueError, match="must be on"):
        bdk.block_diag_dw_cuda(torch.zeros(2, lay.n_out_tiles * 8),
                               torch.zeros(2, lay.n_in_tiles * 8), out_t,
                               in_t, blk=8)
