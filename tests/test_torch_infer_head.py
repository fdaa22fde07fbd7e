"""The serving head (``repro_torch.kernels.infer_head``) on the CPU: the
host-side rules of its kernels, which share the loss head's forward's
streaming core ``csrc/head_stream.cuh`` — which design a launch takes
(``kernel_path``, over f32 or int8 weights) and which CTA owns each member
(``cta_members``) — and its plain version against the JAX package's head
on members that the kernel's tiles cut in every way.  The kernel itself runs only on the card
(tests/test_torch_kernels.py).

Tolerance of the JAX comparison: rtol 1e-5 / atol 1e-6, as in
tests/test_torch_serve.py (f32 on both sides, sums in another order).
"""

import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import infer_head as ihk
from repro_torch.kernels import ops as tops

# a CTA's tile of units: 256 threads of 4 units (vec4) or 1 (scalar) in
# 1, 2, 4 or 8 lanes of rows
TILES = (1024, 512, 256, 128, 64, 32)


def _at(shape, shift: int) -> torch.Tensor:
    """A float32 tensor whose storage starts ``shift`` floats past a
    16-byte boundary."""
    n = int(np.prod(shape))
    buf = torch.zeros(n + 8)
    base = (-buf.data_ptr() // 4) % 4
    return buf[base + shift:base + shift + n].view(shape)


@pytest.mark.parametrize("block,shifts,cols,want", [
    (128, (0, 0), 1024, "vec4"),     # parallelmlp-10k's head
    (8, (0, 0), 64, "vec4"),         # the depth-3 population's head
    (4, (0, 0), 12, "vec4"),
    (5, (0, 0), 40, "scalar"),       # blocks not a multiple of 4
    (6, (0, 0), 36, "scalar"),
    (1, (0, 0), 64, "scalar"),
    (8, (1, 0), 64, "scalar"),       # h 4 bytes off a 16-byte boundary
    (8, (0, 3), 64, "scalar"),       # w2 off
    (128, (2, 2), 1024, "scalar"),   # both off
    (8, (0, 0), 62, "scalar"),       # rows not a multiple of 4 floats
])
def test_kernel_path_rule(block, shifts, cols, want):
    h, w2 = (_at((3, cols), s) for s in shifts)
    assert ihk.kernel_path(block, h, w2) == want


def _at8(shape, shift: int) -> torch.Tensor:
    """An int8 tensor whose storage starts ``shift`` bytes past a 16-byte
    boundary."""
    n = int(np.prod(shape))
    buf = torch.zeros(n + 32, dtype=torch.int8)
    base = (-buf.data_ptr()) % 16
    return buf[base + shift:base + shift + n].view(shape)


@pytest.mark.parametrize("block,shifts,cols,want", [
    (128, (0, 0), 1024, "vec4"),     # parallelmlp-10k's head
    (8, (0, 0), 64, "vec4"),         # the depth-3 population's head
    (8, (0, 4), 64, "vec4"),         # w2_q 4-byte aligned is enough
    (4, (0, 8), 12, "vec4"),
    (8, (0, 1), 64, "scalar"),       # w2_q off a 4-byte boundary
    (8, (0, 2), 64, "scalar"),
    (8, (1, 0), 64, "scalar"),       # h 4 bytes off a 16-byte boundary
    (6, (0, 0), 36, "scalar"),       # a block not a multiple of 4
    (8, (0, 0), 62, "scalar"),       # rows not a multiple of 4 units
])
def test_kernel_path_rule_int8(block, shifts, cols, want):
    """The int8 head's rule: h aligned to 16 bytes, w2_q to 4 (one load of
    a thread's 4 int8 units)."""
    h, w2_q = _at((3, cols), shifts[0]), _at8((2, cols), shifts[1])
    assert ihk.kernel_path(block, h, w2_q) == want


def _member_ptr(widths, block):
    return np.concatenate([[0], np.cumsum([-(-w // block) for w in widths])])


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("widths,block,extra", [
    ((128,) * 40, 128, 0),                 # the paper's members
    ((8, 16, 8, 8, 16, 16, 8) * 30, 8, 0),  # the depth-3 head's widths
    ((40, 5000, 16, 24), 8, 0),            # a member wider than a tile
    ((0, 0, 8, 0, 16) + (0,) * 70 + (24, 0, 0), 8, 0),  # empty members
    ((7, 13, 30, 2, 64, 9), 6, 0),         # a block not a multiple of 4
    ((5, 3, 0, 11, 1), 1, 0),              # block 1
    ((1024, 1024), 128, 0),                # members one tile wide (or more)
    ((16, 0, 8, 0), 8, 3000),              # h wider than the members: the
    ((0, 0), 8, 0),                        # last CTAs own no unit's member
])
def test_every_member_has_one_owner(widths, block, extra, tile):
    """Every member, empty ones too, has exactly one owning CTA; a CTA's
    members start in its tile, and only the last CTA owns members that
    start past its tile's end (its tail)."""
    ptr = _member_ptr(widths, block)
    hidden = int(ptr[-1]) * block + extra
    starts = ptr[:-1] * block
    n_tiles = max(1, -(-hidden // tile))
    owned = [ihk.cta_members(ptr, c, block=block, hidden=hidden, tile=tile)
             for c in range(n_tiles)]
    assert [m for r in owned for m in r] == list(range(len(widths)))
    for c, r in enumerate(owned):
        for m in r:
            assert starts[m] >= c * tile
            assert c == n_tiles - 1 or starts[m] < (c + 1) * tile
    tail = [m for m in owned[-1] if starts[m] >= n_tiles * tile]
    assert tail == [m for m in range(len(widths))
                    if starts[m] >= n_tiles * tile]


@pytest.mark.parametrize("log_probs", [False, True])
@pytest.mark.parametrize("widths,block,o,b", [
    ((12, 40, 4, 64, 8), 4, 5, 33),    # vec4 blocks, O 5
    ((5, 10, 35, 5), 5, 16, 31),       # scalar blocks, O 16
    ((6, 12, 6), 6, 1, 1),             # O 1, B 1
])
def test_infer_head_plain_matches_jax(widths, block, o, b, log_probs):
    rng = np.random.default_rng(b + o)
    blocks = [w // block for w in widths]
    seg = np.repeat(np.arange(len(widths)), blocks).astype(np.int32)
    hh = int(sum(blocks)) * block
    h = rng.normal(0, 1, (b, hh)).astype(np.float32)
    w2 = (rng.normal(0, 1, (o, hh)) / 4).astype(np.float32)
    b2 = rng.normal(0, 1, (len(widths), o)).astype(np.float32)
    want = jops.infer_head(h, w2, b2, seg, block_h=block,
                           log_probs=log_probs)
    n0 = ihk.launches
    got = tops.infer_head(*(torch.from_numpy(a) for a in (h, w2, b2)), seg,
                          block_h=block, log_probs=log_probs)
    assert ihk.launches == n0 + 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
