"""The loss-head kernels' host-side rules, on the CPU: which design a launch
takes (``kernel_path``) and which forward CTA owns each member
(``fwd_cta_members``).  The kernels themselves run only on the card
(tests/test_torch_kernels.py); these rules are the ones their C entries
and the forward kernel apply."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import loss_head as lhk


def _at(shape, shift: int) -> torch.Tensor:
    """A float32 tensor whose storage starts ``shift`` floats past a
    16-byte boundary."""
    n = int(np.prod(shape))
    buf = torch.zeros(n + 8)
    base = (-buf.data_ptr() // 4) % 4
    return buf[base + shift:base + shift + n].view(shape)


@pytest.mark.parametrize("block,shifts,cols,want", [
    (8, (0, 0), 64, "vec4"),
    (128, (0, 0, 0, 0), 1024, "vec4"),
    (4, (0, 0), 12, "vec4"),
    (6, (0, 0), 36, "scalar"),       # a block not a multiple of 4
    (5, (0, 0), 40, "scalar"),
    (8, (1, 0), 64, "scalar"),       # h 4 bytes off a 16-byte boundary
    (8, (0, 2), 64, "scalar"),       # w2 off
    (8, (0, 0, 0, 3), 64, "scalar"),  # the backward's dW off
    (8, (0, 0), 62, "scalar"),       # rows not a multiple of 4 floats
])
def test_kernel_path_rule(block, shifts, cols, want):
    tensors = [_at((3, cols), s) for s in shifts]
    assert lhk.kernel_path(block, *tensors) == want


def _member_ptr(widths, block):
    return np.concatenate([[0], np.cumsum([-(-w // block) for w in widths])])


@pytest.mark.parametrize("widths,block,tile", [
    ((128,) * 40, 128, 1024),              # the paper's members, 8 a tile
    ((8, 16, 8, 8, 16, 16, 8) * 30, 8, 128),  # narrow members, many a tile
    ((40, 5000, 16, 24), 8, 1024),         # one member over several tiles
    ((0, 0, 8, 0, 16) + (0,) * 70 + (24, 0, 0), 8, 32),  # empty members
    ((7, 13, 30, 2, 64, 9), 6, 256),       # a block not a multiple of 4
    ((1024, 1024), 128, 1024),             # members exactly one tile wide
])
def test_every_member_has_one_forward_owner(widths, block, tile):
    ptr = _member_ptr(widths, block)
    hidden = int(ptr[-1]) * block
    starts = ptr[:-1] * block
    n_tiles = max(1, -(-hidden // tile))
    owned = [lhk.fwd_cta_members(ptr, c, block=block, hidden=hidden,
                                 tile=tile) for c in range(n_tiles)]
    # contiguous owners in CTA order, every member exactly once
    assert [m for r in owned for m in r] == list(range(len(widths)))
    for c, r in enumerate(owned):
        for m in r:
            assert starts[m] >= c * tile
            assert c == n_tiles - 1 or starts[m] < (c + 1) * tile
