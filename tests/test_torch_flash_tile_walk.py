"""The f32 flash attention kernel's tile walk (``flash_attn.tile_walk``, the
rule of ``csrc/flash_attn.cu``'s ``tile_range`` and ``edge_tile``) and its
instance rules (``fma_width``, ``fma_tiles``), on the CPU, at both
tilings (128 × 64 up to dh 128, 64 × 32 at dh 192).

The walk is held against ``attention_mask``: every unmasked (q, k) pair lies
in a walked tile, every walked tile not flagged as an edge is unmasked for
every row of its q tile, and a q tile holding a fully masked row walks every
tile.  Then the kernel's algorithm, run in PyTorch over the walk (online
softmax in exp2 over the walked tiles, masks on the edge tiles only), is held
against the dense plain version at the f32 kernel's tolerance, rtol 1e-4 /
atol 1e-5: a tile that the walk skips or leaves unmasked wrongly moves the
result.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attn as fak

# (sq, sk, bq, bk, causal, window): the kernel's tiles and small ones;
# rows past sk + window − 2 are fully masked in the cases marked so
_GRID = [
    (300, 300, *fak.FMA_TILES[128], True, 0),
    (129, 65, *fak.FMA_TILES[128], True, 0),
    (128, 200, *fak.FMA_TILES[128], False, 0),
    (256, 256, *fak.FMA_TILES[128], True, 40),
    (300, 190, *fak.FMA_TILES[128], False, 90),
    (256, 100, *fak.FMA_TILES[128], False, 50),   # rows 148+ fully masked
    (256, 100, *fak.FMA_TILES[128], True, 50),    # the same, causal
    (8192, 8192, *fak.FMA_TILES[128], True, 4096),  # h2o-danube-3-4b
    (40, 20, 16, 8, True, 4),                        # rows 23-39
    (40, 20, 16, 8, False, 4),
    (48, 80, 16, 16, True, 0),
    (33, 65, 16, 32, False, 0),
    (64, 64, 16, 8, True, 24),
    (70, 30, 32, 8, False, 7),                       # rows 36-69
    (48, 48, 16, 8, True, 2),     # a q tile's first column ends a k tile
    (64, 64, 16, 8, False, 10),   # the same, not causal
    # the dh-192 instance's tiles: nemotron-4-340b's prefill, ragged and
    # windowed walks, a fully masked tail
    (512, 512, *fak.FMA_TILES[192], True, 0),
    (100, 70, *fak.FMA_TILES[192], True, 0),
    (200, 200, *fak.FMA_TILES[192], False, 40),
    (160, 60, *fak.FMA_TILES[192], True, 30),     # rows 89+ fully masked
]


def _tiles(sq, sk, bq, bk, causal, window):
    """(q tile rows, its walk, its mask rows) for every q tile."""
    ok = fak.attention_mask(sq, sk, causal=causal, window=window)
    for t, walk in enumerate(fak.tile_walk(sq, sk, bq, bk, causal, window)):
        rows = slice(t * bq, min((t + 1) * bq, sq))
        yield rows, walk, ok[rows]


@pytest.mark.parametrize("sq,sk,bq,bk,causal,window", _GRID)
def test_tile_walk_covers_every_unmasked_pair(sq, sk, bq, bk, causal,
                                              window):
    for rows, (lo, hi, edge), ok in _tiles(sq, sk, bq, bk, causal, window):
        assert 0 <= lo < hi <= math.ceil(sk / bk) and len(edge) == hi - lo
        cols = torch.nonzero(ok.any(0)).flatten()
        if cols.numel():
            assert lo * bk <= int(cols.min()) and int(cols.max()) < hi * bk


@pytest.mark.parametrize("sq,sk,bq,bk,causal,window", _GRID)
def test_tile_walk_leaves_only_unmasked_tiles_unflagged(sq, sk, bq, bk,
                                                        causal, window):
    for rows, (lo, hi, edge), ok in _tiles(sq, sk, bq, bk, causal, window):
        for kt, is_edge in zip(range(lo, hi), edge):
            k0 = kt * bk
            if not is_edge:
                assert k0 + bk <= sk and bool(ok[:, k0:k0 + bk].all()), \
                    (rows, kt)


@pytest.mark.parametrize("sq,sk,bq,bk,causal,window", _GRID)
def test_tile_walk_walks_every_tile_for_a_fully_masked_row(sq, sk, bq, bk,
                                                           causal, window):
    for rows, (lo, hi, _), ok in _tiles(sq, sk, bq, bk, causal, window):
        if not bool(ok.any(1).all()):
            assert (lo, hi) == (0, math.ceil(sk / bk)), rows


def _walked_attention(q, k, v, *, scale, causal, window, bq, bk):
    """The f32 kernel's algorithm over ``tile_walk``: per q tile, the walked
    k tiles in order, the scale on the f32 dot product, −1e30 on the masked
    pairs of the edge tiles only, columns past Sk out of the sums, and the
    online softmax in exp2 with log2 e folded in."""
    log2e = 1.4426950408889634
    sq, sk = q.shape[2], k.shape[2]
    g = q.shape[1] // k.shape[1]
    kr, vr = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    o = torch.empty_like(q)
    for rows, (lo, hi, edge), ok in _tiles(sq, sk, bq, bk, causal, window):
        qt = q[:, :, rows]
        m = torch.full(qt.shape[:3], fak.NEG_INF)
        l = torch.zeros(qt.shape[:3])
        acc = torch.zeros(qt.shape)
        for kt, is_edge in zip(range(lo, hi), edge):
            cols = slice(kt * bk, min(kt * bk + bk, sk))
            s = qt @ kr[:, :, cols].transpose(-1, -2) * scale
            if is_edge:
                s = torch.where(ok[:, cols], s, torch.tensor(fak.NEG_INF))
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2((m - m_new) * log2e)
            p = torch.exp2((s - m_new[..., None]) * log2e)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p @ vr[:, :, cols]
            m = m_new
        o[:, :, rows] = acc / l.clamp_min(1e-30)[..., None]
    return o


@pytest.mark.parametrize("sq,sk,bq,bk,causal,window",
                         [c for c in _GRID if c[0] * c[1] < 10 ** 6])
def test_walked_online_softmax_matches_dense(sq, sk, bq, bk, causal, window):
    rng = np.random.default_rng(sq * sk + window)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
               for s in ((1, 4, sq, 8), (1, 2, sk, 8), (1, 2, sk, 8)))
    kw = dict(scale=8 ** -0.5, causal=causal, window=window)
    got = _walked_attention(q, k, v, bq=bq, bk=bk, **kw)
    want = fak.flash_attn_dense(q, k, v, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("dh,width", [(8, 64), (56, 64), (64, 64), (72, 128),
                                      (120, 128), (128, 128), (136, 192),
                                      (192, 192)])
def test_fma_width(dh, width):
    assert fak.fma_width(dh) == width
    assert fak.fma_tiles(dh) == ((64, 32) if width == 192 else (128, 64))


@pytest.mark.parametrize("dh", [4, 12, 200])
def test_fma_width_rejects_what_no_instance_takes(dh):
    with pytest.raises(ValueError):
        fak.fma_width(dh)
