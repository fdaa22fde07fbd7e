"""The port's training kernels — their plain PyTorch versions — held against
the JAX package's Pallas kernels on the CPU.

Same numpy inputs go through both: JAX runs its kernels in interpret mode,
as its own tests do; the port runs each kernel's plain version, which its
dispatch layer picks for a CPU tensor (the CUDA kernels are held against
these plain versions on the card, tests/test_torch_kernels.py).  Inputs
include pre-activations exactly at the activations' kinks (0, ±0.5) for
all ten activations, and pad rows with target −1.

Tolerances (the JAX package's own tests for the same quantities): forwards
rtol 1e-5 / atol 1e-6 (tests/test_fused_layer.py); gradients rtol 1e-4 /
atol 1e-6 (tests/test_fused_layer.py, tests/test_loss_head.py).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import activations as jact
from repro.core.population import LayeredPopulation as JLayered
from repro.kernels import ops as jops
from repro_torch.core import activations as tact
from repro_torch.core.population import LayeredPopulation as TLayered
from repro_torch.kernels import block_diag as bdk
from repro_torch.kernels import fused_input as fik
from repro_torch.kernels import fused_layer as flk
from repro_torch.kernels import infer_head as ihk
from repro_torch.kernels import loss_head as lhk
from repro_torch.kernels import ops as tops

# the kernel modules (``repro.kernels`` re-exports functions of these names)
jfik = importlib.import_module("repro.kernels.fused_input")
jflk = importlib.import_module("repro.kernels.fused_layer")
jlhk = importlib.import_module("repro.kernels.loss_head")

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
B, BLOCK_B = 16, 8
N_ACTS = len(jact.ACTIVATION_ORDER)
KINKS = np.array([0.0, 0.5, -0.5, 0.0, -0.5, 0.5, 1e-3, -2.0], np.float32)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _np(a):
    return np.asarray(a)


# --------------------------------------------------------------------- #
# activation derivatives                                                #
# --------------------------------------------------------------------- #

def _jax_deriv(name, x):
    fn = jact.ACTIVATIONS[name]
    return np.asarray(jax.vjp(fn, jnp.asarray(x))[1](jnp.ones_like(x))[0])


def test_activation_derivs_match_jax_vjp():
    """Each derivative equals ``jax.vjp`` at ones, kinks included."""
    x = np.concatenate([np.linspace(-12, 12, 481), KINKS,
                        [0.5000001, -0.4999999, 30.0, -30.0]]
                       ).astype(np.float32)
    assert tuple(tact.ACTIVATION_DERIVS) == tuple(tact.ACTIVATIONS)
    for name in jact.ACTIVATION_ORDER:
        got = tact.ACTIVATION_DERIVS[name](torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, _jax_deriv(name, x), err_msg=name,
                                   **FWD)


def test_activation_derivs_at_kinks_are_jaxs():
    k = torch.tensor([0.0, 0.5, -0.5])
    d = {n: fn(k).tolist() for n, fn in tact.ACTIVATION_DERIVS.items()}
    assert d["relu"][0] == 0.0
    assert d["leaky_relu"][0] == 1.0
    assert d["elu"][0] == 1.0
    np.testing.assert_allclose(d["selu"][0], 1.0507009873554805
                               * 1.6732632423543772, rtol=1e-6)
    assert d["hardshrink"][1:] == [0.0, 0.0]
    ids = torch.tensor([0, 3, N_ACTS, -1])
    out = tact.apply_activation_derivs_masked(torch.zeros(2, 4), ids)
    assert torch.isnan(out[:, 2:]).all() and not torch.isnan(out[:, :2]).any()


# --------------------------------------------------------------------- #
# fused input layer: forward with g', backward                          #
# --------------------------------------------------------------------- #

def _input_case(block, n_blocks, f, kinks):
    rng = np.random.default_rng(block + f)
    h = block * n_blocks
    x = rng.normal(0, 1, (B, f)).astype(np.float32)
    w = (rng.normal(0, 1, (h, f)) / np.sqrt(f)).astype(np.float32)
    b = rng.normal(0, 1, h).astype(np.float32)
    if kinks:              # x = 0: the pre-activation is exactly the bias
        x[:] = 0.0
        b = np.resize(KINKS, h)
    ids = (np.arange(n_blocks) % N_ACTS).astype(np.int32)
    mask = (rng.random(h) > 0.2).astype(np.float32)
    return x, w, b, ids, mask


@pytest.mark.parametrize("kinks", [False, True], ids=["random", "kinks"])
@pytest.mark.parametrize("block,n_blocks,f", [(8, 10, 6), (16, 12, 37)])
def test_fused_input_train_plain_matches_jax(block, n_blocks, f, kinks):
    x, w, b, ids, mask = _input_case(block, n_blocks, f, kinks)
    jy, jg = jfik.fused_input_fwd(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)[None],
        jnp.asarray(mask)[None], jnp.asarray(ids), block=block,
        block_b=BLOCK_B, with_deriv=True, interpret=True)
    y, g = fik.fused_input_train_plain(_t(x), _t(w), _t(b), _t(mask),
                                       _t(ids, torch.int32), block=block)
    np.testing.assert_allclose(y.numpy(), _np(jy), **FWD)
    np.testing.assert_allclose(g.numpy(), _np(jg), **FWD)


@pytest.mark.parametrize("block,n_blocks,f", [(8, 10, 6), (16, 12, 37)])
def test_fused_input_bwd_plain_matches_jax(block, n_blocks, f):
    rng = np.random.default_rng(f)
    h = block * n_blocks
    dy = rng.normal(0, 1, (B, h)).astype(np.float32)
    g = (rng.random((B, h)) * (rng.random(h) > 0.2)).astype(np.float32)
    x = rng.normal(0, 1, (B, f)).astype(np.float32)
    w = (rng.normal(0, 1, (h, f)) / np.sqrt(f)).astype(np.float32)
    jdx, jdw = jfik.fused_input_bwd(jnp.asarray(dy), jnp.asarray(g),
                                    jnp.asarray(x), jnp.asarray(w),
                                    block=block, block_b=BLOCK_B,
                                    interpret=True)
    dx, dw = fik.fused_input_bwd_plain(_t(dy), _t(g), _t(x), _t(w),
                                       with_dx=True)
    np.testing.assert_allclose(dx.numpy(), _np(jdx), **GRAD)
    np.testing.assert_allclose(dw.numpy(), _np(jdw), **GRAD)
    none, dw2 = fik.fused_input_bwd_plain(_t(dy), _t(g), _t(x), _t(w),
                                          with_dx=False)
    assert none is None and torch.equal(dw, dw2)


# --------------------------------------------------------------------- #
# fused mid layer: forward with g', one-pass backward                   #
# --------------------------------------------------------------------- #

_WIDTHS = ((5, 3), (12, 9), (7,), (17, 9, 5), (8, 8),
           (5, 3), (3, 11, 2), (24, 16), (4,), (9, 9, 9))


def _layer_case(jlp, tlp, l, kinks, seed):
    lay, jlay = tlp.bd_layout(l), jlp.bd_layout(l)
    blk = lay.block
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, lay.n_in_tiles * blk)).astype(np.float32)
    wb = (rng.normal(0, 1, (lay.n_param_blocks, blk, blk)) / np.sqrt(blk)
          ).astype(np.float32)
    b_eff = rng.normal(0, 1, lay.n_out_tiles * blk).astype(np.float32)
    if kinks:
        x[:] = 0.0
        b_eff = np.resize(KINKS, b_eff.shape[0])
    acts = (np.arange(lay.n_out_tiles) % N_ACTS).astype(np.int32)
    mask = (rng.random(lay.n_out_tiles * blk) > 0.2).astype(np.float32)
    return lay, jlay, x, wb, b_eff, acts, mask


def _jax_ids(jlay, transposed):
    return [jnp.asarray(a) for a in jops._bd_ids(jlay, transposed)]


def _f32_at(shape, shift: int) -> torch.Tensor:
    """A float32 tensor whose storage starts ``shift`` floats past a
    16-byte boundary."""
    n = int(np.prod(shape))
    buf = torch.zeros(n + 8)
    base = (-buf.data_ptr() // 4) % 4
    return buf[base + shift:base + shift + n].view(shape)


@pytest.mark.parametrize("f,h,shifts,want", [
    (100, 1_280_000, (0, 0, 0), "vec4"),  # parallelmlp-10k's input layer
    (100, 88_000, (0, 0, 0), "vec4"),     # the depth-3 population's
    (1028, 204, (0, 0, 0), "vec4"),
    (102, 4100, (0, 0, 0), "scalar"),     # F not a multiple of 4
    (100, 8190, (0, 0, 0), "scalar"),     # H not a multiple of 4
    (100, 8192, (1, 0, 0), "scalar"),     # dy 4 bytes off
    (100, 8192, (0, 2, 0), "scalar"),     # g' off
    (100, 8192, (0, 0, 3), "scalar"),     # x off
])
def test_fused_input_bwd_path_rule(f, h, shifts, want):
    """The backward's instance: 16-byte copies along H and float4 rows of
    dW need F and H multiples of 4 and dy, g', x, dW 16-byte aligned."""
    dy, g = (_f32_at((1, h), s) for s in shifts[:2])
    x = _f32_at((1, f), shifts[2])
    assert fik.bwd_path(dy, g, x, _f32_at((4,), 0)) == want


@pytest.mark.parametrize("kinks", [False, True], ids=["random", "kinks"])
@pytest.mark.parametrize("block,l", [(8, 0), (8, 1), (16, 0)])
def test_fused_layer_train_plain_matches_jax(block, l, kinks):
    jlp = JLayered(6, 3, _WIDTHS, jact.ACTIVATION_ORDER, block=block)
    tlp = TLayered(6, 3, _WIDTHS, jact.ACTIVATION_ORDER, block=block)
    lay, jlay, x, wb, b_eff, acts, mask = _layer_case(jlp, tlp, l, kinks, l)
    wb_aug = np.concatenate([wb, np.eye(block, dtype=np.float32)[None]])
    s_act = acts[np.asarray(jlay.s_out)]
    jy, jg = jflk.fused_layer_fwd(
        jnp.asarray(x), jnp.asarray(wb_aug), jnp.asarray(b_eff)[None],
        jnp.asarray(mask)[None], *_jax_ids(jlay, False), jnp.asarray(s_act),
        n_out_tiles=jlay.n_out_tiles, n_steps=jlay.n_steps, block=block,
        block_b=BLOCK_B, with_deriv=True, interpret=True)
    sched = flk.schedule_on(lay, "cpu")
    y, g = flk.fused_layer_train_plain(_t(x), _t(wb_aug), _t(b_eff),
                                       _t(mask), _t(acts, torch.int32),
                                       *sched, blk=block)
    np.testing.assert_allclose(y.numpy(), _np(jy), **FWD)
    np.testing.assert_allclose(g.numpy(), _np(jg), **FWD)


@pytest.mark.parametrize("block,l", [(8, 0), (8, 1), (16, 0)])
def test_fused_layer_dx_dw_plain_matches_jax(block, l):
    """The one-pass backward, member by member over the member-major
    tiles, pass-through members included, against JAX's kernel over the
    transposed steps: dx and every parameter tile's dW."""
    jlp = JLayered(6, 3, _WIDTHS, jact.ACTIVATION_ORDER, block=block)
    tlp = TLayered(6, 3, _WIDTHS, jact.ACTIVATION_ORDER, block=block)
    lay, jlay, x, wb, _, _, _ = _layer_case(jlp, tlp, l, False, 10 + l)
    rng = np.random.default_rng(20 + l)
    dy = rng.normal(0, 1, (B, lay.n_out_tiles * block)).astype(np.float32)
    g = rng.random((B, lay.n_out_tiles * block)).astype(np.float32)
    wb_t = np.asarray(jops._bd_transposed_tiles(jnp.asarray(wb), jlay))
    jdx, jdwb = jflk.fused_layer_dx_dw(
        jnp.asarray(dy), jnp.asarray(g), jnp.asarray(x), jnp.asarray(wb_t),
        *_jax_ids(jlay, True), jnp.asarray(np.asarray(jlay.s_q_t, np.int32)),
        n_in_tiles=jlay.n_in_tiles, n_steps_t=jlay.n_steps_t,
        n_param_blocks=jlay.n_param_blocks, block=block, block_b=BLOCK_B,
        interpret=True)
    perm_t = flk.schedule_on(lay, "cpu", transposed=True)[3]
    wb_aug = torch.cat([_t(wb), torch.eye(block)[None]])
    tiles = flk.transposed_tiles(wb_aug, perm_t)
    np.testing.assert_array_equal(tiles.numpy(), wb_t)
    dx, dwb = flk.fused_layer_dx_dw_plain(
        _t(dy), _t(g), _t(x), wb_aug[:lay.n_param_blocks],
        *flk.dx_dw_schedule_on(lay, "cpu"), blk=block)
    np.testing.assert_allclose(dx.numpy(), _np(jdx), **GRAD)
    np.testing.assert_allclose(dwb.numpy(), _np(jdwb), **GRAD)


@pytest.mark.parametrize("widths,block,l", [
    (_WIDTHS, 8, 0), (_WIDTHS, 8, 1), (_WIDTHS, 16, 0), (_WIDTHS, 16, 1),
    # block 128: a member of 3 input tiles split into one-tile units
    (((300, 200), (5,), (130, 7)), 128, 0),
    # block 8: a member of 64 input tiles split into chunks of 8
    (((512, 384), (13, 5), (7,)), 8, 0),
    # every unit a warp's (no whole-CTA job)
    (((24,), (13, 5), (17, 9), (32, 16, 8)), 8, 1),
])
def test_dx_dw_units_cover_each_output_once(widths, block, l):
    """The backward's work units cover every dx column and every
    parameter tile exactly once, pass-through tiles only in dx; a unit
    reads the tiles of its member's rectangle; jobs hold one unit of the
    whole-CTA kind or up to ``WARP_JOB`` of the warp kind, warp jobs
    first."""
    lay = TLayered(6, 3, widths, jact.ACTIVATION_ORDER[:len(widths)],
                   block=block).bd_layout(l)
    units, ptr = flk.dx_dw_units(lay)
    dx_cover = np.zeros(lay.n_in_tiles, int)
    dw_cover = np.zeros(lay.n_param_blocks, int)
    pass_tiles = set()
    for in0, nc, out0, no, q, ld, warp, _ in units:
        assert nc >= 1 and no >= 1
        dx_cover[in0:in0 + nc] += 1
        if q < 0:
            assert no == nc and warp == 1
            pass_tiles.update(range(in0, in0 + nc))
            continue
        assert nc * block <= max(block, bdk.TEAM_COLS)
        r, c = np.divmod(np.arange(no * nc), nc)
        q_all = q + r * ld + c
        dw_cover[q_all] += 1
        np.testing.assert_array_equal(np.asarray(lay.wb_out_tile)[q_all],
                                      out0 + r)
        np.testing.assert_array_equal(np.asarray(lay.wb_in_tile)[q_all],
                                      in0 + c)
    np.testing.assert_array_equal(dx_cover, 1)
    np.testing.assert_array_equal(dw_cover, 1)
    ident = np.asarray(lay.s_w_t) == lay.n_param_blocks
    assert pass_tiles == set(np.asarray(lay.s_out_t)[ident].tolist())
    assert ptr[0] == 0 and ptr[-1] == len(units)
    for lo, hi in zip(ptr[:-1], ptr[1:]):
        kinds = set(units[lo:hi, 6].tolist())
        assert len(kinds) == 1
        assert hi - lo == 1 if kinds == {0} else 1 <= hi - lo <= bdk.WARP_JOB
    assert np.all(np.diff(units[:, 6]) <= 0)           # warp jobs first
    if widths[0] == (512, 384):
        assert (units[:, 4] >= 0).sum() > 3     # the wide member was split


@pytest.mark.parametrize("widths,block", [
    (_WIDTHS, 8), (_WIDTHS, 16), (((300, 200), (5,), (130, 7)), 128),
    (((512, 384), (13, 5), (7,)), 8)])
def test_dx_dw_units_reach_ties_them_to_their_layout(widths, block):
    """A units table reaches exactly its layout's input and parameter
    tiles and no output tile past it; ``check_reach`` takes it with that
    layout's tensors and refuses it with a narrower layout's, and refuses
    tables ``dx_dw_units`` never gives."""
    lp = TLayered(6, 3, widths, jact.ACTIVATION_ORDER[:len(widths)],
                  block=block)
    lay = lp.bd_layout(0)
    units, ptr = flk.dx_dw_schedule_on(lay, "cpu")
    n_in, n_out, n_param = bdk.units_reach(units.numpy(), ptr.numpy())
    assert (n_in, n_param) == (lay.n_in_tiles, lay.n_param_blocks)
    assert n_out <= lay.n_out_tiles
    assert units.dx_dw_reach == (n_in, n_out, n_param)

    def tensors(lay):
        return (torch.zeros(2, lay.n_in_tiles * block),
                torch.zeros(2, lay.n_out_tiles * block),
                torch.zeros(lay.n_param_blocks, block, block))

    flk.check_reach(units, ptr, *tensors(lay), blk=block)
    narrow = TLayered(6, 3, ((4, 3), (3,)), ("relu", "tanh"),
                      block=block).bd_layout(0)
    with pytest.raises(ValueError, match="another layout"):
        flk.check_reach(units, ptr, *tensors(narrow), blk=block)
    bad = units.numpy().copy()
    bad[0, 1] = 0                                   # a unit of no columns
    with pytest.raises(ValueError, match="not a units table"):
        bdk.units_reach(bad, ptr.numpy())
    with pytest.raises(ValueError, match="not a units table"):
        bdk.units_reach(units.numpy(), ptr.numpy()[::-1])


def test_transposed_csr_rows_are_the_transposed_runs():
    lay = TLayered(6, 3, _WIDTHS, jact.ACTIVATION_ORDER, block=8).bd_layout(0)
    rowptr, s_in, s_w = flk.csr_schedule(lay, transposed=True)
    np.testing.assert_array_equal(rowptr[:-1],
                                  np.flatnonzero(np.asarray(lay.s_first_t)))
    np.testing.assert_array_equal(rowptr[1:] - 1,
                                  np.flatnonzero(np.asarray(lay.s_last_t)))
    np.testing.assert_array_equal(s_in, lay.s_in_t)
    np.testing.assert_array_equal(s_w, lay.s_w_t)


# --------------------------------------------------------------------- #
# fused loss head                                                       #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("o,n_pad", [(3, 0), (3, 5), (2, 3)])
def test_loss_head_plain_matches_jax(o, n_pad):
    """Forward (per-member mean NLL, dlogits) and backward (dh, dW_out),
    pad rows carrying target −1 and B_real the unpadded row count."""
    pop = TLayered(6, o, _WIDTHS, jact.ACTIVATION_ORDER,
                   block=8).layer_pop(2)
    rng = np.random.default_rng(o + n_pad)
    hh = pop.total_hidden
    h = rng.normal(0, 1, (B, hh)).astype(np.float32)
    w2 = (rng.normal(0, 1, (o, hh)) / 4).astype(np.float32)
    b2 = rng.normal(0, 1, (pop.num_members, o)).astype(np.float32)
    tgt = rng.integers(0, o, B).astype(np.int32)
    tgt[B - n_pad:] = -1
    seg = np.asarray(pop.block_segment_ids, np.int32)
    b_real = B - n_pad
    jper, jdl = jlhk.loss_head_fwd(
        jnp.asarray(h), jnp.asarray(w2), jnp.asarray(b2),
        jnp.asarray(tgt)[:, None], jnp.asarray(seg), pop.num_members,
        b_real=b_real, block_h=pop.block, block_b=BLOCK_B, with_dl=True,
        interpret=True)
    ptr = ihk.member_ptr(_t(seg, torch.int32), pop.num_members)
    per, dl = lhk.loss_head_fwd_plain(_t(h), _t(w2), _t(b2),
                                      _t(tgt, torch.int32), ptr,
                                      block=pop.block, b_real=b_real)
    np.testing.assert_allclose(per.numpy(), _np(jper)[0], **FWD)
    np.testing.assert_allclose(dl.numpy(), _np(jdl), **FWD)
    assert not dl[b_real:].any()
    dper = rng.normal(0, 1, pop.num_members).astype(np.float32)
    jdh, jdw = jlhk.loss_head_bwd(jnp.asarray(dper)[None], jdl,
                                  jnp.asarray(h), jnp.asarray(w2),
                                  jnp.asarray(seg), block_h=pop.block,
                                  block_b=BLOCK_B, interpret=True)
    dh, dw = lhk.loss_head_bwd_plain(_t(dper), dl, _t(h), _t(w2),
                                     _t(seg, torch.int32), block=pop.block)
    np.testing.assert_allclose(dh.numpy(), _np(jdh), **GRAD)
    np.testing.assert_allclose(dw.numpy(), _np(jdw), **GRAD)


# --------------------------------------------------------------------- #
# the autograd entries against the JAX custom VJPs                      #
# --------------------------------------------------------------------- #

def _grads(fn, *tensors):
    leaves = [t.clone().requires_grad_(True) for t in tensors]
    out = fn(*leaves)
    cot = torch.from_numpy(np.random.default_rng(5).normal(
        0, 1, tuple(out.shape)).astype(np.float32))
    grads = torch.autograd.grad(out, leaves, cot)
    return out.detach(), grads, cot.numpy()


def test_ops_training_entries_match_jax_vjps():
    """``ops.fused_input`` / ``fused_layer`` / ``loss_head`` — values and
    every input's gradient — against JAX's custom-VJP ops, each one launch
    per direction in the port's counters."""
    x, w, b, ids, mask = _input_case(8, 10, 6, False)
    counts = (fik.launches, fik.bwd_launches)
    y, (dx, dw, db), cot = _grads(
        lambda *a: tops.fused_input(*a, ids, mask, block=8),
        _t(x), _t(w), _t(b))
    assert (fik.launches, fik.bwd_launches) == (counts[0] + 1, counts[1] + 1)
    jy, vjp = jax.vjp(lambda *a: jops.fused_input(*a, ids, mask, block=8),
                      jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_allclose(y.numpy(), _np(jy), **FWD)
    for got, want in zip((dx, dw, db), vjp(jnp.asarray(cot))):
        np.testing.assert_allclose(got.numpy(), _np(want), **GRAD)

    jlp = JLayered(6, 3, _WIDTHS, jact.ACTIVATION_ORDER, block=8)
    tlp = TLayered(6, 3, _WIDTHS, jact.ACTIVATION_ORDER, block=8)
    lay, jlay, x, wb, b_eff, acts, mask = _layer_case(jlp, tlp, 0, False, 3)
    n0 = flk.dx_dw_launches
    y, grads, cot = _grads(
        lambda *a: tops.fused_layer(*a, lay, acts, mask),
        _t(x), _t(wb), _t(b_eff))
    assert flk.dx_dw_launches == n0 + 1
    jy, vjp = jax.vjp(lambda *a: jops.fused_layer(*a, jlay, acts, mask),
                      jnp.asarray(x), jnp.asarray(wb), jnp.asarray(b_eff))
    np.testing.assert_allclose(y.numpy(), _np(jy), **FWD)
    for got, want in zip(grads, vjp(jnp.asarray(cot))):
        np.testing.assert_allclose(got.numpy(), _np(want), **GRAD)

    pop = tlp.layer_pop(2)
    rng = np.random.default_rng(9)
    h = rng.normal(0, 1, (B, pop.total_hidden)).astype(np.float32)
    w2 = (rng.normal(0, 1, (3, pop.total_hidden)) / 4).astype(np.float32)
    b2 = rng.normal(0, 1, (pop.num_members, 3)).astype(np.float32)
    tgt = rng.integers(0, 3, B).astype(np.int32)
    seg = pop.block_segment_ids
    per, grads, cot = _grads(
        lambda *a: tops.loss_head(*a, tgt, seg, block_h=8),
        _t(h), _t(w2), _t(b2))
    jper, vjp = jax.vjp(
        lambda *a: jops.loss_head(*a, jnp.asarray(tgt), seg, block_h=8),
        jnp.asarray(h), jnp.asarray(w2), jnp.asarray(b2))
    np.testing.assert_allclose(per.numpy(), _np(jper), **FWD)
    for got, want in zip(grads, vjp(jnp.asarray(cot))):
        np.testing.assert_allclose(got.numpy(), _np(want), **GRAD)


def test_training_entries_without_grad_run_the_serving_kernels():
    """No gradient to take → the forward-only kernel (same function), as
    JAX's primal runs ``with_deriv=False``; no backward counter moves."""
    x, w, b, ids, mask = _input_case(8, 10, 6, False)
    before = (fik.launches, fik.bwd_launches)
    with torch.no_grad():
        y = tops.fused_input(_t(x), _t(w), _t(b), ids, mask, block=8)
    assert (fik.launches, fik.bwd_launches) == (before[0] + 1, before[1])
    np.testing.assert_allclose(
        y.numpy(), tops.fused_input_infer(_t(x), _t(w), _t(b), ids, mask,
                                          block=8).numpy(), rtol=0, atol=0)
    with pytest.raises(ValueError, match="targets"):
        tops.loss_head(torch.zeros(2, 8), torch.zeros(3, 8),
                       torch.zeros(1, 3), np.zeros(3, np.int32),
                       np.zeros(1, np.int32), block_h=8)
