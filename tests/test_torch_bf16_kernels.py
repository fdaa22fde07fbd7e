"""The plain versions of the kernels on bf16 operands (the bf16 compute
policy), against the JAX package's Pallas kernels in interpret mode on the
same bf16 inputs: the input layer (y; y and g') and its backward (dW, dx),
the mid layer (y; y and g') and its one-pass backward (dx, dWB), the loss
head (per, dl; dh, dW) and the serving head; the unfused route's
block-diagonal GEMM (y, its dh and dWB, through ``ops.block_diag_gemm``
and autograd), the M3 kernels (y, dh, dW2, through ``ops.m3_matmul``), the
three int8 serving twins on bf16 activations, and the segmented activation
and its backward (``ops.seg_act`` on bf16 h and dy).
Inputs are made with numpy from a seed and rounded to bf16 once, the same
values on both sides; the backward comparisons feed both sides the same
residuals (JAX's g' and dl).

JAX's kernels widen bf16 tiles into an f32 accumulator
(``preferred_element_type``), round du = dy·g' and dl·d_per to bf16 where
they multiply two bf16 tiles, and store each bf16 output once from its f32
value.  XLA's CPU compiler may keep such a bf16 intermediate in f32 (its
``xla_allow_excess_precision``, on by default: JAX's interpret-mode
fused_input backward then rounds du for dx and not for dW), so the JAX
kernels here run compiled with that liberty off (``_jax``): they compute
what their source says.  Tolerance: a bf16 output within one bf16 ulp,
element by element
(both round an f32 sum once, and two orders of that sum may round to
neighbouring bf16 values); an f32 output (logits, per, dl) at rtol 1e-5 /
atol 1e-6 (both sum exact f32 products, in other orders).  The bias
cotangents are held to JAX's f32 sum of f32 products at rtol 1e-6 through
the port's own autograd backward.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.activations import ACTIVATION_ORDER
from repro.core.population import LayeredPopulation as JLayered
from repro.kernels import fused_input as jfik
from repro.kernels import ops as jops
from repro_torch.core.population import LayeredPopulation as TLayered
from repro_torch.kernels import block_diag as bdk
from repro_torch.kernels import fused_input as fik
from repro_torch.kernels import fused_layer as flk
from repro_torch.kernels import infer_head as ihk
from repro_torch.kernels import loss_head as lhk
from repro_torch.kernels import m3_matmul as m3k
from repro_torch.kernels import ops as tops
from repro_torch.kernels import seg_act as sak

F32 = dict(rtol=1e-5, atol=1e-6)


def _bf16(a):
    """numpy → (the same bf16 values for JAX, for torch)."""
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(
        torch.bfloat16)



def _jax(fn, *args):
    """``fn(*args)`` (array arguments; the rest closed over in ``fn``)
    jitted and compiled without XLA's excess precision."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_allow_excess_precision": False})(*args)


def _as_bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(
        torch.bfloat16)


def _ordered(t: torch.Tensor) -> np.ndarray:
    """bf16 values → integers in the order of the values, one apart for
    neighbouring bf16 numbers (±0 both 0)."""
    i = t.contiguous().view(torch.int16).numpy().astype(np.int32)
    return np.where(i < 0, -(i & 0x7FFF), i)


def _within_one_bf16_ulp(got: torch.Tensor, want):
    assert got.dtype == torch.bfloat16
    want = _as_bf16(want)
    assert got.shape == want.shape
    assert np.abs(_ordered(got) - _ordered(want)).max() <= 1


def _input_case(b, f, block, n_blocks, seed):
    """x, W (bf16 both sides), bias, mask, ids; JAX's x and W zero-padded
    to its feature tile (the padding adds exact zeros)."""
    rng = np.random.default_rng(seed)
    h = block * n_blocks
    jx, tx = _bf16(rng.normal(0, 1, (b, f)))
    jw, tw = _bf16(rng.normal(0, 1, (h, f)) / np.sqrt(f))
    bias = rng.normal(0, 1, h).astype(np.float32)
    mask = (rng.random(h) > 0.2).astype(np.float32)
    ids = (np.arange(n_blocks) % len(ACTIVATION_ORDER)).astype(np.int32)
    f_pad = -(-f // 8) * 8
    jx = jnp.pad(jx, ((0, 0), (0, f_pad - f)))
    jw = jnp.pad(jw, ((0, 0), (0, f_pad - f)))
    return (jx, jw, tx, tw, bias, mask, ids)


@pytest.mark.parametrize("b,f,block,n_blocks", [
    (8, 24, 8, 10), (16, 100, 8, 6), (8, 100, 128, 2)])
def test_fused_input_fwd(b, f, block, n_blocks):
    """y and (y, g') in bf16 from bf16 x and W, f32 bias and mask."""
    jx, jw, tx, tw, bias, mask, ids = _input_case(b, f, block, n_blocks, b)
    jargs = (jx, jw, jnp.asarray(bias)[None], jnp.asarray(mask)[None],
             jnp.asarray(ids))
    targs = (tx, tw, torch.from_numpy(bias), torch.from_numpy(mask),
             torch.from_numpy(ids))
    y = fik.fused_input_plain(*targs, block=block)
    _within_one_bf16_ulp(y, _jax(lambda *a: jfik.fused_input_fwd(
        *a, block=block, block_b=8, with_deriv=False, interpret=True),
        *jargs))
    jy, jg = _jax(lambda *a: jfik.fused_input_fwd(
        *a, block=block, block_b=8, with_deriv=True, interpret=True), *jargs)
    ty, tg = fik.fused_input_train_plain(*targs, block=block)
    _within_one_bf16_ulp(ty, jy)
    _within_one_bf16_ulp(tg, jg)
    assert torch.equal(ty, y)


@pytest.mark.parametrize("b,f,block,n_blocks", [(16, 24, 8, 10),
                                                (8, 100, 8, 6)])
def test_fused_input_bwd(b, f, block, n_blocks):
    """dW and dx in bf16: du = dy·g' rounded to bf16, sums in f32 (B 16:
    two of JAX's batch tiles, dW carried across them)."""
    jx, jw, tx, tw, *_ = _input_case(b, f, block, n_blocks, 3 * b)
    rng = np.random.default_rng(b + f)
    h = block * n_blocks
    jdy, tdy = _bf16(rng.normal(0, 1, (b, h)))
    jg, tg = _bf16(rng.random((b, h)) * (rng.random(h) > 0.2))
    jdx, jdw = _jax(lambda *a: jfik.fused_input_bwd(
        *a, block=block, block_b=8, interpret=True), jdy, jg, jx, jw)
    dx, dw = fik.fused_input_bwd_plain(tdy, tg, tx, tw, with_dx=True)
    _within_one_bf16_ulp(dw, jdw[:, :f])
    _within_one_bf16_ulp(dx, jdx[:, :f])
    assert fik.fused_input_bwd_plain(tdy, tg, tx, tw, with_dx=False)[0] \
        is None


_MID = [(((24,), (13, 5), (17, 9), (32, 16, 8)), 8),
        (((64, 32, 16), (13, 5), (7,)) * 2, 8),      # the depth-3 members
        (((40, 20), (17, 33, 9), (7,), (3, 5)), 16)]


def _mid_layers(widths, block):
    acts = tuple(ACTIVATION_ORDER[i % 10] for i in range(len(widths)))
    return (JLayered(5, 3, widths, acts, block=block),
            TLayered(5, 3, widths, acts, block=block))


@pytest.mark.parametrize("widths,block", _MID)
def test_fused_layer_fwd_and_dx_dw(widths, block):
    """Each mid layer: y (serving) and (y, g') (training) in bf16, then dx
    and dWB from the same dy and JAX's g' (pass-through members through
    the identity tile)."""
    jlp, tlp = _mid_layers(widths, block)
    rng = np.random.default_rng(block + len(widths))
    b = 16
    for l in range(jlp.depth - 1):
        jlay, tlay = jlp.bd_layout(l), tlp.bd_layout(l)
        pout = jlp.layer_pop(l + 1)
        jh, th = _bf16(rng.normal(0, 1, (b, jlay.n_in_tiles * block)))
        jw, tw = _bf16(rng.normal(0, 1, (jlay.n_param_blocks, block, block))
                       / np.sqrt(block))
        b_eff = rng.normal(0, 1, jlay.n_out_tiles * block).astype(np.float32)
        mask = np.array(pout.hidden_mask, np.float32)
        acts = np.array(pout.block_act_ids, np.int32)
        s_act = acts[np.asarray(jlay.s_out, np.int32)]
        acts_s = jops._StaticArray(s_act, np.int32)
        mask_s = jops._StaticArray(mask, np.float32)
        jy, (_, _, jgp) = _jax(lambda h, w, b: jops._fused_fwd(
            h, w, b, jlay, acts_s, mask_s, 8, True), jh, jw,
            jnp.asarray(b_eff))
        wb_aug = torch.cat([tw, torch.eye(block, dtype=torch.bfloat16)[None]])
        targs = (th, wb_aug, torch.from_numpy(b_eff), torch.from_numpy(mask),
                 torch.from_numpy(acts), *flk.schedule_on(tlay, "cpu"))
        ty, tg = flk.fused_layer_train_plain(*targs, blk=block)
        _within_one_bf16_ulp(ty, jy)
        _within_one_bf16_ulp(tg, jgp)
        _within_one_bf16_ulp(
            flk.fused_layer_plain(*targs, blk=block),
            _jax(lambda h, w, b: jops.fused_layer_infer(
                h, w, b, jlay, acts, mask, interpret=True), jh, jw,
                jnp.asarray(b_eff)))
        jdy, tdy = _bf16(rng.normal(0, 1, (b, jlay.n_out_tiles * block)))
        jdh, jdwb, jdb = _jax(lambda h, w, g, d: jops._fused_bwd(
            jlay, acts_s, mask_s, 8, True, (h, w, g), d), jh, jw, jgp, jdy)
        g = _as_bf16(jgp)
        dx, dwb = flk.fused_layer_dx_dw_plain(
            tdy, g, th, tw, *flk.dx_dw_schedule_on(tlay, "cpu"), blk=block)
        _within_one_bf16_ulp(dx, jdh)
        _within_one_bf16_ulp(dwb, jdwb)
        # the bias cotangent through the port's autograd backward, on the
        # same residuals: an f32 sum of f32 products, as JAX's
        ctx = SimpleNamespace(saved_tensors=(th, wb_aug, g), layout=tlay,
                              needs_input_grad=(True, True, True))
        got = tops._FusedLayer.backward(ctx, tdy)
        assert got[2].dtype == torch.float32
        np.testing.assert_allclose(got[2].numpy(), np.asarray(jdb),
                                   rtol=1e-6, atol=0)
        assert torch.equal(got[0], dx) and torch.equal(got[1], dwb)


def test_bias_cotangents_sum_f32_products():
    """Σ_b dy·g' under bf16: the port's input-layer backward (its autograd
    ``backward`` on JAX's residuals) returns JAX's db — the f32 sum of f32
    products of the bf16 values — within rtol 1e-6, where a sum of bf16
    products (what ``(dy * g).sum(0)`` gives on bf16 tensors) misses it by
    far more."""
    b, f, block, n = 32, 24, 8, 16
    jx, jw, tx, tw, bias, mask, ids = _input_case(b, f, block, n, 11)
    rng = np.random.default_rng(12)
    jdy, tdy = _bf16(rng.normal(0, 1, (b, block * n)))
    static = (jops._StaticArray(ids, np.int32),
              jops._StaticArray(mask, np.float32), block, 8, True)
    _, res = _jax(lambda x, w, b: jops._fin_fwd(x, w, b, *static), jx, jw,
                  jnp.asarray(bias))
    _, _, jdb = _jax(lambda x, w, g, d: jops._fin_bwd(*static, (x, w, g), d),
                     *res, jdy)
    g = _as_bf16(res[2])
    ctx = SimpleNamespace(saved_tensors=(tx, tw, g),
                          needs_input_grad=(False, True, True))
    got = tops._FusedInput.backward(ctx, tdy)[2]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jdb), rtol=1e-6,
                               atol=0)
    naive = (tdy * g).sum(0).float().numpy()
    assert not np.allclose(naive, np.asarray(jdb), rtol=1e-6, atol=0)


_HEADS = [((128,) * 6, 128, 2, 32), ((8, 16, 8, 16, 16, 8, 24), 8, 2, 16),
          ((40, 12, 100, 4), 4, 5, 24)]


def _segments(widths, block):
    blocks = [-(-w // block) for w in widths]
    seg = np.repeat(np.arange(len(widths)), blocks).astype(np.int32)
    ptr = ihk.member_ptr(torch.from_numpy(seg), len(widths))
    return seg, ptr, int(sum(blocks)) * block


@pytest.mark.parametrize("widths,block,o,b", _HEADS)
def test_loss_head_fwd_bwd(widths, block, o, b):
    """per and dl in f32 from bf16 h and W_out; then dh and dW_out in
    bf16, dl·d_per rounded to bf16 before each product (from JAX's dl)."""
    rng = np.random.default_rng(b + o)
    seg, ptr, hh = _segments(widths, block)
    jh, th = _bf16(rng.normal(0, 1, (b, hh)))
    jw, tw = _bf16(rng.normal(0, 1, (o, hh)) / 4)
    b2 = rng.normal(0, 1, (len(widths), o)).astype(np.float32)
    tgt = rng.integers(0, o, b).astype(np.int32)
    tgt[-2:] = -1
    seg_s = jops._StaticArray(seg, np.int32)
    jper, (_, _, jdl) = _jax(lambda h, w, b2_, t: jops._lh_fwd(
        h, w, b2_, t, seg_s, b - 2, block, 8, True), jh, jw, jnp.asarray(b2),
        jnp.asarray(tgt)[:, None])
    per, dl = lhk.loss_head_fwd_plain(th, tw, torch.from_numpy(b2),
                                      torch.from_numpy(tgt), ptr,
                                      block=block, b_real=b - 2)
    assert per.dtype == dl.dtype == torch.float32
    np.testing.assert_allclose(per.numpy(), np.asarray(jper), **F32)
    np.testing.assert_allclose(dl.numpy(), np.asarray(jdl), **F32)
    dper = rng.normal(0, 1, len(widths)).astype(np.float32)
    jdh, jdw = _jax(lambda h, w, dl_, d: jops._lh_bwd(
        seg_s, b - 2, block, 8, True, (h, w, dl_), d)[:2], jh, jw, jdl,
        jnp.asarray(dper))
    tdl = torch.from_numpy(np.array(jdl))
    dh, dw = lhk.loss_head_bwd_plain(torch.from_numpy(dper), tdl, th, tw,
                                     torch.from_numpy(seg), block=block)
    _within_one_bf16_ulp(dh, jdh)
    _within_one_bf16_ulp(dw, jdw)


@pytest.mark.parametrize("log_probs", [False, True])
@pytest.mark.parametrize("widths,block,o,b", _HEADS)
def test_infer_head(widths, block, o, b, log_probs):
    """f32 logits (log-probs) from bf16 h and W_out through ops, as the
    serving forward calls it."""
    rng = np.random.default_rng(3 * b + o)
    seg, _, hh = _segments(widths, block)
    jh, th = _bf16(rng.normal(0, 1, (b, hh)))
    jw, tw = _bf16(rng.normal(0, 1, (o, hh)) / 4)
    b2 = rng.normal(0, 1, (len(widths), o)).astype(np.float32)
    want = _jax(lambda h, w: jops.infer_head(
        h, w, b2, seg, block_h=block, log_probs=log_probs, interpret=True),
        jh, jw)
    n0 = ihk.bf16_launches
    got = tops.infer_head(th, tw, torch.from_numpy(b2), seg, block_h=block,
                          log_probs=log_probs)
    assert ihk.bf16_launches == n0 + 1 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_operands_of_two_dtypes_are_refused():
    """The policy's operands come in one dtype: f32 activations with bf16
    weights (or the reverse) raise, as do bf16 biases."""
    x, w = torch.zeros(2, 8), torch.zeros(8, 8, dtype=torch.bfloat16)
    ids, mask = np.zeros(1, np.int32), np.ones(8, np.float32)
    with pytest.raises(TypeError, match="one dtype"):
        tops.fused_input(x, w, torch.zeros(8), ids, mask, block=8)
    with pytest.raises(TypeError, match="one dtype"):
        tops.fused_input(x.bfloat16(), w.float(), torch.zeros(8), ids, mask,
                         block=8)
    with pytest.raises(TypeError, match="float32"):
        tops.fused_input(x.bfloat16(), w, torch.zeros(8).bfloat16(), ids,
                         mask, block=8)


# --------------------------------------------------------------------- #
# the unfused route, the M3 kernels and the int8 twins under bf16       #
# --------------------------------------------------------------------- #

def _grads(fn, *operands, dy):
    """``fn`` on copies of ``operands`` that need a gradient → (output, its
    cotangents' gradients with respect to each operand, for ``dy``)."""
    leaves = [t.clone().requires_grad_(True) for t in operands]
    y = fn(*leaves)
    return (y.detach(), *torch.autograd.grad(y, leaves, dy))


_BD = [(((24,), (13, 5), (17, 9), (32, 16, 8)), 8, 70),
       (((64, 32, 16), (13, 5), (7,)) * 2, 8, 40),   # the depth-3 members
       (((40, 20), (17, 33, 9), (7,), (3, 5)), 16, 9)]


@pytest.mark.parametrize("widths,block,b", _BD)
def test_block_diag_gemm_fwd_dh_dw(widths, block, b):
    """y, dh and dWB in bf16 from bf16 h, tiles and dy, through
    ``ops.block_diag_gemm`` and autograd (the plain versions, counted as
    bf16 launches), against JAX's ``block_diag_gemm`` and its VJP in
    interpret mode on 32-row batch tiles (B 70 and 40: dWB summed over
    three and two of them, rounded once)."""
    jlp, tlp = _mid_layers(widths, block)
    rng = np.random.default_rng(block + b)
    for l in range(jlp.depth - 1):
        jlay, tlay = jlp.bd_layout(l), tlp.bd_layout(l)
        jh, th = _bf16(rng.normal(0, 1, (b, jlay.n_in_tiles * block)))
        jw, tw = _bf16(rng.normal(0, 1, (jlay.n_param_blocks, block, block))
                       / np.sqrt(block))
        jdy, tdy = _bf16(rng.normal(0, 1, (b, jlay.n_out_tiles * block)))

        def jfn(h, w, dy):
            y, vjp = jax.vjp(lambda h_, w_: jops.block_diag_gemm(
                h_, w_, jlay, block_b=32, interpret=True), h, w)
            return (y, *vjp(dy))

        jy, jdh, jdw = _jax(jfn, jh, jw, jdy)
        n0 = (bdk.bf16_fwd_launches, bdk.bf16_dw_launches,
              bdk.fwd_launches, bdk.dw_launches)
        ty, tdh, tdw = _grads(
            lambda h, w: tops.block_diag_gemm(h, w, tlay), th, tw, dy=tdy)
        assert (bdk.bf16_fwd_launches, bdk.bf16_dw_launches,
                bdk.fwd_launches, bdk.dw_launches) == (
            n0[0] + 2, n0[1] + 1, n0[2], n0[3])
        for got, want in ((ty, jy), (tdh, jdh), (tdw, jdw)):
            _within_one_bf16_ulp(got, want)


@pytest.mark.parametrize("widths,block,o,b", _HEADS)
def test_m3_matmul_fwd_dh_dw(widths, block, o, b):
    """The M3 kernels on bf16 h, w2 and dy through ``ops.m3_matmul`` and
    autograd: bf16 logits (rounded once, as JAX's out dtype), dh and dW2,
    against JAX's ``m3_matmul`` and its VJP in interpret mode on 8-row
    batch tiles (dW2 summed over them, rounded once)."""
    rng = np.random.default_rng(5 * b + o)
    seg, _, hh = _segments(widths, block)
    p = len(widths)
    jh, th = _bf16(rng.normal(0, 1, (b, hh)))
    jw, tw = _bf16(rng.normal(0, 1, (o, hh)) / 4)
    jdy, tdy = _bf16(rng.normal(0, 1, (b, p, o)))

    def jfn(h, w, dy):
        y, vjp = jax.vjp(lambda h_, w_: jops.m3_matmul(
            h_, w_, seg, p, block_h=block, block_b=8, interpret=True), h, w)
        return (y, *vjp(dy))

    jy, jdh, jdw = _jax(jfn, jh, jw, jdy)
    n0 = (m3k.bf16_fwd_launches, m3k.bf16_dh_launches, m3k.bf16_dw_launches,
          m3k.fwd_launches)
    ty, tdh, tdw = _grads(lambda h, w: tops.m3_matmul(
        h, w, seg, p, block_h=block), th, tw, dy=tdy)
    assert (m3k.bf16_fwd_launches, m3k.bf16_dh_launches,
            m3k.bf16_dw_launches, m3k.fwd_launches) == (
        n0[0] + 1, n0[1] + 1, n0[2] + 1, n0[3])
    for got, want in ((ty, jy), (tdh, jdh), (tdw, jdw)):
        _within_one_bf16_ulp(got, want)


def test_int8_twins_on_bf16_activations():
    """The three int8 serving kernels on bf16 activations (the int8 copy
    under the policy): the input and mid layers' bf16 outputs within one
    bf16 ulp, the head's f32 logits and log-probs at the f32 tolerance, of
    JAX's int8 twins in interpret mode on the same int8 bytes, f32 scales
    and bf16 activations; each counted as a ``bf16_int8`` launch.  The
    scales are what ``quantize_population`` gives the initial weights
    (max |w| / 127, |w| ≤ 1/sqrt(fan-in))."""
    rng = np.random.default_rng(31)
    b, f, block, n = 12, 100, 8, 7
    h = block * n
    f_pad = 104
    jx, tx = _bf16(rng.normal(0, 1, (b, f)))
    wq = rng.integers(-127, 128, (h, f_pad)).astype(np.int8)
    ws = ((rng.random(n) * 0.2 + 0.8) / np.sqrt(f) / 127).astype(np.float32)
    bias = rng.normal(0, 1, h).astype(np.float32)
    mask = (rng.random(h) > 0.2).astype(np.float32)
    ids = (np.arange(n) % len(ACTIVATION_ORDER)).astype(np.int32)
    want = _jax(lambda x, w: jops.fused_input_infer_int8(
        x, w, jnp.asarray(ws), jnp.asarray(bias), ids, mask, block=block,
        interpret=True), jx, jnp.asarray(wq))
    n0 = fik.bf16_int8_launches
    got = tops.fused_input_infer_int8(tx, torch.from_numpy(wq),
                                      torch.from_numpy(ws),
                                      torch.from_numpy(bias), ids, mask,
                                      block=block)
    assert fik.bf16_int8_launches == n0 + 1
    _within_one_bf16_ulp(got, want)

    jlp, tlp = _mid_layers(((64, 32, 16), (13, 5), (7,), (40, 20)), 8)
    for l in range(jlp.depth - 1):
        jlay, tlay = jlp.bd_layout(l), tlp.bd_layout(l)
        pout = jlp.layer_pop(l + 1)
        jh, th = _bf16(rng.normal(0, 1, (b, jlay.n_in_tiles * 8)))
        wbq = rng.integers(-127, 128, (jlay.n_param_blocks + 1, 8, 8)
                           ).astype(np.int8)
        wbq[-1] = np.eye(8, dtype=np.int8)
        wbs = ((rng.random(jlay.n_param_blocks + 1) * 0.2 + 0.8)
               / np.sqrt(64) / 127).astype(np.float32)
        wbs[-1] = 1.0
        b_eff = rng.normal(0, 1, jlay.n_out_tiles * 8).astype(np.float32)
        acts = np.array(pout.block_act_ids, np.int32)
        mk = np.array(pout.hidden_mask, np.float32)
        want = _jax(lambda x, w: jops.fused_layer_infer_int8(
            x, w, jnp.asarray(wbs), jnp.asarray(b_eff), jlay, acts, mk,
            interpret=True), jh, jnp.asarray(wbq))
        n0 = flk.bf16_int8_launches
        got = tops.fused_layer_infer_int8(
            th, torch.from_numpy(wbq), torch.from_numpy(wbs),
            torch.from_numpy(b_eff), tlay, acts, mk)
        assert flk.bf16_int8_launches == n0 + 1
        _within_one_bf16_ulp(got, want)

    widths, block, o = (8, 16, 8, 16, 16, 8, 24), 8, 2
    seg, _, hh = _segments(widths, block)
    jh, th = _bf16(rng.normal(0, 1, (b, hh)))
    w2q = rng.integers(-127, 128, (o, hh)).astype(np.int8)
    w2s = ((rng.random(hh // block) * 0.2 + 0.8) / np.sqrt(16) / 127
           ).astype(np.float32)
    b2 = rng.normal(0, 1, (len(widths), o)).astype(np.float32)
    for log_probs in (False, True):
        want = _jax(lambda x, w: jops.infer_head_int8(
            x, w, jnp.asarray(w2s), jnp.asarray(b2), seg, block_h=block,
            log_probs=log_probs, interpret=True), jh, jnp.asarray(w2q))
        n0 = ihk.bf16_int8_launches
        got = tops.infer_head_int8(th, torch.from_numpy(w2q),
                                   torch.from_numpy(w2s),
                                   torch.from_numpy(b2), seg,
                                   block_h=block, log_probs=log_probs)
        assert ihk.bf16_int8_launches == n0 + 1
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


# --------------------------------------------------------------------- #
# the segmented activation on bf16 h and dy                             #
# --------------------------------------------------------------------- #
# JAX's kernel evaluates each activation in bf16 arithmetic, op by op
# (compiled without excess precision, a multi-op activation rounds several
# times); the port's plain version computes it in f32 on the widened values
# and rounds once.  So they are held at JAX's own bf16 tolerance for the
# kernel (tests/test_kernels.py: rtol/atol 2e-2), and the port alone within
# one bf16 ulp of the f64 value rounded once.


def _f64_rounded(t: torch.Tensor) -> torch.Tensor:
    """An f64 tensor rounded to bf16 (through f32: where that rounds twice
    it lands on a neighbour of the once-rounded value, still within one
    ulp of the f32 computation's once-rounded result)."""
    return t.to(torch.bfloat16)


def _seg_case(rng, b, blocks, block, first):
    ids = ((np.arange(blocks) + first) % len(ACTIVATION_ORDER)
           ).astype(np.int32)
    hh = blocks * block
    mask = (rng.random(hh) > 0.2).astype(np.float32)
    jh, th = _bf16(rng.normal(0, 1, (b, hh)))
    jdy, tdy = _bf16(rng.normal(0, 1, (b, hh)))
    return ids, mask, jh, th, jdy, tdy


@pytest.mark.parametrize("b,blocks,block", [(4, 3, 8), (9, 10, 8),
                                            (2, 4, 16)])
def test_seg_act_fwd_bwd_against_jax(b, blocks, block):
    """tests/test_kernels.py's shapes, each run until every one of the ten
    activations has had a block: the port's plain bf16 ``seg_act`` and
    ``seg_act_bwd`` against JAX's interpret-mode kernels (its custom VJP)
    at JAX's 2e-2, the largest ulp distance printed by activation; and
    within one bf16 ulp of the f64 function rounded once."""
    rng = np.random.default_rng(b * blocks)
    for first in range(0, len(ACTIVATION_ORDER), blocks):
        ids, mask, jh, th, jdy, tdy = _seg_case(rng, b, blocks, block, first)

        def jax_fwd_bwd(h, dy):
            y, vjp = jax.vjp(lambda a: jops.seg_act(
                a, ids, mask, block_h=block, interpret=True), h)
            return y, vjp(dy)[0]

        jy, jdh = _jax(jax_fwd_bwd, jh, jdy)
        tids, tmask = torch.tensor(ids), torch.tensor(mask)
        ty = sak.seg_act_plain(th, tids, tmask, blk=block)
        tdh = sak.seg_act_bwd_plain(th, tdy, tids, tmask, blk=block)
        ey = sak.seg_act_plain(th.double(), tids, tmask.double(), blk=block)
        edh = sak.seg_act_bwd_plain(th.double(), tdy.double(), tids,
                                    tmask.double(), blk=block)
        cols = np.repeat(ids, block)
        for what, got, want, exact in (("y", ty, jy, ey),
                                       ("dh", tdh, jdh, edh)):
            assert got.dtype == torch.bfloat16
            np.testing.assert_allclose(
                got.float().numpy(), np.asarray(want, np.float32),
                rtol=2e-2, atol=2e-2, err_msg=what)
            d = np.abs(_ordered(got) - _ordered(_as_bf16(want)))
            print(f"{what} vs JAX, largest ulp distance by activation: "
                  + str({ACTIVATION_ORDER[i]: int(d[:, cols == i].max())
                         for i in sorted(set(ids))}))
            assert np.abs(_ordered(got)
                          - _ordered(_f64_rounded(exact))).max() <= 1, what


def test_seg_act_bf16_every_input_against_f64():
    """Every bf16 value in [−12, 12] through each activation and its
    derivative: the plain bf16 version within one bf16 ulp of the f64
    value rounded once, but where the f32 derivative forms cancel (JAX's
    forms, the f32 kernels' too): tanh' = 1 − t² for |x| > 6.5 and
    sigmoid' = s·(1 − s) for |x| > 11, whose true values lie below 2^-16
    and 2^-15; there the f32 result is within 2^-23 of them."""
    allb = torch.arange(-32768, 32768, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16)
    v = allb[torch.isfinite(allb.float()) & (allb.float().abs() <= 12)]
    h = v[:v.numel() // 8 * 8].reshape(1, -1)
    ones = torch.ones(h.shape[1])
    for a, name in enumerate(ACTIVATION_ORDER):
        ids = torch.full((h.shape[1] // 8,), a, dtype=torch.int32)
        for what, got, exact in (
                ("y", sak.seg_act_plain(h, ids, ones, blk=8),
                 sak.seg_act_plain(h.double(), ids, ones.double(), blk=8)),
                ("dh", sak.seg_act_bwd_plain(h, torch.ones_like(h), ids,
                                             ones, blk=8),
                 sak.seg_act_bwd_plain(h.double(), torch.ones_like(
                     h, dtype=torch.float64), ids, ones.double(), blk=8))):
            d = np.abs(_ordered(got) - _ordered(_f64_rounded(exact)))[0]
            edge = {"tanh": 6.5, "sigmoid": 11.0}.get(name)
            far = h[0].float().abs().numpy() > (edge or np.inf)
            if what == "dh" and edge:
                err = (got.double() - exact).abs()[0].numpy()
                assert err[far].max() <= 2.0 ** -23, (name, what)
            assert d[~far if what == "dh" else slice(None)].max() <= 1, (
                name, what)


def test_ops_seg_act_bf16_forward_and_backward():
    """``ops.seg_act`` takes bf16 h: a bf16 output, a bf16 gradient through
    its custom backward, each the plain version's bits, one launch each
    counted under the ``bf16_`` counters (the f32 counters untouched)."""
    rng = np.random.default_rng(5)
    block, blocks, b = 8, 12, 6
    ids = (np.arange(blocks) % len(ACTIVATION_ORDER)).astype(np.int32)
    mask = (rng.random(block * blocks) > 0.2).astype(np.float32)
    _, h = _bf16(rng.normal(0, 1, (b, block * blocks)))
    _, dy = _bf16(rng.normal(0, 1, (b, block * blocks)))
    n0 = (sak.launches, sak.bwd_launches, sak.bf16_launches,
          sak.bf16_bwd_launches)
    hg = h.clone().requires_grad_(True)
    y = tops.seg_act(hg, ids, mask, block=block)
    (dh,) = torch.autograd.grad(y, (hg,), dy)
    assert y.dtype == dh.dtype == torch.bfloat16
    assert (sak.launches, sak.bwd_launches, sak.bf16_launches,
            sak.bf16_bwd_launches) == (n0[0], n0[1], n0[2] + 1, n0[3] + 1)
    tids, tmask = torch.tensor(ids), torch.tensor(mask)
    assert torch.equal(y.detach(), sak.seg_act_plain(h, tids, tmask,
                                                     blk=block))
    assert torch.equal(dh, sak.seg_act_bwd_plain(h, dy, tids, tmask,
                                                 blk=block))
    with pytest.raises(TypeError, match="float32, or bfloat16"):
        tops.seg_act(h.half(), ids, mask, block=block)
