"""The port's LM layers (``repro_torch.nn``) against the JAX package's
(``repro.nn``) on the CPU: the same numpy inputs, JAX's parameters carried
across with ``models.lm.params_from_jax``, f32 within rtol 1e-5 / atol
1e-6.

Norms, the per-head qk-norm, the tied readout, RoPE and M-RoPE; the q/k/v
projection with qk-norm and with qkv biases; ``attention`` (the port's
one ``ops.flash_attention`` call, on the CPU its plain version) full,
windowed and against JAX's chunked online-softmax path; ``decode_step``
through a ring buffer that wraps; gated and non-gated FFNs; the
capacity-padded MoE (the port's expert FFN three ``ops.moe_gemm`` calls)
with drops, shared experts and the top-k renormalisation off."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import attention as jattn
from repro.nn import common as jcommon
from repro.nn import ffn as jffn
from repro.nn import rope as jrope
from repro_torch.kernels import flash_attn as fak
from repro_torch.kernels import grouped_gemm as moek
from repro_torch.models.lm import params_from_jax
from repro_torch.nn import attention as tattn
from repro_torch.nn import common as tcommon
from repro_torch.nn import ffn as tffn
from repro_torch.nn import rope as trope

TOL = dict(rtol=1e-5, atol=1e-6)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


def _port(params):
    return params_from_jax(jax.tree.map(np.asarray, params), "cpu")


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(0, 1, shape) \
        .astype(np.float32)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms(kind):
    x = _x((2, 5, 24))
    scale = _x((24,), 1) + 1.0
    p = {"scale": scale}
    if kind == "layernorm":
        p["bias"] = _x((24,), 2)
    jp = jax.tree.map(jnp.asarray, p)
    _close(tcommon.norm_apply(_port(jp), torch.tensor(x)),
           jcommon.norm_apply(jp, jnp.asarray(x)))
    np.testing.assert_array_equal(
        _np(tcommon.norm_init(24, torch.float32, kind)["scale"]),
        _np(jcommon.norm_init(24, jnp.float32, kind)[0]["scale"]))


def test_head_norm_and_tied_readout():
    x = _x((2, 5, 3, 2, 16))
    scale = _x((16,), 1)
    _close(tcommon.rms_head_norm(torch.tensor(scale), torch.tensor(x)),
           jcommon.rms_head_norm(jnp.asarray(scale), jnp.asarray(x)))
    emb = {"embedding": _x((40, 24), 2)}
    h = _x((2, 5, 24), 3)
    _close(tcommon.embed_attend(_port(emb), torch.tensor(h)),
           jcommon.embed_attend(jax.tree.map(jnp.asarray, emb),
                                jnp.asarray(h)))
    toks = np.array([[0, 39, 7], [3, 3, 12]])
    np.testing.assert_array_equal(
        _np(tcommon.embed_apply(_port(emb), torch.tensor(toks))),
        _np(jcommon.embed_apply(jax.tree.map(jnp.asarray, emb),
                                jnp.asarray(toks))))


@pytest.mark.parametrize("act", sorted(tcommon.FFN_ACTS))
def test_ffn_activations(act):
    x = _x((64,)) * 3
    _close(tcommon.FFN_ACTS[act](torch.tensor(x)),
           jcommon.FFN_ACTS[act](jnp.asarray(x)))


def test_rope_and_mrope():
    b, s, h, d = 2, 7, 3, 16
    q, k = _x((b, s, h, d)), _x((b, s, 2, d), 1)
    pos = np.tile(np.arange(3, 3 + s), (b, 1)).astype(np.int32)
    pos[1] += 5
    for got, want in zip(
            trope.apply_rope(torch.tensor(q), torch.tensor(k),
                             torch.tensor(pos), d, 1e4),
            jrope.apply_rope(jnp.asarray(q), jnp.asarray(k),
                             jnp.asarray(pos), d, 1e4)):
        _close(got, want)
    pos3 = np.stack([pos, pos * 2, pos + 1])
    for got, want in zip(
            trope.apply_mrope(torch.tensor(q), torch.tensor(k),
                              torch.tensor(pos3), d, 1e6, (2, 3, 3)),
            jrope.apply_mrope(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(pos3), d, 1e6, (2, 3, 3))):
        _close(got, want)


def _attn_cfg(**kw):
    base = dict(d_model=32, n_heads=4, n_kv_heads=2, d_head=8)
    base.update(kw)
    return jattn.AttnConfig(**base), tattn.AttnConfig(**base)


def _attn_params(jcfg, seed=0):
    jp, _ = jattn.attn_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    # non-trivial norms and biases, so that a dropped term shows
    rng = np.random.default_rng(seed + 10)
    jp = jax.tree.map(lambda a: a + rng.normal(0, 0.1, a.shape)
                      .astype(np.float32), jp)
    return jp, _port(jp)


@pytest.mark.parametrize("kw", [dict(qk_norm=True), dict(qkv_bias=True),
                                dict(bias=True)],
                         ids=["qk_norm", "qkv_bias", "bias"])
def test_qkv_project_and_out_project(kw):
    jcfg, tcfg = _attn_cfg(**kw)
    jp, tp = _attn_params(jcfg)
    x = _x((2, 6, 32))
    for got, want in zip(tattn.qkv_project(tp, tcfg, torch.tensor(x)),
                         jattn.qkv_project(jp, jcfg, jnp.asarray(x))):
        _close(got, want)
    o = _x((2, 6, 2, 2, 8), 1)
    _close(tattn.out_project(tp, tcfg, torch.tensor(o)),
           jattn.out_project(jp, jcfg, jnp.asarray(o)))
    assert sorted(tp) == sorted(jp)


@pytest.mark.parametrize("window,kind,chunked", [
    (None, "rope", False), (5, "rope", False), (None, "rope", True),
    (5, "rope", True), (None, "mrope", False), (None, "none", True)])
def test_attention_is_one_flash_call(window, kind, chunked):
    """The port's attention (one ``ops.flash_attention`` call) against
    JAX's dense path, or its chunked path (``chunked_threshold`` below S,
    chunks of 1024 padded), with the post-rope k and v."""
    jcfg, tcfg = _attn_cfg(qk_norm=True, sliding_window=window,
                           rope_kind=kind, mrope_sections=(1, 1, 2))
    jp, tp = _attn_params(jcfg, 1)
    b, s = 2, 20
    x = _x((b, s, 32), 2)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    if kind == "mrope":
        pos = np.stack([pos] * 3)
    before = fak.launches
    y, (k, v) = tattn.attention(tp, tcfg, torch.tensor(x),
                                torch.tensor(pos), return_kv=True)
    assert fak.launches == before + 1
    jy, (jk, jv) = jattn.attention(
        jp, jcfg, jnp.asarray(x), jnp.asarray(pos), return_kv=True,
        chunked_threshold=8 if chunked else 2048)
    _close(y, jy)
    _close(k, jk)
    _close(v, jv)


def test_decode_step_through_a_ring_that_wraps():
    """Twelve one-token steps into a ring of 8 slots (a window of 8), from
    an empty cache: each step's output and the whole cache as JAX's."""
    jcfg, tcfg = _attn_cfg(qk_norm=True, sliding_window=8)
    jp, tp = _attn_params(jcfg, 2)
    b = 2
    jcache = jattn.init_kv_cache(jcfg, b, 32, jnp.float32)
    tcache = tattn.init_kv_cache(tcfg, b, 32, torch.float32)
    assert tcache["k"].shape == jcache["k"].shape == (b, 8, 2, 8)
    xs = _x((12, b, 1, 32), 3)
    for i in range(12):
        cur = np.array([i, i + 3], np.int32)
        y, tcache = tattn.decode_step(tp, tcfg, torch.tensor(xs[i]), tcache,
                                      torch.tensor(cur))
        jy, jcache = jattn.decode_step(jp, jcfg, jnp.asarray(xs[i]), jcache,
                                       jnp.asarray(cur))
        _close(y, jy)
        for key in ("k", "v"):
            _close(tcache[key], jcache[key])
        np.testing.assert_array_equal(tcache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
    assert (tcache["pos"] >= 0).all()


@pytest.mark.parametrize("gated,act,bias", [(True, "silu", False),
                                            (True, "gelu", True),
                                            (False, "relu2", False),
                                            (False, "relu", True)])
def test_dense_ffn(gated, act, bias):
    jcfg = jffn.FFNConfig(24, 40, act=act, gated=gated, bias=bias)
    tcfg = tffn.FFNConfig(24, 40, act=act, gated=gated, bias=bias)
    jp, _ = jffn.ffn_init(jax.random.PRNGKey(3), jcfg, jnp.float32)
    jp = jax.tree.map(lambda a: a + 0.05, jp)
    x = _x((2, 5, 24), 4)
    _close(tffn.ffn_apply(_port(jp), tcfg, torch.tensor(x)),
           jffn.ffn_apply(jp, jcfg, jnp.asarray(x)))
    tp = tffn.ffn_init(torch.Generator().manual_seed(0), tcfg, torch.float32)
    assert jax.tree.map(np.shape, jp) == \
        {k: {n: tuple(t.shape) for n, t in v.items()} for k, v in tp.items()}


@pytest.mark.parametrize("renorm,shared,factor", [
    (False, 2, 0.5), (True, 0, 0.5), (True, 1, 1.25)],
    ids=["drops_shared_no_renorm", "drops_renorm", "no_drops_shared"])
def test_moe_apply_dense(renorm, shared, factor):
    """64 tokens top-2 of 4 experts: at a capacity factor of 0.5 every
    expert's buffer holds 16 rows and some assignments drop."""
    kw = dict(d_model=16, d_expert=8, num_experts=4, top_k=2,
              num_shared=shared, renorm_topk=renorm,
              capacity_factor=factor)
    jcfg, tcfg = jffn.MoEConfig(**kw), tffn.MoEConfig(**kw)
    jp, _ = jffn.moe_init(jax.random.PRNGKey(5), jcfg, jnp.float32)
    tp = _port(jp)
    x = _x((4, 16, 16), 5)
    before = moek.launches
    y, aux = tffn.moe_apply_dense(tp, tcfg, torch.tensor(x))
    assert moek.launches == before + 3
    jy, jaux = jffn.moe_apply_dense(jp, jcfg, jnp.asarray(x))
    _close(y, jy)
    _close(aux, jaux)
    cap = tffn.moe_capacity(tcfg, 64)
    _, eidx, _ = tffn._route(tp["router"], tcfg, torch.tensor(x)
                             .reshape(64, 16))
    dropped = (torch.bincount(eidx.reshape(-1), minlength=4) - cap) \
        .clamp_min(0).sum()
    assert (dropped > 0) == (factor < 1), (cap, dropped)
    tree = tffn.moe_init(torch.Generator().manual_seed(0), tcfg,
                         torch.float32)
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), jp) == \
        jax.tree.map(lambda t: (tuple(t.shape),
                                str(t.dtype).removeprefix("torch.")), tree)


def test_block_rows():
    """The grouped GEMM's run length: the largest multiple of 8 dividing
    the capacity, up to 128."""
    assert [tffn.block_rows(c) for c in (8, 16, 24, 120, 128, 240, 256,
                                         480, 512)] == \
        [8, 16, 24, 120, 128, 120, 128, 120, 128]
