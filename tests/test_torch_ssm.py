"""The port's Mamba2 mixer (``repro_torch.nn.ssm``) and Hymba's hybrid mixer
(``repro_torch.nn.hybrid``) against the JAX package's (``repro.nn.ssm``,
``repro.nn.hybrid``) on the CPU, on the same numpy inputs from a seed and
JAX's parameters carried across with ``models.lm.params_from_jax``.

JAX's ``tests/test_ssm.py`` as parity: the chunked SSD against JAX's and
against the sequential recurrence at two chunk sizes, initial-state
chaining, decode against the full layer, the prefill cache against the
decode path, a sequence that is not a multiple of the chunk.  The port
against JAX in f32 within rtol 1e-5 / atol 1e-5 (the same products summed
in another order); the port against the recurrence and decode against the
full layer at the JAX tests' own 1e-4 and 2e-4 (two algorithms).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import attention as jattn
from repro.nn import hybrid as jhybrid
from repro.nn import ssm as jssm
from repro_torch.kernels import flash_attn as fak
from repro_torch.models.lm import params_from_jax
from repro_torch.nn import attention as tattn
from repro_torch.nn import hybrid as thybrid
from repro_torch.nn import ssm as tssm

TOL = dict(rtol=1e-5, atol=1e-5)
# JAX's functions jitted once (a config is a static argument): eager JAX
# compiles each of their many small ops on first use
J_SCAN = jax.jit(jssm.ssd_scan, static_argnums=5)
J_APPLY = jax.jit(jssm.ssm_apply, static_argnums=1,
                  static_argnames="return_cache")
J_STEP = jax.jit(jssm.ssm_decode_step, static_argnums=1)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _scan_inputs(seed, bs, s, h, p, g, n):
    """x, dt (post-softplus), a (negative), b, c as numpy f32."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (bs, s, h, p))
    dt = np.log1p(np.exp(rng.normal(0, 1, (bs, s, h))))
    a = -np.exp(rng.normal(0, 1, (h,)))
    b = rng.normal(0, 1, (bs, s, g, n))
    c = rng.normal(0, 1, (bs, s, g, n))
    return [v.astype(np.float32) for v in (x, dt, a, b, c)]


def _recurrence(x, dt, a, b, c):
    """h_t = exp(a·dt_t)·h_{t−1} + dt_t·x_t·b_tᵀ; y_t = h_t·c_t (torch)."""
    bs, s, h, p = x.shape
    rep = h // b.shape[2]
    bh, ch = b.repeat_interleave(rep, 2), c.repeat_interleave(rep, 2)
    state = torch.zeros(bs, h, p, b.shape[3])
    ys = []
    for t in range(s):
        decay = torch.exp(a[None] * dt[:, t])
        state = state * decay[..., None, None] + torch.einsum(
            "bhp,bhn->bhpn", x[:, t] * dt[:, t, :, None], bh[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, ch[:, t]))
    return torch.stack(ys, 1), state


@pytest.mark.parametrize("chunk", [4, 8])
def test_ssd_matches_jax_and_the_recurrence(chunk):
    arrs = _scan_inputs(0, 2, 16, 4, 8, 2, 16)
    y, st = tssm.ssd_scan(*map(torch.from_numpy, arrs), chunk)
    jy, jst = J_SCAN(*map(jnp.asarray, arrs), chunk)
    _close(y, jy)
    _close(st, jst)
    ry, rst = _recurrence(*map(torch.from_numpy, arrs))
    _close(y, ry, dict(rtol=1e-4, atol=1e-4))
    _close(st, rst, dict(rtol=1e-4, atol=1e-4))


def test_initial_state_chaining():
    """Two halves with the state carried equal one pass, and each half
    equals JAX's."""
    x, dt, a, b, c = map(torch.from_numpy, _scan_inputs(1, 1, 32, 2, 4, 1,
                                                        8))
    y_full, st_full = tssm.ssd_scan(x, dt, a, b, c, 8)
    y1, st1 = tssm.ssd_scan(x[:, :16], dt[:, :16], a, b[:, :16], c[:, :16],
                            8)
    y2, st2 = tssm.ssd_scan(x[:, 16:], dt[:, 16:], a, b[:, 16:], c[:, 16:],
                            8, initial_state=st1)
    j = [jnp.asarray(t.numpy()) for t in (x, dt, a, b, c)]
    _, jst1 = J_SCAN(j[0][:, :16], j[1][:, :16], j[2], j[3][:, :16],
                     j[4][:, :16], 8)
    jy2, jst2 = J_SCAN(j[0][:, 16:], j[1][:, 16:], j[2], j[3][:, 16:],
                       j[4][:, 16:], 8, jst1)
    _close(y2, jy2)
    _close(st2, jst2)
    _close(torch.cat([y1, y2], 1), y_full, dict(rtol=1e-4, atol=1e-4))
    _close(st2, st_full, dict(rtol=1e-4, atol=1e-4))


def _layer(seed=0, d=32, **kw):
    cfg = dict(d_model=d, d_state=16, head_dim=16, chunk=8, **kw)
    jp, _ = jssm.ssm_init(jax.random.PRNGKey(seed), jssm.SSMConfig(**cfg),
                          jnp.float32)
    return (tssm.SSMConfig(**cfg), jssm.SSMConfig(**cfg),
            params_from_jax(jax.tree.map(np.asarray, jp), "cpu"), jp)


def test_init_has_jax_structure():
    cfg, jcfg, p, jp = _layer()
    got = tssm.ssm_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    assert jax.tree.structure(jax.tree.map(lambda _: 0, jp)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, got))
    for name in got:
        for g, w in zip(jax.tree.leaves(got[name]),
                        jax.tree.leaves(jp[name])):
            assert tuple(g.shape) == w.shape and \
                str(g.dtype).removeprefix("torch.") == str(w.dtype), name
    assert bool((got["A_log"] >= 0).all() and (got["A_log"] < np.log(16))
                .all())
    dt0 = torch.nn.functional.softplus(got["dt_bias"])
    assert bool((dt0 >= cfg.dt_min * 0.999).all()
                and (dt0 <= cfg.dt_max * 1.001).all())


def test_decode_matches_full_layer():
    cfg, jcfg, p, jp = _layer()
    xs = np.random.default_rng(1).normal(0, 1, (2, 24, 32)) \
        .astype(np.float32)
    x = torch.from_numpy(xs)
    full = tssm.ssm_apply(p, cfg, x)
    _close(full, J_APPLY(jp, jcfg, jnp.asarray(xs)))
    cache = tssm.init_ssm_cache(cfg, 2, torch.float32)
    jcache = jssm.init_ssm_cache(jcfg, 2, jnp.float32)
    outs = []
    for t in range(24):
        o, cache = tssm.ssm_decode_step(p, cfg, x[:, t:t + 1], cache)
        jo, jcache = J_STEP(jp, jcfg, jnp.asarray(xs[:, t:t + 1]), jcache)
        _close(o, jo)
        outs.append(o)
    _close(cache["conv"], jcache["conv"])
    _close(cache["state"], jcache["state"])
    _close(torch.cat(outs, 1), full, dict(rtol=2e-4, atol=2e-4))


def test_prefill_cache_matches_decode_path():
    """ssm_apply(return_cache) over 20 steps (not a multiple of the chunk
    of 8), then a decode step, equals decoding all the way; the prefill's
    cache is JAX's."""
    cfg, jcfg, p, jp = _layer()
    xs = np.random.default_rng(2).normal(0, 1, (1, 21, 32)) \
        .astype(np.float32)
    x = torch.from_numpy(xs)
    out, cache_pre = tssm.ssm_apply(p, cfg, x[:, :20], return_cache=True)
    jout, jcache = J_APPLY(jp, jcfg, jnp.asarray(xs[:, :20]),
                           return_cache=True)
    _close(out, jout)
    _close(cache_pre["conv"], jcache["conv"])
    _close(cache_pre["state"], jcache["state"])
    cache_seq = tssm.init_ssm_cache(cfg, 1, torch.float32)
    for t in range(20):
        _, cache_seq = tssm.ssm_decode_step(p, cfg, x[:, t:t + 1], cache_seq)
    o1, _ = tssm.ssm_decode_step(p, cfg, x[:, 20:21], cache_pre)
    o2, _ = tssm.ssm_decode_step(p, cfg, x[:, 20:21], cache_seq)
    _close(o1, o2, dict(rtol=2e-4, atol=2e-4))


@pytest.mark.parametrize("s", [2, 13, 21])
def test_ssm_apply_off_the_chunk_matches_jax(s):
    """S below d_conv − 1 + 1, inside one chunk, and across chunks with a
    ragged tail: output, final state and conv tail against JAX's; two
    groups of state projections."""
    cfg, jcfg, p, jp = _layer(3, n_groups=2)
    xs = np.random.default_rng(s).normal(0, 1, (2, s, 32)).astype(np.float32)
    out, cache = tssm.ssm_apply(p, cfg, torch.from_numpy(xs),
                                return_cache=True)
    jout, jcache = J_APPLY(jp, jcfg, jnp.asarray(xs), return_cache=True)
    _close(out, jout)
    for key in ("conv", "state"):
        _close(cache[key], jcache[key])


def _hybrid(seed=0):
    acfg = dict(d_model=32, n_heads=4, n_kv_heads=2, d_head=8)
    scfg = dict(d_model=32, d_state=16, head_dim=16, chunk=8)
    jcfg = jhybrid.HybridConfig(jattn.AttnConfig(**acfg),
                                jssm.SSMConfig(**scfg))
    tcfg = thybrid.HybridConfig(tattn.AttnConfig(**acfg),
                                tssm.SSMConfig(**scfg))
    jp, _ = jhybrid.hybrid_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    # a learned β apart from its init of ones
    jp["beta"] = jnp.asarray([0.7, 1.3], jnp.float32)
    return tcfg, jcfg, params_from_jax(jax.tree.map(np.asarray, jp),
                                       "cpu"), jp


def _jax_hybrid(jp, jcfg, xs, pos, window, s, steps):
    """JAX's mixer over the prompt, the caches as its prefill builds them,
    then ``steps`` decode steps → (y, the steps' outputs, the caches)."""
    from repro.models.lm import _kv_to_ring

    def run(jp, xs, pos):
        y = jhybrid.hybrid_apply(jp, jcfg, xs[:, :s], pos, window=window)
        _, (k, v) = jattn.attention(jp["attn"], jcfg.attn, xs[:, :s], pos,
                                    window=window, return_kv=True)
        _, scache = jssm.ssm_apply(jp["ssm"], jcfg.ssm, xs[:, :s],
                                   return_cache=True)
        cache = {"attn": _kv_to_ring(k, v, s, s + steps), "ssm": scache}
        outs = []
        for t in range(s, s + steps):
            o, cache = jhybrid.hybrid_decode_step(
                jp, jcfg, xs[:, t:t + 1], cache,
                jnp.full((xs.shape[0],), t, jnp.int32), window=window)
            outs.append(o)
        return y, outs, cache

    return jax.jit(run)(jp, jnp.asarray(xs), jnp.asarray(pos))


@pytest.mark.parametrize("window", [0, 6])
def test_hybrid_mixer_matches_jax(window):
    """hybrid_apply (one flash launch) and, from the prefill's caches (the
    attention's ring written as models.lm.prefill writes it), three
    hybrid_decode_step's, against JAX's."""
    from repro_torch.models.lm import _kv_to_ring
    tcfg, jcfg, p, jp = _hybrid()
    s, steps = 12, 3
    xs = np.random.default_rng(4).normal(0, 1, (2, s + steps, 32)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (2, s)).copy()
    jy, jouts, jcache = _jax_hybrid(jp, jcfg, xs, pos, window, s, steps)
    n0 = fak.launches
    y, (k, v), scache = thybrid.hybrid_apply(
        p, tcfg, torch.from_numpy(xs[:, :s]), torch.from_numpy(pos),
        window=window, return_cache=True)
    assert fak.launches == n0 + 1
    _close(y, jy)
    _close(thybrid.hybrid_apply(p, tcfg, torch.from_numpy(xs[:, :s]),
                                torch.from_numpy(pos), window=window), jy)
    cache = {"attn": _kv_to_ring(k, v, s, s + steps), "ssm": scache}
    for i, jo in enumerate(jouts):
        t = s + i
        o, cache = thybrid.hybrid_decode_step(
            p, tcfg, torch.from_numpy(xs[:, t:t + 1]), cache,
            torch.full((2,), t, dtype=torch.int32), window=window)
        _close(o, jo)
    _close(cache["ssm"]["state"], jcache["ssm"]["state"])
    _close(cache["attn"]["k"], jcache["attn"]["k"])
