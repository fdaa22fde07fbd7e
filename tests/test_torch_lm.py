"""The port's decoder LMs (``repro_torch.models.lm``,
``repro_torch.launch.serve``) against the JAX package's on the CPU, for
each of the seven attention LMs' ``reduced()`` configs: JAX's parameters
(``lm.init_params(PRNGKey(0))``) carried across with ``params_from_jax``,
the same numpy prompts.

- ``forward``'s logits and aux loss, ``loss_and_metrics``;
- ``prefill``'s last logits and every cache (k, v, pos), over a prompt of
  20 tokens, longer than the sliding windows of 16 (danube, mixtral): the
  ring wraps;
- four teacher-forced ``make_serve_step`` steps, logits and caches;
- ``generate_lm``'s greedy tokens equal to JAX's (the token frontends);
- the launches: one flash attention per attention layer per prefill,
  none in decode; three grouped GEMMs per MoE layer per forward.

f32 within rtol 1e-5 / atol 1e-5 (three layers of f32 sums in another
order); the bf16 case (qwen3 reduced, ``param_dtype="bfloat16"``) within
2e-2 of the outputs' scale.  JAX's results are built once per config (module fixtures)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.launch import serve as jserve
from repro.launch.mesh import make_host_mesh
from repro.models import lm as jlm
from repro_torch.configs import LM_ARCH_IDS, get_arch
from repro_torch.core.tree import tree_leaves
from repro_torch.kernels import flash_attn as fak
from repro_torch.kernels import grouped_gemm as moek
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm

TOL = dict(rtol=1e-5, atol=1e-5)
B, S, STEPS = 2, 20, 4


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _configs(arch_id, bf16=False):
    jarch, tarch = jax_arch(arch_id, reduced=True), \
        get_arch(arch_id, reduced=True)
    if bf16:
        jarch = dataclasses.replace(jarch, model=dataclasses.replace(
            jarch.model, param_dtype="bfloat16"))
        tarch = dataclasses.replace(tarch, model=dataclasses.replace(
            tarch.model, param_dtype="bfloat16"))
    return jarch, tarch


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S + STEPS))
         .astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend == "embeds":
        b["embeds"] = rng.normal(0, 1, (B, S + STEPS, cfg.d_model)) \
            .astype(np.float32)
    return b


def _prompt(cfg, batch, lo, hi):
    if cfg.frontend == "embeds":
        return {"embeds": batch["embeds"][:, lo:hi]}
    return {"tokens": batch["tokens"][:, lo:hi]}


def _torch(tree):
    return {k: torch.as_tensor(v) for k, v in tree.items()}


def _jax_run(jarch, batch):
    """JAX's forward and loss, prefill, four teacher-forced decode steps,
    and the greedy tokens of ``generate_lm``'s loop (its prefill, serve
    step and ``_pick``, jitted once here), as numpy."""
    cfg = jarch.model
    params = jax.jit(lambda k: jlm.init_params(k, cfg)[0])(
        jax.random.PRNGKey(0))
    full = {"labels": jnp.asarray(batch["labels"]),
            **jax.tree.map(jnp.asarray, _prompt(cfg, batch, 0, S))}
    (logits, aux), (loss, metrics) = jax.jit(lambda p, b: (
        jlm.forward(p, cfg, b), jlm.loss_and_metrics(p, cfg, b)))(params,
                                                                   full)
    prefill = jax.jit(lambda p, b: jlm.prefill(p, cfg, b,
                                               max_len=S + STEPS))
    step = jax.jit(jlm.make_serve_step(cfg))
    last, caches = prefill(params, _prompt(cfg, batch, 0, S))
    out = {"params": jax.tree.map(np.asarray, params),
           "logits": np.asarray(logits, np.float32), "aux": float(aux),
           "loss": float(loss), "xent": float(metrics["loss"]),
           "prefill": np.asarray(last, np.float32),
           "caches": jax.tree.map(np.asarray, caches), "steps": []}
    for i in range(STEPS):
        pos = jnp.full((B,), S + i, jnp.int32)
        lg, caches = step(params, caches, _prompt(cfg, batch, S + i,
                                                  S + i + 1), pos)
        out["steps"].append((np.asarray(lg, np.float32),
                             jax.tree.map(np.asarray, caches)))
    if cfg.frontend == "tokens":
        lg, caches = prefill(params, _prompt(cfg, batch, 0, S))
        toks = [jnp.asarray(batch["tokens"][:, :S])]
        for i in range(STEPS):
            toks.append(jserve._pick(lg, True, 1.0, None))
            if i < STEPS - 1:
                lg, caches = step(params, caches, {"tokens": toks[-1]},
                                  jnp.full((B,), S + i, jnp.int32))
        out["tokens"] = np.asarray(jnp.concatenate(toks, axis=1))
    return out


@pytest.fixture(scope="module", params=LM_ARCH_IDS)
def case(request):
    jarch, tarch = _configs(request.param)
    batch = _batch(jarch.model)
    return tarch, batch, _jax_run(jarch, batch)


def _caches_close(got, want, tol=TOL):
    assert sorted(got) == sorted(want)
    for g in want:
        for key in ("k", "v"):
            _close(got[g][key], want[g][key], tol)
        np.testing.assert_array_equal(got[g]["pos"].numpy(), want[g]["pos"])


def test_forward_loss_prefill_and_decode_match_jax(case):
    tarch, batch, want = case
    cfg = tarch.model
    params = tlm.params_from_jax(want["params"], "cpu")
    full = {"labels": torch.as_tensor(batch["labels"]),
            **_torch(_prompt(cfg, batch, 0, S))}
    logits, aux = tlm.forward(params, cfg, full)
    _close(logits, want["logits"])
    _close(aux, want["aux"])
    total, metrics = tlm.loss_and_metrics(params, cfg, full)
    _close(total, want["loss"])
    _close(metrics["loss"], want["xent"])
    assert float(metrics["tokens"]) == B * S
    attn_layers = sum(1 for l in cfg.layers if l.mixer == "attn")
    moe_layers = sum(1 for l in cfg.layers if l.ffn == "moe")
    f0, m0 = fak.launches, moek.launches
    last, caches = tlm.prefill(params, cfg, _torch(_prompt(cfg, batch, 0, S)),
                               max_len=S + STEPS)
    assert (fak.launches - f0, moek.launches - m0) == \
        (attn_layers, 3 * moe_layers)
    _close(last, want["prefill"])
    _caches_close(caches, want["caches"])
    step = tlm.make_serve_step(cfg)
    for i, (wl, wc) in enumerate(want["steps"]):
        f0, m0 = fak.launches, moek.launches
        pos = torch.full((B,), S + i, dtype=torch.int32)
        lg, caches = step(params, caches,
                          _torch(_prompt(cfg, batch, S + i, S + i + 1)), pos)
        assert (fak.launches - f0, moek.launches - m0) == \
            (0, 3 * moe_layers)
        _close(lg, wl)
        _caches_close(caches, wc)


def test_generate_lm_greedy_tokens_match_jax(case):
    tarch, batch, want = case
    if tarch.model.frontend != "tokens":
        with pytest.raises(ValueError, match="token prompts"):
            tserve.generate_lm(tarch, batch["tokens"][:, :S], STEPS, "cpu")
        return
    params = tlm.params_from_jax(want["params"], "cpu")
    toks, stats = tserve.generate_lm(tarch, batch["tokens"][:, :S], STEPS,
                                     "cpu", params=params)
    np.testing.assert_array_equal(toks.numpy(), want["tokens"])
    assert toks.shape == (B, S + STEPS) and stats["tok_per_s"] > 0


def test_init_params_has_jax_structure_shapes_and_dtypes(case):
    """The port's init (reduced, on the CPU) and its meta-device tree (the
    full config) against JAX's: the same keys, shapes and dtypes; the
    parameter counts JAX's."""
    tarch, _, want = case
    cfg = tarch.model
    got = tlm.init_params(torch.Generator().manual_seed(0), cfg)

    def spec(tree):
        if isinstance(tree, dict):
            return {k: spec(v) for k, v in tree.items()}
        if isinstance(tree, torch.Tensor):
            return tuple(tree.shape), str(tree.dtype).removeprefix("torch.")
        return tuple(tree.shape), str(tree.dtype)

    assert spec(got) == spec(want["params"])
    full = get_arch(tarch.arch_id).model
    jfull = jax_arch(tarch.arch_id).model
    assert spec(tlm.init_params(None, full)) == \
        spec(jlm.abstract_params(jfull)[0])
    assert (full.num_params(), full.num_active_params()) == \
        (jfull.num_params(), jfull.num_active_params())
    assert all(t.device.type == "cpu" for t in tree_leaves(got))


def test_generate_lm_matches_jax_generate_lm():
    """qwen3 reduced: JAX's own ``generate_lm`` (parameters from
    ``PRNGKey(0)``, on its host mesh) and the port's on the same
    parameters give the same greedy tokens."""
    jarch, tarch = _configs("qwen3-1.7b")
    prompts = _batch(jarch.model, 2)["tokens"][:, :S]
    want, _ = jserve.generate_lm(jarch, jnp.asarray(prompts), STEPS,
                                 make_host_mesh())
    jparams, _ = jlm.init_params(jax.random.PRNGKey(0), jarch.model)
    params = tlm.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    got, _ = tserve.generate_lm(tarch, prompts, STEPS, "cpu", params=params)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _scaled_close(got, want, rel=2e-2):
    """|got − want| ≤ rel · max|want|: bf16 rounding moves every output
    by a share of the outputs' scale, not of its own size."""
    got, want = _np(got), _np(want)
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), \
        (np.abs(got - want).max(), np.abs(want).max())


def test_bf16_qwen3_matches_jax():
    """qwen3 reduced with bf16 parameters: forward, prefill, its caches and
    two decode steps within 2e-2 of the scale of JAX's outputs; the
    forward's logits no farther than JAX's from JAX's f32 forward on the
    same (bf16) parameters (the flash route keeps the scores and the
    softmax in f32 where JAX rounds them to bf16)."""
    jarch, tarch = _configs("qwen3-1.7b", bf16=True)
    cfg, jcfg = tarch.model, jarch.model
    toks = _batch(cfg, 1)["tokens"]
    jparams = jax.jit(lambda k: jlm.init_params(k, jcfg)[0])(
        jax.random.PRNGKey(0))
    params = tlm.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    assert params["embed"]["embedding"].dtype == torch.bfloat16
    prompt = {"tokens": jnp.asarray(toks[:, :S])}
    logits, _ = tlm.forward(params, cfg, _torch(prompt))
    jlogits, _ = jlm.forward(jparams, jcfg, prompt)
    ref, _ = jlm.forward(jax.tree.map(lambda a: a.astype(jnp.float32),
                                      jparams),
                         dataclasses.replace(jcfg, param_dtype="float32"),
                         prompt)
    _scaled_close(logits, jlogits)
    assert np.abs(_np(logits) - _np(ref)).max() <= \
        np.abs(_np(jlogits) - _np(ref)).max()
    last, caches = tlm.prefill(params, cfg, _torch(prompt), max_len=S + 2)
    jlast, jcaches = jlm.prefill(jparams, jcfg, prompt, max_len=S + 2)
    _scaled_close(last, jlast)
    for g, want in jcaches.items():
        for key in ("k", "v"):
            _scaled_close(caches[g][key], want[key])
        np.testing.assert_array_equal(caches[g]["pos"].numpy(),
                                      np.asarray(want["pos"]))
    step, jstep = tlm.make_serve_step(cfg), jlm.make_serve_step(jcfg)
    for i in range(2):
        t = toks[:, S + i:S + i + 1]
        lg, caches = step(params, caches, {"tokens": torch.as_tensor(t)},
                          torch.full((B,), S + i, dtype=torch.int32))
        jlg, jcaches = jstep(jparams, jcaches, {"tokens": jnp.asarray(t)},
                             jnp.full((B,), S + i, jnp.int32))
        _scaled_close(lg, jlg)
        assert lg.dtype == torch.bfloat16


def test_unported_archs_and_mixers_name_their_items():
    """The encoder-decoder names its ROADMAP item; every mixer of JAX's
    LM is ported (the SSM and hybrid LMs: tests/test_torch_lm_ssm.py), and
    a mixer JAX has not raises."""
    with pytest.raises(NotImplementedError, match=r"9\(c\)"):
        get_arch("whisper-small", reduced=True)
    assert tlm.MIXERS == ("attn", "ssm", "hybrid")
    cfg = get_arch("qwen3-1.7b", reduced=True).model
    odd = dataclasses.replace(cfg, layers=(tlm.LayerSpec("conv", "none"),))
    for call in (lambda: tlm.init_params(None, odd),
                 lambda: tlm.init_caches(odd, 1, 4)):
        with pytest.raises(ValueError, match="conv"):
            call()
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


def test_serve_main_prints_tokens(capsys):
    toks, stats = tserve.main(["--arch", "qwen3-1.7b", "--device", "cpu",
                               "--batch", "2", "--prompt-len", "8",
                               "--tokens", "4"])
    out = capsys.readouterr().out
    assert "generated (2, 12) tokens" in out and toks.shape == (2, 12)
    toks2, _ = tserve.main(["--arch", "qwen3-1.7b", "--device", "cpu",
                            "--batch", "2", "--prompt-len", "8", "--tokens",
                            "4", "--sample"])
    assert toks2.shape == (2, 12) and toks2.dtype == torch.int32
    assert torch.equal(toks2[:, :8], toks[:, :8])
