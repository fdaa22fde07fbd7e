"""The SSM and hybrid LMs in the port (``repro_torch.models.lm`` with the
``ssm`` and ``hybrid`` mixers, ``launch.serve.generate_lm``) against the
JAX package's on the CPU, for mamba2-780m's and hymba-1.5b's ``reduced()``
configs: JAX's parameters (``lm.init_params(PRNGKey(0))``) carried across
with ``params_from_jax``, the same numpy prompts and batch.

- ``forward``'s logits and loss; ``prefill``'s last logits and every cache
  leaf (hymba's attention ring and both SSM caches) over a prompt of 20
  tokens, past hymba's sliding window of 16 and not a multiple of the SSM
  chunk of 16; four teacher-forced ``make_serve_step`` steps;
- ``generate_lm``'s greedy tokens equal to JAX's;
- the launches: one flash attention per hybrid layer a prefill, none in
  decode or in mamba2;
- the gradients of ``loss_and_metrics`` and one ``make_train_step`` update
  (AdamW, ``warmup_cosine`` at step 3 of 10), its flash launches;
- ``train.main --arch <arch> --reduced --device cpu``: three steps, a
  flash launch per hybrid layer a step;
- JAX's ``test_hymba_window_pattern_is_heterogeneous`` on the port;
- a reduced LM with ``d_head`` 192 (nemotron-4-340b's head width): forward
  and prefill.

Tolerances are those of ``tests/test_torch_lm.py`` (serving, rtol 1e-5 /
atol 1e-5) and ``tests/test_torch_lm_train.py`` (training, rtol 1e-5 /
atol 1e-6, AdamW's first step within 2·lr where JAX's gradient is within
its atol of zero), the atol taken of the compared outputs' scale where it
exceeds 1 (``_close``).  JAX's side is jitted once per config (module
fixtures)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.launch import serve as jserve
from repro.launch.cells import build_optimizer as jax_build_optimizer
from repro.models import lm as jlm
from repro.nn.attention import AttnConfig as JAttnConfig
from repro.nn.ffn import FFNConfig as JFFNConfig
from repro.optim import warmup_cosine as jwarmup_cosine
from repro_torch.configs import SSM_ARCH_IDS, get_arch
from repro_torch.core.tree import tree_leaves
from repro_torch.kernels import flash_attn as fak
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.nn.attention import AttnConfig
from repro_torch.nn.ffn import FFNConfig
from repro_torch.optim.optimizers import build_optimizer, warmup_cosine

TOL = dict(rtol=1e-5, atol=1e-5)
# training: the optimizer's rtol 1e-5 and, for the gradients, atol 2e-6:
# the SSD's backward (exp of segment sums, L × L decays) is summed in
# another order by JAX's autodiff of its einsums than by autograd of the
# port's pairwise products; hymba's in_proj gradient (scale 0.93) moves
# by up to 1.5e-6, 13 f32 ulps (the attention LMs' 1e-6 holds mamba2's)
TRAIN_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=2e-6)
ADAM_EPS = 1e-8
B, S, STEPS = 2, 20, 4
STEP, WARMUP, TOTAL = 3, 2, 10


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: small CPU layers run many tiny ops, which a
    full thread pool slows when the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, tol=TOL, what=""):
    """Within rtol, and atol taken of the outputs' scale where it exceeds
    1: the tied logits of these configs reach 41, where one f32 ulp is
    3.8e-6 and three layers of sums in another order move a logit by a
    few of them (1.3e-5 for mamba2, 1.7e-5 for hymba)."""
    got, want = _np(got), _np(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, err_msg=what, rtol=tol["rtol"],
                               atol=tol["atol"] * scale)


def _trees_close(got, want, tol=TOL, what=""):
    """Leaf by leaf in JAX's order: int32 leaves (ring positions) equal."""
    gl, wl = tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl), what
    for i, (a, b) in enumerate(zip(gl, wl)):
        assert tuple(a.shape) == np.shape(b), (what, i)
        if a.dtype == torch.int32:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            _close(a, b, tol, f"{what} leaf {i}")


def _tokens(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (B, S + STEPS))
            .astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}


def _jax_serve(cfg, params, toks, greedy: bool = True):
    """JAX's forward and loss, prefill, teacher-forced decode steps and
    greedy tokens, as numpy."""
    full = {"tokens": jnp.asarray(toks["tokens"][:, :S]),
            "labels": jnp.asarray(toks["labels"])}
    (logits, _), (loss, _) = jax.jit(lambda p, b: (
        jlm.forward(p, cfg, b), jlm.loss_and_metrics(p, cfg, b)))(params,
                                                                   full)
    prefill = jax.jit(lambda p, t: jlm.prefill(p, cfg, {"tokens": t},
                                               max_len=S + STEPS))
    step = jax.jit(jlm.make_serve_step(cfg))
    last, caches = prefill(params, full["tokens"])
    out = {"logits": np.asarray(logits), "loss": float(loss),
           "prefill": np.asarray(last),
           "caches": jax.tree.map(np.asarray, caches), "steps": []}
    for i in range(STEPS):
        t = jnp.asarray(toks["tokens"][:, S + i:S + i + 1])
        lg, caches = step(params, caches, {"tokens": t},
                          jnp.full((B,), S + i, jnp.int32))
        out["steps"].append((np.asarray(lg),
                             jax.tree.map(np.asarray, caches)))
    if greedy:
        lg, caches = prefill(params, full["tokens"])
        seq = [full["tokens"]]
        for i in range(STEPS):
            seq.append(jserve._pick(lg, True, 1.0, None))
            if i < STEPS - 1:
                lg, caches = step(params, caches, {"tokens": seq[-1]},
                                  jnp.full((B,), S + i, jnp.int32))
        out["tokens"] = np.asarray(jnp.concatenate(seq, axis=1))
    return out


@pytest.fixture(scope="module", params=SSM_ARCH_IDS)
def case(request):
    """JAX's parameters, its serving results, gradients and one AdamW
    step, as numpy."""
    jarch = jax_arch(request.param, reduced=True)
    cfg = jarch.model
    params = jax.jit(lambda k: jlm.init_params(k, cfg)[0])(
        jax.random.PRNGKey(0))
    toks = _tokens(cfg)
    out = _jax_serve(cfg, params, toks)
    jb = {"tokens": jnp.asarray(toks["tokens"][:, :S]),
          "labels": jnp.asarray(toks["labels"])}
    (total, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_and_metrics(p, cfg, b), has_aux=True))(
        params, jb)
    opt = jax_build_optimizer(jarch)
    fn = jlm.make_train_step(cfg, opt, jwarmup_cosine(jarch.lr, WARMUP,
                                                      TOTAL))
    p1, s1, m1 = jax.jit(fn)(params, opt.init(params), jb,
                             jnp.asarray(STEP, jnp.int32))
    out.update(arch=get_arch(request.param, reduced=True), toks=toks,
               params=jax.tree.map(np.asarray, params), total=float(total),
               grads=jax.tree.map(np.asarray, grads),
               step=jax.tree.map(np.asarray, (p1, s1, m1)))
    return out


def _hybrid_layers(cfg) -> int:
    return sum(1 for ls in cfg.layers if ls.mixer in ("attn", "hybrid"))


def test_forward_prefill_and_decode_match_jax(case):
    cfg = case["arch"].model
    params = tlm.params_from_jax(case["params"], "cpu")
    toks = case["toks"]
    prompt = {"tokens": torch.from_numpy(toks["tokens"][:, :S])}
    logits, _ = tlm.forward(params, cfg, prompt)
    _close(logits, case["logits"])
    total, _ = tlm.loss_and_metrics(
        params, cfg, {**prompt, "labels": torch.from_numpy(toks["labels"])})
    _close(total, case["loss"])
    f0 = fak.launches
    last, caches = tlm.prefill(params, cfg, prompt, max_len=S + STEPS)
    assert fak.launches - f0 == _hybrid_layers(cfg)
    _close(last, case["prefill"])
    _trees_close(caches, case["caches"], what="prefill caches")
    step = tlm.make_serve_step(cfg)
    for i, (wl, wc) in enumerate(case["steps"]):
        f0 = fak.launches
        lg, caches = step(params, caches, {"tokens": torch.from_numpy(
            toks["tokens"][:, S + i:S + i + 1])},
            torch.full((B,), S + i, dtype=torch.int32))
        assert fak.launches == f0
        _close(lg, wl)
        _trees_close(caches, wc, what=f"step {i} caches")


def test_generate_lm_greedy_tokens_match_jax(case):
    params = tlm.params_from_jax(case["params"], "cpu")
    toks, stats = tserve.generate_lm(case["arch"],
                                     case["toks"]["tokens"][:, :S], STEPS,
                                     "cpu", params=params)
    np.testing.assert_array_equal(toks.numpy(), case["tokens"])
    assert stats["tok_per_s"] > 0


def test_init_params_has_jax_structure_shapes_and_dtypes(case):
    """The port's init (reduced, on the CPU) and its meta-device tree (the
    full config) against JAX's: keys, shapes, dtypes, parameter counts."""
    cfg = case["arch"].model

    def spec(tree):
        if isinstance(tree, dict):
            return {k: spec(v) for k, v in tree.items()}
        if isinstance(tree, torch.Tensor):
            return tuple(tree.shape), str(tree.dtype).removeprefix("torch.")
        return tuple(tree.shape), str(tree.dtype)

    got = tlm.init_params(torch.Generator().manual_seed(0), cfg)
    assert spec(got) == spec(case["params"])
    full = get_arch(case["arch"].arch_id).model
    jfull = jax_arch(case["arch"].arch_id).model
    assert spec(tlm.init_params(None, full)) == \
        spec(jlm.abstract_params(jfull)[0])
    assert full.num_params() == jfull.num_params()


def test_gradients_match_jax(case):
    params = tlm.params_from_jax(case["params"], "cpu")
    toks = case["toks"]
    batch = {"tokens": torch.from_numpy(toks["tokens"][:, :S]),
             "labels": torch.from_numpy(toks["labels"])}
    total, _, grads = tlm.loss_and_grads(params, case["arch"].model, batch)
    _close(total, case["total"], TRAIN_TOL)
    _trees_close(grads, case["grads"], GRAD_TOL, "grads")


def test_train_step_matches_jax(case):
    """One ``make_train_step`` update on the port's own gradients: loss,
    grad_norm, lr and the optimizer state within the tolerance; each
    parameter within it where JAX's clipped gradient ĝ (these configs'
    norms of 37-42 are clipped to 1) lies beyond 1000·eps, else within
    AdamW's first-step reach 2·lr: lr·ĝ/(|ĝ| + eps) moves by lr·eps·Δĝ/ĝ²,
    below the atol for |ĝ| > 1e-5 and up to 2·lr nearer zero.  Flash
    launches one per hybrid layer (no remat in the reduced configs), two
    under remat."""
    arch = case["arch"]
    params = tlm.params_from_jax(case["params"], "cpu")
    toks = case["toks"]
    batch = {"tokens": torch.from_numpy(toks["tokens"][:, :S]),
             "labels": torch.from_numpy(toks["labels"])}
    opt = build_optimizer(arch)
    lr_fn = warmup_cosine(arch.lr, WARMUP, TOTAL)
    f0 = fak.launches
    p1, s1, m1 = tlm.make_train_step(arch.model, opt, lr_fn)(
        params, opt.init(params), batch, STEP)
    assert fak.launches - f0 == _hybrid_layers(arch.model)
    jp1, js1, jm1 = case["step"]
    for k in ("loss", "grad_norm", "lr"):
        _close(m1[k], jm1[k], TRAIN_TOL, k)
    _trees_close(s1, js1, GRAD_TOL, "opt state")
    lr = float(jm1["lr"])
    clip = min(1.0, 1.0 / float(jm1["grad_norm"]))
    for i, (a, b, g) in enumerate(zip(tree_leaves(p1), jax.tree.leaves(jp1),
                                      jax.tree.leaves(case["grads"]))):
        err = np.abs(_np(a) - np.asarray(b))
        tight = clip * np.abs(np.asarray(g)) > 1000 * ADAM_EPS
        assert np.all(err[tight] <= TRAIN_TOL["atol"] + TRAIN_TOL["rtol"]
                      * np.abs(np.asarray(b)[tight])), f"params leaf {i}"
        assert np.all(err[~tight] <= 2 * lr + TRAIN_TOL["atol"]), \
            f"params leaf {i}"
    f0 = fak.launches
    remat = dataclasses.replace(arch.model, remat=True)
    tlm.make_train_step(remat, opt, lr_fn)(params, opt.init(params), batch,
                                           STEP)
    assert fak.launches - f0 == 2 * _hybrid_layers(arch.model)


@pytest.mark.parametrize("arch_id", SSM_ARCH_IDS)
def test_main_trains_the_ssm_lms(arch_id, tmp_path, capsys):
    cfg = get_arch(arch_id, reduced=True).model
    f0 = fak.launches
    runner = ttrain.main(["--arch", arch_id, "--reduced", "--device", "cpu",
                          "--batch", "2", "--seq", "16", "--warmup", "1",
                          "--steps", "3", "--ckpt-dir", str(tmp_path)])
    assert fak.launches - f0 == 3 * _hybrid_layers(cfg)
    losses = [m["loss"] for _, m in runner.metrics_log]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert f"arch={arch_id} device=cpu" in capsys.readouterr().out


def test_hymba_window_pattern_is_heterogeneous():
    """JAX's ``test_hymba_window_pattern_is_heterogeneous`` on the port:
    with a global layer in the stack, perturbing token 0 moves the last
    position (far past every 16-token window); two windowed attention
    layers alone (reach 30 < 39) leave it as it was."""
    cfg = get_arch("hymba-1.5b", reduced=True).model
    assert {ls.window for ls in cfg.layers} == {0, 16}
    params = tlm.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, 40)).astype(np.int32))
    toks2 = toks.clone()
    toks2[0, 0] = (toks[0, 0] + 7) % cfg.vocab
    base, _ = tlm.forward(params, cfg, {"tokens": toks})
    out2, _ = tlm.forward(params, cfg, {"tokens": toks2})
    assert not np.allclose(_np(base[0, -1]), _np(out2[0, -1]), atol=1e-5)
    swa2 = dataclasses.replace(cfg, layers=tuple(
        tlm.LayerSpec("attn", "dense", 16) for _ in range(2)))
    p2 = tlm.init_params(torch.Generator().manual_seed(0), swa2)
    c1, _ = tlm.forward(p2, swa2, {"tokens": toks})
    c2, _ = tlm.forward(p2, swa2, {"tokens": toks2})
    np.testing.assert_allclose(_np(c1[0, -1]), _np(c2[0, -1]), atol=1e-4)


def test_head_width_192_lm_matches_jax():
    """A reduced LM at nemotron-4-340b's head width (d_model 384, 2 heads
    of 192 over 1 KV head, 2 layers, relu² FFN, LayerNorm): forward and
    prefill (one flash call a layer, at dh 192) against JAX's."""
    kw = dict(name="dh192", vocab=211, d_model=384, norm="layernorm",
              param_dtype="float32", remat=False)
    attn = dict(d_model=384, n_heads=2, n_kv_heads=1, d_head=192)
    jcfg = jlm.LMConfig(layers=tuple(jlm.LayerSpec("attn", "dense", 0)
                                     for _ in range(2)),
                        attn=JAttnConfig(**attn),
                        ffn=JFFNConfig(384, 512, act="relu2", gated=False),
                        **kw)
    cfg = tlm.LMConfig(layers=tuple(tlm.LayerSpec("attn", "dense", 0)
                                    for _ in range(2)),
                       attn=AttnConfig(**attn),
                       ffn=FFNConfig(384, 512, act="relu2", gated=False),
                       **kw)
    jp = jax.jit(lambda k: jlm.init_params(k, jcfg)[0])(
        jax.random.PRNGKey(0))
    toks = np.random.default_rng(3).integers(0, 211, (B, S)) \
        .astype(np.int32)
    jlogits, _ = jax.jit(lambda p, t: jlm.forward(p, jcfg, {"tokens": t}))(
        jp, jnp.asarray(toks))
    jlast, jcaches = jax.jit(lambda p, t: jlm.prefill(
        p, jcfg, {"tokens": t}, max_len=S + 2))(jp, jnp.asarray(toks))
    params = tlm.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    prompt = {"tokens": torch.from_numpy(toks)}
    logits, _ = tlm.forward(params, cfg, prompt)
    _close(logits, jlogits)
    f0 = fak.launches
    last, caches = tlm.prefill(params, cfg, prompt, max_len=S + 2)
    assert fak.launches - f0 == 2
    _close(last, jlast)
    _trees_close(caches, jcaches, what="caches")


def test_logit_control_script_runs_reduced():
    """``scripts/lm_logit_control.py`` at hymba's reduced size on the CPU
    (the "kernels" are the plain versions there): the kernels' run is the
    plain run; dropping the window moves the logits far past path 4l's
    f32 ratio; at the per-element rule the sound call reads 0 and a 1 %
    scale or a window one key wider fails its windowed call."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "scripts" / \
        "lm_logit_control.py"
    spec = importlib.util.spec_from_file_location("lm_logit_control", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--device", "cpu", "--reduced", "--prompt", "48"])
    assert out["card"] == "cpu" and out["prompt"] == 48
    assert out["runs"]["kernels"]["from_plain"] == [0.0] * 9
    assert out["runs"]["no_window"]["max_ratio"] > 1.25
    windowed = [row for label, row in out["per_element"].items()
                if not label.endswith(" w0")]
    assert windowed
    for row in windowed:
        assert row["kernels"] == 0.0
        assert row["scale_1pct"] > 1.0 and row["window_plus1"] > 1.0
