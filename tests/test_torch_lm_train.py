"""LM training in the port (``repro_torch.models.lm``: ``loss_and_grads``,
``make_train_step``, remat; ``nn.ffn._expert_ffn``'s training route)
against the JAX package's on the CPU, for each of the seven attention LMs'
``reduced()`` configs: JAX's parameters (``lm.init_params(PRNGKey(0))``)
carried across with ``params_from_jax``, the same numpy batch, the arch's
optimizer (``build_optimizer``) and ``warmup_cosine`` at step 3 of 10.

- the gradients of ``loss_and_metrics`` against ``jax.value_and_grad``;
- one ``make_train_step`` update with JAX's gradients swapped in: loss,
  grad_norm, lr, every parameter and every optimizer-state leaf — the
  clip, the optimizer and ``apply_updates`` held on the same input;
- the same update end to end on the port's own gradients;
- JAX's microbatch invariance and bf16 accumulation tests, on the port and
  against JAX's own results (parameters as the end-to-end update);
- remat (``cfg.remat``) changes no gradient bit and doubles the flash
  launches; a step makes ``n_attn_layers × num_micro × (2 under remat,
  else 1)`` flash launches and no grouped-GEMM launch, and every expert
  weight gets a gradient; ``ops.moe_gemm`` refuses autograd.

The tolerance is the optimizer's, rtol 1e-5 / atol 1e-6; bf16 state
leaves (adafactor's momentum) equal or one bf16 ulp apart, as
``tests/test_torch_adafactor.py`` holds them.  End to end, AdamW's first
step is g/(|g| + eps) per element, so where JAX's gradient is within the
gradient's own atol of zero (its sign and size not fixed by the
gradient tolerance) a parameter is held to the step's reach, 2·lr, and
every other element to the tolerance; under bf16 accumulation the
gradient's resolution is its roundings' reach, 2^-5 of the mean
|microbatch gradient| (each of the four casts and adds rounds to 2^-9 of
its operands), and the same rule holds beyond it."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.launch.cells import build_optimizer as jax_build_optimizer
from repro.models import lm as jlm
from repro.optim import constant_lr as jconstant_lr
from repro.optim import warmup_cosine as jwarmup_cosine
from repro_torch.configs import LM_ARCH_IDS, get_arch
from repro_torch.core.tree import tree_leaves, tree_unflatten
from repro_torch.kernels import flash_attn as fak
from repro_torch.kernels import grouped_gemm as moek
from repro_torch.kernels import ops
from repro_torch.models import lm as tlm
from repro_torch.optim.optimizers import (build_optimizer, constant_lr,
                                          warmup_cosine)

TOL = dict(rtol=1e-5, atol=1e-6)
B, S = 2, 16
STEP, WARMUP, TOTAL = 3, 2, 10


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these small CPU steps run hundreds of tiny ops,
    which a full thread pool slows many times over when the test workers
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    """A numpy (or JAX) array as a tensor, bf16 through its bits."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _batch(cfg, seed=0, b=B, s=S) -> dict:
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend == "embeds":
        out["embeds"] = rng.normal(0, 1, (b, s, cfg.d_model)) \
            .astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return out


def _close(got, want, what=""):
    got = (got.detach().float().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float32))
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               err_msg=what, **TOL)


def _leaves_close(got, want, what):
    """Leaf by leaf in JAX's order: f32 within ``TOL``; bf16 equal, one
    ulp apart, or within ``TOL``; int32 equal."""
    gl, wl = tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl), what
    for i, (a, b) in enumerate(zip(gl, wl)):
        b = _t(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, i)
        if a.dtype == torch.bfloat16:
            ulps = a.view(torch.int16).int() - b.view(torch.int16).int()
            near = ((a.float() - b.float()).abs()
                    <= TOL["atol"] + TOL["rtol"] * b.float().abs())
            assert bool((near | (ulps.abs() <= 1)).all()), f"{what} leaf {i}"
        elif a.dtype == torch.int32:
            assert torch.equal(a, b), f"{what} leaf {i}"
        else:
            np.testing.assert_allclose(a.detach().numpy(), b.numpy(),
                                       err_msg=f"{what} leaf {i}", **TOL)


def _jax_step(jarch, params, batch, num_micro=1, lr_fn=None,
              accum_dtype=jnp.float32, step=STEP):
    cfg = jarch.model
    opt = jax_build_optimizer(jarch)
    fn = jlm.make_train_step(
        cfg, opt, lr_fn or jwarmup_cosine(jarch.lr, WARMUP, TOTAL),
        num_micro=num_micro, accum_dtype=accum_dtype)
    return jax.jit(fn)(params, opt.init(params), batch,
                       jnp.asarray(step, jnp.int32))


@pytest.fixture(scope="module", params=LM_ARCH_IDS)
def case(request):
    """JAX's parameters, batch, gradients and one step, as numpy."""
    jarch = jax_arch(request.param, reduced=True)
    cfg = jarch.model
    params = jax.jit(lambda k: jlm.init_params(k, cfg)[0])(
        jax.random.PRNGKey(0))
    batch = _batch(cfg)
    jb = jax.tree.map(jnp.asarray, batch)
    (total, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_and_metrics(p, cfg, b), has_aux=True))(
        params, jb)
    p1, s1, m1 = _jax_step(jarch, params, jb)

    def npy(tree):
        return jax.tree.map(np.asarray, tree)

    return {"arch": get_arch(request.param, reduced=True), "batch": batch,
            "params": npy(params), "total": float(total),
            "xent": float(metrics["loss"]), "aux": float(metrics["aux_loss"]),
            "grads": npy(grads), "step": (npy(p1), npy(s1), npy(m1))}


def _inputs(case):
    params = tlm.params_from_jax(case["params"], "cpu")
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    return params, batch


def _port_step(arch, params, batch, **kw):
    opt = build_optimizer(arch)
    fn = tlm.make_train_step(arch.model, opt,
                             warmup_cosine(arch.lr, WARMUP, TOTAL), **kw)
    return fn(params, opt.init(params), batch, STEP)


def test_gradients_match_jax(case):
    params, batch = _inputs(case)
    total, metrics, grads = tlm.loss_and_grads(params, case["arch"].model,
                                               batch)
    _close(total, case["total"], "total")
    _close(metrics["loss"], case["xent"], "xent")
    _close(metrics["aux_loss"], case["aux"], "aux")
    _leaves_close(grads, case["grads"], "grads")
    assert all(not t.requires_grad for t in tree_leaves(params))


def test_train_step_on_jax_gradients_matches_jax(case, monkeypatch):
    """The step's clip, optimizer and update on JAX's own gradients."""
    params, batch = _inputs(case)
    jgrads = tree_unflatten(params, [
        _t(g) for g in jax.tree.leaves(case["grads"])])
    monkeypatch.setattr(tlm, "loss_and_grads", lambda p, cfg, b: (
        torch.tensor(case["total"]), {}, jgrads))
    p1, s1, m1 = _port_step(case["arch"], params, batch)
    jp1, js1, jm1 = case["step"]
    for k in ("loss", "grad_norm", "lr"):
        _close(m1[k], jm1[k], k)
    _leaves_close(p1, jp1, "params")
    _leaves_close(s1, js1, "opt state")


def _stepped_close(got, want, grads, lr: float, what: str, spread=None):
    """Parameters after one AdamW-family step on the port's own gradients
    against JAX's: within ``TOL`` wherever JAX's gradient exceeds the
    gradient's atol (and, for a bf16 accumulation, the most its roundings
    can move it: 2^-5 of ``spread``, the mean |microbatch gradient|);
    elsewhere within the step's reach, 2·lr."""
    spread = (jax.tree.leaves(spread) if spread is not None
              else [0.0] * len(tree_leaves(got)))
    for i, (a, b, g, sp) in enumerate(zip(tree_leaves(got),
                                          jax.tree.leaves(want),
                                          jax.tree.leaves(grads), spread)):
        a, b, g = a.float().numpy(), np.asarray(b, np.float32), \
            np.abs(np.asarray(g, np.float32))
        err = np.abs(a - b)
        tight = g > TOL["atol"] + 2.0 ** -5 * np.asarray(sp, np.float32)
        assert np.all(err[tight] <= TOL["atol"] + TOL["rtol"]
                      * np.abs(b[tight])), f"{what} leaf {i}"
        assert np.all(err[~tight] <= 2 * lr + TOL["atol"]), \
            f"{what} leaf {i}"


def test_train_step_matches_jax(case):
    """One ``make_train_step`` update on the port's own gradients."""
    params, batch = _inputs(case)
    p1, s1, m1 = _port_step(case["arch"], params, batch)
    jp1, js1, jm1 = case["step"]
    for k in ("loss", "grad_norm", "lr"):
        _close(m1[k], jm1[k], k)
    _leaves_close(s1, js1, "opt state")
    _stepped_close(p1, jp1, case["grads"], float(jm1["lr"]), "params")


# --------------------------------------------------------------------- #
# JAX's training-policy tests (tests/test_train_policies.py), twinned   #
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def policy():
    """``test_train_policies._setup``: qwen3 reduced, PRNGKey(0) params, a
    (8, 32) batch from PRNGKey(1); JAX's steps at num_micro 1 and 4 (f32)
    and 4 (bf16 accumulation), constant lr 1e-3."""
    jarch = jax_arch("qwen3-1.7b", reduced=True)
    cfg = jarch.model
    params, _ = jlm.init_params(jax.random.PRNGKey(0), cfg)
    k = jax.random.PRNGKey(1)
    batch = {"tokens": jax.random.randint(k, (8, 32), 0, cfg.vocab),
             "labels": jax.random.randint(k, (8, 32), 0, cfg.vocab)}
    grad = jax.jit(lambda b: jax.grad(
        lambda p: jlm.loss_and_metrics(p, cfg, b)[0])(params))

    grads = grad(batch)
    micro = [grad({k: v[2 * i:2 * i + 2] for k, v in batch.items()})
             for i in range(4)]
    spread = jax.tree.map(lambda *g: sum(jnp.abs(x) for x in g) / 4, *micro)
    runs = {}
    for n, dt in ((1, jnp.float32), (4, jnp.float32), (4, jnp.bfloat16)):
        p, s, m = _jax_step(jarch, params, batch, num_micro=n,
                            lr_fn=jconstant_lr(1e-3), accum_dtype=dt,
                            step=0)
        runs[n, jnp.dtype(dt).name] = (jax.tree.map(np.asarray, p),
                                       float(m["loss"]))
    return (get_arch("qwen3-1.7b", reduced=True),
            jax.tree.map(np.asarray, params),
            {k: np.array(v) for k, v in batch.items()}, runs,
            jax.tree.map(np.asarray, grads),
            jax.tree.map(np.asarray, spread))


def _policy_step(policy, n, accum_dtype):
    arch, params, batch = policy[:3]
    tp = tlm.params_from_jax(params, "cpu")
    opt = build_optimizer(arch)
    fn = tlm.make_train_step(arch.model, opt, constant_lr(1e-3),
                             num_micro=n, accum_dtype=accum_dtype)
    p, _, m = fn(tp, opt.init(tp), {k: torch.from_numpy(v)
                                    for k, v in batch.items()}, 0)
    return p, float(m["loss"])


def test_microbatch_count_invariance(policy):
    """num_micro=1 vs 4 give the same update (f32 accumulation); each held
    to JAX's own run within the optimizer tolerance."""
    outs = {n: _policy_step(policy, n, torch.float32) for n in (1, 4)}
    assert abs(outs[1][1] - outs[4][1]) < 1e-4
    for a, b in zip(tree_leaves(outs[1][0]), tree_leaves(outs[4][0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-4)
    for n in (1, 4):
        want_p, want_loss = policy[3][n, "float32"]
        _close(torch.tensor(outs[n][1]), want_loss, f"loss {n}")
        _stepped_close(outs[n][0], want_p, policy[4], 1e-3,
                       f"params num_micro {n}")


def test_bf16_accumulation_close_to_f32(policy):
    """bf16 accumulation tracks f32 within bf16 resolution; the bf16 run
    held to JAX's bf16 run within the optimizer tolerance."""
    _, params, _, runs, grads, spread = policy
    ps = {dt: _policy_step(policy, 4, dt)[0]
          for dt in (torch.float32, torch.bfloat16)}
    deltas = []
    for a, b, p0 in zip(tree_leaves(ps[torch.float32]),
                        tree_leaves(ps[torch.bfloat16]),
                        jax.tree.leaves(params)):
        step_size = np.abs(a.numpy() - np.asarray(p0)).mean()
        diff = np.abs(a.numpy() - b.numpy()).mean()
        if step_size > 0:
            deltas.append(diff / step_size)
    assert np.mean(deltas) < 0.15, np.mean(deltas)
    _stepped_close(ps[torch.bfloat16], runs[4, "bfloat16"][0], grads, 1e-3,
                   "params bf16 accumulation", spread)


def test_num_micro_must_divide_the_batch():
    arch = get_arch("qwen3-1.7b", reduced=True)
    params = tlm.init_params(torch.Generator().manual_seed(0), arch.model)
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(arch.model, b=3).items()}
    opt = build_optimizer(arch)
    step = tlm.make_train_step(arch.model, opt, constant_lr(1e-3),
                               num_micro=2)
    with pytest.raises(ValueError, match="does not divide"):
        step(params, opt.init(params), batch, 0)


# --------------------------------------------------------------------- #
# remat, the launches of a step, the expert FFN's training route        #
# --------------------------------------------------------------------- #

def _counted_grads(cfg, params, batch):
    f0, m0 = fak.launches, moek.launches
    _, _, grads = tlm.loss_and_grads(params, cfg, batch)
    return grads, fak.launches - f0, moek.launches - m0


@pytest.mark.parametrize("arch_id", LM_ARCH_IDS)
def test_remat_changes_no_gradient_bit(arch_id):
    """``cfg.remat`` recomputes each layer in the backward: the gradients
    bitwise those without it, and two flash launches a layer, not one."""
    cfg = get_arch(arch_id, reduced=True).model
    params = tlm.init_params(torch.Generator().manual_seed(1), cfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2).items()}
    attn = sum(1 for ls in cfg.layers if ls.mixer == "attn")
    runs = {}
    for remat in (False, True):
        runs[remat] = _counted_grads(
            dataclasses.replace(cfg, remat=remat), params, batch)
        assert runs[remat][1:] == (attn * (2 if remat else 1), 0), remat
    for a, b in zip(tree_leaves(runs[False][0]), tree_leaves(runs[True][0])):
        assert torch.equal(a, b)
    # serving never rematerialises
    f0 = fak.launches
    with torch.inference_mode():
        tlm.forward(params, dataclasses.replace(cfg, remat=True), batch)
    assert fak.launches - f0 == attn


@pytest.mark.parametrize("arch_id", ["deepseek-moe-16b", "mixtral-8x22b"])
@pytest.mark.parametrize("num_micro,remat", [(1, False), (2, True)])
def test_moe_step_trains_the_experts_without_the_grouped_gemm(
        arch_id, num_micro, remat):
    """A MoE step: every expert leaf's gradient non-zero, 0 grouped-GEMM
    launches, ``n_attn × num_micro × (2 if remat else 1)`` flash launches;
    the same layer served still makes its three grouped-GEMM launches."""
    arch = get_arch(arch_id, reduced=True)
    cfg = dataclasses.replace(arch.model, remat=remat)
    params = tlm.init_params(torch.Generator().manual_seed(2), cfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 3, b=4).items()}
    _, _, grads = tlm.loss_and_grads(params, cfg, batch)
    experts = [(gi, name, g) for gi, sub in grads.items()
               if gi.startswith("g") and "experts" in sub.get("ffn", {})
               for name, g in sub["ffn"]["experts"].items()]
    assert len(experts) >= 3
    for gi, name, g in experts:
        assert bool(torch.isfinite(g).all()), (gi, name)
        per_layer = g.abs().flatten(1).amax(1)
        assert bool((per_layer > 0).all()), (gi, name, per_layer)
    attn = sum(1 for ls in cfg.layers if ls.mixer == "attn")
    moe = sum(1 for ls in cfg.layers if ls.ffn == "moe")
    opt = build_optimizer(arch)
    step = tlm.make_train_step(cfg, opt, constant_lr(1e-3),
                               num_micro=num_micro)
    f0, m0 = fak.launches, moek.launches
    p1, _, m = step(params, opt.init(params), batch, 0)
    assert (fak.launches - f0, moek.launches - m0) == \
        (attn * num_micro * (2 if remat else 1), 0)
    assert np.isfinite(float(m["loss"]))
    m0 = moek.launches
    with torch.inference_mode():
        tlm.forward(p1, cfg, batch)
    assert moek.launches - m0 == 3 * moe


def test_moe_gemm_refuses_autograd():
    """The grouped GEMM is forward only: a call autograd would record
    raises (the device does not matter: the check comes first); under
    no_grad, or with no operand requiring grad, it runs."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(16, 8, generator=gen)
    w = torch.randn(2, 8, 4, generator=gen)
    ids = torch.tensor([0, 1], dtype=torch.int32)
    for xr, wr in ((True, False), (False, True), (True, True)):
        with pytest.raises(RuntimeError, match="forward only"):
            ops.moe_gemm(x.clone().requires_grad_(xr),
                         w.clone().requires_grad_(wr), ids, block_t=8)
    with torch.no_grad():
        y = ops.moe_gemm(x.requires_grad_(), w, ids, block_t=8)
    assert y.shape == (16, 4) and not y.requires_grad
    ops.moe_gemm(x.detach(), w, ids, block_t=8)


def test_build_optimizer_maps_the_arch_policy():
    """``build_optimizer`` takes the arch's optimizer and its kwargs, dtype
    strings as torch dtypes (command-r: AdamW with bf16 moments;
    nemotron: adafactor), as JAX's ``cells.build_optimizer``."""
    tree = {"w": torch.zeros(4, 3)}
    st = build_optimizer(get_arch("command-r-35b")).init(tree)
    assert st["m"]["w"].dtype == st["v"]["w"].dtype == torch.bfloat16
    st = build_optimizer(get_arch("nemotron-4-340b")).init(tree)
    assert set(st) == {"count", "leaves"}
    st = build_optimizer(get_arch("qwen3-1.7b")).init(tree)
    assert st["m"]["w"].dtype == torch.float32
