"""The port's single-layer ParallelMLP (the paper's own module,
``core/parallel_mlp.py``) held against the JAX package on the CPU: init,
forward, the fused loss, SGD steps with a scalar and a per-member learning
rate, the independence property, selection, and the ``"single"``
checkpoint schema in both directions.

Same numpy parameters and batches go through both packages.  JAX runs its
M3 kernels in interpret mode (``m3_impl="pallas"``), as its own tests do;
the port runs each kernel's plain PyTorch version, which its dispatch
layer picks for a CPU tensor.  Tolerances: logits and losses rtol/atol
2e-5 (tests/test_m3.py), parameters after SGD steps rtol 2e-4 / atol 2e-5
(tests/test_independence.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.core import parallel_mlp as jpm
from repro.core import selection as jsel
from repro.core.population import Population as JPopulation
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.core import parallel_mlp as tpm
from repro_torch.core import selection as tsel
from repro_torch.core.population import Population as TPopulation
from repro_torch.launch import launch_count as tlc

FWD = dict(rtol=2e-5, atol=2e-5)
STEP = dict(rtol=2e-4, atol=2e-5)
SIZES = (3, 9, 1, 20, 5, 12)
ACTS = ("relu", "tanh", "identity", "mish", "sigmoid", "gelu")
JPOP = JPopulation(4, 3, SIZES, ACTS, block=8)
TPOP = TPopulation(4, 3, SIZES, ACTS, block=8)
B = 10


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _moved(fn):
    """``fn()`` and the kernel counters it moved."""
    before = tlc.kernel_launches()
    out = fn()
    after = tlc.kernel_launches()
    return out, {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}


@pytest.fixture(scope="module")
def np_params():
    return jax.device_get(jpm.init_params(jax.random.PRNGKey(0), JPOP))


def _batches(n, task="classification", seed=1):
    rng = np.random.default_rng(seed)
    xs = rng.normal(0, 1, (n, B, 4)).astype(np.float32)
    if task == "classification":
        return xs, rng.integers(0, 3, (n, B)).astype(np.int32)
    return xs, rng.normal(0, 1, (n, B, 3)).astype(np.float32)


def _tgt(y, task):
    return _t(y, torch.long if task == "classification" else torch.float32)


def _assert_params(got, want, **tol):
    for k in tpm.KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **tol)


@pytest.mark.parametrize("m3_impl,act_impl,task", [
    ("pallas", "sliced", "classification"),
    ("pallas", "masked", "regression"),
    ("bucketed", "masked", "classification"),
    ("onehot", "sliced", "regression"),
])
def test_forward_and_fused_loss_match_jax(np_params, m3_impl, act_impl,
                                          task):
    xs, ys = _batches(1, task)
    params = tpm.params_from_numpy(np_params, TPOP, device="cpu")
    fw = dict(m3_impl=m3_impl, act_impl=act_impl)
    want = jpm.forward(np_params, xs[0], JPOP, **fw)
    got = tpm.forward(params, _t(xs[0]), TPOP, **fw)
    assert tuple(got.shape) == (B, TPOP.num_members, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    jl, jper = jpm.fused_loss(np_params, xs[0], ys[0], JPOP, task, **fw)
    tl, tper = tpm.fused_loss(params, _t(xs[0]), _tgt(ys[0], task), TPOP,
                              task, **fw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FWD)
    np.testing.assert_allclose(tper.numpy(), np.asarray(jper), **FWD)


@pytest.mark.parametrize("lr_kind", ["scalar", "per_member"])
def test_sgd_steps_match_jax(np_params, lr_kind):
    """Three ``sgd_step``s on the M3 kernels' route against JAX's (jitted,
    interpret), each step exactly one launch of each M3 kernel."""
    xs, ys = _batches(3)
    lr = (0.1 if lr_kind == "scalar" else
          np.linspace(0.02, 0.3, TPOP.num_members).astype(np.float32))
    jp, tp = np_params, tpm.params_from_numpy(np_params, TPOP, device="cpu")
    for s in range(3):
        jp, jl, jper = jpm.sgd_step(jp, xs[s], ys[s], lr, JPOP,
                                    m3_impl="pallas")
        (tp, tl, tper), n = _moved(lambda: tpm.sgd_step(
            tp, _t(xs[s]), _t(ys[s], torch.long), lr, TPOP,
            m3_impl="pallas"))
        assert n == tlc.m3_step_launches()
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FWD)
        np.testing.assert_allclose(tper.numpy(), np.asarray(jper), **FWD)
        _assert_params(tp, jp, **STEP)
    # a forward without a gradient: the forward kernel alone
    with torch.no_grad():
        _, n = _moved(lambda: tpm.forward(tp, _t(xs[0]), TPOP,
                                          m3_impl="pallas"))
    assert n == {"m3_matmul_fwd": 1}


def _standalone_step(member, x, y, lr):
    """Plain SGD on one extracted MLP (mean NLL over the batch)."""
    leaves = {k: member[k].detach().requires_grad_(True)
              for k in tpm.KEYS}
    logits = tpm.member_forward(dict(leaves, activation=member["activation"]),
                                x)
    loss = -torch.log_softmax(logits, -1).gather(1, y[:, None]).mean()
    grads = torch.autograd.grad(loss, [leaves[k] for k in tpm.KEYS])
    new = {k: member[k] - lr * g for k, g in zip(tpm.KEYS, grads)}
    return dict(new, activation=member["activation"])


def test_fused_training_equals_standalone(np_params):
    """The independence property on the M3 kernels' route: each member's
    slice of the fused parameters after three steps equals the member
    trained alone on the same batches; its standalone forward equals its
    column of the fused logits."""
    xs, ys = _batches(3, seed=5)
    lr = 0.05
    fused = tpm.params_from_numpy(np_params, TPOP, device="cpu")
    members = [tpm.extract_member(fused, TPOP, m)
               for m in range(TPOP.num_members)]
    for s in range(3):
        x, y = _t(xs[s]), _t(ys[s], torch.long)
        fused, _, _ = tpm.sgd_step(fused, x, y, lr, TPOP, m3_impl="pallas")
        members = [_standalone_step(m, x, y, lr) for m in members]
    logits = tpm.forward(fused, _t(xs[0]), TPOP, m3_impl="pallas")
    for m in range(TPOP.num_members):
        got = tpm.extract_member(fused, TPOP, m)
        assert got["activation"] == ACTS[m]
        for k in tpm.KEYS:
            np.testing.assert_allclose(got[k].detach().numpy(),
                                       members[m][k].detach().numpy(),
                                       err_msg=f"member {m} {k}", **STEP)
        np.testing.assert_allclose(
            tpm.member_forward(got, _t(xs[0])).detach().numpy(),
            logits[:, m].detach().numpy(), **FWD)


def test_padding_units_never_update(np_params):
    xs, ys = _batches(2, seed=9)
    p0 = tpm.params_from_numpy(np_params, TPOP, device="cpu")
    p = p0
    for s in range(2):
        p, _, _ = tpm.sgd_step(p, _t(xs[s]), _t(ys[s], torch.long), 0.5,
                               TPOP, m3_impl="pallas")
    pad = TPOP.hidden_mask == 0
    assert pad.any()
    for k, sl in (("w1", np.s_[pad]), ("b1", np.s_[pad]),
                  ("w2", np.s_[:, pad])):
        np.testing.assert_array_equal(p[k].numpy()[sl], p0[k].numpy()[sl])
        assert not np.array_equal(p[k].numpy(), p0[k].numpy())


def test_init_params_bounds_and_device():
    """JAX's per-member bounds: w1, b1 within 1/√F; each member's w2 and b2
    within 1/√(its hidden size); the card unless ``device="cpu"``."""
    pop = TPopulation(16, 2, (1, 4, 25, 100), ("relu",) * 4, block=8)
    p = tpm.init_params(torch.Generator().manual_seed(0), pop, device="cpu")
    shapes = {k: tuple(v.shape) for k, v in p.items()}
    assert shapes == {k: tuple(v.shape)
                      for k, v in tpm.abstract_params(pop).items()}
    assert all(v.device.type == "cpu" for v in p.values())
    assert p["w1"].abs().max() <= 1 / 4 and p["b1"].abs().max() <= 1 / 4
    for m, hm in enumerate(pop.hidden_sizes):
        sl = slice(int(pop.offsets[m]), int(pop.offsets[m + 1]))
        w2m = p["w2"][:, sl].abs()
        assert w2m.max() <= 1 / np.sqrt(hm)
        assert w2m.max() > 0.5 / np.sqrt(hm)        # the bound is used
        assert p["b2"][m].abs().max() <= 1 / np.sqrt(hm)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpm.init_params(torch.Generator().manual_seed(0), pop)
    with pytest.raises(ValueError, match="shape"):
        tpm.params_from_numpy({k: v.numpy()[:1] for k, v in p.items()}, pop,
                              device="cpu")


def test_selection_matches_jax(np_params):
    """``evaluate_population`` → ``select_best`` → ``leaderboard`` on a
    single-layer ``Population`` against JAX's, scored on the M3 kernels;
    ``infer=True`` raises as in JAX."""
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (37, 4)).astype(np.float32)
    y = rng.integers(0, 3, 37).astype(np.int32)
    params = tpm.params_from_numpy(np_params, TPOP, device="cpu")
    jl, ja = jsel.evaluate_population(np_params, JPOP, jnp.asarray(x),
                                      jnp.asarray(y), batch_size=16,
                                      m3_impl="pallas")
    tl, ta = tsel.evaluate_population(params, TPOP, x, y, batch_size=16,
                                      m3_impl="pallas")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FWD)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **FWD)
    jm, jbest = jsel.select_best(np_params, JPOP, jl)
    tm, tbest = tsel.select_best(params, TPOP, tl)
    assert tm == jm and tbest["activation"] == jbest["activation"]
    for k in tpm.KEYS:
        np.testing.assert_array_equal(tbest[k].numpy(), np.asarray(jbest[k]))
    jrows = jsel.leaderboard(JPOP, jl, ja, k=4)
    trows = tsel.leaderboard(TPOP, tl, ta, k=4)
    for jr, tr in zip(jrows, trows, strict=True):
        assert {k: tr[k] for k in ("rank", "member", "slot", "hidden",
                                   "activation")} == \
            {k: jr[k] for k in ("rank", "member", "slot", "hidden",
                                "activation")}
        np.testing.assert_allclose(tr["loss"], jr["loss"], **FWD)
    rows = tsel.member_metrics(TPOP, tl, ta)
    assert [r["depth"] for r in rows] == [1] * TPOP.num_members
    with pytest.raises(ValueError) as jerr:
        jsel.evaluate_population(np_params, JPOP, jnp.asarray(x),
                                 jnp.asarray(y), infer=True)
    with pytest.raises(ValueError) as terr:
        tsel.evaluate_population(params, TPOP, x, y, infer=True)
    assert str(terr.value) == str(jerr.value)


def test_single_checkpoint_both_directions(np_params, tmp_path):
    """The ``"single"`` schema: the port's checkpoint restores in JAX as a
    ``Population`` with the same arrays, and JAX's in the port."""
    params = tpm.params_from_numpy(np_params, TPOP, device="cpu")
    tckpt.save_population(str(tmp_path / "port"), 3, params, TPOP)
    meta, _ = jckpt.load_meta(str(tmp_path / "port"))
    assert meta["population"]["schema"] == "single"
    jp, jlay, jstep = jckpt.restore_population(str(tmp_path / "port"))
    assert jstep == 3 and isinstance(jlay, JPopulation)
    assert (jlay.hidden_sizes, jlay.activations, jlay.block) == \
        (SIZES, ACTS, 8)
    for k in tpm.KEYS:
        np.testing.assert_array_equal(np.asarray(jp[k]), params[k].numpy())

    jckpt.save_population(str(tmp_path / "jax"), 5, np_params, JPOP)
    tp, tlay, tstep = tckpt.restore_population(str(tmp_path / "jax"),
                                               device="cpu")
    assert tstep == 5 and isinstance(tlay, TPopulation) and tlay == TPOP
    back = tpm.params_to_numpy(tp)
    for k in tpm.KEYS:
        np.testing.assert_array_equal(back[k], np_params[k])
    np.testing.assert_array_equal(
        tpm.forward(tp, _t(np.ones((2, 4))), tlay, m3_impl="pallas").numpy(),
        tpm.forward(params, _t(np.ones((2, 4))), TPOP,
                    m3_impl="pallas").numpy())
