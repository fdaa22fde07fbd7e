"""The port's training slice held against the JAX package on the CPU: the
loss and its gradients on every route, the independence property, the
optimizer engine and the launch budget of a fused step.

Same numpy parameters (the JAX package's initialisation, carried in with
``params_from_numpy``) and batches go through both packages.  JAX runs its
Pallas kernels in interpret mode, as its own tests do; the port runs each
kernel's plain PyTorch version, which its dispatch layer picks for a CPU
tensor.  Tolerances follow the JAX package's tests for the same quantity:
losses rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol 1e-6
(tests/test_fused_layer.py, tests/test_loss_head.py), member against
standalone 2e-4 / 2e-5 (tests/test_deep.py), optimizer trajectories
1e-5 / 1e-6 (tests/test_population_optim.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import deep as jdeep
from repro.core.activations import ACTIVATION_ORDER
from repro.core.population import LayeredPopulation as JLayered
from repro.optim import optimizers as jopt
from repro_torch.core import deep as tdeep
from repro_torch.core.activations import ACTIVATIONS as TACTS
from repro_torch.core.population import LayeredPopulation as TLayered
from repro_torch.core.population import Population as TPopulation
from repro_torch.core.tree import tree_leaves
from repro_torch.launch import launch_count
from repro_torch.optim import optimizers as topt

LOSS = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
TRAJ = dict(rtol=1e-5, atol=1e-6)

# one member per activation, depths 1..3 (tests/test_torch_serve.py)
_WIDTHS = ((5, 3), (12, 9), (7,), (17, 9, 5), (8, 8),
           (5, 3), (3, 11, 2), (24, 16), (4,), (9, 9, 9))
JLP = JLayered(6, 3, _WIDTHS, ACTIVATION_ORDER, block=8)
TLP = TLayered(6, 3, _WIDTHS, ACTIVATION_ORDER, block=8)
B = 12


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _assert_trees(got, want, **tol):
    gl, wl = tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for i, (a, b) in enumerate(zip(gl, wl)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   err_msg=f"leaf {i}", **tol)


@pytest.fixture(scope="module")
def np_params():
    return jax.device_get(jdeep.init_params(jax.random.PRNGKey(0), JLP))


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(1)
    xs = rng.normal(0, 1, (3, B, 6)).astype(np.float32)
    ys = rng.integers(0, 3, (3, B)).astype(np.int32)
    return xs, ys


# --------------------------------------------------------------------- #
# the loss and its gradients                                            #
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def jax_loss(np_params, batches):
    """JAX's value_and_grad of fused_loss on the plain route and on the
    fused kernels (interpret mode)."""
    x, y = batches[0][0], batches[1][0]
    vg = jax.jit(jax.value_and_grad(jdeep.fused_loss, has_aux=True),
                 static_argnames=("lp", "bd_impl"))
    out = {}
    for route in ("einsum", "fused"):
        (loss, per), grads = vg(np_params, x, y, lp=JLP, bd_impl=route)
        out[route] = (np.asarray(loss), np.asarray(per), grads)
    return out


@pytest.mark.parametrize("loss_impl", ["xla", "fused"])
@pytest.mark.parametrize("bd_impl", ["einsum", "fused"])
def test_fused_loss_and_grads_match_jax(np_params, batches, jax_loss,
                                        bd_impl, loss_impl):
    """Every (bd_impl, loss_impl) route of the port: the loss, the
    per-member losses and every parameter's gradient equal JAX's
    ``value_and_grad(fused_loss)`` on the plain and the fused route."""
    params = tdeep.params_from_numpy(np_params, TLP, device="cpu")
    x, y = _t(batches[0][0]), _t(batches[1][0], torch.long)
    loss, per, grads = tdeep.loss_and_grads(params, x, y, TLP,
                                            bd_impl=bd_impl,
                                            loss_impl=loss_impl)
    for route in ("einsum", "fused"):
        jl, jper, jgrads = jax_loss[route]
        np.testing.assert_allclose(loss.numpy(), jl, **LOSS)
        np.testing.assert_allclose(per.numpy(), jper, **LOSS)
        _assert_trees(grads, jgrads, **GRAD)
    lf, pf = tdeep.fused_loss(params, x, y, TLP, bd_impl=bd_impl,
                              loss_impl=loss_impl)
    assert torch.equal(lf, loss) and torch.equal(pf, per)


def test_fused_step_is_two_depth_plus_one_launches(np_params, batches):
    """One fused optimizer step runs each layer once per direction —
    2·(depth+1) launches; the plain route runs none."""
    params = tdeep.params_from_numpy(np_params, TLP, device="cpu")
    x, y = _t(batches[0][0]), _t(batches[1][0], torch.long)
    opt = topt.sgd()
    for bd_impl, want in (("fused", launch_count.fused_step_budget(3)),
                          ("einsum", {"total": 0})):
        before = launch_count.kernel_launches()
        tdeep.opt_step(params, opt.init(params), x, y, 0.1, opt, TLP,
                       bd_impl=bd_impl)
        after = launch_count.kernel_launches()
        diff = {k: after[k] - before[k] for k in after
                if after[k] != before[k]}
        assert sum(diff.values()) == want["total"], diff
    assert diff == {}
    before = launch_count.kernel_launches()
    tdeep.opt_step(params, opt.init(params), x, y, 0.1, opt, TLP,
                   bd_impl="fused")
    after = launch_count.kernel_launches()
    assert {k: after[k] - before[k] for k in after} == {
        "fused_input": 1, "fused_input_bwd": 1, "fused_layer": 2,
        "fused_layer_dx_dw": 2, "infer_head": 0, "loss_head_fwd": 1,
        "loss_head_bwd": 1, "fused_input_int8": 0, "fused_layer_int8": 0,
        "infer_head_int8": 0, "block_diag_fwd": 0, "block_diag_dw": 0,
        "seg_act": 0, "seg_act_bwd": 0, "m3_matmul_fwd": 0,
        "m3_matmul_dh": 0, "m3_matmul_dw": 0, "flash_attention": 0,
        "moe_gemm": 0, "fused_input_bf16": 0, "fused_input_bwd_bf16": 0,
        "fused_layer_bf16": 0, "fused_layer_dx_dw_bf16": 0,
        "infer_head_bf16": 0, "loss_head_fwd_bf16": 0,
        "loss_head_bwd_bf16": 0, "fused_input_int8_bf16": 0,
        "fused_layer_int8_bf16": 0, "infer_head_int8_bf16": 0,
        "block_diag_fwd_bf16": 0, "block_diag_dw_bf16": 0,
        "m3_matmul_fwd_bf16": 0, "m3_matmul_dh_bf16": 0,
        "m3_matmul_dw_bf16": 0, "seg_act_bf16": 0, "seg_act_bwd_bf16": 0}
    assert launch_count.fused_step_budget(3) == {"fwd": 4, "bwd": 4,
                                                 "total": 8}


def test_rejects_unported_routes(np_params, batches):
    """bf16 compute trains on the unfused route's kernels and on the M3
    kernels, its loss as JAX's within the bf16 slice tolerance (2e-2; the
    gradients: tests/test_torch_bf16_policy.py; the M3 routes in f32:
    tests/test_torch_m3.py; adafactor and the bf16 AdamW state:
    tests/test_torch_adafactor.py); a route JAX refuses is refused here
    too (``ValueError``)."""
    params = tdeep.params_from_numpy(np_params, TLP, device="cpu")
    xn, yn = batches[0][0], batches[1][0]
    x, y = _t(xn), _t(yn, torch.long)
    for kw in (dict(bd_impl="pallas", act_impl="pallas"),
               dict(m3_impl="pallas")):
        loss, per = tdeep.fused_loss(params, x, y, TLP,
                                     compute_dtype="bfloat16", **kw)
        jloss, jper = jax.jit(jdeep.fused_loss, static_argnames=(
            "lp", "bd_impl", "act_impl", "m3_impl", "compute_dtype"))(
            np_params, xn, yn, JLP, compute_dtype="bfloat16", **kw)
        np.testing.assert_allclose(per.detach().numpy(), np.asarray(jper),
                                   rtol=2e-2, atol=2e-2)
    with pytest.raises(ValueError, match="weights_dtype"):
        tdeep.fused_loss(params, x, y, TLP, bd_impl="fused_int8",
                         compute_dtype="bfloat16")


# --------------------------------------------------------------------- #
# the independence property (tests/test_independence.py)                #
# --------------------------------------------------------------------- #

POP = TPopulation(6, 3, (3, 9, 1, 20, 9),
                  ("relu", "tanh", "identity", "mish", "sigmoid"), block=8)
# mixed depths 1..3 with per-layer activations: pass-through members ride
# the identity tile through the fused mid layers and their backward
DEEP = TLayered(6, 3, ((7, 5), (4,), (9, 6, 3), (3, 11), (6,)),
                (("relu", "tanh"), "mish", ("gelu", "elu", "selu"),
                 ("leaky_relu", "sigmoid"), "hardshrink"), block=8)


def _standalone_step(member, x, y, lr):
    """Plain SGD on one extracted MLP (mean NLL over the batch)."""
    flat = [member["w_in"], member["b_in"], member["w_out"],
            member["b_out"]] + [t for lay in member["mid"]
                                for t in (lay["w"], lay["b"])]
    leaves = [t.clone().requires_grad_(True) for t in flat]
    m = dict(member, w_in=leaves[0], b_in=leaves[1], w_out=leaves[2],
             b_out=leaves[3],
             mid=[{"w": leaves[4 + 2 * i], "b": leaves[5 + 2 * i]}
                  for i in range(len(member["mid"]))])
    loss = torch.nn.functional.cross_entropy(tdeep.member_forward(m, x), y)
    grads = torch.autograd.grad(loss, leaves)
    new = [(p - lr * g).detach() for p, g in zip(leaves, grads)]
    return dict(member, w_in=new[0], b_in=new[1], w_out=new[2],
                b_out=new[3],
                mid=[{"w": new[4 + 2 * i], "b": new[5 + 2 * i]}
                     for i in range(len(member["mid"]))])


@pytest.mark.parametrize("lp", [POP.layered(), DEEP],
                         ids=["depth1", "mixed_depth"])
@pytest.mark.parametrize("bd_impl", ["einsum", "fused"])
def test_fused_equals_standalone(bd_impl, lp):
    """Members of a fused population train EXACTLY as they would alone —
    gradients never mix across members — through the fused kernels too,
    mid layers and pass-through members included."""
    rng = np.random.default_rng(42)
    params = tdeep.init_params(torch.Generator().manual_seed(42), lp)
    members = [tdeep.extract_member(params, lp, m)
               for m in range(lp.num_members)]
    lr = 0.05
    for _ in range(5):
        x = _t(rng.normal(0, 1, (16, 6)))
        y = torch.as_tensor(rng.integers(0, 3, 16))
        params, _, _ = tdeep.sgd_step(params, x, y, lr, lp, bd_impl=bd_impl)
        members = [_standalone_step(m, x, y, lr) for m in members]
    for m in range(lp.num_members):
        got = tdeep.extract_member(params, lp, m)
        pairs = [(k, got[k], members[m][k])
                 for k in ("w_in", "b_in", "w_out", "b_out")]
        pairs += [(f"mid{i}/{k}", a[k], b[k]) for i, (a, b) in
                  enumerate(zip(got["mid"], members[m]["mid"]))
                  for k in ("w", "b")]
        for k, a, b in pairs:
            np.testing.assert_allclose(
                a.numpy(), b.numpy(), rtol=2e-4, atol=2e-5,
                err_msg=f"member {m} param {k} diverged")


def test_padding_units_never_update_and_per_member_lr(np_params, batches):
    lp = POP.layered()
    params = tdeep.init_params(torch.Generator().manual_seed(0), lp)
    x, y = _t(batches[0][0]), _t(batches[1][0], torch.long)
    pad = 1.0 - lp.layer_pop(0).hidden_mask
    new, _, _ = tdeep.sgd_step(params, x, y, 0.1, lp, bd_impl="fused")
    np.testing.assert_allclose(new["w_in"].numpy() * pad[:, None],
                               params["w_in"].numpy() * pad[:, None],
                               atol=1e-7)
    lrs = np.array([0.0, 0.1, 0.0, 0.2, 0.05], np.float32)
    new, _, _ = tdeep.sgd_step(params, x, y, lrs, lp, bd_impl="fused")
    for m, lr in enumerate(lrs):
        sl = lp.layer_pop(0).member_slice(m)
        same = torch.equal(new["w_in"][sl], params["w_in"][sl])
        assert same == (lr == 0.0), (m, lr)


# --------------------------------------------------------------------- #
# per-member hyperparameters and the optimizer engine                   #
# --------------------------------------------------------------------- #

def test_member_lr_tree_matches_jax():
    lr = np.linspace(0.01, 0.1, TLP.num_members).astype(np.float32)
    got = tdeep.member_lr_tree(TLP, lr)
    want = jdeep.member_lr_tree(JLP, lr)
    gl, wl = tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        assert a.shape == np.asarray(b).shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("bd_impl", ["einsum", "fused"])
def test_sgd_engine_is_bit_identical_to_plain_sgd(np_params, batches,
                                                  bd_impl):
    """``opt_step`` with ``sgd()`` equals ``p − lr·g`` bit for bit, with a
    scalar and a per-member lr, and so does a 3-step engine chunk against
    three ``sgd_step``s."""
    params = tdeep.params_from_numpy(np_params, TLP, device="cpu")
    xs = _t(batches[0])
    ys = _t(batches[1], torch.long)
    for lr in (0.05, np.linspace(0.02, 0.08, TLP.num_members)):
        plain, _, _ = tdeep.sgd_step(params, xs[0], ys[0], lr, TLP,
                                     bd_impl=bd_impl)
        opt = topt.sgd()
        eng, st, _, _, gn = tdeep.opt_step(params, opt.init(params), xs[0],
                                           ys[0], lr, opt, TLP,
                                           bd_impl=bd_impl)
        assert gn is None and int(st["count"]) == 1
        for a, b in zip(tree_leaves(plain), tree_leaves(eng)):
            assert torch.equal(a, b)
    p1, l1, pe1 = params, [], []
    for k in range(3):
        p1, loss, per = tdeep.sgd_step(p1, xs[k], ys[k], lr, TLP,
                                       bd_impl=bd_impl)
        l1.append(loss)
        pe1.append(per)
    l1, pe1 = torch.stack(l1), torch.stack(pe1)
    engine = tdeep.make_population_train_step(TLP, optimizer=topt.sgd(),
                                              scan_steps=3, bd_impl=bd_impl)
    p2, st, l2, pe2, gn = engine(params, topt.sgd().init(params), xs, ys, lr)
    assert gn is None and int(st["count"]) == 3
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        assert torch.equal(a, b)
    assert torch.equal(l1, l2) and torch.equal(pe1, pe2)


_RECIPES = {
    "momentum": (lambda: jopt.sgd(momentum=0.9),
                 lambda: topt.sgd(momentum=0.9), {}),
    "adamw_clip_sched": (lambda: jopt.adamw(weight_decay=0.01),
                         lambda: topt.adamw(weight_decay=0.01),
                         {"grad_clip": 1.0}),
}


@pytest.mark.parametrize("bd_impl", ["einsum", "fused"])
@pytest.mark.parametrize("recipe", sorted(_RECIPES))
def test_chunk_trajectory_matches_jax(np_params, batches, recipe, bd_impl):
    """k steps of a stateful optimizer through the chunk — params, state,
    losses, pre-clip norms — against JAX's ``make_population_train_step``
    (its einsum route), the adamw recipe under a warmup-cosine schedule
    threading the global step."""
    jmake, tmake, kw = _RECIPES[recipe]
    sched = recipe.endswith("sched")
    xs, ys = batches
    jchunk = jdeep.make_population_train_step(
        JLP, optimizer=jmake(), scan_steps=3, donate=False,
        lr_schedule=jopt.warmup_cosine(1.0, 2, 6) if sched else None, **kw)
    jst0 = jmake().init(np_params)
    jargs = (np_params, jst0, jnp.asarray(xs), jnp.asarray(ys), 0.05)
    jout = jchunk(*jargs, 1) if sched else jchunk(*jargs)

    params = tdeep.params_from_numpy(np_params, TLP, device="cpu")
    opt = tmake()
    chunk = tdeep.make_population_train_step(
        TLP, optimizer=opt, scan_steps=3, bd_impl=bd_impl,
        lr_schedule=topt.warmup_cosine(1.0, 2, 6) if sched else None, **kw)
    targs = (params, opt.init(params), _t(xs), _t(ys, torch.long), 0.05)
    tout = chunk(*targs, 1) if sched else chunk(*targs)
    _assert_trees(tout[0], jout[0], **TRAJ)
    _assert_trees(tout[1], jout[1], **TRAJ)
    assert sorted(tout[1]) == sorted(jout[1])
    np.testing.assert_allclose(tout[2].numpy(), np.asarray(jout[2]), **TRAJ)
    np.testing.assert_allclose(tout[3].numpy(), np.asarray(jout[3]), **TRAJ)
    if kw:
        np.testing.assert_allclose(tout[4].numpy(), np.asarray(jout[4]),
                                   **TRAJ)
    else:
        assert tout[4] is None and jout[4] is None


def test_per_member_momentum_tree_matches_jax(np_params, batches):
    """A per-member momentum TREE (``member_lr_tree`` over a vector): each
    member trains with its own coefficient, as in JAX."""
    moms = np.linspace(0.5, 0.95, TLP.num_members).astype(np.float32)
    jo = jopt.sgd(momentum=jdeep.member_lr_tree(JLP, moms))
    to = topt.sgd(momentum=tdeep.member_lr_tree(TLP, moms))
    x, y = batches[0][0], batches[1][0]
    jp, js = np_params, jo.init(np_params)
    tp = tdeep.params_from_numpy(np_params, TLP, device="cpu")
    ts = to.init(tp)
    for _ in range(2):
        jp, js, *_ = jdeep.opt_step(jp, js, x, y, 0.05, jo, JLP)
        tp, ts, *_ = tdeep.opt_step(tp, ts, _t(x), _t(y, torch.long), 0.05,
                                    to, TLP, bd_impl="fused")
    _assert_trees(tp, jp, **TRAJ)
    _assert_trees(ts["mu"], js["mu"], **TRAJ)


def test_clip_and_schedule_match_jax():
    rng = np.random.default_rng(3)
    tree = {"a": rng.normal(0, 3, (4, 5)).astype(np.float32),
            "b": [rng.normal(0, 1, 7).astype(np.float32)]}
    ttree = {"a": _t(tree["a"]), "b": [_t(tree["b"][0])]}
    for max_norm in (0.5, 1e3):
        jg, jn = jopt.clip_by_global_norm(tree, max_norm)
        tg, tn = topt.clip_by_global_norm(ttree, max_norm)
        np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6)
        _assert_trees(tg, jg, rtol=1e-6, atol=0)
    jfn = jopt.warmup_cosine(0.3, 5, 40)
    tfn = topt.warmup_cosine(0.3, 5, 40)
    for step in (0, 1, 4, 5, 6, 20, 39, 40, 60):
        np.testing.assert_allclose(tfn(step).numpy(),
                                   np.asarray(jfn(jnp.int32(step))),
                                   rtol=1e-6, err_msg=str(step))
    assert float(topt.constant_lr(0.25)(7)) == 0.25
    with pytest.raises(ValueError, match="member_lr_tree"):
        topt.broadcast_lr(torch.ones(3), ttree)
    with pytest.raises(ValueError, match="structure"):
        topt.broadcast_lr({"a": 1.0}, ttree)
