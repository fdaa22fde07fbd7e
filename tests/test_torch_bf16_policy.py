"""The bf16 compute policy as a whole (``compute_dtype="bfloat16"``), held
against the JAX package on the CPU, on the fused route (each kernel's
plain version: the port's dispatch picks it for a CPU tensor; JAX's
kernels in interpret mode), on the unfused route's kernels and the M3
kernels, over the int8 serve copy, and on the plain einsum route: the
served forward and the loss, the f32 gradients, the exact bf16 launch
counts, an sgd and an AdamW chunk, the serving engine and its driver, the
training driver (the twin of tests/test_train_driver.py's bf16 halving
run, ``--serve-publish`` through a ladder, bf16 runs resumed across the
packages both ways on the plain and the unfused route).

Same numpy parameters and batches go through both packages.  Tolerances:
the forward and the loss at rtol 2e-2 / atol 2e-2, the JAX package's own
bf16 fused-vs-einsum tolerance (tests/test_fused_layer.py); the
gradients, f32 in both packages, at rtol 1e-2 / atol 1e-3, tighter than
JAX's bf16-vs-f32 tolerance (rtol 1e-1 / atol 5e-2): both round at the
same points, and an operand a rounding apart moves a gradient element by
a bf16 step of its products (measured: 2.4e-4 at most on the fused route
here); a trajectory of 3 steps at lr 0.05: sgd on the plain route at
rtol 1e-4 / atol 1e-5 (the two packages' plain routes agree to f32
rounding), sgd on the fused route and AdamW at rtol 1e-2 / atol 1e-3
(AdamW's normalised step turns an f32-level difference in a near-zero
gradient into one of up to a few 1e-4: measured 1.3e-4 on 7 of 384
elements), so AdamW runs on the plain route only.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jquant
from repro.checkpoint import checkpoint as jckpt
from repro.core import deep as jdeep
from repro.core.activations import ACTIVATION_ORDER
from repro.core.population import LayeredPopulation as JLayered
from repro.launch import serve_population as jserve
from repro.launch import train as jtrain
from repro.optim import optimizers as jopt
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.core import deep as tdeep
from repro_torch.core.population import LayeredPopulation as TLayered
from repro_torch.core.tree import tree_leaves
from repro_torch.launch import launch_count
from repro_torch.launch import serve_population as tserve
from repro_torch.launch import train as ttrain
from repro_torch.optim import optimizers as topt

FWD = dict(rtol=2e-2, atol=2e-2)
GRAD = dict(rtol=1e-2, atol=1e-3)
BF16 = "bfloat16"

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


def _launches(fn):
    before = launch_count.kernel_launches()
    out = fn()
    after = launch_count.kernel_launches()
    return out, {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}


@pytest.mark.parametrize("bd_impl", ["fused", "einsum"])
def test_forward_and_loss_match_jax(np_params, batches, bd_impl):
    """The served forward (logits, f32) and the loss under the policy; on
    the fused route depth+1 and 2·(depth+1) launches, every one a bf16
    instance."""
    x, y = batches[0][0], batches[1][0]
    params = tdeep.params_from_numpy(np_params, TLP, device="cpu")
    want = jax.jit(jdeep.forward, static_argnames=(
        "lp", "bd_impl", "compute_dtype", "infer", "log_probs"))(
        np_params, x, JLP, bd_impl=bd_impl, compute_dtype=BF16, infer=True,
        log_probs=True)
    got, n = _launches(lambda: tdeep.forward(
        params, _t(x), TLP, bd_impl=bd_impl, compute_dtype=BF16, infer=True,
        log_probs=True))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    (jloss, jper), jgrads = jax.jit(
        jax.value_and_grad(jdeep.fused_loss, has_aux=True),
        static_argnames=("lp", "bd_impl", "compute_dtype"))(
        np_params, x, y, JLP, bd_impl=bd_impl, compute_dtype=BF16)
    (loss, per, grads), n_step = _launches(lambda: tdeep.loss_and_grads(
        params, _t(x), _t(y, torch.long), TLP, bd_impl=bd_impl,
        compute_dtype=BF16))
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), **FWD)
    np.testing.assert_allclose(per.numpy(), np.asarray(jper), **FWD)
    assert all(g.dtype == torch.float32 for g in tree_leaves(grads))
    _assert_trees(grads, jgrads, **GRAD)
    if bd_impl == "fused":
        assert n == launch_count.fused_infer_kernels(TLP.depth, BF16)
        assert n_step == launch_count.fused_step_kernels(TLP.depth, BF16)
        assert n_step == {"fused_input_bf16": 1, "fused_input_bwd_bf16": 1,
                          "fused_layer_bf16": 2,
                          "fused_layer_dx_dw_bf16": 2,
                          "loss_head_fwd_bf16": 1, "loss_head_bwd_bf16": 1}
    else:
        assert n == {} and n_step == {}


@pytest.mark.parametrize("m3_impl", ["bucketed", "onehot", "scatter"])
@pytest.mark.parametrize("act_impl", ["sliced", "masked", "pallas"])
def test_plain_route_heads_and_activations(np_params, batches, m3_impl,
                                           act_impl):
    """The plain route under the policy (JAX's ``input_xla``,
    ``block_diag_einsum`` and ``m3``): each M3 head and activation pass;
    ``act_impl="pallas"`` runs the segmented-activation kernel on the f32
    sum of a bf16 product and an f32 bias."""
    x = batches[0][1]
    params = tdeep.params_from_numpy(np_params, TLP, device="cpu")
    want = jax.jit(jdeep.forward, static_argnames=(
        "lp", "m3_impl", "act_impl", "compute_dtype"))(
        np_params, x, JLP, m3_impl=m3_impl, act_impl=act_impl,
        compute_dtype=BF16)
    got = tdeep.forward(params, _t(x), TLP, m3_impl=m3_impl,
                        act_impl=act_impl, compute_dtype=BF16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


_RECIPES = {
    "sgd fused": (jopt.sgd, topt.sgd, "fused", dict(rtol=1e-2, atol=1e-3)),
    "sgd einsum": (jopt.sgd, topt.sgd, "einsum", dict(rtol=1e-4,
                                                      atol=1e-5)),
    "adamw einsum": (lambda: jopt.adamw(weight_decay=0.01),
                     lambda: topt.adamw(weight_decay=0.01), "einsum",
                     dict(rtol=1e-2, atol=1e-3)),
}


@pytest.mark.parametrize("recipe", sorted(_RECIPES))
def test_chunk_matches_jax(np_params, batches, recipe):
    """Three steps of the train chunk under the policy against JAX's
    ``make_population_train_step``: f32 masters and state, the losses."""
    jmake, tmake, bd_impl, tol = _RECIPES[recipe]
    xs, ys = batches
    jchunk = jdeep.make_population_train_step(
        JLP, optimizer=jmake(), scan_steps=3, donate=False, bd_impl=bd_impl,
        compute_dtype=BF16)
    jout = jchunk(np_params, jmake().init(np_params), jnp.asarray(xs),
                  jnp.asarray(ys), 0.05)
    params = tdeep.params_from_numpy(np_params, TLP, device="cpu")
    opt = tmake()
    chunk = tdeep.make_population_train_step(
        TLP, optimizer=opt, scan_steps=3, bd_impl=bd_impl,
        compute_dtype=BF16)
    tout = chunk(params, opt.init(params), _t(xs), _t(ys, torch.long), 0.05)
    assert all(p.dtype == torch.float32 for p in tree_leaves(tout[:2])
               if p.is_floating_point())
    _assert_trees(tout[0], jout[0], **tol)
    _assert_trees(tout[1], jout[1], **tol)
    np.testing.assert_allclose(tout[3].numpy(), np.asarray(jout[3]), **FWD)


def test_population_server_matches_jax(np_params):
    """``PopulationServer(compute_dtype="bfloat16")``: publish scores with
    the bf16 forward (the same leaderboard as JAX's server), a forward is
    depth+1 bf16 launches, and the served modes match JAX's."""
    rng = np.random.default_rng(4)
    xc = rng.normal(0, 1, (32, 6)).astype(np.float32)
    yc = rng.integers(0, 3, 32).astype(np.int32)
    xs = rng.normal(0, 1, (20, 6)).astype(np.float32)
    js = jserve.PopulationServer(np_params, JLP, bd_impl="fused",
                                 compute_dtype=BF16, batch=8, topk=3)
    jboard = js.publish(xc, yc)
    params = tdeep.params_from_numpy(np_params, TLP, device="cpu")
    ts = tserve.PopulationServer(params, TLP, compute_dtype=BF16, batch=8,
                                 topk=3)
    tboard = ts.publish(xc, yc)
    assert ts.published["topk"] == js.published["topk"]
    assert ts.published["best1"] == js.published["best1"]
    np.testing.assert_allclose([r["loss"] for r in tboard],
                               [r["loss"] for r in jboard], **FWD)
    _, n = _launches(ts.check_budget)
    assert n == {"fused_input_bf16": 1, "fused_layer_bf16": 2,
                 "infer_head_bf16": 1}
    for mode in ("best1", "topk", "all"):
        got, want = ts.run(xs, mode), js.run(xs, mode)
        assert (got["pred"] == np.asarray(want["pred"])).mean() >= 0.9
    # the f32 server is a different policy: its logits are not the bf16 ones
    f32 = tserve.PopulationServer(params, TLP, batch=8)
    with torch.inference_mode():
        a = tdeep.forward(params, _t(xs), TLP, **f32._fw)
        b = tdeep.forward(params, _t(xs), TLP, **ts._fw)
    assert not torch.equal(a, b)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-1, atol=5e-2)


def test_serve_main_bf16(np_params, tmp_path, capsys):
    """``serve_population.main --compute-dtype bfloat16`` end to end on the
    CPU: the launch budget of bf16 instances, publish, the three modes."""
    params = tdeep.params_from_numpy(np_params, TLP, device="cpu")
    tckpt.save_population(str(tmp_path), 1, params, TLP)
    _, n = _launches(lambda: tserve.main(
        ["--ckpt-dir", str(tmp_path), "--requests", "20", "--batch", "8",
         "--calib-samples", "32", "--device", "cpu", "--compute-dtype",
         BF16]))
    out = capsys.readouterr().out
    assert "launch budget: {'launches': 4, 'budget': 4}" in out
    assert "compute bfloat16" in out and "published: best1=" in out
    assert set(n) == {"fused_input_bf16", "fused_layer_bf16",
                      "infer_head_bf16"}


_TINY = ["--arch", "parallelmlp-10k", "--reduced", "--population-depths",
         "8,4;8,4;6;5", "--population-acts", "relu,tanh", "--scan-steps",
         "2", "--samples", "256"]


def test_driver_fused_bf16_halving_with_cheap_rungs(tmp_path):
    """The twin of tests/test_train_driver.py's: the fused route under the
    policy with subsampled rung evals through the halving ladder — the
    driver prunes on schedule, every training launch is a bf16 instance
    (the rung evals and the closing leaderboard are f32: f32 forwards),
    the checkpoint holds f32 masters and records the policy."""
    (params, lp, stats), n = _launches(lambda: ttrain.main(
        _TINY + ["--steps", "6", "--ckpt-every", "2", "--ckpt-dir",
                 str(tmp_path / "ck"), "--bd-impl", "fused",
                 "--compute-dtype", BF16, "--halving", "2:0.5,4:0.5",
                 "--rung-eval-batches", "1", "--device", "cpu"]))
    assert lp.num_real == 1                      # 4 → 2 → 1 members
    assert all(p.dtype == torch.float32 for p in tree_leaves(params))
    meta, _ = tckpt.load_meta(str(tmp_path / "ck"))
    assert meta["train"]["compute_dtype"] == BF16
    assert meta["train"]["bd_impl"] == "fused"
    assert meta["train"]["act_impl"] == "sliced"
    assert meta["train"]["optimizer"]["name"] == "sgd"
    with np.load(tmp_path / "ck" / "step_00000005" / "arrays.npz") as z:
        keys = [k for k in z.files if k.startswith("params/")]
        assert keys and all(z[k].dtype == np.float32 for k in keys)
    for seg in stats["segments"]:
        steps = seg["end"] - seg["start"]
        assert seg["launches"] == {
            k: steps * v for k, v in launch_count.fused_step_kernels(
                seg["depth"], BF16).items()}
    # f32 forwards: two rung evals and the leaderboard, no bf16 one
    assert n["infer_head"] == 3 and "infer_head_bf16" not in n


def test_serve_publish_through_a_ladder(tmp_path, capsys):
    """``--serve-publish``: the leaderboard is republished at each rung
    boundary and at the end (``published: best1=… topk=…``), by an f32
    server of top-k min(4, members); the last published set is a fresh
    ``PopulationServer``'s on the final checkpoint."""
    ck = tmp_path / "ck"
    params, lp, stats = ttrain.main(
        _TINY + ["--steps", "6", "--ckpt-every", "2", "--ckpt-dir", str(ck),
                 "--bd-impl", "fused", "--compute-dtype", BF16,
                 "--halving", "2:0.5,4:0.5", "--serve-publish", "--device",
                 "cpu"])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("published:")]
    assert len(lines) == 3 and len(stats["published"]) == 3
    assert [len(p["topk"]) for p in stats["published"]] == [2, 1, 1]
    assert [p["step"] for p in stats["published"]] == [1, 3, 5]
    from repro_torch.data.synthetic import TabularTask
    (_, _), (xte, yte) = TabularTask(256, lp.in_features,
                                     n_classes=lp.out_features,
                                     seed=0).split()
    fresh, _ = tserve.PopulationServer.from_checkpoint(
        str(ck), device="cpu", bd_impl="fused", act_impl="sliced", batch=8,
        topk=min(4, lp.num_real))
    fresh.publish(xte, yte)
    assert fresh.published["best1"] == stats["published"][-1]["best1"]
    assert fresh.published["topk"] == stats["published"][-1]["topk"]
    assert lines[-1] == (f"published: best1={fresh.published['best1']} "
                         f"topk={fresh.published['topk']}")


_RESUME = _TINY + ["--batch", "8", "--bd-impl", "einsum",
                   "--compute-dtype", BF16, "--ckpt-every", "2"]


def test_bf16_run_resumes_across_packages(tmp_path):
    """A bf16-policy run (the plain route, sgd) stopped at step 4: JAX's
    checkpoint resumed by the port lands on JAX's straight run, and the
    port's resumed by JAX on the port's straight run; each checkpoint
    records the policy."""
    runs = {}
    for d, main, more in (("jax4", jtrain.main, ["--pipeline", "off"]),
                          ("jax6", jtrain.main, ["--pipeline", "off",
                                                 "--steps", "6"]),
                          ("port4", ttrain.main, ["--device", "cpu"]),
                          ("port6", ttrain.main, ["--device", "cpu",
                                                  "--steps", "6"])):
        steps = [] if "--steps" in more else ["--steps", "4"]
        runs[d] = main(_RESUME + more + steps
                       + ["--ckpt-dir", str(tmp_path / d)])
    for d in ("jax4", "port4"):
        meta, step = tckpt.load_meta(str(tmp_path / d))
        assert step == 3 and meta["train"]["compute_dtype"] == BF16
    params, lp, stats = ttrain.main(_RESUME + [
        "--steps", "6", "--resume", "--device", "cpu", "--ckpt-dir",
        str(tmp_path / "jax4")])
    assert stats["steps"] == 2
    _assert_trees(params, jax.device_get(runs["jax6"][0]), rtol=1e-4,
                  atol=1e-5)
    back, _ = jtrain.main(_RESUME + ["--steps", "6", "--resume",
                                     "--pipeline", "off", "--ckpt-dir",
                                     str(tmp_path / "port4")])
    _assert_trees(runs["port6"][0], jax.device_get(back), rtol=1e-4,
                  atol=1e-5)


def test_unfused_bf16_run_resumes_a_jax_run(tmp_path):
    """A bf16-policy run on the unfused route's kernels (sgd, 6 steps,
    checkpoints every 2): JAX's checkpoint of step 3 resumed by the port
    for the last two steps lands on JAX's straight run, at the slice's
    trajectory tolerance for a kernel route (rtol 1e-2 / atol 1e-3: the
    plain versions and JAX's interpret-mode kernels round within a bf16
    ulp of each other)."""
    flags = _TINY + ["--batch", "8", "--bd-impl", "pallas", "--act-impl",
                     "pallas", "--compute-dtype", BF16, "--ckpt-every", "2",
                     "--steps", "6"]
    jparams, _ = jtrain.main(flags + ["--pipeline", "off", "--ckpt-dir",
                                      str(tmp_path / "jax")])
    shutil.copytree(tmp_path / "jax", tmp_path / "jax3",
                    ignore=shutil.ignore_patterns("step_00000005"))
    meta, step = tckpt.load_meta(str(tmp_path / "jax3"))
    assert step == 3 and meta["train"]["compute_dtype"] == BF16
    params, _, stats = ttrain.main(flags + ["--resume", "--device", "cpu",
                                            "--ckpt-dir",
                                            str(tmp_path / "jax3")])
    assert stats["steps"] == 2
    assert stats["segments"][0]["launches"] == {
        k: 2 * v for k, v in launch_count.unfused_step_launches(
            2, "bucketed", BF16).items()}
    _assert_trees(params, jax.device_get(jparams), **GRAD)


@pytest.mark.parametrize("kw", [
    dict(bd_impl="pallas", act_impl="pallas"),
    dict(bd_impl="einsum", m3_impl="pallas"),
    dict(bd_impl="fused", weights_dtype="int8"),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_item_6b_combinations_raise(np_params, batches, kw):
    """The three combinations that raised before Queue 1 item 6b was
    ported now run: bf16 on the unfused route's kernels, on the M3 kernels
    and over the int8 copy each serves JAX's logits (the int8 copy: on the
    bytes of JAX's own ``quantize_population``), each launch the bf16
    instance of its kernel, and the server takes the combination."""
    x = batches[0][2]
    params = tdeep.params_from_numpy(np_params, TLP, device="cpu")
    assert tdeep.check_dtypes(BF16, kw.get("weights_dtype")) == \
        kw.get("weights_dtype")
    jp = np_params
    tp = params
    if "weights_dtype" in kw:
        jp = jax.device_get(jquant.quantize_population(np_params, JLP))
        tp = tdeep.qparams_from_numpy(jp, TLP, device="cpu")
    want = jax.jit(jdeep.forward, static_argnames=(
        "lp", "bd_impl", "act_impl", "m3_impl", "compute_dtype", "infer",
        "weights_dtype"))(jp, x, JLP, compute_dtype=BF16, infer=True, **kw)
    got, n = _launches(lambda: tdeep.forward(tp, _t(x), TLP,
                                             compute_dtype=BF16, infer=True,
                                             **kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    assert n and all(k.endswith("_bf16") or k == "seg_act" for k in n)
    if "m3_impl" not in kw:   # the server has no M3 route
        server = tserve.PopulationServer(params, TLP, compute_dtype=BF16,
                                         bd_impl=kw["bd_impl"],
                                         act_impl=kw.get("act_impl",
                                                         "pallas"),
                                         weights_dtype=kw.get(
                                             "weights_dtype"))
        with torch.inference_mode():
            served = tdeep.forward(tp, _t(x), TLP, **server._fw)
        assert torch.equal(served, got)


_ROUTES = {
    "unfused": dict(bd_impl="pallas", act_impl="pallas"),
    "unfused m3": dict(bd_impl="pallas", act_impl="pallas", m3_impl="pallas"),
    "einsum m3": dict(bd_impl="einsum", m3_impl="pallas"),
}


@pytest.mark.parametrize("route", sorted(_ROUTES))
def test_unfused_and_m3_routes_match_jax(np_params, batches, route):
    """The unfused route's kernels and the M3 kernels under the policy:
    the served forward (log-probs), the loss and the f32 gradients against
    JAX's (its kernels in interpret mode), and exactly the route's
    launches under the ``*_bf16`` names (``seg_act`` in f32, as the policy
    hands it the f32 sum of a bf16 projection and an f32 bias)."""
    kw = _ROUTES[route]
    x, y = batches[0][1], batches[1][1]
    params = tdeep.params_from_numpy(np_params, TLP, device="cpu")
    static = ("lp", "bd_impl", "act_impl", "m3_impl", "compute_dtype")
    want = jax.jit(jdeep.forward, static_argnames=static + (
        "infer", "log_probs"))(np_params, x, JLP, compute_dtype=BF16,
                               infer=True, log_probs=True, **kw)
    got, n = _launches(lambda: tdeep.forward(
        params, _t(x), TLP, compute_dtype=BF16, infer=True, log_probs=True,
        **kw))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    (jloss, jper), jgrads = jax.jit(
        jax.value_and_grad(jdeep.fused_loss, has_aux=True),
        static_argnames=static)(np_params, x, y, JLP, compute_dtype=BF16,
                                **kw)
    (loss, per, grads), n_step = _launches(lambda: tdeep.loss_and_grads(
        params, _t(x), _t(y, torch.long), TLP, compute_dtype=BF16, **kw))
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), **FWD)
    np.testing.assert_allclose(per.numpy(), np.asarray(jper), **FWD)
    assert all(g.dtype == torch.float32 for g in tree_leaves(grads))
    _assert_trees(grads, jgrads, **GRAD)
    m3 = kw.get("m3_impl", "bucketed")
    if kw["bd_impl"] == "pallas":
        assert n == launch_count.unfused_infer_launches(TLP.depth, m3, BF16)
        assert n_step == launch_count.unfused_step_launches(TLP.depth, m3,
                                                            BF16)
    else:
        assert n == {"m3_matmul_fwd_bf16": 1}
        assert n_step == launch_count.m3_step_launches(BF16)
    if route == "unfused m3":
        assert n_step == {"seg_act": 3, "seg_act_bwd": 3,
                          "block_diag_fwd_bf16": 4, "block_diag_dw_bf16": 2,
                          "m3_matmul_fwd_bf16": 1, "m3_matmul_dh_bf16": 1,
                          "m3_matmul_dw_bf16": 1}


@pytest.mark.parametrize("flags", [
    ["--bd-impl", "pallas", "--act-impl", "pallas"],
    ["--weights-dtype", "int8"],
], ids=lambda f: " ".join(f))
def test_serve_main_bf16_routes(np_params, tmp_path, capsys, flags):
    """``serve_population.main --compute-dtype bfloat16`` on the unfused
    route and over the int8 copy, end to end on the CPU: publish, the
    three modes; only bf16 instances launch (``seg_act`` f32), and the
    int8 copy's launch budget is depth+1 ``*_int8_bf16`` launches."""
    params = tdeep.params_from_numpy(np_params, TLP, device="cpu")
    tckpt.save_population(str(tmp_path), 1, params, TLP)
    _, n = _launches(lambda: tserve.main(
        ["--ckpt-dir", str(tmp_path), "--requests", "16", "--batch", "8",
         "--calib-samples", "16", "--device", "cpu", "--compute-dtype",
         BF16] + flags))
    out = capsys.readouterr().out
    assert "compute bfloat16" in out and "published: best1=" in out
    if "int8" in flags:
        assert "launch budget: {'launches': 4, 'budget': 4}" in out
        assert set(n) == {"fused_input_int8_bf16", "fused_layer_int8_bf16",
                          "infer_head_int8_bf16"}
    else:
        assert set(n) == {"seg_act", "block_diag_fwd_bf16"}


def test_unknown_compute_dtype_raises():
    with pytest.raises(ValueError, match="compute_dtype"):
        tdeep.resolve_compute_dtype("float16")
    assert tdeep.resolve_compute_dtype("float32") is None
    assert tdeep.resolve_compute_dtype(torch.bfloat16) is torch.bfloat16
