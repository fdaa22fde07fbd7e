"""The port's unfused route (``bd_impl="pallas"``, ``act_impl="pallas"``)
held against the JAX package on the CPU: the block-diagonal GEMM and the
segmented activation with their gradients, the route's forward, loss
gradients and launch counts, and the two drivers on it.

Same numpy inputs go through both packages.  JAX runs its Pallas kernels
in interpret mode, as tests/test_layered.py and tests/test_activations.py
do; the port runs each kernel's plain PyTorch version, which its dispatch
layer picks for a CPU tensor.  Tolerances: the kernels' forward rtol 1e-5
/ atol 1e-6 and gradients rtol 1e-4 / atol 1e-6 (tests/test_layered.py);
the whole route's logits and loss gradients rtol 1e-4 / atol 1e-6 (more
stages, each summing in its own order).
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.core import deep as jdeep
from repro.core.activations import ACTIVATION_ORDER
from repro.core.population import LayeredPopulation as JLayered
from repro.kernels import ops as jops
from repro.launch import launch_count as jlc
from repro.launch import serve_population as jserve
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.core import deep as tdeep
from repro_torch.core.population import LayeredPopulation as TLayered
from repro_torch.core.tree import tree_leaves
from repro_torch.kernels import ops as tops
from repro_torch.launch import launch_count as tlc
from repro_torch.launch import serve_population as tserve
from repro_torch.launch import train as ttrain
from repro_torch.optim import optimizers as topt

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
ROUTE = dict(rtol=1e-4, atol=1e-6)
UNFUSED = dict(bd_impl="pallas", act_impl="pallas")

# pass-through members (depth 1 and 2 among depth 3) at blocks 8 and 16
_LAYOUTS = {
    "block8": (((5, 3), (12, 9), (7,), (17, 9, 5), (3, 11, 2), (24, 16),
                (4,), (9, 9, 9)), 8),
    "block16": (((40, 20), (17, 33, 9), (7,), (3, 5)), 16),
}
# one member per activation, depths 1..3 (tests/test_torch_train.py)
_WIDTHS = ((5, 3), (12, 9), (7,), (17, 9, 5), (8, 8),
           (5, 3), (3, 11, 2), (24, 16), (4,), (9, 9, 9))
JLP = JLayered(6, 3, _WIDTHS, ACTIVATION_ORDER, block=8)
TLP = TLayered(6, 3, _WIDTHS, ACTIVATION_ORDER, block=8)
B = 9


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _layouts(name):
    widths, block = _LAYOUTS[name]
    acts = tuple(ACTIVATION_ORDER[i % 10] for i in range(len(widths)))
    return (JLayered(5, 3, widths, acts, block=block),
            TLayered(5, 3, widths, acts, block=block))


def _moved(fn):
    """``fn()`` and the kernel counters it moved."""
    before = tlc.kernel_launches()
    out = fn()
    after = tlc.kernel_launches()
    return out, {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}


# --------------------------------------------------------------------- #
# the two kernels' functions and their gradients                        #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("name", sorted(_LAYOUTS))
def test_block_diag_gemm_and_vjp_match_jax(name):
    """Forward, dh and dWB of every mid layer against JAX's
    ``ops.block_diag_gemm`` (interpret) and its ``jax.vjp``; one forward
    and one backward launch the forward kernel twice and dW once."""
    jlp, tlp = _layouts(name)
    rng = np.random.default_rng(len(name))
    for l in range(jlp.depth - 1):
        jlay, tlay = jlp.bd_layout(l), tlp.bd_layout(l)
        blk = jlay.block
        h = rng.normal(0, 1, (B, jlay.n_in_tiles * blk)).astype(np.float32)
        wb = (rng.normal(0, 1, (jlay.n_param_blocks, blk, blk))
              / np.sqrt(blk)).astype(np.float32)
        dy = rng.normal(0, 1, (B, jlay.n_out_tiles * blk)).astype(np.float32)
        jy, vjp = jax.vjp(lambda a, w: jops.block_diag_gemm(
            a, w, jlay, interpret=True), jnp.asarray(h), jnp.asarray(wb))
        jdh, jdwb = vjp(jnp.asarray(dy))
        th = _t(h).requires_grad_(True)
        tw = _t(wb).requires_grad_(True)

        def fwd_bwd():
            y = tops.block_diag_gemm(th, tw, tlay)
            return y, torch.autograd.grad(y, (th, tw), _t(dy))

        (ty, (tdh, tdwb)), n = _moved(fwd_bwd)
        assert n == {"block_diag_fwd": 2, "block_diag_dw": 1}
        np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                                   **FWD)
        np.testing.assert_allclose(tdh.numpy(), np.asarray(jdh), **GRAD)
        np.testing.assert_allclose(tdwb.numpy(), np.asarray(jdwb), **GRAD)
        # without a gradient to take: the forward kernel alone
        with torch.no_grad():
            got, n = _moved(lambda: tops.block_diag_gemm(th, tw, tlay))
        assert n == {"block_diag_fwd": 1}
        assert torch.equal(got, ty.detach())


def _kink_inputs(rng, hh):
    """Pre-activations with every third column exactly on a kink (0, ±0.5)
    and the rest spread over the activations' curved parts."""
    h = rng.normal(0, 2, (B, hh)).astype(np.float32)
    h[:, ::3] = np.resize(np.array([0.0, 0.5, -0.5], np.float32),
                          (B, len(range(0, hh, 3))))
    return h


@pytest.mark.parametrize("block", [8, 16])
def test_seg_act_and_vjp_match_jax(block):
    """All ten activations, the padding mask and inputs on the kinks:
    ``act(h)·mask`` and ``(dy·mask)·act'(h)`` against JAX's ``ops.seg_act``
    (interpret) and its ``jax.vjp``, one launch per direction."""
    rng = np.random.default_rng(block)
    n_blocks = 2 * len(ACTIVATION_ORDER)
    hh = n_blocks * block
    h = _kink_inputs(rng, hh)
    dy = rng.normal(0, 1, (B, hh)).astype(np.float32)
    ids = (np.arange(n_blocks) % len(ACTIVATION_ORDER)).astype(np.int32)
    mask = (rng.random(hh) > 0.25).astype(np.float32)
    # JAX marks the static arrays it is given read-only: give it copies
    jy, vjp = jax.vjp(lambda a: jops.seg_act(a, ids.copy(), mask.copy(),
                                             block_h=block, interpret=True),
                      jnp.asarray(h))
    (jdh,) = vjp(jnp.asarray(dy))
    th = _t(h).requires_grad_(True)

    def fwd_bwd():
        y = tops.seg_act(th, ids, mask, block=block)
        return y, torch.autograd.grad(y, (th,), _t(dy))

    (ty, (tdh,)), n = _moved(fwd_bwd)
    assert n == {"seg_act": 1, "seg_act_bwd": 1}
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **FWD)
    np.testing.assert_allclose(tdh.numpy(), np.asarray(jdh), **FWD)
    with pytest.raises(ValueError, match="aligned"):
        tops.seg_act(th[:, 1:], ids, mask, block=block)


# --------------------------------------------------------------------- #
# the route as a whole                                                  #
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def np_params():
    return jax.device_get(jdeep.init_params(jax.random.PRNGKey(0), JLP))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(1)
    return (rng.normal(0, 1, (B, 6)).astype(np.float32),
            rng.integers(0, 3, B).astype(np.int32))


def test_unfused_forward_and_grads_match_jax(np_params, batch):
    """``forward(infer=True)`` and ``loss_and_grads`` on the unfused route
    against JAX's same route (its kernels in interpret mode)."""
    x, y = batch
    params = tdeep.params_from_numpy(np_params, TLP, device="cpu")
    want = jdeep.forward(np_params, x, JLP, infer=True, **UNFUSED)
    got = tdeep.forward(params, _t(x), TLP, infer=True, **UNFUSED)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ROUTE)
    (jl, jper), jgrads = jax.value_and_grad(jdeep.fused_loss, has_aux=True)(
        np_params, x, y, JLP, **UNFUSED)
    loss, per, grads = tdeep.loss_and_grads(params, _t(x),
                                            _t(y, torch.long), TLP,
                                            **UNFUSED)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jl), **ROUTE)
    np.testing.assert_allclose(per.numpy(), np.asarray(jper), **ROUTE)
    gl, wl = tree_leaves(grads), jax.tree.leaves(jgrads)
    assert len(gl) == len(wl)
    for i, (a, b) in enumerate(zip(gl, wl)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   err_msg=f"leaf {i}", **ROUTE)


def test_unfused_launches_match_jax(np_params, batch):
    """One forward and one optimizer step launch, kernel by kernel, what
    ``launch_count`` states, and in total what JAX's jaxpr count gives for
    the same route."""
    x, y = batch
    params = tdeep.params_from_numpy(np_params, TLP, device="cpu")
    _, n = _moved(lambda: tdeep.forward(params, _t(x), TLP, infer=True,
                                        **UNFUSED))
    assert n == tlc.unfused_infer_launches(TLP.depth)
    assert sum(n.values()) == jlc.count_pallas_launches(
        lambda p, xx: jdeep.forward(p, xx, JLP, infer=True, **UNFUSED),
        np_params, x)
    opt = topt.sgd()
    _, n = _moved(lambda: tdeep.opt_step(
        params, opt.init(params), _t(x), _t(y, torch.long), 0.1, opt, TLP,
        **UNFUSED))
    assert n == tlc.unfused_step_launches(TLP.depth)
    jphase = jlc.phase_launches(
        lambda p: jdeep.fused_loss(p, x, y, JLP, **UNFUSED)[0], np_params)
    assert sum(n.values()) == jphase["total"]
    assert sum(tlc.unfused_infer_launches(TLP.depth).values()) == \
        jphase["fwd"]


def test_in_impl_pallas_raises_as_jax(np_params, batch):
    """Neither package has an input impl named 'pallas': both raise the
    same ValueError."""
    x, _ = batch
    params = tdeep.params_from_numpy(np_params, TLP, device="cpu")
    with pytest.raises(ValueError) as jerr:
        jdeep.forward(np_params, x, JLP, in_impl="pallas", **UNFUSED)
    with pytest.raises(ValueError) as terr:
        tdeep.forward(params, _t(x), TLP, in_impl="pallas", **UNFUSED)
    assert str(terr.value) == str(jerr.value)
    assert "unknown in_impl 'pallas'" in str(terr.value)


# --------------------------------------------------------------------- #
# the drivers                                                           #
# --------------------------------------------------------------------- #

TRAIN = ["--arch", "parallelmlp-10k", "--reduced", "--steps", "4",
         "--batch", "8", "--samples", "128", "--scan-steps", "2",
         "--population-depths", "6,4;5;3,4,2", "--population-acts",
         "relu,tanh,mish", "--population-repeats", "2",
         "--population-features", "5", "--ckpt-every", "2",
         "--device", "cpu", "--bd-impl", "pallas", "--act-impl", "pallas"]


def test_train_main_unfused_on_cpu_restores_in_jax(tmp_path, capsys):
    """``train.main`` on the unfused route: every step's backward through
    the two backward kernels, the trained parameters those of the same run
    on the plain einsum route, and JAX restores the checkpoint to them."""
    ck = tmp_path / "ck"
    (params, lp, stats), n = _moved(lambda: ttrain.main(
        TRAIN + ["--ckpt-dir", str(ck)]))
    assert stats["steps"] == 4 and "leaderboard:" in capsys.readouterr().out
    step = tlc.unfused_step_launches(lp.depth)
    assert n["seg_act_bwd"] == 4 * step["seg_act_bwd"]
    assert n["block_diag_dw"] == 4 * step["block_diag_dw"]
    assert set(n) == set(step)
    plain = TRAIN[:-4] + ["--ckpt-dir", str(tmp_path / "plain")]
    want, _, _ = ttrain.main(plain)
    for a, b in zip(tree_leaves(params), tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **ROUTE)
    jp, jl, jstep = jckpt.restore_population(str(ck))
    assert jstep == 3 and jl.widths == lp.widths
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_train_main_unfused_m3_pallas_on_cpu(tmp_path, capsys):
    """``train.main`` with every unfused stage on its kernels
    (``--m3-impl pallas`` too): each step exactly
    ``unfused_step_launches(depth, "pallas")`` (the closing leaderboard
    adds forwards only), the trained parameters those of the same run
    with the plain M3 head, and JAX restores the checkpoint to them."""
    ck = tmp_path / "ck"
    (params, lp, stats), n = _moved(lambda: ttrain.main(
        TRAIN + ["--ckpt-dir", str(ck), "--m3-impl", "pallas"]))
    assert stats["steps"] == 4 and "leaderboard:" in capsys.readouterr().out
    step = tlc.unfused_step_launches(lp.depth, "pallas")
    for k in ("seg_act_bwd", "block_diag_dw", "m3_matmul_dh",
              "m3_matmul_dw"):
        assert n[k] == 4 * step[k], k
    assert n["m3_matmul_fwd"] > 4 and set(n) == set(step)
    want, _, _ = ttrain.main(TRAIN + ["--ckpt-dir", str(tmp_path / "b")])
    for a, b in zip(tree_leaves(params), tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **ROUTE)
    jp, jl, jstep = jckpt.restore_population(str(ck))
    assert jstep == 3 and jl.widths == lp.widths
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_serve_main_unfused_on_cpu(np_params, tmp_path, capsys):
    """The serving driver on the unfused route: no depth+1 budget (that
    check is the fused route's), every forward one ``seg_act`` per layer
    and one ``block_diag_fwd`` per mid layer, nothing else launched, the
    three modes served."""
    params = tdeep.params_from_numpy(np_params, TLP, device="cpu")
    tckpt.save_population(str(tmp_path), 0, params, TLP)
    out, n = _moved(lambda: tserve.main(
        ["--ckpt-dir", str(tmp_path), "--requests", "20", "--batch", "8",
         "--calib-samples", "32", "--device", "cpu", "--bd-impl", "pallas",
         "--act-impl", "pallas"]))
    assert out["budget"] is None
    assert "launch budget" not in capsys.readouterr().out
    per = tlc.unfused_infer_launches(TLP.depth)
    forwards = n["seg_act"] // per["seg_act"]
    # one calibration slab, then per mode a warm-up and three flushes
    assert forwards == 1 + 3 * (1 + 3)
    assert n == {k: forwards * v for k, v in per.items()}
    assert set(out["serve"]) == {"best1", "topk", "all"}
    for row in out["serve"].values():
        assert row["requests"] == 20 and row["p99_ms"] >= row["p50_ms"] > 0


def test_serving_defaults_match_jax():
    """``PopulationServer`` and the serving CLI default to the JAX
    server's impls: the fused mid layers and the seg_act activation."""
    for name in ("bd_impl", "act_impl"):
        assert inspect.signature(tserve.PopulationServer).parameters[
            name].default == inspect.signature(
                jserve.PopulationServer).parameters[name].default
    server = tserve.PopulationServer(
        tdeep.init_params(torch.Generator().manual_seed(0), TLP), TLP)
    assert server._fw["act_impl"] == "pallas"
    assert server.check_budget() == {"launches": 4, "budget": 4}
