"""The port's int8 serve copy held against the JAX package on the CPU.

The same numpy parameters go through ``repro.quant`` and
``repro_torch.quant``: the int8 tiles and the f32 scales must be
byte-equal.  JAX's int8 forward runs as tests/test_quantized_serve.py runs
it (interpret-mode Pallas kernels); the port runs each fused-dequant
kernel's plain PyTorch version, which its dispatch layer picks for a CPU
tensor.  Tolerance rtol 1e-5 / atol 1e-6 (tests/test_quantized_serve.py):
f32 on both sides, sums taken in a different order.
"""
import jax
import numpy as np
import pytest
import torch

from repro import quant as jquant
from repro.core import deep as jdeep
from repro.core.activations import ACTIVATION_ORDER
from repro.core.population import LayeredPopulation as JLayered
from repro.kernels import ops as jops
from repro_torch import quant as tquant
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.core import deep as tdeep
from repro_torch.core.population import LayeredPopulation as TLayered
from repro_torch.core.tree import tree_leaves
from repro_torch.kernels import fused_input as fik
from repro_torch.kernels import fused_layer as flk
from repro_torch.kernels import infer_head as ihk
from repro_torch.kernels import ops as tops
from repro_torch.launch import launch_count
from repro_torch.launch import serve_population as tserve

RTOL, ATOL = 1e-5, 1e-6

# the heterogeneous population of tests/test_quantized_serve.py: one member
# per activation, depths 1..3, pass-through slots in both mid layers
_WIDTHS = ((5, 3), (12, 9), (7,), (17, 9, 5), (8, 8),
           (5, 3), (3, 11, 2), (24, 16), (4,), (9, 9, 9))
JLP = JLayered(6, 3, _WIDTHS, ACTIVATION_ORDER, block=8)
TLP = TLayered(6, 3, _WIDTHS, ACTIVATION_ORDER, block=8)
LAYOUTS = {"plain": (JLP, TLP), "shard_pad": (JLP.shard_pad(4),
                                              TLP.shard_pad(4))}
B = 9
INT8_KERNELS = {"fused_input_int8", "fused_layer_int8", "infer_head_int8"}


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


@pytest.fixture(scope="module")
def trees():
    """Per layout: JAX's f32 parameters and its int8 copy, as numpy."""
    out = {}
    for name, (jl, _) in LAYOUTS.items():
        p = jax.device_get(jdeep.init_params(jax.random.PRNGKey(0), jl))
        out[name] = (p, jax.device_get(jquant.quantize_population(p, jl)))
    return out


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(1).normal(0, 1, (B, 6)).astype(np.float32)


def _int8_forward_jax(qp, x, jl, **kw):
    return np.asarray(jdeep.forward(qp, x, jl, bd_impl="fused",
                                    act_impl="pallas", infer=True,
                                    weights_dtype="int8", **kw))


# --------------------------------------------------------------------- #
# the packer                                                             #
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_packer_byte_equal_to_jax(trees, layout):
    """Every int8 tile (identity tile and pass-through slots included) and
    every f32 scale and bias, byte for byte and key for key."""
    jl, tl = LAYOUTS[layout]
    p, want = trees[layout]
    got = tquant.quantize_population(
        tdeep.params_from_numpy(p, tl, device="cpu"), tl)
    back = tdeep.qparams_to_numpy(got)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), _leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    eye = np.eye(8, dtype=np.int8)
    for layer in got["mid"]:
        assert np.array_equal(layer["wb"][-1].numpy(), eye)
        assert float(layer["scale"][-1]) == 1.0
    assert got["w_in"].shape[1] == tquant._input_f_pad(6) == 8


def test_packer_against_jitted_jax(trees):
    """JAX's server jit-compiles the packer; XLA then multiplies by 1/127
    where the function divides by 127.  The int8 tiles are the same, the
    scales within one ulp."""
    p, _ = trees["plain"]
    want = jax.device_get(jax.jit(jquant.quantize_population,
                                  static_argnums=1)(p, JLP))
    got = tquant.quantize_population(
        tdeep.params_from_numpy(p, TLP, device="cpu"), TLP)
    for a, b in zip(jax.tree.leaves(tdeep.qparams_to_numpy(got)),
                    _leaves(want)):
        if a.dtype == np.int8:
            assert a.tobytes() == b.tobytes()
        else:
            np.testing.assert_array_max_ulp(a, b, maxulp=1)


def test_scale_math_matches_jax():
    rng = np.random.default_rng(5)
    a = (rng.normal(0, 1, (7, 24)) * 3.7).astype(np.float32)
    a[2] = 0.0                              # an all-zero group stays finite
    s_j = np.asarray(jquant.symmetric_scale(a, axis=1))
    s_t = tquant.symmetric_scale(_t(a), dim=1).numpy()
    assert s_t.tobytes() == s_j.tobytes()
    q_j = np.asarray(jquant.quantize(a, s_j[:, None]))
    q_t = tquant.quantize(_t(a), _t(s_t)[:, None]).numpy()
    assert q_t.tobytes() == q_j.tobytes() and q_t[2].max() == 0
    # half-way values round to even, as jnp.round does
    half = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 126.5, 200.0], np.float32)
    assert tquant.quantize(_t(half), 1.0).tolist() == \
        np.asarray(jquant.quantize(half, 1.0)).tolist() == \
        [0, 2, 2, 0, -2, 126, 127]
    assert float(tquant.symmetric_scale(_t(a))) == \
        float(jquant.symmetric_scale(a))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_dequantize_and_unpack_match_jax(trees, layout):
    jl, tl = LAYOUTS[layout]
    _, qj = trees[layout]
    qt = tdeep.qparams_from_numpy(qj, tl, device="cpu")
    want = jax.device_get(jquant.dequantize_population(qj, jl))
    got = tdeep.params_to_numpy(tquant.dequantize_population(qt, tl))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), _leaves(want)):
        np.testing.assert_array_equal(a, b)
    n_p = tl.bd_layout(0).n_param_blocks
    for wb_j, wb_t in ((qj["mid"][0]["wb"][:n_p],
                        qt["mid"][0]["wb"][:n_p]),):
        for a, b in zip(tquant.unpack_weight_tiles(wb_t, tl, 0),
                        jquant.unpack_weight_tiles(wb_j, jl, 0)):
            assert a.numpy().tobytes() == np.asarray(b).tobytes()
        # unpack is the inverse of the port's packer
        packed = tdeep.pack_weight_tiles(
            tquant.unpack_weight_tiles(wb_t, tl, 0), tl, 0)
        assert torch.equal(packed, wb_t)


def test_serve_copy_bytes_and_qparams_carry(trees):
    p, qj = trees["plain"]
    qt = tdeep.qparams_from_numpy(qj, TLP, device="cpu")
    assert tquant.serve_copy_bytes(qt) == jquant.serve_copy_bytes(qj)
    assert tquant.serve_copy_bytes(tdeep.params_from_numpy(p, TLP,
                                                           device="cpu")) \
        == jquant.serve_copy_bytes(p)
    assert qt["w_in"].dtype == qt["mid"][1]["wb"].dtype == torch.int8
    assert qt["w_out_scale"].dtype == torch.float32
    bad = dict(qj, w_in=qj["w_in"][:, :6])           # not pre-padded
    with pytest.raises(ValueError, match="w_in: shape"):
        tdeep.qparams_from_numpy(bad, TLP, device="cpu")
    bad = dict(qj, w_out=qj["w_out"].astype(np.float32))
    with pytest.raises(ValueError, match="w_out: float32"):
        tdeep.qparams_from_numpy(bad, TLP, device="cpu")
    bad = dict(qj, mid=qj["mid"][:1])
    with pytest.raises(ValueError, match="mid: 1 entries"):
        tdeep.qparams_from_numpy(bad, TLP, device="cpu")


# --------------------------------------------------------------------- #
# the three int8 ops against the JAX wrappers                            #
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("block,n_blocks,f", [(8, 10, 6), (16, 12, 37)])
def test_fused_input_int8_plain_matches_jax(block, n_blocks, f):
    rng = np.random.default_rng(block)
    h = block * n_blocks
    f_pad = tquant._input_f_pad(f)
    x = rng.normal(0, 1, (B, f)).astype(np.float32)
    w_q = rng.integers(-127, 128, (h, f_pad)).astype(np.int8)
    w_q[:, f:] = 0
    w_s = (rng.random(n_blocks) * 0.02 + 1e-3).astype(np.float32)
    b = rng.normal(0, 1, h).astype(np.float32)
    ids = (np.arange(n_blocks) % len(ACTIVATION_ORDER)).astype(np.int32)
    mask = (rng.random(h) > 0.2).astype(np.float32)
    want = jops.fused_input_infer_int8(x, w_q, w_s, b, ids, mask,
                                       block=block)
    n0 = fik.int8_launches
    got = tops.fused_input_infer_int8(_t(x), _t(w_q, torch.int8), _t(w_s),
                                      _t(b), ids, mask, block=block)
    assert fik.int8_launches == n0 + 1
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("l", [0, 1])
def test_fused_layer_int8_plain_matches_jax(l):
    """Every activation in the epilogue, pass-through steps on the
    appended identity tile (scale 1.0) included."""
    lay = TLP.bd_layout(l)
    blk = lay.block
    rng = np.random.default_rng(l)
    h = rng.normal(0, 1, (B, lay.n_in_tiles * blk)).astype(np.float32)
    wb_q = rng.integers(-127, 128, (lay.n_param_blocks + 1, blk, blk)
                        ).astype(np.int8)
    wb_q[-1] = np.eye(blk, dtype=np.int8)
    wb_s = (rng.random(lay.n_param_blocks + 1) * 0.02 + 1e-3
            ).astype(np.float32)
    wb_s[-1] = 1.0
    b_eff = rng.normal(0, 1, lay.n_out_tiles * blk).astype(np.float32)
    acts = (np.arange(lay.n_out_tiles) % len(ACTIVATION_ORDER)
            ).astype(np.int32)
    mask = (rng.random(lay.n_out_tiles * blk) > 0.2).astype(np.float32)
    assert np.any(np.asarray(lay.s_w) == lay.n_param_blocks)  # pass-through
    want = jops.fused_layer_infer_int8(h, wb_q, wb_s, b_eff,
                                       JLP.bd_layout(l), acts, mask)
    n0 = flk.int8_launches
    got = tops.fused_layer_infer_int8(_t(h), _t(wb_q, torch.int8), _t(wb_s),
                                      _t(b_eff), lay, acts, mask)
    assert flk.int8_launches == n0 + 1
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("log_probs", [False, True])
def test_infer_head_int8_plain_matches_jax(log_probs):
    pop = TLP.layer_pop(TLP.depth - 1)
    rng = np.random.default_rng(3)
    hh = pop.total_hidden
    h = rng.normal(0, 1, (B, hh)).astype(np.float32)
    w_q = rng.integers(-127, 128, (3, hh)).astype(np.int8)
    w_s = (rng.random(hh // pop.block) * 0.01 + 1e-3).astype(np.float32)
    b2 = rng.normal(0, 1, (pop.num_members, 3)).astype(np.float32)
    want = jops.infer_head_int8(h, w_q, w_s, b2, pop.block_segment_ids,
                                block_h=pop.block, log_probs=log_probs)
    n0 = ihk.int8_launches
    got = tops.infer_head_int8(_t(h), _t(w_q, torch.int8), _t(w_s), _t(b2),
                               pop.block_segment_ids, block_h=pop.block,
                               log_probs=log_probs)
    assert ihk.int8_launches == n0 + 1
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_int8_ops_reject_what_they_cannot_run(trees):
    """JAX's argument checks: int8 weights, the pre-augmented tile array,
    the pre-padded input weight, the scale shapes."""
    qt = tdeep.qparams_from_numpy(trees["plain"][1], TLP, device="cpu")
    x = torch.zeros(2, 6)
    p0 = TLP.layer_pop(0)
    ids, mask = p0.block_act_ids, p0.hidden_mask
    with pytest.raises(ValueError, match="int8 serve path"):
        tops.fused_input_infer_int8(x, qt["w_in"].float(), qt["w_in_scale"],
                                    qt["b_in"], ids, mask, block=8)
    with pytest.raises(ValueError, match="pre-padded 8"):
        tops.fused_input_infer_int8(x, qt["w_in"][:, :6], qt["w_in_scale"],
                                    qt["b_in"], ids, mask, block=8)
    with pytest.raises(ValueError, match="scales"):
        tops.fused_input_infer_int8(x, qt["w_in"], qt["w_in_scale"][:-1],
                                    qt["b_in"], ids, mask, block=8)
    lay = TLP.bd_layout(0)
    pout = TLP.layer_pop(1)
    h = torch.zeros(2, lay.n_in_tiles * 8)
    mid = qt["mid"][0]
    b_eff = mid["b"]
    with pytest.raises(ValueError, match="pre-augmented"):
        tops.fused_layer_infer_int8(h, mid["wb"][:-1], mid["scale"][:-1],
                                    b_eff, lay, pout.block_act_ids,
                                    pout.hidden_mask)
    with pytest.raises(ValueError, match="int8 serve path"):
        tops.fused_layer_infer_int8(h, mid["wb"].float(), mid["scale"],
                                    b_eff, lay, pout.block_act_ids,
                                    pout.hidden_mask)
    with pytest.raises(ValueError, match="scales"):
        tops.fused_layer_infer_int8(h, mid["wb"], mid["scale"][:-1], b_eff,
                                    lay, pout.block_act_ids,
                                    pout.hidden_mask)
    plast = TLP.layer_pop(TLP.depth - 1)
    hl = torch.zeros(2, plast.total_hidden)
    with pytest.raises(ValueError, match="int8 serve path"):
        tops.infer_head_int8(hl, qt["w_out"].float(), qt["w_out_scale"],
                             qt["b_out"], plast.block_segment_ids, block_h=8)
    with pytest.raises(ValueError, match="scales"):
        tops.infer_head_int8(hl, qt["w_out"], qt["w_out_scale"][1:],
                             qt["b_out"], plast.block_segment_ids, block_h=8)
    # the f32 entries take no int8 weight
    with pytest.raises(TypeError, match="float32"):
        tops.infer_head(hl, qt["w_out"], qt["b_out"],
                        plast.block_segment_ids, block_h=8)


# --------------------------------------------------------------------- #
# the int8 forward                                                       #
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("log_probs", [False, True])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_int8_forward_matches_jax_and_dequant_reference(trees, x, layout,
                                                        log_probs):
    """The port's int8 forward on JAX's int8 tree against JAX's int8
    forward, and against the port's own f32 forward of the dequantized
    tree (the f32 kernels' plain versions)."""
    jl, tl = LAYOUTS[layout]
    _, qj = trees[layout]
    want = _int8_forward_jax(qj, x, jl, log_probs=log_probs)
    qt = tdeep.qparams_from_numpy(qj, tl, device="cpu")
    got = tdeep.forward(qt, _t(x), tl, bd_impl="fused", infer=True,
                        weights_dtype="int8", log_probs=log_probs)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    ref = tdeep.forward(tquant.dequantize_population(qt, tl), _t(x), tl,
                        bd_impl="fused", infer=True, log_probs=log_probs)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_int8_forward_is_depth_plus_one_int8_launches(trees, x):
    qt = tdeep.qparams_from_numpy(trees["plain"][1], TLP, device="cpu")
    before = launch_count.kernel_launches()
    tdeep.forward(qt, _t(x), TLP, bd_impl="fused", infer=True,
                  weights_dtype="int8")
    after = launch_count.kernel_launches()
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert moved == {"fused_input_int8": 1, "fused_layer_int8": 2,
                     "infer_head_int8": 1}
    assert sum(moved.values()) == \
        launch_count.fused_infer_budget(TLP.depth)["total"]


def test_int8_routing_errors(trees, x):
    """JAX's rules: int8 only at serving time, only through the fused
    kernels and the fused_int8 head, requested by weights_dtype alone."""
    p, qj = trees["plain"]
    qt = tdeep.qparams_from_numpy(qj, TLP, device="cpu")
    params = tdeep.params_from_numpy(p, TLP, device="cpu")
    xt = _t(x)
    with pytest.raises(ValueError, match="serving-only"):
        tdeep.forward(qt, xt, TLP, bd_impl="fused", weights_dtype="int8")
    with pytest.raises(ValueError, match="fused serving kernels"):
        tdeep.forward(qt, xt, TLP, bd_impl="einsum", infer=True,
                      weights_dtype="int8")
    with pytest.raises(ValueError, match="fused serving kernels"):
        tdeep.forward(qt, xt, TLP, bd_impl="fused", in_impl="xla",
                      infer=True, weights_dtype="int8")
    with pytest.raises(ValueError, match="weights_dtype"):
        tdeep.forward(params, xt, TLP, bd_impl="fused_int8", infer=True)
    with pytest.raises(ValueError, match="head_impl"):
        tdeep.forward(qt, xt, TLP, bd_impl="fused", infer=True,
                      weights_dtype="int8", head_impl="fused")
    with pytest.raises(ValueError, match="head_impl"):
        tdeep.forward(params, xt, TLP, bd_impl="fused", infer=True,
                      head_impl="fused_int8")
    for wd in ("int4", "bfloat16"):
        with pytest.raises(ValueError, match="weights_dtype"):
            tdeep.forward(params, xt, TLP, bd_impl="fused", infer=True,
                          weights_dtype=wd)
    # "float32" means the f32 weights, as None does
    np.testing.assert_array_equal(
        tdeep.forward(params, xt, TLP, bd_impl="fused", infer=True,
                      weights_dtype="float32").numpy(),
        tdeep.forward(params, xt, TLP, bd_impl="fused", infer=True).numpy())
    # int8 under the bf16 compute policy runs (x and h cast to bf16
    # before each int8 kernel), as JAX's on the same bytes
    got = tdeep.forward(qt, xt, TLP, bd_impl="fused", infer=True,
                        weights_dtype="int8", compute_dtype="bfloat16")
    np.testing.assert_allclose(
        got.numpy(), _int8_forward_jax(qj, x, JLP, compute_dtype="bfloat16"),
        rtol=2e-2, atol=2e-2)


# --------------------------------------------------------------------- #
# the server and its driver                                              #
# --------------------------------------------------------------------- #


def _calib(n=32, seed=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (n, 6)).astype(np.float32),
            rng.integers(0, 3, n).astype(np.int32))


def test_server_quantizes_once_and_holds_no_f32_weight(trees):
    p, qj = trees["plain"]
    masters = tdeep.params_from_numpy(p, TLP, device="cpu")
    server = tserve.PopulationServer(masters, TLP, weights_dtype="int8",
                                     batch=8, topk=2)
    assert server.check_budget() == {"launches": 4, "budget": 4}
    qp = server.params
    assert qp is not masters
    for key in ("w_in", "w_out"):
        assert qp[key].dtype == torch.int8
    assert all(layer["wb"].dtype == torch.int8 for layer in qp["mid"])
    # no f32 weight survives (the f32 biases are the serve copy's own)
    weights = [masters["w_in"], masters["w_out"],
               *(w for layer in masters["mid"] for w in layer["w"])]
    assert not any(t is w for t in tree_leaves(qp) for w in weights)
    # the server's copy is the port's packer on the masters, byte for byte
    for a, b in zip(jax.tree.leaves(tdeep.qparams_to_numpy(qp)),
                    _leaves(qj)):
        assert a.tobytes() == b.tobytes()
    before = launch_count.kernel_launches()
    board = server.publish(*_calib())
    r = server.run(_calib(16, 6)[0], "topk")
    after = launch_count.kernel_launches()
    assert server.params is qp                      # quantized once
    assert {k for k in after if after[k] != before[k]} == INT8_KERNELS
    assert board[0]["rank"] == 1 and r["members_served"] == 2
    assert r["pred"].shape == (16,)


def test_server_refresh_requantizes(trees):
    p, _ = trees["plain"]
    server = tserve.PopulationServer(
        tdeep.params_from_numpy(p, TLP, device="cpu"), TLP,
        weights_dtype="int8", batch=8, topk=2)
    server.check_budget()
    first = server.params
    fresh = tdeep.init_params(torch.Generator().manual_seed(5), TLP)
    server.refresh(fresh, TLP)
    assert server.params["w_in"].dtype == torch.float32     # new masters
    server.check_budget()
    assert server.params["w_in"].dtype == torch.int8        # re-quantized
    assert not torch.equal(server.params["w_in"], first["w_in"])
    want = tquant.quantize_population(fresh, TLP)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(server.params), tree_leaves(want)))


def test_serve_main_int8_on_cpu(trees, tmp_path, capsys):
    """The serving driver end to end over the int8 copy, on the CPU:
    restore, quantize, launch budget, publish, the three modes — and not
    one f32 kernel launched."""
    p, qj = trees["plain"]
    tckpt.save_population(str(tmp_path), 1,
                          tdeep.params_from_numpy(p, TLP, device="cpu"), TLP)
    before = launch_count.kernel_launches()
    out = tserve.main(["--ckpt-dir", str(tmp_path), "--requests", "20",
                       "--batch", "8", "--calib-samples", "32",
                       "--device", "cpu", "--weights-dtype", "int8"])
    after = launch_count.kernel_launches()
    assert out["budget"] == {"launches": 4, "budget": 4}
    assert {k for k in after if after[k] != before[k]} == INT8_KERNELS
    assert out["serve_copy_bytes"] == jquant.serve_copy_bytes(qj)
    assert set(out["serve"]) == {"best1", "topk", "all"}
    for row in out["serve"].values():
        assert row["requests"] == 20 and row["p99_ms"] >= row["p50_ms"] > 0
    assert "serving int8 weights" in capsys.readouterr().out
