"""The port's serving slice held against the JAX package on the CPU.

Same numpy inputs and parameters go through both packages.  JAX runs its
Pallas kernels as its own tests do (interpret mode, through
``ops._resolve_interpret``); the port runs each kernel's plain PyTorch
version, which its dispatch layer picks for a CPU tensor.  Tolerance
rtol 1e-5 / atol 1e-6 (tests/test_infer_path.py): f32 on both sides, sums
taken in a different order.
"""
import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.core import deep as jdeep
from repro.core import ensemble as jens
from repro.core import selection as jsel
from repro.core.activations import ACTIVATION_ORDER
from repro.core.population import LayeredPopulation as JLayered
from repro.kernels import ops as jops
from repro.launch import serve_population as jserve
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.core import deep as tdeep
from repro_torch.core import ensemble as tens
from repro_torch.core import selection as tsel
from repro_torch.core.activations import ACTIVATIONS as TACTS
from repro_torch.core.population import LayeredPopulation as TLayered
from repro_torch.device import resolve
from repro_torch.kernels import fused_input as fik
from repro_torch.kernels import fused_layer as flk
from repro_torch.kernels import infer_head as ihk
from repro_torch.kernels import ops as tops
from repro_torch.launch import launch_count
from repro_torch.launch import serve_population as tserve

RTOL, ATOL = 1e-5, 1e-6

# one member per activation, depths 1..3 (tests/test_infer_path.py)
_WIDTHS = ((5, 3), (12, 9), (7,), (17, 9, 5), (8, 8),
           (5, 3), (3, 11, 2), (24, 16), (4,), (9, 9, 9))
JLP = JLayered(6, 3, _WIDTHS, ACTIVATION_ORDER, block=8)
TLP = TLayered(6, 3, _WIDTHS, ACTIVATION_ORDER, block=8)
B = 9


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


@pytest.fixture(scope="module")
def np_params():
    """The JAX package's initial parameters, as numpy."""
    return jax.device_get(jdeep.init_params(jax.random.PRNGKey(0), JLP))


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(1).normal(0, 1, (B, 6)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_logits(np_params, x):
    """JAX's serving forward (interpret-mode kernels) and its einsum
    reference, logits and log-probs."""
    fused = dict(bd_impl="fused", act_impl="pallas", infer=True)
    return {
        "fused": np.asarray(jdeep.forward(np_params, x, JLP, **fused)),
        "fused_lp": np.asarray(jdeep.forward(np_params, x, JLP,
                                             log_probs=True, **fused)),
        "einsum": np.asarray(jdeep.forward(np_params, x, JLP,
                                           bd_impl="einsum")),
    }


# --------------------------------------------------------------------- #
# the three kernels' plain versions against the JAX kernels             #
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("block,n_blocks,f", [(8, 10, 6), (16, 12, 37)])
def test_fused_input_plain_matches_jax(block, n_blocks, f):
    rng = np.random.default_rng(block)
    h = block * n_blocks
    x = rng.normal(0, 1, (B, f)).astype(np.float32)
    w = (rng.normal(0, 1, (h, f)) / np.sqrt(f)).astype(np.float32)
    b = rng.normal(0, 1, h).astype(np.float32)
    ids = (np.arange(n_blocks) % len(ACTIVATION_ORDER)).astype(np.int32)
    mask = (rng.random(h) > 0.2).astype(np.float32)
    want = jops.fused_input_infer(x, w, b, ids, mask, block=block)
    n0 = fik.launches
    got = tops.fused_input_infer(_t(x), _t(w), _t(b), ids, mask, block=block)
    assert fik.launches == n0 + 1
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def _layer_inputs(lay, rng):
    blk = lay.block
    h = rng.normal(0, 1, (B, lay.n_in_tiles * blk)).astype(np.float32)
    wb = (rng.normal(0, 1, (lay.n_param_blocks, blk, blk)) / np.sqrt(blk)
          ).astype(np.float32)
    b_eff = rng.normal(0, 1, lay.n_out_tiles * blk).astype(np.float32)
    acts = (np.arange(lay.n_out_tiles) % len(ACTIVATION_ORDER)
            ).astype(np.int32)
    mask = (rng.random(lay.n_out_tiles * blk) > 0.2).astype(np.float32)
    return h, wb, b_eff, acts, mask


@pytest.mark.parametrize("l", [0, 1])
def test_fused_layer_plain_matches_jax(l):
    """Every activation in the epilogue, pass-through (identity-tile)
    steps included."""
    lay = TLP.bd_layout(l)
    h, wb, b_eff, acts, mask = _layer_inputs(lay, np.random.default_rng(l))
    want = jops.fused_layer_infer(h, wb, b_eff, JLP.bd_layout(l), acts, mask)
    n0 = flk.launches
    got = tops.fused_layer_infer(_t(h), _t(wb), _t(b_eff), lay, acts, mask)
    assert flk.launches == n0 + 1
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("l", [0, 1])
def test_csr_walk_matches_plain(l):
    """The CUDA kernel's schedule — one owner per output tile looping over
    its CSR run of (s_in, s_w) steps — walked in torch equals the plain
    version, and the CSR rows are exactly the s_first..s_last runs."""
    lay = TLP.bd_layout(l)
    blk = lay.block
    rowptr, s_in, s_w = flk.csr_schedule(lay)
    first = np.flatnonzero(np.asarray(lay.s_first))
    last = np.flatnonzero(np.asarray(lay.s_last))
    np.testing.assert_array_equal(rowptr[:-1], first)
    np.testing.assert_array_equal(rowptr[1:] - 1, last)
    h, wb, b_eff, acts, mask = _layer_inputs(lay, np.random.default_rng(7))
    wb_aug = torch.cat([_t(wb), torch.eye(blk)[None]])
    ht = _t(h)
    walked = torch.empty(B, lay.n_out_tiles * blk)
    for o in range(lay.n_out_tiles):
        acc = torch.zeros(B, blk)
        for s in range(rowptr[o], rowptr[o + 1]):
            xt = ht[:, s_in[s] * blk:(s_in[s] + 1) * blk]
            acc = acc + xt @ wb_aug[s_w[s]].t()
        z = acc + _t(b_eff)[o * blk:(o + 1) * blk]
        fn = TACTS[ACTIVATION_ORDER[acts[o]]]
        walked[:, o * blk:(o + 1) * blk] = \
            fn(z) * _t(mask)[o * blk:(o + 1) * blk]
    sched = [torch.from_numpy(a) for a in (rowptr, s_in, s_w)]
    plain = flk.fused_layer_plain(ht, wb_aug, _t(b_eff), _t(mask),
                                  torch.from_numpy(acts), *sched, blk=blk)
    np.testing.assert_allclose(walked.numpy(), plain.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("log_probs", [False, True])
def test_infer_head_plain_matches_jax(log_probs):
    pop = TLP.layer_pop(TLP.depth - 1)
    rng = np.random.default_rng(3)
    h = rng.normal(0, 1, (B, pop.total_hidden)).astype(np.float32)
    w2 = (rng.normal(0, 1, (3, pop.total_hidden)) / 4).astype(np.float32)
    b2 = rng.normal(0, 1, (pop.num_members, 3)).astype(np.float32)
    want = jops.infer_head(h, w2, b2, pop.block_segment_ids,
                           block_h=pop.block, log_probs=log_probs)
    n0 = ihk.launches
    got = tops.infer_head(_t(h), _t(w2), _t(b2), pop.block_segment_ids,
                          block_h=pop.block, log_probs=log_probs)
    assert ihk.launches == n0 + 1
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_ops_reject_what_they_cannot_run():
    """The dispatch layer has a kernel for CUDA and a plain version for the
    CPU, and nothing else: any other device raises, as do non-f32 inputs
    and unsorted member blocks."""
    x = torch.zeros(2, 6, device="meta")
    w = torch.zeros(16, 6, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tops.fused_input_infer(x, w, torch.zeros(16, device="meta"),
                               np.zeros(2, np.int32), np.ones(16), block=8)
    with pytest.raises(TypeError, match="float32"):
        tops.fused_input_infer(torch.zeros(2, 6, dtype=torch.float64),
                               torch.zeros(16, 6), torch.zeros(16),
                               np.zeros(2, np.int32), np.ones(16), block=8)
    with pytest.raises(ValueError, match="contiguous"):
        tops.infer_head(torch.zeros(2, 16), torch.zeros(3, 16),
                        torch.zeros(2, 3), np.array([1, 0]), block_h=8)


# --------------------------------------------------------------------- #
# the serving forward                                                    #
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("bd_impl,head_impl", [
    ("fused", None), ("fused", "xla"), ("einsum", None), ("einsum", "fused")])
@pytest.mark.parametrize("log_probs", [False, True])
def test_forward_infer_on_jax_params(np_params, x, jax_logits, bd_impl,
                                     head_impl, log_probs):
    params = tdeep.params_from_numpy(np_params, TLP, device="cpu")
    got = tdeep.forward(params, _t(x), TLP, bd_impl=bd_impl, infer=True,
                        head_impl=head_impl, log_probs=log_probs)
    want = jax_logits["fused_lp" if log_probs else "fused"]
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-5)
    ref = jax_logits["einsum"]
    if log_probs:
        ref = np.asarray(jax.nn.log_softmax(ref, axis=-1))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=1e-5)


def test_forward_fused_is_depth_plus_one_calls(np_params, x):
    params = tdeep.params_from_numpy(np_params, TLP, device="cpu")
    before = launch_count.kernel_launches()
    tdeep.forward(params, _t(x), TLP, bd_impl="fused", infer=True)
    after = launch_count.kernel_launches()
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == \
        {"fused_input": 1, "fused_layer": TLP.depth - 1, "infer_head": 1}


def test_params_carry_and_init_distribution(np_params):
    params = tdeep.params_from_numpy(np_params, TLP, device="cpu")
    back = tdeep.params_to_numpy(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_params)):
        assert a.tobytes() == np.asarray(b).tobytes()
    bad = dict(np_params, w_in=np_params["w_in"][:, :-1])
    with pytest.raises(ValueError, match="w_in"):
        tdeep.params_from_numpy(bad, TLP, device="cpu")
    # init: the JAX package's shapes and bounds, drawn from a torch generator
    init = tdeep.init_params(torch.Generator().manual_seed(0), TLP)
    abstract = tdeep.abstract_params(TLP)
    for got, want, meta in zip(jax.tree.leaves(tdeep.params_to_numpy(init)),
                               jax.tree.leaves(np_params),
                               jax.tree.leaves(abstract,
                                               is_leaf=torch.is_tensor)):
        assert got.shape == np.asarray(want).shape == tuple(meta.shape)
    assert np.abs(init["w_in"].numpy()).max() <= 1 / np.sqrt(6)
    for l in range(TLP.depth - 1):
        passthru = TLP.active_unit_mask(l + 1) == 0
        assert passthru.any()
        assert np.all(init["mid"][l]["b"].numpy()[passthru] == 0)


def test_rejects_unported_dtypes(np_params):
    """Every compute dtype the JAX package takes runs on every route: bf16
    on the unfused route's kernels serves as JAX's (within its bf16 slice
    tolerance, 2e-2), through ``forward`` and the server; a dtype JAX
    refuses is refused here too (``ValueError``)."""
    params = tdeep.params_from_numpy(np_params, TLP, device="cpu")
    kw = {"compute_dtype": "bfloat16", "bd_impl": "pallas",
          "act_impl": "pallas"}
    x = np.random.default_rng(3).normal(0, 1, (5, 6)).astype(np.float32)
    want = jax.jit(jdeep.forward, static_argnames=(
        "lp", "bd_impl", "act_impl", "compute_dtype", "infer"))(
        np_params, x, JLP, infer=True, **kw)
    got = tdeep.forward(params, torch.from_numpy(x), TLP, infer=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2,
                               atol=2e-2)
    server = tserve.PopulationServer(params, TLP, **kw)
    with torch.inference_mode():
        assert torch.equal(tdeep.forward(params, torch.from_numpy(x), TLP,
                                         **server._fw), got)
    with pytest.raises(ValueError, match="compute_dtype"):
        tdeep.forward(params, torch.from_numpy(x), TLP, infer=True,
                      compute_dtype="float16")
    with pytest.raises(ValueError, match="weights_dtype"):
        tserve.PopulationServer(params, TLP, weights_dtype="int4")


def test_cuda_entry_points_never_fall_back():
    """Asking for the card where there is none raises; there is no CPU
    fallback."""
    if torch.cuda.is_available():
        assert resolve(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CPU fallback"):
        resolve(None)
    with pytest.raises(RuntimeError, match="no CPU fallback"):
        tckpt.restore_population("/nonexistent", device="cuda")


# --------------------------------------------------------------------- #
# selection and ensembles                                                #
# --------------------------------------------------------------------- #


def test_evaluate_and_leaderboard_match_jax(np_params):
    rng = np.random.default_rng(2)
    xe = rng.normal(0, 1, (40, 6)).astype(np.float32)
    ye = rng.integers(0, 3, 40).astype(np.int32)
    jl, ja = jsel.evaluate_population(np_params, JLP, xe, ye,
                                      bd_impl="fused", act_impl="pallas",
                                      infer=True)
    params = tdeep.params_from_numpy(np_params, TLP, device="cpu")
    tl, ta = tsel.evaluate_population(params, TLP, xe, ye, batch_size=16,
                                      bd_impl="fused", infer=True)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ta.numpy(), ja, rtol=1e-6)
    jb = jsel.leaderboard(JLP, jl, ja, k=10)
    tb = tsel.leaderboard(TLP, tl, ta, k=10)
    assert [r["slot"] for r in tb] == [r["slot"] for r in jb]
    assert [(r["hidden"], r["activation"]) for r in tb] == \
        [(r["hidden"], r["activation"]) for r in jb]
    tba = tsel.leaderboard(TLP, tl, ta, k=3, sort_by="acc")
    assert [r["slot"] for r in tba] == \
        [r["slot"] for r in jsel.leaderboard(JLP, jl, ja, k=3,
                                             sort_by="acc")]
    rows = tsel.member_metrics(TLP.shard_pad(4), np.arange(16.0))
    assert [r["depth"] for r in rows] == [len(w) for w in _WIDTHS]
    m, member = tsel.select_best(params, TLP, tl)
    assert m == int(np.argmin(jl))
    np.testing.assert_allclose(
        tdeep.member_forward(member, _t(xe)).numpy(),
        jdeep.member_forward(jdeep.extract_member(np_params, JLP, m), xe),
        rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="duplicate"):
        tsel.leaderboard(TLP, tl, member_ids=[0] * 10)


@pytest.mark.parametrize("mode,ids", [("best1", [3]), ("topk", [3, 0, 7]),
                                      ("all", None)])
def test_ensemble_predict_matches_jax(jax_logits, mode, ids):
    lg = jax_logits["fused"]
    want = jens.ensemble_predict(lg, JLP, mode, member_ids=ids,
                                 with_uncertainty=True)
    got = tens.ensemble_predict(_t(lg), TLP, mode, member_ids=ids,
                                with_uncertainty=True)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    w = tens.soft_vote(_t(lg), TLP, member_ids=[4, 6], weights=[1.0, 0.0])
    np.testing.assert_allclose(w.numpy(),
                               tens.best_member(_t(lg), TLP, 4).numpy(),
                               rtol=1e-6)


def test_fillers_never_reach_reductions(jax_logits):
    """Shard-pad fillers poisoned with 1e30 change no reduction, and naming
    a filler slot fails loudly."""
    lpp = TLP.shard_pad(4)
    nr = tens.real_slots(lpp)
    assert lpp.num_members > nr == TLP.num_members
    lg = _t(jax_logits["fused"])
    poison = torch.full((B, lpp.num_members - nr, 3), 1e30)
    lg_pad = torch.cat([lg, poison], dim=1)
    np.testing.assert_allclose(tens.soft_vote(lg_pad, lpp).numpy(),
                               tens.soft_vote(lg, TLP).numpy(), rtol=1e-6)
    for k, v in tens.disagreement(lg_pad, lpp).items():
        np.testing.assert_allclose(v.numpy(),
                                   tens.disagreement(lg, TLP)[k].numpy(),
                                   rtol=1e-5, err_msg=k)
        assert torch.isfinite(v).all(), k
    with pytest.raises(ValueError, match="filler"):
        tens.best_member(lg_pad, lpp, nr)
    with pytest.raises(ValueError, match="filler"):
        tens.ensemble_predict(lg_pad, lpp, "topk",
                              member_ids=[1, lpp.num_members - 1])
    with pytest.raises(ValueError, match="empty"):
        tens._validate_slots([], nr)


# --------------------------------------------------------------------- #
# checkpoints and the server                                             #
# --------------------------------------------------------------------- #


def test_jax_checkpoint_served_by_port(np_params, tmp_path):
    """A checkpoint written by the JAX package, served by both servers:
    same leaderboard, same predictions in every mode."""
    jckpt.save_population(str(tmp_path), 7, np_params, JLP)
    kw = dict(batch=8, topk=3)
    js, jstep = jserve.PopulationServer.from_checkpoint(str(tmp_path), **kw)
    ts, tstep = tserve.PopulationServer.from_checkpoint(
        str(tmp_path), device="cpu", **kw)
    assert jstep == tstep == 7 and ts.layout == TLP
    rng = np.random.default_rng(4)
    xc = rng.normal(0, 1, (24, 6)).astype(np.float32)
    yc = rng.integers(0, 3, 24).astype(np.int32)
    xr = rng.normal(0, 1, (19, 6)).astype(np.float32)
    jb, tb = js.publish(xc, yc), ts.publish(xc, yc)
    assert [r["slot"] for r in tb] == [r["slot"] for r in jb]
    np.testing.assert_allclose([r["loss"] for r in tb],
                               [r["loss"] for r in jb], rtol=RTOL)
    assert ts.published == js.published
    for mode in ("best1", "topk", "all"):
        jr, tr = js.run(xr, mode), ts.run(xr, mode)
        np.testing.assert_array_equal(tr["pred"], jr["pred"], err_msg=mode)
        np.testing.assert_allclose(tr["mutual_information"],
                                   jr["mutual_information"], rtol=1e-4,
                                   atol=1e-6, err_msg=mode)
        assert tr["members_served"] == jr["members_served"]


def test_port_checkpoint_restored_by_jax(np_params, tmp_path):
    """The port writes the JAX package's format key for key: JAX restores
    it to the same parameters and layout."""
    params = tdeep.params_from_numpy(np_params, TLP, device="cpu")
    tckpt.save_population(str(tmp_path / "t"), 3, params, TLP)
    jckpt.save_population(str(tmp_path / "j"), 3, np_params, JLP)
    jp, jl, step = jckpt.restore_population(str(tmp_path / "t"))
    assert step == 3 and jl == JLP
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(np_params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    tmeta, _ = tckpt.load_meta(str(tmp_path / "t"))
    jmeta, _ = jckpt.load_meta(str(tmp_path / "j"))
    assert tmeta == jmeta
    tz = np.load(tmp_path / "t" / "step_00000003" / "arrays.npz")
    jz = np.load(tmp_path / "j" / "step_00000003" / "arrays.npz")
    assert tz.files == jz.files
    for k in jz.files:
        assert tz[k].tobytes() == jz[k].tobytes(), k
    tp, tl, _ = tckpt.restore_population(str(tmp_path / "j"), device="cpu")
    assert tl == TLP
    for a, b in zip(jax.tree.leaves(tdeep.params_to_numpy(tp)),
                    jax.tree.leaves(np_params)):
        assert a.tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("b", [9, 1024], ids=["small_b", "large_b"])
def test_check_budget_is_depth_plus_one(np_params, b):
    params = tdeep.params_from_numpy(np_params, TLP, device="cpu")
    server = tserve.PopulationServer(params, TLP, batch=b)
    assert server.check_budget() == {"launches": TLP.depth + 1,
                                     "budget": TLP.depth + 1}
    assert launch_count.fused_infer_budget(3) == {"fwd": 4, "total": 4}


def test_serve_main_on_cpu(np_params, tmp_path, capsys):
    """The serving driver end to end, on the CPU: restore, launch budget,
    publish, and the three modes."""
    params = tdeep.params_from_numpy(np_params, TLP, device="cpu")
    tckpt.save_population(str(tmp_path), 1, params, TLP)
    out = tserve.main(["--ckpt-dir", str(tmp_path), "--requests", "20",
                       "--batch", "8", "--calib-samples", "32",
                       "--device", "cpu"])
    assert out["budget"] == {"launches": 4, "budget": 4}
    assert set(out["serve"]) == {"best1", "topk", "all"}
    for row in out["serve"].values():
        assert row["requests"] == 20 and row["p99_ms"] >= row["p50_ms"] > 0
    assert "published: best1=" in capsys.readouterr().out
    out8 = tserve.main(["--ckpt-dir", str(tmp_path), "--requests", "20",
                        "--batch", "8", "--calib-samples", "32",
                        "--device", "cpu", "--weights-dtype", "int8"])
    assert out8["budget"] == {"launches": 4, "budget": 4}
    assert out8["serve_copy_bytes"] < out["serve_copy_bytes"] / 2
    assert set(out8["serve"]) == {"best1", "topk", "all"}
