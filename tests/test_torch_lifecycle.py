"""The port's successive-halving lifecycle (``core/lifecycle.py``, the
trainer's ``--halving``) held against the JAX package's on the CPU.

Schedules, survivors, ``subset`` layouts and compaction (parameters and
sgd / momentum / AdamW moments; adafactor's carry through
``compact_factored``) on the same numpy inputs: layouts equal field by
field, gathers bitwise equal, the port's host and device gathers bitwise
equal.  A survivor's trajectory after compaction holds to its
never-pruned trajectory at the optimizer tolerance (rtol 1e-5 / atol 1e-6,
tests/test_population_optim.py).  Driver: a JAX ``--halving`` run stopped
mid-ladder and resumed by the port lands on JAX's straight run; the port's
own mid-ladder resume is bitwise its straight run; JAX resumes the port's
mid-ladder checkpoint.
"""
import dataclasses
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.core import deep as jdeep
from repro.core import lifecycle as jlife
from repro.core import population as jpop
from repro.launch import train as jtrain
from repro.optim import optimizers as jopt
from repro_torch import device as tdevice
from repro_torch.core import deep as tdeep
from repro_torch.core import lifecycle as tlife
from repro_torch.core import population as tpop
from repro_torch.core.tree import tree_leaves
from repro_torch.optim import optimizers as topt

TRAJ = dict(rtol=1e-5, atol=1e-6)
WIDTHS = ((7,), (13, 5), (64, 32, 16), (13, 5), (9,), (16, 8), (7,),
          (24, 12, 8))
ACTS = ("relu", ("tanh", "gelu"), ("mish", "sigmoid", "tanh"),
        ("tanh", "gelu"), "relu", ("relu", "tanh"), "tanh", "gelu")
JLP = jpop.LayeredPopulation(6, 3, WIDTHS, ACTS, block=8).sorted()
TLP = tpop.LayeredPopulation(6, 3, WIDTHS, ACTS, block=8).sorted()
_BD_FIELDS = [f.name for f in dataclasses.fields(jpop.BlockDiagLayout)]


def check_layout(jl, tl):
    """Widths, activations, per-layer offsets, buckets and every
    ``bd_layout`` array equal between the packages."""
    assert (tl.widths, tl.activations, tl.depth, tl.n_pad) == \
        (jl.widths, jl.activations, jl.depth, jl.n_pad)
    for l in range(jl.depth):
        np.testing.assert_array_equal(tl.layer_pop(l).offsets,
                                      jl.layer_pop(l).offsets)
    for l in range(jl.depth - 1):
        assert tl.proj_buckets(l) == jl.proj_buckets(l)
        for f in _BD_FIELDS:
            assert getattr(tl.bd_layout(l), f) == \
                getattr(jl.bd_layout(l), f), f


def same_bits(got, want):
    """A port tree (tensors) equal to a JAX tree bit for bit, leaf by
    leaf in JAX's order."""
    gl, wl = tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for i, (a, b) in enumerate(zip(gl, wl)):
        b = np.asarray(b)
        if b.dtype == jnp.bfloat16:    # numpy has no bf16: its bits
            assert a.dtype == torch.bfloat16, i
            a, b = a.view(torch.int16), b.view(np.int16)
        assert a.dtype == torch.from_numpy(b).dtype, i
        assert a.numpy().tobytes() == b.tobytes(), f"leaf {i}"


def to_torch(a) -> torch.Tensor:
    """A numpy array as a tensor, bf16 through its bits."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.tensor(a)


def both_params(seed=0):
    """The same parameters in both packages, from numpy."""
    pj = _jax_init(seed)
    return pj, tdeep.params_from_numpy(pj, TLP, device="cpu")


@functools.cache
def _jax_init(seed):
    """A parameter tree of numpy arrays, drawn from a seeded generator in
    the layout's shapes (JAX's functions take numpy trees)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: rng.uniform(-0.5, 0.5, tuple(a.shape)).astype(np.float32),
        jax.eval_shape(lambda: jdeep.abstract_params(JLP)))


@functools.cache
def trained_states(opt: str):
    """Parameters and an optimizer state with live (non-zero) moments,
    the same numbers in both packages → (JAX params, JAX state, port
    params, port state): the state tree of JAX's ``opt.init``, its
    moments drawn from a seeded numpy generator, its count 2.  Shared by
    the tests, which do not modify it."""
    pj, pt = both_params()
    rng = np.random.default_rng(1)
    sj = jax.tree.map(
        lambda a: (rng.normal(0, 0.1, a.shape).astype(a.dtype) if a.ndim
                   else np.asarray(2, a.dtype)),
        jax.device_get(ALL_OPTS[opt](jopt).init(pj)))
    st = jax.tree.map(to_torch, sj)
    assert jax.tree.structure(ALL_OPTS[opt](topt).init(pt)) \
        == jax.tree.structure(st)
    return pj, sj, pt, st


OPTS = {"sgd": lambda o: o.sgd(),
        "momentum": lambda o: o.sgd(momentum=0.9),
        "adamw": lambda o: o.adamw(weight_decay=0.01)}
# adafactor's state is not params-shaped: compact_factored, not compact
FACTORED = {"adafactor": lambda o: o.adafactor(),
            "adafactor momentum 0": lambda o: o.adafactor(momentum=0.0)}
ALL_OPTS = {**OPTS, **FACTORED}


# --------------------------------------------------------------------- #
# schedule and survivors                                                #
# --------------------------------------------------------------------- #

def test_schedule_and_survivors_match_jax():
    spec = "500:0.5, 1000:0.5,2000:0.25"
    js, ts = jlife.HalvingSchedule.parse(spec), \
        tlife.HalvingSchedule.parse(spec)
    assert ts.rungs == js.rungs
    for total in (300, 1500, 3000):
        assert ts.segments(total) == js.segments(total)
    for n, f in ((8, 0.5), (5, 0.5), (3, 0.25), (1, 0.01), (10000, 0.5)):
        assert ts.n_keep(n, f) == js.n_keep(n, f)
    rng = np.random.default_rng(0)
    for losses in (np.array([3.0, 1.0, 2.0, 5.0, 1.0, 9.0]),
                   rng.normal(size=40).astype(np.float32),
                   np.ones(7)):
        for f in (1 / 6, 0.25, 0.5, 1.0):
            np.testing.assert_array_equal(tlife.survivors(losses, f),
                                          jlife.survivors(losses, f))


@pytest.mark.parametrize("bad", ["", "500", "500:0.5:1", "a:0.5",
                                 "500:0.5,400:0.5", "500:0", "500:1.5",
                                 "0:0.5"])
def test_bad_schedules_raise_in_both(bad):
    with pytest.raises(ValueError):
        jlife.HalvingSchedule.parse(bad)
    with pytest.raises(ValueError):
        tlife.HalvingSchedule.parse(bad)


# --------------------------------------------------------------------- #
# subset and compaction                                                 #
# --------------------------------------------------------------------- #

KEEPS = [(2, 4), (0, 1, 3, 6), (1, 2, 5, 7), (7,), (0, 3, 4, 5)]


@pytest.mark.parametrize("keep", KEEPS, ids=str)
def test_subset_layout_equal_to_jax(keep):
    """``subset`` → the same layout as JAX's, field by field, its device
    caches empty (a new instance)."""
    tdeep.build_tables(TLP, "cpu", bd_impl="fused")
    sub = TLP.subset(keep)
    assert "_device_cache" not in sub.__dict__
    check_layout(JLP.subset(keep), sub)
    for bad in ((), (3, 3), (5, 2), (0, TLP.num_real)):
        with pytest.raises(ValueError):
            TLP.subset(bad)


def test_compact_regroups_bucket_around_pruned_member():
    """A prune out of the middle of a bucket: the survivors either side
    merge into one bucket, their weights gathered in order, bitwise
    JAX's."""
    pj, pt = both_params()
    old = [bk for bk in TLP.proj_buckets(0) if bk[6]]
    m0, n = next((bk[0], bk[1]) for bk in old if bk[1] >= 3)
    keep = [m for m in range(TLP.num_real) if m != m0 + 1]
    nj, qj, _ = jlife.compact(JLP, pj, None, keep, gather="host")
    nt, qt, _ = tlife.compact(TLP, pt, None, keep)
    check_layout(nj, nt)
    merged = [bk for bk in nt.proj_buckets(0) if bk[6] and bk[0] == m0]
    assert merged and merged[0][1] == n - 1
    same_bits(qt, qj)


@pytest.mark.parametrize("opt", sorted(OPTS))
@pytest.mark.parametrize("keep", KEEPS, ids=str)
def test_compact_params_and_moments_bitwise_jax(opt, keep):
    """Parameters and optimizer moments gathered bitwise as JAX gathers
    them; the port's host and device gathers bitwise equal."""
    pj, sj, pt, st = trained_states(opt)
    nj, qj, oj = jlife.compact(JLP, pj, sj, keep, gather="host")
    nt, qt, ot = tlife.compact(TLP, pt, st, keep, gather="device")
    _, qh, oh = tlife.compact(TLP, pt, st, keep, gather="host")
    check_layout(nj, nt)
    same_bits(qt, qj)
    same_bits(ot, jax.device_get(oj))
    for a, b in zip(tree_leaves((qt, ot)), tree_leaves((qh, oh))):
        assert torch.equal(a, b)


def test_pad_state_and_map_params_subtrees():
    """``pad_state`` on one device is the identity; onto a shard-padded
    layout it appends zero moments (bitwise JAX's), scalars pass through;
    a leaf outside a params-shaped subtree raises."""
    pj, sj, pt, st = trained_states("adamw")
    assert tdeep.pad_state(st, TLP, TLP) is st
    jpad, tpad = JLP.shard_pad(3), TLP.shard_pad(3)
    same_bits(tdeep.pad_state(st, TLP, tpad),
              jax.device_get(jdeep.pad_state(sj, JLP, jpad)))
    with pytest.raises(ValueError, match="neither a scalar"):
        tdeep.map_params_subtrees({"x": torch.zeros(3)}, pt, lambda n: n)


def test_trajectory_after_compaction_equals_never_pruned():
    """Survivors trained on after compaction, with a per-member lr, hold
    to their never-pruned trajectory (momentum state through the
    compaction)."""
    rng = np.random.default_rng(2)
    _, p = both_params(3)
    lr = torch.as_tensor(np.exp(rng.uniform(np.log(0.01), np.log(0.2),
                                            TLP.num_real)).astype(np.float32))
    opt = topt.sgd(momentum=0.9)
    batches = [(torch.as_tensor(rng.normal(0, 1, (16, 6)), dtype=torch.float32),
                torch.as_tensor(rng.integers(0, 3, 16))) for _ in range(6)]
    full, fs = p, opt.init(p)
    for x, y in batches[:3]:
        full, fs, *_ = tdeep.opt_step(full, fs, x, y, lr, opt, TLP,
                                      bd_impl="fused")
    keep = [1, 2, 5, 7]
    lp_k, kept, ks = tlife.compact(TLP, full, fs, keep)
    for x, y in batches[3:]:
        full, fs, *_ = tdeep.opt_step(full, fs, x, y, lr, opt, TLP,
                                      bd_impl="fused")
        kept, ks, *_ = tdeep.opt_step(kept, ks, x, y, lr[keep], opt, lp_k,
                                      bd_impl="fused")
    want = tlife.compact_params(TLP, lp_k, full, keep)
    for a, b in zip(tree_leaves(kept), tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TRAJ)


@pytest.mark.parametrize("keep", KEEPS, ids=str)
def test_compact_factored_bitwise_jax(keep):
    """``compact_factored`` of an adafactor state with live moments: the
    parameters and the carried bf16 momentum bitwise JAX's (the port's
    host and device gathers bitwise equal), the count carried, the
    factored statistics dropped."""
    pj, sj, pt, st = trained_states("adafactor")
    nj, qj, cj = jlife.compact_factored(JLP, pj, sj, keep, gather="host")
    nt, qt, ct = tlife.compact_factored(TLP, pt, st, keep)
    _, qh, ch = tlife.compact_factored(TLP, pt, st, keep, gather="host")
    check_layout(nj, nt)
    same_bits(qt, qj)
    same_bits(ct["m"], jax.device_get(cj["m"]))
    assert tree_leaves(ct["m"])[0].dtype == torch.bfloat16
    assert sorted(ct) == ["count", "m"] and int(ct["count"]) == 2
    for a, b in zip(tree_leaves((qt, ct)), tree_leaves((qh, ch))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_compact_factored_without_momentum_and_validation():
    """Without momentum the carry's ``m`` is None; a params-shaped state
    belongs to ``compact`` and an adafactor state to ``compact_factored``,
    each refused by the other with ``ValueError``, as in JAX."""
    pj, sj, pt, st = trained_states("adafactor momentum 0")
    nj, _, cj = jlife.compact_factored(JLP, pj, sj, [1, 4])
    nt, qt, ct = tlife.compact_factored(TLP, pt, st, [1, 4])
    assert cj["m"] is None and ct["m"] is None and int(ct["count"]) == 2
    check_layout(nj, nt)
    with pytest.raises(ValueError, match="adafactor"):
        tlife.compact_factored(TLP, pt, {"mu": pt}, [0])
    with pytest.raises(ValueError, match="compactable"):
        tlife.compact(TLP, pt, st, [0, 1])


def test_device_plans_keep_no_layout_alive():
    """The device gather's index cache is bounded and keyed by the
    layouts' fields: a compacted-away layout instance is not held."""
    import gc
    import weakref
    lp = tpop.LayeredPopulation(6, 3, WIDTHS, ACTS, block=8).sorted()
    ref = weakref.ref(lp)
    pt = tdeep.params_from_numpy(both_params()[0], lp, device="cpu")
    tdeep.build_tables(lp, "cpu", bd_impl="fused")
    for keep in KEEPS:
        tlife.compact(lp, pt, None, keep)
    del lp, pt
    gc.collect()
    assert ref() is None
    assert len(tlife._DEVICE_PLANS) <= tlife._DEVICE_PLANS_MAX


# --------------------------------------------------------------------- #
# the driver                                                            #
# --------------------------------------------------------------------- #

BASE = ["--arch", "parallelmlp-10k", "--reduced", "--scan-steps", "2",
        "--batch", "8", "--samples", "256", "--population-acts",
        "relu,tanh", "--population-depths", "8,4;8,4;6;5;12,6;7;9;10",
        "--ckpt-every", "2", "--halving", "4:0.5,8:0.5"]
PORT = ["--device", "cpu", "--bd-impl", "fused"]


def _meta(d):
    return jckpt.load_meta(str(d))[0]


def _close_to(params, want):
    gl, wl = tree_leaves(params), jax.tree.leaves(jax.device_get(want))
    assert len(gl) == len(wl)
    for i, (a, b) in enumerate(zip(gl, wl)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   err_msg=f"leaf {i}", **TRAJ)


@pytest.fixture(scope="module")
def jax_ladder(tmp_path_factory):
    """JAX's ladder stopped at step 6 (rung 0 applied) and its straight
    12-step run; then JAX resuming the port's own 6-step checkpoint."""
    base = tmp_path_factory.mktemp("ladder")
    jax_flags = BASE + ["--pipeline", "off"]
    jtrain.main(jax_flags + ["--steps", "6", "--ckpt-dir",
                             str(base / "jax6")])
    straight, lp = jtrain.main(jax_flags + ["--steps", "12", "--ckpt-dir",
                                            str(base / "jax12")])
    tdir = base / "port6"
    tparams6, _, _ = _port_run(["--steps", "6", "--ckpt-dir", str(tdir)])
    shutil.copytree(tdir, base / "port6_jax")
    resumed, jlp = jtrain.main(jax_flags + ["--steps", "12", "--resume",
                                            "--ckpt-dir",
                                            str(base / "port6_jax")])
    return dict(base=base, straight=jax.device_get(straight), lp=lp,
                jax_resumed=jax.device_get(resumed), jax_resumed_lp=jlp)


def _port_run(flags):
    return ttrain_main(BASE + PORT + flags)


def ttrain_main(argv):
    from repro_torch.launch import train as ttrain
    return ttrain.main(argv)


def test_port_resumes_jax_mid_ladder(jax_ladder, tmp_path, capsys):
    """JAX's checkpoint between rungs, resumed by the port, lands on
    JAX's straight run: layout, member ids, lifecycle meta, parameters."""
    ck = tmp_path / "ck"
    shutil.copytree(jax_ladder["base"] / "jax6", ck)
    assert _meta(ck)["lifecycle"]["rung"] == 1
    params, lp, stats = _port_run(["--steps", "12", "--resume",
                                   "--ckpt-dir", str(ck)])
    out = capsys.readouterr().out
    assert "resumed from step 5 (rung 1, 4 survivors)" in out
    assert "rung 1 @ step 7: kept 2/4 members" in out
    check_layout(jax_ladder["lp"], lp)
    assert _meta(ck)["lifecycle"] == \
        _meta(jax_ladder["base"] / "jax12")["lifecycle"]
    _close_to(params, jax_ladder["straight"])
    assert [s["members"] for s in stats["segments"]] == [4, 2]


def test_port_mid_ladder_resume_bitwise_its_straight_run(jax_ladder,
                                                        tmp_path):
    """The port stopped at step 6 and resumed equals its straight
    12-step run bit for bit (layout, lifecycle meta, parameters); the
    ladder prunes 8 → 4 → 2 and compacts the fused width."""
    ck = tmp_path / "ck"
    shutil.copytree(jax_ladder["base"] / "port6", ck)
    res, lp_r, _ = _port_run(["--steps", "12", "--resume", "--ckpt-dir",
                              str(ck)])
    straight, lp_s, stats = _port_run(["--steps", "12", "--ckpt-dir",
                                       str(tmp_path / "straight")])
    assert lp_r == lp_s and lp_s.num_real == 2
    assert _meta(ck)["lifecycle"] == _meta(tmp_path / "straight")[
        "lifecycle"]
    for a, b in zip(tree_leaves(res), tree_leaves(straight)):
        assert torch.equal(a, b)
    seg = stats["segments"]
    assert [s["members"] for s in seg] == [8, 4, 2]
    assert seg[0]["fused_hidden"][0] > seg[1]["fused_hidden"][0] \
        > seg[2]["fused_hidden"][0]
    # the fused step: 2·(depth+1) launches a step in every segment, and a
    # compacted layout's tables are built at its rung, none in its steps
    for s in seg:
        n = s["end"] - s["start"]
        assert sum(s["launches"].values()) == n * 2 * (s["depth"] + 1)
    assert [s["tables_built"] for s in seg[1:]] == [0, 0]
    assert all(r["tables_built"] > 0 for r in stats["rungs"])


def test_jax_resumes_port_mid_ladder(jax_ladder):
    """JAX resumes the port's checkpoint between rungs: the same layout
    and member ids as the port's straight run, and its parameters."""
    meta = _meta(jax_ladder["base"] / "port6_jax")
    assert meta["lifecycle"]["rung"] == 2
    assert jax_ladder["jax_resumed_lp"].num_real == 2
    straight, lp, _ = _port_run(["--steps", "12", "--ckpt-dir",
                                 str(jax_ladder["base"] / "port12")])
    check_layout(jax_ladder["jax_resumed_lp"], lp)
    assert meta["lifecycle"] == _meta(jax_ladder["base"] / "port12")[
        "lifecycle"]
    _close_to(straight, jax_ladder["jax_resumed"])


def test_catch_up_prune_on_resume_past_a_boundary(tmp_path):
    """A run without a ladder resumed past a rung boundary prunes at once
    and force-saves the compacted state at the last completed step."""
    plain = [a for a in BASE if a not in ("--halving", "4:0.5,8:0.5")]
    ck = tmp_path / "ck"
    ttrain_main(plain + PORT + ["--steps", "6", "--ckpt-dir", str(ck)])
    _, lp, _ = ttrain_main(plain + PORT + ["--steps", "10", "--resume",
                                           "--halving", "2:0.5",
                                           "--ckpt-dir", str(ck)])
    assert lp.num_real == 4
    steps = jckpt.latest_steps(str(ck))
    assert 5 in steps and 1 not in steps
    from repro_torch.checkpoint.checkpoint import restore_population
    assert restore_population(str(ck), step=5, device="cpu")[1].num_real \
        == 4


def test_table_builds_counted():
    """``device.table_builds`` counts each table once per layout."""
    lp = tpop.LayeredPopulation(6, 3, WIDTHS, ACTS, block=8).sorted()
    n0 = tdevice.table_builds
    tdeep.build_tables(lp, "cpu", bd_impl="fused")
    built = tdevice.table_builds - n0
    assert built > 0
    tdeep.build_tables(lp, "cpu", bd_impl="fused")
    assert tdevice.table_builds - n0 == built
