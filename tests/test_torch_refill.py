"""The port's slot-refill search (``core/lifecycle.py`` growth and refill,
``repro_torch.search``, the trainer's ``--refill pbt|arch``,
``--search-space`` and ``--per-member-*``) held against the JAX package's
on the CPU.

Growth and refill on the same numpy inputs are bitwise JAX's (parameters,
and sgd / momentum / AdamW moments; adafactor's ``m`` and unfactored ``v``
zeroed in place, its factored statistics untouched), the port's host and
device gathers bitwise equal, grow-then-compact a bitwise round trip; the controller's
plans equal JAX's in every field over three rungs.  Driver: JAX's
``--refill pbt --per-member-lr`` run stopped between rungs and resumed by
the port (its newborns fed JAX's draw through ``fresh_member_params``)
lands on JAX's straight run (rtol 1e-5 / atol 1e-6); the port's own
resume is bitwise its straight run; ``--refill arch`` grows the layout
from the menu.
"""
import dataclasses
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import search as jsearch
from repro.checkpoint import checkpoint as jckpt
from repro.core import deep as jdeep
from repro.core import lifecycle as jlife
from repro.core import population as jpop
from repro.launch import train as jtrain
from repro.optim import optimizers as jopt
from repro_torch import search as tsearch
from repro_torch.core import deep as tdeep
from repro_torch.core import lifecycle as tlife
from repro_torch.core import population as tpop
from repro_torch.core.tree import tree_leaves
from repro_torch.launch import train as ttrain
from repro_torch.optim import optimizers as topt

TRAJ = dict(rtol=1e-5, atol=1e-6)
WIDTHS = ((7,), (13, 5), (64, 32, 16), (13, 5), (9,), (16, 8), (7,),
          (24, 12, 8))
ACTS = ("relu", ("tanh", "gelu"), ("mish", "sigmoid", "tanh"),
        ("tanh", "gelu"), "relu", ("relu", "tanh"), "relu", "gelu")
JLP = jpop.LayeredPopulation(6, 3, WIDTHS, ACTS, block=8).sorted()
TLP = tpop.LayeredPopulation(6, 3, WIDTHS, ACTS, block=8).sorted()
# new members: one shallow, one deeper than every existing member (the
# depth extends), one that joins an existing bucket
NEW = [(((13, 5), (8,)), (("tanh", "gelu"), "relu")),
       (((6, 6, 6, 6), (9,), (16, 8)), ("tanh", "relu", ("relu", "tanh")))]
OPTS = {"sgd": lambda o: o.sgd(),
        "momentum": lambda o: o.sgd(momentum=0.9),
        "adamw": lambda o: o.adamw(weight_decay=0.01)}
# states a refill scales in place but growth cannot splice
SCALED = {**OPTS, "adafactor": lambda o: o.adafactor(),
          "adamw bf16": lambda o: o.adamw(weight_decay=0.01,
                                          state_dtype="bfloat16")}
_BD_FIELDS = [f.name for f in dataclasses.fields(jpop.BlockDiagLayout)]


def check_layout(jl, tl):
    assert (tl.widths, tl.activations, tl.depth) == \
        (jl.widths, jl.activations, jl.depth)
    for l in range(jl.depth):
        np.testing.assert_array_equal(tl.layer_pop(l).offsets,
                                      jl.layer_pop(l).offsets)
    for l in range(jl.depth - 1):
        assert tl.proj_buckets(l) == jl.proj_buckets(l)
        for f in _BD_FIELDS:
            assert getattr(tl.bd_layout(l), f) == \
                getattr(jl.bd_layout(l), f), f


def same_bits(got, want):
    gl, wl = tree_leaves(got), jax.tree.leaves(jax.device_get(want))
    assert len(gl) == len(wl)
    for i, (a, b) in enumerate(zip(gl, wl)):
        b = np.asarray(b)
        if b.dtype == jnp.bfloat16:    # numpy has no bf16: its bits
            assert a.dtype == torch.bfloat16, i
            a, b = a.view(torch.int16), b.view(np.int16)
        assert a.dtype == torch.from_numpy(np.array(b)).dtype, i
        assert a.numpy().tobytes() == b.tobytes(), f"leaf {i}"


def to_torch(a) -> torch.Tensor:
    """A numpy array as a tensor, bf16 through its bits."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.tensor(a)


def numpy_tree(jl, seed):
    """A parameter tree of numpy arrays in ``jl``'s shapes, seeded."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: rng.uniform(-0.5, 0.5, tuple(a.shape)).astype(np.float32),
        jax.eval_shape(lambda: jdeep.abstract_params(jl)))


def port_tree(tree, tl):
    return tdeep.params_from_numpy(tree, tl, device="cpu")


@functools.cache
def states(opt: str):
    """(JAX params, JAX state, port params, port state) on ``TLP``, the
    moments drawn from a seeded generator, the count 2."""
    pj = numpy_tree(JLP, 0)
    rng = np.random.default_rng(1)
    sj = jax.tree.map(
        lambda a: (rng.normal(0, 0.1, a.shape).astype(a.dtype) if a.ndim
                   else np.asarray(2, a.dtype)),
        jax.device_get(SCALED[opt](jopt).init(pj)))
    return pj, sj, port_tree(pj, TLP), jax.tree.map(to_torch, sj)


# --------------------------------------------------------------------- #
# growth                                                                #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("new", NEW, ids=["shallow", "deeper"])
def test_grow_positions_and_layout_equal_to_jax(new):
    w, a = new
    pos = TLP.grow_positions(w, a)
    assert pos == JLP.grow_positions(w, a)
    grown = TLP.grow(w, a, pos)
    check_layout(JLP.grow(w, a, pos), grown)
    assert grown == grown.sorted()
    rest = tuple(m for m in range(grown.num_real) if m not in set(pos))
    assert grown.subset(rest) == TLP
    with pytest.raises(ValueError, match="shard-pad"):
        TLP.shard_pad(3).grow(w, a, pos)
    with pytest.raises(ValueError, match="duplicate"):
        TLP.grow(w, a, (2,) * len(w))


@pytest.mark.parametrize("new", NEW, ids=["shallow", "deeper"])
def test_grow_params_bitwise_jax_and_round_trip(new):
    w, a = new
    pos = JLP.grow_positions(w, a)
    jg, tg = JLP.grow(w, a, pos), TLP.grow(w, a, pos)
    fj = numpy_tree(jg.subset(tuple(sorted(pos))), 9)
    ft = port_tree(fj, tg.subset(tuple(sorted(pos))))
    pj, _, pt, _ = states("sgd")
    want = jlife.grow_params(JLP, jg, pj, pos, fj, gather="host")
    dev = tlife.grow_params(TLP, tg, pt, pos, ft, gather="device")
    host = tlife.grow_params(TLP, tg, pt, pos, ft, gather="host")
    same_bits(dev, want)
    same_bits(host, want)
    rest = tuple(m for m in range(tg.num_real) if m not in set(pos))
    for g in ("host", "device"):
        back = tlife.compact_params(tg, TLP, dev, rest, gather=g)
        for x, y in zip(tree_leaves(back), tree_leaves(pt)):
            assert torch.equal(x, y)
    wrong = rest[:len(pos)]
    with pytest.raises(ValueError, match="grow"):
        tlife.grow_params(TLP, tg, pt, wrong, ft)


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_grow_state_bitwise_jax(opt):
    """Grown state: the newborns' moments zero, the survivors' bitwise,
    as JAX grows them."""
    w, a = NEW[1]
    pos = JLP.grow_positions(w, a)
    jg, tg = JLP.grow(w, a, pos), TLP.grow(w, a, pos)
    _, sj, _, st = states(opt)
    want = jdeep.grow_state(sj, JLP, jg, pos, gather="host")
    for g in ("host", "device"):
        same_bits(tdeep.grow_state(st, TLP, tg, pos, gather=g), want)


def test_grow_state_rejects_factored_adafactor():
    """JAX's test: the factored ``v_row``/``v_col`` reduce over the fused
    axis and cannot be spliced member-major, so ``grow_state`` (and
    ``lifecycle.grow``) raise; the trainer grows adafactor's carried
    momentum with ``grow_params``."""
    w, a = NEW[0]
    pos = TLP.grow_positions(w, a)
    grown = TLP.grow(w, a, pos)
    _, _, pt, st = states("adafactor")
    with pytest.raises(ValueError, match="grow_state"):
        tdeep.grow_state(st, TLP, grown, pos)
    fresh = tdeep.init_params(torch.Generator().manual_seed(0),
                              grown.subset(tuple(sorted(pos))))
    with pytest.raises(ValueError, match="grow_state"):
        tlife.grow(TLP, pt, st, w, a, pos, fresh)


# --------------------------------------------------------------------- #
# constant-size refill                                                  #
# --------------------------------------------------------------------- #

def _assignments(lp):
    """Clone a survivor into the pruned slot that shares its arch, and
    fresh-init two other slots."""
    keep, clone = next((m, n) for m in range(lp.num_real)
                       for n in range(m + 1, lp.num_real)
                       if lp.widths[m] == lp.widths[n]
                       and lp.activations[m] == lp.activations[n])
    fresh = sorted({2, lp.num_real - 1} - {keep, clone})
    return ((clone, keep),) + tuple((s, -1) for s in fresh)


def test_refill_params_bitwise_jax():
    asg = _assignments(JLP)
    fslots = sorted(s for s, p in asg if p < 0)
    jf = jpop.LayeredPopulation(6, 3, tuple(JLP.widths[s] for s in fslots),
                                tuple(JLP.activations[s] for s in fslots),
                                block=8)
    fj = numpy_tree(jf, 4)
    ft = port_tree(fj, tpop.LayeredPopulation(6, 3, jf.widths,
                                               jf.activations, block=8))
    pj, _, pt, _ = states("sgd")
    want = jlife.refill_params(JLP, pj, asg, fj, gather="host")
    for g in ("host", "device"):
        same_bits(tlife.refill_params(TLP, pt, asg, ft, gather=g), want)
    clones = tuple((s, p) for s, p in asg if p >= 0)
    same_bits(tlife.refill_params(TLP, pt, clones),
              jlife.refill_params(JLP, pj, clones, gather="host"))
    with pytest.raises(ValueError, match="fresh"):
        tlife.refill_params(TLP, pt, asg)


@pytest.mark.parametrize("opt", sorted(SCALED))
def test_refill_state_and_moment_mask_bitwise_jax(opt):
    slots = [0, 3, TLP.num_real - 1]
    mj, mt = jlife.member_moment_mask(JLP, slots), \
        tlife.member_moment_mask(TLP, slots)
    for x, y in zip(tree_leaves(mt), jax.tree.leaves(mj)):
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes()
    _, sj, pt, st = states(opt)
    same_bits(tlife.refill_state(st, TLP, slots),
              jlife.refill_state(sj, JLP, slots))
    same_bits(topt.scale_member_moments(st, pt, mt),
              jopt.scale_member_moments(sj, jdeep.abstract_params(JLP), mj))
    assert tlife.refill_state(st, TLP, []) is st


def test_scale_member_moments_of_adafactor():
    """The factored branch: ``m`` and unfactored ``v`` zeroed at the
    refilled slots (bf16 kept), ``v_row``/``v_col`` passed through as the
    same tensors; a scale tree of another structure raises, as in JAX."""
    _, _, pt, st = states("adafactor")
    out = topt.scale_member_moments(
        st, pt, tlife.member_moment_mask(TLP, [1]))
    for new, old in zip(tree_leaves(out["leaves"], is_leaf=topt.is_state_leaf),
                        tree_leaves(st["leaves"], is_leaf=topt.is_state_leaf)):
        for key in ("v_row", "v_col"):
            if key in old:
                assert new[key] is old[key]
        assert new["m"].dtype == torch.bfloat16
    assert not out["leaves"]["b_out"]["m"][1].any()
    assert torch.equal(out["leaves"]["b_out"]["m"][0],
                       st["leaves"]["b_out"]["m"][0])
    with pytest.raises(ValueError, match="scale tree"):
        topt.scale_member_moments(st, pt, {"w_in": np.ones(1)})


# --------------------------------------------------------------------- #
# search space and controller                                           #
# --------------------------------------------------------------------- #

SPEC = ("widths=64,32|16,8|7;acts=relu,tanh;lr=0.5..2;momentum=0.6..0.95;"
        "wd=0.4..2.5;lr_perturb=0.9,1.1;momentum_jitter=0.02")


def test_search_space_parse_equal_to_jax():
    assert dataclasses.asdict(tsearch.SearchSpace.parse(SPEC)) == \
        dataclasses.asdict(jsearch.SearchSpace.parse(SPEC))
    assert tsearch.SearchSpace.parse(None) == tsearch.SearchSpace()
    for bad in ("lr=3..0.3", "nope=1", "lr=0.3", "widths"):
        with pytest.raises(ValueError):
            jsearch.SearchSpace.parse(bad)
        with pytest.raises(ValueError):
            tsearch.SearchSpace.parse(bad)


def test_search_space_init_vectors():
    """The port's seed vectors: float32, inside the space's ranges,
    deterministic per seed (JAX's draw the same distribution with other
    numbers)."""
    sp = tsearch.SearchSpace.parse(SPEC)
    for v, lo, hi in ((sp.init_lr(3, 500, 0.01), 0.005, 0.02),
                      (sp.init_momentum(3, 500), 0.6, 0.95),
                      (sp.init_wd(3, 500, 0.001), 0.0004, 0.0025)):
        assert v.dtype == np.float32 and v.shape == (500,)
        assert lo * (1 - 1e-6) <= v.min() and v.max() <= hi * (1 + 1e-6)
        assert v.std() > 0
    np.testing.assert_array_equal(sp.init_lr(3, 8, 0.01),
                                  sp.init_lr(3, 8, 0.01))
    assert not np.array_equal(sp.init_lr(3, 8, 0.01),
                              sp.init_lr(4, 8, 0.01))


@pytest.mark.parametrize("mode", ["pbt", "arch"])
def test_controller_plans_equal_jax_over_three_rungs(mode):
    """The same layout, losses, survivors and recipes → the same plan,
    field by field, rung after rung (the numpy rng is JAX's)."""
    jsp, tsp = jsearch.SearchSpace.parse(SPEC), \
        tsearch.SearchSpace.parse(SPEC)
    jc = jsearch.RefillController(jsp, mode=mode, seed=7)
    tc = tsearch.RefillController(tsp, mode=mode, seed=7)
    rng = np.random.default_rng(5)
    ids = np.arange(TLP.num_real)
    lr = rng.uniform(0.005, 0.02, 64).astype(np.float32)
    mom = rng.uniform(0.6, 0.95, 64).astype(np.float32)
    wd = rng.uniform(0.0004, 0.0025, 64).astype(np.float32)
    next_id = TLP.num_real
    for rung in (1, 2, 3):
        losses = rng.normal(size=TLP.num_real)
        keep = jlife.survivors(losses, 0.5)
        kw = dict(rung=rung, next_id=next_id, base_lr=0.01, lr=lr[ids],
                  momentum=mom[ids], wd=wd[ids], base_wd=0.001)
        pj = jc.plan(JLP, losses, keep, ids, **kw)
        pt = tc.plan(TLP, losses, keep, ids, **kw)
        assert [dataclasses.asdict(m) for m in pt.members] == \
            [dataclasses.asdict(m) for m in pj.members]
        assert pt.assignments == pj.assignments
        ids = ids.copy()
        for m in pt.members:
            ids[m.slot] = m.member_id
        next_id += len(pt.members)
    with pytest.raises(ValueError, match="widths"):
        tsearch.RefillController(tsearch.SearchSpace(), mode="arch")


# --------------------------------------------------------------------- #
# the driver                                                            #
# --------------------------------------------------------------------- #

BASE = ["--arch", "parallelmlp-10k", "--reduced", "--scan-steps", "2",
        "--batch", "8", "--samples", "256", "--population-acts",
        "relu,tanh", "--population-depths", "8,4;6;5;12,6",
        "--population-repeats", "2", "--ckpt-every", "2",
        "--halving", "4:0.5,8:0.5"]
PBT = BASE + ["--refill", "pbt", "--per-member-lr"]
PORT = ["--device", "cpu", "--bd-impl", "fused"]


def _meta(d):
    return jckpt.load_meta(str(d))[0]


def jax_newborns(seed, rung, fresh_lp, device):
    """``fresh_member_params`` drawing as the JAX driver draws."""
    jl = jpop.LayeredPopulation(fresh_lp.in_features, fresh_lp.out_features,
                                fresh_lp.widths, fresh_lp.activations,
                                block=fresh_lp.block)
    p = jdeep.init_params(jax.random.fold_in(jax.random.PRNGKey(seed),
                                             5000 + rung), jl)
    return tdeep.params_from_numpy(jax.device_get(p), fresh_lp,
                                   device=device)


@pytest.fixture(scope="module")
def jax_pbt(tmp_path_factory):
    base = tmp_path_factory.mktemp("pbt")
    flags = PBT + ["--pipeline", "off"]
    jtrain.main(flags + ["--steps", "6", "--ckpt-dir", str(base / "jax6")])
    straight, lp = jtrain.main(flags + ["--steps", "12", "--ckpt-dir",
                                        str(base / "jax12")])
    return base, jax.device_get(straight), lp


def test_port_resumes_jax_pbt_run(jax_pbt, tmp_path, monkeypatch, capsys):
    """JAX's ``--refill pbt --per-member-lr`` run between rungs, resumed
    by the port with JAX's newborns: JAX's straight run's layout, member
    ids, lineage, recipe vector and parameters; the rung kept the layout,
    its chunk and every table."""
    base, straight, jlp = jax_pbt
    ck = tmp_path / "ck"
    shutil.copytree(base / "jax6", ck)
    monkeypatch.setattr(ttrain, "fresh_member_params", jax_newborns)
    params, lp, stats = ttrain.main(PBT + PORT + ["--steps", "12",
                                                  "--resume", "--ckpt-dir",
                                                  str(ck)])
    out = capsys.readouterr().out
    assert "cache-hit (zero re-jit)" in out and "explored 16 models" in out
    assert "born r" in out
    check_layout(jlp, lp)
    assert _meta(ck)["lifecycle"] == _meta(base / "jax12")["lifecycle"]
    gl, wl = tree_leaves(params), jax.tree.leaves(straight)
    for i, (a, b) in enumerate(zip(gl, wl)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   err_msg=f"leaf {i}", **TRAJ)
    assert stats["rungs"][0]["tables_built"] == 0
    assert stats["segments"][-1]["tables_built"] == 0


def test_port_pbt_resume_bitwise_its_straight_run(tmp_path, capsys):
    """The port's own pbt ladder: constant size, one chunk for the whole
    ladder, no table built at a rung or after it; stopped at step 6 and
    resumed, bitwise its straight run (the controller's rng and the
    newborns' generator are keyed by (seed, rung))."""
    ttrain.main(PBT + PORT + ["--steps", "6", "--ckpt-dir",
                              str(tmp_path / "ck")])
    meta = _meta(tmp_path / "ck")["lifecycle"]
    assert meta["rung"] == 1 and meta["next_id"] == 12
    res, lp_r, _ = ttrain.main(PBT + PORT + ["--steps", "12", "--resume",
                                             "--ckpt-dir",
                                             str(tmp_path / "ck")])
    capsys.readouterr()
    straight, lp_s, stats = ttrain.main(PBT + PORT + [
        "--steps", "12", "--ckpt-dir", str(tmp_path / "ck2")])
    out = capsys.readouterr().out
    assert out.count("cache-hit (zero re-jit)") == 2
    assert "1 chunk builds" in out and stats["chunk_builds"] == 1
    assert lp_r == lp_s and lp_s.num_real == 8
    assert [r["tables_built"] for r in stats["rungs"]] == [0, 0]
    assert [s["tables_built"] for s in stats["segments"][1:]] == [0, 0]
    for a, b in zip(tree_leaves(res), tree_leaves(straight)):
        assert torch.equal(a, b)
    m_r, m_s = _meta(tmp_path / "ck")["lifecycle"], \
        _meta(tmp_path / "ck2")["lifecycle"]
    assert m_r == m_s and m_s["lineage"] and len(m_s["lr_vec"]) == 16


def test_refill_arch_grows_layout_from_menu(tmp_path, capsys):
    """``--refill arch`` with AdamW: each rung compacts, then grows the
    layout by members sampled from the menu, its tables built at the
    rung."""
    params, lp, stats = ttrain.main(BASE + PORT + [
        "--refill", "arch", "--optimizer", "adamw",
        "--search-space", "widths=8,4|6|10,5,3;acts=relu,tanh",
        "--steps", "12", "--ckpt-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert out.count("grew 4 sampled archs") == 2 and lp.num_real == 8
    born = {int(k) for k in _meta(tmp_path / "ck")["lifecycle"]["lineage"]}
    ids = _meta(tmp_path / "ck")["lifecycle"]["member_ids"]
    menu = {(8, 4), (6,), (10, 5, 3)}
    assert all(lp.widths[s] in menu for s, m in enumerate(ids) if m in born)
    assert [s["members"] for s in stats["segments"]] == [8, 8, 8]
    assert all(r["tables_built"] > 0 for r in stats["rungs"])
    assert [s["tables_built"] for s in stats["segments"][1:]] == [0, 0]
