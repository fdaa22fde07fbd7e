"""The population axis across ranks (``repro_torch.distributed.sharding``,
``repro_torch.launch.mesh``, ``deep.pad_params``), in one process on the
CPU.

- ``make_host_mesh``'s factorisation against the JAX package's rule for
  worlds 1–32, every world built (the process-group calls stubbed), each
  rank at JAX's coordinates with its model row's and data column's
  groups.
- ``member_partition``: every member once, contiguous, the same on every
  call, balanced by the stated rule; ``member_range`` carries the range's
  fillers as its ``n_pad``.
- ``shard_tree`` / ``unshard_trees`` round trips bit for bit over
  parameters and every optimizer's state (adafactor's factored leaves
  included), with a mid-layer bucket split by a cut and a rank that holds
  fewer layers; each share is the tree of its range's layout.
- ``pad_params``: the real region bit for bit, the shapes of JAX's
  ``pad_params``.
- The reductions: a global-norm clip and adafactor steps on W shares, run
  in W threads whose ``PopulationReduce.sum`` meets at a barrier, against
  the update of the whole padded tree, within rtol 1e-5 / atol 1e-6 (the
  optimizer-trajectory tolerance, tests/test_population_optim.py);
  adafactor's momentum in f32 there (in bf16 a reordered sum may round it
  one bf16 ulp the other way).
- The int8 serve copy packed per share is byte-equal to the matching
  slices of the whole copy.
"""
import threading
import types

import jax
import numpy as np
import pytest
import torch

from repro.core import deep as jdeep
from repro.core import population as jpop
from repro.launch import mesh as jmesh
from repro_torch.core import deep as tdeep
from repro_torch.core.lifecycle import compact_params
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.train import population_from_flags
from repro_torch.optim import optimizers as topt
from repro_torch.quant import quantize_population

TRAJ = dict(rtol=1e-5, atol=1e-6)
SPEC = "16,8;16,8;12,4;12,4;7;9"
DEEP = "24,16,8;12;9,5;16,8;7,7;5;11,6,3"


def layout(spec=SPEC, repeats=1):
    return population_from_flags(spec, "relu,tanh", 20, 2, repeats, 8)


def rand_tree(like, seed):
    g = torch.Generator().manual_seed(seed)
    return tree_map(lambda t: (torch.randn(t.shape, generator=g) if
                               t.dtype.is_floating_point else
                               torch.full(t.shape, 3)).to(t.dtype), like)


# --------------------------------------------------------------------- #
# the mesh                                                              #
# --------------------------------------------------------------------- #

class FakeDist:
    """The process-group calls ``make_host_mesh`` makes, recorded: the
    world's group is "WORLD", a new group the tuple of its ranks."""

    def __init__(self, monkeypatch):
        import torch.distributed as dist
        self.made = []
        self.inited = False
        monkeypatch.setattr(dist, "is_initialized", lambda: self.inited)
        monkeypatch.setattr(dist, "init_process_group", self.init)
        monkeypatch.setattr(dist, "new_group", self.new_group)
        monkeypatch.setattr(dist, "group", types.SimpleNamespace(
            WORLD="WORLD"))

    def init(self, *a, **k):
        self.inited = True

    def new_group(self, ranks, **k):
        self.made.append(tuple(ranks))
        return tuple(ranks)


@pytest.mark.parametrize("world", range(1, 33))
def test_host_mesh_factors_as_jax(world, monkeypatch):
    """JAX's ``make_host_mesh`` on ``world`` devices (its device list and
    mesh maker stubbed) against the port's: the same (data, model), and
    the port builds every world (its process-group calls stubbed): each
    rank at JAX's coordinates (``data = r // model``), every rank making
    every row's and then every column's group in one order, and holding
    its own row's and column's (the world's where an axis is the whole
    world, none where an axis is 1)."""
    monkeypatch.setattr(jmesh.jax, "devices", lambda: list(range(world)))
    monkeypatch.setattr(jmesh, "make_mesh", lambda shape, axes: shape)
    want = tuple(jmesh.make_host_mesh())
    assert tmesh._factor(world, None) == want
    monkeypatch.setenv("WORLD_SIZE", str(world))
    monkeypatch.setenv("RANK", "0")
    if world == 1:
        m = tmesh.make_host_mesh()
        assert m.shape == {"data": 1, "model": 1} and m.group is None
        assert m.row_group is None and m.col_group is None
        assert tmesh.mesh_num_devices(m) == 1 and m.is_writer
        assert sh.pop_axis_size(m) == 1 and sh.pop_axis_size() == 1
        return
    data, model = want
    rows = [tuple(range(d * model, (d + 1) * model)) for d in range(data)]
    cols = [tuple(range(j, world, model)) for j in range(model)]
    for rank in range(world):
        fake = FakeDist(monkeypatch)
        monkeypatch.setattr(tmesh, "_SUBGROUPS",
                            {"world": None, "groups": {}})
        monkeypatch.setenv("RANK", str(rank))
        m = tmesh.make_host_mesh()
        assert m.shape == {"data": data, "model": model} and m.owns_group
        assert m.coords == {"data": rank // model, "model": rank % model}
        assert m.group == "WORLD" and m.is_writer == (rank == 0)
        assert sh.pop_axis_size(m) == model and sh.data_axis_size(m) == data
        if data > 1 and model > 1:
            assert fake.made == rows + cols
            assert m.row_group == rows[rank // model]
            assert m.col_group == cols[rank % model]
        else:
            assert fake.made == []
            assert m.row_group == ("WORLD" if data == 1 else None)
            assert m.col_group == ("WORLD" if model == 1 else None)


def test_host_mesh_remakes_its_groups_in_a_new_world(monkeypatch):
    """A later mesh of one world reuses the rows' and columns' groups; a
    mesh of another world group makes its own, even where the first
    world was left by its caller and not by ``close``."""
    import torch.distributed as dist
    monkeypatch.setattr(tmesh, "_SUBGROUPS", {"world": None, "groups": {}})
    monkeypatch.setenv("WORLD_SIZE", "6")
    monkeypatch.setenv("RANK", "3")
    fake = FakeDist(monkeypatch)
    fake.inited = True
    monkeypatch.setattr(dist, "get_world_size", lambda: 6)
    monkeypatch.setattr(dist, "get_rank", lambda: 3)
    a = tmesh.make_host_mesh()
    b = tmesh.make_host_mesh()
    assert len(fake.made) == 5 and not a.owns_group
    assert (a.row_group, a.col_group) == (b.row_group, b.col_group)
    monkeypatch.setattr(dist, "group", types.SimpleNamespace(
        WORLD=object()))
    c = tmesh.make_host_mesh()
    assert len(fake.made) == 10 and c.row_group == (2, 3)
    assert c.col_group == (1, 3, 5)


# --------------------------------------------------------------------- #
# the partition and the member range                                    #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("spec,repeats", [(SPEC, 1), (DEEP, 3), ("5", 40)])
def test_member_partition_covers_balances_and_repeats(spec, repeats):
    for n in (1, 2, 3, 4, 8):
        lp = layout(spec, repeats).shard_pad(n)
        ranges = sh.member_partition(lp, n)
        assert ranges == sh.member_partition(lp, n)
        assert ranges[0][0] == 0 and ranges[-1][1] == lp.num_members
        assert all(a < b for a, b in ranges)
        assert all(ranges[r][1] == ranges[r + 1][0] for r in range(n - 1))
        cost = sh.member_cost(lp)
        csum = np.concatenate([[0], np.cumsum(cost)])
        for j, (a, _) in enumerate(ranges[1:], 1):
            # no other boundary left of the next cut is nearer j·T/n
            lo = ranges[j - 1][0] + 1
            hi = lp.num_members - (n - j)
            best = min(range(lo, hi + 1),
                       key=lambda k: (abs(n * csum[k] - j * csum[-1]), k))
            assert a == best
    with pytest.raises(ValueError):
        sh.member_partition(layout(), 7)


def test_member_range_carries_its_fillers():
    lp = layout().shard_pad(4)
    assert (lp.num_members, lp.n_pad) == (8, 2)
    sub = lp.member_range(5, 8)
    assert (sub.num_members, sub.n_pad, sub.num_real) == (3, 2, 1)
    assert sub.widths == lp.widths[5:] and sub.activations == \
        lp.activations[5:]
    only = lp.member_range(6, 8)
    assert only.num_real == 0 and only.n_pad == 2
    assert lp.member_range(0, 2).n_pad == 0
    # members keep their padded slices: every array of the range's layout
    # is a slice of the whole layout's
    a, b = 2, 7
    part = lp.member_range(a, b)
    for l in range(part.depth):
        whole, mine = lp.layer_pop(l), part.layer_pop(l)
        assert np.array_equal(
            mine.hidden_mask,
            whole.hidden_mask[whole.offsets[a]:whole.offsets[b]])
    with pytest.raises(ValueError):
        lp.member_range(3, 3)
    with pytest.raises(ValueError, match="shard-pad fillers"):
        lp.subset((0, 6))
    assert sh.shard_layout(lp, 0, 1) is lp


# --------------------------------------------------------------------- #
# tree shares                                                           #
# --------------------------------------------------------------------- #

OPTS = {"sgd": lambda: topt.sgd(),
        "momentum": lambda: topt.sgd(momentum=0.9),
        "adamw": lambda: topt.adamw(weight_decay=0.01),
        "adamw bf16": lambda: topt.adamw(state_dtype=torch.bfloat16),
        "adafactor": lambda: topt.adafactor(weight_decay=0.01)}


@pytest.mark.parametrize("name", sorted(OPTS))
@pytest.mark.parametrize("n", [2, 4])
def test_shard_unshard_round_trips(name, n):
    lp = layout(DEEP).shard_pad(n)
    ranges = sh.member_partition(lp, n)
    params = rand_tree(tdeep.abstract_params(lp), 1)
    state = rand_tree(OPTS[name]().init(tdeep.abstract_params(lp)), 2)
    tree = {"params": params, "extra": state}
    # a cut splits a bucket, and a rank holds fewer layers than the layout
    plans = [sh._plan(lp, a, b) for a, b in ranges]
    sizes = [[m_n for (_, m_n) in sh._buckets(lp, l)]
             for l in range(lp.depth - 1)]
    assert any(cnt < sizes[l][K] for pl in plans
               for l, lay in enumerate(pl["mid"])
               for (K, _, cnt) in lay["w"])
    assert any(pl["depth"] < lp.depth for pl in plans)
    parts = []
    for a, b in ranges:
        part = sh.shard_tree(tree, lp, a, b)
        want = tdeep.abstract_params(lp.member_range(a, b))
        assert [tuple(x.shape) for x in tree_leaves(part["params"])] == \
            [tuple(x.shape) for x in tree_leaves(want)]
        assert [tuple(x.shape) for x in tree_leaves(part["extra"])] == \
            [tuple(x.shape) for x in tree_leaves(
                sh.shard_tree(OPTS[name]().init(
                    tdeep.abstract_params(lp)), lp, a, b))]
        parts.append(part)
    back = sh.unshard_trees(parts, lp, ranges)
    # the mid layers a rank does not hold come back as zero biases: zero
    # them in the reference too (they are gated pass-through slices)
    for a, b in ranges:
        pl = sh._plan(lp, a, b)
        for l, lay in enumerate(pl["mid"]):
            if not lay["kept"]:
                _, lo, hi = lay["b"]
                for t in (tree["params"], *[v for k, v in state.items()
                                            if k in ("mu", "m", "v")]):
                    t["mid"][l]["b"][lo:hi] = 0
                if "leaves" in state:
                    for k, v in state["leaves"]["mid"][l]["b"].items():
                        v[lo:hi] = 0
    for x, y in zip(tree_leaves(back), tree_leaves(tree)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16
                           else x, y.view(torch.int16)
                           if y.dtype == torch.bfloat16 else y)


def test_a_share_is_the_compaction_of_its_range():
    """A share of the parameters equals the lifecycle's compaction of the
    range (fillers kept) onto the range's layout."""
    lp = layout(DEEP).shard_pad(4)
    params = rand_tree(tdeep.abstract_params(lp), 3)
    for a, b in sh.member_partition(lp, 4):
        sub = lp.member_range(a, b)
        got = sh.shard_tree(params, lp, a, b)
        want = compact_params(lp, sub, params, range(a, b))
        for x, y in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(x, y)


def test_pad_params_keeps_the_real_region_bitwise():
    lp = layout()
    lp_pad = lp.shard_pad(4)
    params = tdeep.init_params(torch.Generator().manual_seed(0), lp)
    padded = tdeep.pad_params(params, lp, lp_pad,
                              torch.Generator().manual_seed(1))
    assert tdeep.pad_params(params, lp, lp, None) is params
    real = compact_params(lp_pad, lp, padded, range(lp.num_members))
    for x, y in zip(tree_leaves(real), tree_leaves(params)):
        assert torch.equal(x, y)
    jl = jpop.LayeredPopulation(20, 2, lp.widths, lp.activations, block=8)
    jp = jdeep.pad_params(jdeep.init_params(jax.random.PRNGKey(0), jl), jl,
                          jl.shard_pad(4), jax.random.PRNGKey(1))
    assert [tuple(x.shape) for x in tree_leaves(padded)] == \
        [tuple(x.shape) for x in jax.tree.leaves(jp)]
    assert sh.population_batch_shardings(None, 8) == (slice(None),
                                                       slice(None))


# --------------------------------------------------------------------- #
# the reductions                                                        #
# --------------------------------------------------------------------- #

class ThreadReduce(sh.PopulationReduce):
    """``PopulationReduce`` whose sum meets the other shares' threads at a
    barrier (the in-process stand-in of the all-reduce)."""

    def __init__(self, lp, a, b, rank, board, barrier):
        super().__init__(lp, a, b)
        self.rank, self.board, self.barrier = rank, board, barrier

    def sum(self, t):
        self.board[self.rank] = t
        self.barrier.wait()
        out = sum(self.board[r] for r in range(len(self.board)))
        self.barrier.wait()
        return out


def _sharded_steps(lp, n, params, grads, opt, clip, steps):
    ranges = sh.member_partition(lp, n)
    board, barrier = [None] * n, threading.Barrier(n)
    state = opt.init(params)
    results, errors = [None] * n, []

    def run(r):
        try:
            a, b = ranges[r]
            red = ThreadReduce(lp, a, b, r, board, barrier)
            p = sh.shard_tree(params, lp, a, b)
            st = sh.shard_tree(state, lp, a, b)
            for k in range(steps):
                g = sh.shard_tree(grads[k], lp, a, b)
                norm = None
                if clip:
                    g, norm = topt.clip_by_global_norm(g, clip, reduce=red)
                upd, st = opt.update(g, st, p, 0.05, reduce=red)
                p = topt.apply_updates(p, upd)
            results[r] = ({"params": p, "extra": st}, norm)
        except Exception as e:   # noqa: BLE001 — re-raised below
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    return (sh.unshard_trees([r[0] for r in results], lp, ranges),
            [r[1] for r in results])


@pytest.mark.parametrize("name", ["adafactor", "adafactor momentum 0",
                                  "adamw clip", "sgd clip"])
@pytest.mark.parametrize("n", [2, 4])
def test_reductions_match_the_whole_update(name, n):
    lp = layout(DEEP, 2).shard_pad(n)
    # adafactor's momentum in f32 here: stored in bf16 (the default), a sum
    # taken in another order may round m one bf16 ulp the other way, which
    # reaches the parameters as lr·β·ulp, beyond the f32 tolerance
    opt = {"adafactor": lambda: topt.adafactor(
        weight_decay=0.01, momentum_dtype=torch.float32),
           "adafactor momentum 0": lambda: topt.adafactor(momentum=0.0),
           "adamw clip": lambda: topt.adamw(weight_decay=0.01),
           "sgd clip": lambda: topt.sgd(momentum=0.9)}[name]()
    clip = 1.0 if "clip" in name else None
    params = tdeep.init_params(torch.Generator().manual_seed(0), lp)
    # gradients that vanish on the pass-through biases, as real ones do
    grads = []
    for k in range(3):
        g = rand_tree(tdeep.abstract_params(lp), 10 + k)
        for l in range(lp.depth - 1):
            g["mid"][l]["b"] *= torch.as_tensor(lp.active_unit_mask(l + 1))
        grads.append(g)
    state = opt.init(params)
    p, norm = params, None
    for g in grads:
        if clip:
            g, norm = topt.clip_by_global_norm(g, clip)
        upd, state = opt.update(g, state, p, 0.05)
        p = topt.apply_updates(p, upd)
    got, norms = _sharded_steps(lp, n, params, grads, opt, clip, 3)
    for x, y in zip(tree_leaves(got["params"]), tree_leaves(p)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), **TRAJ)
    for x, y in zip(tree_leaves(got["extra"]), tree_leaves(state)):
        np.testing.assert_allclose(x.float().numpy(), y.float().numpy(),
                                   **TRAJ)
    if clip:
        for nm in norms:
            np.testing.assert_allclose(nm.numpy(), norm.numpy(), **TRAJ)


def test_int8_copy_per_share_is_the_whole_copys_slices():
    lp = layout(DEEP).shard_pad(4)
    params = tdeep.init_params(torch.Generator().manual_seed(0), lp)
    whole = quantize_population(params, lp)
    blk = lp.block
    for a, b in sh.member_partition(lp, 4):
        sub = lp.member_range(a, b)
        mine = quantize_population(sh.shard_tree(params, lp, a, b), sub)
        r0, r1 = (int(lp.layer_pop(0).offsets[i]) for i in (a, b))
        c0, c1 = (int(lp.layer_pop(lp.depth - 1).offsets[i]) for i in (a, b))
        assert torch.equal(mine["w_in"], whole["w_in"][r0:r1])
        assert torch.equal(mine["w_in_scale"],
                           whole["w_in_scale"][r0 // blk:r1 // blk])
        assert torch.equal(mine["w_out"], whole["w_out"][:, c0:c1])
        assert torch.equal(mine["w_out_scale"],
                           whole["w_out_scale"][c0 // blk:c1 // blk])
        for l in range(sub.depth - 1):
            t = lp.bd_layout(l)
            # the range's tiles: those whose output tile lies in its rows
            o0, o1 = (int(lp.layer_pop(l + 1).offsets[i]) // blk
                      for i in (a, b))
            keep = [q for q in range(t.n_param_blocks)
                    if o0 <= t.wb_out_tile[q] < o1]
            assert torch.equal(mine["mid"][l]["wb"][:-1],
                               whole["mid"][l]["wb"][keep])
            assert torch.equal(mine["mid"][l]["scale"][:-1],
                               whole["mid"][l]["scale"][keep])
