"""The population axis across ranks: which members each rank holds, its
share of the parameter and optimizer-state trees, and the few collectives
the reference's arithmetic needs (the population part of the JAX
package's ``repro.distributed.sharding``).

In JAX, GSPMD splits every member-major array of a shard-padded layout BY
INDEX into equal pieces, and XLA inserts the reductions a split member
needs.  The port's kernels take whole members, so here rank r of the
population axis owns a contiguous range of WHOLE members of the
shard-padded layout (``member_partition``), runs the existing kernels on
that range's layout (``shard_layout``: ``LayeredPopulation.member_range``,
fillers included), and no member crosses ranks inside a step.  The layout
and the checkpoint stay the reference's, member for member: a fresh run
still pads with ``shard_pad(pop_axis_size)``, so fillers, ``n_pad`` and
every array's shape equal JAX's on the same device count.

A range of members is a slice of every member-major axis (the fused
hidden axis of each layer, the member axis of ``b_out``), and the range's
mid-layer buckets are the whole layout's buckets cut at the range's ends:
a bucket that a cut splits is one bucket on each side.  So ``shard_tree``
slices and ``unshard_trees`` concatenates, over parameters and every
optimizer's state alike (sgd ``mu``, adamw ``m``/``v``, adafactor's
per-parameter dicts, whose ``v_row``/``v_col`` keep the member axis they
reduce over, or are whole on every rank where they reduced it).  A rank
whose members are all shallower than the layout holds fewer mid layers
(``member_range`` drops layers that only pass its members through); the
whole tree's slices of those layers' biases are pass-through slices,
gated to zero by the active mask, and come back as zeros (their sign bit,
or adafactor's ~1e-30 statistic there, is not kept).

Two places of the reference's math mix members, and a run on W ranks sums
them over the ranks (``PopulationReduce``, the ``reduce`` hook of
``deep.opt_step``; None on one rank, where nothing changes): the global
norm of ``--grad-clip`` and adafactor's statistics over a member axis and
its update RMS.  They divide by the padded layout's counts, fillers
included, as JAX's sharded run does.

The batch axis (``data``): a train chunk's ``(scan, B, ...)`` slab is
split over the ranks of a data column by rows
(``population_batch_shardings``: rank ``d`` of ``data = D`` builds rows ``[d·B/D, (d+1)·B/D)``, the scan axis
whole), as JAX's ``POP_BATCH_X``/``POP_BATCH_Y`` split it, and falls back
to the whole slab on every rank where D does not divide B (JAX's
``filter_spec`` degradation to replication).  A split step's per-member
losses and gradients are each rank's means over its own rows; the data
column averages them (``DataReduce``: one flat buffer a step, summed over
the column and divided by D) into the full batch's, before the clip and
adafactor's statistics, which then sum over the model row only.  A
replicated batch needs no reduction: every rank of the column computes
the full batch's step itself.  The LM parts of the JAX module
(``filter_spec``, ``constrain``, the ``ACT_*`` specs) wait for the LM
trainer (ROADMAP.md, Queue 1 item 9).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.population import LayeredPopulation
from repro_torch.core.tree import tree_leaves, tree_map

POP_AXIS = "model"
PARAM_KEYS = frozenset({"w_in", "b_in", "mid", "w_out", "b_out"})


def pop_axis_size(mesh=None) -> int:
    """The population axis's size: ``mesh.shape["model"]``, 1 without a
    mesh.  The divisor ``LayeredPopulation.shard_pad`` pads to."""
    if mesh is None:
        return 1
    return int(dict(mesh.shape).get(POP_AXIS, 1))


def data_axis_size(mesh=None) -> int:
    """The batch axis's size: ``mesh.shape["data"]``, 1 without a mesh."""
    if mesh is None:
        return 1
    return int(dict(mesh.shape).get("data", 1))


def population_batch_shardings(mesh, batch_size: int) -> tuple:
    """The part of a ``(scan, B, ...)`` train chunk this rank draws, as
    the slices of its two leading axes (the second alone is a ``(B,
    ...)`` flush's): the scan axis whole; the batch axis its data
    coordinate's contiguous ``B / data`` rows where ``data`` divides B,
    else whole."""
    n = data_axis_size(mesh)
    if n == 1 or batch_size % n:
        return slice(None), slice(None)
    k = batch_size // n
    return slice(None), slice(mesh.data_rank * k, (mesh.data_rank + 1) * k)


class DataReduce:
    """The data axis's mean of a step over the ``n`` ranks of a data
    column (``group``), for a batch split by rows: ``mean(tensors)`` packs
    the tensors into one flat buffer, all-reduces its sum over the column
    and divides by ``n`` (the ranks' means of equal row counts averaged:
    the full batch's mean), and unpacks.  Every rank of the column gets
    the same bits.  ``seconds`` and ``calls`` count the host time spent in
    the all-reduce."""

    def __init__(self, group, n: int):
        self.group = group
        self.n = int(n)
        self.seconds = 0.0
        self.calls = 0

    def sum(self, flat: torch.Tensor) -> torch.Tensor:
        """``flat`` summed over the column's ranks, in place."""
        import time

        import torch.distributed as dist
        t0 = time.perf_counter()
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return flat

    def mean(self, tensors: list) -> list:
        flat = self.sum(torch.cat([t.reshape(-1) for t in tensors]))
        flat = flat / self.n
        out, at = [], 0
        for t in tensors:
            out.append(flat[at:at + t.numel()].view(t.shape))
            at += t.numel()
        return out


# --------------------------------------------------------------------- #
# the partition                                                         #
# --------------------------------------------------------------------- #

def member_cost(lp: LayeredPopulation) -> np.ndarray:
    """A member's weight in the partition: its padded width summed over
    every layer of the layout (a pass-through layer counts its carried
    width)."""
    return np.sum([lp.layer_pop(l).padded_sizes.astype(np.int64)
                   for l in range(lp.depth)], axis=0)


def member_partition(lp: LayeredPopulation, n: int) -> tuple:
    """The ranks' member ranges ``((start, stop), ...)`` of an ``n``-way
    population axis: contiguous, in order, covering every member once, at
    least one member each.  Rule: with ``C(k)`` the summed ``member_cost``
    of members ``[0, k)`` and ``T = C(P)``, cut j (j = 1 … n−1) is the
    member boundary k nearest to ``j·T/n`` (the lower k on a tie) among
    those that leave every rank a member.  A pure function of ``(lp,
    n)``: every rank computes the same."""
    P = lp.num_members
    if n < 1 or n > P:
        raise ValueError(f"member_partition: {n} ranks for {P} members")
    csum = np.concatenate([[0], np.cumsum(member_cost(lp))])
    total = int(csum[-1])
    cuts = [0]
    for j in range(1, n):
        lo, hi = cuts[-1] + 1, P - (n - j)
        k = np.arange(lo, hi + 1)
        cuts.append(int(k[np.argmin(np.abs(n * csum[k] - j * total))]))
    cuts.append(P)
    return tuple((cuts[r], cuts[r + 1]) for r in range(n))


def shard_layout(lp: LayeredPopulation, rank: int, n: int
                 ) -> LayeredPopulation:
    """Rank ``rank``'s layout of an ``n``-way population axis: its member
    range, fillers included (``lp`` itself when ``n == 1``)."""
    if n == 1:
        return lp
    return lp.member_range(*member_partition(lp, n)[rank])


# --------------------------------------------------------------------- #
# tree shares                                                           #
# --------------------------------------------------------------------- #

def _buckets(lp: LayeredPopulation, l: int) -> list:
    """``(m0, n)`` of projection l's real buckets, in ``mid[l]["w"]``
    order."""
    return [(m0, n) for (m0, n, *_r, real) in lp.proj_buckets(l) if real]


def _plan(lp: LayeredPopulation, start: int, stop: int) -> dict:
    """Where a member range's leaves sit in the whole layout's: per leaf
    ``(axis, lo, hi)`` of a slice, per mid layer the range's buckets as
    ``(K, i0, cnt)`` (rows ``[i0, i0+cnt)`` of whole bucket ``K``), and
    the depth the range keeps."""
    sub_depth = max(lp.member_depths[start:stop])

    def units(l):
        off = lp.layer_pop(l).offsets
        return int(off[start]), int(off[stop])

    mid = []
    for l in range(lp.depth - 1):
        parts = []
        for K, (m0, n) in enumerate(_buckets(lp, l)):
            a, b = max(start, m0), min(stop, m0 + n)
            if a < b:
                parts.append((K, a - m0, b - a))
        mid.append({"w": parts, "b": (0,) + units(l + 1),
                    "kept": l < sub_depth - 1})
    return {"w_in": (0,) + units(0), "b_in": (0,) + units(0), "mid": mid,
            "w_out": (1,) + units(lp.depth - 1),
            "b_out": (0, start, stop), "depth": sub_depth}


# the axis a derived adafactor statistic reduced (v_row the last, v_col
# the one before), None for a value of the parameter's own shape
_REDUCED = {"v_row": -1, "v_col": -2, "v": None, "m": None}


def _member_axis(axis: int, ndim: int, key) -> int | None:
    """The member axis of ``key``'s array for a parameter of ``ndim`` dims
    whose member axis is ``axis``; None when the statistic reduced it
    (it is whole on every rank)."""
    red = _REDUCED.get(key)
    if red is None:
        return axis
    red %= ndim
    if red == axis:
        return None
    return axis - 1 if red < axis else axis


def _slice(x: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    return x.narrow(axis, lo, hi - lo).clone(
        memory_format=torch.contiguous_format)


def _map_value(value, axis: int, ndim: int, fn):
    """``fn(array, member_axis)`` on a parameter position's value: a
    tensor of the parameter's shape, or adafactor's per-parameter dict,
    each statistic at its own member axis (None: whole)."""
    if isinstance(value, dict):
        return {k: fn(v, _member_axis(axis, ndim, k))
                for k, v in value.items()}
    return fn(value, axis)


def _ndim(value) -> int:
    """The parameter's rank, read off its value (adafactor: ``m`` or
    ``v``, which keep the parameter's shape; v_row's rank + 1)."""
    if isinstance(value, dict):
        if "m" in value:
            return value["m"].ndim
        if "v" in value:
            return value["v"].ndim
        return value["v_row"].ndim + 1
    return value.ndim


def _shard_params(node: dict, plan: dict) -> dict:
    def cut(value, spec):
        axis, lo, hi = spec
        return _map_value(value, axis, _ndim(value),
                          lambda x, ax: x.clone() if ax is None
                          else _slice(x, ax, lo, hi))

    def bucket(value, i0, cnt):
        return _map_value(value, 0, _ndim(value),
                          lambda x, ax: _slice(x, 0, i0, i0 + cnt))

    out = {k: cut(node[k], plan[k])
           for k in ("w_in", "b_in", "w_out", "b_out")}
    out["mid"] = [{"w": [bucket(node["mid"][l]["w"][K], i0, cnt)
                         for (K, i0, cnt) in pl["w"]],
                   "b": cut(node["mid"][l]["b"], pl["b"])}
                  for l, pl in enumerate(plan["mid"]) if pl["kept"]]
    return out


def _is_params(node) -> bool:
    return isinstance(node, dict) and set(node) == PARAM_KEYS


def _walk(node, fn):
    """``fn`` on every params-structured subtree (parameters, sgd ``mu``,
    adamw ``m``/``v``, adafactor ``leaves``); anything else (step counts)
    passes through."""
    if _is_params(node):
        return fn(node)
    if isinstance(node, dict):
        return {k: _walk(v, fn) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_walk(v, fn) for v in node)
    return node


def shard_tree(tree, lp: LayeredPopulation, start: int, stop: int):
    """A rank's share of ``tree`` — the whole layout's parameters or
    optimizer state, or a dict holding both — for members ``[start,
    stop)``: the tree ``lp.member_range(start, stop)`` would hold.  Every
    leaf is a copy (the whole tree may be freed)."""
    plan = _plan(lp, start, stop)
    return _walk(tree, lambda node: _shard_params(node, plan))


def _cat(parts: list, axis) -> torch.Tensor:
    if axis is None:                # whole on every rank: rank 0's copy
        return parts[0]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=axis)


def _join(values: list, axis: int):
    """Concatenate the ranks' values of one parameter position along its
    member axis (each statistic of adafactor's dict at its own)."""
    first = values[0]
    ndim = _ndim(first)
    if isinstance(first, dict):
        return {k: _cat([v[k] for v in values],
                        _member_axis(axis, ndim, k)) for k in first}
    return _cat(values, axis)


def _zeros_rows(like, rows: int):
    """Zeros for ``rows`` units of a 1-D bias position (a tensor, or
    adafactor's dict of 1-D arrays), in ``like``'s dtypes and device."""
    if isinstance(like, dict):
        return {k: _zeros_rows(v, rows) for k, v in like.items()}
    return torch.zeros((rows,), dtype=like.dtype, device=like.device)


def _unshard_params(nodes: list, plans: list, lp: LayeredPopulation) -> dict:
    out = {k: _join([nd[k] for nd in nodes], plans[0][k][0])
           for k in ("w_in", "b_in", "w_out", "b_out")}
    out["mid"] = []
    for l in range(lp.depth - 1):
        # rank → its mid[l] entry (a rank keeps a prefix of the layers)
        held = {r: nd["mid"][l] for r, (nd, pl) in enumerate(zip(nodes, plans))
                if pl["mid"][l]["kept"]}
        like = next(iter(held.values()))["b"]
        b = [held[r]["b"] if r in held
             else _zeros_rows(like, pl["mid"][l]["b"][2]
                              - pl["mid"][l]["b"][1])
             for r, pl in enumerate(plans)]
        w = []
        for K in range(len(_buckets(lp, l))):
            w.append(_join([held[r]["w"][j] for r, pl in enumerate(plans)
                            for j, (k, _, _) in enumerate(pl["mid"][l]["w"])
                            if k == K], 0))
        out["mid"].append({"w": w, "b": _join(b, 0)})
    return out


def unshard_trees(trees: list, lp: LayeredPopulation, ranges) -> object:
    """The inverse of ``shard_tree``: the ranks' shares (in rank order,
    for ``ranges`` = ``member_partition(lp, n)``) joined into the whole
    layout's tree; split buckets are re-joined, the mid layers a rank did
    not hold take zero biases (module docstring), statistics that are
    whole on every rank come from rank 0, and so do step counts."""
    plans = [_plan(lp, a, b) for a, b in ranges]

    def walk(nodes):
        first = nodes[0]
        if _is_params(first):
            return _unshard_params(nodes, plans, lp)
        if isinstance(first, dict):
            return {k: walk([nd[k] for nd in nodes]) for k in first}
        if isinstance(first, (list, tuple)):
            return type(first)(walk([nd[i] for nd in nodes])
                               for i in range(len(first)))
        return first

    return walk(list(trees))


def _leaf_ids(lp: LayeredPopulation, plan: dict | None) -> list:
    """The whole-layout leaf name of each leaf of a params tree (of the
    whole layout when ``plan`` is None, else of a range), in
    ``tree_leaves`` order."""
    tree = {"w_in": "w_in", "b_in": "b_in", "w_out": "w_out",
            "b_out": "b_out", "mid": []}
    for l in range(lp.depth - 1):
        if plan is None:
            ks = range(len(_buckets(lp, l)))
        elif plan["mid"][l]["kept"]:
            ks = [K for (K, _, _) in plan["mid"][l]["w"]]
        else:
            continue
        tree["mid"].append({"w": [f"mid/{l}/w/{K}" for K in ks],
                            "b": f"mid/{l}/b"})
    return tree_leaves(tree)


class PopulationReduce:
    """The population axis's sum, for a rank's share ``[start, stop)`` of
    ``lp`` (``deep.opt_step``'s ``reduce``): ``sum`` all-reduces a tensor
    over the ranks, ``leaf_sums`` one value per leaf summed into the whole
    layout's leaf it belongs to; ``leaf_kinds``, ``leaf_numel`` and
    ``member_extent`` give adafactor the whole layout's counts."""

    def __init__(self, lp: LayeredPopulation, start: int, stop: int,
                 group=None):
        self.group = group
        full = _leaf_ids(lp, None)
        self.n_slots = len(full)
        slot = {name: i for i, name in enumerate(full)}
        ids = _leaf_ids(lp, _plan(lp, start, stop))
        self.slots = [slot[name] for name in ids]
        shapes = _full_shapes(lp)
        self.leaf_numel = [int(np.prod(shapes[name])) for name in ids]
        self.leaf_kinds = [name if name in ("w_in", "w_out", "b_out")
                           else None for name in ids]
        self.member_extent = {
            "w_in": lp.layer_pop(0).total_hidden,
            "w_out": lp.layer_pop(lp.depth - 1).total_hidden,
            "b_out": lp.num_members}
        self._index = None

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the population axis's ranks (a new tensor)."""
        import torch.distributed as dist
        t = t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def leaf_sums(self, vals: list) -> list:
        """One 0-d value per leaf of this rank's tree → per leaf, the sum
        over every rank's leaves that share its whole-layout leaf."""
        v = torch.stack(vals)
        if self._index is None or self._index.device != v.device:
            self._index = torch.as_tensor(self.slots, device=v.device)
        buf = torch.zeros(self.n_slots, dtype=v.dtype, device=v.device)
        buf = self.sum(buf.index_add_(0, self._index, v))
        return list(buf[self._index])


def _full_shapes(lp: LayeredPopulation) -> dict:
    from repro_torch.core.deep import abstract_params
    abs_p = abstract_params(lp)
    return {name: tuple(x.shape)
            for name, x in zip(_leaf_ids(lp, None), tree_leaves(abs_p))}


# --------------------------------------------------------------------- #
# a rank's share of a run                                               #
# --------------------------------------------------------------------- #

def _global(group, r: int) -> int:
    """The global rank of rank ``r`` of ``group``."""
    import torch.distributed as dist
    if group is None or group is dist.group.WORLD:
        return r
    return dist.get_global_rank(group, r)


def _gather_objects(obj, group, dst: int | None):
    """``obj`` from every rank of ``group``, over the host: a list on its
    rank ``dst`` (None elsewhere), or on every rank when ``dst`` is
    None."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    if dst is None:
        out = [None] * n
        dist.all_gather_object(out, obj, group=group)
        return out
    out = [None] * n if dist.get_rank(group) == dst else None
    dist.gather_object(obj, out, dst=_global(group, dst), group=group)
    return out


def _host(tree):
    return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


class PopulationShard:
    """One rank's share of a layout on a mesh: the whole layout ``lp``,
    the model row's ranges, this rank's ``[start, stop)`` and its layout
    ``local``, and the host collectives a run on W ranks needs (over the
    model row, ``group``; the data rows hold the same members).  On a
    world of one (``mesh`` None or one rank) every method is the identity
    and ``local is lp``; on a mesh whose model axis is 1 the layout is
    whole on every rank (``sharded`` false) but the run is still
    ``distributed``."""

    def __init__(self, lp: LayeredPopulation, mesh=None):
        self.lp = lp
        self.mesh = mesh
        self.n = pop_axis_size(mesh)
        self.rank = mesh.pop_rank if mesh is not None else 0
        self.group = getattr(mesh, "row_group", None)
        self.data = data_axis_size(mesh)
        self.data_rank = mesh.data_rank if mesh is not None else 0
        self.world = 1 if mesh is None else mesh.size
        self.ranges = member_partition(lp, self.n)
        self.start, self.stop = self.ranges[self.rank]
        self.local = shard_layout(lp, self.rank, self.n)
        self.reduce = (None if self.n == 1 else
                       PopulationReduce(lp, self.start, self.stop,
                                        self.group))

    @property
    def sharded(self) -> bool:
        """The members are split over more than one rank."""
        return self.n > 1

    @property
    def distributed(self) -> bool:
        """The run spans more than one rank (on either axis)."""
        return self.world > 1

    @property
    def is_writer(self) -> bool:
        """Rank 0 of the world: the one rank that writes and answers."""
        return self.mesh is None or self.mesh.rank == 0

    def data_reduce(self, batch_size: int):
        """The ``DataReduce`` of a ``batch_size``-row step on this mesh:
        over this rank's data column where the data axis splits the
        batch, else None (a replicated batch needs none)."""
        if population_batch_shardings(self.mesh,
                                      batch_size)[1] == slice(None):
            return None
        return DataReduce(self.mesh.col_group, self.data)

    def widths(self) -> list:
        """Each rank's fused widths, per layer of its layout."""
        out = []
        for a, b in self.ranges:
            sub = self.lp.member_range(a, b) if self.n > 1 else self.lp
            out.append([sub.layer_pop(l).total_hidden
                        for l in range(sub.depth)])
        return out

    def shard(self, tree):
        return shard_tree(tree, self.lp, self.start, self.stop) \
            if self.sharded else tree

    def unshard(self, trees):
        return unshard_trees(trees, self.lp, self.ranges)

    def gather_tree(self, tree, everywhere: bool = False):
        """The whole layout's tree from the model row's shares, on the
        host: on rank 0 (None elsewhere; only row 0 gathers, the other
        data rows hold the same members), or on every rank (each row
        over itself)."""
        if not everywhere and not self.is_writer and (
                not self.sharded or self.data_rank > 0):
            return None
        if not self.sharded:
            return _host(tree)
        parts = _gather_objects(_host(tree), self.group,
                                None if everywhere else 0)
        return None if parts is None else self.unshard(parts)

    def gather_members(self, t: torch.Tensor, dst: int | None = None):
        """A tensor whose last axis is this rank's members → the whole
        layout's, over the model row and the host: a CPU tensor on every
        rank, or with ``dst`` on the row's rank ``dst`` only (None
        elsewhere).  A model axis of one: ``t``."""
        if not self.sharded:
            return t
        import torch.distributed as dist
        t = t.detach().to("cpu")
        width = max(b - a for a, b in self.ranges)
        pad = torch.zeros(t.shape[:-1] + (width,), dtype=t.dtype)
        pad[..., :t.shape[-1]] = t
        if dst is None:
            parts = [torch.empty_like(pad) for _ in range(self.n)]
            dist.all_gather(parts, pad, group=self.group)
        else:
            parts = ([torch.empty_like(pad) for _ in range(self.n)]
                     if self.rank == dst else None)
            dist.gather(pad, parts, dst=_global(self.group, dst),
                        group=self.group)
            if parts is None:
                return None
        return torch.cat([p[..., :b - a]
                          for p, (a, b) in zip(parts, self.ranges)], dim=-1)

    def gather_rows(self, t: torch.Tensor, split: bool):
        """A tensor of this rank's rows (leading axis) and members (last
        axis) → the whole batch's and the whole layout's on rank 0, over
        the host (None elsewhere): the members over each model row to its
        rank 0, then, where the batch was ``split`` over the data axis,
        the rows over the data column of those ranks to rank 0; unsplit,
        row 0's is the whole batch."""
        t = self.gather_members(t, dst=0) if self.sharded else t
        if t is None or (self.data_rank > 0 and not split):
            return None
        if not split:
            return t.to("cpu")
        import torch.distributed as dist
        t = t.detach().to("cpu").contiguous()
        parts = ([torch.empty_like(t) for _ in range(self.data)]
                 if self.is_writer else None)
        dist.gather(t, parts, dst=0, group=self.mesh.col_group)
        return None if parts is None else torch.cat(parts, dim=0)
