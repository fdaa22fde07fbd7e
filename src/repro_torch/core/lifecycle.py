"""Successive-halving population lifecycle: train → eval → prune → compact,
and the slot-refill primitives of the search (``repro_torch.search``).

The paper trains its whole population to the horizon and only then
selects.  A halving schedule prunes at rung boundaries instead: the
population is evaluated, the worst members are dropped, and the survivors
are COMPACTED into a freshly built ``LayeredPopulation`` whose fused hidden
axis is physically smaller, so the next rung's steps run on a smaller
layout (the JAX package's ``repro.core.lifecycle``, DESIGN.md §6, §13).

  * Compaction is a pure gather.  Members are independent, so removing
    losers cannot change a survivor's computation: ``compact`` copies each
    survivor's padded slices bit for bit, optimizer moments (sgd ``mu``,
    adamw ``m``/``v``) through the same index maps.  Adafactor's factored
    statistics mix members and cannot be gathered: ``compact_factored``
    carries its momentum and count, and the trainer re-initialises the
    rest on the new layout.
  * Growth (``grow``) is its inverse: new members spliced in at their
    sorted-merge positions, survivors bit for bit, newborns from a fresh
    init with zero moments.  The constant-size refill (``refill_params``,
    ``refill_state``) overwrites pruned slots in place and keeps the
    layout, so no table of the layout is rebuilt.
  * Identity is kept by bookkeeping: the caller carries a slot → original
    ``member_ids`` vector (checkpointed in the lifecycle meta).

``gather="device"`` runs each tree operation as ``index_select`` /
``index_copy_`` on the tensors' device, from index tensors built on the
host once per (layouts, keep | positions | assignments) and copied once
(a small bounded cache keyed by the layouts' fields, so it keeps no layout
instance, and with it no layout's device tables, alive).
``gather="host"`` is the numpy path (bf16 leaves cross it as their raw
16-bit patterns); the two are bitwise equal (both only copy values).
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from repro_torch.core.population import LayeredPopulation


# ---------------------------------------------------------------------- #
# schedule                                                               #
# ---------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class HalvingSchedule:
    """Rungs of ``(end_step, keep_frac)``: after global step ``end_step``
    completes, keep the best ``keep_frac`` of the surviving members.
    ``"500:0.5,1000:0.5,2000:0.25"`` prunes to 50 % at step 500, 50 % of
    the survivors at 1000 and 25 % of those at 2000.  Rungs at or beyond a
    run's total step count never fire, so a short run is a prefix of the
    ladder (what makes mid-ladder checkpoints resumable)."""

    rungs: tuple  # ((end_step, keep_frac), ...)

    def __post_init__(self):
        rungs = tuple((int(s), float(f)) for s, f in self.rungs)
        if not rungs:
            raise ValueError("halving schedule needs at least one rung")
        prev = 0
        for s, f in rungs:
            if s <= prev:
                raise ValueError(
                    f"rung steps must be strictly increasing and > 0, got "
                    f"{[r[0] for r in rungs]}")
            if not 0.0 < f <= 1.0:
                raise ValueError(f"keep_frac must be in (0, 1], got {f}")
            prev = s
        object.__setattr__(self, "rungs", rungs)

    @staticmethod
    def parse(spec: str) -> "HalvingSchedule":
        """``"500:0.5,1000:0.5,2000:0.25"`` → HalvingSchedule."""
        rungs = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            try:
                s, f = part.split(":")
                rungs.append((int(s), float(f)))
            except ValueError as e:
                raise ValueError(
                    f"bad halving rung {part!r} (want STEP:KEEP_FRAC, e.g. "
                    "'500:0.5,1000:0.25')") from e
        return HalvingSchedule(tuple(rungs))

    def segments(self, total_steps: int) -> tuple:
        """The run [0, total_steps) as ``(end_step, keep_frac|None)``
        segments: one per rung boundary inside the run, plus the final
        stretch.  Segment i trains [prev_end, end), then prunes iff
        keep_frac is not None."""
        if total_steps < 1:
            raise ValueError(f"total_steps must be >= 1, got {total_steps}")
        segs = [(s, f) for s, f in self.rungs if s < total_steps]
        segs.append((total_steps, None))
        return tuple(segs)

    @staticmethod
    def n_keep(n: int, keep_frac: float) -> int:
        """Survivor count for a rung: floor(n·frac), never below 1."""
        return max(1, int(n * keep_frac))


def survivors(losses, keep_frac: float) -> np.ndarray:
    """Indices of the best ``n_keep`` members by eval loss, sorted
    ascending (compaction keeps member order).  Ties go to the lower index
    (stable argsort)."""
    losses = np.asarray(losses)
    k = HalvingSchedule.n_keep(losses.shape[0], keep_frac)
    return np.sort(np.argsort(losses, kind="stable")[:k])


# ---------------------------------------------------------------------- #
# the two gather backends                                                #
# ---------------------------------------------------------------------- #

class _Numpy:
    """Host backend: numpy arrays, numpy index arrays."""

    @staticmethod
    def take(a, idx, axis=0):
        return np.take(a, idx, axis=axis)

    @staticmethod
    def cat(parts, axis=0):
        return parts[0].copy() if len(parts) == 1 \
            else np.concatenate(parts, axis=axis)

    @staticmethod
    def zeros(shape, like):
        return np.zeros(shape, like.dtype)

    @staticmethod
    def copy(a):
        return np.array(a)

    @staticmethod
    def put(out, idx, vals, axis=0):
        if axis == 0:
            out[idx] = vals
        else:
            out[:, idx] = vals
        return out


class _Torch:
    """Device backend: tensors, int64 index tensors on their device."""

    @staticmethod
    def take(a, idx, axis=0):
        return a.index_select(axis, idx)

    @staticmethod
    def cat(parts, axis=0):
        return parts[0].clone() if len(parts) == 1 \
            else torch.cat(parts, dim=axis)

    @staticmethod
    def zeros(shape, like):
        return torch.zeros(shape, dtype=like.dtype, device=like.device)

    @staticmethod
    def copy(a):
        return a.clone()

    @staticmethod
    def put(out, idx, vals, axis=0):
        return out.index_copy_(axis, idx, vals)


def _layout_key(lp: LayeredPopulation) -> tuple:
    """A layout's fields, hashable and holding no reference to the
    instance (whose device caches must die with it)."""
    return (lp.in_features, lp.out_features, lp.widths, lp.activations,
            lp.block, lp.n_pad)


# index plans on a device: (kind, layouts, selection, device) → the plan
# with its index arrays as int64 tensors there
_DEVICE_PLANS: collections.OrderedDict = collections.OrderedDict()
_DEVICE_PLANS_MAX = 8


def _plan_on(key, device, build):
    """The index plan ``build()`` (nested dicts/lists/tuples of numpy
    int arrays and ints) with every array copied to ``device`` once, kept
    in a small LRU cache under ``key``."""
    key = key + (str(torch.device(device)),)
    plan = _DEVICE_PLANS.get(key)
    if plan is None:
        def move(node):
            if isinstance(node, np.ndarray):
                return torch.from_numpy(node.astype(np.int64)).to(device)
            if isinstance(node, dict):
                return {k: move(v) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return type(node)(move(v) for v in node)
            return node
        plan = _DEVICE_PLANS[key] = move(build())
        while len(_DEVICE_PLANS) > _DEVICE_PLANS_MAX:
            _DEVICE_PLANS.popitem(last=False)
    else:
        _DEVICE_PLANS.move_to_end(key)
    return plan


def _run(plan_key, build, apply, trees, gather: str):
    """Run ``apply(backend, plan, *trees)`` on the device (``gather=
    "device"``: the trees' tensors, the plan's indices copied there) or on
    the host (``"host"``: numpy, the result copied back to the trees'
    device)."""
    from repro_torch.core.tree import tree_leaves, tree_map
    device = next(x.device for t in trees if t is not None
                  for x in tree_leaves(t))
    if gather == "device":
        return apply(_Torch, _plan_on(plan_key, device, build), *trees)
    if gather != "host":
        raise ValueError(f"gather must be 'device' or 'host', got {gather!r}")
    # numpy has no bf16: such leaves cross as int16 bit patterns (a tree
    # of moments holds one dtype; parameters are never int16)
    host = [None if t is None else tree_map(_bits_to_numpy, t)
            for t in trees]
    out = apply(_Numpy, build(), *host)
    return tree_map(lambda a: _bits_from_numpy(a).to(device), out)


def _bits_to_numpy(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    return x.numpy()


def _bits_from_numpy(a: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.view(torch.bfloat16) if t.dtype == torch.int16 else t


# ---------------------------------------------------------------------- #
# compaction                                                             #
# ---------------------------------------------------------------------- #

def _ranges(starts, lengths) -> np.ndarray:
    """The concatenation of ``arange(s, s + n)`` over (s, n) pairs, int64."""
    starts = np.asarray(starts, np.int64)
    lengths = np.asarray(lengths, np.int64)
    if not lengths.size:
        return np.zeros(0, np.int64)
    ends = np.cumsum(lengths)
    return np.repeat(starts - (ends - lengths), lengths) + np.arange(ends[-1])


def _fused_keep_rows(pop_l, keep) -> np.ndarray:
    """Fused-axis indices of the survivors' PADDED slices in one layer's
    layout (padded sizes do not change under subset)."""
    keep = np.asarray(keep, np.int64)
    return _ranges(pop_l.offsets[keep], pop_l.padded_sizes[keep])


def _real_bucket_pos(lp: LayeredPopulation, l: int) -> dict:
    """member → (real-bucket index, position in the bucket) of projection
    ``l``: the inverse of the bucket packing of ``params['mid'][l]['w']``."""
    pos = {}
    wi = 0
    for (m0, n, hin, hout, off_in, off_out, real) in lp.proj_buckets(l):
        if not real:
            continue
        for i in range(n):
            pos[m0 + i] = (wi, i)
        wi += 1
    return pos


def _runs(where) -> list:
    """Maximal runs of consecutive positions from one source bucket:
    ``where`` per member ``(source..., index)`` → ``[(source..., i0, n)]``."""
    parts, s, n = [], 0, len(where)
    while s < n:
        src, i0 = where[s][:-1], where[s][-1]
        e = s + 1
        while e < n and where[e] == src + (i0 + (e - s),):
            e += 1
        parts.append(src + (i0, e - s))
        s = e
    return parts


def _compact_plan(lp: LayeredPopulation, new_lp: LayeredPopulation, keep):
    mid = []
    for l in range(new_lp.depth - 1):
        pos = _real_bucket_pos(lp, l)
        buckets = [_runs([pos[keep[m]] for m in range(m0, m0 + n)])
                   for (m0, n, *_r, real) in new_lp.proj_buckets(l) if real]
        mid.append({"w": buckets,
                    "b": _fused_keep_rows(lp.layer_pop(l + 1), keep)})
    return {"rows0": _fused_keep_rows(lp.layer_pop(0), keep), "mid": mid,
            "rows_last": _fused_keep_rows(lp.layer_pop(lp.depth - 1), keep),
            "keep": np.asarray(keep, np.int64)}


def _compact_apply(xp, plan, params):
    out = {"w_in": xp.take(params["w_in"], plan["rows0"]),
           "b_in": xp.take(params["b_in"], plan["rows0"]), "mid": []}
    for l, pl in enumerate(plan["mid"]):
        old_w = params["mid"][l]["w"]
        wl = [xp.cat([old_w[wi][i0:i0 + n] for (wi, i0, n) in parts])
              for parts in pl["w"]]
        out["mid"].append({"w": wl,
                           "b": xp.take(params["mid"][l]["b"], pl["b"])})
    out["w_out"] = xp.take(params["w_out"], plan["rows_last"], axis=1)
    out["b_out"] = xp.take(params["b_out"], plan["keep"])
    return out


def compact_params(lp: LayeredPopulation, new_lp: LayeredPopulation,
                   params, keep, gather: str = "host") -> dict:
    """Gather one ``deep.init_params``-shaped tree (parameters, moments,
    gradients) down to the survivors ``keep`` of ``lp``; ``new_lp`` is
    ``lp.subset(keep)``.  Mid-layer bucket weights regroup into
    ``new_lp``'s buckets; layers only pruned members reached are dropped."""
    keep = [int(m) for m in keep]
    return _run(("compact", _layout_key(lp), _layout_key(new_lp),
                 tuple(keep)),
                lambda: _compact_plan(lp, new_lp, keep), _compact_apply,
                [params], gather)


def compact(pop: LayeredPopulation, params, opt_state, keep,
            gather: str = "device"):
    """Prune the population down to ``keep`` (strictly increasing real
    member indices) → ``(new_pop, new_params, new_opt_state)``.
    ``new_pop = pop.subset(keep)``, a freshly built layout (its device
    tables are built at first use); ``params`` and every params-shaped
    subtree of ``opt_state`` are gathered bit for bit, scalar leaves pass
    through.  An adafactor state raises ``ValueError``: its factored
    statistics are not member-major (:func:`compact_factored`)."""
    if not isinstance(pop, LayeredPopulation):
        raise TypeError(
            f"compact expects a LayeredPopulation, got {type(pop).__name__} "
            "(lift single-layer layouts with Population.layered() first)")
    new_pop = pop.subset(keep)
    new_params = compact_params(pop, new_pop, params, keep, gather=gather)
    if opt_state is None:
        return new_pop, new_params, None
    from repro_torch.core.deep import map_params_subtrees
    return new_pop, new_params, map_params_subtrees(
        opt_state, params,
        lambda node: compact_params(pop, new_pop, node, keep, gather=gather),
        op="compact")


def compact_factored(pop: LayeredPopulation, params, opt_state, keep,
                     gather: str = "device"):
    """Adafactor-aware rung compaction → ``(new_pop, new_params, carry)``.
    ``opt_state`` must be an adafactor state (``{"count", "leaves"}``, a
    per-param dict of ``v`` or ``v_row`` + ``v_col`` and optionally
    ``m``).  The factored statistics reduce over the fused hidden axis, so
    no member-major gather recovers a survivor's: they are DROPPED.  The
    carry holds what survives the rung: ``m``, the params-shaped momentum
    tree gathered through the parameters' index maps (bit for bit, its
    dtype kept; None without momentum), and ``count``.  The trainer
    re-initialises the statistics on the new layout and merges the carry
    back in (``launch.train.rewarm_adafactor_state``): the second moment
    re-warms in ~1/(1−b2) steps."""
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.optim.optimizers import is_state_leaf
    if not (isinstance(opt_state, dict) and "leaves" in opt_state):
        raise ValueError(
            "compact_factored expects an adafactor state "
            "({'count', 'leaves'}); use compact() for params-shaped states")
    new_pop = pop.subset(keep)
    new_params = compact_params(pop, new_pop, params, keep, gather=gather)
    leaves = opt_state["leaves"]
    flat = tree_leaves(leaves, is_leaf=is_state_leaf)
    m = None
    if flat and all("m" in st for st in flat):
        m = compact_params(pop, new_pop,
                           tree_map(lambda st: st["m"], leaves,
                                    is_leaf=is_state_leaf),
                           keep, gather=gather)
    return new_pop, new_params, {"count": opt_state["count"], "m": m}


# ---------------------------------------------------------------------- #
# growth (the inverse of compaction)                                     #
# ---------------------------------------------------------------------- #

def _grow_src(new_lp: LayeredPopulation, positions) -> list:
    """Per grown-layout member: ``(tree, index)``, tree 0 the surviving
    tree, tree 1 the fresh tree (whose members sit at sorted(positions):
    a position's fresh index is its rank)."""
    rank = {p: r for r, p in enumerate(sorted(positions))}
    src, oi = [], 0
    for m in range(new_lp.num_members):
        if m in rank:
            src.append((1, rank[m]))
        else:
            src.append((0, oi))
            oi += 1
    return src


def _splice_rows(new_lp, srcs_lp, src, l, carried):
    """Layer ``l``'s fused axis of the grown layout as copies: ``[dst, src]``
    index pairs from each source tree; rows of a source shallower than
    ``l`` read that source's last layer when ``carried`` (w_in/w_out
    semantics), else stay zero (mid-layer bias: a pass-through slice)."""
    pop_new = new_lp.layer_pop(l)
    tree = np.array([t for t, _ in src])
    index = np.array([i for _, i in src], np.int64)
    out = {"n": int(pop_new.total_hidden)}
    for t, key in enumerate(("old", "fresh")):
        slp = srcs_lp[t]
        l_src = l if l < slp.depth else (slp.depth - 1 if carried else None)
        members = np.flatnonzero(tree == t) if l_src is not None \
            else np.zeros(0, np.int64)
        sizes = pop_new.padded_sizes[members]
        out[key] = (_ranges(pop_new.offsets[members], sizes),
                    _ranges(slp.layer_pop(l_src).offsets[index[members]]
                            if len(members) else [], sizes))
    return out


def _grow_plan(lp, new_lp, fresh_lp, positions):
    src = _grow_src(new_lp, positions)
    srcs_lp = (lp, fresh_lp)
    mid = []
    for l in range(new_lp.depth - 1):
        pos_src = [(_real_bucket_pos(slp, l) if l < slp.depth - 1 else {})
                   for slp in srcs_lp]
        buckets = [_runs([(src[m][0],) + pos_src[src[m][0]][src[m][1]]
                          for m in range(m0, m0 + n)])
                   for (m0, n, *_r, real) in new_lp.proj_buckets(l) if real]
        mid.append({"w": buckets,
                    "b": _splice_rows(new_lp, srcs_lp, src, l + 1, False)})
    rows = np.array([i if t == 0 else -1 - i for (t, i) in src])
    return {"w_in": _splice_rows(new_lp, srcs_lp, src, 0, True),
            "b_in": _splice_rows(new_lp, srcs_lp, src, 0, False),
            "mid": mid,
            "w_out": _splice_rows(new_lp, srcs_lp, src, new_lp.depth - 1,
                                  True),
            "b_out": {"n": new_lp.num_members,
                      "old": (np.flatnonzero(rows >= 0),
                              rows[rows >= 0]),
                      "fresh": (np.flatnonzero(rows < 0),
                                -1 - rows[rows < 0])}}


def _splice(xp, sp, old, fresh, axis=0):
    """One grown leaf: zeros, then the old and the fresh rows copied in."""
    like = old if old is not None else fresh
    shape = list(like.shape)
    shape[axis] = sp["n"]
    out = xp.zeros(tuple(shape), like)
    for leaf, (dst, src) in ((old, sp["old"]), (fresh, sp["fresh"])):
        if leaf is not None and len(dst):
            out = xp.put(out, dst, xp.take(leaf, src, axis=axis), axis)
    return out


def _grow_apply(xp, plan, params, fresh):
    out = {"w_in": _splice(xp, plan["w_in"], params["w_in"], fresh["w_in"]),
           "b_in": _splice(xp, plan["b_in"], params["b_in"], fresh["b_in"]),
           "mid": []}
    for l, pl in enumerate(plan["mid"]):
        trees = (params, fresh)
        w_src = [t["mid"][l]["w"] if l < len(t["mid"]) else None
                 for t in trees]
        wl = [xp.cat([w_src[t][wi][i0:i0 + n] for (t, wi, i0, n) in parts])
              for parts in pl["w"]]
        b = [t["mid"][l]["b"] if l < len(t["mid"]) else None for t in trees]
        out["mid"].append({"w": wl, "b": _splice(xp, pl["b"], *b)})
    out["w_out"] = _splice(xp, plan["w_out"], params["w_out"],
                           fresh["w_out"], axis=1)
    out["b_out"] = _splice(xp, plan["b_out"], params["b_out"],
                           fresh["b_out"])
    return out


def grow_params(lp: LayeredPopulation, new_lp: LayeredPopulation,
                params, positions, fresh, gather: str = "device") -> dict:
    """Splice a fresh-members tree into a surviving tree, the exact inverse
    of :func:`compact_params` (grow-then-compact gives the tree back bit
    for bit).  ``new_lp`` is ``lp.grow(..., positions)``; ``fresh`` is an
    ``init_params``-shaped tree of the new members' own layout
    ``new_lp.subset(sorted(positions))`` (parameters, or zeros for
    moments)."""
    positions = tuple(int(p) for p in positions)
    fresh_lp = new_lp.subset(tuple(sorted(positions)))
    old_pos = tuple(m for m in range(new_lp.num_real)
                    if m not in set(positions))
    if len(old_pos) != new_lp.num_real - len(positions) \
            or new_lp.subset(old_pos) != lp:
        raise ValueError(
            "grow_params: new_lp is not lp.grow(...) at these positions "
            "(the survivors' widths/activations must read back as lp)")
    return _run(("grow", _layout_key(lp), _layout_key(new_lp), positions),
                lambda: _grow_plan(lp, new_lp, fresh_lp, positions),
                _grow_apply, [params, fresh], gather)


def grow(pop: LayeredPopulation, params, opt_state, new_widths, new_acts,
         positions, fresh, gather: str = "device"):
    """Grow a compacted population by NEW members → ``(new_pop,
    new_params, new_opt_state)``.  ``fresh`` is the new members' parameter
    tree on ``pop.grow(...).subset(sorted(positions))`` (the driver draws
    it with ``launch.train.fresh_member_params``); their moments are
    zero, the survivors' parameters and moments ride through bit for
    bit.  An adafactor state raises ``ValueError`` (``deep.grow_state``):
    the trainer grows its carried momentum with :func:`grow_params`."""
    from repro_torch.core.deep import grow_state
    new_pop = pop.grow(new_widths, new_acts, positions)
    new_params = grow_params(pop, new_pop, params, positions, fresh,
                             gather=gather)
    if opt_state is None:
        return new_pop, new_params, None
    return new_pop, new_params, grow_state(opt_state, pop, new_pop,
                                           positions, gather=gather)


# ---------------------------------------------------------------------- #
# constant-size slot refill                                              #
# ---------------------------------------------------------------------- #

def _refill_plan(lp, assignments, fresh_lp):
    fresh_of = {}                 # slot → index among fresh_lp's members
    for slot, parent in assignments:
        if parent < 0:
            fresh_of[slot] = len(fresh_of)

    def fused(l, carried):
        pop_l = lp.layer_pop(l)
        # pass-through rows (a slot shallower than l) are zero before and
        # after, unless carried
        live = [(s, p) for s, p in assignments
                if carried or lp.member_depths[s] > l]
        clone = np.array([(s, p) for s, p in live if p >= 0],
                         np.int64).reshape(-1, 2)
        born = np.array([(s, fresh_of[s]) for s, p in live if p < 0],
                        np.int64).reshape(-1, 2)
        out = {"clone": (_ranges(pop_l.offsets[clone[:, 0]],
                                 pop_l.padded_sizes[clone[:, 0]]),
                         _ranges(pop_l.offsets[clone[:, 1]],
                                 pop_l.padded_sizes[clone[:, 1]])),
               "fresh": (np.zeros(0, np.int64), np.zeros(0, np.int64))}
        if len(born):
            sp = fresh_lp.layer_pop(min(l, fresh_lp.depth - 1) if carried
                                    else l)
            sizes = pop_l.padded_sizes[born[:, 0]]
            out["fresh"] = (_ranges(pop_l.offsets[born[:, 0]], sizes),
                            _ranges(sp.offsets[born[:, 1]], sizes))
        return out

    mid = []
    for l in range(lp.depth - 1):
        pos = _real_bucket_pos(lp, l)
        pos_f = (_real_bucket_pos(fresh_lp, l)
                 if fresh_lp is not None and l < fresh_lp.depth - 1 else {})
        groups = {}               # (dst bucket, tree, src bucket) → pairs
        for slot, parent in assignments:
            if not lp.proj_real(slot, l):
                continue
            wi_d, i_d = pos[slot]
            if parent >= 0:
                wi_s, i_s = pos[parent]
                groups.setdefault((wi_d, 0, wi_s), []).append((i_d, i_s))
            else:
                wi_s, i_s = pos_f[fresh_of[slot]]
                groups.setdefault((wi_d, 1, wi_s), []).append((i_d, i_s))
        mid.append({"w": [(k, np.array([p[0] for p in v], np.int64),
                           np.array([p[1] for p in v], np.int64))
                          for k, v in groups.items()],
                    "b": fused(l + 1, False)})
    clone = [(s, p) for s, p in assignments if p >= 0]
    born = [(s, fresh_of[s]) for s, p in assignments if p < 0]
    return {"w_in": fused(0, False), "b_in": fused(0, False), "mid": mid,
            "w_out": fused(lp.depth - 1, True),
            "b_out": {"clone": (np.array([s for s, _ in clone], np.int64),
                                np.array([p for _, p in clone], np.int64)),
                      "fresh": (np.array([s for s, _ in born], np.int64),
                                np.array([j for _, j in born], np.int64))}}


def _scatter(xp, sp, leaf, fresh, axis=0):
    """One refilled leaf: a copy, the clones' rows from their parents'
    rows of the same leaf, the fresh slots' from the fresh tree."""
    out = xp.copy(leaf)
    for src_leaf, (dst, src) in ((leaf, sp["clone"]),
                                 (fresh, sp["fresh"])):
        if len(dst):
            out = xp.put(out, dst, xp.take(src_leaf, src, axis=axis), axis)
    return out


def _refill_apply(xp, plan, params, fresh):
    def fleaf(*keys):
        """The fresh tree's leaf at ``keys``; None where it has none (no
        fresh slots, or a layer the fresh slots do not reach)."""
        node = fresh
        for k in keys:
            if node is None or (isinstance(k, int) and k >= len(node)):
                return None
            node = node[k]
        return node

    out = {"w_in": _scatter(xp, plan["w_in"], params["w_in"],
                            fleaf("w_in")),
           "b_in": _scatter(xp, plan["b_in"], params["b_in"],
                            fleaf("b_in")),
           "mid": []}
    for l, pl in enumerate(plan["mid"]):
        wl = list(params["mid"][l]["w"])
        for (wi_d, t, wi_s), i_d, i_s in pl["w"]:
            src = wl[wi_s] if t == 0 else fresh["mid"][l]["w"][wi_s]
            wl[wi_d] = xp.put(xp.copy(wl[wi_d]), i_d, xp.take(src, i_s))
        out["mid"].append({"w": wl,
                           "b": _scatter(xp, pl["b"], params["mid"][l]["b"],
                                         fleaf("mid", l, "b"))})
    out["w_out"] = _scatter(xp, plan["w_out"], params["w_out"],
                            fleaf("w_out"), axis=1)
    out["b_out"] = _scatter(xp, plan["b_out"], params["b_out"],
                            fleaf("b_out"))
    return out


def refill_params(lp: LayeredPopulation, params, assignments,
                  fresh=None, gather: str = "device") -> dict:
    """Constant-size slot refill: overwrite pruned slots with clones of
    survivors and/or freshly initialised members, keeping the layout (and
    every device table built for it).  ``assignments``: ``(slot, parent)``
    pairs, ``slot`` a pruned real slot, ``parent`` a surviving real slot
    of the same (widths, activations) to clone, or -1 to take the slot
    from ``fresh`` (an ``init_params`` tree of the fresh slots' own
    layout, in ascending slot order).  Survivors' values are untouched."""
    assignments = tuple((int(s), int(p)) for s, p in assignments)
    slots = [s for s, _ in assignments]
    if len(set(slots)) != len(slots):
        raise ValueError(f"refill_params: duplicate slots in {slots}")
    slot_set = set(slots)
    fresh_slots = []
    for slot, parent in assignments:
        if not 0 <= slot < lp.num_real:
            raise ValueError(f"refill_params: slot {slot} out of range "
                             f"[0, {lp.num_real}) (fillers cannot refill)")
        if parent >= 0:
            if parent in slot_set or not 0 <= parent < lp.num_real:
                raise ValueError(
                    f"refill_params: parent {parent} of slot {slot} must "
                    "be a surviving real slot")
            if (lp.widths[parent] != lp.widths[slot]
                    or lp.activations[parent] != lp.activations[slot]):
                raise ValueError(
                    f"refill_params: parent {parent} arch "
                    f"{lp.widths[parent]} does not match slot {slot} arch "
                    f"{lp.widths[slot]}: clones adopt the slot's "
                    "architecture")
        else:
            fresh_slots.append(slot)
    fresh_lp = None
    if fresh_slots:
        if fresh is None:
            raise ValueError("refill_params: fresh-init slots need a "
                             "`fresh` params tree")
        fresh_slots.sort()
        fresh_lp = LayeredPopulation(
            lp.in_features, lp.out_features,
            tuple(lp.widths[s] for s in fresh_slots),
            tuple(lp.activations[s] for s in fresh_slots), block=lp.block)
    else:
        fresh = None
    # fresh members are consumed in ascending slot order
    assignments = tuple(sorted(assignments))
    return _run(("refill", _layout_key(lp), assignments),
                lambda: _refill_plan(lp, assignments, fresh_lp),
                _refill_apply, [params, fresh], gather)


def member_moment_mask(lp: LayeredPopulation, slots) -> dict:
    """Params-structured tree of broadcastable numpy keep masks: 1.0 on
    every other member's slices, 0.0 on the refilled ``slots``.  An
    optimizer-moment tree times this mask is the in-place twin of a
    newborn's zero moments (``optim.scale_member_moments``)."""
    slots = sorted(int(s) for s in slots)
    for s in slots:
        if not 0 <= s < lp.num_real:
            raise ValueError(f"member_moment_mask: slot {s} out of range")

    def fused_mask(l):
        pop_l = lp.layer_pop(l)
        m = np.ones(pop_l.total_hidden, np.float32)
        for s in slots:
            m[pop_l.offsets[s]: pop_l.offsets[s + 1]] = 0.0
        return m

    slot_set = set(slots)
    member_m = np.array([0.0 if m in slot_set else 1.0
                         for m in range(lp.num_members)], np.float32)
    out = {"w_in": fused_mask(0)[:, None], "b_in": fused_mask(0), "mid": []}
    for l in range(lp.depth - 1):
        wl = [member_m[m0: m0 + n][:, None, None]
              for (m0, n, *_r, real) in lp.proj_buckets(l) if real]
        out["mid"].append({"w": wl, "b": fused_mask(l + 1)})
    out["w_out"] = fused_mask(lp.depth - 1)[None, :]
    out["b_out"] = member_m[:, None]
    return out


def refill_state(opt_state, lp: LayeredPopulation, slots):
    """Zero the refilled slots' moments in place (what ``opt.init`` would
    give the newborns), survivors' moments and scalar counts untouched:
    sgd (its count only), momentum ``mu``, adamw ``m``/``v`` (their dtype
    kept), adafactor ``m`` and unfactored ``v``.  Adafactor's factored
    ``v_row``/``v_col`` mix members along their reduced axis and stay
    STALE: they re-warm in ~1/(1−b2) steps, the same cost as riding
    adafactor through a compacting rung."""
    if opt_state is None or not slots:
        return opt_state
    from repro_torch.core.deep import abstract_params
    from repro_torch.optim.optimizers import scale_member_moments
    return scale_member_moments(opt_state, abstract_params(lp),
                                member_moment_mask(lp, slots))
