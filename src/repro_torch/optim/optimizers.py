"""Optimizers — functional, over parameter trees (nested dicts and lists of
tensors), with the JAX package's update rules and state trees.

  * ``sgd``        — momentum optional; the paper trains with plain SGD.
  * ``adamw``      — decoupled weight decay; ``state_dtype=torch.bfloat16``
    stores m and v in bf16 (half the optimizer memory), the moment math in
    float32.
  * ``adafactor``  — factored second moment (row and column statistics of
    every matrix, O(n+m) per matrix), bf16 momentum, an RMS-clipped
    update.

API: ``Optimizer(init, update)``.
  init(params) -> state
  update(grads, state, params, lr) -> (updates, new_state)   # updates: deltas
  update(..., reduce=r)  a rank's share of a population: ``r`` sums over
                         the ranks where the rule mixes members

The state trees keep the JAX package's keys (``count``, ``mu``, ``m``,
``v``; adafactor ``count`` and ``leaves``, a parameter tree of per-param
dicts ``{"m", "v" | "v_row" + "v_col"}``), so a checkpointed state moves
between the two packages.

``lr`` may be a scalar OR a tree of per-leaf scale tensors matching the
parameter tree (broadcastable against each leaf) — how per-member learning
rates reach fused populations: ``core.deep.member_lr_tree`` expands a (P,)
vector into such a tree.  SGD's ``momentum`` and AdamW's ``weight_decay``
take a scalar or such a tree the same way, and so does adafactor's
``weight_decay``.

The update rules are the JAX package's, in plain PyTorch (JAX computes
them in plain ``jnp`` too, outside any kernel).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.core.tree import (tree_leaves, tree_map, tree_structure,
                                   tree_unflatten)

def _f32(v, like: torch.Tensor) -> torch.Tensor:
    """A scalar hyperparameter as a float32 tensor on ``like``'s device, so
    every product is computed in float32 as the JAX package computes it."""
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def tree_zeros_like(tree, dtype=None):
    return tree_map(lambda x: torch.zeros_like(x, dtype=dtype or x.dtype),
                    tree)


def global_norm(tree, reduce=None) -> torch.Tensor:
    """The l2 norm of every leaf together; with ``reduce`` (a rank's share
    of a population, ``distributed.sharding.PopulationReduce``) the
    squares are summed over the ranks first."""
    sq = sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree))
    return torch.sqrt(sq if reduce is None else reduce.sum(sq))


def clip_by_global_norm(grads, max_norm: float, reduce=None):
    """→ (grads scaled to a global norm of at most ``max_norm``, the norm
    before clipping); ``reduce`` as in :func:`global_norm`."""
    norm = global_norm(grads, reduce)
    scale = torch.clamp(_f32(max_norm, norm)
                        / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def _is_tree(val) -> bool:
    return isinstance(val, (dict, list, tuple))


def broadcast_scale(val, tree, name: str = "scale"):
    """Normalise a scalar-or-scale-tree hyperparameter to a tree matching
    ``tree``.  Scalars (numbers, 0-d tensors) are replicated to every leaf;
    a tree is passed through after a structure check; a raw per-member
    (P,) vector is rejected — expand it with ``core.deep.member_lr_tree``
    first."""
    if _is_tree(val):
        if tree_structure(val) != tree_structure(tree):
            raise ValueError(f"{name} tree structure does not match params")
        return val
    if getattr(val, "ndim", 0) != 0:
        raise ValueError(
            f"{name} must be a scalar or a tree of per-leaf scales, got an "
            f"array of shape {tuple(val.shape)}; expand per-member vectors "
            f"with core.deep.member_lr_tree(layout, {name}) first")
    return tree_unflatten(tree, [val] * len(tree_leaves(tree)))


def broadcast_lr(lr, tree):
    return broadcast_scale(lr, tree, "lr")


def hyper_on(h) -> bool:
    """Is a scalar-or-tree hyperparameter active?  Scalars by truthiness
    (``momentum=0.0`` means plain SGD, no state); a scale TREE always."""
    if _is_tree(h):
        return True
    return bool(h)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., tuple]


def _dtype(dtype) -> torch.dtype:
    """A state dtype given as a ``torch.dtype`` or its name."""
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def _count0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


# --------------------------------------------------------------------- #
# SGD                                                                   #
# --------------------------------------------------------------------- #

def sgd(momentum=0.0, nesterov: bool = False) -> Optimizer:
    """``momentum`` may be a scalar or a per-leaf scale tree; a scalar 0
    keeps the stateless plain-SGD path (the state is the step count), whose
    update ``p + (−lr)·g`` equals ``p − lr·g`` bit for bit."""
    stateful = hyper_on(momentum)

    def init(params):
        st = {"count": _count0(params)}
        if stateful:
            st["mu"] = tree_zeros_like(params, torch.float32)
        return st

    def update(grads, state, params, lr, reduce=None):
        # elementwise: a rank's share updates alone (``reduce`` unused)
        lrs = broadcast_lr(lr, grads)
        if not stateful:
            upd = tree_map(lambda g, l: -l * g.float(), grads, lrs)
            return upd, {"count": state["count"] + 1}
        moms = broadcast_scale(momentum, grads, "momentum")
        mu = tree_map(lambda mo, m, g: mo * m + g.float(),
                      moms, state["mu"], grads)
        if nesterov:
            upd = tree_map(lambda mo, m, g, l: -l * (mo * m + g.float()),
                           moms, mu, grads, lrs)
        else:
            upd = tree_map(lambda m, l: -l * m, mu, lrs)
        return upd, {"count": state["count"] + 1, "mu": mu}

    return Optimizer(init, update)


# --------------------------------------------------------------------- #
# AdamW                                                                 #
# --------------------------------------------------------------------- #

def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay=0.1, state_dtype=torch.float32) -> Optimizer:
    """AdamW with decoupled weight decay (a scalar or a per-leaf scale
    tree).  ``state_dtype=torch.bfloat16`` stores m and v in bf16 (half
    the optimizer memory); the moment math stays float32 and its results
    are rounded to the state dtype on the way out."""
    state_dtype = _dtype(state_dtype)
    decoupled = hyper_on(weight_decay)

    def init(params):
        return {"count": _count0(params),
                "m": tree_zeros_like(params, state_dtype),
                "v": tree_zeros_like(params, state_dtype)}

    def update(grads, state, params, lr, reduce=None):
        # elementwise: a rank's share updates alone (``reduce`` unused)
        c = state["count"] + 1
        cf = c.float()
        bc1 = 1.0 - torch.pow(_f32(b1, cf), cf)
        bc2 = 1.0 - torch.pow(_f32(b2, cf), cf)

        def leaf(g, m, v, p, l, wd):
            gf = g.float()
            m32 = b1 * m.float() + (1 - b1) * gf
            v32 = b2 * v.float() + (1 - b2) * gf * gf
            step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
            if wd is not None:
                step = step + wd * p.float()
            return -l * step, m32.to(state_dtype), v32.to(state_dtype)

        flat_g = tree_leaves(grads)
        flat_wd = (tree_leaves(broadcast_scale(weight_decay, grads,
                                               "weight_decay"))
                   if decoupled else [None] * len(flat_g))
        out = [leaf(*a) for a in zip(
            flat_g, tree_leaves(state["m"]), tree_leaves(state["v"]),
            tree_leaves(params), tree_leaves(broadcast_lr(lr, grads)),
            flat_wd)]
        return (tree_unflatten(grads, [o[0] for o in out]),
                {"count": c,
                 "m": tree_unflatten(grads, [o[1] for o in out]),
                 "v": tree_unflatten(grads, [o[2] for o in out])})

    return Optimizer(init, update)


# --------------------------------------------------------------------- #
# Adafactor (factored v, bf16 momentum)                                 #
# --------------------------------------------------------------------- #

def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 2 and shape[-2] >= 2


def is_state_leaf(x) -> bool:
    """An adafactor per-parameter state dict ``{"v" | "v_row" + "v_col"
    [, "m"]}``: one leaf of ``state["leaves"]`` (JAX's ``is_state_leaf``)."""
    return isinstance(x, dict) and ("v" in x or "v_row" in x)


def adafactor(b2: float = 0.99, eps: float = 1e-30, momentum: float = 0.9,
              momentum_dtype=torch.bfloat16, weight_decay=0.0,
              clip_threshold: float = 1.0) -> Optimizer:
    """Adafactor: a leaf of rank ≥ 2 whose two trailing dims are ≥ 2 keeps
    its second moment factored, ``v_row`` over ``shape[:-1]`` and
    ``v_col`` over ``shape[:-2] + shape[-1:]``; any other leaf a plain
    ``v``.  The update is ``g · rsqrt(v̂)``, clipped to an RMS of at most
    ``clip_threshold`` over the whole leaf, then averaged into a momentum
    stored in ``momentum_dtype`` (bf16; the update uses the float32 value
    before rounding).  ``weight_decay`` may be a scalar or a per-leaf
    scale tree, like :func:`adamw`; ``momentum`` is a scalar.

    ``update(..., reduce=)`` updates a rank's share of a population
    (``distributed.sharding.PopulationReduce``): the statistics the
    reference takes over a member axis (``v_col`` of ``w_in`` and
    ``b_out``, ``v_row`` of ``w_out``, the means of ``v_row`` of ``w_in``
    and ``b_out``) and every leaf's update RMS are summed over the ranks
    and divided by the whole layout's counts, fillers included, as the
    reference's padded run computes them; the rest stays local.  The
    state must be the rank's share of the whole layout's state (a leaf is
    factored by its whole shape)."""
    momentum_dtype = _dtype(momentum_dtype)
    decoupled = hyper_on(weight_decay)

    def init(params):
        def leaf(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if _factored(p.shape):
                st = {"v_row": torch.zeros(p.shape[:-1], **f32),
                      "v_col": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                           **f32)}
            else:
                st = {"v": torch.zeros(p.shape, **f32)}
            if momentum:
                st["m"] = torch.zeros(p.shape, dtype=momentum_dtype,
                                      device=p.device)
            return st
        return {"count": _count0(params), "leaves": tree_map(leaf, params)}

    def update(grads, state, params, lr, reduce=None):
        c = state["count"] + 1
        if reduce is not None:
            return _adafactor_sharded(grads, state, params, lr, reduce, c)

        def leaf(g, st, p, l, wd):
            gf = g.float()
            g2 = gf * gf + eps
            new_st = {}
            if "v" in st:
                v = b2 * st["v"] + (1 - b2) * g2
                u = gf * torch.rsqrt(v + eps)
                new_st["v"] = v
            else:
                v_row = b2 * st["v_row"] + (1 - b2) * g2.mean(-1)
                v_col = b2 * st["v_col"] + (1 - b2) * g2.mean(-2)
                r = v_row / torch.clamp(v_row.mean(-1, keepdim=True),
                                        min=eps)
                u = gf * torch.rsqrt(r[..., None] * v_col[..., None, :]
                                     + eps)
                new_st["v_row"], new_st["v_col"] = v_row, v_col
            u_rms = torch.sqrt(torch.mean(u * u) + 1e-30)
            u = u / torch.clamp(u_rms / clip_threshold, min=1.0)
            if momentum:
                m = momentum * st["m"].float() + (1 - momentum) * u
                new_st["m"] = m.to(momentum_dtype)
                u = m
            if wd is not None:
                u = u + wd * p.float()
            return -l * u, new_st

        flat_g = tree_leaves(grads)
        flat_wd = (tree_leaves(broadcast_scale(weight_decay, grads,
                                               "weight_decay"))
                   if decoupled else [None] * len(flat_g))
        out = [leaf(*a) for a in zip(
            flat_g, tree_leaves(state["leaves"], is_leaf=is_state_leaf),
            tree_leaves(params), tree_leaves(broadcast_lr(lr, grads)),
            flat_wd)]
        return (tree_unflatten(grads, [o[0] for o in out]),
                {"count": c,
                 "leaves": tree_unflatten(grads, [o[1] for o in out])})

    def _adafactor_sharded(grads, state, params, lr, reduce, c):
        """``update`` on a rank's share: two sums over the ranks a step,
        the member-axis statistics, then every leaf's update RMS."""
        flat_g = [g.float() for g in tree_leaves(grads)]
        flat_st = tree_leaves(state["leaves"], is_leaf=is_state_leaf)
        flat_p = tree_leaves(params)
        flat_l = tree_leaves(broadcast_lr(lr, grads))
        flat_wd = (tree_leaves(broadcast_scale(weight_decay, grads,
                                               "weight_decay"))
                   if decoupled else [None] * len(flat_g))
        kinds = reduce.leaf_kinds
        g2s = [g * g + eps for g in flat_g]
        # 1. the member-axis sums: w_in's column sums and v_row sum, w_out's
        # row sums, b_out's column sums and v_row sum
        new_st = [{} for _ in flat_g]
        parts = []
        for i, (g2, st) in enumerate(zip(g2s, flat_st)):
            if "v" in st:
                new_st[i]["v"] = b2 * st["v"] + (1 - b2) * g2
                continue
            if kinds[i] in ("w_in", "b_out"):
                v_row = b2 * st["v_row"] + (1 - b2) * g2.mean(-1)
                new_st[i]["v_row"] = v_row
                parts += [g2.sum(-2), v_row.sum()[None]]
            elif kinds[i] == "w_out":
                new_st[i]["v_col"] = (b2 * st["v_col"]
                                      + (1 - b2) * g2.mean(-2))
                parts.append(g2.sum(-1))
            else:                     # a bucket stack: within its members
                new_st[i]["v_row"] = (b2 * st["v_row"]
                                      + (1 - b2) * g2.mean(-1))
                new_st[i]["v_col"] = (b2 * st["v_col"]
                                      + (1 - b2) * g2.mean(-2))
        sums = reduce.sum(torch.cat(parts)) if parts else None
        off = 0
        us = []
        for i, (g, st) in enumerate(zip(flat_g, flat_st)):
            ns = new_st[i]
            if "v" in st:
                us.append(g * torch.rsqrt(ns["v"] + eps))
                continue
            if kinds[i] in ("w_in", "b_out"):
                n = g.shape[-1]
                col, row_sum = sums[off:off + n], sums[off + n]
                off += n + 1
                extent = reduce.member_extent[kinds[i]]
                ns["v_col"] = b2 * st["v_col"] + (1 - b2) * (col / extent)
                row_mean = torch.clamp(row_sum / extent, min=eps)
            elif kinds[i] == "w_out":
                n = g.shape[0]
                row = sums[off:off + n]
                off += n
                ns["v_row"] = (b2 * st["v_row"] + (1 - b2)
                               * (row / reduce.member_extent["w_out"]))
                row_mean = torch.clamp(ns["v_row"].mean(-1, keepdim=True),
                                       min=eps)
            else:
                row_mean = torch.clamp(ns["v_row"].mean(-1, keepdim=True),
                                       min=eps)
            r = ns["v_row"] / row_mean
            us.append(g * torch.rsqrt(r[..., None] * ns["v_col"][..., None, :]
                                      + eps))
        # 2. every leaf's update RMS over the whole layout's leaf
        rms = reduce.leaf_sums([torch.sum(u * u) for u in us])
        out = []
        for i, (u, st, p, l, wd) in enumerate(zip(us, flat_st, flat_p, flat_l,
                                                 flat_wd)):
            u_rms = torch.sqrt(rms[i] / reduce.leaf_numel[i] + 1e-30)
            u = u / torch.clamp(u_rms / clip_threshold, min=1.0)
            if momentum:
                m = momentum * st["m"].float() + (1 - momentum) * u
                new_st[i]["m"] = m.to(momentum_dtype)
                u = m
            if wd is not None:
                u = u + wd * p.float()
            out.append(-l * u)
        return (tree_unflatten(grads, out),
                {"count": c,
                 "leaves": tree_unflatten(grads, new_st)})

    return Optimizer(init, update)


OPTIMIZERS = {"sgd": sgd, "adamw": adamw, "adafactor": adafactor}


def make_optimizer(name: str, **kw) -> Optimizer:
    return OPTIMIZERS[name](**kw)


def build_optimizer(arch) -> Optimizer:
    """An ``ArchSpec``'s optimizer: its ``optimizer`` with its
    ``optimizer_kwargs()``, each ``*dtype`` string as a torch dtype (the
    JAX package's ``repro/launch/cells.py::build_optimizer``)."""
    kw = arch.optimizer_kwargs()
    for k, v in kw.items():
        if isinstance(v, str) and k.endswith("dtype"):
            kw[k] = _dtype(v)
    return make_optimizer(arch.optimizer, **kw)


def apply_updates(params, updates):
    """params + updates (float32 updates)."""
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params,
                    updates)


def scale_member_moments(state, ref, scale_tree):
    """Multiply every params-shaped moment of an optimizer state by a
    params-structured tree of masks or scales, each broadcastable against
    its parameter along the member-major axes (numpy arrays or tensors):
    sgd ``mu``, adamw ``m`` and ``v``; of an adafactor state, each
    parameter's ``m`` and unfactored ``v``, while the factored
    ``v_row``/``v_col`` statistics mix members along their reduced axis
    and pass through untouched (stale; they re-warm in ~1/(1−b2) steps).
    Scalar leaves (step counts) pass through and each moment keeps its
    dtype.  The in-place twin of re-initialising members' moments
    (``lifecycle.refill_state``).  ``ref``: the params tree (live or
    ``abstract_params``) of the current layout."""
    def scale_leaf(mom, mk):
        return mom * torch.as_tensor(mk, dtype=mom.dtype, device=mom.device)

    if isinstance(state, dict) and "leaves" in state:       # adafactor
        flat_st = tree_leaves(state["leaves"], is_leaf=is_state_leaf)
        flat_mk = tree_leaves(scale_tree)
        if len(flat_mk) != len(flat_st):
            raise ValueError("scale_member_moments: scale tree does not "
                             "match the adafactor state's param structure")
        out = []
        for st, mk in zip(flat_st, flat_mk):
            new = dict(st)
            for key in ("v", "m"):
                if key in st:
                    new[key] = scale_leaf(st[key], mk)
            out.append(new)
        return {**state, "leaves": tree_unflatten(
            state["leaves"], out, is_leaf=is_state_leaf)}
    from repro_torch.core.deep import map_params_subtrees
    return map_params_subtrees(
        state, ref, lambda node: tree_map(scale_leaf, node, scale_tree),
        op="scale_member_moments")


# --------------------------------------------------------------------- #
# LR schedules: step → float32 multiplier (a 0-d tensor on the CPU)     #
# --------------------------------------------------------------------- #

def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    """Linear warm-up over ``warmup_steps``, then cosine decay to
    ``min_ratio`` of the peak at ``total_steps`` — float32 arithmetic, as
    the JAX package's schedule computes it."""
    def lr(step):
        s = torch.as_tensor(step, dtype=torch.float32)
        warm = s / max(warmup_steps, 1)
        prog = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return peak_lr * torch.where(s < warmup_steps, warm, cos)
    return lr


def constant_lr(value: float):
    return lambda step: torch.as_tensor(value, dtype=torch.float32)


SCHEDULES = {"warmup_cosine": warmup_cosine, "constant": constant_lr}
