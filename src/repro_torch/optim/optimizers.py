"""Optimizers — functional, over parameter trees (nested dicts and lists of
tensors), with the JAX package's update rules and state trees.

  * ``sgd``    — momentum optional; the paper trains with plain SGD.
  * ``adamw``  — decoupled weight decay.

API: ``Optimizer(init, update)``.
  init(params) -> state
  update(grads, state, params, lr) -> (updates, new_state)   # updates: deltas

The state trees keep the JAX package's keys (``count``, ``mu``, ``m``,
``v``), so a checkpointed state moves between the two packages.

``lr`` may be a scalar OR a tree of per-leaf scale tensors matching the
parameter tree (broadcastable against each leaf) — how per-member learning
rates reach fused populations: ``core.deep.member_lr_tree`` expands a (P,)
vector into such a tree.  SGD's ``momentum`` and AdamW's ``weight_decay``
take a scalar or such a tree the same way.

Not ported yet (ROADMAP.md): ``adafactor`` and a bfloat16 state dtype; both
raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.core.tree import (tree_leaves, tree_map, tree_structure,
                                   tree_unflatten)

_NOT_YET = "is not ported yet (ROADMAP.md, Queue 1)"


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    """A scalar hyperparameter as a float32 tensor on ``like``'s device, so
    every product is computed in float32 as the JAX package computes it."""
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def tree_zeros_like(tree, dtype=None):
    return tree_map(lambda x: torch.zeros_like(x, dtype=dtype or x.dtype),
                    tree)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """→ (grads scaled to a global norm of at most ``max_norm``, the norm
    before clipping)."""
    norm = global_norm(grads)
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

    def update(grads, state, params, lr):
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
    tree).  Moments are float32; a bfloat16 state is not ported yet."""
    if state_dtype not in (torch.float32, "float32"):
        raise NotImplementedError(f"adamw state_dtype={state_dtype!r} "
                                  + _NOT_YET)
    decoupled = hyper_on(weight_decay)

    def init(params):
        return {"count": _count0(params),
                "m": tree_zeros_like(params, torch.float32),
                "v": tree_zeros_like(params, torch.float32)}

    def update(grads, state, params, lr):
        c = state["count"] + 1
        cf = c.float()
        bc1 = 1.0 - torch.pow(_f32(b1, cf), cf)
        bc2 = 1.0 - torch.pow(_f32(b2, cf), cf)

        def leaf(g, m, v, p, l, wd):
            gf = g.float()
            m32 = b1 * m + (1 - b1) * gf
            v32 = b2 * v + (1 - b2) * gf * gf
            step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
            if wd is not None:
                step = step + wd * p.float()
            return -l * step, m32, v32

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


def adafactor(*args, **kwargs) -> Optimizer:
    raise NotImplementedError("the adafactor optimizer " + _NOT_YET)


OPTIMIZERS = {"sgd": sgd, "adamw": adamw, "adafactor": adafactor}


def make_optimizer(name: str, **kw) -> Optimizer:
    return OPTIMIZERS[name](**kw)


def apply_updates(params, updates):
    """params + updates (float32 updates)."""
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params,
                    updates)


def scale_member_moments(state, ref, scale_tree):
    """Multiply every params-shaped moment of an optimizer state (sgd
    ``mu``, adamw ``m`` and ``v``) by a params-structured tree of masks or
    scales, each broadcastable against its parameter along the
    member-major axes (numpy arrays or tensors); scalar leaves (step
    counts) pass through and each moment keeps its dtype.  The in-place
    twin of re-initialising members' moments
    (``lifecycle.refill_state``).  ``ref``: the params tree (live or
    ``abstract_params``) of the current layout."""
    if isinstance(state, dict) and "leaves" in state:
        raise NotImplementedError(
            "scale_member_moments of an adafactor state: the adafactor "
            f"optimizer {_NOT_YET}, item 2)")
    from repro_torch.core.deep import map_params_subtrees

    def scale_leaf(mom, mk):
        return mom * torch.as_tensor(mk, dtype=mom.dtype, device=mom.device)

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
