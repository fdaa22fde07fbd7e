"""Parameter and optimizer-state trees: nested dicts and lists of tensors.

Leaves are visited in the JAX package's order — dict keys sorted, list
items in order — so a flattened tree lines up with ``jax.tree.leaves`` of
the same tree and with the checkpoint's key order.  ``is_leaf`` (a
predicate on nodes, as ``jax.tree.leaves(..., is_leaf=...)`` takes) stops
the walk at a node and treats it as one leaf: adafactor's per-parameter
state dicts are walked so.
"""
from __future__ import annotations


def tree_leaves(tree, is_leaf=None) -> list:
    """Every leaf of ``tree``, in JAX's flattening order."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v, is_leaf)]
    return [tree]


def tree_unflatten(like, leaves, is_leaf=None) -> object:
    """A tree shaped like ``like`` holding ``leaves`` (in ``tree_leaves``
    order, with the same ``is_leaf``)."""
    it = iter(leaves)

    def build(node):
        if is_leaf is not None and is_leaf(node):
            return next(it)
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the tree holds")
    return out


def tree_structure(tree) -> object:
    """The shape of a tree without its leaves (comparable with ``==``)."""
    if isinstance(tree, dict):
        return {k: tree_structure(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_structure(v) for v in tree]
    return None


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` applied leaf by leaf over trees of one structure (``is_leaf``
    applies to every tree)."""
    flat = [tree_leaves(t, is_leaf) for t in (tree, *rest)]
    if any(len(f) != len(flat[0]) for f in flat[1:]):
        raise ValueError("tree_map: trees of different structure")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*flat)], is_leaf)
