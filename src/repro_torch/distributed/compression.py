"""Gradient compression for a slow all-reduce: int8 with error feedback
(the JAX package's ``repro.distributed.compression``).

A data axis that crosses a slow link (the JAX package's cross-pod 'pod'
axis) reduces gradients at a fraction of the in-node bandwidth.  Each
rank quantizes its gradient plus the residual it carried from the last
step to int8 on one symmetric scale, the int8 values are summed as int32
over the ranks, and the residual of this step's quantization is carried
into the next:

    q      = round(clip(g + err, ±s·127) / s)        s = max|g+err| / 127
    g_hat  = Σq · (Σs / n) / n                        (int8 on the wire)
    err'   = (g + err) - q·s                          (local residual)

The arithmetic is JAX's, on the port's own scale helpers
(``repro_torch.quant``), so ``quantize_int8`` is bitwise the JAX
package's.  Its only caller in the JAX package is the LM trainer's
``--compress-grads`` (ROADMAP.md, Queue 1 item 9); no population path
calls it.
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.quant import dequantize, quantize, symmetric_scale


def quantize_int8(g: torch.Tensor, err: torch.Tensor) -> tuple:
    """``(q int8, scale f32 0-d, new_err f32)`` of ``g + err``."""
    gf = g.to(torch.float32) + err
    scale = symmetric_scale(gf)
    q = quantize(gf, scale)
    new_err = gf - dequantize(q, scale)
    return q, scale, new_err


def compressed_all_reduce(g: torch.Tensor, err: torch.Tensor,
                          group=None) -> tuple:
    """The int8 all-reduce of ``g`` over the ranks of ``group`` (the
    world when None) with error feedback → ``(g_hat, new_err)``: ``g_hat``
    the ranks' mean of ``g`` rebuilt from the int32 sum of their int8
    values and their mean scale, in ``g``'s dtype; ``new_err`` this rank's
    residual.  Two collectives: the int32 sum, and one f32 pair (the sum
    of the scales, the count of ranks)."""
    import torch.distributed as dist
    q, scale, new_err = quantize_int8(g, err)
    qsum = q.to(torch.int32)
    dist.all_reduce(qsum, op=dist.ReduceOp.SUM, group=group)
    sn = torch.stack([scale, torch.ones((), dtype=torch.float32,
                                        device=scale.device)])
    dist.all_reduce(sn, op=dist.ReduceOp.SUM, group=group)
    ssum, n = sn[0], sn[1]
    # each rank contributed q_i·s_i ≈ g_i: the mean rebuilt with the mean
    # scale (unbiased when the scales are alike; the residual absorbs the
    # rest)
    g_hat = qsum.to(torch.float32) * (ssum / n) / n
    return g_hat.to(g.dtype), new_err


def compressed_all_reduce_tree(grads, err_tree, group=None) -> tuple:
    """``compressed_all_reduce`` leaf by leaf → ``(g_hat tree, new_err
    tree)``."""
    out = [compressed_all_reduce(g, e, group)
           for g, e in zip(tree_leaves(grads), tree_leaves(err_tree))]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))


def init_error_feedback(params):
    """A zero f32 residual for every leaf of ``params``, on its device."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
