"""Layered ParallelMLPs — the population engine: serving and training.

A ``LayeredPopulation`` runs as one fused network:

  * layer 0:        dense fused matmul (H0 × F) + bias + per-member
                    activation + padding mask;
  * layers 1..L-1:  BLOCK-DIAGONAL projections (member m's units in layer
                    l+1 contract only member m's units in layer l);
  * output layer:   the paper's M3 + per-member bias.

With ``bd_impl="fused"`` each stage is ONE hand-written CUDA kernel per
direction (``kernels/ops.py``): serving (``forward(infer=True)``) costs
exactly ``depth + 1`` launches — the fused input layer, one fused mid layer
per projection and the infer head — and a training step (``fused_loss``
and its gradient) exactly ``2·(depth + 1)``: the same stages with g' in
their epilogues, the fused loss head, and one backward launch each.
``bd_impl="einsum"`` with ``head_impl="xla"`` / ``loss_impl="xla"`` is the
plain PyTorch path, differentiated by autograd.  ``bd_impl="pallas"`` with
``act_impl="pallas"`` is the unfused route over hand-written kernels: each
mid layer is a bare block-diagonal GEMM kernel, the gated bias as a tensor
op, then the segmented-activation kernel (the input layer: a plain matmul,
then the same activation kernel), each differentiable through its own
backward kernels — ``depth`` + ``depth − 1`` launches a forward
(``launch_count.unfused_infer_launches``).

Members never mix: every parameter belongs to exactly one member, so
per-member learning rates (and any per-member optimizer hyperparameter)
are a broadcast (``member_lr_tree``), and the optimizer engine
(``opt_step``, ``make_population_train_step``) trains each member exactly
as it would train alone.

Parameters are a dict tree with the JAX package's layout:
``w_in (H0, F)``, ``b_in (H0,)``, ``mid[l] = {"w": [per-bucket
(n, hout, hin)], "b": (H_{l+1},)}``, ``w_out (O, H_last)``,
``b_out (P, O)``; ``params_from_numpy`` carries a JAX-trained tree in.

Serving also runs over the int8 serve copy (``quant.quantize_population``,
``forward(infer=True, weights_dtype="int8")``): the same depth+1 launches,
each an int8-weight twin of its f32 kernel that dequantizes inside its tile
loop.  ``qparams_from_numpy`` carries the JAX package's int8 tree in.

``compute_dtype="bfloat16"`` is the mixed-precision policy (DESIGN.md §7),
with the JAX package's rounding points: the matmul OPERANDS (activations
and weights) are cast to bf16 at every projection boundary, the kernels
(or the plain route's matmuls) sum in f32, and the biases, the head's
logits after the bias, the loss, the f32 master parameters and their
gradients stay f32.  On the fused route every launch is the kernel's bf16
instance (the same depth+1 and 2·(depth+1) launches); on the unfused
route (``bd_impl="pallas"``) each mid layer's projection is the
block-diagonal kernel's bf16 instance, whose bf16 output plus the f32
bias hands the segmented activation f32, and the ``m3_impl="pallas"``
head is the M3 kernels' bf16 instances (bf16 logits, widened before the
bias); over the int8 copy x and h are cast to bf16 before each int8
kernel, which then runs its bf16-activation instance; the plain route
(``bd_impl="einsum"``, any other ``m3_impl``, any ``act_impl``) runs it
in plain PyTorch.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.activations import (ACTIVATIONS,
                                          apply_activations_masked,
                                          apply_activations_sliced)
from repro_torch.core.m3 import (HEAD_IMPLS, LOSS_IMPLS, acc_dtype, m3,
                                 m3_infer_head, m3_infer_head_int8,
                                 m3_loss_head)
from repro_torch.core.population import LayeredPopulation
from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.device import layout_tensor as _static
from repro_torch.quant import abstract_qparams

# ---------------------------------------------------------------------- #
# block-diagonal mid-layer projection                                    #
# ---------------------------------------------------------------------- #

def block_diag_einsum(h: torch.Tensor, w_buckets, lp: LayeredPopulation,
                      l: int) -> torch.Tensor:
    """h (B, H_l) → (B, H_{l+1}) as one batched einsum per bucket;
    pass-through buckets are slice copies.  Sums in f32 whatever the
    operands' dtype and returns h's (JAX: ``preferred_element_type`` f32,
    then ``astype(h.dtype)``)."""
    b = h.shape[0]
    acc = acc_dtype(h)
    outs = []
    wi = 0
    for (m0, n, hin, hout, off_in, off_out, real) in lp.proj_buckets(l):
        if real:
            hh = h[:, off_in: off_in + n * hin].reshape(b, n, hin)
            outs.append(torch.einsum("bnh,noh->bno", hh.to(acc),
                                     w_buckets[wi].to(acc))
                        .to(h.dtype).reshape(b, n * hout))
            wi += 1
        else:
            outs.append(h[:, off_in: off_in + n * hin])
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)


def pack_weight_tiles(w_buckets, lp: LayeredPopulation, l: int
                      ) -> torch.Tensor:
    """Per-bucket (n, hout, hin) arrays → the flat (n_param_blocks, blk, blk)
    tile array of ``lp.bd_layout(l)`` (member-major, row-major over each
    member's tile grid)."""
    blk = lp.block
    tiles = []
    wi = 0
    for (m0, n, hin, hout, off_in, off_out, real) in lp.proj_buckets(l):
        if not real:
            continue
        w = w_buckets[wi]
        wi += 1
        ob, ib = hout // blk, hin // blk
        tiles.append(w.reshape(n, ob, blk, ib, blk)
                     .permute(0, 1, 3, 2, 4)
                     .reshape(n * ob * ib, blk, blk))
    return torch.cat(tiles, dim=0)


def block_diag_pallas(h: torch.Tensor, w_buckets, lp: LayeredPopulation,
                      l: int) -> torch.Tensor:
    """The bare projection through the block-diagonal GEMM kernel, with its
    two-launch backward (``ops.block_diag_gemm``); callers add the bias and
    run ``_act``."""
    from repro_torch.kernels.ops import block_diag_gemm
    return block_diag_gemm(h, pack_weight_tiles(w_buckets, lp, l),
                           lp.bd_layout(l))


def block_diag_fused(h: torch.Tensor, w_buckets, lp: LayeredPopulation,
                     l: int, *, bias: torch.Tensor) -> torch.Tensor:
    """FUSED mid layer: projection + pass-through-gated bias + per-tile
    activation + padding mask in one kernel launch, with a one-launch
    backward (``ops.fused_layer``; without a gradient to take it runs the
    serving kernel) — returns layer l+1's ACTIVATIONS (callers skip the
    bias add and ``_act``).  The bias stays f32; the packed tiles follow
    h's dtype (JAX: ``wb.astype(h.dtype)``)."""
    from repro_torch.kernels.ops import fused_layer
    dev = h.device
    pout = lp.layer_pop(l + 1)
    b_eff = bias * _static(lp, ("active", l + 1), dev,
                           lp.active_unit_mask(l + 1), torch.float32)
    return fused_layer(
        h, pack_weight_tiles(w_buckets, lp, l).to(h.dtype), b_eff,
        lp.bd_layout(l),
        _static(lp, ("block_act", l + 1), dev, pout.block_act_ids,
                torch.int32),
        _static(lp, ("mask", l + 1), dev, pout.hidden_mask, torch.float32))


def block_diag_fused_infer_int8(h: torch.Tensor, qlayer: dict,
                                lp: LayeredPopulation, l: int
                                ) -> torch.Tensor:
    """The fused mid layer over the int8 serve copy: ``qlayer`` is one
    ``quantize_population`` mid entry — the packed, identity-augmented int8
    tiles, their f32 scales and the f32 bias — so nothing is packed or
    appended per call; the kernel dequantizes per step.  Forward only."""
    from repro_torch.kernels.ops import fused_layer_infer_int8
    dev = h.device
    pout = lp.layer_pop(l + 1)
    b_eff = qlayer["b"] * _static(lp, ("active", l + 1), dev,
                                  lp.active_unit_mask(l + 1), torch.float32)
    return fused_layer_infer_int8(
        h, qlayer["wb"], qlayer["scale"], b_eff, lp.bd_layout(l),
        _static(lp, ("block_act", l + 1), dev, pout.block_act_ids,
                torch.int32),
        _static(lp, ("mask", l + 1), dev, pout.hidden_mask, torch.float32))


BD_IMPLS = {
    "einsum": block_diag_einsum,
    "pallas": block_diag_pallas,
    "fused": block_diag_fused,
}
# impls whose kernel epilogue already applies bias + activation + mask
FUSED_BD_IMPLS = frozenset(["fused"])


# ---------------------------------------------------------------------- #
# input-layer projection                                                 #
# ---------------------------------------------------------------------- #

def input_xla(x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor,
              lp: LayeredPopulation, act_impl: str = "sliced"
              ) -> torch.Tensor:
    """Input projection as a plain matmul (summed in f32: bf16 operands are
    widened, as JAX's ``preferred_element_type`` f32) + bias + the
    per-layer ``_act``."""
    acc = acc_dtype(x)
    return _act(lp, 0, x.to(acc) @ w_in.to(acc).t() + b_in, act_impl)


def input_fused(x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor,
                lp: LayeredPopulation, act_impl: str = "sliced"
                ) -> torch.Tensor:
    """FUSED input layer: dense GEMM + bias + per-block activation +
    padding mask in one kernel launch, with a one-launch backward
    (``ops.fused_input``; without a gradient to take it runs the serving
    kernel).  ``act_impl`` is ignored: the epilogue IS the activation."""
    from repro_torch.kernels.ops import fused_input
    dev = x.device
    p0 = lp.layer_pop(0)
    return fused_input(
        x, w_in, b_in,
        _static(lp, ("block_act", 0), dev, p0.block_act_ids, torch.int32),
        _static(lp, ("mask", 0), dev, p0.hidden_mask, torch.float32),
        block=lp.block)


def input_fused_infer_int8(x: torch.Tensor, w_q: torch.Tensor,
                           w_scale: torch.Tensor, b_in: torch.Tensor,
                           lp: LayeredPopulation) -> torch.Tensor:
    """The fused input layer over the int8 serve copy: the pre-padded int8
    weight and its per-row-block scales, dequantized inside the kernel.
    Forward only."""
    from repro_torch.kernels.ops import fused_input_infer_int8
    dev = x.device
    p0 = lp.layer_pop(0)
    return fused_input_infer_int8(
        x, w_q, w_scale, b_in,
        _static(lp, ("block_act", 0), dev, p0.block_act_ids, torch.int32),
        _static(lp, ("mask", 0), dev, p0.hidden_mask, torch.float32),
        block=lp.block)


IN_IMPLS = {
    "xla": input_xla,
    "fused": input_fused,
}
FUSED_IN_IMPLS = frozenset(["fused"])


def _resolve_in_impl(in_impl, bd_impl: str) -> str:
    """``None`` follows the mid layers: a fused ``bd_impl`` gets the fused
    input kernel, anything else the plain matmul."""
    if in_impl is None:
        return "fused" if bd_impl in FUSED_BD_IMPLS else "xla"
    if in_impl not in IN_IMPLS:
        raise ValueError(f"unknown in_impl {in_impl!r} "
                         f"(have {sorted(IN_IMPLS)})")
    return in_impl


# ---------------------------------------------------------------------- #
# parameters                                                             #
# ---------------------------------------------------------------------- #

def abstract_params(lp: LayeredPopulation, dtype=torch.float32) -> dict:
    """The tree of ``init_params(lp)`` as meta tensors — shapes and dtype,
    no storage (checkpoint restore, shape checks)."""
    def meta(*shape):
        return torch.empty(shape, dtype=dtype, device="meta")

    p0 = lp.layer_pop(0)
    mid = []
    for l in range(lp.depth - 1):
        mid.append({
            "w": [meta(n, hout, hin) for (m0, n, hin, hout, *_r, real)
                  in lp.proj_buckets(l) if real],
            "b": meta(lp.layer_pop(l + 1).total_hidden)})
    return {"w_in": meta(p0.total_hidden, lp.in_features),
            "b_in": meta(p0.total_hidden), "mid": mid,
            "w_out": meta(lp.out_features,
                          lp.layer_pop(lp.depth - 1).total_hidden),
            "b_out": meta(lp.num_members, lp.out_features)}


def init_params(generator: torch.Generator, lp: LayeredPopulation,
                dtype=torch.float32) -> dict:
    """torch.nn.Linear-style init (U(±1/√fan_in), per-member fan-in) on
    ``generator``'s device.  The distribution is the JAX package's; the
    numbers are not (torch's generator is not threefry).  Pass-through
    bias slices are zero."""
    dev = generator.device

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=dev, dtype=dtype)
        return u * (hi - lo) + lo

    def col(a):
        return torch.as_tensor(np.asarray(a, np.float32), dtype=dtype,
                               device=dev)

    p0 = lp.layer_pop(0)
    bound = 1.0 / np.sqrt(lp.in_features)
    params = {"w_in": uniform((p0.total_hidden, lp.in_features), -bound,
                              bound),
              "b_in": uniform((p0.total_hidden,), -bound, bound),
              "mid": []}
    for l in range(lp.depth - 1):
        pout = lp.layer_pop(l + 1)
        wl = []
        for (m0, n, hin, hout, off_in, off_out, real) in lp.proj_buckets(l):
            if not real:
                continue
            fan = np.array([lp.layer_width(m, l) for m in range(m0, m0 + n)],
                           np.float32)
            wl.append(uniform((n, hout, hin), -1.0, 1.0)
                      * col(1.0 / np.sqrt(fan))[:, None, None])
        fan_unit = np.repeat(
            np.array([lp.layer_width(m, l) for m in range(lp.num_members)],
                     np.float32), pout.padded_sizes)
        params["mid"].append({
            "w": wl,
            "b": uniform((pout.total_hidden,), -1.0, 1.0)
            * col(lp.active_unit_mask(l + 1) / np.sqrt(fan_unit))})
    plast = lp.layer_pop(lp.depth - 1)
    last = np.array([w[-1] for w in lp.widths], np.float32)
    params["w_out"] = (uniform((lp.out_features, plast.total_hidden), -1.0,
                               1.0)
                       * col(1.0 / np.sqrt(np.repeat(
                           last, plast.padded_sizes)))[None, :])
    params["b_out"] = (uniform((lp.num_members, lp.out_features), -1.0, 1.0)
                       * col(1.0 / np.sqrt(last))[:, None])
    return params


def _fill_layout(lp: LayeredPopulation,
                 lp_pad: LayeredPopulation) -> LayeredPopulation:
    """The filler-members-only layout of a ``lp.shard_pad(n)`` extension
    (validated: pads are trailing and the real prefix is untouched)."""
    if (lp_pad.num_real != lp.num_members
            or lp_pad.widths[:lp.num_members] != lp.widths
            or lp_pad.depth != lp.depth):
        raise ValueError("lp_pad is not a shard-padded extension of lp")
    return LayeredPopulation(
        lp.in_features, lp.out_features,
        lp_pad.widths[lp_pad.num_real:],
        lp_pad.activations[lp_pad.num_real:], block=lp.block)


def _concat_pad(params: dict, fp: dict, depth: int) -> dict:
    """Append a filler-members tree ``fp`` behind ``params`` on every
    member-major axis (the trailing-pad embedding of ``pad_params`` and
    ``pad_state``)."""
    return {
        "w_in": torch.cat([params["w_in"], fp["w_in"]], dim=0),
        "b_in": torch.cat([params["b_in"], fp["b_in"]], dim=0),
        "mid": [{"w": list(params["mid"][l]["w"]) + list(fp["mid"][l]["w"]),
                 "b": torch.cat([params["mid"][l]["b"], fp["mid"][l]["b"]],
                                dim=0)}
                for l in range(depth - 1)],
        "w_out": torch.cat([params["w_out"], fp["w_out"]], dim=1),
        "b_out": torch.cat([params["b_out"], fp["b_out"]], dim=0),
    }


def pad_params(params, lp: LayeredPopulation, lp_pad: LayeredPopulation,
               generator: torch.Generator) -> dict:
    """Embed ``params`` (initialised for ``lp``) into the shard-padded
    layout ``lp_pad = lp.shard_pad(n)``, the filler members' parameters
    drawn from ``generator`` (``init_params`` of the fillers' own layout;
    the trainer seeds it from ``(seed, 1)``, JAX's ``fold_in(key, 1)``).
    Fillers are trailing on every member-major axis and never share a
    bucket with a real member, so the real region of the result is
    ``params`` bit for bit: a run on W ranks initialises its real members
    exactly as a run on one.  ``lp_pad == lp`` returns ``params``."""
    if lp_pad == lp:
        return params
    fill = _fill_layout(lp, lp_pad)
    return _concat_pad(params, init_params(generator, fill,
                                           params["w_in"].dtype), lp.depth)


def zeros_like_abstract(ref, dtype, device) -> dict:
    """A tree of zeros with the shapes of ``ref`` (e.g. ``abstract_params``)
    in ``dtype`` on ``device``."""
    return tree_map(lambda s: torch.zeros(tuple(s.shape), dtype=dtype,
                                          device=device), ref)


def map_params_subtrees(tree, ref, fn, op: str = "map"):
    """Apply ``fn`` to every params-shaped subtree of an optimizer-state
    tree (structure AND leaf shapes matching ``ref``, a live or abstract
    ``init_params`` tree), passing scalar leaves (step counts: 0-dim
    tensors) through.  The one structural rule for moving optimizer state
    through layout changes (``lifecycle.compact``, ``pad_state``,
    ``grow_state``, ``optim.scale_member_moments``).  Anything else
    raises."""
    from repro_torch.core.tree import tree_structure
    p_def = tree_structure(ref)
    p_shapes = [tuple(x.shape) for x in tree_leaves(ref)]

    def params_like(node):
        if not isinstance(node, dict) or tree_structure(node) != p_def:
            return False
        return [tuple(getattr(x, "shape", ()))
                for x in tree_leaves(node)] == p_shapes

    def walk(node, path):
        if params_like(node):
            return fn(node)
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (i,))
                              for i, v in enumerate(node))
        if getattr(node, "ndim", None) == 0 or np.isscalar(node):
            return node
        raise ValueError(
            f"{op}: optimizer-state leaf {'/'.join(map(str, path))} is "
            "neither a scalar nor part of a params-shaped subtree (factored "
            "moments, e.g. adafactor's v_row/v_col, are not compactable "
            "member-major)")

    return walk(tree, ())


def pad_state(opt_state, lp: LayeredPopulation, lp_pad: LayeredPopulation):
    """Embed an optimizer state into the shard-padded layout ``lp_pad``:
    every params-shaped subtree gains ZERO moments for the filler members
    (what a fresh ``opt.init`` gives them), scalar leaves pass through and
    each subtree keeps its dtype.  ``lp_pad == lp`` (one device) returns
    the state as it is."""
    if lp_pad == lp:
        return opt_state
    fill_abs = abstract_params(_fill_layout(lp, lp_pad))

    def pad_sub(node):
        leaf = tree_leaves(node)[0]
        return _concat_pad(node, zeros_like_abstract(fill_abs, leaf.dtype,
                                                     leaf.device), lp.depth)

    return map_params_subtrees(opt_state, abstract_params(lp), pad_sub,
                               op="pad_state")


def grow_state(opt_state, lp: LayeredPopulation, lp_new: LayeredPopulation,
               positions, gather: str = "device"):
    """Splice an optimizer state into a GROWN layout (``lp_new ==
    lp.grow(...)``): the survivors' moments ride through bit for bit
    (``lifecycle.grow_params``), the new members at ``positions`` get ZERO
    moments, as ``opt.init`` gives a newborn.  Scalar leaves pass through;
    each subtree keeps its dtype.  A factored adafactor state raises
    ``ValueError`` (the trainer grows adafactor's carried momentum with
    ``lifecycle.grow_params``)."""
    from repro_torch.core.lifecycle import grow_params
    positions = tuple(int(p) for p in positions)
    fresh_abs = abstract_params(lp_new.subset(tuple(sorted(positions))))

    def grow_sub(node):
        leaf = tree_leaves(node)[0]
        zeros = zeros_like_abstract(fresh_abs, leaf.dtype, leaf.device)
        return grow_params(lp, lp_new, node, positions, zeros, gather=gather)

    return map_params_subtrees(opt_state, abstract_params(lp), grow_sub,
                               op="grow_state")


def _from_numpy(tree, like, device, where: str):
    """A tree of numpy arrays → tensors on ``device`` with the dtypes of
    ``like`` (a tree of meta tensors), every shape checked against it; an
    int8 leaf must arrive as int8."""
    if isinstance(like, dict):
        return {k: _from_numpy(tree[k], v, device, f"{where}{k}/")
                for k, v in like.items()}
    if isinstance(like, list):
        if len(tree) != len(like):
            raise ValueError(f"{where[:-1]}: {len(tree)} entries, the "
                             f"layout has {len(like)}")
        return [_from_numpy(a, b, device, f"{where}{i}/")
                for i, (a, b) in enumerate(zip(tree, like))]
    arr = np.asarray(tree)
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"{where[:-1]}: shape {arr.shape} != "
                         f"{tuple(like.shape)} for this layout")
    if like.dtype == torch.int8 and arr.dtype != np.int8:
        raise ValueError(f"{where[:-1]}: {arr.dtype}, the int8 serve copy "
                         "stores int8")
    return torch.tensor(arr, dtype=like.dtype, device=device)


def params_from_numpy(tree, lp: LayeredPopulation, device="cuda") -> dict:
    """A parameter tree of numpy arrays (e.g. the JAX package's, through
    ``jax.device_get``) → float32 tensors on ``device``, shape-checked
    against ``lp``."""
    return _from_numpy(tree, abstract_params(lp), device, "")


def params_to_numpy(params) -> dict:
    """The inverse of ``params_from_numpy``: every leaf as a numpy array."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to_numpy(v) for v in params]
    return params.detach().cpu().numpy()


def qparams_from_numpy(tree, lp: LayeredPopulation, device="cuda") -> dict:
    """An int8 serve copy of numpy arrays (e.g. the JAX package's
    ``quantize_population`` tree, through ``jax.device_get``) → tensors on
    ``device``, int8 tiles and f32 scales and biases, shape-checked against
    ``lp`` (``quant.abstract_qparams``)."""
    return _from_numpy(tree, abstract_qparams(lp), device, "")


# the inverse of qparams_from_numpy: the same leaf-by-leaf conversion
qparams_to_numpy = params_to_numpy


# ---------------------------------------------------------------------- #
# forward                                                                #
# ---------------------------------------------------------------------- #

def _act(lp: LayeredPopulation, l: int, h: torch.Tensor,
         act_impl: str = "sliced") -> torch.Tensor:
    """Per-layer activation + padding mask: ``sliced`` (one pass per
    contiguous activation run), ``masked`` (branchless select) or
    ``pallas`` (the segmented-activation kernel, mask fused, one launch per
    direction)."""
    pop = lp.layer_pop(l)
    dev = h.device
    if act_impl == "sliced":
        h = apply_activations_sliced(h, pop.act_runs)
    elif act_impl == "masked":
        h = apply_activations_masked(
            h, _static(lp, ("act_ids", l), dev, pop.act_ids, torch.int32))
    elif act_impl == "pallas":
        from repro_torch.kernels.ops import seg_act
        return seg_act(h, _static(lp, ("block_act", l), dev,
                                  pop.block_act_ids, torch.int32),
                       _static(lp, ("mask", l), dev, pop.hidden_mask,
                               torch.float32), block=lp.block)
    else:
        raise ValueError(f"unknown act_impl {act_impl!r}")
    return h * _static(lp, ("mask", l), dev, pop.hidden_mask, torch.float32)


def _resolve_weights_dtype(weights_dtype):
    """None / "float32" → None (weights consumed as stored); "int8" → the
    int8 serve-copy route (params must be a ``quantize_population`` tree).
    Anything else is a ValueError, as in the JAX package: only int8 has
    fused-dequant serving kernels."""
    if weights_dtype in (None, "float32", torch.float32):
        return None
    if weights_dtype in ("int8", torch.int8):
        return "int8"
    raise ValueError(f"unsupported weights_dtype {weights_dtype!r} — only "
                     "'int8' has fused-dequant serving kernels")


def resolve_compute_dtype(compute_dtype):
    """None / "float32" → None (operands as stored, the f32 path);
    "bfloat16" → ``torch.bfloat16``, the dtype operands are cast to.
    Parameters, accumulators, loss and evaluation stay f32 regardless.
    Anything else is a ValueError."""
    if compute_dtype in (None, "float32", torch.float32):
        return None
    if compute_dtype in ("bfloat16", torch.bfloat16):
        return torch.bfloat16
    raise ValueError(f"unsupported compute_dtype {compute_dtype!r} "
                     "(float32 or bfloat16)")


def check_dtypes(compute_dtype=None, weights_dtype=None):
    """Reject an unknown compute or weights dtype (``ValueError``, as the
    JAX package) → the resolved weights dtype (None or "int8").  Every
    combination of the two with any route runs."""
    resolve_compute_dtype(compute_dtype)
    return _resolve_weights_dtype(weights_dtype)


def _caster(compute_dtype):
    """The policy's cast of an operand: bf16, or the identity."""
    cd = resolve_compute_dtype(compute_dtype)
    return (lambda a: a) if cd is None else (lambda a: a.to(cd))


def _hidden_int8(qparams, x, lp: LayeredPopulation, bd_impl: str, in_impl,
                 infer: bool, cast) -> torch.Tensor:
    """The trunk over the int8 serve copy: the fused-dequant input layer
    and one fused-dequant mid layer per projection, each fed its
    activations through the policy's ``cast`` (JAX: ``cast(x)``,
    ``cast(h)``), so under bf16 each runs its bf16-activation instance."""
    if not infer:
        raise ValueError(
            "weights_dtype='int8' is a serving-only path — the quantized "
            "copy is not differentiable; pass infer=True")
    in_impl = _resolve_in_impl(in_impl, bd_impl)
    if bd_impl not in FUSED_BD_IMPLS or in_impl not in FUSED_IN_IMPLS:
        raise ValueError(
            "weights_dtype='int8' needs the fused serving kernels "
            f"(bd_impl='fused'), got bd_impl={bd_impl!r}, "
            f"in_impl={in_impl!r}")
    h = input_fused_infer_int8(cast(x), qparams["w_in"],
                               qparams["w_in_scale"], qparams["b_in"], lp)
    for l in range(lp.depth - 1):
        h = block_diag_fused_infer_int8(cast(h), qparams["mid"][l], lp, l)
    return h


def _hidden(params, x, lp: LayeredPopulation, bd_impl: str = "einsum",
            act_impl: str = "sliced", compute_dtype=None, in_impl=None,
            weights_dtype=None, infer: bool = False) -> torch.Tensor:
    """Input layer + every mid layer → the last hidden activations.  The
    fused impls run their forward-only kernels when no gradient is taken
    (``kernels/ops.py``); ``weights_dtype="int8"`` (with ``infer=True``)
    runs the int8 serve copy through their fused-dequant twins.  Under
    ``compute_dtype="bfloat16"`` x, h and every weight are cast to bf16 at
    each projection (JAX's ``cast``); a fused layer returns bf16
    activations, a plain or unfused one adds its f32 bias to the bf16
    projection (f32)."""
    if bd_impl.endswith("_int8"):
        raise ValueError(f"bd_impl {bd_impl!r} is the weights_dtype='int8' "
                         "route — request it via weights_dtype, not bd_impl")
    cast = _caster(compute_dtype)
    if check_dtypes(compute_dtype, weights_dtype) is not None:
        return _hidden_int8(params, x, lp, bd_impl, in_impl, infer, cast)
    if bd_impl not in BD_IMPLS:
        raise ValueError(f"unknown bd_impl {bd_impl!r} "
                         f"(have {sorted(BD_IMPLS)})")
    in_impl = _resolve_in_impl(in_impl, bd_impl)
    h = IN_IMPLS[in_impl](cast(x), cast(params["w_in"]), params["b_in"], lp,
                          act_impl)
    for l in range(lp.depth - 1):
        hb = cast(h)
        wl = [cast(w) for w in params["mid"][l]["w"]]
        if bd_impl in FUSED_BD_IMPLS:
            h = BD_IMPLS[bd_impl](hb, wl, lp, l, bias=params["mid"][l]["b"])
            continue
        z = BD_IMPLS[bd_impl](hb, wl, lp, l)
        h = z + params["mid"][l]["b"] * _static(
            lp, ("active", l + 1), h.device, lp.active_unit_mask(l + 1),
            torch.float32)
        h = _act(lp, l + 1, h, act_impl)
    return h


def forward(params, x, lp: LayeredPopulation, m3_impl: str = "bucketed",
            bd_impl: str = "einsum", act_impl: str = "sliced",
            compute_dtype=None, in_impl=None, infer: bool = False,
            head_impl=None, log_probs: bool = False, weights_dtype=None
            ) -> torch.Tensor:
    """x (B, F) → logits (B, P, O) — every member an independent deep MLP.

    ``infer=True`` is the serving path: the output projection runs through
    ``head_impl`` (default ``None`` follows ``bd_impl``) — ``"fused"`` is
    the one-launch infer-head kernel with the per-member bias (and, under
    ``log_probs=True``, the log-softmax) in its epilogue, making the whole
    forward exactly depth+1 kernel launches
    (``launch_count.fused_infer_budget``).  ``log_probs=True`` returns
    log-probabilities on every route.

    ``weights_dtype="int8"`` serves the int8 copy (``params`` a
    ``quant.quantize_population`` tree): every projection runs its
    fused-dequant twin and the head ``"fused_int8"``, still depth+1
    launches.  It needs ``infer=True`` and the fused impls;
    ``"fused_int8"`` serves int8 weights and nothing else.

    ``compute_dtype="bfloat16"``: the bf16 policy (module docstring); the
    logits come back f32 (the M3 kernels' bf16 logits widened before the
    bias, as JAX's ``astype(f32)``)."""
    int8 = _resolve_weights_dtype(weights_dtype) is not None
    cast = _caster(compute_dtype)
    h = _hidden(params, x, lp, bd_impl, act_impl, compute_dtype, in_impl,
                weights_dtype, infer)
    plast = lp.layer_pop(lp.depth - 1)
    if infer:
        if head_impl is None:
            head_impl = (("fused_int8" if int8 else "fused")
                         if bd_impl in FUSED_BD_IMPLS else "xla")
        if head_impl not in HEAD_IMPLS:
            raise ValueError(f"unknown head_impl {head_impl!r} "
                             f"(have {sorted(HEAD_IMPLS)})")
        if int8 and head_impl != "fused_int8":
            raise ValueError(
                "weights_dtype='int8' serves through head_impl='fused_int8' "
                f"(the int8 head store has no f32 twin), got {head_impl!r}")
        if head_impl == "fused_int8":
            if not int8:
                raise ValueError("head_impl='fused_int8' needs "
                                 "weights_dtype='int8'")
            return m3_infer_head_int8(
                cast(h), params["w_out"], params["w_out_scale"],
                params["b_out"],
                plast, log_probs=log_probs,
                seg=_static(lp, "seg_last", h.device,
                            plast.block_segment_ids, torch.int32))
        if head_impl == "fused":
            return m3_infer_head(
                cast(h), cast(params["w_out"]), params["b_out"], plast,
                log_probs=log_probs,
                seg=_static(lp, "seg_last", h.device,
                            plast.block_segment_ids, torch.int32))
    y = m3(cast(h), cast(params["w_out"]), plast, impl=m3_impl)
    if y.dtype == torch.bfloat16:
        y = y.float()
    y = y + params["b_out"][None]
    return torch.log_softmax(y, dim=-1) if log_probs else y


# ---------------------------------------------------------------------- #
# loss, gradients and the training step                                  #
# ---------------------------------------------------------------------- #

def fused_loss(params, x, targets, lp: LayeredPopulation,
               m3_impl: str = "bucketed", bd_impl: str = "einsum",
               act_impl: str = "sliced", compute_dtype=None, in_impl=None,
               loss_impl=None):
    """Summed per-member softmax cross-entropy → ``(loss, per)`` with
    ``per`` (P,) the per-member mean NLL.

    ``loss_impl`` picks the head: ``"xla"`` materialises logits through
    ``forward`` and runs log_softmax in PyTorch; ``"fused"`` runs
    projection + softmax-XE + dlogits in one kernel launch per direction
    (``m3_loss_head``).  The default ``None`` follows ``bd_impl``, so a
    fused run's forward + backward is ``2·(depth + 1)`` launches at any
    batch size (``launch_count.fused_step_budget``)."""
    if loss_impl is None:
        loss_impl = "fused" if bd_impl in FUSED_BD_IMPLS else "xla"
    if loss_impl not in LOSS_IMPLS:
        raise ValueError(f"unknown loss_impl {loss_impl!r} "
                         f"(have {sorted(LOSS_IMPLS)})")
    if loss_impl == "fused":
        cast = _caster(compute_dtype)
        h = _hidden(params, x, lp, bd_impl, act_impl, compute_dtype, in_impl)
        plast = lp.layer_pop(lp.depth - 1)
        per = m3_loss_head(cast(h), cast(params["w_out"]), params["b_out"],
                           targets, plast,
                           seg=_static(lp, "seg_last", h.device,
                                       plast.block_segment_ids, torch.int32))
        return per.sum(), per
    logits = forward(params, x, lp, m3_impl=m3_impl, bd_impl=bd_impl,
                     act_impl=act_impl, compute_dtype=compute_dtype,
                     in_impl=in_impl)
    logp = torch.log_softmax(logits, dim=-1)
    tgt = torch.as_tensor(targets, device=logits.device).long()
    nll = -torch.gather(logp, 2, tgt[:, None, None].expand(
        -1, logp.shape[1], 1))[..., 0]
    per = nll.mean(dim=0)
    return per.sum(), per


def loss_and_grads(params, x, targets, lp: LayeredPopulation, **kw):
    """``fused_loss`` and its gradient with respect to every parameter →
    ``(loss, per, grads)``, all detached (JAX: ``jax.value_and_grad(
    fused_loss, has_aux=True)``).  ``kw``: ``fused_loss``'s routing."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, per = fused_loss(tree_unflatten(params, leaves), x, targets,
                               lp, **kw)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    return loss.detach(), per.detach(), tree_unflatten(params, grads)


def member_lr_tree(lp: LayeredPopulation, lr) -> dict:
    """Per-member learning rates (P,) → a scale tree matching
    ``init_params`` (every parameter belongs to exactly one member, so
    per-member LRs are a broadcast — the paper's §7 'parallelise the
    learning rate').  The same expansion serves any per-member optimizer
    hyperparameter (``sgd(momentum=...)``, ``adamw(weight_decay=...)``).
    The tree lives on ``lr``'s device (the CPU for a numpy vector)."""
    lr = torch.as_tensor(lr, dtype=torch.float32)
    dev = lr.device

    def by_unit(l):
        return lr[_static(lp, ("segment", l), dev,
                          lp.layer_pop(l).segment_ids, torch.long)]

    tree = {"w_in": by_unit(0)[:, None], "b_in": by_unit(0), "mid": []}
    for l in range(lp.depth - 1):
        wl = [lr[m0:m0 + n][:, None, None]
              for (m0, n, *_rest, real) in lp.proj_buckets(l) if real]
        tree["mid"].append({"w": wl, "b": by_unit(l + 1)})
    tree["w_out"] = by_unit(lp.depth - 1)[None, :]
    tree["b_out"] = lr[:, None]
    return tree


def build_tables(lp: LayeredPopulation, device, bd_impl: str = "einsum",
                 act_impl: str = "sliced", m3_impl: str = "bucketed",
                 per_member: bool = False):
    """Build now, once, the device tables that a training step of this
    layout on this route and its evaluation read on ``device`` (static
    masks and ids, the mid layers' schedules and work tables, the head's
    segment ids; with ``per_member`` those of ``member_lr_tree``), so that
    a layout made at a rung boundary pays for them there and its first
    step builds none.  Each is kept on the layout instance (or on its
    tensors), as at first use; ``device.table_builds`` counts those
    built."""
    from repro_torch.kernels import block_diag as _bd
    from repro_torch.kernels import fused_layer as _fl
    # the device as a tensor on it reports it ("cuda:0", not "cuda"): the
    # caches are keyed by that name
    dev = torch.empty(0, device=device).device
    fused = bd_impl in FUSED_BD_IMPLS
    for l in range(lp.depth):
        pop = lp.layer_pop(l)
        _static(lp, ("mask", l), dev, pop.hidden_mask, torch.float32)
        if per_member:
            _static(lp, ("segment", l), dev, pop.segment_ids, torch.long)
        if fused or act_impl == "pallas":
            _static(lp, ("block_act", l), dev, pop.block_act_ids,
                    torch.int32)
        if act_impl == "masked" and not fused:
            _static(lp, ("act_ids", l), dev, pop.act_ids, torch.int32)
        if l:
            _static(lp, ("active", l), dev, lp.active_unit_mask(l),
                    torch.float32)
    for l in range(lp.depth - 1):
        if fused:
            _fl.schedule_on(lp.bd_layout(l), dev)
            _fl.dx_dw_schedule_on(lp.bd_layout(l), dev)
        elif bd_impl == "pallas":
            _fl.schedule_on(lp.bd_layout(l), dev)
            t = _fl.schedule_on(lp.bd_layout(l), dev, transposed=True)
            _bd.dw_units_on(t[4], t[5], lp.block)
    plast = lp.layer_pop(lp.depth - 1)
    _static(lp, "seg_last", dev, plast.block_segment_ids, torch.int32)
    if m3_impl == "pallas" and not fused:
        from repro_torch.core.m3 import block_seg_on
        block_seg_on(plast, dev)


def _lr_on(lr, lp: LayeredPopulation, device):
    """A scalar or (P,) learning rate as float32 on ``device`` — a (P,)
    vector expanded through ``member_lr_tree`` — or a scale tree as is."""
    if isinstance(lr, (dict, list, tuple)):
        return lr
    lr = torch.as_tensor(lr, dtype=torch.float32, device=device)
    return member_lr_tree(lp, lr) if lr.ndim == 1 else lr


def sgd_step(params, x, targets, lr, lp: LayeredPopulation,
             m3_impl: str = "bucketed", bd_impl: str = "einsum",
             act_impl: str = "sliced", compute_dtype=None):
    """One fused plain-SGD step, ``p − lr·g`` → ``(params, loss, per)``.
    ``lr`` may be a scalar or a per-member (P,) vector."""
    from repro_torch.optim.optimizers import broadcast_lr
    loss, per, grads = loss_and_grads(
        params, x, targets, lp, m3_impl=m3_impl, bd_impl=bd_impl,
        act_impl=act_impl, compute_dtype=compute_dtype)
    lrs = broadcast_lr(_lr_on(lr, lp, tree_leaves(params)[0].device), grads)
    return tree_map(lambda p, g, s: p - s * g, params, grads, lrs), loss, per


def opt_step(params, opt_state, x, targets, lr, opt, lp: LayeredPopulation,
             m3_impl: str = "bucketed", bd_impl: str = "einsum",
             act_impl: str = "sliced", compute_dtype=None, grad_clip=None,
             reduce=None, data_reduce=None):
    """One fused optimizer step with state: fused loss + grads → optional
    global-norm clip → ``opt.update`` → ``apply_updates`` →
    ``(params, opt_state, loss, per_member_losses, grad_norm)``;
    ``grad_norm`` is None unless ``grad_clip`` is set.

    ``opt`` is an ``optim.Optimizer``; ``lr`` a scalar, a per-member (P,)
    vector (expanded through ``member_lr_tree``) or a scale tree.  With
    ``opt=sgd()`` the update is bit for bit ``sgd_step``'s ``p − lr·g``:
    the engine computes ``p + (−lr)·g``, and IEEE negation, product and
    sum make the two equal (DESIGN.md §8).

    ``reduce`` (a ``distributed.sharding.PopulationReduce``; None on one
    rank) is the population axis's sum over ranks, for the two places
    where the reference's arithmetic mixes members: the global norm of
    the clip and adafactor's statistics over a member axis.  ``lp`` is
    then this rank's share of the layout.

    ``data_reduce`` (a ``distributed.sharding.DataReduce``; None unless
    the data axis splits the batch) averages the loss, the per-member
    losses and the gradients over the ranks of the data column, each a
    mean over the rank's own rows, into the full batch's means — before
    the clip's norm and the optimizer, so those see the full batch's
    gradient and, with ``reduce``, still sum over the model row only."""
    from repro_torch.optim.optimizers import (apply_updates,
                                              clip_by_global_norm)
    loss, per, grads = loss_and_grads(
        params, x, targets, lp, m3_impl=m3_impl, bd_impl=bd_impl,
        act_impl=act_impl, compute_dtype=compute_dtype)
    if data_reduce is not None:
        loss, per, *leaves = data_reduce.mean([loss, per,
                                               *tree_leaves(grads)])
        grads = tree_unflatten(grads, leaves)
    gnorm = None
    if grad_clip:
        grads, gnorm = clip_by_global_norm(grads, grad_clip, reduce=reduce)
    lr = _lr_on(lr, lp, tree_leaves(params)[0].device)
    if reduce is None:
        upd, opt_state = opt.update(grads, opt_state, params, lr)
    else:
        upd, opt_state = opt.update(grads, opt_state, params, lr,
                                    reduce=reduce)
    return apply_updates(params, upd), opt_state, loss, per, gnorm


def make_population_train_step(lp: LayeredPopulation, *, optimizer,
                               grad_clip=None, m3_impl: str = "bucketed",
                               bd_impl: str = "einsum",
                               act_impl: str = "sliced", scan_steps: int = 1,
                               compute_dtype=None, lr_schedule=None,
                               reduce=None, data_reduce=None):
    """The multi-step population train chunk (JAX: a jitted ``lax.scan``;
    here a Python loop over the chunk's steps, eagerly).

    ``chunk(params, opt_state, xs, ys, lr) -> (params, opt_state, losses,
    pers, gnorms)``, ``gnorms`` each step's pre-clip global gradient norm
    when ``grad_clip`` is set (else None); ``optimizer`` is an
    ``optim.Optimizer`` (``optim.sgd()`` is plain SGD, bit for bit).

    ``xs``/``ys`` carry a leading step axis of at most ``scan_steps``
    (a shorter last chunk runs fewer steps).  State stays on the device;
    ``losses`` (n,) and ``pers`` (n, P) are stacked on the device, so the
    caller fetches the chunk's metrics once.  ``lr_schedule`` (a
    ``step -> multiplier`` callable, e.g. ``optim.warmup_cosine(1.0,
    ...)``) adds a trailing ``step0`` argument, the global step of the
    chunk's first batch; inner step k trains at ``lr · lr_schedule(step0 +
    k)``.  ``reduce``, ``data_reduce``: ``opt_step``'s, for a rank's
    share of the layout and of the batch."""
    if scan_steps < 1:
        raise ValueError(f"scan_steps must be >= 1, got {scan_steps}")
    route = dict(m3_impl=m3_impl, bd_impl=bd_impl, act_impl=act_impl,
                 compute_dtype=compute_dtype)

    def lr_at(lr, step):
        if lr_schedule is None:
            return lr
        mult = lr_schedule(step)
        if isinstance(lr, (dict, list, tuple)):
            return tree_map(lambda v: v * mult.to(v.device), lr)
        lr = torch.as_tensor(lr, dtype=torch.float32)
        return lr * mult.to(lr.device)

    def steps(xs):
        n = xs.shape[0]
        if n > scan_steps:
            raise ValueError(f"{n} steps in a chunk of {scan_steps}")
        return n

    def chunk(params, opt_state, xs, ys, lr, step0=0):
        losses, pers, gnorms = [], [], []
        for k in range(steps(xs)):
            params, opt_state, loss, per, gnorm = opt_step(
                params, opt_state, xs[k], ys[k], lr_at(lr, step0 + k),
                optimizer, lp, grad_clip=grad_clip, reduce=reduce,
                data_reduce=data_reduce, **route)
            losses.append(loss)
            pers.append(per)
            gnorms.append(gnorm)
        return (params, opt_state, torch.stack(losses), torch.stack(pers),
                torch.stack(gnorms) if grad_clip else None)
    return chunk


# ---------------------------------------------------------------------- #
# member extraction (standalone baseline)                                #
# ---------------------------------------------------------------------- #

def extract_member(params, lp: LayeredPopulation, m: int) -> dict:
    """Standalone deep MLP of member m (REAL units and layers only)."""
    d = lp.member_depths[m]
    p0 = lp.layer_pop(0)
    out = {"w_in": params["w_in"][p0.member_slice(m)],
           "b_in": params["b_in"][p0.member_slice(m)],
           "mid": [],
           "activations": lp.activations[m],
           "activation": lp.activations[m][0]}
    for l in range(d - 1):
        wi = 0
        for (m0, n, hin, hout, off_in, off_out, real) in lp.proj_buckets(l):
            if m0 <= m < m0 + n:
                wm = params["mid"][l]["w"][wi][m - m0][
                    : lp.widths[m][l + 1], : lp.widths[m][l]]
                break
            if real:
                wi += 1
        bm = params["mid"][l]["b"][lp.layer_pop(l + 1).member_slice(m)]
        out["mid"].append({"w": wm, "b": bm})
    plast = lp.layer_pop(lp.depth - 1)
    out["w_out"] = params["w_out"][:, plast.member_slice(m)]
    out["b_out"] = params["b_out"][m]
    return out


def member_forward(member: dict, x: torch.Tensor) -> torch.Tensor:
    """Forward of one extracted member, honouring per-layer activations."""
    acts = member["activations"]
    h = ACTIVATIONS[acts[0]](x @ member["w_in"].t() + member["b_in"])
    for l, lay in enumerate(member["mid"]):
        h = ACTIVATIONS[acts[l + 1]](h @ lay["w"].t() + lay["b"])
    return h @ member["w_out"].t() + member["b_out"]
