"""ParallelMLP — the paper's fused population of single-hidden-layer MLPs.

Parameters (one fused set for the whole population of P members), a dict
with the JAX package's layout (``repro/core/parallel_mlp.py``):
    w1 : (total_hidden, in_features)   — concatenated input→hidden weights
    b1 : (total_hidden,)
    w2 : (out_features, total_hidden)  — fused hidden→output weights (M3)
    b2 : (P, out_features)

The forward pass is the paper's steps (§3): one fused matmul (``addmm``,
outside any kernel, as JAX leaves it to XLA) → per-member activation →
padding mask → M3 (``core/m3.py``; ``m3_impl="pallas"`` is the
segment-blocked matmul kernels, one launch forward and two backward).
``fused_loss`` returns the SUM of per-member losses, so the gradient a
member sees is the one it would see trained alone (the independence
property), and ``sgd_step`` takes a scalar or a per-member (P,) learning
rate — every parameter belongs to exactly one member.

Init matches torch.nn.Linear (U(±1/√fan_in)) with per-member fan-in for
the output layer, so every member initialises as it would standalone.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.activations import (ACTIVATIONS,
                                          apply_activations_masked,
                                          apply_activations_sliced)
from repro_torch.core.m3 import m3 as _m3_apply
from repro_torch.core.population import Population
from repro_torch.device import layout_tensor, resolve

KEYS = ("w1", "b1", "w2", "b2")


def abstract_params(pop: Population, dtype=torch.float32) -> dict:
    """The parameter tree's shapes and dtype, as meta tensors."""
    ht, fi, fo = pop.total_hidden, pop.in_features, pop.out_features
    return {"w1": torch.empty(ht, fi, dtype=dtype, device="meta"),
            "b1": torch.empty(ht, dtype=dtype, device="meta"),
            "w2": torch.empty(fo, ht, dtype=dtype, device="meta"),
            "b2": torch.empty(pop.num_members, fo, dtype=dtype,
                              device="meta")}


def init_params(generator: torch.Generator, pop: Population, device=None,
                dtype=torch.float32) -> dict:
    """torch.nn.Linear-style init: w1, b1 ~ U(±1/√F); w2 ~ U(±1/√h_m)
    per unit of member m (its true hidden size h_m); b2 ~ U(±1/√h_m).
    Drawn from ``generator`` (on its device), placed on ``device`` — the
    card unless ``device="cpu"``.  The distribution is the JAX package's;
    the numbers are not (torch's generator is not threefry)."""
    dev = resolve(device)
    gdev = generator.device

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=gdev, dtype=dtype)
        return (u * (hi - lo) + lo).to(dev)

    def col(a):
        return torch.as_tensor(np.asarray(a, np.float32), dtype=dtype,
                               device=dev)

    ht, fi, fo = pop.total_hidden, pop.in_features, pop.out_features
    bound1 = 1.0 / np.sqrt(fi)
    w1 = uniform((ht, fi), -bound1, bound1)
    b1 = uniform((ht,), -bound1, bound1)
    w2 = uniform((fo, ht), -1.0, 1.0) \
        * col(1.0 / np.sqrt(pop.member_fan_in))[None, :]
    b2 = uniform((pop.num_members, fo), -1.0, 1.0) * col(
        1.0 / np.sqrt(np.asarray(pop.hidden_sizes, np.float32)))[:, None]
    return {"w1": w1, "b1": b1, "w2": w2, "b2": b2}


def params_from_numpy(tree, pop: Population, device="cuda") -> dict:
    """A ``w1/b1/w2/b2`` tree of numpy arrays (e.g. the JAX package's,
    through ``jax.device_get``) → float32 tensors on ``device``,
    shape-checked against ``pop``."""
    dev = resolve(device)
    out = {}
    for k, like in abstract_params(pop).items():
        arr = np.asarray(tree[k])
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{k}: shape {arr.shape} != "
                             f"{tuple(like.shape)} for this layout")
        out[k] = torch.tensor(arr, dtype=torch.float32, device=dev)
    return out


def params_to_numpy(params) -> dict:
    """The inverse of ``params_from_numpy``."""
    return {k: params[k].detach().cpu().numpy() for k in KEYS}


def forward(params: dict, x: torch.Tensor, pop: Population, *,
            m3_impl: str = "bucketed", act_impl: str = "sliced"
            ) -> torch.Tensor:
    """x (B, in) → logits (B, P, out).  The paper's steps 1–4."""
    h = torch.addmm(params["b1"], x, params["w1"].t())   # 1. fused matmul
    if act_impl == "sliced":                              # 2. per-member act
        h = apply_activations_sliced(h, pop.act_runs)
    elif act_impl == "masked":
        h = apply_activations_masked(h, layout_tensor(
            pop, "act_ids", h.device, pop.act_ids, torch.long))
    else:
        raise ValueError(f"unknown act_impl {act_impl!r}")
    h = h * layout_tensor(pop, "hidden_mask", h.device, pop.hidden_mask,
                          h.dtype)                        # kill padding
    y = _m3_apply(h, params["w2"], pop, impl=m3_impl)    # 3+4. M3
    return y + params["b2"][None, :, :]


def member_losses(logits: torch.Tensor, targets: torch.Tensor,
                  task: str) -> torch.Tensor:
    """(B, P, O) × (B,) or (B, O) → per-member mean loss (P,)."""
    if task == "classification":
        logp = torch.log_softmax(logits, dim=-1)
        idx = targets.long()[:, None, None].expand(-1, logits.shape[1], 1)
        return -torch.gather(logp, -1, idx)[..., 0].mean(dim=0)
    if task == "regression":
        err = logits - targets[:, None, :]
        return (err ** 2).mean(dim=(0, 2))
    raise ValueError(task)


def member_accuracy(logits: torch.Tensor, targets: torch.Tensor
                    ) -> torch.Tensor:
    pred = torch.argmax(logits, dim=-1)                        # (B, P)
    return (pred == targets[:, None]).float().mean(dim=0)      # (P,)


def fused_loss(params, x, targets, pop: Population,
               task: str = "classification", **fw):
    """Scalar objective = SUM of member losses (keeps gradients independent
    and equal to standalone training) → ``(scalar, per_member)``."""
    per = member_losses(forward(params, x, pop, **fw), targets, task)
    return per.sum(), per


def loss_and_grads(params, x, targets, pop: Population,
                   task: str = "classification", **fw):
    """``fused_loss`` and its gradient with respect to every parameter →
    ``(loss, per, grads)``, all detached (JAX: ``jax.value_and_grad(
    fused_loss, has_aux=True)``)."""
    leaves = {k: params[k].detach().requires_grad_(True) for k in KEYS}
    with torch.enable_grad():
        loss, per = fused_loss(leaves, x, targets, pop, task, **fw)
        grads = torch.autograd.grad(loss, [leaves[k] for k in KEYS])
    return loss.detach(), per.detach(), dict(zip(KEYS, grads))


def sgd_step(params, x, targets, lr, pop: Population,
             task: str = "classification", m3_impl: str = "bucketed",
             act_impl: str = "sliced"):
    """One fused SGD step over the whole population → ``(params, loss,
    per)``.  ``lr`` may be a scalar (the paper) or a per-member vector
    (P,) — the paper's §7 "parallelise the learning rate too"."""
    loss, per, grads = loss_and_grads(params, x, targets, pop, task,
                                      m3_impl=m3_impl, act_impl=act_impl)
    dev = params["w1"].device
    if isinstance(lr, (int, float)):
        # a Python number multiplies as it is: a 0-dim tensor made from it
        # on the card would be a blocking host→device copy every step
        lr = float(lr)
    else:
        lr = torch.as_tensor(lr, dtype=torch.float32, device=dev)
    if isinstance(lr, float) or lr.ndim == 0:
        scale = dict.fromkeys(KEYS, lr)
    else:  # per-member lr vector → expanded along the fused axes
        per_unit = lr[layout_tensor(pop, "segment_ids", dev, pop.segment_ids,
                              torch.long)]
        scale = {"w1": per_unit[:, None], "b1": per_unit,
                 "w2": per_unit[None, :], "b2": lr[:, None]}
    new = {k: params[k] - scale[k] * grads[k] for k in KEYS}
    return new, loss, per


def extract_member(params: dict, pop: Population, m: int) -> dict:
    """Member m's standalone MLP out of the fused parameters."""
    sl = pop.member_slice(m)
    return {"w1": params["w1"][sl], "b1": params["b1"][sl],
            "w2": params["w2"][:, sl], "b2": params["b2"][m],
            "activation": pop.activations[m]}


def member_forward(member: dict, x: torch.Tensor) -> torch.Tensor:
    """Standalone forward of one extracted member (the sequential
    baseline)."""
    h = ACTIVATIONS[member["activation"]](x @ member["w1"].t()
                                          + member["b1"])
    return h @ member["w2"].t() + member["b2"]
