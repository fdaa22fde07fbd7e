"""Feature selection with ParallelMLPs — the paper's §7 future work:

  "perform feature selection using ParallelMLPs by repeating the MLP
   architecture and creating a mask tensor to be applied to the inputs
   before the first input to hidden projection"

The port of the JAX package's ``repro/core/feature_selection.py``.
Masking a member's INPUT is the same as masking the ROWS of its w1 slice,
so the fused network stays one matmul: ``w1`` is multiplied by a per-unit
feature mask (H_tot × F) built from the per-member masks (P × F).  The
gradients of masked weights are killed by re-masking after each update
(projected SGD), so a member cannot use its masked features.  Feature
importance is then read out of the trained population.

The step is ``parallel_mlp.sgd_step``; ``m3_impl="pallas"`` puts it on the
three M3 kernels (one launch of each a step).  Masks drawn by
``random_masks`` come from a ``torch.Generator``: JAX's distribution and
rules, other numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import parallel_mlp as pm
from repro_torch.core.population import Population
from repro_torch.device import layout_tensor, resolve


def random_masks(generator: torch.Generator, num_members: int,
                 n_features: int, keep_prob: float = 0.7,
                 always_full: int = 0, device=None) -> torch.Tensor:
    """(P, F) float mask, each feature kept with probability
    ``keep_prob``; a member left with no feature gets feature 0, and the
    first ``always_full`` members keep everything (baseline members).
    Drawn on the generator's device, placed on ``device`` (the card unless
    ``device="cpu"``)."""
    dev = resolve(device)
    m = (torch.rand(num_members, n_features, generator=generator,
                    device=generator.device) < keep_prob).float()
    m[m.sum(-1) == 0, 0] = 1.0
    m[:always_full] = 1.0
    return m.to(dev)


def unit_masks(pop: Population, member_masks) -> torch.Tensor:
    """(P, F) member masks → (H_tot, F) per-hidden-unit w1 row masks, on
    the masks' device."""
    masks = torch.as_tensor(member_masks, dtype=torch.float32)
    return masks[layout_tensor(pop, "segment_ids", masks.device,
                               pop.segment_ids, torch.long)]


def apply_masks(params: dict, pop: Population, member_masks) -> dict:
    w1 = params["w1"]
    um = unit_masks(pop, member_masks).to(w1.device, w1.dtype)
    return dict(params, w1=w1 * um)


def masked_sgd_step(params, x, targets, lr, pop: Population, member_masks,
                    task: str = "classification", m3_impl: str = "bucketed",
                    act_impl: str = "sliced"):
    """Projected SGD: mask → step → re-mask → ``(params, loss, per)``.
    Members remain independent AND feature-restricted."""
    params = apply_masks(params, pop, member_masks)
    new, loss, per = pm.sgd_step(params, x, targets, lr, pop, task,
                                 m3_impl=m3_impl, act_impl=act_impl)
    return apply_masks(new, pop, member_masks), loss, per


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def feature_importance(pop: Population, member_masks, losses,
                       baseline: float | None = None) -> np.ndarray:
    """Mean-loss-gap attribution: for each feature f, how much better are
    members that SEE f than members that don't.  (F,) — higher = more
    important.  numpy, as in the JAX package; tensors are read back."""
    m = _numpy(member_masks)                          # (P, F)
    l = _numpy(losses)                                # (P,)
    with_f = (m * l[:, None]).sum(0) / np.maximum(m.sum(0), 1)
    without_f = ((1 - m) * l[:, None]).sum(0) / np.maximum((1 - m).sum(0), 1)
    return without_f - with_f
