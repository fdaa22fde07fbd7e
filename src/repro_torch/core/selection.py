"""Model selection over a trained population (paper §5: "perform model
selection in the large pool of trained MLPs"): evaluate → select →
leaderboard, over both layouts — the single-layer ``Population`` (the
paper's ``parallel_mlp``, ``w1/b1/w2/b2``) and the layered engine's
``LayeredPopulation`` — dispatching the forward and the member extraction
to the matching module, as the JAX package does."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import deep as _deep
from repro_torch.core import parallel_mlp as _pmlp
from repro_torch.core.parallel_mlp import member_accuracy, member_losses
from repro_torch.core.population import LayeredPopulation, Population

# rows per evaluation forward: at the paper's full width (1,280,000 fused
# hidden units) the hidden activations of one slab are 512 × 1.28M f32 =
# 2.6 GB on the card
EVAL_SLAB = 512


def _require_layout(pop):
    if not isinstance(pop, (LayeredPopulation, Population)):
        raise TypeError(f"selection takes a Population or a "
                        f"LayeredPopulation, got {type(pop).__name__}")


def _forward(params, x, layout, **fw):
    if isinstance(layout, LayeredPopulation):
        return _deep.forward(params, x, layout, **fw)
    if fw.pop("infer", False):
        raise ValueError("infer=True eval routes through the layered "
                         "engine — single-layer Population has no "
                         "forward-only kernel path")
    return _pmlp.forward(params, x, layout, **fw)


def extract_member(params, layout, m: int) -> dict:
    """Standalone params of member m, whichever layout trained them."""
    _require_layout(layout)
    if isinstance(layout, LayeredPopulation):
        return _deep.extract_member(params, layout, m)
    return _pmlp.extract_member(params, layout, m)


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _tensor(a, device, dtype) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def evaluate_population(params, pop, x, targets,
                        task: str = "classification",
                        batch_size: int = EVAL_SLAB, **fw):
    """Per-member mean loss (and accuracy) over an eval split, in slabs of
    ``batch_size`` rows on the parameters' device.  Forward kwargs pass
    straight to ``deep.forward`` — ``infer=True`` with ``bd_impl="fused"``
    scores on the serving kernels — or, for a single-layer
    ``Population``, to ``parallel_mlp.forward`` (``m3_impl``,
    ``act_impl``).  ``x``/``targets`` may be numpy arrays or tensors.
    Returns (losses (P,), accuracies (P,) or None) as f32 tensors on that
    device."""
    _require_layout(pop)
    dev = params["w_in" if isinstance(pop, LayeredPopulation)
                 else "w1"].device
    tdtype = torch.long if task == "classification" else torch.float32
    n = x.shape[0]
    loss_sum = torch.zeros(pop.num_members, device=dev)
    acc_sum = torch.zeros(pop.num_members, device=dev)
    with torch.inference_mode():
        for i in range(0, n, batch_size):
            xb = _tensor(x[i:i + batch_size], dev, torch.float32)
            tb = _tensor(targets[i:i + batch_size], dev, tdtype)
            logits = _forward(params, xb, pop, **fw)
            loss_sum += member_losses(logits, tb, task) * xb.shape[0]
            if task == "classification":
                acc_sum += member_accuracy(logits, tb) * xb.shape[0]
    losses = loss_sum / n
    accs = acc_sum / n if task == "classification" else None
    return losses, accs


def _num_real(pop) -> int:
    """Members eligible for selection (shard-pad fillers are excluded)."""
    return getattr(pop, "num_real", pop.num_members)


def select_best(params, pop, losses) -> tuple[int, dict]:
    """Best member by eval loss → (index, standalone params).  Shard-pad
    filler members (trailing) never win."""
    m = int(np.argmin(_numpy(losses)[:_num_real(pop)]))
    return m, extract_member(params, pop, m)


def _member_arch(pop, m: int):
    if isinstance(pop, LayeredPopulation):
        return pop.widths[m], "/".join(dict.fromkeys(pop.activations[m]))
    return pop.hidden_sizes[m], pop.activations[m]


def _check_member_ids(member_ids, nr: int):
    """One original id per real member, and no duplicates (a refilled
    member must never alias a pruned member's id)."""
    if len(member_ids) != nr:
        raise ValueError(f"member_ids has {len(member_ids)} entries for "
                         f"{nr} real members")
    ids = np.asarray(member_ids)
    srt = np.sort(ids)
    dup = srt[1:][np.diff(srt) == 0]
    if dup.size:
        raise ValueError(f"member_ids contains duplicate original ids "
                         f"{sorted(set(int(i) for i in dup))} — a refilled "
                         "member is aliasing a pruned member's id")


def _lineage_entry(lineage, member_id: int):
    """``lineage``: optional {original id → (parent id, birth rung)};
    seeds (absent keys) report parent -1, rung 0."""
    if lineage is None:
        return None
    parent, born = lineage.get(int(member_id), (-1, 0))
    return {"member": int(member_id), "parent": int(parent),
            "born_rung": int(born)}


def leaderboard(pop, losses, accs=None, k: int = 10, member_ids=None,
                sort_by: str = "loss", lineage=None):
    """Top-k real members as rows ``{rank, member, slot, hidden,
    activation, loss[, acc][, lineage]}``, ranked by loss (ascending) or,
    with ``sort_by="acc"``, accuracy (descending); ties keep slot order.
    ``member_ids`` maps layout slots to original ids; ``lineage`` adds the
    refill controller's parentage column."""
    nr = _num_real(pop)
    if member_ids is not None:
        _check_member_ids(member_ids, nr)
    losses = _numpy(losses)
    accs = None if accs is None else _numpy(accs)
    if sort_by == "loss":
        key = losses[:nr]
    elif sort_by == "acc":
        if accs is None:
            raise ValueError("sort_by='acc' needs accuracies")
        key = -accs[:nr]
    else:
        raise ValueError(f"unknown sort_by {sort_by!r} (have loss, acc)")
    order = np.argsort(key, kind="stable")[:k]
    rows = []
    for r, m in enumerate(order):
        m = int(m)
        hidden, act = _member_arch(pop, m)
        mid = m if member_ids is None else int(member_ids[m])
        row = dict(rank=r + 1, member=mid, slot=m, hidden=hidden,
                   activation=act, loss=float(losses[m]))
        if accs is not None:
            row["acc"] = float(accs[m])
        lin = _lineage_entry(lineage, mid)
        if lin is not None:
            row["lineage"] = lin
        rows.append(row)
    return rows


def member_metrics(pop, losses, accs=None, member_ids=None, lineage=None):
    """Unranked metric rows ``{member, slot, hidden, activation, depth,
    loss[, acc][, lineage]}`` for every real member — the table the
    leaderboard is a sorted top-k view of."""
    nr = _num_real(pop)
    if member_ids is not None:
        _check_member_ids(member_ids, nr)
    losses = _numpy(losses)
    accs = None if accs is None else _numpy(accs)
    rows = []
    for m in range(nr):
        hidden, act = _member_arch(pop, m)
        mid = m if member_ids is None else int(member_ids[m])
        row = dict(member=mid, slot=m, hidden=hidden, activation=act,
                   depth=len(hidden) if isinstance(hidden, tuple) else 1,
                   loss=float(losses[m]))
        if accs is not None:
            row["acc"] = float(accs[m])
        lin = _lineage_entry(lineage, mid)
        if lin is not None:
            row["lineage"] = lin
        rows.append(row)
    return rows
