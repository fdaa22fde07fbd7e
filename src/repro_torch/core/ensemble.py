"""On-device ensemble reductions over the member axis.

Serving a population means reducing the (B, P, O) per-member outputs of
``deep.forward(infer=True)`` into one answer per request, plus an
uncertainty signal only a population can give:

  best_member       one member's probabilities (leaderboard rank-0 routing)
  soft_vote         mean of member softmaxes over a published member set
                    (optionally weighted) — the top-k / all-members ensemble
  disagreement      mixture entropy, mean member entropy, their gap (the
                    mutual information) and the share of members voting
                    with the ensemble

All reductions accept raw logits or log-probabilities (softmax is
shift-invariant per row).

Filler exclusion: ``LayeredPopulation.shard_pad`` appends identity filler
members.  Those slots hold real arrays but are not models, so every
reduction slices the member axis to ``num_real`` (fillers are trailing)
and validates explicit member sets against the real range, failing loudly
rather than gathering a filler.
"""
from __future__ import annotations

import numpy as np
import torch


def real_slots(pop) -> int:
    """Number of REAL members in a (possibly shard-padded) layout."""
    return int(getattr(pop, "num_real", pop.num_members))


def _real_logits(logits: torch.Tensor, pop):
    nr = real_slots(pop)
    if logits.shape[1] < nr:
        raise ValueError(f"member axis {logits.shape[1]} smaller than the "
                         f"layout's {nr} real members")
    return logits[:, :nr, :], nr


def _validate_slots(member_ids, num_real: int) -> np.ndarray:
    """Explicit member sets must name real members only."""
    ids = np.asarray(member_ids, np.int64).reshape(-1)
    if ids.size == 0:
        raise ValueError("empty ensemble member set")
    bad = ids[(ids < 0) | (ids >= num_real)]
    if bad.size:
        raise ValueError(
            f"member ids {sorted(set(bad.tolist()))} outside the real-member "
            f"range [0, {num_real}) — shard_pad identity fillers must never "
            "reach an ensemble reduction")
    return ids


def member_log_probs(logits: torch.Tensor) -> torch.Tensor:
    """Per-member log-probabilities (idempotent on log-prob input)."""
    return torch.log_softmax(logits, dim=-1)


def _index(ids: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(ids, dtype=torch.long, device=device)


def best_member(logits: torch.Tensor, pop, member_id: int) -> torch.Tensor:
    """(B, P, O) → one member's probabilities (B, O)."""
    lg, nr = _real_logits(logits, pop)
    (mid,) = _validate_slots([member_id], nr)
    return torch.softmax(lg[:, int(mid), :], dim=-1)


def soft_vote(logits: torch.Tensor, pop, member_ids=None,
              weights=None) -> torch.Tensor:
    """(B, P, O) → ensemble probabilities (B, O): mean (or normalised
    ``weights``-weighted mean) of member softmaxes over ``member_ids``
    (default: every real member)."""
    lg, nr = _real_logits(logits, pop)
    if member_ids is None:
        sel = lg
        k = nr
    else:
        ids = _validate_slots(member_ids, nr)
        sel = lg[:, _index(ids, lg.device), :]
        k = ids.shape[0]
    probs = torch.softmax(sel, dim=-1)                  # (B, K, O)
    if weights is None:
        return probs.mean(dim=1)
    w = torch.as_tensor(np.asarray(weights, np.float32).reshape(-1),
                        device=lg.device)
    if w.shape[0] != k:
        raise ValueError(f"{w.shape[0]} weights for {k} members")
    return torch.einsum("bko,k->bo", probs, w / w.sum())


def disagreement(logits: torch.Tensor, pop, member_ids=None) -> dict:
    """Population-disagreement uncertainty over ``member_ids`` (default all
    real members) → (B,) tensors ``mixture_entropy``,
    ``mean_member_entropy``, ``mutual_information``, ``vote_agreement``."""
    lg, nr = _real_logits(logits, pop)
    if member_ids is not None:
        lg = lg[:, _index(_validate_slots(member_ids, nr), lg.device), :]
    logp = torch.log_softmax(lg, dim=-1)                # (B, K, O)
    p = torch.exp(logp)
    mix = p.mean(dim=1)                                 # (B, O)
    mixture_entropy = -torch.sum(mix * torch.log(mix.clamp_min(1e-20)),
                                 dim=-1)
    mean_member_entropy = -torch.sum(p * logp, dim=-1).mean(dim=1)
    pred = torch.argmax(mix, dim=-1)
    votes = torch.argmax(logp, dim=-1)                  # (B, K)
    return {
        "mixture_entropy": mixture_entropy,
        "mean_member_entropy": mean_member_entropy,
        "mutual_information": mixture_entropy - mean_member_entropy,
        "vote_agreement": (votes == pred[:, None]).float().mean(dim=1),
    }


ENSEMBLE_MODES = ("best1", "topk", "all")


def ensemble_predict(logits: torch.Tensor, pop, mode: str = "all",
                     member_ids=None, weights=None,
                     with_uncertainty: bool = False) -> dict:
    """One dispatcher for the three serving reductions.

    ``"best1"`` routes to ``member_ids[0]`` (leaderboard rank 0);
    ``"topk"`` soft-votes over the published ``member_ids``; ``"all"``
    soft-votes over every real member.  Returns ``{"probs": (B, O),
    "pred": (B,)}`` plus the ``disagreement`` tensors (over the same
    member set) when ``with_uncertainty`` is set."""
    if mode not in ENSEMBLE_MODES:
        raise ValueError(f"unknown ensemble mode {mode!r} "
                         f"(have {ENSEMBLE_MODES})")
    if mode == "best1":
        if member_ids is None:
            raise ValueError("mode='best1' needs member_ids (leaderboard)")
        mid = int(np.asarray(member_ids).reshape(-1)[0])
        probs = best_member(logits, pop, mid)
        ids = [mid]
    elif mode == "topk":
        if member_ids is None:
            raise ValueError("mode='topk' needs member_ids (leaderboard)")
        probs = soft_vote(logits, pop, member_ids, weights)
        ids = member_ids
    else:
        probs = soft_vote(logits, pop, None, weights)
        ids = None
    out = {"probs": probs, "pred": torch.argmax(probs, dim=-1)}
    if with_uncertainty:
        out.update(disagreement(logits, pop, ids))
    return out
