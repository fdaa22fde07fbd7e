"""Per-member metrics over fused (B, P, O) outputs."""
from __future__ import annotations

import torch


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
