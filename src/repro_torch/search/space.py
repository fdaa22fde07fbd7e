"""Declarative search-space spec: the port's copy of the JAX package's
``repro.search.space``.

One frozen dataclass owns every range the population search draws from:
the per-member recipe ranges of the trainer's ``--per-member-*`` vectors
and an optional architecture menu for refill sampling.

Spec grammar (``--search-space``), ';'-separated ``key=value`` fields, any
subset (unlisted keys keep the defaults below)::

    widths=64,32|16,8|24   # arch menu: options by '|', layer widths by ','
    acts=relu,tanh         # activation menu
    lr=0.3..3              # log-uniform MULTIPLIER range around the base lr
    momentum=0.5..0.99     # uniform absolute range
    wd=0.3..3              # log-uniform multiplier range around base decay
    lr_perturb=0.8,1.25    # PBT explore: multiply by one of these
    momentum_jitter=0.05   # PBT explore: additive uniform jitter half-width

The ``init_*`` methods draw the seed recipe vectors with the JAX package's
transforms in float32, from ``torch.Generator().manual_seed(seed + k)``
(k = 1, 2, 3) where the JAX package uses ``jax.random.PRNGKey(seed + k)``:
the same distribution, other numbers (as for parameter inits).  The
``sample_*``/``perturb_*`` methods are the controller's numpy draws, equal
to the JAX package's number for number.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _parse_range(text: str, what: str) -> tuple:
    lo, sep, hi = text.partition("..")
    if not sep:
        raise ValueError(f"search space: {what} wants 'LO..HI', got {text!r}")
    lo, hi = float(lo), float(hi)
    if not lo < hi:
        raise ValueError(f"search space: {what} range {lo}..{hi} is empty")
    return (lo, hi)


def _uniform(seed: int, n: int, lo: torch.Tensor,
             hi: torch.Tensor) -> torch.Tensor:
    """(n,) float32 draws of U[lo, hi) from a CPU generator seeded
    ``seed``: ``u·(hi − lo) + lo``, as ``jax.random.uniform`` scales."""
    u = torch.rand(n, generator=torch.Generator().manual_seed(int(seed)),
                   dtype=torch.float32)
    return u * (hi - lo) + lo


def _f32(*vals) -> list:
    return [torch.tensor(v, dtype=torch.float32) for v in vals]


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    widths: tuple = ()                    # arch menu; () = refill keeps slot archs
    acts: tuple = ("relu",)
    lr_scale: tuple = (0.3, 3.0)          # log-uniform, × base lr
    momentum_range: tuple = (0.5, 0.99)   # uniform, absolute
    wd_scale: tuple = (0.3, 3.0)          # log-uniform, × base decay
    lr_perturb: tuple = (0.8, 1.25)       # explore multipliers
    momentum_jitter: float = 0.05         # explore additive half-width

    @classmethod
    def parse(cls, spec: str | None) -> "SearchSpace":
        """``"widths=8,4|6;acts=relu,tanh;lr=0.3..3"`` → SearchSpace.
        ``None``/empty → the default space."""
        kw = {}
        for field in (spec or "").split(";"):
            field = field.strip()
            if not field:
                continue
            key, sep, val = field.partition("=")
            key, val = key.strip(), val.strip()
            if not sep or not val:
                raise ValueError(f"search space: field {field!r} wants "
                                 "'key=value'")
            if key == "widths":
                kw["widths"] = tuple(
                    tuple(int(w) for w in opt.split(","))
                    for opt in val.split("|"))
            elif key == "acts":
                kw["acts"] = tuple(a.strip() for a in val.split(","))
            elif key == "lr":
                kw["lr_scale"] = _parse_range(val, "lr")
            elif key == "momentum":
                kw["momentum_range"] = _parse_range(val, "momentum")
            elif key == "wd":
                kw["wd_scale"] = _parse_range(val, "wd")
            elif key == "lr_perturb":
                kw["lr_perturb"] = tuple(float(f) for f in val.split(","))
            elif key == "momentum_jitter":
                kw["momentum_jitter"] = float(val)
            else:
                raise ValueError(f"search space: unknown key {key!r} "
                                 "(widths, acts, lr, momentum, wd, "
                                 "lr_perturb, momentum_jitter)")
        return cls(**kw)

    # ---- seed recipe vectors over the ORIGINAL population (float32) ---- #

    def init_lr(self, seed: int, n0: int, base_lr: float) -> np.ndarray:
        """Per-member lr vector: exp of U[log(base·lo), log(base·hi))."""
        lo, hi = self.lr_scale
        llo, lhi = (torch.log(v) for v in _f32(base_lr * lo, base_lr * hi))
        return torch.exp(_uniform(seed + 1, n0, llo, lhi)).numpy()

    def init_momentum(self, seed: int, n0: int) -> np.ndarray:
        """Per-member momentum vector: U[lo, hi)."""
        return _uniform(seed + 2, n0, *_f32(*self.momentum_range)).numpy()

    def init_wd(self, seed: int, n0: int, base_wd: float) -> np.ndarray:
        """Per-member weight-decay vector: exp of U[log(base·lo),
        log(base·hi))."""
        lo, hi = self.wd_scale
        llo, lhi = (torch.log(v) for v in _f32(base_wd * lo, base_wd * hi))
        return torch.exp(_uniform(seed + 3, n0, llo, lhi)).numpy()

    # ---- controller-side draws (numpy rng, deterministic per rung) --- #

    def sample_arch(self, rng: np.random.Generator) -> tuple:
        """One (widths, act) draw from the menu; needs a non-empty
        ``widths`` menu."""
        if not self.widths:
            raise ValueError("search space: no 'widths' menu to sample "
                             "architectures from")
        w = self.widths[int(rng.integers(len(self.widths)))]
        return w, self.acts[int(rng.integers(len(self.acts)))]

    def sample_lr(self, rng: np.random.Generator, base_lr: float) -> float:
        lo, hi = self.lr_scale
        return float(base_lr * np.exp(rng.uniform(np.log(lo), np.log(hi))))

    def sample_momentum(self, rng: np.random.Generator) -> float:
        lo, hi = self.momentum_range
        return float(rng.uniform(lo, hi))

    def sample_wd(self, rng: np.random.Generator, base_wd: float) -> float:
        lo, hi = self.wd_scale
        return float(base_wd * np.exp(rng.uniform(np.log(lo), np.log(hi))))

    def perturb_lr(self, rng: np.random.Generator, lr: float,
                   base_lr: float) -> float:
        """PBT explore: multiply by one of ``lr_perturb``, clipped back
        into the space's absolute range."""
        lo, hi = self.lr_scale
        out = lr * float(rng.choice(self.lr_perturb))
        return float(np.clip(out, base_lr * lo, base_lr * hi))

    def perturb_momentum(self, rng: np.random.Generator, m: float) -> float:
        lo, hi = self.momentum_range
        j = self.momentum_jitter
        return float(np.clip(m + rng.uniform(-j, j), lo, hi))

    def perturb_wd(self, rng: np.random.Generator, wd: float,
                   base_wd: float) -> float:
        lo, hi = self.wd_scale
        out = wd * float(rng.choice(self.lr_perturb))
        return float(np.clip(out, base_wd * lo, base_wd * hi))


DEFAULT_SPACE = SearchSpace()
