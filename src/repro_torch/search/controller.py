"""Slot-refill search controller: the port's copy of the JAX package's
``repro.search.controller`` (DESIGN.md §13).

At each halving rung boundary the lifecycle prunes the losing members; the
controller decides what to put back in the freed slots:

  exploit — clone a surviving member whose architecture matches the slot's
            (truncation selection: a uniform draw from the best
            ``exploit_frac`` of the matching survivors), then EXPLORE by
            perturbing the clone's training recipe (lr always; momentum /
            weight decay when those per-member vectors are active).  The
            clone adopts the slot's architecture — that is what keeps the
            layout, and therefore every compiled program, unchanged.
  fresh   — when no survivor shares the slot's architecture (or in
            ``mode="arch"``), initialise a brand-new member: recipe
            sampled from the space, parameters from a fresh draw,
            architecture either the slot's own (PBT mode) or sampled from
            the space's ``widths`` menu (arch mode — the driver then grows
            the layout instead of scattering in place).

Decisions are a pure function of (seed, rung, losses, layout): the rng is
``np.random.default_rng([seed, 777, rung])``, so a resumed run re-plans a
rung identically to the run that first crossed it.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.search.space import SearchSpace


@dataclasses.dataclass(frozen=True)
class RefillMember:
    """One refilled slot: where it goes, where it came from, and the
    recipe it trains with.  ``parent_slot`` is a REAL slot index in the
    pre-refill layout (-1 = fresh init); ``parent_id``/``member_id`` are
    ORIGINAL member ids (the lineage the leaderboard reports);
    ``momentum``/``wd`` are None when that per-member vector is off."""
    slot: int
    parent_slot: int
    parent_id: int
    member_id: int
    birth_rung: int
    widths: tuple
    acts: tuple
    lr: float | None
    momentum: float | None
    wd: float | None
    origin: str                      # "exploit" | "fresh"


@dataclasses.dataclass(frozen=True)
class RefillPlan:
    members: tuple                   # RefillMember, ascending slot order

    @property
    def assignments(self) -> tuple:
        """``(slot, parent_slot)`` pairs for ``lifecycle.refill_params``
        (-1 parents mean the fresh tree)."""
        return tuple((m.slot, m.parent_slot) for m in self.members)

    @property
    def slots(self) -> tuple:
        return tuple(m.slot for m in self.members)

    @property
    def fresh_members(self) -> tuple:
        """The fresh-init members, ascending slot order — the order their
        params tree is built in (``refill_params``'s ``fresh`` contract)."""
        return tuple(m for m in self.members if m.parent_slot < 0)


class RefillController:
    """Plans rung-boundary refills against a :class:`SearchSpace`.

    ``mode="pbt"`` holds the population size constant and every refill
    adopts its slot's architecture (the zero-re-jit path);
    ``mode="arch"`` resamples architectures from the space's menu, so the
    driver takes the grow-layout path instead."""

    def __init__(self, space: SearchSpace, mode: str = "pbt",
                 seed: int = 0, exploit_frac: float = 0.5):
        if mode not in ("pbt", "arch"):
            raise ValueError(f"refill mode {mode!r} (want 'pbt' or 'arch')")
        if mode == "arch" and not space.widths:
            raise ValueError("refill mode 'arch' needs a search space with "
                             "a 'widths' menu")
        self.space = space
        self.mode = mode
        self.seed = int(seed)
        self.exploit_frac = float(exploit_frac)

    def plan(self, lp, losses, keep, member_ids, rung: int, next_id: int,
             base_lr: float, lr=None, momentum=None, wd=None,
             base_momentum: float = 0.9, base_wd: float = 0.0) -> RefillPlan:
        """Decide every freed slot's replacement.

        ``lp`` is the PRE-prune layout, ``losses`` the rung eval over its
        real slots, ``keep`` the survivor slot indices, ``member_ids`` the
        per-slot ORIGINAL ids, ``next_id`` the first unused original id
        (strictly above every id ever issued, so newborns never alias a
        pruned seed).  ``lr``/``momentum``/``wd`` are the per-slot recipe
        values for active vectors (None = that recipe is global)."""
        losses = np.asarray(losses)
        keep_set = set(int(k) for k in keep)
        pruned = [s for s in range(lp.num_real) if s not in keep_set]
        rng = np.random.default_rng([self.seed, 777, int(rung)])
        sp = self.space
        members = []
        for j, slot in enumerate(pruned):
            if self.mode == "arch":
                widths, act = sp.sample_arch(rng)
                members.append(RefillMember(
                    slot=slot, parent_slot=-1, parent_id=-1,
                    member_id=int(next_id) + j, birth_rung=int(rung),
                    widths=tuple(widths), acts=act,
                    lr=None if lr is None else sp.sample_lr(rng, base_lr),
                    momentum=None if momentum is None
                    else sp.sample_momentum(rng),
                    wd=None if wd is None else sp.sample_wd(rng, base_wd),
                    origin="fresh"))
                continue
            cands = [k for k in sorted(keep_set)
                     if lp.widths[k] == lp.widths[slot]
                     and lp.activations[k] == lp.activations[slot]]
            if cands:
                cands.sort(key=lambda k: losses[k])
                top = cands[:max(1, int(np.ceil(len(cands)
                                                * self.exploit_frac)))]
                parent = int(top[int(rng.integers(len(top)))])
                members.append(RefillMember(
                    slot=slot, parent_slot=parent,
                    parent_id=int(member_ids[parent]),
                    member_id=int(next_id) + j, birth_rung=int(rung),
                    widths=lp.widths[slot], acts=lp.activations[slot],
                    lr=None if lr is None
                    else sp.perturb_lr(rng, float(lr[parent]), base_lr),
                    momentum=None if momentum is None
                    else sp.perturb_momentum(rng, float(momentum[parent])),
                    wd=None if wd is None
                    else sp.perturb_wd(rng, float(wd[parent]), base_wd),
                    origin="exploit"))
            else:
                members.append(RefillMember(
                    slot=slot, parent_slot=-1, parent_id=-1,
                    member_id=int(next_id) + j, birth_rung=int(rung),
                    widths=lp.widths[slot], acts=lp.activations[slot],
                    lr=None if lr is None else sp.sample_lr(rng, base_lr),
                    momentum=None if momentum is None
                    else sp.sample_momentum(rng),
                    wd=None if wd is None else sp.sample_wd(rng, base_wd),
                    origin="fresh"))
        return RefillPlan(members=tuple(members))
