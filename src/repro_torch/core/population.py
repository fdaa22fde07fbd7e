"""Population descriptor: a heterogeneous collection of independent MLPs
fused into a single tensor layout (the paper's ParallelMLPs).

The port's own copy of the JAX package's numpy-only layout module, kept
array-for-array equal to it (tests/test_torch_layout.py).  A population of
P members, member ``m`` having ``hidden_sizes[m]`` hidden units and
activation ``activations[m]``, is laid out as one fused hidden axis of
``total_hidden`` units.  Every member's slice is padded up to a multiple of
``block`` so each block belongs to exactly one member; padded units are
masked to zero after activation, so the fused network is mathematically
identical to the P independent networks.

``Population`` is the per-layer layout primitive (``size_buckets`` for the
output projection, ``pair_buckets`` for block-diagonal layer→layer
projections).  ``LayeredPopulation`` composes one ``Population`` per hidden
layer into a deep population with heterogeneous member depths (shallow
members ride through later layers as exact identity pass-throughs) and
per-layer activations.

All layout quantities are static numpy data computed once per layout.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
from functools import cached_property
from typing import Sequence

import numpy as np

from repro_torch.core.activations import ACTIVATION_NAMES


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def _instance_cache(method):
    """Memoise a method on the instance (``__dict__``, like cached_property —
    works on frozen dataclasses and dies with the instance; a process-global
    lru_cache would pin every layout ever constructed)."""
    name = method.__name__

    @functools.wraps(method)
    def wrapper(self, *args):
        cache = self.__dict__.setdefault("_method_cache", {})
        key = (name, args)
        if key not in cache:
            cache[key] = method(self, *args)
        return cache[key]
    return wrapper


@dataclasses.dataclass(frozen=True)
class Population:
    """Static description of a fused population of independent MLPs."""

    in_features: int
    out_features: int
    hidden_sizes: tuple
    activations: tuple  # activation *names*, one per member
    block: int = 1      # hidden-slice alignment

    def __post_init__(self):
        if len(self.hidden_sizes) != len(self.activations):
            raise ValueError(
                f"hidden_sizes ({len(self.hidden_sizes)}) and activations "
                f"({len(self.activations)}) must have the same length")
        for a in self.activations:
            if a not in ACTIVATION_NAMES:
                raise ValueError(f"unknown activation {a!r}; "
                                 f"known: {sorted(ACTIVATION_NAMES)}")
        for h in self.hidden_sizes:
            if h < 1:
                raise ValueError(f"hidden size must be >= 1, got {h}")
        if self.block < 1:
            raise ValueError("block must be >= 1")
        object.__setattr__(self, "hidden_sizes",
                           tuple(int(h) for h in self.hidden_sizes))
        object.__setattr__(self, "activations", tuple(self.activations))

    @staticmethod
    def grid(in_features: int, out_features: int,
             hidden_range: Sequence[int], activations: Sequence[str],
             repeats: int = 1, block: int = 1,
             sort_members: bool = True, sort_by: str = "act") -> "Population":
        """The paper's experimental design: every (hidden size × activation)
        pair, repeated ``repeats`` times.  hidden 1..100 × 10 activations ×
        10 repeats = the paper's 10,000 models."""
        sizes, acts = [], []
        for a in activations:
            for h in hidden_range:
                for _ in range(repeats):
                    sizes.append(h)
                    acts.append(a)
        pop = Population(in_features, out_features, tuple(sizes), tuple(acts),
                         block=block)
        return pop.sorted(sort_by) if sort_members else pop

    def sorted(self, by: str = "act") -> "Population":
        """Reorder members so fused ops touch contiguous slices.

        by="act"  — (activation, size): one activation run per function.
        by="size" — (padded size, activation): one output bucket per size
                    class."""
        if by == "act":
            key = lambda m: (self.activations[m], self.hidden_sizes[m])
        elif by == "size":
            key = lambda m: (_round_up(self.hidden_sizes[m], self.block),
                             self.activations[m], self.hidden_sizes[m])
        else:
            raise ValueError(by)
        order = sorted(range(self.num_members), key=key)
        return dataclasses.replace(
            self,
            hidden_sizes=tuple(self.hidden_sizes[m] for m in order),
            activations=tuple(self.activations[m] for m in order),
        )

    @property
    def num_members(self) -> int:
        return len(self.hidden_sizes)

    @cached_property
    def padded_sizes(self) -> np.ndarray:
        """Per-member hidden size rounded up to ``block``. shape (P,)."""
        return np.array([_round_up(h, self.block) for h in self.hidden_sizes],
                        dtype=np.int32)

    @cached_property
    def offsets(self) -> np.ndarray:
        """Start offset of member m's slice in the fused hidden axis. (P+1,)."""
        return np.concatenate([[0], np.cumsum(self.padded_sizes)]).astype(np.int32)

    @property
    def total_hidden(self) -> int:
        return int(self.offsets[-1])

    @cached_property
    def segment_ids(self) -> np.ndarray:
        """Member id for every fused hidden unit. shape (total_hidden,)."""
        return np.repeat(np.arange(self.num_members, dtype=np.int32),
                         self.padded_sizes)

    @cached_property
    def hidden_mask(self) -> np.ndarray:
        """1.0 for real hidden units, 0.0 for alignment padding. (total_hidden,)."""
        mask = np.zeros(self.total_hidden, dtype=np.float32)
        for m in range(self.num_members):
            mask[self.offsets[m]: self.offsets[m] + self.hidden_sizes[m]] = 1.0
        return mask

    @cached_property
    def act_ids(self) -> np.ndarray:
        """Activation id (index into ``ACTIVATION_ORDER``) for every fused
        hidden unit. (total_hidden,)."""
        lut = {n: i for i, n in enumerate(sorted(ACTIVATION_NAMES))}
        per_member = np.array([lut[a] for a in self.activations], dtype=np.int32)
        return np.repeat(per_member, self.padded_sizes)

    @cached_property
    def act_runs(self):
        """Contiguous runs of identical activation: list of
        (act_name, start, stop) covering [0, total_hidden)."""
        runs = []
        start = 0
        m = 0
        while m < self.num_members:
            a = self.activations[m]
            stop_m = m
            while (stop_m + 1 < self.num_members
                   and self.activations[stop_m + 1] == a):
                stop_m += 1
            stop = int(self.offsets[stop_m + 1])
            runs.append((a, start, stop))
            start = stop
            m = stop_m + 1
        return runs

    @cached_property
    def member_fan_in(self) -> np.ndarray:
        """Fan-in of the output layer per fused hidden unit (= its member's
        true hidden size). (total_hidden,)."""
        return np.repeat(np.array(self.hidden_sizes, dtype=np.float32),
                         self.padded_sizes)

    @cached_property
    def block_segment_ids(self) -> np.ndarray:
        """Member id per hidden *block* (total_hidden // block,); well
        defined because every member slice is block-aligned."""
        assert self.total_hidden % self.block == 0
        return self.segment_ids[:: self.block].copy()

    @cached_property
    def block_act_ids(self) -> np.ndarray:
        """Activation id per hidden block."""
        assert self.total_hidden % self.block == 0
        return self.act_ids[:: self.block].copy()

    @_instance_cache
    def size_buckets(self):
        """Contiguous runs of members with identical *padded* size →
        static (start_member, n_members, padded_size, start_col) tuples."""
        out = []
        sizes = self.padded_sizes
        m = 0
        while m < self.num_members:
            n = 1
            while m + n < self.num_members and sizes[m + n] == sizes[m]:
                n += 1
            out.append((m, n, int(sizes[m]), int(self.offsets[m])))
            m += n
        return tuple(out)

    def pair_buckets(self, out_pop: "Population", keys: Sequence = None):
        """Contiguous runs of members with identical padded (in, out) widths
        for a block-diagonal ``self``→``out_pop`` projection; ``keys`` (one
        hashable per member) further splits runs.  Returns static
        (start_member, n_members, padded_in, padded_out, in_offset,
        out_offset) tuples."""
        if out_pop.num_members != self.num_members:
            raise ValueError("pair_buckets: member count mismatch "
                             f"({self.num_members} vs {out_pop.num_members})")
        runs = []
        m = 0
        while m < self.num_members:
            n = 1
            key = (self.padded_sizes[m], out_pop.padded_sizes[m],
                   None if keys is None else keys[m])
            while m + n < self.num_members and \
                    (self.padded_sizes[m + n], out_pop.padded_sizes[m + n],
                     None if keys is None else keys[m + n]) == key:
                n += 1
            runs.append((m, n, int(key[0]), int(key[1]),
                         int(self.offsets[m]), int(out_pop.offsets[m])))
            m += n
        return tuple(runs)

    def member_slice(self, m: int) -> slice:
        """Slice of member m's REAL units (excludes padding)."""
        return slice(int(self.offsets[m]),
                     int(self.offsets[m]) + self.hidden_sizes[m])

    def describe(self) -> str:
        by_act = collections.Counter(self.activations)
        return (f"Population(P={self.num_members}, total_hidden={self.total_hidden}, "
                f"block={self.block}, in={self.in_features}, out={self.out_features}, "
                f"acts={dict(by_act)})")

    def layered(self) -> "LayeredPopulation":
        """This population as a depth-1 LayeredPopulation (same layout)."""
        return LayeredPopulation(
            self.in_features, self.out_features,
            tuple((h,) for h in self.hidden_sizes),
            tuple((a,) for a in self.activations), block=self.block)


@dataclasses.dataclass(frozen=True)
class BlockDiagLayout:
    """Static tile metadata for one block-diagonal l→l+1 projection.

    The fused weight is a flat array of (block × block) tiles, member-major,
    row-major over each member's (out_tile, in_tile) grid, with ONE shared
    identity tile appended at index ``n_param_blocks`` (used by
    pass-through members; it is not a parameter).  Step ``s`` reads input
    tile ``s_in[s]`` against weight tile ``s_w[s]`` and accumulates into
    output tile ``s_out[s]``; each output tile's steps are consecutive
    (``s_first``/``s_last`` flag the run edges), which is what lets the
    CUDA kernel walk them as CSR rows (``kernels/fused_layer.py``).  The
    ``*_t`` fields describe the transposed projection of the backward."""
    block: int
    n_in_tiles: int
    n_out_tiles: int
    n_param_blocks: int
    n_steps: int
    s_in: tuple
    s_w: tuple
    s_out: tuple
    s_first: tuple
    s_last: tuple
    n_steps_t: int
    s_in_t: tuple
    s_w_t: tuple
    s_out_t: tuple
    s_first_t: tuple
    s_last_t: tuple
    s_q_t: tuple
    perm_t: tuple
    wb_out_tile: tuple
    wb_in_tile: tuple


def _normalise_member_acts(acts, depth_m: int, member: int):
    if isinstance(acts, str):
        acts = (acts,) * depth_m
    acts = tuple(acts)
    if len(acts) != depth_m:
        raise ValueError(
            f"member {member}: {len(acts)} activations for depth {depth_m}")
    for a in acts:
        if a not in ACTIVATION_NAMES:
            raise ValueError(f"unknown activation {a!r}; "
                             f"known: {sorted(ACTIVATION_NAMES)}")
    return acts


@dataclasses.dataclass(frozen=True)
class LayeredPopulation:
    """P independent deep MLPs with HETEROGENEOUS depths fused into one
    layered layout.

    ``widths[m]`` is member m's per-hidden-layer width tuple (any length
    ≥ 1); ``activations[m]`` is one name (every layer) or one name per
    hidden layer.  A member of depth d < depth occupies, in every layer
    l ≥ d, a slice of its FINAL width that is carried through unchanged
    (identity weight, no bias, identity activation)."""

    in_features: int
    out_features: int
    widths: tuple          # tuple[tuple[int, ...]] — per member, per layer
    activations: tuple     # tuple[tuple[str, ...]] — per member, per layer
    block: int = 8
    n_pad: int = 0         # trailing shard-pad members (see shard_pad)

    def __post_init__(self):
        if len(self.widths) != len(self.activations):
            raise ValueError(
                f"widths ({len(self.widths)}) and activations "
                f"({len(self.activations)}) must have the same length")
        if not self.widths:
            raise ValueError("empty population")
        # a rank's share of a shard-padded layout (``member_range``) may
        # hold fillers only; a whole layout holds at least one real member
        if not 0 <= self.n_pad <= len(self.widths):
            raise ValueError(f"n_pad {self.n_pad} out of range "
                             f"[0, {len(self.widths)}]")
        widths = tuple(tuple(int(h) for h in w) for w in self.widths)
        for m, w in enumerate(widths):
            if len(w) < 1:
                raise ValueError(f"member {m}: needs at least one hidden layer")
            for h in w:
                if h < 1:
                    raise ValueError(f"member {m}: hidden size must be >= 1")
        acts = tuple(_normalise_member_acts(a, len(w), m)
                     for m, (a, w) in enumerate(zip(self.activations, widths)))
        object.__setattr__(self, "widths", widths)
        object.__setattr__(self, "activations", acts)

    @staticmethod
    def grid(in_features: int, out_features: int,
             layer_widths: Sequence[Sequence[int]],
             activations: Sequence[str], repeats: int = 1, block: int = 8,
             sort_members: bool = True) -> "LayeredPopulation":
        """Every widths-tuple × activation pair, repeated."""
        widths, acts = [], []
        for a in activations:
            for w in layer_widths:
                for _ in range(repeats):
                    widths.append(tuple(int(h) for h in w))
                    acts.append(a)
        lp = LayeredPopulation(in_features, out_features, tuple(widths),
                               tuple(acts), block=block)
        return lp.sorted() if sort_members else lp

    def sorted(self) -> "LayeredPopulation":
        """Reorder members so equal-shape members are contiguous.  Shard-pad
        members stay trailing."""
        def key(m):
            return (len(self.widths[m]),
                    tuple(_round_up(h, self.block) for h in self.widths[m]),
                    self.activations[m], self.widths[m])
        n_real = self.num_members - self.n_pad
        order = sorted(range(n_real), key=key) + list(
            range(n_real, self.num_members))
        return dataclasses.replace(
            self,
            widths=tuple(self.widths[m] for m in order),
            activations=tuple(self.activations[m] for m in order))

    @property
    def num_members(self) -> int:
        return len(self.widths)

    @property
    def num_real(self) -> int:
        """Members that exist in the user's population (excludes trailing
        shard-pad filler members)."""
        return self.num_members - self.n_pad

    @cached_property
    def member_depths(self) -> tuple:
        return tuple(len(w) for w in self.widths)

    @property
    def depth(self) -> int:
        return max(self.member_depths)

    def layer_width(self, m: int, l: int) -> int:
        """Member m's width at layer l (its final width once passed-through)."""
        return self.widths[m][min(l, self.member_depths[m] - 1)]

    def layer_act(self, m: int, l: int) -> str:
        """Member m's activation at layer l (identity once passed-through)."""
        return self.activations[m][l] if l < self.member_depths[m] else "identity"

    @_instance_cache
    def layer_pop(self, l: int) -> Population:
        """The fused per-layer layout of hidden layer l."""
        if not 0 <= l < self.depth:
            raise ValueError(f"layer {l} out of range [0, {self.depth})")
        return Population(self.in_features, self.out_features,
                          tuple(self.layer_width(m, l)
                                for m in range(self.num_members)),
                          tuple(self.layer_act(m, l)
                                for m in range(self.num_members)),
                          block=self.block)

    def proj_real(self, m: int, l: int) -> bool:
        """True iff member m has a REAL weight in projection l (layer l→l+1)."""
        return l + 1 < self.member_depths[m]

    @_instance_cache
    def proj_buckets(self, l: int):
        """Buckets of projection l: (m0, n, hin, hout, off_in, off_out, real)
        runs, where ``real`` marks trained weight blocks vs identity
        pass-throughs.  Shard-pad members never merge into a real member's
        bucket."""
        pin, pout = self.layer_pop(l), self.layer_pop(l + 1)
        flags = tuple((self.proj_real(m, l), m >= self.num_real)
                      for m in range(self.num_members))
        return tuple(run + (flags[run[0]][0],)
                     for run in pin.pair_buckets(pout, keys=flags))

    @_instance_cache
    def active_unit_mask(self, l: int) -> np.ndarray:
        """1.0 for fused units of layer l belonging to members whose layer l
        is REAL (depth > l), 0.0 for pass-through slices — gates the
        mid-layer bias."""
        pop = self.layer_pop(l)
        mask = np.zeros(pop.total_hidden, dtype=np.float32)
        for m in range(self.num_members):
            if self.member_depths[m] > l:
                mask[pop.offsets[m]: pop.offsets[m + 1]] = 1.0
        return mask

    @_instance_cache
    def bd_layout(self, l: int) -> BlockDiagLayout:
        """Tile metadata for running projection l as ONE fused kernel (see
        BlockDiagLayout)."""
        pin, pout = self.layer_pop(l), self.layer_pop(l + 1)
        blk = self.block
        P = self.num_members
        ib = (pin.padded_sizes // blk).astype(int)
        ob = (pout.padded_sizes // blk).astype(int)
        in_t0 = (pin.offsets // blk).astype(int)
        out_t0 = (pout.offsets // blk).astype(int)
        real = [self.proj_real(m, l) for m in range(P)]

        base = np.zeros(P, dtype=int)
        acc = 0
        for m in range(P):
            base[m] = acc
            if real[m]:
                acc += ob[m] * ib[m]
        n_param = acc
        ident = n_param                       # shared identity tile (appended)

        n_out_tiles = int(out_t0[P])
        n_in_tiles = int(in_t0[P])

        def ragged_steps(transposed: bool):
            s_in, s_w, s_out, first, last, qs = [], [], [], [], [], []
            for m in range(P):
                n_o, n_i = (ib[m], ob[m]) if transposed else (ob[m], ib[m])
                rd0 = (out_t0 if transposed else in_t0)[m]
                wr0 = (in_t0 if transposed else out_t0)[m]
                for r in range(n_o):
                    t = wr0 + r
                    if real[m]:
                        for k in range(n_i):
                            s_in.append(rd0 + k)
                            s_w.append(base[m] + r * n_i + k)
                            s_out.append(t)
                            first.append(1 if k == 0 else 0)
                            last.append(1 if k == n_i - 1 else 0)
                            qs.append(base[m] + (k * n_o + r if transposed
                                                 else r * n_i + k))
                    else:
                        s_in.append(rd0 + r)
                        s_w.append(ident)
                        s_out.append(t)
                        first.append(1)
                        last.append(1)
                        qs.append(ident)
            return s_in, s_w, s_out, first, last, qs

        s_in, s_w, s_out, s_first, s_last, _ = ragged_steps(False)
        (s_in_t, s_w_t, s_out_t, s_first_t, s_last_t,
         s_q_t) = ragged_steps(True)

        perm = np.zeros(n_param + 1, int)
        perm[n_param] = n_param
        wb_out_tile = np.zeros(n_param, int)
        wb_in_tile = np.zeros(n_param, int)
        for m in range(P):
            if real[m]:
                for r in range(ob[m]):
                    for c in range(ib[m]):
                        q = base[m] + r * ib[m] + c
                        perm[base[m] + c * ob[m] + r] = q
                        wb_out_tile[q] = out_t0[m] + r
                        wb_in_tile[q] = in_t0[m] + c

        ints = lambda a: tuple(int(v) for v in a)
        return BlockDiagLayout(
            block=blk, n_in_tiles=n_in_tiles, n_out_tiles=n_out_tiles,
            n_param_blocks=n_param,
            n_steps=len(s_out), s_in=ints(s_in), s_w=ints(s_w),
            s_out=ints(s_out), s_first=ints(s_first), s_last=ints(s_last),
            n_steps_t=len(s_out_t), s_in_t=ints(s_in_t), s_w_t=ints(s_w_t),
            s_out_t=ints(s_out_t), s_first_t=ints(s_first_t),
            s_last_t=ints(s_last_t), s_q_t=ints(s_q_t),
            perm_t=ints(perm),
            wb_out_tile=ints(wb_out_tile), wb_in_tile=ints(wb_in_tile))

    def shard_pad(self, n_shards: int) -> "LayeredPopulation":
        """Append filler members so the layout divides an ``n_shards``-way
        population axis: member count ≡ 0 (mod n_shards) and every layer's
        fused hidden axis ≡ 0 (mod n_shards·block).  Fillers are
        depth-``depth`` identity-activation members appended AFTER the real
        members, excluded from selection.  Idempotent when already
        divisible."""
        if n_shards <= 1:
            return self
        blk, L = self.block, self.depth
        hidden = [self.layer_pop(l).total_hidden for l in range(L)]
        mod = n_shards * blk
        d = (-self.num_members) % n_shards
        if d == 0 and all(h % mod == 0 for h in hidden):
            return self
        if d == 0:
            d = n_shards          # hidden axes still need fixing
        base = ((blk,) * L,) * (d - 1)
        last = []
        for l in range(L):
            h = hidden[l] + (d - 1) * blk
            c = 1
            while (h + c * blk) % mod:
                c += 1
                assert c <= mod // blk + 1, "shard_pad: no aligning width"
            last.append(c * blk)
        widths = self.widths + base + (tuple(last),)
        acts = self.activations + (("identity",) * L,) * d
        return dataclasses.replace(self, widths=widths, activations=acts,
                                   n_pad=self.n_pad + d)

    def _sort_key(self, m: int):
        """The member-ordering key of ``sorted()``, exposed so growth can
        insert new members at their sorted-merge position."""
        return (len(self.widths[m]),
                tuple(_round_up(h, self.block) for h in self.widths[m]),
                self.activations[m], self.widths[m])

    def grow_positions(self, widths, activations) -> tuple:
        """Insert positions (indices into the GROWN layout) that place each
        new ``(widths, activations)`` member at its sorted-merge slot: after
        every existing member whose sort key is <= its own, so a sorted
        layout stays sorted after :meth:`grow`.  Equal-key new members keep
        their given order.  If the existing real members are not sorted,
        the new members append at the end."""
        acts = tuple(_normalise_member_acts(a, len(tuple(w)), j)
                     for j, (w, a) in enumerate(zip(widths, activations)))
        widths = tuple(tuple(int(h) for h in w) for w in widths)
        old_keys = [self._sort_key(m) for m in range(self.num_real)]
        if any(old_keys[i] > old_keys[i + 1]
               for i in range(len(old_keys) - 1)):
            return tuple(self.num_real + j for j in range(len(widths)))

        def key(j):
            return (len(widths[j]),
                    tuple(_round_up(h, self.block) for h in widths[j]),
                    acts[j], widths[j])
        positions = [0] * len(widths)
        oi = 0                      # old members already passed
        for placed, j in enumerate(sorted(range(len(widths)), key=key)):
            while oi < len(old_keys) and old_keys[oi] <= key(j):
                oi += 1
            positions[j] = oi + placed
        return tuple(positions)

    def grow(self, widths, activations, positions) -> "LayeredPopulation":
        """A fresh layout with new REAL members spliced in, the inverse of
        :meth:`subset` (``core/lifecycle.py``).  ``positions[j]`` is the
        index in the result where new member ``j`` lands; the existing
        members fill the rest in order, so ``grown.subset(rest) == self``.
        Needs a layout without shard-pad fillers; the depth extends when a
        new member is deeper than every existing one."""
        if self.n_pad:
            raise ValueError(
                "grow: layout carries shard-pad fillers; grow the real "
                "layout (compact / subset first), then shard_pad the result")
        widths = tuple(tuple(int(h) for h in w) for w in widths)
        acts = tuple(_normalise_member_acts(a, len(w), j)
                     for j, (w, a) in enumerate(zip(widths, activations)))
        if len(widths) != len(acts) or not widths:
            raise ValueError("grow: need at least one new member, with one "
                             "activation spec per member")
        positions = tuple(int(p) for p in positions)
        if len(positions) != len(widths):
            raise ValueError(
                f"grow: {len(positions)} positions for {len(widths)} new "
                "members")
        n_total = self.num_real + len(widths)
        for p in positions:
            if not 0 <= p < n_total:
                raise ValueError(
                    f"grow: position {p} out of range [0, {n_total})")
        if len(set(positions)) != len(positions):
            raise ValueError(f"grow: duplicate positions in {positions}")
        pos_map = dict(zip(positions, range(len(widths))))
        out_w, out_a = [], []
        oi = 0
        for m in range(n_total):
            if m in pos_map:
                out_w.append(widths[pos_map[m]])
                out_a.append(acts[pos_map[m]])
            else:
                out_w.append(self.widths[oi])
                out_a.append(self.activations[oi])
                oi += 1
        return LayeredPopulation(self.in_features, self.out_features,
                                 tuple(out_w), tuple(out_a),
                                 block=self.block)

    def subset(self, keep) -> "LayeredPopulation":
        """A fresh layout of the given REAL members only, the lifecycle's
        compaction primitive (``core/lifecycle.py``).  ``keep`` is strictly
        increasing; member order is kept, so buckets split by a pruned
        member merge again, and the depth shrinks when the deepest members
        go.  The new instance starts with empty device caches."""
        keep = tuple(int(m) for m in keep)
        if not keep:
            raise ValueError("subset: empty keep set")
        prev = -1
        for m in keep:
            if not 0 <= m < self.num_real:
                raise ValueError(
                    f"subset: member {m} out of range [0, {self.num_real}) "
                    "(shard-pad fillers cannot survive)")
            if m <= prev:
                raise ValueError(
                    "subset: keep indices must be strictly increasing, got "
                    f"{keep}")
            prev = m
        return LayeredPopulation(
            self.in_features, self.out_features,
            tuple(self.widths[m] for m in keep),
            tuple(self.activations[m] for m in keep), block=self.block)

    def member_range(self, start: int, stop: int) -> "LayeredPopulation":
        """The layout of members ``[start, stop)``, in order, FILLERS
        INCLUDED: the shard-pad fillers of the range stay trailing and are
        its ``n_pad`` (a range of fillers only has no real member).  One
        rank's share of the population axis
        (``repro_torch.distributed.sharding``).  A member keeps its padded
        slices, its buckets' keys and its depth, so every member-major
        array of the range is a slice of the whole layout's; the depth is
        the range's deepest member's, so layers that only pass the
        range's members through are dropped (as ``subset`` drops them).
        The new instance starts with empty device caches."""
        start, stop = int(start), int(stop)
        if not 0 <= start < stop <= self.num_members:
            raise ValueError(f"member_range: [{start}, {stop}) is not a "
                             f"non-empty range of [0, {self.num_members})")
        return LayeredPopulation(
            self.in_features, self.out_features, self.widths[start:stop],
            self.activations[start:stop], block=self.block,
            n_pad=stop - max(start, self.num_real) if stop > self.num_real
            else 0)

    def describe(self) -> str:
        by_depth = collections.Counter(self.member_depths)
        pad = f", pad={self.n_pad}" if self.n_pad else ""
        return (f"LayeredPopulation(P={self.num_members}{pad}, depth={self.depth}, "
                f"block={self.block}, in={self.in_features}, "
                f"out={self.out_features}, depths={dict(sorted(by_depth.items()))}, "
                f"fused_hidden={[self.layer_pop(l).total_hidden for l in range(self.depth)]})")
