"""Synthetic data substrate.

Two generators:

  * ``TabularTask`` — the paper's controlled datasets (§4.3): N samples ×
    F features, Gaussian cluster-per-class with class-dependent means, so
    MLPs of different capacity separate measurably.  Deterministic in seed.

  * ``TokenTask`` — LM token streams for the assigned architectures: a
    fixed-seed Markov-ish stream (nontrivial bigram structure so loss
    actually falls during the end-to-end examples).

Batching is STEP-INDEXED: ``batch(step)`` is a pure function of
(seed, step), so a restarted/elastically-rescaled job consumes identical
data without any iterator state in the checkpoint — the fault-tolerance
design's data half (DESIGN.md §5)."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TabularTask:
    n_samples: int
    n_features: int
    n_classes: int = 2
    seed: int = 0
    noise: float = 1.0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # class means on a scaled simplex + random rotation → linearly
        # separable-ish but benefits from nonlinearity via noise mixing
        means = rng.normal(0, 2.0, (self.n_classes, self.n_features))
        rot = np.linalg.qr(rng.normal(
            0, 1, (self.n_features, self.n_features)))[0]
        y = rng.integers(0, self.n_classes, self.n_samples)
        x = means[y] + self.noise * rng.normal(
            0, 1, (self.n_samples, self.n_features))
        x = (x @ rot).astype(np.float32)
        # nonlinear warp so identity-activation members underfit
        x[:, ::2] = np.tanh(x[:, ::2])
        self.x, self.y = x, y.astype(np.int32)

    def batch(self, step: int, batch_size: int):
        """Deterministic without-replacement epoch shuffling by step index."""
        n = self.n_samples
        per_epoch = max(n // batch_size, 1)
        epoch, k = divmod(step, per_epoch)
        order = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch])).permutation(n)
        idx = order[(k * batch_size) % n: (k * batch_size) % n + batch_size]
        if len(idx) < batch_size:  # wrap
            idx = np.concatenate([idx, order[:batch_size - len(idx)]])
        return self.x[idx], self.y[idx]

    def batch_slab(self, start: int, n_steps: int, batch_size: int,
                   out=None, rows=None):
        """``n_steps`` consecutive batches as one ``(n_steps, ...)`` slab —
        VALUE-IDENTICAL to stacking ``batch(step)`` for ``step`` in
        ``[start, start + n_steps)`` (tests/test_pipeline.py pins this).

        This is the §11 producer-granularity build: ``batch`` must stay a
        pure random-access function of ``step``, so every call re-derives
        its epoch's n-sample permutation; a slab builder knows its steps
        are consecutive and derives each epoch order ONCE (single-entry
        cache, so consecutive slabs inside one epoch pay only the row
        gathers).  ``out=(xs, ys)`` writes into caller-owned staging
        buffers (the prefetcher's alternating pair) instead of
        allocating.  ``rows=(lo, hi)`` builds only rows ``[lo, hi)`` of
        each batch (a rank's share of a batch split over the data axis):
        the full slab's ``[:, lo:hi]``."""
        n = self.n_samples
        per_epoch = max(n // batch_size, 1)
        lo, hi = (0, batch_size) if rows is None else rows
        if out is not None:
            xs, ys = out
        else:
            xs = np.empty((n_steps, hi - lo, self.n_features), np.float32)
            ys = np.empty((n_steps, hi - lo), np.int32)
        for j in range(n_steps):
            epoch, k = divmod(start + j, per_epoch)
            cached = getattr(self, "_epoch_order", None)
            if cached is None or cached[0] != epoch:
                cached = (epoch, np.random.default_rng(
                    np.random.SeedSequence([self.seed, epoch])).permutation(n))
                self._epoch_order = cached
            order = cached[1]
            idx = order[(k * batch_size) % n: (k * batch_size) % n
                        + batch_size]
            if len(idx) < batch_size:  # wrap, as batch() does
                idx = np.concatenate([idx, order[:batch_size - len(idx)]])
            idx = idx[lo:hi]
            xs[j], ys[j] = self.x[idx], self.y[idx]
        return xs, ys

    def split(self, frac: float = 0.8):
        k = int(self.n_samples * frac)
        return (self.x[:k], self.y[:k]), (self.x[k:], self.y[k:])


@dataclasses.dataclass
class TokenTask:
    vocab: int
    seed: int = 0
    order: int = 1          # bigram structure strength

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # sparse-ish bigram preference table (vocab capped for the table)
        v = min(self.vocab, 4096)
        self._v = v
        self._jump = rng.integers(1, v - 1, size=v)

    def batch(self, step: int, batch_size: int, seq_len: int):
        """tokens[t+1] is a deterministic function of tokens[t] with noise —
        learnable structure, pure function of (seed, step)."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        v = self._v
        toks = np.empty((batch_size, seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, v, batch_size)
        noise = rng.random((batch_size, seq_len)) < 0.15
        rand = rng.integers(0, v, (batch_size, seq_len))
        for t in range(seq_len):
            nxt = (toks[:, t] + self._jump[toks[:, t] % v]) % v
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def lm_batch(task: TokenTask, step: int, batch_size: int, seq_len: int):
    return task.batch(step, batch_size, seq_len)
