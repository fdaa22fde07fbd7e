"""The paper's ten activation functions, and two ways of applying a
*different* activation to different column slices of a fused hidden tensor.

Ids follow ``ACTIVATION_ORDER`` (the sorted names), shared with
``Population.act_ids`` and the CUDA kernels' epilogue
(``kernels/csrc/activations.cuh``).  Definitions match the JAX package's
exactly: gelu is the exact (erf) form, leaky_relu has slope 0.01,
hardshrink uses λ=0.5 with strict inequalities, mish is
``x·tanh(softplus(x))`` with ``softplus(x) = logaddexp(x, 0)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _identity(x):
    return x


def _sigmoid(x):
    return torch.sigmoid(x)


def _tanh(x):
    return torch.tanh(x)


def _relu(x):
    return torch.relu(x)


def _elu(x):
    return F.elu(x)


def _selu(x):
    return F.selu(x)


def _gelu(x):
    return F.gelu(x, approximate="none")


def _leaky_relu(x):
    return torch.where(x >= 0, x, 0.01 * x)


def _hardshrink(x, lambd: float = 0.5):
    return torch.where((x > lambd) | (x < -lambd), x, torch.zeros_like(x))


def _mish(x):
    return x * torch.tanh(torch.logaddexp(x, torch.zeros_like(x)))


ACTIVATIONS = {
    "identity": _identity,
    "sigmoid": _sigmoid,
    "tanh": _tanh,
    "relu": _relu,
    "elu": _elu,
    "selu": _selu,
    "gelu": _gelu,
    "leaky_relu": _leaky_relu,
    "hardshrink": _hardshrink,
    "mish": _mish,
}
ACTIVATION_NAMES = frozenset(ACTIVATIONS)
# canonical id order — shared with Population.act_ids and the CUDA kernels
ACTIVATION_ORDER = tuple(sorted(ACTIVATIONS))
ACTIVATION_FNS = tuple(ACTIVATIONS[n] for n in ACTIVATION_ORDER)
PAPER_TEN = ("identity", "sigmoid", "tanh", "relu", "elu", "selu", "gelu",
             "leaky_relu", "hardshrink", "mish")


def apply_activations_sliced(h: torch.Tensor, runs) -> torch.Tensor:
    """Apply per-run activations to contiguous column slices.

    ``runs`` is ``Population.act_runs``: static (name, start, stop) triples.
    One elementwise pass per run; with a sorted population that is at most
    ten passes over disjoint slices."""
    pieces = [ACTIVATIONS[name](h[..., start:stop])
              for name, start, stop in runs]
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=-1)


def apply_activations_masked(h: torch.Tensor, act_ids) -> torch.Tensor:
    """Branchless: evaluate every activation present, select by per-column
    id.  The oracle, and the plain form the kernels are checked against."""
    ids = torch.as_tensor(act_ids, device=h.device)
    out = torch.zeros_like(h)
    for i, fn in enumerate(ACTIVATION_FNS):
        out = torch.where(ids == i, fn(h), out)
    return out
