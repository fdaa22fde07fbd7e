"""The paper's ten activation functions, and two ways of applying a
*different* activation to different column slices of a fused hidden tensor.

Ids follow ``ACTIVATION_ORDER`` (the sorted names), shared with
``Population.act_ids`` and the CUDA kernels' epilogue
(``kernels/csrc/activations.cuh``).  Definitions match the JAX package's
exactly: gelu is the exact form x/2·erfc(−x/√2), JAX's, leaky_relu has slope 0.01,
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
    # erfc, not 1 + erf: the sum cancels for x below 0
    return 0.5 * x * torch.special.erfc(-x * 0.7071067811865476)


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


# ---------------------------------------------------------------------- #
# derivatives — JAX's values (``jax.vjp`` at ones), kinks included       #
# ---------------------------------------------------------------------- #
# relu'(0) = 0 (jax.nn.relu's custom jvp); leaky_relu'(0) = 1 (the
# ``where(x >= 0)`` form); elu'(0) = 1 and selu'(0) = scale·alpha (the
# ``x > 0`` branch is strict); hardshrink'(±0.5) = 0 (strict inequalities);
# mish' uses d softplus/dx = exp(x − softplus(x)), logaddexp's jvp.
_SELU_SCALE = 1.0507009873554804934193349852946
_SELU_ALPHA = 1.6732632423543772848170429916717


def _d_identity(x):
    return torch.ones_like(x)


def _d_sigmoid(x):
    s = torch.sigmoid(x)
    return s * (1 - s)


def _d_tanh(x):
    t = torch.tanh(x)
    return 1 - t * t


def _d_relu(x):
    return (x > 0).to(x.dtype)


def _d_elu(x):
    return torch.where(x > 0, torch.ones_like(x),
                       torch.exp(torch.where(x > 0, torch.zeros_like(x), x)))


def _d_selu(x):
    return _SELU_SCALE * torch.where(
        x > 0, torch.ones_like(x),
        _SELU_ALPHA * torch.exp(torch.where(x > 0, torch.zeros_like(x), x)))


def _d_gelu(x):
    return (0.5 * torch.special.erfc(-x * 0.7071067811865476)
            + x * torch.exp(-0.5 * x * x) * 0.3989422804014327)


def _d_leaky_relu(x):
    return torch.where(x >= 0, torch.ones_like(x),
                       torch.full_like(x, 0.01))


def _d_hardshrink(x, lambd: float = 0.5):
    return ((x > lambd) | (x < -lambd)).to(x.dtype)


def _d_mish(x):
    sp = torch.logaddexp(x, torch.zeros_like(x))
    t = torch.tanh(sp)
    return t + x * (1 - t * t) * torch.exp(x - sp)


ACTIVATION_DERIVS = {
    "identity": _d_identity,
    "sigmoid": _d_sigmoid,
    "tanh": _d_tanh,
    "relu": _d_relu,
    "elu": _d_elu,
    "selu": _d_selu,
    "gelu": _d_gelu,
    "leaky_relu": _d_leaky_relu,
    "hardshrink": _d_hardshrink,
    "mish": _d_mish,
}
ACTIVATION_DERIV_FNS = tuple(ACTIVATION_DERIVS[n] for n in ACTIVATION_ORDER)


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
    return _select(h, act_ids, ACTIVATION_FNS, torch.zeros_like(h))


def apply_activation_derivs_masked(h: torch.Tensor, act_ids) -> torch.Tensor:
    """The activations' derivatives at ``h``, selected by per-column id —
    the plain form of the training kernels' g' epilogue.  An id outside
    ``ACTIVATION_ORDER`` gives NaN, as the kernels do."""
    return _select(h, act_ids, ACTIVATION_DERIV_FNS,
                   torch.full_like(h, float("nan")))


def _select(h: torch.Tensor, act_ids, fns, out) -> torch.Tensor:
    ids = torch.as_tensor(act_ids, device=h.device)
    for i, fn in enumerate(fns):
        out = torch.where(ids == i, fn(h), out)
    return out
