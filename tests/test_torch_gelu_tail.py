"""The exact gelu's negative tail, held against the JAX package on the CPU.

JAX computes ``jax.nn.gelu(approximate=False)`` as x/2 · erfc(−x/√2), and
so does the port, on the CPU (``core/activations.py``) and in its kernels
(``csrc/activations.cuh``); the derivative is JAX's too, 0.5·erfc(−x/√2) +
x·exp(−x²/2)/√(2π).  The form x/2 · (1 + erf(x/√2)) would cancel for x
well below 0: 8.4e-4 relative off the exact value where |gelu| > 1e-3, 0.17
where |gelu| > 1e-6, and 0 below x ≈ −5.5, all inside the f32 tests' atol
(1e-5).  These tests hold the port to the exact value in relative terms
wherever |gelu| > 1e-6 (within 1e-5; JAX is within 1.6e-6), and hold the
tail's size through the activation and its derivative alone, the segmented
activation and the fused input layer on pre-activations in the tail, and
populations of gelu members whose every layer sits in the tail, on the
fused and the unfused route, in f32 and under the bf16 compute policy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

from repro.core import activations as jact
from repro.core import deep as jdeep
from repro.core.population import LayeredPopulation as JLayered
from repro.kernels import ops as jops
from repro_torch.core import activations as tact
from repro_torch.core import deep as tdeep
from repro_torch.core.population import LayeredPopulation as TLayered
from repro_torch.core.tree import tree_leaves
from repro_torch.kernels import ops as tops

RTOL, ATOL = 1e-4, 1e-5          # the f32 tests' tolerance
FWD = dict(rtol=2e-2, atol=2e-2)  # the bf16 policy's forward tolerance
GRAD = dict(rtol=1e-2, atol=1e-3)
# the port's gelu against the exact value and JAX's, anywhere in [−10, 10]
# (measured: 3.8e-7 and 2.4e-7; the erf form's were 1.07e-6 and 1.19e-6),
# and its derivative's (measured: 1.1e-7 and 1.2e-7)
GELU_ABS, DGELU_ABS = 2e-6, 5e-7
TAIL_SHIFT = -6.0                 # the biases that put every layer in the tail

_WIDTHS = ((5, 3), (12, 9), (7,), (17, 9, 5), (8, 8))
JLP = JLayered(6, 3, _WIDTHS, ("gelu",) * len(_WIDTHS), block=8)
TLP = TLayered(6, 3, _WIDTHS, ("gelu",) * len(_WIDTHS), block=8)
B = 12


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _exact_gelu(x):
    x = np.asarray(x, np.float64)
    return 0.5 * x * scipy.special.erfc(-x / np.sqrt(2))


def test_gelu_and_derivative_against_jax():
    """The activation and its derivative on a grid of [−10, 10], each
    package on its own copy of the grid: the port's within ``GELU_ABS`` /
    ``DGELU_ABS`` of the exact values and of JAX's, JAX's within them of
    the exact values.  Relative to the exact value where |gelu| > 1e-6,
    the port's and JAX's errors stay below 1e-5 (measured 1.3e-6 and
    1.6e-6)."""
    grid = np.linspace(-10, 10, 20001).astype(np.float32)
    x64 = grid.astype(np.float64)
    exact = _exact_gelu(grid)
    dexact = (0.5 * scipy.special.erfc(-x64 / np.sqrt(2))
              + x64 * np.exp(-0.5 * x64 * x64) / np.sqrt(2 * np.pi))
    tx = torch.tensor(grid)
    got = tact.ACTIVATIONS["gelu"](tx).numpy().astype(np.float64)
    dgot = tact.ACTIVATION_DERIVS["gelu"](tx).numpy().astype(np.float64)
    jx = jnp.array(grid.copy())
    want = np.asarray(jact.ACTIVATIONS["gelu"](jx), np.float64)
    dwant = np.asarray(jax.vmap(jax.grad(jact.ACTIVATIONS["gelu"]))(jx),
                       np.float64)
    for what, a, b, tol in (("port vs exact", got, exact, GELU_ABS),
                            ("JAX vs exact", want, exact, GELU_ABS),
                            ("port vs JAX", got, want, GELU_ABS),
                            ("port' vs exact", dgot, dexact, DGELU_ABS),
                            ("JAX' vs exact", dwant, dexact, DGELU_ABS),
                            ("port' vs JAX'", dgot, dwant, DGELU_ABS)):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=what)

    def rel(v, floor):
        big = np.abs(exact) > floor
        return (np.abs(v - exact)[big] / np.abs(exact)[big]).max()

    assert rel(got, 1e-3) < 1e-3
    assert rel(got, 1e-6) < 1e-5
    assert rel(want, 1e-6) < 1e-5


@pytest.mark.parametrize("block", [8, 16])
def test_seg_act_tail_matches_jax(block):
    """Gelu blocks on pre-activations in [−10, −3]: ``act(h)·mask`` and
    ``(dy·mask)·act'(h)`` against JAX's ``ops.seg_act`` (interpret) and its
    ``jax.vjp`` at the f32 tolerance."""
    rng = np.random.default_rng(block)
    n_blocks = 6
    hh = n_blocks * block
    h = rng.uniform(-10, -3, (B, hh)).astype(np.float32)
    dy = rng.normal(0, 1, (B, hh)).astype(np.float32)
    ids = np.full(n_blocks, jact.ACTIVATION_ORDER.index("gelu"), np.int32)
    mask = (rng.random(hh) > 0.25).astype(np.float32)
    jy, vjp = jax.vjp(lambda a: jops.seg_act(a, ids.copy(), mask.copy(),
                                             block_h=block, interpret=True),
                      jnp.asarray(h))
    (jdh,) = vjp(jnp.asarray(dy))
    th = _t(h).requires_grad_(True)
    y = tops.seg_act(th, ids, mask, block=block)
    (dh,) = torch.autograd.grad(y, (th,), _t(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dh.numpy(), np.asarray(jdh), rtol=RTOL,
                               atol=ATOL)


def test_fused_input_tail_matches_jax():
    """The fused input layer with gelu blocks whose bias puts u in the
    tail, against JAX's ``ops.fused_input_infer`` (its kernel, interpret
    mode on the CPU)."""
    rng = np.random.default_rng(3)
    block, n_blocks, f = 8, 6, 6
    hh = block * n_blocks
    x = rng.normal(0, 1, (B, f)).astype(np.float32)
    w = (rng.normal(0, 1, (hh, f)) / np.sqrt(f)).astype(np.float32)
    bias = rng.uniform(-9, -4, hh).astype(np.float32)
    mask = (rng.random(hh) > 0.2).astype(np.float32)
    ids = np.full(n_blocks, jact.ACTIVATION_ORDER.index("gelu"), np.int32)
    want = jops.fused_input_infer(x, w, bias, ids, mask, block=block)
    got = tops.fused_input_infer(_t(x), _t(w), _t(bias), ids, mask,
                                 block=block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _tail_params():
    """JAX's initial weights with every layer's bias moved by
    ``TAIL_SHIFT``: each member's pre-activations lie in the tail."""
    p = jax.device_get(jdeep.init_params(jax.random.PRNGKey(0), JLP))
    p["b_in"] = p["b_in"] + TAIL_SHIFT
    for m in p["mid"]:
        m["b"] = m["b"] + TAIL_SHIFT
    return p


_ROUTES = {"fused": dict(bd_impl="fused"),
           "unfused": dict(bd_impl="pallas", act_impl="pallas")}


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("route", sorted(_ROUTES))
def test_tail_population_matches_jax(route, compute_dtype):
    """Gelu members in the tail through a whole forward (logits) and the
    loss's f32 gradients, against JAX's: at the f32 tolerance, or under the
    bf16 policy at its forward and gradient tolerances."""
    kw = _ROUTES[route]
    np_params = _tail_params()
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (B, 6)).astype(np.float32)
    y = rng.integers(0, 3, B).astype(np.int32)
    params = tdeep.params_from_numpy(np_params, TLP, device="cpu")
    static = ("lp", "bd_impl", "act_impl", "compute_dtype")
    want = jax.jit(jdeep.forward, static_argnames=static + ("infer",))(
        np_params, x, JLP, compute_dtype=compute_dtype, infer=True, **kw)
    got = tdeep.forward(params, _t(x), TLP, compute_dtype=compute_dtype,
                        infer=True, **kw)
    fwd = FWD if compute_dtype else dict(rtol=RTOL, atol=ATOL)
    grad = GRAD if compute_dtype else dict(rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **fwd)
    (_, _), jgrads = jax.jit(
        jax.value_and_grad(jdeep.fused_loss, has_aux=True),
        static_argnames=static)(np_params, x, y, JLP,
                                compute_dtype=compute_dtype, **kw)
    _, _, grads = tdeep.loss_and_grads(params, _t(x), _t(y, torch.long),
                                       TLP, compute_dtype=compute_dtype, **kw)
    gl, wl = tree_leaves(grads), jax.tree.leaves(jgrads)
    assert len(gl) == len(wl)
    for i, (a, b) in enumerate(zip(gl, wl)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   err_msg=f"leaf {i}", **grad)
