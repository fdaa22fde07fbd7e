"""The port's feature selection (``repro_torch/core/feature_selection.py``,
the paper's §7) held against the JAX package's on the CPU: the same numpy
parameters, masks and batches through both.  The port's step runs on the
M3 route it is given (``m3_impl="pallas"``: the kernels' plain versions on
the CPU); JAX's ``masked_sgd_step`` runs its default route.  Tolerances:
masks and masked parameters exactly; parameters after 3 steps rtol 2e-4 /
atol 2e-5 (tests/test_independence.py); importance 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import feature_selection as jfs
from repro.core import parallel_mlp as jpm
from repro.core.population import Population as JPopulation
from repro_torch.core import feature_selection as tfs
from repro_torch.core import parallel_mlp as tpm
from repro_torch.core.population import Population as TPopulation
from repro_torch.launch import launch_count as tlc

SIZES, ACTS = (4, 7, 3, 9, 1), ("relu", "tanh", "gelu", "mish", "sigmoid")
JPOP = JPopulation(6, 2, SIZES, ACTS, block=4)
TPOP = TPopulation(6, 2, SIZES, ACTS, block=4)
MASKS = np.asarray([[1, 1, 0, 0, 1, 1],
                    [1, 0, 1, 0, 1, 0],
                    [0, 1, 1, 1, 0, 0],
                    [1, 1, 1, 1, 1, 1],
                    [0, 0, 0, 0, 0, 1]], np.float32)
STEP = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module")
def np_params():
    return jax.device_get(jpm.init_params(jax.random.PRNGKey(0), JPOP))


def _tparams(np_params):
    return tpm.params_from_numpy(np_params, TPOP, device="cpu")


def test_unit_and_applied_masks_equal_jax(np_params):
    want = np.asarray(jfs.unit_masks(JPOP, MASKS))
    got = tfs.unit_masks(TPOP, torch.from_numpy(MASKS))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tfs.unit_masks(TPOP, MASKS).numpy(), want)
    jm = jfs.apply_masks(np_params, JPOP, MASKS)
    tm = tfs.apply_masks(_tparams(np_params), TPOP, MASKS)
    for k in tpm.KEYS:
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]),
                                      err_msg=k)


@pytest.mark.parametrize("m3_impl", ["bucketed", "pallas"])
def test_masked_sgd_steps_match_jax(np_params, m3_impl):
    """3 projected SGD steps: the parameters, losses and per-member losses
    against JAX's; every masked w1 entry exactly 0 after every step; with
    ``m3_impl="pallas"`` one launch of each M3 kernel a step."""
    rng = np.random.default_rng(2)
    xs = rng.normal(0, 1, (3, 16, 6)).astype(np.float32)
    ys = rng.integers(0, 2, (3, 16)).astype(np.int32)
    jp, tp = np_params, _tparams(np_params)
    masked_out = 1.0 - tfs.unit_masks(TPOP, MASKS)
    tlc.reset_kernel_launches()
    for x, y in zip(xs, ys):
        jp, jloss, jper = jfs.masked_sgd_step(jp, jnp.asarray(x),
                                              jnp.asarray(y), 0.1, JPOP,
                                              MASKS)
        tp, tloss, tper = tfs.masked_sgd_step(
            tp, torch.from_numpy(x), torch.from_numpy(y), 0.1, TPOP,
            torch.from_numpy(MASKS), m3_impl=m3_impl)
        assert (tp["w1"] * masked_out).abs().max().item() == 0.0
        np.testing.assert_allclose(tper.numpy(), np.asarray(jper), **STEP)
        np.testing.assert_allclose(tloss.item(), float(jloss), **STEP)
    for k in tpm.KEYS:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   err_msg=k, **STEP)
    m3 = {k: v for k, v in tlc.kernel_launches().items()
          if k.startswith("m3_") and v}
    want = ({k: 3 * v for k, v in tlc.m3_step_launches().items()}
            if m3_impl == "pallas" else {})
    assert m3 == want


def test_feature_importance_equals_jax():
    rng = np.random.default_rng(3)
    masks = (rng.random((40, 9)) < 0.5).astype(np.float32)
    masks[:, 4] = 1.0   # a feature every member sees
    losses = rng.random(40).astype(np.float32)
    want = np.asarray(jfs.feature_importance(JPOP, masks, losses))
    for m, l in ((masks, losses),
                 (torch.from_numpy(masks), torch.from_numpy(losses))):
        np.testing.assert_allclose(tfs.feature_importance(TPOP, m, l), want,
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("keep_prob,always_full", [(0.7, 0), (0.5, 4),
                                                   (0.02, 3)])
def test_random_masks_rules(keep_prob, always_full):
    """JAX's distribution and rules on the port's generator: (P, F)
    float32 of zeros and ones, at least one feature a row (feature 0
    where the draw kept none), the first ``always_full`` rows all ones,
    the same masks from the same seed."""
    p, f = 300, 7

    def draw(seed):
        return tfs.random_masks(torch.Generator().manual_seed(seed), p, f,
                                keep_prob=keep_prob,
                                always_full=always_full, device="cpu")
    m = draw(5)
    assert m.shape == (p, f) and m.dtype == torch.float32
    assert set(m.unique().tolist()) <= {0.0, 1.0}
    assert (m.sum(-1) >= 1).all()
    assert (m[:always_full] == 1).all()
    only_f0 = (m.sum(-1) == 1) & (m[:, 0] == 1)
    if keep_prob < 0.1:   # most rows drew nothing and got feature 0
        assert only_f0[always_full:].float().mean() > 0.5
    kept = m[always_full:].mean().item()
    assert abs(kept - keep_prob) < 0.1 or keep_prob < 0.1
    assert torch.equal(m, draw(5)) and not torch.equal(m, draw(6))
