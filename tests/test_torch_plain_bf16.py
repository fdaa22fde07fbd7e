"""The plain versions of three kernels on bf16 operands, against the JAX
package's Pallas kernels in interpret mode: ``infer_head_plain``,
``m3_matmul_fwd_plain`` and ``block_diag_fwd_plain``.  JAX's kernels
multiply and sum in an f32 accumulator (``preferred_element_type``) and
cast once at the flush; the plain versions must do the same, not sum in
the operands' dtype.  Inputs are made with numpy from a seed and rounded
to bf16 once, the same values on both sides.

Tolerance: an f32 output (the head) at rtol 1e-5 / atol 1e-6, as
tests/test_torch_serve.py (both sides sum exact f32 products, in other
orders); a bf16 output within one bf16 ulp (both round an f32 sum once,
and two orders of that sum may round to neighbouring bf16 values).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.activations import ACTIVATION_ORDER
from repro.core.population import LayeredPopulation as JLayered
from repro.kernels import ops as jops
from repro_torch.core.population import LayeredPopulation as TLayered
from repro_torch.kernels import block_diag as bdk
from repro_torch.kernels import fused_layer as flk
from repro_torch.kernels import infer_head as ihk
from repro_torch.kernels import m3_matmul as m3k

F32 = dict(rtol=1e-5, atol=1e-6)


def _bf16(a):
    """numpy f32 → (the same bf16 values for JAX, for torch)."""
    return (jnp.asarray(a, jnp.bfloat16),
            torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16))


def _ordered(t: torch.Tensor) -> np.ndarray:
    """bf16 values → integers in the order of the values, one apart for
    neighbouring bf16 numbers (±0 both 0)."""
    i = t.contiguous().view(torch.int16).numpy().astype(np.int32)
    return np.where(i < 0, -(i & 0x7FFF), i)


def _within_one_bf16_ulp(got: torch.Tensor, want):
    assert got.dtype == torch.bfloat16
    want = torch.from_numpy(np.array(want.astype(jnp.float32))).to(
        torch.bfloat16)
    assert got.shape == want.shape
    assert np.abs(_ordered(got) - _ordered(want)).max() <= 1


def _segments(widths, block):
    blocks = [-(-w // block) for w in widths]
    seg = np.repeat(np.arange(len(widths)), blocks).astype(np.int32)
    ptr = ihk.member_ptr(torch.from_numpy(seg), len(widths))
    return seg, ptr, int(sum(blocks)) * block


@pytest.mark.parametrize("log_probs", [False, True])
@pytest.mark.parametrize("widths,block,o,b", [
    ((128,) * 6, 128, 2, 32),                   # parallelmlp-10k's members
    ((8, 16, 8, 16, 16, 8, 24), 8, 2, 9),       # the depth-3 head's
    ((40, 12, 100, 4), 4, 5, 33),
])
def test_infer_head_plain_bf16_matches_jax(widths, block, o, b, log_probs):
    """f32 logits (or log-probs) from bf16 h and w2."""
    rng = np.random.default_rng(b + o)
    seg, ptr, hh = _segments(widths, block)
    jh, th = _bf16(rng.normal(0, 1, (b, hh)).astype(np.float32))
    jw, tw = _bf16((rng.normal(0, 1, (o, hh)) / 4).astype(np.float32))
    b2 = rng.normal(0, 1, (len(widths), o)).astype(np.float32)
    want = jops.infer_head(jh, jw, b2, seg, block_h=block,
                           log_probs=log_probs, interpret=True)
    got = ihk.infer_head_plain(th, tw, torch.from_numpy(b2), ptr,
                               block=block, log_probs=log_probs)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("widths,block,o,b", [
    ((128,) * 6, 128, 2, 32),
    ((8, 16, 8, 16, 16, 8, 24), 8, 2, 9),
    ((40, 12, 100, 4), 4, 16, 33),
])
def test_m3_matmul_fwd_plain_bf16_matches_jax(widths, block, o, b):
    """bf16 logits, summed in f32, from bf16 h and w2."""
    rng = np.random.default_rng(3 * b + o)
    seg, ptr, hh = _segments(widths, block)
    jh, th = _bf16(rng.normal(0, 1, (b, hh)).astype(np.float32))
    jw, tw = _bf16((rng.normal(0, 1, (o, hh)) / 4).astype(np.float32))
    want = jops.m3_matmul(jh, jw, seg, len(widths), block_h=block,
                          interpret=True)
    _within_one_bf16_ulp(m3k.m3_matmul_fwd_plain(th, tw, ptr, block=block),
                         want)


@pytest.mark.parametrize("widths,block", [
    (((5, 3), (12, 9), (7,), (17, 9, 5), (24, 16), (9, 9, 9)), 8),
    (((40, 20), (17, 33, 9), (7,), (3, 5)), 16),
])
def test_block_diag_fwd_plain_bf16_matches_jax(widths, block):
    """Every mid layer's block-diagonal product in bf16, summed in f32, from
    bf16 activations and tiles (pass-through members included)."""
    acts = tuple(ACTIVATION_ORDER[i % 10] for i in range(len(widths)))
    jlp = JLayered(5, 3, widths, acts, block=block)
    tlp = TLayered(5, 3, widths, acts, block=block)
    rng = np.random.default_rng(block)
    for l in range(jlp.depth - 1):
        jlay, tlay = jlp.bd_layout(l), tlp.bd_layout(l)
        jx, tx = _bf16(rng.normal(0, 1, (11, jlay.n_in_tiles * block))
                       .astype(np.float32))
        jw, tw = _bf16((rng.normal(0, 1, (jlay.n_param_blocks, block,
                                          block)) / np.sqrt(block))
                       .astype(np.float32))
        want = jops.block_diag_gemm(jx, jw, jlay, interpret=True)
        wb = torch.cat([tw, torch.eye(block, dtype=torch.bfloat16)[None]])
        got = bdk.block_diag_fwd_plain(tx, wb, *flk.schedule_on(tlay, "cpu"),
                                       blk=block)
        _within_one_bf16_ulp(got, want)
