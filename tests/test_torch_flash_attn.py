"""The port's flash attention (``repro_torch.kernels.ops.flash_attention``,
run on the CPU through its plain version) against the JAX package's
kernel (``repro.kernels.flash_attention``, Pallas in interpret mode) and its
oracle (``repro.kernels.ref.flash_attn_ref``), on the same numpy inputs.

Tolerances are those of the JAX package's own ``tests/test_flash_attn.py``:
2e-5 in f32 and 3e-2 in bf16 (the JAX kernel rounds p to bf16 before the PV
product, the oracle does not), 2e-4 for the gradients and the model layout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jax_flash
from repro.kernels.ref import flash_attn_ref
from repro_torch.kernels import flash_attn as fak
from repro_torch.kernels import ops

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _qkv(rng, b, h, hkv, sq, sk, dh):
    return (rng.normal(0, 1, (b, h, sq, dh)).astype(np.float32),
            rng.normal(0, 1, (b, hkv, sk, dh)).astype(np.float32),
            rng.normal(0, 1, (b, hkv, sk, dh)).astype(np.float32))


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,h,hkv,sq,sk,dh,causal,window,bq,bk", [
    (2, 4, 2, 64, 64, 16, True, 0, 32, 32),      # GQA causal
    (1, 2, 2, 48, 80, 8, True, 0, 32, 32),        # Sq != Sk, padding
    (2, 4, 1, 64, 64, 16, True, 24, 32, 32),      # MQA + sliding window
    (1, 3, 3, 33, 65, 16, False, 0, 16, 32),      # non-causal, ragged pad
    (1, 8, 2, 128, 128, 32, True, 0, 128, 64),    # bigger blocks
    (1, 4, 1, 64, 64, 192, True, 0, 32, 32),      # dh 192 (nemotron), GQA 4
    (1, 2, 1, 48, 40, 136, False, 16, 16, 16),    # dh 136, a window
])
def test_flash_matches_jax(b, h, hkv, sq, sk, dh, causal, window, bq, bk,
                           dtype, rng):
    jdt, tdt, tol = DTYPES[dtype]
    arrs = _qkv(rng, b, h, hkv, sq, sk, dh)
    scale = dh ** -0.5
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrs)
    want_kernel = jax_flash(jq, jk, jv, scale, causal, window, bq, bk, True)
    want_ref = flash_attn_ref(jq, jk, jv, scale=scale, causal=causal,
                              window=window)
    q, k, v = (torch.from_numpy(a).to(tdt) for a in arrs)
    n0 = fak.launches
    got = ops.flash_attention(q, k, v, scale, causal, window, bq, bk)
    assert fak.launches == n0 + 1
    assert got.dtype == tdt and tuple(got.shape) == (b, h, sq, dh)
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_flash_gradients(rng):
    """Gradients of q, k, v against ``jax.grad`` through the JAX kernel's
    custom VJP, in the setting of ``test_flash_gradients``; the forward is
    one launch and the backward none."""
    arrs = _qkv(rng, 1, 2, 1, 32, 32, 8)
    scale = 8 ** -0.5

    def loss_k(qq, kk, vv):
        return (jax_flash(qq, kk, vv, scale, True, 0, 16, 16, True)
                ** 2).sum()

    want = jax.grad(loss_k, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                                 for a in arrs))
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrs)
    n0 = fak.launches
    o = ops.flash_attention(q, k, v, scale, True, 0, 16, 16)
    assert fak.launches == n0 + 1
    (o ** 2).sum().backward()
    assert fak.launches == n0 + 1
    for got, w in zip((q.grad, k.grad, v.grad), want):
        np.testing.assert_allclose(_np(got), _np(w), rtol=2e-4, atol=2e-4)


def test_flash_gradient_of_some_inputs(rng):
    """Only the inputs that need a gradient get one (k here)."""
    arrs = _qkv(rng, 1, 2, 1, 16, 24, 8)
    q, v = (torch.from_numpy(a) for a in (arrs[0], arrs[2]))
    k = torch.from_numpy(arrs[1]).requires_grad_()
    o = ops.flash_attention(q, k, v, 0.3, False, 5)
    o.sum().backward()
    kk = torch.from_numpy(arrs[1]).requires_grad_()
    fak.flash_attn_dense(q, kk, v, scale=0.3, causal=False,
                         window=5).sum().backward()
    assert q.grad is None and v.grad is None
    np.testing.assert_allclose(_np(k.grad), _np(kk.grad), rtol=1e-6,
                               atol=1e-6)


def test_flash_matches_model_attention(rng):
    """The port's entry on the model's (B,S,Hkv,G,dh) layout against
    ``repro.nn.attention.attend_dense``."""
    from repro.nn.attention import attend_dense
    b, hkv, g, s, dh = 2, 2, 3, 40, 16
    q5 = rng.normal(0, 1, (b, s, hkv, g, dh)).astype(np.float32)
    k4 = rng.normal(0, 1, (b, s, hkv, dh)).astype(np.float32)
    v4 = rng.normal(0, 1, (b, s, hkv, dh)).astype(np.float32)
    pos = jnp.arange(s)
    scale = dh ** -0.5
    want = attend_dense(jnp.asarray(q5), jnp.asarray(k4), jnp.asarray(v4),
                        pos, pos, causal=True, window=7, scale=scale)
    qf = torch.from_numpy(q5).reshape(b, s, hkv * g, dh).transpose(1, 2)
    kf = torch.from_numpy(k4).transpose(1, 2)
    vf = torch.from_numpy(v4).transpose(1, 2)
    got = ops.flash_attention(qf, kf, vf, scale, True, 7, 16, 16)
    got = got.transpose(1, 2).reshape(b, s, hkv, g, dh)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_fully_masked_rows_follow_the_oracle(causal, rng):
    """Rows 23–39 of this case are fully masked (q_pos ≥ Sk + window − 1).
    The port gives them the oracle's value, the mean of v over Sk, on every
    row.  JAX's kernel, padding k and v from Sk = 20 to its block_k of 16's
    multiple 32, gives Σv / 32 there instead: rows 23–39 differ from JAX's
    kernel by design (the port never counts kv padding); every other row
    agrees with it."""
    arrs = _qkv(rng, 1, 2, 1, 40, 20, 8)
    scale, window = 8 ** -0.5, 4
    jq, jk, jv = (jnp.asarray(a) for a in arrs)
    want_ref = flash_attn_ref(jq, jk, jv, scale=scale, causal=causal,
                              window=window)
    want_kernel = jax_flash(jq, jk, jv, scale, causal, window, 16, 16, True)
    q, k, v = (torch.from_numpy(a) for a in arrs)
    got = _np(ops.flash_attention(q, k, v, scale, causal, window, 16, 16))
    np.testing.assert_allclose(got, _np(want_ref), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got[:, :, 23:], np.broadcast_to(
        arrs[2].mean(axis=2, keepdims=True), got[:, :, 23:].shape),
        rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got[:, :, :23], _np(want_kernel)[:, :, :23],
                               rtol=2e-5, atol=2e-5)
    assert np.abs(got[:, :, 23:] - _np(want_kernel)[:, :, 23:]).max() > 1e-3


def test_flash_rejects_bad_operands():
    q = torch.zeros(1, 3, 4, 8)
    with pytest.raises(ValueError):
        ops.flash_attention(q, torch.zeros(1, 2, 4, 8), torch.zeros(1, 2, 4, 8),
                            1.0)
    with pytest.raises(TypeError):
        ops.flash_attention(q, torch.zeros(1, 1, 4, 8, dtype=torch.float64),
                            torch.zeros(1, 1, 4, 8, dtype=torch.float64), 1.0)


@pytest.mark.parametrize("dtype,dh,path", [
    (torch.bfloat16, 8, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 120, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 136, "wgmma"), (torch.bfloat16, 192, "wgmma"),
    (torch.float32, 8, "fma"), (torch.float32, 128, "fma"),
    (torch.float32, 192, "fma")])
def test_kernel_path(dtype, dh, path):
    assert fak.kernel_path(dtype, dh) == path


@pytest.mark.parametrize("dtype,dh,err", [
    (torch.bfloat16, 12, ValueError), (torch.bfloat16, 200, ValueError),
    (torch.float16, 64, TypeError)])
def test_kernel_path_rejects_what_no_kernel_takes(dtype, dh, err):
    with pytest.raises(err):
        fak.kernel_path(dtype, dh)
