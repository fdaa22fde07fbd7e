"""The port's grouped GEMM (``repro_torch.kernels.ops.moe_gemm``, run on the
CPU through its plain version) against the JAX package's kernel
(``repro.kernels.moe_gemm``, Pallas in interpret mode) and its oracle
(``repro.kernels.ref.moe_gemm_ref``), on the same numpy inputs.

Tolerances are those of the JAX package's ``tests/test_kernels.py::
test_moe_gemm_kernel``: 2e-5 in f32, 5e-2 in bf16 (the output is rounded
to bf16; the two packages sum over D in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import moe_gemm as jax_moe_gemm
from repro.kernels import ref
from repro_torch.kernels import grouped_gemm as moek
from repro_torch.kernels import ops

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("e,d,f,block_t", [(2, 16, 24, 8), (4, 32, 16, 8),
                                           (1, 8, 8, 8)])
def test_moe_gemm_matches_jax(e, d, f, block_t, dtype, rng):
    jdt, tdt, tol = DTYPES[dtype]
    # tokens sorted by expert, each expert's run a multiple of block_t
    runs = rng.integers(1, 4, e)
    eids = np.repeat(np.arange(e, dtype=np.int32), runs)
    t = int(eids.size) * block_t
    x = rng.normal(0, 1, (t, d)).astype(np.float32)
    w = rng.normal(0, 1, (e, d, f)).astype(np.float32)
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    want_kernel = jax_moe_gemm(jx, jw, eids, block_t=block_t,
                               block_d=max(d // 2, 8), block_f=max(f // 2, 8),
                               interpret=True)
    want_ref = ref.moe_gemm_ref(jx, jw, eids, block_t)
    tx, tw = (torch.from_numpy(a).to(tdt) for a in (x, w))
    n0 = moek.launches
    got = ops.moe_gemm(tx, tw, eids, block_t=block_t, block_d=max(d // 2, 8),
                       block_f=max(f // 2, 8))
    assert moek.launches == n0 + 1
    assert got.dtype == tdt and tuple(got.shape) == (t, f)
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_expand_block_ids_matches_jax():
    ids = np.array([0, 0, 2, 3, 3, 3], np.int32)
    np.testing.assert_array_equal(moek.expand_block_ids(ids, 8),
                                  ref.expand_block_ids(ids, 8))


def test_moe_gemm_block_tiles_do_not_change_the_result(rng):
    eids = np.array([0, 1, 1, 3], np.int32)
    x = torch.from_numpy(rng.normal(0, 1, (32, 24)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 1, (4, 24, 40)).astype(np.float32))
    a = ops.moe_gemm(x, w, eids, block_t=8)
    b = ops.moe_gemm(x, w, torch.from_numpy(eids), block_t=8, block_d=8,
                     block_f=16)
    assert torch.equal(a, b)


def test_misaligned_tokens_raise_in_both_packages(rng):
    x = rng.normal(0, 1, (12, 8)).astype(np.float32)
    w = rng.normal(0, 1, (2, 8, 8)).astype(np.float32)
    eids = np.array([0], np.int32)
    with pytest.raises(ValueError):
        jax_moe_gemm(jnp.asarray(x), jnp.asarray(w), eids, block_t=8,
                     interpret=True)
    n0 = moek.launches
    with pytest.raises(ValueError):
        ops.moe_gemm(torch.from_numpy(x), torch.from_numpy(w), eids,
                     block_t=8)
    assert moek.launches == n0


@pytest.mark.parametrize("dtype,d,f,block_t,path", [
    (torch.bfloat16, 2048, 1408, 128, "wgmma"),   # deepseek-moe-16b up
    (torch.bfloat16, 1408, 2048, 64, "wgmma"),    # and down, 64-row runs
    (torch.bfloat16, 40, 24, 192, "wgmma"),       # ragged D and F edges
    (torch.bfloat16, 2048, 1408, 8, "fma"),       # runs below a wgmma tile
    (torch.bfloat16, 2048, 1408, 96, "fma"),
    (torch.bfloat16, 12, 1408, 128, "fma"),       # rows not 16-byte strided
    (torch.bfloat16, 2048, 20, 128, "fma"),
    (torch.float32, 2048, 1408, 128, "fma"),      # f32 keeps the FMA kernel
])
def test_kernel_path(dtype, d, f, block_t, path):
    assert moek.kernel_path(dtype, d, f, block_t) == path


def test_kernel_path_rejects_other_dtypes():
    with pytest.raises(TypeError):
        moek.kernel_path(torch.float16, 2048, 1408, 128)


def _at(n: int, shift: int) -> torch.Tensor:
    """A float32 tensor of ``n`` elements whose storage starts ``shift``
    floats past a 16-byte boundary."""
    buf = torch.zeros(n + 8)
    base = (-buf.data_ptr() // 4) % 4
    return buf[base + shift:base + shift + n]


@pytest.mark.parametrize("block_t", [8, 64, 128, 192])
@pytest.mark.parametrize("d,f,shift", [
    (2048, 1408, 0),    # deepseek-moe-16b's widths
    (40, 24, 0),
    (37, 1408, 0),      # D not a multiple of 4
    (2048, 101, 0),     # F not
    (37, 101, 0),
    (2048, 1408, 1),    # x 4 bytes off a 16-byte boundary
    (2048, 1408, 2),
])
def test_fma_instance_rule(d, f, shift, block_t):
    """The FMA kernel's instance: 128-row SIMT tiles where block_t is a
    multiple of 128, 64-row ones where it is a multiple of 64, else the
    8-row tiling; 16-byte loads where D and F are multiples of 4 and every
    tensor is 16-byte aligned."""
    x, w, y = _at(8, shift), _at(8, 0), _at(8, 0)
    rows, loads = moek.fma_instance(d, f, block_t, x, w, y)
    assert rows == (128 if block_t % 128 == 0 else
                    64 if block_t % 64 == 0 else 8)
    vec = d % 4 == 0 and f % 4 == 0 and shift == 0 and rows != 8
    assert loads == ("vec4" if vec else "scalar")
