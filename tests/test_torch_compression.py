"""The int8 all-reduce with error feedback
(``repro_torch.distributed.compression``) against the JAX package's
(``repro.distributed.compression``), on the CPU.

- ``quantize_int8`` bitwise JAX's (the int8 values, the scale, the
  residual) on random inputs with a carried residual and on edge inputs:
  all zeros, one huge element, all negative.
- ``compressed_all_reduce`` on 2 and 4 gloo ranks (``torchrun``) against
  ``compressed_psum`` under ``shard_map`` on 2 and 4 of 4 CPU devices
  (``XLA_FLAGS=--xla_force_host_platform_device_count=4`` in a
  subprocess), for two steps of error feedback, each rank's gradient of
  another scale: every rank's int8 values and the int32 sum equal, the
  rebuilt gradient within n f32 ulps of JAX's, and the residual within n
  f32 ulps of the operands it is the difference of (``g + err`` and
  ``q·s``: under ``jit`` XLA may contract ``gf − q·s`` into one fused
  multiply-add, which rounds once where the port rounds the product
  first, a difference of up to half an ulp of ``q·s``, however small the
  residual; the residual carries the last step's difference into this
  one's, so the allowances add up over the steps); the tree version leaf
  for leaf the single-tensor one, from ``init_error_feedback``'s zeros.
"""
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as jcomp
from repro_torch.distributed import compression as tcomp
from test_torch_distributed import _env, _ok

L = 1000          # elements a rank
STEPS = 2         # steps of error feedback

_JAX = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.distributed.compression import compressed_psum, quantize_int8
inp, res = np.load(sys.argv[1]), {}
for n in (2, 4):
    mesh = make_mesh((n,), ("pod",), devices=jax.devices()[:n])

    def f(g, e):
        q, _, _ = quantize_int8(g[0], e[0])
        qsum = jax.lax.psum(q.astype(jnp.int32), "pod")
        g_hat, new_err = compressed_psum(g[0], e[0], "pod")
        return q[None], qsum[None], g_hat[None], new_err[None]

    fn = jax.jit(shard_map(f, mesh=mesh, in_specs=(P("pod"), P("pod")),
                           out_specs=(P("pod"),) * 4))
    err = np.zeros((n, inp["g"].shape[-1]), np.float32)
    for s in range(inp["g"].shape[1]):
        out = fn(inp["g"][:n, s], err)
        for k, v in zip(("q", "qsum", "g_hat", "err"), out):
            res[f"{k}{n}_{s}"] = np.asarray(v)
        err = np.asarray(out[3])
np.savez(sys.argv[2], **res)
print("OK")
"""

_RANKS = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch.distributed import compression as c
dist.init_process_group("gloo")
r, n = dist.get_rank(), dist.get_world_size()
g_all = np.load(sys.argv[1])["g"]
res, err = {}, torch.zeros(g_all.shape[-1])
tree_err = c.init_error_feedback({"a": torch.zeros(600), "b": [
    torch.zeros(400)]})
leaf_err = [torch.zeros(600), torch.zeros(400)]
for s in range(g_all.shape[1]):
    g = torch.from_numpy(g_all[r, s])
    q, _, _ = c.quantize_int8(g, err)
    qsum = q.to(torch.int32)
    dist.all_reduce(qsum)
    g_hat, err = c.compressed_all_reduce(g, err)
    tree, tree_err = c.compressed_all_reduce_tree(
        {"a": g[:600], "b": [g[600:]]}, tree_err)
    leaf = [c.compressed_all_reduce(x, e)
            for x, e in zip((g[:600], g[600:]), leaf_err)]
    leaf_err = [e for _, e in leaf]
    res.update({f"q_{s}": q.numpy(), f"qsum_{s}": qsum.numpy(),
                f"g_hat_{s}": g_hat.numpy(), f"err_{s}": err.numpy(),
                f"tree_{s}": torch.cat([tree["a"], tree["b"][0]]).numpy(),
                f"tree_err_{s}": torch.cat([tree_err["a"],
                                            tree_err["b"][0]]).numpy(),
                f"leaf_{s}": torch.cat([x for x, _ in leaf]).numpy(),
                f"leaf_err_{s}": torch.cat(leaf_err).numpy()})
np.savez(sys.argv[2] + f".{r}.npz", **res)
dist.destroy_process_group()
"""


def _inputs(seed: int = 0) -> np.ndarray:
    """(4 ranks, STEPS, L) gradients, rank r at scale 10^(r-1)."""
    rng = np.random.default_rng(seed)
    g = rng.normal(0, 1, (4, STEPS, L)).astype(np.float32)
    return g * (10.0 ** (np.arange(4) - 1))[:, None, None].astype(np.float32)


@pytest.mark.parametrize("case", ["random", "zeros", "one_huge",
                                  "negative"])
def test_quantize_int8_is_bitwise_jax(case):
    rng = np.random.default_rng(1)
    g = rng.normal(0, 1, (4096,)).astype(np.float32)
    err = (rng.normal(0, 1e-3, g.shape)).astype(np.float32)
    if case == "zeros":
        g, err = np.zeros_like(g), np.zeros_like(err)
    elif case == "one_huge":
        g[123] = 3e30
    elif case == "negative":
        g = -np.abs(g) - 0.5
    jq, js, je = jcomp.quantize_int8(jnp.asarray(g), jnp.asarray(err))
    tq, ts, te = tcomp.quantize_int8(torch.from_numpy(g),
                                     torch.from_numpy(err))
    assert tq.dtype == torch.int8 and ts.dtype == te.dtype == torch.float32
    assert tq.numpy().tobytes() == np.asarray(jq).tobytes()
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    assert te.numpy().tobytes() == np.asarray(je).tobytes()
    if case == "zeros":
        assert not tq.any() and not te.any()


@pytest.fixture(scope="module")
def reduced(tmp_path_factory):
    """JAX's ``compressed_psum`` on 2 and 4 devices and the port's
    ``compressed_all_reduce`` on 2 and 4 gloo ranks, on the same
    inputs."""
    d = tmp_path_factory.mktemp("compression")
    np.savez(d / "in.npz", g=_inputs())
    r = subprocess.run([sys.executable, "-c", _JAX, str(d / "in.npz"),
                        str(d / "jax.npz")], capture_output=True, text=True,
                       env=_env(), timeout=300)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-4000:]
    (d / "ranks.py").write_text(_RANKS)
    for n in (2, 4):
        logs = d / f"logs{n}"
        r = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(n), "--log-dir", str(logs), "--tee",
             "3", str(d / "ranks.py"), str(d / "in.npz"),
             str(d / f"port{n}")], capture_output=True, text=True,
            env=_env(), timeout=240)
        r.logs = logs
        _ok(r)
    jax_out = dict(np.load(d / "jax.npz"))
    port = {n: [dict(np.load(d / f"port{n}.{r}.npz")) for r in range(n)]
            for n in (2, 4)}
    return jax_out, port


def _ulp(x) -> np.ndarray:
    return np.spacing(np.abs(x).astype(np.float32)).astype(np.float64)


def _ulps(a, b, n):
    """|a − b| within n f32 ulps of the larger magnitude of the two."""
    gap = np.abs(a.astype(np.float64) - b.astype(np.float64))
    return bool(np.all(gap <= n * _ulp(np.maximum(np.abs(a), np.abs(b)))))


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("n", [2, 4])
def test_compressed_all_reduce_matches_jax_compressed_psum(reduced, n,
                                                           step):
    jax_out, port = reduced
    g = _inputs()
    for r in range(n):
        mine = port[n][r]
        allow = np.zeros(L)        # the residual's allowance, step by step
        for s in range(step + 1):
            gf = g[r, s] + (mine[f"err_{s - 1}"] if s else 0.0)
            allow += n * _ulp(np.maximum(np.abs(gf),
                                         np.abs(gf - mine[f"err_{s}"])))
        assert np.array_equal(mine[f"q_{step}"], jax_out[f"q{n}_{step}"][r])
        assert np.array_equal(mine[f"qsum_{step}"],
                              jax_out[f"qsum{n}_{step}"][r])
        assert _ulps(mine[f"g_hat_{step}"], jax_out[f"g_hat{n}_{step}"][r],
                     n)
        gap = np.abs(mine[f"err_{step}"].astype(np.float64)
                     - jax_out[f"err{n}_{step}"][r])
        assert np.all(gap <= allow)
        # every rank rebuilds the same mean
        assert np.array_equal(mine[f"g_hat_{step}"],
                              port[n][0][f"g_hat_{step}"])


@pytest.mark.parametrize("n", [2, 4])
def test_the_tree_reduce_is_the_leafwise_reduce(reduced, n):
    """``compressed_all_reduce_tree`` from ``init_error_feedback``'s zeros,
    two steps: bitwise ``compressed_all_reduce`` on each leaf with its own
    residual (each leaf on its own scale)."""
    _, port = reduced
    for r in range(n):
        mine = port[n][r]
        for s in range(STEPS):
            assert mine[f"tree_{s}"].tobytes() == mine[f"leaf_{s}"].tobytes()
            assert (mine[f"tree_err_{s}"].tobytes()
                    == mine[f"leaf_err_{s}"].tobytes())
            # a leaf's scale is its own: the residual differs from the
            # whole vector's
            assert not np.array_equal(mine[f"tree_err_{s}"],
                                      mine[f"err_{s}"])
