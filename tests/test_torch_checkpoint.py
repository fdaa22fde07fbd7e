"""The port's checkpoint (``checkpoint/checkpoint.py``) held against the JAX
package's on the CPU: bf16 leaves stored as their raw bits and
reinterpreted on restore, so a tree of bf16, f32 and int32 leaves written
by either package restores in the other bit for bit and both write the
same ``arrays.npz`` bytes; bf16 population parameters; and the off-thread
``AsyncCheckpointer`` (JAX's cadence test, its ``step_map`` and
``save_pred``, a host snapshot complete before ``maybe_save`` returns, and
a failed write raised rather than lost).
"""
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.core import deep as jdeep
from repro.core import population as jpop
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.core import population as tpop
from repro_torch.core.tree import tree_leaves, tree_map

WIDTHS = ((7,), (13, 5), (9,))
ACTS = ("relu", ("tanh", "gelu"), "mish")


def to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def jax_tree(seed=0) -> dict:
    """bf16, f32 and int32 leaves (JAX's ``_tree`` of test_checkpoint.py,
    with live bf16 values), as JAX arrays."""
    rng = np.random.default_rng(seed)
    return {"params": {"w": jnp.asarray(rng.normal(0, 1, (8, 4)),
                                        jnp.float32),
                       "b": jnp.asarray(rng.normal(0, 1e-3, (4,)),
                                        jnp.bfloat16)},
            "opt": {"count": jnp.asarray(3, jnp.int32),
                    "m": {"w": jnp.asarray(rng.normal(0, 1, (8, 4)),
                                           jnp.bfloat16),
                          "b": jnp.ones((4,), jnp.float32)}}}


def same_bits(got, want):
    gl, wl = tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for i, (a, b) in enumerate(zip(gl, wl)):
        b = to_torch(b)
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b), i


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_bf16_and_f32_leaves_cross_packages_bitwise(writer, tmp_path):
    """A tree saved by one package restores in both, bit for bit, in its
    own dtypes; the manifest records ``bfloat16`` over a uint16 array."""
    jt = jax_tree()
    tt = jax.tree.map(to_torch, jt)
    if writer == "jax":
        jckpt.save(str(tmp_path), 5, jt)
    else:
        tckpt.save(str(tmp_path), 5, tt)
    got, step = tckpt.restore(str(tmp_path), tree_map(
        lambda t: torch.empty_like(t, device="meta"), tt), device="cpu")
    assert step == 5
    same_bits(got, jt)
    back, _ = jckpt.restore(str(tmp_path), jax.tree.map(jnp.zeros_like, jt))
    same_bits(got, back)
    with np.load(tmp_path / "step_00000005" / "arrays.npz") as data:
        assert data["opt/m/w"].dtype == np.uint16
        assert data["params/w"].dtype == np.float32


def test_both_packages_write_the_same_npz_bytes(tmp_path):
    jt = jax_tree(1)
    jckpt.save(str(tmp_path / "jax"), 0, jt)
    tckpt.save(str(tmp_path / "port"), 0, jax.tree.map(to_torch, jt))
    files = [(tmp_path / d / "step_00000000" / "arrays.npz").read_bytes()
             for d in ("jax", "port")]
    assert files[0] == files[1]
    manifests = [json.loads((tmp_path / d / "step_00000000" / "tree.json")
                            .read_text())["manifest"] for d in ("jax", "port")]
    assert manifests[0] == manifests[1]
    assert manifests[1]["opt/m/w"] == {"shape": [8, 4], "dtype": "bfloat16"}


def test_restore_reinterprets_bits_never_casts(tmp_path):
    """The stored uint16 patterns come back as the same bf16 values (a
    cast of the integers would give 16,000-odd); restored into an f32
    prototype they are those bf16 values widened, as in JAX."""
    vals = torch.tensor([1.5, -2.0e-3, 3.0e4, 0.0], dtype=torch.bfloat16)
    tckpt.save(str(tmp_path), 0, {"x": vals})
    got, _ = tckpt.restore(str(tmp_path), {"x": vals}, device="cpu")
    assert got["x"].dtype == torch.bfloat16 and torch.equal(got["x"], vals)
    wide, _ = tckpt.restore(str(tmp_path),
                            {"x": torch.zeros(4, dtype=torch.float32)},
                            device="cpu")
    assert torch.equal(wide["x"], vals.float())
    jwide, _ = jckpt.restore(str(tmp_path), {"x": jnp.zeros(4, jnp.float32)})
    np.testing.assert_array_equal(np.asarray(jwide["x"]), wide["x"].numpy())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_bf16_population_params_cross_packages(writer, tmp_path):
    """``restore_population`` of a checkpoint whose parameters are bf16
    rebuilds bf16 parameters on the stored layout, bitwise, in both
    packages."""
    jlp = jpop.LayeredPopulation(5, 2, WIDTHS, ACTS).sorted()
    tlp = tpop.LayeredPopulation(5, 2, WIDTHS, ACTS).sorted()
    pj = jdeep.init_params(jax.random.PRNGKey(0), jlp, jnp.bfloat16)
    if writer == "jax":
        jckpt.save_population(str(tmp_path), 3, pj, jlp)
    else:
        tckpt.save_population(str(tmp_path), 3, jax.tree.map(to_torch, pj),
                              tlp)
    pt, lp, step = tckpt.restore_population(str(tmp_path), device="cpu")
    assert step == 3 and lp == tlp
    assert tckpt.load_meta(str(tmp_path))[0]["population"]["dtype"] \
        == "bfloat16"
    same_bits(pt, pj)
    pj2, jl, _ = jckpt.restore_population(str(tmp_path))
    assert jl.widths == lp.widths
    same_bits(pt, pj2)


def test_async_checkpointer(tmp_path):
    """JAX's cadence test, then ``step_map`` (chunks → global steps) and
    ``save_pred`` (a predicate in place of the cadence)."""
    tt = jax.tree.map(to_torch, jax_tree())
    ck = tckpt.AsyncCheckpointer(str(tmp_path / "a"), every=2, keep_last=10)
    saved = [s for s in range(6) if ck.maybe_save(s, tt)]
    ck.wait()
    assert saved == [0, 2, 4]
    assert tckpt.latest_steps(str(tmp_path / "a")) == [0, 2, 4]
    got, step = tckpt.restore(str(tmp_path / "a"), tt, device="cpu")
    assert step == 4
    same_bits(got, jax_tree())
    ck = tckpt.AsyncCheckpointer(str(tmp_path / "b"), keep_last=10,
                                 step_map=lambda c: 8 * c + 7,
                                 save_pred=lambda c: c % 3 == 1)
    assert [c for c in range(6) if ck.maybe_save(c, tt)] == [1, 4]
    ck.wait()
    assert tckpt.latest_steps(str(tmp_path / "b")) == [15, 39]
    assert len(ck.saved) == 2


def test_async_snapshot_is_complete_when_maybe_save_returns(tmp_path,
                                                           monkeypatch):
    """A tensor updated in place after ``maybe_save`` returns does not
    reach the checkpoint, even while the write is in flight."""
    gate = threading.Event()
    real_save = tckpt.save

    def held_save(*a, **kw):
        assert gate.wait(timeout=30)
        return real_save(*a, **kw)

    monkeypatch.setattr(tckpt, "save", held_save)
    x = torch.arange(6, dtype=torch.float32)
    ck = tckpt.AsyncCheckpointer(str(tmp_path), every=1)
    assert ck.maybe_save(0, {"x": x})
    x.add_(100.0)
    gate.set()
    ck.wait()
    got, _ = tckpt.restore(str(tmp_path), {"x": x}, device="cpu")
    assert torch.equal(got["x"], torch.arange(6, dtype=torch.float32))


def test_async_checkpointer_raises_a_failed_write(tmp_path):
    """The worker's exception is raised at the next ``wait`` (then
    cleared), and at a ``maybe_save`` that follows a failed write."""
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    tt = {"x": torch.ones(3)}
    ck = tckpt.AsyncCheckpointer(str(blocker / "ck"), every=1)
    assert ck.maybe_save(0, tt)
    with pytest.raises(RuntimeError, match="step 0") as err:
        ck.wait()
    assert isinstance(err.value.__cause__, OSError)
    ck.wait()
    assert ck.maybe_save(1, tt)
    with pytest.raises(RuntimeError, match="step 1"):
        ck.maybe_save(2, tt)
    assert not os.path.exists(blocker / "ck")
