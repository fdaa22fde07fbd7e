"""The port's adafactor and bf16-state AdamW (``optim/optimizers.py``) held
against the JAX package's on the CPU.

The same numpy parameters and gradients go through both packages' update
for 3 steps, over a depth-3 population's tree: factored 2-D leaves
(``w_in``, ``w_out``), 3-D mid-layer tile stacks, vectors (the biases) and
``b_out`` (P, O), with momentum 0 and 0.9 and a scalar or per-member
weight decay.  Tolerances: updates, parameters and f32 state within rtol
1e-5 / atol 1e-6 (tests/test_population_optim.py); bf16 leaves equal, or
one bf16 ulp apart (the two packages reduce in different orders, so an f32
value near a rounding boundary may round the other way), or, where a
moment cancels to near zero and an atol-sized f32 difference spans more
than one ulp, within that same f32 tolerance.  Also JAX's own optimizer
tests of the two features (tests/test_optim.py), as port tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.core import deep as jdeep
from repro.core import population as jpop
from repro.optim import optimizers as jopt
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.core import deep as tdeep
from repro_torch.core import population as tpop
from repro_torch.core.tree import tree_leaves
from repro_torch.optim import optimizers as topt

TOL = dict(rtol=1e-5, atol=1e-6)
WIDTHS = ((7,), (13, 5), (24, 12, 8), (9, 3), (16, 8))
ACTS = ("relu", ("tanh", "gelu"), ("mish", "sigmoid", "tanh"),
        ("tanh", "relu"), ("relu", "tanh"))
JLP = jpop.LayeredPopulation(6, 3, WIDTHS, ACTS, block=8).sorted()
TLP = tpop.LayeredPopulation(6, 3, WIDTHS, ACTS, block=8).sorted()
OPTS = {
    "adafactor": lambda o, wd, bf16: o.adafactor(weight_decay=wd),
    "adafactor momentum 0": lambda o, wd, bf16: o.adafactor(
        momentum=0.0, weight_decay=wd),
    "adamw bf16": lambda o, wd, bf16: o.adamw(weight_decay=wd,
                                              state_dtype=bf16),
}


def to_torch(a) -> torch.Tensor:
    """A numpy (or JAX) array as a tensor, bf16 through its bits."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def assert_state_close(got, want):
    """Leaf by leaf in JAX's order: f32 within ``TOL``; bf16 each element
    equal or one ulp apart (as int16 bit patterns of same-signed values),
    or within ``TOL`` (a near-zero moment); int32 equal."""
    gl, wl = tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for i, (a, b) in enumerate(zip(gl, wl)):
        b = to_torch(b)
        assert a.dtype == b.dtype and a.shape == b.shape, i
        if a.dtype == torch.bfloat16:
            ulps = (a.view(torch.int16).int() - b.view(torch.int16).int())
            near = ((a.float() - b.float()).abs()
                    <= TOL["atol"] + TOL["rtol"] * b.float().abs())
            assert bool((near | (ulps.abs() <= 1)).all()), f"leaf {i}"
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(),
                                       err_msg=f"leaf {i}", **TOL)


def trees(seed: int):
    """Parameters and 3 gradient trees, numpy, in the layout's shapes."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jdeep.abstract_params(JLP))

    def draw(scale):
        return jax.tree.map(lambda a: rng.normal(0, scale, a.shape)
                            .astype(np.float32), shapes)

    return draw(0.5), [draw(1.0) for _ in range(3)]


@pytest.mark.parametrize("wd", ["scalar", "per-member"])
@pytest.mark.parametrize("name", sorted(OPTS))
def test_three_steps_match_jax(name, wd):
    """3 updates from one state: updates, parameters and state within the
    optimizer tolerance of JAX's (bf16 leaves within one ulp); the state
    trees carry the same leaves under the same checkpoint keys."""
    params, grads = trees(0)
    if wd == "scalar":
        jwd = twd = 0.01
    else:
        vec = np.random.default_rng(1).uniform(
            0.001, 0.05, JLP.num_members).astype(np.float32)
        jwd = jdeep.member_lr_tree(JLP, jnp.asarray(vec))
        twd = tdeep.member_lr_tree(TLP, torch.from_numpy(vec))
    jo = OPTS[name](jopt, jwd, jnp.bfloat16)
    to = OPTS[name](topt, twd, torch.bfloat16)
    pj = jax.tree.map(jnp.asarray, params)
    pt = tdeep.params_from_numpy(params, TLP, device="cpu")
    sj, st = jo.init(pj), to.init(pt)
    assert set(tckpt._flatten_with_paths(st)) == \
        set(jckpt._flatten_with_paths(sj)[0])
    lr = 0.05
    for g in grads:
        uj, sj = jo.update(jax.tree.map(jnp.asarray, g), sj, pj, lr)
        ut, st = to.update(tdeep.params_from_numpy(g, TLP, device="cpu"),
                           st, pt, lr)
        assert_state_close(ut, uj)
        pj, pt = jopt.apply_updates(pj, uj), topt.apply_updates(pt, ut)
    assert_state_close(pt, pj)
    assert_state_close(st, sj)
    assert int(st["count"]) == 3


def test_adafactor_factors_each_leaf_as_jax():
    """Which leaves are factored, and the statistics' shapes: a 2-D leaf
    whose trailing dims are ≥ 2 (w_in, w_out, b_out), a mid-layer tile
    stack, a vector unfactored."""
    st = topt.adafactor().init(tdeep.abstract_params(TLP))["leaves"]
    sj = jax.eval_shape(jopt.adafactor().init,
                        jdeep.abstract_params(JLP))["leaves"]
    for key in ("w_in", "w_out", "b_out"):
        assert set(st[key]) == {"m", "v_row", "v_col"}
    assert set(st["b_in"]) == {"m", "v"}
    w0, s0 = tdeep.abstract_params(TLP)["mid"][0]["w"][0], \
        st["mid"][0]["w"][0]
    assert w0.ndim == 3 and s0["v_row"].shape == w0.shape[:-1]
    assert s0["v_col"].shape == w0.shape[:-2] + w0.shape[-1:]
    flat_t = {k: tuple(v.shape) for k, v in
              tckpt._flatten_with_paths(st).items()}
    flat_j = {k: tuple(v.shape) for k, v in
              jckpt._flatten_with_paths(sj)[0].items()}
    assert flat_t == flat_j


def test_adafactor_factored_state_is_small():
    """JAX's test: a matrix's state is O(n+m), a vector unfactored, the
    momentum bf16."""
    p = {"w": torch.zeros(512, 256), "b": torch.zeros(256)}
    leaves = topt.adafactor().init(p)["leaves"]
    assert leaves["w"]["v_row"].shape == (512,)
    assert leaves["w"]["v_col"].shape == (256,)
    assert "v" in leaves["b"]
    assert leaves["w"]["m"].dtype == torch.bfloat16
    matrix_state = leaves["w"]["v_row"].numel() + leaves["w"]["v_col"].numel()
    assert matrix_state < p["w"].numel() // 64


def test_adafactor_descends():
    """JAX's test: 20 steps on a quadratic lower it."""
    w = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (16, 8))
                         .astype(np.float32))
    opt = topt.adafactor(momentum=0.0)
    p = {"w": w}
    st = opt.init(p)
    for _ in range(20):
        upd, st = opt.update({"w": 2 * p["w"]}, st, p, 0.05)
        p = topt.apply_updates(p, upd)
    assert float((p["w"] ** 2).sum()) < float((w ** 2).sum())


def test_adamw_bf16_state_halves_memory():
    """JAX's test: m and v in bf16, half the f32 state's bytes, finite
    updates; the state dtype may be named."""
    opt = topt.adamw(state_dtype=torch.bfloat16)
    p = {"w": torch.zeros(128, 64)}
    st = opt.init(p)
    assert st["m"]["w"].dtype == torch.bfloat16
    upd, st = opt.update({"w": torch.ones(128, 64)}, st, p, 1e-3)
    assert st["v"]["w"].dtype == torch.bfloat16
    assert torch.isfinite(upd["w"]).all()
    f32 = topt.adamw().init(p)
    nbytes = lambda t: sum(x.numel() * x.element_size()   # noqa: E731
                           for x in tree_leaves(t) if x.ndim)
    assert 2 * nbytes(st) == nbytes(f32)
    assert topt.adamw(state_dtype="bfloat16").init(p)["v"]["w"].dtype \
        == torch.bfloat16
