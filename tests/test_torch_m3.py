"""The port's M3 held against the JAX package on the CPU: the segment-
blocked matmul (``ops.m3_matmul``) and its gradients (also at path 4e's
member widths), the four M3 implementations, and the layered engine's head
under ``m3_impl="pallas"`` and ``"onehot"``; and the instance rule of the
M3 kernels (``m3_matmul.kernel_path``), which run only on the card
(tests/test_torch_kernels.py).

Same numpy inputs go through both packages.  JAX runs its Pallas kernels
in interpret mode, as tests/test_m3.py does; the port runs each kernel's
plain PyTorch version, which its dispatch layer picks for a CPU tensor.
Tolerances (tests/test_m3.py): values rtol/atol 2e-5, gradients 2e-4; the
layered route's logits and loss gradients rtol 1e-4 / atol 1e-6
(tests/test_torch_unfused.py: more stages, each summing in its own order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import deep as jdeep
from repro.core.activations import ACTIVATION_ORDER
from repro.core.m3 import M3_IMPLS as JM3
from repro.core.population import LayeredPopulation as JLayered
from repro.core.population import Population as JPopulation
from repro.kernels import ops as jops
from repro_torch.core import deep as tdeep
from repro_torch.core.m3 import M3_IMPLS as TM3
from repro_torch.core.population import LayeredPopulation as TLayered
from repro_torch.core.population import Population as TPopulation
from repro_torch.core.tree import tree_leaves
from repro_torch.kernels import infer_head as ihk
from repro_torch.kernels import m3_matmul as m3k
from repro_torch.kernels import ops as tops
from repro_torch.launch import launch_count as tlc

FWD = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=2e-4, atol=2e-4)
ROUTE = dict(rtol=1e-4, atol=1e-6)
# padded units at every block: sizes not multiples of 8 or 16
SIZES = (3, 9, 1, 20, 5)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _moved(fn):
    """``fn()`` and the kernel counters it moved."""
    before = tlc.kernel_launches()
    out = fn()
    after = tlc.kernel_launches()
    return out, {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}


def _inputs(pop, b, o, seed):
    """h (masked: padding units are zero, as the model makes them), w2 and
    a cotangent dy, from a seed."""
    rng = np.random.default_rng(seed)
    h = (rng.normal(0, 1, (b, pop.total_hidden))
         * pop.hidden_mask).astype(np.float32)
    w2 = rng.normal(0, 1, (o, pop.total_hidden)).astype(np.float32)
    dy = rng.normal(0, 1, (b, pop.num_members, o)).astype(np.float32)
    return h, w2, dy


@pytest.mark.parametrize("o", [2, 5])
@pytest.mark.parametrize("block", [1, 8, 16])
def test_m3_matmul_and_vjp_match_jax(block, o):
    """Forward, dh and dW2 against JAX's ``ops.m3_matmul`` (interpret) and
    its ``jax.vjp``, at a ragged batch (7 rows; JAX pads to 8) with padded
    units; one forward and one backward launch each kernel once."""
    pop = TPopulation(4, o, SIZES, ("relu",) * len(SIZES), block=block)
    h, w2, dy = _inputs(pop, 7, o, block * 10 + o)
    seg = pop.block_segment_ids
    jy, vjp = jax.vjp(lambda a, w: jops.m3_matmul(
        a, w, seg.copy(), pop.num_members, block_h=block, interpret=True),
        jnp.asarray(h), jnp.asarray(w2))
    jdh, jdw = vjp(jnp.asarray(dy))
    th = _t(h).requires_grad_(True)
    tw = _t(w2).requires_grad_(True)

    def fwd_bwd():
        y = tops.m3_matmul(th, tw, seg, pop.num_members, block_h=block)
        return y, torch.autograd.grad(y, (th, tw), _t(dy))

    (ty, (tdh, tdw)), n = _moved(fwd_bwd)
    assert n == tlc.m3_step_launches()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **FWD)
    np.testing.assert_allclose(tdh.numpy(), np.asarray(jdh), **GRAD)
    np.testing.assert_allclose(tdw.numpy(), np.asarray(jdw), **GRAD)
    # only the gradients asked for: dW2 alone, then no backward at all
    y, n = _moved(lambda: torch.autograd.grad(
        tops.m3_matmul(th.detach(), tw, seg, pop.num_members,
                       block_h=block), (tw,), _t(dy)))
    assert n == {"m3_matmul_fwd": 1, "m3_matmul_dw": 1}
    np.testing.assert_array_equal(y[0].numpy(), tdw.numpy())
    with torch.no_grad():
        got, n = _moved(lambda: tops.m3_matmul(th, tw, seg, pop.num_members,
                                               block_h=block))
    assert n == {"m3_matmul_fwd": 1}
    assert torch.equal(got, ty.detach())


def test_m3_matmul_rejects_what_jax_rejects():
    """A misaligned hidden axis raises in both packages; unsorted member
    ids and a mismatched weight raise in the port."""
    pop = TPopulation(4, 2, SIZES, ("relu",) * len(SIZES), block=8)
    h, w2, _ = _inputs(pop, 4, 2, 0)
    seg = pop.block_segment_ids
    with pytest.raises(ValueError, match="aligned") as jerr:
        jops.m3_matmul(jnp.asarray(h[:, 1:]), jnp.asarray(w2[:, 1:]), seg,
                       pop.num_members, block_h=8, interpret=True)
    with pytest.raises(ValueError, match="aligned") as terr:
        tops.m3_matmul(_t(h[:, 1:]), _t(w2[:, 1:]), seg, pop.num_members,
                       block_h=8)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="sorted"):
        tops.m3_matmul(_t(h), _t(w2), seg[::-1].copy(), pop.num_members,
                       block_h=8)
    with pytest.raises(ValueError, match="does not match"):
        tops.m3_matmul(_t(h), _t(w2[:, 8:]), seg, pop.num_members, block_h=8)


def test_m3_plain_versions_give_an_empty_member_zero():
    """A member that owns no block: y = 0 from the forward, and nothing of
    it in dh or dW2 (the kernels' contract; the JAX kernel leaves its
    output block unwritten)."""
    h = torch.randn(3, 16)
    w2 = torch.randn(2, 16)
    ptr = torch.tensor([0, 1, 1, 2], dtype=torch.int32)     # member 1 empty
    y = m3k.m3_matmul_fwd_plain(h, w2, ptr, block=8)
    assert y.shape == (3, 3, 2) and torch.all(y[:, 1] == 0)
    torch.testing.assert_close(y[:, 2], h[:, 8:] @ w2[:, 8:].t())
    dy = torch.randn(3, 3, 2)
    seg = torch.tensor([0, 2], dtype=torch.int32)
    dh = m3k.m3_matmul_dh_plain(dy, w2, seg, block=8)
    torch.testing.assert_close(dh[:, :8], dy[:, 0] @ w2[:, :8])
    dw = m3k.m3_matmul_dw_plain(dy, h, seg, block=8)
    torch.testing.assert_close(dw[:, 8:], dy[:, 2].t() @ h[:, 8:])


def _at(shape, shift: int) -> torch.Tensor:
    """A float32 tensor whose storage starts ``shift`` floats past a
    16-byte boundary."""
    n = int(np.prod(shape))
    buf = torch.zeros(n + 8)
    base = (-buf.data_ptr() // 4) % 4
    return buf[base + shift:base + shift + n].view(shape)


@pytest.mark.parametrize("block,shifts,cols,o,want", [
    (128, (0, 0), 1024, 2, "vec4"),   # path 4d's members
    (8, (0, 0), 64, 2, "vec4"),       # path 4e's head
    (4, (0, 0), 12, 5, "vec4"),
    (8, (0, 0), 64, 20, "vec4"),      # past 16 classes: the same instance
    (8, (1, 0), 64, 20, "scalar"),    # h 4 bytes off a 16-byte boundary
    (8, (0, 2), 64, 20, "scalar"),    # w2 (forward) or dw2 (dW) off
    (128, (3, 1), 1024, 2, "scalar"),
    (6, (0, 0), 36, 2, "scalar"),     # a block not a multiple of 4
    (1, (0, 0), 64, 16, "scalar"),
])
def test_kernel_path_rule(block, shifts, cols, o, want):
    """The instance an M3 forward (h, w2) or dW (h, dw2) launch takes:
    vec4 where the block and H are multiples of 4 and both tensors start
    on 16 bytes, else scalar, whatever the class count (beyond 16 the
    kernels walk the classes 16 at a time in the same instance)."""
    h, second = _at((3, cols), shifts[0]), _at((o, cols), shifts[1])
    assert m3k.kernel_path(block, h, second) == want


# path 4e's member widths (the depth-3 head's "…,16;…,5;7" padded to 16, 8
# and 8 units at block 8), and an empty member
HEAD_WIDTHS = (16, 5, 7, 0, 7, 16, 5, 16)


@pytest.mark.parametrize("o", [2, 20])
def test_m3_at_path_4e_widths_matches_jax(o):
    """The plain versions, and ``ops.m3_matmul``'s forward and VJP, against
    JAX's ``ops.m3_matmul`` (interpret) at path 4e's member widths, block 8,
    with padded units and a member that owns no block (its y is 0 here;
    the JAX kernel leaves it unwritten, so it is left out there)."""
    blocks = [-(-w // 8) for w in HEAD_WIDTHS]
    seg = np.repeat(np.arange(len(HEAD_WIDTHS)), blocks).astype(np.int32)
    mask = np.concatenate([np.arange(n * 8) < w
                           for w, n in zip(HEAD_WIDTHS, blocks)])
    p, hh = len(HEAD_WIDTHS), 8 * sum(blocks)
    rng = np.random.default_rng(o)
    h = (rng.normal(0, 1, (7, hh)) * mask).astype(np.float32)
    w2 = rng.normal(0, 1, (o, hh)).astype(np.float32)
    dy = rng.normal(0, 1, (7, p, o)).astype(np.float32)
    jy, vjp = jax.vjp(lambda a, w: jops.m3_matmul(
        a, w, seg.copy(), p, block_h=8, interpret=True),
        jnp.asarray(h), jnp.asarray(w2))
    jdh, jdw = vjp(jnp.asarray(dy))
    live = np.array(blocks) > 0
    tseg = _t(seg, torch.int32)
    plain = (m3k.m3_matmul_fwd_plain(_t(h), _t(w2), ihk.member_ptr(tseg, p),
                                     block=8),
             m3k.m3_matmul_dh_plain(_t(dy), _t(w2), tseg, block=8),
             m3k.m3_matmul_dw_plain(_t(dy), _t(h), tseg, block=8))
    th = _t(h).requires_grad_(True)
    tw = _t(w2).requires_grad_(True)
    ty = tops.m3_matmul(th, tw, seg, p, block_h=8)
    via_ops = (ty.detach(), *torch.autograd.grad(ty, (th, tw), _t(dy)))
    for y, dh, dw in (plain, via_ops):
        assert torch.all(y[:, ~live] == 0)
        np.testing.assert_allclose(y[:, live].numpy(),
                                   np.asarray(jy)[:, live], **FWD)
        np.testing.assert_allclose(dh.numpy(), np.asarray(jdh), **GRAD)
        np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), **GRAD)


@pytest.mark.parametrize("impl", sorted(JM3))
def test_m3_impls_match_jax(impl):
    """Each of the four M3 implementations, values and the gradients of a
    weighted sum, against the JAX package's implementation of that name."""
    assert sorted(TM3) == sorted(JM3)
    sizes = (5, 17, 2, 8)
    acts = ("relu", "tanh", "gelu", "mish")
    jpop = JPopulation(4, 3, sizes, acts, block=8)
    tpop = TPopulation(4, 3, sizes, acts, block=8)
    h, w2, r = _inputs(tpop, 6, 3, 3)

    def jloss(a, w):
        return jnp.sum(JM3[impl](a, w, jpop) * r)

    jy = JM3[impl](jnp.asarray(h), jnp.asarray(w2), jpop)
    jdh, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(h),
                                               jnp.asarray(w2))
    th = _t(h).requires_grad_(True)
    tw = _t(w2).requires_grad_(True)
    ty = TM3[impl](th, tw, tpop)
    tdh, tdw = torch.autograd.grad((ty * _t(r)).sum(), (th, tw))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **FWD)
    np.testing.assert_allclose(tdh.numpy(), np.asarray(jdh), **GRAD)
    np.testing.assert_allclose(tdw.numpy(), np.asarray(jdw), **GRAD)


# --------------------------------------------------------------------- #
# the layered engine's head                                             #
# --------------------------------------------------------------------- #

_WIDTHS = ((5, 3), (12, 9), (7,), (17, 9, 5), (8, 8),
           (5, 3), (3, 11, 2), (24, 16), (4,), (9, 9, 9))
JLP = JLayered(6, 3, _WIDTHS, ACTIVATION_ORDER, block=8)
TLP = TLayered(6, 3, _WIDTHS, ACTIVATION_ORDER, block=8)
B = 9


@pytest.fixture(scope="module")
def np_params():
    return jax.device_get(jdeep.init_params(jax.random.PRNGKey(0), JLP))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(1)
    return (rng.normal(0, 1, (B, 6)).astype(np.float32),
            rng.integers(0, 3, B).astype(np.int32))


@pytest.mark.parametrize("route", [
    dict(m3_impl="pallas"),
    dict(m3_impl="onehot"),
    dict(bd_impl="pallas", act_impl="pallas", m3_impl="pallas"),
], ids=lambda r: "-".join(f"{k}={v}" for k, v in r.items()))
def test_layered_head_matches_jax(np_params, batch, route):
    """``forward`` and ``loss_and_grads`` with the M3 head on ``route``
    against JAX's same route; with ``m3_impl="pallas"`` a step launches
    the M3 kernels once each (and the unfused route's kernels as
    ``unfused_step_launches`` says)."""
    x, y = batch
    params = tdeep.params_from_numpy(np_params, TLP, device="cpu")
    # jitted: JAX's interpret-mode kernels run faster traced once
    want = jax.jit(lambda p, a: jdeep.forward(p, a, JLP, **route))(
        np_params, x)
    got = tdeep.forward(params, _t(x), TLP, **route)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ROUTE)
    (jl, jper), jgrads = jax.jit(jax.value_and_grad(
        lambda p, a, t: jdeep.fused_loss(p, a, t, JLP, **route),
        has_aux=True))(np_params, x, y)
    (loss, per, grads), n = _moved(lambda: tdeep.loss_and_grads(
        params, _t(x), _t(y, torch.long), TLP, **route))
    np.testing.assert_allclose(loss.numpy(), np.asarray(jl), **ROUTE)
    np.testing.assert_allclose(per.numpy(), np.asarray(jper), **ROUTE)
    gl, wl = tree_leaves(grads), jax.tree.leaves(jgrads)
    assert len(gl) == len(wl)
    for i, (a, b) in enumerate(zip(gl, wl)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   err_msg=f"leaf {i}", **ROUTE)
    if route.get("bd_impl") == "pallas":
        assert n == tlc.unfused_step_launches(TLP.depth, "pallas")
    elif route["m3_impl"] == "pallas":
        assert n == tlc.m3_step_launches()
    else:
        assert n == {}
