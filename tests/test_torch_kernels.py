"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test decides inside itself whether a card is present
and skips on a CPU-only machine.  On the card run

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

(``--noconftest`` because the shared conftest imports JAX, which the GPU
machine need not have; this file imports torch and numpy only).

Tolerance: rtol 1e-4 / atol 1e-5 — f32 throughout, the kernels sum in a
different order than the plain versions (FMA chains over shared-memory
tiles and warp shuffles against cuBLAS), full float32 matmuls (TF32 off).
A plain version that sums with ``index_add_`` runs in f64 (``_f64``).
"""

import functools
import time

import numpy as np
import pytest
import torch

from repro_torch.core.activations import ACTIVATION_ORDER
from repro_torch.core.population import LayeredPopulation
from repro_torch.kernels import fused_input as fik
from repro_torch.kernels import fused_layer as flk
from repro_torch.kernels import infer_head as ihk
from repro_torch.kernels import loss_head as lhk
from repro_torch.kernels import _build, ops

pytestmark = pytest.mark.gpu

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _load_kernels()
    return torch.device("cuda")


@functools.cache
def _load_kernels():
    """Build and load every kernel library once, before any test opens a
    ``torch.profiler`` window (``_kernels_run``): in a run whose first
    window held the build and the first load (H100, torch 2.11), no window
    of the process recorded the kernels' device activity."""
    for name in _build.kernel_names():
        _build.library(name)


def _t(a, dev, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)


def _close(got, want):
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


def _f64(*tensors):
    """The f32 tensors in f64, the rest as they are: for the plain versions
    that sum with ``index_add_``, whose f32 order on the card varies per
    run (two f32 orders of a sum over hundreds of products differ by about
    atol), the exact sum is the reference."""
    return tuple(t.double() if t.dtype == torch.float32 else t
                 for t in tensors)


def _kernels_run(fn, word: str):
    """``fn()``'s result and the names, as ``torch.profiler`` records them,
    of the kernels the card ran for it whose name holds ``word``.  The
    window opens and closes with 0.1 s of idle host time: the profiler
    keeps only device activity that falls inside its window on the host's
    clock, and its device timestamps can run 0.1 ms or more ahead of that
    clock, so an unpadded window around one launch may record none."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.1)
        out = fn()
        torch.cuda.synchronize()
        time.sleep(0.1)
    names = [e.name for e in sorted(prof.events(),
                                    key=lambda e: e.time_range.start)
             if e.device_type == torch.autograd.DeviceType.CUDA
             and word in e.name]
    return out, names


# The forward's shapes: the four first cases of each test are the port's
# first ones; the rest reach each instance and edge of the W-streaming
# kernel (64-unit warp tiles, 8 batch rows a thread, F in stages).
_FWD_GRID = [
    (9, 6, 8, 20, 0), (32, 100, 128, 12, 0), (33, 17, 8, 41, 0),
    (32, 100, 8, 13, 0),      # block 8; H 104, not a multiple of a tile
    (32, 100, 128, 5, 0),     # B 32, block 128: a tile within one block
    (16, 100, 64, 3, 0),      # B < 32: a 16-row batch tile
    (3, 100, 8, 9, 0),        # B < 32: a 4-row batch tile
    (300, 100, 128, 2, 0),    # B > 32: ten batch tiles
    (32, 100, 8, 13, 1),      # x 4 bytes off a 16-byte boundary: scalar
    (5, 101, 8, 9, 0),        # F % 4 != 0: scalar, a tail of single steps
    (33, 1030, 8, 5, 0),      # F over many stages, x not resident
]


def _fwd_inputs(rng, b, f, block, n_blocks, shift, dev):
    h = block * n_blocks
    x = _shifted(rng.normal(0, 1, (b, f)).astype(np.float32), shift, dev)
    w = _t(rng.normal(0, 1, (h, f)) / np.sqrt(f), dev)
    bias = _t(rng.normal(0, 1, h), dev)
    mask = _t(rng.random(h) > 0.2, dev)
    ids = _t(np.arange(n_blocks) % len(ACTIVATION_ORDER), dev, torch.int32)
    return x, w, bias, mask, ids


def _fwd_instance(ran, path):
    """The profiler saw one launch, of the instance ``fwd_path`` names."""
    assert len(ran) == 1 and ("fused_input_kernel<%d,"
                              % (4 if path == "vec4" else 1)) in ran[0], ran


@pytest.mark.parametrize("b,f,block,n_blocks,shift",
                         _FWD_GRID + [(300, 130, 16, 9, 0)])
def test_fused_input_matches_plain(dev, b, f, block, n_blocks, shift):
    """y against the plain version, on the instance ``fwd_path`` names (the
    kernel ``torch.profiler`` saw run); two launches bitwise equal."""
    rng = np.random.default_rng(b)
    x, w, bias, mask, ids = _fwd_inputs(rng, b, f, block, n_blocks, shift,
                                        dev)
    n0 = fik.launches
    got, ran = _kernels_run(lambda: fik.fused_input_cuda(
        x, w, bias, mask, ids, block=block), "fused_input_kernel")
    assert fik.launches == n0 + 1
    path = fik.fwd_path(x, w, got)
    assert path == ("vec4" if f % 4 == 0 and w.shape[0] % 4 == 0
                    and shift % 4 == 0 else "scalar")
    _fwd_instance(ran, path)
    _close(got, fik.fused_input_plain(x, w, bias, mask, ids, block=block))
    assert torch.equal(got, fik.fused_input_cuda(x, w, bias, mask, ids,
                                                 block=block))


# The mid layer's forward (block_diag and fused_layer, one group core)
# beyond each test's first cases: a block that is not a multiple of 4 (the
# scalar instance), storage 4 or 12 bytes off a 16-byte boundary (scalar),
# B = 1 and B = 300 (ten batch tiles a group).  (widths, block, B, shift)
_MID_FWD_EXTRA = [
    (((24,), (13, 5), (17, 9), (32, 16, 8)), 6, 300, 0),
    (((40, 20), (17, 33, 9), (7,)), 5, 33, 0),
    (((24,), (13, 5), (17, 9), (32, 16, 8)), 8, 1, 0),
    (((64, 32, 16), (13, 5), (7,)) * 4, 8, 32, 1),
    (((200, 130), (64, 100), (7,)), 128, 300, 3),
]


def _group_instance(ran, path, word):
    """The profiler saw one launch, of the group core's instance
    ``block_diag.fwd_path`` names."""
    assert len(ran) == 1 and ("%s<%d" % (word, 4 if path == "vec4" else 1)
                              ) in ran[0], ran


def _mid_x_wb(rng, lay, block, b, shift, dev):
    """x and the identity-augmented tiles of one mid layer, each stored
    ``shift`` floats into its allocation."""
    x = rng.normal(0, 1, (b, lay.n_in_tiles * block)).astype(np.float32)
    wb = (rng.normal(0, 1, (lay.n_param_blocks + 1, block, block))
          / np.sqrt(block)).astype(np.float32)
    return _shifted(x, shift, dev), _shifted(wb, shift, dev)


@pytest.mark.parametrize("widths,block,b,shift", [
    (((24,), (13, 5), (17, 9), (32, 16, 8)), 8, 11, 0),
    (((5, 3), (12, 9), (7,), (17, 9, 5), (8, 8), (5, 3), (3, 11, 2),
      (24, 16), (4,), (9, 9, 9)), 8, 40, 0),
    (((200, 130), (64, 100), (7,)), 128, 33, 0),
] + _MID_FWD_EXTRA)
def test_fused_layer_matches_plain(dev, widths, block, b, shift):
    """y against the plain version, on the instance ``block_diag.fwd_path``
    names (the kernel ``torch.profiler`` saw run); two launches bitwise
    equal."""
    from repro_torch.kernels import block_diag as bdk
    acts = tuple(ACTIVATION_ORDER[i % 10] for i in range(len(widths)))
    lp = LayeredPopulation(5, 3, widths, acts, block=block)
    rng = np.random.default_rng(b)
    for l in range(lp.depth - 1):
        lay = lp.bd_layout(l)
        pout = lp.layer_pop(l + 1)
        x, wb = _mid_x_wb(rng, lay, block, b, shift, dev)
        b_eff = _t(rng.normal(0, 1, lay.n_out_tiles * block), dev)
        mask = _t(pout.hidden_mask, dev)
        acts_t = _t(pout.block_act_ids, dev, torch.int32)
        sched = flk.schedule_on(lay, dev)
        args = (x, wb, b_eff, mask, acts_t, *sched)
        n0 = flk.launches
        got, ran = _kernels_run(lambda: flk.fused_layer_cuda(*args,
                                                             blk=block),
                                "fused_layer_group_kernel")
        assert flk.launches == n0 + 1
        path = bdk.fwd_path(x, wb, got)
        assert path == ("vec4" if block % 4 == 0 and shift % 4 == 0
                        else "scalar")
        _group_instance(ran, path, "fused_layer_group_kernel")
        _close(got, flk.fused_layer_plain(*_f64(*args), blk=block))
        assert torch.equal(got, flk.fused_layer_cuda(*args, blk=block))


# several hundred members 8 or 16 units wide, as at the depth-3 head
_HEAD_NARROW = tuple(int(w) for w in
                     np.random.default_rng(6).choice([8, 16], 300))
_HEAD_EMPTY = (0, 0, 8, 0, 16) + (0,) * 70 + (24, 0, 0)


@pytest.mark.parametrize("log_probs", [False, True])
@pytest.mark.parametrize("widths,block,o,b,shift", [
    ((5, 12, 7, 17, 8, 3, 24, 4, 9, 1), 8, 3, 9, 0),
    ((100, 1, 37, 128, 129), 128, 2, 70, 0),
    ((33, 2, 65), 16, 16, 5, 0),
    ((128,) * 40, 128, 2, 33, 0),           # parallelmlp-10k's members
    (_HEAD_NARROW, 8, 2, 32, 0),            # the depth-3 head's
    (_HEAD_NARROW, 8, 16, 257, 0),
    (_HEAD_NARROW, 8, 5, 1, 0),
    (_HEAD_EMPTY, 8, 5, 31, 0),             # empty members, first and last
    ((1024, 1024, 2048, 40), 128, 1, 33, 0),  # members a tile wide or more
    ((40, 5000, 16, 24), 8, 2, 257, 0),     # a member over several tiles
    ((7, 13, 30, 2, 64, 9), 6, 2, 31, 0),   # blocks not a multiple of 4
    ((5, 10, 35, 5, 0, 15) * 20, 5, 16, 33, 0),
    ((3, 1, 0, 7, 2) * 50, 1, 1, 257, 0),
    ((128,) * 40, 128, 2, 31, 1),           # h 4 bytes off: the scalar path
    (_HEAD_NARROW, 8, 5, 33, 2),
])
def test_infer_head_matches_plain(dev, log_probs, widths, block, o, b,
                                  shift):
    """Each launch against the plain version, on the design ``kernel_path``
    names (the kernel ``torch.profiler`` saw run); two launches on the same
    inputs bitwise equal."""
    rng = np.random.default_rng(len(widths) + o)
    blocks = [-(-w // block) for w in widths]
    seg = np.repeat(np.arange(len(widths)), blocks).astype(np.int32)
    hh = int(sum(blocks)) * block
    # h's storage starts `shift` floats past a (256-byte aligned) allocation
    h = torch.empty(b * hh + shift, device=dev)[shift:].view(b, hh)
    h.copy_(_t(rng.normal(0, 1, (b, hh)), dev))
    w2 = _t(rng.normal(0, 1, (o, hh)) / 8, dev)
    b2 = _t(rng.normal(0, 1, (len(widths), o)), dev)
    ptr = ihk.member_ptr(_t(seg, dev, torch.int32), len(widths))
    path = ihk.kernel_path(block, h, w2)
    assert path == ("vec4" if block % 4 == 0 and shift % 4 == 0
                    else "scalar")
    n0 = ihk.launches
    got, ran = _kernels_run(lambda: ihk.infer_head_cuda(
        h, w2, b2, ptr, block=block, log_probs=log_probs), "infer_head")
    assert ihk.launches == n0 + 1
    assert len(ran) == 1 and f"infer_head_kernel_{path}" in ran[0], ran
    _close(got, ihk.infer_head_plain(*_f64(h, w2, b2, ptr), block=block,
                                     log_probs=log_probs))
    assert torch.equal(got, ihk.infer_head_cuda(h, w2, b2, ptr, block=block,
                                                log_probs=log_probs))


_SERVE_WIDTHS = ((5, 3), (12, 9), (7,), (17, 9, 5), (8, 8), (5, 3),
                 (3, 11, 2), (24, 16), (4,), (9, 9, 9))


def _serve_layout():
    return LayeredPopulation(6, 3, _SERVE_WIDTHS, ACTIVATION_ORDER, block=8)


def _params_on(params, device):
    if isinstance(params, dict):
        return {k: _params_on(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [_params_on(v, device) for v in params]
    return params.to(device)


def test_forward_on_card_matches_cpu(dev):
    """The served forward on the card (depth+1 kernel launches) against the
    same parameters' plain route on the CPU, every activation present."""
    from repro_torch.core.deep import forward, init_params
    from repro_torch.launch.launch_count import kernel_launches
    lp = _serve_layout()
    p_cpu = init_params(torch.Generator().manual_seed(0), lp)
    p_dev = _params_on(p_cpu, dev)
    x = torch.randn(9, 6, generator=torch.Generator().manual_seed(1))
    before = kernel_launches()
    got = forward(p_dev, x.to(dev), lp, bd_impl="fused", infer=True,
                  log_probs=True)
    after = kernel_launches()
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == \
        {"fused_input": 1, "fused_layer": lp.depth - 1, "infer_head": 1}
    want = forward(p_cpu, x, lp, bd_impl="einsum", head_impl="xla",
                   infer=True, log_probs=True)
    _close(got, want)


def test_server_on_card_matches_cpu(dev):
    """``PopulationServer`` on the card: launch budget, leaderboard and
    predictions in every mode equal to the same server on the CPU."""
    from repro_torch.core.deep import init_params
    from repro_torch.launch.serve_population import PopulationServer
    lp = _serve_layout()
    params = init_params(torch.Generator().manual_seed(0), lp)
    rng = np.random.default_rng(2)
    xc = rng.normal(0, 1, (40, 6)).astype(np.float32)
    yc = rng.integers(0, 3, 40)
    xr = rng.normal(0, 1, (21, 6)).astype(np.float32)
    cpu, card = (PopulationServer(_params_on(params, d), lp, batch=8, topk=3)
                 for d in ("cpu", dev))
    assert card.check_budget() == {"launches": 4, "budget": 4}
    assert [r["slot"] for r in card.publish(xc, yc)] == \
        [r["slot"] for r in cpu.publish(xc, yc)]
    for mode in ("best1", "topk", "all"):
        np.testing.assert_array_equal(card.run(xr, mode)["pred"],
                                      cpu.run(xr, mode)["pred"])


def test_ops_launch_on_card_and_reject_bad_input(dev):
    """The dispatch layer launches the kernel for a CUDA tensor (the
    counter moves) and raises on input the kernel does not take — it never
    gives way to the plain version."""
    x = torch.randn(4, 6, device=dev)
    w = torch.randn(16, 6, device=dev)
    b = torch.zeros(16, device=dev)
    ids = np.zeros(2, np.int32)
    mask = np.ones(16, np.float32)
    n0 = fik.launches
    ops.fused_input_infer(x, w, b, ids, mask, block=8)
    assert fik.launches == n0 + 1
    with pytest.raises(TypeError):
        ops.fused_input_infer(x.double(), w, b, ids, mask, block=8)
    h = torch.randn(3, 16, device=dev)
    with pytest.raises(ValueError, match="at most"):
        ops.infer_head(h, torch.randn(17, 16, device=dev),
                       torch.zeros(2, 17, device=dev), np.array([0, 1]),
                       block_h=8)


# --------------------------------------------------------------------- #
# the training kernels                                                  #
# --------------------------------------------------------------------- #

def _kinks(n_cols: int) -> np.ndarray:
    """Pre-activations exactly at the activations' kinks and around them."""
    vals = np.array([0.0, 0.5, -0.5, 1e-3, -1e-3, 2.0, -2.0, 0.25],
                    np.float32)
    return np.resize(vals, n_cols)


@pytest.mark.parametrize("b,f,block,n_blocks,shift",
                         _FWD_GRID + [(70, 130, 16, 9, 0)])
def test_fused_input_train_matches_plain(dev, b, f, block, n_blocks, shift):
    """(y, g') against the plain version, on the instance ``fwd_path``
    names; y bitwise the serving launch's, two launches bitwise equal; and
    pre-activations at the activations' kinks."""
    rng = np.random.default_rng(b)
    x, w, bias, mask, ids = _fwd_inputs(rng, b, f, block, n_blocks, shift,
                                        dev)
    n0 = fik.launches
    (y, g), ran = _kernels_run(lambda: fik.fused_input_train_cuda(
        x, w, bias, mask, ids, block=block), "fused_input_kernel")
    assert fik.launches == n0 + 1
    _fwd_instance(ran, fik.fwd_path(x, w, y, g))
    wy, wg = fik.fused_input_train_plain(x, w, bias, mask, ids, block=block)
    _close(y, wy)
    _close(g, wg)
    assert torch.equal(y, fik.fused_input_cuda(x, w, bias, mask, ids,
                                               block=block))
    again = fik.fused_input_train_cuda(x, w, bias, mask, ids, block=block)
    assert torch.equal(y, again[0]) and torch.equal(g, again[1])
    # kinks: x = 0 makes the pre-activation exactly the bias
    kb = _t(_kinks(w.shape[0]), dev)
    y, g = fik.fused_input_train_cuda(torch.zeros_like(x), w, kb, mask, ids,
                                      block=block)
    wy, wg = fik.fused_input_train_plain(torch.zeros_like(x), w, kb, mask,
                                         ids, block=block)
    _close(y, wy)
    _close(g, wg)


def _shifted(a, shift: int, dev, dtype=None):
    """``a`` on the card in a tensor (of ``dtype``; default int8 for int8
    arrays, else f32) whose storage starts ``shift`` elements past a
    (256-byte aligned) allocation."""
    a = np.asarray(a)
    if dtype is None:
        dtype = torch.int8 if a.dtype == np.int8 else torch.float32
    t = torch.empty(a.size + shift, device=dev,
                    dtype=dtype)[shift:].view(a.shape)
    t.copy_(torch.as_tensor(a))
    return t


@pytest.mark.parametrize("with_dx", [False, True])
@pytest.mark.parametrize("b,f,h,shift", [
    (9, 6, 64, 0), (32, 100, 8192, 0), (70, 130, 4104, 0),
    (32, 100, 8196, 0),     # H not a multiple of a task's 80 rows
    (32, 102, 4100, 0),     # F % 4 != 0: the scalar instance
    (33, 1030, 260, 0),     # F over 1024 (two feature groups a thread), B 33
    (40, 1028, 204, 0),     # the same on the vec4 instance, B 40
    (300, 100, 1000, 0),    # B over nine batch chunks, added in order
    (1, 100, 4000, 0),      # B 1
    (32, 100, 8192, 1),     # dy 4 bytes off a 16-byte boundary: scalar
    (32, 101, 8190, 3),     # dy off, F and H not multiples of 4
])
def test_fused_input_bwd_matches_plain(dev, with_dx, b, f, h, shift):
    """dW (and dx) against the plain version, on the instance ``bwd_path``
    names (the kernel ``torch.profiler`` saw run); two launches on the same
    inputs bitwise equal."""
    rng = np.random.default_rng(h)
    dy = _shifted(rng.normal(0, 1, (b, h)).astype(np.float32), shift, dev)
    g = _t(rng.random((b, h)) * (rng.random(h) > 0.2), dev)
    x = _t(rng.normal(0, 1, (b, f)), dev)
    w = _t(rng.normal(0, 1, (h, f)) / np.sqrt(f), dev)
    path = fik.bwd_path(dy, g, x, torch.empty(4, device=dev))
    assert path == ("vec4" if f % 4 == 0 and h % 4 == 0 and shift % 4 == 0
                    else "scalar")
    n0 = fik.bwd_launches
    (dx, dw), ran = _kernels_run(lambda: fik.fused_input_bwd_cuda(
        dy, g, x, w, with_dx=with_dx), "fused_input_bwd")
    assert fik.bwd_launches == n0 + 1
    assert len(ran) == 1 and ("fused_input_bwd_kernel<%d>"
                              % (4 if path == "vec4" else 1)) in ran[0], ran
    wdx, wdw = fik.fused_input_bwd_plain(dy, g, x, w, with_dx=with_dx)
    _close(dw, wdw)
    again_dx, again_dw = fik.fused_input_bwd_cuda(dy, g, x, w,
                                                  with_dx=with_dx)
    assert torch.equal(dw, again_dw)      # one owner, one order
    if with_dx:
        _close(dx, wdx)
        assert torch.equal(dx, again_dx)  # ordered reduction: reproducible
    else:
        assert dx is None


_TRAIN_GRID = [
    (((24,), (13, 5), (17, 9), (32, 16, 8)), 8, 11),
    (((5, 3), (12, 9), (7,), (17, 9, 5), (8, 8), (5, 3), (3, 11, 2),
      (24, 16), (4,), (9, 9, 9)), 8, 40),
    (((40, 20), (17, 33, 9), (7,)), 16, 70),
    (((200, 130), (64, 100), (7,)), 128, 33),
    # a block-8 member wider than one unit of the backward (64 input
    # tiles: eight units; 384 output units: twelve chunks) and a batch past
    # its 32-row chunks (dW added over chunks in order)
    (((512, 384), (13, 5), (7,)), 8, 300),
]


# (widths, block, B, shift): _TRAIN_GRID, then the forward's extra shapes
_MID_GRID = [(w, block, b, 0) for w, block, b in _TRAIN_GRID] \
    + _MID_FWD_EXTRA


@pytest.mark.parametrize("widths,block,b,shift", _MID_GRID)
def test_fused_layer_train_and_dx_dw_match_plain(dev, widths, block, b,
                                                 shift):
    """The training forward (y, g') on the instance ``block_diag.fwd_path``
    names, two launches bitwise equal and y bitwise the serving launch's;
    then the one-pass backward, bitwise reproducible."""
    from repro_torch.kernels import block_diag as bdk
    acts = tuple(ACTIVATION_ORDER[i % 10] for i in range(len(widths)))
    lp = LayeredPopulation(5, 3, widths, acts, block=block)
    rng = np.random.default_rng(b)
    for l in range(lp.depth - 1):
        lay = lp.bd_layout(l)
        pout = lp.layer_pop(l + 1)
        x, wb = _mid_x_wb(rng, lay, block, b, shift, dev)
        wb[-1] = torch.eye(block, device=dev)
        b_eff = _t(rng.normal(0, 1, lay.n_out_tiles * block), dev)
        mask = _t(pout.hidden_mask, dev)
        acts_t = _t(pout.block_act_ids, dev, torch.int32)
        sched = flk.schedule_on(lay, dev)
        fargs = (x, wb, b_eff, mask, acts_t, *sched)
        (y, g), ran = _kernels_run(
            lambda: flk.fused_layer_train_cuda(*fargs, blk=block),
            "fused_layer_group_kernel")
        _group_instance(ran, bdk.fwd_path(x, wb, y, g),
                        "fused_layer_group_kernel")
        wy, wg = flk.fused_layer_train_plain(*_f64(*fargs), blk=block)
        _close(y, wy)
        _close(g, wg)
        again = flk.fused_layer_train_cuda(*fargs, blk=block)
        assert torch.equal(y, again[0]) and torch.equal(g, again[1])
        assert torch.equal(y, flk.fused_layer_cuda(*fargs, blk=block))
        dy = _t(rng.normal(0, 1, (b, lay.n_out_tiles * block)), dev)
        args = (dy, g, x, wb[:-1], *flk.dx_dw_schedule_on(lay, dev))
        n0 = flk.dx_dw_launches
        dx, dwb = flk.fused_layer_dx_dw_cuda(*args, blk=block)
        assert flk.dx_dw_launches == n0 + 1
        wdx, wdwb = flk.fused_layer_dx_dw_plain(*_f64(*args), blk=block)
        _close(dx, wdx)
        _close(dwb, wdwb)
        # one owner per output, a fixed order: bitwise reproducible
        again = flk.fused_layer_dx_dw_cuda(*args, blk=block)
        assert torch.equal(dx, again[0]) and torch.equal(dwb, again[1])


def test_group_core_shapes_match_the_kernel(dev):
    """The register tile ``block_diag.fwd_groups`` cuts by is the
    kernel's."""
    from repro_torch.kernels import block_diag as bdk
    assert bdk.core_shapes() == (bdk.GROUP_COLS, bdk.LANE_COLS)


@pytest.mark.parametrize("block,b", [(8, 33), (5, 7)])
def test_group_core_reads_the_indices_of_a_general_csr(dev, block, b):
    """A CSR whose tiles follow no rule of a layout (its weight tiles
    renumbered at random, one member's input tiles reversed in its first
    row): the forward (block_diag and fused_layer), reading s_in and s_w,
    still matches the plain version."""
    from repro_torch.kernels import block_diag as bdk
    rng = np.random.default_rng(block)
    lp = LayeredPopulation(5, 3, ((24,), (13, 5), (17, 9), (32, 16, 8)),
                           ("relu", "tanh", "gelu", "elu"), block=block)
    lay = lp.bd_layout(0)
    rowptr, s_in, s_w = flk.csr_schedule(lay)
    perm = rng.permutation(lay.n_param_blocks + 1)
    s_w = perm[s_w].astype(np.int32)
    s_in = s_in.copy()
    s_in[rowptr[0]:rowptr[1]] = s_in[rowptr[0]:rowptr[1]][::-1]
    sched = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                  for a in (rowptr, s_in, s_w))
    x = _t(rng.normal(0, 1, (b, lay.n_in_tiles * block)), dev)
    wb = _t(rng.normal(0, 1, (lay.n_param_blocks + 1, block, block)), dev)
    _close(bdk.block_diag_fwd_cuda(x, wb, *sched, blk=block),
           bdk.block_diag_fwd_plain(*_f64(x, wb, *sched), blk=block))
    pout = lp.layer_pop(1)
    args = (x, wb, _t(rng.normal(0, 1, lay.n_out_tiles * block), dev),
            _t(pout.hidden_mask, dev),
            _t(pout.block_act_ids, dev, torch.int32), *sched)
    y, g = flk.fused_layer_train_cuda(*args, blk=block)
    wy, wg = flk.fused_layer_train_plain(*_f64(*args), blk=block)
    _close(y, wy)
    _close(g, wg)


def test_mid_forward_refuses_another_layouts_groups(dev):
    """A schedule (and its group table) of a wider layout would send the
    kernel past x and wb: every forward wrapper refuses it before any
    launch."""
    small = LayeredPopulation(5, 3, ((24,), (13, 5)), ("relu", "tanh"),
                              block=8).bd_layout(0)
    wide = LayeredPopulation(5, 3, ((512, 384), (13, 5)), ("relu", "tanh"),
                             block=8).bd_layout(0)
    x = torch.zeros(4, small.n_in_tiles * 8, device=dev)
    wb = torch.zeros(small.n_param_blocks + 1, 8, 8, device=dev)
    vec = torch.zeros(wide.n_out_tiles * 8, device=dev)
    ids = torch.zeros(wide.n_out_tiles, dtype=torch.int32, device=dev)
    from repro_torch.kernels import block_diag as bdk
    sched = flk.schedule_on(wide, dev)
    n0, m0 = bdk.fwd_launches, flk.launches
    wb_q = torch.zeros(small.n_param_blocks + 1, 8, 8, dtype=torch.int8,
                       device=dev)
    scale = torch.ones(small.n_param_blocks + 1, device=dev)
    i0 = flk.int8_launches
    for call in (lambda: bdk.block_diag_fwd_cuda(x, wb, *sched, blk=8),
                 lambda: flk.fused_layer_cuda(x, wb, vec, vec, ids, *sched,
                                              blk=8),
                 lambda: flk.fused_layer_train_cuda(x, wb, vec, vec, ids,
                                                    *sched, blk=8),
                 lambda: flk.fused_layer_int8_cuda(x, wb_q, scale, vec, vec,
                                                   ids, *sched, blk=8)):
        with pytest.raises(ValueError, match="another layout"):
            call()
    assert (bdk.fwd_launches, flk.launches, flk.int8_launches) == (n0, m0,
                                                                    i0)


@pytest.mark.parametrize("change", ["other_s_w", "s_w_in_place", "planted"])
def test_mid_forward_follows_the_csr_it_is_given(dev, change):
    """A schedule's rowptr, its table kept, launched with another s_w of
    the same size, with its s_w changed in place, or with another layout's
    table planted on it: every forward wrapper computes the CSR it is
    given, as the plain version does."""
    from repro_torch.kernels import block_diag as bdk
    rng = np.random.default_rng(5)
    lp = LayeredPopulation(5, 3, ((24,), (13, 5), (17, 9), (32, 16, 8)),
                           ("relu", "tanh", "gelu", "elu"), block=8)
    lay = lp.bd_layout(0)
    pout = lp.layer_pop(1)
    rowptr, s_in, s_w = (t.clone() for t in flk.schedule_on(lay, dev))
    x = _t(rng.normal(0, 1, (9, lay.n_in_tiles * 8)), dev)
    wb = _t(rng.normal(0, 1, (lay.n_param_blocks + 1, 8, 8)), dev)
    ep = (_t(rng.normal(0, 1, lay.n_out_tiles * 8), dev),
          _t(pout.hidden_mask, dev),
          _t(pout.block_act_ids, dev, torch.int32))
    bdk.block_diag_fwd_cuda(x, wb, rowptr, s_in, s_w, blk=8)  # keeps one
    perm = torch.from_numpy(rng.permutation(lay.n_param_blocks + 1)
                            .astype(np.int32)).to(dev)
    if change == "other_s_w":
        s_w = perm[s_w.long()]
    elif change == "s_w_in_place":
        s_w.copy_(perm[s_w.long()])
    else:
        wide = LayeredPopulation(5, 3, ((512, 384), (13, 5)),
                                 ("relu", "tanh"), block=8).bd_layout(0)
        rowptr.bd_groups = flk.schedule_on(wide, dev)[0].bd_groups
    sched = (rowptr, s_in, s_w)
    _close(bdk.block_diag_fwd_cuda(x, wb, *sched, blk=8),
           bdk.block_diag_fwd_plain(*_f64(x, wb, *sched), blk=8))
    args = (x, wb, *ep, *sched)
    _close(flk.fused_layer_cuda(*args, blk=8),
           flk.fused_layer_plain(*_f64(*args), blk=8))
    y, g = flk.fused_layer_train_cuda(*args, blk=8)
    wy, wg = flk.fused_layer_train_plain(*_f64(*args), blk=8)
    _close(y, wy)
    _close(g, wg)


def test_dx_dw_packing_matches_the_kernels_stages(dev):
    """The packing constants ``dx_dw_units`` cuts by are the kernel's
    stage shapes."""
    from repro_torch.kernels import block_diag as bdk
    assert flk.kernel_stages() == (bdk.TEAM_COLS, bdk.WARP_OUT,
                                   bdk.WARP_COLS, bdk.WARP_JOB)


def test_block_diag_dw_refuses_another_layouts_tiles(dev):
    """Tile lists of a wider layout would send the dW kernel past dy and
    x: the wrapper refuses them before any launch."""
    from repro_torch.kernels import block_diag as bdk
    small = LayeredPopulation(5, 3, ((24,), (13, 5)), ("relu", "tanh"),
                              block=8).bd_layout(0)
    wide = LayeredPopulation(5, 3, ((512, 384), (13, 5)), ("relu", "tanh"),
                             block=8).bd_layout(0)
    x = torch.zeros(4, small.n_in_tiles * 8, device=dev)
    dy = torch.zeros(4, small.n_out_tiles * 8, device=dev)
    out_t, in_t = flk.schedule_on(wide, dev, transposed=True)[4:]
    n0 = bdk.dw_launches
    with pytest.raises(ValueError, match="block_diag_dw: the units reach"):
        bdk.block_diag_dw_cuda(dy, x, out_t, in_t, blk=8)
    assert bdk.dw_launches == n0


def test_fused_layer_dx_dw_refuses_another_layouts_units(dev):
    """Units of a wider layout would send the kernel past x, dy and wb:
    the wrapper refuses them before any launch."""
    small = LayeredPopulation(5, 3, ((24,), (13, 5)), ("relu", "tanh"),
                              block=8).bd_layout(0)
    wide = LayeredPopulation(5, 3, ((512, 384), (13, 5)), ("relu", "tanh"),
                             block=8).bd_layout(0)
    x = torch.zeros(4, small.n_in_tiles * 8, device=dev)
    dy = torch.zeros(4, small.n_out_tiles * 8, device=dev)
    wb = torch.zeros(small.n_param_blocks, 8, 8, device=dev)
    flk.fused_layer_dx_dw_cuda(dy, dy, x, wb,
                               *flk.dx_dw_schedule_on(small, dev), blk=8)
    n0 = flk.dx_dw_launches
    for units, ptr in (flk.dx_dw_schedule_on(wide, dev),
                       tuple(torch.from_numpy(a).to(dev)
                             for a in flk.dx_dw_units(wide))):
        with pytest.raises(ValueError, match="another layout"):
            flk.fused_layer_dx_dw_cuda(dy, dy, x, wb, units, ptr, blk=8)
    assert flk.dx_dw_launches == n0


# several hundred narrow members, 8 or 16 units at block 8, as at the head
# of the trainer's depth-3 population
_NARROW = tuple(int(w) for w in
                np.random.default_rng(5).choice([8, 16], 300))


@pytest.mark.parametrize("widths,block,o,b,shift", [
    ((5, 12, 7, 17, 8, 3, 24, 4, 9, 1), 8, 3, 9, 0),
    ((100, 1, 37, 128, 129), 128, 2, 70, 0),
    ((33, 2, 65), 16, 16, 5, 0),
    (_NARROW, 8, 2, 32, 0),
    (_NARROW, 8, 16, 257, 0),
    (_NARROW, 8, 2, 1, 0),
    ((40, 5000, 16, 24), 8, 2, 32, 0),      # a member wider than a CTA tile
    ((40, 5000, 16, 24), 8, 1, 257, 0),
    ((128,) * 40, 128, 2, 32, 0),
    ((7, 13, 30, 2, 64, 9), 6, 2, 32, 0),   # a block not a multiple of 4
    (_NARROW[:80], 8, 2, 32, 1),            # h 4 bytes off: the scalar path
])
def test_loss_head_matches_plain(dev, widths, block, o, b, shift):
    """Each launch against the plain version, on the design ``kernel_path``
    names (the kernel ``torch.profiler`` saw run); two launches on the same
    inputs bitwise equal."""
    rng = np.random.default_rng(len(widths) + o)
    blocks = [-(-w // block) for w in widths]
    seg = _t(np.repeat(np.arange(len(widths)), blocks), dev, torch.int32)
    hh = int(sum(blocks)) * block
    # h's storage starts `shift` floats past a (256-byte aligned) allocation
    h = torch.empty(b * hh + shift, device=dev)[shift:].view(b, hh)
    h.copy_(_t(rng.normal(0, 1, (b, hh)), dev))
    w2 = _t(rng.normal(0, 1, (o, hh)) / 8, dev)
    b2 = _t(rng.normal(0, 1, (len(widths), o)), dev)
    tgt = rng.integers(0, o, b)
    pads = min(2, b - 1)
    tgt[b - pads:] = -1                              # pad rows
    tgt = _t(tgt, dev, torch.int32)
    ptr = ihk.member_ptr(seg, len(widths))
    path = lhk.kernel_path(block, h, w2)
    assert path == ("vec4" if block % 4 == 0 and shift % 4 == 0
                    else "scalar")
    fwd = (h, w2, b2, tgt, ptr)
    n0, m0 = lhk.fwd_launches, lhk.bwd_launches
    (per, dl), ran = _kernels_run(lambda: lhk.loss_head_fwd_cuda(
        *fwd, block=block, b_real=b - pads), "loss_head")
    assert len(ran) == 1 and f"loss_head_fwd_kernel_{path}" in ran[0], ran
    wper, wdl = lhk.loss_head_fwd_plain(*_f64(*fwd), block=block,
                                        b_real=b - pads)
    _close(per, wper)
    _close(dl, wdl)
    again = lhk.loss_head_fwd_cuda(*fwd, block=block, b_real=b - pads)
    assert torch.equal(per, again[0]) and torch.equal(dl, again[1])
    dper = _t(rng.normal(0, 1, len(widths)), dev)
    (dh, dw), ran = _kernels_run(lambda: lhk.loss_head_bwd_cuda(
        dper, dl, h, w2, seg, block=block), "loss_head")
    assert lhk.kernel_path(block, h, w2, dh, dw) == path
    assert len(ran) == 1 and f"loss_head_bwd_kernel_{path}" in ran[0], ran
    wdh, wdw = lhk.loss_head_bwd_plain(dper, dl, h, w2, seg, block=block)
    assert (lhk.fwd_launches, lhk.bwd_launches) == (n0 + 2, m0 + 1)
    _close(dh, wdh)
    _close(dw, wdw)
    again = lhk.loss_head_bwd_cuda(dper, dl, h, w2, seg, block=block)
    assert torch.equal(dh, again[0]) and torch.equal(dw, again[1])


def test_train_step_on_card_matches_cpu(dev):
    """One fused optimizer step on the card — 2·(depth+1) launches —
    against the same step on the CPU (the kernels' plain versions) and the
    plain route on the card; two steps from one state are bitwise equal."""
    from repro_torch.core import deep
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.launch_count import (fused_step_budget,
                                                 kernel_launches)
    from repro_torch.optim.optimizers import adamw
    lp = _serve_layout()
    p_cpu = deep.init_params(torch.Generator().manual_seed(0), lp)
    p_dev = _params_on(p_cpu, dev)
    x = torch.randn(33, 6, generator=torch.Generator().manual_seed(1))
    y = torch.randint(0, 3, (33,), generator=torch.Generator().manual_seed(2))
    opt = adamw(weight_decay=0.01)

    def step(params, xx, yy, **kw):
        return deep.opt_step(params, opt.init(params), xx, yy, 0.01, opt, lp,
                             grad_clip=1.0, **kw)

    before = kernel_launches()
    got = step(p_dev, x.to(dev), y.to(dev), bd_impl="fused")
    after = kernel_launches()
    assert sum(after.values()) - sum(before.values()) == \
        fused_step_budget(lp.depth)["total"]
    again = step(p_dev, x.to(dev), y.to(dev), bd_impl="fused")
    for a, b in zip(tree_leaves(got[0]), tree_leaves(again[0])):
        assert torch.equal(a, b)
    for want in (step(p_cpu, x, y, bd_impl="fused"),
                 step(p_dev, x.to(dev), y.to(dev), bd_impl="einsum")):
        _close(got[3], want[3])
        for a, b in zip(tree_leaves(got[0]), tree_leaves(want[0])):
            _close(a, b)



# --------------------------------------------------------------------- #
# the int8 serving kernels                                              #
# --------------------------------------------------------------------- #

def _int8(rng, shape, dev):
    return _t(rng.integers(-127, 128, shape), dev, torch.int8)


def _scales(rng, n, dev):
    """Scales of weights up to about 1 in magnitude (max|w| / 127), as the
    packer gives for the populations' init."""
    return _t(rng.random(n) * 0.006 + 1e-3, dev)


@pytest.mark.parametrize("b,f,block,n_blocks,shift",
                         _FWD_GRID + [(70, 130, 16, 9, 0)])
def test_fused_input_int8_matches_plain(dev, b, f, block, n_blocks, shift):
    """Batches off the 32-row tile, block 8 to 128; the pad columns of the
    pre-padded weight hold junk, which the kernel must not read.  The
    instance ``fwd_path`` names; bitwise the f32 kernel on the dequantized
    weight where both take the same instance; two launches bitwise equal."""
    from repro_torch.quant import _input_f_pad
    rng = np.random.default_rng(b + 1)
    h = block * n_blocks
    x = _shifted(rng.normal(0, 1, (b, f)).astype(np.float32), shift, dev)
    w_q = _int8(rng, (h, _input_f_pad(f)), dev)
    w_s = _scales(rng, n_blocks, dev)
    bias = _t(rng.normal(0, 1, h), dev)
    mask = _t(rng.random(h) > 0.2, dev)
    ids = _t(np.arange(n_blocks) % len(ACTIVATION_ORDER), dev, torch.int32)
    n0 = fik.int8_launches
    got, ran = _kernels_run(lambda: fik.fused_input_int8_cuda(
        x, w_q, w_s, bias, mask, ids, block=block), "fused_input_kernel")
    assert fik.int8_launches == n0 + 1
    path = fik.fwd_path(x, w_q, got)
    _fwd_instance(ran, path)
    _close(got, fik.fused_input_int8_plain(x, w_q, w_s, bias, mask, ids,
                                           block=block))
    assert torch.equal(got, fik.fused_input_int8_cuda(
        x, w_q, w_s, bias, mask, ids, block=block))
    w_dq = (w_q[:, :f].float() * w_s.repeat_interleave(block)[:, None]
            ).contiguous()
    y32 = fik.fused_input_cuda(x, w_dq, bias, mask, ids, block=block)
    if fik.fwd_path(x, w_dq, y32) == path:
        assert torch.equal(got, y32)


@pytest.mark.parametrize("widths,block,b,shift", _MID_GRID + [
    # x on a 16-byte boundary, wb_q 4 bytes past one: the vec4 instance
    (((64, 32, 16), (13, 5), (7,)) * 4, 8, 32, 4),
    # block 12: a 32-deep chunk starts inside a tile row and crosses its
    # end; block 4: four tiles a group row
    (((24,), (13, 5), (17, 9), (32, 16, 8)), 12, 33, 0),
    (((40, 20), (17, 33, 9), (7,)), 4, 9, 0)])
def test_fused_layer_int8_matches_plain(dev, widths, block, b, shift):
    """Pass-through steps on the appended identity tile (scale 1.0), every
    tile its own scale, blocks 5 to 128, batches off the tile, storage off
    a 16-byte boundary: on the group kernel's instance ``fwd_path`` names
    for the int8 tiles (the kernel ``torch.profiler`` saw run); two
    launches bitwise equal, and bitwise the f32 group kernel on the
    dequantized tiles where both take the same instance."""
    from repro_torch.kernels import block_diag as bdk
    acts = tuple(ACTIVATION_ORDER[i % 10] for i in range(len(widths)))
    lp = LayeredPopulation(5, 3, widths, acts, block=block)
    rng = np.random.default_rng(b + 2)
    word = "fused_layer_i8_group_kernel"
    for l in range(lp.depth - 1):
        lay = lp.bd_layout(l)
        pout = lp.layer_pop(l + 1)
        x = _shifted(rng.normal(0, 1, (b, lay.n_in_tiles * block))
                     .astype(np.float32), shift, dev)
        wb_q = _shifted(rng.integers(-127, 128, (lay.n_param_blocks + 1,
                                                 block, block))
                        .astype(np.int8), shift, dev)
        wb_q[-1] = torch.eye(block, device=dev, dtype=torch.int8)
        wb_s = _scales(rng, lay.n_param_blocks + 1, dev)
        wb_s[-1] = 1.0
        b_eff = _t(rng.normal(0, 1, lay.n_out_tiles * block), dev)
        mask = _t(pout.hidden_mask, dev)
        acts_t = _t(pout.block_act_ids, dev, torch.int32)
        sched = flk.schedule_on(lay, dev)
        args = (x, wb_q, wb_s, b_eff, mask, acts_t, *sched)
        n0 = flk.int8_launches
        got, ran = _kernels_run(
            lambda: flk.fused_layer_int8_cuda(*args, blk=block), word)
        assert flk.int8_launches == n0 + 1
        path = bdk.fwd_path(x, wb_q, got)
        assert path == ("vec4" if block % 4 == 0 and shift % 4 == 0
                        else "scalar")
        _group_instance(ran, path, word)
        _close(got, flk.fused_layer_int8_plain(*_f64(*args), blk=block))
        assert torch.equal(got, flk.fused_layer_int8_cuda(*args, blk=block))
        wdq = wb_q.float() * wb_s[:, None, None]
        y32 = flk.fused_layer_cuda(x, wdq, *args[3:], blk=block)
        if bdk.fwd_path(x, wdq, y32) == path:
            assert torch.equal(got.view(torch.int32), y32.view(torch.int32))


@pytest.mark.parametrize("log_probs", [False, True])
@pytest.mark.parametrize("widths,block,o,b,shifts", [
    ((5, 12, 7, 17, 8, 3, 24, 4, 9, 1), 8, 3, 9, (0, 0)),
    ((100, 1, 37, 128, 129, 600), 128, 2, 70, (0, 0)),  # over 256 units
    ((33, 2, 700), 8, 16, 33, (0, 0)),
    ((128,) * 40, 128, 2, 32, (0, 0)),     # parallelmlp-10k's members
    (_HEAD_NARROW, 8, 2, 32, (0, 0)),      # the depth-3 head's, block 8
    (_HEAD_NARROW, 8, 16, 257, (0, 0)),
    (_HEAD_EMPTY, 8, 5, 31, (0, 0)),       # empty members, first and last
    ((40, 5000, 16, 24), 8, 2, 33, (0, 0)),  # a member over several tiles
    ((7, 13, 30, 2, 64, 9), 6, 2, 31, (0, 0)),  # block 6: the scalar path
    ((128,) * 40, 128, 2, 32, (1, 0)),     # h 4 bytes off: scalar
    (_HEAD_NARROW, 8, 2, 32, (0, 2)),      # w2_q 2 bytes off: scalar
])
def test_infer_head_int8_matches_plain(dev, log_probs, widths, block, o, b,
                                       shifts):
    """Each launch against the plain version, on the design ``kernel_path``
    names for an int8 w2 (the kernel ``torch.profiler`` saw run); two
    launches on the same inputs bitwise equal, and bitwise the f32
    kernel's output on the dequantized weight where both take the same
    instance."""
    rng = np.random.default_rng(len(widths) + o + 1)
    blocks = [-(-w // block) for w in widths]
    seg = np.repeat(np.arange(len(widths)), blocks).astype(np.int32)
    hh = int(sum(blocks)) * block
    h = _shifted(rng.normal(0, 1, (b, hh)).astype(np.float32), shifts[0],
                 dev)
    w_q = _shifted(rng.integers(-127, 128, (o, hh)).astype(np.int8),
                   shifts[1], dev)
    w_s = _scales(rng, hh // block, dev)
    b2 = _t(rng.normal(0, 1, (len(widths), o)), dev)
    ptr = ihk.member_ptr(_t(seg, dev, torch.int32), len(widths))
    path = ihk.kernel_path(block, h, w_q)
    assert path == ("vec4" if block % 4 == 0 and shifts[0] % 4 == 0
                    and shifts[1] % 4 == 0 else "scalar")
    n0 = ihk.int8_launches
    got, ran = _kernels_run(lambda: ihk.infer_head_int8_cuda(
        h, w_q, w_s, b2, ptr, block=block, log_probs=log_probs),
        "infer_head")
    assert ihk.int8_launches == n0 + 1
    assert len(ran) == 1 and f"infer_head_i8_kernel_{path}" in ran[0], ran
    _close(got, ihk.infer_head_int8_plain(*_f64(h, w_q, w_s, b2, ptr),
                                          block=block, log_probs=log_probs))
    assert torch.equal(got, ihk.infer_head_int8_cuda(
        h, w_q, w_s, b2, ptr, block=block, log_probs=log_probs))
    w_dq = w_q.float() * w_s.repeat_interleave(block)[None, :]
    if ihk.kernel_path(block, h, w_dq) == path:
        assert torch.equal(got, ihk.infer_head_cuda(
            h, w_dq, b2, ptr, block=block, log_probs=log_probs))


def test_int8_server_on_card_matches_cpu(dev):
    """The int8 serve copy on the card: quantized there byte-equal to the
    CPU's, its forward depth+1 int8 launches and none of the f32 kernels,
    equal to the f32 forward of the dequantized tree on the CPU, and the
    server's predictions equal to the same server on the CPU."""
    from repro_torch.core.deep import forward, init_params
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.launch_count import kernel_launches
    from repro_torch.launch.serve_population import PopulationServer
    from repro_torch.quant import dequantize_population, quantize_population
    lp = _serve_layout()
    params = init_params(torch.Generator().manual_seed(0), lp)
    q_cpu = quantize_population(params, lp)
    q_dev = quantize_population(_params_on(params, dev), lp)
    assert all(torch.equal(a.cpu(), b) for a, b in
               zip(tree_leaves(q_dev), tree_leaves(q_cpu)))
    x = torch.randn(9, 6, generator=torch.Generator().manual_seed(1))
    before = kernel_launches()
    got = forward(q_dev, x.to(dev), lp, bd_impl="fused", infer=True,
                  weights_dtype="int8", log_probs=True)
    after = kernel_launches()
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == \
        {"fused_input_int8": 1, "fused_layer_int8": lp.depth - 1,
         "infer_head_int8": 1}
    want = forward(dequantize_population(q_cpu, lp), x, lp,
                   bd_impl="einsum", head_impl="xla", infer=True,
                   log_probs=True)
    _close(got, want)
    rng = np.random.default_rng(2)
    xc = rng.normal(0, 1, (40, 6)).astype(np.float32)
    yc = rng.integers(0, 3, 40)
    xr = rng.normal(0, 1, (21, 6)).astype(np.float32)
    cpu, card = (PopulationServer(_params_on(params, d), lp, batch=8, topk=3,
                                  weights_dtype="int8")
                 for d in ("cpu", dev))
    assert card.check_budget() == {"launches": 4, "budget": 4}
    assert [r["slot"] for r in card.publish(xc, yc)] == \
        [r["slot"] for r in cpu.publish(xc, yc)]
    for mode in ("best1", "topk", "all"):
        np.testing.assert_array_equal(card.run(xr, mode)["pred"],
                                      cpu.run(xr, mode)["pred"])


# --------------------------------------------------------------------- #
# the unfused route: block-diagonal GEMM and segmented activation       #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("b,block,n_blocks,offset", [
    (9, 8, 20, 0), (32, 16, 13, 0), (33, 128, 7, 0), (5, 8, 3, 1),
    (7, 3, 5, 0)])
def test_seg_act_and_bwd_match_plain(dev, b, block, n_blocks, offset):
    """Every activation, the padding mask, pre-activations on the kinks;
    16-byte vector access, and the scalar path (an unaligned view, a width
    not a multiple of 4)."""
    from repro_torch.kernels import seg_act as sak
    rng = np.random.default_rng(b + block)
    hh = block * n_blocks
    vals = rng.normal(0, 2, (b, hh)).astype(np.float32)
    vals[:, ::3] = _kinks(hh)[::3]
    store = torch.zeros(b * hh + offset, device=dev)
    h = store[offset:].view(b, hh)
    h.copy_(_t(vals, dev))
    dy = _t(rng.normal(0, 1, (b, hh)), dev)
    ids = _t(np.arange(n_blocks) % len(ACTIVATION_ORDER), dev, torch.int32)
    mask = _t(rng.random(hh) > 0.2, dev)
    n0, m0 = sak.launches, sak.bwd_launches
    got = sak.seg_act_cuda(h, ids, mask, blk=block)
    dh = sak.seg_act_bwd_cuda(h, dy, ids, mask, blk=block)
    assert (sak.launches, sak.bwd_launches) == (n0 + 1, m0 + 1)
    _close(got, sak.seg_act_plain(h, ids, mask, blk=block))
    _close(dh, sak.seg_act_bwd_plain(h, dy, ids, mask, blk=block))


@pytest.mark.parametrize("b,block,n_blocks,offset", [
    (9, 8, 20, 0), (32, 16, 13, 0), (33, 128, 7, 0), (5, 8, 3, 1),
    (7, 3, 5, 0)])
def test_seg_act_bf16_matches_plain(dev, b, block, n_blocks, offset):
    """The bf16 instances (``seg_act_bf16_fwd_kernel``,
    ``seg_act_bf16_bwd_kernel``) on bf16 h and dy, every activation, the
    kinks and the f32 mask: ≤ 1 bf16 ulp from the plain version (the f32
    function on the widened values, rounded once) beyond the f32 atol, the
    instance ``torch.profiler`` saw (8-byte vector access, or scalar on an
    unaligned view or a width not a multiple of 4), two launches bitwise
    equal, counted under ``bf16_launches``/``bf16_bwd_launches``; the
    strict ulp distance is printed."""
    from repro_torch.kernels import seg_act as sak
    rng = np.random.default_rng(b + block)
    hh = block * n_blocks
    vals = rng.normal(0, 2, (b, hh)).astype(np.float32)
    vals[:, ::3] = _kinks(hh)[::3]
    h = _bf16(vals, dev, offset)
    dy = _bf16(rng.normal(0, 1, (b, hh)), dev)
    ids = _t(np.arange(n_blocks) % len(ACTIVATION_ORDER), dev, torch.int32)
    mask = _t(rng.random(hh) > 0.2, dev)
    vec = hh % 4 == 0 and offset == 0
    n0 = (sak.launches, sak.bwd_launches, sak.bf16_launches,
          sak.bf16_bwd_launches)
    y, ran = _kernels_run(lambda: sak.seg_act_cuda(h, ids, mask, blk=block),
                          "seg_act_bf16_fwd_kernel")
    inst = f"<{4 if vec else 1}>"
    assert len(ran) == 1 and "seg_act_bf16_fwd_kernel" + inst in ran[0], ran
    dh, ran = _kernels_run(lambda: sak.seg_act_bwd_cuda(h, dy, ids, mask,
                                                        blk=block),
                           "seg_act_bf16_bwd_kernel")
    assert len(ran) == 1 and "seg_act_bf16_bwd_kernel" + inst in ran[0], ran
    assert (sak.launches, sak.bwd_launches, sak.bf16_launches,
            sak.bf16_bwd_launches) == (n0[0], n0[1], n0[2] + 1, n0[3] + 1)
    assert y.dtype == dh.dtype == torch.bfloat16
    wy = sak.seg_act_plain(h, ids, mask, blk=block)
    wdh = sak.seg_act_bwd_plain(h, dy, ids, mask, blk=block)
    print(f"seg_act bf16: {_bf16_ulps(y, wy, 0.0)} / "
          f"{_bf16_ulps(dh, wdh, 0.0)} ulps from the plain version (strict)")
    assert _bf16_ulps(y, wy) <= 1 and _bf16_ulps(dh, wdh) <= 1
    assert torch.equal(y, sak.seg_act_cuda(h, ids, mask, blk=block))
    assert torch.equal(dh, sak.seg_act_bwd_cuda(h, dy, ids, mask, blk=block))


def test_gelu_tail_on_card(dev):
    """The kernels' gelu (``activations.cuh``: x/2 · erfc(−x/√2), JAX's
    form and the plain version's) in its negative tail, through ``seg_act``
    and the fused input layer, against the exact value (the same form in
    f64): within 2e-6 absolute, the bound tests/test_torch_gelu_tail.py
    holds the CPU's gelu to against JAX's, and within 1e-5 relative
    wherever |gelu| > 1e-6, the CPU's relative bound.  The relative errors
    are printed."""
    from repro_torch.kernels import seg_act as sak

    def exact(u):
        u = u.double().cpu()
        return 0.5 * u * torch.special.erfc(-u / np.sqrt(2.0))

    rng = np.random.default_rng(7)
    block, n_blocks, b, f = 8, 64, 32, 100
    hh = block * n_blocks
    gelu = ACTIVATION_ORDER.index("gelu")
    ids = _t(np.full(n_blocks, gelu), dev, torch.int32)
    ones = torch.ones(hh, device=dev)
    h = _t(np.linspace(-10, 10, b * hh).reshape(b, hh), dev)
    x, w, _, _, _ = _fwd_inputs(rng, b, f, block, n_blocks, 0, dev)
    bias = _t(rng.uniform(-9, -3, hh), dev)
    u = torch.addmm(bias.double(), x.double(), w.double().t())
    for what, got, want in (
            ("seg_act", sak.seg_act_cuda(h, ids, ones, blk=block), exact(h)),
            ("fused_input", fik.fused_input_cuda(x, w, bias, ones, ids,
                                                 block=block), exact(u))):
        torch.cuda.synchronize()
        err = (got.double().cpu() - want).abs()
        big, tail = want.abs() > 1e-3, want.abs() > 1e-6
        rel = (err[big] / want.abs()[big]).max().item()
        rel_tail = (err[tail] / want.abs()[tail]).max().item()
        print(f"{what}: gelu max abs err {err.max().item()!r}, max rel err "
              f"where |gelu| > 1e-3 {rel!r}, where |gelu| > 1e-6 "
              f"{rel_tail!r}")
        assert err.max().item() <= 2e-6, what
        assert rel_tail <= 1e-5, what


@pytest.mark.parametrize("widths,block,b,shift", _MID_GRID)
def test_block_diag_fwd_dh_dw_match_plain(dev, widths, block, b, shift):
    """The forward, the dh pass (the same kernel on the transposed tiles
    and steps, pass-through members through the identity tile), each on
    the instance ``fwd_path`` names and bitwise equal launched twice, and
    dWB; dWB twice on the same inputs is bitwise equal (no atomics)."""
    from repro_torch.kernels import block_diag as bdk
    acts = tuple(ACTIVATION_ORDER[i % 10] for i in range(len(widths)))
    lp = LayeredPopulation(5, 3, widths, acts, block=block)
    rng = np.random.default_rng(b)
    word = "block_diag_group_kernel"
    for l in range(lp.depth - 1):
        lay = lp.bd_layout(l)
        x, wb = _mid_x_wb(rng, lay, block, b, shift, dev)
        wb[-1] = torch.eye(block, device=dev)
        sched = flk.schedule_on(lay, dev)
        n0 = bdk.fwd_launches
        y, ran = _kernels_run(
            lambda: bdk.block_diag_fwd_cuda(x, wb, *sched, blk=block), word)
        assert bdk.fwd_launches == n0 + 1
        _group_instance(ran, bdk.fwd_path(x, wb, y), word)
        _close(y, bdk.block_diag_fwd_plain(*_f64(x, wb, *sched), blk=block))
        assert torch.equal(y, bdk.block_diag_fwd_cuda(x, wb, *sched,
                                                      blk=block))
        rowptr_t, s_in_t, s_w_t, perm_t, out_t, in_t = flk.schedule_on(
            lay, dev, transposed=True)
        wb_t = flk.transposed_tiles(wb, perm_t)
        dy = _shifted(rng.normal(0, 1, (b, lay.n_out_tiles * block))
                      .astype(np.float32), shift, dev)
        dh_args = (dy, wb_t, rowptr_t, s_in_t, s_w_t)
        dh, ran = _kernels_run(
            lambda: bdk.block_diag_fwd_cuda(*dh_args, blk=block), word)
        _group_instance(ran, bdk.fwd_path(dy, wb_t, dh), word)
        _close(dh, bdk.block_diag_fwd_plain(*_f64(*dh_args), blk=block))
        assert torch.equal(dh, bdk.block_diag_fwd_cuda(*dh_args, blk=block))
        m0 = bdk.dw_launches
        dwb, ran = _kernels_run(
            lambda: bdk.block_diag_dw_cuda(dy, x, out_t, in_t, blk=block),
            "block_diag_dw_member_kernel")
        assert bdk.dw_launches == m0 + 1
        assert len(ran) == 1 and ("block_diag_dw_member_kernel<%d>" % (
            4 if bdk.dw_path(dy, x, dwb) == "vec4" else 1)) in ran[0], ran
        _close(dwb, bdk.block_diag_dw_plain(*_f64(dy, x, out_t, in_t),
                                            blk=block))
        assert torch.equal(dwb, bdk.block_diag_dw_cuda(dy, x, out_t, in_t,
                                                       blk=block))
        if b > 32:  # the sums of 32-row chunks, added in order, in f32
            chunked = torch.zeros_like(dwb)
            for b0 in range(0, b, 32):
                chunked += bdk.block_diag_dw_plain(
                    dy[b0:b0 + 32], x[b0:b0 + 32], out_t, in_t, blk=block)
            _close(dwb, chunked)
        # the tiles in a shuffled list: no rectangle, every tile alone, each
        # tile's sum the same chain
        perm = torch.from_numpy(rng.permutation(out_t.shape[0])).to(dev)
        dwb_s = bdk.block_diag_dw_cuda(dy, x, out_t[perm].contiguous(),
                                       in_t[perm].contiguous(), blk=block)
        assert torch.equal(dwb_s.view(torch.int32),
                           dwb[perm].view(torch.int32))


def test_unfused_route_on_card_matches_cpu(dev):
    """The unfused route (bd_impl="pallas", act_impl="pallas") on the card:
    its forward's and its step's launches, and both against the same route
    on the CPU (the kernels' plain versions) and the fused route on the
    card."""
    from repro_torch.core import deep
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.launch_count import (kernel_launches,
                                                 unfused_infer_launches,
                                                 unfused_step_launches)
    lp = _serve_layout()
    p_cpu = deep.init_params(torch.Generator().manual_seed(0), lp)
    p_dev = _params_on(p_cpu, dev)
    x = torch.randn(33, 6, generator=torch.Generator().manual_seed(1))
    y = torch.randint(0, 3, (33,), generator=torch.Generator().manual_seed(2))
    unfused = dict(bd_impl="pallas", act_impl="pallas")

    def moved(fn):
        before = kernel_launches()
        out = fn()
        after = kernel_launches()
        return out, {k: after[k] - before[k] for k in after
                     if after[k] != before[k]}

    got, n = moved(lambda: deep.forward(p_dev, x.to(dev), lp, infer=True,
                                        **unfused))
    assert n == unfused_infer_launches(lp.depth)
    _close(got, deep.forward(p_cpu, x, lp, infer=True, **unfused))
    _close(got, deep.forward(p_dev, x.to(dev), lp, bd_impl="fused",
                             infer=True))
    (_, per, grads), n = moved(lambda: deep.loss_and_grads(
        p_dev, x.to(dev), y.to(dev), lp, **unfused))
    assert n == unfused_step_launches(lp.depth)
    for want in (deep.loss_and_grads(p_cpu, x, y, lp, **unfused),
                 deep.loss_and_grads(p_dev, x.to(dev), y.to(dev), lp,
                                     bd_impl="fused")):
        _close(per, want[1])
        for a, b in zip(tree_leaves(grads), tree_leaves(want[2])):
            _close(a, b)


# --------------------------------------------------------------------- #
# M3: the segment-blocked matmul and its two gradients                  #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("sizes,block,o,b,offset", [
    ((3, 9, 1, 20, 5), 1, 2, 7, 0),
    ((3, 9, 1, 20, 5), 8, 5, 33, 0),
    ((17, 40, 2, 8, 30, 16), 16, 2, 9, 0),
    ((100, 1, 57, 128), 128, 2, 32, 0),
    ((5, 12, 7), 8, 20, 11, 0),
    ((5, 12, 7), 8, 3, 6, 1),
    # dh's row blocks: O = 20 past a chunk of columns, a batch that leaves
    # a partial row block, a block that straddles dh's column chunks
    ((300, 129, 57, 700), 128, 20, 37, 0),
    ((300, 129, 57, 700), 128, 2, 29, 0),
    ((90, 37, 260), 12, 16, 13, 0),
])
def test_m3_matmul_kernels_match_plain(dev, sizes, block, o, b, offset):
    """Forward, dh and dW2 against their plain versions: blocks 1 to 128,
    class counts in the small and the 16-wide register instance and
    beyond (O = 20), padded units, the scalar instance (block 1, or an
    unaligned view of h); dh and dW2 twice are bitwise equal."""
    from repro_torch.core.population import Population
    from repro_torch.kernels import m3_matmul as m3k
    pop = Population(4, o, sizes, ("relu",) * len(sizes), block=block)
    rng = np.random.default_rng(b + block + o)
    hh = pop.total_hidden
    store = torch.zeros(b * hh + offset, device=dev)
    h = store[offset:].view(b, hh)
    h.copy_(_t(rng.normal(0, 1, (b, hh)) * pop.hidden_mask, dev))
    w2 = _t(rng.normal(0, 1, (o, hh)), dev)
    dy = _t(rng.normal(0, 1, (b, pop.num_members, o)), dev)
    seg = _t(pop.block_segment_ids, dev, torch.int32)
    ptr = ihk.member_ptr(seg, pop.num_members)
    counts = (m3k.fwd_launches, m3k.dh_launches, m3k.dw_launches)
    y = m3k.m3_matmul_fwd_cuda(h, w2, ptr, block=block)
    dh = m3k.m3_matmul_dh_cuda(dy, w2, seg, block=block)
    dw = m3k.m3_matmul_dw_cuda(dy, h, seg, block=block)
    assert (m3k.fwd_launches, m3k.dh_launches, m3k.dw_launches) == \
        tuple(c + 1 for c in counts)
    _close(y, m3k.m3_matmul_fwd_plain(*_f64(h, w2, ptr), block=block))
    _close(dh, m3k.m3_matmul_dh_plain(dy, w2, seg, block=block))
    _close(dw, m3k.m3_matmul_dw_plain(dy, h, seg, block=block))
    assert torch.equal(dw, m3k.m3_matmul_dw_cuda(dy, h, seg, block=block))
    assert torch.equal(dh, m3k.m3_matmul_dh_cuda(dy, w2, seg, block=block))


def test_m3_matmul_empty_member_and_autograd_on_card(dev):
    """A member that owns no block gets y = 0; ``ops.m3_matmul`` on the
    card launches one forward and, backward, dh then dW2, and matches the
    same call on the CPU; it rejects what the kernels do not take."""
    from repro_torch.kernels import m3_matmul as m3k
    h = torch.randn(5, 24, device=dev)
    w2 = torch.randn(3, 24, device=dev)
    ptr = torch.tensor([0, 1, 1, 3], dtype=torch.int32, device=dev)
    y = m3k.m3_matmul_fwd_cuda(h, w2, ptr, block=8)
    assert torch.all(y[:, 1] == 0)
    _close(y, m3k.m3_matmul_fwd_plain(h, w2, ptr, block=8))
    seg = np.array([0, 0, 1, 2, 2], np.int32)
    hc = torch.randn(6, 40).requires_grad_(True)
    wc = torch.randn(2, 40).requires_grad_(True)
    dy = torch.randn(6, 3, 2)
    hd = hc.detach().to(dev).requires_grad_(True)
    wd = wc.detach().to(dev).requires_grad_(True)
    counts = (m3k.fwd_launches, m3k.dh_launches, m3k.dw_launches)
    yd = ops.m3_matmul(hd, wd, seg, 3, block_h=8)
    gd = torch.autograd.grad(yd, (hd, wd), dy.to(dev))
    assert (m3k.fwd_launches, m3k.dh_launches, m3k.dw_launches) == \
        tuple(c + 1 for c in counts)
    yc = ops.m3_matmul(hc, wc, seg, 3, block_h=8)
    gc = torch.autograd.grad(yc, (hc, wc), dy)
    _close(yd.detach(), yc.detach())
    for a, b in zip(gd, gc):
        _close(a, b)
    with pytest.raises(ValueError):
        m3k.m3_matmul_fwd_cuda(h, w2, ptr.long(), block=8)
    with pytest.raises(ValueError):
        m3k.m3_matmul_dh_cuda(torch.randn(5, 3, 3, device=dev), w2,
                              torch.zeros(3, dtype=torch.int32, device=dev),
                              block=129)


@pytest.mark.parametrize("o", [2, 5, 16, 20])
@pytest.mark.parametrize("sizes,block,b,offset", [
    ((16, 5, 7) * 30, 8, 32, 0),       # path 4e's head widths: 8 lanes
    ((100, 1, 57, 128) * 5, 128, 32, 0),   # the paper's members
    ((128, 5), 8, 9, 0),               # H 136: one 128-unit tile and 8 more
    ((128,) * 2112 + (8,), 8, 5, 0),   # H 270,344: 264 tiles of 1,024 (one
    # lane) and 8 units more
    ((5, 12, 7), 8, 11, 1),            # h an unaligned view: scalar
])
def test_m3_matmul_matches_the_heads(dev, sizes, block, o, b, offset):
    """The M3 forward runs the heads' streaming core and dW the loss head's
    backward role: y is ``infer_head``'s logits with a zero bias and dW
    ``loss_head_bwd``'s dW with d_per = 1, bit for bit, wherever both take
    the same instance (``kernel_path``); beyond 16 classes y chunk by chunk
    of 16 classes against ``infer_head`` on the chunk's rows of w2 (the
    sums do not depend on the class tile), dW's first chunk against the
    loss head's (the same class tile), and both against the plain
    versions.  Each wrapper launches its kernel once, under its own name
    and instance; two launches on the same inputs are bitwise equal."""
    from repro_torch.core.population import Population
    from repro_torch.kernels import m3_matmul as m3k
    pop = Population(4, o, sizes, ("relu",) * len(sizes), block=block)
    rng = np.random.default_rng(b + block + o)
    hh, p = pop.total_hidden, pop.num_members
    store = torch.zeros(b * hh + offset, device=dev)
    h = store[offset:].view(b, hh)
    h.copy_(_t(rng.normal(0, 1, (b, hh)) * pop.hidden_mask, dev))
    w2 = _t(rng.normal(0, 1, (o, hh)), dev)
    dy = _t(rng.normal(0, 1, (b, p, o)), dev)
    seg = _t(pop.block_segment_ids, dev, torch.int32)
    ptr = ihk.member_ptr(seg, p)
    counts = (m3k.fwd_launches, m3k.dw_launches)
    y, fwd_names = _kernels_run(
        lambda: m3k.m3_matmul_fwd_cuda(h, w2, ptr, block=block),
        "m3_fwd_stream_kernel")
    dw, dw_names = _kernels_run(
        lambda: m3k.m3_matmul_dw_cuda(dy, h, seg, block=block),
        "m3_dw_stream_kernel")
    assert (m3k.fwd_launches, m3k.dw_launches) == \
        tuple(c + 1 for c in counts)
    fwd_path = m3k.kernel_path(block, h, w2)
    assert len(fwd_names) == 1 and fwd_path in fwd_names[0]
    assert len(dw_names) == 1 \
        and m3k.kernel_path(block, h, dw) in dw_names[0]
    _close(y, m3k.m3_matmul_fwd_plain(*_f64(h, w2, ptr), block=block))
    _close(dw, m3k.m3_matmul_dw_plain(dy, h, seg, block=block))
    assert torch.equal(y, m3k.m3_matmul_fwd_cuda(h, w2, ptr, block=block))
    assert torch.equal(dw, m3k.m3_matmul_dw_cuda(dy, h, seg, block=block))
    for o0 in range(0, o, ihk.MAX_O):
        oc = min(ihk.MAX_O, o - o0)
        wc = w2[o0:o0 + oc]
        assert ihk.kernel_path(block, h, wc) == fwd_path
        assert torch.equal(y[..., o0:o0 + oc], ihk.infer_head_cuda(
            h, wc, torch.zeros(p, oc, device=dev), ptr, block=block))
    oc = min(ihk.MAX_O, o)
    dyc = dy[..., :oc].contiguous()
    dh_l, dw_l = lhk.loss_head_bwd_cuda(torch.ones(p, device=dev), dyc, h,
                                        w2[:oc], seg, block=block)
    if lhk.kernel_path(block, h, w2[:oc], dh_l, dw_l) == \
            m3k.kernel_path(block, h, dw):
        assert torch.equal(dw[:oc], dw_l)


def test_m3_matmul_refuses_a_hidden_axis_past_int32(dev, monkeypatch):
    """The forward and dW index H as a 32-bit int: their C entries return
    cudaErrorInvalidValue for H = 2**31 before they touch a pointer, and
    the wrappers refuse a wider H themselves (here the limit lowered to 8
    units)."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels import m3_matmul as m3k
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for entry in ("m3_fwd_f32", "m3_dw_f32"):
        fn = _build.function("m3_matmul", entry, [P] * 4 + [I, L, I, I, I, P])
        assert fn(None, None, None, None, 4, 2**31, 2, 1, 8, None) == 1
    monkeypatch.setattr(m3k, "MAX_HIDDEN", 8)
    h = torch.randn(3, 16, device=dev)
    seg = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="past"):
        m3k.m3_matmul_fwd_cuda(h, torch.randn(2, 16, device=dev),
                               ihk.member_ptr(seg, 2), block=8)
    with pytest.raises(ValueError, match="past"):
        m3k.m3_matmul_dw_cuda(torch.randn(3, 2, 2, device=dev), h, seg,
                              block=8)


# flash attention and the grouped GEMM take f32 or bf16: f32 at the file's
# tolerance; bf16 attention per element: the kernel rounds each p to bf16
# (unit roundoff 2^-8) before the PV product, which moves an output by at
# most 2^-8 times the attention of |v|, and each side rounds o to bf16 once
# (rtol 1e-2); the grouped GEMM at 1e-2 (both round the same f32 sums to
# bf16 once; a sum order apart, a value may round to the neighbouring bf16)
_FLASH_BF16_RTOL = 1e-2
_MOE_BF16_TOL = 1e-2
_FLASH_GRID = [
    (2, 4, 2, 64, 64, 16, True, 0),       # GQA causal
    (1, 2, 2, 48, 80, 8, True, 0),         # Sq != Sk
    (2, 4, 1, 64, 64, 16, True, 24),       # MQA + sliding window
    (1, 3, 3, 33, 65, 16, False, 0),       # non-causal, ragged
    (1, 8, 2, 128, 128, 32, True, 0),      # wider heads
    (1, 4, 2, 200, 150, 120, True, 40),    # dh 120 (h2o-danube-3-4b)
    (1, 2, 1, 40, 20, 8, True, 4),         # fully masked rows 23-39
    (1, 2, 1, 40, 20, 8, False, 4),
    (1, 2, 2, 130, 300, 128, False, 0),    # dh 128, several k tiles
    # the tensor-core kernel's 128-row q tiles and 64-column k tiles
    (1, 8, 2, 129, 129, 64, True, 0),      # one row past a q tile, GQA 4
    (1, 4, 1, 257, 190, 128, True, 0),     # Sq != Sk across both tilings
    (2, 4, 1, 257, 300, 120, False, 100),  # dh 120, a window, not causal
    (1, 4, 4, 300, 130, 64, True, 50),     # rows 179-299 fully masked
    (1, 8, 2, 129, 257, 128, False, 0),    # dh 128 (two boxes), GQA 4
    # the f32 kernel's 128-row q tiles and 64-column k tiles, at each of
    # its instances (fma_width: 64 for dh 8-64, 128 for dh 72-128; 192
    # for dh 136-192 below, on 64-row q and 32-column k tiles)
    (1, 2, 1, 127, 127, 8, True, 0),       # Sq one short of a q tile
    (1, 2, 1, 127, 127, 128, False, 0),    # the same, DP 128
    (1, 4, 2, 128, 200, 64, True, 0),      # Sq one q tile, Sk > Sq
    (1, 4, 2, 129, 129, 72, True, 0),      # one row past it; dh 72
    (1, 2, 2, 128, 65, 120, False, 0),     # Sk one past a k tile
    (1, 2, 1, 129, 65, 16, True, 0),       # the same, causal, DP 64
    (1, 4, 1, 256, 256, 128, True, 40),    # window edges inside tiles
    (1, 2, 1, 300, 190, 56, False, 90),    # the same, not causal, DP 64
    (1, 2, 1, 256, 100, 72, False, 50),    # q tile 1: rows 148+ fully
    (1, 2, 1, 256, 100, 32, True, 50),     # masked beside real rows
    (2, 4, 2, 384, 384, 120, True, 0),     # dh 120, three q tiles
    # the DP 192 instances (f32: 64-row q tiles, 32-column k tiles; bf16:
    # three 64-column boxes, m64n192 PV)
    (1, 4, 1, 129, 129, 192, True, 0),     # GQA 4, one row past a q tile
    (1, 2, 1, 65, 97, 136, False, 0),      # dh 136 padded to 192
    (2, 6, 2, 200, 200, 192, True, 40),    # a window inside the tiles
    (1, 2, 2, 100, 40, 184, True, 30),     # rows 69-99 fully masked
]


def _close_tol(got, want, tol):
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,sq,sk,dh,causal,window", _FLASH_GRID)
def test_flash_attention_matches_dense(dev, dtype, b, h, hkv, sq, sk, dh,
                                       causal, window):
    from repro_torch.kernels import flash_attn as fak
    rng = np.random.default_rng(sq * sk + dh)
    q = _t(rng.normal(0, 1, (b, h, sq, dh)), dev).to(dtype)
    k = _t(rng.normal(0, 1, (b, hkv, sk, dh)), dev).to(dtype)
    v = _t(rng.normal(0, 1, (b, hkv, sk, dh)), dev).to(dtype)
    scale = dh ** -0.5
    n0 = fak.launches
    got = ops.flash_attention(q, k, v, scale, causal, window)
    assert fak.launches == n0 + 1 and got.dtype == dtype
    want = fak.flash_attn_dense(q, k, v, scale=scale, causal=causal,
                                window=window)
    if dtype == torch.float32:
        _close(got, want)
        return
    kw = dict(scale=scale, causal=causal, window=window)
    atol = fak.flash_attn_dense(q.float(), k.float(), v.float().abs(), **kw)
    err = (got.float() - want.float()).abs()
    allowed = atol * 2.0 ** -8 + ATOL + _FLASH_BF16_RTOL * want.float().abs()
    assert bool((err <= allowed).all()), \
        f"max |err| {err.max().item()}, {(err / allowed).max().item()} of " \
        "the per-element tolerance"


@pytest.mark.parametrize("b,h,hkv,sq,sk,dh,causal,window", [
    (1, 4, 2, 300, 300, 128, True, 0), (1, 4, 1, 200, 150, 120, True, 40),
    (1, 2, 1, 256, 100, 72, False, 50), (1, 4, 2, 129, 65, 64, True, 0),
    (1, 2, 1, 70, 90, 8, False, 0), (1, 4, 1, 129, 129, 192, True, 0),
    (1, 2, 1, 100, 70, 136, False, 20)])
def test_flash_attention_f32_is_reproducible(dev, b, h, hkv, sq, sk, dh,
                                             causal, window):
    """Two f32 launches on the same inputs are bitwise equal (each output
    has one owner and one order of sums), on the instance ``fma_width``
    names, as ``torch.profiler`` saw it run."""
    from repro_torch.kernels import flash_attn as fak
    rng = np.random.default_rng(sq + dh)
    q = _t(rng.normal(0, 1, (b, h, sq, dh)), dev)
    k = _t(rng.normal(0, 1, (b, hkv, sk, dh)), dev)
    v = _t(rng.normal(0, 1, (b, hkv, sk, dh)), dev)
    kw = dict(scale=dh ** -0.5, causal=causal, window=window)
    first, ran = _kernels_run(
        lambda: fak.flash_attention_cuda(q, k, v, **kw), "flash_attn")
    assert len(ran) == 1 and \
        f"flash_attn_fwd_kernel<{fak.fma_width(dh)}>" in ran[0], ran
    assert torch.equal(first, fak.flash_attention_cuda(q, k, v, **kw))
    _close(first, fak.flash_attn_dense(q, k, v, **kw))


@pytest.mark.parametrize("model_layout", [False, True])
def test_flash_attention_gradients_on_card(dev, model_layout):
    """One launch forward, none backward; the gradients are autograd of the
    dense version, on the card as on the CPU.  ``model_layout``: the leaves
    are (B, S, heads, dh) and attend as transposed (B, heads, S, dh)
    views."""
    from repro_torch.kernels import flash_attn as fak
    rng = np.random.default_rng(5)
    arrs = [rng.normal(0, 1, s) for s in ((2, 4, 48, 16), (2, 2, 56, 16),
                                          (2, 2, 56, 16))]
    if model_layout:
        arrs = [a.transpose(0, 2, 1, 3) for a in arrs]

    def attend(leaves):
        if model_layout:
            leaves = [t.transpose(1, 2) for t in leaves]
        o = ops.flash_attention(*leaves, 0.25, True, 9)
        (o ** 2).sum().backward()
        return o.detach()

    dev_in = [_t(a, dev).requires_grad_() for a in arrs]
    cpu_in = [_t(a, "cpu").requires_grad_() for a in arrs]
    n0 = fak.launches
    o = attend(dev_in)
    assert fak.launches == n0 + 1
    _close(o, attend(cpu_in))
    for a, c in zip(dev_in, cpu_in):
        _close(a.grad, c.grad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,d,f,block_t,runs,shift", [
    (2, 16, 24, 8, (1, 3), 0), (4, 32, 16, 8, (2, 1, 1, 3), 0),
    (1, 8, 8, 8, (2,), 0), (3, 40, 1408, 64, (1, 0, 2), 0),
    (4, 136, 72, 128, (0, 2, 1, 0), 0),
    # the tensor-core path's edges: D and F no multiples of its 64 / 128
    # tiles, block_t 64 beside 128 and 192, empty experts, full widths
    (3, 40, 24, 64, (2, 0, 1), 0), (2, 136, 72, 64, (1, 3), 0),
    (3, 136, 24, 128, (1, 0, 2), 0), (2, 64, 200, 192, (1, 1), 0),
    (2, 2048, 1408, 128, (2, 1), 0),
    # the SIMT GEMM's scalar instance: D or F no multiple of 4, or x off a
    # 16-byte boundary; its vec4 instance in bf16 (D, F no multiples of 8)
    (3, 37, 101, 64, (1, 0, 2), 0), (2, 37, 101, 128, (2, 1), 0),
    (2, 37, 101, 192, (1, 1), 0), (2, 2048, 101, 128, (1, 1), 0),
    (2, 37, 1408, 192, (1, 2), 0), (2, 36, 100, 128, (1, 2), 1),
    (2, 36, 100, 64, (2, 1), 0)])
def test_moe_gemm_matches_dense(dev, dtype, e, d, f, block_t, runs, shift):
    """Each launch against the dense version, on the kernel its design and
    (on the FMA path) its instance name: ``*wgmma_kernel``,
    ``moe_gemm_simt_kernel<T, rows, vec4>`` or the 8-row
    ``moe_gemm_kernel``, as ``torch.profiler`` saw it run."""
    from repro_torch.kernels import grouped_gemm as moek
    rng = np.random.default_rng(d * f)
    eids = np.repeat(np.arange(e, dtype=np.int32), runs)
    t = int(eids.size) * block_t
    # x's storage starts `shift` elements past a (256-byte aligned) one
    x = torch.empty(t * d + shift, device=dev, dtype=dtype)[shift:]
    x = x.view(t, d)
    x.copy_(_t(rng.normal(0, 1, (t, d)), dev))
    w = _t(rng.normal(0, 1, (e, d, f)), dev).to(dtype)
    n0 = moek.launches
    got, ran = _kernels_run(lambda: ops.moe_gemm(x, w, eids, block_t=block_t),
                            "moe_gemm")
    assert moek.launches == n0 + 1 and got.dtype == dtype
    assert len(ran) == 1, ran
    if moek.kernel_path(dtype, d, f, block_t) == "wgmma":
        assert "moe_gemm_wgmma_kernel" in ran[0], ran
    else:
        rows, loads = moek.fma_instance(d, f, block_t, x, w, got)
        assert loads == ("vec4" if d % 4 == 0 and f % 4 == 0 and not shift
                         and rows != 8 else "scalar")
        c_type = "float" if dtype == torch.float32 else "__nv_bfloat16"
        kernel = "moe_gemm_kernel" if rows == 8 else (
            f"moe_gemm_simt_kernel<{c_type}, {rows}, "
            f"{'true' if loads == 'vec4' else 'false'}>")
        assert kernel in ran[0], ran
    want = moek.moe_gemm_dense(x, w, _t(eids, dev, torch.int32),
                               block_t=block_t)
    if dtype == torch.float32:
        _close(got, want)
    else:
        _close_tol(got, want, _MOE_BF16_TOL)
    with pytest.raises(ValueError):
        ops.moe_gemm(x[:-1], w, eids, block_t=block_t)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block_t", [8, 64, 128, 192])
def test_moe_gemm_expert_id_past_e_gives_nan_rows(dev, dtype, block_t):
    """An expert id equal to E: that run's rows come out NaN (nothing is
    read out of bounds), the other runs as the dense version."""
    from repro_torch.kernels import grouped_gemm as moek
    rng = np.random.default_rng(block_t)
    e, d, f = 3, 72, 136
    eids = np.array([0, e, 2, 1], np.int32)
    x = _t(rng.normal(0, 1, (eids.size * block_t, d)), dev).to(dtype)
    w = _t(rng.normal(0, 1, (e, d, f)), dev).to(dtype)
    tensor_cores = dtype == torch.bfloat16 and block_t % 64 == 0
    assert moek.kernel_path(dtype, d, f, block_t) == \
        ("wgmma" if tensor_cores else "fma")
    got = ops.moe_gemm(x, w, eids, block_t=block_t)
    torch.cuda.synchronize()
    runs = got.view(eids.size, block_t, f)
    assert bool(torch.isnan(runs[1]).all())
    keep = [0, 2, 3]
    want = moek.moe_gemm_dense(
        x.view(eids.size, block_t, d)[keep].reshape(-1, d), w,
        _t(eids[keep], dev, torch.int32), block_t=block_t)
    if dtype == torch.float32:
        _close(runs[keep].reshape(-1, f), want)
    else:
        _close_tol(runs[keep].reshape(-1, f), want, _MOE_BF16_TOL)


def test_bf16_kernels_run_on_the_tensor_cores(dev):
    """The built libraries' bf16 kernels hold HGMMA (wgmma) in their SASS,
    and the FMA kernels none: a build without the tensor-core instructions
    fails here, not only in its speed."""
    import os
    import shutil
    import subprocess

    from torch.utils.cpp_extension import CUDA_HOME

    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or os.path.join(CUDA_HOME or "",
                                                     "bin", "cuobjdump")
    assert os.path.exists(tool), "cuobjdump not found (PATH / CUDA_HOME)"
    paths = _build.build_all()
    for lib in ("moe_gemm", "flash_attn"):
        sass = subprocess.run([tool, "-sass", str(paths[lib])], check=True,
                              capture_output=True, text=True).stdout
        funcs = {f.split()[0]: f for f in sass.split("Function : ")[1:]}
        tc = [name for name in funcs if "wgmma" in name]
        assert tc, f"{lib}: no tensor-core kernel among {sorted(funcs)}"
        for name, body in funcs.items():
            assert ("HGMMA" in body) == (name in tc), \
                f"{lib}: {name} {'lacks' if name in tc else 'has'} HGMMA"


# --------------------------------------------------------------------- #
# the bf16 compute policy's instances                                   #
# --------------------------------------------------------------------- #
#
# bf16 operands on the card against the plain versions on the card, on
# the same bf16 inputs: both widen them (exact), sum in f32 in different
# orders and round each bf16 output once, so an output may land on the
# neighbouring bf16 value and no further — at most 1 bf16 ulp apart,
# element by element (``_bf16_ulps``) — except where the two f32 sums
# themselves differ by more than half a bf16 step: a sum over hundreds of
# products (B = 300) that cancels to near 0, where the two orders differ
# by up to the f32 tests' atol (1e-5); such elements are held to that
# atol instead.  f32 outputs (the heads' logits, per and dl) keep the f32
# tolerance.  du = dy·g' and dl·d_per are rounded to bf16 on both sides
# the same way (a product of two bf16 values rounded once), so they add
# no difference of their own.
#
# The carve-out has a third reference (``_f64_check``): at each element
# where the kernel is more than 1 bf16 ulp from the plain version but
# within the atol of it, the kernel is within 1 bf16 ulp of the f64 sum
# of the same bf16 products rounded once to bf16 — or, where that sum
# cancels so far that an f32 sum of its terms in any order may stray
# further (the distance is printed), within the worst-case error of an
# f32 sum of those n terms, (n − 1)·2^-24·Σ|terms| (twice that through an
# activation: no activation's slope passes 2), plus its own rounding to
# bf16, of the exact sum.  So the carve-out is the order of an f32 sum,
# not a wrong sum.

def _ulp_key(t: torch.Tensor) -> torch.Tensor:
    """bf16 values → integers in the order of the values, one apart for
    neighbouring bf16 numbers (±0 both 0)."""
    v = t.contiguous().view(torch.int16).int()
    return torch.where(v < 0, -(v + 32768), v)


def _f64_to_bf16(v: torch.Tensor) -> torch.Tensor:
    """f64 values rounded once to bf16, to nearest even.  A cast through
    f32 rounds twice: where the f32 lands on a bf16 midpoint from an f64
    off it, it is first moved one f32 step back toward the f64."""
    f = v.float()
    off = ((f.view(torch.int32) & 0xFFFF) == 0x8000) & (f.double() != v)
    toward = torch.where(v > f.double(), torch.full_like(f, np.inf),
                         torch.full_like(f, -np.inf))
    return torch.where(off, torch.nextafter(f, toward), f).to(torch.bfloat16)


def _sum_bound(lin, a, b, scale: float = 1.0):
    """The f64 sums ``lin(a, b)`` of the products of two bf16 (or f32)
    operands, widened, and the worst-case error of an f32 sum of the same
    products in any order, ``scale``·(n − 1)·2^-24·Σ|products| per output
    (n the terms of each: ``lin`` on ones)."""
    a, b = a.double(), b.double()
    n = lin(torch.ones_like(a), torch.ones_like(b))
    mag = lin(a.abs(), b.abs())
    return lin(a, b), scale * (n - 1).clamp(min=0) * 2.0 ** -24 * mag


def _f64_check(got, plain, exact, bound) -> int:
    """The third reference (see above) at the carve-out of
    ``_bf16_ulps(got, plain)``: asserts it, returns the kernel's largest
    distance there from ``exact`` rounded once, in bf16 ulps."""
    torch.cuda.synchronize()
    exact = exact.to(got.device)
    excused = ((_ulp_key(got) - _ulp_key(plain)).abs() > 1) \
        & ((got.float() - plain.float()).abs() <= ATOL)
    d = (_ulp_key(got) - _ulp_key(_f64_to_bf16(exact))).abs()
    err = (got.double() - exact).abs()
    wrong = excused & (d > 1) \
        & (err > bound.to(got.device) + 2.0 ** -8 * got.double().abs())
    assert not wrong.any(), (got[wrong][:8], exact[wrong][:8])
    return int(d[excused].max().item()) if excused.any() else 0

def _bf16_ulps(a: torch.Tensor, b: torch.Tensor, atol: float = ATOL) -> int:
    """The largest distance between two bf16 tensors in bf16 ulps (steps
    of the bf16 grid; +0 and -0 the same point), over the elements more
    than ``atol`` apart."""
    assert a.dtype == b.dtype == torch.bfloat16 and a.shape == b.shape
    torch.cuda.synchronize()
    far = (a.float() - b.float()).abs() > atol
    return int((_ulp_key(a) - _ulp_key(b)).abs()[far].max().item()) \
        if far.any() else 0


def _act_bound(lin, a, b, bias, exact):
    """The worst-case error of an output of an activation of an f32 sum
    of the products ``lin`` sums plus a bias: the sum's (n terms and the
    bias), through a slope of at most 2, and the activation's own f32
    evaluation (16 f32 ulps of the output)."""
    a, b = a.double(), b.double()
    n = lin(torch.ones_like(a), torch.ones_like(b))
    mag = lin(a.abs(), b.abs()) + bias.double().abs()
    return 2 * n * 2.0 ** -24 * mag + 16 * 2.0 ** -24 * exact.abs()


def _bf16(a, dev, shift: int = 0):
    """``a`` as a bf16 tensor on the card (``_shifted``)."""
    return _shifted(np.asarray(a, np.float32), shift, dev, torch.bfloat16)


@pytest.mark.parametrize("b,f,block,n_blocks,shift", [
    (32, 100, 128, 12, 0),    # parallelmlp-10k's rows: 200 bytes, vec4
    (32, 100, 8, 13, 0),      # block 8, H 104
    (300, 100, 128, 2, 0),    # B > 32: ten batch tiles
    (3, 100, 8, 9, 0),        # B < 32
    (5, 101, 8, 9, 0),        # F % 4 != 0: scalar
    (32, 100, 8, 13, 1),      # x 2 bytes off an 8-byte boundary: scalar
    (33, 1030, 8, 5, 0),      # F over many stages, x not resident
])
def test_bf16_fused_input_matches_plain(dev, b, f, block, n_blocks, shift):
    """The bf16 instance (y; y and g'): ≤ 1 bf16 ulp from the plain
    version, on the instance ``fwd_path`` names, counted in
    ``bf16_launches``; two launches bitwise equal."""
    rng = np.random.default_rng(b + f)
    x32, w32, bias, mask, ids = _fwd_inputs(rng, b, f, block, n_blocks, 0,
                                            dev)
    x = _bf16(x32.cpu().numpy(), dev, shift)
    w = w32.to(torch.bfloat16)
    n0, m0 = fik.bf16_launches, fik.launches
    got, ran = _kernels_run(lambda: fik.fused_input_cuda(
        x, w, bias, mask, ids, block=block), "fused_input_kernel")
    assert (fik.bf16_launches, fik.launches) == (n0 + 1, m0)
    assert got.dtype == torch.bfloat16
    path = fik.fwd_path(x, w, got)
    assert path == ("vec4" if f % 4 == 0 and shift % 4 == 0 else "scalar")
    assert len(ran) == 1 and ("fused_input_kernel<%d, __nv_bfloat16"
                              % (4 if path == "vec4" else 1)) in ran[0], ran
    assert _bf16_ulps(got, fik.fused_input_plain(
        x, w, bias, mask, ids, block=block)) <= 1
    assert torch.equal(got, fik.fused_input_cuda(x, w, bias, mask, ids,
                                                 block=block))
    y, g = fik.fused_input_train_cuda(x, w, bias, mask, ids, block=block)
    wy, wg = fik.fused_input_train_plain(x, w, bias, mask, ids, block=block)
    assert torch.equal(y, got)
    assert _bf16_ulps(g, wg) <= 1 and _bf16_ulps(y, wy) <= 1
    ey, eg = fik.fused_input_train_plain(x.double(), w.double(), bias, mask,
                                         ids, block=block)
    for out, want, exact in ((y, wy, ey), (g, wg, eg)):
        _f64_check(out, want, exact, _act_bound(
            lambda a, b: a @ b.t(), x, w, bias, exact))


@pytest.mark.parametrize("with_dx", [False, True])
@pytest.mark.parametrize("b,f,h,shift", [
    (32, 100, 8192, 0),     # parallelmlp-10k's F, one batch chunk
    (300, 100, 1000, 0),    # ten chunks: dW summed in the f32 scratch
    (32, 102, 4100, 0),     # F % 4 != 0: scalar
    (32, 100, 8192, 1),     # dy 2 bytes off: scalar
    (33, 1030, 260, 0),     # two feature groups a thread
])
def test_bf16_fused_input_bwd_matches_plain(dev, with_dx, b, f, h, shift):
    """dW (and dx) of the bf16 instance: ≤ 1 bf16 ulp from the plain
    version (du rounded to bf16 on both sides), on the instance
    ``bwd_path`` names; two launches bitwise equal."""
    rng = np.random.default_rng(h + b)
    dy = _bf16(rng.normal(0, 1, (b, h)), dev, shift)
    g = _bf16(rng.random((b, h)) * (rng.random(h) > 0.2), dev)
    x = _bf16(rng.normal(0, 1, (b, f)), dev)
    w = _bf16(rng.normal(0, 1, (h, f)) / np.sqrt(f), dev)
    path = fik.bwd_path(dy, g, x, torch.empty(4, device=dev,
                                              dtype=torch.bfloat16))
    assert path == ("vec4" if f % 4 == 0 and h % 4 == 0 and shift % 4 == 0
                    else "scalar")
    n0 = fik.bf16_bwd_launches
    (dx, dw), ran = _kernels_run(lambda: fik.fused_input_bwd_cuda(
        dy, g, x, w, with_dx=with_dx), "fused_input_bwd")
    assert fik.bf16_bwd_launches == n0 + 1
    assert len(ran) == 1 and ("fused_input_bwd_bf16_kernel<%d>"
                              % (4 if path == "vec4" else 1)) in ran[0], ran
    wdx, wdw = fik.fused_input_bwd_plain(dy, g, x, w, with_dx=with_dx)
    assert dw.dtype == torch.bfloat16 and _bf16_ulps(dw, wdw) <= 1
    again = fik.fused_input_bwd_cuda(dy, g, x, w, with_dx=with_dx)
    assert torch.equal(dw, again[1])
    du = dy * g   # rounded to bf16 once, as the kernel forms it
    _f64_check(dw, wdw, *_sum_bound(lambda a, b: a.t() @ b, du, x))
    if with_dx:
        assert _bf16_ulps(dx, wdx) <= 1 and torch.equal(dx, again[0])
        _f64_check(dx, wdx, *_sum_bound(lambda a, b: a @ b, du, w))


@pytest.mark.parametrize("widths,block,b,shift", [
    (((24,), (13, 5), (17, 9), (32, 16, 8)), 8, 11, 0),
    (((64, 32, 16), (13, 5), (7,)) * 4, 8, 32, 0),   # the depth-3 members
    (((40, 20), (17, 33, 9), (7,)), 16, 70, 0),
    (((200, 130), (64, 100), (7,)), 128, 33, 0),
    (((512, 384), (13, 5), (7,)), 8, 300, 0),         # dWB over 10 chunks
    (((40, 20), (17, 33, 9), (7,)), 5, 33, 0),        # block 5: scalar
    (((64, 32, 16), (13, 5), (7,)) * 4, 8, 32, 1),   # 2 bytes off: scalar
])
def test_bf16_fused_layer_train_and_dx_dw_match_plain(dev, widths, block, b,
                                                      shift):
    """The bf16 instances of the mid layer: y and g' (and y of the serving
    launch, bitwise the training one's), then dx and dWB, each ≤ 1 bf16
    ulp from the plain version, on the instance ``block_diag.fwd_path``
    names; two launches bitwise equal."""
    from repro_torch.kernels import block_diag as bdk
    acts = tuple(ACTIVATION_ORDER[i % 10] for i in range(len(widths)))
    lp = LayeredPopulation(5, 3, widths, acts, block=block)
    rng = np.random.default_rng(b + block)
    for l in range(lp.depth - 1):
        lay = lp.bd_layout(l)
        pout = lp.layer_pop(l + 1)
        x = _bf16(rng.normal(0, 1, (b, lay.n_in_tiles * block)), dev, shift)
        wbn = rng.normal(0, 1, (lay.n_param_blocks + 1, block, block)) \
            / np.sqrt(block)
        wbn[-1] = np.eye(block)
        wb = _bf16(wbn, dev, shift)
        b_eff = _t(rng.normal(0, 1, lay.n_out_tiles * block), dev)
        mask = _t(pout.hidden_mask, dev)
        acts_t = _t(pout.block_act_ids, dev, torch.int32)
        fargs = (x, wb, b_eff, mask, acts_t, *flk.schedule_on(lay, dev))
        n0 = flk.bf16_launches
        (y, g), ran = _kernels_run(
            lambda: flk.fused_layer_train_cuda(*fargs, blk=block),
            "fused_layer_bf16_group_kernel")
        assert flk.bf16_launches == n0 + 1
        path = bdk.fwd_path(x, wb, y, g)
        assert path == ("vec4" if block % 4 == 0 and shift % 4 == 0
                        else "scalar")
        _group_instance(ran, path, "fused_layer_bf16_group_kernel")
        wy, wg = flk.fused_layer_train_plain(*fargs, blk=block)
        assert _bf16_ulps(y, wy) <= 1 and _bf16_ulps(g, wg) <= 1
        sched = fargs[5:]
        ey, eg = flk.fused_layer_train_plain(x.double(), wb.double(),
                                             *fargs[2:], blk=block)
        for out, want, exact in ((y, wy, ey), (g, wg, eg)):
            _f64_check(out, want, exact, _act_bound(
                lambda a, c: bdk.block_diag_fwd_plain(a, c, *sched,
                                                      blk=block),
                x, wb, b_eff, exact))
        again = flk.fused_layer_train_cuda(*fargs, blk=block)
        assert torch.equal(y, again[0]) and torch.equal(g, again[1])
        assert torch.equal(y, flk.fused_layer_cuda(*fargs, blk=block))
        dy = _bf16(rng.normal(0, 1, (b, lay.n_out_tiles * block)), dev)
        args = (dy, g, x, wb[:-1], *flk.dx_dw_schedule_on(lay, dev))
        n0 = flk.bf16_dx_dw_launches
        (dx, dwb), ran = _kernels_run(
            lambda: flk.fused_layer_dx_dw_cuda(*args, blk=block),
            "fused_layer_dx_dw")
        assert flk.bf16_dx_dw_launches == n0 + 1
        assert len(ran) == 1 and "fused_layer_dx_dw_bf16_kernel" in ran[0]
        wdx, wdwb = flk.fused_layer_dx_dw_plain(*args, blk=block)
        assert _bf16_ulps(dx, wdx) <= 1 and _bf16_ulps(dwb, wdwb) <= 1
        du, units = dy * g, args[4:]   # du rounded to bf16 once, as here
        one = torch.ones_like(du, dtype=torch.float64)
        _f64_check(dx, wdx, *_sum_bound(
            lambda a, c: flk.fused_layer_dx_dw_plain(
                a, one, x.double(), c, *units, blk=block)[0], du, wb[:-1]))
        _f64_check(dwb, wdwb, *_sum_bound(
            lambda a, c: flk.fused_layer_dx_dw_plain(
                a, one, c, wb[:-1].double(), *units, blk=block)[1], du, x))
        again = flk.fused_layer_dx_dw_cuda(*args, blk=block)
        assert torch.equal(dx, again[0]) and torch.equal(dwb, again[1])


@pytest.mark.parametrize("widths,block,o,b,shift", [
    ((128,) * 40, 128, 2, 32, 0),           # parallelmlp-10k's members
    (_NARROW, 8, 2, 32, 0),                 # the depth-3 head's
    ((40, 5000, 16, 24), 8, 2, 257, 0),     # a member over several tiles
    ((7, 13, 30, 2, 64, 9), 6, 2, 32, 0),   # a block not a multiple of 4
    (_NARROW[:80], 8, 2, 32, 1),            # h 2 bytes off: scalar
])
def test_bf16_heads_match_plain(dev, widths, block, o, b, shift):
    """The heads' bf16 instances: infer_head's logits and log-probs and
    the loss head's per and dl (f32, within the f32 tolerance of the plain
    version on the same bf16 operands), the loss head's dh and dW (bf16,
    ≤ 1 ulp); each on the design ``kernel_path`` names, two launches
    bitwise equal."""
    rng = np.random.default_rng(len(widths) + o + 1)
    blocks = [-(-w // block) for w in widths]
    seg = _t(np.repeat(np.arange(len(widths)), blocks), dev, torch.int32)
    hh = int(sum(blocks)) * block
    h = _bf16(rng.normal(0, 1, (b, hh)), dev, shift)
    w2 = _bf16(rng.normal(0, 1, (o, hh)) / 8, dev)
    b2 = _t(rng.normal(0, 1, (len(widths), o)), dev)
    tgt = rng.integers(0, o, b)
    tgt[b - 1:] = -1
    tgt = _t(tgt, dev, torch.int32)
    ptr = ihk.member_ptr(seg, len(widths))
    path = ihk.kernel_path(block, h, w2)
    assert path == ("vec4" if block % 4 == 0 and shift % 4 == 0
                    else "scalar")
    for log_probs in (False, True):
        n0 = ihk.bf16_launches
        got, ran = _kernels_run(lambda: ihk.infer_head_cuda(
            h, w2, b2, ptr, block=block, log_probs=log_probs), "infer_head")
        assert ihk.bf16_launches == n0 + 1 and got.dtype == torch.float32
        assert len(ran) == 1 and f"infer_head_bf16_kernel_{path}" in ran[0]
        _close(got, ihk.infer_head_plain(
            h.double(), w2.double(), b2.double(), ptr, block=block,
            log_probs=log_probs))
        assert torch.equal(got, ihk.infer_head_cuda(
            h, w2, b2, ptr, block=block, log_probs=log_probs))
    fwd = (h, w2, b2, tgt, ptr)
    n0, m0 = lhk.bf16_fwd_launches, lhk.bf16_bwd_launches
    (per, dl), ran = _kernels_run(lambda: lhk.loss_head_fwd_cuda(
        *fwd, block=block, b_real=b - 1), "loss_head")
    assert len(ran) == 1 and f"loss_head_fwd_bf16_kernel_{path}" in ran[0]
    wper, wdl = lhk.loss_head_fwd_plain(h.double(), w2.double(),
                                        b2.double(), tgt, ptr, block=block,
                                        b_real=b - 1)
    _close(per, wper)
    _close(dl, wdl)
    dper = _t(rng.normal(0, 1, len(widths)), dev)
    (dh, dw), ran = _kernels_run(lambda: lhk.loss_head_bwd_cuda(
        dper, dl, h, w2, seg, block=block), "loss_head")
    assert len(ran) == 1 and f"loss_head_bwd_bf16_kernel_{path}" in ran[0]
    assert (lhk.bf16_fwd_launches, lhk.bf16_bwd_launches) == (n0 + 1, m0 + 1)
    wdh, wdw = lhk.loss_head_bwd_plain(dper, dl, h, w2, seg, block=block)
    assert _bf16_ulps(dh, wdh) <= 1 and _bf16_ulps(dw, wdw) <= 1
    # dl·d_per rounded to bf16 once, as the kernel stages it
    gl = (dl * dper[None, :, None]).to(torch.bfloat16)
    one = torch.ones_like(dper, dtype=torch.float64)
    _f64_check(dh, wdh, *_sum_bound(lambda a, c: lhk.loss_head_bwd_plain(
        one, a, h.double(), c, seg, block=block)[0], gl, w2))
    _f64_check(dw, wdw, *_sum_bound(lambda a, c: lhk.loss_head_bwd_plain(
        one, a, c, w2.double(), seg, block=block)[1], gl, h))
    again = lhk.loss_head_bwd_cuda(dper, dl, h, w2, seg, block=block)
    assert torch.equal(dh, again[0]) and torch.equal(dw, again[1])


def test_bf16_step_on_card_matches_cpu(dev):
    """One fused step under the bf16 policy on the card — 2·(depth+1)
    launches, each a bf16 instance — against the same step on the CPU
    (the plain versions); f32 masters and gradients; two steps bitwise
    equal; and a bf16 served forward, depth+1 bf16 launches."""
    from repro_torch.core import deep
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.launch_count import (fused_infer_kernels,
                                                 fused_step_kernels,
                                                 kernel_launches)
    from repro_torch.optim.optimizers import sgd
    lp = _serve_layout()
    p_cpu = deep.init_params(torch.Generator().manual_seed(0), lp)
    p_dev = _params_on(p_cpu, dev)
    x = torch.randn(32, 6, generator=torch.Generator().manual_seed(1))
    y = torch.randint(0, 3, (32,), generator=torch.Generator().manual_seed(2))
    opt = sgd()

    def step(params, xx, yy):
        return deep.opt_step(params, opt.init(params), xx, yy, 0.1, opt, lp,
                             bd_impl="fused", compute_dtype="bfloat16")

    def diff(before):
        after = kernel_launches()
        return {k: after[k] - before[k] for k in after
                if after[k] != before[k]}

    before = kernel_launches()
    got = step(p_dev, x.to(dev), y.to(dev))
    assert diff(before) == fused_step_kernels(lp.depth, "bfloat16")
    assert all(t.dtype == torch.float32 for t in tree_leaves(got[0]))
    again = step(p_dev, x.to(dev), y.to(dev))
    for a, b in zip(tree_leaves(got[0]), tree_leaves(again[0])):
        assert torch.equal(a, b)
    want = step(p_cpu, x, y)
    # the losses: the f32 tolerance of the slice's CPU tests over bf16
    # operands (2e-2, JAX's bf16 fused-vs-einsum tolerance)
    np.testing.assert_allclose(got[3].cpu().numpy(), want[3].numpy(),
                               rtol=2e-2, atol=2e-2)
    for a, b in zip(tree_leaves(got[0]), tree_leaves(want[0])):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=2e-2,
                                   atol=2e-3)
    before = kernel_launches()
    with torch.inference_mode():
        deep.forward(p_dev, x.to(dev), lp, bd_impl="fused", infer=True,
                     compute_dtype="bfloat16")
    assert diff(before) == fused_infer_kernels(lp.depth, "bfloat16")


# --------------------------------------------------------------------- #
# the bf16 policy on the unfused route, the M3 kernels and the int8     #
# serve copy                                                            #
# --------------------------------------------------------------------- #
#
# Each bf16 instance sums the same products as its f32 instance on the
# widened operands, in the same order (the same core, its loads widened),
# and rounds once: where both take the same instance its output is
# bitwise the f32 instance's rounded to bf16 (f32 logits: bitwise the f32
# instance's).  Against its plain version: ≤ 1 bf16 ulp beyond the atol,
# and the carve-out held to the f64 sum (``_f64_check``).

def _as_f32_rounded(fn, *args):
    """``fn`` on the operands widened to f32, its output rounded once to
    bf16."""
    return fn(*[a.float() if a.dtype == torch.bfloat16 else a
                for a in args]).to(torch.bfloat16)


@pytest.mark.parametrize("widths,block,b,shift", _MID_GRID + [
    (((64, 32, 16), (13, 5), (7,)) * 4, 8, 32, 1)])  # 2 bytes off: scalar
def test_bf16_block_diag_fwd_dh_dw_match_plain(dev, widths, block, b, shift):
    """The unfused mid layer's bf16 instances: the forward and its dh pass
    (``block_diag_bf16_group_kernel``) and dWB
    (``block_diag_dw_bf16_member_kernel``; B = 300: ten 32-row chunks
    summed in f32, rounded once), each on the instance ``fwd_path`` /
    ``dw_path`` names, ≤ 1 bf16 ulp from the plain version, bitwise the
    f32 instance on the widened operands rounded once, two launches
    bitwise equal; counted in ``bf16_fwd_launches`` /
    ``bf16_dw_launches``."""
    from repro_torch.kernels import block_diag as bdk
    acts = tuple(ACTIVATION_ORDER[i % 10] for i in range(len(widths)))
    lp = LayeredPopulation(5, 3, widths, acts, block=block)
    rng = np.random.default_rng(b + 7)
    word = "block_diag_bf16_group_kernel"
    for l in range(lp.depth - 1):
        lay = lp.bd_layout(l)
        x = _bf16(rng.normal(0, 1, (b, lay.n_in_tiles * block)), dev, shift)
        wbn = rng.normal(0, 1, (lay.n_param_blocks + 1, block, block)) \
            / np.sqrt(block)
        wbn[-1] = np.eye(block)
        wb = _bf16(wbn, dev, shift)
        sched = flk.schedule_on(lay, dev)
        n0, m0 = bdk.bf16_fwd_launches, bdk.fwd_launches
        y, ran = _kernels_run(
            lambda: bdk.block_diag_fwd_cuda(x, wb, *sched, blk=block), word)
        assert (bdk.bf16_fwd_launches, bdk.fwd_launches) == (n0 + 1, m0)
        assert y.dtype == torch.bfloat16
        path = bdk.fwd_path(x, wb, y)
        assert path == ("vec4" if block % 4 == 0 and shift % 4 == 0
                        else "scalar")
        _group_instance(ran, path, word)
        want = bdk.block_diag_fwd_plain(x, wb, *sched, blk=block)
        assert _bf16_ulps(y, want) <= 1
        _f64_check(y, want, *_sum_bound(
            lambda a, c: bdk.block_diag_fwd_plain(a, c, *sched, blk=block),
            x, wb))
        assert torch.equal(y, bdk.block_diag_fwd_cuda(x, wb, *sched,
                                                      blk=block))
        y32 = _as_f32_rounded(lambda a, c: bdk.block_diag_fwd_cuda(
            a, c, *sched, blk=block), x, wb)
        if shift == 0:   # the f32 instance takes the same path
            assert torch.equal(y, y32)
        rowptr_t, s_in_t, s_w_t, perm_t, out_t, in_t = flk.schedule_on(
            lay, dev, transposed=True)
        wb_t = flk.transposed_tiles(wb, perm_t)
        dy = _bf16(rng.normal(0, 1, (b, lay.n_out_tiles * block)), dev,
                   shift)
        dh_args = (dy, wb_t, rowptr_t, s_in_t, s_w_t)
        dh, ran = _kernels_run(
            lambda: bdk.block_diag_fwd_cuda(*dh_args, blk=block), word)
        _group_instance(ran, bdk.fwd_path(dy, wb_t, dh), word)
        want = bdk.block_diag_fwd_plain(*dh_args, blk=block)
        assert _bf16_ulps(dh, want) <= 1
        _f64_check(dh, want, *_sum_bound(
            lambda a, c: bdk.block_diag_fwd_plain(a, c, *dh_args[2:],
                                                  blk=block), dy, wb_t))
        assert torch.equal(dh, bdk.block_diag_fwd_cuda(*dh_args, blk=block))
        n0, m0 = bdk.bf16_dw_launches, bdk.dw_launches
        dwb, ran = _kernels_run(
            lambda: bdk.block_diag_dw_cuda(dy, x, out_t, in_t, blk=block),
            "block_diag_dw")
        assert (bdk.bf16_dw_launches, bdk.dw_launches) == (n0 + 1, m0)
        assert dwb.dtype == torch.bfloat16
        dpath = bdk.dw_path(dy, x, dwb)
        assert dpath == ("vec4" if block % 4 == 0 and shift % 4 == 0
                         else "scalar")
        assert len(ran) == 1 and ("block_diag_dw_bf16_member_kernel<%d>" % (
            4 if dpath == "vec4" else 1)) in ran[0], ran
        want = bdk.block_diag_dw_plain(dy, x, out_t, in_t, blk=block)
        assert _bf16_ulps(dwb, want) <= 1
        _f64_check(dwb, want, *_sum_bound(
            lambda a, c: bdk.block_diag_dw_plain(a, c, out_t, in_t,
                                                 blk=block), dy, x))
        assert torch.equal(dwb, bdk.block_diag_dw_cuda(dy, x, out_t, in_t,
                                                       blk=block))
        if shift == 0:   # one f32 sum over the whole batch, rounded once
            assert torch.equal(dwb, _as_f32_rounded(
                lambda a, c: bdk.block_diag_dw_cuda(a, c, out_t, in_t,
                                                    blk=block), dy, x))


@pytest.mark.parametrize("sizes,block,o,b,offset", [
    ((3, 9, 1, 20, 5), 1, 2, 7, 0),          # block 1: scalar
    ((3, 9, 1, 20, 5), 8, 5, 33, 0),
    ((100, 1, 57, 128), 128, 2, 32, 0),      # parallelmlp-10k's block
    (_NARROW, 8, 2, 32, 0),                  # the depth-3 head's members
    ((300, 129, 57, 700), 128, 20, 300, 0),  # O past 16, B = 300
    ((5, 12, 7), 8, 3, 6, 1),                # h 2 bytes off: scalar
])
def test_bf16_m3_matmul_kernels_match_plain(dev, sizes, block, o, b, offset):
    """The M3 kernels' bf16 instances: y (bf16 logits, rounded once in the
    forward's epilogue), dh and dW2 (one f32 sum over the batch, rounded
    once), each on the design ``kernel_path`` names, ≤ 1 bf16 ulp from the
    plain version, bitwise the f32 instance on the widened operands
    rounded once where both take the same design, twice bitwise equal;
    counted in the ``bf16_*`` counters."""
    from repro_torch.core.population import Population
    from repro_torch.kernels import m3_matmul as m3k
    pop = Population(4, o, sizes, ("relu",) * len(sizes), block=block)
    rng = np.random.default_rng(b + block + o + 1)
    hh = pop.total_hidden
    h = _bf16(rng.normal(0, 1, (b, hh)) * pop.hidden_mask, dev, offset)
    w2 = _bf16(rng.normal(0, 1, (o, hh)), dev)
    dy = _bf16(rng.normal(0, 1, (b, pop.num_members, o)), dev)
    seg = _t(pop.block_segment_ids, dev, torch.int32)
    ptr = ihk.member_ptr(seg, pop.num_members)
    f32 = (m3k.fwd_launches, m3k.dh_launches, m3k.dw_launches)
    counts = (m3k.bf16_fwd_launches, m3k.bf16_dh_launches,
              m3k.bf16_dw_launches)
    path = ihk.kernel_path(block, h, w2)
    assert path == ("vec4" if block % 4 == 0 and offset % 4 == 0
                    else "scalar")
    y, ran = _kernels_run(lambda: m3k.m3_matmul_fwd_cuda(
        h, w2, ptr, block=block), "m3_")
    assert len(ran) == 1 and f"m3_fwd_bf16_stream_kernel_{path}" in ran[0]
    dh, ran = _kernels_run(lambda: m3k.m3_matmul_dh_cuda(
        dy, w2, seg, block=block), "m3_")
    assert len(ran) == 1 and "m3_dh_bf16_kernel" in ran[0], ran
    dw, ran = _kernels_run(lambda: m3k.m3_matmul_dw_cuda(
        dy, h, seg, block=block), "m3_")
    assert len(ran) == 1 and "m3_dw_bf16_stream_kernel" in ran[0], ran
    assert (m3k.fwd_launches, m3k.dh_launches, m3k.dw_launches) == f32
    assert (m3k.bf16_fwd_launches, m3k.bf16_dh_launches,
            m3k.bf16_dw_launches) == tuple(c + 1 for c in counts)
    assert y.dtype == dh.dtype == dw.dtype == torch.bfloat16
    cases = (
        (y, lambda a, c: m3k.m3_matmul_fwd_plain(a, c, ptr, block=block),
         (h, w2), lambda a, c: m3k.m3_matmul_fwd_cuda(a, c, ptr,
                                                      block=block)),
        (dh, lambda a, c: m3k.m3_matmul_dh_plain(a, c, seg, block=block),
         (dy, w2), lambda a, c: m3k.m3_matmul_dh_cuda(a, c, seg,
                                                      block=block)),
        (dw, lambda a, c: m3k.m3_matmul_dw_plain(a, c, seg, block=block),
         (dy, h), lambda a, c: m3k.m3_matmul_dw_cuda(a, c, seg,
                                                     block=block)))
    for got, plain, ops_, kernel in cases:
        want = plain(*ops_)
        assert _bf16_ulps(got, want) <= 1
        _f64_check(got, want, *_sum_bound(plain, *ops_))
        assert torch.equal(got, kernel(*ops_))
        if offset == 0:
            assert torch.equal(got, _as_f32_rounded(kernel, *ops_))


@pytest.mark.parametrize("b,f,block,n_blocks,shift", [
    (32, 100, 128, 12, 0),    # parallelmlp-10k's rows: 200 bytes, vec4
    (32, 100, 8, 13, 0),
    (300, 100, 128, 2, 0),    # ten batch tiles
    (5, 101, 8, 9, 0),        # F % 4 != 0: scalar
    (32, 100, 8, 13, 1),      # x 2 bytes off an 8-byte boundary: scalar
    (33, 1030, 8, 5, 0),      # x not resident
])
def test_bf16_fused_input_int8_matches_plain(dev, b, f, block, n_blocks,
                                             shift):
    """The int8 input layer on bf16 x (``fused_input_i8_bf16_kernel``): y
    bf16, ≤ 1 bf16 ulp from the plain version, bitwise the f32 int8
    instance on x widened, rounded once, where both take the same
    instance; two launches bitwise equal; counted in
    ``bf16_int8_launches``."""
    from repro_torch.quant import _input_f_pad
    rng = np.random.default_rng(b + 3)
    h = block * n_blocks
    x = _bf16(rng.normal(0, 1, (b, f)), dev, shift)
    w_q = _int8(rng, (h, _input_f_pad(f)), dev)
    w_s = _scales(rng, n_blocks, dev)
    bias = _t(rng.normal(0, 1, h), dev)
    mask = _t(rng.random(h) > 0.2, dev)
    ids = _t(np.arange(n_blocks) % len(ACTIVATION_ORDER), dev, torch.int32)
    n0, m0 = fik.bf16_int8_launches, fik.int8_launches
    got, ran = _kernels_run(lambda: fik.fused_input_int8_cuda(
        x, w_q, w_s, bias, mask, ids, block=block), "fused_input")
    assert (fik.bf16_int8_launches, fik.int8_launches) == (n0 + 1, m0)
    assert got.dtype == torch.bfloat16
    path = fik.fwd_path(x, w_q, got)
    assert path == ("vec4" if f % 4 == 0 and shift % 4 == 0 else "scalar")
    assert len(ran) == 1 and ("fused_input_i8_bf16_kernel<%d"
                              % (4 if path == "vec4" else 1)) in ran[0], ran
    want = fik.fused_input_int8_plain(x, w_q, w_s, bias, mask, ids,
                                      block=block)
    assert _bf16_ulps(got, want) <= 1
    w_dq = w_q[:, :f].float() * w_s.repeat_interleave(block)[:, None]
    exact = fik.fused_input_plain(x.double(), w_dq.double(), bias, mask, ids,
                                  block=block)
    _f64_check(got, want, exact, _act_bound(lambda a, c: a @ c.t(), x, w_dq,
                                            bias, exact))
    assert torch.equal(got, fik.fused_input_int8_cuda(
        x, w_q, w_s, bias, mask, ids, block=block))
    x32 = x.float()
    y32 = fik.fused_input_int8_cuda(x32, w_q, w_s, bias, mask, ids,
                                    block=block)
    if fik.fwd_path(x32, w_q, y32) == path:
        assert torch.equal(got, y32.to(torch.bfloat16))


@pytest.mark.parametrize("widths,block,b,shift", _MID_GRID + [
    (((64, 32, 16), (13, 5), (7,)) * 4, 8, 32, 1)])  # 2 bytes off: scalar
def test_bf16_fused_layer_int8_matches_plain(dev, widths, block, b, shift):
    """The int8 mid layer on bf16 x (``fused_layer_i8_bf16_group_kernel``,
    the core's I8BW policy): y bf16 on the instance ``fwd_path`` names,
    ≤ 1 bf16 ulp from the plain version, bitwise the f32 int8 instance on
    x widened, rounded once, where both take the same instance; two
    launches bitwise equal."""
    from repro_torch.kernels import block_diag as bdk
    acts = tuple(ACTIVATION_ORDER[i % 10] for i in range(len(widths)))
    lp = LayeredPopulation(5, 3, widths, acts, block=block)
    rng = np.random.default_rng(b + 5)
    word = "fused_layer_i8_bf16_group_kernel"
    for l in range(lp.depth - 1):
        lay = lp.bd_layout(l)
        pout = lp.layer_pop(l + 1)
        x = _bf16(rng.normal(0, 1, (b, lay.n_in_tiles * block)), dev, shift)
        wb_q = _int8(rng, (lay.n_param_blocks + 1, block, block), dev)
        wb_q[-1] = torch.eye(block, device=dev, dtype=torch.int8)
        wb_s = _scales(rng, lay.n_param_blocks + 1, dev)
        wb_s[-1] = 1.0
        b_eff = _t(rng.normal(0, 1, lay.n_out_tiles * block), dev)
        mask = _t(pout.hidden_mask, dev)
        acts_t = _t(pout.block_act_ids, dev, torch.int32)
        sched = flk.schedule_on(lay, dev)
        args = (x, wb_q, wb_s, b_eff, mask, acts_t, *sched)
        n0, m0 = flk.bf16_int8_launches, flk.int8_launches
        got, ran = _kernels_run(
            lambda: flk.fused_layer_int8_cuda(*args, blk=block), word)
        assert (flk.bf16_int8_launches, flk.int8_launches) == (n0 + 1, m0)
        path = bdk.fwd_path(x, wb_q, got)
        assert path == ("vec4" if block % 4 == 0 and shift % 4 == 0
                        else "scalar")
        _group_instance(ran, path, word)
        want = flk.fused_layer_int8_plain(*args, blk=block)
        assert got.dtype == torch.bfloat16 and _bf16_ulps(got, want) <= 1
        wdq = wb_q.float() * wb_s[:, None, None]
        exact = flk.fused_layer_plain(x.double(), wdq.double(), *args[3:],
                                      blk=block)
        _f64_check(got, want, exact, _act_bound(
            lambda a, c: bdk.block_diag_fwd_plain(a, c, *sched, blk=block),
            x, wdq, b_eff, exact))
        assert torch.equal(got, flk.fused_layer_int8_cuda(*args, blk=block))
        x32 = x.float()
        y32 = flk.fused_layer_int8_cuda(x32, *args[1:], blk=block)
        if bdk.fwd_path(x32, wb_q, y32) == path:
            assert torch.equal(got, y32.to(torch.bfloat16))


@pytest.mark.parametrize("log_probs", [False, True])
@pytest.mark.parametrize("widths,block,o,b,shifts", [
    ((128,) * 40, 128, 2, 32, (0, 0)),     # parallelmlp-10k's members
    (_HEAD_NARROW, 8, 2, 32, (0, 0)),      # the depth-3 head's, block 8
    (_HEAD_EMPTY, 8, 5, 31, (0, 0)),       # empty members
    ((40, 5000, 16, 24), 8, 16, 33, (0, 0)),  # a member over several tiles
    ((7, 13, 30, 2, 64, 9), 6, 2, 31, (0, 0)),  # block 6: scalar
    ((128,) * 40, 128, 2, 32, (1, 0)),     # h 2 bytes off: scalar
    (_HEAD_NARROW, 8, 2, 32, (0, 2)),      # w2_q 2 bytes off: scalar
])
def test_bf16_infer_head_int8_matches_plain(dev, log_probs, widths, block, o,
                                            b, shifts):
    """The int8 head on bf16 h (``infer_head_i8_bf16_kernel_*``): f32
    logits within the f32 tolerance of the plain version on the same
    operands, on the design ``kernel_path`` names, bitwise the f32 int8
    instance on h widened where both take the same design; two launches
    bitwise equal."""
    rng = np.random.default_rng(len(widths) + o + 3)
    blocks = [-(-w // block) for w in widths]
    seg = np.repeat(np.arange(len(widths)), blocks).astype(np.int32)
    hh = int(sum(blocks)) * block
    h = _bf16(rng.normal(0, 1, (b, hh)), dev, shifts[0])
    w_q = _shifted(rng.integers(-127, 128, (o, hh)).astype(np.int8),
                   shifts[1], dev)
    w_s = _scales(rng, hh // block, dev)
    b2 = _t(rng.normal(0, 1, (len(widths), o)), dev)
    ptr = ihk.member_ptr(_t(seg, dev, torch.int32), len(widths))
    path = ihk.kernel_path(block, h, w_q)
    assert path == ("vec4" if block % 4 == 0 and shifts[0] % 4 == 0
                    and shifts[1] % 4 == 0 else "scalar")
    n0, m0 = ihk.bf16_int8_launches, ihk.int8_launches
    got, ran = _kernels_run(lambda: ihk.infer_head_int8_cuda(
        h, w_q, w_s, b2, ptr, block=block, log_probs=log_probs),
        "infer_head")
    assert (ihk.bf16_int8_launches, ihk.int8_launches) == (n0 + 1, m0)
    assert got.dtype == torch.float32
    assert len(ran) == 1 and f"infer_head_i8_bf16_kernel_{path}" in ran[0]
    _close(got, ihk.infer_head_int8_plain(*_f64(h.float(), w_q, w_s, b2,
                                                ptr), block=block,
                                          log_probs=log_probs))
    assert torch.equal(got, ihk.infer_head_int8_cuda(
        h, w_q, w_s, b2, ptr, block=block, log_probs=log_probs))
    h32 = h.float()
    if ihk.kernel_path(block, h32, w_q) == path:
        assert torch.equal(got, ihk.infer_head_int8_cuda(
            h32, w_q, w_s, b2, ptr, block=block, log_probs=log_probs))


def test_bf16_unfused_m3_and_int8_routes_on_card_match_cpu(dev):
    """The three combinations on the card against the CPU's plain
    versions: the unfused step with the M3 head under bf16 (exactly
    ``unfused_step_launches(depth, "pallas", "bfloat16")``: the
    block-diagonal and M3 kernels' bf16 instances, ``seg_act`` in f32),
    its served forward, and the int8 serve copy under bf16 (depth+1
    ``*_int8_bf16`` launches); f32 masters and gradients."""
    from repro_torch.core import deep
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.launch_count import (fused_infer_kernels,
                                                 kernel_launches,
                                                 unfused_infer_launches,
                                                 unfused_step_launches)
    from repro_torch.quant import quantize_population
    lp = _serve_layout()
    p_cpu = deep.init_params(torch.Generator().manual_seed(0), lp)
    p_dev = _params_on(p_cpu, dev)
    x = torch.randn(33, 6, generator=torch.Generator().manual_seed(1))
    y = torch.randint(0, 3, (33,), generator=torch.Generator().manual_seed(2))
    route = dict(bd_impl="pallas", act_impl="pallas", m3_impl="pallas",
                 compute_dtype="bfloat16")

    def moved(fn):
        before = kernel_launches()
        out = fn()
        after = kernel_launches()
        return out, {k: after[k] - before[k] for k in after
                     if after[k] != before[k]}

    got, n = moved(lambda: deep.forward(p_dev, x.to(dev), lp, infer=True,
                                        **route))
    assert n == unfused_infer_launches(lp.depth, "pallas", "bfloat16")
    want = deep.forward(p_cpu, x, lp, infer=True, **route)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=2e-2,
                               atol=2e-2)
    (_, per, grads), n = moved(lambda: deep.loss_and_grads(
        p_dev, x.to(dev), y.to(dev), lp, **route))
    assert n == unfused_step_launches(lp.depth, "pallas", "bfloat16")
    assert all(g.dtype == torch.float32 for g in tree_leaves(grads))
    _, wper, wgrads = deep.loss_and_grads(p_cpu, x, y, lp, **route)
    np.testing.assert_allclose(per.cpu().numpy(), wper.numpy(), rtol=2e-2,
                               atol=2e-2)
    for a, b in zip(tree_leaves(grads), tree_leaves(wgrads)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-2,
                                   atol=1e-3)
    q_dev = quantize_population(p_dev, lp)
    q_cpu = quantize_population(p_cpu, lp)
    got, n = moved(lambda: deep.forward(
        q_dev, x.to(dev), lp, bd_impl="fused", infer=True,
        weights_dtype="int8", compute_dtype="bfloat16"))
    assert n == fused_infer_kernels(lp.depth, "bfloat16", "int8")
    want = deep.forward(q_cpu, x, lp, bd_impl="fused", infer=True,
                        weights_dtype="int8", compute_dtype="bfloat16")
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=2e-2,
                               atol=2e-2)
