"""The input layer's forward wrappers (``repro_torch.kernels.fused_input``)
on the CPU: which instance a launch takes (``fwd_path``, over f32 or int8
weights, by the rule the C entries apply) and the shape checks the
wrappers make before they reach a kernel.  The kernel itself runs only on
the card (tests/test_torch_kernels.py); the plain versions are held to the
JAX package's kernels in tests/test_torch_serve.py and test_torch_quant.py.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import fused_input as fik


def _at(shape, shift: int, dtype=torch.float32) -> torch.Tensor:
    """A tensor whose storage starts ``shift`` elements past a 16-byte
    boundary."""
    n = int(np.prod(shape))
    size = torch.empty(0, dtype=dtype).element_size()
    buf = torch.zeros(n + 64, dtype=dtype)
    base = (-buf.data_ptr() % 16) // size
    return buf[base + shift:base + shift + n].view(shape)


@pytest.mark.parametrize("f,h,shifts,want", [
    (100, 1280, (0, 0, 0), "vec4"),      # parallelmlp-10k's input layer
    (100, 88, (0, 0, 0), "vec4"),        # the depth-3 population's, cut
    (1028, 204, (0, 0, 0), "vec4"),
    (102, 64, (0, 0, 0), "scalar"),      # F not a multiple of 4
    (100, 62, (0, 0, 0), "scalar"),      # H not a multiple of 4
    (100, 64, (1, 0, 0), "scalar"),      # x 4 bytes off
    (100, 64, (0, 2, 0), "scalar"),      # W off
    (100, 64, (0, 0, 3), "scalar"),      # y off
])
def test_fwd_path_rule(f, h, shifts, want):
    """16-byte copies of W rows and x and 16-byte stores of y need F and H
    multiples of 4 and x, W, y on 16-byte boundaries."""
    x, w, y = (_at(shape, s) for shape, s in
               zip(((3, f), (h, f), (3, h)), shifts))
    assert fik.fwd_path(x, w, y) == want


@pytest.mark.parametrize("g_shift,want", [(0, "vec4"), (1, "scalar")])
def test_fwd_path_rule_with_g(g_shift, want):
    """The training launch's g' takes the same rule as y."""
    x, w, y = _at((3, 100), 0), _at((64, 100), 0), _at((3, 64), 0)
    assert fik.fwd_path(x, w, y, _at((3, 64), g_shift)) == want


@pytest.mark.parametrize("f,f_pad,shifts,want", [
    (100, 104, (0, 0), "vec4"),     # the packer's F_pad: 4 int8 a copy
    (6, 8, (0, 0), "scalar"),       # F not a multiple of 4
    (100, 104, (0, 4), "scalar"),   # w_q 4 bytes off a 16-byte boundary
    (100, 102, (0, 0), "scalar"),   # a row stride not a multiple of 4
    (100, 104, (2, 0), "scalar"),   # x off
])
def test_fwd_path_rule_int8(f, f_pad, shifts, want):
    """Over int8 weights the row stride is F_pad and w_q's start counts."""
    x = _at((3, f), shifts[0])
    w_q = _at((64, f_pad), shifts[1], torch.int8)
    assert fik.fwd_path(x, w_q, _at((3, 64), 0)) == want


def _fwd(b=3, f=6, h=16, block=8):
    return (torch.zeros(b, f), torch.zeros(h, f), torch.zeros(h),
            torch.zeros(h), torch.zeros(h // block, dtype=torch.int32))


@pytest.mark.parametrize("entry", [fik.fused_input_cuda,
                                   fik.fused_input_train_cuda])
@pytest.mark.parametrize("bad", ["w", "bias", "mask", "act_ids"])
def test_forward_wrappers_check_shapes(entry, bad):
    """An inconsistent shape raises before any kernel is reached."""
    x, w, bias, mask, ids = _fwd()
    if bad == "w":
        w = torch.zeros(16, 7)
    elif bad == "bias":
        bias = torch.zeros(15)
    elif bad == "mask":
        mask = torch.zeros(17)
    else:
        ids = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="inconsistent shapes"):
        entry(x, w, bias, mask, ids, block=8)


@pytest.mark.parametrize("entry", [fik.fused_input_cuda,
                                   fik.fused_input_train_cuda])
def test_forward_wrappers_take_only_card_tensors(entry):
    """Consistent CPU tensors still raise: a wrapper launches its kernel or
    raises, and never computes on the CPU (ops.py picks the plain version
    for a CPU tensor)."""
    with pytest.raises(ValueError, match="must be on"):
        entry(*_fwd(), block=8)


@pytest.mark.parametrize("bad", ["f_pad", "block", "w_scale", "bias"])
def test_int8_wrapper_checks_shapes(bad):
    x = torch.zeros(3, 6)
    w_q = torch.zeros(16, 8, dtype=torch.int8)
    w_s, bias, mask = torch.zeros(2), torch.zeros(16), torch.zeros(16)
    ids = torch.zeros(2, dtype=torch.int32)
    block = 8
    if bad == "f_pad":
        w_q = torch.zeros(16, 5, dtype=torch.int8)
    elif bad == "block":
        block = 6
    elif bad == "w_scale":
        w_s = torch.zeros(3)
    else:
        bias = torch.zeros(8)
    with pytest.raises(ValueError, match="inconsistent shapes"):
        fik.fused_input_int8_cuda(x, w_q, w_s, bias, mask, ids, block=block)
    if bad == "f_pad":   # the same call with consistent shapes
        with pytest.raises(ValueError, match="must be on"):
            fik.fused_input_int8_cuda(x, torch.zeros(16, 8,
                                                     dtype=torch.int8),
                                      w_s, bias, mask, ids, block=8)
