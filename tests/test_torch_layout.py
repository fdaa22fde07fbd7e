"""The port's numpy-side copies held against the JAX package: population
layouts, synthetic data, activations and the paper's configuration.  Also
the port's import isolation: ``repro_torch`` never imports ``jax`` or
``repro``."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs import parallelmlp_10k as jcfg
from repro.core import activations as jact
from repro.core import population as jpop
from repro.data import synthetic as jsyn
from repro_torch.configs import parallelmlp_10k as tcfg
from repro_torch.core import activations as tact
from repro_torch.core import population as tpop
from repro_torch.data import synthetic as tsyn

_POP_ARRAYS = ("padded_sizes", "offsets", "segment_ids", "hidden_mask",
               "act_ids", "member_fan_in", "block_segment_ids",
               "block_act_ids")
_BD_FIELDS = [f.name for f in dataclasses.fields(jpop.BlockDiagLayout)]


def _same(a, b, where):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=where)
        assert np.asarray(a).dtype == np.asarray(b).dtype, where
    else:
        assert a == b, where


def _check_pop(jp, tp, where):
    assert tp.total_hidden == jp.total_hidden, where
    assert tp.num_members == jp.num_members, where
    for name in _POP_ARRAYS:
        _same(getattr(jp, name), getattr(tp, name), f"{where}.{name}")
    assert tp.act_runs == jp.act_runs, where
    assert tp.size_buckets() == jp.size_buckets(), where
    assert tp.describe() == jp.describe(), where


def _check_layered(jl, tl, where):
    assert (tl.depth, tl.num_members, tl.num_real, tl.n_pad) == \
        (jl.depth, jl.num_members, jl.num_real, jl.n_pad), where
    assert tl.widths == jl.widths and tl.activations == jl.activations, where
    assert tl.member_depths == jl.member_depths, where
    assert tl.describe() == jl.describe(), where
    for l in range(jl.depth):
        _check_pop(jl.layer_pop(l), tl.layer_pop(l), f"{where}.layer{l}")
        _same(jl.active_unit_mask(l), tl.active_unit_mask(l),
              f"{where}.active{l}")
    for l in range(jl.depth - 1):
        assert tl.proj_buckets(l) == jl.proj_buckets(l), where
        jb, tb = jl.bd_layout(l), tl.bd_layout(l)
        for f in _BD_FIELDS:
            _same(getattr(jb, f), getattr(tb, f), f"{where}.bd{l}.{f}")


_LAYERED_GRID = [
    (((5, 3), (12, 9), (7,), (17, 9, 5), (8, 8), (5, 3), (3, 11, 2),
      (24, 16), (4,), (9, 9, 9)), jact.ACTIVATION_ORDER, 8),
    (((24,), (13, 5), (17, 9), (32, 16, 8)),
     ("relu", "tanh", "gelu", "sigmoid"), 8),
    (((3,), (3,), (31, 2)), ("identity", "mish", "elu"), 16),
    (((200, 130), (64, 100), (7,)), ("selu", "hardshrink", "leaky_relu"),
     128),
    (((6, 4), (6, 4), (6, 4), (2,)),
     (("relu", "tanh"), ("relu", "tanh"), "gelu", "relu"), 1),
]


@pytest.mark.parametrize("n_shards", [1, 3, 4])
@pytest.mark.parametrize("widths,acts,block", _LAYERED_GRID,
                         ids=["all_ten", "mixed_depth", "tiny_ragged",
                              "block128", "per_layer_acts"])
def test_layered_layout_arrays_equal(widths, acts, block, n_shards):
    """Every static layout array — segment ids, activation ids and runs,
    masks, buckets, and every BlockDiagLayout step array (``*_t``,
    ``s_q_t`` and ``perm_t`` included) — equal between the packages, on
    the plain, sorted and shard-padded layouts."""
    jl = jpop.LayeredPopulation(6, 3, widths, acts, block=block)
    tl = tpop.LayeredPopulation(6, 3, widths, acts, block=block)
    for how, j, t in (("plain", jl, tl),
                      ("sorted", jl.sorted(), tl.sorted()),
                      ("padded", jl.shard_pad(n_shards),
                       tl.shard_pad(n_shards))):
        _check_layered(j, t, f"{how}/{n_shards}")


@pytest.mark.parametrize("block,by", [(1, "act"), (8, "size"), (128, "act")])
def test_population_grid_and_layered_equal(block, by):
    kw = dict(hidden_range=range(1, 14, 3),
              activations=("tanh", "relu", "mish"), repeats=2, block=block,
              sort_by=by)
    jp = jpop.Population.grid(7, 2, **kw)
    tp = tpop.Population.grid(7, 2, **kw)
    assert tp.hidden_sizes == jp.hidden_sizes
    assert tp.activations == jp.activations
    _check_pop(jp, tp, "grid")
    _check_layered(jp.layered(), tp.layered(), "layered")


def test_paper_config_equal():
    """``parallelmlp-10k``: the paper's 10,000 members at block 128, a
    fused width of 1,280,000, member for member the JAX configuration."""
    jm, tm = jcfg.config().model, tcfg.config().model
    assert tm.num_members == 10_000 and tm.total_hidden == 1_280_000
    assert (tm.hidden_sizes, tm.activations, tm.block) == \
        (jm.hidden_sizes, jm.activations, jm.block)
    np.testing.assert_array_equal(tm.block_act_ids, jm.block_act_ids)
    np.testing.assert_array_equal(tm.block_segment_ids, jm.block_segment_ids)
    jr, tr = jcfg.reduced().model, tcfg.reduced().model
    _check_pop(jr, tr, "reduced")
    assert tcfg.config().arch_id == jcfg.config().arch_id


def test_tabular_task_byte_identical():
    j = jsyn.TabularTask(300, 11, n_classes=3, seed=5)
    t = tsyn.TabularTask(300, 11, n_classes=3, seed=5)
    assert t.x.tobytes() == j.x.tobytes() and t.y.tobytes() == j.y.tobytes()
    for step in (0, 7, 41):
        for a, b in zip(j.batch(step, 64), t.batch(step, 64)):
            assert a.tobytes() == b.tobytes()
    for a, b in zip(j.batch_slab(3, 5, 32), t.batch_slab(3, 5, 32)):
        assert a.tobytes() == b.tobytes()
    for (ja, jb), (ta, tb) in zip(j.split(0.7), t.split(0.7)):
        assert ja.tobytes() == ta.tobytes() and jb.tobytes() == tb.tobytes()


def test_activations_match_jax():
    """The ten activations, same ids in the same order, same values —
    including the kinks (0, ±0.5) and both tails."""
    assert tact.ACTIVATION_ORDER == jact.ACTIVATION_ORDER
    assert tact.PAPER_TEN == jact.PAPER_TEN
    x = np.concatenate([np.linspace(-12, 12, 481),
                        [0.0, 0.5, -0.5, 0.5000001, -0.4999999, 30.0, -30.0]]
                       ).astype(np.float32)
    for name in jact.ACTIVATION_ORDER:
        want = np.asarray(jact.ACTIVATIONS[name](x))
        got = tact.ACTIVATIONS[name](torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_apply_activations_sliced_and_masked_match_jax():
    pop = jpop.Population(4, 2, (3, 9, 5, 8, 2, 7, 4, 6, 1, 10),
                          jact.ACTIVATION_ORDER, block=8)
    h = np.random.default_rng(0).normal(0, 2, (5, pop.total_hidden)
                                        ).astype(np.float32)
    ht = torch.from_numpy(h)
    want_s = np.asarray(jact.apply_activations_sliced(h, pop.act_runs))
    want_m = np.asarray(jact.apply_activations_masked(h, pop.act_ids))
    np.testing.assert_allclose(
        tact.apply_activations_sliced(ht, pop.act_runs).numpy(), want_s,
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tact.apply_activations_masked(ht, torch.from_numpy(pop.act_ids))
        .numpy(), want_m, rtol=1e-5, atol=1e-6)


def test_port_imports_neither_jax_nor_repro():
    """Import every module of ``repro_torch`` and the example twins
    (``examples/torch_*.py``) in a fresh interpreter where ``jax``,
    ``jaxlib`` and ``repro`` cannot be imported: each import must succeed,
    and no such module may load."""
    import repro_torch
    root = os.path.dirname(repro_torch.__file__)
    mods = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f),
                                      os.path.dirname(root))
                mod = rel[:-3].replace(os.sep, ".")
                mods.append(mod.removesuffix(".__init__"))
    examples = os.path.join(os.path.dirname(os.path.dirname(root)),
                            "examples")
    twins = sorted(os.path.join(examples, f) for f in os.listdir(examples)
                   if f.startswith("torch_") and f.endswith(".py"))
    code = (
        "import importlib, importlib.abc, importlib.util, sys\n"
        "class Refuse(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError(f'{name} is not importable here')\n"
        "sys.meta_path.insert(0, Refuse())\n"
        f"for m in {sorted(mods)!r}:\n"
        "    importlib.import_module(m)\n"
        f"for i, path in enumerate({twins!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'twin{i}', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(root)
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert len(mods) >= 35
    assert [os.path.basename(t) for t in twins] == [
        "torch_fault_tolerant_train.py", "torch_feature_selection.py",
        "torch_quickstart.py", "torch_search_population.py",
        "torch_train_lm.py"]
    # the training slice's modules and the paper's workflow are among
    # those imported
    assert {"repro_torch.core.tree", "repro_torch.kernels.loss_head",
            "repro_torch.optim.optimizers", "repro_torch.launch.train",
            "repro_torch.distributed.fault_tolerance",
            "repro_torch.distributed.compression",
            "repro_torch.configs", "repro_torch.kernels.flash_attn",
            "repro_torch.kernels.grouped_gemm",
            "repro_torch.core.feature_selection",
            "repro_torch.launch.paper_tables", "repro_torch.core.lifecycle",
            "repro_torch.search", "repro_torch.search.space",
            "repro_torch.search.controller"} <= set(mods)
