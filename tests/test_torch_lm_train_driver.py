"""The port's LM training driver (``repro_torch.launch.train.run_lm``,
``train.main --arch <LM>``) held against the JAX package's on the CPU.

- ``tests/test_system.py::test_lm_training_reduces_loss``'s twin: qwen3
  reduced from JAX's parameters, 60 steps of B 8 × S 64 at lr 3e-3; the
  loss falls by more than 0.5 and the first steps follow JAX's;
- ``::test_train_driver_with_restart``'s twin on qwen3 reduced (the SSM
  and hybrid LMs' driver: tests/test_torch_lm_ssm.py): a crash at step
  25, the restore of the step-20 checkpoint, and the same curve as the
  unbroken run;
- ``train.main --arch <LM> --reduced --device cpu`` for each of the seven
  attention LMs: a flash launch per attention layer a step, no
  grouped-GEMM launch;
- resumes across the packages, both ways, on qwen3 (tokens) and qwen2-vl
  (the ``embeds`` frontend, whose inputs both drivers draw alike): the
  resumed curve matches the writer's unbroken run;
- ``scripts/lm_grad_rounding.py`` at the reduced size: on the CPU the
  "kernels" are the plain versions, the bf16 gradients some way from f32.

Tolerance: the optimizer's, rtol 1e-5 / atol 1e-6 (losses, gradient
norms, learning rates).
"""
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.data import TokenTask as JTokenTask
from repro.launch import mesh as jmesh
from repro.launch import train as jtrain
from repro.launch.cells import build_optimizer as jax_build_optimizer
from repro.models import lm as jlm
from repro.optim import constant_lr as jconstant_lr
from repro_torch.configs import LM_ARCH_IDS, get_arch
from repro_torch.configs.base import ArchSpec
from repro_torch.data.synthetic import TokenTask
from repro_torch.distributed.fault_tolerance import TrainRunner
from repro_torch.kernels import flash_attn as fak
from repro_torch.kernels import grouped_gemm as moek
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.optim.optimizers import build_optimizer, constant_lr

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these small CPU steps run hundreds of tiny ops,
    which a full thread pool slows many times over when the test workers
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(task, step, b, s):
    return {k: torch.from_numpy(v) for k, v in task.batch(step, b, s).items()}


def test_lm_training_reduces_loss():
    """60 steps from JAX's parameters: the loss falls by more than 0.5;
    the first three steps' losses and gradient norms are JAX's."""
    jarch = jax_arch("qwen3-1.7b", reduced=True)
    arch = get_arch("qwen3-1.7b", reduced=True)
    cfg = arch.model
    jparams, _ = jlm.init_params(jax.random.PRNGKey(0), jarch.model)
    jopt = jax_build_optimizer(jarch)
    jstate = jopt.init(jparams)
    jstep = jax.jit(jlm.make_train_step(jarch.model, jopt,
                                        jconstant_lr(3e-3)))
    jtask = JTokenTask(vocab=cfg.vocab, seed=0)
    want = []
    for s in range(3):
        jparams, jstate, m = jstep(jparams, jstate, jax.tree.map(
            jnp.asarray, jtask.batch(s, 8, 64)), jnp.asarray(s, jnp.int32))
        want.append((float(m["loss"]), float(m["grad_norm"])))

    params = tlm.params_from_jax(jax.tree.map(
        np.asarray, jlm.init_params(jax.random.PRNGKey(0), jarch.model)[0]),
        "cpu")
    opt = build_optimizer(arch)
    state = opt.init(params)
    step = tlm.make_train_step(cfg, opt, constant_lr(3e-3))
    task = TokenTask(vocab=cfg.vocab, seed=0)
    losses = []
    for s in range(60):
        params, state, m = step(params, state, _batch(task, s, 8, 64), s)
        losses.append(float(m["loss"]))
        if s < 3:
            np.testing.assert_allclose((losses[-1], float(m["grad_norm"])),
                                       want[s], err_msg=f"step {s}", **TOL)
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])


def test_train_driver_with_restart(tmp_path):
    """30 steps with a checkpoint every 10; a crash at step 25 restores
    step 20 and replays: the same curve as the unbroken run, bitwise."""
    arch = get_arch("qwen3-1.7b", reduced=True)
    cfg = arch.model
    task = TokenTask(vocab=cfg.vocab, seed=0)
    opt = build_optimizer(arch)
    step = tlm.make_train_step(cfg, opt, constant_lr(1e-3))

    def make_runner(ckpt_dir, failure_hook=None):
        params = tlm.init_params(torch.Generator().manual_seed(0), cfg)
        state = {"params": params, "opt": opt.init(params)}

        def step_fn(st, s):
            p, o, m = step(st["params"], st["opt"], _batch(task, s, 4, 32),
                           s)
            return {"params": p, "opt": o}, {"loss": float(m["loss"])}

        return TrainRunner(step_fn, state, ckpt_dir=ckpt_dir,
                           ckpt_every=10, failure_hook=failure_hook)

    ref = make_runner(str(tmp_path / "ref"))
    ref.run(30)
    boom = {25: True}

    def hook(s):
        if boom.pop(s, False):
            raise RuntimeError("chip gone")

    ft = make_runner(str(tmp_path / "ft"), hook)
    ft.run(30)
    assert ft.restarts == 1
    ref_curve = {s: m["loss"] for s, m in ref.metrics_log}
    ft_curve = {s: m["loss"] for s, m in ft.metrics_log}
    assert ft_curve == ref_curve and len(ft_curve) == 30
    # steps 21-24 ran twice: the replay from the step-20 checkpoint
    assert [s for s, _ in ft.walls].count(22) == 2
    assert ft.state["opt"]["count"].item() == 30
    for a, b in zip(jax.tree.leaves(ref.state), jax.tree.leaves(ft.state)):
        assert torch.equal(a, b)


def _main(arch_id, tmp, *extra):
    return ttrain.main(["--arch", arch_id, "--reduced", "--device", "cpu",
                        "--batch", "2", "--seq", "16", "--warmup", "2",
                        "--ckpt-dir", str(tmp), *extra])


@pytest.mark.parametrize("arch_id", LM_ARCH_IDS)
def test_main_trains_each_lm(arch_id, tmp_path, capsys):
    cfg = get_arch(arch_id, reduced=True).model
    attn = sum(1 for ls in cfg.layers if ls.mixer == "attn")
    f0, m0 = fak.launches, moek.launches
    runner = _main(arch_id, tmp_path, "--steps", "3", "--ckpt-every", "2")
    assert (fak.launches - f0, moek.launches - m0) == (3 * attn, 0)
    assert [s for s, _ in runner.metrics_log] == [0, 1, 2]
    for _, m in runner.metrics_log:
        assert set(m) == {"loss", "grad_norm", "lr"}
        assert all(np.isfinite(v) for v in m.values())
    assert runner.metrics_log[0][1]["lr"] == 0.0      # warmup from 0
    out = capsys.readouterr().out
    assert f"arch={arch_id} device=cpu" in out and "done: 3 steps" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000000", "step_00000002"]


def test_main_microbatches_and_clip_flags(tmp_path):
    """``--num-micro 2`` accumulates two microbatches (two flash launches
    a layer a step); ``--grad-clip`` unset clips at 1.0 as JAX's LM
    default; ``--num-micro`` must divide ``--batch``."""
    cfg = get_arch("qwen3-1.7b", reduced=True).model
    f0 = fak.launches
    one = _main("qwen3-1.7b", tmp_path / "a", "--steps", "3")
    two = _main("qwen3-1.7b", tmp_path / "b", "--steps", "3",
                "--num-micro", "2")
    assert fak.launches - f0 == 3 * cfg.n_layers * (1 + 2)
    for (_, a), (_, b) in zip(one.metrics_log, two.metrics_log):
        assert abs(a["loss"] - b["loss"]) < 1e-4
    # the clip is on: the step-0 norm is far above 1.0, and step 2's loss
    # (after the first step with lr > 0) is --grad-clip 1.0's, not 100's
    clip1 = _main("qwen3-1.7b", tmp_path / "c", "--steps", "3",
                  "--grad-clip", "1.0")
    clip100 = _main("qwen3-1.7b", tmp_path / "d", "--steps", "3",
                    "--grad-clip", "100")
    assert one.metrics_log[0][1]["grad_norm"] > 2.0
    assert one.metrics_log == clip1.metrics_log
    assert one.metrics_log[2][1]["loss"] != clip100.metrics_log[2][1]["loss"]
    with pytest.raises(ValueError, match="does not divide"):
        _main("qwen3-1.7b", tmp_path / "e", "--steps", "1", "--num-micro",
              "3")


def test_lm_refusals_name_their_items():
    """Still not ported, each raising NotImplementedError that names its
    ROADMAP item: the encoder-decoder in ``run_lm`` (9(c)), an LM across
    ranks (9(d)); whisper at ``--arch``."""
    args = SimpleNamespace(device="cpu")
    enc = ArchSpec(arch_id="whisper-small", kind="encdec", model=None)
    with pytest.raises(NotImplementedError, match=r"9\(c\)"):
        ttrain.run_lm(enc, args)
    lm_arch = get_arch("qwen3-1.7b", reduced=True)
    with pytest.raises(NotImplementedError, match=r"9\(d\)"):
        ttrain.run_lm(lm_arch, args, mesh=SimpleNamespace(size=2))
    with pytest.raises(NotImplementedError, match=r"9\(c\)"):
        ttrain.main(["--arch", "whisper-small", "--reduced", "--device",
                     "cpu"])


# --------------------------------------------------------------------- #
# resumes across the packages                                           #
# --------------------------------------------------------------------- #

STEPS, EVERY = 8, 4


def _jax_lm(arch_id, ckpt_dir, resume=False) -> dict:
    """JAX's ``run_lm`` (B 2 × S 16, warmup 2 of 8, a checkpoint every 4
    steps) → {step: metrics}."""
    args = SimpleNamespace(
        warmup=2, steps=STEPS, num_micro=1, grad_clip=None, seed=0,
        batch=2, seq=16, ckpt_dir=str(ckpt_dir), ckpt_every=EVERY,
        straggler_timeout=1e9, resume=resume)
    runner = jtrain.run_lm(jax_arch(arch_id, reduced=True), args,
                           jmesh.make_host_mesh())
    return dict(runner.metrics_log)


def _torch_lm(arch_id, ckpt_dir, resume=False) -> dict:
    runner = _main(arch_id, ckpt_dir, "--steps", str(STEPS), "--ckpt-every",
                   str(EVERY), *(["--resume"] if resume else []))
    return dict(runner.metrics_log)


def _same_curve(got: dict, want: dict):
    assert sorted(got) == [5, 6, 7]
    for s in got:
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(got[s][k], want[s][k],
                                       err_msg=f"step {s} {k}", **TOL)


@pytest.mark.parametrize("arch_id", ["qwen3-1.7b", "qwen2-vl-72b"])
def test_port_resumes_a_jax_checkpoint(arch_id, tmp_path, capsys):
    want = _jax_lm(arch_id, tmp_path / "jax")
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    got = _torch_lm(arch_id, tmp_path / "port", resume=True)
    assert "resumed from step 4" in capsys.readouterr().out
    _same_curve(got, want)


@pytest.mark.parametrize("arch_id", ["qwen3-1.7b", "qwen2-vl-72b"])
def test_jax_resumes_a_port_checkpoint(arch_id, tmp_path, capsys):
    want = _torch_lm(arch_id, tmp_path / "port")
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    got = _jax_lm(arch_id, tmp_path / "jax", resume=True)
    assert "resumed from step 4" in capsys.readouterr().out
    _same_curve(got, want)


def test_grad_rounding_script_runs_reduced(capsys):
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "scripts" / \
        "lm_grad_rounding.py"
    spec = importlib.util.spec_from_file_location("lm_grad_rounding", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--reduced", "--device", "cpu", "--train-steps", "2",
                    "--extra-steps", "1", "--batch", "2", "--seq", "8"])
    assert out["card"] == "cpu" and out["layers"] == 3
    assert out["kernels-plain"] == 0.0
    assert 0.0 < out["plain-f32"] < 0.1
    assert len(out["leaves"]) == 13
    assert out["kernels_over_plain_f32"] == [1.0] * 13
    assert len(out["scale_1pct_over_plain_f32"]) == 13
    assert "tree plain-f32" in capsys.readouterr().out
