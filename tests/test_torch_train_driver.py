"""The port's training driver held against the JAX package's, on the CPU:
resume a JAX run in the port (parameters and optimizer state), the port's
checkpoint restored by JAX, crash replay, the M3 routes (``--m3-impl
pallas|onehot``), the lifecycle and recipe flags (``--halving``,
``--refill``, ``--per-member-*``) run to their end, adafactor and the
bf16 AdamW state through a halving ladder resumed mid-ladder across the
packages in both directions, and ``--pipeline on`` (once not ported)
against ``--pipeline off``.

The JAX driver trains on its einsum route; the port's driver resumes with
``--device cpu``, where every kernel runs its plain PyTorch version.
Tolerance: optimizer trajectories, rtol 1e-5 / atol 1e-6
(tests/test_population_optim.py).
"""
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.core import deep as jdeep
from repro.launch import train as jtrain
from repro.optim import optimizers as jopt
from repro_torch import search as tsearch
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.core import deep as tdeep
from repro_torch.core.tree import tree_leaves
from repro_torch.distributed.fault_tolerance import (StragglerPolicy,
                                                     TrainRunner)
from repro_torch.launch import train as ttrain
from repro_torch.optim import optimizers as topt

TRAJ = dict(rtol=1e-5, atol=1e-6)
RECIPE = ["--arch", "parallelmlp-10k", "--reduced", "--batch", "8",
          "--samples", "128", "--scan-steps", "2", "--population-depths",
          "6,4;5;3,4,2", "--population-acts", "relu,tanh,mish",
          "--population-repeats", "2", "--population-features", "5",
          "--optimizer", "adamw", "--weight-decay", "0.01", "--grad-clip",
          "1.0", "--lr-schedule", "warmup_cosine", "--warmup", "3",
          "--ckpt-every", "2"]


def _assert_trees(got, want):
    gl, wl = tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for i, (a, b) in enumerate(zip(gl, wl)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   err_msg=f"leaf {i}", **TRAJ)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX trains 4 steps and saves; then JAX resumes it to step 8 from a
    copy.  Returns (the 4-step checkpoint dir, JAX's resumed params)."""
    base = tmp_path_factory.mktemp("jax")
    first = base / "first"
    jtrain.main(RECIPE + ["--steps", "4", "--ckpt-dir", str(first),
                          "--pipeline", "off"])
    resumed = base / "resumed"
    shutil.copytree(first, resumed)
    params, _ = jtrain.main(RECIPE + ["--steps", "8", "--ckpt-dir",
                                      str(resumed), "--pipeline", "off",
                                      "--resume"])
    return first, jax.device_get(params)


def test_port_resumes_a_jax_run(jax_runs, tmp_path, capsys):
    """The port restores JAX's checkpoint — parameters and AdamW state —
    continues the run with the same schedule, and lands on JAX's own
    resumed parameters; its checkpoint then restores in JAX."""
    first, jax_params = jax_runs
    ck = tmp_path / "port"
    shutil.copytree(first, ck)
    params, lp, stats = ttrain.main(RECIPE + ["--steps", "8", "--ckpt-dir",
                                              str(ck), "--device", "cpu",
                                              "--bd-impl", "fused",
                                              "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "leaderboard:" in out
    assert "mean member loss" in out and "trained 6 MLPs" in out
    assert stats["steps"] == 4
    _assert_trees(params, jax_params)

    # JAX reads the port's final checkpoint: same layout, params, state
    meta, step = jckpt.load_meta(str(ck))
    assert step == 7 and meta["train"]["optimizer"]["name"] == "adamw"
    jlp = jckpt.layout_from_meta(meta)
    opt = jopt.adamw(weight_decay=0.01)
    extra_like = jax.eval_shape(opt.init, jdeep.abstract_params(jlp))
    jp, jl, _, jst = jckpt.restore_population(str(ck),
                                              extra_like=extra_like)
    assert jl.widths == lp.widths and jl.activations == lp.activations
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert int(jst["count"]) == 8
    tparams, _, _, tst = tckpt.restore_population(
        str(ck), device="cpu",
        extra_like=topt.adamw(weight_decay=0.01).init(
            tdeep.abstract_params(lp)))
    for a, b in zip(jax.tree.leaves(jst), tree_leaves(tst)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_resume_rejects_another_optimizer(jax_runs, tmp_path):
    ck = tmp_path / "port"
    shutil.copytree(jax_runs[0], ck)
    bad = [a if a != "adamw" else "momentum" for a in RECIPE]
    with pytest.raises(ValueError, match="optimizer config mismatch"):
        ttrain.main(bad + ["--steps", "8", "--ckpt-dir", str(ck),
                           "--device", "cpu", "--resume"])


def test_crash_replay_matches_an_unbroken_run(tmp_path):
    """``TrainRunner``: a failure mid-run restores the last checkpoint and
    replays; the result equals a run that never failed, bit for bit, and
    ``on_restore`` hears the replay's re-entry step."""
    from repro_torch.core.population import LayeredPopulation
    lp = LayeredPopulation(4, 2, ((6, 3), (5,)), ("relu", "tanh"))
    rng = np.random.default_rng(0)
    xs = torch.as_tensor(rng.normal(0, 1, (6, 8, 4)).astype(np.float32))
    ys = torch.as_tensor(rng.integers(0, 2, (6, 8)))
    opt = topt.sgd(momentum=0.9)

    def run(ckpt_dir, fail_at=None):
        params = tdeep.init_params(torch.Generator().manual_seed(0), lp)
        failed, restored = [], []

        def step_fn(state, s):
            p, st, *_ = tdeep.opt_step(state["params"], state["extra"],
                                       xs[s], ys[s], 0.1, opt, lp,
                                       bd_impl="fused")
            return {"params": p, "extra": st}, {}

        def hook(s):
            if s == fail_at and not failed:
                failed.append(s)
                raise RuntimeError("injected failure")

        runner = TrainRunner(step_fn, {"params": params,
                                       "extra": opt.init(params)},
                             ckpt_dir=str(ckpt_dir), ckpt_every=2,
                             failure_hook=hook,
                             on_restore=restored.append,
                             straggler=StragglerPolicy(timeout_s=1e9))
        assert runner.run(6) == 6
        return runner, restored

    clean, _ = run(tmp_path / "clean")
    # checkpoints at steps 0, 2, 4: a failure at 5 re-enters at 5, one at 0
    # (before any checkpoint) replays from the initial-state snapshot
    broken, restored = run(tmp_path / "broken", fail_at=5)
    assert broken.restarts == 1 and restored == [5]
    early, restored = run(tmp_path / "early", fail_at=0)
    assert restored == [0]
    for r in (broken, early):
        for a, b in zip(tree_leaves(r.state), tree_leaves(clean.state)):
            assert torch.equal(a, b)
    pol = StragglerPolicy(timeout_s=1.0, max_strikes=2)
    pol.observe(0, 2.0)
    with pytest.raises(TimeoutError):
        pol.observe(1, 3.0)
    assert pol.events == [(0, 2.0), (1, 3.0)]


@pytest.mark.parametrize("flags", [
    ["--pipeline", "on"],
], ids=lambda f: " ".join(f))
def test_unported_flags_raise(flags, tmp_path):
    """``--pipeline on`` once raised here (ROADMAP.md, Queue 1 item 7); it
    now runs, and is the default: its run is bitwise the synchronous
    ``--pipeline off`` run (parameters, losses, launches)."""
    from repro_torch.launch import launch_count
    base = ["--arch", "parallelmlp-10k", "--reduced", "--steps", "2",
            "--device", "cpu"]
    runs = {}
    for tag, extra in (("on", flags), ("off", ["--pipeline", "off"])):
        launch_count.reset_kernel_launches()
        params, lp, stats = ttrain.main(
            base + ["--ckpt-dir", str(tmp_path / tag), *extra])
        runs[tag] = (params, lp, stats, launch_count.kernel_launches())
    (pa, lpa, sa, na), (pb, lpb, sb, nb) = runs["on"], runs["off"]
    assert lpa == lpb and sa["steps"] == 2 and na == nb
    assert sa["chunk_loss"] == sb["chunk_loss"] and sa["chunk_loss"]
    for a, b in zip(tree_leaves(pa), tree_leaves(pb)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("flags", [
    ["--compute-dtype", "bfloat16", "--bd-impl", "pallas", "--act-impl",
     "pallas"],
    ["--compute-dtype", "bfloat16", "--m3-impl", "pallas"],
], ids=lambda f: " ".join(f))
def test_bf16_unfused_and_m3_flags_run(flags, tmp_path):
    """The bf16 policy on the unfused route's kernels and on the M3
    kernels (once refused, Queue 1 item 6b) trains to its end on the CPU:
    each step exactly its route's launches under the ``*_bf16`` names
    (``seg_act`` in f32), the policy in the checkpoint's meta, f32
    masters."""
    from repro_torch.launch import launch_count
    params, lp, stats = ttrain.main(TINY + flags + ["--ckpt-dir",
                                                    str(tmp_path)])
    assert stats["steps"] == 4
    route = dict(zip(flags[2::2], flags[3::2]))
    if route.get("--bd-impl") == "pallas":
        per_step = launch_count.unfused_step_launches(lp.depth, "bucketed",
                                                      "bfloat16")
    else:
        per_step = launch_count.m3_step_launches("bfloat16")
    assert stats["segments"][0]["launches"] == {
        k: 4 * v for k, v in per_step.items()}
    meta, step = tckpt.load_meta(str(tmp_path))
    assert step == 3 and meta["train"]["compute_dtype"] == "bfloat16"
    assert all(p.dtype == torch.float32 for p in tree_leaves(params))


TINY = ["--arch", "parallelmlp-10k", "--reduced", "--steps", "4",
        "--batch", "4", "--samples", "64", "--scan-steps", "2",
        "--population-depths", "4;3;5,2;6", "--population-features", "5",
        "--ckpt-every", "2", "--device", "cpu"]


@pytest.mark.parametrize("flags", [
    ["--halving", "2:0.5"],
    ["--halving", "2:0.5", "--refill", "pbt"],
    ["--per-member-lr"],
    ["--optimizer", "momentum", "--per-member-momentum"],
], ids=lambda f: " ".join(f))
def test_lifecycle_flags_run(flags, tmp_path):
    """The lifecycle and recipe flags (Queue 1 item 5) run to their end
    on the CPU, and the checkpoint's lifecycle meta says what they did."""
    params, lp, stats = ttrain.main(TINY + flags + ["--ckpt-dir",
                                                    str(tmp_path)])
    assert stats["steps"] == 4
    meta, step = tckpt.load_meta(str(tmp_path))
    life = meta["lifecycle"]
    assert step == 3 and life["n_members0"] == 4
    assert len(life["member_ids"]) == lp.num_real
    rec = meta["train"]["optimizer"]
    if "--halving" in flags:
        assert life["rung"] == 1 and len(stats["rungs"]) == 1
    if "--refill" in flags:
        assert lp.num_real == 4 and rec["refill"] == "pbt"
        assert life["next_id"] == 6 and len(life["lineage"]) == 2
        assert sorted(life["member_ids"])[-2:] == [4, 5]
    elif "--halving" in flags:
        assert lp.num_real == 2 and "next_id" not in life
    if "--per-member-lr" in flags:
        assert rec["per_member_lr"] and rec["seed"] == 0
        assert np.asarray(life["lr_vec"], np.float32).tobytes() == \
            tsearch.SearchSpace().init_lr(0, 4, rec["lr"]).tobytes()
    if "--per-member-momentum" in flags:
        assert rec["per_member_momentum"] and len(life["mom_vec"]) == 4


def test_refill_needs_halving(tmp_path):
    with pytest.raises(SystemExit, match="--halving"):
        ttrain.main(TINY + ["--refill", "pbt", "--ckpt-dir",
                            str(tmp_path)])


def test_per_member_resume_of_a_jax_run_without_vectors(tmp_path):
    """A JAX ``--per-member-lr`` run without ``--refill`` stores no lr
    vector: the port refuses to resume it (it cannot redraw JAX's
    ``jax.random`` vector) and says why."""
    flags = [a for a in TINY if a not in ("--device", "cpu")]
    jtrain.main(flags + ["--per-member-lr", "--steps", "2", "--pipeline",
                         "off", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(ValueError, match="lr_vec"):
        ttrain.main(TINY + ["--per-member-lr", "--resume", "--ckpt-dir",
                            str(tmp_path)])


@pytest.mark.parametrize("flags", [
    ["--m3-impl", "pallas"],
    ["--m3-impl", "onehot"],
    ["--bd-impl", "pallas", "--act-impl", "pallas", "--m3-impl", "pallas"],
], ids=lambda f: " ".join(f))
def test_m3_impl_flags_resume_as_jax(jax_runs, flags, tmp_path, capsys):
    """``--m3-impl pallas|onehot`` reach the step: JAX's 4-step run resumed
    to step 6 on the same route by both trainers (JAX's kernels in
    interpret mode) lands on the same parameters, within the route
    tolerance of tests/test_torch_unfused.py."""
    resume = RECIPE + ["--steps", "6", "--resume", *flags]
    ck_j, ck_t = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(jax_runs[0], ck_j)
    shutil.copytree(jax_runs[0], ck_t)
    want, _ = jtrain.main(resume + ["--ckpt-dir", str(ck_j), "--pipeline",
                                    "off"])
    params, _, stats = ttrain.main(resume + ["--ckpt-dir", str(ck_t),
                                             "--device", "cpu"])
    assert stats["steps"] == 2 and "leaderboard:" in capsys.readouterr().out
    gl, wl = tree_leaves(params), jax.tree.leaves(jax.device_get(want))
    assert len(gl) == len(wl)
    for i, (a, b) in enumerate(zip(gl, wl)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   err_msg=f"leaf {i}", rtol=1e-4, atol=1e-6)


def test_ckpt_dir_defaults_to_a_fresh_temp_dir(tmp_path, monkeypatch,
                                               capsys):
    """Without ``--ckpt-dir`` each run checkpoints into a new directory
    under the temporary root, never a shared fixed path; ``--resume``
    without it is refused."""
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    tiny = ["--arch", "parallelmlp-10k", "--reduced", "--steps", "2",
            "--batch", "4", "--samples", "64", "--scan-steps", "2",
            "--population-depths", "4;3", "--population-features", "5",
            "--ckpt-every", "2", "--device", "cpu"]
    dirs = []
    for _ in range(2):
        ttrain.main(tiny)
        line = next(s for s in capsys.readouterr().out.splitlines()
                    if s.startswith("checkpoints: "))
        dirs.append(line.split(": ", 1)[1])
    assert dirs[0] != dirs[1]
    for d in dirs:
        assert str(tmp_path) in d and tckpt.latest_steps(d) == [1]
    with pytest.raises(SystemExit, match="--ckpt-dir"):
        ttrain.main(tiny + ["--resume"])


def test_depth_spec_and_population_flags(tmp_path):
    assert ttrain.parse_depth_spec("64,32,16;13,5;7") == \
        jtrain.parse_depth_spec("64,32,16;13,5;7") == \
        ((64, 32, 16), (13, 5), (7,))
    with pytest.raises(ValueError):
        ttrain.parse_depth_spec(" ; ")
    lp = ttrain.population_from_flags("64,32,16;13,5;7", "paper", 100,
                                      repeats=10)
    assert lp.num_members == 30 and lp.depth == 3 and lp.block == 8
    # an LM arch trains (reduced here; the full one is a card's run)
    runner = ttrain.main(["--arch", "qwen3-1.7b", "--reduced", "--device",
                          "cpu", "--steps", "2", "--batch", "2", "--seq",
                          "8", "--ckpt-dir", str(tmp_path)])
    assert [s for s, _ in runner.metrics_log] == [0, 1]
    # what still raises names its ROADMAP item
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttrain.main(["--arch", "whisper-small", "--device", "cpu"])


# --------------------------------------------------------------------- #
# adafactor and the bf16 AdamW state through a ladder, both packages    #
# --------------------------------------------------------------------- #

LADDER = TINY + ["--halving", "2:0.5,4:0.5"]
OPTIMIZERS = {
    "adafactor": ["--optimizer", "adafactor", "--weight-decay", "0.001"],
    "adafactor pbt": ["--optimizer", "adafactor", "--refill", "pbt"],
    "adafactor arch": ["--optimizer", "adafactor", "--refill", "arch",
                       "--search-space", "widths=4,2|3;acts=relu,tanh"],
    "adamw bf16": ["--optimizer", "adamw", "--opt-state-dtype", "bfloat16",
                   "--weight-decay", "0.01"],
}


def jax_newborns(seed, rung, fresh_lp, device):
    """``fresh_member_params`` drawing as the JAX driver draws."""
    from repro.core import population as jpop
    jl = jpop.LayeredPopulation(fresh_lp.in_features, fresh_lp.out_features,
                                fresh_lp.widths, fresh_lp.activations,
                                block=fresh_lp.block)
    p = jdeep.init_params(jax.random.fold_in(jax.random.PRNGKey(seed),
                                             5000 + rung), jl)
    return tdeep.params_from_numpy(jax.device_get(p), fresh_lp,
                                   device=device)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_ladder_resumes_across_packages(name, tmp_path,
                                                  monkeypatch, capsys):
    """A 6-step ladder (4 → 2 → 1 members, or refilled to 4) stopped at
    step 4, between its rungs: JAX's checkpoint resumed by the port lands
    on JAX's straight run, and the port's resumed by JAX on the port's
    straight run (layout, lifecycle meta, parameters; the port's newborns
    drawn as JAX draws them); the checkpoints carry the state's bf16
    leaves as bf16."""
    flags = LADDER + OPTIMIZERS[name]
    jflags = [a for a in flags if a not in ("--device", "cpu")] + [
        "--pipeline", "off"]
    monkeypatch.setattr(ttrain, "fresh_member_params", jax_newborns)
    meta = {}

    def lifecycle(d):
        return tckpt.load_meta(str(tmp_path / d))[0]["lifecycle"]

    for d, run, more in (("jax4", jtrain.main, jflags),
                         ("jax6", jtrain.main, jflags + ["--steps", "6"]),
                         ("port4", ttrain.main, flags),
                         ("port6", ttrain.main, flags + ["--steps", "6"])):
        meta[d] = run(more + ["--ckpt-dir", str(tmp_path / d)])
    assert lifecycle("jax4")["rung"] == lifecycle("port4")["rung"] == 1
    with np.load(tmp_path / "port4" / "step_00000003" / "arrays.npz") as z:
        m = "extra/m/w_in" if "adamw" in name else "extra/leaves/w_in/m"
        assert z[m].dtype == np.uint16
    capsys.readouterr()
    params, lp, stats = ttrain.main(flags + ["--steps", "6", "--resume",
                                             "--ckpt-dir",
                                             str(tmp_path / "jax4")])
    assert "resumed from step 3 (rung 1" in capsys.readouterr().out
    assert stats["steps"] == 2 and lp.widths == meta["jax6"][1].widths
    assert lifecycle("jax4") == lifecycle("jax6")
    _assert_trees(params, jax.device_get(meta["jax6"][0]))
    back, blp = jtrain.main(jflags + ["--steps", "6", "--resume",
                                      "--ckpt-dir", str(tmp_path / "port4")])
    assert blp.widths == meta["port6"][1].widths
    assert lifecycle("port4") == lifecycle("port6")
    _assert_trees(meta["port6"][0], jax.device_get(back))


def test_adafactor_rung_rewarms_the_factored_state(tmp_path):
    """The state a compacting rung leaves (force-saved at step 1): a fresh
    init's on the new layout (``rewarm_adafactor_state``), its factored
    and unfactored statistics zero, the momentum carried (bf16, live) and
    the count 2; ``rewarm`` without momentum keeps the fresh state."""
    ttrain.main(TINY + ["--optimizer", "adafactor", "--halving", "2:0.5",
                        "--steps", "3", "--ckpt-dir", str(tmp_path)])
    meta, _ = tckpt.load_meta(str(tmp_path), step=1)
    lp = tckpt.layout_from_meta(meta)
    opt = topt.adafactor()
    _, lp1, _, st = tckpt.restore_population(
        str(tmp_path), step=1, device="cpu",
        extra_like=opt.init(tdeep.abstract_params(lp)))
    assert lp1.num_real == 2 and int(st["count"]) == 2
    for leaf in tree_leaves(st["leaves"], is_leaf=topt.is_state_leaf):
        assert leaf["m"].dtype == torch.bfloat16 and leaf["m"].any()
        for key in ("v", "v_row", "v_col"):
            if key in leaf:
                assert not leaf[key].any()
    fresh = topt.adafactor(momentum=0.0).init(tdeep.abstract_params(lp))
    count = torch.tensor(5, dtype=torch.int32)
    out = ttrain.rewarm_adafactor_state(fresh, {"count": count, "m": None})
    assert out["leaves"] is fresh["leaves"] and out["count"] is count


def test_adafactor_crash_replay_matches_an_unbroken_run(tmp_path):
    """``TrainRunner`` over adafactor (bf16 momentum) with its
    off-thread saves: a failure restores the last checkpoint and replays,
    bit for bit the unbroken run."""
    from repro_torch.core.population import LayeredPopulation
    lp = LayeredPopulation(4, 2, ((6, 3), (5,)), ("relu", "tanh"))
    rng = np.random.default_rng(0)
    xs = torch.as_tensor(rng.normal(0, 1, (6, 8, 4)).astype(np.float32))
    ys = torch.as_tensor(rng.integers(0, 2, (6, 8)))
    opt = topt.adafactor(weight_decay=0.001)

    def run(ckpt_dir, fail_at=None):
        params = tdeep.init_params(torch.Generator().manual_seed(0), lp)
        failed, restored = [], []

        def step_fn(state, s):
            p, st, *_ = tdeep.opt_step(state["params"], state["extra"],
                                       xs[s], ys[s], 0.1, opt, lp,
                                       bd_impl="fused")
            return {"params": p, "extra": st}, {}

        def hook(s):
            if s == fail_at and not failed:
                failed.append(s)
                raise RuntimeError("injected failure")

        runner = TrainRunner(step_fn, {"params": params,
                                       "extra": opt.init(params)},
                             ckpt_dir=str(ckpt_dir), ckpt_every=2,
                             failure_hook=hook, on_restore=restored.append)
        assert runner.run(6) == 6
        return runner, restored

    clean, _ = run(tmp_path / "clean")
    broken, restored = run(tmp_path / "broken", fail_at=5)
    assert broken.restarts == 1 and restored == [5]
    assert tckpt.latest_steps(str(tmp_path / "broken")) == [0, 2, 4]
    leaves = tree_leaves(clean.state)
    assert any(t.dtype == torch.bfloat16 for t in leaves)
    for a, b in zip(tree_leaves(broken.state), leaves):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_opt_state_dtype_needs_adamw_and_resume_checks_it(tmp_path):
    """``--opt-state-dtype bfloat16`` with another optimizer exits, as in
    JAX; a resume under another state dtype than the checkpoint's is the
    mismatch JAX's check names (bf16 moments read as f32)."""
    for opt in ("momentum", "adafactor"):
        with pytest.raises(SystemExit, match="adamw only"):
            ttrain.main(TINY + ["--optimizer", opt, "--opt-state-dtype",
                                "bfloat16", "--ckpt-dir", str(tmp_path)])
    ttrain.main(TINY + ["--optimizer", "adamw", "--steps", "2",
                        "--ckpt-dir", str(tmp_path)])
    with pytest.raises(ValueError, match="state_dtype"):
        ttrain.main(TINY + ["--optimizer", "adamw", "--opt-state-dtype",
                            "bfloat16", "--resume", "--ckpt-dir",
                            str(tmp_path)])
