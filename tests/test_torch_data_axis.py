"""The data axis end to end on the CPU: ``train.main`` and
``serve_population.main`` under ``torchrun`` on meshes with a data axis —
W = 3 (data 3 × model 1) and W = 6 (data 3 × model 2) gloo ranks —
against one rank and against the JAX package's trainer and server on 3
and 6 devices (``XLA_FLAGS=--xla_force_host_platform_device_count=N`` in a
subprocess, as tests/test_population_sharding.py runs it).

- In one process: a step whose batch is split over three threads, each
  averaging its share's means through a ``DataReduce`` that meets the
  others at a barrier, against the step on the whole batch (sgd, AdamW
  with the clip, adafactor), within rtol 1e-5 / atol 1e-6 (the
  optimizer-trajectory tolerance, tests/test_population_optim.py); a
  rank's rows of a slab are the whole slab's.
- The JAX trainer runs 4 steps on 3 and on 6 devices under sgd, AdamW
  with ``--grad-clip`` and adafactor, at ``--batch 12`` (split over the
  data axis of 3) and ``--batch 8`` (replicated), checkpointing at steps
  1 and 3.  The port resumes each step-1 checkpoint at W = 3 or 6 and at
  W = 1 and lands within the tolerance of JAX's step 3 and of W = 1's
  (the parameters, the per-member held-out losses, the per-chunk losses);
  each rank of a data column holds the same bits after every chunk, and
  each rank's loop is 2·(depth+1) launches a step.
- Fresh sgd runs at W = 3 and W = 6 follow W = 1 (``--shard-pad 2`` at
  W = 6); a failure on rank 2 before a step replays bitwise into the
  unbroken W = 3 run; ``--halving --refill pbt --per-member-lr`` keeps
  W = 1's survivors and lineage at W = 3 and 6; a W = 6 checkpoint
  resumes at W = 1, 2 and 3 and a W = 1 checkpoint at W = 6, each within
  the tolerance of the run it left.
- ``serve_population --sharded`` at W = 3 and 6 over JAX's checkpoints,
  f32, int8 and bf16, a flush of 12 split over the data axis (and a flush
  of 16 on every data row): one rank's predictions, JAX's in f32, the
  board's losses within the tolerance, each rank's forward depth+1
  launches.
- Each rank sits at JAX's mesh coordinates, with its model row's and data
  column's groups.

The multi-process harness is tests/test_torch_distributed.py's: every
run a subprocess with a timeout, one thread a rank, each rank's stderr
kept and shown in full when a job fails.
"""
import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.core import deep as tdeep
from repro_torch.core.tree import tree_leaves
from repro_torch.data.synthetic import TabularTask
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import member_partition
from repro_torch.launch import serve_population as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.launch_count import fused_step_kernels
from repro_torch.optim import optimizers as topt
from test_torch_distributed import (BASE, OPT, PORT, TRAJ, _ckpt, _close,
                                    _env, _equal, _losses, _ok, _result,
                                    _resume_copy, _train, torchrun)

# Adafactor's momentum holds each element's update divided by its row's
# and column's factored RMS, so the relative rounding of a reordered
# batch sum shows there undamped: split three ways, 2 of its 2955 state
# elements lie beyond rtol 1e-5 / atol 1e-6 (at most 6.0e-5 relative, in
# one momentum leaf; the weights, lr·momentum, stay within it).  Its
# state is held at ten times the relative tolerance, which the shares'
# steps without the column's mean miss in 2174 of 2955 elements.
ADA_STATE = dict(rtol=1e-4, atol=1e-6)

# the batch split over the data axis of 3, and one it does not divide
CFG = {f"{k}{b}": v + ["--batch", str(b)] for k, v in OPT.items()
       for b in (12, 8)}
SERVE = ["--requests", "40", "--batch", "12", "--calib-samples", "64",
         "--device", "cpu"]
SERVE_KW = {"f32": {}, "int8": {"weights_dtype": "int8"},
            "bf16": {"compute_dtype": "bfloat16"}}
SGD12 = CFG["sgd12"]
PBT = SGD12 + ["--steps", "6", "--halving", "2:0.5", "--refill", "pbt",
               "--per-member-lr"]

_JAXN = r"""
import json, os, sys
n = int(sys.argv[2])
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n}"
import jax, numpy as np
from repro.compat import set_mesh
from repro.data.synthetic import TabularTask
from repro.launch.mesh import make_host_mesh
from repro.launch.serve_population import PopulationServer
from repro.launch.train import main
out, runs = sys.argv[1], json.loads(sys.argv[3])
assert len(jax.devices()) == n
for name, argv in runs.items():
    main(argv + ["--ckpt-dir", os.path.join(out, name)])
mesh = make_host_mesh()
server, step = PopulationServer.from_checkpoint(
    os.path.join(out, "sgd12"), mesh=mesh, batch=12, topk=4,
    bd_impl="einsum", act_impl="sliced")
lp = server.layout
task = TabularTask(64 + 40, lp.in_features, n_classes=lp.out_features,
                   seed=0)
(xc, yc), (xr, _) = task.split(frac=64 / (64 + 40))
res = {"mesh": dict(mesh.shape)}
with set_mesh(mesh):
    board = server.publish(xc, yc)
    res["board"] = [[r["slot"], r["loss"]] for r in board]
    for mode in ("best1", "topk", "all"):
        res[mode] = np.asarray(server.run(xr[:40], mode)["pred"]).tolist()
with open(os.path.join(out, "serve.json"), "w") as f:
    json.dump(res, f)
print("OK")
"""


# --------------------------------------------------------------------- #
# in one process                                                        #
# --------------------------------------------------------------------- #

def test_batch_rows_split_where_the_data_axis_divides():
    """``population_batch_shardings`` on (data, model) meshes, and a
    rank's rows of a slab equal to the whole slab's."""
    from repro_torch.launch.mesh import HostMesh
    task = TabularTask(128, 20, seed=0)
    for shape, b, want in (((3, 1), 12, [(0, 4), (4, 8), (8, 12)]),
                           ((3, 2), 12, [(0, 4), (4, 8), (8, 12)]),
                           ((3, 2), 8, [(0, 8)] * 3),
                           ((1, 4), 12, [(0, 12)]),
                           ((2, 2), 12, [(0, 6), (6, 12)])):
        data, model = shape
        for d in range(data):
            mesh = HostMesh({"data": data, "model": model}, rank=d * model)
            xs, ys = sh.population_batch_shardings(mesh, b)
            lo, hi = want[d]
            assert xs == slice(None)
            assert ys == (slice(None) if (lo, hi) == (0, b)
                          else slice(lo, hi))
            fx, fy = task.batch_slab(5, 3, b)
            rx, ry = task.batch_slab(5, 3, b, rows=(lo, hi))
            assert np.array_equal(rx, fx[:, lo:hi])
            assert np.array_equal(ry, fy[:, lo:hi])
    assert sh.population_batch_shardings(None, 12) == (slice(None),
                                                        slice(None))


class ThreadData(sh.DataReduce):
    """``DataReduce`` whose sum meets the other rows' threads at a barrier
    (the in-process stand-in of the data column's all-reduce)."""

    def __init__(self, n, rank, board, barrier):
        super().__init__(None, n)
        self.rank, self.board, self.barrier = rank, board, barrier

    def sum(self, flat):
        self.board[self.rank] = flat
        self.barrier.wait()
        out = sum(self.board[r] for r in range(len(self.board)))
        self.barrier.wait()
        return out


@pytest.mark.parametrize("name", sorted(OPT))
def test_split_step_matches_the_full_batch_step(name):
    """Three steps of a 12-row batch split in three 4-row shares, each
    share's losses and gradients averaged over the column before the clip
    and the optimizer, against the same steps on the whole batch: the
    losses and the parameters within the tolerance, the state within it
    under sgd and AdamW and within ``ADA_STATE`` under adafactor; the
    three shares' parameters and state equal."""
    lp = ttrain.population_from_flags("16,8;16,8;12,4;12,4;7;9",
                                      "relu,tanh", 20, 2, 1, 8)
    opt = {"sgd": lambda: topt.sgd(),
           "adamw": lambda: topt.adamw(weight_decay=0.01),
           "adafactor": lambda: topt.adafactor(
               weight_decay=0.001, momentum_dtype=torch.float32)}[name]()
    clip = 1.0 if name == "adamw" else None
    params = tdeep.init_params(torch.Generator().manual_seed(0), lp)
    task = TabularTask(128, 20, seed=0)
    xs, ys = (torch.as_tensor(a) for a in task.batch_slab(0, 3, 12))
    route = dict(bd_impl="fused", grad_clip=clip)

    def steps(x, y, red):
        p, st, out = params, opt.init(params), []
        for k in range(3):
            p, st, loss, per, gn = tdeep.opt_step(
                p, st, x[k], y[k], 0.05, opt, lp, data_reduce=red, **route)
            out.append((loss, per, gn))
        return p, st, out

    want = steps(xs, ys, None)
    board, barrier = [None] * 3, threading.Barrier(3)
    got, errors = [None] * 3, []

    def run(r):
        try:
            got[r] = steps(xs[:, 4 * r:4 * r + 4].contiguous(),
                           ys[:, 4 * r:4 * r + 4].contiguous(),
                           ThreadData(3, r, board, barrier))
        except Exception as e:   # noqa: BLE001 — re-raised below
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    for r in (1, 2):
        _equal({"p": got[r][0], "s": got[r][1]},
               {"p": got[0][0], "s": got[0][1]})
    _close(got[0][0], want[0])
    for x, y in zip(tree_leaves(got[0][1]), tree_leaves(want[1])):
        np.testing.assert_allclose(x.float().numpy(), y.float().numpy(),
                                   **(ADA_STATE if name == "adafactor"
                                      else TRAJ))
    for (l1, p1, g1), (l2, p2, g2) in zip(got[0][2], want[2]):
        np.testing.assert_allclose(l1.numpy(), l2.numpy(), **TRAJ)
        np.testing.assert_allclose(p1.numpy(), p2.numpy(), **TRAJ)
        if clip:
            np.testing.assert_allclose(g1.numpy(), g2.numpy(), **TRAJ)


# --------------------------------------------------------------------- #
# the runs                                                              #
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def jax36(tmp_path_factory):
    """The JAX runs on 3 and on 6 devices (two subprocesses at once), and
    copies of their step-1 checkpoints for the port to resume."""
    d = tmp_path_factory.mktemp("data_axis")
    runs = {k: BASE + v + ["--steps", "4", "--pipeline", "off"]
            for k, v in CFG.items()}
    procs = {}
    for n in (3, 6):
        log = open(d / f"jax{n}.log", "w")
        procs[n] = (subprocess.Popen(
            [sys.executable, "-c", _JAXN, str(d / f"jax{n}"), str(n),
             json.dumps(runs)], stdout=log, stderr=subprocess.STDOUT,
            text=True, env=_env()), log)
    for n, (proc, log) in procs.items():
        try:
            rc = proc.wait(timeout=600)
        finally:
            log.close()
        text = (d / f"jax{n}.log").read_text()
        assert rc == 0 and "OK" in text, text[-4000:]
    for n in (3, 6):
        for k in CFG:
            for w in (f"w{n}", "w1"):
                _resume_copy(d / f"jax{n}" / k, d / f"{w}_jax{n}_{k}", 1)
    return d


@pytest.fixture(scope="module")
def runs(jax36):
    """The port's jobs at W = 6, 3 and 2 (in that order: each resumes a
    checkpoint of an earlier one), and the one-rank runs they are held
    to."""
    d = jax36
    one = {}
    for n in (3, 6):
        for k, v in CFG.items():
            name = f"w1_jax{n}_{k}"
            one[name] = ttrain.main(BASE + PORT + v + [
                "--steps", "4", "--resume", "--ckpt-dir", str(d / name)])
    for name, argv in (("w1_sgd", SGD12 + ["--steps", "6"]),
                       ("w1_sgd_p2", SGD12 + ["--steps", "6",
                                              "--shard-pad", "2"]),
                       ("w1_pbt", PBT),
                       ("w1_pbt_p2", PBT + ["--shard-pad", "2"])):
        one[name] = ttrain.main(BASE + PORT + argv
                                + ["--ckpt-dir", str(d / name)])
    _resume_copy(d / "w1_sgd", d / "w6_from_w1", 1)

    def serving(n):
        jck = str(d / f"jax{n}" / "sgd12")
        return [{"kind": "serve", "out": str(d / f"w{n}_serve_{tag}"),
                 "argv": ["--ckpt-dir", jck, "--sharded", *SERVE, *extra],
                 "logits": {"ckpt": jck, "rows": 12, "kw": SERVE_KW[tag]}}
                for tag, extra in (
                    ("f32", []), ("int8", ["--weights-dtype", "int8"]),
                    ("bf16", ["--compute-dtype", "bfloat16"]))]

    resume = ["--steps", "4", "--resume"]
    jobs6 = [_train(d, f"w6_jax6_{k}", v + resume, digest=True)
             for k, v in CFG.items()]
    jobs6 += [_train(d, "w6_sgd", SGD12 + ["--steps", "6"], digest=True),
              _train(d, "w6_pbt", PBT, digest=True),
              _train(d, "w6_from_w1", SGD12 + ["--steps", "6",
                                               "--resume"])]
    _ok(torchrun(d, 6, jobs6 + serving(6), limit=400.0))
    for w in (1, 2, 3):
        _resume_copy(d / "w6_sgd", d / f"w{w}_from_w6", 1)
    jobs3 = [_train(d, f"w3_jax3_{k}", v + resume, digest=True)
             for k, v in CFG.items()]
    jobs3 += [_train(d, "w3_sgd", SGD12 + ["--steps", "6"], digest=True),
              _train(d, "w3_crash", SGD12 + ["--steps", "6"],
                     fail_hook=[1, 2], digest=True),
              _train(d, "w3_pbt", PBT, digest=True),
              _train(d, "w3_from_w6", SGD12 + ["--steps", "6",
                                               "--resume"]),
              {"kind": "serve", "out": str(d / "w3_serve_whole"),
               "argv": ["--ckpt-dir", str(d / "jax3" / "sgd12"),
                        "--sharded", *SERVE, "--batch", "16"]}]
    _ok(torchrun(d, 3, jobs3 + serving(3), limit=400.0))
    _ok(torchrun(d, 2, [_train(d, "w2_from_w6", SGD12 + [
        "--steps", "6", "--resume"])]))
    one["w1_from_w6"] = ttrain.main(BASE + PORT + SGD12 + [
        "--steps", "6", "--resume", "--ckpt-dir", str(d / "w1_from_w6")])
    for n in (3, 6):
        jck = str(d / f"jax{n}" / "sgd12")
        for tag, extra in (("f32", []),
                           ("int8", ["--weights-dtype", "int8"]),
                           ("bf16", ["--compute-dtype", "bfloat16"])):
            one[f"serve{n}_{tag}"] = tserve.main(["--ckpt-dir", jck,
                                                  *SERVE, *extra])
    one["serve3_whole"] = tserve.main([
        "--ckpt-dir", str(d / "jax3" / "sgd12"), *SERVE, "--batch", "16"])
    return d, one


def _ranks(d: Path, name: str, w: int) -> list:
    return [_result(d, name, r) for r in range(w)]


def _columns(w: int) -> list:
    """The data columns of W = 3 (3 × 1) and 6 (3 × 2), as rank lists."""
    model = 2 if w == 6 else 1
    return [list(range(j, w, model)) for j in range(model)]


def _launches_ok(res: dict):
    """Each segment of a rank: 2·(depth+1) launches a step of the rank's
    own depth, kernel by kernel."""
    for steps, depth, got in res["segments"]:
        want = {k: steps * v for k, v in fused_step_kernels(depth).items()}
        assert got == want, (steps, depth, got)


@pytest.mark.parametrize("w", [3, 6])
def test_each_rank_sits_at_jax_coordinates_with_its_groups(runs, w):
    d, _ = runs
    data, model = 3, w // 3
    for r, res in enumerate(_ranks(d, f"w{w}_sgd", w)):
        m = res["mesh"]
        assert m["shape"] == {"data": data, "model": model}
        assert m["coords"] == {"data": r // model, "model": r % model}
        assert m["row"] == (list(range(r - r % model, r - r % model
                                       + model)) if model > 1 else None)
        assert m["col"] == list(range(r % model, w, model))
    jax_mesh = json.loads((d / f"jax{w}" / "serve.json").read_text())
    assert jax_mesh["mesh"] == {"data": data, "model": model}


@pytest.mark.parametrize("name", sorted(CFG))
@pytest.mark.parametrize("w", [3, 6])
def test_resumes_jax_runs_and_follows_one_rank(runs, w, name):
    """W ranks resuming JAX's step-1 checkpoint land on JAX's step 3 and
    on W = 1's, within the tolerance; a data column's ranks hold the same
    bits after every chunk; each rank's loop is 2·(depth+1) a step."""
    d, one = runs
    run = f"w{w}_jax{w}_{name}"
    (jp, jlp), _ = _ckpt(d / f"jax{w}", name)
    (tp, tlp), meta = _ckpt(d, run)
    (op, olp), _ = _ckpt(d, f"w1_jax{w}_{name}")
    assert tlp == jlp == olp and jlp.n_pad == (2 if w == 6 else 0)
    assert meta["lifecycle"]["n_members0"] == 6
    np.testing.assert_allclose(_losses(tp, tlp), _losses(jp, jlp), **TRAJ)
    np.testing.assert_allclose(_losses(tp, tlp), _losses(op, olp), **TRAJ)
    _close(tp, op)
    if name.startswith("adafactor"):
        # adafactor keeps its momentum in bf16: JAX's order of a sum may
        # round one element one bf16 ulp the other way (lr·β·ulp in a
        # weight), and where the port on one rank lands beyond the
        # tolerance of JAX so may W ranks, no further than the tolerance
        # from W = 1 (held above)
        for x, y, z in zip(tree_leaves(tp), tree_leaves(jp),
                           tree_leaves(op)):
            far = ~torch.isclose(x, y, **TRAJ)
            assert not (far & torch.isclose(z, y, **TRAJ)).any()
    else:
        _close(tp, jp)
    ranks = _ranks(d, run, w)
    want = one[f"w1_jax{w}_{name}"][2]["chunk_loss"]
    got = ranks[0]["chunk_loss"]
    assert sorted(got) == sorted(str(k) for k in want)
    np.testing.assert_allclose([got[str(k)] for k in want],
                               list(want.values()), **TRAJ)
    for col in _columns(w):
        assert all(ranks[r]["digests"] == ranks[col[0]]["digests"]
                   for r in col)
    assert len(ranks[0]["digests"]) == 1            # one chunk of 2 steps
    for res in ranks:
        assert res["chunk_loss"] == got
        _launches_ok(res)
    if w == 6:
        assert ranks[0]["ranks"] == [list(r) for r in
                                     member_partition(jlp, 2)]


@pytest.mark.parametrize("w", [3, 6])
def test_fresh_runs_follow_one_rank(runs, w):
    """A fresh split-batch sgd run at W ranks against W = 1 (on W = 6's
    padded layout there: ``--shard-pad 2``): the real members and the
    per-chunk losses within the tolerance, every chunk's state the same
    bits down each data column and different across a model row."""
    d, one = runs
    twin = "w1_sgd" if w == 3 else "w1_sgd_p2"
    (pw, lpw), _ = _ckpt(d, f"w{w}_sgd")
    (p1, lp1), _ = _ckpt(d, twin)
    assert lpw == lp1
    _close(pw, p1)
    ranks = _ranks(d, f"w{w}_sgd", w)
    want = one[twin][2]["chunk_loss"]
    np.testing.assert_allclose(
        [ranks[0]["chunk_loss"][str(k)] for k in want], list(want.values()),
        **TRAJ)
    assert len(ranks[0]["digests"]) == 3
    for col in _columns(w):
        assert all(ranks[r]["digests"] == ranks[col[0]]["digests"]
                   for r in col)
    if w == 6:
        assert ranks[0]["digests"][0] != ranks[1]["digests"][0]
    for res in ranks:
        _launches_ok(res)


def test_crash_on_rank_2_replays_bitwise_the_unbroken_run(runs):
    d, _ = runs
    crash, clean = _ranks(d, "w3_crash", 3), _ranks(d, "w3_sgd", 3)
    assert [r["restarts"] for r in crash] == [1, 1, 1]
    # the replayed chunk appears twice; its second state is the clean one
    for a, b in zip(crash, clean):
        assert dict(a["digests"]) == dict(b["digests"])
    (pc, _), _ = _ckpt(d, "w3_crash")
    (pu, _), _ = _ckpt(d, "w3_sgd")
    _equal(pc, pu)
    for s in (1, 3, 5):
        a = np.load(d / "w3_crash" / f"step_{s:08d}" / "arrays.npz")
        b = np.load(d / "w3_sgd" / f"step_{s:08d}" / "arrays.npz")
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].tobytes() == b[k].tobytes(), (s, k)


@pytest.mark.parametrize("w", [3, 6])
def test_pbt_ladder_keeps_the_survivors_of_one_rank(runs, w):
    d, _ = runs
    (pw, lpw), mw = _ckpt(d, f"w{w}_pbt")
    (p1, lp1), m1 = _ckpt(d, "w1_pbt" if w == 3 else "w1_pbt_p2")
    l1, lw = m1["lifecycle"], mw["lifecycle"]
    assert l1["member_ids"] == lw["member_ids"] and l1["rung"] == 1
    assert l1["lineage"] == lw["lineage"] and l1["lr_vec"] == lw["lr_vec"]
    assert lpw == lp1
    _close(pw, p1)
    ranks = _ranks(d, f"w{w}_pbt", w)
    assert ranks[0]["rungs"] == [[6, 6]]
    for col in _columns(w):
        assert all(ranks[r]["digests"] == ranks[col[0]]["digests"]
                   for r in col)


@pytest.mark.parametrize("case", ["w6_to_w1", "w6_to_w2", "w6_to_w3",
                                  "w1_to_w6"])
def test_checkpoints_resume_across_worlds(runs, case):
    """A checkpoint written at one W continues at another from its step 1
    and lands within the tolerance of the run it left (its layout wins:
    W = 6's padded for a model axis of 2, W = 1's unpadded)."""
    d, one = runs
    src, dst = case.split("_to_")
    (pa, lpa), _ = _ckpt(d, f"{dst}_from_{src}")
    (pb, lpb), _ = _ckpt(d, f"{src}_sgd")
    assert lpa == lpb and lpa.n_pad == (2 if src == "w6" else 0)
    _close(pa, pb)
    if dst == "w1":
        assert one["w1_from_w6"][2]["steps"] == 4
    else:
        w = int(dst[1:])
        ranks = _ranks(d, f"{dst}_from_{src}", w)
        assert all(r["restarts"] == 0 for r in ranks)
        assert sorted(ranks[0]["chunk_loss"]) == ["3", "5"]


@pytest.mark.parametrize("tag", ["f32", "int8", "bf16"])
@pytest.mark.parametrize("w", [3, 6])
def test_sharded_serving_matches_one_rank_and_jax(runs, w, tag):
    d, one = runs
    name = f"w{w}_serve_{tag}"
    got = _result(d, name)
    want = one[f"serve{w}_{tag}"]
    lp = tckpt.layout_from_meta(
        tckpt.load_meta(str(d / f"jax{w}" / "sgd12"))[0])
    assert got["ranks"] == [list(r) for r in member_partition(lp, w // 3)]
    assert got["pred"] == want["pred"]
    assert [s for s, _ in got["board"]] == [r["slot"] for r in want["board"]]
    np.testing.assert_allclose([v for _, v in got["board"]],
                               [r["loss"] for r in want["board"]], **TRAJ)
    for r in range(w):
        res = _result(d, name, r)
        assert res["budget"]["launches"] == 3         # depth + 1 of a rank
        d_r = r // (w // 3)
        assert res["rows"] == [4 * d_r, 4 * d_r + 4]   # 12 rows over 3
        assert (res["pred"] is None) == (r > 0)
    if tag == "f32":
        jax_res = json.loads((d / f"jax{w}" / "serve.json").read_text())
        for mode in ("best1", "topk", "all"):
            assert got["pred"][mode] == jax_res[mode], mode
        assert [s for s, _ in got["board"]] == [s for s, _ in
                                                jax_res["board"]]
        np.testing.assert_allclose([v for _, v in got["board"]],
                                   [v for _, v in jax_res["board"]], **TRAJ)


def _flush_logits(ckpt: str, kw: dict, blocks: int) -> torch.Tensor:
    """One rank's logits of the worker's 12-row flush, served as
    ``blocks`` equal flushes through ``PopulationServer.flush_logits``."""
    k = 12 // blocks
    server, _ = tserve.PopulationServer.from_checkpoint(
        ckpt, device="cpu", batch=k, **kw)
    server._ensure_quantized()
    x = torch.randn(12, server.layout.in_features,
                    generator=torch.Generator().manual_seed(3))
    return torch.cat([server.flush_logits(server.params,
                                          x[i * k:(i + 1) * k])
                      for i in range(blocks)])


@pytest.mark.parametrize("tag", ["f32", "int8", "bf16"])
@pytest.mark.parametrize("w", [3, 6])
def test_split_flush_logits_match_one_rank(runs, w, tag):
    """A flush of 12 split over the data axis (4 rows a rank; at W = 6
    each rank's members of them) and gathered by rank 0: bitwise one
    rank's logits of the same three 4-row flushes, and within the
    tolerance of one rank's whole flush."""
    d, _ = runs
    got = torch.load(d / f"w{w}_serve_{tag}.logits.pt")
    ckpt = str(d / f"jax{w}" / "sgd12")
    assert [_result(d, f"w{w}_serve_{tag}", r)["logits"]
            for r in range(w)] == [True] + [False] * (w - 1)
    assert torch.equal(got, _flush_logits(ckpt, SERVE_KW[tag], 3))
    whole = _flush_logits(ckpt, SERVE_KW[tag], 1)
    np.testing.assert_allclose(got.float().numpy(), whole.float().numpy(),
                               **TRAJ)


def test_a_flush_the_data_axis_does_not_divide_runs_on_every_row(runs):
    d, one = runs
    want = one["serve3_whole"]
    for r in range(3):
        res = _result(d, "w3_serve_whole", r)
        assert res["rows"] == [0, 16] and res["budget"]["launches"] == 3
    got = _result(d, "w3_serve_whole")
    assert got["pred"] == want["pred"]
    np.testing.assert_allclose([v for _, v in got["board"]],
                               [r["loss"] for r in want["board"]], **TRAJ)
    assert got["pred"] == _result(d, "w3_serve_f32")["pred"]
