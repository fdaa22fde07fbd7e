"""The population axis across ranks end to end on the CPU: ``train.main``
and ``serve_population.main`` under ``torchrun`` with W = 2 and 4 gloo
ranks, against one rank and against the JAX package's trainer and server
on 4 devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4`` in a
subprocess, as tests/test_population_sharding.py runs it).

- The JAX trainer runs 4 steps under sgd, AdamW with ``--grad-clip`` and
  adafactor on 4 devices (6 members, shard-padded to 8), checkpointing at
  steps 1 and 3.  The port resumes its step-1 checkpoint at W = 2 (all
  three), W = 4 and W = 1 (AdamW) and lands within rtol 1e-5 / atol 1e-6
  of JAX's step 3 (the optimizer-trajectory tolerance,
  tests/test_population_optim.py): the parameters, and the per-member
  held-out losses.
- A fresh sgd run at W = 2 holds the real members to a W = 1 run and
  prints the same per-chunk losses, within the tolerance (the plain
  versions' sums may take another order on another layout's shapes; on
  the card the real members are bitwise, chip_smoke.py path 4k); a crash
  on rank 1 replays bitwise into the unbroken W = 2 run; ``--halving
  --refill pbt --per-member-lr`` keeps the same survivors and lineage as
  W = 1.
- AdamW with the clip, adafactor, and AdamW with the clip through a
  halving rung at W = 4 against W = 1 with ``--shard-pad 4`` (one rank
  following the 4-rank run, fillers included): within the tolerance, the
  same survivors.  A W = 2 checkpoint resumes at W = 1.
- ``serve_population --sharded`` at W = 2 over JAX's checkpoint, f32,
  int8 and bf16 compute, against one rank (predictions equal, the
  board's losses within the tolerance) and against JAX's server on its 4-device mesh
  (predictions equal, losses within the tolerance).
- A rank that raises inside a step fails the run within the process
  group's timeout.

Every multi-process run is a subprocess with a timeout; each rank uses one
thread; rendezvous on a free port (``torchrun --standalone``).
"""
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.core.lifecycle import compact_params
from repro_torch.core.selection import evaluate_population
from repro_torch.core.tree import tree_leaves
from repro_torch.data.synthetic import TabularTask
from repro_torch.distributed.sharding import member_partition
from repro_torch.launch import serve_population as tserve
from repro_torch.launch import train as ttrain

TRAJ = dict(rtol=1e-5, atol=1e-6)
SRC = str(Path(__file__).resolve().parents[1] / "src")
BASE = ["--arch", "parallelmlp-10k", "--reduced", "--batch", "8",
        "--samples", "128", "--scan-steps", "2", "--population-depths",
        "16,8;16,8;12,4;12,4;7;9", "--population-acts", "relu,tanh",
        "--ckpt-every", "2"]
OPT = {"sgd": ["--optimizer", "sgd"],
       "adamw": ["--optimizer", "adamw", "--weight-decay", "0.01",
                 "--grad-clip", "1.0"],
       "adafactor": ["--optimizer", "adafactor", "--weight-decay", "0.001"]}
PORT = ["--device", "cpu", "--bd-impl", "fused"]
SERVE = ["--requests", "40", "--batch", "16", "--calib-samples", "64",
         "--device", "cpu"]

_JAX4 = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from repro.compat import set_mesh
from repro.data.synthetic import TabularTask
from repro.launch.mesh import make_host_mesh
from repro.launch.serve_population import PopulationServer
from repro.launch.train import main
out, runs = sys.argv[1], json.loads(sys.argv[2])
assert len(jax.devices()) == 4
for name, argv in runs.items():
    main(argv + ["--ckpt-dir", os.path.join(out, name)])
mesh = make_host_mesh()
server, step = PopulationServer.from_checkpoint(
    os.path.join(out, "sgd"), mesh=mesh, batch=16, topk=4,
    bd_impl="einsum", act_impl="sliced")
lp = server.layout
task = TabularTask(64 + 40, lp.in_features, n_classes=lp.out_features,
                   seed=0)
(xc, yc), (xr, _) = task.split(frac=64 / (64 + 40))
res = {}
with set_mesh(mesh):
    board = server.publish(xc, yc)
    res["board"] = [[r["slot"], r["loss"]] for r in board]
    for mode in ("best1", "topk", "all"):
        res[mode] = np.asarray(server.run(xr[:40], mode)["pred"]).tolist()
with open(os.path.join(out, "serve.json"), "w") as f:
    json.dump(res, f)
print("OK")
"""

_WORKER = r"""
import faulthandler, gc, hashlib, json, os, sys
faulthandler.enable()      # a fatal signal prints every thread's stack
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch.core import deep
from repro_torch.core.tree import tree_leaves
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.launch import serve_population, train
from repro_torch.launch.mesh import close, make_host_mesh


def digest(state):
    h = hashlib.sha256()
    for t in tree_leaves(state):
        if isinstance(t, torch.Tensor):
            h.update(t.detach().cpu().reshape(-1).contiguous()
                     .view(torch.uint8).numpy())
        else:
            h.update(repr(t).encode())
    return h.hexdigest()


jobs = json.load(open(sys.argv[1]))
mesh = make_host_mesh(timeout_s=float(sys.argv[2]))   # kept for every job
rank = dist.get_rank()
# no name of this module may hold a group, or an object that holds one (a
# server: each job runs in run()): a group still referenced when close(mesh)
# destroys it keeps its gloo threads, which then abort the interpreter's
# exit now and then ("terminate called without an active exception")
where = {"shape": mesh.shape, "coords": mesh.coords,
         **{axis: None if g is None else dist.get_process_group_ranks(g)
            for axis, g in (("row", mesh.row_group),
                            ("col", mesh.col_group))}}
runner, chunk_maker = ft.TrainRunner, deep.make_population_train_step


def run(job):
    # one job: whatever it makes (a server holds the mesh's groups) dies
    # with this frame, before close(mesh)
    ft.TrainRunner, deep.make_population_train_step = runner, chunk_maker
    if "fail_hook" in job:        # a failure before a step: replayed
        at, who = job["fail_hook"]

        class Failing(runner):
            def __init__(self, *a, **k):
                done = []

                def hook(c):
                    if c == at and rank == who and not done:
                        done.append(c)
                        raise RuntimeError("injected failure")
                k["failure_hook"] = hook
                super().__init__(*a, **k)
        ft.TrainRunner = Failing
    if "fail_step" in job:        # a failure inside a step: fatal
        at, who = job["fail_step"]

        def failing_maker(*a, **k):
            chunk, calls = chunk_maker(*a, **k), []

            def wrapped(*args):
                calls.append(1)
                if rank == who and len(calls) == at:
                    raise RuntimeError("rank failed inside a step")
                return chunk(*args)
            return wrapped
        deep.make_population_train_step = failing_maker
    digests = []
    if job.get("digest"):         # this rank's state after every chunk
        inner = ft.TrainRunner

        class Digesting(inner):
            def __init__(self, step_fn, *a, **k):
                def step(state, c):
                    state, metrics = step_fn(state, c)
                    digests.append([c, digest(state)])
                    return state, metrics
                super().__init__(step, *a, **k)
        ft.TrainRunner = Digesting
    if job["kind"] == "train":
        _, lp, stats = train.main(job["argv"])
        res = {"chunk_loss": stats["chunk_loss"],
               "restarts": stats["restarts"],
               "ranks": stats.get("ranks"), "digests": digests,
               # (steps, this rank's depth, its launches) a segment
               "segments": [
                   [g["end"] - g["start"],
                    len(g["rank_fused_hidden"][mesh.pop_rank])
                    if "rank_fused_hidden" in g else g["depth"],
                    g["launches"]] for g in stats["segments"]],
               "rungs": [[r["members_before"], r["members"]]
                         for r in stats["rungs"]]}
    else:
        out = serve_population.main(job["argv"])
        res = {"pred": out.get("pred"), "ranks": out.get("ranks"),
               "budget": out["budget"], "rows": out.get("rows"),
               "board": [[r["slot"], r["loss"]] for r in out["board"]]}
        if "logits" in job:       # one flush through the server's path
            lg = job["logits"]
            server, _ = serve_population.PopulationServer.from_checkpoint(
                lg["ckpt"], device="cpu", mesh=mesh, batch=lg["rows"],
                **lg["kw"])
            server._ensure_quantized()
            x = torch.randn(lg["rows"], server.layout.in_features,
                            generator=torch.Generator().manual_seed(3))
            lo, hi = server.rows
            got = server.flush_logits(server.params, x[lo:hi])
            res["logits"] = got is not None       # rank 0's alone
            if got is not None:
                torch.save(got, f"{job['out']}.logits.pt")
    res["mesh"] = where
    with open(f"{job['out']}.{rank}.json", "w") as f:
        json.dump(res, f)


try:
    for job in jobs:
        run(job)
finally:
    gc.collect()          # a cycle that holds a group goes first
    close(mesh)
# the gloo threads still alive once the group is destroyed: 0 unless a
# reference to a group outlives close(mesh) (_ok holds every rank to 0)
tasks = "/proc/self/task"
left = sum("gloo" in open(f"{tasks}/{t}/comm").read()
           for t in os.listdir(tasks))
print("WORKER OK", rank, "gloo threads", left)
"""


def _env():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC] + os.environ.get("PYTHONPATH", "").split(os.pathsep)),
        OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    return env


def torchrun(tmp: Path, n: int, jobs: list, timeout_s: float = 60.0,
             limit: float = 240.0):
    """Run ``jobs`` in one ``torchrun`` job of ``n`` ranks → the
    subprocess's result, with ``logs``: the directory each rank's stdout
    and stderr are written to (``--log-dir``, ``--tee 3``).  A job still
    running after ``limit`` seconds is killed with its ranks (its own
    process group) and fails the test with the ranks' logs, naming the
    limit: torchrun's own ``subprocess.TimeoutExpired`` left the ranks
    running and showed neither."""
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    tag = f"{n}-{len(list(tmp.iterdir()))}"
    spec = tmp / f"jobs{tag}.json"
    spec.write_text(json.dumps(jobs))
    logs = tmp / f"logs{tag}"
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(n), "--log-dir", str(logs), "--tee", "3",
         str(script), str(spec), str(timeout_s)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(), start_new_session=True)
    t0 = time.monotonic()
    try:
        out, err = proc.communicate(timeout=limit)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        files = _rank_logs(logs)
        text = "".join(f"\n---- rank {k} stderr ----\n"
                       f"{files[k].read_text(errors='replace')[-3000:]}"
                       for k in sorted(files))
        pytest.fail(f"torchrun of {n} ranks ({len(jobs)} jobs) passed its "
                    f"limit of {limit} s (gloo timeout {timeout_s} s) after "
                    f"{time.monotonic() - t0:.0f} s{text}\n---- torchrun "
                    f"stderr (end) ----\n{err[-3000:]}", pytrace=False)
    r = subprocess.CompletedProcess(proc.args, proc.returncode, out, err)
    r.logs = logs
    return r


def _rank_logs(logs: Path) -> dict:
    """rank → its stderr file, of a ``torchrun`` job's ``--log-dir``."""
    return {int(p.parent.name): p for p in logs.rglob("stderr.log")}


def _ok(r):
    """Fail with the job's failing rank's whole stderr first (torchrun's
    root cause: the first rank to fail), then every other rank's, then
    the end of torchrun's own.  A job that exits 0 must have left no gloo
    thread alive on any rank after closing its mesh: a group kept alive
    past ``destroy_process_group`` (by a name, or an object, still
    holding it) takes its
    threads into the interpreter's exit, where they abort it now and then
    ("terminate called without an active exception")."""
    if r.returncode == 0:
        left = re.findall(r"WORKER OK (\d+) gloo threads (\d+)", r.stdout)
        assert all(n == "0" for _, n in left), \
            f"gloo threads alive at a worker's exit (rank, threads): {left}"
        return
    files = _rank_logs(r.logs)
    m = re.search(r"Root Cause.*?rank\s*:\s*(\d+)", r.stderr, re.S)
    first = int(m.group(1)) if m else None
    order = ([first] if first in files else []) + sorted(
        k for k in files if k != first)
    text = "".join(f"\n---- rank {k} stderr ({files[k]}) ----\n"
                   f"{files[k].read_text(errors='replace')}" for k in order)
    pytest.fail(f"torchrun exited {r.returncode}; first failure: rank "
                f"{first}{text}\n---- torchrun stderr (end) ----\n"
                f"{r.stderr[-4000:]}", pytrace=False)


def _train(d: Path, name: str, argv: list, **extra):
    return {"kind": "train", "out": str(d / name),
            "argv": BASE + PORT + argv + ["--ckpt-dir", str(d / name)],
            **extra}


def _resume_copy(src: Path, dst: Path, step: int) -> Path:
    """A copy of checkpoint directory ``src`` holding steps ≤ ``step``."""
    shutil.copytree(src, dst)
    for s in tckpt.latest_steps(str(dst)):
        if s > step:
            shutil.rmtree(dst / f"step_{s:08d}")
    return dst


@pytest.fixture(scope="module")
def jax4(tmp_path_factory):
    """The JAX runs on 4 devices, and copies of their step-1 checkpoints
    for the port to resume."""
    d = tmp_path_factory.mktemp("dist")
    jax_runs = {k: BASE + v + ["--steps", "4", "--pipeline", "off"]
                for k, v in OPT.items()}
    r = subprocess.run([sys.executable, "-c", _JAX4, str(d / "jax"),
                        json.dumps(jax_runs)], capture_output=True,
                       text=True, env=_env(), timeout=600)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-4000:]
    for k in OPT:
        for w in ("w1", "w2", "w4"):
            _resume_copy(d / "jax" / k, d / f"{w}_jax_{k}", 1)
    return d


# the W = 2 jobs' gloo timeout: the longest stretch between two
# collectives (a rank's start-up before its rendezvous, a save's gather, a
# server's publish) takes a few seconds alone and many times that beside
# six busy test workers
W2_GLOO_TIMEOUT_S = 180.0


@pytest.fixture(scope="module")
def w2(jax4):
    """The port's jobs at W = 2 and the one-rank runs they are held to:
    three ``torchrun`` jobs of three (JAX's checkpoints resumed; the fresh,
    crashed and pbt runs; the three servers), each within its own limit."""
    d = jax4
    jck = str(d / "jax" / "sgd")
    resumes = [_train(d, f"w2_jax_{k}", v + ["--steps", "4", "--resume"])
               for k, v in OPT.items()]
    fresh = [
        _train(d, "w2_sgd", OPT["sgd"] + ["--steps", "6"]),
        _train(d, "w2_crash", OPT["sgd"] + ["--steps", "6"],
               fail_hook=[1, 1]),
        _train(d, "w2_pbt", OPT["sgd"] + [
            "--steps", "6", "--halving", "2:0.5", "--refill", "pbt",
            "--per-member-lr"])]
    serves = [
        {"kind": "serve", "out": str(d / "w2_serve"),
         "argv": ["--ckpt-dir", jck, "--sharded", *SERVE]},
        {"kind": "serve", "out": str(d / "w2_serve8"),
         "argv": ["--ckpt-dir", jck, "--sharded", "--weights-dtype", "int8",
                  *SERVE]},
        {"kind": "serve", "out": str(d / "w2_serve16"),
         "argv": ["--ckpt-dir", jck, "--sharded", "--compute-dtype",
                  "bfloat16", *SERVE]}]
    for jobs in (resumes, fresh, serves):
        _ok(torchrun(d, 2, jobs, timeout_s=W2_GLOO_TIMEOUT_S))
    one = {}
    for name, argv in (
            ("w1_sgd", OPT["sgd"] + ["--steps", "6"]),
            ("w1_pbt", OPT["sgd"] + ["--steps", "6", "--halving", "2:0.5",
                                     "--refill", "pbt", "--per-member-lr"]),
            ("w1_jax_adamw", OPT["adamw"] + ["--steps", "4", "--resume"])):
        one[name] = ttrain.main(BASE + PORT + argv
                                + ["--ckpt-dir", str(d / name)])
    _resume_copy(d / "w2_sgd", d / "w1_from_w2", 1)
    one["w1_from_w2"] = ttrain.main(BASE + PORT + OPT["sgd"] + [
        "--steps", "6", "--resume", "--ckpt-dir", str(d / "w1_from_w2")])
    for tag, extra in (("f32", []), ("int8", ["--weights-dtype", "int8"]),
                       ("bf16", ["--compute-dtype", "bfloat16"])):
        one[f"serve_{tag}"] = tserve.main(["--ckpt-dir", jck, *SERVE,
                                           *extra])
    return d, one


CLIP_HALVING = OPT["adamw"] + ["--steps", "6", "--halving", "2:0.5"]


@pytest.fixture(scope="module")
def w4(jax4):
    """The port's jobs at W = 4 and the one-rank runs on the same padded
    layout they are held to."""
    d = jax4
    jobs4 = [_train(d, "w4_jax_adamw", OPT["adamw"] + ["--steps", "4",
                                                       "--resume"]),
             _train(d, "w4_adamw", OPT["adamw"] + ["--steps", "4"]),
             _train(d, "w4_adafactor", OPT["adafactor"] + ["--steps", "4"]),
             _train(d, "w4_halving", CLIP_HALVING)]
    _ok(torchrun(d, 4, jobs4))
    for name, argv in (
            ("w1_adamw", OPT["adamw"] + ["--steps", "4", "--shard-pad",
                                         "4"]),
            ("w1_adafactor", OPT["adafactor"] + ["--steps", "4",
                                                 "--shard-pad", "4"]),
            ("w1_halving", CLIP_HALVING + ["--shard-pad", "4"])):
        ttrain.main(BASE + PORT + argv + ["--ckpt-dir", str(d / name)])
    return d


def _ckpt(d: Path, name: str):
    meta, _ = tckpt.load_meta(str(d / name))
    return tckpt.restore_population(str(d / name), device="cpu")[:2], meta


def _result(d: Path, name: str, rank: int = 0) -> dict:
    return json.loads((d / f"{name}.{rank}.json").read_text())


def _real(params, lp):
    """The real members' tree of a (possibly padded) layout."""
    if not lp.n_pad:
        return params, lp
    real = lp.subset(range(lp.num_real))
    return compact_params(lp, real, params, range(lp.num_real)), real


def _losses(params, lp):
    task = TabularTask(128, lp.in_features, n_classes=lp.out_features,
                       seed=0)
    (_, _), (xte, yte) = task.split()
    losses, _ = evaluate_population(params, lp, xte, yte)
    return losses[:lp.num_real].numpy()


def _close(a, b, **tol):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), **(tol or TRAJ))


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


@pytest.mark.parametrize("name", sorted(OPT))
def test_w2_resumes_jax_4_device_runs(w2, name):
    d, _ = w2
    (jp, jlp), _ = _ckpt(d / "jax", name)
    (tp, tlp), meta = _ckpt(d, f"w2_jax_{name}")
    assert tlp == jlp and jlp.n_pad == 2
    assert meta["lifecycle"]["n_members0"] == 6
    np.testing.assert_allclose(_losses(tp, tlp), _losses(jp, jlp), **TRAJ)
    if name != "adafactor":
        # adafactor keeps its momentum in bf16: a reordered sum may round
        # one element one bf16 ulp the other way (lr·β·ulp in a weight)
        _close(tp, jp)
    assert _result(d, f"w2_jax_{name}")["ranks"] == [
        list(r) for r in member_partition(jlp, 2)]


@pytest.mark.parametrize("world", ["w1", "w4"])
def test_jax_padded_checkpoint_resumes_at_w1_and_w4(request, world):
    # W = 1's run is one of the W = 2 job's one-rank twins
    d = (request.getfixturevalue("w2")[0] if world == "w1"
         else request.getfixturevalue("w4"))
    (jp, jlp), _ = _ckpt(d / "jax", "adamw")
    (tp, tlp), _ = _ckpt(d, f"{world}_jax_adamw")
    assert tlp == jlp
    _close(tp, jp)
    np.testing.assert_allclose(_losses(tp, tlp), _losses(jp, jlp), **TRAJ)


def test_w2_real_members_follow_w1(w2):
    """On the CPU every kernel runs its plain version, whose sums (BLAS,
    torch reductions) may take another order on another layout's shapes:
    the real members are held to the tolerance here (bit for bit on the
    card: chip_smoke.py path 4k)."""
    d, one = w2
    (p2, lp2), _ = _ckpt(d, "w2_sgd")
    (p1, lp1), _ = _ckpt(d, "w1_sgd")
    assert lp2.n_pad == 2 and lp1.n_pad == 0
    real, lp_real = _real(p2, lp2)
    assert lp_real == lp1
    _close(real, p1)
    got = _result(d, "w2_sgd")
    want = one["w1_sgd"][2]["chunk_loss"]
    assert sorted(got["chunk_loss"]) == sorted(str(k) for k in want)
    np.testing.assert_allclose([got["chunk_loss"][str(k)] for k in want],
                               list(want.values()), **TRAJ)
    assert _result(d, "w2_sgd", 1)["chunk_loss"] == got["chunk_loss"]


def test_crash_replay_on_one_rank_is_bitwise_the_unbroken_run(w2):
    d, _ = w2
    assert [_result(d, "w2_crash", r)["restarts"] for r in (0, 1)] == [1, 1]
    (pc, _), _ = _ckpt(d, "w2_crash")
    (pu, _), _ = _ckpt(d, "w2_sgd")
    _equal(pc, pu)
    for s in (1, 3, 5):
        a = np.load(d / "w2_crash" / f"step_{s:08d}" / "arrays.npz")
        b = np.load(d / "w2_sgd" / f"step_{s:08d}" / "arrays.npz")
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].tobytes() == b[k].tobytes(), (s, k)


def test_pbt_ladder_keeps_the_survivors_of_one_rank(w2):
    d, _ = w2
    (p2, lp2), m2 = _ckpt(d, "w2_pbt")
    (p1, lp1), m1 = _ckpt(d, "w1_pbt")
    l1, l2 = m1["lifecycle"], m2["lifecycle"]
    assert l1["member_ids"] == l2["member_ids"] and l1["rung"] == 1
    assert l1["lineage"] == l2["lineage"] and l1["lr_vec"] == l2["lr_vec"]
    real, _ = _real(p2, lp2)
    _close(real, p1)
    assert _result(d, "w2_pbt")["rungs"] == [[6, 6]]


@pytest.mark.parametrize("name", ["adamw", "adafactor", "halving"])
def test_w4_follows_w1_on_the_same_padded_layout(w4, name):
    d = w4
    (p4, lp4), m4 = _ckpt(d, f"w4_{name}")
    (p1, lp1), m1 = _ckpt(d, f"w1_{name}")
    assert lp4 == lp1 and lp4.n_pad > 0
    assert m4["lifecycle"]["member_ids"] == m1["lifecycle"]["member_ids"]
    np.testing.assert_allclose(_losses(p4, lp4), _losses(p1, lp1), **TRAJ)
    if name != "adafactor":
        _close(p4, p1)
    if name == "halving":
        assert _result(d, "w4_halving")["rungs"] == [[6, 3]]
        assert lp4.num_real == 3 and lp4.num_members == 4


def test_a_w2_checkpoint_resumes_at_w1(w2):
    d, one = w2
    (pa, lpa), _ = _ckpt(d, "w1_from_w2")
    (pb, lpb), _ = _ckpt(d, "w2_sgd")
    assert lpa == lpb and lpa.n_pad == 2
    _equal(pa, pb)
    assert one["w1_from_w2"][2]["steps"] == 4


@pytest.mark.parametrize("tag", ["f32", "int8", "bf16"])
def test_sharded_serving_matches_one_rank_and_jax(w2, tag):
    d, one = w2
    name = {"f32": "w2_serve", "int8": "w2_serve8",
            "bf16": "w2_serve16"}[tag]
    got = _result(d, name)
    want = one[f"serve_{tag}"]
    lp = tckpt.layout_from_meta(tckpt.load_meta(str(d / "jax" / "sgd"))[0])
    assert got["ranks"] == [list(r) for r in member_partition(lp, 2)]
    assert got["pred"] == want["pred"]
    assert [s for s, _ in got["board"]] == [r["slot"] for r in want["board"]]
    np.testing.assert_allclose([v for _, v in got["board"]],
                               [r["loss"] for r in want["board"]], **TRAJ)
    assert got["budget"]["launches"] == 3         # depth + 1 of a rank
    assert _result(d, name, 1)["pred"] is None
    if tag == "f32":
        jax_res = json.loads((d / "jax" / "serve.json").read_text())
        for mode in ("best1", "topk", "all"):
            assert got["pred"][mode] == jax_res[mode], mode
        assert [s for s, _ in got["board"]] == [s for s, _ in
                                                jax_res["board"]]
        np.testing.assert_allclose([v for _, v in got["board"]],
                                   [v for _, v in jax_res["board"]], **TRAJ)


def test_a_rank_that_raises_fails_the_run_within_its_timeout(tmp_path):
    job = _train(tmp_path, "fail", OPT["sgd"] + ["--steps", "8",
                                                "--dist-timeout", "15"],
                 fail_step=[2, 1])
    t0 = time.monotonic()
    r = torchrun(tmp_path, 2, [job], timeout_s=15.0, limit=120.0)
    assert r.returncode != 0
    assert time.monotonic() - t0 < 90.0
    assert "rank failed inside a step" in r.stderr + r.stdout
