"""The port's streaming data plane (``repro_torch.data.pipeline``) against
the JAX package's (``repro.data.pipeline``), on the CPU.

- The generic part's unit semantics (JAX's tests/test_pipeline.py and the
  signature-gated retarget of tests/test_refill.py), run on both packages'
  classes with the same ``produce`` functions: order, backpressure, a
  blocked put woken within 10 ms, seek, retarget, ``PrefetchError``
  messages and chaining, ``close`` unblocking a full queue, ``depth=0``
  refused, ``DeferredMetrics`` laziness.
- The torch part on the CPU: the slab a producer hands over is a snapshot,
  so a consumer three chunks behind still reads untouched slabs.
- ``train.main --pipeline on`` bitwise ``--pipeline off`` (parameters,
  optimizer state, checkpoint arrays, printed losses, kernel launches)
  under sgd, momentum and adafactor with ``--halving``, ``--refill pbt``
  and the unfused route; within rtol 1e-5 / atol 1e-6 of the JAX
  trainer's pipelined run (the optimizer-trajectory tolerance,
  tests/test_population_optim.py); no producer thread alive after
  ``main`` returns or raises.
- A ``TrainRunner`` crash replay whose steps read a ``Prefetcher``,
  bitwise the unbroken run.

Every blocking ``get`` takes a timeout of 10 s or less.  The two ``gpu``
cases (pinned staging and a side-stream copy; the crash replay on the
card) skip without a card; this module imports JAX only inside the tests
that compare with it, so on a machine without JAX run them with

    PYTHONPATH=src python -m pytest --noconftest -m gpu \\
        tests/test_torch_pipeline.py
"""
import importlib
import os
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core.tree import tree_leaves
from repro_torch.data import pipeline as tpl

T = 10.0          # every blocking get's timeout, in seconds


@pytest.fixture(params=["jax", "port"])
def pl(request):
    """The data plane's module of either package."""
    return importlib.import_module({"jax": "repro.data.pipeline",
                                    "port": "repro_torch.data.pipeline"}[
        request.param])


# --------------------------------------------------------------------- #
# Prefetcher and DeferredMetrics: the JAX package's unit semantics      #
# --------------------------------------------------------------------- #

def test_prefetcher_orders_and_matches_sync(pl):
    made = []

    def produce(c, staging):
        made.append(c)
        return c * 10

    with pl.Prefetcher(produce, 8) as pf:
        got = [pf.get(c, timeout=T) for c in range(8)]
    assert got == [c * 10 for c in range(8)]
    assert made == list(range(8))


def test_prefetcher_get_past_end_raises(pl):
    with pl.Prefetcher(lambda c, s: c, 3) as pf:
        for c in range(3):
            pf.get(c, timeout=T)
        with pytest.raises(pl.PrefetchError, match="past the end"):
            pf.get(3, timeout=T)


def test_prefetcher_backpressure_bounded(pl):
    """At most ``depth`` slabs queued ahead of the consumer, plus one build
    in flight."""
    made = []

    def produce(c, staging):
        made.append(c)
        return c

    with pl.Prefetcher(produce, 100, depth=2) as pf:
        deadline = time.monotonic() + 5.0
        while len(made) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.1)
        assert max(made) <= 3
        pf.get(0, timeout=T)
        pf.get(1, timeout=T)
        deadline = time.monotonic() + 5.0
        while len(made) < 5 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert max(made) <= 5


def test_prefetcher_staging_alternates(pl):
    seen = []

    def produce(c, staging):
        seen.append(id(staging))
        return c

    with pl.Prefetcher(produce, 6, make_staging=lambda: [0]) as pf:
        for c in range(6):
            pf.get(c, timeout=T)
    assert len(set(seen)) == 2
    assert all(a != b for a, b in zip(seen, seen[1:]))


def test_prefetcher_out_of_order_get_seeks(pl):
    with pl.Prefetcher(lambda c, s: c * 10, 10) as pf:
        assert [pf.get(c, timeout=T) for c in (0, 1, 0, 1, 5, 6)] == [
            0, 10, 0, 10, 50, 60]


def test_prefetcher_producer_exception_surfaces_and_close_never_hangs(pl):
    def produce(c, staging):
        if c == 2:
            raise RuntimeError("disk on fire")
        return c

    pf = pl.Prefetcher(produce, 8, name="prefetch")
    assert pf.get(0, timeout=T) == 0
    assert pf.get(1, timeout=T) == 1
    with pytest.raises(pl.PrefetchError) as ei:
        pf.get(2, timeout=T)
    assert str(ei.value) == ("prefetch: producer thread failed while "
                             "building a batch slab: "
                             "RuntimeError('disk on fire')")
    assert isinstance(ei.value.__cause__, RuntimeError)
    t0 = time.monotonic()
    pf.close()
    pf.close()
    assert time.monotonic() - t0 < 5.0


def test_prefetcher_close_unblocks_full_queue(pl):
    pf = pl.Prefetcher(lambda c, s: np.zeros(4), 1000, depth=1,
                       name="prefetch-full")
    time.sleep(0.1)                 # the producer fills the queue, blocks
    t0 = time.monotonic()
    pf.close()
    assert time.monotonic() - t0 < 5.0
    assert not any(t.name == "prefetch-full" for t in threading.enumerate())


def test_prefetcher_blocked_put_wakes_fast_after_get(pl):
    """A producer blocked on the full queue resumes within 10 ms of the
    consumer's get: a condition-variable hand-off, not a poll.  The
    hand-off is tried up to 5 times and the test passes on the first that
    wakes within the bound: on a loaded machine the scheduler can only
    add latency to a wake-up, so one fast wake-up shows the hand-off,
    while a poll every 10 ms or more would miss the bound every time."""
    produced = {}

    def produce(c, staging):
        produced[c] = time.perf_counter()
        return c

    def wait_for(c):
        deadline = time.monotonic() + 5.0
        while c not in produced and time.monotonic() < deadline:
            time.sleep(0.001)
        assert c in produced

    pf = pl.Prefetcher(produce, 8, depth=1)
    try:
        wakes = []
        for k in range(5):
            # chunk k is queued, chunk k+1 built and blocked on the put
            wait_for(k + 1)
            time.sleep(0.05)
            assert k + 2 not in produced
            t_get = time.perf_counter()
            assert pf.get(k, timeout=T) == k
            wait_for(k + 2)
            wakes.append(produced[k + 2] - t_get)
            if wakes[-1] < 0.010:
                break
        assert min(wakes) < 0.010, wakes
    finally:
        pf.close()


def test_prefetcher_retarget_switches_source(pl):
    pf = pl.Prefetcher(lambda c, s: ("old", c), 100)
    assert pf.get(0, timeout=T) == ("old", 0)
    pf.retarget(lambda c, s: ("new", c), 4, start=0)
    assert [pf.get(c, timeout=T) for c in range(4)] == [("new", c)
                                                      for c in range(4)]
    with pytest.raises(pl.PrefetchError, match="past the end"):
        pf.get(4, timeout=T)
    pf.close()


def test_prefetcher_rejects_bad_depth(pl):
    with pytest.raises(ValueError, match="depth must be >= 1, got 0"):
        pl.Prefetcher(lambda c, s: c, 4, depth=0)


def test_deferred_metrics_lazy_and_cached(pl):
    calls = []

    def resolve():
        calls.append(1)
        return {"loss": 0.5, "step": 7}

    m = pl.DeferredMetrics(resolve)
    assert not m.resolved and not calls
    assert repr(m) == "DeferredMetrics(<unresolved>)"
    assert m["loss"] == 0.5
    assert m.resolved and len(calls) == 1
    assert dict(m) == {"loss": 0.5, "step": 7}
    assert len(m) == 2 and "step" in m
    assert len(calls) == 1
    assert "0.5" in repr(m)


def test_retarget_keeps_staging_on_matching_signature(pl):
    def make_staging():
        return (np.empty((2, 4, 3), np.float32), np.empty((2, 4), np.int32))

    def produce(c, staging):
        sx, sy = staging
        sx[...] = c
        return np.array(sx)

    pf = pl.Prefetcher(produce, 4, make_staging=make_staging)
    ids0 = tuple(id(a) for a in pf._staging[0] + pf._staging[1])
    assert pf.get(0, timeout=T)[0, 0, 0] == 0
    sig = pl.staging_signature(make_staging())
    pf.retarget(produce, 4, make_staging=make_staging, signature=sig)
    assert tuple(id(a) for a in pf._staging[0] + pf._staging[1]) == ids0
    assert pf.get(0, timeout=T)[0, 0, 0] == 0
    pf.close()


def test_retarget_rebuilds_staging_on_mismatch_or_none(pl):
    def make_a():
        return np.empty((2, 4), np.float32)

    def make_b():
        return np.empty((2, 3), np.float32)

    def produce(c, staging):
        staging[...] = c
        return np.array(staging)

    pf = pl.Prefetcher(produce, 4, make_staging=make_a)
    ids0 = tuple(id(a) for a in pf._staging)
    pf.retarget(produce, 4, make_staging=make_b,
                signature=(((2, 3), np.dtype(np.float32).str),))
    assert tuple(id(a) for a in pf._staging) != ids0
    assert pf.get(0, timeout=T).shape == (2, 3)
    ids1 = tuple(id(a) for a in pf._staging)
    pf.retarget(produce, 4, make_staging=make_b)
    assert tuple(id(a) for a in pf._staging) != ids1
    pf.close()


def test_staging_signature_of_torch_tensors_is_numpys():
    """A torch staging buffer's signature is that of numpy arrays of the
    same shapes and dtypes, so a signature built by hand matches it."""
    t = (torch.empty(8, 4, 3), torch.empty(8, 4, dtype=torch.int32))
    a = (np.empty((8, 4, 3), np.float32), np.empty((8, 4), np.int32))
    sig = tpl.staging_signature(t)
    assert sig == tpl.staging_signature(a) == (
        ((8, 4, 3), "<f4"), ((8, 4), "<i4"))


# --------------------------------------------------------------------- #
# the torch part on the CPU: snapshots, never the staging buffer        #
# --------------------------------------------------------------------- #

def _specs(rows=3):
    return (((rows, 4), np.float32), ((rows,), np.int32))


def _fill(c):
    def fill(x, y):
        x[...] = c
        y[...] = -c
    return fill


def test_cpu_slabs_survive_a_consumer_three_chunks_behind():
    """The producer rebuilds each staging buffer two chunks later; a
    consumer that holds chunk c's slab until chunk c+3 is built still
    reads chunk c's values, because the CPU slab is a clone.  Handing the
    staging views over instead (what ``.to("cpu")`` would do) shows the
    hazard."""
    stager = tpl.SlabStager("cpu")
    pf = tpl.Prefetcher(lambda c, s: stager.stage(s, 2 + c % 2, _fill(c)),
                        8, make_staging=lambda: stager.staging(_specs()))
    held = []
    for c in range(8):
        held.append(pf.get(c, timeout=T))
        if c >= 3:
            x, y = held[c - 3].take()
            assert x.shape == (2 + (c - 3) % 2, 4)
            assert bool((x == c - 3).all()) and bool((y == 3 - c).all())
    pf.close()
    assert stager.made == 2 and stager.pinned == [False] * 4

    aliased = tpl.Prefetcher(
        lambda c, s: (_fill(c)(s[0].numpy(), s[1].numpy()), s[0])[1], 4,
        make_staging=lambda: stager.staging(_specs()))
    first = aliased.get(0, timeout=T)
    for c in range(1, 4):
        aliased.get(c, timeout=T)
    aliased.close()
    assert bool((first == 2).all())        # chunk 2 wrote chunk 0's buffer


def test_cpu_stage_snapshot_and_rows():
    stager = tpl.SlabStager("cpu")
    st = stager.staging(_specs(4))
    slab = stager.stage(st, 2, _fill(7))
    x, y = slab.take()
    assert slab.event is None
    assert x.shape == (2, 4) and y.dtype == torch.int32
    assert x.data_ptr() != st[0].data_ptr()
    st[0].zero_()
    assert bool((x == 7).all()) and bool((y == -7).all())


# --------------------------------------------------------------------- #
# the trainer: --pipeline on is bitwise --pipeline off                  #
# --------------------------------------------------------------------- #

DRIVE = ["--arch", "parallelmlp-10k", "--reduced", "--steps", "8",
         "--ckpt-every", "4", "--population-depths", "8,4;8,4;6;5",
         "--population-acts", "relu,tanh", "--scan-steps", "2",
         "--samples", "256"]


def _port(tmp_path, tag, pipeline, extra=()):
    """The port's trainer on the CPU, the kernel counters read around it:
    (params, layout, stats, launches, printed loss lines)."""
    import contextlib
    import io

    from repro_torch.launch import train as ttrain
    from repro_torch.launch.launch_count import (kernel_launches,
                                                 reset_kernel_launches)
    reset_kernel_launches()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        params, lp, stats = ttrain.main(
            DRIVE + ["--ckpt-dir", str(tmp_path / tag), "--device", "cpu",
                     "--pipeline", "on" if pipeline else "off", *extra])
    lines = [ln for ln in out.getvalue().splitlines()
             if "mean member loss" in ln or ln.startswith("rung ")]
    return params, lp, stats, kernel_launches(), lines


def _final_arrays(directory):
    from repro_torch.checkpoint import checkpoint as tckpt
    step = tckpt.latest_steps(str(directory))[-1]
    return np.load(os.path.join(str(directory), f"step_{step:08d}",
                                "arrays.npz"))


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "prefetch"
            and t.is_alive()]


@pytest.mark.parametrize("extra", [
    [],
    ["--optimizer", "momentum", "--halving", "2:0.5,4:0.5"],
    ["--optimizer", "adafactor", "--weight-decay", "0.001", "--halving",
     "2:0.5,4:0.5"],
    ["--halving", "4:0.5", "--refill", "pbt"],
    ["--bd-impl", "pallas", "--act-impl", "pallas"],
], ids=["sgd", "momentum-halving", "adafactor-halving", "refill-pbt",
        "unfused"])
def test_pipeline_on_is_bitwise_off(tmp_path, extra):
    """Parameters, the final checkpoint's arrays (the optimizer state
    among them), every printed loss and rung line, the per-chunk losses,
    the stats' losses and grad norm and the kernel launches: identical.
    The pipelined run allocates its two staging buffers once (a pbt rung
    keeps them), the synchronous run one a segment."""
    pa, lpa, sa, na, la = _port(tmp_path, "on", True, extra)
    assert not _prefetch_threads()
    pb, lpb, sb, nb, lb = _port(tmp_path, "off", False, extra)
    assert lpa == lpb
    for a, b in zip(tree_leaves(pa), tree_leaves(pb)):
        assert torch.equal(a, b)
    za, zb = _final_arrays(tmp_path / "on"), _final_arrays(tmp_path / "off")
    assert sorted(za.files) == sorted(zb.files)
    if "--optimizer" in extra:
        assert any(k.startswith("extra/") for k in za.files)
    for k in za.files:
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    assert la == lb and la
    assert na == nb
    for key in ("first_loss", "last_loss", "chunk_loss", "member_steps"):
        assert sa[key] == sb[key], key
    assert len(sa["chunk_loss"]) == 4 and sa["restarts"] == 0
    assert sa["staging"]["made"] == 2
    assert sb["staging"]["made"] == len(sb["segments"])


def test_pipeline_matches_the_jax_trainer(tmp_path):
    """JAX's tests/test_pipeline.py run (``_drive``: pipelined by default)
    to step 8; the port resumes its step-3 checkpoint (the two packages
    draw other initial weights) and runs the last 4 steps pipelined on the
    CPU: the same layout, parameters within the optimizer tolerance, and
    the same final state with ``--pipeline off``."""
    import shutil

    import jax

    from repro.launch import train as jtrain
    jp, jlp = jtrain.main(DRIVE + ["--ckpt-dir", str(tmp_path / "jax")])
    for tag in ("on", "off"):
        shutil.copytree(tmp_path / "jax", tmp_path / tag)
        shutil.rmtree(tmp_path / tag / "step_00000007")
    got = {}
    for tag in ("on", "off"):
        got[tag] = _port(tmp_path, tag, tag == "on", ["--resume"])
        assert got[tag][2]["steps"] == 4
    tp, tlp = got["on"][:2]
    assert tlp.describe() == jlp.describe()
    gl, wl = tree_leaves(tp), jax.tree.leaves(jax.device_get(jp))
    assert len(gl) == len(wl)
    for i, (a, b) in enumerate(zip(gl, wl)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6, err_msg=f"leaf {i}")
    for a, b in zip(gl, tree_leaves(got["off"][0])):
        assert torch.equal(a, b)


def test_producer_failure_raises_through_main_and_leaves_no_thread(
        tmp_path, monkeypatch):
    """A producer that fails surfaces on the training thread as a
    ``PrefetchError`` (chained to the failure) every time the runner
    replays, until its restarts run out; ``main`` raises and leaves no
    producer thread behind.  Nothing falls back to the synchronous loop."""
    from repro_torch.data.synthetic import TabularTask
    from repro_torch.launch import train as ttrain
    real = TabularTask.batch_slab

    def broken(self, start, n_steps, batch_size, out=None):
        if start >= 4:
            raise OSError("staging source gone")
        return real(self, start, n_steps, batch_size, out=out)

    monkeypatch.setattr(TabularTask, "batch_slab", broken)
    with pytest.raises(RuntimeError, match="exceeded 3 restarts") as ei:
        ttrain.main(DRIVE + ["--ckpt-dir", str(tmp_path / "ck"), "--device",
                             "cpu"])
    assert isinstance(ei.value.__cause__, tpl.PrefetchError)
    assert isinstance(ei.value.__cause__.__cause__, OSError)
    assert not _prefetch_threads()


# --------------------------------------------------------------------- #
# crash replay through a Prefetcher                                     #
# --------------------------------------------------------------------- #

def _replay_runs(tmp_path, device):
    """A ``TrainRunner`` whose steps read their batches from a
    ``Prefetcher`` over a ``SlabStager`` on ``device``: the unbroken run,
    one whose step 3 fails after the step-2 checkpoint and one whose step
    0 fails before any checkpoint — each failure after the step has read
    its slab, so the replay's ``get`` is out of order and the prefetcher
    seeks.  Returns the three runners and the re-entry steps
    ``on_restore`` heard."""
    from repro_torch.core import deep as tdeep
    from repro_torch.core.population import LayeredPopulation
    from repro_torch.distributed.fault_tolerance import (StragglerPolicy,
                                                         TrainRunner)
    from repro_torch.optim import optimizers as topt
    lp = LayeredPopulation(4, 2, ((6, 3), (5,)), ("relu", "gelu"))
    rng = np.random.default_rng(0)
    xs = rng.normal(0, 1, (6, 8, 4)).astype(np.float32)
    ys = rng.integers(0, 2, (6, 8)).astype(np.int32)
    opt = topt.sgd(momentum=0.9)

    def run(tag, fail_at=None):
        stager = tpl.SlabStager(device)

        def produce(s, staging):
            def fill(x, y):
                x[...] = xs[s]
                y[...] = ys[s]
            return stager.stage(staging, 8, fill)

        pf = tpl.Prefetcher(produce, 6, make_staging=lambda: stager.staging(
            (((8, 4), np.float32), ((8,), np.int32))))
        params = tdeep.init_params(
            torch.Generator(device=device).manual_seed(0), lp)
        failed, restored = [], []

        def step_fn(state, s):
            x, y = pf.get(s, timeout=T).take()
            if s == fail_at and not failed:
                failed.append(s)
                raise RuntimeError("injected failure")
            p, st, *_ = tdeep.opt_step(state["params"], state["extra"], x,
                                       y.long(), 0.1, opt, lp,
                                       bd_impl="fused")
            return {"params": p, "extra": st}, {}

        runner = TrainRunner(step_fn, {"params": params,
                                       "extra": opt.init(params)},
                             ckpt_dir=str(tmp_path / tag), ckpt_every=2,
                             on_restore=restored.append,
                             straggler=StragglerPolicy(timeout_s=1e9))
        try:
            assert runner.run(6) == 6
        finally:
            pf.close()
        return runner, restored

    clean, _ = run("clean")
    late, late_restored = run("late", fail_at=3)
    early, early_restored = run("early", fail_at=0)
    return clean, (late, late_restored), (early, early_restored)


def _assert_replays_bitwise(tmp_path, device):
    clean, (late, r_late), (early, r_early) = _replay_runs(tmp_path, device)
    # checkpoints at steps 0, 2, 4: a failure at 3 re-enters at 3, one at
    # 0 replays from the initial-state snapshot
    assert late.restarts == 1 and r_late == [3]
    assert early.restarts == 1 and r_early == [0]
    for r in (late, early):
        for a, b in zip(tree_leaves(r.state), tree_leaves(clean.state)):
            assert torch.equal(a, b)


def test_crash_replay_through_a_prefetcher_is_bitwise(tmp_path):
    _assert_replays_bitwise(tmp_path, "cpu")


# --------------------------------------------------------------------- #
# on the card                                                           #
# --------------------------------------------------------------------- #

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
def test_pinned_staging_and_side_stream_copy_on_card():
    """On the card: every staging buffer pinned; the slab's copy queued on
    the stager's own stream with an event; ``take`` makes the current
    stream wait on it; the values are the staged ones; a buffer is written
    again only after its last copy has finished (the producer runs two
    chunks ahead of a slow consumer, with depth 2)."""
    dev = _card()
    stager = tpl.SlabStager(dev)
    assert stager.stream != torch.cuda.current_stream(dev)
    pf = tpl.Prefetcher(lambda c, s: stager.stage(s, 3, _fill(c)), 12,
                        make_staging=lambda: stager.staging(_specs()))
    for c in range(12):
        slab = pf.get(c, timeout=T)
        assert slab.event is not None
        x, y = slab.take()
        assert x.device == dev and y.dtype == torch.int32
        torch.cuda._sleep(2_000_000)      # a slow chunk on the card
        assert bool((x == c).all()) and bool((y == -c).all())
    pf.close()
    assert stager.made == 2 and stager.pinned == [True] * 4


@pytest.mark.gpu
def test_crash_replay_through_a_prefetcher_on_card(tmp_path):
    _card()
    _assert_replays_bitwise(tmp_path, "cuda")


def test_stager_counts_hold_under_thread_contention():
    """The stager's counts, shared by the producer and the training
    thread, lose no update: 16 threads allocating staging buffers and
    staging slabs with a 1 µs switch interval."""
    import sys
    stager = tpl.SlabStager("cpu")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for _ in range(25):
                st = stager.staging(_specs())
                stager.stage(st, 2, _fill(i))

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=T)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert stager.made == 16 * 25 and len(stager.pinned) == 2 * 16 * 25
