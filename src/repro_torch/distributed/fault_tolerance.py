"""Fault tolerance: the checkpoint/restart loop, the straggler watchdog
and the elastic re-mesh.

The train loop is a RESUMABLE pure function of (checkpoint, step,
data(step)):

  * ``TrainRunner`` — drives steps, checkpoints on a cadence, and on ANY
    exception restores the last committed checkpoint (or, before the first
    one, a host snapshot of the initial state) and replays; the data is
    step-indexed, so the replay is exact.  ``failure_hook`` injects
    failures for tests.
  * ``StragglerPolicy`` — wall-clock per-step watchdog: records slow steps
    and raises after ``max_strikes`` consecutive ones, so the runner's
    restart path takes over.

Saves go through ``checkpoint.AsyncCheckpointer``: the state is
snapshotted to the host at the save, the write runs off the training
thread, and every restore joins the write in flight first.  A write that
fails raises at the next save (a restart, like any failure) or at the
run's end.

On W ranks (``TrainRunner(shard=...)``, a
``distributed.sharding.PopulationShard`` of a mesh of more than one rank,
on either axis) each rank steps its share of the population and of the
batch; a save gathers model row 0's shares to rank 0, the only writer
(the other data rows hold the same members); a restore reads the step
rank 0 found committed and hands each rank its share of it.  A failure
is acted on together: before every step the whole world all-reduces a
flag (an injected failure, a straggler's strikes), and every rank
restores when any raised it.  A failure inside a step (where the
other ranks may wait in one of the step's collectives) ends the run: the
process group's timeout bounds how long the others wait.

``elastic_remesh`` puts a host state on a (new) world: any world the mesh
rule accepts — any W, with or without a data axis — resumes any world's
checkpoint, since a whole-member partition needs no divisibility and
every data row holds the whole state of its row.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from repro_torch.checkpoint.checkpoint import (AsyncCheckpointer,
                                               latest_steps, restore)
from repro_torch.core.tree import tree_leaves, tree_map


@dataclasses.dataclass
class StragglerPolicy:
    timeout_s: float = 60.0
    max_strikes: int = 3
    on_straggler: Optional[Callable[[int, float], None]] = None
    strikes: int = 0
    events: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float):
        if dt <= self.timeout_s:
            self.strikes = 0
            return
        self.strikes += 1
        self.events.append((step, dt))
        if self.on_straggler:
            self.on_straggler(step, dt)
        if self.strikes >= self.max_strikes:
            raise TimeoutError(
                f"step {step}: {self.strikes} consecutive steps over "
                f"{self.timeout_s}s — requesting restart")


def elastic_remesh(state, lp, mesh=None):
    """The whole layout's host ``state`` (a tree of tensors: parameters,
    optimizer state, or a dict of both) and a world → ``(mesh, shard,
    this rank's share)``: the mesh of the job's current ranks
    (``launch.mesh.make_host_mesh`` when ``mesh`` is None), this rank's
    ``PopulationShard`` of ``lp`` on it, and its share of ``state`` (still
    on the host).  The layout is not re-padded: a checkpoint's layout
    wins, as in the JAX package."""
    from repro_torch.distributed.sharding import PopulationShard
    if mesh is None:
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh()
    shard = PopulationShard(lp, mesh)
    return mesh, shard, shard.shard(state)


def _host_copy(state):
    return tree_map(lambda t: t.detach().to("cpu", copy=True), state)


class TrainRunner:
    """Checkpoint/restart training driver.

    ``step_fn(state, step) -> (state, metrics)`` must be pure and
    replayable; ``state`` is a tree of tensors on one device.
    ``metrics_log`` and ``walls`` keep each step's metrics and seconds
    (the failure hook's and the step's, as the straggler watchdog sees
    them), replays included.
    ``ckpt_meta`` / ``ckpt_step_map`` / ``ckpt_save_pred`` go to the
    ``AsyncCheckpointer`` (population runs attach the layout and record
    GLOBAL step numbers while the runner counts chunks);
    ``ckpt_step_unmap`` maps a restored checkpoint's recorded step back
    into the runner's step domain.  ``on_restore(step)`` fires after every crash restore with the
    step the replay re-enters at.

    ``shard`` (a ``PopulationShard`` of a mesh of more than one rank,
    with ``full_like``: the whole layout's state tree, meta tensors are
    fine) makes ``state`` this rank's share: saves gather to rank 0,
    restores take this rank's share of rank 0's step, and failures are
    decided together (module docstring)."""

    def __init__(self, step_fn, state, *, ckpt_dir: str,
                 ckpt_every: int = 50, keep_last: int = 3,
                 straggler: StragglerPolicy | None = None,
                 failure_hook: Optional[Callable[[int], None]] = None,
                 max_restarts: int = 3, ckpt_meta: dict | None = None,
                 ckpt_step_map: Optional[Callable[[int], int]] = None,
                 ckpt_step_unmap: Optional[Callable[[int], int]] = None,
                 ckpt_save_pred: Optional[Callable[[int], bool]] = None,
                 on_restore: Optional[Callable[[int], None]] = None,
                 shard=None, full_like=None):
        self.step_fn = step_fn
        self.state = state
        self.device = tree_leaves(state)[0].device
        self.shard = (shard if shard is not None and shard.distributed
                      else None)
        self.full_like = full_like
        self.ckpt = AsyncCheckpointer(
            ckpt_dir, every=ckpt_every, keep_last=keep_last, meta=ckpt_meta,
            step_map=ckpt_step_map, save_pred=ckpt_save_pred,
            gather=None if self.shard is None else self.shard.gather_tree)
        self.ckpt_step_unmap = ckpt_step_unmap or (lambda s: s)
        self.on_restore = on_restore
        self.straggler = straggler or StragglerPolicy(timeout_s=1e9)
        self.failure_hook = failure_hook
        self.max_restarts = max_restarts
        self.restarts = 0
        self.metrics_log = []
        self.walls = []       # (step, seconds) of each step that ran
        # host snapshot of the INITIAL state: a failure before the first
        # committed checkpoint replays from step 0.  Skipped when the
        # directory already holds a checkpoint (a resume restores from disk)
        # and freed as soon as one commits.
        self._init_state_host = (None if latest_steps(ckpt_dir)
                                 else _host_copy(state))

    def _restore(self) -> int:
        self.ckpt.wait()
        steps = latest_steps(self.ckpt.directory)
        if self.shard is not None:
            # rank 0 wrote; every rank restores the step it found committed
            last = self.shard.mesh.broadcast_int(steps[-1] if steps else -1)
            steps = [last] if last >= 0 else []
        if not steps:
            if self._init_state_host is None:
                raise RuntimeError(
                    f"no committed checkpoint under {self.ckpt.directory} "
                    "and the initial-state snapshot was already released")
            self.state = tree_map(lambda t: t.to(self.device),
                                  self._init_state_host)
            step = 0
        elif self.shard is not None:
            full, saved = restore(self.ckpt.directory, self.full_like,
                                  step=steps[-1], device="cpu")
            self.state = tree_map(lambda t: t.to(self.device),
                                  self.shard.shard(full))
            step = self.ckpt_step_unmap(saved) + 1
        else:
            self.state, saved = restore(self.ckpt.directory, self.state,
                                        device=self.device)
            step = self.ckpt_step_unmap(saved) + 1
        if self.on_restore:
            self.on_restore(step)
        return step

    def _fail(self, err) -> int:
        self.restarts += 1
        if self.restarts > self.max_restarts:
            raise RuntimeError(
                f"exceeded {self.max_restarts} restarts") from err
        return self._restore()

    def _run_sharded(self, num_steps: int, step: int) -> int:
        """``run`` on W ranks: a failure outside a step is acted on by all
        ranks together; one inside a step ends the run."""
        late = None          # a straggler's strikes, acted on next step
        while step < num_steps:
            err, late = late, None
            if err is None:
                try:
                    if self.failure_hook:
                        self.failure_hook(step)
                except KeyboardInterrupt:
                    raise
                except Exception as e:   # noqa: BLE001 — decided together
                    err = e
            if self.shard.mesh.agree(err is not None):
                step = self._fail(err)
                continue
            t0 = time.time()
            self.state, metrics = self.step_fn(self.state, step)
            dt = time.time() - t0
            try:
                self.straggler.observe(step, dt)
            except TimeoutError as e:
                late = e
            self.walls.append((step, dt))
            self.metrics_log.append((step, metrics))
            self.ckpt.maybe_save(step, self.state)
            if self._init_state_host is not None and self.ckpt.saved:
                self._init_state_host = None
            step += 1
        self.ckpt.wait()
        return step

    def run(self, num_steps: int, start_step: int = 0) -> int:
        step = start_step
        if self.shard is not None:
            return self._run_sharded(num_steps, step)
        while step < num_steps:
            try:
                t0 = time.time()
                if self.failure_hook:
                    self.failure_hook(step)
                self.state, metrics = self.step_fn(self.state, step)
                dt = time.time() - t0
                self.walls.append((step, dt))
                self.straggler.observe(step, dt)
                self.metrics_log.append((step, metrics))
                self.ckpt.maybe_save(step, self.state)
                if self._init_state_host is not None and self.ckpt.saved:
                    self._init_state_host = None   # a checkpoint committed
                step += 1
            except KeyboardInterrupt:
                raise
            except Exception as e:   # noqa: BLE001 — restart on ANY failure
                step = self._fail(e)
        self.ckpt.wait()
        return step
