"""The host mesh: the ranks of a ``torch.distributed`` job as the JAX
package's ``(data, model)`` mesh (``repro.launch.mesh``).

``make_host_mesh`` reads the job from torch's standard environment —
``torchrun``'s ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
``MASTER_ADDR``/``MASTER_PORT`` — and factors the world as the JAX package
factors its device count: ``model`` (the population axis) is the largest
of 16, 8, 4, 2 that divides it, ``data`` the rest.  Without that
environment (or with a world of one) the mesh is ``(1, 1)`` and no process
group is made.  Only ``data == 1`` is ported: the population axis over
every rank, each rank a contiguous range of whole members
(``distributed.sharding``); a mesh with a data axis raises
(ROADMAP.md, Queue 1 item 8b).

The process group is gloo: the host collectives (gathers of trees and of
per-member losses, the step a resume agrees on) run on CPU tensors, and
the one in-step reduction, the population axis's sum
(``sharding.PopulationReduce``), on the device tensors themselves
(gloo's ``all_reduce`` takes CUDA tensors).  The group has a timeout
(``--dist-timeout``), so a rank that diverges or dies fails the others
within it instead of leaving them blocked.

Each rank runs on ``cuda:(LOCAL_RANK mod device_count)``: several ranks
may share one card, which shows that the ranks agree but not how fast
they are (they split its SMs).  The JAX package's
``make_production_mesh`` (a TPU pod's 16×16 or 2×16×16 slice) has no
counterpart here: no machine of this port holds such a slice.
"""
from __future__ import annotations

import dataclasses
import datetime
import os

import torch


@dataclasses.dataclass
class HostMesh:
    """A ``(data, model)`` mesh over the ranks of a job (``model`` the
    population axis).  ``group`` is the population axis's process group
    (None on a world of one); ``coords`` this rank's place on each axis."""
    shape: dict
    rank: int = 0
    local_rank: int = 0
    group: object = None
    owns_group: bool = False

    @property
    def size(self) -> int:
        return mesh_num_devices(self)

    @property
    def coords(self) -> dict:
        m = self.shape["model"]
        return {"data": self.rank // m, "model": self.rank % m}

    @property
    def pop_rank(self) -> int:
        return self.coords["model"]

    @property
    def is_writer(self) -> bool:
        """Rank 0: the one rank that prints the run's reports and writes
        its checkpoints."""
        return self.rank == 0

    def device(self, requested="cuda") -> torch.device:
        """This rank's device: ``cuda:(LOCAL_RANK mod device_count)`` when
        the card is asked for (``"cuda"``), else ``requested`` as given."""
        from repro_torch.device import resolve
        dev = resolve(requested)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda",
                               self.local_rank % torch.cuda.device_count())
        return dev

    def agree(self, flag: bool) -> bool:
        """True on every rank iff ``flag`` is true on any: a decision the
        ranks take together (a failure, a save)."""
        if self.group is None:
            return bool(flag)
        import torch.distributed as dist
        t = torch.tensor([1 if flag else 0], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return bool(t.item())

    def broadcast_int(self, value: int) -> int:
        """Rank 0's ``value`` on every rank."""
        if self.group is None:
            return int(value)
        import torch.distributed as dist
        t = torch.tensor([int(value)], dtype=torch.int64)
        dist.broadcast(t, src=0, group=self.group)
        return int(t.item())

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` (picklable) on every rank."""
        if self.group is None:
            return obj
        import torch.distributed as dist
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]

    def describe(self, device) -> str:
        """``rank 1/2 on cuda:0, shared by 2 ranks``."""
        shared = ""
        if device.type == "cuda":
            n = sum(1 for r in range(self.size)
                    if r % torch.cuda.device_count() == device.index)
            if n > 1:
                shared = f", shared by {n} ranks"
        return f"rank {self.rank}/{self.size} on {device}{shared}"


def _factor(n: int, model: int | None) -> tuple:
    if model is None:
        model = 1
        for cand in (16, 8, 4, 2):
            if n % cand == 0 and n >= cand:
                model = cand
                break
    if model < 1 or n % model:
        raise ValueError(f"model axis {model} does not divide the world "
                         f"{n}")
    return n // model, model


def make_host_mesh(model: int | None = None,
                   timeout_s: float = 600.0) -> HostMesh:
    """The largest ``(data, model)`` mesh on the job's ranks (JAX's rule,
    module docstring).  Joins the job's gloo process group, made here from
    the environment with a ``timeout_s`` timeout unless one exists.  A
    mesh with ``data > 1`` raises ``NotImplementedError``."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        rank = int(os.environ.get("RANK", "0"))
    data, model = _factor(world, model)
    if data > 1:
        raise NotImplementedError(
            f"a world of {world} ranks factors as data={data} x "
            f"model={model}: the data axis (batch sharding and the "
            "gradient all-reduce) is not ported yet (ROADMAP.md, Queue 1, "
            "item 8b); run on a world of 1, 2, 4, 8 or 16 ranks")
    mesh = HostMesh({"data": data, "model": model}, rank=rank,
                    local_rank=int(os.environ.get("LOCAL_RANK", rank)))
    if world > 1:
        if not dist.is_initialized():
            dist.init_process_group(
                "gloo", init_method="env://", world_size=world, rank=rank,
                timeout=datetime.timedelta(seconds=timeout_s))
            mesh.owns_group = True
        mesh.group = dist.group.WORLD
    return mesh


def mesh_num_devices(mesh) -> int:
    n = 1
    for v in mesh.shape.values():
        n *= int(v)
    return n


def close(mesh):
    """Leave the job's process group at the end of a run, if
    ``make_host_mesh`` made it (a caller's own group stays)."""
    import torch.distributed as dist
    if mesh.owns_group and dist.is_initialized():
        dist.destroy_process_group()
    mesh.group = None
    mesh.owns_group = False
