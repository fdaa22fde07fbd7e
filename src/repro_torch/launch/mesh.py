"""The host mesh: the ranks of a ``torch.distributed`` job as the JAX
package's ``(data, model)`` mesh (``repro.launch.mesh``).

``make_host_mesh`` reads the job from torch's standard environment —
``torchrun``'s ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
``MASTER_ADDR``/``MASTER_PORT`` — and factors the world as the JAX package
factors its device count: ``model`` (the population axis) is the largest
of 16, 8, 4, 2 that divides it, ``data`` the rest.  Without that
environment (or with a world of one) the mesh is ``(1, 1)`` and no process
group is made.  Rank r sits at ``data = r // model``, ``model = r %
model``, as JAX lays a mesh over its devices.

The process groups (gloo):

  * ``group``, the whole world: the host decisions every rank takes
    together (``agree``, ``broadcast_int``, ``broadcast_object``);
  * ``row_group``, this rank's model row (the ranks of its ``data``
    coordinate): the population axis, over which the members are split
    (``distributed.sharding.PopulationShard``, ``PopulationReduce``);
  * ``col_group``, this rank's data column (the ranks of its ``model``
    coordinate, which hold the same members): the batch axis, over which
    a step's gradients are averaged (``sharding.DataReduce``) and a
    served flush's rows gathered.

A row of a ``data == 1`` mesh is the world, and so is a column of a
``model == 1`` one: those groups are ``group`` itself; an axis of size 1
has no group (None).  Otherwise every rank makes every row's and every
column's group with ``dist.new_group``, rows first, in one fixed order.
The host collectives run on CPU tensors, the in-step reductions on the
device tensors themselves (gloo's collectives take CUDA tensors and
stage them through the host).  Each group has the timeout
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
    population axis).  ``group`` is the world's process group (None on a
    world of one), ``row_group`` this rank's model row's and
    ``col_group`` its data column's (module docstring); ``coords`` this
    rank's place on each axis."""
    shape: dict
    rank: int = 0
    local_rank: int = 0
    group: object = None
    owns_group: bool = False
    row_group: object = None
    col_group: object = None

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
    def data_rank(self) -> int:
        return self.coords["data"]

    def row_ranks(self, d: int) -> list:
        """The global ranks of model row ``d`` (data coordinate ``d``)."""
        m = self.shape["model"]
        return list(range(d * m, (d + 1) * m))

    def col_ranks(self, j: int) -> list:
        """The global ranks of data column ``j`` (model coordinate ``j``)."""
        m = self.shape["model"]
        return list(range(j, self.size, m))

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


# the world group the subgroups were made in (held, so that no later
# world is taken for it), and per (data, model) the rows' groups and the
# columns' groups
_SUBGROUPS: dict = {"world": None, "groups": {}}


def make_host_mesh(model: int | None = None,
                   timeout_s: float = 600.0) -> HostMesh:
    """The largest ``(data, model)`` mesh on the job's ranks (JAX's rule,
    module docstring).  Joins the job's gloo process group, made here from
    the environment with a ``timeout_s`` timeout unless one exists, and
    makes the rows' and columns' groups."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        rank = int(os.environ.get("RANK", "0"))
    data, model = _factor(world, model)
    mesh = HostMesh({"data": data, "model": model}, rank=rank,
                    local_rank=int(os.environ.get("LOCAL_RANK", rank)))
    if world > 1:
        timeout = datetime.timedelta(seconds=timeout_s)
        if not dist.is_initialized():
            dist.init_process_group(
                "gloo", init_method="env://", world_size=world, rank=rank,
                timeout=timeout)
            mesh.owns_group = True
        mesh.group = dist.group.WORLD
        if data == 1:
            mesh.row_group = mesh.group
        elif model == 1:
            mesh.col_group = mesh.group
        else:
            # every rank makes every group, in this order, once per world
            # group (a later mesh of the same job reuses them)
            if _SUBGROUPS["world"] is not dist.group.WORLD:
                _SUBGROUPS.update(world=dist.group.WORLD, groups={})
            groups = _SUBGROUPS["groups"]
            if (data, model) not in groups:
                groups[data, model] = (
                    [dist.new_group(mesh.row_ranks(d), timeout=timeout,
                                    backend="gloo") for d in range(data)],
                    [dist.new_group(mesh.col_ranks(j), timeout=timeout,
                                    backend="gloo") for j in range(model)])
            rows, cols = groups[data, model]
            mesh.row_group = rows[mesh.data_rank]
            mesh.col_group = cols[mesh.pop_rank]
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
        dist.destroy_process_group()      # the rows' and columns' too
        _SUBGROUPS.update(world=None, groups={})
    mesh.group = mesh.row_group = mesh.col_group = None
    mesh.owns_group = False
