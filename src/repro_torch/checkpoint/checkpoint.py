"""Atomic, layout-carrying population checkpoints, byte-compatible with the
JAX package's on-disk format, so a checkpoint written by either package
restores in the other.

Layout:  <dir>/step_<N>/
           arrays.npz     — flattened leaves keyed by tree path
                            ("params/w_in", "params/mid/0/w/1", ...)
           tree.json      — {"step", "manifest": {key: {shape, dtype}},
                             "meta": {"population": layout, ...}}
           META.ok        — commit marker, written last

Keys join dict keys (in sorted order) and list indices with "/", the order
in which JAX flattens a tree.  Leaves are stored as full host arrays; a
restore puts them on the device it is given.  A bf16 leaf is stored as its
raw bits (an unsigned 16-bit array, manifest dtype ``"bfloat16"``), as the
JAX package stores it, and a restore reinterprets those bits, never casts
them: both packages write the same bytes for the same tree.  Optimizer
state rides in the ``extra`` subtree (``save_population(extra_state=...)``),
with the optimizer's record in ``meta["train"]["optimizer"]``, as in the
JAX package, so a training run moves between the two packages.

``AsyncCheckpointer`` takes a training loop's cadence saves off its
thread: it snapshots every leaf to the host before it returns, then a
worker thread serialises and writes.  Unlike the JAX package's, a write
that fails is raised at the next ``wait`` or ``maybe_save``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.core.tree import tree_map
from repro_torch.device import resolve


def _flatten_with_paths(tree, prefix: str = "") -> dict:
    """{"/"-joined path: leaf} in JAX's flattening order."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten_with_paths(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten_with_paths(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def _unflatten_like(like, leaves: dict, prefix: str = ""):
    if isinstance(like, dict):
        return {k: _unflatten_like(v, leaves, f"{prefix}{k}/")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten_like(v, leaves, f"{prefix}{i}/")
                          for i, v in enumerate(like))
    return leaves[prefix[:-1]]


def _host(leaf) -> tuple:
    """A leaf → (the host array stored, the dtype its manifest records):
    bf16 as its raw bits, a uint16 array (numpy has no bf16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, stored: str) -> torch.Tensor:
    """A stored array → a CPU tensor of its manifest dtype: raw bf16 bits
    are reinterpreted, never cast."""
    if stored == str(arr.dtype):
        return torch.as_tensor(arr)
    if stored == "bfloat16" and arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    raise ValueError(f"stored as {arr.dtype} under manifest dtype "
                     f"{stored!r}: not a bit pattern the port can read")


def save(directory: str, step: int, state_tree, keep_last: int = 3,
         meta: dict | None = None) -> str:
    """Atomic synchronous save of a tree of tensors / arrays.  Returns the
    committed path.  ``meta``: JSON-serialisable dict stored beside the
    manifest (population checkpoints keep their layout there)."""
    tgt = os.path.join(directory, f"step_{step:08d}")
    tmp = tgt + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    host, manifest = {}, {}
    for key, leaf in _flatten_with_paths(state_tree).items():
        host[key], dtype = _host(leaf)
        manifest[key] = {"shape": list(host[key].shape), "dtype": dtype}
    np.savez(os.path.join(tmp, "arrays.npz"), **host)
    with open(os.path.join(tmp, "tree.json"), "w") as f:
        json.dump({"step": step, "manifest": manifest, "meta": meta or {}},
                  f)
    with open(os.path.join(tmp, "META.ok"), "w") as f:
        f.write(str(time.time()))
    if os.path.exists(tgt):
        shutil.rmtree(tgt)
    os.rename(tmp, tgt)
    _gc(directory, keep_last)
    return tgt


def _gc(directory: str, keep_last: int):
    steps = latest_steps(directory)
    for s in steps[:-keep_last] if keep_last else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


def latest_steps(directory: str) -> list[int]:
    """Committed steps under ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp") and \
                os.path.exists(os.path.join(directory, name, "META.ok")):
            out.append(int(name[5:]))
    return sorted(out)


def _pick_step(directory: str, step: int | None) -> int:
    steps = latest_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no committed checkpoints under {directory}")
    return steps[-1] if step is None else step


def restore(directory: str, like_tree, step: int | None = None,
            device="cuda"):
    """Restore into the structure of ``like_tree`` (tensors — meta tensors
    are fine — giving each leaf's shape and dtype) on ``device``.  Leaves
    the like-tree does not name are ignored; a leaf stored in another
    dtype than its prototype's is cast after its bits are read, as the JAX
    package does.  Returns (tree, step)."""
    dev = resolve(device)
    step = _pick_step(directory, step)
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "tree.json")) as f:
        manifest = json.load(f)["manifest"]
    out = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for key, proto in _flatten_with_paths(like_tree).items():
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = data[key]
            if tuple(arr.shape) != tuple(proto.shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                                 f"{tuple(proto.shape)}")
            out[key] = _from_host(arr, manifest[key]["dtype"]).to(
                device=dev, dtype=proto.dtype)
    return _unflatten_like(like_tree, out), step


def load_meta(directory: str, step: int | None = None) -> tuple:
    """The ``meta`` dict stored with a checkpoint → (meta, step)."""
    step = _pick_step(directory, step)
    with open(os.path.join(directory, f"step_{step:08d}", "tree.json")) as f:
        return json.load(f).get("meta", {}), step


# --------------------------------------------------------------------- #
# population checkpoints (the layout travels with the parameters)      #
# --------------------------------------------------------------------- #

def population_meta(layout, params, lifecycle: dict | None = None,
                    train_meta: dict | None = None) -> dict:
    """The layout meta a population checkpoint carries: widths, per-layer
    activations, block, shard-pad count, parameter schema and dtype, plus
    the optional halving ``lifecycle`` state and ``train`` policy."""
    from repro_torch.core.population import LayeredPopulation, Population
    if isinstance(layout, Population):
        layout = layout.layered()
    if not isinstance(layout, LayeredPopulation):
        raise TypeError(f"not a population layout: {type(layout)}")
    # two parameter schemas share the layout format, as in the JAX
    # package: the layered engine (w_in/b_in/mid/w_out/b_out) and the
    # single-layer module (parallel_mlp: w1/b1/w2/b2)
    if "w_in" in params:
        schema, first = "layered", params["w_in"]
    elif "w1" in params:
        schema, first = "single", params["w1"]
    else:
        raise TypeError(f"unrecognised population params: {sorted(params)}")
    meta = {"population": {
        "in_features": layout.in_features,
        "out_features": layout.out_features,
        "widths": [list(w) for w in layout.widths],
        "activations": [list(a) for a in layout.activations],
        "block": layout.block,
        "n_pad": layout.n_pad,
        "schema": schema,
        "dtype": str(first.dtype).removeprefix("torch."),
    }}
    if lifecycle is not None:
        meta["lifecycle"] = dict(lifecycle)
    if train_meta is not None:
        meta["train"] = dict(train_meta)
    return meta


def lifecycle_from_meta(meta: dict, layout) -> tuple:
    """Lifecycle state from a checkpoint ``meta`` → ``(rung, member_ids,
    n_members0)``.  Checkpoints written without the halving lifecycle
    default to rung 0 with an identity member mapping over the layout's
    real members."""
    num_real = getattr(layout, "num_real", layout.num_members)
    life = meta.get("lifecycle") or {}
    rung = int(life.get("rung", 0))
    member_ids = np.asarray(life.get("member_ids", range(num_real)),
                            dtype=np.int64)
    if member_ids.shape[0] != num_real:
        raise ValueError(
            f"lifecycle meta carries {member_ids.shape[0]} member ids for a "
            f"layout with {num_real} real members")
    return rung, member_ids, int(life.get("n_members0", num_real))


def optimizer_from_meta(meta: dict):
    """The optimizer record stored under ``meta["train"]["optimizer"]``
    (None for checkpoints without one — those carry no optimizer state and
    may only resume stateless)."""
    return (meta.get("train") or {}).get("optimizer")


def require_optimizer_match(meta: dict, record: dict):
    """Fail LOUDLY when a resume would reinterpret a stored optimizer state
    under a different training recipe: the checkpoint's optimizer record
    must EQUAL the requested one.  Returns the stored record; ``None``
    means a checkpoint with no optimizer meta (the caller decides whether a
    stateless resume is acceptable)."""
    stored = optimizer_from_meta(meta)
    if stored is None or stored == record:
        return stored
    diff = {k: {"checkpoint": stored.get(k), "requested": record.get(k)}
            for k in sorted(set(stored) | set(record))
            if stored.get(k) != record.get(k)}
    raise ValueError(
        "resume: optimizer config mismatch — the checkpoint's state tree "
        f"was written by optimizer {stored.get('name')!r} and cannot be "
        f"reinterpreted under the requested config; differing fields: {diff}")


def layout_from_meta(meta: dict):
    from repro_torch.core.population import LayeredPopulation
    p = meta["population"]
    return LayeredPopulation(
        int(p["in_features"]), int(p["out_features"]),
        tuple(tuple(int(h) for h in w) for w in p["widths"]),
        tuple(tuple(a) for a in p["activations"]),
        block=int(p["block"]), n_pad=int(p.get("n_pad", 0)))


def save_population(directory: str, step: int, params, layout,
                    keep_last: int = 3, extra_state=None,
                    lifecycle: dict | None = None,
                    train_meta: dict | None = None) -> str:
    """Checkpoint population parameters WITH their static layout, so
    ``restore_population`` (in either package) rebuilds both.
    ``extra_state`` (the optimizer state) is stored under its own
    ``extra`` subtree."""
    tree = {"params": params}
    if extra_state is not None:
        tree["extra"] = extra_state
    return save(directory, step, tree, keep_last=keep_last,
                meta=population_meta(layout, params, lifecycle=lifecycle,
                                     train_meta=train_meta))


# the parameter dtypes a population checkpoint may record
PARAM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def restore_population(directory: str, step: int | None = None,
                       device="cuda", extra_like=None, mesh=None):
    """→ (params, layout, step[, extra_state]), the parameter tree rebuilt
    from the stored layout on ``device``.  The layout matches the params:
    a ``LayeredPopulation`` for layered-schema checkpoints, a
    ``Population`` for single-layer (``parallel_mlp``) ones.  Pass
    ``extra_like`` (a tree shaped like the saved ``extra_state`` — meta
    tensors are fine, e.g. ``opt.init(deep.abstract_params(layout))``) to
    restore it too.  The parameters come back in the dtype the checkpoint
    records (float32, or bf16 — which training and serving do not take
    yet: ``deep.check_dtypes``).

    With ``mesh`` (``launch.mesh.make_host_mesh``) of more than one rank,
    each rank loads the whole host arrays and keeps its model row's share
    (``distributed.sharding.PopulationShard``; the whole tree where the
    model axis is 1): the
    parameters (and ``extra``) come back as that rank's trees on
    ``device``, the layout is the WHOLE (shard-padded) layout, and the
    shard is appended to the result.  ``extra_like`` is then the whole
    layout's state tree."""
    from repro_torch.core import deep, parallel_mlp
    from repro_torch.core.population import Population
    device = resolve(device)
    if mesh is not None and mesh.size > 1:
        from repro_torch.distributed.fault_tolerance import elastic_remesh
        out = restore_population(directory, step, device="cpu",
                                 extra_like=extra_like)
        state = {"params": out[0]}
        if extra_like is not None:
            state["extra"] = out[3]
        _, shard, state = elastic_remesh(state, out[1], mesh)
        state = tree_map(lambda t: t.to(device), state)
        rest = (state["extra"],) if extra_like is not None else ()
        return (state["params"], out[1], out[2]) + rest + (shard,)
    meta, step = load_meta(directory, step)
    if "population" not in meta:
        raise ValueError(f"{directory} step {step}: not a population "
                         "checkpoint (no layout meta)")
    pmeta = meta["population"]
    dtype = PARAM_DTYPES.get(pmeta.get("dtype", "float32"))
    if dtype is None:
        raise ValueError(f"unknown parameter dtype {pmeta['dtype']!r}")
    layout = layout_from_meta(meta)
    schema = pmeta.get("schema", "layered")
    if schema == "single":
        layout = Population(layout.in_features, layout.out_features,
                            tuple(w[0] for w in layout.widths),
                            tuple(a[0] for a in layout.activations),
                            block=layout.block)
        like = {"params": parallel_mlp.abstract_params(layout, dtype)}
    elif schema == "layered":
        like = {"params": deep.abstract_params(layout, dtype)}
    else:
        raise ValueError(f"unknown parameter schema {schema!r}")
    if extra_like is not None:
        like["extra"] = extra_like
    tree, step = restore(directory, like, step=step, device=device)
    if extra_like is not None:
        return tree["params"], layout, step, tree["extra"]
    return tree["params"], layout, step


def _snapshot(leaf):
    """A leaf's host copy, independent of the live tensor (a later update
    in place cannot reach it); the copy is complete when this returns."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


class AsyncCheckpointer:
    """Cadence saves for a training loop, off its thread:
    ``maybe_save(step, state)`` waits for the previous write, snapshots
    every leaf to the host (synchronously: the snapshot is complete when
    it returns), and hands serialisation and the write to a daemon thread,
    which touches no CUDA state; ``wait`` joins the write in flight (call
    it before exit and before a restore).  A write that failed raises at
    the next ``wait`` or ``maybe_save`` (the JAX package's worker loses
    it).

    ``meta`` is attached to every save (population runs pass the layout
    meta, so the files stay ``restore_population``-compatible);
    ``step_map`` turns the caller's step counter into the recorded step (a
    chunked loop counts chunks, checkpoints carry global steps);
    ``save_pred`` replaces the ``step % every`` cadence with a predicate on
    the caller's counter.

    ``gather`` (a rank's share of a population on W ranks:
    ``PopulationShard.gather_tree``) turns the host snapshot of this
    rank's share into the whole tree on rank 0 (gathered over model row
    0) and None elsewhere; only rank 0 writes, and the others count the
    save as made."""

    def __init__(self, directory: str, every: int = 100, keep_last: int = 3,
                 meta: dict | None = None, step_map=None, save_pred=None,
                 gather=None):
        self.directory = directory
        self.gather = gather
        self.every = every
        self.keep_last = keep_last
        self.meta = meta
        self.step_map = step_map or (lambda s: s)
        self.save_pred = save_pred
        self.saved = []
        self._thread: threading.Thread | None = None
        self._error: tuple | None = None

    def maybe_save(self, step: int, state_tree) -> bool:
        if self.save_pred is not None:
            if not self.save_pred(step):
                return False
        elif not self.every or step % self.every:
            return False
        self.wait()
        host_tree = tree_map(_snapshot, state_tree)
        rec_step = self.step_map(step)
        if self.gather is not None:
            host_tree = self.gather(host_tree)
            if host_tree is None:          # not rank 0: rank 0 writes
                self.saved.append(None)
                return True

        def work():
            try:
                self.saved.append(save(self.directory, rec_step, host_tree,
                                       self.keep_last, meta=self.meta))
            except Exception as e:   # noqa: BLE001 — re-raised by wait()
                self._error = (rec_step, e)

        self._thread = threading.Thread(target=work, daemon=True,
                                        name=f"checkpoint-{rec_step}")
        self._thread.start()
        return True

    def wait(self):
        """Join the write in flight; raise if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            (step, err), self._error = self._error, None
            raise RuntimeError(f"checkpoint write of step {step} to "
                               f"{self.directory} failed") from err
