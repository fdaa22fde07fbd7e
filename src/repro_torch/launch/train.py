"""Training driver: ``python -m repro_torch.launch.train --arch <id>
[...]``, with the JAX package's flag names and prints
(``repro.launch.train``), on one card.

LM archs (``--arch qwen3-1.7b``, any of the seven attention LMs, or the
SSM and hybrid LMs mamba2-780m and hymba-1.5b; ``--reduced`` for the
laptop-scale config) train through ``run_lm``, the
JAX driver's: parameters from a generator seeded 0 (JAX: ``PRNGKey(0)``),
the arch's optimizer (``optim.build_optimizer``), ``warmup_cosine`` over
``--warmup`` and ``--steps``, ``TokenTask`` batches of ``--batch`` ×
``--seq`` (the ``embeds`` frontend draws its inputs as JAX's does), the
step of ``models.lm.make_train_step`` with ``--num-micro`` microbatches
and the global-norm clip at ``--grad-clip`` (1.0 when unset), under a
``TrainRunner`` (checkpoints every ``--ckpt-every`` steps, the straggler
watchdog, ``--resume`` from the last committed step, crash replay).  Its
checkpoints and JAX's restore in either package.  Not yet: the
encoder-decoder (ROADMAP Queue 1 item 9(c), refused by
``configs.get_arch``), an LM across ranks (item 9(d)).

The population path: build (or resume) a ``LayeredPopulation``, initialise
parameters and optimizer state on the device, and train in chunks of
``--scan-steps`` optimizer steps (``deep.make_population_train_step``)
under a ``TrainRunner`` — cadence checkpoints carrying the layout and the
optimizer state, crash replay from the last checkpoint.  ``--bd-impl
fused`` runs every step as exactly 2·(depth+1) hand-written CUDA kernel
launches; ``--bd-impl pallas --act-impl pallas`` runs the unfused route
over the block-diagonal GEMM and segmented-activation kernels, and
``--m3-impl pallas`` its output head over the segment-blocked matmul
kernels (``--m3-impl`` picks the head of every route but ``--bd-impl
fused``, whose fused loss head runs no M3, as in the JAX package).  The
run ends with a leaderboard over the held-out split, scored on the run's
own route (the serving kernels under ``--bd-impl fused``, else the run's
``--act-impl`` and ``--m3-impl``).

``--halving "500:0.5,1000:0.25"`` adds the successive-halving lifecycle
(``core/lifecycle.py``): the run is split into rung segments; at each rung
boundary the population is evaluated on ``--rung-eval-batches`` batches of
the held-out split, on the run's own route, the best ``keep_frac`` survive,
and they are COMPACTED into a freshly built, smaller layout whose device
tables are built there (``deep.build_tables``), before the next segment.
``--refill pbt|arch`` (``repro_torch.search``) puts clones of survivors
with perturbed recipes, or fresh members, into the freed slots: ``pbt``
keeps the layout (no table is rebuilt), ``arch`` samples architectures
from ``--search-space`` and grows the layout.  ``--per-member-lr`` /
``--per-member-momentum`` / ``--per-member-weight-decay`` race one
recipe per member.  Checkpoints carry the lifecycle (rung, slot →
original member ids, the recipe vectors, and under ``--refill`` the id
counter and the lineage), so ``--resume`` continues a ladder mid-way, in
either package.

Deliberate differences from the JAX driver (ROADMAP.md): rungs score on
the run's own route; the per-member vectors and newborns are drawn from
``torch.Generator``s (``SearchSpace.init_*``, ``fresh_member_params``),
other numbers than ``jax.random``'s; the recipe vectors are always written
into the lifecycle meta, and ``--resume`` with a per-member flag raises on
a checkpoint without them (a JAX run without ``--refill``): the port cannot
redraw JAX's vector.

``--optimizer {sgd,momentum,adamw,adafactor}`` picks the optimizer;
``--opt-state-dtype bfloat16`` stores AdamW's moments in bf16.  At a
compacting rung adafactor's factored statistics cannot be gathered: the
rung carries its momentum and count (``lifecycle.compact_factored``, grown
with the layout under ``--refill arch``) into a fresh state on the new
layout (``rewarm_adafactor_state``).  Checkpoints are written off the
training thread (``checkpoint.AsyncCheckpointer``).

``--compute-dtype bfloat16`` trains under the bf16 compute policy
(DESIGN.md §7): on the fused route every launch of a step is its kernel's
bf16 instance; on the unfused route (``--bd-impl pallas``) the
block-diagonal kernels' and, with ``--m3-impl pallas``, the M3 kernels'
bf16 instances (the segmented activation in f32, as the policy hands it
f32); on the plain route (``--bd-impl einsum``) the matmuls take bf16
operands; the masters, the optimizer state, the checkpoint and the rung
evals and closing leaderboard stay f32.
``--serve-publish`` keeps an f32 ``PopulationServer`` on the live run,
refreshed and republished at every rung boundary and at the end
(``published: best1=… topk=…``).

``--pipeline on`` (the default, as in the JAX package) runs each segment
through the streaming data plane (``data/pipeline.py``): a producer thread
builds chunk c+1's slab into pinned host staging and copies it on a side
stream while chunk c runs, and each chunk's metrics are fetched after the
next chunk is launched.  ``--pipeline off`` builds and copies the same way
on the training thread and fetches each chunk's metrics before the next
launch.  The trajectory is bitwise the same either way.

Under ``torchrun --nproc-per-node W`` the ranks form JAX's ``(data,
model)`` mesh (``launch/mesh.py``: ``model`` the largest of 16, 8, 4, 2
dividing W, ``data`` the rest).  The population axis spans a model row,
as the JAX driver's does a mesh's ``model`` axis
(``distributed/sharding.py``): the layout is shard-padded to ``model``
(``shard_pad``; the fillers drawn from a generator seeded from ``(seed,
1)``, the real members bitwise a one-rank init), each rank trains a
contiguous range of whole members on the same kernels, and the ranks of
a row meet only where the reference mixes members (the clip's global
norm, adafactor's member-axis statistics), to gather per-member losses
for the reports and the rungs, and to gather the state to rank 0, the
only writer of checkpoints, and to every rank at a rung, where the
one-rank code compacts, refills or grows it before it is re-padded and
re-partitioned.  The data axis splits each batch by rows where it
divides ``--batch`` (each rank builds and copies only its rows), and the
ranks of a data column, which hold the same members, average each step's
losses and gradients (``sharding.DataReduce``) before the clip and the
optimizer; where it does not divide, every rank takes the whole batch.
Failures are decided by the whole world.  A checkpoint of either
package, padded for any world, resumes on any W (its layout wins).  Only
rank 0 prints the run's reports.  On one rank nothing of this runs.
"""
from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch


def parse_depth_spec(spec: str):
    """"64,32,16;13,5;7" → ((64, 32, 16), (13, 5), (7,)) — one member per
    ';'-separated group, one hidden layer per ','-separated width."""
    widths = []
    for member in spec.split(";"):
        member = member.strip()
        if not member:
            continue
        widths.append(tuple(int(w) for w in member.split(",")))
    if not widths:
        raise ValueError(f"empty population spec {spec!r}")
    return tuple(widths)


def population_from_flags(depths: str, acts: str, features: int,
                          classes: int = 2, repeats: int = 1,
                          block: int = 8):
    """The layered population of the ``--population-*`` flags: members by
    ';', per-layer widths by ','; activations cycled over members ('paper'
    for the ten), sorted."""
    from repro_torch.core.activations import PAPER_TEN
    from repro_torch.core.population import LayeredPopulation
    widths = parse_depth_spec(depths)
    names = tuple(a.strip() for a in acts.split(","))
    if names == ("paper",):
        names = PAPER_TEN
    n = len(widths) * repeats
    return LayeredPopulation(features, classes, widths * repeats,
                             tuple(names[i % len(names)] for i in range(n)),
                             block=block).sorted()


def check_recipe_flags(args, opt_name: str):
    """The JAX driver's checks of the per-member and state-dtype flags
    against the optimizer (``SystemExit``, as there)."""
    if args.per_member_momentum and opt_name != "momentum":
        raise SystemExit("--per-member-momentum needs --optimizer momentum")
    if args.per_member_weight_decay and opt_name not in ("adamw",
                                                         "adafactor"):
        raise SystemExit(
            "--per-member-weight-decay needs --optimizer adamw/adafactor")
    if args.per_member_weight_decay and args.weight_decay <= 0:
        raise SystemExit("--per-member-weight-decay scales --weight-decay; "
                         "set it > 0")
    if args.opt_state_dtype != "float32" and opt_name != "adamw":
        raise SystemExit(
            "--opt-state-dtype applies to --optimizer adamw only "
            "(sgd/momentum moments are f32; adafactor manages its own "
            "state dtypes) — it would be silently ignored here")


def optimizer_record(arch, args, opt_name: str, grad_clip) -> dict:
    """The record checkpoints carry under ``meta["train"]["optimizer"]`` —
    the JAX package's schema, so a resume in either package validates it:
    the per-member flags, and the seed wherever a vector or the refill
    controller's rng depends on it."""
    rec = {"name": opt_name, "lr": float(arch.lr),
           "grad_clip": float(grad_clip or 0.0),
           "per_member_lr": bool(args.per_member_lr),
           "per_member_momentum": bool(args.per_member_momentum),
           "per_member_weight_decay": bool(args.per_member_weight_decay)}
    if opt_name == "momentum":
        rec["momentum"] = float(args.momentum)
    if opt_name in ("adamw", "adafactor"):
        rec["weight_decay"] = float(args.weight_decay)
    if opt_name == "adamw":
        rec["state_dtype"] = args.opt_state_dtype
    if (args.per_member_lr or args.per_member_momentum
            or args.per_member_weight_decay):
        rec["seed"] = int(args.seed)
    if args.refill != "off":
        rec["refill"] = args.refill
        rec["seed"] = int(args.seed)
        if args.search_space:
            rec["search_space"] = args.search_space
    return rec


def fresh_member_params(seed: int, rung: int, fresh_lp, device) -> dict:
    """The parameters of the members born at rung ``rung``, for their own
    layout ``fresh_lp``: ``deep.init_params`` from a ``torch.Generator``
    on ``device`` seeded from ``(seed, 5000 + rung)``, so a resumed run
    draws the same newborns (the JAX package folds the same numbers into
    its ``jax.random`` key: the same distribution, other numbers)."""
    from repro_torch.core.deep import init_params
    return init_params(_seeded(seed, 5000 + int(rung), device), fresh_lp)


def rewarm_adafactor_state(fresh, carried):
    """A fresh (all-zero) adafactor state on a rung's new layout with the
    carry of ``lifecycle.compact_factored`` merged in: its momentum tree
    (None without momentum) and step count.  The factored ``v_row``/
    ``v_col`` stay the fresh zeros — they reduce over the fused hidden
    axis, so survivors' statistics mix members and cannot be gathered;
    zeroing them costs the ~1/(1−b2)-step re-warm."""
    from repro_torch.core.tree import tree_map
    from repro_torch.optim.optimizers import is_state_leaf
    if carried["m"] is None:
        return {**fresh, "count": carried["count"]}
    return {"count": carried["count"],
            "leaves": tree_map(lambda st, m: {**st, "m": m},
                               fresh["leaves"], carried["m"],
                               is_leaf=is_state_leaf)}


def _seeded(seed: int, k: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``(seed, k)`` (the counterpart
    of JAX's ``fold_in(key, k)``: the same role, other numbers)."""
    state = np.random.SeedSequence([int(seed), int(k)])
    return torch.Generator(device=device).manual_seed(
        int(state.generate_state(1, np.uint32)[0]))


def _quiet(*args, **kwargs):
    """``print`` of a rank other than 0."""


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _memory(device):
    return (torch.cuda.memory_allocated(device) if device.type == "cuda"
            else None)


def run_lm(arch, args, mesh=None):
    """LM training, the JAX driver's ``run_lm`` → the ``TrainRunner``
    (``metrics_log``: each step's loss, grad_norm and lr; ``walls``: each
    step's seconds; ``state``: the trained {"params", "opt"})."""
    from repro_torch.checkpoint.checkpoint import latest_steps, restore
    from repro_torch.data.synthetic import TokenTask
    from repro_torch.device import resolve
    from repro_torch.distributed.fault_tolerance import (StragglerPolicy,
                                                         TrainRunner)
    from repro_torch.models import lm
    from repro_torch.optim.optimizers import build_optimizer, warmup_cosine

    if arch.kind == "encdec":
        raise NotImplementedError(
            f"arch {arch.arch_id!r}: the encoder-decoder is not ported yet "
            "(ROADMAP.md, Queue 1 item 9(c))")
    if mesh is not None and mesh.size > 1:
        raise NotImplementedError(
            f"arch {arch.arch_id!r} on {mesh.size} ranks: the LM across "
            "ranks is not ported yet (ROADMAP.md, Queue 1 item 9(d))")
    if args.batch % args.num_micro:
        # before the runner, which would replay a failing step
        raise ValueError(f"--num-micro {args.num_micro} does not divide "
                         f"--batch {args.batch}")
    cfg = arch.model
    device = resolve(args.device)
    if args.ckpt_dir is None:
        if args.resume:
            raise SystemExit("--resume needs --ckpt-dir")
        args.ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
        print(f"checkpoints: {args.ckpt_dir}")
    print(f"arch={arch.arch_id} device={device}")
    params = lm.init_params(torch.Generator(device).manual_seed(0), cfg)
    opt = build_optimizer(arch)
    lr_fn = warmup_cosine(arch.lr, args.warmup, args.steps)
    # LM default stays 1.0 when the flag is unset (populations default to
    # clipping off), as in the JAX driver
    train_step = lm.make_train_step(
        cfg, opt, lr_fn, num_micro=args.num_micro,
        grad_clip=1.0 if args.grad_clip is None else args.grad_clip)
    task = TokenTask(vocab=cfg.vocab, seed=args.seed)

    def make_batch(step):
        b = task.batch(step, args.batch, args.seq)
        if cfg.frontend == "embeds":
            rng = np.random.default_rng([args.seed, step])
            b["embeds"] = rng.normal(
                0, 1, (args.batch, args.seq, cfg.d_model)).astype(np.float32)
            del b["tokens"]
        return {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    def step_fn(state, step):
        p, o, metrics = train_step(state["params"], state["opt"],
                                   make_batch(step), step)
        return {"params": p, "opt": o}, {k: float(v)
                                         for k, v in metrics.items()}

    runner = TrainRunner(
        step_fn, {"params": params, "opt": opt.init(params)},
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        straggler=StragglerPolicy(timeout_s=args.straggler_timeout))
    del params
    start = 0
    if args.resume and latest_steps(args.ckpt_dir):
        runner.state, last = restore(args.ckpt_dir, runner.state,
                                     device=device)
        start = last + 1
        print(f"resumed from step {last}")
    t0 = time.time()
    runner.run(args.steps, start_step=start)
    dt = time.time() - t0
    losses = [m["loss"] for _, m in runner.metrics_log]
    if losses:
        print(f"done: {len(losses)} steps in {dt:.1f}s; "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return runner


def run_population(arch, args, mesh=None):
    """Fused population training → ``(params, layout, stats)``; ``stats``:
    first/last mean member loss, steps, seconds, restarts, member steps,
    chunk builds, and with ``--halving`` one entry per trained segment
    (``segments``: steps, members, fused widths, seconds, kernel launches,
    tables built) and per rung (``rungs``: the eval, the gather and the
    table build, each timed, and the device memory after).

    ``mesh`` (``launch.mesh.make_host_mesh``) of W ranks: ``params`` is
    this rank's share of the WHOLE layout returned, ``stats["ranks"]`` the
    ranks' member ranges and ``stats["rank_fused_hidden"]`` their fused
    widths."""
    from repro_torch import device as device_mod
    from repro_torch.checkpoint.checkpoint import (latest_steps,
                                                   layout_from_meta,
                                                   lifecycle_from_meta,
                                                   load_meta,
                                                   population_meta,
                                                   require_optimizer_match,
                                                   restore_population,
                                                   save_population)
    from repro_torch.core import deep
    from repro_torch.core.tree import tree_map
    from repro_torch.core.lifecycle import (HalvingSchedule, compact,
                                            compact_factored, grow,
                                            grow_params, refill_params,
                                            refill_state, survivors)
    from repro_torch.core.population import LayeredPopulation, Population
    from repro_torch.core.selection import evaluate_population, leaderboard
    from repro_torch.data.pipeline import (DeferredMetrics, Prefetcher,
                                           SlabStager)
    from repro_torch.data.synthetic import TabularTask
    from repro_torch.device import resolve
    from repro_torch.distributed.fault_tolerance import (StragglerPolicy,
                                                         TrainRunner)
    from repro_torch.distributed.sharding import (
        PopulationShard, pop_axis_size, population_batch_shardings)
    from repro_torch.launch.launch_count import kernel_launches
    from repro_torch.optim.optimizers import (adafactor, adamw, sgd,
                                              warmup_cosine)
    from repro_torch.search import RefillController, SearchSpace

    schedule = HalvingSchedule.parse(args.halving) if args.halving else None
    refill_mode = args.refill
    space = SearchSpace.parse(args.search_space)
    controller = None
    if refill_mode != "off":
        if schedule is None:
            raise SystemExit("--refill needs --halving (rung boundaries "
                             "are where slots free up)")
        controller = RefillController(space, mode=refill_mode,
                                      seed=args.seed,
                                      exploit_frac=args.refill_exploit_frac)
    W = pop_axis_size(mesh)
    world = 1 if mesh is None else mesh.size
    # the population axis the layout is padded for: the mesh's, unless
    # --shard-pad asks for another (one rank can then follow W ranks' run)
    pad = getattr(args, "shard_pad", None) or W
    say = print if world == 1 or mesh.is_writer else _quiet
    # this rank's rows of each batch: all of them unless the data axis
    # splits it
    rows = population_batch_shardings(mesh, args.batch)[1].indices(
        args.batch)[:2]
    if args.ckpt_dir is None:
        if args.resume:
            raise SystemExit("--resume needs --ckpt-dir")
        if world == 1:
            args.ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
        else:        # one directory for the job: rank 0's
            args.ckpt_dir = mesh.broadcast_object(
                tempfile.mkdtemp(prefix="repro_torch_ckpt_")
                if mesh.is_writer else None)
        say(f"checkpoints: {args.ckpt_dir}")
    if world == 1:
        device = resolve(args.device)
    else:
        device = mesh.device(args.device)
        print(mesh.describe(device), flush=True)
    opt_name = args.optimizer or arch.optimizer
    grad_clip = args.grad_clip if args.grad_clip else None
    if opt_name not in ("sgd", "momentum", "adamw", "adafactor"):
        raise SystemExit(f"unknown optimizer {opt_name!r}")
    check_recipe_flags(args, opt_name)
    opt_record = optimizer_record(arch, args, opt_name, grad_clip)
    route = dict(bd_impl=args.bd_impl, act_impl=args.act_impl,
                 m3_impl=args.m3_impl)

    if args.population_depths:
        lp = population_from_flags(
            args.population_depths, args.population_acts,
            args.population_features, args.population_classes,
            args.population_repeats, args.population_block)
    else:
        model = arch.model
        lp = model.layered() if isinstance(model, Population) else model
    scan = max(args.scan_steps, 1)
    if world == 1:
        print(f"device={device} scan_steps={scan}")
    else:
        say(f"mesh={dict(mesh.shape)} device={device} scan_steps={scan}")

    start = 0
    rung = 0
    life = {}
    ck_step = None
    if world == 1:
        resuming = bool(args.resume and latest_steps(args.ckpt_dir))
    else:
        # the job resumes the step rank 0 found committed
        found = (latest_steps(args.ckpt_dir)
                 if args.resume and mesh.is_writer else [])
        ck_step = mesh.broadcast_int(found[-1] if found else -1)
        resuming = ck_step >= 0
    if resuming:
        meta, last = load_meta(args.ckpt_dir, ck_step)
        stored = require_optimizer_match(meta, opt_record)
        if stored is None and opt_name != "sgd":
            raise SystemExit(
                f"--resume: the checkpoint at step {last} carries no "
                "optimizer state; it can only resume with the stateless "
                "'--optimizer sgd'")
        # the checkpoint's layout wins, shard-padded for whatever world
        # wrote it: a whole-member partition needs no divisibility
        lp = layout_from_meta(meta)
        rung, member_ids, n0 = lifecycle_from_meta(meta, lp)
        life = meta.get("lifecycle") or {}
        start = last + 1
    else:
        n0 = lp.num_members
        member_ids = np.arange(n0)
        lp_real, lp = lp, lp.shard_pad(pad)

    # ---- per-member recipe vectors over the ORIGINAL n0 members, indexed
    # by original id (a refilled member appends its recipe at its fresh
    # id); a resume reads them from the lifecycle meta, never redraws
    def recipe_vector(flag, key, what, draw):
        if not flag:
            return None
        if not resuming:
            return draw()
        if key not in life:
            raise ValueError(
                f"--resume with {what}: the checkpoint's lifecycle meta "
                f"has no {key!r} (a JAX run without --refill writes none); "
                "the JAX package draws the vector with jax.random, which "
                "the port cannot redraw, and a different vector beneath "
                "the restored state would silently change every member's "
                "recipe")
        return np.asarray(life[key], np.float32)

    lr0 = recipe_vector(args.per_member_lr, "lr_vec", "--per-member-lr",
                        lambda: space.init_lr(args.seed, n0, arch.lr))
    mom0 = recipe_vector(args.per_member_momentum, "mom_vec",
                         "--per-member-momentum",
                         lambda: space.init_momentum(args.seed, n0))
    wd0 = recipe_vector(args.per_member_weight_decay, "wd_vec",
                        "--per-member-weight-decay",
                        lambda: space.init_wd(args.seed, n0,
                                              args.weight_decay))
    if lr0 is not None:
        say(f"per-member learning rates in "
            f"[{arch.lr * space.lr_scale[0]:.4f}, "
            f"{arch.lr * space.lr_scale[1]:.4f}]")
    if mom0 is not None:
        say(f"per-member momentum in [{space.momentum_range[0]:.2f}, "
            f"{space.momentum_range[1]:.2f}]")
    if wd0 is not None:
        say(f"per-member weight decay in "
            f"[{args.weight_decay * space.wd_scale[0]:.5f}, "
            f"{args.weight_decay * space.wd_scale[1]:.5f}]")

    # ---- lineage: original id → (parent id, birth rung); ids come from a
    # counter above every id issued, so a newborn never aliases a seed
    next_id = int(n0)
    lineage = {}
    if resuming and refill_mode != "off":
        next_id = int(life.get("next_id", n0))
        lineage = {int(k): (int(v[0]), int(v[1]))
                   for k, v in (life.get("lineage") or {}).items()}

    def member_tree(vec0, base, sh):
        """A recipe vector indexed down to the layout's slots (fillers get
        ``base``), cut to this rank's members and expanded to a scale tree
        on the device: copied there once per layout or recipe change, not
        once a step."""
        v = vec0[member_ids]
        if sh.lp.n_pad:
            v = np.concatenate([v, np.full(sh.lp.n_pad, base, v.dtype)])
        v = torch.as_tensor(v[sh.start:sh.stop], device=device)
        return deep.member_lr_tree(sh.local, v)

    # bumped by every build_opt: part of the chunk cache's key, so a
    # rebuilt optimizer (new momentum / decay trees) builds a new chunk,
    # while a rung that changes neither (the constant-size refill with
    # per-member lr only) reuses it
    opt_epoch = 0

    def build_opt(sh):
        nonlocal opt_epoch
        opt_epoch += 1
        if opt_name == "sgd":
            return sgd()
        if opt_name == "momentum":
            return sgd(momentum=args.momentum if mom0 is None
                       else member_tree(mom0, args.momentum, sh))
        wd = (args.weight_decay if wd0 is None
              else member_tree(wd0, args.weight_decay, sh))
        if opt_name == "adamw":
            return adamw(weight_decay=wd, state_dtype=args.opt_state_dtype)
        return adafactor(weight_decay=wd)

    sh = PopulationShard(lp, mesh)
    if resuming:
        opt = build_opt(sh)
        at = {} if world == 1 else {"step": ck_step, "mesh": mesh}
        if stored is None:
            params, lp_ckpt, *_ = restore_population(args.ckpt_dir,
                                                     device=device, **at)
            opt_state = opt.init(params)
        else:
            params, lp_ckpt, _, opt_state, *_ = restore_population(
                args.ckpt_dir, device=device,
                extra_like=opt.init(deep.abstract_params(lp)), **at)
        if lp_ckpt != lp:
            raise ValueError("--resume: the checkpoint's layout does not "
                             "match its meta")
        say(f"resumed from step {last}"
            + (f" (rung {rung}, {lp.num_real} survivors)"
               if rung else ""))
    else:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = deep.init_params(gen, lp_real)
        if lp is not lp_real:
            # born padded: the real members bitwise a one-rank init, the
            # fillers from their own generator; each rank keeps its share
            params = deep.pad_params(params, lp_real, lp,
                                     _seeded(args.seed, 1, device))
        opt = build_opt(sh)
        opt_state = opt.init(params)    # factored by the whole shapes
        params, opt_state = sh.shard(params), sh.shard(opt_state)
    say(f"population: {lp.describe()}  optimizer: {opt_name}"
        + (f" (grad clip {grad_clip})" if grad_clip else ""))
    if W > 1:
        say(f"population axis: {W} ranks, members {list(sh.ranges)}, "
            f"fused widths {sh.widths()}")
    if sh.data > 1:
        say(f"data axis: {sh.data} ranks, "
            + (f"{rows[1] - rows[0]} of {args.batch} rows a rank, the "
               "gradients averaged over each data column"
               if rows != (0, args.batch) else
               f"{args.batch} rows on every rank (the data axis does not "
               "divide them)"))
    data_reduce = sh.data_reduce(args.batch)

    task = TabularTask(args.samples, lp.in_features,
                       n_classes=lp.out_features, seed=args.seed)
    (_, _), (xte, yte) = task.split()

    def lifecycle_meta():
        m = {"rung": rung, "n_members0": int(n0),
             "member_ids": [int(i) for i in member_ids]}
        if refill_mode != "off":
            m["next_id"] = int(next_id)
            m["lineage"] = {str(k): [int(p), int(b)]
                            for k, (p, b) in sorted(lineage.items())}
        for key, vec in (("lr_vec", lr0), ("mom_vec", mom0),
                         ("wd_vec", wd0)):
            if vec is not None:
                m[key] = [float(v) for v in vec]
        return m

    train_meta = {"compute_dtype": args.compute_dtype,
                  "bd_impl": args.bd_impl, "act_impl": args.act_impl,
                  "optimizer": opt_record, "lr_schedule": args.lr_schedule}
    lr_sched = (warmup_cosine(1.0, args.warmup, args.steps)
                if args.lr_schedule == "warmup_cosine" else None)

    total = args.steps
    print_every = max(50 // scan, 1)
    stats = {"restarts": 0, "member_steps": 0, "chunk_builds": 0,
             "refilled": 0, "segments": [], "rungs": [], "chunk_loss": {}}
    # the chunk of the current (layout, optimizer epoch): a rung boundary
    # that changes neither reuses it, with every table of the layout
    chunk = {}
    pipeline = args.pipeline == "on"
    stager = SlabStager(device)    # pinned staging, side-stream copies
    pf = None          # ONE Prefetcher for the run, retargeted per rung
    pending = []       # the in-flight chunk's DeferredMetrics (≤ 1)

    def train_segment(params, opt_state, sh, opt, seg_start, seg_end):
        """Global steps [seg_start, seg_end) under the current layout
        (``sh.lp``; this rank trains ``sh.local``), in chunks of ``scan``
        steps under a ``TrainRunner``.  With ``--pipeline on`` chunk c+1's
        slab is built and copied by the prefetcher while chunk c runs, and
        chunk c's metrics resolve after chunk c+1 is launched; with
        ``off`` the same builder runs on this thread and each chunk's
        metrics resolve before the next launch."""
        nonlocal pf
        lp = sh.lp
        key = (sh.local, opt_epoch)
        if key not in chunk:
            chunk.clear()
            chunk[key] = deep.make_population_train_step(
                sh.local, optimizer=opt, grad_clip=grad_clip,
                scan_steps=scan, lr_schedule=lr_sched,
                compute_dtype=args.compute_dtype, reduce=sh.reduce,
                data_reduce=data_reduce, **route)
            stats["chunk_builds"] += 1
        chunk_fn = chunk[key]
        lr = arch.lr if lr0 is None else member_tree(lr0, arch.lr, sh)
        n_chunks = (seg_end - seg_start + scan - 1) // scan

        # one probe batch pins the staging dtypes/shapes (a pure function
        # of the step index): this rank's rows of it
        bx0, by0 = task.batch(seg_start, args.batch)
        bx0, by0 = bx0[rows[0]:rows[1]], by0[rows[0]:rows[1]]
        specs = (((scan,) + bx0.shape, bx0.dtype),
                 ((scan,) + by0.shape, by0.dtype))
        # an unsplit batch calls batch_slab as one rank always has, so a
        # stand-in for it that predates ``rows`` still serves one rank
        slab_rows = {} if rows == (0, args.batch) else {"rows": rows}

        def make_staging():
            return stager.staging(specs)

        def build_slab(c, staging):
            """Chunk c's (scan, B, ...) slab — this rank's rows of it —
            built into ``staging`` and copied to the device (the producer
            thread's body, and the synchronous path's builder: both stage
            and copy alike)."""
            g0 = seg_start + c * scan
            n = min(scan, seg_end - g0)
            return stager.stage(staging, n, lambda sx, sy: task.batch_slab(
                g0, n, args.batch, out=(sx, sy), **slab_rows))

        if pipeline:
            if pf is None:
                pf = Prefetcher(build_slab, n_chunks,
                                make_staging=make_staging,
                                depth=args.prefetch_depth)
            else:
                # rung boundary: drop the old segment's slabs; the
                # signature keeps the staging buffers where the slab
                # shapes are unchanged
                sig = tuple((shape, np.dtype(dt).str) for shape, dt in specs)
                pf.retarget(build_slab, n_chunks,
                            make_staging=make_staging, signature=sig)
        sync_staging = None if pipeline else make_staging()

        def resolve_metrics(per_host, gn_host, ev, g0, n, c):
            """Host side of chunk c's metrics, from copies queued right
            after its launch: waits for them (``ev``), never for a later
            chunk; runs in chunk order in both modes."""
            def resolve():
                if ev is not None:
                    ev.synchronize()
                # the mean runs over REAL members only (on W ranks, of the
                # per-member losses gathered from every rank)
                per = (per_host.numpy() if not sh.sharded else
                       sh.gather_members(per_host)[:, :lp.num_real].numpy())
                stats.setdefault("first_loss", float(per[0].mean()))
                mean = float(per[-1].mean())
                stats["last_loss"] = mean
                stats["chunk_loss"][g0 + n - 1] = mean
                metrics = {"loss": mean, "step": g0 + n - 1}
                if gn_host is not None:
                    metrics["grad_norm"] = float(gn_host[0])
                if c % print_every == 0:
                    gn = (f"  grad norm {metrics['grad_norm']:.3f}"
                          if gn_host is not None else "")
                    say(f"step {g0 + n - 1:4d}  mean member loss "
                        f"{mean:.4f}{gn}")
                return metrics
            return resolve

        def step_fn(state, c):
            g0 = seg_start + c * scan
            n = min(scan, seg_end - g0)
            with torch.profiler.record_function("train_chunk"):
                slab = pf.get(c) if pipeline else build_slab(c, sync_staging)
                xs, ys = slab.take()
                p, st, _losses, pers, gnorms = chunk_fn(
                    state["params"], state["extra"], xs, ys, lr, g0)
                # the host copies of this chunk's metrics, queued now
                per_host = (pers if sh.sharded else pers[:, :lp.num_real]
                            ).to("cpu", non_blocking=True)
                gn_host = (None if gnorms is None
                           else gnorms[n - 1:n].to("cpu", non_blocking=True))
                ev = None
                if device.type == "cuda":
                    ev = torch.cuda.Event()
                    ev.record()
                dm = DeferredMetrics(resolve_metrics(per_host, gn_host, ev,
                                                     g0, n, c))
                if pipeline:
                    # chunk c is launched: now pay chunk c-1's fetch
                    while pending:
                        pending.pop(0).force()
                    pending.append(dm)
                else:
                    dm.force()
            return {"params": p, "extra": st}, dm

        def on_restore(c):
            # crash replay: metrics queued for the abandoned trajectory
            # must not resolve (their chunks re-run); the prefetcher
            # re-seeks itself on the out-of-order get(c)
            pending.clear()

        def chunk_crosses_cadence(c):
            # chunk c covers global steps [g0, g1): checkpoint iff one of
            # them completes a --ckpt-every multiple
            if not args.ckpt_every:
                return False
            g0 = seg_start + c * scan
            g1 = min(g0 + scan, seg_end)
            return g1 // args.ckpt_every > g0 // args.ckpt_every

        runner = TrainRunner(
            step_fn, {"params": params, "extra": opt_state},
            ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
            straggler=StragglerPolicy(timeout_s=args.straggler_timeout),
            ckpt_meta=population_meta(lp, params,
                                      lifecycle=lifecycle_meta(),
                                      train_meta=train_meta),
            ckpt_step_map=lambda c: min(seg_start + (c + 1) * scan,
                                        seg_end) - 1,
            ckpt_step_unmap=lambda g: (g + 1 - seg_start) // scan - 1,
            ckpt_save_pred=chunk_crosses_cadence,
            on_restore=on_restore, shard=sh,
            full_like=None if not sh.distributed else {
                "params": deep.abstract_params(lp),
                "extra": opt.init(deep.abstract_params(lp))})
        n_before = kernel_launches()
        tables_before = device_mod.table_builds
        t0 = time.perf_counter()
        runner.run(n_chunks)
        # the segment's last chunk still owes its fetch: resolve it before
        # the rung boundary and the closing eval read stats
        while pending:
            pending.pop(0).force()
        _sync(device)
        n_after = kernel_launches()
        stats["segments"].append({
            "start": seg_start, "end": seg_end, "members": lp.num_real,
            "depth": lp.depth,
            "fused_hidden": [lp.layer_pop(l).total_hidden
                             for l in range(lp.depth)],
            "seconds": time.perf_counter() - t0,
            "launches": {k: n_after[k] - n_before[k] for k in n_after
                         if n_after[k] != n_before[k]},
            "tables_built": device_mod.table_builds - tables_before})
        if sh.sharded:
            stats["segments"][-1].update(
                ranks=list(sh.ranges), rank_fused_hidden=sh.widths())
        stats["restarts"] += runner.restarts
        stats["member_steps"] += lp.num_real * (seg_end - seg_start)
        return runner.state["params"], runner.state["extra"]

    # rung segments: [0, b0) prune [b0, b1) prune ... [b_last, total).  A
    # resumed run re-enters the ladder at its checkpointed rung (the
    # boundaries before it are already applied to the layout)
    segments = schedule.segments(total) if schedule else ((total, None),)
    n_eval = len(yte)
    if args.rung_eval_batches:
        n_eval = min(n_eval, args.rung_eval_batches * args.batch)
    server = None

    def publish_live(params, sh):
        """--serve-publish: refresh the serving leaderboard from the LIVE
        run, so that the published member set tracks the halving ladder
        (rung boundaries and the final state).  One f32 server (top-k
        ``min(4, real members)``), re-targeted at each call; scored over
        the rung evals' calibration rows (on W ranks, each rank's share)."""
        nonlocal server
        from repro_torch.launch.serve_population import PopulationServer
        lp = sh.lp
        if server is None:
            server = PopulationServer(params, lp, bd_impl=args.bd_impl,
                                      act_impl=args.act_impl,
                                      batch=args.batch,
                                      topk=min(4, lp.num_real), shard=sh)
        else:
            server.refresh(params, lp, shard=sh)
        server.publish(xte[:n_eval], yte[:n_eval])
        say(f"published: best1={server.published['best1']} "
            f"topk={server.published['topk']}")
        stats.setdefault("published", []).append(
            {"step": pos - 1, "best1": list(server.published["best1"]),
             "topk": list(server.published["topk"])})
        return server
    t0 = time.time()
    pos = start
    try:
        for i in range(min(rung, len(segments) - 1) if schedule else 0,
                       len(segments)):
            seg_end, keep_frac = segments[i]
            if pos < seg_end:
                params, opt_state = train_segment(params, opt_state, sh, opt,
                                                  pos, seg_end)
                pos = seg_end
            if keep_frac is None:
                continue
            # ---- rung boundary: eval (on the run's own route), prune, then
            # refill in place, compact, or compact and grow; the new layout's
            # device tables are built here, not in the next segment's step
            tables_before = device_mod.table_builds
            launches_before = sum(kernel_launches().values())
            t_r = time.perf_counter()
            losses, _ = evaluate_population(params, sh.local, xte[:n_eval],
                                            yte[:n_eval], infer=True, **route)
            n_before = lp.num_real
            rung_losses = sh.gather_members(losses.cpu()).numpy()[:n_before]
            keep = survivors(rung_losses, keep_frac)
            t_eval = time.perf_counter() - t_r
            eval_launches = sum(kernel_launches().values()) - launches_before
            rung = i + 1
            plan = None
            if controller is not None:
                plan = controller.plan(
                    lp, rung_losses, keep, member_ids, rung=rung,
                    next_id=next_id, base_lr=arch.lr,
                    lr=None if lr0 is None else lr0[member_ids],
                    momentum=None if mom0 is None else mom0[member_ids],
                    wd=None if wd0 is None else wd0[member_ids],
                    base_momentum=args.momentum, base_wd=args.weight_decay)
                # refilled recipes append at their fresh ids (plan order is id
                # order); survivors' entries are untouched
                for f in plan.members:
                    lineage[f.member_id] = (f.parent_id, f.birth_rung)
                    if lr0 is not None:
                        lr0 = np.append(lr0, np.float32(f.lr))
                    if mom0 is not None:
                        mom0 = np.append(mom0, np.float32(f.momentum))
                    if wd0 is not None:
                        wd0 = np.append(wd0, np.float32(f.wd))
                next_id += len(plan.members)
                stats["refilled"] += len(plan.members)
            t_g = time.perf_counter()
            if sh.sharded:
                # every rank takes the whole state and runs the one-rank
                # code on it: the same survivors, refills and growth
                full = sh.gather_tree({"params": params, "extra": opt_state},
                                      everywhere=True)
                full = tree_map(lambda t: t.to(device), full)
                params, opt_state = full["params"], full["extra"]
                del full
            if refill_mode == "pbt":
                # the population size is held: the layout, its tables and the
                # chunk stay; one gather/scatter and a moment mask
                fresh = None
                fm = plan.fresh_members
                if fm:
                    fresh = fresh_member_params(
                        args.seed, rung,
                        LayeredPopulation(lp.in_features, lp.out_features,
                                          tuple(f.widths for f in fm),
                                          tuple(f.acts for f in fm),
                                          block=lp.block), device)
                params = refill_params(lp, params, plan.assignments, fresh)
                opt_state = refill_state(opt_state, lp, plan.slots)
                member_ids = member_ids.copy()
                for f in plan.members:
                    member_ids[f.slot] = f.member_id
                if mom0 is not None or wd0 is not None:
                    opt = build_opt(sh)       # new recipe trees: a new chunk
                hit = (lp, opt_epoch) in chunk
                n_ex = sum(1 for f in plan.members if f.origin == "exploit")
                msg = (f"pruned {n_before - len(keep)}/{n_before}, refilled "
                       f"in place ({n_ex} exploit, "
                       f"{len(plan.members) - n_ex} fresh) -> layout "
                       "unchanged, chunk "
                       + ("cache-hit (zero re-jit)" if hit else "rebuild"))
            else:
                kept_ids = member_ids[keep]
                carry = None
                if opt_name == "adafactor":
                    # the factored statistics cannot ride the member-major
                    # gather: carry the momentum and the count, re-init the
                    # rest
                    lp_new, params, carry = compact_factored(lp, params,
                                                             opt_state, keep)
                    opt_state = None
                else:
                    lp_new, params, opt_state = compact(lp, params, opt_state,
                                                        keep)
                member_ids = kept_ids
                msg = f"kept {len(keep)}/{n_before} members -> "
                if refill_mode == "arch":
                    widths_new = tuple(f.widths for f in plan.members)
                    acts_new = tuple(f.acts for f in plan.members)
                    positions = lp_new.grow_positions(widths_new, acts_new)
                    lp_grown = lp_new.grow(widths_new, acts_new, positions)
                    fresh_lp = lp_grown.subset(tuple(sorted(positions)))
                    fresh = fresh_member_params(args.seed, rung, fresh_lp,
                                                device)
                    if carry is not None and carry["m"] is not None:
                        m = carry["m"]
                        carry = {**carry, "m": grow_params(
                            lp_new, lp_grown, m, positions,
                            deep.zeros_like_abstract(
                                deep.abstract_params(fresh_lp),
                                m["w_in"].dtype, device))}
                    lp_new, params, opt_state = grow(
                        lp_new, params, opt_state, widths_new, acts_new,
                        positions, fresh)
                    pos_of = {p: j for j, p in enumerate(positions)}
                    ids, oi = [], 0
                    for slot in range(lp_new.num_real):
                        if slot in pos_of:
                            ids.append(plan.members[pos_of[slot]].member_id)
                        else:
                            ids.append(member_ids[oi])
                            oi += 1
                    member_ids = np.asarray(ids, member_ids.dtype)
                    msg = (f"kept {len(keep)}/{n_before}, grew "
                           f"{len(plan.members)} sampled archs -> ")
                if pad > 1:
                    # re-pad to the ranks, the fillers from a generator of
                    # this rung, zero moments
                    lp_pad = lp_new.shard_pad(pad)
                    params = deep.pad_params(
                        params, lp_new, lp_pad,
                        _seeded(args.seed, 1000 + rung, device))
                    if carry is not None and carry["m"] is not None:
                        carry = {**carry, "m": deep.pad_state(
                            carry["m"], lp_new, lp_pad)}
                    elif carry is None:
                        opt_state = deep.pad_state(opt_state, lp_new, lp_pad)
                    lp_new = lp_pad
                lp = lp_new
                sh = PopulationShard(lp, mesh)
                opt = build_opt(sh)
                if carry is not None:
                    opt_state = rewarm_adafactor_state(opt.init(params), carry)
                msg += lp.describe()
            full = None
            if sh.sharded:
                full = (params, opt_state)
                params, opt_state = sh.shard(params), sh.shard(opt_state)
            _sync(device)
            t_gather = time.perf_counter() - t_g
            t_b = time.perf_counter()
            if refill_mode != "pbt":
                deep.build_tables(sh.local, device,
                                  per_member=lr0 is not None
                                  or mom0 is not None or wd0 is not None,
                                  **route)
                _sync(device)
            t_tables = time.perf_counter() - t_b
            say(f"rung {i} @ step {pos - 1}: {msg}")
            stats["rungs"].append({
                "rung": rung, "step": pos - 1, "members_before": n_before,
                "members": lp.num_real, "depth": lp.depth,
                "fused_hidden": [lp.layer_pop(l).total_hidden
                                 for l in range(lp.depth)],
                "eval_s": t_eval, "eval_launches": eval_launches,
                "gather_s": t_gather, "tables_s": t_tables,
                "tables_built": device_mod.table_builds - tables_before,
                "memory_allocated": _memory(device)})
            if sh.sharded:
                stats["rungs"][-1].update(ranks=list(sh.ranges),
                                          rank_fused_hidden=sh.widths())
            if args.ckpt_every and sh.is_writer:
                # force-save the post-rung state at the last COMPLETED step,
                # overwriting any cadence save of it: the latest checkpoint
                # always matches the live layout (on W ranks rank 0 writes
                # the whole state every rank held)
                p_all, st_all = full or (params, opt_state)
                save_population(args.ckpt_dir, pos - 1, p_all, lp,
                                extra_state=st_all,
                                lifecycle=lifecycle_meta(),
                                train_meta=train_meta)
            del full
            if args.serve_publish:
                publish_live(params, sh)
    finally:
        # no producer thread outlives the run, whether it returns or raises
        if pf is not None:
            pf.close()
    stats["staging"] = {"made": stager.made, "pinned": list(stager.pinned)}
    _sync(device)
    dt = time.time() - t0

    steps_run = max(total - start, 0)
    stats.update(steps=steps_run, seconds=dt, explored=next_id)
    if sh.sharded:
        stats.update(ranks=list(sh.ranges), rank_fused_hidden=sh.widths())
    if sh.data > 1:
        stats.update(rows=list(rows), data_reduce_calls=(
            data_reduce.calls if data_reduce else 0),
            data_reduce_s=data_reduce.seconds if data_reduce else 0.0)
    if steps_run:
        loss0 = stats.get("first_loss", 0.0)
        loss = stats.get("last_loss", 0.0)
        pop_desc = (f"{n0}->{lp.num_real}" if lp.num_real != n0
                    else f"{lp.num_real}")
        say(f"trained {pop_desc} MLPs × {steps_run} steps in "
            f"{dt:.1f}s ({stats['member_steps'] / max(dt, 1e-9):.0f} "
            f"model-steps/s); loss {loss0:.4f} -> {loss:.4f}")
        if refill_mode != "off":
            say(f"explored {next_id} models ({stats['refilled']} "
                f"refilled) in {dt:.1f}s ({next_id / max(dt, 1e-9):.2f} "
                f"models/s); {stats['chunk_builds']} chunk builds")
        if args.ckpt_every:
            # final checkpoint ONLY if the cadence didn't just write it
            # (rank 0's directory decides for every rank)
            saved = latest_steps(args.ckpt_dir) if sh.is_writer else []
            need = not saved or saved[-1] != total - 1
            if sh.distributed:
                need = bool(mesh.broadcast_int(need))
            if need:
                p_all, st_all = params, opt_state
                if sh.distributed:
                    got = sh.gather_tree({"params": params,
                                          "extra": opt_state})
                    p_all, st_all = (got or {}).get("params"), \
                        (got or {}).get("extra")
                if sh.is_writer:
                    save_population(args.ckpt_dir, total - 1, p_all, lp,
                                    extra_state=st_all,
                                    lifecycle=lifecycle_meta(),
                                    train_meta=train_meta)
    if args.serve_publish:
        # final refresh: the served set matches the state the run ended on
        publish_live(params, sh)

    losses, accs = evaluate_population(params, sh.local, xte, yte,
                                       infer=True, **route)
    losses, accs = sh.gather_members(losses), sh.gather_members(accs)
    say("leaderboard:")
    for row in leaderboard(lp, losses, accs, k=min(10, lp.num_real),
                           member_ids=member_ids,
                           lineage=lineage if refill_mode != "off"
                           else None):
        lin = ""
        if "lineage" in row:
            li = row["lineage"]
            lin = (f"  born r{li['born_rung']}"
                   + (f" of {li['parent']}" if li["parent"] >= 0
                      else " fresh" if li["born_rung"] else " seed"))
        say(f"  #{row['rank']:2d} member {row['member']:4d} "
            f"hidden={row['hidden']} {row['activation']:11s} "
            f"loss={row['loss']:.4f} acc={row['acc']:.3f}{lin}")
    return params, lp, stats


def parser() -> argparse.ArgumentParser:
    """The driver's flags (the JAX driver's names)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="laptop-scale family config (smoke/CI)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128,
                    help="LM archs: tokens a sequence")
    ap.add_argument("--num-micro", type=int, default=1,
                    help="LM archs: microbatches a step (gradient "
                         "accumulation; must divide --batch)")
    ap.add_argument("--grad-clip", type=float, default=None,
                    help="global-norm gradient clip; populations: default "
                         "OFF (0 disables; when set, the pre-clip norm is "
                         "logged); LM archs: 1.0 when unset")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a new temporary "
                         "directory under $TMPDIR; --resume needs it)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--straggler-timeout", type=float, default=1e9)
    ap.add_argument("--population-depths", default=None,
                    help='heterogeneous-depth spec, e.g. "64,32,16;13,5;7" '
                         "(members by ';', per-layer widths by ',')")
    ap.add_argument("--population-acts", default="relu",
                    help="comma list cycled over members, or 'paper' for "
                         "the ten paper activations")
    ap.add_argument("--population-repeats", type=int, default=1)
    ap.add_argument("--population-features", type=int, default=20)
    ap.add_argument("--population-classes", type=int, default=2)
    ap.add_argument("--population-block", type=int, default=8)
    ap.add_argument("--samples", type=int, default=2048)
    ap.add_argument("--m3-impl", default="bucketed",
                    choices=["scatter", "onehot", "bucketed", "pallas"])
    ap.add_argument("--bd-impl", default="einsum",
                    choices=["einsum", "pallas", "fused"],
                    help="mid-layer projection: per-bucket einsum, the "
                         "block-diagonal GEMM kernel (pallas: bias and "
                         "activation after it), or the FUSED kernels "
                         "(projection + bias + activation in one launch "
                         "per direction)")
    ap.add_argument("--compute-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--rung-eval-batches", type=int, default=0,
                    help="halving rungs: evaluate only this many --batch-"
                         "sized held-out batches at each rung boundary (0 = "
                         "the whole split; the closing leaderboard always "
                         "scores the whole split)")
    ap.add_argument("--act-impl", default="sliced",
                    choices=["sliced", "masked", "pallas"],
                    help="per-layer activation of the unfused route "
                         "(pallas: the segmented-activation kernel)")
    ap.add_argument("--scan-steps", type=int, default=8,
                    help="optimizer steps per chunk (metrics are fetched "
                         "once per chunk)")
    ap.add_argument("--pipeline", default="on", choices=["on", "off"],
                    help="the streaming data plane: 'on' builds and copies "
                         "chunk c+1's slab on a producer thread (pinned "
                         "staging, a side-stream copy) while chunk c runs "
                         "and fetches chunk c's metrics after chunk c+1 is "
                         "launched; 'off' does both on the training thread "
                         "(bitwise the same trajectory)")
    ap.add_argument("--prefetch-depth", type=int, default=2,
                    help="--pipeline on: how many chunks the producer may "
                         "run ahead")
    ap.add_argument("--serve-publish", action="store_true")
    ap.add_argument("--per-member-lr", action="store_true")
    ap.add_argument("--lr-schedule", default="constant",
                    choices=["constant", "warmup_cosine"],
                    help="per-step LR multiplier (warmup over --warmup "
                         "steps, cosine decay to 10%% over --steps)")
    ap.add_argument("--optimizer", default=None,
                    choices=["sgd", "momentum", "adamw", "adafactor"],
                    help="default: the arch's optimizer (sgd for "
                         "parallelmlp)")
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--weight-decay", type=float, default=0.0)
    ap.add_argument("--opt-state-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--per-member-momentum", action="store_true")
    ap.add_argument("--per-member-weight-decay", action="store_true")
    ap.add_argument("--halving", default=None,
                    help='successive-halving rungs "STEP:KEEP,..." (e.g. '
                         '"500:0.5,1000:0.25"): after each listed global '
                         "step keep the best fraction of the members and "
                         "compact the layout (rungs at or past --steps "
                         "never fire; resume with the same spec)")
    ap.add_argument("--refill", default="off",
                    choices=["off", "pbt", "arch"],
                    help="refill the slots a --halving rung frees: 'pbt' "
                         "clones same-arch survivors with perturbed recipes "
                         "(fresh members where none matches) and keeps the "
                         "layout; 'arch' samples architectures from "
                         "--search-space and grows the layout")
    ap.add_argument("--search-space", default=None,
                    help="search-space spec for --refill and the "
                         "--per-member-* ranges, ';'-separated, e.g. "
                         "\"widths=64,32|16,8;acts=relu,tanh;lr=0.3..3\"")
    ap.add_argument("--refill-exploit-frac", type=float, default=0.5,
                    help="--refill pbt: clones draw from the best FRAC of "
                         "the slot-arch-matching survivors")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "PyTorch versions); under torchrun each rank "
                         "takes cuda:(LOCAL_RANK mod the cards)")
    ap.add_argument("--shard-pad", type=int, default=None,
                    help="pad the population for this many ranks of the "
                         "population axis (default: the world's), so that "
                         "a run on fewer ranks follows theirs member for "
                         "member, fillers included")
    ap.add_argument("--dist-timeout", type=float, default=600.0,
                    help="under torchrun: the process group's timeout in "
                         "seconds, the longest a rank waits for the others "
                         "in a collective before the run fails")
    return ap


def main(argv=None):
    """Train ``--arch``: a population → ``(params, layout, stats)``
    (``run_population``); an LM → its ``TrainRunner`` (``run_lm``)."""
    args = parser().parse_args(argv)

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import close, make_host_mesh
    arch = get_arch(args.arch, reduced=args.reduced)
    mesh = make_host_mesh(timeout_s=args.dist_timeout)
    try:
        if arch.kind == "population":
            return run_population(arch, args, mesh=mesh)
        return run_lm(arch, args, mesh=mesh)
    finally:
        close(mesh)


if __name__ == "__main__":
    main()
