"""Population training driver: ``python -m repro_torch.launch.train --arch
parallelmlp-10k [...]``, with the JAX package's flag names and prints
(``repro.launch.train``), on one card.

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

Single device: the population is not shard-padded.  Flags whose paths are
not ported yet raise ``NotImplementedError`` naming the ROADMAP item:
``--halving``, ``--refill``, ``--per-member-*``, ``--compute-dtype
bfloat16``, ``--optimizer adafactor``, ``--opt-state-dtype bfloat16``,
``--serve-publish`` and ``--pipeline on``.
``--pipeline`` defaults to ``off`` here (the JAX package's trajectory is
bit-identical either way).
"""
from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch

_QUEUE1 = "not ported yet (ROADMAP.md, Queue 1"


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


def check_supported(args):
    """Raise ``NotImplementedError`` for every flag whose path the port
    does not have yet."""
    unsupported = [
        (args.halving, "--halving: the successive-halving lifecycle is "
         f"{_QUEUE1}, item 5)"),
        (args.refill != "off", "--refill: the slot-refill search is "
         f"{_QUEUE1}, item 5)"),
        (args.search_space, "--search-space: the search space is "
         f"{_QUEUE1}, item 5)"),
        (args.per_member_lr or args.per_member_momentum
         or args.per_member_weight_decay,
         "--per-member-*: the per-member recipe vectors draw through "
         f"search/space.py, {_QUEUE1}, item 5)"),
        (args.compute_dtype != "float32", "--compute-dtype bfloat16: the "
         f"bf16 policy is {_QUEUE1}, item 6)"),
        (args.optimizer == "adafactor", "--optimizer adafactor is "
         f"{_QUEUE1}, item 2)"),
        (args.opt_state_dtype != "float32", "--opt-state-dtype bfloat16 is "
         f"{_QUEUE1}, item 2)"),
        (args.serve_publish, "--serve-publish: PopulationServer.refresh "
         f"from a live run is {_QUEUE1}, item 6)"),
        (args.pipeline == "on", "--pipeline on: the streaming data plane "
         f"is {_QUEUE1}, item 7)"),
    ]
    for bad, why in unsupported:
        if bad:
            raise NotImplementedError(why)


def optimizer_record(arch, args, opt_name: str, grad_clip) -> dict:
    """The record checkpoints carry under ``meta["train"]["optimizer"]`` —
    the JAX package's schema, so a resume in either package validates it."""
    rec = {"name": opt_name, "lr": float(arch.lr),
           "grad_clip": float(grad_clip or 0.0),
           "per_member_lr": False, "per_member_momentum": False,
           "per_member_weight_decay": False}
    if opt_name == "momentum":
        rec["momentum"] = float(args.momentum)
    if opt_name in ("adamw", "adafactor"):
        rec["weight_decay"] = float(args.weight_decay)
    if opt_name == "adamw":
        rec["state_dtype"] = args.opt_state_dtype
    return rec


def _build_opt(opt_name: str, args):
    from repro_torch.optim.optimizers import adamw, sgd
    if opt_name == "sgd":
        return sgd()
    if opt_name == "momentum":
        return sgd(momentum=args.momentum)
    return adamw(weight_decay=args.weight_decay)


def run_population(arch, args):
    """Fused population training on one device → ``(params, layout,
    stats)``; ``stats``: first/last mean member loss, steps, seconds."""
    from repro_torch.checkpoint.checkpoint import (latest_steps,
                                                   layout_from_meta,
                                                   lifecycle_from_meta,
                                                   load_meta,
                                                   population_meta,
                                                   require_optimizer_match,
                                                   restore_population,
                                                   save_population)
    from repro_torch.core import deep
    from repro_torch.core.population import Population
    from repro_torch.core.selection import evaluate_population, leaderboard
    from repro_torch.data.synthetic import TabularTask
    from repro_torch.device import resolve
    from repro_torch.distributed.fault_tolerance import (StragglerPolicy,
                                                         TrainRunner)
    from repro_torch.optim.optimizers import warmup_cosine

    check_supported(args)
    if args.ckpt_dir is None:
        if args.resume:
            raise SystemExit("--resume needs --ckpt-dir")
        args.ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
        print(f"checkpoints: {args.ckpt_dir}")
    device = resolve(args.device)
    opt_name = args.optimizer or arch.optimizer
    grad_clip = args.grad_clip if args.grad_clip else None
    if opt_name not in ("sgd", "momentum", "adamw"):
        raise SystemExit(f"unknown optimizer {opt_name!r}")
    opt_record = optimizer_record(arch, args, opt_name, grad_clip)

    if args.population_depths:
        lp = population_from_flags(
            args.population_depths, args.population_acts,
            args.population_features, args.population_classes,
            args.population_repeats, args.population_block)
    else:
        model = arch.model
        lp = model.layered() if isinstance(model, Population) else model
    scan = max(args.scan_steps, 1)
    print(f"device={device} scan_steps={scan}")

    start = 0
    rung = 0
    resuming = bool(args.resume and latest_steps(args.ckpt_dir))
    if resuming:
        meta, last = load_meta(args.ckpt_dir)
        stored = require_optimizer_match(meta, opt_record)
        if stored is None and opt_name != "sgd":
            raise SystemExit(
                f"--resume: the checkpoint at step {last} carries no "
                "optimizer state; it can only resume with the stateless "
                "'--optimizer sgd'")
        lp_meta = layout_from_meta(meta)
        if lp_meta.n_pad:
            raise NotImplementedError(
                "--resume: the checkpoint's layout is shard-padded for a "
                "multi-device mesh; multi-GPU is not ported yet "
                "(ROADMAP.md, Queue 1, item 8)")
        rung, member_ids, n0 = lifecycle_from_meta(meta, lp_meta)
        if rung:
            raise NotImplementedError(
                "--resume: the checkpoint is mid-way through a halving "
                f"ladder; the lifecycle is {_QUEUE1}, item 5)")
        opt = _build_opt(opt_name, args)
        if stored is None:
            params, lp, _ = restore_population(args.ckpt_dir, device=device)
            opt_state = opt.init(params)
        else:
            params, lp, _, opt_state = restore_population(
                args.ckpt_dir, device=device,
                extra_like=opt.init(deep.abstract_params(lp_meta)))
        start = last + 1
        print(f"resumed from step {last}")
    else:
        n0 = lp.num_members
        member_ids = np.arange(n0)
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = deep.init_params(gen, lp)
        opt = _build_opt(opt_name, args)
        opt_state = opt.init(params)
    print(f"population: {lp.describe()}  optimizer: {opt_name}"
          + (f" (grad clip {grad_clip})" if grad_clip else ""))

    task = TabularTask(args.samples, lp.in_features,
                       n_classes=lp.out_features, seed=args.seed)
    (_, _), (xte, yte) = task.split()
    lifecycle = {"rung": rung, "n_members0": int(n0),
                 "member_ids": [int(i) for i in member_ids]}
    train_meta = {"compute_dtype": args.compute_dtype,
                  "bd_impl": args.bd_impl, "act_impl": args.act_impl,
                  "optimizer": opt_record, "lr_schedule": args.lr_schedule}
    lr_sched = (warmup_cosine(1.0, args.warmup, args.steps)
                if args.lr_schedule == "warmup_cosine" else None)
    chunk_fn = deep.make_population_train_step(
        lp, optimizer=opt, grad_clip=grad_clip, m3_impl=args.m3_impl,
        bd_impl=args.bd_impl, act_impl=args.act_impl, scan_steps=scan,
        lr_schedule=lr_sched)

    total = args.steps
    n_chunks = (total - start + scan - 1) // scan
    print_every = max(50 // scan, 1)
    stats = {}

    def step_fn(state, c):
        g0 = start + c * scan
        n = min(scan, total - g0)
        xs, ys = task.batch_slab(g0, n, args.batch)
        p, st, _losses, pers, gnorms = chunk_fn(
            state["params"], state["extra"],
            torch.from_numpy(xs).to(device), torch.from_numpy(ys).to(device),
            arch.lr, g0)
        # one fetch per chunk; the mean runs over REAL members only
        per = pers[:, :lp.num_real].cpu().numpy()
        stats.setdefault("first_loss", float(per[0].mean()))
        mean = float(per[-1].mean())
        stats["last_loss"] = mean
        metrics = {"loss": mean, "step": g0 + n - 1}
        if gnorms is not None:
            metrics["grad_norm"] = float(gnorms[n - 1].cpu())
        if c % print_every == 0:
            gn = (f"  grad norm {metrics['grad_norm']:.3f}"
                  if gnorms is not None else "")
            print(f"step {g0 + n - 1:4d}  mean member loss {mean:.4f}{gn}")
        return {"params": p, "extra": st}, metrics

    def chunk_crosses_cadence(c):
        # chunk c covers global steps [g0, g1): checkpoint iff one of them
        # completes a --ckpt-every multiple
        if not args.ckpt_every:
            return False
        g0 = start + c * scan
        g1 = min(g0 + scan, total)
        return g1 // args.ckpt_every > g0 // args.ckpt_every

    runner = TrainRunner(
        step_fn, {"params": params, "extra": opt_state},
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        straggler=StragglerPolicy(timeout_s=args.straggler_timeout),
        ckpt_meta=population_meta(lp, params, lifecycle=lifecycle,
                                  train_meta=train_meta),
        ckpt_step_map=lambda c: min(start + (c + 1) * scan, total) - 1,
        ckpt_step_unmap=lambda g: (g + 1 - start) // scan - 1,
        ckpt_save_pred=chunk_crosses_cadence)
    t0 = time.time()
    runner.run(n_chunks)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    params, opt_state = runner.state["params"], runner.state["extra"]

    steps_run = max(total - start, 0)
    stats.update(steps=steps_run, seconds=dt, restarts=runner.restarts)
    if steps_run:
        loss0 = stats.get("first_loss", 0.0)
        loss = stats.get("last_loss", 0.0)
        print(f"trained {lp.num_real} MLPs × {steps_run} steps in "
              f"{dt:.1f}s ({lp.num_real * steps_run / max(dt, 1e-9):.0f} "
              f"model-steps/s); loss {loss0:.4f} -> {loss:.4f}")
        if args.ckpt_every:
            # final checkpoint ONLY if the cadence didn't just write it
            saved = latest_steps(args.ckpt_dir)
            if not saved or saved[-1] != total - 1:
                save_population(args.ckpt_dir, total - 1, params, lp,
                                extra_state=opt_state, lifecycle=lifecycle,
                                train_meta=train_meta)

    losses, accs = evaluate_population(params, lp, xte, yte,
                                       bd_impl=args.bd_impl,
                                       act_impl=args.act_impl,
                                       m3_impl=args.m3_impl, infer=True)
    print("leaderboard:")
    for row in leaderboard(lp, losses, accs, k=min(10, lp.num_real),
                           member_ids=member_ids):
        print(f"  #{row['rank']:2d} member {row['member']:4d} "
              f"hidden={row['hidden']} {row['activation']:11s} "
              f"loss={row['loss']:.4f} acc={row['acc']:.3f}")
    return params, lp, stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="laptop-scale family config (smoke/CI)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--grad-clip", type=float, default=None,
                    help="global-norm gradient clip, default OFF (0 "
                         "disables; when set, the pre-clip norm is logged)")
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
                    help="halving rungs only (not ported yet)")
    ap.add_argument("--act-impl", default="sliced",
                    choices=["sliced", "masked", "pallas"],
                    help="per-layer activation of the unfused route "
                         "(pallas: the segmented-activation kernel)")
    ap.add_argument("--scan-steps", type=int, default=8,
                    help="optimizer steps per chunk (metrics are fetched "
                         "once per chunk)")
    ap.add_argument("--pipeline", default="off", choices=["on", "off"],
                    help="the streaming data plane (not ported yet; 'off' "
                         "is the synchronous build-then-run loop)")
    ap.add_argument("--prefetch-depth", type=int, default=2)
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
    ap.add_argument("--halving", default=None)
    ap.add_argument("--refill", default="off",
                    choices=["off", "pbt", "arch"])
    ap.add_argument("--search-space", default=None)
    ap.add_argument("--refill-exploit-frac", type=float, default=0.5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_arch
    arch = get_arch(args.arch, reduced=args.reduced)
    return run_population(arch, args)


if __name__ == "__main__":
    main()
