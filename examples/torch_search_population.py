"""Slot-refill search over a fused MLP population, through the PyTorch
port (the twin of ``examples/search_population.py``; DESIGN.md §13).

    PYTHONPATH=src python examples/torch_search_population.py \
        [--device cpu] [--steps 48] [--ladder "12:0.5,24:0.5,36:0.5"]

Plain successive halving prunes losers and lets the freed device slots
idle.  This demo runs the same rung ladder with the search controller
instead: at every rung the losers are pruned AND their slots are
refilled in place — PBT-style exploit clones of the best survivors with
perturbed learning rates, plus fresh inits where no same-arch survivor
exists.  Because the population size (and therefore the fused layout)
never changes, every rung boundary is one gather/scatter on the device,
the WHOLE ladder trains through a single chunk and no device table is
built after the first step — the demo counts both to prove it, then
prints the lineage-annotated leaderboard ("r2 of 3" = cloned from member
3 at rung 2).  Runs on the card unless ``--device cpu``.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core import deep as deep_mod
from repro_torch.core import lifecycle
from repro_torch.core.population import LayeredPopulation
from repro_torch.core.selection import evaluate_population
from repro_torch.data.synthetic import TabularTask
from repro_torch.device import resolve
from repro_torch.launch.train import fresh_member_params
from repro_torch.optim.optimizers import sgd
from repro_torch.search import RefillController, SearchSpace

SEED = 0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the card; cpu runs the plain versions")
    ap.add_argument("--steps", type=int, default=48)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--ladder", default="12:0.5,24:0.5,36:0.5")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--samples", type=int, default=4096)
    ap.add_argument("--bd-impl", default="fused",
                    choices=["fused", "pallas", "einsum"])
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    lp = LayeredPopulation.grid(
        16, 2, [(32, 16), (24, 12), (16, 8), (8, 4)], ("relu", "tanh"),
        repeats=args.repeats, block=8)
    n0 = lp.num_members
    space = SearchSpace.parse("lr=0.3..3;lr_perturb=0.8,1.25")
    controller = RefillController(space, mode="pbt", seed=SEED)
    print(f"population: {lp.describe()}")
    print(f"ladder: {args.ladder} over {args.steps} steps, space: "
          "lr=0.3..3\n")

    task = TabularTask(args.samples, 16, n_classes=2, seed=SEED)
    _, (xte, yte) = task.split()

    params = deep_mod.init_params(
        torch.Generator(device=dev).manual_seed(SEED), lp)
    # per-member lr drawn from the SAME space the controller perturbs
    lr = np.array(space.init_lr(SEED, n0, 0.05), np.float32)
    member_ids = np.arange(n0)
    lineage = {int(i): (-1, 0) for i in member_ids}   # id -> (parent, rung)
    next_id = n0

    # ONE chunk for the whole run: the per-member lr is an argument of
    # every call, so refilled recipes re-enter the same chunk
    schedule = lifecycle.HalvingSchedule.parse(args.ladder)
    segments = schedule.segments(args.steps)
    scan = max(end - start for start, (end, _) in zip(
        [0] + [e for e, _ in segments[:-1]], segments))
    opt = sgd()
    opt_state = opt.init(params)
    route = dict(bd_impl=args.bd_impl, act_impl="pallas"
                 if args.bd_impl != "fused" else "sliced")
    chunk, builds, tables = None, 0, None
    pos = 0
    t0 = time.perf_counter()
    for rung, (end, frac) in enumerate(segments, start=1):
        if chunk is None:       # built exactly once: the layout never changes
            chunk = deep_mod.make_population_train_step(
                lp, optimizer=opt, scan_steps=scan, **route)
            builds += 1
        xs, ys = task.batch_slab(pos, end - pos, args.batch)
        params, opt_state, _, _, _ = chunk(
            params, opt_state, torch.as_tensor(xs, device=dev),
            torch.as_tensor(ys, device=dev), torch.as_tensor(lr,
                                                             device=dev))
        if tables is None:      # every table the step reads is built now
            tables = device_mod.table_builds
        pos = end
        if frac is None:
            continue
        losses, _ = evaluate_population(params, lp, xte, yte, infer=True,
                                        **route)
        losses = losses.cpu().numpy()
        keep = lifecycle.survivors(losses, frac)
        plan = controller.plan(lp, losses, keep, member_ids, rung=rung,
                               next_id=next_id, base_lr=0.05, lr=lr)
        fresh = None
        if plan.fresh_members:
            fresh = fresh_member_params(SEED, rung, LayeredPopulation(
                lp.in_features, lp.out_features,
                tuple(f.widths for f in plan.fresh_members),
                tuple(f.acts for f in plan.fresh_members),
                block=lp.block), dev)
        params = lifecycle.refill_params(lp, params, plan.assignments, fresh)
        member_ids = member_ids.copy()
        for f in plan.members:
            member_ids[f.slot] = f.member_id
            lineage[f.member_id] = (f.parent_id, f.birth_rung)
            lr[f.slot] = f.lr
        next_id += len(plan.members)
        n_ex = sum(1 for f in plan.members if f.origin == "exploit")
        print(f"rung {rung} @ step {end}: pruned {n0 - len(keep)}, "
              f"refilled {len(plan.members)} ({n_ex} exploit clones, "
              f"{len(plan.members) - n_ex} fresh) — layout unchanged")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    rebuilt = device_mod.table_builds - tables

    losses, _ = evaluate_population(params, lp, xte, yte, infer=True,
                                    **route)
    losses = losses.cpu().numpy()
    order = np.argsort(losses)[:5]
    print(f"\nexplored {next_id} models in {dt:.1f}s "
          f"({next_id / dt:.1f} models/s) with {builds} chunk build, "
          f"{rebuilt} tables built after the first chunk")
    print("\nrank  loss     id   lr      born")
    rows = []
    for r, slot in enumerate(order, start=1):
        mid = int(member_ids[slot])
        parent, born = lineage[mid]
        origin = ("seed" if born == 0 else
                  f"r{born} of {parent}" if parent >= 0 else f"r{born} fresh")
        print(f"{r:4d}  {float(losses[slot]):.4f}  {mid:3d}  "
              f"{lr[slot]:.4f}  {origin}")
        rows.append({"rank": r, "loss": float(losses[slot]), "id": mid,
                     "lr": float(lr[slot]), "born": origin})
    assert builds == 1, "constant-size refill must never rebuild the chunk"
    assert rebuilt == 0, "constant-size refill must build no device table"
    return {"explored": next_id, "chunk_builds": builds,
            "tables_rebuilt": rebuilt, "leaderboard": rows,
            "member_ids": member_ids.tolist()}


if __name__ == "__main__":
    main()
