"""Quickstart — the paper's experiment end-to-end at laptop scale, through
the PyTorch port (the twin of ``examples/quickstart.py``).

Trains a heterogeneous population of MLPs (hidden sizes × all ten paper
activations, fused into ONE network) on a synthetic tabular task, then does
model selection over the population — the workflow the paper's speedup
enables (§5: "perform model selection in the large pool of trained MLPs").

    PYTHONPATH=src python examples/torch_quickstart.py [--members 400] \
        [--steps 200] [--device cpu] [--m3-impl pallas]

Runs on the card unless ``--device cpu``; ``--m3-impl pallas`` puts every
step and the evaluation on the M3 kernels.
"""
import argparse
import math
import time

import torch

from repro_torch.core import parallel_mlp as pm
from repro_torch.core.activations import PAPER_TEN
from repro_torch.core.population import Population
from repro_torch.core.selection import (evaluate_population, leaderboard,
                                        select_best)
from repro_torch.data.synthetic import TabularTask
from repro_torch.device import resolve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--members", type=int, default=400)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--features", type=int, default=20)
    ap.add_argument("--samples", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--per-member-lr", action="store_true",
                    help="paper §7: every member gets its own step size")
    ap.add_argument("--device", default=None,
                    help="default: the card; cpu runs the plain versions")
    ap.add_argument("--m3-impl", default="bucketed",
                    choices=["scatter", "bucketed", "onehot", "pallas"])
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    task = TabularTask(args.samples, args.features, n_classes=2, seed=0)
    (xtr, ytr), (xte, yte) = task.split()
    hidden = range(1, args.members // (10 * 2) + 1)
    pop = Population.grid(args.features, 2, hidden, PAPER_TEN,
                          repeats=2, block=8)
    print(f"fused population: {pop.describe()}")

    gen = torch.Generator(device=dev)
    params = pm.init_params(gen.manual_seed(0), pop, device=dev)
    lr = args.lr
    if args.per_member_lr:
        u = torch.rand(pop.num_members, generator=gen.manual_seed(1),
                       device=dev)
        lr = torch.exp(math.log(0.01) + u * (math.log(0.3) - math.log(0.01)))
        print("per-member learning rates in [0.01, 0.3]")

    t0 = time.time()
    for step in range(args.steps):
        xb, yb = task.batch(step, args.batch)
        params, loss, per = pm.sgd_step(
            params, torch.as_tensor(xb, device=dev),
            torch.as_tensor(yb, device=dev), lr, pop, m3_impl=args.m3_impl)
        if step % 50 == 0:
            print(f"step {step:4d}  mean member loss "
                  f"{float(loss) / pop.num_members:.4f}")
    dt = time.time() - t0
    print(f"trained {pop.num_members} MLPs × {args.steps} steps "
          f"in {dt:.1f}s ({pop.num_members * args.steps / dt:.0f} "
          f"model-steps/s)")

    losses, accs = evaluate_population(params, pop, xte, yte,
                                       m3_impl=args.m3_impl)
    m, best = select_best(params, pop, losses)
    print(f"\nbest member #{m}: hidden={pop.hidden_sizes[m]} "
          f"act={pop.activations[m]} loss={float(losses[m]):.4f} "
          f"acc={float(accs[m]):.3f}")
    print("\nleaderboard:")
    rows = leaderboard(pop, losses, accs, k=10)
    for row in rows:
        print(f"  #{row['rank']:2d} member {row['member']:4d} "
              f"hidden={row['hidden']:3d} {row['activation']:11s} "
              f"loss={row['loss']:.4f} acc={row['acc']:.3f}")
    return rows


if __name__ == "__main__":
    main()
