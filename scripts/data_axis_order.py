#!/usr/bin/env python3
"""How far a reordered batch sum carries through training: the depth-3
population trained on the whole batch, against the same steps with the
batch split over a data axis of D (each share's means averaged, as
``sharding.DataReduce`` averages them) and with the rows of every batch
permuted (one batch, summed in another order).  First, that the fused
route is right at every row count a share may have: its per-member
losses and gradients against the plain route's (``bd_impl="einsum"``) on
the same device, at B 8, 16, 24, 32 and 48.

    PYTHONPATH=src python3 scripts/data_axis_order.py [--repeats 20]
        [--steps 12] [--batch 48] [--data 3] [--device cpu]

Runs on the card unless ``--device cpu`` is passed.

Trains with ``chip_smoke.py``'s depth-3 flags (``--population-depths
"64,32,16;13,5;7" --population-acts paper --population-features 100``,
parallelmlp-10k's lr 1e-2 under ``warmup_cosine`` with 10 warm-up steps,
the fused route) under sgd and under AdamW with a clip of 1.0, and
prints for each optimizer and each reordering the max |difference| from
the whole-batch run over the parameters and the count of elements beyond
the optimizer tolerance (rtol 1e-5 / atol 1e-6).  The D shares run in D
threads whose all-reduce meets at a barrier, rank order fixed.
"""
import argparse
import threading

import torch

from repro_torch.core import deep
from repro_torch.core.tree import tree_leaves
from repro_torch.data.synthetic import TabularTask
from repro_torch.device import resolve
from repro_torch.distributed.sharding import DataReduce
from repro_torch.launch.train import population_from_flags
from repro_torch.optim import optimizers


class ThreadColumn(DataReduce):
    """``DataReduce`` over D threads, summed in rank order at a barrier."""

    def __init__(self, n, rank, board, barrier):
        super().__init__(None, n)
        self.rank, self.board, self.barrier = rank, board, barrier

    def sum(self, flat):
        self.board[self.rank] = flat
        self.barrier.wait()
        out = sum(self.board[r] for r in range(len(self.board)))
        self.barrier.wait()
        return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--data", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    lp = population_from_flags("64,32,16;13,5;7", "paper", 100, 2,
                               args.repeats, 8)
    params = deep.init_params(torch.Generator(device=dev).manual_seed(0), lp)
    task = TabularTask(2048, 100, seed=0)
    xs, ys = (torch.as_tensor(a, device=dev)
              for a in task.batch_slab(0, args.steps, args.batch))
    sched = optimizers.warmup_cosine(1.0, 10, args.steps)
    rows = args.batch // args.data
    out = {}
    for b in (8, 16, 24, 32, 48):
        x, y = (torch.as_tensor(a, device=dev) for a in task.batch(3, b))
        _, per_f, g_f = deep.loss_and_grads(params, x, y, lp,
                                            bd_impl="fused")
        _, per_p, g_p = deep.loss_and_grads(params, x, y, lp,
                                            bd_impl="einsum")
        rel = max(float((a - c).abs().max() / c.abs().max().clamp_min(
            1e-30)) for a, c in zip(tree_leaves(g_f), tree_leaves(g_p)))
        out[("grads", b)] = rel
        print(f"B {b:2d}: fused against plain, per-member losses max "
              f"|diff| {float((per_f - per_p).abs().max())!r}, gradients "
              f"max |diff| / max |g| over the leaves {rel!r}")
    for name, make, clip in (("sgd", optimizers.sgd, None),
                             ("adamw+clip", optimizers.adamw, 1.0)):
        opt = make()

        def run(x, y, red=None):
            p, st = params, opt.init(params)
            for k in range(args.steps):
                lr = 1e-2 * sched(k)
                p, st, *_ = deep.opt_step(p, st, x[k], y[k], lr, opt, lp,
                                          bd_impl="fused", grad_clip=clip,
                                          data_reduce=red)
            return p

        whole = run(xs, ys)
        board = [None] * args.data
        barrier = threading.Barrier(args.data)
        shares = [None] * args.data

        def share(r):
            sl = slice(r * rows, (r + 1) * rows)
            shares[r] = run(xs[:, sl].contiguous(), ys[:, sl].contiguous(),
                            ThreadColumn(args.data, r, board, barrier))

        threads = [threading.Thread(target=share, args=(r,))
                   for r in range(args.data)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        perm = torch.randperm(args.batch,
                              generator=torch.Generator().manual_seed(5))
        permuted = run(xs[:, perm].contiguous(), ys[:, perm].contiguous())
        for what, got in (("split", shares[0]), ("permuted", permuted)):
            gap, beyond, n = 0.0, 0, 0
            for a, b in zip(tree_leaves(got), tree_leaves(whole)):
                gap = max(gap, float((a - b).abs().max()))
                beyond += int((~torch.isclose(a, b, rtol=1e-5,
                                              atol=1e-6)).sum())
                n += a.numel()
            out[(name, what)] = (gap, beyond, n)
            print(f"{name:10s} {what:8s} against the whole batch: max "
                  f"|diff| {gap!r}, {beyond} of {n} beyond rtol 1e-5 / "
                  f"atol 1e-6")
    return out


if __name__ == "__main__":
    main()
