"""The paper's Tables 1–2: fused ParallelMLP training against training its
members one at a time, wall clock, on the card.

    python -m repro_torch.launch.paper_tables [--full] [--block 1]
        [--m3-impl scatter|bucketed|onehot|pallas] [--device cpu]

The port's twin of the JAX package's ``benchmarks/bench_paper_tables.py``,
with its flags and defaults.  The paper trains 10,000 MLPs (hidden 1..100 ×
10 activations × 10 repeats: ``--full``) on synthetic datasets with samples
∈ {100, 1k, 10k}, features ∈ {5, 10, 50, 100}, batch ∈ {32, 128, 256},
timing 10 epochs.

  * The parallel arm (``parallel_time``) is ``parallel_mlp.sgd_step`` over
    the fused population: one warm-up step, then ``steps_per_epoch ×
    epochs`` steps, the card synchronised before the clock starts and
    after the loop; nothing in the loop reads a value back to the host.
  * The sequential arm (``sequential_time``) trains a stratified sample of
    members (``--seq-sample``) alone for one epoch each, after one
    warm-up step each, and extrapolates to P members × epochs (the arm is
    linear in P by construction; ±σ is the spread over the sample).  Its
    step is a plain, eager PyTorch MLP step (forward, ``log_softmax``,
    mean NLL, ``torch.autograd.grad``, ``p − lr·g``): the paper's
    baseline, which launches no kernel of the port.
  * Both arms copy each batch of ``TabularTask`` to the device once a step
    (pinned, without waiting on the card), as the JAX bench's
    ``jnp.asarray`` does.

Prints the CSV of the JAX bench:
  samples,features,batch,members,parallel_s,sequential_s,sequential_sigma,
  ratio_pct,speedup
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import parallel_mlp as pm
from repro_torch.core.activations import ACTIVATIONS, PAPER_TEN
from repro_torch.core.population import Population
from repro_torch.data.synthetic import TabularTask
from repro_torch.device import resolve

HEADER = ("samples,features,batch,members,parallel_s,sequential_s,"
          "sequential_sigma,ratio_pct,speedup")


def _batch(task: TabularTask, step: int, batch: int, dev: torch.device):
    """Batch ``step`` of ``task`` on ``dev``: through pinned memory and a
    copy that does not wait on the card."""
    x, y = (torch.from_numpy(a) for a in task.batch(step, batch))
    if dev.type != "cuda":
        return x, y
    return (x.pin_memory().to(dev, non_blocking=True),
            y.pin_memory().to(dev, non_blocking=True))


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _init(pop: Population, dev: torch.device) -> dict:
    """Both arms start from the same seeded parameters."""
    return pm.init_params(torch.Generator(device=dev).manual_seed(0), pop,
                          device=dev)


def parallel_train(params: dict, pop: Population, task: TabularTask,
                   batch: int, steps: int, lr: float = 0.01,
                   m3_impl: str = "scatter") -> dict:
    """``steps`` fused SGD steps on batches 0 … steps − 1 → the trained
    parameters."""
    dev = params["w1"].device
    for step in range(steps):
        x, y = _batch(task, step, batch, dev)
        params, _, _ = pm.sgd_step(params, x, y, lr, pop, m3_impl=m3_impl)
    return params


def parallel_time(pop: Population, task: TabularTask, batch: int,
                  epochs: int, lr: float = 0.01, m3_impl: str = "scatter",
                  device=None) -> float:
    """Seconds of ``steps_per_epoch × epochs`` fused steps after one
    warm-up step.  ``m3_impl="scatter"`` is the paper's own formulation
    (broadcast multiply + scatter-add); ``"pallas"`` the M3 kernels."""
    dev = resolve(device)
    params = _init(pop, dev)
    steps = max(task.n_samples // batch, 1) * epochs
    params = parallel_train(params, pop, task, batch, 1, lr, m3_impl)
    _sync(dev)
    t0 = time.perf_counter()
    params = parallel_train(params, pop, task, batch, steps, lr, m3_impl)
    _sync(dev)
    return time.perf_counter() - t0


def own_member(params: dict, pop: Population, m: int) -> dict:
    """Member m's standalone MLP (``extract_member``), cloned into
    contiguous tensors of its own."""
    return {k: (v.clone(memory_format=torch.contiguous_format)
                if isinstance(v, torch.Tensor) else v)
            for k, v in pm.extract_member(params, pop, m).items()}


def _member_loss(member: dict, x: torch.Tensor, y: torch.Tensor):
    h = ACTIVATIONS[member["activation"]](x @ member["w1"].t()
                                          + member["b1"])
    logits = h @ member["w2"].t() + member["b2"]
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, 1, y.long()[:, None]).mean()


def member_step(member: dict, x, y, lr: float) -> dict:
    """One standalone SGD step of one member, plain eager PyTorch."""
    leaves = {k: member[k].detach().requires_grad_(True) for k in pm.KEYS}
    with torch.enable_grad():
        loss = _member_loss(dict(member, **leaves), x, y)
        grads = torch.autograd.grad(loss, [leaves[k] for k in pm.KEYS])
    return dict(member, **{k: member[k] - lr * g
                           for k, g in zip(pm.KEYS, grads)})


def sequential_train(member: dict, task: TabularTask, batch: int,
                     steps: int, lr: float = 0.01) -> dict:
    """``steps`` standalone steps of one member (``own_member``) on batches
    0 … steps − 1 → the trained member."""
    dev = member["w1"].device
    for step in range(steps):
        x, y = _batch(task, step, batch, dev)
        member = member_step(member, x, y, lr)
    return member


def sequential_time(pop: Population, task: TabularTask, batch: int,
                    epochs: int, sample: int, lr: float = 0.01,
                    device=None) -> tuple[float, float]:
    """Time ``sample`` members for one epoch each; extrapolate to P
    members × epochs → (estimate_s, sigma_s)."""
    dev = resolve(device)
    params = _init(pop, dev)
    idx = np.linspace(0, pop.num_members - 1, sample).astype(int)
    steps_per_epoch = max(task.n_samples // batch, 1)
    per_model = []
    for m in idx:
        member = own_member(params, pop, int(m))
        member = sequential_train(member, task, batch, 1, lr)   # warm-up
        _sync(dev)
        t0 = time.perf_counter()
        member = sequential_train(member, task, batch, steps_per_epoch, lr)
        _sync(dev)
        per_model.append(time.perf_counter() - t0)
    per_model = np.asarray(per_model)
    est = per_model.mean() * pop.num_members * epochs
    sigma = per_model.std() * pop.num_members * epochs / np.sqrt(sample)
    return est, sigma


def run(samples_list, features_list, batches, models, repeats, epochs,
        seq_sample, block, m3_impl="scatter", device=None, around_arm=None):
    """Every cell of the grid, both arms → the CSV rows (also printed).
    ``around_arm(arm, fn)`` runs one arm ("parallel", "sequential") and
    returns ``fn()``: a caller's hook around each arm (``chip_smoke.py``
    counts kernel launches with it)."""
    dev = resolve(device)
    around_arm = around_arm or (lambda arm, fn: fn())
    hidden = range(1, models // (10 * repeats) + 1)
    rows = []
    print(HEADER, flush=True)
    for ns in samples_list:
        for nf in features_list:
            task = TabularTask(ns, nf, n_classes=2, seed=1)
            pop = Population.grid(nf, 2, hidden, PAPER_TEN,
                                  repeats=repeats, block=block)
            for b in batches:
                b_eff = min(b, ns)
                tp = around_arm("parallel", lambda: parallel_time(
                    pop, task, b_eff, epochs, m3_impl=m3_impl, device=dev))
                ts, sig = around_arm("sequential", lambda: sequential_time(
                    pop, task, b_eff, epochs, seq_sample, device=dev))
                row = (ns, nf, b, pop.num_members, tp, ts, sig,
                       100.0 * tp / ts, ts / tp)
                rows.append(row)
                print(",".join(f"{v:.4g}" if isinstance(v, float) else str(v)
                               for v in row), flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="the paper's exact 10,000-model grid")
    ap.add_argument("--models", type=int, default=1000)
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--seq-sample", type=int, default=25)
    ap.add_argument("--samples", type=int, nargs="+",
                    default=[100, 1000, 10000])
    ap.add_argument("--features", type=int, nargs="+",
                    default=[5, 10, 50, 100])
    ap.add_argument("--batches", type=int, nargs="+", default=[32, 128, 256])
    ap.add_argument("--block", type=int, default=1,
                    help="1 = the paper's exact layout")
    ap.add_argument("--m3-impl", default="scatter",
                    choices=["scatter", "bucketed", "onehot", "pallas"],
                    help="pallas = the M3 kernels")
    ap.add_argument("--device", default=None,
                    help="default: the card; cpu runs every kernel's plain "
                    "PyTorch version")
    args = ap.parse_args(argv)
    if args.full:
        args.models, args.repeats = 10_000, 10
    return run(args.samples, args.features, args.batches, args.models,
               args.repeats, args.epochs, args.seq_sample, args.block,
               m3_impl=args.m3_impl, device=args.device)


if __name__ == "__main__":
    main()
