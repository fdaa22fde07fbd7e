"""Feature selection with ParallelMLPs — the paper's §7 future work, live,
through the PyTorch port (the twin of ``examples/feature_selection.py``).

    PYTHONPATH=src python examples/torch_feature_selection.py \
        [--device cpu] [--m3-impl pallas]

Builds a task where only 3 of 16 features carry signal, trains a fused
population of identical MLPs under random per-member feature masks
(projected SGD keeps masked features inert: every masked w1 entry is
exactly 0 after every step, checked on the device and read back once),
then reads feature importance out of the population by loss-gap
attribution.  Runs on the card unless ``--device cpu``; ``--m3-impl
pallas`` puts every step on the three M3 kernels."""
import argparse

import numpy as np
import torch

from repro_torch.core import parallel_mlp as pm
from repro_torch.core.feature_selection import (apply_masks,
                                                feature_importance,
                                                masked_sgd_step,
                                                random_masks, unit_masks)
from repro_torch.core.population import Population
from repro_torch.device import resolve


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the card; cpu runs the plain versions")
    ap.add_argument("--m3-impl", default="bucketed",
                    choices=["scatter", "bucketed", "onehot", "pallas"])
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    rng = np.random.default_rng(0)
    F, N, signal = 16, 4096, (2, 7, 11)
    x = rng.normal(0, 1, (N, F)).astype(np.float32)
    logit = x[:, signal[0]] + 0.8 * x[:, signal[1]] - 1.2 * x[:, signal[2]]
    y = (logit > 0).astype(np.int32)
    print(f"task: {F} features, signal carried by {signal}")

    P = 64
    pop = Population(F, 2, tuple([8] * P), ("relu",) * P, block=8)
    gen = torch.Generator(device=dev)
    masks = random_masks(gen.manual_seed(1), P, F, keep_prob=0.5,
                         always_full=4, device=dev)
    params = pm.init_params(gen.manual_seed(0), pop, device=dev)
    masked_out = 1.0 - unit_masks(pop, masks)
    xb = torch.as_tensor(x, device=dev)
    yb = torch.as_tensor(y, device=dev)
    leaked = []   # max |masked w1| after each step, kept on the device
    for step in range(150):
        i = (step * 256) % (N - 256)
        params, loss, per = masked_sgd_step(
            params, xb[i:i + 256], yb[i:i + 256], 0.2, pop, masks,
            m3_impl=args.m3_impl)
        leaked.append((params["w1"] * masked_out).abs().max())
        if step % 50 == 0:
            print(f"step {step:3d}  mean loss {float(loss) / P:.4f}")
    leaked = torch.stack(leaked).max().item()
    print(f"masked w1 entries after every step: max |w| = {leaked}")

    logits = pm.forward(apply_masks(params, pop, masks), xb, pop,
                        m3_impl=args.m3_impl)
    per = pm.member_losses(logits, yb, "classification")
    imp = feature_importance(pop, masks, per)
    order = np.argsort(imp)[::-1]
    print("\nfeature importance (loss-gap attribution):")
    for f in order[:6]:
        tag = " <-- signal" if f in signal else ""
        print(f"  feature {f:2d}: {imp[f]:+.4f}{tag}")
    found = set(order[:3].tolist())
    n_found = len(found & set(signal))
    print(f"\ntop-3 = {sorted(found)}  (true signal = {sorted(signal)}; "
          f"recovered {n_found}/3)")
    return {"steps": 150, "masked_max_abs": leaked, "recovered": n_found,
            "top3": sorted(found)}


if __name__ == "__main__":
    main()
