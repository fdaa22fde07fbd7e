"""Fault tolerance through the PyTorch port (the twin of
``examples/fault_tolerant_train.py``): train with injected failures and a
straggler watchdog, then check that the restarted run matches an
uninterrupted one.

    PYTHONPATH=src python examples/torch_fault_tolerant_train.py \
        [--device cpu] [--workdir DIR]

What this shows, on one card:
  * checkpoints every K steps, written off the training thread,
  * ANY step failure → restore of the last committed checkpoint and an
    exact replay (step-indexed data),
  * a straggler policy that raises after N slow steps → the same path,
  * int8 gradient compression with error feedback for a slow all-reduce.
"""
import argparse
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.data.synthetic import TokenTask
from repro_torch.device import resolve
from repro_torch.distributed.compression import quantize_int8
from repro_torch.distributed.fault_tolerance import (StragglerPolicy,
                                                     TrainRunner)
from repro_torch.models import lm
from repro_torch.optim.optimizers import build_optimizer, constant_lr


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the card; cpu runs the plain versions")
    ap.add_argument("--workdir", default=None,
                    help="checkpoint root (default: a new temporary "
                         "directory)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    work = Path(args.workdir or tempfile.mkdtemp(prefix="repro_torch_ft_"))

    arch = get_arch("qwen3-1.7b", reduced=True)
    cfg = arch.model
    task = TokenTask(vocab=cfg.vocab, seed=0)
    opt = build_optimizer(arch)
    train_step = lm.make_train_step(cfg, opt, constant_lr(1e-3))

    def fresh_state():
        params = lm.init_params(torch.Generator(dev).manual_seed(0), cfg)
        return {"params": params, "opt": opt.init(params)}

    def step_fn(state, s):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in task.batch(s, 4, 64).items()}
        p, o, m = train_step(state["params"], state["opt"], batch, s)
        return {"params": p, "opt": o}, {"loss": float(m["loss"])}

    print("reference run (no failures), 40 steps…")
    ref = TrainRunner(step_fn, fresh_state(), ckpt_dir=str(work / "ref"),
                      ckpt_every=10)
    ref.run(40)

    print("failure run: the card fails at steps 17 and 33…")
    boom = {17: True, 33: True}

    def failure(s):
        if boom.pop(s, False):
            raise RuntimeError(f"simulated device failure @ step {s}")

    runner = TrainRunner(
        step_fn, fresh_state(), ckpt_dir=str(work / "demo"), ckpt_every=10,
        failure_hook=failure,
        straggler=StragglerPolicy(timeout_s=120.0, max_strikes=3))
    t0 = time.time()
    runner.run(40)
    print(f"  finished with {runner.restarts} restarts "
          f"in {time.time() - t0:.1f}s")

    ref_loss = dict(ref.metrics_log)[39]["loss"]
    ft_loss = dict(runner.metrics_log)[39]["loss"]
    print(f"  final loss  ref={ref_loss:.6f}  restarted={ft_loss:.6f}  "
          f"(identical: {abs(ref_loss - ft_loss) < 1e-6})")

    print("\nint8 gradient compression (a slow all-reduce's wire):")
    g = torch.as_tensor(np.random.default_rng(0).normal(0, 0.02, (4096,)),
                        dtype=torch.float32, device=dev)
    q, scale, err = quantize_int8(g, torch.zeros_like(g))
    rec = q.float() * scale
    rel = float(torch.linalg.norm(rec - g) / torch.linalg.norm(g))
    wire = q.numel() * q.element_size() + 4
    print(f"  wire bytes: {wire} vs f32 {g.numel() * 4} "
          f"({g.numel() * 4 / wire:.1f}x less); rel err {rel:.4f} "
          f"(error feedback carries the residual forward)")
    return {"restarts": runner.restarts, "ref_loss": ref_loss,
            "ft_loss": ft_loss, "rel_err": rel, "wire_bytes": wire,
            "residual": float(err.abs().max())}


if __name__ == "__main__":
    main()
