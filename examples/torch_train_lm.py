"""End-to-end LM training through the PyTorch port (the twin of
``examples/train_lm.py``): a ~110M-parameter qwen3-family model for a few
hundred steps on synthetic token data.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] \
        [--num-micro 2] [--device cpu] [--tiny]

The same code path as the launcher (``repro_torch.launch.train --arch
<LM>``): ``models.lm.make_train_step`` with microbatches, AdamW,
warmup-cosine, checkpoints written off the training thread
(``AsyncCheckpointer``), step-indexed data.  Runs on the card unless
``--device cpu``; every attention layer's forward is one flash-attention
launch.  ``--tiny`` swaps in a 2-layer, 64-wide model of the same family
(a smoke run).
"""
import argparse
import tempfile
import time

import torch

from repro_torch.checkpoint.checkpoint import AsyncCheckpointer
from repro_torch.core.tree import tree_leaves
from repro_torch.data.synthetic import TokenTask
from repro_torch.device import resolve
from repro_torch.models import lm
from repro_torch.models.lm import LayerSpec, LMConfig
from repro_torch.nn.attention import AttnConfig
from repro_torch.nn.ffn import FFNConfig
from repro_torch.optim.optimizers import adamw, warmup_cosine


def config_100m() -> LMConfig:
    """qwen3-family, ~110M params: 12L d768 12H(kv4) ff2304 qk-norm tied."""
    return LMConfig(
        name="qwen3-100m", vocab=32_000, d_model=768,
        layers=tuple(LayerSpec("attn", "dense", 0) for _ in range(12)),
        attn=AttnConfig(d_model=768, n_heads=12, n_kv_heads=4, d_head=64,
                        qk_norm=True, rope_theta=1e6),
        ffn=FFNConfig(768, 2304, act="silu", gated=True),
        norm="rmsnorm", tie_embeddings=True, param_dtype="float32",
        remat=False)


def config_tiny() -> LMConfig:
    """The same family at 2 layers, d 64, vocab 512."""
    return LMConfig(
        name="qwen3-tiny", vocab=512, d_model=64,
        layers=tuple(LayerSpec("attn", "dense", 0) for _ in range(2)),
        attn=AttnConfig(d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
                        qk_norm=True, rope_theta=1e6),
        ffn=FFNConfig(64, 192, act="silu", gated=True),
        norm="rmsnorm", tie_embeddings=True, param_dtype="float32",
        remat=False)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--num-micro", type=int, default=2)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: a new temporary directory")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="default: the card; cpu runs the plain versions")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    cfg = config_tiny() if args.tiny else config_100m()
    params = lm.init_params(torch.Generator(dev).manual_seed(0), cfg)
    n = sum(t.numel() for t in tree_leaves(params))
    print(f"model: {cfg.name}  params={n / 1e6:.1f}M  device={dev}")
    opt = adamw(weight_decay=0.1)
    opt_state = opt.init(params)
    lr_fn = warmup_cosine(args.lr, warmup_steps=20, total_steps=args.steps)
    step_fn = lm.make_train_step(cfg, opt, lr_fn, num_micro=args.num_micro)
    task = TokenTask(vocab=cfg.vocab, seed=0)
    ckpt = AsyncCheckpointer(
        args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_lm_ckpt_"),
        every=args.ckpt_every)

    tokens_per_step = args.batch * args.seq
    losses = []
    t0 = time.time()
    for s in range(args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in task.batch(s, args.batch, args.seq).items()}
        params, opt_state, m = step_fn(params, opt_state, batch, s)
        ckpt.maybe_save(s, {"params": params, "opt": opt_state})
        losses.append(float(m["loss"]))
        if s % 20 == 0 or s == args.steps - 1:
            dt = time.time() - t0
            tps = tokens_per_step * (s + 1) / dt
            print(f"step {s:4d}  loss {losses[-1]:.4f}  "
                  f"lr {float(m['lr']):.2e}  "
                  f"grad_norm {float(m['grad_norm']):.2f}  "
                  f"{tps:.0f} tok/s")
    ckpt.wait()
    print(f"done in {time.time() - t0:.1f}s; checkpoints: {ckpt.saved}")
    return {"losses": losses, "saved": ckpt.saved, "params": n}


if __name__ == "__main__":
    main()
