"""Serving driver for the decoder LMs: batched prefill + decode, ported
from the JAX package's ``repro/launch/serve.py``.

    python -m repro_torch.launch.serve --arch qwen3-1.7b [--full] \
        [--batch 4] [--prompt-len 32] [--tokens 32] [--sample] [--device cpu]

The standard two-phase inference flow: prefill the prompt batch (every
attention or hybrid layer one flash-attention launch, every MoE layer
three grouped-GEMM launches; it builds the ring-buffer KV caches and the
SSM layers' conv rings and states), then step the
decode loop under ``torch.inference_mode`` with the caches updated in
place (JAX donates them to its jitted step).  Runs on the card unless
``--device cpu`` (the kernels' plain versions).

Differences from JAX's driver: ``generate_lm`` takes a ``device`` where
JAX takes a mesh (one card; the LM's sharding is ROADMAP Queue 1 item
9(d)) and optional ``params`` (without them it inits from a generator
seeded 0, as JAX inits from ``PRNGKey(0)``); a sampled pick draws from a
``torch.Generator`` (other numbers than JAX's, the same distribution).
The encoder-decoder (``generate_encdec``) is item 9(c).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.device import resolve
from repro_torch.models import lm


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate_lm(arch, prompts, max_new: int, device=None, greedy: bool = True,
                temperature: float = 1.0, seed: int = 0, params=None):
    """prompts: (B, S) int -> (B, S+max_new) tokens + timing dict.

    ``params`` (the tree of ``lm.init_params``) default to an init from a
    generator seeded 0 on ``device`` (default the card)."""
    cfg = arch.model
    if cfg.frontend != "tokens":
        raise ValueError(f"{arch.arch_id}: generate_lm takes token prompts; "
                         f"its frontend is {cfg.frontend!r}")
    dev = resolve(device)
    if params is None:
        params = lm.init_params(torch.Generator(dev).manual_seed(0), cfg)
    prompts = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
    b, s = prompts.shape
    max_len = s + max_new
    gen = torch.Generator(dev).manual_seed(seed)
    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        logits, caches = lm.prefill(params, cfg, {"tokens": prompts},
                                    max_len=max_len)
        tok = _pick(logits, greedy, temperature, gen)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        serve_step = lm.make_serve_step(cfg)
        out = [prompts, tok]
        t0 = time.perf_counter()
        for i in range(max_new - 1):
            pos = torch.full((b,), s + i, dtype=torch.int32, device=dev)
            logits, caches = serve_step(params, caches, {"tokens": tok}, pos)
            tok = _pick(logits, greedy, temperature, gen)
            out.append(tok)
        tokens = torch.cat(out[:max_new + 1], dim=1)
        _sync(dev)
        t_decode = time.perf_counter() - t0
    return tokens, {"prefill_s": t_prefill, "decode_s": t_decode,
                    "tok_per_s": b * max_new / max(t_decode, 1e-9)}


def _pick(logits, greedy: bool, temperature: float, gen):
    """The next token (B, 1) int32: the argmax of the last position's
    logits, or a draw from their softmax at ``temperature``."""
    if greedy:
        return torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    p = torch.softmax(logits[:, -1].float() / temperature, dim=-1)
    return torch.multinomial(p, 1, generator=gen).to(torch.int32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="the arch's reduced config (the default, as in "
                         "the JAX package's driver)")
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="the arch's full config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--sample", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch, reduced=args.reduced)
    if arch.kind == "encdec":
        raise NotImplementedError(
            f"arch {args.arch!r}: the encoder-decoder is not ported yet "
            "(ROADMAP.md, Queue 1 item 9(c))")
    if arch.kind != "lm":
        raise ValueError(f"arch {args.arch!r} is a {arch.kind}, not an LM "
                         "(serve populations with "
                         "repro_torch.launch.serve_population)")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, arch.model.vocab, (args.batch,
                                                 args.prompt_len))
    toks, stats = generate_lm(arch, prompts, args.tokens, args.device,
                              greedy=not args.sample)
    print(f"generated {tuple(toks.shape)} tokens; {stats}")
    print(toks[:2, -16:].cpu().numpy())
    return toks, stats


if __name__ == "__main__":
    main()
