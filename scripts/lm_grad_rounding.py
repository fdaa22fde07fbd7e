#!/usr/bin/env python3
"""How far bf16 roundings move an LM's training gradients: qwen3-1.7b's
gradients of one batch through the kernels (the bf16 flash forward,
which rounds each softmax weight p to bf16 before its PV product) against
the same function on the plain versions (the dense attention, p in f32),
and both against an f32 reference (the same parameters widened to f32,
the plain f32 attention), leaf by leaf; also against the plain version
with p rounded to bf16 as the kernel rounds it; and, as controls, the
kernels with a planted fault made at the call (the softmax scale one bf16
ulp high, ×(1 + 2⁻⁸), and 1 % high), each against the f32 reference.

    PYTHONPATH=src python3 scripts/lm_grad_rounding.py [--train-steps 16]
        [--warmup 4] [--extra-steps 0] [--batch 4] [--seq 512]
        [--device cpu] [--reduced]

Runs on the card unless ``--device cpu`` is passed (there the "kernels"
are the plain versions, so only the f32 distances say anything).  The
parameters are ``train.main``'s: an init from a generator seeded 0,
trained ``--train-steps`` steps of ``TokenTask`` batches (``--warmup``
steps of warmup, AdamW, remat), no checkpoint, then ``--extra-steps``
more steps of the runner's step function (``chip_smoke.py`` path 4m
profiles two before it compares the state); ``--reduced`` takes the
reduced config in bf16 (a rehearsal on the CPU).  For each gradient
leaf it prints the max |difference| of each pair over the
leaf's scale (its largest |value| in the reference of the pair) and the
relative l2 distance, and the whole tree's relative l2 distances; then,
for each run, each leaf's max |difference| from the f32 reference over
the plain run's, and the largest of those ratios.
"""
import argparse
import dataclasses
import json
import tempfile
from contextlib import contextmanager, nullcontext

import torch

from repro_torch.configs import get_arch
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.data.synthetic import TokenTask
from repro_torch.device import resolve
from repro_torch.kernels import flash_attn as fak
from repro_torch.kernels import ops
from repro_torch.models import lm


@contextmanager
def _flash_swapped(fn):
    saved = ops.flash_attention
    ops.flash_attention = fn
    try:
        yield
    finally:
        ops.flash_attention = saved


def _dense(q, k, v, scale, causal=True, window=0, **_):
    return fak.flash_attn_dense(q, k, v, scale=scale, causal=causal,
                                window=int(window or 0))


def _p_rounded(q, k, v, scale, causal=True, window=0, **_):
    """The dense attention with p rounded to bf16 before PV (against the
    row's max), o in q's dtype; differentiable, the rounding passed
    straight through."""
    g = q.shape[1] // k.shape[1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                     k.repeat_interleave(g, dim=1).float()) * scale
    ok = fak.attention_mask(q.shape[2], k.shape[2], causal=causal,
                            window=int(window or 0), device=q.device)
    s = torch.where(ok, s, torch.full((), fak.NEG_INF, device=q.device))
    p = torch.exp(s - s.amax(-1, keepdim=True).detach())
    o = torch.einsum("bhqk,bhkd->bhqd", p.bfloat16().float(),
                     v.repeat_interleave(g, dim=1).float())
    return (o / p.sum(-1, keepdim=True)).to(q.dtype)


def _scaled(entry, factor):
    """The kernel's entry with its softmax scale multiplied by ``factor``
    (a planted fault)."""
    def call(q, k, v, scale, causal=True, window=0, **kw):
        return entry(q, k, v, scale * factor, causal, window, **kw)
    return call


def _max_diff(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def _pair(a, b) -> tuple:
    """(max |a − b| / max |b|, ‖a − b‖ / ‖b‖) in f32."""
    a, b = a.float(), b.float()
    scale = b.abs().max().item()
    d = (a - b).abs().max().item()
    return (d / scale if scale else float(d > 0),
            ((a - b).norm() / b.norm().clamp_min(1e-30)).item())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--train-steps", type=int, default=16)
    ap.add_argument("--warmup", type=int, default=4)
    ap.add_argument("--extra-steps", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--device", default=None)
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()
        torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.launch import train
    arch = get_arch("qwen3-1.7b", reduced=args.reduced)
    arch = dataclasses.replace(arch, model=dataclasses.replace(
        arch.model, param_dtype="bfloat16", remat=True))
    cfg = arch.model
    with tempfile.TemporaryDirectory() as ckpt:
        runner = train.run_lm(arch, train.parser().parse_args([
            "--arch", "qwen3-1.7b", "--batch", str(args.batch), "--seq",
            str(args.seq), "--steps", str(args.train_steps), "--warmup",
            str(args.warmup), "--ckpt-every", "0", "--ckpt-dir", ckpt,
            "--device", str(dev)]))
    state = runner.state
    for k in range(args.extra_steps):
        state, _ = runner.step_fn(state, args.train_steps + k)
    del runner
    params = state["params"]
    del state
    batch = {k: torch.from_numpy(v).to(dev) for k, v in TokenTask(
        cfg.vocab, 0).batch(args.train_steps, args.batch, args.seq).items()}
    grads = {}
    entry = ops.flash_attention
    for label, swap in (("kernels", None), ("plain", _dense),
                        ("p_rounded", _p_rounded),
                        ("scale_ulp", _scaled(entry, 1 + 2.0 ** -8)),
                        ("scale_1pct", _scaled(entry, 1.01))):
        with _flash_swapped(swap) if swap else nullcontext():
            grads[label] = lm.loss_and_grads(params, cfg, batch)[2]
    p32 = tree_map(lambda t: t.float(), params)
    del params
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    with _flash_swapped(_dense):
        grads["f32"] = lm.loss_and_grads(p32, cfg32, batch)[2]
    del p32
    pairs = (("kernels", "plain"), ("kernels", "f32"), ("plain", "f32"),
             ("kernels", "p_rounded"), ("p_rounded", "f32"))
    leaves = {k: tree_leaves(v) for k, v in grads.items()}
    out = {"card": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                    else "cpu"), "layers": cfg.n_layers, "leaves": []}
    for i in range(len(leaves["f32"])):
        row = {f"{a}-{b}": _pair(leaves[a][i], leaves[b][i])
               for a, b in pairs}
        out["leaves"].append(row)
        print(f"leaf {i:2d} {tuple(leaves['f32'][i].shape)}: " + "; ".join(
            f"{k} max {v[0]:.4g} l2 {v[1]:.4g}" for k, v in row.items()),
            flush=True)
    for a, b in pairs:
        num = sum((x.float() - y.float()).norm() ** 2
                  for x, y in zip(leaves[a], leaves[b])) ** 0.5
        den = sum(y.float().norm() ** 2 for y in leaves[b]) ** 0.5
        out[f"{a}-{b}"] = (num / den).item()
        print(f"tree {a}-{b}: relative l2 {out[f'{a}-{b}']:.4g}", flush=True)
    for run in ("kernels", "p_rounded", "scale_ulp", "scale_1pct"):
        ratio = [_max_diff(a, f) / _max_diff(p, f) if _max_diff(p, f)
                 else float(_max_diff(a, f) > 0)
                 for a, p, f in zip(leaves[run], leaves["plain"],
                                    leaves["f32"])]
        out[f"{run}_over_plain_f32"] = ratio
        print(f"{run}: |run - f32| / |plain - f32| by leaf "
              f"{[round(r, 4) for r in ratio]}, max {max(ratio)!r}",
              flush=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
