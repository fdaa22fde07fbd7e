#!/usr/bin/env python3
"""How far a faulty flash kernel moves an LM's logits, beside how far
bf16's own roundings move them: ``chip_smoke.py`` path 4l's setup for one
model (its ``LM_SERVE`` entry, weights from a generator seeded 17, prompts
seeded 18, the greedy tokens of ``generate_lm``), then the prefill's last
logits and 8 teacher-forced decode steps through

- the kernels (``kernels``), the plain versions (``plain``), and the plain
  versions on the parameters widened to f32 (``f32``);
- the kernels with a planted fault, made at the call by changing the
  kernel's arguments (nothing of the port changes): the softmax scale one
  bf16 ulp high (``scale_ulp``, ×(1 + 2⁻⁸)) and 1 % high (``scale_1pct``),
  a windowed call's window one key wider (``window_plus1``) and no window
  at all (``no_window``).

For each run and each logits step it prints the max |difference| from the
f32 run over the plain run's (the ratio path 4l's f32 rule holds), and
the max |difference| from the plain run.  Then, for each distinct flash
call of the prefill (shape and window), the kernel and each planted
fault against the plain version on the true arguments, at path 4l's
per-element rule (``_lm_kernel_fields``): the largest share of the
per-element tolerance (above 1 fails that check).

    PYTHONPATH=src python3 scripts/lm_logit_control.py [--arch hymba-1.5b]
        [--device cpu --reduced --prompt 64]

Runs on the card, where it builds the kernels first, unless ``--device
cpu`` is passed (a rehearsal: there the "kernels" are the plain versions,
so only the faults' rows say anything); ``--reduced`` takes the arch's
reduced config in bf16, ``--prompt`` cuts the prompt.
"""
import argparse
import dataclasses
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

FAULTS = {
    "scale_ulp": lambda sc, w: (sc * (1 + 2.0 ** -8), w),
    "scale_1pct": lambda sc, w: (sc * 1.01, w),
    "window_plus1": lambda sc, w: (sc, w + 1 if w else 0),
    "no_window": lambda sc, w: (sc, 0),
}


def _faulty(fault):
    def flash(entry):
        def call(q, k, v, scale, causal=True, window=0, **kw):
            sc, w = fault(scale, int(window or 0))
            return entry(q, k, v, sc, causal, w, **kw)
        return call
    return cs._lm_ops(flash, lambda entry: entry)


def _kernel_shares(arch, prompts, max_len: int) -> dict:
    """Each distinct flash call of a prefill: the kernel and each fault
    against ``flash_attn_dense`` on the true arguments → the largest
    |difference| over its per-element tolerance, by call and run."""
    from repro_torch.kernels import flash_attn as fak
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    params = lm.init_params(torch.Generator(prompts.device).manual_seed(17),
                            arch.model)
    calls = {}
    with torch.inference_mode():
        with cs._recorded_lm_calls(calls):
            lm.prefill(params, arch.model, {"tokens": prompts},
                       max_len=max_len)
        del params
        out = {}
        for key, (q, k, v, sc, causal, window) in calls.items():
            if key[0] != "flash":
                continue
            kw = dict(scale=sc, causal=causal, window=window)
            want = fak.flash_attn_dense(q, k, v, **kw).float()
            rtol, atol = cs._flash_bf16_tol(fak.flash_attn_dense, q, k, v,
                                            **kw)
            row = {}
            for name, fault in (("kernels", lambda a, b: (a, b)),
                                *FAULTS.items()):
                fsc, fw = fault(sc, window)
                got = ops.flash_attention(q, k, v, fsc, causal, fw).float()
                row[name] = ((got - want).abs()
                             / (atol + rtol * want.abs())).max().item()
            label = "{}x{}x{}x{} w{}".format(*q.shape, window)
            out[label] = row
            print(f"per element, flash {label}: share of the tolerance "
                  f"{row}", flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--device", default=None)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--prompt", type=int, default=None)
    args = ap.parse_args(argv)
    from repro_torch.configs import get_arch
    from repro_torch.core.tree import tree_map
    from repro_torch.device import resolve
    from repro_torch.launch import serve
    from repro_torch.models import lm
    dev = resolve(args.device)
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()
        torch.backends.cuda.matmul.allow_tf32 = False
    if args.reduced:
        arch = get_arch(args.arch, reduced=True)
        arch = dataclasses.replace(arch, model=dataclasses.replace(
            arch.model, param_dtype="bfloat16"))
    else:
        arch = cs._lm_model(args.arch)[0]
    cfg = arch.model
    _, b, s, new = cs.LM_SERVE[args.arch]
    s = args.prompt or s
    params = lm.init_params(torch.Generator(dev).manual_seed(17), cfg)
    gen = torch.Generator(dev).manual_seed(18)
    prompts = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                            device=dev, dtype=torch.int32)
    toks, _ = serve.generate_lm(arch, prompts, new, dev, params=params)

    def teacher_forced(p, c):
        step = lm.make_serve_step(c)
        last, caches = lm.prefill(p, c, {"tokens": prompts},
                                  max_len=s + new)
        logits = [last[..., :cfg.vocab].float()]
        for i in range(min(new - 1, 8)):
            pos = torch.full((b,), s + i, dtype=torch.int32, device=dev)
            lg, caches = step(p, caches,
                              {"tokens": toks[:, s + i:s + i + 1]}, pos)
            logits.append(lg[..., :cfg.vocab].float())
        return logits

    runs = {}
    with torch.inference_mode():
        runs["kernels"] = teacher_forced(params, cfg)
        with cs._plain_lm_kernels():
            runs["plain"] = teacher_forced(params, cfg)
        for name, fault in FAULTS.items():
            with _faulty(fault):
                runs[name] = teacher_forced(params, cfg)
        p32 = tree_map(lambda t: t.float(), params)
        del params
        with cs._plain_lm_kernels():
            f32 = teacher_forced(p32, dataclasses.replace(
                cfg, param_dtype="float32"))
        del p32
    card = (torch.cuda.get_device_name(0) if dev.type == "cuda"
            else "cpu")
    out = {"arch": args.arch, "card": card, "batch": b, "prompt": s,
           "runs": {}}
    plain_f32 = [(p - r).abs().max().item()
                 for p, r in zip(runs["plain"], f32)]
    for name, logits in runs.items():
        ratio = [(g - r).abs().max().item() / pf
                 for g, r, pf in zip(logits, f32, plain_f32)]
        to_plain = [(g - p).abs().max().item()
                    for g, p in zip(logits, runs["plain"])]
        out["runs"][name] = {"ratio_to_plain_f32": ratio,
                             "max_ratio": max(ratio),
                             "from_plain": to_plain}
        print(f"{args.arch} {name}: |run - f32| / |plain - f32| max "
              f"{max(ratio)!r}, by step {[round(r, 4) for r in ratio]}; "
              f"|run - plain| {to_plain}", flush=True)
    out["plain_f32"] = plain_f32
    out["per_element"] = _kernel_shares(arch, prompts, s + new)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
