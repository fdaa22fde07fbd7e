#!/usr/bin/env python3
"""Time a set of the population kernels of one source tree on the card.

    python3 scripts/time_kernels.py TREE LABEL --set mid|heads|flash
            [--population smoke|mixed]
    python3 scripts/time_kernels.py --compare LABEL_A LABEL_B

The first form imports ``repro_torch`` from ``TREE/src`` (this checkout, or
another one unpacked beside it: the parent commit, a variant) and prints the
device time from ``torch.profiler`` (``chip_smoke._device_ms``, 50 launches)
of each kernel of the set, on inputs made from a seeded generator:

* ``mid``: the depth-3 population's two mid layers at B = 32 (``smoke``:
  the population ``chip_smoke.py`` trains, its members sorted; ``mixed``:
  the same members unsorted, so that no two pass-through members are
  neighbours): ``block_diag_fwd`` (forward and the dh pass),
  ``fused_layer`` (serve, and with g'), ``fused_layer_int8`` (its tiles
  quantized per tile, q = round(w / s), s = max|w| / 127) and
  ``block_diag_dw``, each layer and then their sums;
* ``heads``: the two shapes of ``chip_smoke.py``'s M3 rows — path 4d
  (``parallelmlp-10k``'s layer: B 32, block 128, H 1,280,000, P 10,000,
  O 2) and path 4e's head (the depth-3 population's last layer: block 8,
  H 32,000, P 3,000) — ``m3_matmul_fwd``, ``m3_matmul_dh``,
  ``m3_matmul_dw``, the f32 ``infer_head`` and ``loss_head_bwd`` (d_per
  ones) on the same inputs;
* ``flash``: the f32 flash attention forward (``flash_attention_cuda``) at
  ``chip_smoke.py``'s two attention shapes, qwen3-1.7b's (B 2, S 4096, H
  16, Hkv 8, dh 128, causal) and h2o-danube-3-4b's (B 1, S 8192, H 32, Hkv
  8, dh 120, causal, window 4096), q, k, v from N(0, 1).

The outputs are saved under ``build/time_kernels/LABEL.pt``; ``--compare``
says, for each, whether two saved runs are bit for bit equal, and their
max |difference|.  Needs one card; a tree's kernels build under its own
``build/kernels``.
"""
import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "time_kernels"


def compare(a: str, b: str) -> bool:
    import torch
    x, y = (torch.load(OUT / f"{n}.pt") for n in (a, b))
    same = {k: torch.equal(x[k].view(torch.int32), y[k].view(torch.int32))
            for k in x if k in y}
    print(f"{a} and {b} bitwise equal: {same}")
    print(f"{a} and {b} max |difference|: "
          + str({k: (x[k] - y[k]).abs().max().item() for k in same}))
    return x.keys() == y.keys() and all(same.values())


def population(kind: str, cs):
    """``chip_smoke.py``'s depth-3 population (``smoke``), or its members
    before ``population_from_flags`` sorts them (``mixed``)."""
    from repro_torch.core.activations import PAPER_TEN
    from repro_torch.core.population import LayeredPopulation
    from repro_torch.launch.train import (parse_depth_spec,
                                          population_from_flags)
    d = cs.DEPTH3
    if kind == "smoke":
        return population_from_flags(d["depths"], d["acts"], d["features"],
                                     repeats=d["repeats"])
    widths = parse_depth_spec(d["depths"]) * d["repeats"]
    acts = tuple(PAPER_TEN[i % len(PAPER_TEN)] for i in range(len(widths)))
    return LayeredPopulation(d["features"], 2, widths, acts, block=8)


def mid_runs(cs, dev, kind):
    """Yields (layer, {key: (launch, the word its kernel's trace name
    holds)}) for the depth-3 population's mid layers."""
    import numpy as np
    import torch

    from repro_torch.kernels import block_diag as bdk
    from repro_torch.kernels import fused_layer as flk
    lp = population(kind, cs)
    rng = np.random.default_rng(0)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    for l in range(lp.depth - 1):
        lay, pout = lp.bd_layout(l), lp.layer_pop(l + 1)
        x = t(rng.normal(0, 1, (cs.BATCH, lay.n_in_tiles * lay.block)))
        wb = t(rng.normal(0, 1, (lay.n_param_blocks + 1, lay.block,
                                 lay.block)) / lay.block ** 0.5)
        wb[-1] = torch.eye(lay.block, device=dev)
        args = (x, wb, t(rng.normal(0, 1, lay.n_out_tiles * lay.block)),
                t(pout.hidden_mask), t(pout.block_act_ids, torch.int32),
                *flk.schedule_on(lay, dev))
        rowptr_t, s_in_t, s_w_t, perm_t, out_t, in_t = flk.schedule_on(
            lay, dev, transposed=True)
        dh_args = (t(rng.normal(0, 1, (cs.BATCH,
                                       lay.n_out_tiles * lay.block))),
                   flk.transposed_tiles(wb, perm_t), rowptr_t, s_in_t, s_w_t)
        scale = wb.abs().amax((1, 2)) / 127
        scale[-1] = 1.0
        wb_q = torch.round(wb / scale[:, None, None]).clamp(-127, 127) \
            .to(torch.int8)
        args8 = (x, wb_q, scale, *args[2:])
        yield f"layer {l}", {
            "bd": (lambda: bdk.block_diag_fwd_cuda(x, wb, *args[5:],
                                                   blk=lay.block),
                   "block_diag"),
            "dh": (lambda: bdk.block_diag_fwd_cuda(*dh_args, blk=lay.block),
                   "block_diag"),
            "serve": (lambda: flk.fused_layer_cuda(*args, blk=lay.block),
                      "fused_layer"),
            "train": (lambda: flk.fused_layer_train_cuda(*args,
                                                         blk=lay.block),
                      "fused_layer"),
            "int8": (lambda: flk.fused_layer_int8_cuda(*args8,
                                                       blk=lay.block),
                     "fused_layer_i8"),
            "dw": (lambda: bdk.block_diag_dw_cuda(dh_args[0], x, out_t, in_t,
                                                  blk=lay.block),
                   "block_diag_dw")}


def heads_runs(cs, dev):
    """Yields (path, {key: (launch, the word its kernel's trace name
    holds)}) at the M3 rows' two shapes."""
    import torch

    from repro_torch.configs import parallelmlp_10k
    from repro_torch.kernels import infer_head as ihk
    from repro_torch.kernels import loss_head as lhk
    from repro_torch.kernels import m3_matmul as m3k
    from repro_torch.launch.train import population_from_flags
    d = cs.DEPTH3
    lp3k = population_from_flags(d["depths"], d["acts"], d["features"],
                                 repeats=d["repeats"])
    pops = {"4d": (parallelmlp_10k.config().model.layered(), 0),
            "4e": (lp3k, lp3k.depth - 1)}
    gen = torch.Generator(device=dev).manual_seed(25)
    for name, (lp, layer) in pops.items():
        pop = lp.layer_pop(layer)
        hh, o, p = pop.total_hidden, lp.out_features, lp.num_members
        seg = torch.as_tensor(pop.block_segment_ids, dtype=torch.int32,
                              device=dev)
        mask = torch.as_tensor(pop.hidden_mask, dtype=torch.float32,
                               device=dev)
        h = torch.randn(cs.BATCH, hh, generator=gen, device=dev) * mask
        w2 = torch.randn(o, hh, generator=gen, device=dev) * 0.1
        b2 = torch.zeros(p, o, device=dev)
        dy = torch.randn(cs.BATCH, p, o, generator=gen, device=dev) * 1e-3
        ptr, blk = ihk.member_ptr(seg, p), lp.block
        dper = torch.ones(p, device=dev)
        yield f"path {name}", {
            "m3_fwd": (lambda: m3k.m3_matmul_fwd_cuda(h, w2, ptr, block=blk),
                       "m3_fwd"),
            "m3_dh": (lambda: m3k.m3_matmul_dh_cuda(dy, w2, seg, block=blk),
                      "m3_dh"),
            "m3_dw": (lambda: m3k.m3_matmul_dw_cuda(dy, h, seg, block=blk),
                      "m3_dw"),
            "infer_head": (lambda: ihk.infer_head_cuda(h, w2, b2, ptr,
                                                       block=blk),
                           "infer_head_kernel"),
            "loss_head_bwd": (lambda: lhk.loss_head_bwd_cuda(
                dper, dy, h, w2, seg, block=blk), "loss_head_bwd_kernel")}


def flash_runs(cs, dev):
    """Yields (shape, {key: (launch, the word its kernel's trace name
    holds)}) for the f32 flash attention at qwen3-1.7b's and
    h2o-danube-3-4b's shapes."""
    from functools import partial

    import torch

    from repro_torch.kernels import flash_attn as fak
    gen = torch.Generator(device=dev).manual_seed(26)
    for name, c in (("qwen3", cs.QWEN3), ("danube", cs.DANUBE)):
        q, k, v = (torch.randn(c["b"], n, c["s"], c["dh"], generator=gen,
                               device=dev)
                   for n in (c["h"], c["hkv"], c["hkv"]))
        yield name, {"f32": (partial(
            fak.flash_attention_cuda, q, k, v, scale=c["dh"] ** -0.5,
            causal=True, window=c["window"]), "flash_attn_fwd_kernel")}


def main(tree: Path, label: str, kset: str, kind: str):
    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import torch

    import chip_smoke as cs
    import repro_torch
    if not Path(repro_torch.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"repro_torch came from {repro_torch.__file__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    groups = {"mid": lambda: mid_runs(cs, dev, kind),
              "heads": lambda: heads_runs(cs, dev),
              "flash": lambda: flash_runs(cs, dev)}[kset]()
    outs, sums = {}, {}
    for group, runs in groups:  # each group timed before the next is made
        ms = {}
        for key, (fn, word) in runs.items():
            got = fn()
            for i, t in enumerate(got if isinstance(got, tuple) else (got,)):
                outs[f"{group} {key} {i}"] = t.cpu()
            ms[key] = cs._device_ms(fn, word, 50)
            sums[key] = sums.get(key, 0.0) + ms[key]
        print(f"{label} {group}: " + " ".join(
            f"{k} {v!r}" for k, v in ms.items()), flush=True)
    if kset == "mid":
        print(f"{label} sum: " + " ".join(f"{k} {v!r}"
                                          for k, v in sums.items()),
              flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    torch.save(outs, OUT / f"{label}.pt")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?", type=Path)
    ap.add_argument("label", nargs="?")
    ap.add_argument("--set", dest="kset", choices=("mid", "heads", "flash"))
    ap.add_argument("--population", choices=("smoke", "mixed"),
                    default="smoke", help="the mid set's population")
    ap.add_argument("--compare", nargs=2, metavar="LABEL")
    a = ap.parse_args()
    if a.compare:
        sys.exit(0 if compare(*a.compare) else 1)
    if a.tree is None or a.label is None or a.kset is None:
        ap.error("TREE, LABEL and --set, or --compare")
    main(a.tree.resolve(), a.label, a.kset, a.population)
