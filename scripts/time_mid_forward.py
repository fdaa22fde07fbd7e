#!/usr/bin/env python3
"""Time the mid layers' kernels of one source tree on the card.

    python3 scripts/time_mid_forward.py TREE LABEL [--population smoke|mixed]
    python3 scripts/time_mid_forward.py --compare LABEL_A LABEL_B

The first form imports ``repro_torch`` from ``TREE/src`` (this checkout, or
another one unpacked beside it: the parent commit, a variant), builds the
depth-3 population's two mid layers at B = 32 (``smoke``: the population
``chip_smoke.py`` trains, its members sorted; ``mixed``: the same members
unsorted, so that no two pass-through members are neighbours), and prints each layer's device time from ``torch.profiler``
(``chip_smoke._device_ms``, 50 launches) of ``block_diag_fwd`` (forward and
the dh pass), ``fused_layer`` (serve, and with g'), ``fused_layer_int8``
(its tiles quantized per tile, q = round(w / s), s = max|w| / 127) and
``block_diag_dw``, then their sums.  Inputs come from a seeded generator.  The outputs are saved under
``build/mid_forward/LABEL.pt``; ``--compare`` says whether two saved runs
are bit for bit equal.  Needs one card; a tree's kernels build under its
own ``build/kernels``.
"""
import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "mid_forward"


def compare(a: str, b: str) -> bool:
    import torch
    x, y = (torch.load(OUT / f"{n}.pt") for n in (a, b))
    return x.keys() == y.keys() and all(
        torch.equal(p.view(torch.int32), q.view(torch.int32))
        for k in x for p, q in zip(x[k], y[k]))


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


def main(tree: Path, label: str, kind: str):
    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import block_diag as bdk
    from repro_torch.kernels import fused_layer as flk
    if not Path(bdk.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"repro_torch came from {bdk.__file__}")
    lp = population(kind, cs)
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    outs = {}
    sums = dict(bd=0.0, dh=0.0, serve=0.0, train=0.0, int8=0.0, dw=0.0)
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
        runs = {
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
        ms = {}
        for key, (fn, word) in runs.items():
            got = fn()
            outs[f"{key}{l}"] = [a.cpu() for a in (
                got if isinstance(got, tuple) else (got,))]
            ms[key] = cs._device_ms(fn, word, 50)
            sums[key] += ms[key]
        print(f"{label} layer {l}: " + " ".join(
            f"{k} {v!r}" for k, v in ms.items()), flush=True)
    print(f"{label} sum: " + " ".join(f"{k} {v!r}" for k, v in sums.items()),
          flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    torch.save(outs, OUT / f"{label}.pt")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?", type=Path)
    ap.add_argument("label", nargs="?")
    ap.add_argument("--population", choices=("smoke", "mixed"),
                    default="smoke")
    ap.add_argument("--compare", nargs=2, metavar="LABEL")
    a = ap.parse_args()
    if a.compare:
        same = compare(*a.compare)
        print(f"{a.compare[0]} and {a.compare[1]} bitwise equal: {same}")
        sys.exit(0 if same else 1)
    if a.tree is None or a.label is None:
        ap.error("TREE and LABEL, or --compare")
    main(a.tree.resolve(), a.label, a.population)
