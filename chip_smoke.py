#!/usr/bin/env python3
"""Build the PyTorch port's CUDA kernels and serve the paper's population on
one NVIDIA GPU, end to end, through the entry points a user calls.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

  1. the card's name and power limit (``nvidia-smi``);
  2. build every kernel from ``src/repro_torch/kernels/csrc`` (nvcc);
  3. the main path, with every kernel counter set to 0 before it and read
     after it:
       a. ``parallelmlp-10k`` at full width (10,000 members, 1,280,000
          fused hidden units), random weights from a seeded generator,
          saved as a checkpoint and served by ``serve_population.main``:
          launch budget (2), publish over 512 calibration rows, 256
          requests in slabs of 32 in each of best1 / topk / all;
       b. a 3,000-member depth-3 population built from the trainer's flags
          ``--population-depths "64,32,16;13,5;7" --population-acts paper
          --population-features 100 --population-repeats 1000`` (block 8),
          served the same way (launch budget 4);
  4. each kernel against its plain PyTorch version on the same inputs at
     the path's shapes (rtol 1e-4 / atol 1e-5, f32, TF32 off), and the
     served forward against the plain route on the card and on the CPU;
  5. each kernel, its plain version and the nearest library call timed
     with CUDA events; the least time the card could take (bound) from the
     bytes and operations of this run's inputs;
  6. one JSON line ``{"kernels": [...]}``, then the card's line
     ``{"ok": true, "device": {...}}`` last.
"""
import json
import subprocess
import sys
import tempfile
import time
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RTOL, ATOL = 1e-4, 1e-5
# NVIDIA H100 SXM data sheet: HBM3 bandwidth and f32 (non-tensor-core) peak
MEM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BATCH = 32


def _require(cond, msg: str):
    if not cond:
        raise RuntimeError(msg)


def _time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, after
    warm-up, with CUDA events."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _bound_ms(n_bytes: int, flops: int) -> tuple[float, str]:
    t_mem = n_bytes / MEM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def trainer_population(depths: str, acts: str, features: int,
                       classes: int = 2, repeats: int = 1, block: int = 8):
    """The layered population the trainer builds from its
    ``--population-*`` flags (members by ';', per-layer widths by ',';
    activations cycled over members, 'paper' for the ten)."""
    from repro_torch.core.activations import PAPER_TEN
    from repro_torch.core.population import LayeredPopulation
    widths = tuple(tuple(int(w) for w in m.split(","))
                   for m in depths.split(";") if m.strip())
    names = PAPER_TEN if acts == "paper" else tuple(
        a.strip() for a in acts.split(","))
    n = len(widths) * repeats
    return LayeredPopulation(features, classes, widths * repeats,
                             tuple(names[i % len(names)] for i in range(n)),
                             block=block).sorted()


def serve(name: str, lp, seed: int, workdir: Path, budget: int):
    """Init ``lp`` on the card, checkpoint it, and serve the checkpoint
    through the serving driver.  Returns (params, driver result)."""
    import torch

    from repro_torch.checkpoint.checkpoint import save_population
    from repro_torch.core.deep import init_params
    from repro_torch.launch import serve_population
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(gen, lp)
    ckpt = workdir / name
    t0 = time.perf_counter()
    save_population(str(ckpt), 0, params, lp)
    print(f"[{name}] {lp.describe()}; checkpoint written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    out = serve_population.main(["--ckpt-dir", str(ckpt), "--requests",
                                 "256", "--batch", str(BATCH)])
    torch.cuda.synchronize()
    print(f"[{name}] served in {time.perf_counter() - t0:.1f} s", flush=True)
    _require(out["budget"] == {"launches": budget, "budget": budget},
             f"{name}: launch budget {out['budget']}, expected {budget}")
    for mode, row in out["serve"].items():
        _require(row["requests"] == 256 and row["req_per_s"] > 0,
                 f"{name}/{mode}: {row}")
    return params, out


def check_forward(name, params, lp, x):
    """The served route (fused kernels) against the plain route on the card
    and, on the first rows, against the plain route on the CPU."""
    import torch

    from repro_torch.core.deep import forward
    with torch.inference_mode():
        got = forward(params, x, lp, bd_impl="fused", infer=True)
        plain = forward(params, x, lp, bd_impl="einsum", head_impl="xla",
                        infer=True)
    want_shape = (x.shape[0], lp.num_members, lp.out_features)
    _require(tuple(got.shape) == want_shape and bool(torch.isfinite(got)
                                                     .all()),
             f"{name}: served logits {tuple(got.shape)} not finite "
             f"{want_shape}")
    err = (got - plain).abs().max().item()
    _require(torch.allclose(got, plain, rtol=RTOL, atol=ATOL),
             f"{name}: fused forward vs plain route max |err| {err}")
    with torch.inference_mode():
        ref = forward(_to(params, "cpu"), x[:4].cpu(), lp, bd_impl="einsum",
                      head_impl="xla", infer=True)
    e_cpu = (got[:4].cpu() - ref).abs().max().item()
    _require(torch.allclose(got[:4].cpu(), ref, rtol=RTOL, atol=ATOL),
             f"{name}: card vs CPU max |err| {e_cpu}")
    print(f"[{name}] served forward vs plain route: max|err| {err!r} on the "
          f"card, {e_cpu!r} against the CPU", flush=True)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def compare(name, kernel, plain, library, n_bytes, flops, launches, iters):
    """Hold one kernel against its plain version on the same inputs, and
    time kernel, plain version and library call."""
    import torch
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    _require(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
             f"{name}: kernel vs plain max |err| {err} "
             f"(rtol {RTOL}, atol {ATOL})")
    bound, by = _bound_ms(n_bytes, flops)
    row = {"name": name, "route": "cuda",
           "source": f"src/repro_torch/kernels/csrc/{name}.cu",
           "launches": launches, "max_abs_err": err, "rtol": RTOL,
           "atol": ATOL,
           "ms": _time_ms(kernel, iters), "plain_ms": _time_ms(plain, iters),
           "bound_ms": bound, "bound_by": by,
           "library_ms": _time_ms(library, iters)}
    print(f"[{name}] max|err| {err!r}  kernel {row['ms']!r} ms  plain "
          f"{row['plain_ms']!r} ms  library {row['library_ms']!r} ms  bound "
          f"{bound!r} ms ({by}: {n_bytes} B, {flops} FLOP)", flush=True)
    return row


def kernel_rows(p10k, lp10k, p3k, lp3k, launches):
    """Phase 4 + 5: the three kernels at the main path's shapes."""
    import numpy as np
    import torch

    from repro_torch.core.activations import apply_activations_sliced
    from repro_torch.core.deep import pack_weight_tiles
    from repro_torch.kernels import fused_input as fik
    from repro_torch.kernels import fused_layer as flk
    from repro_torch.kernels import infer_head as ihk
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = []

    # fused_input at full width: x (32, 100) · W_in (1,280,000, 100)ᵀ
    p0 = lp10k.layer_pop(0)
    x = torch.randn(BATCH, lp10k.in_features, generator=gen, device=dev)
    w, b = p10k["w_in"], p10k["b_in"]
    ids = torch.as_tensor(p0.block_act_ids, dtype=torch.int32, device=dev)
    mask = torch.as_tensor(p0.hidden_mask, dtype=torch.float32, device=dev)
    blk = lp10k.block
    h = fik.fused_input_cuda(x, w, b, mask, ids, block=blk)

    def library_input():
        z = torch.addmm(b, x, w.t())
        return apply_activations_sliced(z, p0.act_runs) * mask

    rows.append(compare(
        "fused_input",
        lambda: fik.fused_input_cuda(x, w, b, mask, ids, block=blk),
        lambda: fik.fused_input_plain(x, w, b, mask, ids, block=blk),
        library_input, _nbytes(x, w, b, mask, ids, h),
        2 * BATCH * w.shape[0] * w.shape[1], launches["fused_input"], 20))

    # infer_head at full width, on the layer-0 activations just computed
    w2, b2 = p10k["w_out"], p10k["b_out"]
    seg = torch.as_tensor(p0.block_segment_ids, dtype=torch.int32,
                          device=dev)
    ptr = ihk.member_ptr(seg, lp10k.num_members)
    y = ihk.infer_head_cuda(h, w2, b2, ptr, block=blk)
    n_mem, width = lp10k.num_members, p0.total_hidden // lp10k.num_members
    _require(width * n_mem == p0.total_hidden
             and np.all(p0.padded_sizes == width),
             "parallelmlp-10k: members are not all one padded width")
    # one batched GEMM with the bias (every member is `width` units wide)
    hb = h.view(BATCH, n_mem, width).transpose(0, 1)
    wb2 = w2.view(w2.shape[0], n_mem, width).permute(1, 2, 0)
    rows.append(compare(
        "infer_head",
        lambda: ihk.infer_head_cuda(h, w2, b2, ptr, block=blk),
        lambda: ihk.infer_head_plain(h, w2, b2, ptr, block=blk),
        lambda: torch.baddbmm(b2[:, None, :], hb, wb2),
        _nbytes(h, w2, b2, ptr, y),
        2 * BATCH * h.shape[1] * w2.shape[0], launches["infer_head"], 20))
    got = ihk.infer_head_cuda(h, w2, b2, ptr, block=blk, log_probs=True)
    want = ihk.infer_head_plain(h, w2, b2, ptr, block=blk, log_probs=True)
    _require(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
             "infer_head log_probs: kernel vs plain")

    # fused_layer on the depth-3 population, both mid layers, each fed by
    # the layer before it as on the path; the row is one forward's worth
    # (the two launches summed)
    q0 = lp3k.layer_pop(0)
    x3 = torch.randn(BATCH, lp3k.in_features, generator=gen, device=dev)
    hin = fik.fused_input_cuda(
        x3, p3k["w_in"], p3k["b_in"],
        torch.as_tensor(q0.hidden_mask, dtype=torch.float32, device=dev),
        torch.as_tensor(q0.block_act_ids, dtype=torch.int32, device=dev),
        block=lp3k.block)
    layer_rows = []
    for l in range(lp3k.depth - 1):
        lay = lp3k.bd_layout(l)
        pout = lp3k.layer_pop(l + 1)
        b3 = lay.block
        wb = torch.cat([pack_weight_tiles(p3k["mid"][l]["w"], lp3k, l),
                        torch.eye(b3, device=dev)[None]])
        b_eff = p3k["mid"][l]["b"] * torch.as_tensor(
            lp3k.active_unit_mask(l + 1), dtype=torch.float32, device=dev)
        m3 = torch.as_tensor(pout.hidden_mask, dtype=torch.float32,
                             device=dev)
        a3 = torch.as_tensor(pout.block_act_ids, dtype=torch.int32,
                             device=dev)
        sched = flk.schedule_on(lay, dev)
        out = flk.fused_layer_cuda(hin, wb, b_eff, m3, a3, *sched, blk=b3)
        # the same block-sparse product as one cuSPARSE BSR matmul (no
        # bias / activation / mask)
        bsr = torch.sparse_bsr_tensor(
            sched[0], sched[1], wb[sched[2].long()],
            size=(lay.n_out_tiles * b3, lay.n_in_tiles * b3),
            check_invariants=True)
        args = (hin, wb, b_eff, m3, a3, *sched)
        layer_rows.append(compare(
            "fused_layer", partial(flk.fused_layer_cuda, *args, blk=b3),
            partial(flk.fused_layer_plain, *args, blk=b3),
            partial(torch.matmul, bsr, hin.t()), _nbytes(*args, out),
            2 * BATCH * b3 * b3 * lay.n_steps, launches["fused_layer"], 50))
        hin = out
    row = dict(max(layer_rows, key=lambda r: r["bound_ms"]))
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        row[key] = sum(r[key] for r in layer_rows)
    row["max_abs_err"] = max(r["max_abs_err"] for r in layer_rows)
    rows.insert(1, row)
    replaces = {"fused_input": "src/repro/kernels/fused_input.py:83",
                "fused_layer": "src/repro/kernels/fused_layer.py:98",
                "infer_head": "src/repro/kernels/infer_head.py:75"}
    for r in rows:
        r["replaces"] = replaces[r["name"]]
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this script runs only on a GPU", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found: run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__} CUDA {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # 2. build
    from repro_torch.configs import parallelmlp_10k
    from repro_torch.kernels import _build
    from repro_torch.launch.launch_count import (kernel_launches,
                                                 reset_kernel_launches)
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name in sorted(libs):
        for line in (_build.BUILD_DIR / f"{name}.log").read_text() \
                .splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # 3. the main path
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        workdir = Path(tmp)
        lp10k = parallelmlp_10k.config().model.layered()
        lp3k = trainer_population("64,32,16;13,5;7", "paper", 100,
                                  repeats=1000)
        _require(lp10k.num_members == 10_000
                 and lp10k.layer_pop(0).total_hidden == 1_280_000,
                 "parallelmlp-10k is not at full width")
        _require(lp3k.num_members == 3000 and lp3k.depth == 3,
                 "the trainer population is not 3,000 members deep 3")
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_launches()
        p10k, out10k = serve("parallelmlp-10k", lp10k, 0, workdir, 2)
        p3k, out3k = serve("trainer-depth3", lp3k, 1, workdir, 4)
        torch.cuda.synchronize()
        launches = kernel_launches()
        print(f"main-path kernel launches: {launches}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        for name, n in launches.items():
            _require(n > 0, f"kernel {name} was not launched on the main "
                     "path")

    # 4 + 5. each kernel against its plain version; timings; outputs
    x = torch.randn(BATCH, 100, generator=torch.Generator(device="cuda")
                    .manual_seed(3), device="cuda")
    check_forward("parallelmlp-10k", p10k, lp10k, x)
    check_forward("trainer-depth3", p3k, lp3k, x)
    rows = kernel_rows(p10k, lp10k, p3k, lp3k, launches)
    _require(sorted(r["name"] for r in rows) == sorted(libs),
             "a built kernel has no comparison row")

    # 6. results
    print(json.dumps({"serve": {"parallelmlp-10k": out10k["serve"],
                                "trainer-depth3": out3k["serve"]}}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
