"""Population serving engine: batched ensemble inference on one card, or
with ``--sharded`` under ``torchrun`` on several ranks.

``python -m repro_torch.launch.serve_population --ckpt-dir CKPT``

Request lifecycle:

  1. requests land in a HOST staging slab (two of them, alternating, so
     requests for flush k+1 stage while flush k's copy to the card may
     still be in flight; pinned memory on the card);
  2. the slab flushes when it fills to ``batch`` — or when the
     max-latency timer for its oldest request fires first (a partial slab,
     zero-padded to the full batch);
  3. one eager step per ensemble mode, under ``torch.inference_mode()``,
     runs the forward-only fused path (``deep.forward(infer=True)``:
     depth+1 kernel launches; or, with ``bd_impl="pallas"``, the unfused
     route's block-diagonal GEMM and segmented-activation kernels) and
     reduces the (B, P, O) member outputs on the card
     (``core.ensemble``): best-member routing, top-k soft-vote or
     all-members soft-vote, each with disagreement uncertainty;
  4. per-request latency = flush wait + step wall; the driver reports
     p50/p99 and req/s per mode.

The served member set comes from ``selection.leaderboard`` over a
calibration split evaluated with the SAME forward-only kernels
(``publish``); rank 0 becomes ``best1``'s route, the top-k slots become
``topk``'s vote.  Shard-pad fillers can never be published or reduced
over (``core.ensemble`` validates).

``compute_dtype="bfloat16"`` (``--compute-dtype bfloat16``) serves under
the bf16 compute policy (DESIGN.md §7): the requests and the weights are
cast to bf16 at every projection, each of the depth+1 launches is its
kernel's bf16 instance (``check_budget`` holds both), the logits stay f32,
and ``publish`` scores with the same forward.  On the unfused route
(``--bd-impl pallas``) the block-diagonal kernel's bf16 instance runs each
mid layer; over the int8 copy (``--weights-dtype int8``) the activations
are cast to bf16 before each int8 kernel, which runs its bf16-activation
instance (``*_int8_bf16``), still depth+1 launches.

``weights_dtype="int8"`` (``--weights-dtype int8``) serves the int8 copy
(DESIGN.md §12): the server quantizes the restored masters once, on their
device (``quant.quantize_population``), drops them, and every forward —
publish, the serve steps, the launch budget — runs the fused-dequant
kernels, still depth+1 launches.

``--sharded`` under ``torchrun --nproc-per-node W`` serves on the ranks'
``(data, model)`` mesh (``launch/mesh.py``, ``distributed/sharding.py``):
each model row holds the population, each rank restoring its range of
whole members (``restore_population(mesh=)``), and runs its share's
forward — the same kernels, depth+1 launches of its own depth — on its
rows of each flush: the flush's batch is split over the data axis where
the axis divides it (JAX's ``POP_LOGITS``, batch over ``data``, members
over ``model``), else every data row takes the whole flush.  The
per-member logits go to rank 0 over the host (members over each row,
then rows over the data column), and rank 0 reduces best1, topk or all
over the REAL members only (``core.ensemble``), so its answers are a
one-rank server's.  ``publish`` ranks the members' losses gathered over
the model row (every row scores the whole calibration split).  The int8
copy is packed per rank, from the rank's share (every scale is a
member's).  Without a process group ``--sharded`` serves as one rank.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core.deep import check_dtypes, forward
from repro_torch.core.ensemble import (ENSEMBLE_MODES, ensemble_predict,
                                       real_slots)
from repro_torch.core.selection import evaluate_population, leaderboard
from repro_torch.launch.launch_count import (fused_infer_budget,
                                             fused_infer_kernels,
                                             kernel_launches)
from repro_torch.quant import serve_copy_bytes


class PopulationServer:
    """Batched ensemble serving over a trained population on the device its
    parameters live on.  ``modes``: any of ``("best1", "topk", "all")``."""

    def __init__(self, params, layout, *, bd_impl: str = "fused",
                 act_impl: str = "pallas", compute_dtype=None,
                 weights_dtype=None, batch: int = 32, topk: int = 4,
                 max_latency_ms: float = 5.0, shard=None):
        self.weights_dtype = check_dtypes(compute_dtype, weights_dtype)
        self.compute_dtype = compute_dtype
        self.params = params
        self.batch = int(batch)
        self._target(layout, shard)
        self.device = params["w_in"].device
        self.topk = int(topk)
        self.max_latency_ms = float(max_latency_ms)
        self._fw = dict(bd_impl=bd_impl, act_impl=act_impl, infer=True,
                        compute_dtype=compute_dtype,
                        weights_dtype=self.weights_dtype)
        # the int8 copy is made once from the masters (at the first
        # consumer of self.params), which are then released
        self._quantized = self.weights_dtype is None
        self._host = self._staging(layout.in_features)
        self._flip = 0
        self.board = None
        self.published: dict = {"all": None}

    def _target(self, layout, shard):
        """``layout`` is the whole layout; on W ranks (``shard``, a
        ``PopulationShard`` of it) ``params`` are this rank's share and
        every forward runs ``self.local``, its layout, on this rank's rows
        ``self.rows`` of each flush (``population_batch_shardings``)."""
        from repro_torch.distributed.sharding import \
            population_batch_shardings
        self.layout = layout
        self.shard = (shard if shard is not None and shard.distributed
                      else None)
        self.local = layout if self.shard is None else self.shard.local
        self.rows = population_batch_shardings(
            None if self.shard is None else self.shard.mesh,
            self.batch)[1].indices(self.batch)[:2]
        self.split = self.rows != (0, self.batch)

    @property
    def is_writer(self) -> bool:
        """The rank that reduces and answers: rank 0, or the only one."""
        return self.shard is None or self.shard.is_writer

    def _staging(self, features: int) -> list[torch.Tensor]:
        """The two alternating host slabs (pinned when serving the card, so
        the copy to it is asynchronous)."""
        pin = self.device.type == "cuda"
        return [torch.zeros((self.batch, features), dtype=torch.float32,
                            pin_memory=pin) for _ in range(2)]

    # ----------------------------------------------------------------- #
    # published member set                                              #
    # ----------------------------------------------------------------- #

    def refresh(self, params, layout, shard=None):
        """Re-target the server at new (params, layout) — e.g. a training
        run's state after a halving rung.  Everything keyed on the layout
        resets: the leaderboard and published sets, and the staging slabs
        if the feature width changed.  Call
        :meth:`publish` after to re-derive the served member set."""
        if layout.in_features != self.layout.in_features:
            self._host = self._staging(layout.in_features)
        self.params = params
        self._target(layout, shard)
        self.device = params["w_in"].device
        # a halving rung may shrink the population below the served top-k
        self.topk = max(1, min(self.topk, real_slots(layout)))
        self.board = None
        self.published = {"all": None}
        self._quantized = self.weights_dtype is None   # re-quantize fresh
        return self

    def _ensure_quantized(self):
        """Replace the master weights with the int8 serve copy, once per
        (re)fresh: every consumer of ``self.params`` (``publish``, the serve
        steps, ``check_budget``) comes through here, so after the first the
        server holds no f32 weight, and no reference to the masters."""
        if self._quantized:
            return
        from repro_torch.quant import quantize_population
        self.params = quantize_population(self.params, self.local)
        self._quantized = True

    def publish(self, x_calib, y_calib, task: str = "classification",
                sort_by: str = "loss"):
        """Refresh the served member set from a leaderboard over a
        calibration split, scored with the same forward-only kernels the
        serve steps run (in slabs of ``selection.EVAL_SLAB`` rows).
        Returns the leaderboard rows."""
        self._ensure_quantized()
        losses, accs = evaluate_population(
            self.params, self.local, x_calib, y_calib, task=task,
            **self._fw)
        if self.shard is not None:
            losses = self.shard.gather_members(losses)
            accs = None if accs is None else self.shard.gather_members(accs)
        self.board = leaderboard(self.layout, losses, accs,
                                 k=max(self.topk, 1), sort_by=sort_by)
        self.published = {
            "best1": [self.board[0]["slot"]],
            "topk": [r["slot"] for r in self.board[:self.topk]],
            "all": None,                  # every real member, sliced on device
        }
        return self.board

    # ----------------------------------------------------------------- #
    # per-mode step                                                     #
    # ----------------------------------------------------------------- #

    def _step(self, mode: str):
        """The eager serve step of ``mode`` over the current published set,
        on this rank's rows of a flush: forward-only fused path, then the
        on-device ensemble reduction (on W ranks, on rank 0 over every
        rank's logits; the others' step returns None)."""
        if mode not in ENSEMBLE_MODES:
            raise ValueError(f"unknown mode {mode!r} (have {ENSEMBLE_MODES})")
        if mode != "all" and mode not in self.published:
            raise ValueError(f"mode {mode!r} needs a published member set "
                             "— call publish() first")
        self._ensure_quantized()
        ids = self.published.get(mode)
        lp, flush_logits = self.layout, self.flush_logits

        def step(params, xb):
            logits = flush_logits(params, xb)
            if logits is None:
                return None
            with torch.inference_mode():
                return ensemble_predict(logits, lp, mode, member_ids=ids,
                                        with_uncertainty=True)

        return step

    def flush_logits(self, params, xb):
        """A flush's logits ``(B, P, O)`` from this rank's rows of it,
        ``xb`` (``self.rows``): the forward of this rank's members, and
        on W ranks every rank's members and rows gathered to rank 0 over
        the host (None elsewhere)."""
        with torch.inference_mode():
            logits = forward(params, xb, self.local, **self._fw)
            if self.shard is None:
                return logits
            # (B_r, P_r, O) → rank 0's (B, P, O)
            got = self.shard.gather_rows(logits.transpose(1, 2), self.split)
            return None if got is None else got.transpose(1, 2).to(xb.device)

    # ----------------------------------------------------------------- #
    # request loop                                                      #
    # ----------------------------------------------------------------- #

    def run(self, xs, mode: str = "all", warmup: bool = True) -> dict:
        """Serve ``xs`` (N, F) through the batching loop → per-request
        predictions + latency stats.  Closed-loop: all requests are queued
        at t=0, so full slabs flush on fill and only the trailing partial
        slab flushes on its max-latency timer (its requests pay that wait
        in their recorded latency).  ``warmup`` runs one zero slab before
        the clock starts."""
        step = self._step(mode)
        lo, hi = self.rows
        xs = np.asarray(xs, np.float32)
        n = int(xs.shape[0])
        lat = np.zeros(n)
        preds = np.zeros(n, np.int64)
        unc = np.zeros(n, np.float32)
        if warmup:
            out = step(self.params, torch.zeros(
                (hi - lo, self.layout.in_features), device=self.device))
            if out is not None:
                out["pred"].cpu()
        t0 = time.perf_counter()
        i = 0
        while i < n:
            nb = min(self.batch, n - i)
            buf = self._host[self._flip]
            self._flip ^= 1
            buf[:nb] = torch.from_numpy(xs[i:i + nb])
            if nb < self.batch:               # max-latency flush: timer fired
                buf[nb:] = 0.0
            # this rank's rows of the flush
            out = step(self.params, buf[lo:hi].to(self.device,
                                                  non_blocking=True))
            if out is not None:
                preds[i:i + nb] = out["pred"].cpu().numpy()[:nb]
                unc[i:i + nb] = out["mutual_information"].cpu().numpy()[:nb]
            elif self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            done = time.perf_counter() - t0
            # every request in the slab completes at the flush's done time;
            # a timer-fired partial slab waited out max_latency first
            lat[i:i + nb] = done + (self.max_latency_ms / 1e3
                                    if nb < self.batch else 0.0)
            i += nb
        wall = time.perf_counter() - t0
        return {
            "mode": mode,
            "members_served": (real_slots(self.layout)
                               if self.published.get(mode) is None
                               else len(self.published[mode])),
            "requests": n,
            "pred": preds,
            "mutual_information": unc,
            "p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p99_ms": float(np.percentile(lat, 99) * 1e3),
            "req_per_s": n / max(wall, 1e-9),
            "wall_s": wall,
        }

    # ----------------------------------------------------------------- #
    # invariants                                                        #
    # ----------------------------------------------------------------- #

    def check_budget(self):
        """One serve forward must advance the kernel counters by exactly
        depth+1: input + (depth−1) mid layers + infer head, each the
        instance of the served weights and compute dtype
        (``launch_count.fused_infer_kernels``); on W ranks, of this rank's
        layout's depth.  Raises otherwise."""
        self._ensure_quantized()
        lp = self.local
        xb = torch.zeros((self.rows[1] - self.rows[0], lp.in_features),
                         device=self.device)
        before = kernel_launches()
        with torch.inference_mode():
            forward(self.params, xb, lp, **self._fw)
        after = kernel_launches()
        diff = {k: after[k] - before[k] for k in after
                if after[k] != before[k]}
        got = sum(diff.values())
        budget = fused_infer_budget(lp.depth)["total"]
        if got != budget:
            raise RuntimeError(f"serve forward made {got} kernel launches, "
                               f"the budget is {budget} (depth+1)")
        want = fused_infer_kernels(lp.depth, self.compute_dtype,
                                   self.weights_dtype)
        if diff != want:
            raise RuntimeError(f"serve forward launched {diff}, expected "
                               f"{want}")
        return {"launches": got, "budget": budget}

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, step: int | None = None,
                        device="cuda", mesh=None, **kw):
        """A server over a checkpoint; with ``mesh`` of W ranks, over this
        rank's share (every rank reads the step rank 0 found)."""
        from repro_torch.checkpoint.checkpoint import (latest_steps,
                                                       restore_population)
        if mesh is None or mesh.size == 1:
            params, layout, step = restore_population(ckpt_dir, step=step,
                                                      device=device)
            return cls(params, layout, **kw), step
        if step is None:
            found = latest_steps(ckpt_dir) if mesh.is_writer else []
            step = mesh.broadcast_int(found[-1] if found else -1)
            if step < 0:
                raise FileNotFoundError(
                    f"no committed checkpoints under {ckpt_dir}")
        params, layout, step, shard = restore_population(
            ckpt_dir, step=step, device=device, mesh=mesh)
        return cls(params, layout, shard=shard, **kw), step


def main(argv=None) -> dict:
    """The serving driver.  Returns {"step", "budget", "board", "serve",
    "serve_copy_bytes"} (``serve``: the per-mode latency and throughput
    rows; ``serve_copy_bytes``: the served parameters' device bytes)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--modes", nargs="+", default=list(ENSEMBLE_MODES),
                    choices=list(ENSEMBLE_MODES))
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--topk", type=int, default=4)
    ap.add_argument("--max-latency-ms", type=float, default=5.0)
    ap.add_argument("--calib-samples", type=int, default=512)
    ap.add_argument("--sharded", action="store_true",
                    help="under torchrun: serve the population axis "
                    "across the ranks (each rank its range of whole "
                    "members, rank 0 reduces); without a process group, "
                    "one rank")
    ap.add_argument("--bd-impl", default="fused",
                    choices=["fused", "pallas", "einsum"])
    ap.add_argument("--act-impl", default="pallas",
                    choices=["pallas", "sliced", "masked"],
                    help="activation pass of the unfused routes (the fused "
                    "kernels apply the activation in their epilogue)")
    ap.add_argument("--compute-dtype", default=None,
                    choices=["float32", "bfloat16"],
                    help="bfloat16: the mixed-precision policy (bf16 "
                    "operands, f32 sums and logits) on the kernels' bf16 "
                    "instances (any --bd-impl, --weights-dtype int8) or "
                    "the plain route")
    ap.add_argument("--weights-dtype", default=None, choices=["int8"],
                    help="int8: quantize the restored weights once "
                    "(quant.quantize_population) and serve only the int8 "
                    "copy through the fused-dequant kernels")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                    "PyTorch versions)")
    ap.add_argument("--dist-timeout", type=float, default=600.0,
                    help="--sharded under torchrun: the process group's "
                    "timeout in seconds")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    check_dtypes(args.compute_dtype, args.weights_dtype)
    mesh = None
    if args.sharded:
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(timeout_s=args.dist_timeout)
    try:
        return _serve(args, mesh)
    finally:
        if mesh is not None:
            from repro_torch.launch.mesh import close
            close(mesh)


def _serve(args, mesh) -> dict:
    device = args.device
    if mesh is not None and mesh.group is not None:
        device = mesh.device(args.device)
        print(mesh.describe(device), flush=True)
    server, step = PopulationServer.from_checkpoint(
        args.ckpt_dir, step=args.step, device=device, mesh=mesh,
        batch=args.batch, topk=args.topk,
        max_latency_ms=args.max_latency_ms, bd_impl=args.bd_impl,
        act_impl=args.act_impl, compute_dtype=args.compute_dtype,
        weights_dtype=args.weights_dtype)
    say = print if server.is_writer else (lambda *a, **k: None)
    lp = server.layout
    say(f"restored step {step}: {real_slots(lp)} members "
        f"(+{lp.num_members - real_slots(lp)} fillers), "
        f"F={lp.in_features} O={lp.out_features} depth={lp.depth} "
        f"on {server.device}")
    if server.shard is not None:
        say(f"mesh {dict(server.shard.mesh.shape)}: members over the model "
            f"axis {list(server.shard.ranges)}, rows of a flush of "
            f"{server.batch} "
            + ("split over the data axis" if server.split else
               "on every data row"))

    from repro_torch.data.synthetic import TabularTask
    task = TabularTask(args.calib_samples + args.requests, lp.in_features,
                       n_classes=lp.out_features, seed=0)
    (xc, yc), (xr, _) = task.split(
        frac=args.calib_samples / (args.calib_samples + args.requests))

    budget = None
    if args.bd_impl == "fused":
        budget = server.check_budget()
        say("launch budget:", budget)
    board = server.publish(xc, yc)
    served_bytes = serve_copy_bytes(server.params)
    say(f"serving {args.weights_dtype or 'float32'} weights: "
        f"{served_bytes} bytes of parameters on {server.device}"
        + (" (this rank's share)" if server.shard is not None else "")
        + (f"; compute {args.compute_dtype}" if args.compute_dtype
           else ""))
    say(f"published: best1={server.published['best1']} "
        f"topk={server.published['topk']}")
    for row in board[:3]:
        say("  ", row)
    results = {}
    preds = {}
    for mode in args.modes:
        r = server.run(xr[:args.requests], mode)
        results[mode] = {k: v for k, v in r.items()
                         if k not in ("pred", "mutual_information")}
        preds[mode] = r["pred"]
        say(f"{mode:6s} members={r['members_served']:3d} "
            f"p50={r['p50_ms']:.2f}ms p99={r['p99_ms']:.2f}ms "
            f"{r['req_per_s']:.0f} req/s")
    out = {"step": step, "budget": budget, "board": board, "serve": results,
           "serve_copy_bytes": served_bytes}
    if server.shard is not None:
        out["ranks"] = list(server.shard.ranges)
        out["rows"] = list(server.rows)
    if not server.is_writer:
        return out
    out["pred"] = {m: p.tolist() for m, p in preds.items()}
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=2, default=str)
        print("wrote", args.json_out)
    return out


if __name__ == "__main__":
    main()
