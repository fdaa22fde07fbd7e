#!/usr/bin/env python3
"""Build the PyTorch port's CUDA kernels, then serve and train the paper's
population on one NVIDIA GPU, end to end, through the entry points a user
calls.

    python3 chip_smoke.py [--parent DIR]

``--parent DIR`` (another checkout, e.g. the parent commit's ``git
archive``) also holds the ``infer_head`` (f32 and int8), ``loss_head_fwd``
and ``loss_head_bwd`` outputs bitwise to that tree's kernels at both heads'
shapes, the M3 dW at path 4d's, the input layer's
(``fused_input`` y, its training launch's y and g', ``fused_input_int8``
y) at both input-layer shapes, and the mid layers' (``fused_layer`` y and
y, g', ``fused_layer_int8`` y, ``block_diag_fwd`` y and dh,
``block_diag_dw`` dWB) at both depth-3 mid layers, timing the parent's
mid-layer kernels and M3 forward and dW beside them (phase 8).  A parent
whose gelu is x/2·(1 + erf(x/√2)) (this tree's is x/2·erfc(−x/√2), JAX's)
differs in the gelu members' columns of the activation epilogues' outputs
(``fused_input`` and ``fused_layer``, f32 and int8): those are held bitwise
outside those columns and, inside, within the f32 tolerance of the
parent's and, where the kernel's own pre-activation lies below −2 (the
tail, where 1 + erf cancels), no farther in relative terms from the f64
function of it than the parent's; how many moved and how far is in the
rows' ``parent_gelu`` fields.  The
f32 ``seg_act`` kernels' ptxas report is held to the parent's.

Phases (any failure exits non-zero, and no result line is printed):

  1. the card's name and power limit (``nvidia-smi``);
  2. build every kernel from ``src/repro_torch/kernels/csrc`` (nvcc, one
     process per source, in parallel);
  3. the serving path, every kernel counter set to 0 before it and read
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
       c. the int8 serving path: both checkpoints served again by
          ``serve_population.main --weights-dtype int8``, each run counted
          alone: depth+1 launches a forward, int8 kernels only; req/s and
          p50/p99 per mode beside the f32 serve's; then each checkpoint's
          int8 copy as the server holds it: device memory with only that
          copy alive, byte-equal to the copy quantized on the CPU, its
          size against the f32 tree's, and its forward against the f32
          kernels on its dequantized tree;
       d. the unfused route (the block-diagonal GEMM and segmented-
          activation kernels): both checkpoints served again by
          ``serve_population.main --bd-impl pallas --act-impl pallas``,
          each run counted alone: every forward exactly ``seg_act`` ×depth
          and ``block_diag_fwd`` ×(depth−1), nothing else; req/s and
          p50/p99 per mode beside the fused serve's; then each
          checkpoint's unfused forward (logits, and the ``all`` ensemble's
          probabilities) against the fused route's;
  4. the training path, the counters set to 0 just before each training
     run and read just after it (the held-out checks run outside them):
       a. ``parallelmlp-10k`` at full width trained by
          ``repro_torch.launch.train.main`` (``--bd-impl fused``, sgd, batch
          32, 16 steps in chunks of 8, checkpoints every 8 steps), then the
          trained checkpoint served by ``serve_population.main`` in f32
          and in int8 (counted on the two serving paths; the int8 copy
          checked as in 3c);
       b. the depth-3 population trained with ``--optimizer adamw
          --grad-clip 1.0 --lr-schedule warmup_cosine``;
       c. the same, on the unfused route (``--bd-impl pallas --act-impl
          pallas``);
       d. the paper's single-layer ParallelMLP (``core/parallel_mlp``) at
          the full width of ``parallelmlp-10k``: ``init_params`` from a
          seeded generator, 16 ``sgd_step``s at batch 32 with
          ``m3_impl="pallas"`` (exactly one launch of each M3 kernel a
          step, no other kernel), the held-out loss below the same seed's
          initial loss, then ``evaluate_population`` (512 held-out rows),
          ``select_best`` and ``leaderboard`` on the M3 kernels, the best
          member's standalone forward against its column of the fused
          logits, and a ``"single"`` checkpoint round trip;
       e. the depth-3 population on the unfused route with ``--m3-impl
          pallas`` (every unfused stage on its kernel);
       f. the paper's Tables 1-2 at its exact layout (hidden 1..100 × the
          ten activations × 10 repeats, F 100, block 1: 10,000 members,
          505,000 fused units) through ``repro_torch.launch.paper_tables``:
          (i) one cell of the grid by ``paper_tables.run`` (samples 1,000,
          batch 32, 10 epochs, seq-sample 25, ``m3_impl="pallas"``), the
          counters zeroed before each arm and read after it — exactly one
          launch of each M3 kernel a parallel step, the warm-up too, and
          none in the sequential arm — and its CSV row; (ii) independence:
          8 ``parallel_train`` steps from one seeded state and
          ``sequential_train`` on the same batches for 3 sampled members
          of different activations and sizes, each member's parameters
          against ``extract_member`` of the fused state within rtol 2e-4 /
          atol 2e-5; (iii) ``examples/torch_feature_selection.py`` at its
          own sizes with ``--m3-impl pallas``: every masked w1 entry
          exactly 0 after every step, one launch of each M3 kernel a step;
       g. the lifecycle and the refill search (``core/lifecycle.py``,
          ``repro_torch.search``), each run through ``train.main`` with the
          counters set to 0 just before it and read just after it: the
          10k ladder (sgd, 24 steps, ``--halving "8:0.5,16:0.5"
          --rung-eval-batches 4``: 10,000 → 5,000 → 2,500 members, fused
          width 1,280,000 → 640,000 → 320,000); the depth-3 population
          under AdamW and clipping (a constant lr) with ``--halving
          "8:0.5"``, with ``--refill arch --search-space ...`` and with
          ``--refill pbt --per-member-lr``.  Checked: every segment
          exactly 2·(depth+1) launches a step, kernel by kernel, and no
          other kernel; the members (and the 10k fused width) after each
          rung; a pbt rung builds no table and reuses its chunk, and no
          segment after a rung builds one; each rung's saved state, a
          step on the fused route against the plain route on the card;
          the survivors' held-out loss falls; the depth-3 halving run
          stopped at step 12 and resumed against the straight run; the
          compaction (10k, depth 3), growth and refill on the card bitwise
          the same on the CPU.  Printed: each rung's eval, gather and
          table-build time and the run's device memory after it; each
          segment's step wall; the 10k ladder's device time a step and
          idle share by segment (a second run without checkpoints, a
          third under ``torch.profiler``) and its model-steps/s against
          the same 24 steps without ``--halving``; the steady-state step
          (``time_train_step``) of each rung's layout;
       h. the optimizers and the checkpoint (a process of its own, as 4g):
          ``parallelmlp-10k``'s fused step at batch 32 under sgd, AdamW
          (f32 state), AdamW (bf16 state) and adafactor, in turns: exactly
          2·(depth+1) = 4 launches a step, the state's bytes read from its
          tensors against those of the shapes (``STATE_BYTES_10K``), the
          steady step's wall, device time and idle share; an update of
          the bf16 AdamW and adafactor on the card against the CPU at the
          10k shapes, from one state with live moments (f32 within rtol
          1e-5 / atol 1e-6, bf16 within one ulp); the 10k ladder under ``--optimizer adafactor
          --weight-decay 0.001`` (24 steps, checkpoints every 8 through
          the ``AsyncCheckpointer``: each rung's saved state's statistics
          fresh zeros with its bf16 momentum carried, the momentum's
          gather on the card bitwise the CPU's, the held-out loss falling,
          a run stopped at step 12 and resumed bitwise the straight run);
          the depth-3 population (clip 1.0, constant lr) under adafactor
          with ``--halving "8:0.5"`` and ``--refill arch``, and ``--refill
          pbt --per-member-lr``, and under AdamW with ``--opt-state-dtype
          bfloat16 --halving "8:0.5"`` (4g's checks of each run); the 10k
          parameters and adafactor state (806,560,420 B): the time
          ``maybe_save`` holds the loop and its worker's write against a
          synchronous ``save``, the checkpoint restored bitwise on the
          card and on the CPU, and a ``TrainRunner`` crash replay with
          async saves bitwise an unbroken run;
       i. the bf16 compute policy (a process of its own, as 4g; alone:
          ``chip_smoke.py --bf16 DIR``): (i) both checkpoints of phase 3
          served by ``serve_population.main`` in f32 and under
          ``--compute-dtype bfloat16`` in turns, on the fused route and
          over the int8 copy (``--weights-dtype int8``), the depth-3 one on
          the unfused route too (``--bd-impl pallas --act-impl pallas``),
          each bf16 run counted alone (every forward depth+1 launches of
          the ``*_bf16`` or ``*_int8_bf16`` instances, or the unfused
          route's ``block_diag_fwd_bf16`` ×(depth−1) and ``seg_act``
          ×depth, nothing else), req/s and p50/p99 per mode beside the f32
          serve's, the bf16 logits against the CPU's (the CPU tests' slice
          tolerance) and within JAX's policy tolerance (rtol 1e-1 / atol
          5e-2) of the f32 ones but the hardshrink members; (ii)
          ``parallelmlp-10k`` trained by ``train.main --compute-dtype
          bfloat16`` (sgd, batch 32, 16 steps in chunks of 8, checkpoints
          every 8) on the fused route and on the unfused route with the
          M3 head (``--bd-impl pallas --act-impl pallas --m3-impl
          pallas``), each counted alone: every step exactly its route's
          bf16 launches (2·(depth+1); ``seg_act``, ``seg_act_bwd`` and one
          of each M3 kernel's bf16 instance) and no other kernel in the
          loop, f32 masters in the checkpoint and the policy in its meta,
          the held-out loss falling, one step on the card against the
          CPU's plain versions within the CPU tests' slice tolerance
          (losses 2e-2, gradients and parameters rtol 1e-2 / atol 1e-3),
          the steady step (wall, device ms, idle share, the casts and
          other non-population kernels apart) beside the f32 step of the
          same route, in turns; (iii) the depth-3 population under
          ``--optimizer adamw --grad-clip 1.0 --compute-dtype bfloat16
          --halving "8:0.5" --serve-publish``: each segment 2·(depth+1)
          bf16 launches a step, a ``published:`` set at the rung and at
          the end, the last a fresh ``PopulationServer``'s on the final
          checkpoint; and path 4e's run under the policy (the unfused
          route with the M3 head, AdamW, clip 1.0): (ii)'s checks, every
          step the block-diagonal and M3 kernels' bf16 instances; (iv)
          the bf16 instances of rows 1–15 but 16–17 (which the policy
          hands f32) at the main paths' shapes (``bf16_*`` fields of their
          rows), each output ≤ 1 bf16 ulp from its plain version beyond
          the f32 atol and, at that carve-out, within 1 ulp of the f64
          sum of the same bf16 products rounded once or within an f32
          sum's worst-case error of it (``bf16_f64_*``);
       j. the streaming data plane (a process of its own, as 4g; alone:
          ``chip_smoke.py --pipeline DIR``): (i) ``parallelmlp-10k`` at
          full width, fused, sgd, B 32, 64 steps in chunks of 8, no
          checkpoints, a warm-up run, then ``--pipeline on`` and ``off``
          in turns (on, off, off, on), each counted alone: final
          parameters bitwise equal, per-chunk losses identical, kernel
          launches equal; each run's train-loop wall and model-steps/s
          (with and without the runner's initial-state snapshot); one run
          of each mode in a
          profiler window held to the counters, and over its last 4
          chunks the device's idle share, kernels and copies apart; (ii)
          the depth-3 population under AdamW, clip 1.0 (4g's flags) with
          ``--halving "8:0.5" --refill pbt --per-member-lr``, on against
          off: parameters and the final checkpoint's arrays bitwise equal,
          the pbt rung building no table and, pipelined, no staging
          buffer; (iii) every staging buffer pinned, the slab copies
          ("Pinned -> Device") on a stream apart from the kernels', each
          slab copy's gap from the kernels in both windows, and, where the
          host does not wait on the card (a ``Prefetcher`` feeding the 10k
          input layer's training forward chunk by chunk), a copy of a
          chunk overlapping a kernel of an earlier chunk (both timestamps
          printed);
       k. the population axis across ranks (a process of its own, as 4g;
          alone: ``chip_smoke.py --sharded DIR``), W ranks sharing the one
          card under ``torch.distributed.run --standalone`` (gloo), each
          job's kernel counters set to 0 just before it and read just
          after on every rank: (i) ``parallelmlp-10k`` at full width,
          fused, sgd, B 32, 16 steps in chunks of 8, checkpoints at steps
          8 and 16, on W = 2 against W = 1: every checkpoint array
          byte-equal and the manifests equal (no fillers at 10k: the real
          members bitwise), the per-chunk losses equal, each rank's loop
          2·(depth+1) launches a step, both one-card walls and
          model-steps/s; (ii) the depth-3 population at 999 repeats
          (2,997 members, ``shard_pad(4)`` adding 3 fillers), AdamW, clip
          1.0, ``--halving "4:0.5,8:0.5"``, 12 steps, ``--shard-pad 4``:
          W = 4 against W = 1 within the optimizer tolerance (rtol 1e-5 /
          atol 1e-6) with the same survivors at both rungs and each
          rank's segments 2·(depth+1) launches a step of its own depth,
          then W = 4's checkpoint after the first rung resumed at W = 1
          and W = 1's at W = 2, each within the tolerance of the run it
          left; (iii) ``serve_population --sharded`` at W = 2 over the 10k
          checkpoint in f32 and int8: every mode's predictions equal
          W = 1's, the served logits on a batch bitwise W = 1's, each
          rank's forward depth+1 launches, req/s and p50/p99 beside
          W = 1's; then the data axis: (iv) the 10k at B 48, 8 steps,
          on W = 3 (data 3: 16 rows a rank, the gradients averaged over
          the data column by gloo on the card's tensors) against W = 1:
          the checkpoint within the optimizer tolerance, the three ranks'
          parameters the same bits, 4 launches a step on each rank, both
          one-card walls and the all-reduce's host ms a step; (v) the
          depth-3 ladder of (ii) at B 48 on W = 6 (data 3 × model 2)
          against W = 1 with ``--shard-pad 2``: the same survivors at
          both rungs, each data column's ranks the same bits, each rank's
          segments 2·(depth+1) a step of its own depth; (vi)
          ``serve_population --sharded`` at W = 3, flushes of 48 split
          over the data axis: every mode's predictions equal W = 1's, a
          split flush's logits bitwise W = 1's on the same row shares
          and within the tolerance of its whole flush, each rank's
          forward depth+1 launches;
       l. the decoder LMs served (a process of its own, as 4g; alone:
          ``chip_smoke.py --lm DIR``) by ``repro_torch.launch.serve.
          generate_lm`` with random bf16 weights from a seeded generator:
          qwen3-1.7b whole (28 layers, 4 prompts of 512 tokens, 32 greedy
          tokens), deepseek-moe-16b at full width cut to 4 layers (its
          dense layer 0 and three MoE layers of 64 experts, top-6, 2
          shared; the same traffic), h2o-danube-3-4b at full width cut
          to 2 layers (one prompt of 4,608 tokens, past its 4,096 window,
          then 16 tokens), nemotron-4-340b at full width cut to 2 of 96
          layers (d_head 192; 4 × 512 + 16), mamba2-780m whole (48 SSM
          layers; 4 × 512 + 32) and hymba-1.5b whole (32 hybrid layers;
          one prompt of 2,048 tokens, past its 1,024 window, + 32), each
          run twice with the counters set to 0 just before and read just
          after: exactly one ``flash_attention`` launch per attention or
          hybrid layer in the prefill and none in decode,
          three ``moe_gemm`` launches per MoE layer per forward, nothing
          else, the two runs' tokens equal; prefill ms, decode ms a token
          and tokens/s of the second run; each distinct kernel call (shape
          and window) of a prefill and a decode step at the model's
          shapes against its plain version, timed beside it, SDPA
          (``is_causal``, ``enable_gqa``; the window as a boolean mask)
          or ``torch.bmm`` over the capacity buffer, and its bound; the
          prefill's last logits and up to 8 teacher-forced decode steps'
          logits against the same calls with ``flash_attn_dense``/
          ``moe_gemm_dense`` on the card (max |difference| within 1e-2 of
          the logits' scale or 2 bf16 ulps of it; hymba-1.5b alone, past
          that, the kernels' run no farther from the same calls in f32
          than 1.25 times the plain run is, ``LM_LOGIT_F32``); the
          greedy tokens' agreement reported, not asserted);
       m. the decoder LMs trained (a process of its own, as 4g; alone:
          ``chip_smoke.py --lm-train DIR``): (a) qwen3-1.7b whole (28
          layers, bf16 parameters, remat, AdamW) trained by
          ``repro_torch.launch.train.main --arch qwen3-1.7b --batch 4
          --seq 512 --steps 16 --warmup 4 --ckpt-every 0``, then
          hymba-1.5b whole (8 steps) and mamba2-780m whole (4 steps) the
          same way, the counters set to 0 just before and read just
          after: exactly two ``flash_attention`` launches an attention or
          hybrid layer a step (the forward and its recompute; none for
          mamba2) and nothing else; the step walls (the median of steps
          2 on), the peak device memory, and the loss of a held-out
          ``TokenTask`` batch (a step no run draws) before training (the
          driver's init, a generator seeded 0) and after it, which must
          be lower; then two more steps of the driver's step function
          under ``torch.profiler``: device ms, launches and idle share a
          step; (b) from qwen3's and mamba2's states and one batch each,
          the gradients
          (``lm.loss_and_grads``, the step's own) and one
          ``make_train_step`` update through the kernels and through the
          plain versions (4l's swap): every gradient leaf, the loss and
          the gradient norm within 1e-2 of the plain value's scale or 2
          bf16 ulps of it, or, where larger, within bf16's own reach: the
          plain run's max distance from the same function on the
          parameters widened to f32 (how many leaves the first rule
          holds is printed), and the leaves a second run of the
          kernels' gradients does not give bitwise (printed); (c) the same update in 2 microbatches: its
          loss at that rule and twice the flash launches; the training
          forward's flash call at its shape against its plain version
          and SDPA, timed, and its bound; (d) deepseek-moe-16b at full
          width cut to 4 layers trained 4 steps of B 4 × S 512 by
          ``train.run_lm``: no grouped-GEMM launch (the experts train on
          JAX's einsum route), every (layer, expert) gradient of the
          three expert weights finite and non-zero, then the trained
          parameters served by ``generate_lm`` with three grouped-GEMM
          launches a MoE layer a forward;
  5. the training step's invariants: one ``opt_step`` is exactly
     2·(depth+1) kernel launches; a fused step on the card against the
     plain route on the card and the same step on the CPU (per-member
     losses, gradients, updated parameters); two fused steps from one
     state are bitwise equal; one single-layer step (path 4d) launches the
     three M3 kernels once each, matches the same step with
     ``m3_impl="bucketed"`` on the card and on the CPU, and two such steps
     from one state are bitwise equal; one unfused step launches ``seg_act``,
     ``seg_act_bwd`` ×depth, ``block_diag_fwd`` ×2(depth−1) and
     ``block_diag_dw`` ×(depth−1) and matches the fused step from the same
     state; then the steady-state step timed (host wall per synchronised
     step; device time by kernel and the device's idle share from
     ``torch.profiler``), the depth-3 step fused, unfused and unfused
     with the M3 head (path 4e) in turns (fused, unfused, M3, M3, unfused,
     fused), and the single-layer step with
     ``m3_impl`` pallas and bucketed in turns (pallas, bucketed, bucketed,
     pallas), then path 4f's two arms a step each (the fused step at
     block 1 on the M3 kernels; a sampled member's eager step);
  6. the JAX package's kernel API (``ops.flash_attention``,
     ``ops.moe_gemm``) at three model configurations' full widths, seeded
     random inputs, the counters set to 0 just before and read just after:
     qwen3-1.7b attention (B 2, S 4096, H 16, Hkv 8, dh 128, causal)
     forward in f32 and bf16, then an f32 forward and backward on the
     model layout's transposed views; h2o-danube-
     3-4b's (B 1, S 8192, H 32, Hkv 8, dh 120, window 4096) bf16 forward;
     nemotron-4-340b's (B 4, S 512, H 96, Hkv 8, dh 192, causal) forward
     in f32 and bf16 on the DP 192 instances (their names as the profiler
     recorded them);
     deepseek-moe-16b's two expert projections (64 experts, D 2048, F 1408)
     over the capacity buffer of 4096 tokens top-6 (512 rows an expert,
     T = 32,768) in f32 and bf16, and both over a seeded top-6 routing with
     every expert's run padded to 128 rows, some empty (f32; the up
     projection in bf16 too).  Exactly one launch a forward, none in the
     backward (6 flash, 7 grouped-GEMM launches), every bf16 launch on the
     tensor-core design and every f32 one on the FMA design (each
     wrapper's ``kernel_path``, and the kernel ``torch.profiler`` saw
     launched: ``*wgmma_kernel``, and for the grouped GEMM's f32 launches
     the SIMT GEMM ``moe_gemm_simt_kernel``); the outputs finite and
     against the
     plain versions (attention: the dense oracle, f32 at rtol 1e-4 / atol
     1e-5, bf16 at rtol 1e-2 and a per-element atol of 2^-8 times the
     attention of |v|, the most that rounding p to bf16 can move an
     output; the gradients at 2e-4 against autograd of the oracle, which
     is what the backward runs: a check of its wiring, not of a kernel;
     grouped GEMM: f32 at rtol 1e-4 / atol 1e-4, bf16 at 1e-2);
  7. each kernel against its plain PyTorch version on the same inputs at
     the paths' shapes (rtol 1e-4 / atol 1e-5, f32, TF32 off, unless a
     row says otherwise; the M3 kernels at both path 4d's and path 4e's
     head; the loss-head kernels at ``parallelmlp-10k``'s and at the
     depth-3 population's head, block 8), and the served forward against
     the plain route on the card and on the CPU;
  8. each kernel, its plain version and the nearest library call timed
     with CUDA events; the least time the card could take (bound) from the
     bytes and operations of this run's inputs (f32 at 67 TFLOP/s, bf16 at
     the tensor cores' 989); the ``infer_head`` and loss-head rows also
     carry each kernel's device time from ``torch.profiler``
     (``device_ms``: at block 8 the event time is the host's launch time),
     the design each launch took (``path``, by ``kernel_path``) and the
     depth-3 head as ``depth3_*``; ``infer_head`` its log-probabilities
     instance's times (``log_probs_*``) and its f32 kernels' ptxas report;
     ``fused_input`` and ``fused_input_int8`` the instance each launch
     takes (``path``, ``train_path``, by ``fwd_path``), their device times
     (``device_ms``, ``train_device_ms``), the depth-3 input layer (block
     8, H 88,000) as ``depth3_*``, two launches on the same inputs bitwise
     equal, and (int8) whether it is bitwise the f32 kernel on the
     dequantized weight (``bitwise_f32_dequantized``, required where both
     take the same instance), and every instance's ptxas report;
     the loss-head rows the fewest PyTorch calls that compute the kernel's
     whole function, checked against it and timed (``library_full_ms``,
     named in ``library_full_calls``; ``library_ms`` stays the single
     call); the grouped GEMM's f32 runs the FMA instance they took
     (``fma_instance``: tile rows, vec4 or scalar); ``fused_layer_dx_dw``
     its device time and the whole function in PyTorch calls (dy·g', the
     transposed BSR matmul, a bmm on tiles gathered in the timed call:
     ``library_full_*``; ``library_ms`` stays the dx-only BSR matmul);
     the three ``m3_matmul`` rows their device times at both shapes
     (``device_ms``, ``path_b_device_ms``), two launches on the same inputs
     bitwise equal at both, and at path 4e's head (members 8 and 16
     units wide) a CSR library call each (``path_b_library_ms``, its
     device time ``path_b_library_device_ms``, its result held to the
     plain version: ``torch.matmul`` on w2 laid out beforehand as a
     CSR matrix for the forward and dh, ``torch.sparse.sampled_addmm`` on
     its pattern for dW); the forward and dW (on the heads'
     cores) each launch's instance (``path``, ``path_b_path``, by
     ``kernel_path``) and whether they are bitwise ``infer_head``'s logits
     with a zero bias and ``loss_head_bwd``'s dW with d_per ones
     (``bitwise_*``, required where both take one instance), and all three
     their ptxas report; ``fused_layer`` and ``block_diag_fwd`` (the
     group core) their device times (``device_ms``, and
     ``train_device_ms`` or the dh pass's ``dh_device_ms``), each launch's
     instance (``path``, ``train_path``, ``dh_path``, by
     ``block_diag.fwd_path``), two launches on the same inputs bitwise
     equal, and their ptxas report; ``fused_layer_int8`` the same of its
     group kernel (``device_ms``, ``path`` by ``fwd_path`` of the int8
     tiles, ptxas) and whether it is bitwise the f32 group kernel on the
     dequantized tiles (``bitwise_f32_dequantized``, required where both
     take the same instance); ``block_diag_dw`` its member-owned kernel's
     device time, instance (``path``, by ``block_diag.dw_path``) and
     ptxas report, two launches bitwise equal; ``fused_input_bwd`` its device time, the
     instance it took (``path``, by ``bwd_path``), dy·g' then ``mm`` as
     ``library_full_*`` (``library_ms`` stays the ``mm`` of duᵀ·x) and dx
     beside dW (``dx_*``); ``infer_head_int8`` its design (``path``), its
     device time, the depth-3 head as ``depth3_*`` and whether it is
     bitwise the f32 kernel on the dequantized weight
     (``bitwise_f32_dequantized``, required where both take the same
     instance); these rows, and ``infer_head``, their kernels' ptxas
     report; ``fused_layer_dx_dw`` and ``fused_input_bwd`` (with and
     without dx) two launches on the same inputs bitwise equal; with
     ``--parent``, ``infer_head`` (f32 and int8, logits and
     log-probabilities), ``loss_head_fwd`` and ``loss_head_bwd`` (dh, dW)
     bitwise the other tree's kernels at both shapes, the M3 dW at path
     4d's, ``fused_input`` (y; y and g') and
     ``fused_input_int8`` at both input-layer shapes, and ``fused_layer``
     (y; y and g'), ``fused_layer_int8``, ``block_diag_fwd`` (y and dh)
     and ``block_diag_dw`` at both depth-3 mid layers, with the parent's
     device times of rows 4, 5, 11, 12, 13 and 15 (``parent_*device_ms``);
     the rows of ``infer_head``, ``infer_head_int8``, ``loss_head_fwd``
     and ``loss_head_bwd`` at the depth-3 head path 4e's CSR product as
     their library call (``depth3_library_*``: the logits only, on the
     dequantized weight for int8; dh only for ``loss_head_bwd``), held to
     the plain version and timed by events and ``torch.profiler``; the f32
     flash attention at qwen3-1.7b's, h2o-danube-3-4b's
     (``danube_f32_*``) and nemotron-4-340b's (``nemotron_f32_*``; the
     bf16 run ``nemotron_bf16_*`` too) shapes its device time, two
     launches bitwise equal and
     (``--parent``) the parent kernel's device time and the max
     |difference| of the two trees' outputs (``*parent_*``); the three
     ``m3_matmul`` rows also at path 4f's block-1 head (B 32, H 505,000,
     P 10,000, O 2, the scalar instances) on its trained hidden layer:
     against the plain version, two launches bitwise equal, the kernel,
     plain version and CSR library call timed, device times, the byte
     bound and the instance (``block1_*``; ``block1_launches`` the grid
     cell's parallel arm);
  9. one JSON line ``{"kernels": [...]}`` (one row per ported TPU kernel,
     nineteen; rows 18-19's ``launches`` are path 4l's, phase 6's
     ``api_launches``, path 4m's training runs' ``lm_train_launches``
     (the grouped GEMM's 0; its serving after 4m's training
     ``lm_train_serve_launches``), ``lm_serve`` holds their calls at the
     served models' shapes and row 18's ``lm_train`` its call at the
     training shape; the int8 rows' library call is the f32 row's on the
     dequantized weight, the dequantization not timed; ``seg_act``/
     ``seg_act_bwd`` have none, and say why, and carry their bf16
     instances at the depth-3 population's unfused shapes as ``bf16_*``
     (``bf16_launches`` from ``ops.seg_act`` on bf16 h, forward and
     backward, counted alone; each against its plain version, timed, the
     bound at bf16 bytes, summed over the three layers); the two rows of
     phase 6 carry
     their bf16 runs as ``bf16_*`` fields (flash also danube's f32 and
     bf16 runs as ``danube_f32_*``, ``danube_bf16_*``), each run's design
     as ``*path``
     and the tensor-core kernels' ptxas report as ``ptxas``), then the
     card's line
     ``{"ok": true, "device": {...}}`` last.
"""
import gc
import json
import math
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager, nullcontext
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RTOL, ATOL = 1e-4, 1e-5
# NVIDIA H100 SXM data sheet: HBM3 bandwidth and f32 (non-tensor-core) peak
MEM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BATCH = 32
PROFILE_PAD_S = 0.1   # idle host time at each end of a profiler window
SENTINEL = "spin_kernel"   # torch.cuda._sleep's kernel, a window's first
SENTINELS = 16
CHUNK_SPAN = "train_chunk"   # the trainer's record_function around a chunk
DEPTH3 = dict(depths="64,32,16;13,5;7", acts="paper", features=100,
              repeats=1000)
SERVE_KERNELS = ("fused_input", "fused_layer", "infer_head")
INT8_KERNELS = ("fused_input_int8", "fused_layer_int8", "infer_head_int8")
UNFUSED = ["--bd-impl", "pallas", "--act-impl", "pallas"]
UNFUSED_KERNELS = ("block_diag_fwd", "block_diag_dw", "seg_act",
                   "seg_act_bwd")
M3_KERNELS = ("m3_matmul_fwd", "m3_matmul_dh", "m3_matmul_dw")
# path 4f: one cell of the paper's Tables 1-2 (paper_tables --full --block
# 1: 10,000 members, 505,000 fused units), batch BATCH; the two arms' state
# held member by member at tests/test_independence.py's tolerance
PAPER = dict(samples=1000, features=100, models=10_000, repeats=10,
             block=1, epochs=10, seq_sample=25)
INDEPENDENCE_TOL = (2e-4, 2e-5)
# path 4g: the successive-halving ladder at full width and the depth-3
# population's three lifecycle runs, 24 steps each
LIFECYCLE_STEPS = 24
LADDER10K = ["--arch", "parallelmlp-10k", "--halving", "8:0.5,16:0.5",
             "--rung-eval-batches", "4"]
ARCH_SPACE = "widths=64,32,16|13,5|7|32,16;acts=relu,tanh,gelu"
SERVE_REQUESTS = 256
# the JAX package's kernel API at three model configurations' widths (the
# shapes of src/repro_torch/configs/, copied from src/repro/configs/):
# qwen3_1_7b.py attention at the train_4k shape; h2o_danube_3_4b.py's
# sliding-window attention (d_head 3840 / 32 = 120); deepseek_moe_16b.py's
# routed experts over the capacity buffer nn/ffn.py::moe_apply_dense builds
# for 4096 tokens (top-6 of 64, factor 1.25: 480 rows an expert, rounded up
# to 512 so that every run is block_t = 128-aligned)
QWEN3 = dict(b=2, s=4096, h=16, hkv=8, dh=128, window=0)
DANUBE = dict(b=1, s=8192, h=32, hkv=8, dh=120, window=4096)
# nemotron_4_340b.py's attention at path 4l's prefill (4 × 512 tokens):
# d_head 192, the kernel's widest instance (DP 192)
NEMOTRON = dict(b=4, s=512, h=96, hkv=8, dh=192, window=0)
MOE = dict(experts=64, d=2048, f=1408, top_k=6, tokens=4096, capacity=512,
           block_t=128)
LM_KERNELS = ("flash_attention", "moe_gemm")
# the dense bf16 tensor-core peak (NVIDIA H100 SXM data sheet)
BF16_FLOP_PER_S = 989e12
# bf16 attention against its dense plain version, per output element: the
# kernel rounds each p to bf16 (unit roundoff 2^-8) before the PV product,
# which moves an output by at most 2^-8 · Σ_j p_j |v_j| / l, the attention
# of |v| (``_flash_bf16_tol``); each side rounds o to bf16 once (2^-8
# relative each: rtol 1e-2).  A constant atol would be the size of the
# outputs themselves at S 4096, where |o| is about 0.03.
FLASH_BF16_RTOL = 1e-2
# the grouped GEMM in bf16 at 1e-2: both round the same f32 sums to bf16
# once, and a sum order apart a value may land on the neighbouring bf16
MOE_BF16_TOL = (1e-2, 1e-2)
# the grouped GEMM in f32: each output is a sum of 1408 or 2048 products
# of order 1/sqrt(D), ~20× the terms of the population kernels' sums, and
# two summation orders differ by up to ~1e-5 absolute on N(0, 1) outputs
MOE_F32_TOL = (RTOL, 1e-4)
# every ported TPU kernel: its row name → the Pallas function it replaces
REPLACES = {
    "fused_input": "src/repro/kernels/fused_input.py:83",
    "fused_input_int8": "src/repro/kernels/fused_input.py:161",
    "fused_input_bwd": "src/repro/kernels/fused_input.py:242",
    "fused_layer": "src/repro/kernels/fused_layer.py:98",
    "fused_layer_int8": "src/repro/kernels/fused_layer.py:183",
    "fused_layer_dx_dw": "src/repro/kernels/fused_layer.py:287",
    "infer_head": "src/repro/kernels/infer_head.py:75",
    "infer_head_int8": "src/repro/kernels/infer_head.py:150",
    "loss_head_fwd": "src/repro/kernels/loss_head.py:101",
    "loss_head_bwd": "src/repro/kernels/loss_head.py:175",
    "block_diag_fwd": "src/repro/kernels/block_diag.py:82",
    "block_diag_dw": "src/repro/kernels/block_diag.py:138",
    "m3_matmul_fwd": "src/repro/kernels/m3_matmul.py:53",
    "m3_matmul_dh": "src/repro/kernels/m3_matmul.py:92",
    "m3_matmul_dw": "src/repro/kernels/m3_matmul.py:138",
    "seg_act": "src/repro/kernels/seg_act.py:27",
    "seg_act_bwd": "src/repro/kernels/seg_act.py:65",
    "flash_attention": "src/repro/kernels/flash_attn.py:86",
    "moe_gemm": "src/repro/kernels/moe_gemm.py:42",
}
SOURCES = {"flash_attention": "flash_attn",
           "loss_head_fwd": "loss_head", "loss_head_bwd": "loss_head",
           "fused_input_int8": "fused_input",
           "fused_layer_int8": "fused_layer",
           "infer_head_int8": "infer_head",
           "block_diag_fwd": "block_diag", "block_diag_dw": "block_diag",
           "seg_act_bwd": "seg_act", "m3_matmul_fwd": "m3_matmul",
           "m3_matmul_dh": "m3_matmul", "m3_matmul_dw": "m3_matmul"}


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


@contextmanager
def _profiled():
    """``torch.profiler`` (CPU and CUDA activity) over the body, the window
    opened and closed with ``PROFILE_PAD_S`` of idle host time.  The
    profiler keeps only the device activity whose timestamps, moved onto
    the host's clock, fall inside its window, and the two clocks disagree
    by a varying amount (at times a kernel "starts" 0.1 ms or more before
    its launch call: ``lag`` in ``_device_ms``): without the pad a window
    loses the launches of its first stretch, and a short one all of them.
    In a process that has run paths 4g's or 4i's runs the profiler also
    loses the first kernels launched in a window, whatever the pad (on an
    H100 with torch 2.11: the first launch call of 26 windows of 20 or 50
    launches, and of windows with a 1 s pad, had no device record; once
    the first two): each window launches ``SENTINELS`` kernels named ``SENTINEL``
    first, which take that loss; no count or time here includes them.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        for _ in range(SENTINELS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        yield prof
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)


def _missing_launches(prof, kernel: str) -> str:
    """Where a window's launch calls of kernels named ``kernel`` that
    lack device activity stand among those calls, how many such kernels
    the profiler's raw records hold, and the first device start against
    the first call (a clock shift would lose the first launches, an
    unflushed buffer the last)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    raw = prof.profiler.kineto_results.events()
    dev = {e.correlation_id(): e for e in raw if e.device_type() == cuda}
    calls = sorted((e for e in raw if e.device_type() != cuda
                    and "LaunchKernel" in e.name()),
                   key=lambda e: e.start_ns())
    ours = [e for e in calls if e.correlation_id() not in dev
            or kernel in dev[e.correlation_id()].name()]
    lost = [i for i, e in enumerate(ours) if e.correlation_id() not in dev]
    n_raw = sum(1 for e in dev.values() if kernel in e.name())
    first = (min((e.start_ns() for e in dev.values()), default=0)
             - (ours[0].start_ns() if ours else 0))
    return (f"launch calls without device activity at {lost} of "
            f"{len(ours)}; {n_raw} such kernels in the raw records; first "
            f"device start - first call {first / 1e3!r} us")


@contextmanager
def _counted_window(name: str):
    """``_profiled`` over the body, held to the port's kernel counters:
    the profiler must see, by the names in ``KERNEL_SYMBOLS``, as many
    launches as the counters counted in the window; the two counts are
    printed."""
    import torch

    from repro_torch.launch.launch_count import kernel_launches
    n0 = sum(kernel_launches().values())
    with _profiled() as prof:
        yield prof
    counted = sum(kernel_launches().values()) - n0
    cuda = torch.autograd.DeviceType.CUDA
    seen = sum(1 for e in prof.events() if e.device_type == cuda
               and any(k in e.name for k in KERNEL_SYMBOLS))
    print(f"[{name}] profiler window: {seen} of {counted} counted launches "
          "seen", flush=True)
    _require(seen == counted, f"{name}: the profiler saw {seen} of the "
             f"{counted} launches counted in its window; "
             + _missing_launches(prof, ""))


def _device_ms(fn, kernel: str, iters: int = 20) -> float:
    """Mean device time of one launch of the kernel named ``kernel`` over
    ``iters`` calls of ``fn``, after warm-up, from ``torch.profiler`` (at a
    small shape the CUDA-event time of back-to-back calls is the host's
    time to launch); the profiler must see every launch.  ``kernel`` ""
    takes all that one call runs on the card (a library call may launch
    several kernels, fills and copies).  Also printed: the least time from
    a launch's host call to its kernel's start on the device (``lag``),
    below 0 where the profiler's device and host clocks disagree."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with _profiled() as prof:
        for _ in range(iters):
            fn()
    cuda = torch.autograd.DeviceType.CUDA
    evts = [e for e in prof.events() if e.device_type == cuda
            and kernel in e.name and SENTINEL not in e.name]
    raw = prof.profiler.kineto_results.events()
    called = {e.correlation_id(): e.start_ns() for e in raw
              if e.device_type() != cuda and "LaunchKernel" in e.name()}
    lags = [e.start_ns() - called[e.correlation_id()] for e in raw
            if e.device_type() == cuda and kernel in e.name()
            and e.correlation_id() in called]
    print(f"[{kernel}] profiler window: {len(evts)} of {iters} launches "
          f"seen; lag from launch call to kernel start "
          f"{min(lags, default=float('nan')) / 1e3!r} us (least)",
          flush=True)
    _require(len(evts) == iters or (not kernel and len(evts) > iters),
             f"the profiler saw {len(evts)} {kernel} launches in {iters} "
             "calls; " + _missing_launches(prof, kernel))
    return sum(e.device_time_total for e in evts) / iters / 1e3


def _bound_ms(n_bytes: int, flops: int,
              peak: float = F32_FLOP_PER_S) -> tuple[float, str]:
    t_mem = n_bytes / MEM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _close(name, got, want, tol=(RTOL, ATOL)):
    """Max |err| of ``got`` against ``want`` (tensors or trees), raising
    outside ``tol`` = (rtol, atol); bf16 tensors compare in f32.  ``atol``
    may be a tensor, one allowance per element of a single output."""
    import torch

    from repro_torch.core.tree import tree_leaves
    rtol, atol = tol
    err = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        a, b = a.float(), b.to(a.device).float()
        e = (a - b).abs().max().item() if a.numel() else 0.0
        if torch.is_tensor(atol):
            share = ((a - b).abs() / (atol + rtol * b.abs())).max().item()
            print(f"[{name}] max |err| {e!r}, at most {share!r} of its "
                  "per-element tolerance", flush=True)
            _require(share <= 1.0, f"{name}: max |err| {e}, {share} of the "
                     f"per-element tolerance (rtol {rtol})")
        else:
            _require(torch.allclose(a, b, rtol=rtol, atol=atol),
                     f"{name}: max |err| {e} (rtol {rtol}, atol {atol})")
        err = max(err, e)
    return err


# --------------------------------------------------------------------- #
# the serving path                                                      #
# --------------------------------------------------------------------- #

def serve_checkpoint(name: str, ckpt: Path, budget, flags=()):
    """Serve a checkpoint through the serving driver with extra ``flags``;
    check its launch budget (None: the unfused route has none) and that
    every mode answered."""
    import torch

    from repro_torch.launch import serve_population
    t0 = time.perf_counter()
    out = serve_population.main(
        ["--ckpt-dir", str(ckpt), "--requests", str(SERVE_REQUESTS),
         "--batch", str(BATCH), *flags])
    torch.cuda.synchronize()
    print(f"[{name}] served in {time.perf_counter() - t0:.1f} s", flush=True)
    want = None if budget is None else {"launches": budget, "budget": budget}
    _require(out["budget"] == want,
             f"{name}: launch budget {out['budget']}, expected {budget}")
    for mode, row in out["serve"].items():
        _require(row["requests"] == SERVE_REQUESTS and row["req_per_s"] > 0,
                 f"{name}/{mode}: {row}")
    return out


def serve(name: str, lp, seed: int, workdir: Path, budget: int):
    """Init ``lp`` on the card, checkpoint it, and serve the checkpoint.
    Returns (checkpoint dir, driver result); the parameters are not kept
    on the card."""
    import torch

    from repro_torch.checkpoint.checkpoint import save_population
    from repro_torch.core.deep import init_params
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(gen, lp)
    ckpt = workdir / name
    t0 = time.perf_counter()
    save_population(str(ckpt), 0, params, lp)
    print(f"[{name}] {lp.describe()}; checkpoint written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del params
    return ckpt, serve_checkpoint(name, ckpt, budget)


def serve_int8(name: str, ckpt: Path, budget: int, f32_out: dict):
    """Serve ``ckpt``'s int8 copy through the serving driver, counted
    alone: int8 kernels only, no f32 kernel.  Prints each mode's req/s and
    p50/p99 beside the f32 serve's.  Returns (driver result, the run's
    kernel launches)."""
    import torch

    from repro_torch.launch.launch_count import (kernel_launches,
                                                 reset_kernel_launches)
    reset_kernel_launches()
    out = serve_checkpoint(f"{name} int8", ckpt, budget,
                           ["--weights-dtype", "int8"])
    torch.cuda.synchronize()
    n = kernel_launches()
    other = {k: v for k, v in n.items() if k not in INT8_KERNELS and v}
    _require(not other, f"{name} int8: non-int8 kernels launched {other}")
    _print_beside(name, ("f32", "int8"), f32_out, out)
    return out, n


def _print_beside(name: str, labels, ref_out: dict, out: dict):
    """Each mode's req/s and p50/p99 of two serves of one checkpoint."""
    for mode, row in out["serve"].items():
        ref = ref_out["serve"][mode]
        print(f"[{name}] {mode:5s} {labels[0]} {ref['req_per_s']:.0f} req/s "
              f"p50 {ref['p50_ms']:.2f} p99 {ref['p99_ms']:.2f} ms | "
              f"{labels[1]} {row['req_per_s']:.0f} req/s p50 "
              f"{row['p50_ms']:.2f} p99 {row['p99_ms']:.2f} ms", flush=True)


def serve_unfused(name: str, ckpt: Path, lp, fused_out: dict):
    """Serve ``ckpt`` on the unfused route through the serving driver,
    counted alone: every forward (one calibration slab, then per mode a
    warm-up and one per flush) exactly ``unfused_infer_launches``, no other
    kernel.  Prints each mode's req/s and p50/p99 beside the fused serve's.
    Returns (driver result, the run's kernel launches)."""
    import torch

    from repro_torch.core.selection import EVAL_SLAB
    from repro_torch.launch.launch_count import (kernel_launches,
                                                 reset_kernel_launches,
                                                 unfused_infer_launches)
    reset_kernel_launches()
    out = serve_checkpoint(f"{name} unfused", ckpt, None, UNFUSED)
    torch.cuda.synchronize()
    n = kernel_launches()
    forwards = -(-512 // EVAL_SLAB) + len(out["serve"]) * (
        1 + -(-SERVE_REQUESTS // BATCH))
    want = {k: forwards * v
            for k, v in unfused_infer_launches(lp.depth).items()}
    _require({k: v for k, v in n.items() if v} == want,
             f"{name} unfused: launches {n}, expected {want} ({forwards} "
             "forwards)")
    _print_beside(name, ("fused", "unfused"), fused_out, out)
    return out, n


def check_unfused_forward(name: str, ckpt: Path, x) -> float:
    """One unfused forward of ``ckpt``'s parameters: exactly
    ``unfused_infer_launches``; its logits and the ``all`` ensemble's
    probabilities against the fused route's."""
    import torch

    from repro_torch.checkpoint.checkpoint import restore_population
    from repro_torch.core.deep import forward
    from repro_torch.core.ensemble import ensemble_predict
    from repro_torch.launch.launch_count import (kernel_launches,
                                                 reset_kernel_launches,
                                                 unfused_infer_launches)
    params, lp, _ = restore_population(str(ckpt), device="cuda")
    with torch.inference_mode():
        reset_kernel_launches()
        got = forward(params, x, lp, bd_impl="pallas", act_impl="pallas",
                      infer=True)
        torch.cuda.synchronize()
        n = {k: v for k, v in kernel_launches().items() if v}
        want = forward(params, x, lp, bd_impl="fused", infer=True)
        probs = [ensemble_predict(y, lp, "all")["probs"] for y in (got, want)]
    per = unfused_infer_launches(lp.depth)
    _require(n == per, f"{name}: an unfused forward launched {n}, expected "
             f"{per}")
    _require(tuple(got.shape) == (x.shape[0], lp.num_members,
                                  lp.out_features)
             and bool(torch.isfinite(got).all()),
             f"{name}: unfused logits {tuple(got.shape)} not finite")
    err = max(_close(f"{name}: unfused vs fused logits", got, want),
              _close(f"{name}: unfused vs fused ensemble", *probs))
    print(f"[{name}] unfused forward: launches {n}; vs the fused route "
          f"max|err| {err!r}", flush=True)
    return err


def check_int8(name: str, ckpt: Path, x) -> dict:
    """The int8 copy as ``PopulationServer(weights_dtype="int8")`` holds
    it: device memory allocated once it alone is on the card (besides
    what the caller holds, printed as the baseline), byte-equal to the copy
    quantized on the CPU from the same masters, its size against the f32
    tree's, and its forward against the f32 kernels on its dequantized
    tree."""
    import torch

    from repro_torch.checkpoint.checkpoint import restore_population
    from repro_torch.core.deep import forward
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.serve_population import PopulationServer
    from repro_torch.quant import (dequantize_population,
                                   quantize_population, serve_copy_bytes)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    server, _ = PopulationServer.from_checkpoint(
        str(ckpt), device="cuda", weights_dtype="int8", batch=BATCH)
    server.check_budget()                # the first consumer: quantizes
    torch.cuda.synchronize()
    alloc = torch.cuda.memory_allocated()
    q, lp = server.params, server.layout
    masters, _, _ = restore_population(str(ckpt), device="cpu")
    q_cpu = quantize_population(masters, lp)
    _require(all(a.dtype == b.dtype and torch.equal(a.cpu(), b)
                 for a, b in zip(tree_leaves(q), tree_leaves(q_cpu))),
             f"{name}: the int8 copy quantized on the card differs from the "
             "CPU's")
    n8, n32 = serve_copy_bytes(q), serve_copy_bytes(masters)
    with torch.inference_mode():
        got = forward(q, x, lp, bd_impl="fused", infer=True,
                      weights_dtype="int8")
        want = forward(dequantize_population(q, lp), x, lp, bd_impl="fused",
                       infer=True)
    want_shape = (x.shape[0], lp.num_members, lp.out_features)
    _require(tuple(got.shape) == want_shape
             and bool(torch.isfinite(got).all()),
             f"{name}: int8 logits {tuple(got.shape)} not finite "
             f"{want_shape}")
    err = _close(f"{name}: int8 forward vs f32 kernels on the dequantized "
                 "tree", got, want)
    out = {"memory_allocated": alloc, "baseline_allocated": base,
           "serve_copy_bytes": n8, "f32_bytes": n32,
           "max_abs_err_vs_dequant": err}
    print(f"[{name}] int8 copy: memory_allocated {alloc} B ({base} B "
          f"before the server); serve copy {n8} B vs f32 {n32} B "
          f"({n32 / n8:.2f}x); byte-equal to the CPU's; forward vs f32 "
          f"kernels on the dequantized tree max|err| {err!r}", flush=True)
    return out


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
    err = _close(f"{name}: fused forward vs plain route", got, plain)
    with torch.inference_mode():
        ref = forward(_to(params, "cpu"), x[:4].cpu(), lp, bd_impl="einsum",
                      head_impl="xla", infer=True)
    e_cpu = _close(f"{name}: card vs CPU", got[:4], ref)
    print(f"[{name}] served forward vs plain route: max|err| {err!r} on the "
          f"card, {e_cpu!r} against the CPU", flush=True)


# --------------------------------------------------------------------- #
# the training path                                                     #
# --------------------------------------------------------------------- #

def m3_only(n: dict) -> dict:
    return {k: n[k] for k in M3_KERNELS}


def _add_counts(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in a}


def train(name: str, workdir: Path, flags: list, unfused: bool = False,
          m3: bool = False):
    """Train through ``repro_torch.launch.train.main`` (seed 0; the fused
    route, or with ``unfused`` the unfused one, with ``m3`` its head on the
    M3 kernels too), the kernel counters set to 0 just before the run and
    read just after it; then check the per-member losses stay finite and
    that the mean held-out loss fell below the same seed's initial
    parameters'.  Returns (params, layout, stats, checkpoint dir, the
    run's kernel launches)."""
    import torch

    from repro_torch.core.deep import init_params
    from repro_torch.core.selection import EVAL_SLAB, evaluate_population
    from repro_torch.data.synthetic import TabularTask
    from repro_torch.launch import train as train_driver
    from repro_torch.launch.launch_count import (kernel_launches,
                                                 reset_kernel_launches)
    ckpt = workdir / f"train-{name}"
    reset_kernel_launches()
    t0 = time.perf_counter()
    params, lp, stats = train_driver.main(
        ["--bd-impl", "fused", "--batch", str(BATCH), "--steps", "16",
         "--scan-steps", "8", "--ckpt-dir", str(ckpt), "--ckpt-every", "8",
         "--seed", "0", *flags, *(UNFUSED if unfused else []),
         *(["--m3-impl", "pallas"] if m3 else [])])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    _require(stats["steps"] == 16 and stats["restarts"] == 0,
             f"{name}: {stats}")
    (_, _), (xte, yte) = TabularTask(2048, lp.in_features,
                                     n_classes=lp.out_features,
                                     seed=0).split()
    # one backward launch of each kind per step (the forwards also serve
    # the run's closing leaderboard, so they count more)
    if unfused:
        want = {"seg_act_bwd": 16 * lp.depth,
                "block_diag_dw": 16 * (lp.depth - 1)}
        allowed = UNFUSED_KERNELS + (M3_KERNELS if m3 else ())
        other = {k: v for k, v in launches.items()
                 if v and k not in allowed}
        _require(not other, f"{name}: other kernels launched {other}")
        if m3:   # 16 steps, then the leaderboard's forwards on the head
            want.update(m3_matmul_fwd=16 + -(-len(yte) // EVAL_SLAB),
                        m3_matmul_dh=16, m3_matmul_dw=16)
    else:
        want = {"fused_input_bwd": 16, "loss_head_fwd": 16,
                "loss_head_bwd": 16,
                "fused_layer_dx_dw": 16 * (lp.depth - 1)}
    _require({k: launches[k] for k in want} == want,
             f"{name}: training launches {launches}, expected {want}")
    init = init_params(torch.Generator(device="cuda").manual_seed(0), lp)
    before, after = (evaluate_population(p, lp, xte, yte, bd_impl="fused",
                                         infer=True)[0]
                     for p in (init, params))
    _require(bool(torch.isfinite(after).all())
             and after.mean().item() < before.mean().item(),
             f"{name}: held-out mean member loss {before.mean().item()} -> "
             f"{after.mean().item()}")
    stats["heldout_loss"] = [before.mean().item(), after.mean().item()]
    print(f"[{name}] trained in {wall:.1f} s (train loop "
          f"{stats['seconds']:.2f} s): {stats}; kernel launches {launches}",
          flush=True)
    return params, lp, stats, ckpt, launches


def _step_parts(params, x, y, lp, opt, **route):
    """One optimizer step, its parts kept: (per, grads, new params)."""
    import torch

    from repro_torch.core.deep import loss_and_grads
    from repro_torch.optim.optimizers import apply_updates
    _, per, grads = loss_and_grads(params, x, y, lp, **route)
    lr = torch.tensor(1e-2, device=x.device)
    upd, _ = opt.update(grads, opt.init(params), params, lr)
    return per, grads, apply_updates(params, upd)


def check_train_step(name, params, lp, x, y):
    """A step's launch budget, its parity with the plain route on the card
    and with the CPU, and its bitwise reproducibility."""
    import torch

    from repro_torch.core.deep import opt_step
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.launch_count import (fused_step_budget,
                                                 kernel_launches,
                                                 reset_kernel_launches)
    from repro_torch.optim.optimizers import adamw, sgd
    opt = sgd()
    reset_kernel_launches()
    opt_step(params, opt.init(params), x, y, 1e-2, opt, lp, bd_impl="fused")
    torch.cuda.synchronize()
    got = sum(kernel_launches().values())
    want = fused_step_budget(lp.depth)["total"]
    _require(got == want, f"{name}: a train step made {got} launches, the "
             f"budget is 2·(depth+1) = {want}")

    fused = _step_parts(params, x, y, lp, opt, bd_impl="fused")
    plain = _step_parts(params, x, y, lp, opt, bd_impl="einsum",
                        loss_impl="xla")
    errs = [_close(f"{name} step vs plain route: {what}", a, b)
            for what, a, b in zip(("losses", "grads", "params"), fused,
                                  plain)]
    cpu = _step_parts(_to(params, "cpu"), x.cpu(), y.cpu(), lp, opt,
                      bd_impl="fused")
    errs_cpu = [_close(f"{name} step vs CPU: {what}", a, b)
                for what, a, b in zip(("losses", "grads", "params"), fused,
                                      cpu)]

    clip = adamw(weight_decay=0.01)
    runs = [opt_step(params, clip.init(params), x, y, 1e-2, clip, lp,
                     bd_impl="fused", grad_clip=1.0) for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves((runs[0][0], runs[0][1], runs[0][3])),
        tree_leaves((runs[1][0], runs[1][1], runs[1][3]))))
    _require(same, f"{name}: two fused steps from one state differ")
    print(f"[{name}] train step: {got} launches (2·(depth+1)); max|err| "
          f"losses/grads/params {errs!r} vs the plain route on the card, "
          f"{errs_cpu!r} vs the CPU; two steps bitwise equal", flush=True)


def check_unfused_step(name, params, lp, x, y):
    """One unfused step's launches, kernel by kernel, and its parity with
    the fused step from the same state."""
    import torch

    from repro_torch.core.deep import opt_step
    from repro_torch.launch.launch_count import (kernel_launches,
                                                 reset_kernel_launches,
                                                 unfused_step_launches)
    from repro_torch.optim.optimizers import sgd
    opt = sgd()
    reset_kernel_launches()
    opt_step(params, opt.init(params), x, y, 1e-2, opt, lp,
             bd_impl="pallas", act_impl="pallas")
    torch.cuda.synchronize()
    got = {k: v for k, v in kernel_launches().items() if v}
    want = unfused_step_launches(lp.depth)
    _require(got == want, f"{name}: an unfused step launched {got}, "
             f"expected {want}")
    unfused = _step_parts(params, x, y, lp, opt, bd_impl="pallas",
                          act_impl="pallas")
    fused = _step_parts(params, x, y, lp, opt, bd_impl="fused")
    errs = [_close(f"{name} unfused step vs fused: {what}", a, b)
            for what, a, b in zip(("losses", "grads", "params"), unfused,
                                  fused)]
    print(f"[{name}] unfused train step: launches {got}; max|err| "
          f"losses/grads/params {errs!r} vs the fused step", flush=True)


def train_single(name: str, pop, workdir: Path):
    """Path 4d, the paper's single-layer ParallelMLP at full width:
    ``init_params`` on the card from a seeded generator, 16 ``sgd_step``s
    (batch 32, lr 1e-2, ``m3_impl="pallas"``) on the task's training
    split, the kernel counters set to 0 just before the steps and read
    just after them (exactly ``m3_step_launches`` a step, no other
    kernel); then the held-out loss against the same seed's initial
    parameters', ``evaluate_population`` → ``select_best`` →
    ``leaderboard`` on 512 held-out rows and the M3 kernels, the best
    member's standalone forward against its column of the fused logits,
    and a ``"single"`` checkpoint round trip.  Returns (trained params,
    stats, the steps' kernel launches)."""
    import torch

    from repro_torch.checkpoint.checkpoint import (restore_population,
                                                   save_population)
    from repro_torch.core import parallel_mlp as pm
    from repro_torch.core.selection import (evaluate_population,
                                            leaderboard, select_best)
    from repro_torch.data.synthetic import TabularTask
    from repro_torch.launch.launch_count import (kernel_launches,
                                                 m3_step_launches,
                                                 reset_kernel_launches)
    (xtr, ytr), (xte, yte) = TabularTask(4096, pop.in_features,
                                         n_classes=pop.out_features,
                                         seed=0).split()
    xte, yte = xte[:512], yte[:512]
    xs = torch.as_tensor(xtr[:16 * BATCH], device="cuda").view(16, BATCH, -1)
    ys = torch.as_tensor(ytr[:16 * BATCH], device="cuda").view(16, BATCH)
    params = pm.init_params(torch.Generator(device="cuda").manual_seed(0),
                            pop)
    before, _ = evaluate_population(params, pop, xte, yte, m3_impl="pallas")
    torch.cuda.synchronize()
    reset_kernel_launches()
    t0 = time.perf_counter()
    pers = []
    for k in range(16):
        params, _, per = pm.sgd_step(params, xs[k], ys[k], 1e-2, pop,
                                     m3_impl="pallas")
        pers.append(per)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    want = {k: 16 * v for k, v in m3_step_launches().items()}
    _require({k: v for k, v in launches.items() if v} == want,
             f"{name}: 16 steps launched {launches}, expected {want}")
    losses, accs = evaluate_population(params, pop, xte, yte,
                                       m3_impl="pallas")
    _require(bool(torch.isfinite(losses).all())
             and losses.mean().item() < before.mean().item(),
             f"{name}: held-out mean member loss {before.mean().item()} -> "
             f"{losses.mean().item()}")
    m, best = select_best(params, pop, losses)
    rows = leaderboard(pop, losses, accs, k=10)
    _require(rows[0]["member"] == m and len(rows) == 10, f"{name}: {rows}")
    for row in rows:
        print(f"[{name}]  #{row['rank']:2d} member {row['member']:5d} "
              f"hidden={row['hidden']:3d} {row['activation']:11s} "
              f"loss={row['loss']:.4f} acc={row['acc']:.3f}")
    xb = torch.as_tensor(xte[:BATCH], device="cuda")
    with torch.inference_mode():
        fused = pm.forward(params, xb, pop, m3_impl="pallas")
        alone = pm.member_forward(best, xb)
    err_member = _close(f"{name}: best member standalone vs its fused "
                        "logits", alone, fused[:, m])
    ckpt = workdir / name
    save_population(str(ckpt), 15, params, pop)
    back, lay, step = restore_population(str(ckpt), device="cuda")
    _require(step == 15 and lay == pop
             and all(torch.equal(back[k], params[k]) for k in pm.KEYS),
             f"{name}: the single-layer checkpoint did not round-trip")
    stats = {"steps": 16, "steps_wall_s": wall,
             "first_batch_loss": pers[0].mean().item(),
             "last_batch_loss": pers[-1].mean().item(),
             "heldout_loss": [before.mean().item(), losses.mean().item()],
             "best": {"member": m, "hidden": rows[0]["hidden"],
                      "activation": rows[0]["activation"],
                      "loss": rows[0]["loss"], "acc": rows[0]["acc"]},
             "best_member_max_abs_err": err_member}
    print(f"[{name}] {pop.describe()}; 16 sgd steps in {wall:.2f} s; "
          f"launches {launches}; {stats}", flush=True)
    return params, stats, launches


def _single_parts(params, x, y, pop, m3_impl):
    """One single-layer SGD step, its parts kept: (per, grads, new)."""
    from repro_torch.core import parallel_mlp as pm
    _, per, grads = pm.loss_and_grads(params, x, y, pop, m3_impl=m3_impl)
    new, _, _ = pm.sgd_step(params, x, y, 1e-2, pop, m3_impl=m3_impl)
    return per, grads, new


def check_single_step(name, params, pop, x, y):
    """Path 4d's step: its launches, its parity with the bucketed M3 on the
    card and on the CPU, and its bitwise reproducibility."""
    import torch

    from repro_torch.core import parallel_mlp as pm
    from repro_torch.launch.launch_count import (kernel_launches,
                                                 m3_step_launches,
                                                 reset_kernel_launches)
    reset_kernel_launches()
    pm.sgd_step(params, x, y, 1e-2, pop, m3_impl="pallas")
    torch.cuda.synchronize()
    got = {k: v for k, v in kernel_launches().items() if v}
    _require(got == m3_step_launches(), f"{name}: a step launched {got}")
    kernel = _single_parts(params, x, y, pop, "pallas")
    errs = [_close(f"{name} step vs bucketed on the card: {what}", a, b)
            for what, a, b in zip(("losses", "grads", "params"), kernel,
                                  _single_parts(params, x, y, pop,
                                                "bucketed"))]
    cpu = _single_parts(_to(params, "cpu"), x.cpu(), y.cpu(), pop,
                        "bucketed")
    errs_cpu = [_close(f"{name} step vs bucketed on the CPU: {what}", a, b)
                for what, a, b in zip(("losses", "grads", "params"), kernel,
                                      cpu)]
    runs = [pm.sgd_step(params, x, y, 1e-2, pop, m3_impl="pallas")
            for _ in range(2)]
    same = all(torch.equal(runs[0][0][k], runs[1][0][k]) for k in pm.KEYS) \
        and torch.equal(runs[0][2], runs[1][2])
    _require(same, f"{name}: two steps from one state differ")
    print(f"[{name}] step: launches {got}; max|err| losses/grads/params "
          f"{errs!r} vs bucketed on the card, {errs_cpu!r} vs bucketed on "
          "the CPU; two steps bitwise equal", flush=True)


# names of the port's kernels in a profiler trace
KERNEL_SYMBOLS = ("fused_input_i8_bf16_kernel",
                  "fused_layer_i8_bf16_group_kernel",
                  "infer_head_i8_bf16_kernel", "infer_head_i8_kernel",
                  "block_diag_bf16_group_kernel",
                  "block_diag_dw_bf16_member_kernel",
                  "m3_fwd_bf16_stream_kernel", "m3_dh_bf16_kernel",
                  "m3_dw_bf16_stream_kernel",
                  "fused_input_bwd_bf16_kernel",
                  "fused_layer_dx_dw_bf16_kernel",
                  "fused_layer_bf16_group_kernel", "infer_head_bf16_kernel",
                  "loss_head_fwd_bf16_kernel", "loss_head_bwd_bf16_kernel",
                  "fused_input_bwd_kernel", "fused_input_kernel",
                  "fused_layer_dx_dw_kernel", "fused_layer_group_kernel",
                  "fused_layer_i8_group_kernel",
                  "infer_head_kernel", "loss_head_fwd_kernel",
                  "loss_head_bwd_kernel", "block_diag_group_kernel",
                  "block_diag_dw_member_kernel", "seg_act_fwd_kernel",
                  "seg_act_bwd_kernel", "seg_act_bf16_fwd_kernel",
                  "seg_act_bf16_bwd_kernel", "m3_fwd_stream_kernel",
                  "m3_dh_kernel", "m3_dw_stream_kernel")


def time_train_step(name, params, lp, x, y, adam: bool,
                    unfused: bool = False, m3: bool = False,
                    iters: int = 20, opt=None):
    """Steady-state train step (the fused route, or with ``unfused`` the
    unfused one, with ``m3`` its head on the M3 kernels too) under sgd, or
    with ``adam`` AdamW clipped at 1.0 (``opt``: another optimizer in its
    place, clipped the same way): see ``time_step``."""
    from repro_torch.core.deep import opt_step
    from repro_torch.optim.optimizers import adamw, sgd
    if opt is None:
        opt = adamw(weight_decay=0.01) if adam else sgd()
    state = opt.init(params)
    route = (dict(bd_impl="pallas", act_impl="pallas") if unfused
             else dict(bd_impl="fused"))
    if m3:
        route["m3_impl"] = "pallas"
    kw = dict(route, grad_clip=1.0 if adam else None)
    return time_step(name, lambda: opt_step(params, state, x, y, 1e-2, opt,
                                            lp, **kw), iters)


def time_step(name, step, iters: int = 20):
    """A steady-state step ``step()``: host wall per synchronised step, and
    the device time by kernel over 3 profiled steps (``torch.profiler``),
    from which the device's idle share of the step."""
    import torch

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / iters * 1e3
    with _counted_window(name) as prof:
        for _ in range(3):
            step()
    by_name, n_kernels = {}, 0
    for evt in prof.events():
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or SENTINEL in evt.name):
            continue
        sym = next((k for k in KERNEL_SYMBOLS if k in evt.name),
                   "other: " + evt.name[:60])
        by_name[sym] = by_name.get(sym, 0.0) + evt.device_time_total / 3e3
        n_kernels += 1
    busy = sum(by_name.values())
    out = {"step_wall_ms": wall_ms, "device_ms": busy if by_name else None,
           "device_idle_share": 1 - busy / wall_ms if by_name else None,
           "device_launches": n_kernels / 3,
           "device_ms_by_kernel": dict(sorted(by_name.items(),
                                              key=lambda kv: -kv[1])[:12])}
    print(f"[{name}] train step: {wall_ms:.3f} ms wall; device "
          f"{out['device_ms']} ms in {out['device_launches']} launches; "
          f"idle share {out['device_idle_share']}", flush=True)
    return out


# --------------------------------------------------------------------- #
# the paper's tables (path 4f)                                          #
# --------------------------------------------------------------------- #

def paper_pop():
    """The paper's exact layout, ``paper_tables --full --block 1``: hidden
    1..100 × the ten activations × 10 repeats at F = 100, block 1 —
    10,000 members, 505,000 fused hidden units."""
    from repro_torch.core.activations import PAPER_TEN
    from repro_torch.core.population import Population
    pop = Population.grid(PAPER["features"], 2, range(1, 101), PAPER_TEN,
                          repeats=PAPER["repeats"], block=PAPER["block"])
    _require((pop.num_members, pop.total_hidden) == (10_000, 505_000),
             f"the paper's layout is {pop.describe()}")
    return pop


def _counted(fn):
    """``fn()`` with every kernel counter set to 0 just before it and read
    just after it → (its value, {kernel: launches} of the kernels it
    launched)."""
    import torch

    from repro_torch.launch.launch_count import (kernel_launches,
                                                 reset_kernel_launches)
    torch.cuda.synchronize()
    reset_kernel_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in kernel_launches().items() if v}


def paper_cell(name: str):
    """Path 4f (i): one cell of the paper's grid through
    ``paper_tables.run`` (samples 1,000, features 100, batch 32, the
    ``--full`` population at block 1, 10 epochs, seq-sample 25,
    ``m3_impl="pallas"``), the counters zeroed before each arm and read
    after it: every parallel step, the warm-up too, exactly one launch of
    each M3 kernel and no other; the sequential arm none.  Returns (the CSV
    row as a dict with each arm's per-step time, {arm: launches})."""
    from repro_torch.launch import paper_tables as pt
    from repro_torch.launch.launch_count import m3_step_launches
    counts = {}

    def around(arm, fn):
        out, counts[arm] = _counted(fn)
        return out
    p = PAPER
    rows = pt.run([p["samples"]], [p["features"]], [BATCH], p["models"],
                  p["repeats"], p["epochs"], p["seq_sample"], p["block"],
                  m3_impl="pallas", device="cuda", around_arm=around)
    per_epoch = p["samples"] // BATCH
    steps = per_epoch * p["epochs"]
    want = {k: (steps + 1) * v for k, v in m3_step_launches().items()}
    _require(counts["parallel"] == want, f"{name}: the parallel arm "
             f"launched {counts['parallel']}, expected {want}")
    _require(counts["sequential"] == {}, f"{name}: the sequential arm "
             f"launched {counts['sequential']}")
    row = dict(zip(pt.HEADER.split(","), rows[0]))
    _require(all(v > 0 for v in rows[0][4:6])
             and all(math.isfinite(v) for v in rows[0][4:]),
             f"{name}: {row}")
    row.update(parallel_step_ms=row["parallel_s"] / steps * 1e3,
               sequential_member_step_ms=row["sequential_s"]
               / (row["members"] * steps) * 1e3)
    print(f"[{name}] {row}; launches {counts}", flush=True)
    return row, counts


def paper_independence(name: str):
    """Path 4f (ii), the paper's central property on the card: from one
    seeded state (TF32 off), 8 ``parallel_train`` steps on the M3 kernels,
    and ``sequential_train`` on the same 8 batches for 3 members of the
    grid's stratified sample with different activations and hidden sizes;
    each member's w1, b1, w2, b2 against ``extract_member`` of the parallel
    state within rtol 2e-4 / atol 2e-5 (tests/test_independence.py).
    Returns (the trained state, the layout, a batch (x, y) of the task on
    the card, {member: max |err|}, the parallel steps' launches, the
    members held)."""
    import numpy as np
    import torch

    from repro_torch.core import parallel_mlp as pm
    from repro_torch.data.synthetic import TabularTask
    from repro_torch.launch import paper_tables as pt
    from repro_torch.launch.launch_count import m3_step_launches
    pop = paper_pop()
    task = TabularTask(PAPER["samples"], PAPER["features"], n_classes=2,
                       seed=1)
    start = pm.init_params(torch.Generator(device="cuda").manual_seed(0),
                           pop)
    par, n = _counted(lambda: pt.parallel_train(start, pop, task, BATCH, 8,
                                                0.01, "pallas"))
    want = {k: 8 * v for k, v in m3_step_launches().items()}
    _require(n == want, f"{name}: 8 parallel steps launched {n}")
    picked = []
    for m in np.linspace(0, pop.num_members - 1,
                         PAPER["seq_sample"]).astype(int).tolist():
        if all(pop.activations[m] != pop.activations[q]
               and pop.hidden_sizes[m] != pop.hidden_sizes[q]
               for q in picked):
            picked.append(m)
    picked = picked[:3]
    _require(len(picked) == 3, f"{name}: sample {picked}")
    errs = {}
    for m in picked:
        alone, n = _counted(lambda: pt.sequential_train(
            pt.own_member(start, pop, m), task, BATCH, 8, 0.01))
        _require(n == {}, f"{name}: the sequential arm launched {n}")
        fused = pm.extract_member(par, pop, m)
        errs[m] = _close(f"{name}: member {m} ({pop.activations[m]}, "
                         f"{pop.hidden_sizes[m]} units) alone vs fused",
                         {k: alone[k] for k in pm.KEYS},
                         {k: fused[k] for k in pm.KEYS},
                         tol=INDEPENDENCE_TOL)
    print(f"[{name}] 8 steps: launches {want}; members "
          f"{[(m, pop.activations[m], pop.hidden_sizes[m]) for m in picked]}"
          f" trained alone match the fused state: max |err| {errs}",
          flush=True)
    batch = tuple(torch.as_tensor(a, device="cuda")
                  for a in task.batch(0, BATCH))
    return par, pop, batch, errs, want, picked


def paper_step_times(params, pop, x, y, m: int):
    """Path 4f's two arms a step at a time in the steady state
    (``time_step``): the fused ``sgd_step`` on the M3 kernels, and member
    ``m``'s standalone eager step (``paper_tables.member_step``, the
    sequential arm's), each on batch (x, y) already on the card."""
    from repro_torch.core import parallel_mlp as pm
    from repro_torch.launch import paper_tables as pt
    member = pt.own_member(params, pop, m)
    return {name: time_step(name, step) for name, step in (
        ("paper-tables parallel step",
         partial(pm.sgd_step, params, x, y, 0.01, pop, m3_impl="pallas")),
        (f"paper-tables member {m} step",
         partial(pt.member_step, member, x, y, 0.01)))}


def paper_feature_selection(name: str):
    """Path 4f (iii): ``examples/torch_feature_selection.py`` at its own
    sizes (F 16, N 4096, 64 members of 8 units, block 8, 150 steps) on the
    card with ``--m3-impl pallas``: every masked w1 entry exactly 0.0 after
    every step, one launch of each M3 kernel a step (and the closing
    forward's), and how many of the 3 signal features it recovered."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_feature_selection",
        ROOT / "examples" / "torch_feature_selection.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    res, n = _counted(lambda: example.main(["--device", "cuda",
                                            "--m3-impl", "pallas"]))
    steps = res["steps"]
    want = {"m3_matmul_fwd": steps + 1, "m3_matmul_dh": steps,
            "m3_matmul_dw": steps}
    _require(n == want, f"{name}: launched {n}, expected {want}")
    _require(res["masked_max_abs"] == 0.0,
             f"{name}: a masked w1 entry reached {res['masked_max_abs']}")
    print(f"[{name}] {steps} steps: launches {n}; masked w1 entries 0.0 "
          f"after every step; recovered {res['recovered']}/3 signal "
          f"features (top-3 {res['top3']})", flush=True)
    return res, n


def m3_block1_fields(params, pop, x, launches):
    """Rows 13–15 at path 4f's head, the paper's block-1 layout (B 32, H
    505,000, P 10,000, O 2: the scalar instances) on the hidden layer of
    path 4f's trained state: each kernel against its plain version (rtol
    1e-4 / atol 1e-5), two launches bitwise equal, timed beside the plain
    version and the CSR library call (``_m3_csr_library``), its device
    time, its byte bound and the instance it took, as fields
    ``block1_*`` of the rows ({row: fields})."""
    import torch

    from repro_torch.core.activations import apply_activations_sliced
    from repro_torch.kernels import m3_matmul as m3k
    dev = x.device
    h = apply_activations_sliced(
        torch.addmm(params["b1"], x, params["w1"].t()), pop.act_runs
    ).contiguous()
    w2, o, hh = params["w2"], params["w2"].shape[0], pop.total_hidden
    seg = torch.as_tensor(pop.block_segment_ids, dtype=torch.int32,
                          device=dev)
    ptr = torch.as_tensor(pop.offsets // pop.block, dtype=torch.int32,
                          device=dev)
    dy = torch.randn(BATCH, pop.num_members, o, device=dev,
                     generator=torch.Generator(device="cuda").manual_seed(13))
    csr = _m3_csr_library(h, w2, seg, dy, pop.block)
    dh_out, dw_out = torch.empty_like(h), torch.empty_like(w2)
    # name → (kernel, plain, arguments, outputs, its name in a trace, the
    # tensors it walks by units: kernel_path's)
    cases = {
        "m3_matmul_fwd": (m3k.m3_matmul_fwd_cuda, m3k.m3_matmul_fwd_plain,
                          (h, w2, ptr), (dy,), "m3_fwd_stream_kernel",
                          (h, w2)),
        "m3_matmul_dh": (m3k.m3_matmul_dh_cuda, m3k.m3_matmul_dh_plain,
                         (dy, w2, seg), (dh_out,), "m3_dh_kernel",
                         (w2, dh_out)),
        "m3_matmul_dw": (m3k.m3_matmul_dw_cuda, m3k.m3_matmul_dw_plain,
                         (dy, h, seg), (dw_out,), "m3_dw_stream_kernel",
                         (h, dw_out)),
    }
    out = {}
    for name, (cuda, plain, args, outs, symbol, walked) in cases.items():
        kern = partial(cuda, *args, block=pop.block)
        ref = partial(plain, *args, block=pop.block)
        want = ref()
        err = _close(f"{name} at block 1: kernel vs plain", kern(), want)
        _require(torch.equal(kern(), kern()),
                 f"{name} at block 1: two launches differ")
        call, to_kernel = csr[name]
        lib_err = _close(f"{name} at block 1: CSR library call vs plain",
                         to_kernel(call()), want)
        del want
        bound, by = _bound_ms(_nbytes(*args, *outs), 2 * BATCH * hh * o)
        out[name] = {
            "block1_launches": launches[name], "block1_max_abs_err": err,
            "block1_path": m3k.kernel_path(pop.block, *walked),
            "block1_ms": _time_ms(kern, 20),
            "block1_device_ms": _device_ms(kern, symbol, 20),
            "block1_plain_ms": _time_ms(ref, 5),
            "block1_bound_ms": bound, "block1_bound_by": by,
            "block1_library_ms": _time_ms(call, 20),
            "block1_library_device_ms": _device_ms(call, "", 20),
            "block1_library_max_abs_err": lib_err,
            "block1_library": ("torch.matmul (CSR)" if name != "m3_matmul_dw"
                               else "torch.sparse.sampled_addmm (CSR)")}
        print(f"[{name} at block 1] {out[name]}", flush=True)
    return out


# --------------------------------------------------------------------- #
# the lifecycle and the refill search (path 4g)                         #
# --------------------------------------------------------------------- #

def depth3_flags() -> list:
    """The trainer flags of the depth-3 population (phase 4b)."""
    return ["--arch", "parallelmlp-10k", "--population-depths",
            DEPTH3["depths"], "--population-acts", DEPTH3["acts"],
            "--population-features", str(DEPTH3["features"]),
            "--population-repeats", str(DEPTH3["repeats"]),
            "--optimizer", "adamw", "--grad-clip", "1.0",
            "--lr-schedule", "warmup_cosine"]


def check_batch(rows: int = BATCH):
    """The batch of the task the checks use (phases 3c, 4g and 5), made on
    the card from a seeded generator."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(rows, 100, generator=gen, device="cuda")
    y = torch.randint(0, 2, (rows,), generator=gen, device="cuda")
    return x, y


def path_process(workdir: Path, key: str) -> dict:
    """Path 4g, 4h, 4i, 4j, 4k, 4l or 4m (``key`` "lifecycle", "optim",
    "bf16", "pipeline", "sharded", "lm" or "lm_train") in a process of its
    own (``chip_smoke.py --KEY DIR``, underscores as dashes,
    waited for), so that its profiler windows leave the later phases'
    whole (after 4g's or 4i's runs the profiler loses the first kernels of
    a window; ``_profiled``'s sentinels take them).  Returns its
    ``KEY.json``: the results and the kernel launches of its runs (4i's
    results also carry its kernel rows' fields)."""
    out = workdir / key
    out.mkdir()
    sys.stdout.flush()
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                        f"--{key.replace('_', '-')}", str(out)],
                       timeout=900)
    _require(r.returncode == 0, f"chip_smoke.py --{key} exited "
             f"{r.returncode}")
    return json.loads((out / f"{key}.json").read_text())


def _segment_want(n: int, depth: int) -> dict:
    """A fused training segment's launches: 2·(depth+1) a step, kernel by
    kernel (the training forwards count under the serving names)."""
    want = {"fused_input": n, "fused_input_bwd": n, "loss_head_fwd": n,
            "loss_head_bwd": n}
    if depth > 1:
        want.update(fused_layer=n * (depth - 1),
                    fused_layer_dx_dw=n * (depth - 1))
    return want


def lifecycle_train(name: str, workdir: Path, flags: list,
                    steps: int = LIFECYCLE_STEPS, ckpt_every: int = 8,
                    ckpt: Path | None = None, profile: bool = False):
    """One ``repro_torch.launch.train.main`` run of path 4g on the fused
    route (batch 32, chunks of 8, seed 0), the kernel counters set to 0
    just before it and read just after it, optionally under
    ``torch.profiler``.  Returns (params, layout, stats, checkpoint dir,
    launches, profiler or None)."""
    import torch

    from repro_torch.launch import train as train_driver
    from repro_torch.launch.launch_count import (kernel_launches,
                                                 reset_kernel_launches)
    ckpt = ckpt or workdir / f"life-{name}"
    argv = ["--bd-impl", "fused", "--batch", str(BATCH), "--steps",
            str(steps), "--scan-steps", "8", "--ckpt-dir", str(ckpt),
            "--ckpt-every", str(ckpt_every), "--seed", "0", *flags]
    prof = None
    base = torch.cuda.memory_allocated()
    reset_kernel_launches()
    if profile:
        with _profiled() as prof:
            params, lp, stats = train_driver.main(argv)
    else:
        params, lp, stats = train_driver.main(argv)
    torch.cuda.synchronize()
    launches = kernel_launches()
    _require(stats["restarts"] == 0, f"{name}: {stats['restarts']} restarts")
    for r in stats["rungs"]:
        # the run's own device memory after the rung (the earlier phases'
        # tensors are still allocated)
        r["run_memory"] = r["memory_allocated"] - base
        print(f"[{name}] rung {r['rung']} @ step {r['step']}: "
              f"{r['members_before']} -> {r['members']} members, fused "
              f"{r['fused_hidden']}; eval {r['eval_s'] * 1e3:.2f} ms, "
              f"gather {r['gather_s'] * 1e3:.2f} ms, tables "
              f"{r['tables_s'] * 1e3:.2f} ms ({r['tables_built']} built); "
              f"run memory {r['run_memory'] / 2**20:.1f} MiB", flush=True)
    return params, lp, stats, ckpt, launches, prof


def check_ladder(name: str, stats: dict, launches: dict, members: list,
                 pbt: bool = False, hidden0: list | None = None):
    """Path 4g's invariants of one run: every segment exactly 2·(depth+1)
    launches a step, kernel by kernel, and no kernel but the fused
    route's in the run; the live members (and, given, the first layer's
    fused width) after each rung; a ``pbt`` rung builds no table, and no
    segment after a rung builds one (the rung built the new layout's)."""
    for s in stats["segments"]:
        want = _segment_want(s["end"] - s["start"], s["depth"])
        _require(s["launches"] == want, f"{name}: segment [{s['start']}, "
                 f"{s['end']}) launched {s['launches']}, expected {want}")
    other = {k: v for k, v in launches.items()
             if v and k not in SERVE_KERNELS + ("fused_input_bwd",
                                                "fused_layer_dx_dw",
                                                "loss_head_fwd",
                                                "loss_head_bwd")}
    _require(not other, f"{name}: other kernels launched {other}")
    got = [r["members"] for r in stats["rungs"]]
    _require(got == members, f"{name}: members after the rungs {got}, "
             f"expected {members}")
    if hidden0 is not None:
        got = [r["fused_hidden"][0] for r in stats["rungs"]]
        _require(got == hidden0, f"{name}: fused width after the rungs "
                 f"{got}, expected {hidden0}")
    for r in stats["rungs"]:
        _require((r["tables_built"] == 0) if pbt else (r["tables_built"] > 0),
                 f"{name}: rung {r['rung']} built {r['tables_built']} "
                 "tables")
    after = [s["tables_built"] for s in stats["segments"][1:]]
    _require(not any(after), f"{name}: segments after a rung built "
             f"{after} tables")


def segment_rows(name: str, stats: dict, walls: dict | None = None,
                 prof=None) -> list:
    """One row per segment: steps, members, fused widths, step wall (host,
    synchronised at the segment's end; ``walls`` the unprofiled run's
    stats where ``prof`` comes from a profiled run) and, from ``prof``,
    the device time a step and the device's idle share of the wall.  The
    profiler's kernels are cut into segments by the run's launch counts
    (a segment's launches, then the next rung's eval's)."""
    import torch
    raw = ours = []
    if prof is not None:
        cuda = torch.autograd.DeviceType.CUDA
        # the trainer's chunk spans also leave a record on the device
        # timeline: no device work
        raw = sorted((e for e in prof.profiler.kineto_results.events()
                      if e.device_type() == cuda
                      and e.name() != CHUNK_SPAN),
                     key=lambda e: e.start_ns())
        ours = [e for e in raw if any(k in e.name() for k in KERNEL_SYMBOLS)]
    rows, idx = [], 0
    walls = walls or stats
    for k, (s, w) in enumerate(zip(stats["segments"], walls["segments"])):
        n = s["end"] - s["start"]
        row = {"steps": [s["start"], s["end"]], "members": s["members"],
               "fused_hidden": s["fused_hidden"],
               "step_wall_ms": w["seconds"] / n * 1e3}
        if prof is not None:
            if k:
                idx += stats["rungs"][k - 1]["eval_launches"]
            count = sum(s["launches"].values())
            seg = ours[idx: idx + count]
            _require(len(seg) == count, f"{name}: the profiler saw "
                     f"{len(seg)} of segment {k}'s {count} launches")
            idx += count
            t0 = seg[0].start_ns()
            t1 = seg[-1].start_ns() + seg[-1].duration_ns()
            busy = sum(e.duration_ns() for e in raw
                       if t0 <= e.start_ns() < t1) / 1e6
            row.update(device_ms=busy / n,
                       device_idle_share=1 - busy / n / row["step_wall_ms"])
        rows.append(row)
        print(f"[{name}] segment {k}: {row}", flush=True)
    return rows


def heldout_fall(name: str, params, lp, ckpt: Path, lp0) -> list:
    """The held-out mean loss of the run's seed members (original ids
    below the population's size: survivors, not newborns) at the seed's
    initial parameters and at the end; raises unless it fell."""
    import torch

    from repro_torch.checkpoint.checkpoint import load_meta
    from repro_torch.core.deep import init_params
    from repro_torch.core.selection import evaluate_population
    from repro_torch.data.synthetic import TabularTask
    (_, _), (xte, yte) = TabularTask(2048, lp.in_features,
                                     n_classes=lp.out_features,
                                     seed=0).split()
    ids = load_meta(str(ckpt))[0]["lifecycle"]["member_ids"]
    seeds = [s for s, m in enumerate(ids) if m < lp0.num_members]
    init = init_params(torch.Generator(device="cuda").manual_seed(0), lp0)
    before = evaluate_population(init, lp0, xte, yte, bd_impl="fused",
                                 infer=True)[0]
    after = evaluate_population(params, lp, xte, yte, bd_impl="fused",
                                infer=True)[0]
    del init
    b = before[[ids[s] for s in seeds]].mean().item()
    a = after[seeds].mean().item()
    _require(bool(torch.isfinite(after).all()) and a < b,
             f"{name}: the survivors' held-out mean loss {b} -> {a}")
    print(f"[{name}] held-out mean loss of {len(seeds)} seed members "
          f"{b!r} -> {a!r}", flush=True)
    return [b, a]


def check_rung_steps(name: str, ckpt: Path, steps: list, x, y,
                     adam: bool = False, opt=None) -> tuple:
    """The state each rung force-saved (its new layout): one step on the
    fused route against the plain route on the card (per-member losses,
    gradients, updated parameters), then its steady-state step timed
    (``time_train_step``: sgd, or AdamW with clipping, or ``opt`` with
    clipping).  Returns (max |err| by step, the timings by step)."""
    from repro_torch.checkpoint.checkpoint import restore_population
    from repro_torch.optim.optimizers import sgd
    errs, timed = {}, {}
    for step in steps:
        params, lp, _ = restore_population(str(ckpt), step=step,
                                           device="cuda")
        fused = _step_parts(params, x, y, lp, sgd(), bd_impl="fused")
        plain = _step_parts(params, x, y, lp, sgd(), bd_impl="einsum",
                            loss_impl="xla")
        errs[step] = [_close(f"{name} step {step} vs plain: {what}", a, b)
                      for what, a, b in zip(("losses", "grads", "params"),
                                            fused, plain)]
        print(f"[{name}] after the rung at step {step} ({lp.num_real} "
              f"members, depth {lp.depth}): max|err| losses/grads/params "
              f"{errs[step]!r} vs the plain route on the card", flush=True)
        timed[step] = time_train_step(f"{name} after the rung at {step}",
                                      params, lp, x, y, adam=adam, opt=opt)
        timed[step].update(members=lp.num_real, fused_hidden=[
            lp.layer_pop(l).total_hidden for l in range(lp.depth)])
    return errs, timed


def _same_trees(a, b) -> bool:
    """Two trees of tensors equal leaf by leaf, dtype and bits
    (``_same_bits``), wherever each leaf lies."""
    from repro_torch.core.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        p.dtype == q.dtype and p.shape == q.shape
        and _same_bits(p.cpu(), q.cpu()) for p, q in zip(la, lb))


def gathers_bitwise(name: str, params, lp, opt, x, y, grow: bool):
    """The lifecycle's three tree operations on the card against the same
    operations on the CPU copy (numpy host gather), bitwise: compaction
    of parameters and optimizer moments (after one step, so the moments
    are live) to half the members by random losses; with ``grow``, a
    growth of the compacted population by members of the menu and a
    constant-size refill of the pruned slots.  Each timed on the card
    (host wall, synchronised)."""
    import numpy as np
    import torch

    from repro_torch.core import lifecycle as life
    from repro_torch.core.deep import opt_step
    from repro_torch.launch.train import fresh_member_params
    state = opt.init(params)
    params, state, *_ = opt_step(params, state, x, y, 1e-2, opt, lp,
                                 bd_impl="fused")
    losses = np.random.default_rng(7).random(lp.num_real)
    keep = life.survivors(losses, 0.5)
    cpu_p, cpu_s = _to(params, "cpu"), _to(state, "cpu")
    out, times = {}, {}

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        times[key] = (time.perf_counter() - t0) * 1e3
        return r

    lp_k, card_p, card_s = timed("compact_ms", lambda: life.compact(
        lp, params, state, keep))
    _, host_p, host_s = life.compact(lp, cpu_p, cpu_s, keep, gather="host")
    out["compact"] = _same_trees((card_p, card_s), (host_p, host_s))
    if grow:
        widths = ((32, 16), (13, 5), (64, 32, 16), (7,))
        acts = ("relu", "tanh", "gelu", "relu")
        pos = lp_k.grow_positions(widths, acts)
        fresh_lp = lp_k.grow(widths, acts, pos).subset(tuple(sorted(pos)))
        fresh = fresh_member_params(0, 1, fresh_lp, "cuda")
        grown = timed("grow_ms", lambda: life.grow(
            lp_k, card_p, card_s, widths, acts, pos, fresh))
        host_g = life.grow(lp_k, host_p, host_s, widths, acts, pos,
                           _to(fresh, "cpu"), gather="host")
        out["grow"] = grown[0] == host_g[0] and _same_trees(
            grown[1:], host_g[1:])
        pruned = [m for m in range(lp.num_real) if m not in set(keep)]
        twins = {}
        for m in keep:
            twins.setdefault((lp.widths[m], lp.activations[m]), int(m))
        asg = tuple((s, twins.get((lp.widths[s], lp.activations[s]), -1))
                    for s in pruned)
        fs = [s for s, p in asg if p < 0]
        fresh = None
        if fs:
            from repro_torch.core.population import LayeredPopulation
            fresh = fresh_member_params(0, 1, LayeredPopulation(
                lp.in_features, lp.out_features,
                tuple(lp.widths[s] for s in fs),
                tuple(lp.activations[s] for s in fs), block=lp.block),
                "cuda")
        card_r = timed("refill_ms", lambda: (
            life.refill_params(lp, params, asg, fresh),
            life.refill_state(state, lp, [s for s, _ in asg])))
        host_r = (life.refill_params(lp, cpu_p, asg,
                                     None if fresh is None
                                     else _to(fresh, "cpu"), gather="host"),
                  life.refill_state(cpu_s, lp, [s for s, _ in asg]))
        out["refill"] = _same_trees(card_r, host_r)
    for key, same in out.items():
        _require(same, f"{name}: {key} on the card differs from the CPU's")
    print(f"[{name}] {', '.join(out)} on the card bitwise the CPU's; "
          f"times {times!r} ms", flush=True)
    return {"bitwise_cpu": out, **times}


def lifecycle_path(workdir: Path) -> tuple:
    """Path 4g: the 10k ladder (sgd, ``--halving "8:0.5,16:0.5"
    --rung-eval-batches 4``: 10,000 → 5,000 → 2,500 members, fused width
    1,280,000 → 640,000 → 320,000), its rungs' states stepped against the
    plain route, the ladder again under the profiler and without
    checkpoints beside the same 24 steps without ``--halving``; the
    depth-3 population under AdamW three ways (``--halving "8:0.5"``, with
    a mid-ladder resume against the straight run; ``--refill arch``;
    ``--refill pbt --per-member-lr``); the gathers on the card against the
    CPU.  Returns (the results, the kernel launches of the runs)."""
    import torch

    from repro_torch.configs import parallelmlp_10k
    from repro_torch.launch.train import population_from_flags
    lp10k = parallelmlp_10k.config().model.layered()
    depth3 = depth3_flags()
    x, y = check_batch()
    res, n_all = {}, {}

    def count(n):
        for k, v in n.items():
            n_all[k] = n_all.get(k, 0) + v

    # the 10k ladder with rung checkpoints (every member pads to one
    # block, so the fused width halves with the members)
    name = "lifecycle 10k"
    n0, h0 = lp10k.num_members, lp10k.layer_pop(0).total_hidden
    p, lp, st, ck, n, _ = lifecycle_train(name, workdir, LADDER10K)
    count(n)
    check_ladder(name, st, n, [n0 // 2, n0 // 4],
                 hidden0=[h0 // 2, h0 // 4])
    _require(lp.num_real == n0 // 4
             and lp.layer_pop(0).total_hidden == h0 // 4,
             f"{name}: ended at {lp.describe()}")
    held = heldout_fall(name, p, lp, ck, lp10k)
    rung_steps, rung_times = check_rung_steps(name, ck, [7, 15], x, y)
    del p
    res[name] = {"rungs": st["rungs"], "heldout_loss": held,
                 "rung_step_max_abs_err": rung_steps,
                 "rung_steps": rung_times,
                 "chunk_builds": st["chunk_builds"]}
    # the depth-3 population, AdamW + clipping, three ways
    lp3 = population_from_flags(DEPTH3["depths"], DEPTH3["acts"],
                                DEPTH3["features"],
                                repeats=DEPTH3["repeats"])
    n3 = lp3.num_members
    # a constant lr: a cosine schedule spans --steps, so a run stopped at
    # step 12 would not be a prefix of the 24-step run it is held to
    cut = depth3.index("--lr-schedule")
    depth3 = depth3[:cut] + depth3[cut + 2:]
    for key, flags, members, pbt in (
            ("halving", ["--halving", "8:0.5"], [n3 // 2], False),
            ("arch", ["--halving", "8:0.5", "--refill", "arch",
                      "--search-space", ARCH_SPACE], [n3], False),
            ("pbt", ["--halving", "8:0.5", "--refill", "pbt",
                     "--per-member-lr"], [n3], True)):
        name = f"lifecycle depth-3 {key}"
        p, lp, st, ck, n, _ = lifecycle_train(name, workdir,
                                              depth3 + flags)
        count(n)
        check_ladder(name, st, n, members, pbt=pbt)
        errs, timed = check_rung_steps(name, ck, [7], x, y, adam=True)
        out = {"segments": segment_rows(name, st), "rungs": st["rungs"],
               "heldout_loss": heldout_fall(name, p, lp, ck, lp3),
               "rung_step_max_abs_err": errs, "rung_steps": timed,
               "chunk_builds": st["chunk_builds"],
               "explored": st["explored"], "layout": lp.describe()}
        if key == "pbt":
            _require(st["chunk_builds"] == 1, f"{name}: "
                     f"{st['chunk_builds']} chunks for a constant layout")
        if key == "halving":
            # stop at step 12 (past the rung), resume to 24: the straight
            # run's parameters
            half = workdir / "life-resume"
            lifecycle_train(name + " to 12", workdir, depth3 + flags,
                            steps=12, ckpt=half)
            r, lp_r, _, _, _, _ = lifecycle_train(
                name + " resumed", workdir, depth3 + flags + ["--resume"],
                ckpt=half)
            _require(lp_r == lp, f"{name}: the resumed layout differs")
            out["resume_max_abs_err"] = _close(
                f"{name} resumed vs straight", r, p, (1e-5, 1e-6))
            out["resume_bitwise"] = _same_trees(r, p)
            print(f"[{name}] mid-ladder resume vs the straight run: "
                  f"max|err| {out['resume_max_abs_err']!r}, bitwise "
                  f"{out['resume_bitwise']}", flush=True)
            out["gathers"] = gathers_bitwise(name, p, lp, _adamw(), x, y,
                                             grow=False)
        if key == "arch":
            out["gathers"] = gathers_bitwise(name, p, lp, _adamw(), x, y,
                                             grow=True)
        res[name] = out
        del p
    # the 10k compaction on the card against the CPU's (sgd: no moments)
    from repro_torch.checkpoint.checkpoint import restore_population
    from repro_torch.optim.optimizers import sgd
    p10, lp5k, _ = restore_population(str(workdir / "life-lifecycle 10k"),
                                      step=7, device="cuda")
    res["lifecycle 10k"]["gathers"] = gathers_bitwise(
        "lifecycle 10k", p10, lp5k, sgd(), x, y, grow=False)
    del p10
    torch.cuda.empty_cache()
    # last (the profiler's longest window), the same 10k ladder without
    # checkpoints: walls; then under the profiler: device time a step by
    # segment; then the 24 steps without the ladder
    name = "lifecycle 10k"
    _, _, st_w, _, n, _ = lifecycle_train(
        name + " (walls)", workdir, LADDER10K, ckpt_every=0)
    count(n)
    _, _, st_p, _, n, prof = lifecycle_train(
        name + " (profiled)", workdir, LADDER10K, ckpt_every=0,
        profile=True)
    count(n)
    segs = segment_rows(name, st_p, walls=st_w, prof=prof)
    del prof
    _, _, st_b, _, n, _ = lifecycle_train(
        "10k without halving", workdir,
        LADDER10K[:LADDER10K.index("--halving")], ckpt_every=0)
    count(n)
    rate = st_w["member_steps"] / st_w["seconds"]
    rate_b = st_b["member_steps"] / st_b["seconds"]
    print(f"[{name}] {rate!r} model-steps/s over the ladder's train loop "
          f"against {rate_b!r} without --halving ({rate / rate_b!r}×)",
          flush=True)
    res[name].update({
        "segments": segs, "rungs_without_checkpoints": st_w["rungs"],
        "model_steps_per_s": rate, "model_steps_per_s_without_halving": rate_b,
        "loop_seconds": [st_w["seconds"], st_b["seconds"]],
        "member_steps": [st_w["member_steps"], st_b["member_steps"]]})
    return res, n_all


def _adamw():
    from repro_torch.optim.optimizers import adamw
    return adamw(weight_decay=0.01)


# --------------------------------------------------------------------- #
# the optimizers and the checkpoint (path 4h)                           #
# --------------------------------------------------------------------- #

# the optimizer state's bytes at parallelmlp-10k, from its shapes (count
# apart): 131,860,000 f32 parameters (w_in 1,280,000 × 100, b_in, w_out
# 2 × 1,280,000, b_out 10,000 × 2); AdamW m and v in f32 or bf16;
# adafactor m in bf16 and 3,850,104 f32 statistics (w_in's v_row and
# v_col, b_in's v, w_out's, b_out's)
STATE_BYTES_10K = {"sgd": 0, "adamw": 1_054_880_000,
                   "adamw bf16": 527_440_000, "adafactor": 279_120_416}
OPTIM_ORDER = ("sgd", "adamw", "adamw bf16", "adafactor")


def _optimizer(name: str):
    """Path 4h's optimizers by name, as the trainer builds them."""
    import torch

    from repro_torch.optim.optimizers import adafactor, adamw, sgd
    return {"sgd": sgd, "adamw": lambda: adamw(weight_decay=0.01),
            "adamw bf16": lambda: adamw(weight_decay=0.01,
                                        state_dtype=torch.bfloat16),
            "adafactor": lambda: adafactor(weight_decay=0.001)}[name]()


def state_bytes(state) -> tuple:
    """(bytes of the optimizer state's tensors but the step count, the
    count's bytes), read from the tensors."""
    from repro_torch.core.tree import tree_leaves
    sizes = [t.numel() * t.element_size() for t in tree_leaves(state)]
    count = state["count"]
    return sum(sizes) - count.numel() * count.element_size(), \
        count.numel() * count.element_size()


def _close_state(name, got, want, tol=(1e-5, 1e-6)) -> float:
    """Two optimizer trees leaf by leaf: f32 within ``tol``; bf16 each
    element equal or one ulp apart, or within ``tol`` (a near-zero
    moment); int32 equal.  Returns the largest f32 |err|."""
    import torch

    from repro_torch.core.tree import tree_leaves
    err = 0.0
    for i, (a, b) in enumerate(zip(tree_leaves(got), tree_leaves(want))):
        a, b = a.cpu(), b.cpu()
        _require(a.dtype == b.dtype and a.shape == b.shape,
                 f"{name}: leaf {i} {a.dtype}{tuple(a.shape)} against "
                 f"{b.dtype}{tuple(b.shape)}")
        if a.dtype == torch.bfloat16:
            ulps = (a.view(torch.int16).int() - b.view(torch.int16).int())
            near = (a.float() - b.float()).abs() <= tol[1] + tol[0] * \
                b.float().abs()
            _require(bool((near | (ulps.abs() <= 1)).all()),
                     f"{name}: bf16 leaf {i} {ulps.abs().max().item()} "
                     "ulps apart")
        elif a.dtype == torch.float32:
            err = max(err, _close(f"{name} leaf {i}", a, b, tol))
        else:
            _require(torch.equal(a, b), f"{name}: leaf {i} differs")
    return err


def optimizer_steps_10k(name: str, lp, x, y, count) -> dict:
    """``parallelmlp-10k``'s fused step under each optimizer, in turns
    (sgd, adamw, adamw bf16, adafactor, then the reverse): the launches of
    one step (exactly 2·(depth+1) = 4, kernel by kernel; given to
    ``count``), the state's bytes from its tensors against
    ``STATE_BYTES_10K``, and the steady step (``time_step``: wall, device
    ms, idle share)."""
    import torch

    from repro_torch.core.deep import init_params, opt_step
    from repro_torch.launch.launch_count import (kernel_launches,
                                                 reset_kernel_launches)
    params = init_params(torch.Generator(device="cuda").manual_seed(0), lp)
    out = {}
    for run, key in enumerate(OPTIM_ORDER + OPTIM_ORDER[::-1]):
        opt = _optimizer(key)
        state = opt.init(params)
        label = f"{name} {key}" + (" (2)" if run >= len(OPTIM_ORDER) else "")
        reset_kernel_launches()
        opt_step(params, state, x, y, 1e-2, opt, lp, bd_impl="fused")
        torch.cuda.synchronize()
        n = {k: v for k, v in kernel_launches().items() if v}
        count(n)
        _require(n == _segment_want(1, lp.depth), f"{label}: a step "
                 f"launched {n}, expected 2·(depth+1)")
        nbytes, count_bytes = state_bytes(state)
        _require(nbytes == STATE_BYTES_10K[key] and count_bytes == 4,
                 f"{label}: optimizer state {nbytes} + {count_bytes} B, "
                 f"expected {STATE_BYTES_10K[key]} + 4")
        row = time_step(label, lambda: opt_step(params, state, x, y, 1e-2,
                                                opt, lp, bd_impl="fused"))
        row.update(launches=sum(n.values()), state_bytes=nbytes,
                   count_bytes=count_bytes)
        print(f"[{label}] optimizer state {nbytes} B + {count_bytes} B "
              "count", flush=True)
        out[label] = row
        del state
    return out


def update_card_vs_cpu(name: str, lp) -> dict:
    """An update of adamw bf16 and adafactor on the card against the same
    update on the CPU, same inputs at ``parallelmlp-10k``'s shapes: seeded
    parameters and gradients, and the state one update on the card left
    (live moments, its bf16 bits shared by both sides: a bf16 moment that
    rounds the other way on one side would move the next update by most
    of an ulp).  The update and f32 state within rtol 1e-5 / atol 1e-6,
    bf16 leaves within one ulp (``_close_state``; the two devices reduce
    in different orders)."""
    import torch

    from repro_torch.core.deep import init_params
    from repro_torch.core.tree import tree_map
    gen = torch.Generator(device="cuda").manual_seed(11)
    params = init_params(gen, lp)
    grads = [tree_map(lambda p: torch.randn(p.shape, generator=gen,
                                            device="cuda"), params)
             for _ in range(2)]
    out = {}
    for key in ("adamw bf16", "adafactor"):
        opt = _optimizer(key)
        _, st = opt.update(grads[0], opt.init(params), params, 1e-2)
        card = opt.update(grads[1], st, params, 1e-2)
        cpu = opt.update(_to(grads[1], "cpu"), _to(st, "cpu"),
                         _to(params, "cpu"), 1e-2)
        out[key] = _close_state(f"{name} {key} card vs CPU", card, cpu)
        print(f"[{name} {key}] an update on the card against the CPU: "
              f"f32 max|err| {out[key]!r}, bf16 leaves within one ulp",
              flush=True)
        del st, card, cpu
    return {"max_abs_err": out}


def _adafactor_state_at(ckpt: Path, step: int):
    """(params, layout, adafactor state) of a checkpoint's step."""
    from repro_torch.checkpoint.checkpoint import (layout_from_meta,
                                                   load_meta,
                                                   restore_population)
    from repro_torch.core.deep import abstract_params
    lp = layout_from_meta(load_meta(str(ckpt), step)[0])
    like = _optimizer("adafactor").init(abstract_params(lp))
    params, lp, _, state = restore_population(str(ckpt), step=step,
                                              device="cuda", extra_like=like)
    return params, lp, state


def check_rewarmed(name: str, ckpt: Path, step: int):
    """A compacting rung's saved adafactor state: its statistics fresh
    zeros on the new layout, its bf16 momentum carried (live), its count
    the steps taken."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.optim.optimizers import is_state_leaf
    _, lp, st = _adafactor_state_at(ckpt, step)
    for leaf in tree_leaves(st["leaves"], is_leaf=is_state_leaf):
        _require(all(not leaf[k].any() for k in ("v", "v_row", "v_col")
                     if k in leaf), f"{name}: a statistic of step {step}'s "
                 "state is not zero")
        _require(str(leaf["m"].dtype) == "torch.bfloat16"
                 and bool(leaf["m"].any()),
                 f"{name}: step {step}'s momentum is not carried")
    _require(int(st["count"]) == step + 1, f"{name}: count "
             f"{int(st['count'])} at step {step}")
    print(f"[{name}] the state saved at the rung of step {step} "
          f"({lp.num_real} members): statistics zero, bf16 momentum "
          f"carried, count {int(st['count'])}", flush=True)


def factored_gather_bitwise(name: str, ckpt: Path, step: int) -> dict:
    """``compact_factored`` of a rung's saved adafactor state to half its
    members (random losses) on the card against the same on the CPU (the
    numpy host gather): parameters and bf16 momentum bitwise; timed on the
    card."""
    import numpy as np
    import torch

    from repro_torch.core import lifecycle as life
    params, lp, state = _adafactor_state_at(ckpt, step)
    keep = life.survivors(np.random.default_rng(7).random(lp.num_real), 0.5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, card_p, card_c = life.compact_factored(lp, params, state, keep)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    _, host_p, host_c = life.compact_factored(lp, _to(params, "cpu"),
                                              _to(state, "cpu"), keep,
                                              gather="host")
    same = _same_trees((card_p, card_c["m"]), (host_p, host_c["m"]))
    _require(same, f"{name}: compact_factored on the card differs from the "
             "CPU's")
    print(f"[{name}] compact_factored of step {step}'s state "
          f"({lp.num_real} -> {len(keep)} members) on the card bitwise the "
          f"CPU's; {ms!r} ms", flush=True)
    return {"bitwise_cpu": same, "compact_factored_ms": ms}


def adafactor_ladder_10k(name: str, workdir: Path, lp10k, x, y,
                         count) -> dict:
    """The 10k ladder under adafactor (``--weight-decay 0.001``), 24 steps,
    checkpoints every 8 through the ``AsyncCheckpointer``: 10,000 → 5,000
    → 2,500 members at 4 launches a step, each rung's saved state
    re-warmed (``check_rewarmed``), stepped against the plain route and
    its steady adafactor step timed (``check_rung_steps``), its momentum
    gather bitwise the CPU's, the held-out loss falling, and a run
    stopped at step 12 and resumed bitwise the straight run."""
    flags = LADDER10K + ["--optimizer", "adafactor", "--weight-decay",
                         "0.001"]
    n0, h0 = lp10k.num_members, lp10k.layer_pop(0).total_hidden
    p, lp, st, ck, n, _ = lifecycle_train(name, workdir, flags)
    count(n)
    check_ladder(name, st, n, [n0 // 2, n0 // 4], hidden0=[h0 // 2, h0 // 4])
    out = {"rungs": st["rungs"], "segments": segment_rows(name, st),
           "heldout_loss": heldout_fall(name, p, lp, ck, lp10k)}
    for step in (7, 15):
        check_rewarmed(name, ck, step)
    out["rung_step_max_abs_err"], out["rung_steps"] = check_rung_steps(
        name, ck, [7, 15], x, y, opt=_optimizer("adafactor"))
    out["gather"] = factored_gather_bitwise(name, ck, 15)
    half = workdir / "optim-10k-resume"
    _, _, _, _, n, _ = lifecycle_train(name + " to 12", workdir, flags,
                                       steps=12, ckpt=half)
    count(n)
    r, lp_r, _, _, n, _ = lifecycle_train(name + " resumed", workdir,
                                          flags + ["--resume"], ckpt=half)
    count(n)
    _require(lp_r == lp, f"{name}: the resumed layout differs")
    out["resume_bitwise"] = _same_trees(r, p)
    _require(out["resume_bitwise"], f"{name}: the run resumed at step 12 "
             "differs from the straight run")
    print(f"[{name}] resumed at step 12: bitwise the straight run",
          flush=True)
    del p, r
    return out


def depth3_optim_runs(workdir: Path, x, y, count) -> dict:
    """The depth-3 population (clip 1.0, a constant lr) under adafactor
    with ``--halving "8:0.5"`` and ``--refill arch``, and with ``--refill
    pbt --per-member-lr``, and under AdamW with a bf16 state and
    ``--halving "8:0.5"``: path 4g's checks of each run (``check_ladder``,
    ``check_rung_steps``, ``heldout_fall``), the pbt rung 0 tables and one
    chunk, each rung's steady step timed under the run's optimizer."""
    from repro_torch.launch.train import population_from_flags
    lp3 = population_from_flags(DEPTH3["depths"], DEPTH3["acts"],
                                DEPTH3["features"],
                                repeats=DEPTH3["repeats"])
    n3 = lp3.num_members
    base = depth3_flags()
    base = base[:base.index("--optimizer")] + ["--grad-clip", "1.0"]
    af = ["--optimizer", "adafactor", "--halving", "8:0.5"]
    res = {}
    for key, flags, members, pbt, opt in (
            ("adafactor arch", af + ["--refill", "arch", "--search-space",
                                     ARCH_SPACE], [n3], False, "adafactor"),
            ("adafactor pbt", af + ["--refill", "pbt", "--per-member-lr"],
             [n3], True, "adafactor"),
            ("adamw bf16", ["--optimizer", "adamw", "--opt-state-dtype",
                            "bfloat16", "--halving", "8:0.5"], [n3 // 2],
             False, "adamw bf16")):
        name = f"optim depth-3 {key}"
        p, lp, st, ck, n, _ = lifecycle_train(name, workdir, base + flags)
        count(n)
        check_ladder(name, st, n, members, pbt=pbt)
        errs, timed = check_rung_steps(name, ck, [7], x, y, adam=True,
                                       opt=_optimizer(opt))
        res[name] = {"segments": segment_rows(name, st), "rungs": st["rungs"],
                     "heldout_loss": heldout_fall(name, p, lp, ck, lp3),
                     "rung_step_max_abs_err": errs, "rung_steps": timed,
                     "chunk_builds": st["chunk_builds"],
                     "layout": lp.describe()}
        if pbt:
            _require(st["chunk_builds"] == 1, f"{name}: "
                     f"{st['chunk_builds']} chunks for a constant layout")
        del p
    return res


def checkpoint_10k(name: str, workdir: Path, lp, x, y, count) -> dict:
    """``parallelmlp-10k``'s parameters and adafactor state (one step in,
    so the bf16 momentum is live; 806,560,420 B): the time ``maybe_save``
    holds the loop (the host snapshot) and the worker's write, against a
    synchronous ``save`` of the same tree, in turns (sync, async, async,
    sync); the async checkpoint restored on the card and on the CPU,
    bitwise; then a ``TrainRunner`` crash replay (4 steps, saves every 2,
    a failure at step 3) bitwise an unbroken run on the card."""
    import shutil

    import torch

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.core.deep import abstract_params, init_params, opt_step
    from repro_torch.core.tree import tree_leaves
    from repro_torch.distributed.fault_tolerance import TrainRunner
    from repro_torch.launch.launch_count import (kernel_launches,
                                                 reset_kernel_launches)
    opt = _optimizer("adafactor")
    params = init_params(torch.Generator(device="cuda").manual_seed(0), lp)
    reset_kernel_launches()
    params, state, *_ = opt_step(params, opt.init(params), x, y, 1e-2, opt,
                                 lp, bd_impl="fused")
    tree = {"params": params, "extra": state}
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(tree))
    out = {"tree_bytes": nbytes, "sync_save_ms": [], "hold_ms": [],
           "write_ms": []}
    for k, mode in enumerate(("sync", "async", "async", "sync")):
        d = workdir / f"optim-ckpt-{k}"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "sync":
            ckpt.save(str(d), 0, tree)
            out["sync_save_ms"].append((time.perf_counter() - t0) * 1e3)
        else:
            saver = ckpt.AsyncCheckpointer(str(d), every=1)
            saver.maybe_save(0, tree)
            t1 = time.perf_counter()
            saver.wait()
            out["hold_ms"].append((t1 - t0) * 1e3)
            out["write_ms"].append((time.perf_counter() - t1) * 1e3)
    print(f"[{name}] {nbytes} B: maybe_save holds the loop "
          f"{out['hold_ms']!r} ms, its worker writes {out['write_ms']!r} "
          f"ms; a synchronous save {out['sync_save_ms']!r} ms", flush=True)
    like = {"params": abstract_params(lp),
            "extra": opt.init(abstract_params(lp))}
    out["restore_bitwise"] = {}
    for dev in ("cuda", "cpu"):
        got, _ = ckpt.restore(str(workdir / "optim-ckpt-1"), like,
                              device=dev)
        out["restore_bitwise"][dev] = _same_trees(got, tree)
        _require(out["restore_bitwise"][dev], f"{name}: the bf16 state "
                 f"saved from the card restores differently on {dev}")
        del got
    for k in range(4):
        shutil.rmtree(workdir / f"optim-ckpt-{k}")
    # crash replay: 4 steps on 4 batches of the task
    gen = torch.Generator(device="cuda").manual_seed(5)
    xs = torch.randn(4, BATCH, lp.in_features, generator=gen, device="cuda")
    ys = torch.randint(0, lp.out_features, (4, BATCH), generator=gen,
                       device="cuda")

    def run(d, fail_at=None):
        failed, restored = [], []

        def step_fn(st, s):
            p, o, *_ = opt_step(st["params"], st["extra"], xs[s], ys[s],
                                1e-2, opt, lp, bd_impl="fused")
            return {"params": p, "extra": o}, {}

        def hook(s):
            if s == fail_at and not failed:
                failed.append(s)
                raise RuntimeError("injected failure")

        runner = TrainRunner(step_fn, tree, ckpt_dir=str(d), ckpt_every=2,
                             failure_hook=hook, on_restore=restored.append)
        _require(runner.run(4) == 4, f"{name}: the runner stopped early")
        return runner, restored

    clean, _ = run(workdir / "optim-replay-clean")
    broken, restored = run(workdir / "optim-replay-broken", fail_at=3)
    torch.cuda.synchronize()
    count(kernel_launches())
    out["replay_bitwise"] = broken.restarts == 1 and restored == [3] and \
        _same_trees(broken.state, clean.state)
    _require(out["replay_bitwise"], f"{name}: the crash replay "
             f"({broken.restarts} restarts, re-entered at {restored}) "
             "differs from the unbroken run")
    print(f"[{name}] crash replay with async saves: re-entered at step "
          f"{restored}, bitwise the unbroken run", flush=True)
    for d in ("clean", "broken"):
        shutil.rmtree(workdir / f"optim-replay-{d}")
    return out


def optim_path(workdir: Path) -> tuple:
    """Path 4h: ``parallelmlp-10k``'s fused step under sgd, AdamW (f32 and
    bf16 state) and adafactor in turns; the update on the card against the
    CPU; the 10k ladder under adafactor; the depth-3 population under
    adafactor (``--refill arch``, ``--refill pbt --per-member-lr``) and
    under AdamW with a bf16 state; the 10k checkpoint through the
    ``AsyncCheckpointer``.  Returns (the results, the kernel launches of
    its training runs)."""
    import torch

    from repro_torch.configs import parallelmlp_10k
    lp10k = parallelmlp_10k.config().model.layered()
    x, y = check_batch()
    n_all = {}

    def count(n):
        for k, v in n.items():
            n_all[k] = n_all.get(k, 0) + v

    res = {"steps": optimizer_steps_10k("optim 10k", lp10k, x, y, count),
           "update_card_vs_cpu": update_card_vs_cpu("optim 10k", lp10k)}
    torch.cuda.empty_cache()
    res["ladder"] = adafactor_ladder_10k("optim 10k adafactor ladder",
                                         workdir, lp10k, x, y, count)
    torch.cuda.empty_cache()
    res.update(depth3_optim_runs(workdir, x, y, count))
    torch.cuda.empty_cache()
    res["checkpoint"] = checkpoint_10k("optim 10k checkpoint", workdir,
                                       lp10k, x, y, count)
    return res, n_all


# --------------------------------------------------------------------- #
# the bf16 compute policy (path 4i)                                     #
# --------------------------------------------------------------------- #

# the bf16 instances, by counter, and the kernel row each belongs to: the
# fused route's, the unfused route's and the M3 kernels', and the int8
# kernels' on bf16 activations
BF16_ROWS = {"fused_input_bf16": "fused_input",
             "fused_input_bwd_bf16": "fused_input_bwd",
             "fused_layer_bf16": "fused_layer",
             "fused_layer_dx_dw_bf16": "fused_layer_dx_dw",
             "infer_head_bf16": "infer_head",
             "loss_head_fwd_bf16": "loss_head_fwd",
             "loss_head_bwd_bf16": "loss_head_bwd",
             "fused_input_int8_bf16": "fused_input_int8",
             "fused_layer_int8_bf16": "fused_layer_int8",
             "infer_head_int8_bf16": "infer_head_int8",
             "block_diag_fwd_bf16": "block_diag_fwd",
             "block_diag_dw_bf16": "block_diag_dw",
             "m3_matmul_fwd_bf16": "m3_matmul_fwd",
             "m3_matmul_dh_bf16": "m3_matmul_dh",
             "m3_matmul_dw_bf16": "m3_matmul_dw"}
BF16_KERNELS = tuple(BF16_ROWS)
# rows 16-17's bf16 instances: the kernel API's, on no population path
SEG_BF16_KERNELS = ("seg_act_bf16", "seg_act_bwd_bf16")
# JAX's own tolerance of bf16 compute against f32 (tests/test_infer_path.py)
BF16_POLICY_TOL = (1e-1, 5e-2)
# the CPU tests' slice tolerances under the policy
# (tests/test_torch_bf16_policy.py): losses, gradients
BF16_FWD_TOL, BF16_GRAD_TOL = (2e-2, 2e-2), (1e-2, 1e-3)
# the unfused route's and the M3 head's flags (path 4i)
FUSED_ROUTE = dict(bd_impl="fused")
UNFUSED_M3 = dict(bd_impl="pallas", act_impl="pallas", m3_impl="pallas")


def bf16_ulps(a, b, atol: float = 0.0) -> int:
    """The largest distance between two bf16 tensors in bf16 ulps (steps
    of the bf16 grid, ±0 one point), over the elements more than ``atol``
    apart (0: every element)."""
    import torch
    _require(a.dtype == b.dtype == torch.bfloat16 and a.shape == b.shape,
             f"bf16_ulps: {a.dtype} {tuple(a.shape)} against {b.dtype} "
             f"{tuple(b.shape)}")
    d = (_ulp_key(a) - _ulp_key(b.to(a.device))).abs()
    if atol:
        d = d[(a.float() - b.to(a.device).float()).abs() > atol]
    return int(d.max().item()) if d.numel() else 0


def _ulp_key(t):
    """bf16 values → integers in the order of the values, one apart for
    neighbouring bf16 numbers (±0 both 0)."""
    import torch
    v = t.contiguous().view(torch.int16).int()
    return torch.where(v < 0, -(v + 32768), v)


def _f64_to_bf16(v):
    """f64 values rounded once to bf16, to nearest even.  A cast through
    f32 rounds twice: where the f32 lands on a bf16 midpoint from an f64
    off it, it is first moved one f32 step back toward the f64."""
    import torch
    f = v.float()
    off = ((f.view(torch.int32) & 0xFFFF) == 0x8000) & (f.double() != v)
    toward = torch.where(v > f.double(), torch.full_like(f, math.inf),
                         torch.full_like(f, -math.inf))
    return torch.where(off, torch.nextafter(f, toward), f).to(torch.bfloat16)


def _sum_bound(lin, a, b):
    """The third reference of a sum of products of two operands (``lin``
    of them, its other arguments closed over): the f64 sums of the same
    products, the operands widened, and the worst-case error of an f32 sum
    of those n terms in any order, (n − 1)·2^-24·Σ|terms| (n: ``lin`` on
    ones), per output."""
    import torch
    a, b = a.double(), b.double()
    n = lin(torch.ones_like(a), torch.ones_like(b))
    mag = lin(a.abs(), b.abs())
    return lin(a, b), (n - 1).clamp(min=0) * 2.0 ** -24 * mag


def _act_bound(lin, a, b, bias, exact):
    """The worst-case error of an activation's output (``exact``, f64)
    over an f32 sum of the products ``lin`` sums plus a bias: the sum's (n
    terms and the bias) through a slope of at most 2 (none of the ten
    activations' slopes, nor of their derivatives, passes 2), and the
    activation's own f32 evaluation, 16 f32 ulps of the output."""
    import torch
    a, b = a.double(), b.double()
    n = lin(torch.ones_like(a), torch.ones_like(b))
    mag = lin(a.abs(), b.abs()) + bias.double().abs()
    return 2 * n * 2.0 ** -24 * mag + 16 * 2.0 ** -24 * exact.abs()


def _excused_vs_f64(got, plain, exact, bound) -> dict:
    """The carve-out of ``bf16_ulps(got, plain, ATOL)`` — the elements more
    than 1 bf16 ulp from the plain version but within the f32 atol of it —
    held to a third reference, the f64 sum of the same bf16 products
    (``exact``): at each, the kernel within 1 bf16 ulp of it rounded once,
    or (a sum that cancels so far that an f32 sum of its terms in any order
    may stray further) within ``bound``, the f32 sum's worst-case error,
    plus the kernel's own rounding (2^-8 of its value), of the exact sum.
    Returns the counts and the largest distance from the rounded f64
    sum."""
    excused = ((_ulp_key(got) - _ulp_key(plain)).abs() > 1) \
        & ((got.float() - plain.float()).abs() <= ATOL)
    d = (_ulp_key(got) - _ulp_key(_f64_to_bf16(exact))).abs()
    far = excused & (d > 1)
    wrong = far & ((got.double() - exact).abs()
                   > bound + 2.0 ** -8 * got.double().abs())
    return {"excused": int(excused.sum().item()),
            "max_ulps_at_excused": int(d[excused].max().item())
            if bool(excused.any()) else 0,
            "beyond_1ulp_at_excused": int(far.sum().item()),
            "beyond_f32_bound": int(wrong.sum().item())}


def serve_bf16(name: str, ckpt: Path, lp, x, flags=()) -> tuple:
    """(i) ``ckpt`` served by ``serve_population.main`` in f32 and under
    ``--compute-dtype bfloat16`` in turns, with the route's ``flags`` (the
    fused route; ``UNFUSED``; ``--weights-dtype int8``), each bf16 run
    counted alone: every forward the route's launches of the bf16
    instances — depth+1 on the fused route (``*_bf16``) and over the int8
    copy (``*_int8_bf16``), ``unfused_infer_launches`` on the unfused
    route (``seg_act`` f32) — nothing else; req/s and p50/p99 per mode
    beside the f32 serve's; then, on a batch, the bf16 served forward's
    logits against the same forward on the CPU (the plain versions, the
    CPU tests' slice tolerance; the int8 copy quantized on the card,
    byte-equal to the CPU's) and against the f32 forward of the same
    route and weights within JAX's policy tolerance for every member but
    the hardshrink ones: hardshrink jumps by λ = 0.5 at ±λ, so a unit
    within a bf16 rounding of it lands on the other side under the policy
    and moves its member's logits by up to λ·|w_out| (0.29 at a 3-unit
    member); their largest difference and the count beyond the tolerance
    are printed.  Returns (results, the bf16 runs' launches)."""
    import torch

    from repro_torch.checkpoint.checkpoint import restore_population
    from repro_torch.core.deep import forward
    from repro_torch.launch.launch_count import (fused_infer_kernels,
                                                 kernel_launches,
                                                 reset_kernel_launches,
                                                 unfused_infer_launches)
    from repro_torch.quant import quantize_population
    unfused = "--bd-impl" in flags
    int8 = "--weights-dtype" in flags
    budget = None if unfused else lp.depth + 1
    f32_out = serve_checkpoint(f"{name} f32", ckpt, budget, flags)
    reset_kernel_launches()
    out = serve_checkpoint(f"{name} bf16", ckpt, budget,
                           [*flags, "--compute-dtype", "bfloat16"])
    torch.cuda.synchronize()
    n = {k: v for k, v in kernel_launches().items() if v}
    if unfused:
        per = unfused_infer_launches(lp.depth, "bucketed", "bfloat16")
        forwards = n.get("seg_act", 0) // lp.depth
    else:
        per = fused_infer_kernels(lp.depth, "bfloat16",
                                  "int8" if int8 else None)
        forwards = n.get("infer_head_int8_bf16" if int8
                         else "infer_head_bf16", 0)
    _require(forwards > 0 and n == {k: v * forwards for k, v in per.items()},
             f"{name} bf16: the serving launches {n}, expected {per} a "
             "forward, bf16 instances only")
    _print_beside(name, ("f32", "bf16"), f32_out, out)
    params = restore_population(str(ckpt), device="cuda")[0]
    route = (dict(bd_impl="pallas", act_impl="pallas") if unfused
             else dict(bd_impl="fused"))
    if int8:
        params = quantize_population(params, lp)
        route["weights_dtype"] = "int8"
    with torch.inference_mode():
        f32 = forward(params, x, lp, infer=True, **route)
        bf = forward(params, x, lp, infer=True, compute_dtype="bfloat16",
                     **route)
        cpu = forward(_to(params, "cpu"), x.cpu(), lp, infer=True,
                      compute_dtype="bfloat16", **route)
    _require(bf.dtype == torch.float32, f"{name}: bf16 logits {bf.dtype}")
    err_cpu = _close(f"{name}: bf16 served logits vs the CPU's", bf, cpu,
                     BF16_FWD_TOL)
    jumps = torch.tensor(["hardshrink" in a for a in lp.activations],
                         device=bf.device)
    err = _close(f"{name}: bf16 served logits vs f32 (every member but "
                 "the hardshrink ones)", bf[:, ~jumps], f32[:, ~jumps],
                 BF16_POLICY_TOL)
    rtol, atol = BF16_POLICY_TOL
    d = (bf - f32).abs()[:, jumps]
    beyond = int((d > atol + rtol * f32[:, jumps].abs()).sum().item())
    hard = d.max().item() if d.numel() else 0.0
    print(f"[{name}] hardshrink members: bf16 logits up to {hard!r} from "
          f"f32, {beyond} of {d.numel()} beyond the policy tolerance",
          flush=True)
    return {"serve": out["serve"], "serve_f32": f32_out["serve"],
            "logits_vs_cpu_max_abs_err": err_cpu,
            "logits_vs_f32_max_abs_err": err,
            "hardshrink_logits_vs_f32_max_abs_err": hard,
            "hardshrink_logits_beyond_policy_tol": beyond,
            "forwards": forwards}, n


def _route_flags(route: dict) -> list:
    """The trainer's flags of ``deep``'s routing keywords."""
    return [a for k, v in route.items()
            for a in ("--" + k.replace("_", "-"), v)]


def _step_bf16(params, x, y, lp, **route):
    """One sgd step under the policy on ``route``, its parts kept: (per,
    grads, new params)."""
    return _step_parts(params, x, y, lp, _optimizer("sgd"),
                       compute_dtype="bfloat16", **route)


def train_bf16(name: str, workdir: Path, lp, x, y, flags: list,
               route: dict = FUSED_ROUTE, opt_name: str = "sgd") -> tuple:
    """(ii) A population trained by ``train.main`` with ``flags`` on
    ``route``, ``deep``'s routing keywords (``FUSED_ROUTE``;
    ``UNFUSED_M3``, the unfused route with the M3 head) under
    ``--compute-dtype bfloat16`` (batch 32, 16 steps in chunks of 8,
    checkpoints every 8), counted alone: each step exactly the route's
    launches (``fused_step_kernels``, 2·(depth+1)
    bf16 launches; ``unfused_step_launches``, the block-diagonal and M3
    kernels' bf16 instances and ``seg_act`` in f32) and nothing else in
    the loop (the closing leaderboard is f32); f32 masters in the
    checkpoint, the policy in its meta; the held-out loss falls; one sgd
    step on the card against the same step on the CPU (the plain
    versions) within the CPU tests' slice tolerance; the steady step of
    ``opt_name`` (wall, device ms, idle share, the cast passes apart)
    beside the f32 step of the same route, in turns.  Returns (results,
    the run's launches)."""
    import numpy as np
    import torch

    from repro_torch.checkpoint.checkpoint import load_meta
    from repro_torch.core.deep import init_params, opt_step
    from repro_torch.core.selection import evaluate_population
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.synthetic import TabularTask
    from repro_torch.launch import train as train_driver
    from repro_torch.launch.launch_count import (fused_step_kernels,
                                                 kernel_launches,
                                                 reset_kernel_launches,
                                                 unfused_step_launches)
    ckpt = workdir / f"train-{name}"
    reset_kernel_launches()
    t0 = time.perf_counter()
    params, lp, stats = train_driver.main(
        [*flags, *_route_flags(route), "--compute-dtype", "bfloat16",
         "--batch", str(BATCH), "--steps", "16", "--scan-steps", "8",
         "--ckpt-dir", str(ckpt), "--ckpt-every", "8", "--seed", "0"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = {k: v for k, v in kernel_launches().items() if v}
    seg = stats["segments"][0]
    per = (fused_step_kernels(lp.depth, "bfloat16")
           if route["bd_impl"] == "fused" else
           unfused_step_launches(lp.depth, route.get("m3_impl", "bucketed"),
                                 "bfloat16"))
    want = {k: 16 * v for k, v in per.items()}
    _require(stats["steps"] == 16 and seg["launches"] == want,
             f"{name}: the training loop launched {seg['launches']}, "
             f"expected {want}")
    meta, step = load_meta(str(ckpt))
    _require(step == 15 and meta["train"]["compute_dtype"] == "bfloat16",
             f"{name}: checkpoint step {step}, meta {meta['train']}")
    with np.load(ckpt / "step_00000015" / "arrays.npz") as z:
        kinds = {str(z[k].dtype) for k in z.files if k.startswith("params/")}
    _require(kinds == {"float32"}, f"{name}: checkpointed masters {kinds}")
    _require(all(p.dtype == torch.float32 for p in tree_leaves(params)),
             f"{name}: live masters not f32")
    (_, _), (xte, yte) = TabularTask(2048, lp.in_features,
                                     n_classes=lp.out_features,
                                     seed=0).split()
    init = init_params(torch.Generator(device="cuda").manual_seed(0), lp)
    before, after = (evaluate_population(p, lp, xte, yte, bd_impl="fused",
                                         infer=True)[0]
                     for p in (init, params))
    del init
    _require(bool(torch.isfinite(after).all())
             and after.mean().item() < before.mean().item(),
             f"{name}: held-out mean member loss {before.mean().item()} -> "
             f"{after.mean().item()}")
    res = {"stats": stats, "wall_s": wall,
           "heldout_loss": [before.mean().item(), after.mean().item()]}
    print(f"[{name}] trained in {wall:.1f} s: held-out mean loss "
          f"{res['heldout_loss']!r}; kernel launches {n}", flush=True)

    # one step on the card against the CPU's plain versions
    card = _step_bf16(params, x, y, lp, **route)
    cpu = _step_bf16(_to(params, "cpu"), x.cpu(), y.cpu(), lp, **route)
    res["step_vs_cpu_max_abs_err"] = [
        _close(f"{name} bf16 step vs CPU: {what}", a, b, tol)
        for what, a, b, tol in zip(("losses", "grads", "params"), card, cpu,
                                   (BF16_FWD_TOL, BF16_GRAD_TOL,
                                    BF16_GRAD_TOL))]
    del card, cpu
    # the steady step, f32 and bf16 in turns, from one state; the cast
    # passes (dtype-converting copies: the masters to bf16, the bf16
    # gradients back to f32) apart
    opt = _optimizer(opt_name)
    state = opt.init(params)
    clip = None if opt_name == "sgd" else 1.0
    steps = {}
    for key, cd in (("f32", None), ("bf16", "bfloat16"),
                    ("bf16 (2)", "bfloat16"), ("f32 (2)", None)):
        step = partial(opt_step, params, state, x, y, 1e-2, opt, lp,
                       compute_dtype=cd, grad_clip=clip, **route)
        steps[key] = time_step(f"{name} step {key}", step)
        by = steps[key]["device_ms_by_kernel"]
        steps[key]["other_device_ms"] = sum(
            v for k, v in by.items() if k.startswith("other: "))
        steps[key]["cast_device_ms"] = _named_device_ms(step,
                                                        "direct_copy")
    res["steps"] = steps
    print(f"[{name}] steady step wall / device ms / non-population "
          "kernels / casts: " + "; ".join(
              f"{k} {v['step_wall_ms']!r} / {v['device_ms']!r} / "
              f"{v['other_device_ms']!r} / {v['cast_device_ms']!r}"
              for k, v in steps.items()), flush=True)
    return res, n


def _named_device_ms(fn, word: str, iters: int = 3) -> float:
    """The device time a call of ``fn`` spends in kernels whose name holds
    ``word``, over ``iters`` profiled calls (``torch.profiler``)."""
    import torch
    with _counted_window(word) as prof:
        for _ in range(iters):
            fn()
    return sum(e.device_time_total for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and word in e.name) / iters / 1e3


def depth3_bf16_publish(name: str, workdir: Path) -> tuple:
    """(iii) The depth-3 population under ``--optimizer adamw --grad-clip
    1.0 --compute-dtype bfloat16 --halving "8:0.5" --serve-publish``,
    counted alone: each segment 2·(depth+1) bf16 launches a step; a
    ``published:`` set at the rung and at the end; the last equals a fresh
    f32 ``PopulationServer``'s on the final checkpoint.  Returns (results,
    the run's launches)."""
    import torch

    from repro_torch.data.synthetic import TabularTask
    from repro_torch.launch import train as train_driver
    from repro_torch.launch.launch_count import (fused_step_kernels,
                                                 kernel_launches,
                                                 reset_kernel_launches)
    from repro_torch.launch.serve_population import PopulationServer
    ckpt = workdir / f"train-{name}"
    reset_kernel_launches()
    params, lp, stats = train_driver.main(
        ["--bd-impl", "fused", "--batch", str(BATCH), "--steps", "16",
         "--scan-steps", "8", "--ckpt-dir", str(ckpt), "--ckpt-every", "8",
         "--seed", "0", *depth3_flags()[:-2], "--compute-dtype", "bfloat16",
         "--halving", "8:0.5", "--serve-publish"])
    torch.cuda.synchronize()
    n = {k: v for k, v in kernel_launches().items() if v}
    for seg in stats["segments"]:
        want = {k: (seg["end"] - seg["start"]) * v for k, v in
                fused_step_kernels(seg["depth"], "bfloat16").items()}
        _require(seg["launches"] == want, f"{name}: segment "
                 f"{seg['start']}-{seg['end']} launched {seg['launches']}, "
                 f"expected {want}")
    pub = stats.get("published", [])
    _require([p["step"] for p in pub] == [7, 15],
             f"{name}: published at {pub}")
    (_, _), (xte, yte) = TabularTask(2048, lp.in_features,
                                     n_classes=lp.out_features,
                                     seed=0).split()
    fresh, _ = PopulationServer.from_checkpoint(
        str(ckpt), device="cuda", bd_impl="fused", act_impl="sliced",
        batch=BATCH, topk=min(4, lp.num_real))
    fresh.publish(xte, yte)
    same = (fresh.published["best1"] == pub[-1]["best1"]
            and fresh.published["topk"] == pub[-1]["topk"])
    _require(same, f"{name}: the last published set {pub[-1]} is not a "
             f"fresh server's {fresh.published}")
    print(f"[{name}] {lp.num_real} members after the rung; published "
          f"{pub}; a fresh server on the final checkpoint publishes the "
          "same set", flush=True)
    return {"published": pub, "members": lp.num_real,
            "segments": stats["segments"]}, n


def _bf16_fields(prefix, kernel, plain, library, n_bytes, flops, iters,
                 word, f32_out=(), label="", f64=None):
    """One bf16 instance against its plain version on the same bf16
    inputs, with ``prefix``-named fields: the largest distance of its bf16
    outputs from the plain version's in bf16 ulps (must be ≤ 1; also over
    the elements more than the f32 atol apart), the carve-out held to the
    f64 sums ``f64()`` gives (one (exact, bound) a bf16 output:
    ``_excused_vs_f64``, none may be beyond the f32 sum's bound), its f32
    outputs (indices ``f32_out``) within the f32 tolerance, two launches
    bitwise equal, the time (CUDA events) and device time
    (``torch.profiler``, kernels named ``word``), the plain version's and
    the library call's time (or why there is none) and the bound (bf16
    bytes; the work over the bf16 tensor-core peak, the int8 twins' too:
    an int8 weight is exact in bf16, and its scale factors out of the
    sum)."""
    import torch
    got, want, again = kernel(), plain(), kernel()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    again = again if isinstance(again, tuple) else (again,)
    torch.cuda.synchronize()
    ulps, ulps_far, err = 0, 0, 0.0
    refs = iter(f64()) if f64 else None
    carve = {}
    for i, (a, b) in enumerate(zip(got, want)):
        if i in f32_out:
            err = max(err, _close(f"{label}: f32 output {i} vs plain", a, b))
        else:
            ulps = max(ulps, bf16_ulps(a, b))
            ulps_far = max(ulps_far, bf16_ulps(a, b, ATOL))
            if refs is not None:
                exact, bnd = next(refs)
                for k, v in _excused_vs_f64(a, b, exact, bnd).items():
                    carve[k] = max(carve.get(k, 0), v) \
                        if k == "max_ulps_at_excused" else \
                        carve.get(k, 0) + v
                del exact, bnd
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    del got, want, again, refs
    bound, by = _bound_ms(n_bytes, flops, BF16_FLOP_PER_S)
    lib_ms, lib_none = None, None
    if isinstance(library, str):
        lib_none = library
    else:
        try:
            lib_ms = _time_ms(library, iters)
        except (RuntimeError, NotImplementedError) as e:
            lib_none = f"the library call fails on bf16: {str(e)[:160]}"
    out = {prefix + "max_ulps": ulps,
           prefix + "max_ulps_beyond_f32_atol": ulps_far,
           prefix + "bitwise_repeat": bitwise,
           prefix + "ms": _time_ms(kernel, iters),
           prefix + "device_ms": _device_ms(kernel, word, iters),
           prefix + "plain_ms": _time_ms(plain, iters),
           prefix + "library_ms": lib_ms,
           prefix + "bound_ms": bound, prefix + "bound_by": by}
    if f32_out:
        out[prefix + "max_abs_err"] = err
    if lib_none:
        out[prefix + "library_none"] = lib_none
    out.update({prefix + "f64_" + k: v for k, v in carve.items()})
    print(f"[{label}] {out}", flush=True)
    _require(ulps_far <= 1 and bitwise, f"{label}: {ulps_far} bf16 ulps "
             f"from the plain version (strictly {ulps}), bitwise repeat "
             f"{bitwise}")
    _require(carve.get("beyond_f32_bound", 0) == 0,
             f"{label}: {carve}: the kernel strays from the f64 sum beyond "
             "an f32 sum's error")
    return out


def _sum_fields(rows: list) -> dict:
    """Fields of a kernel launched once per mid layer: times, bounds and
    counts summed, the worst distance, every run bitwise."""
    out = dict(rows[0])
    for key in out:
        vals = [r[key] for r in rows]
        if key.endswith("_ms") and all(v is not None for v in vals):
            out[key] = sum(vals)
        elif key.endswith("ulps") or key.endswith("atol") \
                or key.endswith("at_excused") and "max_" in key:
            out[key] = max(vals)
        elif "_f64_" in key:
            out[key] = sum(vals)
        elif key.endswith("bitwise_repeat"):
            out[key] = all(vals)
    return out


def seg_act_bf16_fields(lp3k) -> dict:
    """Rows 16–17's bf16 instances at the depth-3 population's unfused
    shapes, path 4i's (B 32, block 8, each layer's hidden width,
    activation ids and mask), on seeded bf16 pre-activations and
    cotangents: first ``ops.seg_act`` forward and backward on each
    layer's bf16 h — the kernel API's entry, which no population path
    calls on bf16 (the policy hands it f32) — the counters set to 0 just
    before and read just after (``bf16_launches``: one of each instance a
    layer, nothing else); then each layer's kernel against its plain
    version (``_bf16_fields``), summed over the layers.  Returns {row:
    fields}."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import seg_act as sak
    from repro_torch.launch.launch_count import (kernel_launches,
                                                 reset_kernel_launches)
    gen = torch.Generator(device="cuda").manual_seed(16)
    blk = lp3k.block
    layers = []
    for l in range(lp3k.depth):
        pop = lp3k.layer_pop(l)
        ids = torch.as_tensor(pop.block_act_ids, dtype=torch.int32,
                              device="cuda")
        mask = torch.as_tensor(pop.hidden_mask, dtype=torch.float32,
                               device="cuda")
        h, dy = (torch.randn(BATCH, pop.total_hidden, generator=gen,
                             device="cuda").to(torch.bfloat16)
                 for _ in range(2))
        layers.append((h, dy, ids, mask))
    torch.cuda.synchronize()
    reset_kernel_launches()
    for h, dy, ids, mask in layers:
        hg = h.clone().requires_grad_(True)
        y = ops.seg_act(hg, ids, mask, block=blk)
        (dh,) = torch.autograd.grad(y, (hg,), dy)
        _require(y.dtype == dh.dtype == torch.bfloat16,
                 f"ops.seg_act on bf16 h gave {y.dtype}, {dh.dtype}")
    torch.cuda.synchronize()
    n = {k: v for k, v in kernel_launches().items() if v}
    want = {"seg_act_bf16": lp3k.depth, "seg_act_bwd_bf16": lp3k.depth}
    _require(n == want, f"ops.seg_act on bf16: launches {n}, expected "
             f"{want}")
    no_call = ("no single PyTorch call applies a different activation to "
               "each block of columns")
    fwd, bwd = [], []
    for l, (h, dy, ids, mask) in enumerate(layers):
        y = sak.seg_act_cuda(h, ids, mask, blk=blk)
        fwd.append(_bf16_fields(
            "bf16_", partial(sak.seg_act_cuda, h, ids, mask, blk=blk),
            partial(sak.seg_act_plain, h, ids, mask, blk=blk), no_call,
            _nbytes(h, ids, mask, y), 2 * h.numel(), 20,
            "seg_act_bf16_fwd_kernel", label=f"seg_act bf16 at layer {l}"))
        bwd.append(_bf16_fields(
            "bf16_", partial(sak.seg_act_bwd_cuda, h, dy, ids, mask,
                             blk=blk),
            partial(sak.seg_act_bwd_plain, h, dy, ids, mask, blk=blk),
            no_call, _nbytes(h, dy, ids, mask, y), 3 * h.numel(), 20,
            "seg_act_bf16_bwd_kernel",
            label=f"seg_act_bwd bf16 at layer {l}"))
    out = {"seg_act": _sum_fields(fwd), "seg_act_bwd": _sum_fields(bwd)}
    widths = [lp3k.layer_pop(l).total_hidden for l in range(lp3k.depth)]
    for row, key in (("seg_act", "seg_act_bf16"),
                     ("seg_act_bwd", "seg_act_bwd_bf16")):
        out[row].update(bf16_launches=n[key], bf16_hidden=widths,
                        bf16_path=["vec4" if w % 4 == 0 else "scalar"
                                   for w in widths])
    return out


def bf16_kernel_fields(p10k, lp10k, p3k, lp3k) -> dict:
    """(iv) The bf16 instances of rows 1, 3, 4, 6, 7, 9 and 10 at the main
    paths' shapes (``parallelmlp-10k`` B 32 for the input layer and the
    heads, the depth-3 population's two mid layers summed), each fed as on
    the path: ``bf16_*`` fields of their rows (``_bf16_fields``).  The
    library calls take bf16 operands where the f32 row's call has them:
    addmm, mm, baddbmm, bmm and the BSR matmul."""
    import torch

    from repro_torch.core.activations import apply_activations_sliced
    from repro_torch.core.deep import pack_weight_tiles
    from repro_torch.kernels import block_diag as bdk
    from repro_torch.kernels import fused_input as fik
    from repro_torch.kernels import fused_layer as flk
    from repro_torch.kernels import infer_head as ihk
    from repro_torch.kernels import loss_head as lhk
    bf = torch.bfloat16
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(17)
    rows = {}
    n_b = BATCH * 2   # a bf16 row of the batch

    # row 1 (and its training launch) at full width
    p0 = lp10k.layer_pop(0)
    blk = lp10k.block
    x = torch.randn(BATCH, lp10k.in_features, generator=gen,
                    device=dev).to(bf)
    w, b = p10k["w_in"].to(bf), p10k["b_in"]
    ids = torch.as_tensor(p0.block_act_ids, dtype=torch.int32, device=dev)
    mask = torch.as_tensor(p0.hidden_mask, dtype=torch.float32, device=dev)
    fin = (x, w, b, mask, ids)
    h, g = fik.fused_input_train_cuda(*fin, block=blk)
    flops = 2 * BATCH * w.shape[0] * w.shape[1]
    _require(fik.fwd_path(x, w, h, g) == "vec4",
             "fused_input bf16: not the vec4 instance at F = 100")
    b16 = b.to(bf)

    def library_input():
        z = torch.addmm(b16, x, w.t())
        return apply_activations_sliced(z, p0.act_runs) * mask

    def input_f64(train):
        exact = fik.fused_input_train_plain(x.double(), w.double(), *fin[2:],
                                            block=blk)
        return [(e, _act_bound(lambda a, c: a @ c.t(), x, w, b, e))
                for e in exact[:2 if train else 1]]

    rows["fused_input"] = _bf16_fields(
        "bf16_", partial(fik.fused_input_cuda, *fin, block=blk),
        partial(fik.fused_input_plain, *fin, block=blk), library_input,
        _nbytes(*fin, h), flops, 20, "fused_input_kernel<4, __nv_bfloat16",
        label="fused_input bf16", f64=partial(input_f64, False))
    rows["fused_input"].update(_bf16_fields(
        "bf16_train_", partial(fik.fused_input_train_cuda, *fin, block=blk),
        partial(fik.fused_input_train_plain, *fin, block=blk),
        "the f32 row's library call has no g'", _nbytes(*fin, h, g), flops,
        20, "fused_input_kernel<4, __nv_bfloat16",
        label="fused_input bf16 with g'", f64=partial(input_f64, True)))
    rows["fused_input"]["bf16_path"] = "vec4"

    # row 3, as on the path (no dx)
    dy = (torch.randn(h.shape, generator=gen, device=dev) * 1e-3).to(bf)
    bwd = (dy, g, x, w)
    dw = fik.fused_input_bwd_cuda(*bwd, with_dx=False)[1]
    du = dy * g
    rows["fused_input_bwd"] = _bf16_fields(
        "bf16_", lambda: fik.fused_input_bwd_cuda(*bwd, with_dx=False)[1],
        lambda: fik.fused_input_bwd_plain(*bwd, with_dx=False)[1],
        lambda: torch.mm(du.t(), x), _nbytes(dy, g, x, dw), flops, 10,
        "fused_input_bwd_bf16_kernel", label="fused_input_bwd bf16",
        f64=lambda: [_sum_bound(lambda a, c: a.t() @ c, du, x)])
    rows["fused_input_bwd"]["bf16_path"] = fik.bwd_path(dy, g, x, dw)
    del dw, du, bwd, dy

    # rows 7, 9, 10 at full width on the layer-0 activations
    w2, b2 = p10k["w_out"].to(bf), p10k["b_out"]
    seg = torch.as_tensor(p0.block_segment_ids, dtype=torch.int32,
                          device=dev)
    ptr = ihk.member_ptr(seg, lp10k.num_members)
    n_mem = lp10k.num_members
    width = p0.total_hidden // n_mem
    hb = h.view(BATCH, n_mem, width).transpose(0, 1)
    wb2 = w2.view(w2.shape[0], n_mem, width).permute(1, 2, 0)
    b2b = b2.to(bf)[:, None, :]
    y = ihk.infer_head_cuda(h, w2, b2, ptr, block=blk)
    hflops = 2 * BATCH * h.shape[1] * w2.shape[0]
    rows["infer_head"] = _bf16_fields(
        "bf16_", lambda: ihk.infer_head_cuda(h, w2, b2, ptr, block=blk),
        lambda: ihk.infer_head_plain(h, w2, b2, ptr, block=blk),
        lambda: torch.baddbmm(b2b, hb, wb2), _nbytes(h, w2, b2, ptr, y),
        hflops, 20, "infer_head_bf16_kernel", f32_out=(0,),
        label="infer_head bf16")
    rows["infer_head"].update(_bf16_fields(
        "bf16_log_probs_",
        lambda: ihk.infer_head_cuda(h, w2, b2, ptr, block=blk,
                                    log_probs=True),
        lambda: ihk.infer_head_plain(h, w2, b2, ptr, block=blk,
                                     log_probs=True),
        "no one PyTorch call adds the bias and the log-softmax",
        _nbytes(h, w2, b2, ptr, y), hflops, 20, "infer_head_bf16_kernel",
        f32_out=(0,), label="infer_head bf16 log_probs"))
    tgt = torch.randint(0, lp10k.out_features, (BATCH,), generator=gen,
                        device=dev, dtype=torch.int32)
    lh = (h, w2, b2, tgt, ptr)
    per, dl = lhk.loss_head_fwd_cuda(*lh, block=blk, b_real=BATCH)
    rows["loss_head_fwd"] = _bf16_fields(
        "bf16_", partial(lhk.loss_head_fwd_cuda, *lh, block=blk,
                         b_real=BATCH),
        partial(lhk.loss_head_fwd_plain, *lh, block=blk, b_real=BATCH),
        lambda: torch.baddbmm(b2b, hb, wb2), _nbytes(*lh, per, dl), hflops,
        20, "loss_head_fwd_bf16_kernel", f32_out=(0, 1),
        label="loss_head_fwd bf16")
    dper = torch.ones(n_mem, device=dev)
    lb = (dper, dl, h, w2, seg)
    dh, dw2 = lhk.loss_head_bwd_cuda(*lb, block=blk)
    dlm = dl.transpose(0, 1).to(bf)                      # (P, B, O)
    wm = w2.view(w2.shape[0], n_mem, width).permute(1, 0, 2)
    gl = (dl * dper[None, :, None]).to(bf)   # dl·d_per, as the kernel rounds
    one = torch.ones(n_mem, device=dev, dtype=torch.float64)
    rows["loss_head_bwd"] = _bf16_fields(
        "bf16_", partial(lhk.loss_head_bwd_cuda, *lb, block=blk),
        partial(lhk.loss_head_bwd_plain, *lb, block=blk),
        lambda: torch.bmm(dlm, wm), _nbytes(*lb, dh, dw2), 2 * hflops, 20,
        "loss_head_bwd_bf16_kernel", label="loss_head_bwd bf16",
        f64=lambda: [
            _sum_bound(lambda a, c: lhk.loss_head_bwd_plain(
                one, a, h.double(), c, seg, block=blk)[0], gl, w2),
            _sum_bound(lambda a, c: lhk.loss_head_bwd_plain(
                one, a, c, w2.double(), seg, block=blk)[1], gl, h)])
    for key in ("infer_head", "loss_head_fwd", "loss_head_bwd"):
        rows[key]["bf16_path"] = ihk.kernel_path(blk, h, w2)
    del h, g, dl, dh, dw2, hb, wb2, dlm, wm, x, w, w2, gl

    # rows 4 and 6 at the depth-3 population's mid layers, each fed by the
    # layer before it
    q0 = lp3k.layer_pop(0)
    x3 = torch.randn(BATCH, lp3k.in_features, generator=gen,
                     device=dev).to(bf)
    hin = fik.fused_input_cuda(
        x3, p3k["w_in"].to(bf), p3k["b_in"],
        torch.as_tensor(q0.hidden_mask, dtype=torch.float32, device=dev),
        torch.as_tensor(q0.block_act_ids, dtype=torch.int32, device=dev),
        block=lp3k.block)
    fwd, bwd_rows = [], []
    for l in range(lp3k.depth - 1):
        lay = lp3k.bd_layout(l)
        pout = lp3k.layer_pop(l + 1)
        b3 = lay.block
        wb = torch.cat([pack_weight_tiles(p3k["mid"][l]["w"], lp3k, l),
                        torch.eye(b3, device=dev)[None]]).to(bf)
        b_eff = p3k["mid"][l]["b"] * torch.as_tensor(
            lp3k.active_unit_mask(l + 1), dtype=torch.float32, device=dev)
        m3 = torch.as_tensor(pout.hidden_mask, dtype=torch.float32,
                             device=dev)
        a3 = torch.as_tensor(pout.block_act_ids, dtype=torch.int32,
                             device=dev)
        sched = flk.schedule_on(lay, dev)
        args = (hin, wb, b_eff, m3, a3, *sched)
        out, g3 = flk.fused_layer_train_cuda(*args, blk=b3)
        bsr = torch.sparse_bsr_tensor(
            sched[0], sched[1], wb[sched[2].long()],
            size=(lay.n_out_tiles * b3, lay.n_in_tiles * b3),
            check_invariants=True)
        flops = 2 * BATCH * b3 * b3 * lay.n_steps

        def layer_f64(train, hin=hin, wb=wb, args=args, sched=sched, b3=b3,
                      b_eff=b_eff):
            exact = flk.fused_layer_train_plain(hin.double(), wb.double(),
                                                *args[2:], blk=b3)
            return [(e, _act_bound(lambda a, c: bdk.block_diag_fwd_plain(
                a, c, *sched, blk=b3), hin, wb, b_eff, e))
                for e in exact[:2 if train else 1]]

        row = _bf16_fields(
            "bf16_", partial(flk.fused_layer_cuda, *args, blk=b3),
            partial(flk.fused_layer_plain, *args, blk=b3),
            partial(torch.matmul, bsr, hin.t()), _nbytes(*args, out), flops,
            50, "fused_layer_bf16_group_kernel",
            label=f"fused_layer bf16 mid layer {l}",
            f64=partial(layer_f64, False))
        row.update(_bf16_fields(
            "bf16_train_", partial(flk.fused_layer_train_cuda, *args, blk=b3),
            partial(flk.fused_layer_train_plain, *args, blk=b3),
            "the f32 row's library call has no bias, activation or g'",
            _nbytes(*args, out, g3), flops, 50,
            "fused_layer_bf16_group_kernel",
            label=f"fused_layer bf16 with g' mid layer {l}",
            f64=partial(layer_f64, True)))
        fwd.append(row)
        rowptr_t, s_in_t, s_w_t, perm_t, _, _ = flk.schedule_on(
            lay, dev, transposed=True)
        wb_t = flk.transposed_tiles(wb, perm_t)
        dy3 = torch.randn(out.shape, generator=gen, device=dev).to(bf)
        bargs = (dy3, g3, hin, wb[:-1], *flk.dx_dw_schedule_on(lay, dev))
        dx3, dwb3 = flk.fused_layer_dx_dw_cuda(*bargs, blk=b3)
        bsr_t = torch.sparse_bsr_tensor(
            rowptr_t, s_in_t, wb_t[s_w_t.long()],
            size=(lay.n_in_tiles * b3, lay.n_out_tiles * b3),
            check_invariants=True)
        du3 = dy3 * g3   # rounded to bf16 once, as the kernel forms it

        def dx_dw_f64(du3=du3, hin=hin, wb=wb, units=bargs[4:], b3=b3):
            one = torch.ones_like(du3, dtype=torch.float64)
            return [
                _sum_bound(lambda a, c: flk.fused_layer_dx_dw_plain(
                    a, one, hin.double(), c, *units, blk=b3)[0], du3,
                    wb[:-1]),
                _sum_bound(lambda a, c: flk.fused_layer_dx_dw_plain(
                    a, one, c, wb[:-1].double(), *units, blk=b3)[1], du3,
                    hin)]

        bwd_rows.append(_bf16_fields(
            "bf16_", partial(flk.fused_layer_dx_dw_cuda, *bargs, blk=b3),
            partial(flk.fused_layer_dx_dw_plain, *bargs, blk=b3),
            partial(torch.matmul, bsr_t, du3.t()),
            _nbytes(*bargs, dx3, dwb3), 4 * BATCH * b3 * b3
            * lay.n_param_blocks, 50, "fused_layer_dx_dw_bf16_kernel",
            label=f"fused_layer_dx_dw bf16 mid layer {l}", f64=dx_dw_f64))
        hin = out
    rows["fused_layer"] = _sum_fields(fwd)
    rows["fused_layer_dx_dw"] = _sum_fields(bwd_rows)
    for key in ("fused_layer", "fused_layer_dx_dw"):
        rows[key]["bf16_summed_over"] = "the depth-3 population's 2 mid layers"
    return rows


def bf16_route_kernel_fields(p10k, lp10k, p3k, lp3k) -> dict:
    """(vii) The bf16 instances of rows 2, 8 and 13–15 at
    ``parallelmlp-10k``'s full width (B 32) and of rows 5, 11 (and its dh
    pass) and 12 at the depth-3 population's two mid layers (summed), each
    fed as on its path (the int8 rows on the int8 copy
    ``quantize_population`` makes of the checkpoint, each layer fed the
    bf16 output of the one before it): ``bf16_*`` fields of their rows
    (``_bf16_fields``, the carve-out held to the f64 sums).  The library
    calls: for row 11 the bf16 BSR matmul (its dh the transposed one), for
    row 12 a bf16 ``bmm`` on tiles gathered beforehand, for rows 13–15 the
    bucketed bf16 ``einsum``s, for rows 2, 5, 8 the f32 row's call on the
    dequantized weight in bf16."""
    import torch

    from repro_torch.core.activations import apply_activations_sliced
    from repro_torch.core.deep import pack_weight_tiles
    from repro_torch.kernels import block_diag as bdk
    from repro_torch.kernels import fused_input as fik
    from repro_torch.kernels import fused_layer as flk
    from repro_torch.kernels import infer_head as ihk
    from repro_torch.kernels import m3_matmul as m3k
    from repro_torch.quant import quantize_population
    bf = torch.bfloat16
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(19)
    rows = {}

    # row 2 at full width, then row 8 on its output
    q10k = quantize_population(p10k, lp10k)
    p0 = lp10k.layer_pop(0)
    blk = lp10k.block
    f = lp10k.in_features
    x = torch.randn(BATCH, f, generator=gen, device=dev).to(bf)
    ids = torch.as_tensor(p0.block_act_ids, dtype=torch.int32, device=dev)
    mask = torch.as_tensor(p0.hidden_mask, dtype=torch.float32, device=dev)
    fin8 = (x, q10k["w_in"], q10k["w_in_scale"], q10k["b_in"], mask, ids)
    h = fik.fused_input_int8_cuda(*fin8, block=blk)
    w_dq = q10k["w_in"][:, :f].float() \
        * q10k["w_in_scale"].repeat_interleave(blk)[:, None]
    w16, b16 = w_dq.to(bf), q10k["b_in"].to(bf)

    def library_input():
        z = torch.addmm(b16, x, w16.t())
        return apply_activations_sliced(z, p0.act_runs) * mask

    def input_f64():
        exact = fik.fused_input_plain(x.double(), w_dq.double(), *fin8[3:],
                                      block=blk)
        return [(exact, _act_bound(lambda a, c: a @ c.t(), x, w_dq,
                                   q10k["b_in"], exact))]

    rows["fused_input_int8"] = _bf16_fields(
        "bf16_", partial(fik.fused_input_int8_cuda, *fin8, block=blk),
        partial(fik.fused_input_int8_plain, *fin8, block=blk),
        library_input, _nbytes(*fin8, h), 2 * BATCH * w_dq.shape[0] * f, 20,
        "fused_input_i8_bf16_kernel", label="fused_input_int8 bf16",
        f64=input_f64)
    rows["fused_input_int8"]["bf16_path"] = fik.fwd_path(x, q10k["w_in"], h)
    del w_dq, w16, b16

    seg = torch.as_tensor(p0.block_segment_ids, dtype=torch.int32,
                          device=dev)
    ptr = ihk.member_ptr(seg, lp10k.num_members)
    n_mem = lp10k.num_members
    width = p0.total_hidden // n_mem
    head8 = (h, q10k["w_out"], q10k["w_out_scale"], q10k["b_out"], ptr)
    y8 = ihk.infer_head_int8_cuda(*head8, block=blk)
    w2dq16 = (q10k["w_out"].float() * q10k["w_out_scale"].repeat_interleave(
        blk)[None, :]).to(bf)
    hb = h.view(BATCH, n_mem, width).transpose(0, 1)
    wb2 = w2dq16.view(w2dq16.shape[0], n_mem, width).permute(1, 2, 0)
    b2b = q10k["b_out"].to(bf)[:, None, :]
    hflops = 2 * BATCH * h.shape[1] * w2dq16.shape[0]
    rows["infer_head_int8"] = _bf16_fields(
        "bf16_", partial(ihk.infer_head_int8_cuda, *head8, block=blk),
        partial(ihk.infer_head_int8_plain, *head8, block=blk),
        lambda: torch.baddbmm(b2b, hb, wb2), _nbytes(*head8, y8), hflops, 20,
        "infer_head_i8_bf16_kernel", f32_out=(0,),
        label="infer_head_int8 bf16")
    rows["infer_head_int8"]["bf16_path"] = ihk.kernel_path(
        blk, h, q10k["w_out"])
    del q10k, head8, y8, w2dq16, hb, wb2, b2b

    # rows 13-15 at full width: h the layer-0 output, bf16 dy
    w2 = p10k["w_out"].to(bf)
    o = w2.shape[0]
    dy = (torch.randn(BATCH, n_mem, o, generator=gen, device=dev)
          * 1e-2).to(bf)
    y = m3k.m3_matmul_fwd_cuda(h, w2, ptr, block=blk)
    dh = m3k.m3_matmul_dh_cuda(dy, w2, seg, block=blk)
    dw2 = m3k.m3_matmul_dw_cuda(dy, h, seg, block=blk)
    hb = h.view(BATCH, n_mem, width)
    wb = w2.view(o, n_mem, width)
    for name, kernel, plain, ops_, lib, out, word in (
            ("m3_matmul_fwd", partial(m3k.m3_matmul_fwd_cuda, block=blk),
             lambda a, c: m3k.m3_matmul_fwd_plain(a, c, ptr, block=blk),
             (h, w2, ptr), lambda: torch.einsum("bnh,onh->bno", hb, wb), y,
             "m3_fwd_bf16_stream_kernel"),
            ("m3_matmul_dh", partial(m3k.m3_matmul_dh_cuda, block=blk),
             lambda a, c: m3k.m3_matmul_dh_plain(a, c, seg, block=blk),
             (dy, w2, seg), lambda: torch.einsum("bno,onh->bnh", dy, wb), dh,
             "m3_dh_bf16_kernel"),
            ("m3_matmul_dw", partial(m3k.m3_matmul_dw_cuda, block=blk),
             lambda a, c: m3k.m3_matmul_dw_plain(a, c, seg, block=blk),
             (dy, h, seg), lambda: torch.einsum("bnh,bno->onh", hb, dy), dw2,
             "m3_dw_bf16_stream_kernel")):
        rows[name] = _bf16_fields(
            "bf16_", partial(kernel, *ops_),
            partial(plain, *ops_[:2]), lib, _nbytes(*ops_, out), hflops, 20,
            word, label=f"{name} bf16",
            f64=lambda plain=plain, ops_=ops_: [_sum_bound(plain, *ops_[:2])])
    rows["m3_matmul_fwd"]["bf16_path"] = ihk.kernel_path(blk, h, w2)
    rows["m3_matmul_dh"]["bf16_path"] = ihk.kernel_path(blk, w2, dh)
    rows["m3_matmul_dw"]["bf16_path"] = ihk.kernel_path(blk, h, dw2)
    del h, w2, dy, y, dh, dw2, hb, wb, x

    # rows 5, 11 (and dh), 12 at the depth-3 population's mid layers
    q3k = quantize_population(p3k, lp3k)
    q0 = lp3k.layer_pop(0)
    x3 = torch.randn(BATCH, lp3k.in_features, generator=gen,
                     device=dev).to(bf)
    hin = fik.fused_input_int8_cuda(
        x3, q3k["w_in"], q3k["w_in_scale"], q3k["b_in"],
        torch.as_tensor(q0.hidden_mask, dtype=torch.float32, device=dev),
        torch.as_tensor(q0.block_act_ids, dtype=torch.int32, device=dev),
        block=lp3k.block)
    int8_rows, fwd_rows, dh_rows, dw_rows = [], [], [], []
    for l in range(lp3k.depth - 1):
        lay = lp3k.bd_layout(l)
        pout = lp3k.layer_pop(l + 1)
        b3 = lay.block
        qm = q3k["mid"][l]
        b_eff = qm["b"] * torch.as_tensor(lp3k.active_unit_mask(l + 1),
                                          dtype=torch.float32, device=dev)
        m3 = torch.as_tensor(pout.hidden_mask, dtype=torch.float32,
                             device=dev)
        a3 = torch.as_tensor(pout.block_act_ids, dtype=torch.int32,
                             device=dev)
        sched = flk.schedule_on(lay, dev)
        args8 = (hin, qm["wb"], qm["scale"], b_eff, m3, a3, *sched)
        out = flk.fused_layer_int8_cuda(*args8, blk=b3)
        wdq = qm["wb"].float() * qm["scale"][:, None, None]
        flops = 2 * BATCH * b3 * b3 * lay.n_steps
        size = (lay.n_out_tiles * b3, lay.n_in_tiles * b3)
        bsr8 = torch.sparse_bsr_tensor(sched[0], sched[1],
                                       wdq.to(bf)[sched[2].long()],
                                       size=size, check_invariants=True)

        def int8_f64(hin=hin, wdq=wdq, args8=args8, sched=sched, b3=b3,
                     b_eff=b_eff):
            exact = flk.fused_layer_plain(hin.double(), wdq.double(),
                                          *args8[3:], blk=b3)
            return [(exact, _act_bound(lambda a, c: bdk.block_diag_fwd_plain(
                a, c, *sched, blk=b3), hin, wdq, b_eff, exact))]

        int8_rows.append(_bf16_fields(
            "bf16_", partial(flk.fused_layer_int8_cuda, *args8, blk=b3),
            partial(flk.fused_layer_int8_plain, *args8, blk=b3),
            partial(torch.matmul, bsr8, hin.t()), _nbytes(*args8, out),
            flops, 50, "fused_layer_i8_bf16_group_kernel",
            label=f"fused_layer_int8 bf16 mid layer {l}", f64=int8_f64))
        int8_rows[-1]["bf16_path"] = bdk.fwd_path(hin, qm["wb"], out)
        # rows 11, 12: the bare projection of the same bf16 input through
        # the master tiles in bf16, its dh pass and dW on a bf16 dy
        wb = torch.cat([pack_weight_tiles(p3k["mid"][l]["w"], lp3k, l),
                        torch.eye(b3, device=dev)[None]]).to(bf)
        bd = (hin, wb, *sched)
        yb = bdk.block_diag_fwd_cuda(*bd, blk=b3)
        bsr = torch.sparse_bsr_tensor(sched[0], sched[1],
                                      wb[sched[2].long()], size=size,
                                      check_invariants=True)
        lin = partial(bdk.block_diag_fwd_plain, rowptr=sched[0],
                      s_in=sched[1], s_w=sched[2], blk=b3)
        fwd_rows.append(_bf16_fields(
            "bf16_", partial(bdk.block_diag_fwd_cuda, *bd, blk=b3),
            partial(bdk.block_diag_fwd_plain, *bd, blk=b3),
            partial(torch.matmul, bsr, hin.t()), _nbytes(*bd, yb), flops, 50,
            "block_diag_bf16_group_kernel",
            label=f"block_diag_fwd bf16 mid layer {l}",
            f64=lambda lin=lin, hin=hin, wb=wb: [_sum_bound(lin, hin, wb)]))
        fwd_rows[-1]["bf16_path"] = bdk.fwd_path(hin, wb, yb)
        rowptr_t, s_in_t, s_w_t, perm_t, out_t, in_t = flk.schedule_on(
            lay, dev, transposed=True)
        wb_t = flk.transposed_tiles(wb, perm_t)
        dy3 = torch.randn(BATCH, lay.n_out_tiles * b3, generator=gen,
                          device=dev).to(bf)
        dhb = (dy3, wb_t, rowptr_t, s_in_t, s_w_t)
        dh3 = bdk.block_diag_fwd_cuda(*dhb, blk=b3)
        bsr_t = torch.sparse_bsr_tensor(
            rowptr_t, s_in_t, wb_t[s_w_t.long()],
            size=(lay.n_in_tiles * b3, lay.n_out_tiles * b3),
            check_invariants=True)
        lin_t = partial(bdk.block_diag_fwd_plain, rowptr=rowptr_t,
                        s_in=s_in_t, s_w=s_w_t, blk=b3)
        dh_rows.append(_bf16_fields(
            "bf16_dh_", partial(bdk.block_diag_fwd_cuda, *dhb, blk=b3),
            partial(bdk.block_diag_fwd_plain, *dhb, blk=b3),
            partial(torch.matmul, bsr_t, dy3.t()), _nbytes(*dhb, dh3), flops,
            50, "block_diag_bf16_group_kernel",
            label=f"block_diag_fwd bf16 dh mid layer {l}",
            f64=lambda lin=lin_t, dy3=dy3, wb_t=wb_t: [
                _sum_bound(lin, dy3, wb_t)]))
        dh_rows[-1]["bf16_dh_path"] = bdk.fwd_path(dy3, wb_t, dh3)
        dwa = (dy3, hin, out_t, in_t)
        dwb = bdk.block_diag_dw_cuda(*dwa, blk=b3)
        dyg = dy3.view(BATCH, -1, b3)[:, out_t.long()].permute(1, 2, 0) \
            .contiguous()
        xg = hin.view(BATCH, -1, b3)[:, in_t.long()].transpose(0, 1) \
            .contiguous()
        lin_w = partial(bdk.block_diag_dw_plain, wb_out_tile=out_t,
                        wb_in_tile=in_t, blk=b3)
        dw_rows.append(_bf16_fields(
            "bf16_", partial(bdk.block_diag_dw_cuda, *dwa, blk=b3),
            partial(bdk.block_diag_dw_plain, *dwa, blk=b3),
            partial(torch.bmm, dyg, xg), _nbytes(*dwa, dwb),
            2 * BATCH * b3 * b3 * lay.n_param_blocks, 50,
            "block_diag_dw_bf16_member_kernel",
            label=f"block_diag_dw bf16 mid layer {l}",
            f64=lambda lin=lin_w, dy3=dy3, hin=hin: [
                _sum_bound(lin, dy3, hin)]))
        dw_rows[-1]["bf16_path"] = bdk.dw_path(dy3, hin, dwb)
        hin = out
    rows["fused_layer_int8"] = _sum_fields(int8_rows)
    rows["block_diag_fwd"] = _sum_fields(fwd_rows)
    rows["block_diag_fwd"].update(_sum_fields(dh_rows))
    rows["block_diag_dw"] = _sum_fields(dw_rows)
    for key in ("fused_layer_int8", "block_diag_fwd", "block_diag_dw"):
        rows[key]["bf16_summed_over"] = "the depth-3 population's 2 mid layers"
    return rows


def bf16_path(workdir: Path) -> tuple:
    """Path 4i: the bf16 compute policy.  (i) both phase-3 checkpoints
    (beside ``workdir``; made as phase 3 makes them where they are
    missing, when path 4i runs alone: ``chip_smoke.py --bf16 DIR``) served
    under ``--compute-dtype bfloat16`` on the fused route and over the
    int8 copy, the depth-3 one on the unfused route too (the 10k
    checkpoint, depth 1, has no mid layer); (ii) ``parallelmlp-10k``
    trained under it on the fused route and on the unfused route with the
    M3 head (sgd); (iii) the depth-3 population under AdamW, a halving
    rung and ``--serve-publish`` on the fused route, and under AdamW,
    clip 1.0, on the unfused route with the M3 head (path 4e's run); (iv)
    the bf16 instances of the kernel rows (under ``"kernel_rows"``),
    measured first (after (i)-(iii) the profiler loses the first kernel
    of a window, which ``_profiled``'s sentinel takes).  Returns (the results, the kernel launches of
    (i)-(iii))."""
    import torch

    from repro_torch.checkpoint.checkpoint import (restore_population,
                                                   save_population)
    from repro_torch.configs import parallelmlp_10k
    from repro_torch.core.deep import init_params
    from repro_torch.launch.train import population_from_flags
    lp10k = parallelmlp_10k.config().model.layered()
    lp3k = population_from_flags(DEPTH3["depths"], DEPTH3["acts"],
                                 DEPTH3["features"],
                                 repeats=DEPTH3["repeats"])
    ck10k, ck3k = workdir.parent / "parallelmlp-10k", \
        workdir.parent / "trainer-depth3"
    for ck, lp, seed in ((ck10k, lp10k, 0), (ck3k, lp3k, 1)):
        if not ck.exists():
            save_population(str(ck), 0, init_params(
                torch.Generator(device="cuda").manual_seed(seed), lp), lp)
    p10k = restore_population(str(ck10k), device="cuda")[0]
    p3k = restore_population(str(ck3k), device="cuda")[0]
    rows = bf16_kernel_fields(p10k, lp10k, p3k, lp3k)
    torch.cuda.empty_cache()
    rows.update(bf16_route_kernel_fields(p10k, lp10k, p3k, lp3k))
    del p10k, p3k
    torch.cuda.empty_cache()
    x, y = check_batch()
    n_all = {}

    def count(n):
        for k, v in n.items():
            n_all[k] = n_all.get(k, 0) + v

    res = {}
    int8 = ["--weights-dtype", "int8"]
    for key, ck, lp, flags in (
            ("parallelmlp-10k", ck10k, lp10k, ()),
            ("trainer-depth3", ck3k, lp3k, ()),
            ("unfused trainer-depth3", ck3k, lp3k, UNFUSED),
            ("int8 parallelmlp-10k", ck10k, lp10k, int8),
            ("int8 trainer-depth3", ck3k, lp3k, int8)):
        res["serve " + key], n = serve_bf16("bf16 " + key, ck, lp, x, flags)
        count(n)
        torch.cuda.empty_cache()
    for key, lp, flags, route, opt_name in (
            ("parallelmlp-10k", lp10k, ["--arch", "parallelmlp-10k"],
             FUSED_ROUTE, "sgd"),
            ("unfused m3 parallelmlp-10k", lp10k,
             ["--arch", "parallelmlp-10k"], UNFUSED_M3, "sgd"),
            ("unfused m3 trainer-depth3", lp3k, depth3_flags(),
             UNFUSED_M3, "adamw")):
        res["train " + key], n = train_bf16("bf16 " + key, workdir, lp, x,
                                            y, flags, route, opt_name)
        count(n)
        torch.cuda.empty_cache()
    res["train trainer-depth3"], n = depth3_bf16_publish(
        "bf16 trainer-depth3", workdir)
    count(n)
    for name in BF16_KERNELS:
        _require(n_all.get(name, 0) > 0, f"kernel {name} was not launched "
                 "on path 4i")
    for counter, row in BF16_ROWS.items():
        rows[row]["bf16_launches"] = n_all[counter]
    res["kernel_rows"] = rows
    return res, n_all


# --------------------------------------------------------------------- #
# path 4j: the streaming data plane                                     #
# --------------------------------------------------------------------- #

PIPELINE_STEPS = 64         # (i): 8 chunks of 8 steps at 10k
PIPELINE_WINDOW = 4         # chunks of a profiled window


def pipeline_train(name: str, workdir: Path, flags: list, mode: str,
                   profile: bool = False):
    """One ``train.main`` run of path 4j on the fused route (batch 32,
    chunks of 8, seed 0) with ``--pipeline mode``, the kernel counters set
    to 0 just before it and read just after it, optionally in a
    ``_counted_window``.  Returns (params, layout, stats, launches,
    profiler or None)."""
    import contextlib

    import torch

    from repro_torch.launch import train as train_driver
    from repro_torch.launch.launch_count import (kernel_launches,
                                                 reset_kernel_launches)
    argv = ["--bd-impl", "fused", "--batch", str(BATCH), "--scan-steps",
            "8", "--seed", "0", "--ckpt-dir",
            str(workdir / f"pipe-{name}-{mode}"), "--pipeline", mode,
            *flags]
    torch.cuda.synchronize()
    reset_kernel_launches()
    window = (_counted_window(f"{name} --pipeline {mode}") if profile
              else contextlib.nullcontext())
    with window as prof:
        params, lp, stats = train_driver.main(argv)
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernel_launches().items() if v}
    _require(stats["restarts"] == 0, f"{name}: {stats['restarts']} restarts")
    pinned = stats["staging"]["pinned"]
    _require(pinned and all(pinned), f"{name} --pipeline {mode}: staging "
             f"buffers pinned {pinned}")
    return params, lp, stats, launches, prof


def _union_ms(spans, t0, t1) -> float:
    """The length of the union of ``spans`` (ns pairs) inside [t0, t1],
    in ms."""
    total, end = 0, t0
    for a, b in sorted(spans):
        a, b = max(a, end), min(b, t1)
        if b > a:
            total += b - a
            end = b
    return total / 1e6


def _loop_window(prof, last: int = PIPELINE_WINDOW) -> dict:
    """The device activity of the last ``last`` chunks of a ``train.main``
    run under ``torch.profiler``: a chunk is the trainer's ``CHUNK_SPAN``
    span on the training thread, and a device event belongs to it when its
    launch call falls inside the span (the producer's copies, launched
    from its own thread, count by time).  The window runs from the first
    start to the last end of those events; in it, the device's busy time
    (the union of every device event but the spans' own records on the
    device timeline), the kernels' and the copies' apart, the idle share,
    and the device time by name (the 10 largest); and the host time of the
    chunks' spans.  Also: the streams the slab copies (pinned host to
    device) ran on against the port's kernels', the other host-to-device
    copies by name, and each slab copy's gap from the end of the last
    kernel that started before it (< 0: it overlaps one), with the count
    of overlapping copies."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    raw = prof.profiler.kineto_results.events()
    spans = sorted((e.start_ns(), e.end_ns()) for e in raw
                   if e.device_type() != cuda and e.name() == CHUNK_SPAN)
    _require(len(spans) >= last, f"{len(spans)} {CHUNK_SPAN} spans")
    spans = spans[-last:]
    dev = {e.correlation_id(): e for e in raw
           if e.device_type() == cuda and e.correlation_id()
           and e.name() != CHUNK_SPAN}
    # launch calls are the CUDA API's records (cudaLaunchKernel,
    # cudaMemcpyAsync, ...); other host records may carry ids of their own
    mine = [dev[e.correlation_id()] for e in raw
            if e.device_type() != cuda and e.name().startswith("cu")
            and e.correlation_id() in dev
            and any(a <= e.start_ns() <= b for a, b in spans)]
    _require(mine, "no device activity launched in the chunks' spans")
    t0 = min(e.start_ns() for e in mine)
    t1 = max(e.end_ns() for e in mine)
    devs = [e for e in raw if e.device_type() == cuda
            and SENTINEL not in e.name() and e.name() != CHUNK_SPAN]
    copies = [e for e in devs if "Memcpy" in e.name()]
    htod = [e for e in copies if "HtoD" in e.name()]
    slab = [e for e in htod if "Pinned" in e.name()]
    kernels = [e for e in devs if "Memcpy" not in e.name()
               and "Memset" not in e.name()]
    ours = [e for e in kernels if any(k in e.name()
                                      for k in KERNEL_SYMBOLS)]
    win = (t1 - t0) / 1e6
    busy = _union_ms([(e.start_ns(), e.end_ns()) for e in devs], t0, t1)
    by_name = {}
    for e in devs:
        a, b = max(e.start_ns(), t0), min(e.end_ns(), t1)
        if b > a:
            key = e.name().split("(")[0][:80]
            by_name[key] = by_name.get(key, 0.0) + (b - a) / 1e6
    out = {"chunks_host_ms": (spans[-1][1] - spans[0][0]) / 1e6,
           "window_ms": win, "busy_ms": busy, "idle_share": 1 - busy / win,
           "kernel_busy_ms": _union_ms([(e.start_ns(), e.end_ns())
                                        for e in kernels], t0, t1),
           "copy_busy_ms": _union_ms([(e.start_ns(), e.end_ns())
                                      for e in copies], t0, t1),
           "top_ms": dict(sorted(by_name.items(),
                                 key=lambda kv: -kv[1])[:10]),
           "slab_copies": len(slab),
           "slab_streams": sorted({e.device_resource_id() for e in slab}),
           "other_htod": {n: sum(1 for e in htod if e.name() == n)
                          for n in {e.name() for e in htod}
                          if "Pinned" not in n},
           "kernel_streams": sorted({e.device_resource_id() for e in ours})}
    # each slab copy's distance from the device's kernels: the gap from
    # the end of the last kernel before it to its start (< 0: overlap)
    gaps = []
    for c in slab:
        prev = [k.end_ns() for k in kernels if k.start_ns() <= c.start_ns()]
        gaps.append((c.start_ns() - max(prev)) / 1e3 if prev else None)
    out["slab_copy_gaps_us"] = gaps
    out["slab_copies_overlapping"] = sum(1 for g in gaps
                                         if g is not None and g < 0)
    return out


def slab_overlap(name: str, chunks: int = 8) -> dict:
    """(iii) The slab copies against compute that does not wait on the
    host: a ``Prefetcher`` over a ``SlabStager`` at path 4j's slab shapes
    (8 batches of the task's B 32 × F 100 rows and labels a chunk) feeding
    each chunk's 8 batches to the 10k input layer's training forward
    (``fused_input_train_cuda``, full width, weights from a seeded init),
    the host never waiting on the card, in a ``_counted_window``: every
    slab copy on a stream apart from the kernels', and a copy of a chunk
    overlapping a kernel of an earlier chunk (kernels and copies assigned
    to chunks in their stream order), both timestamps printed."""
    import numpy as np
    import torch

    from repro_torch.configs import parallelmlp_10k
    from repro_torch.core import deep
    from repro_torch.data import Prefetcher, SlabStager
    from repro_torch.data.synthetic import TabularTask
    from repro_torch.kernels import fused_input as fik
    lp = parallelmlp_10k.config().model.layered()
    p0 = lp.layer_pop(0)
    params = deep.init_params(torch.Generator(device="cuda").manual_seed(0),
                              lp)
    w, b = params["w_in"], params["b_in"]
    del params
    ids = torch.as_tensor(p0.block_act_ids, dtype=torch.int32,
                          device="cuda")
    mask = torch.as_tensor(p0.hidden_mask, dtype=torch.float32,
                           device="cuda")
    task = TabularTask(2048, lp.in_features, n_classes=lp.out_features,
                       seed=0)
    stager = SlabStager("cuda")
    specs = (((8, BATCH, lp.in_features), np.float32), ((8, BATCH), np.int32))

    def produce(c, staging):
        return stager.stage(staging, 8, lambda sx, sy: task.batch_slab(
            8 * c, 8, BATCH, out=(sx, sy)))

    fik.fused_input_train_cuda(torch.zeros(BATCH, lp.in_features,
                                           device="cuda"), w, b, mask, ids,
                               block=lp.block)
    torch.cuda.synchronize()
    with _counted_window(name) as prof:
        with Prefetcher(produce, chunks,
                        make_staging=lambda: stager.staging(specs)) as pf:
            for c in range(chunks):
                xs, _ = pf.get(c, timeout=60.0).take()
                for k in range(8):
                    fik.fused_input_train_cuda(xs[k], w, b, mask, ids,
                                               block=lp.block)
    cuda = torch.autograd.DeviceType.CUDA
    raw = prof.profiler.kineto_results.events()
    kernels = sorted((e for e in raw if e.device_type() == cuda
                      and "fused_input_kernel" in e.name()),
                     key=lambda e: e.start_ns())
    slab = sorted((e for e in raw if e.device_type() == cuda
                   and "Pinned -> Device" in e.name()),
                  key=lambda e: e.start_ns())
    _require(len(kernels) == 8 * chunks and len(slab) == 2 * chunks,
             f"{name}: {len(kernels)} kernels, {len(slab)} slab copies")
    out = {"pinned": stager.pinned,
           "slab_streams": sorted({e.device_resource_id() for e in slab}),
           "kernel_streams": sorted({e.device_resource_id()
                                     for e in kernels})}
    t0 = kernels[0].start_ns()
    for j, c in enumerate(slab):
        k = next((i for i, k in enumerate(kernels)
                  if i // 8 < j // 2 and k.start_ns() < c.end_ns()
                  and c.start_ns() < k.end_ns()), None)
        if k is not None:
            out["overlap"] = {
                "copy_chunk": j // 2, "copy_us": [(c.start_ns() - t0) / 1e3,
                                                  (c.end_ns() - t0) / 1e3],
                "kernel_chunk": k // 8,
                "kernel_us": [(kernels[k].start_ns() - t0) / 1e3,
                              (kernels[k].end_ns() - t0) / 1e3]}
            break
    print(f"[{name}] {out}", flush=True)
    _require(all(stager.pinned) and not set(out["slab_streams"])
             & set(out["kernel_streams"]), f"{name}: {out}")
    _require("overlap" in out, f"{name}: no slab copy overlapped a kernel "
             f"of an earlier chunk: {out}")
    return out


def pipeline_path(workdir: Path) -> tuple:
    """Path 4j (``chip_smoke.py --pipeline DIR``): (i) ``parallelmlp-10k``
    at full width, fused, sgd, B 32, 64 steps in chunks of 8, no
    checkpoints, a warm-up run, then ``--pipeline on`` and ``off`` in
    turns (on, off, off, on): final parameters bitwise equal, the
    per-chunk losses identical, the kernel launches equal; each run's
    train-loop wall and model-steps/s (``train.main``'s, which holds the
    runner's host snapshot of the initial state, and the runner's chunks
    alone); then one run of each mode in a ``_counted_window``: the
    device's idle share over its last 4 chunks (``_loop_window``),
    kernels and copies apart.  (ii) The depth-3 population under AdamW,
    clip 1.0 (path 4g's flags, a constant lr) with ``--halving "8:0.5"
    --refill pbt --per-member-lr``, 24 steps, checkpoints every 8: a
    warm-up run, then off and on, each against the warm-up's parameters
    and final checkpoint arrays (the optimizer state) bitwise, the same
    launches, the pbt rung building no table and no staging buffer (two
    in a pipelined run, one a segment in a synchronous one).  (iii) Every
    staging buffer pinned; the slab copies ("Pinned -> Device") on
    streams apart from the kernels'; each slab copy's gap from the
    kernels in both windows (the step's own host syncs drain the card
    before most copies); and ``slab_overlap``: a copy of a chunk
    overlapping a kernel of an earlier chunk where the host does not wait
    on the card.  Returns (results, the launches of its runs)."""
    import numpy as np
    import torch

    from repro_torch.checkpoint.checkpoint import latest_steps
    t_path = time.perf_counter()
    n_all = {}

    def count(n):
        for k, v in n.items():
            n_all[k] = n_all.get(k, 0) + v

    res = {"runs": []}
    flags10k = ["--arch", "parallelmlp-10k", "--steps",
                str(PIPELINE_STEPS), "--ckpt-every", "0"]
    first, ref = None, {}
    # run 0 warms the process up (allocator, host memory, first launches):
    # held bitwise like the rest, timed apart from runs 1-4
    for i, mode in enumerate(("on", "on", "off", "off", "on")):
        params, lp, st, n, _ = pipeline_train(f"10k run {i}", workdir,
                                              flags10k, mode)
        count(n)
        run_s = sum(seg["seconds"] for seg in st["segments"])
        run = {"mode": mode, "loop_s": st["seconds"],
               "model_steps_per_s": st["member_steps"] / st["seconds"],
               "runner_s": run_s,
               "runner_model_steps_per_s": st["member_steps"] / run_s,
               "chunk_loss": st["chunk_loss"], "launches": n,
               "staging_made": st["staging"]["made"]}
        res["runs"].append(run)
        print(f"[pipeline 10k run {i} --pipeline {mode}] train loop "
              f"{st['seconds']!r} s, {run['model_steps_per_s']!r} "
              f"model-steps/s; the runner's chunks {run_s!r} s, "
              f"{run['runner_model_steps_per_s']!r} model-steps/s; "
              f"launches {n}", flush=True)
        if first is None:
            first, ref = params, run
            continue
        _require(_same_trees(params, first), f"10k run {i} ({mode}): the "
                 "final parameters are not bitwise run 0's")
        _require(run["chunk_loss"] == ref["chunk_loss"]
                 and n == ref["launches"], f"10k run {i} ({mode}): losses "
                 f"{run['chunk_loss']} launches {n} against run 0's "
                 f"{ref['chunk_loss']} {ref['launches']}")
        del params
    del first
    torch.cuda.empty_cache()
    res["windows"] = {}
    for mode in ("on", "off"):
        params, lp, st, n, prof = pipeline_train(
            "10k profiled", workdir, flags10k, mode, profile=True)
        count(n)
        win = _loop_window(prof)
        res["windows"][mode] = win
        print(f"[pipeline 10k --pipeline {mode}] last {PIPELINE_WINDOW} "
              f"chunks: {win}", flush=True)
        _require(win["slab_copies"] > 0 and not set(win["slab_streams"])
                 & set(win["kernel_streams"]), f"--pipeline {mode}: the "
                 f"slab copies (pinned -> device) against the kernels' "
                 f"streams: {win}")
        del params, prof
    torch.cuda.empty_cache()
    res["slab_overlap"] = slab_overlap("pipeline slab copies")
    # (ii) the depth-3 pbt ladder, on against off
    depth3 = depth3_flags()
    cut = depth3.index("--lr-schedule")
    flags3 = depth3[:cut] + depth3[cut + 2:] + [
        "--halving", "8:0.5", "--refill", "pbt", "--per-member-lr",
        "--steps", "24", "--ckpt-every", "8"]
    # run 0 warms the process up for the depth-3 layout (its host-side
    # tables); runs 1 and 2 are timed
    got = []
    for i, mode in enumerate(("on", "off", "on")):
        params, lp, st, n, _ = pipeline_train(f"depth-3 pbt {i}", workdir,
                                              flags3, mode)
        count(n)
        ck = workdir / f"pipe-depth-3 pbt {i}-{mode}"
        step = latest_steps(str(ck))[-1]
        arrays = dict(np.load(ck / f"step_{step:08d}" / "arrays.npz"))
        got.append((mode, params, lp, st, n, arrays))
    _, p0, lp0, s0, n0, z0 = got[0]
    for i, (mode, p, lp, st, n, z) in enumerate(got[1:], 1):
        _require(lp == lp0 and _same_trees(p, p0), f"depth-3 pbt run {i} "
                 f"({mode}): other parameters than run 0's")
        _require(sorted(z) == sorted(z0) and any(k.startswith("extra/")
                                                  for k in z)
                 and all(np.array_equal(z[k], z0[k]) for k in z),
                 f"depth-3 pbt run {i} ({mode}): the final checkpoint's "
                 "arrays differ from run 0's")
        _require(n == n0 and st["chunk_loss"] == s0["chunk_loss"],
                 f"depth-3 pbt run {i} ({mode}): launches {n} / {n0}, "
                 "losses differ")
    for mode, _, _, st, _, _ in got:
        _require(len(st["rungs"]) == 1
                 and st["rungs"][0]["tables_built"] == 0
                 and st["staging"]["made"] == (
                     2 if mode == "on" else len(st["segments"])),
                 f"depth-3 pbt --pipeline {mode}: rungs {st['rungs']}, "
                 f"staging buffers made {st['staging']['made']} (2: none "
                 "rebuilt at the rung)")
    res["depth3_pbt"] = [
        {"mode": mode, "loop_s": st["seconds"],
         "model_steps_per_s": st["member_steps"] / st["seconds"],
         "runner_s": sum(seg["seconds"] for seg in st["segments"]),
         "staging_made": st["staging"]["made"],
         "rung_tables_built": st["rungs"][0]["tables_built"],
         "last_loss": st["last_loss"]} for mode, _, _, st, _, _ in got]
    del got
    res["seconds"] = time.perf_counter() - t_path
    print(f"[pipeline] path 4j: --pipeline on and off bitwise equal at 10k "
          f"and through the depth-3 pbt ladder; {res['depth3_pbt']}; "
          f"{res['seconds']:.1f} s", flush=True)
    return res, n_all


# --------------------------------------------------------------------- #
# path 4k: the population axis across ranks                             #
# --------------------------------------------------------------------- #

SHARDED_STEPS = 16          # (i): 2 chunks of 8 steps at 10k
# (ii): the depth-3 ladder.  AdamW with the clip amplifies a reordered sum
# of the clip's norm to ~1e-6 in a weight over 24 steps, the edge of the
# optimizer tolerance (measured on one H100: 1.8e-6 at 24 steps);
# 12 steps keep the comparison inside it
SHARDED_LADDER = 12
SHARDED_HALVING = "4:0.5,8:0.5"
SHARDED_TOL = (1e-5, 1e-6)  # the optimizer tolerance (tests' TRAJ)
# (iv)-(vi): the data axis.  A batch of 48 splits over a data axis of 3
# (16 rows a rank); the 10k runs 8 steps in chunks of 4 at W = 3
DATA_BATCH = 48
DATA_STEPS = 8


def _json_stats(st: dict) -> dict:
    """The parts of ``train.main``'s stats path 4k reads, as JSON."""
    seg_keys = ("start", "end", "members", "depth", "fused_hidden",
                "seconds", "launches", "ranks", "rank_fused_hidden")
    return {"chunk_loss": {str(k): v for k, v in st["chunk_loss"].items()},
            "seconds": st["seconds"], "member_steps": st["member_steps"],
            "restarts": st["restarts"], "steps": st["steps"],
            "ranks": st.get("ranks"),
            "rank_fused_hidden": st.get("rank_fused_hidden"),
            "rows": st.get("rows"),
            "data_reduce_calls": st.get("data_reduce_calls"),
            "data_reduce_s": st.get("data_reduce_s"),
            "segments": [{k: s[k] for k in seg_keys if k in s}
                         for s in st["segments"]],
            "rungs": [[r["members_before"], r["members"]]
                      for r in st["rungs"]]}


def serve_logits(ckpt: Path, x, mesh=None, int8: bool = False,
                 blocks: int = 1):
    """The served logits of ``ckpt`` on the batch ``x``, through a
    ``PopulationServer``'s own flush (``flush_logits``, f32 or its int8
    copy) of ``len(x)`` rows: on W ranks each rank's members of its rows
    of the flush (split over a data axis that divides it) gathered to rank
    0 (None elsewhere); on one rank with ``blocks`` > 1, ``x`` in that
    many equal flushes, concatenated (the rows a data axis of ``blocks``
    hands each rank)."""
    import torch

    from repro_torch.launch.serve_population import PopulationServer
    k = int(x.shape[0]) // blocks
    server, _ = PopulationServer.from_checkpoint(
        str(ckpt), device=x.device, mesh=mesh, bd_impl="fused", batch=k,
        weights_dtype="int8" if int8 else None)
    server._ensure_quantized()
    if server.shard is None:
        return torch.cat([server.flush_logits(server.params,
                                              x[i * k:(i + 1) * k])
                          for i in range(blocks)]).cpu()
    lo, hi = server.rows
    got = server.flush_logits(server.params, x[lo:hi])
    return None if got is None else got.cpu()


def _digest(tree) -> str:
    """sha256 of every leaf's bytes, in ``tree_leaves`` order."""
    import hashlib

    import torch

    from repro_torch.core.tree import tree_leaves
    h = hashlib.sha256()
    for t in tree_leaves(tree):
        h.update(t.detach().cpu().reshape(-1).contiguous()
                 .view(torch.uint8).numpy())
    return h.hexdigest()


def rank_jobs(spec: Path) -> int:
    """One rank of a path-4k job (``chip_smoke.py --rank-jobs SPEC`` under
    ``torch.distributed.run``): each job of SPEC (``train.main`` or
    ``serve_population.main`` argv), the kernel counters set to 0 just
    before it and read just after; writes ``OUT.RANK.json`` per job (with
    ``"digest"``, the sha256 of the rank's final parameters), and rank 0
    a serve job's logits on ``check_batch`` as ``OUT.pt``."""
    import torch

    from repro_torch.launch import serve_population
    from repro_torch.launch import train as train_driver
    from repro_torch.launch.launch_count import (kernel_launches,
                                                 reset_kernel_launches)
    from repro_torch.launch.mesh import close, make_host_mesh
    mesh = make_host_mesh()
    try:
        for job in json.loads(spec.read_text()):
            torch.cuda.synchronize()
            reset_kernel_launches()
            if job["kind"] == "train":
                params, _, st = train_driver.main(job["argv"])
                res = {"stats": _json_stats(st)}
                if job.get("digest"):
                    res["digest"] = _digest(params)
                del params
            else:
                out = serve_population.main(job["argv"])
                res = {k: out.get(k) for k in ("serve", "pred", "budget",
                                               "ranks")}
            torch.cuda.synchronize()
            res["launches"] = {k: v for k, v in kernel_launches().items()
                               if v}
            if job["kind"] == "serve":
                got = serve_logits(Path(job["ckpt"]),
                                   check_batch(job.get("rows", BATCH))[0],
                                   mesh, job["int8"])
                if got is not None:
                    torch.save(got, f"{job['out']}.pt")
            Path(f"{job['out']}.{mesh.rank}.json").write_text(
                json.dumps(res))
    finally:
        close(mesh)
    return 0


def run_ranks(workdir: Path, n: int, jobs: list, timeout: int = 600) -> dict:
    """``jobs`` on ``n`` ranks of one card (``python -m
    torch.distributed.run --standalone --nproc-per-node n``, gloo): its
    own session, killed whole at ``timeout``.  Returns each job's per-rank
    results ``{out: [rank 0's, rank 1's, ...]}``."""
    import os
    import signal
    spec = workdir / f"ranks{n}-{int(time.time() * 1e3)}.json"
    spec.write_text(json.dumps(jobs))
    sys.stdout.flush()
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(n), str(ROOT / "chip_smoke.py"),
         "--rank-jobs", str(spec)], start_new_session=True)
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        rc = "timeout"
    _require(rc == 0, f"{n} ranks: exited {rc}")
    print(f"[sharded] {n} ranks ran {len(jobs)} jobs in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {job["out"]: [json.loads(Path(f"{job['out']}.{r}.json")
                                    .read_text()) for r in range(n)]
            for job in jobs}


def _truncated(src: Path, dst: Path, step: int) -> Path:
    """A copy of checkpoint directory ``src`` holding steps ≤ ``step``."""
    import shutil

    from repro_torch.checkpoint.checkpoint import latest_steps
    shutil.copytree(src, dst)
    for s in latest_steps(str(dst)):
        if s > step:
            shutil.rmtree(dst / f"step_{s:08d}")
    return dst


def _ckpt_arrays(ck: Path, step: int) -> tuple:
    """(each array of a checkpoint's ``arrays.npz`` as bytes, its
    tree.json) — the npz archive's entries carry their write times, so the
    files are compared array by array."""
    import numpy as np
    d = ck / f"step_{step:08d}"
    with np.load(d / "arrays.npz") as z:
        arrays = {k: (z[k].dtype.str, z[k].shape, z[k].tobytes())
                  for k in z.files}
    return arrays, json.loads((d / "tree.json").read_text())


def _ckpt_close(name: str, a: Path, b: Path, tol=SHARDED_TOL) -> float:
    """Two checkpoints' parameters and optimizer state leaf by leaf within
    ``tol`` (bf16 leaves as floats) → the max |difference|."""
    import numpy as np

    from repro_torch.checkpoint.checkpoint import latest_steps
    sa, sb = latest_steps(str(a))[-1], latest_steps(str(b))[-1]
    _require(sa == sb, f"{name}: last steps {sa} and {sb}")
    za, ta = _ckpt_arrays(a, sa)
    zb, tb = _ckpt_arrays(b, sb)
    _require(sorted(za) == sorted(zb) and ta["meta"]["population"]
             == tb["meta"]["population"], f"{name}: other trees")
    worst = 0.0
    for k in za:
        x, y = (np.frombuffer(z[k][2], np.dtype(z[k][0])).reshape(z[k][1])
                for z in (za, zb))
        if ta["manifest"][k]["dtype"] == "bfloat16":
            x, y = ((v.astype(np.uint32) << 16).view(np.float32)
                    for v in (x, y))
        x, y = x.astype(np.float64), y.astype(np.float64)
        if x.size:
            worst = max(worst, float(np.abs(x - y).max()))
        _require(np.allclose(x, y, rtol=tol[0], atol=tol[1]),
                 f"{name}: {k} beyond rtol {tol[0]} / atol {tol[1]}: max "
                 f"|diff| {float(np.abs(x - y).max())}")
    return worst


def sharded_path(workdir: Path) -> tuple:
    """Path 4k (``chip_smoke.py --sharded DIR``): the population axis on
    W ranks sharing the one card (gloo).  (i) ``parallelmlp-10k`` at full
    width, fused, sgd, B 32, 16 steps in chunks of 8, checkpoints at steps
    8 and 16, on W = 2 against W = 1: every checkpoint array byte-equal
    and the manifests equal (no fillers at 10k: the real members bitwise),
    the printed per-chunk losses equal, each rank's loop 2·(depth+1)
    launches a step; both runs' walls and model-steps/s.  (ii) The depth-3
    population at 999 repeats (2,997 members; ``shard_pad(4)`` adds 3
    fillers), AdamW, clip 1.0, ``--halving "4:0.5,8:0.5"``, 12 steps,
    checkpoints every 4, ``--shard-pad 4`` everywhere: W = 4 against W = 1
    (every array within the optimizer tolerance, the same survivors at
    every rung), then W = 1 resuming W = 4's checkpoint after the first
    rung and W = 2 resuming W = 1's, each continuing within the tolerance of the run it
    left.  (iii) ``serve_population --sharded`` at W = 2 over the 10k
    checkpoint in f32 and int8: the predictions of every mode equal
    W = 1's, the served logits on a batch bitwise W = 1's, each rank's
    forward depth+1 launches; req/s and p50/p99 of both.  (iv)-(vi) the
    data axis (``data_axis_runs``).  Returns (results, the launches of
    its runs, summed over the ranks)."""
    import torch

    from repro_torch.launch import serve_population
    from repro_torch.launch import train as train_driver
    from repro_torch.launch.launch_count import (kernel_launches,
                                                 reset_kernel_launches)
    from repro_torch.launch.train import population_from_flags
    t_path = time.perf_counter()
    n_all = {}
    lp3 = population_from_flags(DEPTH3["depths"], DEPTH3["acts"],
                                DEPTH3["features"], repeats=999).shard_pad(4)
    _require((lp3.num_real, lp3.n_pad) == (2997, 3), "the depth-3 "
             f"population at 999 repeats: {lp3.describe()}")

    def count(n):
        for k, v in n.items():
            n_all[k] = n_all.get(k, 0) + v

    def here(argv):
        """``train.main`` on one rank in this process, counted."""
        torch.cuda.synchronize()
        reset_kernel_launches()
        _, _, st = train_driver.main(argv)
        torch.cuda.synchronize()
        count(kernel_launches())
        _require(st["restarts"] == 0, f"{argv}: restarts")
        return _json_stats(st)

    common = ["--bd-impl", "fused", "--batch", str(BATCH), "--scan-steps",
              "8", "--seed", "0", "--ckpt-every", "8"]
    flags10k = common + ["--arch", "parallelmlp-10k", "--steps",
                         str(SHARDED_STEPS)]
    depth3 = depth3_flags()
    rep = depth3.index("--population-repeats")
    flags3 = common + depth3[:rep + 1] + ["999"] + depth3[rep + 2:] + [
        "--halving", SHARDED_HALVING, "--steps", str(SHARDED_LADDER),
        "--shard-pad", "4", "--ckpt-every", "4"]
    d = {k: workdir / k for k in ("w1_10k", "w2_10k", "w1_d3", "w4_d3",
                                  "w1_from_w4", "w2_from_w1", "w2_serve")}
    res = {}
    # W = 1: the 10k run and the depth-3 ladder on the padded layout
    s1 = here(flags10k + ["--ckpt-dir", str(d["w1_10k"])])
    s1d = here(flags3 + ["--ckpt-dir", str(d["w1_d3"])])
    # W = 4: the depth-3 ladder
    got4 = run_ranks(workdir, 4, [
        {"kind": "train", "out": str(d["w4_d3"]),
         "argv": flags3 + ["--ckpt-dir", str(d["w4_d3"])]}])
    r4 = got4[str(d["w4_d3"])]
    for r in r4:
        count(r["launches"])
    # 4 → 1: one rank resumes the 4 ranks' checkpoint after the first rung
    _truncated(d["w4_d3"], d["w1_from_w4"], 3)
    s1r = here(flags3 + ["--ckpt-dir", str(d["w1_from_w4"]), "--resume"])
    # W = 2: the 10k run, 1 → 2, and the sharded server over the 10k
    _truncated(d["w1_d3"], d["w2_from_w1"], 3)
    serve_argv = ["--ckpt-dir", str(d["w1_10k"]), "--requests",
                  str(SERVE_REQUESTS), "--batch", str(BATCH)]
    got2 = run_ranks(workdir, 2, [
        {"kind": "train", "out": str(d["w2_10k"]),
         "argv": flags10k + ["--ckpt-dir", str(d["w2_10k"])]},
        {"kind": "train", "out": str(d["w2_from_w1"]),
         "argv": flags3 + ["--ckpt-dir", str(d["w2_from_w1"]),
                           "--resume"]},
        {"kind": "serve", "out": str(d["w2_serve"]) + "-f32",
         "ckpt": str(d["w1_10k"]), "int8": False,
         "argv": serve_argv + ["--sharded"]},
        {"kind": "serve", "out": str(d["w2_serve"]) + "-int8",
         "ckpt": str(d["w1_10k"]), "int8": True,
         "argv": serve_argv + ["--sharded", "--weights-dtype", "int8"]}])
    for per_rank in got2.values():
        for r in per_rank:
            count(r["launches"])

    # (i) 10k: W = 2 against W = 1
    r2 = got2[str(d["w2_10k"])]
    for step in (7, 15):
        a, ta = _ckpt_arrays(d["w1_10k"], step)
        b, tb = _ckpt_arrays(d["w2_10k"], step)
        _require(a == b and ta == tb, f"10k step {step}: the W = 2 "
                 "checkpoint is not the W = 1 one's arrays and manifest")
    _require(all(r["stats"]["chunk_loss"] == s1["chunk_loss"] for r in r2),
             f"10k: per-chunk losses {[r['stats']['chunk_loss'] for r in r2]}"
             f" against W = 1's {s1['chunk_loss']}")
    want = _segment_want(SHARDED_STEPS, 1)
    for rank, r in enumerate(r2):
        got = r["stats"]["segments"][0]["launches"]
        _require(got == want, f"10k rank {rank}: the loop launched {got}, "
                 f"2·(depth+1) a step is {want}")
    w1_rate = s1["member_steps"] / s1["seconds"]
    w2_rate = r2[0]["stats"]["member_steps"] / r2[0]["stats"]["seconds"]
    res["10k"] = {
        "w1_s": s1["seconds"], "w1_model_steps_per_s": w1_rate,
        "w2_s": r2[0]["stats"]["seconds"], "w2_model_steps_per_s": w2_rate,
        "ranks": r2[0]["stats"]["ranks"],
        "rank_fused_hidden": r2[0]["stats"]["rank_fused_hidden"],
        "rank_launches": [r["stats"]["segments"][0]["launches"]
                          for r in r2],
        "checkpoints_equal": [7, 15], "chunk_loss": s1["chunk_loss"]}
    print(f"[sharded 10k] W = 2 ranks {res['10k']['ranks']} (fused widths "
          f"{res['10k']['rank_fused_hidden']}): checkpoints at steps 8 and "
          f"16 array for array and manifest equal to W = 1's, losses "
          f"equal, each rank {want} in its loop; one-card walls W = 1 "
          f"{s1['seconds']!r} s ({w1_rate!r} model-steps/s), W = 2 "
          f"{r2[0]['stats']['seconds']!r} s ({w2_rate!r} model-steps/s)",
          flush=True)

    # (ii) the depth-3 ladder with fillers: W = 4 against W = 1, resumes
    s4 = r4[0]["stats"]
    _require(s4["rungs"] == s1d["rungs"] and len(s1d["rungs"]) == 2,
             f"depth-3: rungs {s4['rungs']} against W = 1's {s1d['rungs']}")
    ids = [_ckpt_arrays(p, SHARDED_LADDER - 1)[1]["meta"]["lifecycle"]
           ["member_ids"] for p in (d["w1_d3"], d["w4_d3"])]
    _require(ids[0] == ids[1], "depth-3: W = 4 kept other survivors")
    for rank, r in enumerate(r4):
        for seg in r["stats"]["segments"]:
            n = seg["end"] - seg["start"]
            depth = len(seg["rank_fused_hidden"][rank])
            _require(seg["launches"] == _segment_want(n, depth),
                     f"depth-3 rank {rank}: segment {seg['start']}-"
                     f"{seg['end']} launched {seg['launches']}")
    err4 = _ckpt_close("depth-3 W = 4 / W = 1", d["w4_d3"], d["w1_d3"])
    err41 = _ckpt_close("depth-3 resumed 4 -> 1", d["w1_from_w4"],
                        d["w4_d3"])
    err12 = _ckpt_close("depth-3 resumed 1 -> 2", d["w2_from_w1"],
                        d["w1_d3"])
    s2r = got2[str(d["w2_from_w1"])][0]["stats"]
    res["depth3"] = {
        "members": lp3.num_real, "fillers": lp3.n_pad, "rungs": s1d["rungs"],
        "ranks": [seg.get("ranks") for seg in s4["segments"]],
        "rank_fused_hidden": [seg.get("rank_fused_hidden")
                              for seg in s4["segments"]],
        "w4_vs_w1_max_abs_err": err4, "resume_4_to_1_max_abs_err": err41,
        "resume_1_to_2_max_abs_err": err12,
        "w1_s": s1d["seconds"], "w4_s": s4["seconds"],
        "resumed_steps": [s1r["steps"], s2r["steps"]]}
    print(f"[sharded depth-3] {lp3.num_real} members + {lp3.n_pad} "
          f"fillers, rungs "
          f"{s1d['rungs']} the same on W = 4 and W = 1, the survivors "
          f"equal; max |diff| W = 4 / W = 1 {err4!r}, resumed 4 -> 1 "
          f"{err41!r}, 1 -> 2 {err12!r} (tolerance rtol {SHARDED_TOL[0]} / "
          f"atol {SHARDED_TOL[1]}); ranks by segment "
          f"{res['depth3']['ranks']}", flush=True)

    # (iii) the sharded server against one rank
    x = check_batch()[0]
    res["serve"] = {}
    for tag, flags in (("f32", []), ("int8", ["--weights-dtype", "int8"])):
        torch.cuda.synchronize()
        reset_kernel_launches()
        one = serve_population.main(serve_argv + flags)
        torch.cuda.synchronize()
        count(kernel_launches())
        out = str(d["w2_serve"]) + f"-{tag}"
        ranks = got2[out]
        _require(ranks[0]["pred"] == one["pred"], f"serve {tag}: W = 2 "
                 "predictions differ from W = 1's")
        for rank, r in enumerate(ranks):
            _require(r["budget"]["launches"] == r["budget"]["budget"] == 2,
                     f"serve {tag} rank {rank}: budget {r['budget']}")
        mine = serve_logits(d["w1_10k"], x, None, tag == "int8")
        theirs = torch.load(out + ".pt")
        _require(_same_bits(mine, theirs), f"serve {tag}: the W = 2 logits "
                 "are not bitwise W = 1's")
        res["serve"][tag] = {"w1": one["serve"], "w2": ranks[0]["serve"]}
        for mode in one["serve"]:
            a, b = one["serve"][mode], ranks[0]["serve"][mode]
            print(f"[sharded serve {tag}] {mode:5s} W = 1 "
                  f"{a['req_per_s']!r} req/s p50 {a['p50_ms']!r} p99 "
                  f"{a['p99_ms']!r} ms | W = 2 {b['req_per_s']!r} req/s p50 "
                  f"{b['p50_ms']!r} p99 {b['p99_ms']!r} ms", flush=True)
    print("[sharded serve] f32 and int8 predictions equal to W = 1's in "
          "every mode, the logits bitwise", flush=True)
    res.update(data_axis_runs(workdir, d, flags10k, flags3, serve_argv,
                              here, count))
    res["seconds"] = time.perf_counter() - t_path
    print(f"[sharded] path 4k in {res['seconds']:.1f} s; launches {n_all}",
          flush=True)
    return res, n_all


def data_axis_runs(workdir: Path, d: dict, flags10k: list, flags3: list,
                   serve_argv: list, here, count) -> dict:
    """Path 4k (iv)-(vi): the data axis, ranks sharing the one card.
    (iv) ``parallelmlp-10k`` at full width, fused, sgd, B 48, 8 steps in
    chunks of 4, at W = 3 (data 3: 16 rows a rank, the gradients averaged
    over the column by gloo on the card's tensors) against W = 1: the
    checkpoint within the optimizer tolerance, the three ranks' final
    parameters the same bits, each rank's loop 2·(depth+1) launches a
    step; both one-card walls and the all-reduce's host ms a step.  (v)
    The depth-3 ladder of (ii) at B 48 on W = 6 (data 3 × model 2)
    against W = 1 with ``--shard-pad 2``: the same survivors at both
    rungs, each data column's ranks the same bits, each rank's segments
    2·(depth+1) launches a step of its own depth; the max |difference|
    of the checkpoints as a finding.  (vi) ``serve_population --sharded``
    at W = 3 over the 10k checkpoint, flushes of 48 split over the data
    axis: every mode's predictions equal W = 1's at the same flush, each
    rank's forward depth+1 launches; the logits of a flush of 48 split
    over the three ranks and gathered by rank 0 bitwise W = 1's on the
    same three 16-row shares, and within the tolerance of W = 1's whole
    flush."""
    import torch

    from repro_torch.launch import serve_population
    from repro_torch.launch.launch_count import (kernel_launches,
                                                 reset_kernel_launches)
    for k in ("w1_10k48", "w3_10k", "w1_d3p2", "w6_d3", "w3_serve"):
        d[k] = workdir / k
    res = {}
    flags10k = flags10k + ["--batch", str(DATA_BATCH), "--steps",
                           str(DATA_STEPS), "--scan-steps", "4",
                           "--ckpt-every", "4"]
    flags3 = flags3 + ["--batch", str(DATA_BATCH), "--shard-pad", "2"]
    serve48 = serve_argv + ["--batch", str(DATA_BATCH)]
    s1 = here(flags10k + ["--ckpt-dir", str(d["w1_10k48"])])
    s1d = here(flags3 + ["--ckpt-dir", str(d["w1_d3p2"])])
    torch.cuda.synchronize()
    reset_kernel_launches()
    one = serve_population.main(serve48)
    torch.cuda.synchronize()
    count(kernel_launches())
    got3 = run_ranks(workdir, 3, [
        {"kind": "train", "out": str(d["w3_10k"]), "digest": True,
         "argv": flags10k + ["--ckpt-dir", str(d["w3_10k"])]},
        {"kind": "serve", "out": str(d["w3_serve"]),
         "ckpt": str(d["w1_10k"]), "int8": False, "rows": DATA_BATCH,
         "argv": serve48 + ["--sharded"]}])
    got6 = run_ranks(workdir, 6, [
        {"kind": "train", "out": str(d["w6_d3"]), "digest": True,
         "argv": flags3 + ["--ckpt-dir", str(d["w6_d3"])]}])
    for per_rank in list(got3.values()) + list(got6.values()):
        for r in per_rank:
            count(r["launches"])

    # (iv) 10k: W = 3 against W = 1
    r3 = got3[str(d["w3_10k"])]
    err = _ckpt_close("10k W = 3 / W = 1", d["w3_10k"], d["w1_10k48"])
    _require(len({r["digest"] for r in r3}) == 1, "10k W = 3: the data "
             "column's ranks hold other parameters")
    want = _segment_want(DATA_STEPS, 1)
    for rank, r in enumerate(r3):
        st = r["stats"]
        _require(st["segments"][0]["launches"] == want, f"10k W = 3 rank "
                 f"{rank}: the loop launched {st['segments'][0]['launches']}"
                 f", 2·(depth+1) a step is {want}")
        _require(st["rows"] == [16 * rank, 16 * rank + 16]
                 and st["data_reduce_calls"] == DATA_STEPS,
                 f"10k W = 3 rank {rank}: rows {st['rows']}, "
                 f"{st['data_reduce_calls']} all-reduces")
    st3 = r3[0]["stats"]
    reduce_ms = [r["stats"]["data_reduce_s"] / DATA_STEPS * 1e3 for r in r3]
    res["data10k"] = {
        "batch": DATA_BATCH, "steps": DATA_STEPS, "max_abs_err": err,
        "w1_s": s1["seconds"], "w3_s": st3["seconds"],
        "w1_model_steps_per_s": s1["member_steps"] / s1["seconds"],
        "w3_model_steps_per_s": st3["member_steps"] / st3["seconds"],
        "allreduce_host_ms_per_step": reduce_ms,
        "rank_launches": [r["stats"]["segments"][0]["launches"]
                          for r in r3]}
    print(f"[data 10k] W = 3 (data 3, {DATA_BATCH // 3} of {DATA_BATCH} "
          f"rows a rank): checkpoint max |diff| {err!r} from W = 1's "
          f"(rtol {SHARDED_TOL[0]} / atol {SHARDED_TOL[1]}), the three "
          f"ranks' parameters the same bits, each rank {want} in its "
          f"loop; one-card walls W = 1 {s1['seconds']!r} s, W = 3 "
          f"{st3['seconds']!r} s; the gradient all-reduce's host ms a "
          f"step by rank {reduce_ms!r}", flush=True)

    # (v) the depth-3 ladder on W = 6 against W = 1, --shard-pad 2
    r6 = got6[str(d["w6_d3"])]
    s6 = r6[0]["stats"]
    _require(s6["rungs"] == s1d["rungs"] and len(s1d["rungs"]) == 2,
             f"depth-3 W = 6: rungs {s6['rungs']} against W = 1's "
             f"{s1d['rungs']}")
    ids = [_ckpt_arrays(p, SHARDED_LADDER - 1)[1]["meta"]["lifecycle"]
           ["member_ids"] for p in (d["w1_d3p2"], d["w6_d3"])]
    _require(ids[0] == ids[1], "depth-3: W = 6 kept other survivors")
    for j in range(2):               # the data columns of (3, 2)
        _require(len({r6[i]["digest"] for i in (j, j + 2, j + 4)}) == 1,
                 f"depth-3 W = 6: data column {j}'s ranks hold other "
                 "parameters")
    for rank, r in enumerate(r6):
        for seg in r["stats"]["segments"]:
            n = seg["end"] - seg["start"]
            depth = len(seg["rank_fused_hidden"][rank % 2])
            _require(seg["launches"] == _segment_want(n, depth),
                     f"depth-3 W = 6 rank {rank}: segment {seg['start']}-"
                     f"{seg['end']} launched {seg['launches']}")
    diff = _ckpt_diff(d["w6_d3"], d["w1_d3p2"])
    res["data_depth3"] = {
        "rungs": s1d["rungs"], "survivors_equal": True,
        "ranks": [seg.get("ranks") for seg in s6["segments"]],
        "w6_vs_w1": diff, "w1_s": s1d["seconds"],
        "w6_s": s6["seconds"],
        "allreduce_host_ms_per_step": [
            r["stats"]["data_reduce_s"] / SHARDED_LADDER * 1e3 for r in r6]}
    print(f"[data depth-3] W = 6 (data 3 × model 2): rungs {s6['rungs']} "
          f"and the survivors equal to W = 1's (--shard-pad 2), each data "
          f"column the same bits, each rank 2·(depth+1) a step of its own "
          f"depth; the checkpoints apart by {diff!r}; walls W = 1 "
          f"{s1d['seconds']!r} s, W = 6 {s6['seconds']!r} s", flush=True)

    # (vi) the server at W = 3, flushes split over the data axis
    ranks = got3[str(d["w3_serve"])]
    _require(ranks[0]["pred"] == one["pred"], "serve W = 3: predictions "
             "differ from W = 1's")
    for rank, r in enumerate(ranks):
        _require(r["budget"]["launches"] == r["budget"]["budget"] == 2,
                 f"serve W = 3 rank {rank}: budget {r['budget']}")
    # a flush of 48 split in three: each rank's 16 rows gathered by rank 0
    x = check_batch(DATA_BATCH)[0]
    theirs = torch.load(str(d["w3_serve"]) + ".pt")
    shares = serve_logits(d["w1_10k"], x, blocks=3)
    _require(_same_bits(shares, theirs), "serve W = 3: the split flush's "
             "logits are not bitwise W = 1's on the same rows")
    whole = serve_logits(d["w1_10k"], x)
    _require(torch.allclose(theirs, whole, rtol=SHARDED_TOL[0],
                            atol=SHARDED_TOL[1]),
             "serve W = 3: the split flush's logits are beyond the "
             "tolerance of W = 1's whole flush")
    gap = float((theirs - whole).abs().max())
    res["data_serve"] = {"w1": one["serve"], "w3": ranks[0]["serve"],
                         "logits_vs_whole_flush": gap}
    for mode in one["serve"]:
        a, b = one["serve"][mode], ranks[0]["serve"][mode]
        print(f"[data serve] {mode:5s} flush {DATA_BATCH}: W = 1 "
              f"{a['req_per_s']!r} req/s p50 {a['p50_ms']!r} p99 "
              f"{a['p99_ms']!r} ms | W = 3 {b['req_per_s']!r} req/s p50 "
              f"{b['p50_ms']!r} p99 {b['p99_ms']!r} ms", flush=True)
    print(f"[data serve] W = 3 predictions equal to W = 1's in every mode; "
          f"a split flush's logits bitwise W = 1's on the same 16-row "
          f"shares, max |diff| {gap!r} from W = 1's whole flush of "
          f"{DATA_BATCH}", flush=True)
    return res


def _ckpt_diff(a: Path, b: Path) -> dict:
    """Where two checkpoints of one tree differ most (bf16 leaves as
    floats): the max |difference|, its array, and how many elements of
    the parameters lie beyond the optimizer tolerance."""
    import numpy as np

    from repro_torch.checkpoint.checkpoint import latest_steps
    za, ta = _ckpt_arrays(a, latest_steps(str(a))[-1])
    zb, _ = _ckpt_arrays(b, latest_steps(str(b))[-1])
    out = {"max_abs_diff": 0.0, "at": None, "params_beyond_tol": 0,
           "params": 0}
    for k in za:
        x, y = (np.frombuffer(z[k][2], np.dtype(z[k][0])).reshape(z[k][1])
                for z in (za, zb))
        if ta["manifest"][k]["dtype"] == "bfloat16":
            x, y = ((v.astype(np.uint32) << 16).view(np.float32)
                    for v in (x, y))
        x, y = x.astype(np.float64), y.astype(np.float64)
        if not x.size:
            continue
        gap = float(np.abs(x - y).max())
        if gap > out["max_abs_diff"]:
            out.update(max_abs_diff=gap, at=k)
        if k.startswith("params"):
            out["params"] += x.size
            out["params_beyond_tol"] += int(np.sum(~np.isclose(
                x, y, rtol=SHARDED_TOL[0], atol=SHARDED_TOL[1])))
    return out


# --------------------------------------------------------------------- #
# path 4l: LM serving                                                   #
# --------------------------------------------------------------------- #

# the served models: arch id → (layers kept: None = all, prompts, prompt
# length, new tokens).  qwen3-1.7b whole; deepseek-moe-16b at full width,
# its dense layer 0 and three MoE layers; h2o-danube-3-4b at full width,
# two layers, one prompt past its 4,096 window; nemotron-4-340b at full
# width (d_head 192), 2 of its 96 layers (6.9 GB of bf16 weights a layer,
# 18.9 GB of embeddings: 33 GB); mamba2-780m whole (48 SSM layers, no
# attention); hymba-1.5b whole (32 hybrid layers, 3 global, the rest a
# 1,024 window), one prompt of 2,048 tokens past its window
LM_SERVE = {"qwen3-1.7b": (None, 4, 512, 32),
            "deepseek-moe-16b": (4, 4, 512, 32),
            "h2o-danube-3-4b": (2, 1, 4608, 16),
            "nemotron-4-340b": (2, 4, 512, 16),
            "mamba2-780m": (None, 4, 512, 32),
            "hymba-1.5b": (None, 1, 2048, 32)}
# logits of the kernels' run against the plain versions' (both bf16): the
# largest |difference| within LM_LOGIT_TOL of the plain logits' largest
# |value| (rtol 1e-2 of the kernel API's bf16 entries, taken of the
# outputs' scale: a model's logits cross zero, and each layer's bf16
# roundings move every logit by a share of that scale), and never below
# 2 bf16 ulps of that value: the logits are bf16, so one rounding of the
# largest apart is 1 ulp, 2^-8 to 2^-7 of the scale by where it sits in
# its binade (on an H100 every step read 1 ulp apart)
LM_LOGIT_TOL = 1e-2
# the one model whose logits that rule does not hold (hymba-1.5b: 32
# hybrid layers, the kernels' and plain runs 3.0-3.75 apart at scales of
# 143-240, the rule 2.0-2.4, on an H100); where the rule does not hold
# them, they are held to the same calls on the parameters widened to f32:
# the kernels' run no farther from that f32 function than
# LM_LOGIT_F32_RATIO times the plain run is.  The limit, from readings
# on an H100 (scripts/lm_logit_control.py): the kernels' run reads at most
# 1.056 (every step of three runs), the kernel with its window dropped
# 13.9-27.9; subtler planted faults (the softmax scale one bf16 ulp or
# 1 % high, a window one key wider) read 1.04-1.13, inside bf16's own
# drift at 32 layers: the per-element check of each call
# (``_lm_kernel_fields``) is what fails them (1.09-11.0 of its
# tolerance; the sound kernel 0.55-0.56).  Every other model is held to
# the rule alone (nemotron-4-340b's f32 copy, 65 GB beside its 33 GB in
# bf16, would not fit on the card)
LM_LOGIT_F32 = ("hymba-1.5b",)
LM_LOGIT_F32_RATIO = 1.25


def _flash_layers(cfg) -> int:
    """The layers whose forward is one flash-attention call: attention
    and hybrid (attention beside SSM heads) mixers."""
    return sum(1 for l in cfg.layers if l.mixer in ("attn", "hybrid"))


def _lm_model(arch_id: str):
    """The arch's full config, its depth cut to ``LM_SERVE``'s layers →
    (arch, the full config's layer count)."""
    import dataclasses

    from repro_torch.configs import get_arch
    arch = get_arch(arch_id)
    full = arch.model.n_layers
    keep = LM_SERVE[arch_id][0]
    if keep is not None:
        arch = dataclasses.replace(arch, model=dataclasses.replace(
            arch.model, layers=arch.model.layers[:keep]))
    return arch, full


@contextmanager
def _lm_ops(flash, moe):
    """``ops.flash_attention`` and ``ops.moe_gemm`` replaced for the body
    by ``flash(the kernel's entry)`` and ``moe(...)``.  Nothing of the port
    changes; its modules call ``ops.*`` at call time."""
    from repro_torch.kernels import ops
    saved = ops.flash_attention, ops.moe_gemm
    ops.flash_attention, ops.moe_gemm = flash(saved[0]), moe(saved[1])
    try:
        yield
    finally:
        ops.flash_attention, ops.moe_gemm = saved


def _plain_lm_kernels():
    """The reference run of the same calls: the plain versions on the same
    (card) tensors."""
    from repro_torch.kernels import flash_attn as fak
    from repro_torch.kernels import grouped_gemm as moek

    def flash(_):
        return lambda q, k, v, scale, causal=True, window=0, **__: \
            fak.flash_attn_dense(q, k, v, scale=scale, causal=causal,
                                 window=int(window or 0))

    def moe(_):
        return lambda x, w, ids, *, block_t=128, **__: \
            moek.moe_gemm_dense(x, w, ids, block_t=block_t)

    return _lm_ops(flash, moe)


def _recorded_lm_calls(calls: dict):
    """Each ``ops.flash_attention`` and ``ops.moe_gemm`` call's arguments
    kept in ``calls`` (its first call of each kind and shape), the calls
    made as they are."""
    def flash(entry):
        def call(q, k, v, scale, causal=True, window=0, **kw):
            calls.setdefault(("flash", tuple(q.shape), int(window or 0)),
                             (q, k, v, scale, causal, int(window or 0)))
            return entry(q, k, v, scale, causal, window, **kw)
        return call

    def moe(entry):
        def call(x, w, ids, *, block_t=128, **kw):
            calls.setdefault(("moe", tuple(x.shape), tuple(w.shape)),
                             (x, w, ids, block_t))
            return entry(x, w, ids, block_t=block_t, **kw)
        return call

    return _lm_ops(flash, moe)


def _logit_err(name: str, got, want, vocab: int, power: str,
               f32=None) -> dict:
    """The kernels' logits against the plain versions' over the real
    vocabulary (the padded slots hold −1e30): max |difference| within
    ``LM_LOGIT_TOL`` of the plain logits' scale; where that rule does not
    hold them and ``f32()`` gives the same calls' logits on the
    parameters widened to f32 (given for ``LM_LOGIT_F32``'s models only),
    the kernels' run no farther from that f32 function than
    ``LM_LOGIT_F32_RATIO`` times the plain run is (bf16's own reach: two
    bf16 runs a rounding apart in every layer drift apart as far as
    either drifts from f32; each kernel call is held per element at the
    model's shapes by ``_lm_kernel_fields``); the argmax agreement
    reported."""
    import torch
    got, want = got[..., :vocab].float(), want[..., :vocab].float()
    _require(bool(torch.isfinite(got).all()), f"{name}: non-finite logits")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    rule = max(LM_LOGIT_TOL * scale,
               2 * 2.0 ** (math.floor(math.log2(scale)) - 7))
    same = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    out = {"max_abs_err": err, "scale": scale, "rule": rule,
           "argmax_agree": same}
    print(f"[lm serve] {name} ({power}): logits max |kernels - plain| "
          f"{err!r} of scale {scale!r} (rule {rule!r}); argmax agree "
          f"{same!r}", flush=True)
    if err <= rule or f32 is None:
        _require(err <= rule, f"{name}: logits max |err| {err} beyond "
                 f"{rule} (scale {scale})")
        return out
    ref = f32()[..., :vocab].float()
    out["kernels_f32"] = (got - ref).abs().max().item()
    out["plain_f32"] = (want - ref).abs().max().item()
    out["f32_ratio"] = out["kernels_f32"] / out["plain_f32"]
    print(f"[lm serve] {name}: beyond the rule; from the f32 function "
          f"the kernels' run {out['kernels_f32']!r}, the plain run's "
          f"{out['plain_f32']!r} (ratio {out['f32_ratio']!r}, limit "
          f"{LM_LOGIT_F32_RATIO})", flush=True)
    _require(out["f32_ratio"] <= LM_LOGIT_F32_RATIO,
             f"{name}: the kernels' logits {out['kernels_f32']} from the "
             f"f32 function, beyond {LM_LOGIT_F32_RATIO} times the plain "
             f"run's {out['plain_f32']}")
    return out


def _lm_kernel_fields(calls: dict, power: str) -> dict:
    """Each distinct flash-attention and grouped-GEMM call of a prefill at
    the model's shapes: the kernel against its plain version, the kernel,
    plain version and library call timed (SDPA with ``is_causal`` and
    ``enable_gqa``, a window as a boolean mask; ``torch.bmm`` over the
    (E, C, ·) capacity buffer), the bound from this call's bytes and
    operations at the bf16 peak."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attn as fak
    from repro_torch.kernels import grouped_gemm as moek
    out = {}
    for key, args in calls.items():
        if key[0] == "flash":
            q, k, v, sc, causal, window = args
            mask = (fak.attention_mask(q.shape[2], k.shape[2], causal=causal,
                                       window=window, device=q.device)
                    if window else None)
            library = partial(F.scaled_dot_product_attention, q, k, v,
                              attn_mask=mask, is_causal=mask is None
                              and causal, scale=sc, enable_gqa=True)
            row = compare(
                "flash_attention",
                partial(fak.flash_attention_cuda, q, k, v, scale=sc,
                        causal=causal, window=window),
                partial(fak.flash_attn_dense, q, k, v, scale=sc,
                        causal=causal, window=window),
                library, _nbytes(q, k, v, q),
                4 * q.shape[0] * q.shape[1] * q.shape[3]
                * _pairs(q.shape[2], k.shape[2], causal, window), None, 3,
                _flash_bf16_tol(fak.flash_attn_dense, q, k, v, scale=sc,
                                causal=causal, window=window),
                BF16_FLOP_PER_S,
                label=f"flash_attention {tuple(q.shape)} ({power})")
            row["path"] = fak.kernel_path(q.dtype, q.shape[-1])
            name = "flash {}x{}x{}x{} w{}".format(*q.shape, window)
        else:
            x, w, ids, bt = args
            e = w.shape[0]
            library = partial(torch.bmm, x.view(e, -1, x.shape[1]), w)
            row = compare(
                "moe_gemm", partial(moek.moe_gemm_cuda, x, w, ids,
                                    block_t=bt),
                partial(moek.moe_gemm_dense, x, w, ids, block_t=bt),
                library, _nbytes(x, w, ids) + x.shape[0] * w.shape[2]
                * x.element_size(), 2 * x.shape[0] * x.shape[1] * w.shape[2],
                None, 3, MOE_BF16_TOL, BF16_FLOP_PER_S,
                label=f"moe_gemm {tuple(x.shape)}x{tuple(w.shape)} "
                f"({power})")
            row["path"] = moek.kernel_path(x.dtype, x.shape[1], w.shape[2],
                                           bt)
            if row["path"] == "fma":
                row["fma_instance"] = moek.fma_instance(
                    x.shape[1], w.shape[2], bt, x, w)
            row["block_t"] = bt
            name = "moe {}x{} -> {}".format(*x.shape, w.shape[2])
        out[name] = {k: row[k] for k in (
            "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "path", "fma_instance", "block_t") if k in row}
        out[name]["card"] = power
    return out


def lm_serve_one(arch_id: str, power: str) -> tuple:
    """One model of path 4l: ``generate_lm`` twice (a first run, then the
    timed one), the counters set to 0 just before each and read just
    after; then each kernel call's fields at the model's shapes (every
    distinct shape and window); then the prefill's last logits and
    teacher-forced decode steps against the same calls on the plain
    versions (``_logit_err``).  Returns (results, launches of the timed
    run)."""
    import dataclasses

    import torch

    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.launch import serve
    from repro_torch.launch.launch_count import (kernel_launches,
                                                 reset_kernel_launches)
    from repro_torch.models import lm
    arch, full_layers = _lm_model(arch_id)
    cfg = arch.model
    _, b, s, new = LM_SERVE[arch_id]
    t0 = time.perf_counter()
    params = lm.init_params(torch.Generator("cuda").manual_seed(17), cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    print(f"[lm serve] {arch_id}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"vocab {cfg.vocab}, {n_params} parameters, {n_bytes} B "
          f"({cfg.param_dtype}), init {time.perf_counter() - t0:.2f} s",
          flush=True)
    gen = torch.Generator("cuda").manual_seed(18)
    prompts = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                            device="cuda", dtype=torch.int32)
    attn = _flash_layers(cfg)
    moe = sum(1 for l in cfg.layers if l.ffn == "moe")
    want = {"flash_attention": attn, "moe_gemm": 3 * moe * new}
    runs = []
    for run in range(2):
        torch.cuda.synchronize()
        reset_kernel_launches()
        toks, stats = serve.generate_lm(arch, prompts, new, "cuda",
                                        params=params)
        torch.cuda.synchronize()
        n = {k: v for k, v in kernel_launches().items() if v}
        _require(n == {k: v for k, v in want.items() if v},
                 f"{arch_id} run {run}: launches {n}, expected {want} "
                 "(flash once per attention or hybrid layer in the "
                 "prefill, none in decode; three grouped GEMMs per MoE "
                 "layer per forward)")
        runs.append((toks, stats, n))
    toks, stats, n = runs[1]
    _require(toks.shape == (b, s + new), f"{arch_id}: tokens {toks.shape}")
    _require(torch.equal(toks, runs[0][0]), f"{arch_id}: two greedy runs "
             "gave different tokens")
    res = {"layers": cfg.n_layers, "layers_of": full_layers,
           "params": n_params, "param_bytes": n_bytes, "batch": b,
           "prompt": s, "new_tokens": new, "launches": n,
           "prefill_ms": stats["prefill_s"] * 1e3,
           "decode_ms_per_token": stats["decode_s"] * 1e3 / max(new - 1, 1),
           "tok_per_s": stats["tok_per_s"],
           "first_run": {"prefill_ms": runs[0][1]["prefill_s"] * 1e3,
                         "decode_s": runs[0][1]["decode_s"]},
           "card": power}
    print(f"[lm serve] {arch_id} ({power}): prefill {res['prefill_ms']!r} "
          f"ms ({b} x {s}), decode {res['decode_ms_per_token']!r} ms a "
          f"token ({b} a step), {res['tok_per_s']!r} tokens/s; launches "
          f"{n}", flush=True)

    # the logits: the kernels' prefill and teacher-forced decode (the
    # greedy tokens) against the same calls on the plain versions
    def teacher_forced(p, c):
        """The prefill's last logits, then up to 8 decode steps on the
        greedy tokens."""
        step = lm.make_serve_step(c)
        last, caches = lm.prefill(p, c, {"tokens": prompts},
                                  max_len=s + new)
        logits = [last]
        for i in range(min(new - 1, 8)):
            pos = torch.full((b,), s + i, dtype=torch.int32, device="cuda")
            lg, caches = step(p, caches,
                              {"tokens": toks[:, s + i:s + i + 1]}, pos)
            logits.append(lg)
        return logits

    step = lm.make_serve_step(cfg)
    with torch.inference_mode():
        outs = {}
        for label in ("kernels", "plain"):
            with (_plain_lm_kernels() if label == "plain"
                  else nullcontext()):
                outs[label] = teacher_forced(params, cfg)

        def f32(i):
            """Logits i of the same calls on the plain versions with the
            parameters widened to f32 (run once, when a check needs it)."""
            def fn():
                if "f32" not in outs:
                    with _plain_lm_kernels():
                        outs["f32"] = teacher_forced(
                            tree_map(lambda t: t.float(), params),
                            dataclasses.replace(cfg, param_dtype="float32"))
                return outs["f32"][i]
            return fn

        # each kernel call at the model's shapes first: the kernel against
        # its plain version per element, before the model's logits
        calls = {}
        with _recorded_lm_calls(calls):
            lm.prefill(params, cfg, {"tokens": prompts}, max_len=s + new)
        step_calls = {}
        caches = lm.prefill(params, cfg, {"tokens": prompts},
                            max_len=s + new)[1]
        with _recorded_lm_calls(step_calls):
            step(params, caches, {"tokens": toks[:, s:s + 1]},
                 torch.full((b,), s, dtype=torch.int32, device="cuda"))
        del caches
        calls.update(step_calls)
        res["kernels"] = _lm_kernel_fields(calls, power)
        del calls, step_calls

        held_f32 = arch_id in LM_LOGIT_F32
        res["prefill_logits"] = _logit_err(
            f"{arch_id} prefill", outs["kernels"][0], outs["plain"][0],
            cfg.vocab, power, f32(0) if held_f32 else None)
        res["decode_logits"] = [
            _logit_err(f"{arch_id} decode step {i}", a, p, cfg.vocab, power,
                       f32(i + 1) if held_f32 else None)
            for i, (a, p) in enumerate(zip(outs["kernels"][1:],
                                           outs["plain"][1:]))]
        plain_greedy = torch.cat([lg[:, -1:, :cfg.vocab].argmax(-1)
                                  for lg in outs["plain"]], 1)
        res["greedy_agree_plain"] = (
            plain_greedy == toks[:, s:s + plain_greedy.shape[1]]) \
            .float().mean().item()
        del outs
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res, n


def lm_serve_path(workdir: Path) -> tuple:
    """Path 4l (``chip_smoke.py --lm DIR``): the decoder LMs served by
    ``repro_torch.launch.serve.generate_lm`` with random bf16 weights from
    a seeded generator (``lm_serve_one`` each): qwen3-1.7b whole (28
    layers, 4 prompts of 512 tokens, 32 greedy tokens), deepseek-moe-16b
    at full width cut to 4 layers (its dense layer 0, three MoE layers of
    64 experts, top-6, 2 shared), h2o-danube-3-4b at full width cut to 2
    layers (one prompt of 4,608 tokens, past its 4,096 window, 16 tokens),
    nemotron-4-340b at full width cut to 2 of 96 layers (d_head 192, 4 ×
    512 + 16), mamba2-780m whole (4 × 512 + 32, no attention) and
    hymba-1.5b whole (1 × 2,048 + 32, past its 1,024 window).  Returns
    (results, the launches of the timed runs, summed)."""
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60)
    power = smi.stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    res, total = {"card": power}, {}
    for arch_id in LM_SERVE:
        res[arch_id], n = lm_serve_one(arch_id, power)
        for k, v in n.items():
            total[k] = total.get(k, 0) + v
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    res["seconds"] = time.perf_counter() - t0
    print(f"[lm serve] path 4l in {res['seconds']:.1f} s on {power}; peak "
          f"device memory {res['peak_gib']:.2f} GiB; launches {total}",
          flush=True)
    return res, total


# --------------------------------------------------------------------- #
# path 4m: LM training                                                  #
# --------------------------------------------------------------------- #

# whole models through train.main, B 4 × S 512, no checkpoint
# (--ckpt-every 0: a step-0 save of qwen3-1.7b would write 17 GB), AdamW
# with f32 moments, remat: qwen3-1.7b 16 steps (warmup 4), hymba-1.5b 8
# (warmup 2), mamba2-780m 4 (warmup 1); ``compare``: the trained state's
# gradients and update held to the plain versions' (``lm_train_compare``)
LM_TRAIN = {"qwen3-1.7b": dict(batch=4, seq=512, steps=16, warmup=4,
                               compare=True),
            "hymba-1.5b": dict(batch=4, seq=512, steps=8, warmup=2,
                               compare=False),
            "mamba2-780m": dict(batch=4, seq=512, steps=4, warmup=1,
                                compare=True)}
# deepseek-moe-16b at full width cut to 4 of 28 layers (path 4l's cut):
# 4 steps of B 4 × S 512 through run_lm, then served, 4 new tokens
LM_TRAIN_MOE = dict(layers=4, batch=4, seq=512, steps=4, new=4)
HELDOUT_STEP = 1_000_000     # a TokenTask step that no run draws


def _token_batch(cfg, step: int, b: int, s: int) -> dict:
    """``TokenTask(vocab, seed 0)``'s batch of ``step`` on the card."""
    import torch

    from repro_torch.data.synthetic import TokenTask
    return {k: torch.from_numpy(v).to("cuda") for k, v in
            TokenTask(vocab=cfg.vocab, seed=0).batch(step, b, s).items()}


def _heldout_loss(params, cfg, batch) -> float:
    """The step's loss (NLL, z-loss and aux) on ``batch``, no gradient."""
    import torch

    from repro_torch.models import lm
    with torch.inference_mode():
        return lm.loss_and_metrics(params, cfg, batch)[0].item()


def _bf16_rule(name: str, got, want, reach: float = 0.0) -> dict:
    """Path 4l's bf16 rule on a tensor or a scalar: max |got − want|
    within ``LM_LOGIT_TOL`` of ``want``'s scale (its largest |value|),
    never below 2 bf16 ulps of that scale, or within ``reach`` (bf16's
    own: ``want``'s max distance from the same function in f32) where
    that is larger; a leaf whose scale is 0 must be equal."""
    import torch
    got = torch.as_tensor(got).float()
    want = torch.as_tensor(want).float().to(got.device)
    _require(bool(torch.isfinite(got).all()), f"{name}: non-finite values")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    rule = (max(LM_LOGIT_TOL * scale,
                2 * 2.0 ** (math.floor(math.log2(scale)) - 7))
            if scale > 0 else 0.0)
    tol = max(rule, reach)
    _require(err <= tol, f"{name}: max |kernels - plain| {err} beyond {tol} "
             f"(scale {scale}, bf16's reach {reach})")
    return {"max_abs_err": err, "scale": scale, "rule": rule,
            "bf16_reach": reach, "tol": tol}


def _max_diff(a, b) -> float:
    import torch
    return (torch.as_tensor(a).float()
            - torch.as_tensor(b).float()).abs().max().item()


def _launched() -> dict:
    from repro_torch.launch.launch_count import kernel_launches
    return {k: v for k, v in kernel_launches().items() if v}


def lm_train_whole(arch_id: str, workdir: Path, power: str) -> tuple:
    """Path 4m (a): a whole model (``LM_TRAIN``) trained by
    ``train.main``: the counters, the step walls, the held-out loss before
    and after (it must fall), the peak device memory; two more steps of
    the driver's step function under ``torch.profiler``: device ms, idle
    share, launches a step.  Returns (results, the training run's
    launches, the trained state two profiled steps later)."""
    import statistics

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import train
    from repro_torch.launch.launch_count import reset_kernel_launches
    from repro_torch.models import lm
    arch = get_arch(arch_id)
    cfg = arch.model
    _require(cfg.remat and cfg.param_dtype == "bfloat16",
             f"{arch_id} is not bf16 with remat")
    d = LM_TRAIN[arch_id]
    b, s, steps = d["batch"], d["seq"], d["steps"]
    held = _token_batch(cfg, HELDOUT_STEP, b, s)
    # the held-out loss before: run_lm's init (a generator seeded 0)
    p0 = lm.init_params(torch.Generator("cuda").manual_seed(0), cfg)
    n_params = sum(t.numel() for t in tree_leaves(p0))
    before = _heldout_loss(p0, cfg, held)
    del p0
    gc.collect()
    torch.cuda.empty_cache()

    # (a) train.main, the counters set to 0 just before and read after
    flags = ["--arch", arch_id, "--batch", str(b), "--seq", str(s),
             "--steps", str(steps), "--warmup", str(d["warmup"]),
             "--ckpt-every", "0", "--ckpt-dir", str(workdir / arch_id),
             "--device", "cuda"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_launches()
    t0 = time.perf_counter()
    runner = train.main(flags)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    n = _launched()
    attn = _flash_layers(cfg)
    want = {"flash_attention": attn * steps * 2} if attn else {}
    _require(n == want, f"{arch_id} training: launches {n}, expected "
             f"{want} (two flash launches an attention or hybrid layer a "
             "step under remat, no other kernel)")
    peak = torch.cuda.max_memory_allocated()
    walls = [dt for _, dt in runner.walls]
    losses = [m["loss"] for _, m in runner.metrics_log]
    _require(len(walls) == steps and runner.restarts == 0
             and all(math.isfinite(x) for x in losses),
             f"{arch_id} training: {len(walls)} steps, {runner.restarts} "
             f"restarts, losses {losses}")
    step_ms = statistics.median(walls[2:]) * 1e3
    state = runner.state
    after = _heldout_loss(state["params"], cfg, held)
    print(f"[lm train] {arch_id} ({power}): {n_params} parameters, "
          f"train.main {main_s:.1f} s; step {step_ms!r} ms (median of "
          f"steps 2-{steps - 1}); loss {losses[0]!r} -> {losses[-1]!r}; "
          f"held-out {before!r} -> {after!r}; peak "
          f"{peak / 2 ** 30:.2f} GiB; launches {n}", flush=True)
    _require(after < before, f"{arch_id}: the held-out loss {after} is "
             f"not below its value before training, {before}")

    # two more steps of the driver's own step function, profiled
    reset_kernel_launches()
    with _profiled() as prof:
        for k in range(2):
            state, _ = runner.step_fn(state, steps + k)
    n_prof = _launched()
    runner.state = None
    del runner
    cuda = torch.autograd.DeviceType.CUDA
    dev = [e for e in prof.events() if e.device_type == cuda
           and SENTINEL not in e.name]
    flash_seen = sum(1 for e in dev if "flash_attn" in e.name)
    _require(flash_seen == n_prof.get("flash_attention", 0) == 4 * attn,
             f"profiled steps: {flash_seen} flash kernels seen, counters "
             f"{n_prof}")
    device_ms = sum(e.device_time_total for e in dev) / 2e3
    flash_ms = sum(e.device_time_total for e in dev
                   if "flash_attn" in e.name) / 2e3
    by_name = {}
    for e in dev:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) \
            + e.device_time_total / 2e3
    res = {"layers": cfg.n_layers, "params": n_params, "batch": b,
           "seq": s, "steps": steps, "train_main_s": main_s,
           "step_walls_ms": [w * 1e3 for w in walls],
           "step_wall_ms": step_ms, "losses": losses,
           "heldout_before": before, "heldout_after": after,
           "peak_gib": peak / 2 ** 30, "launches": n,
           "launches_per_step": {k: v / steps for k, v in n.items()},
           "device_ms": device_ms, "flash_device_ms": flash_ms,
           "device_launches": len(dev) / 2,
           "device_idle_share": 1 - device_ms / step_ms,
           "device_ms_by_kernel": dict(sorted(
               by_name.items(), key=lambda kv: -kv[1])[:12]),
           "card": power}
    print(f"[lm train] {arch_id} step: device {device_ms!r} ms in "
          f"{len(dev) / 2} launches (flash {flash_ms!r} ms); idle share "
          f"{res['device_idle_share']!r} of the {step_ms!r} ms step",
          flush=True)
    del prof, dev
    gc.collect()
    torch.cuda.empty_cache()
    return res, n, state


def lm_train_compare(params, opt_state, arch, power: str) -> dict:
    """Path 4m (b)-(c) on a trained state: one batch's gradients
    (``lm.loss_and_grads``, the step's own function) and one
    ``make_train_step`` update through the kernels and through the plain
    versions (4l's swap), every gradient leaf, the loss and the norm at
    4l's bf16 rule or within bf16's own reach, where that is larger: the
    plain run's max distance from the same function on the parameters
    widened to f32 (a bf16 gradient after 28 layers is 2-9 % of its
    leaf's scale from the f32 one, ``scripts/lm_grad_rounding.py``); then
    the update in 2 microbatches, its loss at the same rule and twice the
    flash launches; and the flash call of the training forward at its
    shape against its plain version and SDPA."""
    import dataclasses

    import torch

    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.launch.launch_count import reset_kernel_launches
    from repro_torch.models import lm
    from repro_torch.optim.optimizers import (build_optimizer, global_norm,
                                              warmup_cosine)
    cfg = arch.model
    d = LM_TRAIN[arch.arch_id]
    b, s, steps = d["batch"], d["seq"], d["steps"]
    attn = _flash_layers(cfg)
    batch = _token_batch(cfg, steps, b, s)
    opt = build_optimizer(arch)
    lr_fn = warmup_cosine(arch.lr, d["warmup"], steps)
    runs = {}
    for label in ("kernels", "plain"):
        with (_plain_lm_kernels() if label == "plain" else nullcontext()):
            reset_kernel_launches()
            total, _, grads = lm.loss_and_grads(params, cfg, batch)
            n_grad = _launched()
            _, _, m = lm.make_train_step(cfg, opt, lr_fn)(
                params, opt_state, batch, steps)
            m = {k: v.item() for k, v in m.items()}
            torch.cuda.synchronize()
            n_all = _launched()
        want = ({"flash_attention": 2 * attn}
                if label == "kernels" and attn else {})
        _require(n_grad == want and n_all == {
            k: 2 * v for k, v in want.items()},
            f"{label}: gradient launches {n_grad}, with the update "
            f"{n_all}; expected {want} each")
        runs[label] = (total, grads, m)
        gc.collect()
    (tk, gk, mk), (tp, gp, mp) = runs["kernels"], runs["plain"]
    # the same gradients again: which leaves a replay on the card does
    # not give bitwise (reported, not required: atomics sum in any order)
    _, _, again = lm.loss_and_grads(params, cfg, batch)
    replay = {i: _max_diff(a, b) for i, (a, b) in enumerate(
        zip(tree_leaves(gk), tree_leaves(again))) if not torch.equal(a, b)}
    del again
    # the reference of bf16's reach: the plain versions in f32
    with _plain_lm_kernels():
        tf, _, gf = lm.loss_and_grads(
            tree_map(lambda t: t.float(), params),
            dataclasses.replace(cfg, param_dtype="float32"), batch)
    nf = global_norm(gf).item()
    leaves, worst = [], {"share": 0.0}
    for i, (a, w, f32) in enumerate(zip(tree_leaves(gk), tree_leaves(gp),
                                        tree_leaves(gf))):
        f = _bf16_rule(f"gradient leaf {i}", a, w, _max_diff(w, f32))
        f["share"] = f["max_abs_err"] / f["tol"] if f["tol"] else 0.0
        f["kernels_f32"] = _max_diff(a, f32)
        # reported, not required: the kernels' distance from f32 over the
        # plain run's (scripts/lm_grad_rounding.py reads the same ratio)
        f["f32_ratio"] = (f["kernels_f32"] / f["bf16_reach"]
                          if f["bf16_reach"] else None)
        leaves.append(f)
        if f["share"] >= worst["share"]:
            worst = {"leaf": i, **f}
    loss_reach = abs(tp.item() - tf.item())
    out = {"loss": _bf16_rule("loss", tk, tp, loss_reach),
           "step_loss": _bf16_rule("step loss", mk["loss"], mp["loss"],
                                   loss_reach),
           "grad_norm": _bf16_rule("grad_norm", mk["grad_norm"],
                                   mp["grad_norm"],
                                   abs(mp["grad_norm"] - nf)),
           "f32_loss": tf.item(), "f32_grad_norm": nf,
           "gradient_leaves": leaves, "worst_gradient_leaf": worst,
           "within_rule": sum(f["max_abs_err"] <= f["rule"]
                              for f in leaves),
           "max_f32_ratio": max((f["f32_ratio"] for f in leaves
                                 if f["f32_ratio"] is not None),
                                default=None),
           "kernels_step": mk, "plain_step": mp,
           "replay_not_bitwise": replay}
    del runs, gk, gp, gf
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[lm train] {arch.arch_id} kernels vs plain ({power}): loss "
          f"{tk.item()!r} / "
          f"{tp.item()!r} (f32 {tf.item()!r}), grad_norm "
          f"{mk['grad_norm']!r} / {mp['grad_norm']!r} (f32 {nf!r}); "
          f"{out['within_rule']} of {len(leaves)} gradient leaves within "
          f"4l's rule, every one within max(rule, bf16's reach); the worst "
          f"leaf {worst['leaf']} at {worst['share']!r} of its tolerance "
          f"({worst['max_abs_err']!r} against the rule's {worst['rule']!r} "
          f"and bf16's reach {worst['bf16_reach']!r}); from f32 the "
          f"kernels' gradient at most {out['max_f32_ratio']!r} times the "
          f"plain run's distance (reported); a replay's "
          f"gradients differ at leaves {replay} (max |difference|)",
          flush=True)

    # (c) the same batch in 2 microbatches
    reset_kernel_launches()
    _, _, m2 = lm.make_train_step(cfg, opt, lr_fn, num_micro=2)(
        params, opt_state, batch, steps)
    m2 = {k: v.item() for k, v in m2.items()}
    n2 = _launched()
    _require(n2 == ({"flash_attention": 2 * 2 * attn} if attn else {}),
             f"num_micro 2: launches {n2}, expected twice the step's")
    out["num_micro_2"] = {"step": m2, "launches": n2,
                          "loss": _bf16_rule("num_micro 2 loss", m2["loss"],
                                             mk["loss"], loss_reach)}
    print(f"[lm train] num_micro 2: loss {m2['loss']!r} against "
          f"{mk['loss']!r}; launches {n2}", flush=True)

    # the flash call of the training forward, at its shape
    calls = {}
    with torch.no_grad(), _recorded_lm_calls(calls):
        lm.forward(params, cfg, batch)
    out["kernels"] = _lm_kernel_fields(calls, power)
    del calls
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_train_moe(workdir: Path, power: str) -> tuple:
    """Path 4m (d): deepseek-moe-16b at full width cut to 4 of 28 layers,
    trained by ``run_lm`` (no grouped-GEMM launch: the experts train on
    JAX's einsum route), every expert's gradient finite and non-zero,
    then the trained parameters served by ``generate_lm`` (three
    grouped-GEMM launches a MoE layer a forward).  Returns (results, the
    training run's launches)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import serve, train
    from repro_torch.launch.launch_count import reset_kernel_launches
    from repro_torch.models import lm
    d = LM_TRAIN_MOE
    arch = get_arch("deepseek-moe-16b")
    full = arch.model.n_layers
    arch = dataclasses.replace(arch, model=dataclasses.replace(
        arch.model, layers=arch.model.layers[:d["layers"]]))
    cfg = arch.model
    attn = sum(1 for ls in cfg.layers if ls.mixer == "attn")
    moe = sum(1 for ls in cfg.layers if ls.ffn == "moe")
    args = train.parser().parse_args([
        "--arch", "deepseek-moe-16b", "--batch", str(d["batch"]), "--seq",
        str(d["seq"]), "--steps", str(d["steps"]), "--warmup", "1",
        "--ckpt-every", "0", "--ckpt-dir", str(workdir / "deepseek"),
        "--device", "cuda"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_launches()
    t0 = time.perf_counter()
    runner = train.run_lm(arch, args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = _launched()
    want = {"flash_attention": attn * d["steps"] * (2 if cfg.remat else 1)}
    _require(n == want, f"deepseek-moe-16b training: launches {n}, expected "
             f"{want} (no grouped GEMM in training)")
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for _, m in runner.metrics_log]
    walls = [dt * 1e3 for _, dt in runner.walls]
    params = runner.state["params"]
    runner.state = None
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    batch = _token_batch(cfg, d["steps"], d["batch"], d["seq"])
    reset_kernel_launches()
    _, _, grads = lm.loss_and_grads(params, cfg, batch)
    _require(_launched() == {"flash_attention": attn * 2},
             f"deepseek gradients: launches {_launched()}")
    experts = 0
    for gi, sub in grads.items():
        if not (gi.startswith("g") and "experts" in sub.get("ffn", {})):
            continue
        for name, g in sub["ffn"]["experts"].items():
            _require(bool(torch.isfinite(g).all()),
                     f"deepseek {gi} {name}: a non-finite gradient")
            per = g.float().abs().flatten(2).amax(2)       # (layers, E)
            _require(bool((per > 0).all()), f"deepseek {gi} {name}: "
                     f"{int((per == 0).sum())} (layer, expert) gradients "
                     "are all zero")
            experts += per.numel()
    _require(experts == 3 * moe * cfg.moe.num_experts,
             f"deepseek: {experts} expert gradients checked")
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator("cuda").manual_seed(18)
    prompts = torch.randint(0, cfg.vocab, (d["batch"], d["seq"]),
                            generator=gen, device="cuda", dtype=torch.int32)
    reset_kernel_launches()
    toks, stats = serve.generate_lm(arch, prompts, d["new"], "cuda",
                                    params=params)
    torch.cuda.synchronize()
    n_serve = _launched()
    want_serve = {"flash_attention": attn, "moe_gemm": 3 * moe * d["new"]}
    _require(n_serve == want_serve, f"deepseek served after training: "
             f"launches {n_serve}, expected {want_serve}")
    _require(toks.shape == (d["batch"], d["seq"] + d["new"]),
             f"deepseek served: tokens {tuple(toks.shape)}")
    res = {"layers": cfg.n_layers, "layers_of": full,
           "params": sum(t.numel() for t in tree_leaves(params)),
           "run_lm_s": secs, "step_walls_ms": walls, "losses": losses,
           "peak_gib": peak / 2 ** 30, "launches": n,
           "expert_gradients_checked": experts,
           "serve_launches": n_serve,
           "serve_prefill_ms": stats["prefill_s"] * 1e3, "card": power}
    print(f"[lm train] deepseek-moe-16b ({cfg.n_layers} of {full} layers, "
          f"{power}): run_lm {secs:.1f} s, steps {walls} ms, loss "
          f"{losses}; peak {res['peak_gib']:.2f} GiB; launches {n}; "
          f"{experts} (layer, expert) gradients finite and non-zero; "
          f"served: launches {n_serve}", flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res, n


def lm_train_path(workdir: Path) -> tuple:
    """Path 4m (``chip_smoke.py --lm-train DIR``): LM training on the card
    (``lm_train_whole``: qwen3-1.7b, hymba-1.5b and mamba2-780m whole;
    ``lm_train_compare`` on qwen3's and mamba2's trained states;
    ``lm_train_moe``).  Returns (results, the training runs' launches,
    summed)."""
    import torch

    from repro_torch.configs import get_arch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60)
    power = smi.stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    res, total = {"card": power}, {}
    for arch_id in LM_TRAIN:
        res[arch_id], n, state = lm_train_whole(arch_id, workdir, power)
        if LM_TRAIN[arch_id]["compare"]:
            res[arch_id]["compare"] = lm_train_compare(
                state["params"], state["opt"], get_arch(arch_id), power)
        del state
        gc.collect()
        torch.cuda.empty_cache()
        for k, v in n.items():
            total[k] = total.get(k, 0) + v
    res["deepseek-moe-16b"], n = lm_train_moe(workdir, power)
    for k, v in n.items():
        total[k] = total.get(k, 0) + v
    res["seconds"] = time.perf_counter() - t0
    print(f"[lm train] path 4m in {res['seconds']:.1f} s on {power}; "
          f"training launches {total}", flush=True)
    return res, total


# --------------------------------------------------------------------- #
# the kernel API at LM widths: flash attention and the grouped GEMM     #
# --------------------------------------------------------------------- #

def _moe_ids(counts, block_t: int, device):
    """Per-expert row counts → (per-block expert ids, each run's first
    row), every run padded up to a multiple of ``block_t``."""
    import torch
    blocks = (counts + block_t - 1) // block_t
    ids = torch.repeat_interleave(
        torch.arange(counts.numel(), device=device), blocks).to(torch.int32)
    start = torch.cumsum(blocks * block_t, 0) - blocks * block_t
    return ids, start


def lm_inputs():
    """The phase's inputs, made on the card from a seeded generator:
    qwen3-1.7b's q, k, v (f32, and a bf16 copy), h2o-danube-3-4b's (f32,
    and a bf16 copy), nemotron-4-340b's (f32, and a bf16 copy),
    deepseek-moe-16b's capacity buffer and expert weights for both
    projections (f32, and bf16 copies; weights at the 1/sqrt(fan-in) scale
    of an init), and a seeded top-6 routing of 4096 tokens with each
    expert's run padded to 128 rows and the last eight experts given no
    token (ragged runs, some empty)."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(13)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    c, d, nm = QWEN3, DANUBE, NEMOTRON
    qkv = (randn(c["b"], c["h"], c["s"], c["dh"]),
           randn(c["b"], c["hkv"], c["s"], c["dh"]),
           randn(c["b"], c["hkv"], c["s"], c["dh"]))
    qkv_d = tuple(randn(d["b"], n, d["s"], d["dh"])
                  for n in (d["h"], d["hkv"], d["hkv"]))
    qkv_n = tuple(randn(nm["b"], n, nm["s"], nm["dh"])
                  for n in (nm["h"], nm["hkv"], nm["hkv"]))
    m = MOE
    e, dm, f = m["experts"], m["d"], m["f"]
    t = e * m["capacity"]
    moe = {"ids": _moe_ids(torch.full((e,), m["capacity"], device=dev),
                           m["block_t"], dev)[0],
           "up": (randn(t, dm), randn(e, dm, f, scale=dm ** -0.5)),
           "down": (randn(t, f), randn(e, f, dm, scale=f ** -0.5))}
    # the ragged layout: tokens routed top-6, grouped by expert
    logits = randn(m["tokens"], e)
    logits[:, e - 8:] = float("-inf")
    flat = logits.topk(m["top_k"], dim=-1).indices.reshape(-1)
    counts = torch.bincount(flat, minlength=e)
    ids_r, start = _moe_ids(counts, m["block_t"], dev)
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order]
    rank = torch.arange(flat.numel(), device=dev) - (
        torch.cumsum(counts, 0) - counts)[sorted_e]
    x_r = torch.zeros(int(ids_r.numel()) * m["block_t"], dm, device=dev)
    x_r[start[sorted_e] + rank] = randn(m["tokens"], dm)[order // m["top_k"]]
    moe["ragged"] = {"ids": ids_r, "x": x_r,
                     "counts": counts.tolist()}
    return {"qwen3": qkv, "danube_f32": qkv_d,
            "danube": tuple(t.bfloat16() for t in qkv_d),
            "nemotron_f32": qkv_n,
            "nemotron_bf16": tuple(t.bfloat16() for t in qkv_n), "moe": moe}


def lm_path(inp):
    """Phase 6: the JAX package's kernel API (``ops.flash_attention``,
    ``ops.moe_gemm``) driven at full model widths, every kernel counter set
    to 0 just before and read just after: qwen3-1.7b attention forward in
    f32 and bf16, then an f32 forward and backward (each forward exactly
    one flash launch, the backward none; that forward takes the model
    layout's transposed views); h2o-danube-3-4b's windowed bf16
    forward; deepseek-moe-16b's two projections over the capacity buffer in
    f32 and bf16, then both over the ragged routing and the up projection
    again in bf16 (one launch each; every bf16 launch on the tensor cores,
    every f32 one on the FMA units: by each wrapper's ``kernel_path``, and
    by the name of the kernel ``torch.profiler`` saw run); nemotron-4-340b's
    causal forward at d_head 192 in f32 and bf16 (the DP 192 instances, by
    the recorded kernel name).  Returns (outputs, the phase's kernel
    launches, {output: the design that ran; nemotron's also the kernel
    name}).
    """
    import torch

    from repro_torch.kernels import flash_attn as fak
    from repro_torch.kernels import ops
    from repro_torch.launch.launch_count import (kernel_launches,
                                                 reset_kernel_launches)
    from repro_torch.kernels import grouped_gemm as moek

    wants = []

    def once(key, counter, fn, d=None):
        """``fn``'s one launch, its output ``key``; ``d``: a projection's
        input width."""
        mod = fak if counter == "flash" else moek
        n0 = mod.launches
        out = fn()
        want = "wgmma" if out.dtype == torch.bfloat16 else "fma"
        path = (fak.kernel_path(out.dtype, out.shape[-1]) if mod is fak else
                moek.kernel_path(out.dtype, d, out.shape[-1], bt))
        _require(path == want, f"{key}: a {out.dtype} forward took the "
                 f"{path} design, expected {want}")
        _require(mod.launches == n0 + 1, f"{key}: a forward launched "
                 f"{mod.launches - n0} kernels, expected 1")
        wants.append((key, counter, want))
        return out

    q, k, v = inp["qwen3"]
    sc = QWEN3["dh"] ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(14)
    do = torch.randn(q.shape, generator=gen, device="cuda")
    qkv16 = tuple(t.bfloat16() for t in (q, k, v))
    qd, kd, vd = inp["danube"]
    mo = inp["moe"]
    bt = MOE["block_t"]
    rg = mo["ragged"]
    d_up, d_down = MOE["d"], MOE["f"]
    torch.cuda.synchronize()
    with _profiled() as prof:
        reset_kernel_launches()
        t0 = time.perf_counter()
        out = {"qwen3_f32": once("qwen3_f32", "flash",
                                 lambda: ops.flash_attention(
                                     q, k, v, sc, True, 0)),
               "qwen3_bf16": once("qwen3_bf16", "flash",
                                  lambda: ops.flash_attention(
                                      *qkv16, sc, True, 0))}
        # the model's layout: leaves (B, S, heads, dh), attended as strided
        # (B, heads, S, dh) views
        leaves = [t.detach().transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v)]
        o = once("qwen3_grad_out", "flash", lambda: ops.flash_attention(
            *(t.transpose(1, 2) for t in leaves), sc, True, 0))
        n_fwd = fak.launches
        o.backward(do)
        torch.cuda.synchronize()
        _require(fak.launches == n_fwd, "flash_attention: the backward "
                 f"launched {fak.launches - n_fwd} flash kernels, expected 0")
        out["qwen3_grads"] = [t.grad.transpose(1, 2) for t in leaves]
        out["qwen3_grad_out"] = o.detach()
        out["danube_bf16"] = once("danube_bf16", "flash",
                                  lambda: ops.flash_attention(
                                      qd, kd, vd, DANUBE["dh"] ** -0.5, True,
                                      DANUBE["window"]))
        for key in ("nemotron_f32", "nemotron_bf16"):
            out[key] = once(key, "flash", lambda: ops.flash_attention(
                *inp[key], NEMOTRON["dh"] ** -0.5, True, 0))
        for proj in ("up", "down"):
            x, w = mo[proj]
            key = f"moe_{proj}"
            out[f"{key}_f32"] = once(f"{key}_f32", "moe", lambda: ops.moe_gemm(
                x, w, mo["ids"], block_t=bt), x.shape[1])
            out[f"{key}_bf16"] = once(f"{key}_bf16", "moe",
                                      lambda: ops.moe_gemm(
                                          x.bfloat16(), w.bfloat16(),
                                          mo["ids"], block_t=bt), x.shape[1])
        out["moe_ragged_up"] = once("moe_ragged_up", "moe",
                                    lambda: ops.moe_gemm(
                                        rg["x"], mo["up"][1], rg["ids"],
                                        block_t=bt), d_up)
        out["moe_ragged_down"] = once("moe_ragged_down", "moe",
                                      lambda: ops.moe_gemm(
                                          out["moe_ragged_up"], mo["down"][1],
                                          rg["ids"], block_t=bt), d_down)
        out["moe_ragged_up_bf16"] = once(
            "moe_ragged_up_bf16", "moe", lambda: ops.moe_gemm(
                rg["x"].bfloat16(), mo["up"][1].bfloat16(), rg["ids"],
                block_t=bt), d_up)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = {k_: v_ for k_, v_ in kernel_launches().items() if v_}
    _require(n == {"flash_attention": 6, "moe_gemm": 7},
             f"the kernel API phase launched {n}, expected 6 flash and 7 "
             "grouped-GEMM launches and nothing else")
    # which kernels the card ran, in launch order, against each launch's
    # design: the tensor-core kernels are the *wgmma_kernel entries
    ran = [e.name for e in sorted(prof.events(),
                                  key=lambda e: e.time_range.start)
           if e.device_type == torch.autograd.DeviceType.CUDA
           and ("flash_attn" in e.name or "moe_gemm" in e.name)]
    _require(len(ran) == len(wants), f"the profiler saw {len(ran)} kernel "
             f"API launches, expected {len(wants)}: {ran}")
    designs = {}
    for (key, counter, want), name in zip(wants, ran):
        got = "wgmma" if "wgmma_kernel" in name else "fma"
        _require(got == want and ("flash_attn" if counter == "flash"
                                  else "moe_gemm") in name,
                 f"{key}: the card ran {name!r}, expected the {counter} "
                 f"kernel's {want} design")
        _require(not (counter == "moe" and want == "fma")
                 or "moe_gemm_simt_kernel" in name,
                 f"{key}: the card ran {name!r}, expected the SIMT GEMM "
                 "(moe_gemm_simt_kernel)")
        _require(not key.startswith("nemotron") or "<192>" in name,
                 f"{key}: the card ran {name!r}, expected the DP 192 "
                 "instance")
        designs[key] = got
        if key.startswith("nemotron"):
            designs[f"{key}_kernel"] = name.removeprefix("void ") \
                .rsplit("(", 1)[0]
    print("[lm kernels] kernels the card ran: "
          f"{[n.removeprefix('void ').rsplit('(', 1)[0] for n in ran]}",
          flush=True)
    print(f"[lm kernels] phase in {wall:.2f} s; launches {n}; ragged "
          f"routing: {len(rg['counts'])} experts, runs {min(rg['counts'])}"
          f"-{max(rg['counts'])} tokens, "
          f"{sum(c == 0 for c in rg['counts'])} empty, T = "
          f"{rg['x'].shape[0]}", flush=True)
    return out, n, designs


def _by_head_group(fn, q, k, v, **kw):
    """``fn`` over one kv head (and its query heads) at a time, the
    results joined: the dense (Sq, Sk) scores of one group only."""
    import torch
    g = q.shape[1] // k.shape[1]
    return torch.cat([fn(q[:, i * g:(i + 1) * g], k[:, i:i + 1],
                         v[:, i:i + 1], **kw)
                      for i in range(k.shape[1])], dim=1)


def _flash_bf16_tol(plain, q, k, v, **kw):
    """(rtol, per-element atol) of a bf16 attention output against
    ``plain`` on the same inputs (see FLASH_BF16_RTOL): 2^-8 times the
    attention of |v| in f32, plus ATOL."""
    a = plain(q.float(), k.float(), v.float().abs(), **kw)
    return FLASH_BF16_RTOL, a.mul_(2.0 ** -8).add_(ATOL)


def _flash_p_rounded(q, k, v, *, scale, causal, window):
    """The dense oracle with each p rounded to bf16 before the PV product,
    as the kernel rounds it (against the row's final max, where the kernel
    rounds against its running one) → f32.  Used for a second reading of
    the bf16 kernel's error only."""
    import torch

    from repro_torch.kernels.flash_attn import NEG_INF, attention_mask
    g = q.shape[1] // k.shape[1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                     k.repeat_interleave(g, dim=1).float()) * scale
    ok = attention_mask(q.shape[2], k.shape[2], causal=causal, window=window,
                        device=q.device)
    s = torch.where(ok, s, torch.full((), NEG_INF, device=q.device))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    del s
    o = torch.einsum("bhqk,bhkd->bhqd", p.bfloat16().float(),
                     v.repeat_interleave(g, dim=1).float())
    return o / p.sum(-1, keepdim=True)


def _pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """Unmasked (q, k) pairs of one head: what the attention must
    compute."""
    import numpy as np
    qp = np.arange(sq)
    lo = np.maximum(qp - window + 1, 0) if window > 0 else np.zeros_like(qp)
    hi = np.minimum(qp, sk - 1) if causal else np.full_like(qp, sk - 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def check_lm_outputs(inp, out):
    """The phase's outputs: finite, of the expected shapes, each against
    its plain version on the card (flash: the dense oracle at rtol 1e-4 /
    atol 1e-5 in f32 and at the per-element bound of ``_flash_bf16_tol``
    in bf16, danube's by head group, with a second reading of the bf16
    error against ``_flash_p_rounded``; nemotron-4-340b's at d_head 192
    the same way; the grouped GEMM against the
    per-block bmm).  The backward's gradients are held against autograd of
    the dense version: the backward is that same autograd, so this checks
    the Function's wiring (each gradient to its input, through the strided
    views) and exercises no kernel.  Returns {check: max |err|}."""
    import torch

    from repro_torch.kernels import grouped_gemm as moek
    from repro_torch.kernels.flash_attn import flash_attn_dense
    q, k, v = inp["qwen3"]
    sc = QWEN3["dh"] ** -0.5
    errs = {}
    qkv16 = tuple(t.bfloat16() for t in (q, k, v))
    kw = dict(scale=sc, causal=True, window=0)
    for key, args in (("qwen3_f32", (q, k, v)), ("qwen3_bf16", qkv16)):
        got = out[key]
        _require(got.shape == q.shape and got.dtype == args[0].dtype
                 and bool(torch.isfinite(got).all()),
                 f"{key}: {tuple(got.shape)} {got.dtype} not finite")
        tol = ((RTOL, ATOL) if key == "qwen3_f32"
               else _flash_bf16_tol(flash_attn_dense, *args, **kw))
        errs[key] = _close(key, got, flash_attn_dense(*args, **kw), tol)
        del tol
    errs["qwen3_bf16_vs_p_rounded"] = (
        out["qwen3_bf16"].float() - _flash_p_rounded(*qkv16, **kw)
    ).abs().max().item()
    _require(torch.equal(out["qwen3_grad_out"], out["qwen3_f32"]),
             "flash_attention: the forward under autograd differs from the "
             "same forward without it")
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    gen = torch.Generator(device="cuda").manual_seed(14)
    do = torch.randn(q.shape, generator=gen, device="cuda")
    flash_attn_dense(*leaves, **kw).backward(do)
    errs["qwen3_grads_wiring"] = max(
        _close(f"qwen3 d{n}", got, t.grad, (2e-4, 2e-4))
        for n, got, t in zip("qkv", out["qwen3_grads"], leaves))
    del leaves, qkv16
    qd, kd, vd = inp["danube"]
    got = out["danube_bf16"]
    _require(got.shape == qd.shape and bool(torch.isfinite(got).all()),
             "danube: output not finite")
    kw = dict(scale=DANUBE["dh"] ** -0.5, causal=True,
              window=DANUBE["window"])
    dense_g = partial(_by_head_group, flash_attn_dense)
    errs["danube_bf16"] = _close(
        "danube_bf16", got, dense_g(qd, kd, vd, **kw),
        _flash_bf16_tol(dense_g, qd, kd, vd, **kw))
    errs["danube_bf16_vs_p_rounded"] = (got.float() - _by_head_group(
        _flash_p_rounded, qd, kd, vd, **kw)).abs().max().item()
    kw = dict(scale=NEMOTRON["dh"] ** -0.5, causal=True, window=0)
    for key in ("nemotron_f32", "nemotron_bf16"):
        args, got = inp[key], out[key]
        _require(got.shape == args[0].shape and got.dtype == args[0].dtype
                 and bool(torch.isfinite(got).all()),
                 f"{key}: {tuple(got.shape)} {got.dtype} not finite")
        tol = ((RTOL, ATOL) if key == "nemotron_f32"
               else _flash_bf16_tol(flash_attn_dense, *args, **kw))
        errs[key] = _close(key, got, flash_attn_dense(*args, **kw), tol)
        del tol
    errs["nemotron_bf16_vs_p_rounded"] = (
        out["nemotron_bf16"].float()
        - _flash_p_rounded(*inp["nemotron_bf16"], **kw)).abs().max().item()
    mo = inp["moe"]
    for proj in ("up", "down"):
        x, w = mo[proj]
        for dt, tol in (("f32", MOE_F32_TOL), ("bf16", MOE_BF16_TOL)):
            key = f"moe_{proj}_{dt}"
            xx, ww = (x, w) if dt == "f32" else (x.bfloat16(), w.bfloat16())
            got = out[key]
            _require(got.shape == (x.shape[0], w.shape[2])
                     and got.dtype == xx.dtype
                     and bool(torch.isfinite(got).all()),
                     f"{key}: {tuple(got.shape)} not finite")
            errs[key] = _close(key, got, moek.moe_gemm_dense(
                xx, ww, mo["ids"], block_t=MOE["block_t"]), tol)
    rg = mo["ragged"]
    want_up = moek.moe_gemm_dense(rg["x"], mo["up"][1], rg["ids"],
                                  block_t=MOE["block_t"])
    errs["moe_ragged"] = max(
        _close("moe ragged up", out["moe_ragged_up"], want_up, MOE_F32_TOL),
        _close("moe ragged down", out["moe_ragged_down"],
               moek.moe_gemm_dense(out["moe_ragged_up"], mo["down"][1],
                                   rg["ids"], block_t=MOE["block_t"]),
               MOE_F32_TOL))
    errs["moe_ragged_up_bf16"] = _close(
        "moe ragged up bf16", out["moe_ragged_up_bf16"],
        moek.moe_gemm_dense(rg["x"].bfloat16(), mo["up"][1].bfloat16(),
                            rg["ids"], block_t=MOE["block_t"]), MOE_BF16_TOL)
    print(f"[lm kernels] max|err| against the plain versions: {errs}",
          flush=True)
    return errs


def _flash_f32_fields(kernel, qkv, scale, causal, window, parent_libs):
    """The f32 flash kernel's device time (``device_ms``), two launches on
    the same inputs bitwise equal (``bitwise_repeat``), and with
    ``parent_libs`` the parent's f32 kernel through its C entry
    ``flash_attn_fwd_f32`` (signature unchanged): its device time
    (``parent_device_ms``) and the max |difference| of the two trees'
    outputs (``parent_max_abs_err``)."""
    import ctypes

    import torch
    out = kernel()
    _require(torch.equal(out, kernel()), "flash_attention f32: two "
             "launches on the same inputs differ")
    fields = {"bitwise_repeat": True,
              "device_ms": _device_ms(kernel, "flash_attn_fwd_kernel", 10)}
    if parent_libs:
        q, k, v = qkv
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn = parent_libs["flash_attn"].flash_attn_fwd_f32
        fn.argtypes, fn.restype = [P] * 4 + [I] * 6 + [F, I, I, P], I
        o = torch.empty_like(q)
        run = partial(fn, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      o.data_ptr(), q.shape[0], q.shape[1], k.shape[1],
                      q.shape[2], k.shape[2], q.shape[3], scale, int(causal),
                      window, torch.cuda.current_stream().cuda_stream)
        _require(run() == 0, "the parent's flash_attn_fwd_f32 failed")
        torch.cuda.synchronize()
        fields["parent_max_abs_err"] = (o - out).abs().max().item()
        fields["parent_device_ms"] = _device_ms(run, "flash_attn_fwd_kernel",
                                                10)
    print(f"[flash_attention f32, dh {qkv[0].shape[-1]}] {fields}",
          flush=True)
    return fields


def _prefixed(prefix: str, row: dict) -> dict:
    keys = ("max_abs_err", "rtol", "atol", "atol_per_element", "ms",
            "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_device_ms",
            "library_max_abs_err", "library", "bitwise_repeat",
            "parent_device_ms", "parent_max_abs_err",
            "library_none", "path", "log_probs_max_abs_err", "log_probs_ms",
            "log_probs_device_ms", "fma_instance", "bitwise_f32_dequantized",
            "train_max_abs_err", "train_ms", "train_plain_ms",
            "train_bound_ms", "train_bound_by", "train_path",
            "train_device_ms")
    return {f"{prefix}_{k}": row[k] for k in keys if k in row}


def _ptxas(lib: str, build_dir: Path | None = None) -> dict:
    """The report of ``nvcc -Xptxas -v`` in ``build/kernels/<lib>.log``
    (or ``build_dir``'s), printed: {kernel: registers, static
    shared-memory bytes, spill bytes}, each kernel named as ``c++filt``
    demangles it, without its parameters."""
    import re
    import shutil

    from repro_torch.kernels import _build
    out, cur = {}, None
    log = (build_dir or _build.BUILD_DIR) / f"{lib}.log"
    for line in log.read_text().splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            cur = out.setdefault(m[1], {})
        elif m := re.search(r"Function properties for (\w+)", line):
            cur = out.get(m[1])
        elif cur is not None and "spill" in line:
            cur["spill_bytes"] = sum(
                int(n) for n in re.findall(r"(\d+) bytes spill", line))
        elif cur is not None and (m := re.search(r"Used (\d+) reg", line)):
            smem = re.search(r"(\d+) bytes smem", line)
            cur.update(registers=int(m[1]), smem_bytes=int(smem[1]) if smem
                       else 0)
    syms, tool = list(out), shutil.which("c++filt")
    anon = "(anonymous namespace)::"

    def bare(d):  # the name without its parameters
        d = d.removeprefix("void ")
        return (anon if d.startswith(anon) else "") + \
            d.removeprefix(anon).split("(", 1)[0]
    names = syms if not (tool and syms) else [
        bare(d) for d in subprocess.run(
            [tool, *syms], check=True, capture_output=True, text=True,
            timeout=60).stdout.splitlines()]
    out = dict(zip(names, out.values()))
    for name, report in out.items():
        print(f"  ptxas {lib}: {name} {report}", flush=True)
    return out


def lm_rows(inp, lm_n, designs, ptxas, parent_libs=None):
    """The two rows of the kernel API: ``flash_attention`` at qwen3-1.7b's
    shape in f32 (library: ``scaled_dot_product_attention`` with
    ``is_causal`` and ``enable_gqa``), its bf16 times beside them
    (``bf16_*``), and h2o-danube-3-4b's windowed forward in f32
    (``danube_f32_*``) and bf16 (``danube_bf16_*``; library: the same call
    with the window as a boolean mask; the plain version by head group),
    nemotron-4-340b's causal forward at d_head 192 in f32
    (``nemotron_f32_*``) and bf16 (``nemotron_bf16_*``, with its device
    time, two launches bitwise equal and the kernel name phase 6 saw:
    ``*_kernel``; the two DP 192 instances' ptxas as ``dp192_ptxas``);
    the f32 runs also their kernel's device time (``device_ms``), two
    launches bitwise equal, and with ``parent_libs`` (``--parent``) the
    parent's f32 kernel through its C entry: its device time
    (``parent_device_ms``) and the max |difference| of the two trees'
    outputs (``parent_max_abs_err``); ``moe_gemm`` as both
    deepseek-moe-16b projections over the capacity buffer summed, f32
    (library: ``torch.bmm`` on the (64, 512, D) buffer, the einsum of
    ``nn/ffn.py::_expert_ffn``), bf16 beside it, and the ragged routing's
    up projection in f32 (``ragged_*``) and bf16 (``ragged_bf16_*``).
    Each run carries the design phase 6 saw the same shape and dtype run
    (``*path``: ``designs``, from ``lm_path``), and each row the ptxas
    report of its library's kernels (``ptxas``, from ``_ptxas``; the f32
    flash kernel's qwen3-1.7b instance must not spill).  The ragged rows'
    library call is ``torch._grouped_mm`` over the runs where this PyTorch
    has it and it matches the plain version."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attn as fak
    from repro_torch.kernels import grouped_gemm as moek
    sdpa = F.scaled_dot_product_attention

    def flash_row(qkv, causal, window, tol, peak, plain, library, iters,
                  path):
        q = qkv[0]
        sc = q.shape[-1] ** -0.5
        n_pairs = _pairs(q.shape[2], qkv[1].shape[2], causal, window)
        if tol is None:
            tol = _flash_bf16_tol(plain, *qkv, scale=sc, causal=causal,
                                  window=window)
        kernel = partial(fak.flash_attention_cuda, *qkv, scale=sc,
                         causal=causal, window=window)
        row = compare(
            "flash_attention", kernel,
            partial(plain, *qkv, scale=sc, causal=causal, window=window),
            library, _nbytes(*qkv, q),
            4 * q.shape[0] * q.shape[1] * q.shape[3] * n_pairs,
            lm_n["flash_attention"], iters, tol, peak)
        row["path"] = path
        if q.dtype == torch.float32:
            row.update(_flash_f32_fields(kernel, qkv, sc, causal, window,
                                         parent_libs))
        return row

    q, k, v = inp["qwen3"]
    sc = QWEN3["dh"] ** -0.5
    row = flash_row((q, k, v), True, 0, (RTOL, ATOL), F32_FLOP_PER_S,
                    fak.flash_attn_dense,
                    lambda: sdpa(q, k, v, is_causal=True, scale=sc,
                                 enable_gqa=True), 5, designs["qwen3_f32"])
    q16, k16, v16 = (t.bfloat16() for t in (q, k, v))
    row.update(_prefixed("bf16", flash_row(
        (q16, k16, v16), True, 0, None, BF16_FLOP_PER_S,
        fak.flash_attn_dense,
        lambda: sdpa(q16, k16, v16, is_causal=True, scale=sc,
                     enable_gqa=True), 5, designs["qwen3_bf16"])))
    del q16, k16, v16
    sd = DANUBE["dh"] ** -0.5
    mask = fak.attention_mask(DANUBE["s"], DANUBE["s"], causal=True,
                              window=DANUBE["window"], device=q.device)
    # danube in f32 (timed here only: phase 6 runs its bf16 forward) and
    # bf16
    for prefix, key, tol, peak in (
            ("danube_f32", "danube_f32", (RTOL, ATOL), F32_FLOP_PER_S),
            ("danube_bf16", "danube", None, BF16_FLOP_PER_S)):
        qkv_d = inp[key]
        row.update(_prefixed(prefix, flash_row(
            qkv_d, True, DANUBE["window"], tol, peak,
            partial(_by_head_group, fak.flash_attn_dense),
            partial(sdpa, *qkv_d, attn_mask=mask, scale=sd,
                    enable_gqa=True), 3,
            designs.get(prefix) or fak.kernel_path(qkv_d[0].dtype,
                                                   DANUBE["dh"]))))
        del qkv_d
    # nemotron-4-340b at d_head 192 (the DP 192 instances), f32 and bf16:
    # each also its device time, two launches bitwise equal and the kernel
    # name phase 6's profile recorded
    sn = NEMOTRON["dh"] ** -0.5
    for prefix, tol, peak in (("nemotron_f32", (RTOL, ATOL), F32_FLOP_PER_S),
                              ("nemotron_bf16", None, BF16_FLOP_PER_S)):
        qkv_n = inp[prefix]
        fields = flash_row(qkv_n, True, 0, tol, peak, fak.flash_attn_dense,
                           partial(sdpa, *qkv_n, is_causal=True, scale=sn,
                                   enable_gqa=True), 5, designs[prefix])
        if prefix == "nemotron_bf16":     # f32: in _flash_f32_fields
            kernel = partial(fak.flash_attention_cuda, *qkv_n, scale=sn,
                             causal=True, window=0)
            _require(torch.equal(kernel(), kernel()), f"{prefix}: two "
                     "launches on the same inputs differ")
            fields.update(bitwise_repeat=True, device_ms=_device_ms(
                kernel, "flash_attn_wgmma_kernel", 10))
        row.update(_prefixed(prefix, fields))
        row[f"{prefix}_kernel"] = designs[f"{prefix}_kernel"]
        print(f"[flash_attention {prefix}] {row[f'{prefix}_kernel']}: "
              + ", ".join(f"{k} {fields[k]!r}" for k in (
                  "ms", "device_ms", "bound_ms", "plain_ms", "library_ms",
                  "max_abs_err") if k in fields), flush=True)
        del qkv_n
    row["ptxas"] = ptxas["flash_attn"]
    row["dp192_ptxas"] = {k: v for k, v in row["ptxas"].items()
                          if "<192>" in k}
    _require(len(row["dp192_ptxas"]) == 2, "the DP 192 instances' ptxas "
             f"report: {row['dp192_ptxas']}")
    qwen3_instance = [r for name, r in row["ptxas"].items()
                      if "flash_attn_fwd_kernel<128>" in name]
    _require(len(qwen3_instance) == 1
             and qwen3_instance[0].get("spill_bytes") == 0,
             f"flash_attn_fwd_kernel<128> spills: {qwen3_instance}")
    rows = {"flash_attention": row}

    mo, bt = inp["moe"], MOE["block_t"]
    e, cap = MOE["experts"], MOE["capacity"]

    def moe_row(x, w, ids, tol, peak, library, path, iters=5):
        # bytes: x and ids read, y written, and the weights of the experts
        # that ids names (an expert with no run is never read)
        used = w[:1].numel() * w.element_size() * int(
            ids[(ids >= 0) & (ids < w.shape[0])].unique().numel())
        row = compare(
            "moe_gemm", partial(moek.moe_gemm_cuda, x, w, ids, block_t=bt),
            partial(moek.moe_gemm_dense, x, w, ids, block_t=bt), library,
            _nbytes(x, ids) + used + x.shape[0] * w.shape[2]
            * x.element_size(),
            2 * x.shape[0] * x.shape[1] * w.shape[2], lm_n["moe_gemm"],
            iters, tol, peak)
        row["path"] = path
        if path == "fma":
            row["fma_instance"] = moek.fma_instance(
                x.shape[1], w.shape[2], bt, x, w)
        return row

    def grouped_mm(x, w, ids, tol):
        """``torch._grouped_mm`` over the runs (expert e's rows end at
        offs[e]; the runs are in expert order), or why it cannot stand as
        the library call."""
        if not hasattr(torch, "_grouped_mm"):
            return "ragged runs: this PyTorch has no torch._grouped_mm"
        _require(bool((ids[1:] >= ids[:-1]).all()), "ragged runs out of "
                 "expert order")
        runs = torch.bincount(ids.long(), minlength=w.shape[0])
        offs = torch.cumsum(runs * bt, 0).to(torch.int32)
        fn = partial(torch._grouped_mm, x, w, offs=offs)
        try:
            _close(f"torch._grouped_mm {x.dtype}", fn(),
                   moek.moe_gemm_dense(x, w, ids, block_t=bt), tol)
        except RuntimeError as err:
            return f"ragged runs: torch._grouped_mm: {err}"[:200]
        return fn

    def projections(dt, tol, peak):
        out = []
        for proj in ("up", "down"):
            x, w = mo[proj]
            if dt is not None:
                x, w = x.to(dt), w.to(dt)
            xb = x.view(e, cap, x.shape[1])
            key = f"moe_{proj}_{'bf16' if dt else 'f32'}"
            out.append(moe_row(x, w, mo["ids"], tol, peak,
                               partial(torch.bmm, xb, w), designs[key]))
        return _sum_rows(out)

    row = projections(None, MOE_F32_TOL, F32_FLOP_PER_S)
    row.update(_prefixed("bf16", projections(torch.bfloat16, MOE_BF16_TOL,
                                             BF16_FLOP_PER_S)))
    rg = mo["ragged"]
    for prefix, dt, tol, peak in (
            ("ragged", torch.float32, MOE_F32_TOL, F32_FLOP_PER_S),
            ("ragged_bf16", torch.bfloat16, MOE_BF16_TOL, BF16_FLOP_PER_S)):
        x, w = rg["x"].to(dt), mo["up"][1].to(dt)
        row.update(_prefixed(prefix, moe_row(
            x, w, rg["ids"], tol, peak, grouped_mm(x, w, rg["ids"], tol),
            designs["moe_ragged_up" + prefix.removeprefix("ragged")])))
        del x, w
    row["ragged_counts"] = rg["counts"]
    row["ptxas"] = ptxas["moe_gemm"]
    rows["moe_gemm"] = row
    return rows


# --------------------------------------------------------------------- #
# kernel rows                                                           #
# --------------------------------------------------------------------- #

def compare(name, kernel, plain, library, n_bytes, flops, launches, iters,
            tol=(RTOL, ATOL), peak=F32_FLOP_PER_S, label=None):
    """Hold one kernel against its plain version on the same inputs, and
    time kernel, plain version and library call.  ``kernel``/``plain``
    return a tensor or a tuple of tensors; ``library`` is a callable, or a
    string saying why no single PyTorch call computes the function.
    ``tol``: (rtol, atol) of the comparison; ``peak``: the operand type's
    peak FLOP/s, for the bound; ``label``: the run's name in the log (the
    row's name if None)."""
    import torch
    label = label or name
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = _close(f"{label}: kernel vs plain", got, want, tol)
    del got, want
    bound, by = _bound_ms(n_bytes, flops, peak)
    row = {"name": name, "route": "cuda",
           "source": ("src/repro_torch/kernels/csrc/"
                      f"{SOURCES.get(name, name)}.cu"),
           "replaces": REPLACES[name],
           "launches": launches, "max_abs_err": err, "rtol": tol[0],
           "atol": (tol[1].max().item() if torch.is_tensor(tol[1])
                    else tol[1]),
           "ms": _time_ms(kernel, iters), "plain_ms": _time_ms(plain, iters),
           "bound_ms": bound, "bound_by": by,
           "library_ms": (None if isinstance(library, str)
                          else _time_ms(library, iters))}
    if isinstance(library, str):
        row["library_none"] = library
    if torch.is_tensor(tol[1]):
        row["atol_per_element"] = True
    print(f"[{label}] max|err| {err!r}  kernel {row['ms']!r} ms  plain "
          f"{row['plain_ms']!r} ms  library {row['library_ms']!r} ms  bound "
          f"{bound!r} ms ({by}: {n_bytes} B, {flops} FLOP)", flush=True)
    return row


def _train_fields(name, kernel, plain, n_bytes, flops, launches, iters):
    """The with-g' training forward of a serving kernel: extra fields."""
    import torch
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = _close(f"{name} (with g'): kernel vs plain", got, want)
    bound, by = _bound_ms(n_bytes, flops)
    out = {"train_launches": launches, "train_max_abs_err": err,
           "train_ms": _time_ms(kernel, iters),
           "train_plain_ms": _time_ms(plain, iters),
           "train_bound_ms": bound, "train_bound_by": by}
    print(f"[{name} with g'] {out}", flush=True)
    return out


def _sum_rows(rows):
    """One row for a kernel launched once per mid layer: the launches of
    one step summed (times and bounds), the worst error."""
    row = dict(max(rows, key=lambda r: r["bound_ms"]))
    for key in row:
        if key.endswith("ms") and row[key] is not None:
            row[key] = sum(r[key] for r in rows)
    for key in ("max_abs_err", "train_max_abs_err", "dh_max_abs_err",
                "library_full_max_abs_err"):
        if key in row:
            row[key] = max(r[key] for r in rows)
    return row


def kernel_rows(p10k, lp10k, p3k, lp3k, serve_n, train_n, int8_n,
                unfused_serve_n, unfused_train_n, m3_n, parent_libs=None):
    """Phases 7 + 8: every population kernel at the main paths'
    shapes; with ``parent_libs`` (``--parent``) the f32 heads', the input
    layer's and the mid layers' outputs also against another tree's
    kernels (``same_as_parent``, ``same_input_as_parent``,
    ``same_mid_as_parent``)."""
    import numpy as np
    import torch

    from repro_torch.core.activations import apply_activations_sliced
    from repro_torch.core.deep import pack_weight_tiles
    from repro_torch.kernels import block_diag as bdk
    from repro_torch.kernels import fused_input as fik
    from repro_torch.kernels import fused_layer as flk
    from repro_torch.kernels import infer_head as ihk
    from repro_torch.kernels import loss_head as lhk
    from repro_torch.kernels import m3_matmul as m3k
    from repro_torch.kernels import seg_act as sak
    from repro_torch.quant import quantize_population
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = {}
    q10k = quantize_population(p10k, lp10k)
    q3k = quantize_population(p3k, lp3k)

    # ---- fused_input at full width: x (32, 100) · W_in (1,280,000, 100)ᵀ
    p0 = lp10k.layer_pop(0)
    x = torch.randn(BATCH, lp10k.in_features, generator=gen, device=dev)
    w, b = p10k["w_in"], p10k["b_in"]
    ids = torch.as_tensor(p0.block_act_ids, dtype=torch.int32, device=dev)
    mask = torch.as_tensor(p0.hidden_mask, dtype=torch.float32, device=dev)
    blk = lp10k.block
    h, g = fik.fused_input_train_cuda(x, w, b, mask, ids, block=blk)
    fin = (x, w, b, mask, ids)

    def library_input():
        z = torch.addmm(b, x, w.t())
        return apply_activations_sliced(z, p0.act_runs) * mask

    rows["fused_input"] = compare(
        "fused_input", partial(fik.fused_input_cuda, *fin, block=blk),
        partial(fik.fused_input_plain, *fin, block=blk), library_input,
        _nbytes(*fin, h), 2 * BATCH * w.shape[0] * w.shape[1],
        serve_n["fused_input"], 20)
    rows["fused_input"].update(_train_fields(
        "fused_input", partial(fik.fused_input_train_cuda, *fin, block=blk),
        partial(fik.fused_input_train_plain, *fin, block=blk),
        _nbytes(*fin, h, g), 2 * BATCH * w.shape[0] * w.shape[1],
        train_n["fused_input"], 20))
    rows["fused_input"].update(_fused_input_fields(fin, blk))

    # ---- fused_input_int8 at full width: x (32, 100) · W_q (1,280,000,
    # 104) int8ᵀ; the library call is addmm on the dequantized weight
    wq, wqs = q10k["w_in"], q10k["w_in_scale"]
    fin8 = (x, wq, wqs, b, mask, ids)
    h8 = fik.fused_input_int8_cuda(*fin8, block=blk)
    wdq = wq[:, :x.shape[1]].float() * wqs.repeat_interleave(blk)[:, None]

    def library_input8():
        z = torch.addmm(b, x, wdq.t())
        return apply_activations_sliced(z, p0.act_runs) * mask

    rows["fused_input_int8"] = compare(
        "fused_input_int8", partial(fik.fused_input_int8_cuda, *fin8,
                                    block=blk),
        partial(fik.fused_input_int8_plain, *fin8, block=blk),
        library_input8, _nbytes(*fin8, h8),
        2 * BATCH * wq.shape[0] * x.shape[1], int8_n["fused_input_int8"], 20)
    del wdq
    rows["fused_input_int8"].update(_fused_input_int8_fields(fin8, blk))
    gelu_moves = {}      # --parent: how far the gelu columns moved
    if parent_libs:
        gelu_moves["parallelmlp-10k"] = same_input_as_parent(
            parent_libs, "parallelmlp-10k", fin, fin8, blk)

    # ---- fused_input_bwd at full width, as on the path (no dx: x is data)
    dy = torch.randn(h.shape, generator=gen, device=dev) * 1e-3
    bwd = (dy, g, x, w)
    dw = fik.fused_input_bwd_cuda(*bwd, with_dx=False)[1]
    _require(torch.equal(dw, fik.fused_input_bwd_cuda(*bwd,
                                                      with_dx=False)[1]),
             "fused_input_bwd: two launches on the same inputs differ")
    du = dy * g

    def dw_kernel():
        return fik.fused_input_bwd_cuda(*bwd, with_dx=False)[1]

    def library_full():
        return torch.mm((dy * g).t(), x)

    rows["fused_input_bwd"] = compare(
        "fused_input_bwd", dw_kernel,
        lambda: fik.fused_input_bwd_plain(*bwd, with_dx=False)[1],
        lambda: torch.mm(du.t(), x), _nbytes(dy, g, x, dw),
        2 * BATCH * w.shape[0] * w.shape[1], train_n["fused_input_bwd"], 10)
    got = fik.fused_input_bwd_cuda(*bwd, with_dx=True)
    err = _close("fused_input_bwd dx", got,
                 fik.fused_input_bwd_plain(*bwd, with_dx=True))
    _require(all(torch.equal(a, b) for a, b in zip(
        got, fik.fused_input_bwd_cuda(*bwd, with_dx=True))),
        "fused_input_bwd with dx: two launches on the same inputs differ")
    fields = {
        "path": fik.bwd_path(dy, g, x, dw),
        "device_ms": _device_ms(dw_kernel, "fused_input_bwd_kernel", 20),
        "library_full_max_abs_err": _close(
            "fused_input_bwd: library calls vs kernel", library_full(), dw),
        "library_full_ms": _time_ms(library_full, 10),
        "library_full_calls": "mul: du = dy·g'; mm: duᵀ·x, in the timed call",
        "dx_max_abs_err": err,
        "dx_ms": _time_ms(lambda: fik.fused_input_bwd_cuda(*bwd,
                                                           with_dx=True), 10)}
    print(f"[fused_input_bwd] {fields}", flush=True)
    rows["fused_input_bwd"].update(fields)
    del got, du

    # ---- infer_head / loss_head at full width, on the layer-0 activations
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
    rows["infer_head"] = compare(
        "infer_head", lambda: ihk.infer_head_cuda(h, w2, b2, ptr, block=blk),
        lambda: ihk.infer_head_plain(h, w2, b2, ptr, block=blk),
        lambda: torch.baddbmm(b2[:, None, :], hb, wb2),
        _nbytes(h, w2, b2, ptr, y),
        2 * BATCH * h.shape[1] * w2.shape[0], serve_n["infer_head"], 20)
    got = ihk.infer_head_cuda(h, w2, b2, ptr, block=blk, log_probs=True)
    want = ihk.infer_head_plain(h, w2, b2, ptr, block=blk, log_probs=True)
    rows["infer_head"]["log_probs_max_abs_err"] = _close(
        "infer_head log_probs: kernel vs plain", got, want)
    rows["infer_head"].update(_infer_head_fields(
        partial(ihk.infer_head_cuda, h, w2, b2, ptr, block=blk), blk, h, w2))

    # ---- infer_head_int8 at full width, on the int8 input layer's output;
    # the library call is the f32 row's baddbmm on the dequantized weight
    w2q, w2s = q10k["w_out"], q10k["w_out_scale"]
    head8 = (h8, w2q, w2s, b2, ptr)
    y8 = ihk.infer_head_int8_cuda(*head8, block=blk)
    hb8 = h8.view(BATCH, n_mem, width).transpose(0, 1)
    wb2dq = (w2q.float() * w2s.repeat_interleave(blk)[None, :]).view(
        w2q.shape[0], n_mem, width).permute(1, 2, 0)
    rows["infer_head_int8"] = compare(
        "infer_head_int8", partial(ihk.infer_head_int8_cuda, *head8,
                                   block=blk),
        partial(ihk.infer_head_int8_plain, *head8, block=blk),
        lambda: torch.baddbmm(b2[:, None, :], hb8, wb2dq),
        _nbytes(*head8, y8), 2 * BATCH * h8.shape[1] * w2q.shape[0],
        int8_n["infer_head_int8"], 20)
    got = ihk.infer_head_int8_cuda(*head8, block=blk, log_probs=True)
    want = ihk.infer_head_int8_plain(*head8, block=blk, log_probs=True)
    rows["infer_head_int8"]["log_probs_max_abs_err"] = _close(
        "infer_head_int8 log_probs: kernel vs plain", got, want)
    del wb2dq
    rows["infer_head_int8"].update(_infer_head_int8_fields(head8, blk))

    tgt = torch.randint(0, lp10k.out_features, (BATCH,), generator=gen,
                        device=dev, dtype=torch.int32)
    lh = (h, w2, b2, tgt, ptr)
    per, dl = lhk.loss_head_fwd_cuda(*lh, block=blk, b_real=BATCH)
    rows["loss_head_fwd"] = compare(
        "loss_head_fwd",
        partial(lhk.loss_head_fwd_cuda, *lh, block=blk, b_real=BATCH),
        partial(lhk.loss_head_fwd_plain, *lh, block=blk, b_real=BATCH),
        lambda: torch.baddbmm(b2[:, None, :], hb, wb2),
        _nbytes(*lh, per, dl), 2 * BATCH * h.shape[1] * w2.shape[0],
        train_n["loss_head_fwd"], 20)
    dper = torch.ones(n_mem, device=dev)
    lb = (dper, dl, h, w2, seg)
    dh, dw2 = lhk.loss_head_bwd_cuda(*lb, block=blk)
    dlm = dl.transpose(0, 1)                            # (P, B, O)
    wm = w2.view(w2.shape[0], n_mem, width).permute(1, 0, 2)  # (P, O, width)
    rows["loss_head_bwd"] = compare(
        "loss_head_bwd", partial(lhk.loss_head_bwd_cuda, *lb, block=blk),
        partial(lhk.loss_head_bwd_plain, *lb, block=blk),
        lambda: torch.bmm(dlm, wm), _nbytes(*lb, dh, dw2),
        4 * BATCH * h.shape[1] * w2.shape[0], train_n["loss_head_bwd"], 20)
    for key, fields in zip(("loss_head_fwd", "loss_head_bwd"),
                           loss_head_library_full(lh, lb, hb, wb2, wm,
                                                  (per, dl), (dh, dw2))):
        rows[key].update(fields)
    if parent_libs:
        same_as_parent(parent_libs, "parallelmlp-10k", lh, lb, head8, blk)
    for key, fields in _loss_head_fields(
            {"loss_head_fwd": partial(lhk.loss_head_fwd_cuda, *lh, block=blk,
                                      b_real=BATCH),
             "loss_head_bwd": partial(lhk.loss_head_bwd_cuda, *lb,
                                      block=blk)},
            blk, h, w2, dh, dw2).items():
        rows[key].update(fields)

    # ---- the depth-3 population's mid layers, each fed by the layer
    # before it as on the path; a row is one step's worth (both launches)
    q0 = lp3k.layer_pop(0)
    x3 = torch.randn(BATCH, lp3k.in_features, generator=gen, device=dev)
    m0 = torch.as_tensor(q0.hidden_mask, dtype=torch.float32, device=dev)
    a0 = torch.as_tensor(q0.block_act_ids, dtype=torch.int32, device=dev)
    fin3 = (x3, p3k["w_in"], p3k["b_in"], m0, a0)
    fin83 = (x3, q3k["w_in"], q3k["w_in_scale"], q3k["b_in"], m0, a0)
    hin = fik.fused_input_cuda(*fin3, block=lp3k.block)
    hin8 = fik.fused_input_int8_cuda(*fin83, block=lp3k.block)
    for key, fields in _depth3_input_rows(fin3, fin83, lp3k.block, hin,
                                          hin8).items():
        rows[key].update(fields)
    if parent_libs:
        gelu_moves["depth-3 input layer"] = same_input_as_parent(
            parent_libs, "the depth-3 input layer", fin3, fin83, lp3k.block)
    fwd_rows, bwd_rows, int8_rows, bd_rows, dw_rows = [], [], [], [], []
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
        args = (hin, wb, b_eff, m3, a3, *sched)
        out, g3 = flk.fused_layer_train_cuda(*args, blk=b3)
        # the same block-sparse product as one cuSPARSE BSR matmul (no
        # bias / activation / mask)
        bsr = torch.sparse_bsr_tensor(
            sched[0], sched[1], wb[sched[2].long()],
            size=(lay.n_out_tiles * b3, lay.n_in_tiles * b3),
            check_invariants=True)
        flops = 2 * BATCH * b3 * b3 * lay.n_steps
        row = compare(
            "fused_layer", partial(flk.fused_layer_cuda, *args, blk=b3),
            partial(flk.fused_layer_plain, *args, blk=b3),
            partial(torch.matmul, bsr, hin.t()),
            _nbytes(*args, out), flops, serve_n["fused_layer"], 50)
        row.update(_train_fields(
            "fused_layer", partial(flk.fused_layer_train_cuda, *args, blk=b3),
            partial(flk.fused_layer_train_plain, *args, blk=b3),
            _nbytes(*args, out, g3), flops, train_n["fused_layer"], 50))
        row.update(_mid_fwd_fields(
            "fused_layer", f"mid layer {l}",
            partial(flk.fused_layer_cuda, *args, blk=b3),
            partial(flk.fused_layer_train_cuda, *args, blk=b3), args[:2]))
        fwd_rows.append(row)

        # the int8 twin, fed by the int8 path's previous layer; the
        # library call is the BSR matmul on the dequantized tiles
        wbq, wbs = q3k["mid"][l]["wb"], q3k["mid"][l]["scale"]
        b_eff8 = q3k["mid"][l]["b"] * torch.as_tensor(
            lp3k.active_unit_mask(l + 1), dtype=torch.float32, device=dev)
        args8 = (hin8, wbq, wbs, b_eff8, m3, a3, *sched)
        out8 = flk.fused_layer_int8_cuda(*args8, blk=b3)
        bsr8 = torch.sparse_bsr_tensor(
            sched[0], sched[1],
            (wbq.float() * wbs[:, None, None])[sched[2].long()],
            size=(lay.n_out_tiles * b3, lay.n_in_tiles * b3),
            check_invariants=True)
        int8_rows.append(compare(
            "fused_layer_int8", partial(flk.fused_layer_int8_cuda, *args8,
                                        blk=b3),
            partial(flk.fused_layer_int8_plain, *args8, blk=b3),
            partial(torch.matmul, bsr8, hin8.t()),
            _nbytes(*args8, out8), flops, int8_n["fused_layer_int8"], 50))
        int8_rows[-1].update(_mid_int8_fields(f"mid layer {l}", args8, b3))
        hin8 = out8

        rowptr_t, s_in_t, s_w_t, perm_t, out_t, in_t = flk.schedule_on(
            lay, dev, transposed=True)
        wb_t = flk.transposed_tiles(wb, perm_t)
        dy3 = torch.randn(out.shape, generator=gen, device=dev)
        # the parameter tiles as the forward reads them, and the layout's
        # work units
        bargs = (dy3, g3, hin, wb[:-1], *flk.dx_dw_schedule_on(lay, dev))
        dx3, dwb3 = flk.fused_layer_dx_dw_cuda(*bargs, blk=b3)
        _require(all(torch.equal(a, b) for a, b in zip(
            (dx3, dwb3), flk.fused_layer_dx_dw_cuda(*bargs, blk=b3))),
            "fused_layer_dx_dw: two launches on the same inputs differ")
        bsr_t = torch.sparse_bsr_tensor(
            rowptr_t, s_in_t, wb_t[s_w_t.long()],
            size=(lay.n_in_tiles * b3, lay.n_out_tiles * b3),
            check_invariants=True)
        du3 = dy3 * g3
        kernel = partial(flk.fused_layer_dx_dw_cuda, *bargs, blk=b3)
        row = compare(
            "fused_layer_dx_dw", kernel,
            partial(flk.fused_layer_dx_dw_plain, *bargs, blk=b3),
            partial(torch.matmul, bsr_t, du3.t()),
            # what the kernel moves: its arguments and outputs; dx and dW
            # are one product each a parameter tile (pass-through tiles
            # are copies)
            _nbytes(*bargs, dx3, dwb3),
            4 * BATCH * b3 * b3 * lay.n_param_blocks,
            train_n["fused_layer_dx_dw"], 50)
        row.update(_dx_dw_fields(kernel, dy3, g3, hin, bsr_t, out_t, in_t,
                                 b3, (dx3, dwb3)))
        bwd_rows.append(row)

        # the unfused route's block-diagonal GEMM on the same tiles: the
        # forward (library: the BSR matmul above), its dh on the
        # transposed tiles and steps, and dWB (library: one bmm on the
        # tiles gathered beforehand, the gather not timed)
        bd_args = (hin, wb, *sched)
        y_bd = bdk.block_diag_fwd_cuda(*bd_args, blk=b3)
        row = compare(
            "block_diag_fwd", partial(bdk.block_diag_fwd_cuda, *bd_args,
                                      blk=b3),
            partial(bdk.block_diag_fwd_plain, *bd_args, blk=b3),
            partial(torch.matmul, bsr, hin.t()), _nbytes(*bd_args, y_bd),
            flops, unfused_serve_n["block_diag_fwd"], 50)
        dh_args = (dy3, wb_t, rowptr_t, s_in_t, s_w_t)
        dh3 = bdk.block_diag_fwd_cuda(*dh_args, blk=b3)
        dh_bound, _ = _bound_ms(_nbytes(*dh_args, dh3),
                                2 * BATCH * b3 * b3 * lay.n_steps_t)
        row.update(
            train_launches=unfused_train_n["block_diag_fwd"],
            dh_max_abs_err=_close("block_diag_fwd dh: kernel vs plain", dh3,
                                  bdk.block_diag_fwd_plain(*dh_args,
                                                           blk=b3)),
            dh_ms=_time_ms(partial(bdk.block_diag_fwd_cuda, *dh_args,
                                   blk=b3), 50),
            dh_bound_ms=dh_bound,
            dh_library_ms=_time_ms(partial(torch.matmul, bsr_t, dy3.t()),
                                   50))
        row.update(_mid_fwd_fields(
            "block_diag_fwd", f"mid layer {l}",
            partial(bdk.block_diag_fwd_cuda, *bd_args, blk=b3),
            partial(bdk.block_diag_fwd_cuda, *dh_args, blk=b3), bd_args[:2],
            dh_args[:2]))
        dw_args = (dy3, hin, out_t, in_t)
        theirs = (same_mid_as_parent(parent_libs, f"mid layer {l}", args,
                                     args8, dh_args, dw_args, b3)
                  if parent_libs else {})
        if parent_libs:
            gelu_moves[f"depth-3 mid layer {l}"] = theirs.pop("parent_gelu")
        for r, key in ((row, "block_diag_fwd"), (fwd_rows[-1], "fused_layer"),
                       (int8_rows[-1], "fused_layer_int8")):
            r.update(theirs.get(key, {}))
        bd_rows.append(row)
        dwb_bd = bdk.block_diag_dw_cuda(*dw_args, blk=b3)
        _require(_same_bits(dwb_bd, bdk.block_diag_dw_cuda(*dw_args,
                                                           blk=b3)),
                 "block_diag_dw: two launches on the same inputs differ")
        dyg = dy3.view(BATCH, -1, b3)[:, out_t.long()].permute(1, 2, 0) \
            .contiguous()
        xg = hin.view(BATCH, -1, b3)[:, in_t.long()].transpose(0, 1) \
            .contiguous()
        dw_rows.append(compare(
            "block_diag_dw", partial(bdk.block_diag_dw_cuda, *dw_args,
                                     blk=b3),
            partial(bdk.block_diag_dw_plain, *dw_args, blk=b3),
            partial(torch.bmm, dyg, xg), _nbytes(*dw_args, dwb_bd),
            2 * BATCH * b3 * b3 * lay.n_param_blocks,
            unfused_train_n["block_diag_dw"], 50))
        dw_kernel = partial(bdk.block_diag_dw_cuda, *dw_args, blk=b3)
        dw_rows[-1].update(
            path=bdk.dw_path(dy3, hin, dwb_bd),
            device_ms=_device_ms(dw_kernel, "block_diag_dw_member_kernel",
                                 50),
            **theirs.get("block_diag_dw", {}))
        print(f"[block_diag_dw at mid layer {l}] path "
              f"{dw_rows[-1]['path']} device {dw_rows[-1]['device_ms']!r} "
              "ms", flush=True)
        hin = out
    rows["fused_layer"] = _sum_rows(fwd_rows)
    rows["fused_layer_int8"] = _sum_rows(int8_rows)
    rows["fused_layer_int8"]["bitwise_f32_dequantized"] = (
        None if any(r["bitwise_f32_dequantized"] is None for r in int8_rows)
        else all(r["bitwise_f32_dequantized"] for r in int8_rows))
    rows["fused_layer_dx_dw"] = _sum_rows(bwd_rows)
    rows["block_diag_fwd"] = _sum_rows(bd_rows)
    rows["block_diag_dw"] = _sum_rows(dw_rows)

    # ---- seg_act / seg_act_bwd at full width, on the input layer's
    # pre-activation (the unfused route's input layer: addmm, then seg_act);
    # last, so that the rows above draw the inputs they drew before these
    z = torch.addmm(b, x, w.t())
    y_sa = sak.seg_act_cuda(z, ids, mask, blk=blk)
    no_call = ("no single PyTorch call applies a different activation to "
               "each block of columns")
    rows["seg_act"] = compare(
        "seg_act", partial(sak.seg_act_cuda, z, ids, mask, blk=blk),
        partial(sak.seg_act_plain, z, ids, mask, blk=blk), no_call,
        _nbytes(z, ids, mask, y_sa), 2 * z.numel(),
        unfused_serve_n["seg_act"], 20)
    rows["seg_act"]["train_launches"] = unfused_train_n["seg_act"]
    dz = torch.randn(z.shape, generator=gen, device=dev)
    dh_sa = sak.seg_act_bwd_cuda(z, dz, ids, mask, blk=blk)
    rows["seg_act_bwd"] = compare(
        "seg_act_bwd", partial(sak.seg_act_bwd_cuda, z, dz, ids, mask,
                               blk=blk),
        partial(sak.seg_act_bwd_plain, z, dz, ids, mask, blk=blk), no_call,
        _nbytes(z, dz, ids, mask, dh_sa), 3 * z.numel(),
        unfused_train_n["seg_act_bwd"], 20)

    # ---- m3_matmul at path 4d's full width (block 128: every member one
    # 128-unit tile) on the layer-0 activations, and at path 4e's head (the
    # depth-3 population's last layer, block 8, 1-2 tiles a member); the
    # library call is the bucketed M3's einsum at block 128 (one size
    # bucket), at path 4e's head a CSR product (members 8 and 16 units
    # wide: no one dense call), each used nowhere on the kernels' route
    gen3 = torch.Generator(device="cuda").manual_seed(11)
    o = w2.shape[0]
    dy_a = torch.randn(BATCH, n_mem, o, generator=gen3, device=dev)
    hv, wv = h.view(BATCH, n_mem, width), w2.view(o, n_mem, width)
    plast = lp3k.layer_pop(lp3k.depth - 1)
    w2_b = p3k["w_out"]
    seg_b = torch.as_tensor(plast.block_segment_ids, dtype=torch.int32,
                            device=dev)
    ptr_b = ihk.member_ptr(seg_b, lp3k.num_members)
    dy_b = torch.randn(BATCH, lp3k.num_members, o, generator=gen3,
                       device=dev)
    blk_b = lp3k.block
    csr_b = _m3_csr_library(hin, w2_b, seg_b, dy_b, blk_b)
    _require(tuple(hin.shape) == (BATCH, plast.total_hidden),
             "the depth-3 population's last hidden layer is not the head's "
             "input")
    flops_a = 2 * BATCH * h.shape[1] * o
    flops_b = 2 * BATCH * hin.shape[1] * o
    # name → ((kernel, plain), args at path 4d, args at path 4e, library,
    # outputs at 4d, at 4e, the kernel's name in a trace); each function's
    # inputs and output are the same tensors' sizes as its arguments (y and
    # dy, dh and h, dw2 and w2), which gives its bytes
    cases = {
        "m3_matmul_fwd": ((m3k.m3_matmul_fwd_cuda, m3k.m3_matmul_fwd_plain),
                          (h, w2, ptr), (hin, w2_b, ptr_b),
                          partial(torch.einsum, "bnh,onh->bno", hv, wv),
                          (dy_a,), (dy_b,), "m3_fwd_stream_kernel"),
        "m3_matmul_dh": ((m3k.m3_matmul_dh_cuda, m3k.m3_matmul_dh_plain),
                         (dy_a, w2, seg), (dy_b, w2_b, seg_b),
                         partial(torch.einsum, "bno,onh->bnh", dy_a, wv),
                         (h,), (hin,), "m3_dh_kernel"),
        "m3_matmul_dw": ((m3k.m3_matmul_dw_cuda, m3k.m3_matmul_dw_plain),
                         (dy_a, h, seg), (dy_b, hin, seg_b),
                         partial(torch.einsum, "bnh,bno->onh", hv, dy_a),
                         (w2,), (w2_b,), "m3_dw_stream_kernel"),
    }
    for name, ((cuda, plain), args_a, args_b, library, out_a, out_b,
               symbol) in cases.items():
        ka = partial(cuda, *args_a, block=blk)
        kb = partial(cuda, *args_b, block=blk_b)
        rows[name] = compare(
            name, ka, partial(plain, *args_a, block=blk), library,
            _nbytes(*args_a, *out_a), flops_a, m3_n[name], 20)
        rows[name].update(
            path_b_max_abs_err=_close(
                f"{name} at path 4e's head: kernel vs plain", kb(),
                plain(*args_b, block=blk_b)),
            path_b_ms=_time_ms(kb, 50),
            path_b_bound_ms=_bound_ms(_nbytes(*args_b, *out_b), flops_b)[0])
        lib_b, to_kernel = csr_b[name]
        rows[name].update(
            path_b_library_max_abs_err=_close(
                f"{name} at path 4e's head: CSR library call vs plain",
                to_kernel(lib_b()), plain(*args_b, block=blk_b)),
            path_b_library_ms=_time_ms(lib_b, 50),
            path_b_library_device_ms=_device_ms(lib_b, "", 50),
            path_b_library=("torch.matmul (CSR)" if name != "m3_matmul_dw"
                            else "torch.sparse.sampled_addmm (CSR)"))
        for k in (ka, kb):
            _require(torch.equal(k(), k()), f"{name}: two launches on the "
                     "same inputs differ")
        # device time beside the events: at path 4e's head the events time
        # the wrapper's host cost
        ms, ms_b = _device_ms(ka, symbol, 50), _device_ms(kb, symbol, 50)
        rows[name].update(device_ms=ms, path_b_device_ms=ms_b)
        print(f"[{name}] device {ms!r} ms; path 4e's head {ms_b!r} ms; two "
              "launches bitwise equal at both; path 4e's library call "
              f"{rows[name]['path_b_library_ms']!r} ms, device "
              f"{rows[name]['path_b_library_device_ms']!r} ms", flush=True)
    at_a, at_b = (h, w2, ptr, seg, dy_a, blk), (hin, w2_b, ptr_b, seg_b,
                                                 dy_b, blk_b)
    for name, fields in _m3_on_heads(at_a, at_b).items():
        rows[name].update(fields)
    if parent_libs:
        for name, fields in same_m3_as_parent(parent_libs, at_a,
                                              at_b).items():
            rows[name].update(fields)

    # ---- loss_head at the depth-3 population's head (block 8, members 8
    # or 16 units wide), on its last hidden layer: extra fields of the two
    # rows
    gen_lh = torch.Generator(device="cuda").manual_seed(12)
    tgt_b = torch.randint(0, o, (BATCH,), generator=gen_lh, device=dev,
                          dtype=torch.int32)
    lh_b = (hin, w2_b, p3k["b_out"], tgt_b, ptr_b)
    per_b, dl_b = lhk.loss_head_fwd_cuda(*lh_b, block=blk_b, b_real=BATCH)
    lb_b = (torch.ones(lp3k.num_members, device=dev), dl_b, hin, w2_b, seg_b)
    dh_b, dw_b = lhk.loss_head_bwd_cuda(*lb_b, block=blk_b)
    kernels = {"loss_head_fwd": partial(lhk.loss_head_fwd_cuda, *lh_b,
                                        block=blk_b, b_real=BATCH),
               "loss_head_bwd": partial(lhk.loss_head_bwd_cuda, *lb_b,
                                        block=blk_b)}
    plains = {"loss_head_fwd": partial(lhk.loss_head_fwd_plain, *lh_b,
                                       block=blk_b, b_real=BATCH),
              "loss_head_bwd": partial(lhk.loss_head_bwd_plain, *lb_b,
                                       block=blk_b)}
    work = {"loss_head_fwd": (_nbytes(*lh_b, per_b, dl_b), flops_b),
            "loss_head_bwd": (_nbytes(*lb_b, dh_b, dw_b), 2 * flops_b)}
    fields = _loss_head_fields(kernels, blk_b, hin, w2_b, dh_b, dw_b)
    # the library calls of rows 7-10 here: path 4e's CSR products on the
    # same head (_m3_csr_library), the logits only (rows 7-9) and dh only
    # (row 10), each held to the plain version's logits or dh
    ih_b = (hin, w2_b, p3k["b_out"], ptr_b)
    logits_b = ihk.infer_head_plain(*ih_b, block=blk_b)
    csr_dh = _m3_csr_library(hin, w2_b, seg_b, dl_b, blk_b)["m3_matmul_dh"]
    libraries = {
        "loss_head_fwd": (*csr_b["m3_matmul_fwd"], logits_b,
                          "torch.matmul (CSR), logits only", p3k["b_out"]),
        "loss_head_bwd": (*csr_dh, plains["loss_head_bwd"]()[0],
                          "torch.matmul (CSR), dh only")}
    for key, kernel in kernels.items():
        row = compare(key, kernel, plains[key], libraries[key][0],
                      *work[key], None, 50,
                      label=f"{key} at the depth-3 head")
        row.update(fields[key])
        row.update(_depth3_head_library(key, *libraries[key]))
        rows[key].update(_prefixed("depth3", row))

    # ---- infer_head at the same head, the serving forward's last launch
    y_b = ihk.infer_head_cuda(*ih_b, block=blk_b)
    row = compare("infer_head", partial(ihk.infer_head_cuda, *ih_b,
                                        block=blk_b),
                  partial(ihk.infer_head_plain, *ih_b, block=blk_b),
                  csr_b["m3_matmul_fwd"][0], _nbytes(*ih_b, y_b), flops_b,
                  None, 50, label="infer_head at the depth-3 head")
    row.update(_depth3_head_library("infer_head", *csr_b["m3_matmul_fwd"],
                                    logits_b,
                                    "torch.matmul (CSR), logits only",
                                    p3k["b_out"]))
    row["log_probs_max_abs_err"] = _close(
        "infer_head log_probs at the depth-3 head: kernel vs plain",
        ihk.infer_head_cuda(*ih_b, block=blk_b, log_probs=True),
        ihk.infer_head_plain(*ih_b, block=blk_b, log_probs=True))
    row.update(_infer_head_fields(partial(ihk.infer_head_cuda, *ih_b,
                                          block=blk_b), blk_b, hin, w2_b))
    rows["infer_head"].update(_prefixed("depth3", row))

    # ---- infer_head_int8 at the same head, the int8 serving forward's last
    # launch, on the int8 path's last hidden layer
    ih8_b = (hin8, q3k["w_out"], q3k["w_out_scale"], q3k["b_out"], ptr_b)
    y8_b = ihk.infer_head_int8_cuda(*ih8_b, block=blk_b)
    w2_b8 = q3k["w_out"].float() * q3k["w_out_scale"].repeat_interleave(
        blk_b)[None, :]  # dequantized, as the int8 plain version does
    csr8 = _m3_csr_library(hin8, w2_b8, seg_b, dy_b,
                           blk_b)["m3_matmul_fwd"]
    row = compare("infer_head_int8", partial(ihk.infer_head_int8_cuda, *ih8_b,
                                             block=blk_b),
                  partial(ihk.infer_head_int8_plain, *ih8_b, block=blk_b),
                  csr8[0], _nbytes(*ih8_b, y8_b), flops_b, None, 50,
                  label="infer_head_int8 at the depth-3 head")
    row.update(_depth3_head_library(
        "infer_head_int8", *csr8,
        ihk.infer_head_int8_plain(*ih8_b, block=blk_b),
        "torch.matmul (CSR) on the dequantized weight, logits only",
        q3k["b_out"]))
    del w2_b8, csr8
    row["log_probs_max_abs_err"] = _close(
        "infer_head_int8 log_probs at the depth-3 head: kernel vs plain",
        ihk.infer_head_int8_cuda(*ih8_b, block=blk_b, log_probs=True),
        ihk.infer_head_int8_plain(*ih8_b, block=blk_b, log_probs=True))
    row.update(_infer_head_int8_fields(ih8_b, blk_b))
    rows["infer_head_int8"].update(_prefixed("depth3", row))
    if parent_libs:
        same_as_parent(parent_libs, "the depth-3 head", lh_b, lb_b, ih8_b,
                       blk_b)
    # --parent: the gelu columns' moves, f32 (y; y, g') and int8 (y) apart
    for where, rep in gelu_moves.items():
        row = "fused_input" if "input" in where or "10k" in where \
            else "fused_layer"
        rows[row].setdefault("parent_gelu", {})[where] = {
            k: v for k, v in rep.items() if k != "int8_y"}
        rows[row + "_int8"].setdefault("parent_gelu", {})[where] = \
            rep["int8_y"]
    return rows


def _fused_input_fields(fin, block):
    """Extra fields of the ``fused_input`` row at one shape, from its
    arguments (x, w, bias, mask, act_ids): the instance its serving and
    training launches take (``path``, ``train_path``, by ``fwd_path``), both
    kernels' device times from ``torch.profiler``; two launches on the same
    inputs bitwise equal, and the training launch's y bitwise the serving
    launch's (one FMA chain, one epilogue)."""
    import torch

    from repro_torch.kernels import fused_input as fik
    x, w = fin[:2]
    serve = partial(fik.fused_input_cuda, *fin, block=block)
    train = partial(fik.fused_input_train_cuda, *fin, block=block)
    y, (yt, gt) = serve(), train()
    _require(torch.equal(y, serve()) and all(
        torch.equal(a, b) for a, b in zip((yt, gt), train())),
        f"fused_input at block {block}: two launches on the same inputs "
        "differ")
    _require(torch.equal(yt, y), f"fused_input at block {block}: the "
             "training launch's y is not the serving launch's")
    out = {"path": fik.fwd_path(x, w, y),
           "train_path": fik.fwd_path(x, w, yt, gt),
           "device_ms": _device_ms(serve, "fused_input_kernel", 20),
           "train_device_ms": _device_ms(train, "fused_input_kernel", 20)}
    print(f"[fused_input at block {block}] {out}", flush=True)
    return out


def _fused_input_int8_fields(fin8, block):
    """Extra fields of the ``fused_input_int8`` row at one shape, from its
    arguments (x, w_q, w_scale, bias, mask, act_ids): the instance it takes
    (``fwd_path`` of the int8 weight), its device time, two launches bitwise
    equal, and whether its output is bitwise the f32 kernel's on the
    dequantized weight (``bitwise_f32_dequantized``; required where both
    take the same instance, else None)."""
    import torch

    from repro_torch.kernels import fused_input as fik
    x, wq, ws, b, m, ids = fin8
    kernel = partial(fik.fused_input_int8_cuda, *fin8, block=block)
    y8 = kernel()
    _require(torch.equal(y8, kernel()), f"fused_input_int8 at block {block}:"
             " two launches on the same inputs differ")
    path = fik.fwd_path(x, wq, y8)
    wdq = (wq[:, :x.shape[1]].float()
           * ws.repeat_interleave(block)[:, None]).contiguous()
    yf = fik.fused_input_cuda(x, wdq, b, m, ids, block=block)
    same = None
    if fik.fwd_path(x, wdq, yf) == path:
        same = torch.equal(y8, yf)
        _require(same, f"fused_input_int8 at block {block}: not bitwise the "
                 "f32 kernel on the dequantized weight")
    del wdq, yf
    out = {"path": path,
           "device_ms": _device_ms(kernel, "fused_input_kernel", 20),
           "bitwise_f32_dequantized": same}
    print(f"[fused_input_int8 at block {block}] {out}", flush=True)
    return out


def _depth3_input_rows(fin, fin8, block, h, h8):
    """The input layer's rows at the depth-3 population's shape (x (32,
    100), W (88,000, 100), block 8), serving, training (``train_*``) and
    int8, as ``depth3_*`` fields of rows 1 and 2.  No single PyTorch call
    computes the per-block activations at block 8."""
    from repro_torch.kernels import fused_input as fik
    x, w = fin[:2]
    no_call = "no single PyTorch call: a different activation per 8 units"
    flops = 2 * BATCH * w.shape[0] * w.shape[1]
    row = compare("fused_input",
                  partial(fik.fused_input_cuda, *fin, block=block),
                  partial(fik.fused_input_plain, *fin, block=block), no_call,
                  _nbytes(*fin, h), flops, None, 50,
                  label="fused_input at the depth-3 input layer")
    train = _train_fields(
        "fused_input at the depth-3 input layer",
        partial(fik.fused_input_train_cuda, *fin, block=block),
        partial(fik.fused_input_train_plain, *fin, block=block),
        _nbytes(*fin, h, h), flops, None, 50)   # g' is y's size
    row.update({k: v for k, v in train.items() if k != "train_launches"})
    row.update(_fused_input_fields(fin, block))
    row8 = compare("fused_input_int8",
                   partial(fik.fused_input_int8_cuda, *fin8, block=block),
                   partial(fik.fused_input_int8_plain, *fin8, block=block),
                   no_call, _nbytes(*fin8, h8), flops, None, 50,
                   label="fused_input_int8 at the depth-3 input layer")
    row8.update(_fused_input_int8_fields(fin8, block))
    return {"fused_input": _prefixed("depth3", row),
            "fused_input_int8": _prefixed("depth3", row8)}


def _dx_dw_fields(kernel, dy, g, x, bsr_t, out_t, in_t, blk, want):
    """Extra fields of the ``fused_layer_dx_dw`` row at one mid layer: the
    kernel's device time from ``torch.profiler``, and the fewest PyTorch
    calls that compute its whole function, checked against its outputs
    and timed (``library_full_*``; ``library_ms`` is dx alone)."""
    import torch
    b = dy.shape[0]
    q_out, q_in = out_t.long(), in_t.long()

    def full():
        du = dy * g
        dx = torch.matmul(bsr_t, du.t()).t().contiguous()
        dw = torch.bmm(du.view(b, -1, blk)[:, q_out].permute(1, 2, 0),
                       x.view(b, -1, blk)[:, q_in].transpose(0, 1))
        return dx, dw

    out = {"device_ms": _device_ms(kernel, "fused_layer_dx_dw_kernel", 50),
           "library_full_max_abs_err": _close(
               "fused_layer_dx_dw: library calls vs kernel", full(), want),
           "library_full_ms": _time_ms(full, 50),
           "library_full_calls": (
               "mul: du = dy·g'; the transposed BSR matmul: dx, and one "
               "layout copy of it to (B, n_in·blk); two gathers of du and "
               "x by parameter tile and bmm: dWB, all in the timed call")}
    print(f"[fused_layer_dx_dw] {out}", flush=True)
    return out


def _mid_fwd_fields(name, where, kernel, second, xw, dh_xw=None):
    """Extra fields of row 4 (``fused_layer``) or row 11
    (``block_diag_fwd``) at one mid layer: the instance each launch takes
    (``path``, and ``train_path`` for the training launch or ``dh_path``
    for the dh pass, by ``block_diag.fwd_path``), the group kernel's device
    times from ``torch.profiler`` (``device_ms``, and ``train_device_ms``
    or ``dh_device_ms``); two launches on the same inputs bitwise equal.
    ``second`` is the training launch (row 4, returning (y, g')) or the dh
    pass (row 11, on ``dh_xw``)."""
    from repro_torch.kernels import block_diag as bdk
    word = ("fused_layer_group_kernel" if name == "fused_layer"
            else "block_diag_group_kernel")
    y, y2, again = kernel(), second(), second()
    twice = zip(y2, again) if dh_xw is None else ((y2, again),)
    _require(_same_bits(y, kernel())
             and all(_same_bits(a, b) for a, b in twice),
             f"{name} at {where}: two launches on the same inputs differ")
    key = "train" if dh_xw is None else "dh"
    out = {"path": bdk.fwd_path(*xw, y),
           f"{key}_path": (bdk.fwd_path(*xw, *y2) if dh_xw is None
                           else bdk.fwd_path(*dh_xw, y2)),
           "device_ms": _device_ms(kernel, word, 50),
           f"{key}_device_ms": _device_ms(second, word, 50)}
    print(f"[{name} at {where}] {out}", flush=True)
    return out


def _mid_int8_fields(where, args8, block):
    """Extra fields of row 5 (``fused_layer_int8``) at one mid layer, from
    its arguments (x, wb_q, wb_scale, b_eff, mask, tile_act, rowptr, s_in,
    s_w): the instance the launch takes (``path``, ``block_diag.fwd_path``
    of the int8 tiles), the int8 group kernel's device time from
    ``torch.profiler``, two launches on the same inputs bitwise equal, and
    whether its output is bitwise the f32 group kernel's on the tiles
    dequantized as q·scale (``bitwise_f32_dequantized``; required where
    both take the same instance, else None)."""
    from repro_torch.kernels import block_diag as bdk
    from repro_torch.kernels import fused_layer as flk
    x, wbq, wbs = args8[:3]
    kernel = partial(flk.fused_layer_int8_cuda, *args8, blk=block)
    y = kernel()
    _require(_same_bits(y, kernel()),
             f"fused_layer_int8 at {where}: two launches on the same inputs "
             "differ")
    path = bdk.fwd_path(x, wbq, y)
    wdq = wbq.float() * wbs[:, None, None]
    y32 = flk.fused_layer_cuda(x, wdq, *args8[3:], blk=block)
    same = None
    if bdk.fwd_path(x, wdq, y32) == path:
        same = _same_bits(y, y32)
        _require(same, f"fused_layer_int8 at {where}: not bitwise the f32 "
                 "kernel on the dequantized tiles")
    out = {"path": path,
           "device_ms": _device_ms(kernel, "fused_layer_i8_group_kernel", 50),
           "bitwise_f32_dequantized": same}
    print(f"[fused_layer_int8 at {where}] {out}", flush=True)
    return out


def _infer_head_fields(kernel, block, h, w2):
    """Extra fields of the ``infer_head`` row at one shape, from ``kernel``
    (a call of the f32 kernel): the design the launch took
    (``kernel_path``), the kernel's device time from ``torch.profiler``,
    and the log-probabilities instance's times beside the logits'."""
    from repro_torch.kernels import infer_head as ihk
    lp = partial(kernel, log_probs=True)
    ms = _device_ms(kernel, "infer_head_kernel", 50)
    lp_ms = _device_ms(lp, "infer_head_kernel", 50)
    out = {"path": ihk.kernel_path(block, h, w2),
           "device_ms": ms,
           "log_probs_ms": _time_ms(lp, 50), "log_probs_device_ms": lp_ms}
    print(f"[infer_head at block {block}] {out}", flush=True)
    return out


def _infer_head_int8_fields(args, block):
    """Extra fields of the ``infer_head_int8`` row at one shape, from its
    arguments (h, w2_q, w2_scale, b2, member_ptr): the design the launch
    took (``kernel_path`` of an int8 w2), the kernel's device time from
    ``torch.profiler``, and whether its output is bitwise the f32
    kernel's on the dequantized weight (``bitwise_f32_dequantized``;
    required where both take the same instance, else None)."""
    import torch

    from repro_torch.kernels import infer_head as ihk
    h, w2q, w2s, b2, ptr = args
    kernel = partial(ihk.infer_head_int8_cuda, *args, block=block)
    path = ihk.kernel_path(block, h, w2q)
    w2dq = w2q.float() * w2s.repeat_interleave(block)[None, :]
    same = None
    if ihk.kernel_path(block, h, w2dq) == path:
        for lp in (False, True):
            same = torch.equal(kernel(log_probs=lp), ihk.infer_head_cuda(
                h, w2dq, b2, ptr, block=block, log_probs=lp))
            _require(same, f"infer_head_int8 at block {block} (log_probs "
                     f"{lp}): not bitwise the f32 kernel on the dequantized "
                     "weight")
    out = {"path": path,
           "device_ms": _device_ms(kernel, "infer_head_i8_kernel", 50),
           "bitwise_f32_dequantized": same}
    print(f"[infer_head_int8 at block {block}] {out}", flush=True)
    return out


def parent_libs(parent: Path) -> dict:
    """``--parent``: the ``infer_head``, ``loss_head``, ``fused_input``,
    ``block_diag``, ``fused_layer``, ``m3_matmul`` and ``flash_attn``
    kernel libraries of another checkout of the repository, built by that
    tree's own ``_build.build_all`` in a subprocess (at once where that
    tree's own run has built them): {name: ctypes.CDLL}."""
    import ctypes
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.kernels import _build; "
            "print(json.dumps({k: str(v) for k, v in "
            "_build.build_all().items()}))")
    out = subprocess.run([sys.executable, "-c", code, str(parent / "src")],
                         check=True, capture_output=True, text=True,
                         timeout=600)
    paths = json.loads(out.stdout.strip().splitlines()[-1])
    names = ("infer_head", "loss_head", "fused_input", "block_diag",
             "fused_layer", "m3_matmul", "flash_attn")
    print(f"--parent {parent}: {[paths[k] for k in names]}", flush=True)
    return {k: ctypes.CDLL(paths[k]) for k in names}


def same_as_parent(libs, name, lh, lb, ih8, block):
    """The f32 ``infer_head`` (logits and log-probabilities),
    ``loss_head_fwd``, ``loss_head_bwd`` (dh and dW) and ``infer_head_int8``
    (logits and log-probabilities) outputs of this tree's kernels on ``lh``
    = (h, w2, b2, targets, member_ptr), ``lb`` = (d_per, dl, h, w2,
    block_seg) and ``ih8`` = (h, w2_q, w2_scale, b2, member_ptr) against the
    C entries of ``libs`` (``parent_libs``), which keep their signatures:
    bitwise, or fail."""
    import ctypes

    import torch

    from repro_torch.kernels import infer_head as ihk
    from repro_torch.kernels import loss_head as lhk
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    h, w2, b2, tgt, ptr = lh
    b, hh = h.shape
    o, p = w2.shape[0], b2.shape[0]
    stream = torch.cuda.current_stream().cuda_stream
    ih = libs["infer_head"].infer_head_f32
    ih.argtypes, ih.restype = [P] * 5 + [I] * 6 + [P], I
    i8 = libs["infer_head"].infer_head_i8
    i8.argtypes, i8.restype = [P] * 6 + [I] * 6 + [P], I
    lf = libs["loss_head"].loss_head_fwd_f32
    lf.argtypes, lf.restype = [P] * 7 + [I] * 5 + [F, P], I
    lbw = libs["loss_head"].loss_head_bwd_f32
    lbw.argtypes, lbw.restype = [P] * 7 + [I] * 5 + [P], I
    for lp in (0, 1):
        y = torch.empty(b, p, o, device=h.device)
        _require(ih(h.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                    ptr.data_ptr(), y.data_ptr(), b, hh, o, p, block, lp,
                    stream) == 0, "the parent's infer_head_f32 failed")
        _require(torch.equal(y, ihk.infer_head_cuda(
            h, w2, b2, ptr, block=block, log_probs=bool(lp))),
            f"infer_head at {name} (log_probs {lp}): not bitwise the "
            "parent's")
        _require(i8(*[t.data_ptr() for t in ih8], y.data_ptr(), b, hh, o, p,
                    block, lp, stream) == 0,
                 "the parent's infer_head_i8 failed")
        _require(_same_bits(y, ihk.infer_head_int8_cuda(
            *ih8, block=block, log_probs=bool(lp))),
            f"infer_head_int8 at {name} (log_probs {lp}): not bitwise the "
            "parent's")
    per = torch.empty(p, device=h.device)
    dl = torch.empty(b, p, o, device=h.device)
    _require(lf(h.data_ptr(), w2.data_ptr(), b2.data_ptr(), tgt.data_ptr(),
                ptr.data_ptr(), per.data_ptr(), dl.data_ptr(), b, hh, o, p,
                block, 1.0 / b, stream) == 0,
             "the parent's loss_head_fwd_f32 failed")
    got = lhk.loss_head_fwd_cuda(*lh, block=block, b_real=b)
    _require(torch.equal(per, got[0]) and torch.equal(dl, got[1]),
             f"loss_head_fwd at {name}: not bitwise the parent's")
    dh, dw = torch.empty(b, hh, device=h.device), torch.empty_like(w2)
    _require(lbw(*[t.data_ptr() for t in lb], dh.data_ptr(), dw.data_ptr(),
                 b, hh, o, p, block, stream) == 0,
             "the parent's loss_head_bwd_f32 failed")
    got = lhk.loss_head_bwd_cuda(*lb, block=block)
    _require(_same_bits(dh, got[0]) and _same_bits(dw, got[1]),
             f"loss_head_bwd at {name}: not bitwise the parent's")
    print(f"[{name}] infer_head (logits, log-probs), infer_head_int8 (the "
          "same), loss_head_fwd and loss_head_bwd (dh, dW) bitwise the "
          "parent's", flush=True)


def _m3_csr_library(h, w2, seg, dy, block):
    """One PyTorch call for each M3 function at a shape whose members no
    single dense call covers (path 4e's head: 8 and 16 units wide), on
    w2 laid out beforehand as a CSR matrix (a row a (member, class), a
    column a unit; nothing of the layout timed): the forward and dh are
    cuSPARSE products, dW the sampled product on the same pattern.  Returns
    {row: (call, its output in the kernel's layout)}; each call's result is
    in the CSR's transposed layout, which ``to_kernel`` undoes."""
    import warnings

    import torch
    warnings.filterwarnings("ignore", "Sparse CSR tensor support")
    warnings.filterwarnings("ignore", "Sparse invariant checks")
    b, p, o = dy.shape
    hh = h.shape[1]
    unit = seg.long().repeat_interleave(block)
    j = torch.arange(hh, device=h.device).repeat(o)
    row = unit[j] * o + torch.arange(o, device=h.device).repeat_interleave(hh)
    vals = w2.reshape(-1)

    def csr(idx, shape, v):
        return torch.sparse_coo_tensor(idx, v, shape).coalesce() \
            .to_sparse_csr()
    wt = csr(torch.stack([row, j]), (p * o, hh), vals)     # (P·O, H)
    w = csr(torch.stack([j, row]), (hh, p * o), vals)      # (H, P·O)
    pattern = torch.sparse_csr_tensor(
        wt.crow_indices(), wt.col_indices(), torch.zeros_like(wt.values()),
        wt.shape)
    ht = h.t().contiguous()
    dyt = dy.reshape(b, p * o).t().contiguous()

    def dw_dense(d):
        r = torch.repeat_interleave(torch.arange(p * o, device=h.device),
                                    d.crow_indices().diff())
        out = torch.zeros(o, hh, device=h.device)
        out[r % o, d.col_indices()] = d.values()
        return out
    return {
        "m3_matmul_fwd": (partial(torch.matmul, wt, ht),
                          lambda y: y.t().reshape(b, p, o)),
        "m3_matmul_dh": (partial(torch.matmul, w, dyt), lambda d: d.t()),
        "m3_matmul_dw": (partial(torch.sparse.sampled_addmm, pattern, dyt, h,
                                 beta=0.0), dw_dense)}


def _depth3_head_library(name, call, to_kernel, want, label, bias=None):
    """A head row's CSR library call at the depth-3 head (``call`` and
    ``to_kernel`` from ``_m3_csr_library``): its result (plus ``bias``,
    outside the timed call, where ``want`` is the logits) held to the plain
    version, its device time and its name, as fields of the row."""
    got = to_kernel(call())
    fields = {"library_max_abs_err": _close(
                  f"{name} at the depth-3 head: CSR library call vs plain",
                  got if bias is None else got + bias, want),
              "library_device_ms": _device_ms(call, "", 50),
              "library": label}
    print(f"[{name} at the depth-3 head] {fields}", flush=True)
    return fields


def _m3_on_heads(at_a, at_b):
    """Rows 13 and 15 on the heads' cores, at path 4d (``at_a``) and path
    4e's head (``at_b``), each (h, w2, member_ptr, block_seg, dy, block):
    the instance each launch takes (``path``, ``path_b_path``, by
    ``m3_matmul.kernel_path``), and the outputs bit for bit the heads'
    kernels' where both take one instance — the forward ``infer_head``'s
    logits with a zero bias (``bitwise_infer_head``), dW ``loss_head_bwd``'s
    dW with d_per ones (``bitwise_loss_head_bwd``; None where the
    instances differ) — or fail.  Returns {row: fields}."""
    import torch

    from repro_torch.kernels import infer_head as ihk
    from repro_torch.kernels import loss_head as lhk
    from repro_torch.kernels import m3_matmul as m3k
    out = {"m3_matmul_fwd": {}, "m3_matmul_dw": {}}
    for pre, (h, w2, ptr, seg, dy, block) in (("", at_a), ("path_b_", at_b)):
        p, o = ptr.shape[0] - 1, w2.shape[0]
        y = m3k.m3_matmul_fwd_cuda(h, w2, ptr, block=block)
        dw = m3k.m3_matmul_dw_cuda(dy, h, seg, block=block)
        fwd_path = m3k.kernel_path(block, h, w2)
        dw_path = m3k.kernel_path(block, h, dw)
        _require(ihk.kernel_path(block, h, w2) == fwd_path
                 and torch.equal(y, ihk.infer_head_cuda(
                     h, w2, torch.zeros(p, o, device=h.device), ptr,
                     block=block)),
                 f"m3_matmul_fwd at block {block}: not bitwise infer_head's "
                 "zero-bias logits")
        dh_l, dw_l = lhk.loss_head_bwd_cuda(torch.ones(p, device=h.device),
                                            dy, h, w2, seg, block=block)
        same = None
        if lhk.kernel_path(block, h, w2, dh_l, dw_l) == dw_path:
            same = torch.equal(dw, dw_l)
            _require(same, f"m3_matmul_dw at block {block}: not bitwise "
                     "loss_head_bwd's dW with d_per ones")
        out["m3_matmul_fwd"].update({f"{pre}path": fwd_path,
                                     f"{pre}bitwise_infer_head": True})
        out["m3_matmul_dw"].update({f"{pre}path": dw_path,
                                    f"{pre}bitwise_loss_head_bwd": same})
    print(f"[m3_matmul on the heads' cores] {out}", flush=True)
    return out


def same_m3_as_parent(libs, at_a, at_b):
    """The parent's M3 forward and dW through its C entries ``m3_fwd_f32``
    and ``m3_dw_f32`` (their signatures unchanged) at path 4d (``at_a``)
    and path 4e's head (``at_b``), each (h, w2, member_ptr, block_seg, dy,
    block): dW at path 4d bitwise this tree's (one lane there: the same
    chain over the rows), or fail; and their device times from
    ``torch.profiler`` as {row: {parent_device_ms,
    parent_path_b_device_ms}}."""
    import ctypes

    import torch

    from repro_torch.kernels import m3_matmul as m3k
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fwd, dw = libs["m3_matmul"].m3_fwd_f32, libs["m3_matmul"].m3_dw_f32
    for fn in (fwd, dw):
        fn.argtypes, fn.restype = [P] * 4 + [I, L, I, I, I, P], I
    stream = torch.cuda.current_stream().cuda_stream
    out = {"m3_matmul_fwd": {}, "m3_matmul_dw": {}}
    for key, (h, w2, ptr, seg, dy, block) in (
            ("parent_device_ms", at_a), ("parent_path_b_device_ms", at_b)):
        b, hh = h.shape
        o, p = w2.shape[0], ptr.shape[0] - 1
        y, dwp = torch.empty(b, p, o, device=h.device), torch.empty_like(w2)
        run_fwd = partial(fwd, h.data_ptr(), w2.data_ptr(), ptr.data_ptr(),
                          y.data_ptr(), b, hh, o, p, block, stream)
        run_dw = partial(dw, h.data_ptr(), dy.data_ptr(), seg.data_ptr(),
                         dwp.data_ptr(), b, hh, o, p, block, stream)
        _require(run_fwd() == 0 and run_dw() == 0,
                 "the parent's m3_fwd_f32 or m3_dw_f32 failed")
        if key == "parent_device_ms":
            _require(_same_bits(dwp, m3k.m3_matmul_dw_cuda(dy, h, seg,
                                                           block=block)),
                     "m3_matmul_dw at path 4d: not bitwise the parent's")
        out["m3_matmul_fwd"][key] = _device_ms(run_fwd, "m3_fwd", 50)
        out["m3_matmul_dw"][key] = _device_ms(run_dw, "m3_dw", 50)
    print(f"[m3_matmul] dW at path 4d bitwise the parent's; the parent's "
          f"device times {out}", flush=True)
    return out


def _same_bits(a, b) -> bool:
    """Tensors of one dtype equal bit for bit (a signed zero or a NaN's
    payload counts, where ``torch.equal`` would let -0 pass for +0)."""
    import torch
    bits = {4: torch.int32, 2: torch.int16, 1: torch.int8}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(bits), b.view(bits))


def _gelu_cols(act_ids, block: int):
    """The columns of the gelu members' blocks (one id a block)."""
    from repro_torch.core.activations import ACTIVATION_ORDER
    return (act_ids == ACTIVATION_ORDER.index("gelu")).repeat_interleave(
        block)


def _identity_ids(act_ids):
    """Every block's activation the identity: the same launch then writes
    its f32 pre-activation (the epilogue picks the function per element
    after the sums)."""
    import torch

    from repro_torch.core.activations import ACTIVATION_ORDER
    return torch.full_like(act_ids, ACTIVATION_ORDER.index("identity"))


GELU_TAIL = -2.0   # below it 1 + erf(x/√2) < 0.046: the sum cancels


def _gelu_moved(name, got, theirs, cols, u, mask, deriv=False) -> dict:
    """``got`` (this tree's kernel) against ``theirs`` (the parent's C
    entry on the same inputs), where the parent computed the gelu as
    x/2·(1 + erf(x/√2)) and this tree as x/2·erfc(−x/√2), JAX's form
    (``deriv``: their derivatives): bitwise outside the gelu members'
    columns ``cols``; in them within the f32 tolerance of the parent's
    and, in the tail the erfc form repairs (the kernel's own f32
    pre-activation ``u`` below ``GELU_TAIL``, the value above 1e-6), no
    farther from the f64 function of ``u`` (times the mask) in relative
    terms than the parent's.  Returns the elements that moved and the
    largest move; both trees' largest relative error in that tail, their
    summed error over every negative pre-activation and their largest
    error; and (y) their largest relative error wherever |gelu| > 1e-6."""
    import torch

    from repro_torch.core.activations import ACTIVATIONS, ACTIVATION_DERIVS
    _require(_same_bits(got[:, ~cols].contiguous(),
                        theirs[:, ~cols].contiguous()),
             f"{name}: outside the gelu members' columns not bitwise the "
             "parent's")
    g, t = got[:, cols].double(), theirs[:, cols].double()
    uc = u[:, cols].double()
    fn = (ACTIVATION_DERIVS if deriv else ACTIVATIONS)["gelu"]
    exact = fn(uc) * mask[cols].double()
    err_new, err_par = (g - exact).abs(), (t - exact).abs()

    def worst_rel(err, where):
        return ((err[where] / exact.abs()[where]).max().item()
                if bool(where.any()) else 0.0)

    neg = uc < 0
    tail = (uc < GELU_TAIL) & (exact.abs() > 1e-6)
    bits = got[:, cols].contiguous().view(torch.int32) \
        != theirs[:, cols].contiguous().view(torch.int32)
    out = {"elements": int(g.numel()), "moved": int(bits.sum().item()),
           "max_move": (g - t).abs().max().item() if g.numel() else 0.0,
           "tail_elements": int(tail.sum().item()),
           "tail_max_rel_err": worst_rel(err_new, tail),
           "parent_tail_max_rel_err": worst_rel(err_par, tail),
           "negative_err_sum": err_new[neg].sum().item(),
           "parent_negative_err_sum": err_par[neg].sum().item(),
           "max_abs_err": err_new.max().item() if g.numel() else 0.0,
           "parent_max_abs_err": err_par.max().item() if g.numel() else 0.0}
    if not deriv:
        big = exact.abs() > 1e-6
        out["max_rel_err"] = worst_rel(err_new, big)
        out["parent_max_rel_err"] = worst_rel(err_par, big)
    print(f"[{name}] gelu columns against the parent: {out}", flush=True)
    _require(torch.allclose(g, t, rtol=RTOL, atol=ATOL),
             f"{name}: the gelu columns moved beyond the f32 tolerance of "
             f"the parent's: {out}")
    _require(out["tail_max_rel_err"] <= out["parent_tail_max_rel_err"],
             f"{name}: the gelu tail is no closer to the f64 value than the "
             f"parent's: {out}")
    return out


def same_input_as_parent(libs, name, fin, fin8, block) -> dict:
    """The input layer's outputs of this tree's kernels — y, the training
    launch's (y, g') and the int8 y — on fin = (x, w, bias, mask, act_ids)
    and fin8 = (x, w_q, w_scale, bias, mask, act_ids) against the C entries
    of ``libs`` (``parent_libs``), which keep their signatures: bitwise
    outside the gelu members' columns, and there as ``_gelu_moved`` holds
    them (the pre-activations from the same kernels with every block's
    activation the identity).  Returns {output: ``_gelu_moved``'s
    report}."""
    import ctypes

    import torch

    from repro_torch.kernels import fused_input as fik
    P, I = ctypes.c_void_p, ctypes.c_int
    lib = libs["fused_input"]
    fi, ft, f8 = (lib.fused_input_infer_f32, lib.fused_input_train_f32,
                  lib.fused_input_infer_i8)
    fi.argtypes, fi.restype = [P] * 6 + [I] * 4 + [P], I
    ft.argtypes, ft.restype = [P] * 7 + [I] * 4 + [P], I
    f8.argtypes, f8.restype = [P] * 7 + [I] * 5 + [P], I
    x, w, b, m, ids = fin
    bb, f = x.shape
    h = w.shape[0]
    ptr = [t.data_ptr() for t in (x, w, b, m, ids)]
    stream = torch.cuda.current_stream().cuda_stream
    y, g = (torch.empty(bb, h, device=x.device) for _ in range(2))
    cols = _gelu_cols(ids, block)
    ones = torch.ones_like(m)
    u = fik.fused_input_cuda(x, w, b, ones, _identity_ids(ids), block=block)
    u8 = fik.fused_input_int8_cuda(*fin8[:4], ones, _identity_ids(ids),
                                   block=block)
    out = {}
    _require(fi(*ptr, y.data_ptr(), bb, f, h, block, stream) == 0,
             "the parent's fused_input_infer_f32 failed")
    out["y"] = _gelu_moved(f"fused_input at {name}",
                           fik.fused_input_cuda(*fin, block=block), y, cols,
                           u, m)
    _require(ft(*ptr, y.data_ptr(), g.data_ptr(), bb, f, h, block,
                stream) == 0, "the parent's fused_input_train_f32 failed")
    got = fik.fused_input_train_cuda(*fin, block=block)
    out["train_y"] = _gelu_moved(f"fused_input (with g') y at {name}",
                                 got[0], y, cols, u, m)
    out["train_g"] = _gelu_moved(f"fused_input (with g') g' at {name}",
                                 got[1], g, cols, u, m, deriv=True)
    wq = fin8[1]
    _require(f8(*[t.data_ptr() for t in fin8], y.data_ptr(), bb, f,
                wq.shape[1], h, block, stream) == 0,
             "the parent's fused_input_infer_i8 failed")
    out["int8_y"] = _gelu_moved(f"fused_input_int8 at {name}",
                                fik.fused_input_int8_cuda(*fin8,
                                                          block=block),
                                y, cols, u8, m)
    print(f"[{name}] fused_input (y; y, g') and fused_input_int8 bitwise the "
          "parent's outside the gelu members' columns", flush=True)
    return out


def same_mid_as_parent(libs, name, args, args8, dh_args, dw_args, block):
    """A mid layer's outputs of this tree's kernels against the C entries of
    ``libs`` (``parent_libs``), called with their own signatures: the
    forward's group-table entries (x, wb or wb_q and wb_scale, [b_eff,
    mask, tile_act,] s_in, s_w, groups, y, …) and ``block_diag_dw_f32``'s
    member units (dy, x, units, job_ptr, dwb, …; the tables of
    ``block_diag.checked_dw_units``).  ``fused_layer`` y and (y, g') and
    ``block_diag_fwd`` y on
    args = (x, wb, b_eff, mask, tile_act, rowptr, s_in, s_w), its dh on
    dh_args = (dy, wb_t, rowptr_t, s_in_t, s_w_t), ``fused_layer_int8`` y
    on args8 = (x, wb_q, wb_scale, b_eff, mask, tile_act, rowptr, s_in,
    s_w), ``block_diag_dw`` dWB on dw_args = (dy, x, wb_out_tile,
    wb_in_tile), and dWB again on a 300-row dy and x: bitwise, or fail —
    but the ``fused_layer`` outputs in the gelu members' columns, which
    ``_gelu_moved`` holds (the pre-activations from the same kernels with
    every tile's activation the identity).  Returns the parent kernels'
    device times from ``torch.profiler`` as {row: fields}
    (``parent_device_ms``, and ``parent_train_device_ms`` or
    ``parent_dh_device_ms``) and ``_gelu_moved``'s reports as
    ``parent_gelu``."""
    import ctypes

    import torch

    from repro_torch.kernels import block_diag as bdk
    from repro_torch.kernels import fused_layer as flk
    P, I = ctypes.c_void_p, ctypes.c_int
    fl, bd = libs["fused_layer"], libs["block_diag"]
    fi, ft, f8 = (fl.fused_layer_infer_f32, fl.fused_layer_train_f32,
                  fl.fused_layer_infer_i8)
    fi.argtypes, fi.restype = [P] * 9 + [I] * 5 + [P], I
    ft.argtypes, ft.restype = [P] * 10 + [I] * 5 + [P], I
    f8.argtypes, f8.restype = [P] * 10 + [I] * 5 + [P], I
    bf, bw = bd.block_diag_fwd_f32, bd.block_diag_dw_f32
    bf.argtypes, bf.restype = [P] * 6 + [I] * 5 + [P], I
    bw.argtypes, bw.restype = [P] * 5 + [I] * 5 + [P], I
    stream = torch.cuda.current_stream().cuda_stream
    x, wb = args[:2]
    b, n_in = x.shape[0], x.shape[1] // block
    n_out = args[5].shape[0] - 1
    y, g = (torch.empty(b, n_out * block, device=x.device)
            for _ in range(2))
    groups = bdk.groups_on(*args[5:], block)
    ptr = [t.data_ptr() for t in (*args[:5], *args[6:], groups)]
    bd_ptr = [t.data_ptr() for t in (x, wb, *args[6:], groups)]
    dy, wb_t, rowptr_t = dh_args[:3]
    groups_t = bdk.groups_on(*dh_args[2:], block)
    n_rows_t = rowptr_t.shape[0] - 1
    dh = torch.empty(b, n_rows_t * block, device=x.device)
    dh_ptr = [t.data_ptr() for t in (dy, wb_t, *dh_args[3:], groups_t)]
    out_t = dw_args[2]
    dwb = torch.empty(out_t.shape[0], block, block, device=x.device)

    def serve():
        return fi(*ptr, y.data_ptr(), b, n_in, n_out, block,
                  groups.shape[0], stream)

    def train():
        return ft(*ptr, y.data_ptr(), g.data_ptr(), b, n_in, n_out, block,
                  groups.shape[0], stream)

    i8_ptr = [t.data_ptr() for t in (*args8[:6], *args8[7:], groups)]

    def int8():
        return f8(*i8_ptr, y.data_ptr(), b, n_in, n_out, block,
                  groups.shape[0], stream)

    def fwd():
        return bf(*bd_ptr, y.data_ptr(), b, n_in, n_out, block,
                  groups.shape[0], stream)

    def dh_pass():
        return bf(*dh_ptr, dh.data_ptr(), b, dy.shape[1] // block, n_rows_t,
                  block, groups_t.shape[0], stream)

    def dw_call(dy_, x_):
        """The parent's dW of dy_ and x_ over the tiles of dw_args."""
        units, jobs = bdk.checked_dw_units(dy_, x_, *dw_args[2:], block)

        def call():
            return bw(dy_.data_ptr(), x_.data_ptr(), units.data_ptr(),
                      jobs.data_ptr(), dwb.data_ptr(), dy_.shape[0],
                      dy_.shape[1] // block, x_.shape[1] // block, block,
                      jobs.shape[0] - 1, stream)
        return call

    dw = dw_call(*dw_args[:2])

    mask, tile_act = args[3], args[4]
    cols = _gelu_cols(tile_act, block)
    ones = torch.ones_like(mask)
    u = flk.fused_layer_cuda(*args[:3], ones, _identity_ids(tile_act),
                             *args[5:], blk=block)
    u8 = flk.fused_layer_int8_cuda(*args8[:4], ones, _identity_ids(tile_act),
                                   *args8[6:], blk=block)
    gelu = {}
    _require(serve() == 0, "the parent's fused_layer_infer_f32 failed")
    gelu["y"] = _gelu_moved(f"fused_layer at {name}",
                            flk.fused_layer_cuda(*args, blk=block), y, cols,
                            u, mask)
    _require(train() == 0, "the parent's fused_layer_train_f32 failed")
    got = flk.fused_layer_train_cuda(*args, blk=block)
    gelu["train_y"] = _gelu_moved(f"fused_layer (with g') y at {name}",
                                  got[0], y, cols, u, mask)
    gelu["train_g"] = _gelu_moved(f"fused_layer (with g') g' at {name}",
                                  got[1], g, cols, u, mask, deriv=True)
    _require(int8() == 0, "the parent's fused_layer_infer_i8 failed")
    gelu["int8_y"] = _gelu_moved(f"fused_layer_int8 at {name}",
                                 flk.fused_layer_int8_cuda(*args8, blk=block),
                                 y, cols, u8, mask)
    _require(fwd() == 0, "the parent's block_diag_fwd_f32 failed")
    _require(_same_bits(y, bdk.block_diag_fwd_cuda(x, wb, *args[5:],
                                                   blk=block)),
             f"block_diag_fwd at {name}: not bitwise the parent's")
    _require(dh_pass() == 0, "the parent's block_diag_fwd_f32 (dh) failed")
    _require(_same_bits(dh, bdk.block_diag_fwd_cuda(*dh_args, blk=block)),
             f"block_diag_fwd dh at {name}: not bitwise the parent's")
    _require(dw() == 0, "the parent's block_diag_dw_f32 failed")
    _require(_same_bits(dwb, bdk.block_diag_dw_cuda(*dw_args, blk=block)),
             f"block_diag_dw at {name}: not bitwise the parent's")
    # B = 300, ten 32-row chunks, the last one short: the chunk sums are
    # added in the parent's order
    gen = torch.Generator(device=x.device).manual_seed(300)
    dw300 = tuple(torch.randn(300, t.shape[1], device=x.device,
                              generator=gen) for t in dw_args[:2])
    dw300 += tuple(dw_args[2:])
    _require(dw_call(*dw300[:2])() == 0,
             "the parent's block_diag_dw_f32 (B = 300) failed")
    _require(_same_bits(dwb, bdk.block_diag_dw_cuda(*dw300, blk=block)),
             f"block_diag_dw at {name}, B = 300: not bitwise the parent's")
    out = {"fused_layer": {
               "parent_device_ms": _device_ms(serve,
                                              "fused_layer_group_kernel", 50),
               "parent_train_device_ms": _device_ms(
                   train, "fused_layer_group_kernel", 50)},
           "fused_layer_int8": {
               "parent_device_ms": _device_ms(
                   int8, "fused_layer_i8_group_kernel", 50)},
           "block_diag_fwd": {
               "parent_device_ms": _device_ms(fwd, "block_diag_group_kernel",
                                              50),
               "parent_dh_device_ms": _device_ms(
                   dh_pass, "block_diag_group_kernel", 50)},
           "block_diag_dw": {
               "parent_device_ms": _device_ms(
                   dw, "block_diag_dw_member_kernel", 50)}}
    out["parent_gelu"] = gelu
    print(f"[{name}] fused_layer (y; y, g') and fused_layer_int8 outside "
          f"the gelu members' columns, block_diag_fwd (y, dh) and "
          f"block_diag_dw (B = {b} and 300) bitwise the parent's; "
          f"the parent's device times {out}", flush=True)
    return out


def _loss_head_fields(kernels, block, h, w2, dh, dw):
    """Extra fields of the two loss-head rows at one shape, from
    ``kernels`` {row name: a call of its kernel}: the design each launch
    took (``kernel_path``) and the kernel's device time from
    ``torch.profiler``."""
    from repro_torch.kernels import loss_head as lhk
    paths = (lhk.kernel_path(block, h, w2),
             lhk.kernel_path(block, h, w2, dh, dw))
    out = {}
    for (key, fn), path in zip(kernels.items(), paths):
        out[key] = {"path": path,
                    "device_ms": _device_ms(fn, f"{key}_kernel", 50)}
    return out


def loss_head_library_full(lh, lb, hb, wb2, wm, fwd_out, bwd_out):
    """The fewest PyTorch calls that compute each loss-head kernel's whole
    function at ``parallelmlp-10k``'s shape (every member one width, so
    batched GEMMs over the members' (P, B, width) views), checked against
    the kernels' outputs and then timed: fields ``library_full_ms`` and
    ``library_full_calls`` of each row."""
    import torch
    h, w2, b2, tgt, _ = lh
    dper, dl = lb[0], lb[1]
    b, hh = h.shape
    o = w2.shape[0]
    # the targets' masks, made once, outside the time: (B, O) and (B, 1)
    t = tgt.long()
    valid = (t >= 0).float()[:, None]
    onehot = (torch.arange(o, device=h.device)[None] == t[:, None]).float()
    nll_w = -onehot * valid / BATCH
    scale = valid / BATCH
    neg_onehot = -onehot * scale

    def fwd():
        z = torch.baddbmm(b2[:, None, :], hb, wb2)          # (P, B, O)
        ls = torch.log_softmax(z, -1)
        per = (ls * nll_w).sum((1, 2))
        return per, torch.addcmul(neg_onehot, ls.exp(),
                                  scale).transpose(0, 1).contiguous()

    def bwd():
        g = (dl * dper[None, :, None]).transpose(0, 1)     # (P, B, O)
        dh = torch.bmm(g, wm).transpose(0, 1).reshape(b, hh)
        dw = torch.bmm(g.transpose(1, 2), hb).transpose(0, 1).reshape(o, hh)
        return dh, dw

    mb_a_float = 4e-6
    calls = (
        "baddbmm: the (P, B, O) logits; log_softmax; mul + sum: the "
        "per-member NLL; exp + addcmul: dl; one layout copy, dl to (B, P, "
        f"O) ({mb_a_float * dl.numel():.2f} MB); the targets' one-hot and "
        "row masks made once, outside the time",
        "mul: dl · d_per; bmm: dh as (P, B, width); bmm: dW as (P, O, "
        f"width); two layout copies, dh to (B, H) ({mb_a_float * b * hh:.2f}"
        f" MB) and dW to (O, H) ({mb_a_float * o * hh:.2f} MB)")
    out = []
    for name, fn, want, what in (("loss_head_fwd", fwd, fwd_out, calls[0]),
                                 ("loss_head_bwd", bwd, bwd_out, calls[1])):
        err = _close(f"{name}: library calls vs kernel", fn(), want)
        out.append({"library_full_ms": _time_ms(fn, 20),
                    "library_full_calls": what,
                    "library_full_max_abs_err": err})
        print(f"[{name}] library, the whole function: {out[-1]}", flush=True)
    return out


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout of the repository (e.g. the "
                    "parent commit's git archive): hold the output heads', "
                    "the path-4d M3 dW's, the input-layer and mid-layer "
                    "outputs bitwise to its kernels', and time its f32 "
                    "flash attention beside this tree's")
    ap.add_argument("--lifecycle", type=Path, default=None,
                    help=argparse.SUPPRESS)   # path 4g's own process
    ap.add_argument("--optim", type=Path, default=None,
                    help=argparse.SUPPRESS)   # path 4h's own process
    ap.add_argument("--bf16", type=Path, default=None,
                    help=argparse.SUPPRESS)   # path 4i's own process
    ap.add_argument("--pipeline", type=Path, default=None,
                    help=argparse.SUPPRESS)   # path 4j's own process
    ap.add_argument("--sharded", type=Path, default=None,
                    help=argparse.SUPPRESS)   # path 4k's own process
    ap.add_argument("--rank-jobs", type=Path, default=None,
                    help=argparse.SUPPRESS)   # one of path 4k's ranks
    ap.add_argument("--lm", type=Path, default=None,
                    help=argparse.SUPPRESS)   # path 4l's own process
    ap.add_argument("--lm-train", type=Path, default=None,
                    help=argparse.SUPPRESS)   # path 4m's own process
    args = ap.parse_args()
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
    if args.rank_jobs:
        return rank_jobs(args.rank_jobs)
    for out, path, key in ((args.lifecycle, lifecycle_path, "lifecycle"),
                           (args.optim, optim_path, "optim"),
                           (args.bf16, bf16_path, "bf16"),
                           (args.pipeline, pipeline_path, "pipeline"),
                           (args.sharded, sharded_path, "sharded"),
                           (args.lm, lm_serve_path, "lm"),
                           (args.lm_train, lm_train_path, "lm_train")):
        if out:
            from repro_torch.kernels import _build
            _build.build_all()
            res, n = path(out)
            (out / f"{key}.json").write_text(
                json.dumps({"results": res, "launches": n}))
            return 0
    t_start = time.perf_counter()

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__} CUDA {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # 2. build
    from repro_torch.checkpoint.checkpoint import restore_population
    from repro_torch.configs import parallelmlp_10k
    from repro_torch.kernels import _build
    from repro_torch.launch.launch_count import (kernel_launches,
                                                 reset_kernel_launches)
    from repro_torch.launch.train import population_from_flags
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    ptxas = {name: _ptxas(name) for name in sorted(libs)}
    parent = parent_libs(args.parent.resolve()) if args.parent else None

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        workdir = Path(tmp)
        lp10k = parallelmlp_10k.config().model.layered()
        lp3k = population_from_flags(DEPTH3["depths"], DEPTH3["acts"],
                                     DEPTH3["features"],
                                     repeats=DEPTH3["repeats"])
        _require(lp10k.num_members == 10_000
                 and lp10k.layer_pop(0).total_hidden == 1_280_000,
                 "parallelmlp-10k is not at full width")
        _require(lp3k.num_members == 3000 and lp3k.depth == 3,
                 "the trainer population is not 3,000 members deep 3")

        # a batch of the task for the checks (phases 3c and 5)
        x, y = check_batch()

        # 3. the serving path
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_launches()
        ck10k0, out10k = serve("parallelmlp-10k", lp10k, 0, workdir, 2)
        ck3k0, out3k = serve("trainer-depth3", lp3k, 1, workdir, 4)
        torch.cuda.synchronize()
        serve_n = kernel_launches()
        print(f"serving path kernel launches: {serve_n}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        for name in SERVE_KERNELS:
            _require(serve_n[name] > 0, f"kernel {name} was not launched on "
                     "the serving path")

        # 3c. the int8 serving path, each run counted alone; then the
        # servers' int8 copies checked with nothing else on the card
        out8, int8_n = {}, dict.fromkeys(INT8_KERNELS, 0)
        fresh = (("parallelmlp-10k", ck10k0, 2, out10k),
                 ("trainer-depth3", ck3k0, 4, out3k))
        for name, ck, budget, f32_out in fresh:
            out8[name], n = serve_int8(name, ck, budget, f32_out)
            int8_n = {k: int8_n[k] + n[k] for k in INT8_KERNELS}
        int8_copy = {name: check_int8(name, ck, x)
                     for name, ck, _, _ in fresh}

        # 3d. the unfused route, each serve counted alone; then one
        # forward of each checkpoint against the fused route
        out_u, unfused_serve_n = {}, dict.fromkeys(UNFUSED_KERNELS, 0)
        for (name, ck, _, f32_out), lp in zip(fresh, (lp10k, lp3k)):
            out_u[name], n = serve_unfused(name, ck, lp, f32_out)
            unfused_serve_n = _add_counts(unfused_serve_n, n)
        unfused_err = {name: check_unfused_forward(name, ck, x)
                       for name, ck, _, _ in fresh}
        print(f"unfused serving path kernel launches: {unfused_serve_n}",
              flush=True)
        for name in ("seg_act", "block_diag_fwd"):
            _require(unfused_serve_n[name] > 0, f"kernel {name} was not "
                     "launched on the unfused serving path")
        p10k = restore_population(str(ck10k0), device="cuda")[0]
        p3k = restore_population(str(ck3k0), device="cuda")[0]

        # 4. the training path: each run counted alone (train()), the
        # held-out checks outside the counts; the trained checkpoint's serve
        # counts on the serving path
        torch.cuda.reset_peak_memory_stats()
        t10k, _, stats10k, ck10k, n10k = train(
            "parallelmlp-10k", workdir, ["--arch", "parallelmlp-10k"])
        reset_kernel_launches()
        served = serve_checkpoint("parallelmlp-10k trained", ck10k, 2)
        torch.cuda.synchronize()
        serve_n = _add_counts(serve_n, kernel_launches())
        name = "parallelmlp-10k trained"
        out8[name], n = serve_int8(name, ck10k, 2, served)
        int8_n = {k: int8_n[k] + n[k] for k in INT8_KERNELS}
        int8_copy[name] = check_int8(name, ck10k, x)
        print(f"int8 serving path kernel launches: {int8_n}", flush=True)
        for name, n in int8_n.items():
            _require(n > 0, f"kernel {name} was not launched on the int8 "
                     "serving path")
        depth3 = depth3_flags()
        t3k, _, stats3k, _, n3k = train("trainer-depth3", workdir, depth3)
        train_n = _add_counts(n10k, n3k)
        print(f"training path kernel launches: {train_n}; serving path "
              f"with the trained checkpoint: {serve_n}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        for name, n in train_n.items():
            _require((n == 0) if name in INT8_KERNELS + UNFUSED_KERNELS
                     + M3_KERNELS + LM_KERNELS + BF16_KERNELS
                     + SEG_BF16_KERNELS else (n > 0),
                     f"kernel {name} was launched {n} times on the "
                     "training path")

        # 4c. the unfused route's training, counted alone
        _, _, stats3u, _, unfused_train_n = train(
            "trainer-depth3 unfused", workdir, depth3, unfused=True)
        for name in UNFUSED_KERNELS:
            _require(unfused_train_n[name] > 0, f"kernel {name} was not "
                     "launched on the unfused training path")

        # 4d. path A, the paper's single-layer ParallelMLP at full width,
        # its 16 steps counted alone (train_single)
        pop10k = parallelmlp_10k.config().model
        t_single, stats_single, n_single = train_single(
            "parallelmlp-10k single", pop10k, workdir)
        # 4e. path B, the depth-3 trainer with every unfused stage on its
        # kernel (--m3-impl pallas too), counted alone
        _, _, stats3m, _, n3m = train("trainer-depth3 unfused m3", workdir,
                                      depth3, unfused=True, m3=True)
        for name in M3_KERNELS + UNFUSED_KERNELS:
            _require(n3m[name] > 0, f"kernel {name} was not launched on "
                     "path 4e")
        # 4f. the paper's tables at its block-1 layout: one cell of the
        # grid through paper_tables.run (each arm counted alone), the two
        # arms' independence, and the feature-selection example
        paper_row, paper_n = paper_cell("paper-tables cell")
        p4f, pop4f, b4f, indep_err, n_indep, held = paper_independence(
            "paper-tables independence")
        feat, n_feat = paper_feature_selection("feature selection")
        n4f = {k: paper_n["parallel"][k] + n_indep[k] + n_feat[k]
               for k in M3_KERNELS}
        m3_n = {k: n_single[k] + n3m[k] + n4f[k] for k in M3_KERNELS}
        print(f"M3 kernel launches: path 4d {m3_only(n_single)}; path 4e "
              f"{m3_only(n3m)}; path 4f {n4f}", flush=True)
        # 4g. the lifecycle: the 10k ladder, the depth-3 population's three
        # runs, each counted alone, and the gathers on the card
        t0 = time.perf_counter()
        got = path_process(workdir, "lifecycle")
        life, life_n = got["results"], got["launches"]
        print(f"[lifecycle] path 4g in {time.perf_counter() - t0:.1f} s; "
              f"kernel launches {life_n}", flush=True)
        # 4h. the optimizers and the checkpoint: the 10k step under each
        # optimizer, adafactor's 10k ladder, the depth-3 runs, the 10k
        # checkpoint off the training thread
        t0 = time.perf_counter()
        got = path_process(workdir, "optim")
        optim, optim_n = got["results"], got["launches"]
        print(f"[optim] path 4h in {time.perf_counter() - t0:.1f} s; "
              f"kernel launches {optim_n}", flush=True)
        # 4i. the bf16 compute policy on the fused route: both checkpoints
        # served, the 10k trained, the depth-3 ladder with --serve-publish,
        # the bf16 instances of the kernel rows
        t0 = time.perf_counter()
        got = path_process(workdir, "bf16")
        bf16, bf16_n = got["results"], got["launches"]
        bf16_rows = bf16.pop("kernel_rows")
        print(f"[bf16] path 4i in {time.perf_counter() - t0:.1f} s; "
              f"kernel launches {bf16_n}", flush=True)
        # 4j. the data plane: --pipeline on against off at 10k and through
        # the depth-3 pbt ladder, the copies pinned, apart, overlapping
        t0 = time.perf_counter()
        got = path_process(workdir, "pipeline")
        pipe, pipe_n = got["results"], got["launches"]
        print(f"[pipeline] path 4j in {time.perf_counter() - t0:.1f} s; "
              f"kernel launches {pipe_n}", flush=True)
        # 4k. the population axis on 2 and 4 ranks sharing the card: the
        # 10k run, the depth-3 ladder with fillers, resumes across world
        # sizes, the sharded server, each against one rank; then the data
        # axis on 3 and 6 ranks: the 10k with its batch split, the depth-3
        # ladder on (3, 2), the server with its flushes split
        t0 = time.perf_counter()
        got = path_process(workdir, "sharded")
        sharded, sharded_n = got["results"], got["launches"]
        print(f"[sharded] path 4k in {time.perf_counter() - t0:.1f} s; "
              f"kernel launches over its ranks {sharded_n}", flush=True)
        for name in ("fused_input", "fused_input_bwd", "fused_layer",
                     "fused_layer_dx_dw", "loss_head_fwd", "loss_head_bwd",
                     "infer_head", "fused_input_int8", "infer_head_int8"):
            _require(sharded_n.get(name, 0) > 0, f"kernel {name} was not "
                     "launched on path 4k")
        # 4l. the decoder LMs served: qwen3-1.7b, mamba2-780m and
        # hymba-1.5b whole, deepseek-moe-16b (4 layers), h2o-danube-3-4b
        # (2 layers) and nemotron-4-340b (2 layers) at full width, each
        # against the same calls on the plain versions
        t0 = time.perf_counter()
        got = path_process(workdir, "lm")
        lm_serve, lm_serve_n = got["results"], got["launches"]
        print(f"[lm serve] path 4l in {time.perf_counter() - t0:.1f} s; "
              f"kernel launches {lm_serve_n}", flush=True)
        for name in LM_KERNELS:
            _require(lm_serve_n.get(name, 0) > 0, f"kernel {name} was not "
                     "launched on path 4l")
        # 4m. LM training: qwen3-1.7b, hymba-1.5b and mamba2-780m whole
        # through train.main, qwen3's and mamba2's gradients and update
        # against the plain versions, microbatches; deepseek-moe-16b (4
        # layers) trained, then served
        t0 = time.perf_counter()
        got = path_process(workdir, "lm_train")
        lm_train, lm_train_n = got["results"], got["launches"]
        print(f"[lm train] path 4m in {time.perf_counter() - t0:.1f} s; "
              f"training launches {lm_train_n}", flush=True)
        _require(lm_train_n.get("flash_attention", 0) > 0
                 and "moe_gemm" not in lm_train_n,
                 f"path 4m's training launched {lm_train_n}: flash "
                 "attention in every layer, no grouped GEMM")

    # 5. the training step's invariants, on a batch of the task
    check_train_step("parallelmlp-10k", t10k, lp10k, x, y)
    check_train_step("trainer-depth3", t3k, lp3k, x, y)
    check_unfused_step("trainer-depth3", t3k, lp3k, x, y)
    steps = {"parallelmlp-10k": time_train_step("parallelmlp-10k", t10k,
                                                lp10k, x, y, adam=False)}
    # the depth-3 step from one state, fused, unfused and unfused with the
    # M3 head (path 4e) in turns
    for key, unfused, m3 in (("trainer-depth3", False, False),
                             ("trainer-depth3 unfused", True, False),
                             ("trainer-depth3 unfused m3", True, True),
                             ("trainer-depth3 unfused m3 (2)", True, True),
                             ("trainer-depth3 unfused (2)", True, False),
                             ("trainer-depth3 (2)", False, False)):
        steps[key] = time_train_step(key, t3k, lp3k, x, y, adam=True,
                                     unfused=unfused, m3=m3)
    # path 4d's step: invariants, then m3_impl pallas and bucketed in turns
    check_single_step("parallelmlp-10k single", t_single, pop10k, x, y)
    from repro_torch.core.parallel_mlp import sgd_step
    for impl, run in (("pallas", ""), ("bucketed", ""), ("bucketed", " (2)"),
                      ("pallas", " (2)")):
        key = f"parallelmlp-10k single {impl}{run}"
        steps[key] = time_step(key, partial(sgd_step, t_single, x, y, 1e-2,
                                            pop10k, m3_impl=impl))
    # path 4f's two arms a step at a time
    steps.update(paper_step_times(p4f, pop4f, *b4f, held[1]))

    # 6. the kernel API at LM widths, counted alone; then its outputs
    # against the plain versions
    lm_in = lm_inputs()
    lm_out, lm_n, lm_designs = lm_path(lm_in)
    lm_err = check_lm_outputs(lm_in, lm_out)
    # freed before the population rows, which are timed as before this
    # phase existed; its rows are timed last on the same inputs made anew
    del lm_in, lm_out

    # 7 + 8. each kernel against its plain version; timings; outputs
    check_forward("parallelmlp-10k", p10k, lp10k, x)
    check_forward("trainer-depth3", p3k, lp3k, x)
    # rows 13-15 at path 4f's block-1 head, before the other rows
    block1 = m3_block1_fields(p4f, pop4f, b4f[0], paper_n["parallel"])
    del p4f, b4f
    # the rows are timed on an emptied allocator cache: left as the earlier
    # phases leave it, the f32 fused_layer row read 4-5 % slower on the H100
    gc.collect()
    torch.cuda.empty_cache()
    rows = kernel_rows(p10k, lp10k, p3k, lp3k, serve_n, train_n, int8_n,
                       unfused_serve_n, unfused_train_n, m3_n, parent)
    for name, fields in block1.items():
        rows[name].update(fields)
    for name, fields in bf16_rows.items():
        rows[name].update(fields)
    for name, fields in seg_act_bf16_fields(lp3k).items():
        rows[name].update(fields)
    for field, counts in (("lifecycle_launches", life_n),
                          ("optim_launches", optim_n),
                          ("pipeline_launches", pipe_n),
                          ("sharded_launches", sharded_n)):
        for name, n in counts.items():
            if n:
                rows[name][field] = n
    gc.collect()
    torch.cuda.empty_cache()
    rows.update(lm_rows(lm_inputs(), lm_n, lm_designs, ptxas, parent))
    # rows 18-19: path 4l's launches (the model path's), phase 6's apart,
    # and each call at the served models' shapes
    for name in LM_KERNELS:
        rows[name]["api_launches"] = rows[name]["launches"]
        rows[name]["launches"] = lm_serve_n[name]
        rows[name]["lm_train_launches"] = lm_train_n.get(name, 0)
        rows[name]["lm_serve"] = {
            arch_id: {shape: fields for shape, fields in
                      lm_serve[arch_id]["kernels"].items()
                      if shape.startswith(name.split("_")[0])}
            for arch_id in LM_SERVE}
    rows["flash_attention"]["lm_train"] = \
        lm_train["qwen3-1.7b"]["compare"]["kernels"]
    rows["moe_gemm"]["lm_train_serve_launches"] = \
        lm_train["deepseek-moe-16b"]["serve_launches"]["moe_gemm"]
    for row, lib, words in (
            ("fused_input", "fused_input", ("fused_input_kernel", ", float,")),
            ("fused_input_int8", "fused_input",
             ("fused_input_kernel", "signed char")),
            ("infer_head", "infer_head", ("infer_head_kernel",)),
            ("infer_head_int8", "infer_head", ("infer_head_i8_kernel",)),
            ("fused_input_bwd", "fused_input_bwd",
             ("fused_input_bwd_kernel",)),
            ("fused_layer_dx_dw", "fused_layer_dx_dw",
             ("fused_layer_dx_dw_kernel",)),
            ("m3_matmul_fwd", "m3_matmul", ("m3_fwd_stream_kernel",)),
            ("m3_matmul_dh", "m3_matmul", ("m3_dh_kernel",)),
            ("m3_matmul_dw", "m3_matmul", ("m3_dw_stream_kernel",)),
            ("fused_layer", "fused_layer", ("fused_layer_group_kernel",)),
            ("fused_layer_int8", "fused_layer",
             ("fused_layer_i8_group_kernel",)),
            ("block_diag_fwd", "block_diag", ("block_diag_group_kernel",)),
            ("block_diag_dw", "block_diag",
             ("block_diag_dw_member_kernel",)),
            ("seg_act", "seg_act", ("seg_act_fwd_kernel",)),
            ("seg_act_bwd", "seg_act", ("seg_act_bwd_kernel",))):
        rows[row]["ptxas"] = {k: v for k, v in ptxas[lib].items()
                              if all(word in k for word in words)}
    if args.parent:
        # rows 16-17's f32 kernels: the parent's ptxas report
        theirs = _ptxas("seg_act", args.parent.resolve() / "build"
                        / "kernels")
        for row in ("seg_act", "seg_act_bwd"):
            same = all(theirs.get(k) == v
                       for k, v in rows[row]["ptxas"].items())
            rows[row]["parent_ptxas_same"] = same
            _require(same and rows[row]["ptxas"], f"{row}: the f32 "
                     f"kernels' ptxas {rows[row]['ptxas']} against the "
                     f"parent's {theirs}")
    for row, lib, words in (
            ("fused_input", "fused_input",
             ("fused_input_kernel", "__nv_bfloat16")),
            ("fused_input_bwd", "fused_input_bwd",
             ("fused_input_bwd_bf16_kernel",)),
            ("fused_layer", "fused_layer", ("fused_layer_bf16_group_kernel",)),
            ("fused_layer_dx_dw", "fused_layer_dx_dw",
             ("fused_layer_dx_dw_bf16_kernel",)),
            ("infer_head", "infer_head", ("infer_head_bf16_kernel",)),
            ("loss_head_fwd", "loss_head", ("loss_head_fwd_bf16_kernel",)),
            ("loss_head_bwd", "loss_head", ("loss_head_bwd_bf16_kernel",)),
            ("fused_input_int8", "fused_input",
             ("fused_input_i8_bf16_kernel",)),
            ("fused_layer_int8", "fused_layer",
             ("fused_layer_i8_bf16_group_kernel",)),
            ("infer_head_int8", "infer_head", ("infer_head_i8_bf16_kernel",)),
            ("block_diag_fwd", "block_diag", ("block_diag_bf16_group_kernel",)),
            ("block_diag_dw", "block_diag",
             ("block_diag_dw_bf16_member_kernel",)),
            ("m3_matmul_fwd", "m3_matmul", ("m3_fwd_bf16_stream_kernel",)),
            ("m3_matmul_dh", "m3_matmul", ("m3_dh_bf16_kernel",)),
            ("m3_matmul_dw", "m3_matmul", ("m3_dw_bf16_stream_kernel",)),
            ("seg_act", "seg_act", ("seg_act_bf16_fwd_kernel",)),
            ("seg_act_bwd", "seg_act", ("seg_act_bf16_bwd_kernel",))):
        rows[row]["bf16_ptxas"] = {k: v for k, v in ptxas[lib].items()
                                   if all(word in k for word in words)}
    rows = [rows[name] for name in REPLACES if name in rows]
    _require([r["name"] for r in rows] == list(REPLACES),
             "a ported TPU kernel has no row")
    _require({Path(r["source"]).stem for r in rows} >= set(libs),
             "a built kernel library has no row")

    # 9. results
    print(json.dumps({"serve": {"parallelmlp-10k": out10k["serve"],
                                "trainer-depth3": out3k["serve"],
                                "parallelmlp-10k trained": served["serve"]},
                      "serve_int8": {k: v["serve"] for k, v in out8.items()},
                      "int8_copy": int8_copy,
                      "serve_unfused": {k: v["serve"]
                                        for k, v in out_u.items()},
                      "unfused_vs_fused_max_abs_err": unfused_err,
                      "train": {"parallelmlp-10k": stats10k,
                                "trainer-depth3": stats3k,
                                "trainer-depth3 unfused": stats3u,
                                "parallelmlp-10k single": stats_single,
                                "trainer-depth3 unfused m3": stats3m},
                      "train_step": steps,
                      "lifecycle": life,
                      "optim": optim,
                      "bf16": bf16,
                      "pipeline": pipe,
                      "sharded": sharded,
                      "lm_serve": {k: ({f: x for f, x in v.items()
                                        if f != "kernels"}
                                       if isinstance(v, dict) else v)
                                   for k, v in lm_serve.items()},
                      "lm_train": lm_train,
                      "paper_tables": {
                          "cell": paper_row, "launches": paper_n,
                          "independence_max_abs_err": indep_err,
                          "feature_selection": feat},
                      "lm_kernels_max_abs_err": lm_err,
                      "seconds": time.perf_counter() - t_start}))
    print(f"chip_smoke: the whole run in {time.perf_counter() - t_start:.1f}"
          f" s (path 4j {pipe['seconds']:.1f} s, path 4k "
          f"{sharded['seconds']:.1f} s, path 4l {lm_serve['seconds']:.1f} "
          f"s, path 4m {lm_train['seconds']:.1f} s)", flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
