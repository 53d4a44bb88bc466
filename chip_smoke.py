#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. device — the card's name and power limit (nvidia-smi);
2. build — every kernel of the main paths from ``src/repro_torch/kernels/
   csrc`` with nvcc for sm_90a (all sources at once), ptxas registers and
   spills (a spill fails the run); the B7 library's SASS (``cuobjdump
   -sass``) must hold ``HGMMA`` (``wgmma``) and ``UTMALDG`` (TMA loads):
   the bf16 forward was built for the tensor cores;
3. bit-exactness (run after 4c, beside the invariant pool of 5: both
   are checked, neither timed) — B1
   (significance filter), B4 (wire pack) and B5 (wire
   unpack-add) against their plain PyTorch versions on the card, at
   n in {1, 7, 13, 127, 1000003, 213620, 1431340}, with -0.0 and all-zero
   tiles in the inputs; B4 at float32, fp16 and bf16, B5 on float32 and
   int32 targets and, decode only, on float16 and bfloat16 targets from
   fp16 and bf16 values. Then B4 and B5 under repetition (the look-back's
   races show only so): at those n, one tile - 1, one tile and one tile +
   1 (the tile read from ``kernels.wire_pack.TILE``) and 16,777,223 (4,097
   tiles), densities 0, 0.05 and 1.0 with NaN and -0.0 among the values,
   B4 in its eight type pairs, B5 adding into float32 and int32 targets
   and decoding only into float32, int32, float16 and bfloat16 leaves,
   with all values and with three fewer than the set bits (the gather
   clamps to the last value), each case 50 times in a row. B2 (fused
   Adam + filter) and B3 (fused Adam) at the same n and at 0-d, steps 1
   and 100, in every combination of float32 and bfloat16 storage (B2:
   p/g, moments, residual; B3: p/g, moments); B2 at v_t in {0, 0.7}
   (float32 also at scale 1/3), B3 at weight decay in {0, 0.1}; and
   both at lm-100m's largest leaves (18,874,368 and 25,165,824 elements)
   in the bsp/isp steps' types: B2 on bfloat16 leaves, B3 with bfloat16
   moments and p in float32 and bfloat16. Tolerance: bit-identical.
   B7 (flash attention) against ``ref.mha_ref`` at float32 (2e-5) and
   bfloat16 (2e-2) over Dh 64 / 128
   / 256, causal and not, windows 64, 100 and 128, q_offsets (Sq 128
   against Skv 384 at 256, Sq 100 against Skv 300 at 200), ragged lengths
   (127, 129, 200, 255, 333, 1000; the tensor-core tile edges at Dh 32,
   64 and 128), GQA 24/8, 12/4 and 8/2, phi4-mini's prefill (B 4, S 1024),
   lm-100m's bsp step (B 16, S 256, H 12), and the serving prefills'
   windows: gemma3-12b's local layers (B 4, S 2,048, H 16/8, Dh 256,
   window 1,024) and mixtral-8x22b's (B 2, S 5,120, H 48/8, Dh 128,
   window 4,096); B8 (sLSTM scan) against
   ``ref.slstm_scan_ref`` on h and the final (c, n, h), from a zero and a
   non-zero state, on both routes: the cluster route (bf16 R) at B 2, S
   16, d 64, H 2 (2e-5) and at xlstm-1.3b's prefill width (S 1024, d
   2048, H 4) at B 1, 3, 4 and 16 (1e-4), the cooperative route (float32
   R) at the test shape (2e-5) and at B 4 of the prefill shape (1e-4);
   each case's plan is logged. Tolerances: those of the JAX package's own
   kernel tests; both sum in float32 in another order.
   The pod path's kernels: B6 (wire nnz) bit-exact at the sizes above and
   at lm-100m's pod-stacked 75,497,472 and 100,663,296 elements, float32,
   float16, bfloat16 and int32, with -0.0, a NaN, an all-zero tile and
   unaligned starts; B1 bit-exact on bfloat16 and float16 with x shared by
   a leading pod dimension; B7 also at Dh 32 and at lm-100m's and lm-8m's
   training shapes, and the gradients of one lm-100m attention block
   through its autograd Function against plain autograd (2e-2); the
   eviction pull at P_old 3, 5, 7 against numpy's float32 division, bit
   for bit;
4. main paths — ``python -m repro_torch.launch.train --runtime faas``,
   4 workers, 10 steps, 5 steps per invocation for the PMF-Nesterov
   bitmap leg; the other legs take their steps in one invocation (each
   invocation costs 4 cold starts); the B2 ones and SSP cross the
   boundary in the invariant runs instead. The PMF-Nesterov bitmap leg
   runs first and alone (its steady step is the main path's step time);
   the others run at the end of the invariant pool (phase 5), checked,
   not timed. Each job once with
   ``--wire-scheme bitmap`` and once with ``auto``: the PMF job at ML-10M
   width (U 10681 x 20, M 20 x 71567) with Nesterov (B1, B4, B5), and the
   LR job on dense Criteo (13 features, 200,000 samples, batch 256) with
   Adam (B2, B4, B5); then PMF at ML-10M width with Adam, bitmap only, so
   that B2 runs on the 1,431,340-element M leaf; then PMF-Nesterov bitmap
   under ``--consistency ssp --slack 3`` (bounded staleness: its drain
   after step 10 delivers the last 4 frontiers) and over ``--transport
   shm``. The kernel launch counts are read from the workers' telemetry of
   each run (each worker process starts at 0; the SSP drain's ride its
   final bye); a kernel of the path launched 0 times on a worker fails the
   run, and so does B1 launched on an Adam leg; on the PMF-Nesterov bitmap
   legs every worker must launch exactly B1 20, B4 20 and B5 60 times.
   The SSP digest must differ from ISP's, and the shm leg's digest and
   per-step wire bytes must equal tcp's; no segment of any job may be
   left in /dev/shm. Then the straggler duel, fig. 9's live half: PMF
   bitmap, 4 workers, 24 steps in one invocation, worker 0 sleeping 0.5 s
   every 12 steps, once under ISP and once under SSP (slack 3), one after
   the other; the non-straggler workers' p95 step time over steps > 1 of
   each and their ratio are logged, with their waits counted directly
   (worker-steps longer than half the delay, and their seconds), and both
   must finish with no dup mismatch;
4b. chaos — after the duel, alone, the chaos leg through the
   CLI (``--chaos``, so the supervisor runs out of process under
   ``run_job_resilient``): PMF-Nesterov bitmap at ML-10M width, 4 workers,
   2 tcp shards, 10 steps in one invocation, a checkpoint every 2, under
   one event of each of the nine kinds (``CHAOS_PLAN``: worker 3 delayed
   at every step from 5 on, a transport stall, delay and reset, worker 1
   SIGKILLed, shard 1's WAL corrupted (the rollback SIGKILLs the pool), a
   checkpoint write failed, the coordinator SIGKILLed, and at step 6 the
   supervisor itself). It must finish every step with the full pool and
   no dup mismatch, every event must fire (none skipped, each with its
   recovery), the supervisor must be restarted and resumed and re-adopt
   the four live workers and both shards by pid, worker 1 must be
   respawned at -9, every worker must launch B1, B4 and B5, the digest
   must be pmf_bitmap's, and no process of the job may be left; each
   recovery, the quarantined WAL bytes and the rollback are logged; its
   workers run under ``--hostperf`` (``launch/hostperf.py``'s env);
4c. topology tune — after the chaos leg, alone, the online co-tuner
   (``--topology-tune``, DESIGN.md §16): PMF-Nesterov bitmap at ML-10M
   width, 4 workers, one tcp shard at the start, 48 steps in one
   invocation, unpaced; the CLI chunks the leaves at 64 KiB over the
   consistent-hash ring, so each worker launches B4 once a chunk a step
   and B5 once a chunk a peer a step (102 chunks: the counts are derived
   from ``sharding.tree_subleaves`` and required exactly, with B1 96). It
   must explore its three cells (the start, 2 shards, shm) for at least
   ``topo_explore_steps`` steady steps each, commit with nothing
   abandoned and end on the chosen cell, refuse no retune, keep no dup
   mismatch and leave nothing in /dev/shm; each cell's p50, p95, phase
   p50s and first steps, and each handover's fence, moved subkeys and
   seconds are logged (``[topology]`` lines);
5. invariants — for PMF-Nesterov and for LR, the bitmap run's final-params
   digest must be identical with 2 broker shards, on a rerun, and with
   ``--wire-impl numpy`` (which must also give identical wire bytes); the
   PMF-Adam digest with 2 broker shards; LR's 2-shard run and rerun and
   PMF-Adam's 2-shard run at 5 steps an invocation, so that the B2 legs,
   run in one invocation, must equal a run across an invocation boundary
   (PMF-Nesterov's leg crosses one itself, and its rerun does too). These
   four runs across a boundary are pre-warmed (``--prewarm``): each must
   equal its cold leg's digest and per-step wire bytes and, for PMF-
   Nesterov, its exact launches, with a successor promoted on every slot
   (overlap >= 0; readiness at promotion and the walls logged); the SSP
   leg's digest and wire bytes at 2 shards over shm (5 steps an invocation: fresh segments for
   each) and with worker 1 SIGKILLed at step 7; the PMF bitmap leg's at 2
   shards over shm with shard 1 SIGKILLed at step 4 (one broker respawn,
   its segments served again); a small job of each workload on the card
   must agree with the same job on the CPU, 3 steps an invocation (final
   eval RMSE or BCE within 1e-3 relative: the two devices sum in different
   orders). PMF-Nesterov's pre-warmed rerun runs alone, so that its wall
   reads beside pmf_bitmap's; the other runs go side by side, five at a
   time, the main-path legs after pmf_bitmap last, while this process
   runs phase 3 and then the in-process trainer's legs below, one at a
   time: they are checked for bits, not timed. After the pool no process of the port
   but this one may be left (``[processes]`` line). First in that pool the
   retune leg, ``pmf_retune``: PMF-Nesterov bitmap, 4 workers, 10 steps in
   one invocation, one tcp shard re-sharded live to 2 shm shards at step
   3 and back to one tcp shard at 7 (``--retune``), worker 0 sleeping
   0.25 s a step so the supervisor mints each fence with steps left. Both
   handovers must commit with exactly their changes, the job end on one
   tcp shard at generation 2, billed at 2 shards, with no crash respawn,
   3 invocations a worker, no dup mismatch (the retired shard's counted),
   nothing left in /dev/shm, exactly B1 20 and the chunked B4 and B5
   counts on every worker, and the digest of ``pmf_bitmap``; beside it the
   tuning leg's job at a fixed topology (48 steps, one tcp shard, whole
   leaves), whose digest and per-step wire bytes the tuning leg's must
   equal. Beside them, the fleet (``--jobs``, ``runtime/scheduler.py``):
   ``fleet_pmf_lr`` packs the PMF-Nesterov and LR-Adam bitmap legs' jobs
   (4 workers, 10 steps each; PMF 5 an invocation) on one pool of 4
   slots over one tcp shard, one process a slot running a thread a job:
   each job's digest must be its solo leg's, every PMF worker must count
   exactly B1 20, B4 20 and B5 60 for its job (its thread's own count),
   every LR worker B2, B4 and B5 and no B1, and the rollup's per-job
   totals must sum to the pooled bill; ``fleet_pool_budget_shm`` runs the
   same jobs over 2 shm shards under ``--pool-budget 6``: at least two
   fair-share evictions, both jobs at step 10 with a survivor, every
   worker's launches of its job's kernels, nothing left in /dev/shm
   (evictions depend on timing: no digest); both without a dup mismatch,
   each logged on a ``[fleet]`` line (the pooled bill, its rollup, the
   invocations). Then the LM serving paths (``SERVE``), at full width in
   bf16, one after the other in fresh processes: ``python -m
   repro_torch.launch.serve --no-smoke`` for phi4-mini-3.8b (B7 in its 32
   attention layers) and xlstm-1.3b (B8 in its 6 sLSTM blocks), 8
   requests, 4 slots, prompt 1024, 32 new tokens each, and gemma3-12b (its
   48 layers, 40 of them sliding-window: B7 with the window of 1,024 and
   a ring cache), 8 requests, 4 slots, prompt 2,048, 32 new; then
   mixtral-8x22b cut to 8 of its 56 layers (sliding window 4,096, MoE 8
   experts top-2) through ``serve.serve(args, cfg=...)`` (``serve_cut``),
   4 requests, 2 slots, prompt 5,120, 32 new. B7 must launch exactly 32,
   48 and 8 times and B8 6 times (one prefill), and the new tokens must be
   the reference loop's count.
   The in-process trainer, ``python -m repro_torch.launch.train --runtime
   inproc --arch lm-100m --mode isp-pod`` at the JAX CLI's defaults (4 pods
   x 4 sequences x 256 tokens, Adam 3e-4, v 0.7), 10 steps with ``--scheme
   bitmap`` and with ``--scheme topk --budget 0.01``: B1 and B6 110
   launches each and B7 480, the loss finite and lower at the last step
   than at the first, the sent fraction in (0, 1); lm-8m under ``--autotune
   --sched-interval 0.1`` with checkpoints; in this process one profiled
   lm-100m step (busy share) and a scripted scale-in from 4 pods to 3 (the
   flushed parameters bit-exact against the plain float32 sum, then two
   steps at 3 pods). The in-process trainer's flat modes, ``--mode bsp``
   and ``--mode isp`` at lm-100m with the same defaults (one gradient over
   the 16 x 256-token global batch), 10 steps each: exactly B3 110 and B7
   120 under bsp, B2 110, B6 110 and B7 120 under isp, nothing else; the
   loss finite and falling, the isp sent fraction in (0, 1); then the CLI's
   default invocation (``--steps 20``: bsp, Adam, lm-8m on the card; B3
   220, B7 80); in this process one profiled lm-100m bsp step, and lm-100m
   cut to 2 layers in float32 for 3 bsp steps on the card and on the CPU
   from the same seeded parameters, losses within 1e-3 relative. Last, each
   serving arch cut in depth (``CARD_VS_CPU``: phi4 2 layers, xlstm one
   superblock, gemma3 one local and one global layer, mixtral 1 layer),
   float32, the same seeded parameters on the card and on the CPU: prefill
   logits within 1e-3 of a 128-token prompt in 2 slots (gemma3: 1,040
   tokens in 1 slot, past its window), and the greedy tokens of 2 decode
   steps (gemma3: 4, on the wrapped ring) compared (TF32 off for matmul
   and cuDNN). A profile of one prefill and 4 decode steps of each served
   config (device time, busy share, largest kernels, B7's or B8's share)
   says where a serving run's time goes. Every profile traces device
   activity only (the host trace's post-processing cost more than the
   steps it traced);
5b. simulator — the serverless training simulator in this process
   (``repro_torch.core.simulator``), ``examples/mlless_pmf.py``'s jobs at
   ML-10M width: P = 8 replicas of 2,048 ratings a step, Nesterov 0.08, v
   0.7, an 8,192-rating eval batch, 120 steps or RMSE 0.95: MLLess BSP,
   MLLess + ISP (twice: every loss and comm_frac bit-identical), MLLess +
   ISP + tuner, serverful BSP, PyWren BSP, MLLess SSP (slack 3), and
   MLLess + ISP at P = 24. B1 and B6 must launch exactly 2 a step (one a
   leaf) on the ISP jobs and not at all on the others, the eval RMSE must
   be finite and end below its first step's, and every worker's replica
   must be the same under BSP. First, B1 and B6 at the stacked leaves
   (8, 10681, 20), (8, 20, 71567) and (24, 20, 71567) against their plain
   versions, bit for bit; last, 3 ISP steps at P = 8 on the card and on
   the CPU (RMSE within 1e-5 and comm_frac within 1e-3 relative), and one
   steady ISP step under torch.profiler (device and wall ms, operations);
6. times — each kernel and its plain version at the main paths' shapes
   and measured density, with CUDA events, L2 cold (a 64 MiB buffer is
   rewritten before every launch) and warm, beside the bound: the bytes
   the function must move over 3.35 TB/s; for B3 also one
   ``torch._fused_adamw_`` call on the same float32 tensors; B3 and B2
   again at lm-100m's FF leaf with every operand bfloat16 (B3's row),
   B3 beside ``torch._fused_adamw_`` on the same bfloat16 tensors. B4 and
   B5 (and B5's decode-only form) must issue exactly one device operation
   a call (profiler counts: no memset, no second kernel; counted right
   after the build, alone on the card, at the main path's density and at
   4%, while the tracer is fresh). B7 at
   phi4-mini's prefill, the lm-100m bsp, lm-100m isp-pod and lm-8m bsp
   attention shapes, and the two windowed prefills above, each beside one
   ``scaled_dot_product_attention`` call (a window as a boolean
   ``attn_mask``), and B8 at xlstm-1.3b's prefill (its plan, the clusters the card
   holds at once, and one cluster a head against two, in turns), each
   beside the larger of its bytes over 3.35 TB/s and its operations over
   the peak rate of their type (989 TFLOP/s bf16, 67 TFLOP/s float32);
7. step profile — one worker step's device work at ML-10M width under
   torch.profiler: device time and device operations per step beside the
   host time and the main path's steady step time (the card's busy share);
8. summary — one ``{"kernels": [...]}`` line, the nvidia-smi line, and
   last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
SIZES = (1, 7, 13, 127, 1000003, 213620, 1431340)
# B4 and B5 under repetition (a race in the look-back shows only so): every
# encode type pair and every decode route, at SIZES, one tile - 1, one tile
# and one tile + 1, and a leaf of 4,097 tiles, at three densities with NaN
# and -0.0 among the values
WIRE_REPEATS = 50
WIRE_DENSITIES = (0.0, 0.05, 1.0)
WIRE_LONG = (1 << 24) + 7
ML10M = {"n_users": 10681, "n_movies": 71567, "n_ratings": 400000,
         "rank": 20, "batch_size": 256}
CRITEO = {"n_samples": 200000, "batch_size": 256}
# a job: workload, its config, optimizer and learning rate
PMF = {"workload": "pmf", "wcfg": ML10M, "optimizer": "nesterov", "lr": 0.08}
LR = {"workload": "lr", "wcfg": CRITEO, "optimizer": "adam", "lr": 0.01}
PMF_ADAM = dict(PMF, optimizer="adam", lr=0.01)
SMALL = {
    "pmf": dict(PMF, wcfg={"n_users": 120, "n_movies": 150,
                           "n_ratings": 6000, "rank": 4, "batch_size": 64}),
    "lr": dict(LR, wcfg={"n_samples": 4000, "batch_size": 128}),
}
KERNELS = {  # name -> (source, the TPU kernel's pallas_call it replaces)
    "significance_filter": ("src/repro_torch/kernels/csrc/significance.cu",
                            "src/repro/kernels/significance.py:92"),
    "wire_pack": ("src/repro_torch/kernels/csrc/wire_pack.cu",
                  "src/repro/kernels/wire_pack.py:133"),
    "wire_unpack_add": ("src/repro_torch/kernels/csrc/wire_pack.cu",
                        "src/repro/kernels/wire_pack.py:261"),
    "adam_sig_update": ("src/repro_torch/kernels/csrc/fused_adam.cu",
                        "src/repro/kernels/fused_adam.py:166"),
    "adam_update": ("src/repro_torch/kernels/csrc/fused_adam.cu",
                    "src/repro/kernels/fused_adam.py:119"),
}
KERNELS.update({
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:148"),
    "slstm_scan": ("src/repro_torch/kernels/csrc/slstm_scan.cu",
                   "src/repro/kernels/slstm_scan.py:105"),
    "wire_nnz": ("src/repro_torch/kernels/csrc/wire_pack.cu",
                 "src/repro/kernels/wire_pack.py:191"),
})
# the pod path at lm-100m, 4 pods: the (12, 768, 2048) FF leaves stacked
# over the pods, and the tied (32768, 768) embedding, the largest
POD_FF_LEAF, POD_TOK_LEAF = 4 * 12 * 768 * 2048, 4 * 32768 * 768
POD_SIZES = SIZES + (POD_FF_LEAF, POD_TOK_LEAF)
# the in-process trainer's legs (the JAX CLI's defaults at lm-100m width)
POD_ARGS = ["--arch", "lm-100m", "--mode", "isp-pod", "--workers", "4",
            "--per-worker-batch", "4", "--seq", "256", "--steps", "10"]
POD_LEGS = (("bitmap", ["--scheme", "bitmap"]),
            ("topk", ["--scheme", "topk", "--budget", "0.01"]))
# per 10-step lm-100m leg: 11 leaves a step for B1 and B6, 12 layers x 4
# pods a step for B7 (its forward; the backward recomputes the plain form)
POD_LAUNCHES = {"significance_filter": 110, "wire_nnz": 110,
                "flash_attention": 480}
# the in-process trainer's bsp and isp legs at lm-100m (the same defaults,
# one gradient over the global batch of 16 x 256 tokens): per 10 steps, 11
# leaves a step for B3 (bsp) or B2 and B6 (isp), 12 layers a step for B7;
# every other kernel 0
FLAT_ARGS = ["--arch", "lm-100m", "--workers", "4", "--per-worker-batch",
             "4", "--seq", "256", "--steps", "10"]
FLAT_LAUNCHES = {
    "bsp": {"adam_update": 110, "flash_attention": 120},
    "isp": {"adam_sig_update": 110, "wire_nnz": 110, "flash_attention": 120},
}
# the CLI's default invocation: bsp, Adam, lm-8m (11 leaves, 4 layers), 20
# steps of 4 x 4 x 256 tokens
CLI_DEFAULT_STEPS = 20
CLI_DEFAULT_LAUNCHES = {"adam_update": 220, "flash_attention": 80}
# lm-100m's largest leaves: the (12, 768, 2048) FF leaves and the tied
# (32768, 768) embedding; B2 and B3 are checked bit for bit at both
FF_LEAF, TOK_LEAF = 12 * 768 * 2048, 32768 * 768
TRAIN_CPU_TOL = 1e-3  # card vs CPU, float32 losses (sums in other orders)
BF16_FLOPS = 989e12  # H100 SXM, dense bf16 tensor cores
# B7 and B8 sum in float32 in another order than their plain versions:
# the tolerances of the JAX package's own tests (tests/test_kernels.py)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# the bf16 B7 rounds each probability to bf16 before P V: against a model of
# that arithmetic each term may differ by two roundings of P and the output
# by one, at bf16's unit roundoff
BF16_U = 2.0 ** -8
SLSTM_TOL, SLSTM_TOL_FULL = 2e-5, 1e-4
# the LM serving paths, each at full width in bf16: arch -> the kernel, its
# launches in one prefill, the run's arguments and, for a depth cut, its
# layers. gemma3's prompt is twice its local window (the window masks, the
# ring keeps the tail, decode wraps); mixtral (141B parameters) is cut to 8
# of its 56 layers to fit the card, its prompt past its window of 4,096
SERVE = {
    "phi4-mini-3.8b": dict(kernel="flash_attention", per_prefill=32,
                           requests=8, slots=4, prompt_len=1024, gen_len=32),
    "xlstm-1.3b": dict(kernel="slstm_scan", per_prefill=6, requests=8,
                       slots=4, prompt_len=1024, gen_len=32),
    "gemma3-12b": dict(kernel="flash_attention", per_prefill=48, requests=8,
                       slots=4, prompt_len=2048, gen_len=32),
    "mixtral-8x22b": dict(kernel="flash_attention", per_prefill=8,
                          requests=4, slots=2, prompt_len=5120, gen_len=32,
                          layers=8),
}
# card against CPU, float32 at full width: arch -> the depth cut's blocks
# (indices into the first group's superblock), reps, prompt, slots and
# greedy decode steps. gemma3's 1,040-token prompt crosses its window of
# 1,024 (prefill leaves the ring wrapped) and its decode steps write the
# ring's slots 16..19
CARD_VS_CPU = {
    "phi4-mini-3.8b": dict(blocks=(0,), reps=2, prompt=128, slots=2,
                           steps=2),
    "xlstm-1.3b": dict(blocks=None, reps=1, prompt=128, slots=2, steps=2),
    "gemma3-12b": dict(blocks=(0, -1), reps=1, prompt=1040, slots=1,
                       steps=4),
    "mixtral-8x22b": dict(blocks=(0,), reps=1, prompt=128, slots=2,
                          steps=2),
}
LM_CPU_TOL = 1e-3  # card vs CPU, float32 logits (sums in other orders)
# the simulator phase: examples/mlless_pmf.py's jobs at ML-10M width, P
# workers of SIM_B ratings, Nesterov, v 0.7, an 8,192-rating eval batch
SIM_P, SIM_B, SIM_STEPS, SIM_EVAL = 8, 2048, 120, 8192
SIM_P_MAX = 24  # the largest P of benchmarks/fig10_scalability.py
SIM_LR, SIM_V, SIM_SLACK, SIM_RMSE_TARGET = 0.08, 0.7, 3, 0.95
SIM_JOBS = (  # (label, platform, consistency, tuner)
    ("mlless_bsp", "MLLESS", "BSP", False),
    ("mlless_isp", "MLLESS", "ISP", False),
    ("mlless_all", "MLLESS", "ISP", True),
    ("serverful", "SERVERFUL", "BSP", False),
    ("pywren", "PYWREN", "BSP", False),
    ("mlless_ssp", "MLLESS", "SSP", False),
)
# the stacked leaves B1 and B6 see: P = 8's U and M, P = 24's M
SIM_STACKED = ((SIM_P, 10681, 20), (SIM_P, 20, 71567),
               (SIM_P_MAX, 20, 71567))
# card vs CPU: tests/test_torch_simulator.py's CARD_LOSS_RTOL and
# CARD_COMM_RTOL (other summation orders; a mask at its threshold can flip)
SIM_CPU_LOSS_RTOL, SIM_CPU_COMM_RTOL = 1e-5, 1e-3



class SmokeFailure(Exception):
    pass


_LOG_LOCK = threading.Lock()


def log(tag: str, **kv) -> None:
    """One line on stdout, whole: phases that run side by side log from
    their own threads."""
    line = f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kv.items()) + "\n"
    with _LOG_LOCK:
        sys.stdout.write(line)
        sys.stdout.flush()


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# -- phase 3: bit-exactness ----------------------------------------------------


def _bits(t):
    """The tensor's bytes (its values for an integer type), flat, where it
    lies: comparisons run on the card."""
    import torch

    t = t.detach().contiguous().reshape(-1)
    if t.dtype.is_floating_point:
        return t.view(torch.uint8)
    return t


def _same(a, b) -> bool:
    import torch

    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _abs_err(a, b) -> float:
    import torch

    if a.numel() == 0:
        return 0.0
    d = (a.detach().to(torch.float64) - b.detach().to(torch.float64)).abs()
    d = torch.nan_to_num(d, nan=0.0)  # NaN == NaN bitwise is checked apart
    return float(d.max())


def _inputs(n: int, seed: int):
    """u, x, r with -0.0 entries and a leading all-zero tile in x and r."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    u = (rng.standard_normal(n) * 0.01).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    r = (rng.standard_normal(n) * 0.01).astype(np.float32)
    u[::5] = -0.0
    x[::7] = 0.0
    x[: min(n, 256)] = 0.0
    r[: min(n, 256)] = -0.0
    return (torch.from_numpy(u), torch.from_numpy(x), torch.from_numpy(r))


def check_kernels(dev) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import ref, significance, wire_pack

    err = {k: 0.0 for k in KERNELS}
    for i, n in enumerate(SIZES):
        u, x, r = _inputs(n, seed=i)
        v_t = 0.5
        got = significance.significance_filter(u.to(dev), x.to(dev),
                                               r.to(dev), v_t)
        want = ref.significance_ref(u.to(dev), x.to(dev), r.to(dev), v_t)
        for g, w in zip(got, want):
            require(_same(g, w), f"significance_filter differs at n={n}")
            err["significance_filter"] = max(err["significance_filter"],
                                             _abs_err(g, w))
        sig = want[0].clone()
        sig[: min(n, 512)] = 0.0  # all-zero tiles
        sig[512:1024:3] = -0.0
        for vdt in (torch.float32, torch.float16, torch.bfloat16):
            got = wire_pack.wire_pack(sig, vdt)
            want = ref.wire_pack_ref(sig, vdt)
            nnz = int(want[4])
            require(int(got[4]) == nnz, f"wire_pack nnz differs at n={n}")
            for j, (g, w) in enumerate(zip(got, want)):
                if j in (2, 3):  # compacted values/indices: first nnz
                    g, w = g[:nnz], w[:nnz]
                require(_same(g, w),
                        f"wire_pack output {j} differs at n={n} {vdt}")
                err["wire_pack"] = max(err["wire_pack"], _abs_err(g, w))
            tgt = torch.from_numpy(np.random.default_rng(100 + i)
                                   .standard_normal(n).astype(np.float32))
            tgt[::3] = -0.0
            tgt = tgt.to(dev)
            mask, cvals = want[0], want[2][:nnz]
            g = wire_pack.wire_unpack_add(tgt, mask, cvals)
            w = ref.wire_unpack_add_ref(tgt, mask, cvals)
            require(_same(g, w), f"wire_unpack_add differs at n={n} {vdt}")
            err["wire_unpack_add"] = max(err["wire_unpack_add"],
                                         _abs_err(g, w))
            if vdt != torch.float32:  # decode only into half leaves
                for tdt in (torch.float16, torch.bfloat16):
                    g = wire_pack.wire_unpack(mask, cvals, n, tdt)
                    w = ref.wire_unpack_ref(mask, cvals, n, tdt)
                    require(_same(g, w), f"wire_unpack {vdt} -> {tdt} "
                            f"differs at n={n}")
        si = (sig * 1000).to(torch.int32)
        got = wire_pack.wire_pack(si, torch.int32)
        want = ref.wire_pack_ref(si, torch.int32)
        nnz = int(want[4])
        for j, (g, w) in enumerate(zip(got, want)):
            if j in (2, 3):
                g, w = g[:nnz], w[:nnz]
            require(_same(g, w), f"wire_pack int32 output {j} at n={n}")
        ti = torch.from_numpy(np.random.default_rng(200 + i).integers(
            -1000, 1000, n, dtype=np.int32)).to(dev)
        g = wire_pack.wire_unpack_add(ti, want[0], want[2][:nnz])
        w = ref.wire_unpack_add_ref(ti, want[0], want[2][:nnz])
        require(_same(g, w), f"wire_unpack_add int32 differs at n={n}")
    check_adam(dev, err)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)  # a fault during a kernel surfaces here
    for k, v in err.items():
        adam = {"sizes": ",".join(map(str, SIZES))
                + f",0-d,{FF_LEAF},{TOK_LEAF}",
                "dtypes": "float32,bfloat16 (every combination at the "
                          "small sizes; the path's at the large)"}
        log("kernel-check", kernel=k, max_abs_err=v,
            **(adam if k.startswith("adam")
               else {"sizes": ",".join(map(str, SIZES))}))
    return err


def _wire_leaf(n: int, density: float, seed: int):
    """float32 with about ``density`` of it significant, -0.0 (not
    significant) at every 13th element and, where anything is significant,
    NaN (significant) at every 997th."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n).astype(np.float32)
    a[rng.random(n) >= density] = 0.0
    a[5::13] = -0.0
    if density > 0:
        a[3::997] = np.nan
    return torch.from_numpy(a)


def _differs(a, b):
    """A 0-d bool on the card: do a and b differ in any bit (shapes and
    types are checked here, the bits without a sync)."""
    import torch

    require(a.shape == b.shape and a.dtype == b.dtype,
            f"{a.shape} {a.dtype} against {b.shape} {b.dtype}")
    return torch.ne(_bits(a), _bits(b)).any()


def check_wire_stress(dev) -> dict:
    """B4 and B5, each case called WIRE_REPEATS times in a row, every
    result bit-equal to the plain version on the same inputs: B4 in its
    eight type pairs, B5 adding into float32 and int32 targets and decoding
    only into float32, int32, float16 and bfloat16 leaves, with all values
    and with three fewer than the set bits (the gather clamps)."""
    import torch

    from repro_torch.kernels import ref, wire_pack

    f32, f16, bf16, i32 = (torch.float32, torch.float16, torch.bfloat16,
                           torch.int32)
    pairs = ((f32, f32), (f32, f16), (f32, bf16), (f16, f16), (f16, bf16),
             (bf16, f16), (bf16, bf16), (i32, i32))
    sizes = SIZES + (wire_pack.TILE - 1, wire_pack.TILE, wire_pack.TILE + 1,
                     WIRE_LONG) + topology_chunk_sizes()
    calls = {"wire_pack": 0, "wire_unpack_add": 0, "wire_unpack": 0}
    for n in sizes:
        for density in WIRE_DENSITIES:
            x32 = _wire_leaf(n, density, seed=n).to(dev)
            tgt = _wire_leaf(n, 1.0, seed=n + 1).to(dev)
            tgt = torch.nan_to_num(tgt, nan=-0.0)
            for tin, tout in pairs:
                x = (torch.nan_to_num(x32 * 1000, nan=7.0).to(i32)
                     if tin == i32 else x32.to(tin))
                want = ref.wire_pack_ref(x, tout)
                k = int(want[4])
                what = f"{tin}->{tout} n={n} density={density}"
                bad = torch.zeros((), dtype=torch.bool, device=dev)
                for _ in range(WIRE_REPEATS):
                    got = wire_pack.wire_pack(x, tout)
                    for j, (g, w) in enumerate(zip(got, want)):
                        if j in (2, 3):
                            g, w = g[:k], w[:k]
                        bad |= _differs(g, w)
                calls["wire_pack"] += WIRE_REPEATS
                require(not bool(bad), f"wire_pack {what} differs")
                if tin not in (f32, i32):
                    continue  # B5's inputs depend on the wire type only
                mask = want[0]
                t = (torch.nan_to_num(tgt * 1000, nan=0.0).to(i32)
                     if tout == i32 else tgt)
                decode = [f32] if tout == f32 else (
                    [i32] if tout == i32 else [f32, f16, bf16])
                for cv in (want[2][:k], want[2][:max(k - 3, 0)]):
                    cases = [("wire_unpack_add",
                              lambda: wire_pack.wire_unpack_add(t, mask, cv),
                              ref.wire_unpack_add_ref(t, mask, cv))]
                    for tdt in decode:
                        cases.append((
                            "wire_unpack",
                            lambda tdt=tdt: wire_pack.wire_unpack(
                                mask, cv, n, tdt),
                            ref.wire_unpack_ref(mask, cv, n, tdt)))
                    for name, kern, w in cases:
                        bad = torch.zeros((), dtype=torch.bool, device=dev)
                        for _ in range(WIRE_REPEATS):
                            bad |= _differs(kern(), w)
                        calls[name] += WIRE_REPEATS
                        require(not bool(bad), f"{name} {what} values "
                                f"{cv.numel()} of {k} differs")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)  # a fault during a kernel surfaces here
    log("wire-stress", sizes=",".join(map(str, sizes)),
        densities=",".join(map(str, WIRE_DENSITIES)),
        repeats=WIRE_REPEATS, calls=json.dumps(calls), tile=wire_pack.TILE,
        long_leaf_tiles=wire_pack.tiles(WIRE_LONG))
    return calls


def _adam_inputs(shape, seed: int):
    """p, g, mu, nu (>= 0), r as float32 with -0.0 entries and a leading
    all-zero tile in p, g, mu, nu and r."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    out = []
    for scale in (1.0, 0.1, 0.01, 1e-4, 0.01):
        a = np.asarray(rng.standard_normal(shape) * scale, np.float32)
        flat = a.reshape(-1)
        flat[: min(flat.size, 256)] = 0.0
        flat[1::5] = -0.0
        out.append(a)
    np.abs(out[3], out=out[3])
    return [torch.from_numpy(a) for a in out]


def _check_adam_case(dev, err: dict, ins, step: int, what: str, *,
                     sig=None, adam=None) -> None:
    """One B2 call (``sig``: (p, m, r dtypes, v_t, scale)) or B3 call
    (``adam``: (p, m dtypes, weight decay)) against its plain version on
    the same host scalars, bit for bit."""
    from repro_torch.kernels import fused_adam, ref

    if sig is not None:
        pdt, mdt, rdt, v_t, scale = sig
        t = [ins[0].to(pdt), ins[1].to(pdt), ins[2].to(mdt), ins[3].to(mdt),
             ins[4].to(rdt)]
        got = fused_adam.adam_sig_update(*t, 1e-3, step, v_t, scale=scale)
        s = ref.adam_scalars(1e-3, 0.9, 0.999, 1e-8, step, v_t, scale)
        want = ref.adam_sig_ref(*t, s)
        name = "adam_sig_update"
    else:
        pdt, mdt, wd = adam
        t = [ins[0].to(pdt), ins[1].to(pdt), ins[2].to(mdt), ins[3].to(mdt)]
        got = fused_adam.adam_update(*t, 1e-3, step, weight_decay=wd)
        s = ref.adam_scalars(1e-3, 0.9, 0.999, 1e-8, step, wd)
        want = ref.adam_ref(*t, s)
        name = "adam_update"
    for j, (g, w) in enumerate(zip(got, want)):
        require(g.dtype == w.dtype and _same(g, w),
                f"{name} output {j} differs at {what} step={step} "
                f"{sig or adam}")
        err[name] = max(err[name], _abs_err(g, w))


def check_adam(dev, err: dict) -> None:
    """B2 and B3 against their plain versions on the same host scalars.
    At 0-d and SIZES: every storage-type combination (B2: p/g, moments and
    residual each float32 or bfloat16; B3: p/g and moments), B2 at v_t in
    {0, 0.7} (float32 also at scale 1/3), B3 at weight decay 0 and 0.1. At
    lm-100m's FF leaf and tied embedding: the path's types, B2 on bfloat16
    leaves and B3 with bfloat16 moments (p in float32 and bfloat16)."""
    import torch

    f32, bf16 = torch.float32, torch.bfloat16
    types = (f32, bf16)
    for i, shape in enumerate([()] + [(n,) for n in SIZES + (FF_LEAF,
                                                             TOK_LEAF)]):
        big = shape in ((FF_LEAF,), (TOK_LEAF,))
        ins = [t.to(dev) for t in _adam_inputs(shape, seed=50 + i)]
        what = f"shape={shape}"
        for step in (1, 100):
            for v_t in (0.0, 0.7):
                if big:
                    combos = [(bf16, bf16, bf16, 1.0)]
                else:
                    combos = [(f32, f32, f32, 1.0), (f32, f32, f32, 1 / 3)]
                    combos += [(p, m, r, 1.0) for p in types for m in types
                               for r in types if bf16 in (p, m, r)]
                for pdt, mdt, rdt, scale in combos:
                    _check_adam_case(dev, err, ins, step, what,
                                     sig=(pdt, mdt, rdt, v_t, scale))
            for pdt in types:
                for mdt in ((bf16,) if big else types):
                    for wd in ((0.0,) if big else (0.0, 0.1)):
                        _check_adam_case(dev, err, ins, step, what,
                                         adam=(pdt, mdt, wd))
        del ins
    torch.cuda.empty_cache()


# -- phase 3b: B7 and B8 against their plain versions ---------------------------


def _close(got, want, tol: float, what: str) -> float:
    """Require ``|got - want| <= tol + tol * |want|`` everywhere (finite,
    same shape); returns the largest absolute difference."""
    import torch

    g, w = got.detach().float(), want.detach().float()
    require(g.shape == w.shape, f"{what}: shape {tuple(g.shape)} != "
            f"{tuple(w.shape)}")
    require(bool(torch.isfinite(g).all()), f"{what}: non-finite output")
    diff = (g - w).abs()
    bad = diff > tol + tol * w.abs()
    require(not bool(bad.any()), f"{what}: {int(bad.sum())} entries off by "
            f"up to {float(diff.max())} (tolerance {tol})")
    return float(diff.max()) if diff.numel() else 0.0


def _randn(shape, gen, dev, dtype=None, scale: float = 1.0):
    import torch

    t = torch.randn(shape, generator=gen, device=dev) * scale
    return t.to(dtype) if dtype is not None else t


# (B, Sq, Skv, H, K, Dh, causal, window, q_offset) of the B7 sweep
FLASH_CASES = (
    [(2, 256, 256, 2, 2, dh, causal, None, 0)
     for dh in (32, 64, 128, 256) for causal in (True, False)]
    + [(1, 256, 256, 2, 2, 128, True, w, 0) for w in (64, 128)]
    + [(1, 128, 384, 2, 2, 128, True, None, 256),  # q_offset
       (2, 200, 200, 2, 2, 128, True, None, 0),  # ragged
       (1, 1000, 1000, 2, 2, 64, True, None, 0),
       (1, 1000, 1000, 2, 2, 256, False, 128, 0),
       (2, 333, 333, 24, 8, 128, True, None, 0),  # GQA 24/8
       (4, 1024, 1024, 24, 8, 128, True, None, 0),  # phi4-mini prefill
       (4, 256, 256, 12, 12, 64, True, None, 0),  # lm-100m training
       (4, 256, 256, 8, 8, 32, True, None, 0)]  # lm-8m training
    # the tensor-core kernel's tile edges (BQ 64 / 128, BK 64 / 128)
    + [(2, s, s, 2, 2, dh, causal, None, 0) for s in (127, 129, 255)
       for dh in (32, 64, 128) for causal in (True, False)]
    + [(1, 100, 300, 2, 2, 128, True, None, 200),  # q_offset off the tile
       (1, 300, 300, 2, 2, 64, True, 100, 0),  # window 100
       (2, 256, 256, 12, 4, 64, True, None, 0),  # GQA 12/4
       (2, 256, 256, 8, 2, 32, True, None, 0),  # GQA 8/2
       (16, 256, 256, 12, 12, 64, True, None, 0),  # lm-100m bsp step
       # the serving prefills' sliding windows: gemma3-12b's local layers,
       # mixtral-8x22b's layers
       (4, 2048, 2048, 16, 8, 256, True, 1024, 0),
       (2, 5120, 5120, 48, 8, 128, True, 4096, 0)])


def _mha_p_bf16(q, k, v, causal, window, q_offset):
    """``ref.mha_ref``'s arithmetic with the bf16 B7's one new rounding: the
    unnormalised probabilities P go to bf16 before P V, their sum l stays
    float32. Returns the float32 output and the size of its terms,
    ``(P |v|) / l``, both (B, Sq, H, Dh)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref

    b, sq, h, dh = q.shape
    skv, kh = k.shape[1], k.shape[2]
    scale = float(np.float32(1.0) / np.sqrt(np.float32(dh)))
    qg = q.float().reshape(b, sq, kh, h // kh, dh)
    logits = torch.einsum("bqkgd,bckd->bkgqc", qg, k.float()) * scale
    q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    allow = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        allow &= k_pos <= q_pos
    if window is not None:
        allow &= q_pos - k_pos < window
    # in place: at mixtral's prefill (B 2, S 5,120, H 48) each (B, H, Sq,
    # Skv) float32 tensor takes 10 GB
    p = logits.masked_fill_(~allow, ref.NEG_INF)
    p = p.sub_(p.amax(-1, keepdim=True)).exp_()
    l = p.sum(-1, keepdim=True)
    pb = p.bfloat16().float()
    del logits, p

    def pv(x):
        y = torch.einsum("bkgqc,bckd->bkgqd", pb, x) / l
        return y.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh)

    vf = v.float()
    return pv(vf), pv(vf.abs())


def _within_p_rounding(got, q, k, v, kw, what: str) -> float:
    """Require the bf16 B7 within ``2u (P |v|) / l + u |o|`` of
    ``_mha_p_bf16``'s ``o`` everywhere (u = BF16_U, plus 1e-6); returns the
    largest share of that bound used."""
    want, size = _mha_p_bf16(q, k, v, **kw)
    bound = 2 * BF16_U * size + BF16_U * want.abs() + 1e-6
    share = float(((got.float() - want).abs() / bound).max())
    require(share <= 1.0, f"{what}: off the P-rounded-to-bf16 model by "
            f"{share:.3f} of its bound")
    return share


def check_flash(dev) -> float:
    """B7 against ``ref.mha_ref`` on the card over FLASH_CASES, each at
    float32 and bfloat16, and the bf16 kernel also against the model of its
    arithmetic (``_within_p_rounding``); returns the largest absolute
    difference from ``ref.mha_ref``."""
    import torch

    from repro_torch.kernels import flash_attention, ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    worst = 0.0
    for b, sq, skv, h, kh, dh, causal, window, off in FLASH_CASES:
        for name, dt in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
            q = _randn((b, sq, h, dh), gen, dev, dt)
            k = _randn((b, skv, kh, dh), gen, dev, dt)
            v = _randn((b, skv, kh, dh), gen, dev, dt)
            kw = dict(causal=causal, window=window, q_offset=off)
            got = flash_attention.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize(dev)
            err = _close(got, ref.mha_ref(q, k, v, **kw), FLASH_TOL[name],
                         f"flash_attention B{b} Sq{sq} Skv{skv} H{h}/{kh} "
                         f"Dh{dh} {name} {kw}")
            worst = max(worst, err)
            extra = {}
            if dt == torch.bfloat16:
                extra["p_bf16_model_bound_share"] = _within_p_rounding(
                    got, q, k, v, kw, f"flash_attention B{b} Sq{sq} "
                    f"Skv{skv} H{h}/{kh} Dh{dh} {kw}")
            log("kernel-check", kernel="flash_attention", B=b, Sq=sq,
                Skv=skv, H=f"{h}/{kh}", Dh=dh, dtype=name, causal=causal,
                window=window, q_offset=off, max_abs_err=err,
                tolerance=FLASH_TOL[name], **extra)
            del q, k, v, got
    # the mixtral case's references take tens of GB: give them back to the
    # card, which the serving processes need whole
    torch.cuda.empty_cache()
    return worst


def _slstm_case(dev, gen, b, s, d, heads, r_dtype, state: bool):
    import torch

    dh = d // heads
    xg = _randn((b, s, 4 * d), gen, dev)
    r = _randn((heads, dh, 4 * dh), gen, dev, r_dtype, 0.5 / dh ** 0.5)
    st = None
    if state:
        st = (_randn((b, d), gen, dev), _randn((b, d), gen, dev).abs() + 1,
              _randn((b, d), gen, dev))
    return xg, r, st


def check_slstm(dev) -> float:
    """B8 against ``ref.slstm_scan_ref`` on the card: h and the final
    (c, n, h), from a zero and a non-zero state, on both routes: at the
    test shape (2e-5) bf16 R on the cluster route and float32 R on the
    cooperative one; at xlstm-1.3b's prefill width (1e-4) bf16 R at B 1,
    3, 4 and 16 (cluster) and float32 R at B 4 (cooperative). Logs each
    case's plan; returns the largest absolute difference."""
    import torch

    from repro_torch.kernels import ref, slstm_scan

    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    cases = [(2, 16, 64, 2, dt, st, SLSTM_TOL)
             for dt in (torch.float32, torch.bfloat16) for st in (False, True)]
    cases += [(b, 1024, 2048, 4, torch.bfloat16, st, SLSTM_TOL_FULL)
              for b in (1, 3, 4, 16) for st in (False, True)]
    cases += [(4, 1024, 2048, 4, torch.float32, st, SLSTM_TOL_FULL)
              for st in (False, True)]
    worst = 0.0
    routes = set()
    for b, s, d, heads, rdt, st, tol in cases:
        xg, r, state = _slstm_case(dev, gen, b, s, d, heads, rdt, st)
        p = slstm_scan.plan(b, d, heads, rdt)
        routes.add(p.route)
        hs, final = slstm_scan.slstm_scan(xg, r, state)
        torch.cuda.synchronize(dev)
        want_hs, want_final = ref.slstm_scan_ref(xg, r, state)
        what = f"slstm_scan B{b} S{s} d{d} H{heads} r {rdt} state={st}"
        err = _close(hs, want_hs, tol, what + " h")
        for name, g, w in zip("cnh", final, want_final):
            err = max(err, _close(g, w, tol, f"{what} final {name}"))
        worst = max(worst, err)
        log("kernel-check", kernel="slstm_scan", B=b, S=s, d=d, H=heads,
            r_dtype=str(rdt).split(".")[1], initial_state=st,
            route=p.route, cluster=p.cluster, units=p.units, rows=p.rows,
            kslices=p.kslices, threads=p.threads, smem=p.smem,
            max_abs_err=err, tolerance=tol)
    require(routes == {"cluster", "cooperative"},
            f"slstm_scan: checked routes {sorted(routes)}, not both")
    return worst


# -- phase 3c: the pod path's kernels and reintegration --------------------------


def _pod_values(n: int, gen, dev):
    """float32 values on the card with zeros (60%), -0.0, a NaN and a
    leading all-zero 32,768-element tile (the TPU kernels' tile)."""
    import torch

    x = torch.randn(n, generator=gen, device=dev)
    x[torch.rand(n, generator=gen, device=dev) < 0.6] = 0.0
    x[1::11] = -0.0
    if n > 2 * 32768:
        x[:32768] = 0.0
        x[32768 + 5] = float("nan")
    return x


def check_pod_kernels(dev, err: dict) -> None:
    """B6 against its plain version on the card at POD_SIZES for float32,
    float16, bfloat16 and int32 (and once from an unaligned start), and B1
    on bfloat16 and float16 with x shared by a leading pod dimension (3
    pods; 4 at the lm-100m FF leaf), bit for bit."""
    import torch

    from repro_torch.kernels import ref, significance, wire_pack

    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    for n in POD_SIZES:
        x = _pod_values(n, gen, dev)
        cases = [x, x.half(), x.bfloat16(), (x.nan_to_num(0.0) * 1000).int()]
        if n > 1:  # unaligned starts: the kernel's element-wise path
            cases += [x[1:], cases[2][1:]]
        for t in cases:
            got, want = wire_pack.wire_nnz(t), ref.wire_nnz_ref(t)
            require(got.dtype == torch.int32 and int(got) == int(want),
                    f"wire_nnz differs at n={t.numel()} {t.dtype}: "
                    f"{int(got)} != {int(want)}")
            err["wire_nnz"] = max(err["wire_nnz"],
                                  float(abs(int(got) - int(want))))
        del x, cases
    for n in SIZES + (POD_FF_LEAF // 4,):
        pods = 4 if n == POD_FF_LEAF // 4 else 3
        for dt in (torch.bfloat16, torch.float16):
            u = (torch.randn(pods, n, generator=gen, device=dev) * 0.01)
            x = torch.randn(n, generator=gen, device=dev)
            r = (torch.randn(pods, n, generator=gen, device=dev) * 0.01)
            u[:, ::5] = -0.0
            x[::7] = 0.0
            x[: min(n, 256)] = 0.0
            r[:, : min(n, 256)] = -0.0
            u, x, r = u.to(dt), x.to(dt), r.to(dt)
            got = significance.significance_filter(u, x, r, 0.5)
            want = ref.significance_ref(u, x, r, 0.5)
            for g, w in zip(got, want):
                require(_same(g, w), f"significance_filter differs at "
                        f"pods={pods} n={n} {dt}")
                err["significance_filter"] = max(
                    err["significance_filter"], _abs_err(g, w))
            del u, x, r, got, want
    torch.cuda.synchronize(dev)
    log("kernel-check", kernel="wire_nnz", max_abs_err=err["wire_nnz"],
        sizes=",".join(map(str, POD_SIZES)),
        dtypes="float32,float16,bfloat16,int32")
    log("kernel-check", kernel="significance_filter", pods="3,4",
        dtypes="bfloat16,float16", max_abs_err=err["significance_filter"],
        sizes=",".join(map(str, SIZES + (POD_FF_LEAF // 4,))))


def check_reintegration(dev) -> None:
    """The eviction pull ``x + (l - x) / P_old`` on card tensors, with the
    divisor as the FaaS worker passes it (a 0-d float32 device tensor) and
    as a Python int, against numpy's float32 division: bit for bit."""
    import numpy as np
    import torch

    from repro_torch.dist.elastic import reintegrate_into

    rng = np.random.default_rng(5)
    own = rng.standard_normal(1 << 20).astype(np.float32)
    leaving = rng.standard_normal(1 << 20).astype(np.float32)
    for p_old in (3, 5, 7):
        want = own + (leaving - own) / np.float32(p_old)
        pool = torch.full((), float(p_old), dtype=torch.float32, device=dev)
        for divisor in (pool, p_old):
            got = reintegrate_into(torch.from_numpy(own).to(dev),
                                   torch.from_numpy(leaving).to(dev),
                                   divisor).cpu().numpy()
            require(got.tobytes() == want.tobytes(),
                    f"reintegrate_into at P_old={p_old} differs from numpy")
        log("reintegration", p_old=p_old, n=own.size, bit_exact=True)


def check_attention_grads(dev) -> float:
    """One lm-100m attention block (bf16, B 4, S 256; projections, RoPE,
    B7, output projection) on the card: the loss's gradients with respect
    to x, wq, wk, wv and wo through FlashAttention, against the same block
    with plain autograd through ``ref.mha_ref``, within 2e-2; every input
    must get a finite, nonzero gradient and B7 must launch once."""
    import torch

    from repro_torch.kernels import build, ref
    from repro_torch.launch.train import LM_100M
    from repro_torch.models import attention

    cfg, spec = LM_100M, LM_100M.groups[0][0][0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    d = cfg.d_model
    x = _randn((4, 256, d), gen, dev, torch.bfloat16)
    p = {k: _randn((d, d), gen, dev, torch.bfloat16, d ** -0.5)
         for k in ("wq", "wk", "wv", "wo")}
    go = _randn((4, 256, d), gen, dev, torch.bfloat16)
    inputs = [x] + [p[k] for k in ("wq", "wk", "wv", "wo")]

    def grads(plain: bool):
        leaves = [t.detach().requires_grad_() for t in inputs]
        params = dict(zip(("wq", "wk", "wv", "wo"), leaves[1:]))
        kernel = attention.ops.flash_attention
        if plain:
            attention.ops.flash_attention = (
                lambda q, k, v, causal=True, **kw: ref.mha_ref(q, k, v,
                                                               causal=causal))
        try:
            out, _ = attention.attn_apply(cfg, spec, params, leaves[0])
        finally:
            attention.ops.flash_attention = kernel
        return torch.autograd.grad(out, leaves, go)

    build.reset_launches()
    got = grads(plain=False)
    require(build.LAUNCHES["flash_attention"] == 1,
            "attention block: B7 did not launch")
    want = grads(plain=True)
    torch.cuda.synchronize(dev)
    worst = 0.0
    tol = FLASH_TOL["bfloat16"]
    for name, g, w in zip(("x", "wq", "wk", "wv", "wo"), got, want):
        require(bool(torch.isfinite(g).all()) and bool((g != 0).any()),
                f"attention block: no gradient for {name}")
        # bf16 products summed over 1,024 tokens cancel: the error is held
        # to the gradient's scale, not entry by entry
        err = float((g.float() - w.float()).abs().max())
        scale = float(w.float().abs().max())
        require(err <= tol * scale, f"attention block gradient of {name}: "
                f"off by {err} at scale {scale} (tolerance {tol} x scale)")
        log("kernel-check", kernel="flash_attention", what="lm-100m "
            "attention block gradient through FlashAttention vs plain "
            "autograd", input=name, max_abs_err=err, scale=scale,
            tolerance=f"{tol} x scale")
        worst = max(worst, err / scale)
    return worst


# -- phases 4 and 5: the main paths -------------------------------------------


def _train_cmd(run_dir: str, job: dict, *, workers: int, steps: int,
               inv_steps: int, scheme: str, impl: str = "cuda",
               n_brokers: int = 1, device: str = "cuda",
               transport: str = "tcp", consistency: str = "isp",
               slack: int = 3, checkpoint_every: int = 100,
               chaos: str = None, prewarm: bool = False,
               hostperf: bool = False, retunes: tuple = (),
               topology_tune: bool = False, jobs: str = None,
               pool_budget: int = None) -> list:
    """The CLI a user runs (``jobs``: a fleet's jobs file, whose fields
    override the flags)."""
    out = os.path.join(run_dir, "result.json")
    return [sys.executable, "-m", "repro_torch.launch.train",
            "--runtime", "faas", "--workload", job["workload"],
            "--workload-cfg", json.dumps(job["wcfg"]),
            "--workers", str(workers), "--steps", str(steps),
            "--invocation-steps", str(inv_steps),
            "--optimizer", job["optimizer"], "--lr", str(job["lr"]),
            "--wire-scheme", scheme, "--wire-impl", impl,
            "--n-brokers", str(n_brokers), "--device", device,
            "--transport", transport, "--consistency", consistency,
            "--slack", str(slack),
            "--checkpoint-every", str(checkpoint_every),
            "--run-dir", run_dir, "--out", out,
            *(["--chaos", chaos] if chaos else []),
            *(["--prewarm"] if prewarm else []),
            *(["--hostperf"] if hostperf else []),
            *[a for r in retunes for a in ("--retune", r)],
            *(["--topology-tune"] if topology_tune else []),
            *(["--jobs", jobs] if jobs else []),
            *(["--pool-budget", str(pool_budget)] if pool_budget else [])]


def run_trains(jobs: list, timeout_s: float = 300.0,
               stagger_s: float = 0.0, max_parallel: int = 0) -> list:
    """Run training jobs ``(run_dir, job, kwargs)`` side by side through
    the CLI, starting one every ``stagger_s`` seconds and at most
    ``max_parallel`` at once (0: all; a host that starts too many at once
    can keep a broker from listening within its spawn time); returns
    their result dicts. Every process group started here is killed if the
    time limit passes."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    cap = max_parallel or len(jobs)
    deadline = time.monotonic() + timeout_s
    procs = []
    try:
        for i, (run_dir, job, kw) in enumerate(jobs):
            while sum(p.poll() is None for p in procs) >= cap:
                if time.monotonic() > deadline:
                    raise subprocess.TimeoutExpired("train runs", timeout_s)
                time.sleep(0.2)
            if i and stagger_s:
                time.sleep(stagger_s)
            os.makedirs(run_dir, exist_ok=True)
            with open(os.path.join(run_dir, "stderr.log"), "wb") as err:
                procs.append(subprocess.Popen(
                    _train_cmd(run_dir, job, **kw), env=env,
                    stdout=subprocess.DEVNULL, stderr=err,
                    start_new_session=True))
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"train runs timed out after {timeout_s}s")
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    results = []
    for p, (run_dir, _, _) in zip(procs, jobs):
        if p.returncode != 0:
            with open(os.path.join(run_dir, "stderr.log"), "rb") as f:
                tail = f.read().decode(errors="replace")[-4000:]
            raise SmokeFailure(f"train run {run_dir} failed "
                               f"({p.returncode}):\n{tail}")
        with open(os.path.join(run_dir, "result.json")) as f:
            results.append(json.load(f))
    return results


def steady(res: dict, inv_steps: int) -> dict:
    """Step and phase means over the steps that do not start an invocation
    (those pay the worker's cold start: process, torch import, CUDA
    context, first launches)."""
    rows = [r for r in res["history"] if (r["step"] - 1) % inv_steps]
    phases = {k: sum(r["phase"][k] for r in rows) / len(rows)
              for k in rows[0]["phase"]}
    return {"step_s": sum(r["dur_s"] for r in rows) / len(rows),
            "phase_s": phases, "steps": [r["step"] for r in rows]}


def _job_cfg(run_dir: str, job: dict, device: str = "cuda"):
    from repro_torch.runtime.supervisor import FaaSJobConfig

    return FaaSJobConfig(run_dir=run_dir, workload=job["workload"],
                         workload_cfg=job["wcfg"], device=device,
                         optimizer=job["optimizer"], lr=job["lr"])


def digest(run_dir: str, job: dict) -> str:
    from repro_torch.runtime.supervisor import final_params_digest

    return final_params_digest(_job_cfg(run_dir, job))


def final_params(run_dir: str, job: dict, device: str):
    from repro_torch.runtime.supervisor import final_params

    return final_params(_job_cfg(run_dir, job, device))[0]


# (label, job, scheme, the kernels every worker must launch, CLI options);
# B1 must not run on an Adam leg: there B2 takes the optimizer and the
# filter. The SSP leg delivers frontiers 1..6 at steps 5..10 and 7..10 in
# its drain, so each worker makes as many B5 launches as under ISP
PMF_LAUNCHES = {"significance_filter": 20, "wire_pack": 20,
                "wire_unpack_add": 60}
SSP = {"consistency": "ssp", "slack": 3}
SHM = {"transport": "shm"}
# a leg that tests no invocation boundary runs its 10 steps in one
# invocation: each invocation costs its 4 workers a cold start. The
# invariant runs take the B2 jobs across a boundary
ONE = {"inv_steps": 10}
LEGS = (
    ("pmf_bitmap", PMF, "bitmap",
     ("significance_filter", "wire_pack", "wire_unpack_add"), {}),
    ("pmf_auto", PMF, "auto", ("significance_filter", "wire_pack"), ONE),
    ("lr_bitmap", LR, "bitmap",
     ("adam_sig_update", "wire_pack", "wire_unpack_add"), ONE),
    ("lr_auto", LR, "auto", ("adam_sig_update", "wire_pack"), ONE),
    ("pmf_adam_bitmap", PMF_ADAM, "bitmap",
     ("adam_sig_update", "wire_pack", "wire_unpack_add"), ONE),
    ("pmf_ssp_bitmap", PMF, "bitmap", tuple(PMF_LAUNCHES), dict(SSP, **ONE)),
    ("pmf_bitmap_shm", PMF, "bitmap", tuple(PMF_LAUNCHES), dict(SHM, **ONE)),
)
# the legs whose launch counts are exact, worker by worker
EXACT = {"pmf_bitmap": PMF_LAUNCHES, "pmf_ssp_bitmap": PMF_LAUNCHES,
         "pmf_bitmap_shm": PMF_LAUNCHES}


def _leg_opts(**kw) -> dict:
    """A leg's run: 4 workers, 10 steps, 5 an invocation, bitmap, unless
    ``kw`` says otherwise."""
    return dict(dict(workers=4, steps=10, inv_steps=5, scheme="bitmap"),
                **kw)


def startup_split(run_dir: str, job: str = None) -> dict:
    """Mean seconds of each part of the workers' cold starts in a run (the
    ``startup`` line each worker invocation prints to its log: import,
    hello, workload with the CUDA context, a successor's warm-up and gate
    wait, restore), with the invocations counted; in a fleet's run, the
    lines of ``job``'s threads (``startup:<job>``)."""
    rows = []
    logdir = os.path.join(run_dir, "logs")
    tag = "startup " if job is None else f"startup:{job} "
    for name in os.listdir(logdir):
        if name.startswith("w"):
            with open(os.path.join(logdir, name)) as f:
                rows += [json.loads(line[len(tag):]) for line in f
                         if line.startswith(tag)]
    parts = {k for r in rows for k in r}
    return {"invocations": len(rows), **{
        k: round(sum(r[k] for r in rows if k in r)
                 / sum(1 for r in rows if k in r), 3) for k in sorted(parts)}}


def left_in_dev_shm(res: dict) -> list:
    """The job's shared-memory segments still in /dev/shm (none may be)."""
    return [n for n in os.listdir("/dev/shm")
            if n.startswith(res["shm_token"])]


def _leg_dir(tmp: str, label: str) -> str:
    return os.path.join(tmp, f"main_{label}")


def _check_leg(leg: tuple, d: str, res: dict) -> None:
    """One main-path leg's checks and its ``[main-path]`` line."""
    label, job, scheme, must, kw = leg
    opts = _leg_opts(scheme=scheme, **kw)
    launches = res["kernel_launches_by_worker"]
    require(res["steps"] == 10 and res["final_pool"] == 4,
            f"{label}: steps={res['steps']} pool={res['final_pool']}")
    require(res["dup_mismatches"] == 0, f"{label}: dup mismatches")
    require(sorted(launches) == ["0", "1", "2", "3"],
            f"{label}: launch telemetry from workers {sorted(launches)}")
    for w, counts in launches.items():
        for name in must:
            require(counts.get(name, 0) > 0,
                    f"{label}: {name} launched 0 times on worker {w}")
        if job["optimizer"] == "adam":
            require(counts.get("significance_filter", 0) == 0,
                    f"{label}: B1 launched on worker {w} of an Adam leg")
        if label in EXACT:
            got = {k: counts.get(k, 0) for k in EXACT[label]}
            require(got == EXACT[label],
                    f"{label}: worker {w} launched {got}, not "
                    f"{EXACT[label]}")
    require(left_in_dev_shm(res) == [],
            f"{label}: segments left in /dev/shm")
    sent = [r["sent_fraction"] for r in res["history"]]
    require(sum(sent) > 0, f"{label}: nothing was sent")
    require(res["final_eval"] is not None
            and math.isfinite(res["final_eval"]),
            f"{label}: final eval {res['final_eval']}")
    log("main-path", leg=label, workload=job["workload"],
        optimizer=job["optimizer"], scheme=scheme, impl="cuda",
        consistency=res["consistency"], slack=res["slack"],
        transport=res["transport"], steps=res["steps"],
        final_loss=res["final_loss"], final_eval=res["final_eval"],
        wire_bytes_total=res["wire_bytes_total"],
        step_s_mean=res["measured_step_s"], wall_s=res["wall_s"],
        worker_seconds=res["bill"]["worker_seconds"],
        n_invocations=res["n_invocations"],
        sent_fraction_mean=sum(sent) / len(sent),
        phase_s_mean=json.dumps(res["phase_s_mean"]),
        steady=json.dumps(steady(res, opts["inv_steps"])),
        startup=json.dumps(startup_split(d)),
        launches=json.dumps(launches), alone=leg is LEGS[0])


def main_path(tmp: str) -> dict:
    """The PMF-Nesterov bitmap leg, alone on the host: its steady step is
    the main path's step time (the step profile's busy share reads it),
    and the pre-warmed rerun's and the chaos leg's walls read beside its
    wall. The other legs run in the invariant pool (``main_leg_jobs``,
    ``check_main_legs``): they are checked for launches and bits, not
    timed."""
    leg = LEGS[0]
    label, job, scheme, _, kw = leg
    d = _leg_dir(tmp, label)
    res, = run_trains([(d, job, _leg_opts(scheme=scheme, **kw))])
    _check_leg(leg, d, res)
    return {label: (d, res)}


def main_leg_jobs(tmp: str) -> list:
    """The other main-path legs, as ``run_trains`` jobs."""
    return [(_leg_dir(tmp, label), job, _leg_opts(scheme=scheme, **kw))
            for label, job, scheme, _, kw in LEGS[1:]]


def check_main_legs(tmp: str, runs: dict, results: dict) -> None:
    """Check the pooled legs (``results`` by run directory), add them to
    ``runs``, then hold SSP against ISP and shm against tcp."""
    for leg in LEGS[1:]:
        d = _leg_dir(tmp, leg[0])
        _check_leg(leg, d, results[d])
        runs[leg[0]] = (d, results[d])
    # SSP is not quietly ISP; shm is tcp bit for bit
    d0, res0 = runs["pmf_bitmap"]
    dig0 = digest(d0, PMF)
    dig_ssp = digest(runs["pmf_ssp_bitmap"][0], PMF)
    dig_shm = digest(runs["pmf_bitmap_shm"][0], PMF)
    shm_res = runs["pmf_bitmap_shm"][1]
    same_bytes = [r["wire_bytes"] for r in shm_res["history"]] == [
        r["wire_bytes"] for r in res0["history"]]
    log("main-path", check="pmf_ssp_bitmap against pmf_bitmap",
        digest_differs=dig_ssp != dig0,
        final_ckpt_step=runs["pmf_ssp_bitmap"][1]["final_ckpt_step"])
    log("main-path", check="pmf_bitmap_shm against pmf_bitmap",
        digest_equal=dig_shm == dig0, wire_bytes_equal=same_bytes,
        steady_wire_s_shm=steady(shm_res, 10)["phase_s"]["wire"],
        steady_wire_s_tcp=steady(res0, 5)["phase_s"]["wire"])
    require(dig_ssp != dig0, "pmf_ssp_bitmap: the digest of ISP's")
    require(runs["pmf_ssp_bitmap"][1]["final_ckpt_step"] == 11,
            "pmf_ssp_bitmap: no sentinel checkpoint after the drain")
    require(dig_shm == dig0, "pmf_bitmap_shm: digest differs from tcp")
    require(same_bytes, "pmf_bitmap_shm: per-step wire bytes differ")


# Fig. 9's live half (benchmarks/fig9_ssp_vs_isp.py:57-59) at ML-10M width:
# worker 0 hiccups 0.5 s every 12 steps, once under ISP and once under SSP
DUEL_STEPS = 24
# the straggler: worker 0 sleeps 0.5 s after its compute at steps 12 and 24
DUEL_STRAGGLER = {"kind": "compute_delay", "step": 0, "worker": 0,
                  "delay_s": 0.5, "every": 12}


def _nonstraggler_steps(history: list) -> list:
    """(step, seconds) of every other worker's step > 1 (fig9's
    ``_nonstraggler_p95`` takes its p95): the straggler's own steps carry
    its sleep under both models, and step 1 the cold start."""
    return [(row["step"], d) for row in history if row["step"] > 1
            for w, d in row["dur_s_by_worker"].items()
            if int(w) != DUEL_STRAGGLER["worker"]]


def straggler_duel(tmp: str) -> dict:
    """The straggler duel: 4 workers, 24 steps in one invocation, bitmap,
    under ``isp`` and under ``ssp --slack 3``, one after the other. Logs
    the non-straggler p95 step time of each and their ratio, and counts
    the waits directly: the non-straggler worker-steps longer than half
    the delay, their steps and their seconds. Requires only that both
    finish with no dup mismatch (the numbers are findings)."""
    import numpy as np

    p95 = {}
    for consistency in ("isp", "ssp"):
        d = os.path.join(tmp, f"duel_{consistency}")
        res, = run_trains([(d, PMF, dict(
            workers=4, steps=DUEL_STEPS, inv_steps=DUEL_STEPS,
            scheme="bitmap", consistency=consistency, slack=3,
            chaos=f"0:{json.dumps([DUEL_STRAGGLER])}"))])
        require(res["steps"] == DUEL_STEPS and res["final_pool"] == 4,
                f"duel {consistency}: steps={res['steps']}")
        require(res["dup_mismatches"] == 0,
                f"duel {consistency}: dup mismatches")
        steps = _nonstraggler_steps(res["history"])
        p95[consistency] = float(np.percentile([x for _, x in steps], 95))
        waits = [(t, x) for t, x in steps
                 if x > DUEL_STRAGGLER["delay_s"] / 2]
        log("duel", consistency=consistency, slack=res["slack"],
            straggler=json.dumps(DUEL_STRAGGLER),
            nonstraggler_step_s_p95=p95[consistency],
            nonstraggler_samples=len(steps), waits=len(waits),
            wait_steps=json.dumps(sorted(t for t, _ in waits)),
            wait_s=sum(x for _, x in waits),
            nonstraggler_step_s_sum=sum(x for _, x in steps),
            step_s_mean=res["measured_step_s"], wall_s=res["wall_s"],
            final_eval=res["final_eval"], final_loss=res["final_loss"],
            wire_bytes_total=res["wire_bytes_total"])
    log("duel", nonstraggler_p95_isp_over_ssp=p95["isp"] / p95["ssp"])
    return p95


# the chaos leg: the PMF main path at ML-10M width under one event of each
# of the nine kinds, each at step 5 or earlier and the supervisor's own
# death at a step of its own; wal_corrupt's rollback respawns the pool in
# the wave of worker 1's kill, and ckpt_enospc fails a save of that wave.
# Worker 3 straggles by CHAOS_DELAY_S at every step from 5 on, and the
# barrier holds the pool with it: the steps after the supervisor's death
# (7 to 10, about 4 x 5 s) outlast its restart (8-12 s on the card's
# host), so the successor finds all four workers alive and adopts them
CHAOS_SEED = 24
CHAOS_DELAY_S = 5.0
CHAOS_PLAN = (
    {"kind": "compute_delay", "step": 5, "worker": 3,
     "delay_s": CHAOS_DELAY_S, "every": 1},
    {"kind": "transport_stall", "step": 3, "worker": 0, "delay_s": 0.3},
    {"kind": "transport_delay", "step": 3, "worker": 2, "delay_s": 0.2},
    {"kind": "worker_kill", "step": 4, "worker": 1},
    {"kind": "wal_corrupt", "step": 4, "shard": 1},
    {"kind": "ckpt_enospc", "step": 4, "worker": 0},
    {"kind": "transport_reset", "step": 5, "worker": 2},
    {"kind": "broker_kill", "step": 5, "shard": 0},
    {"kind": "supervisor_kill", "step": 6},
)


def _job_processes(run_dir: str) -> list:
    """(pid, command) of every live (not zombie) process of a FaaS job
    run in ``run_dir``: its supervisor and brokers name the directory on
    their command lines, its workers one of the brokers' addresses."""
    bdir = os.path.join(run_dir, "broker")
    addrs = []
    for name in os.listdir(bdir):
        if name.endswith(".port"):
            with open(os.path.join(bdir, name)) as f:
                addrs.append(f.read().strip())
    found = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
            with open(f"/proc/{pid}/stat") as f:
                state = f.read().rsplit(")", 1)[-1].split()[0]
        except OSError:
            continue
        words = set(cmd.replace(",", " ").split())
        if ("repro_torch" in cmd and state != "Z"
                and (run_dir + os.sep in cmd
                     or any(a in words for a in addrs))):
            found.append((int(pid), cmd))
    return found


def chaos_leg(tmp: str, runs: dict) -> dict:
    """The chaos leg through the CLI (``--chaos``; the plan holds a
    supervisor_kill, so the CLI drives the supervisor out of process
    through ``run_job_resilient``): PMF-Nesterov bitmap at ML-10M width, 4
    workers, 2 tcp shards, 10 steps in one invocation, a checkpoint every
    2, its workers under ``--hostperf``, alone on the host. Requires every
    step and the full pool with no dup mismatch, every event fired (none
    skipped, each with its recovery), the supervisor restarted and resumed
    with all four live workers and both shards re-adopted by pid, worker 1
    respawned after its SIGKILL (-9),
    B1, B4 and B5 on every worker, the digest of ``pmf_bitmap`` and no
    process of the job left alive."""
    d = os.path.join(tmp, "chaos")
    plan = f"{CHAOS_SEED}:{json.dumps(list(CHAOS_PLAN))}"
    res, = run_trains([(d, PMF, _leg_opts(
        n_brokers=2, inv_steps=10, checkpoint_every=2, chaos=plan,
        hostperf=True))])
    left = _job_processes(d)
    require(res["steps"] == 10 and res["final_pool"] == 4,
            f"chaos: steps={res['steps']} pool={res['final_pool']}")
    require(res["dup_mismatches"] == 0, "chaos: dup mismatches")
    events = res["chaos_events"]
    for e in events:
        log("chaos", event=e["kind"], index=e["index"], step=e["step"],
            worker=e.get("worker"), shard=e.get("shard"),
            at_frontier=e.get("at_frontier"), recovery_s=e.get("recovery_s"),
            skipped=e.get("skipped"),
            quarantined_bytes=e.get("quarantined_bytes"),
            rollback=json.dumps(e.get("rollback")),
            readopted=json.dumps(e.get("readopted")))
    fired = {e["index"] for e in events}
    require(fired == set(range(len(CHAOS_PLAN))),
            f"chaos: events {sorted(set(range(len(CHAOS_PLAN))) - fired)} "
            "never fired")
    for e in events:
        require("skipped" not in e and e.get("recovery_s") is not None,
                f"chaos: {e['kind']} skipped or unrecovered: {e}")
    kill, = [e for e in events if e["kind"] == "supervisor_kill"]
    require(res["supervisor_restarts"] >= 1
            and res["supervisor_resumed"] >= 1
            and kill.get("readopted") == {"workers": 4, "brokers": 2,
                                          "successors_killed": 0},
            "chaos: the supervisor was not restarted and resumed with the "
            f"live pool re-adopted: {kill}")
    require(any(r["worker"] == 1 and r["exit_code"] == -9
                for r in res["respawns"]),
            f"chaos: no respawn of worker 1 at -9: {res['respawns']}")
    launches = res["kernel_launches_by_worker"]
    require(sorted(launches) == ["0", "1", "2", "3"],
            f"chaos: launch telemetry from workers {sorted(launches)}")
    for w, counts in launches.items():
        for name in PMF_LAUNCHES:
            require(counts.get(name, 0) > 0,
                    f"chaos: {name} launched 0 times on worker {w}")
    dig, dig0 = digest(d, PMF), digest(runs["pmf_bitmap"][0], PMF)
    rollback, = [e["rollback"] for e in events if e["kind"] == "wal_corrupt"]
    log("chaos", leg="pmf_bitmap under the plan",
        digest_equal=dig == dig0, wall_s=res["wall_s"],
        wall_s_pmf_bitmap=runs["pmf_bitmap"][1]["wall_s"],
        wal_quarantined_bytes=res["wal_quarantined_bytes"],
        rollback=json.dumps(rollback),
        respawns=json.dumps(res["respawns"]),
        broker_respawns=json.dumps(res["broker_respawns"]),
        supervisor_restarts=res["supervisor_restarts"],
        hostperf=json.dumps(res["hostperf"]),
        n_invocations=res["n_invocations"],
        worker_seconds=res["bill"]["worker_seconds"],
        startup=json.dumps(startup_split(d)),
        launches=json.dumps(launches), processes_left=len(left))
    require(res["hostperf"] is not None
            and res["hostperf"]["xla_flags"] is None,
            f"chaos: hostperf {res['hostperf']}")
    require(dig == dig0, "chaos: digest differs from pmf_bitmap's")
    require(not left, f"chaos: processes of the job still alive: {left}")
    return res


# live topology (DESIGN.md §16), PMF-Nesterov bitmap at ML-10M width, 4
# workers, one tcp shard at the start, one invocation. The retune leg
# re-shards to 2 shm shards at step 3 and back to one tcp shard at 7;
# worker 0 sleeps 0.25 s a step (timing only; the barrier paces the pool)
# so the supervisor mints each fence with steps left: at 0.03 s a step the
# job would end before the first. The tuning leg runs the online co-tuner
# over its three cells, unpaced, over enough steps for three handovers
RETUNES = ('3:{"n_brokers": 2, "transport": "shm"}',
           '7:{"n_brokers": 1, "transport": "tcp"}')
RETUNE_PACE = ('0:[{"kind": "compute_delay", "step": 0, "worker": 0, '
               '"delay_s": 0.25, "every": 1}]')
TUNE_STEPS = 48


def topology_chunks() -> list:
    """The chunks ``sharding.tree_subleaves`` cuts a PMF job's leaves into
    at ML-10M width when the CLI chunks them for retunes and tuning (at
    the size ``launch.train._topology_args`` picks): one
    ``(leaf, subkey, offset, n)`` each."""
    import types

    import torch

    from repro_torch.launch.train import _topology_args
    from repro_torch.runtime import sharding

    split = _topology_args(types.SimpleNamespace(
        retune=[RETUNES[0]], topology_tune=False,
        shard_split_bytes=0))["shard_split_bytes"]
    template = {"U": torch.empty((10681, 20), device="meta"),
                "M": torch.empty((20, 71567), device="meta")}
    return sharding.tree_subleaves(template, split)


def topology_chunk_sizes() -> tuple:
    """The distinct chunk lengths of ``topology_chunks``, the shapes B4 and
    B5 see on the topology legs (a full chunk and each leaf's tail)."""
    return tuple(sorted({n for _, _, _, n in topology_chunks()}))


def topology_launches(steps: int, workers: int = 4) -> tuple:
    """The launches each worker of a PMF-Nesterov bitmap job at ML-10M
    width makes on ``topology_chunks``, derived from the code: one B4 a
    chunk a step, one B5 a chunk a peer a step and one B1 a leaf a step.
    Returns (counts, chunks)."""
    chunks = topology_chunks()
    n, leaves = len(chunks), len({leaf for leaf, _, _, _ in chunks})
    return {"significance_filter": leaves * steps, "wire_pack": n * steps,
            "wire_unpack_add": (workers - 1) * n * steps}, n


def check_topology_run(label: str, d: str, res: dict, steps: int) -> None:
    """What both topology legs must show: every step with the full pool
    and no dup mismatch (the retired shards' counted), no refused retune,
    every handover completed at frontier fence - 1, no segment left in
    /dev/shm, and on every worker exactly the launches
    ``topology_launches`` derives. Logs each handover (its fence, the
    subkeys it moved, its seconds) and the launches a step."""
    want, chunks = topology_launches(steps)
    for e in res["topology_events"]:
        log("topology", leg=label, gen=e["gen"], fence=e["fence"],
            changes=json.dumps(e["changes"]), at_frontier=e["at_frontier"],
            moved_subkeys=e.get("moved_subkeys"),
            total_subkeys=e.get("total_subkeys"), noop=e.get("noop"),
            refused=e.get("refused"), handover_s=e.get("handover_s"),
            migrate_s=e.get("migrate_s"))
    launches = res["kernel_launches_by_worker"]
    log("topology", leg=label, steps=res["steps"], chunks=chunks,
        final_topology=json.dumps(res["topology"]),
        topology_gen=res["topology_gen"], n_redis=res["bill"]["n_redis"],
        dup_mismatches=res["dup_mismatches"], wall_s=res["wall_s"],
        n_invocations=res["n_invocations"],
        broker_respawns=len(res["broker_respawns"]),
        respawns=len(res["respawns"]),
        step_s_mean=res["measured_step_s"],
        phase_s_mean=json.dumps(res["phase_s_mean"]),
        launches_per_step=json.dumps({
            w: {k: v / res["steps"] for k, v in c.items()}
            for w, c in launches.items()}),
        startup=json.dumps(startup_split(d)))
    require(res["steps"] == steps and res["final_pool"] == 4,
            f"{label}: steps={res['steps']} pool={res['final_pool']}")
    require(res["dup_mismatches"] == 0, f"{label}: dup mismatches")
    require(not any("refused" in e for e in res["topology_events"]),
            f"{label}: a retune was refused: {res['topology_events']}")
    # every worker parked with step fence-1 done and none past it: no
    # worker had begun the fence's step when the coordinator minted it
    require(all(e["at_frontier"] == e["fence"] - 1
                for e in res["topology_events"] if e["fence"] is not None),
            f"{label}: a handover's frontier is not its fence - 1: "
            f"{res['topology_events']}")
    require(sorted(launches) == ["0", "1", "2", "3"],
            f"{label}: launch telemetry from workers {sorted(launches)}")
    for w, counts in launches.items():
        got = {k: counts.get(k, 0) for k in want}
        require(got == want, f"{label}: worker {w} launched {got}, not "
                f"{want} ({chunks} chunks)")
    require(left_in_dev_shm(res) == [],
            f"{label}: segments left in /dev/shm")


def topology_tune_leg(tmp: str) -> tuple:
    """The online co-tuner alone (its cells' p50s are what it measures):
    ``--topology-tune``, 48 steps in one invocation, unpaced. It must
    explore all three cells (the start, 2 shards, shm), each for at least
    ``topo_explore_steps`` steady steps, commit with nothing abandoned and
    end on the chosen cell, besides ``check_topology_run``. Logs each
    cell's p50, p95, phase p50s and its first steps' seconds (the tuner
    drops ``warmup_steps`` of them). Its digest is checked against a
    fixed-topology run in the invariant pool."""
    from repro_torch.core.autotuner import TopologyTunerConfig
    from repro_torch.runtime.supervisor import FaaSJobConfig

    d = os.path.join(tmp, "topology_tune")
    res, = run_trains([(d, PMF, _leg_opts(
        steps=TUNE_STEPS, inv_steps=TUNE_STEPS, topology_tune=True))])
    check_topology_run("pmf_topology_tune", d, res, TUNE_STEPS)
    tuner = res["topology_tuner"]
    explore = FaaSJobConfig.__dataclass_fields__["topo_explore_steps"].default
    warmup = TopologyTunerConfig().warmup_steps
    starts = [1] + [e["fence"] for e in res["topology_events"]
                    if e.get("fence") is not None]
    for i, c in enumerate(tuner["cells"]):
        # the cell's first steps (cell i starts at the i-th fence)
        lo = starts[i] if i < len(starts) else TUNE_STEPS + 1
        hi = starts[i + 1] if i + 1 < len(starts) else TUNE_STEPS + 1
        durs = [round(r["dur_s"], 5) for r in res["history"]
                if lo <= r["step"] < hi]
        log("topology", leg="pmf_topology_tune", cell=i,
            n_brokers=c["cell"]["n_brokers"],
            transport=c["cell"]["transport"], n_steps=c["n_steps"],
            p50=c["p50"], p95=c["p95"], phase_p50=json.dumps(c["phase_p50"]),
            explored_steps=f"{lo}-{hi - 1}", explored_step_s=json.dumps(durs),
            warmup_steps=warmup)
    if len(starts) > 3:  # the commit moved the job back to an earlier cell
        log("topology", leg="pmf_topology_tune", after_commit_from=starts[3],
            step_s=json.dumps([round(r["dur_s"], 5) for r in res["history"]
                               if r["step"] >= starts[3]]))
    log("topology", leg="pmf_topology_tune", chosen=tuner["chosen"],
        chosen_cell=json.dumps(tuner["chosen_cell"]),
        committed=tuner["committed"], abandoned=tuner["abandoned"])
    require(len(tuner["cells"]) == 3
            and all(c["n_steps"] >= explore for c in tuner["cells"]),
            f"pmf_topology_tune: cells not all explored: {tuner['cells']}")
    require(tuner["committed"] and not tuner["abandoned"],
            f"pmf_topology_tune: no commit: {tuner}")
    require(res["topology"] == tuner["chosen_cell"],
            f"pmf_topology_tune: ended on {res['topology']}, chose "
            f"{tuner['chosen_cell']}")
    return d, res


def check_retune(d: str, res: dict, runs: dict) -> None:
    """The retune leg (run in the invariant pool): the two handovers with
    exactly their changes, none refused or a no-op; one tcp shard at the
    end, generation 2, billed at the peak of 2 shards; no crash respawn
    and 3 invocations a worker (the first and one after each handover);
    the digest of ``pmf_bitmap``; besides ``check_topology_run``."""
    check_topology_run("pmf_retune", d, res, 10)
    events = res["topology_events"]
    changes = [json.loads(r.split(":", 1)[1]) for r in RETUNES]
    logs = os.listdir(os.path.join(d, "logs"))
    per_worker = [sum(1 for n in logs if n.startswith(f"w{w:03d}.inv"))
                  for w in range(4)]
    dig, dig0 = digest(d, PMF), digest(runs["pmf_bitmap"][0], PMF)
    log("topology", leg="pmf_retune", against="pmf_bitmap",
        digest_equal=dig == dig0, invocations_by_worker=json.dumps(
            per_worker))
    require([e["changes"] for e in events] == changes
            and not any(e.get("noop") for e in events),
            f"pmf_retune: handovers {events}")
    require(res["topology"]["n_brokers"] == 1
            and res["topology"]["transport"] == "tcp"
            and res["topology_gen"] == 2 and res["bill"]["n_redis"] == 2,
            f"pmf_retune: topology {res['topology']} gen "
            f"{res['topology_gen']} n_redis {res['bill']['n_redis']}")
    require(res["respawns"] == [] and per_worker == [3, 3, 3, 3],
            f"pmf_retune: respawns {res['respawns']}, invocations "
            f"{per_worker}")
    require(dig == dig0, "pmf_retune: digest differs from pmf_bitmap's")


def check_prewarmed(label: str, d: str, res: dict, leg: str,
                    cold: dict) -> None:
    """A pre-warmed run (4 workers, 10 steps, 5 an invocation) against its
    cold leg: exactly one successor promoted on every slot at the one
    boundary, with an overlap >= 0, no cold process spawned for the second
    invocation, and the leg's exact launches where it has them (the
    warm-up's launches are not reported). Logs each slot's readiness at
    promotion and both walls (the warm run's in the invariant pool, the
    cold leg's alone for PMF-Nesterov and in the pool for the others)."""
    overlaps = res["cold_start_overlaps"]
    logs = set(os.listdir(os.path.join(d, "logs")))
    log("prewarm", run=label, against=leg,
        overlap_s=json.dumps([round(o["overlap_s"], 3) for o in overlaps]),
        ready_at_promotion=json.dumps(
            [o["ready_at_promotion"] for o in overlaps]),
        wall_s=res["wall_s"], wall_s_cold=cold["wall_s"],
        worker_seconds=res["bill"]["worker_seconds"],
        worker_seconds_cold=cold["bill"]["worker_seconds"],
        n_invocations=res["n_invocations"],
        startup=json.dumps(startup_split(d)),
        launches=json.dumps(res["kernel_launches_by_worker"]))
    require(sorted(o["worker"] for o in overlaps) == [0, 1, 2, 3]
            and all(o["invocation"] == 1 and o["overlap_s"] >= 0.0
                    for o in overlaps),
            f"{label}: prewarm overlaps {overlaps}")
    cold_spawns = sorted(f"w{w:03d}.inv001.log" for w in range(4)
                         if f"w{w:03d}.inv001.log" in logs)
    require(not cold_spawns and all(f"w{w:03d}.inv001.pre.log" in logs
                                    for w in range(4)),
            f"{label}: a slot spawned its second invocation cold: "
            f"{cold_spawns}")
    if leg in EXACT:
        for w, counts in res["kernel_launches_by_worker"].items():
            got = {k: counts.get(k, 0) for k in EXACT[leg]}
            require(got == EXACT[leg], f"{label}: worker {w} launched "
                    f"{got}, not {EXACT[leg]}")


def check_topology_pool(topo: list, results: dict, runs: dict,
                        tune: tuple) -> dict:
    """The topology runs of the invariant pool: the retune leg
    (``check_retune``) and the tuning leg against its job at a fixed
    topology (digest, per-step wire bytes, no dup mismatch). Logs the
    fixed run's per-step seconds beside the tuning leg's, so that a drift
    with the step count in the tuning leg's cells reads against a job
    with no handover. Returns the retune leg's result."""
    (retune_d, _, _), (fixed_d, _, _) = topo
    retune_res, fixed_res = results[retune_d], results[fixed_d]
    check_retune(retune_d, retune_res, runs)
    tune_d, tune_res = tune
    dig, dig_fixed = digest(tune_d, PMF), digest(fixed_d, PMF)
    same_bytes = [r["wire_bytes"] for r in tune_res["history"]] == [
        r["wire_bytes"] for r in fixed_res["history"]]
    log("invariant", workload="pmf", against="pmf at a fixed topology, "
        f"{TUNE_STEPS} steps", run="pmf_topology_tune",
        digest_equal=dig == dig_fixed, wire_bytes_equal=same_bytes,
        dup_mismatches=fixed_res["dup_mismatches"],
        wall_s=tune_res["wall_s"], wall_s_fixed=fixed_res["wall_s"])
    for label, res in (("pmf_topology_tune", tune_res),
                       ("fixed", fixed_res)):
        log("topology", leg=label, step_s=json.dumps(
            [round(r["dur_s"], 5) for r in res["history"]]),
            decode_s=json.dumps([round(r["phase"]["decode"], 5)
                                 for r in res["history"]]))
    require(dig == dig_fixed, "pmf_topology_tune: digest differs from the "
            "fixed-topology run's")
    require(same_bytes, "pmf_topology_tune: per-step wire bytes differ")
    require(fixed_res["dup_mismatches"] == 0,
            "pmf fixed 48: dup mismatches")
    return retune_res


# the fleet (runtime/scheduler.py): the PMF-Nesterov and LR-Adam bitmap
# legs packed on one pool of 4 slots, each slot's process running one
# thread a job (job id -> the job's FaaSJobConfig fields; the CLI's flags
# give the rest, as for the legs). PMF takes 5 steps an invocation, as its
# leg does; its boundary ends the invocation for the LR thread too
FLEET_JOBS = {
    "pmf": {"workload": "pmf", "workload_cfg": ML10M,
            "optimizer": "nesterov", "lr": 0.08, "invocation_steps": 5},
    "lr": {"workload": "lr", "workload_cfg": CRITEO, "optimizer": "adam",
           "lr": 0.01, "invocation_steps": 10},
}
FLEET_LEGS = {"pmf": ("pmf_bitmap", PMF), "lr": ("lr_bitmap", LR)}
FLEET_MUST = {"pmf": tuple(PMF_LAUNCHES),
              "lr": ("adam_sig_update", "wire_pack", "wire_unpack_add")}
# the budgeted fleet: 8 (worker, job) pairs against 6, so the scheduler
# evicts two fair-share (one from each job)
FLEET_BUDGET = 6


def fleet_runs(tmp: str) -> list:
    """The two fleet runs of the invariant pool, as ``run_trains`` jobs:
    ``fleet_pmf_lr`` (one tcp shard, no budget) and
    ``fleet_pool_budget_shm`` (2 shm shards, pool budget 6)."""
    jobs = os.path.join(tmp, "fleet_jobs.json")
    with open(jobs, "w") as f:
        json.dump({"jobs": FLEET_JOBS}, f)
    return [(os.path.join(tmp, "fleet_pmf_lr"), PMF,
             _leg_opts(jobs=jobs)),
            (os.path.join(tmp, "fleet_pool_budget_shm"), PMF,
             _leg_opts(jobs=jobs, n_brokers=2, transport="shm",
                       pool_budget=FLEET_BUDGET))]


def _fleet_log(label: str, d: str, res: dict) -> None:
    """The ``[fleet]`` line: the pooled bill, its rollup, the invocations,
    each job's launches and cold starts."""
    log("fleet", run=label, wall_s=res["wall_s"],
        n_invocations=res["n_invocations"], n_respawns=res["n_respawns"],
        bill=json.dumps(res["bill"]),
        rollup=json.dumps({j: {k: r[k] for k in ("busy_s", "share",
                                                 "total")}
                           for j, r in res["rollup"]["per_job"].items()}),
        rollup_total=res["rollup"]["total"],
        steps=json.dumps({j: r["steps"] for j, r in res["jobs"].items()}),
        final_pool=json.dumps({j: r["final_pool"]
                               for j, r in res["jobs"].items()}),
        final_eval=json.dumps({j: r["final_eval"]
                               for j, r in res["jobs"].items()}),
        step_s_mean=json.dumps({j: r["measured_step_s"]
                                for j, r in res["jobs"].items()}),
        # each step's mean seconds, mean compute and slowest worker: a
        # job's invocations end where PMF's boundary caught it, and a
        # respawned job's first compute (its kernels' loads) holds the
        # lock its sibling waits on
        steps_s=json.dumps({j: [
            [row["step"], round(row["dur_s"], 5),
             round(row["phase"]["compute"], 5),
             round(max(row["dur_s_by_worker"].values()), 5)]
            for row in r["history"]] for j, r in res["jobs"].items()}),
        scale_events=json.dumps({j: r["scale_events"]
                                 for j, r in res["jobs"].items()}),
        launches=json.dumps({j: r["kernel_launches_by_worker"]
                             for j, r in res["jobs"].items()}),
        startup=json.dumps({j: startup_split(d, j) for j in res["jobs"]}),
        dup_mismatches=res["dup_mismatches"],
        shm_left=len(left_in_dev_shm(res)))


def check_fleet(fleet: list, results: dict, runs: dict) -> dict:
    """The fleet runs of the invariant pool. ``fleet_pmf_lr``: each job's
    digest is its solo leg's, every PMF worker launches exactly
    ``PMF_LAUNCHES`` for its job and every LR worker B2, B4 and B5 and no
    B1, the rollup's per-job totals sum to the pooled total.
    ``fleet_pool_budget_shm``: at least two fair-share evictions, both jobs
    at step 10 with a survivor, every worker's launches of its job's
    kernels (evictions depend on timing: no digest). Both: no dup
    mismatch, nothing left in /dev/shm. Returns both results."""
    out = {}
    for d, _, kw in fleet:
        label = os.path.basename(d)
        res = results[d]
        _fleet_log(label, d, res)
        require(res["dup_mismatches"] == 0, f"{label}: dup mismatches")
        require(left_in_dev_shm(res) == [],
                f"{label}: segments left in /dev/shm")
        total = sum(r["total"] for r in res["rollup"]["per_job"].values())
        require(math.isclose(total, res["rollup"]["total"], rel_tol=1e-12)
                and res["rollup"]["total"] == res["bill"]["total"],
                f"{label}: the rollup's jobs sum to {total}, not the pooled "
                f"{res['rollup']['total']}")
        require(sorted(res["jobs"]) == sorted(FLEET_JOBS),
                f"{label}: jobs {sorted(res['jobs'])}")
        for jid, job in res["jobs"].items():
            launches = job["kernel_launches_by_worker"]
            require(job["steps"] == 10, f"{label} {jid}: steps "
                    f"{job['steps']}")
            require(sorted(launches) == ["0", "1", "2", "3"],
                    f"{label} {jid}: launch telemetry from workers "
                    f"{sorted(launches)}")
            for w, counts in launches.items():
                for name in FLEET_MUST[jid]:
                    require(counts.get(name, 0) > 0, f"{label} {jid}: "
                            f"{name} launched 0 times on worker {w}")
                if jid == "lr":
                    require(counts.get("significance_filter", 0) == 0,
                            f"{label}: B1 counted for the LR job on "
                            f"worker {w}")
            require(job["final_eval"] is not None
                    and math.isfinite(job["final_eval"]),
                    f"{label} {jid}: final eval {job['final_eval']}")
        if kw.get("pool_budget"):
            fair = [e for j in res["jobs"].values()
                    for e in j["scale_events"] if e["reason"] == "fair-share"]
            require(len(fair) >= 2, f"{label}: {len(fair)} fair-share "
                    "evictions")
            for jid, job in res["jobs"].items():
                require(job["final_pool"] >= 1,
                        f"{label} {jid}: final pool {job['final_pool']}")
        else:
            for jid, job in res["jobs"].items():
                leg, spec = FLEET_LEGS[jid]
                dig = digest(os.path.join(d, "jobs", jid), spec)
                dig_solo = digest(runs[leg][0], spec)
                log("invariant", workload=jid, against=leg, run=label,
                    digest_equal=dig == dig_solo,
                    final_pool=job["final_pool"])
                require(dig == dig_solo, f"{label} {jid}: digest differs "
                        f"from {leg}")
                require(job["final_pool"] == 4,
                        f"{label} {jid}: final pool {job['final_pool']}")
            for w, counts in res["jobs"]["pmf"][
                    "kernel_launches_by_worker"].items():
                got = {k: counts.get(k, 0) for k in PMF_LAUNCHES}
                require(got == PMF_LAUNCHES, f"{label}: PMF worker {w} "
                        f"launched {got}, not {PMF_LAUNCHES}")
        out[label] = res
    return out


def invariants(tmp: str, runs: dict, tune: tuple, beside) -> tuple:
    """The invariant pool, with the main-path legs after the first
    (``main_leg_jobs``) at its end; ``beside()`` runs in this thread while
    the pool runs (work on the card that is checked, not timed). Returns
    the retune leg's result, the fleet runs' (their launches join the
    kernels line) and what ``beside()`` returned."""
    import torch
    from concurrent.futures import ThreadPoolExecutor

    checks = {"pmf": (PMF, "pmf_bitmap"), "lr": (LR, "lr_bitmap")}
    shapes = {"pmf": [(10681, 20), (20, 71567)], "lr": [(13,), ()]}
    # the invariant runs and the card/CPU reference pairs run side by side
    # in one pool: they are checked for bits, not timed. The LR and
    # PMF-Adam legs ran in one invocation, so their n_brokers=2 runs and
    # LR's rerun take 5 steps an invocation (and the card/CPU pairs 3):
    # there the B2 path crosses an invocation boundary (a worker respawn,
    # Adam's moments and the residual restored onto the card) and must
    # equal its one-invocation leg bit for bit. PMF-Nesterov's leg itself
    # runs 5 an invocation, so its n_brokers=2 run takes one (the split
    # across invocations) and its rerun 5. The runs that cross a boundary
    # here are pre-warmed (--prewarm): each must equal its cold leg in
    # digest, per-step wire bytes and, where the leg has them, exact
    # launches, with every successor's overlap measured
    labels = (("n_brokers=2", {"n_brokers": 2}), ("rerun", {}),
              ("wire_impl=numpy", {"impl": "numpy"}))
    across = {"pmf": ("rerun",), "lr": ("n_brokers=2", "rerun")}
    # SSP and shm, checked in the same pool (PMF bitmap, 4 workers, 10
    # steps): (batch, label, the leg it must equal, options, the worker and
    # broker respawns it must record, the exact launches of every worker or
    # None). The SSP/shm run takes 5 steps an invocation, the one SSP run
    # that crosses a boundary: its respawned workers must decode on the
    # card (the drain in the second invocation), so its launches are exact
    ssp_shm = (
        ("pmf", "ssp n_brokers=2 shm", "pmf_ssp_bitmap",
         dict(SSP, n_brokers=2, **SHM), (0, 0), PMF_LAUNCHES),
        ("lr", "ssp worker 1 SIGKILLed at step 7", "pmf_ssp_bitmap",
         dict(SSP, chaos='0:[{"kind": "worker_kill", "step": 7, "worker": 1}]',
              **ONE), (1, 0), None),
        ("lr", "n_brokers=2 shm, shard 1 SIGKILLed at step 4", "pmf_bitmap",
         dict(SHM, n_brokers=2,
              chaos='0:[{"kind": "broker_kill", "step": 4, "shard": 1}]',
              **ONE), (0, 1), None),
    )
    batches = {}
    for name, (job, leg) in checks.items():
        jobs = [(os.path.join(tmp, f"inv_{name}_"
                              + label.replace("=", "_")), job,
                 _leg_opts(**(dict(kw, prewarm=True) if label in across[name]
                              else dict(ONE, **kw))))
                for label, kw in labels]
        jobs += [(os.path.join(tmp, f"ref_{name}_{device}"), SMALL[name],
                  dict(workers=2, steps=6, inv_steps=3, scheme="bitmap",
                       device=device)) for device in ("cuda", "cpu")]
        if name == "pmf":
            jobs.append((os.path.join(tmp, "inv_pmf_adam_n_brokers_2"),
                         PMF_ADAM, _leg_opts(n_brokers=2, prewarm=True)))
        extra = [x for x in ssp_shm if x[0] == name]
        jobs += [(os.path.join(tmp, f"inv_extra_{name}_{i}"), PMF,
                  _leg_opts(**x[3])) for i, x in enumerate(extra)]
        batches[name] = jobs
    # the topology runs, first in the pool (the retune leg pays three cold
    # starts in a row): the retune leg (checked for bits) and the tuning
    # leg's job at a fixed topology (one tcp shard, whole leaves)
    topo = [(os.path.join(tmp, "pmf_retune"), PMF, _leg_opts(
                inv_steps=10, retunes=RETUNES, chaos=RETUNE_PACE)),
            (os.path.join(tmp, "inv_pmf_fixed_48"), PMF, _leg_opts(
                steps=TUNE_STEPS, inv_steps=TUNE_STEPS))]
    # PMF-Nesterov's pre-warmed rerun runs alone first, so that its wall
    # reads beside pmf_bitmap's (alone too); then one pool for the rest,
    # five jobs at a time: they are checked for bits, not timed (seven at
    # once have kept a broker that imported torch from listening within
    # its 30 s on a slow host). The longest start first (the topology
    # runs, then the pre-warmed ones) and the one-invocation main-path
    # legs last, so that no long job starts last; results are keyed by run
    # directory
    solo = batches["pmf"][1]  # labels[1], the rerun
    rest = [j for jobs in batches.values() for j in jobs if j is not solo]
    fleet = fleet_runs(tmp)
    legs = main_leg_jobs(tmp)
    pool = topo + fleet + [j for j in rest if j[2].get("prewarm")] + [
        j for j in rest if not j[2].get("prewarm")] + legs
    results = dict(zip([solo[0]], run_trains([solo])))
    with ThreadPoolExecutor(1) as ex:
        pooled = ex.submit(run_trains, pool, timeout_s=900.0, stagger_s=2.0,
                           max_parallel=5)
        side = beside()
        results.update(zip([d for d, _, _ in pool], pooled.result()))
    check_main_legs(tmp, runs, results)
    for name, (job, leg) in checks.items():
        params = final_params(runs[leg][0], job, "cuda")
        leaves = list(params)
        require([tuple(x.shape) for x in leaves] == shapes[name],
                f"{name}: final param shapes")
        require(all(bool(torch.isfinite(x).all()) for x in leaves),
                f"{name}: non-finite params")
    retune_res = check_topology_pool(topo, results, runs, tune)
    fleets = check_fleet(fleet, results, runs)
    for name, (job, leg) in checks.items():
        jobs = batches[name]
        by_job = [results[d] for d, _, _ in jobs]
        d0, res0 = runs[leg]
        dig0 = digest(d0, job)
        extra = [x for x in ssp_shm if x[0] == name]
        for (_, label, against, _, respawns, exact), (d, _, _), res in zip(
                extra, jobs[-len(extra):], by_job[-len(extra):]):
            d_ref, res_ref = runs[against]
            dig, dig_ref = digest(d, PMF), digest(d_ref, PMF)
            same_bytes = [r["wire_bytes"] for r in res["history"]] == [
                r["wire_bytes"] for r in res_ref["history"]]
            log("invariant", workload="pmf", against=against, run=label,
                digest_equal=dig == dig_ref, wire_bytes_equal=same_bytes,
                dup_mismatches=res["dup_mismatches"],
                respawns=len(res["respawns"]),
                broker_respawns=len(res["broker_respawns"]),
                shm_left=len(left_in_dev_shm(res)), wall_s=res["wall_s"])
            require(dig == dig_ref, f"pmf: digest differs: {label}")
            require(same_bytes, f"pmf: per-step wire bytes differ: {label}")
            require(res["dup_mismatches"] == 0, f"pmf: dup mismatches: "
                    f"{label}")
            got = (len(res["respawns"]), len(res["broker_respawns"]))
            require(got == respawns, f"pmf: (worker, broker) respawns "
                    f"{got}, not {respawns}: {label}")
            require(left_in_dev_shm(res) == [],
                    f"pmf: segments left in /dev/shm: {label}")
            if exact is not None:
                got = {w: {k: c.get(k, 0) for k in exact} for w, c in
                       res["kernel_launches_by_worker"].items()}
                require(got == {str(w): exact for w in range(4)},
                        f"pmf: launches {got}, not {exact} on each of 4 "
                        f"workers: {label}")

        for (label, _), (d, _, kw), res in zip(labels, jobs, by_job):
            dig = digest(d, job)
            same_bytes = [r["wire_bytes"] for r in res["history"]] == [
                r["wire_bytes"] for r in res0["history"]]
            log("invariant", workload=name, against=f"{leg} n_brokers=1",
                run=label, inv_steps=kw["inv_steps"],
                prewarm=kw.get("prewarm", False),
                digest_equal=dig == dig0,
                wire_bytes_equal=same_bytes,
                dup_mismatches=res["dup_mismatches"], wall_s=res["wall_s"])
            require(dig == dig0, f"{name}: final-params digest differs: "
                    f"{label}")
            require(same_bytes, f"{name}: per-step wire bytes differ: {label}")
            require(res["dup_mismatches"] == 0,
                    f"{name}: dup mismatches: {label}")
            if kw.get("prewarm"):
                check_prewarmed(f"{name} {label}", d, res, leg, res0)
        if name == "pmf":
            d_adam, res_adam = runs["pmf_adam_bitmap"]
            i_adam = len(labels) + 2  # after the card/CPU reference pair
            res_a2 = by_job[i_adam]
            dig_a, dig_a2 = digest(d_adam, PMF_ADAM), digest(
                jobs[i_adam][0], PMF_ADAM)
            same_bytes = [r["wire_bytes"] for r in res_a2["history"]] == [
                r["wire_bytes"] for r in res_adam["history"]]
            log("invariant", workload="pmf-adam",
                against="pmf_adam_bitmap n_brokers=1", run="n_brokers=2",
                inv_steps=5, prewarm=True,
                digest_equal=dig_a == dig_a2, wire_bytes_equal=same_bytes,
                dup_mismatches=res_a2["dup_mismatches"])
            require(dig_a == dig_a2, "pmf-adam: final-params digest differs: "
                    "n_brokers=2")
            require(same_bytes,
                    "pmf-adam: per-step wire bytes differ: n_brokers=2")
            require(res_a2["dup_mismatches"] == 0,
                    "pmf-adam: dup mismatches: n_brokers=2")
            check_prewarmed("pmf-adam n_brokers=2", jobs[i_adam][0], res_a2,
                            "pmf_adam_bitmap", res_adam)
        evals = {"cuda": by_job[3]["final_eval"],
                 "cpu": by_job[4]["final_eval"]}
        rel = abs(evals["cuda"] - evals["cpu"]) / abs(evals["cpu"])
        log("reference", workload=f"{name}-small", cuda_eval=evals["cuda"],
            cpu_eval=evals["cpu"], rel_diff=rel, tolerance=1e-3,
            metric="rmse" if name == "pmf" else "bce")
        require(rel <= 1e-3, f"{name}: card and CPU disagree: rel {rel}")
        if name == "lr":
            require(all(by_job[3]["kernel_launches_by_worker"][w].get(
                "adam_sig_update", 0) > 0 for w in ("0", "1")),
                "lr-small: B2 not launched on the card")
    return retune_res, fleets, side


# -- phase 4c: the in-process isp-pod trainer --------------------------------


def _inproc_cmd(out: str, extra: list) -> list:
    return [sys.executable, "-X", "faulthandler", "-m",
            "repro_torch.launch.train", "--runtime", "inproc", *extra,
            "--log-every", "100", "--out", out]


def _run_inproc(tmp: str, label: str, extra: list,
                timeout_s: float = 300.0) -> dict:
    """One in-process leg in a fresh process; past ``timeout_s`` it gets
    SIGABRT first, so that its log ends with every thread's stack."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    out = os.path.join(tmp, f"pod_{label}.json")
    errlog = os.path.join(tmp, f"pod_{label}.stderr.log")
    t0 = time.perf_counter()
    with open(errlog, "wb") as err:
        proc = subprocess.Popen(_inproc_cmd(out, extra), env=env,
                                stdout=subprocess.DEVNULL, stderr=err)
        try:
            proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            proc.send_signal(signal.SIGABRT)
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        with open(errlog, "rb") as f:
            tail = f.read().decode(errors="replace")[-6000:]
        raise SmokeFailure(f"pod leg {label} failed ({proc.returncode}) "
                           f"after {wall:.1f} s:\n{tail}")
    with open(out) as f:
        res = json.load(f)
    res["process_wall_s"] = wall
    return res


def pod_paths(tmp: str) -> dict:
    """``python -m repro_torch.launch.train --runtime inproc --arch lm-100m
    --mode isp-pod`` at the JAX CLI's defaults (4 pods x 4 x 256 tokens,
    Adam at 3e-4, v 0.7), 10 steps, once per POD_LEGS scheme, each in a
    fresh process: B1, B6 and B7 must launch POD_LAUNCHES times, the loss
    must be finite and its last step below its first, and the sent
    fraction strictly between 0 and 1. Then lm-8m (Dh 32) under the
    auto-tuner with checkpoints, which reports its final pool."""
    out = {}
    for label, extra in POD_LEGS:
        res = _run_inproc(tmp, label, POD_ARGS + extra)
        losses = [h["loss"] for h in res["history"]]
        steady_s = [h["step_s"] for h in res["history"][1:]]
        launches = res["kernel_launches"]
        log("pod-path", leg=label, arch=res["arch"], n_params=res["n_params"],
            steps=res["steps"], final_pool=res["final_pool"],
            first_loss=losses[0], final_loss=losses[-1],
            mean_sent_fraction=res["mean_sent_fraction"],
            first_step_s=res["history"][0]["step_s"],
            steady_step_s=sum(steady_s) / len(steady_s),
            wall_s=res["wall_s"], process_wall_s=res["process_wall_s"],
            peak_memory_bytes=res.get("peak_memory_bytes"),
            losses=json.dumps(losses),
            sent=json.dumps([h["sent_fraction"] for h in res["history"]]),
            launches=json.dumps(launches))
        for name, want in POD_LAUNCHES.items():
            require(launches.get(name, 0) == want,
                    f"pod {label}: {name} launched {launches.get(name, 0)} "
                    f"times, expected {want}")
        require(all(x == x and abs(x) < float("inf") for x in losses),
                f"pod {label}: non-finite loss {losses}")
        require(losses[-1] < losses[0], f"pod {label}: loss did not fall "
                f"({losses[0]} -> {losses[-1]})")
        require(0.0 < res["mean_sent_fraction"] < 1.0,
                f"pod {label}: mean sent fraction {res['mean_sent_fraction']}")
        out[label] = res
    ck = os.path.join(tmp, "pod_autotune_ckpt")
    res = _run_inproc(tmp, "autotune", [
        "--arch", "lm-8m", "--mode", "isp-pod", "--workers", "4",
        "--per-worker-batch", "4", "--seq", "256", "--steps", "20",
        "--scheme", "bitmap", "--autotune", "--sched-interval", "0.1",
        "--checkpoint-dir", ck, "--checkpoint-every", "10"])
    pools = [h["pool"] for h in res["history"]]
    log("pod-path", leg="autotune", arch=res["arch"], steps=res["steps"],
        final_pool=res["final_pool"], pools=json.dumps(pools),
        final_loss=res["final_loss"], wall_s=res["wall_s"],
        launches=json.dumps(res["kernel_launches"]))
    require(res["steps"] == 20 and 1 <= res["final_pool"] <= 4,
            f"pod autotune: steps {res['steps']} pool {res['final_pool']}")
    require(res["kernel_launches"].get("flash_attention", 0) > 0,
            "pod autotune: B7 (Dh 32) not launched")
    require(os.path.isdir(os.path.join(ck, "step_0000000020")),
            "pod autotune: no checkpoint at step 20")
    out["autotune"] = res
    return out


def pod_in_process(dev) -> dict:
    """The lm-100m isp-pod step in this process: two warm steps, one under
    torch.profiler (device time beside wall time: the card's busy share,
    and the largest kernels), then a scripted ``_scale_in_pod`` from 4 pods
    to 3, whose flushed parameters must equal the plain float32 sum of the
    parameters and the evicted pod's residual bit for bit, and two steps
    at 3 pods."""
    import argparse

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import optim, tree as tree_lib
    from repro_torch.core.isp import ISPConfig
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.dist.compression import CompressionConfig
    from repro_torch.dist.elastic import ElasticPlan
    from repro_torch.kernels import build
    from repro_torch.launch import train
    from repro_torch.models.transformer import LM

    lm = LM(train.LM_100M)
    opt = optim.adam(3e-4)
    isp, comp = ISPConfig(v=0.7), CompressionConfig(scheme="bitmap")
    params = lm.init(0, dev)
    st = train.TrainState(params, train.lift_pod(opt.init(params), 4),
                          train.lift_pod(tree_lib.tree_map(torch.zeros_like,
                                                           params), 4), 0, 4)

    def run(steps: int) -> list:
        fn = train.make_pod_step(lm, opt, isp, comp, st.pool)
        losses = []
        for _ in range(steps):
            pipe = TokenPipeline(lm.cfg.vocab_size, 256, 4 * st.pool)
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in pipe.next_batch(st.step).items()}
            st.params, st.opt_state, st.residual, loss, _ = fn(
                st.params, st.opt_state, st.residual, batch, st.step + 1)
            losses.append(float(loss))
            st.step += 1
        return losses

    run(2)
    torch.cuda.synchronize(dev)
    build.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(1)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    dev_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    if dev_us <= 0:
        log("pod-profile", device_ms_per_step="not measured",
            note="the profiler reported no device time")
    else:
        log("pod-profile", arch="lm-100m", pods=4, scheme="bitmap",
            wall_ms_per_step=wall * 1e3, device_ms_per_step=dev_us / 1e3,
            busy_share=dev_us / 1e6 / wall,
            device_ops_per_step=sum(e.count for e in kernels),
            launches=json.dumps(dict(build.LAUNCHES)),
            top=json.dumps([[e.key[:60], e.self_device_time_total / 1e3]
                            for e in top]))
    before = [x.clone() for x in tree_lib.leaves(st.params)]
    leaving = [r[3].clone() for r in tree_lib.leaves(st.residual)]
    st = train._scale_in_pod(argparse.Namespace(checkpoint_dir=None), st,
                             ElasticPlan(4, 4), isp)
    require(st.pool == 3, f"scale-in: pool {st.pool}")
    for x, p, r in zip(tree_lib.leaves(st.params), before, leaving):
        want = (p.float() + r.float()).to(p.dtype)
        require(_same(x, want), "scale-in: flushed params differ from the "
                "plain float32 sum")
    moved = sum(int(torch.count_nonzero(r)) for r in leaving)
    build.reset_launches()
    losses = run(2)
    launches = dict(build.LAUNCHES)
    require(all(x == x and abs(x) < float("inf") for x in losses),
            f"after scale-in: loss {losses}")
    require(launches.get("significance_filter") == 22
            and launches.get("wire_nnz") == 22
            and launches.get("flash_attention") == 2 * 12 * 3,
            f"after scale-in: launches {launches}")
    log("pod-scale-in", pods="4->3", flushed_nonzero_residuals=moved,
        flush_bit_exact=True, losses_at_3_pods=json.dumps(losses),
        launches=json.dumps(launches))
    del st, before, leaving
    torch.cuda.empty_cache()
    return {"wall_ms": wall * 1e3, "device_ms": dev_us / 1e3}


# -- phase 4d: the in-process trainer's bsp and isp modes -------------------


def _losses_ok(label: str, losses: list) -> None:
    require(all(x == x and abs(x) < float("inf") for x in losses),
            f"{label}: non-finite loss {losses}")
    require(losses[-1] < losses[0], f"{label}: loss did not fall "
            f"({losses[0]} -> {losses[-1]})")


def flat_paths(tmp: str) -> dict:
    """``python -m repro_torch.launch.train --arch lm-100m --mode bsp`` and
    ``--mode isp`` at the JAX CLI's defaults (4 workers x 4 x 256 tokens,
    one gradient over the global batch, Adam at 3e-4, v 0.7), 10 steps,
    each in a fresh process: the launches must equal FLAT_LAUNCHES exactly
    (B3 under bsp, B2 and B6 under isp, B7 in both, nothing else), the
    loss finite and lower at the last step than at the first, the isp sent
    fraction strictly between 0 and 1. Then the CLI's default invocation,
    ``python -m repro_torch.launch.train --steps 20`` (bsp, Adam, lm-8m,
    on the card), read from its printed result."""
    out = {}
    for mode, want in FLAT_LAUNCHES.items():
        res = _run_inproc(tmp, f"flat_{mode}", FLAT_ARGS + ["--mode", mode])
        losses = [h["loss"] for h in res["history"]]
        steady_s = [h["step_s"] for h in res["history"][1:]]
        launches = res["kernel_launches"]
        log("flat-path", mode=mode, arch=res["arch"],
            n_params=res["n_params"], steps=res["steps"],
            final_pool=res["final_pool"], first_loss=losses[0],
            final_loss=losses[-1],
            mean_sent_fraction=res["mean_sent_fraction"],
            first_step_s=res["history"][0]["step_s"],
            steady_step_s=sum(steady_s) / len(steady_s),
            wall_s=res["wall_s"], process_wall_s=res["process_wall_s"],
            peak_memory_bytes=res.get("peak_memory_bytes"),
            losses=json.dumps(losses),
            sent=json.dumps([h["sent_fraction"] for h in res["history"]]),
            launches=json.dumps(launches))
        require(launches == want, f"flat {mode}: launches {launches}, "
                f"expected exactly {want}")
        require(res["steps"] == 10 and res["final_pool"] == 4,
                f"flat {mode}: steps {res['steps']} pool {res['final_pool']}")
        _losses_ok(f"flat {mode}", losses)
        if mode == "bsp":
            require(res["mean_sent_fraction"] == 1.0,
                    f"flat bsp: sent fraction {res['mean_sent_fraction']}")
        else:
            require(0.0 < res["mean_sent_fraction"] < 1.0,
                    f"flat isp: mean sent fraction "
                    f"{res['mean_sent_fraction']}")
        out[mode] = res
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--steps",
         str(CLI_DEFAULT_STEPS)], env=env, capture_output=True, text=True,
        timeout=300)
    wall = time.perf_counter() - t0
    require(proc.returncode == 0, f"CLI default invocation failed "
            f"({proc.returncode}):\n{proc.stderr[-4000:]}")
    text = proc.stdout
    res = json.loads(text[text.index("\n{") + 1:])
    launches = res["kernel_launches"]
    log("flat-path", mode="bsp (the CLI's default invocation: --steps "
        f"{CLI_DEFAULT_STEPS}, no other flag)", arch=res["arch"],
        device=json.dumps(res["device"]), steps=res["steps"],
        final_loss=res["final_loss"], wall_s=res["wall_s"],
        process_wall_s=wall, launches=json.dumps(launches))
    require(res["arch"] == "lm-8m" and "mode=bsp" in text
            and res["device"] != "cpu", "CLI default: not bsp/lm-8m on the "
            f"card: {text[:200]}")
    require(res["steps"] == CLI_DEFAULT_STEPS
            and res["mean_sent_fraction"] == 1.0,
            f"CLI default: steps {res['steps']} sent "
            f"{res['mean_sent_fraction']}")
    require(launches == CLI_DEFAULT_LAUNCHES, f"CLI default: launches "
            f"{launches}, expected exactly {CLI_DEFAULT_LAUNCHES}")
    first = float(text.split("loss=")[1].split()[0])  # step 10's log line
    require(res["final_loss"] == res["final_loss"]
            and res["final_loss"] < first,
            f"CLI default: loss {first} at step 10 -> {res['final_loss']}")
    out["cli_default"] = res
    return out


def _profile_steps(fn, dev) -> dict:
    """``fn()`` under torch.profiler: wall and device milliseconds, the
    card's busy share, device operations and the largest kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    dev_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {"wall_ms": wall * 1e3, "device_ms": dev_us / 1e3,
            "ops": sum(e.count for e in kernels),
            "top": [[e.key[:60], e.self_device_time_total / 1e3]
                    for e in top]}


def flat_in_process(dev) -> dict:
    """One lm-100m bsp step (4 x 4 x 256 tokens, Adam 3e-4) in this
    process under torch.profiler, after two warm steps: device time beside
    wall time (the card's busy share), the device operations and the
    largest kernels, and the step's launches."""
    import torch

    from repro_torch import optim, tree as tree_lib
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import build
    from repro_torch.launch import train
    from repro_torch.models.transformer import LM

    lm = LM(train.LM_100M)
    opt = optim.adam(3e-4)
    params = lm.init(0, dev)
    st = train.TrainState(params, opt.init(params), tree_lib.tree_map(
        torch.zeros_like, params), 0, 4)
    fn = train.make_step(lm, opt, None)

    def run(steps: int) -> None:
        for _ in range(steps):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in TokenPipeline(
                lm.cfg.vocab_size, 256, 16).next_batch(st.step).items()}
            st.params, st.opt_state, st.residual, loss, _ = fn(
                st.params, st.opt_state, st.residual, batch, st.step + 1)
            float(loss)
            st.step += 1

    run(2)
    build.reset_launches()
    prof = _profile_steps(lambda: run(1), dev)
    launches = dict(build.LAUNCHES)
    if prof["device_ms"] <= 0:
        log("flat-profile", device_ms_per_step="not measured",
            note="the profiler reported no device time")
    else:
        log("flat-profile", arch="lm-100m", mode="bsp", optimizer="adam",
            wall_ms_per_step=prof["wall_ms"],
            device_ms_per_step=prof["device_ms"],
            busy_share=prof["device_ms"] / prof["wall_ms"],
            device_ops_per_step=prof["ops"], launches=json.dumps(launches),
            top=json.dumps(prof["top"]))
    require(launches == {"adam_update": 11, "flash_attention": 12},
            f"flat profile step: launches {launches}")
    del st, params
    torch.cuda.empty_cache()
    return prof


def train_card_vs_cpu(dev) -> dict:
    """lm-100m at full width cut to 2 layers, float32, the same seeded
    parameters (made on the CPU, copied to the card) and batches on both
    devices: 3 bsp steps with Adam at 3e-4 through ``train.make_step``
    (B7 and B3 on the card, their plain versions on the CPU, TF32 off).
    Each step's loss must agree within TRAIN_CPU_TOL relative."""
    import dataclasses

    import torch

    from repro_torch import optim, tree as tree_lib
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import build
    from repro_torch.launch import train
    from repro_torch.models.config import (BlockSpec, FF, Mixer,
                                           uniform_groups)
    from repro_torch.models.transformer import LM

    cfg = dataclasses.replace(
        train.LM_100M, groups=uniform_groups(BlockSpec(Mixer.GLOBAL_ATTN,
                                                       FF.SWIGLU), 2),
        param_dtype="float32", activation_dtype="float32")
    lm = LM(cfg)
    opt = optim.adam(3e-4)
    p_cpu = lm.init(0, "cpu")
    losses, secs = {}, {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        params = tree_lib.tree_map(lambda t: t.to(d, copy=True), p_cpu)
        state, res = opt.init(params), tree_lib.tree_map(torch.zeros_like,
                                                         params)
        fn = train.make_step(lm, opt, None)
        build.reset_launches()
        t0 = time.perf_counter()
        out = []
        for step in range(3):
            batch = {k: torch.from_numpy(v).to(d) for k, v in TokenPipeline(
                cfg.vocab_size, 256, 16).next_batch(step).items()}
            params, state, res, loss, _ = fn(params, state, res, batch,
                                             step + 1)
            out.append(float(loss))
        secs[name] = time.perf_counter() - t0
        losses[name] = out
        if name == "cuda":
            require(dict(build.LAUNCHES) == {"adam_update": 33,
                                             "flash_attention": 6},
                    f"train depth cut: launches {dict(build.LAUNCHES)}")
        del params, state, res
    torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                   losses["cpu"]))
    log("reference", arch="lm-100m depth cut", layers=cfg.n_layers,
        dtype="float32", mode="bsp", optimizer="adam", steps=3,
        batch="16 x 256", matmul_allow_tf32=torch.backends.cuda.matmul
        .allow_tf32, cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
        losses_cuda=json.dumps(losses["cuda"]),
        losses_cpu=json.dumps(losses["cpu"]), max_rel_diff=rel,
        tolerance=TRAIN_CPU_TOL, seconds_cuda=secs["cuda"],
        seconds_cpu=secs["cpu"])
    require(rel <= TRAIN_CPU_TOL, f"train depth cut: card and CPU losses "
            f"differ by {rel} relative")
    return {"max_rel_diff": rel}


# -- phase 4b: the LM serving paths ------------------------------------------


def reference_new_tokens(requests: int, slots: int, gen_len: int) -> int:
    """The tokens the reference serving loop generates for ``requests
    >= slots`` (``repro.launch.serve``'s loop: at most ``gen_len`` decode
    steps, a finished slot admits the next request)."""
    count = [0] * requests
    slot_req = list(range(slots))
    remaining = list(range(slots, requests))
    done = steps = 0
    while done < requests and steps < gen_len:
        for s, r in enumerate(slot_req):
            if r is None:
                continue
            count[r] += 1
            if count[r] >= gen_len:
                done += 1
                slot_req[s] = remaining.pop(0) if remaining else None
        steps += 1
    return sum(count)


def serve_cut(arch: str, out: str) -> None:
    """Serve SERVE[arch]'s depth cut through ``serve.serve(args, cfg=...)``
    (the loop a user calls, with the cut in place of the registered
    config), writing its result to ``out``; run in a process of its own
    by ``serve_paths``."""
    import argparse

    from repro_torch.launch import serve

    a = SERVE[arch]
    args = argparse.Namespace(
        arch=arch, smoke=False, requests=a["requests"], slots=a["slots"],
        prompt_len=a["prompt_len"], gen_len=a["gen_len"], seed=0,
        device="cuda", out=out)
    serve.serve(args, cfg=_serve_cfg(arch))


def _serve_cfg(arch: str):
    """SERVE[arch]'s config: the full one, or its first group's superblock
    repeated ``layers`` times (bf16, full width)."""
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = get_arch(arch)
    layers = SERVE[arch].get("layers")
    if layers is None:
        return cfg
    sb, _ = cfg.groups[0]
    return dataclasses.replace(cfg, groups=((sb, layers // len(sb)),))


def serve_paths(tmp: str) -> dict:
    """``python -m repro_torch.launch.serve --no-smoke`` for each arch of
    SERVE at full width (a depth cut through ``serve_cut``), one after the
    other, each in a fresh process (its launch counts start at 0); returns
    the result dicts."""
    import torch

    from repro_torch.kernels import build

    # mixtral's init peaks near 65 GB: nothing of this process may stay
    # cached on the card
    torch.cuda.empty_cache()
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    out = {}
    for arch, a in SERVE.items():
        want_tokens = reference_new_tokens(a["requests"], a["slots"],
                                           a["gen_len"])
        path = os.path.join(tmp, f"serve_{arch}.json")
        build.reset_launches()
        if a.get("layers") is None:
            cmd = [sys.executable, "-m", "repro_torch.launch.serve",
                   "--no-smoke", "--arch", arch,
                   "--requests", str(a["requests"]),
                   "--slots", str(a["slots"]), "--prompt-len",
                   str(a["prompt_len"]), "--gen-len", str(a["gen_len"]),
                   "--out", path]
        else:
            cmd = [sys.executable, "-c",
                   f"import sys; sys.path[:0] = [{ROOT!r}, {SRC!r}]; "
                   f"import chip_smoke; chip_smoke.serve_cut({arch!r}, "
                   f"{path!r})"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=400)
        wall = time.perf_counter() - t0
        require(proc.returncode == 0,
                f"serve {arch} failed ({proc.returncode}):\n"
                f"{proc.stderr[-4000:]}")
        with open(path) as f:
            res = json.load(f)
        launches = res["kernel_launches"]
        kernel, per_prefill = a["kernel"], a["per_prefill"]
        log("serve", arch=arch, layers=_serve_cfg(arch).n_layers,
            requests=a["requests"], slots=a["slots"],
            prompt=a["prompt_len"], wall_s=wall, **{
                k: res[k] for k in ("prefill_s", "decode_s", "decode_steps",
                                    "new_tokens", "prefill_tokens_per_s",
                                    "decode_tokens_per_s",
                                    "peak_memory_bytes")},
            launches=json.dumps(launches))
        require(launches.get(kernel, 0) == per_prefill,
                f"serve {arch}: {kernel} launched {launches.get(kernel, 0)} "
                f"times, expected {per_prefill}")
        require(res["new_tokens"] == want_tokens,
                f"serve {arch}: {res['new_tokens']} new tokens, the "
                f"reference loop gives {want_tokens}")
        require(res["decode_steps"] == a["gen_len"],
                f"serve {arch}: {res['decode_steps']} decode steps")
        out[arch] = res
    return out


def _depth_cut(arch: str):
    """CARD_VS_CPU[arch]'s cut: the arch at full width in float32, its
    first group's superblock (or the blocks named) repeated ``reps``
    times."""
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = get_arch(arch)
    cut = CARD_VS_CPU[arch]
    sb, _ = cfg.groups[0]
    if cut["blocks"] is not None:
        sb = tuple(sb[i] for i in cut["blocks"])
    return dataclasses.replace(cfg, groups=((sb, cut["reps"]),),
                               param_dtype="float32",
                               activation_dtype="float32")


def card_vs_cpu(dev) -> dict:
    """The same seeded port parameters (made on the card, copied to the
    CPU) at full width, cut in depth, float32 (CARD_VS_CPU): prefill of
    the prompt and greedy decode steps on the card (kernels) and on the
    CPU (plain versions). Prefill last-position logits must agree within
    LM_CPU_TOL; the greedy tokens are compared and reported."""
    import torch

    from repro_torch import tree as tree_lib
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import build
    from repro_torch.models.transformer import LM

    out = {}
    for arch, cut in CARD_VS_CPU.items():
        kernel = SERVE[arch]["kernel"]
        cfg = _depth_cut(arch)
        lm = LM(cfg)
        plen, slots, steps = cut["prompt"], cut["slots"], cut["steps"]
        t0 = time.perf_counter()
        p_dev = lm.init(0, dev)
        p_cpu = tree_lib.tree_map(lambda t: t.cpu(), p_dev)
        prompt = torch.from_numpy(TokenPipeline(
            cfg.vocab_size, plen, slots, seed=0).next_batch(0)["tokens"])
        logits, toks = {}, {}
        for name, d, params in (("cuda", dev, p_dev), ("cpu", "cpu", p_cpu)):
            build.reset_launches()
            cache = lm.init_cache(slots, plen + steps, d)
            lg, cache = lm.prefill(params, cache, {"tokens": prompt.to(d)})
            logits[name] = lg.float().cpu()
            seq = []
            tok = torch.argmax(lg[:, -1], -1).to(torch.int32)
            for i in range(steps):
                seq.append(tok.cpu().tolist())
                lg, cache = lm.decode_step(params, cache,
                                           {"tokens": tok[:, None]}, plen + i)
                tok = torch.argmax(lg[:, -1], -1).to(torch.int32)
            toks[name] = seq
            if name == "cuda":
                require(build.LAUNCHES[kernel] > 0,
                        f"{arch} depth cut: {kernel} not launched on the card")
        err = _close(logits["cuda"], logits["cpu"], LM_CPU_TOL,
                     f"{arch} depth cut: prefill logits card vs CPU")
        agree = sum(a == b for a, b in zip(toks["cuda"], toks["cpu"]))
        log("reference", arch=f"{arch} depth cut", layers=cfg.n_layers,
            dtype="float32", prompt=plen, slots=slots,
            matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
            cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
            logits_max_abs_err=err,
            logits_max_abs=float(logits["cpu"].abs().max()),
            tolerance=LM_CPU_TOL, greedy_steps_equal=f"{agree}/{steps}",
            tokens_cuda=json.dumps(toks["cuda"]),
            tokens_cpu=json.dumps(toks["cpu"]),
            wall_s=time.perf_counter() - t0)
        out[arch] = {"max_abs_err": err, "greedy_equal": agree}
        del p_dev, p_cpu
        torch.cuda.empty_cache()
    return out


def profile_serve(dev) -> None:
    """Where a serving run's time goes, per arch of SERVE at its served
    config and arguments: one warm prefill of all slots and 4 greedy decode
    steps under torch.profiler (device activity only: post-processing a
    host trace of the decode steps took longer than the steps), device
    time beside the host's wall time (the card's busy share), B7's or B8's
    device time and share, and the largest kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models.transformer import LM

    for arch, a in SERVE.items():
        slots, plen = a["slots"], a["prompt_len"]
        lm = LM(_serve_cfg(arch))
        params = lm.init(0, dev)
        cache = lm.init_cache(slots, plen + a["gen_len"], dev)
        prompt = torch.from_numpy(TokenPipeline(
            lm.cfg.vocab_size, plen, slots).next_batch(0)["tokens"]).to(dev)

        def prefill():
            lm.prefill(params, cache, {"tokens": prompt})

        def decode(n: int = 4):
            tok = prompt[:, -1:].to(torch.int32)
            for i in range(n):
                logits, _ = lm.decode_step(params, cache, {"tokens": tok},
                                           plen + i)
                tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
                tok.tolist()  # the serving loop reads every step's tokens

        prefill()
        decode(2)
        mark = "slstm" if a["kernel"] == "slstm_scan" else "flash"
        for phase, fn, steps in (("prefill", prefill, 1),
                                 ("decode", decode, 4)):
            torch.cuda.synchronize(dev)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize(dev)
                wall = time.perf_counter() - t0
            kernels = [e for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False)]
            dev_us = sum(e.self_device_time_total for e in kernels)
            top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
            k_us = sum(e.self_device_time_total for e in kernels
                       if mark in e.key)
            log("serve-profile", arch=arch, layers=lm.cfg.n_layers,
                phase=phase, steps=steps, kernel=a["kernel"],
                kernel_ms_per_step=k_us / 1e3 / steps,
                kernel_device_share=k_us / dev_us if dev_us else 0.0,
                wall_ms_per_step=wall * 1e3 / steps,
                device_ms_per_step=dev_us / 1e3 / steps,
                busy_share=dev_us / 1e6 / wall,
                device_ops_per_step=sum(e.count for e in kernels) / steps,
                top=json.dumps([[e.key[:60], e.self_device_time_total
                                 / 1e3 / steps] for e in top]))
        del params, cache
        torch.cuda.empty_cache()


# B7's timed shapes, all causal bf16: (label, B, S, H, K, Dh, window); the
# first gives the kernel's row in the summary
FLASH_TIMED = (("phi4-mini prefill", 4, 1024, 24, 8, 128, None),
               ("lm-100m bsp step", 16, 256, 12, 12, 64, None),
               ("lm-100m isp-pod step", 4, 256, 12, 12, 64, None),
               ("lm-8m bsp step", 16, 256, 8, 8, 32, None),
               ("gemma3-12b local prefill", 4, 2048, 16, 8, 256, 1024),
               ("mixtral-8x22b prefill", 2, 5120, 48, 8, 128, 4096))


def time_flash(dev, flush) -> dict:
    """B7 at each FLASH_TIMED shape beside one
    ``scaled_dot_product_attention`` call on (B, H, S, Dh) copies of the
    same tensors (its yardstick only; the port never calls it; a window
    goes in as a boolean ``attn_mask``) and beside its bound (the window's
    allowed pairs). Returns the first shape's row."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    out = None
    for label, b, s, h, kh, dh, window in FLASH_TIMED:
        q = _randn((b, s, h, dh), gen, dev, torch.bfloat16)
        k = _randn((b, s, kh, dh), gen, dev, torch.bfloat16)
        v = _randn((b, s, kh, dh), gen, dev, torch.bfloat16)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = None
        if window is not None:
            pos = torch.arange(s, device=dev)
            lag = pos[:, None] - pos[None, :]
            mask = (lag >= 0) & (lag < window)

        def kern():
            return flash_attention.flash_attention(q, k, v, causal=True,
                                                   window=window)

        def sdpa():
            if mask is None:
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)

        # allowed (query, key) pairs: query i sees min(i + 1, window) keys
        w = s if window is None else window
        pairs = b * h * (w * (w + 1) // 2 + (s - w) * w)
        flops = 4 * dh * pairs
        nbytes = 2 * (2 * b * s * h * dh + 2 * b * s * kh * dh)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
        bound = max(t_bytes, t_ops) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        t_cold = _time(kern, dev, 20, True, flush)
        t_warm = _time(kern, dev, 20, False, flush)
        p_cold = _time(lambda: ref.mha_ref(q, k, v, causal=True,
                                           window=window), dev, 5, True,
                       flush)
        lib_ms = _time(sdpa, dev, 20, True, flush)
        dev_ms = _device_ms(kern, 10)
        lib_dev_ms = _device_ms(sdpa, 10)
        log("kernel-time", kernel="flash_attention", shape=json.dumps(label),
            B=b, S=s, H=f"{h}/{kh}", Dh=dh, window=window, ms=t_cold,
            ms_l2warm=t_warm,
            device_ms_l2warm=dev_ms, plain_ms=p_cold, bound_ms=bound,
            bound_by=bound_by, bytes=nbytes, flops=flops,
            bytes_ms=t_bytes * 1e3, operations_ms=t_ops * 1e3,
            library_ms=lib_ms, library_device_ms_l2warm=lib_dev_ms,
            device_ratio_to_library=dev_ms / lib_dev_ms,
            bound_share=bound / dev_ms,
            library_note="F.scaled_dot_product_attention(is_causal=True, "
                         "enable_gqa=True) on (B, H, S, Dh) copies"
                         + ("" if window is None else
                            "; the window as a boolean attn_mask"))
        if out is None:
            out = {"ms": t_cold, "plain_ms": p_cold, "bound_ms": bound,
                   "bound_by": bound_by, "library_ms": lib_ms}
        del q, k, v, qt, kt, vt, mask
    return out


def time_lm_kernels(dev, flush) -> dict:
    """B7 (``time_flash``), and B8 at xlstm-1.3b's prefill shape (B 4, S
    1024, d 2048, H 4, R bf16) beside its bound; B8's plan, the clusters
    the card holds at once (``cudaOccupancyMaxActiveClusters``) and the
    batch split: one cluster a head against two, the same tensors, in
    turns (one, two, two, one)."""
    import torch

    from repro_torch.kernels import ref, slstm_scan

    out = {"flash_attention": time_flash(dev, flush)}
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    bd, sd, d, heads = 4, 1024, 2048, 4
    xg, r, _ = _slstm_case(dev, gen, bd, sd, d, heads, torch.bfloat16, False)
    flops = 2 * bd * sd * d * 4 * (d // heads)
    nbytes = (xg.numel() * 4 + bd * sd * d * 4 + r.numel() * 2
              + 6 * bd * d * 4)  # xg, h, R, initial and final state

    def kern():
        return slstm_scan.slstm_scan(xg, r)

    p = slstm_scan.plan(bd, d, heads, torch.bfloat16)
    zeros = tuple(torch.zeros(bd, d, device=dev) for _ in range(3))
    plans = {g: slstm_scan._cluster_plan(bd, d // heads, g) for g in (1, 2)}
    split = {1: [], 2: []}
    for groups in (1, 2, 2, 1):  # CUDA events: milliseconds a launch
        split[groups].append(_time(
            lambda q=plans[groups]: slstm_scan._launch(xg, r, zeros, q),
            dev, 5, False, flush))
    for groups, q in plans.items():
        log("slstm-split", clusters_per_head=groups, rows=q.rows,
            ctas=q.clusters(bd, heads) * q.cluster,
            max_active_clusters=slstm_scan.max_clusters(q, d, heads,
                                                        torch.bfloat16),
            ms_l2warm=json.dumps(split[groups]), chosen=q == p)
    t_cold = _time(kern, dev, 10, True, flush)
    t_warm = _time(kern, dev, 10, False, flush)
    p_cold = _time(lambda: ref.slstm_scan_ref(xg, r), dev, 2, True, flush)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    bound = max(t_bytes, t_ops) * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    dev_ms = _device_ms(kern, 5)
    log("kernel-time", kernel="slstm_scan", route=p.route,
        cluster=p.cluster, rows=p.rows,
        max_active_clusters=slstm_scan.max_clusters(p, d, heads,
                                                    torch.bfloat16),
        ms=t_cold, ms_l2warm=t_warm, device_ms_l2warm=dev_ms,
        plain_ms=p_cold, bound_ms=bound, bound_by=bound_by, bytes=nbytes,
        flops=flops, bytes_ms=t_bytes * 1e3, operations_ms=t_ops * 1e3,
        bound_share=bound / dev_ms, library_ms=None,
        library_note="no single PyTorch call does the sLSTM scan")
    out["slstm_scan"] = {"ms": t_cold, "plain_ms": p_cold,
                         "bound_ms": bound, "bound_by": bound_by,
                         "library_ms": None}
    return out


# -- phase 5b: the serverless training simulator ----------------------------


class SimPMF:
    """examples/mlless_pmf.py's PMF job at ML-10M width: the data, one
    seeded replica on the CPU, the minibatches (rows of the step's seeded
    draw, P x SIM_B) and the eval RMSE of SIM_EVAL held-out ratings."""

    def __init__(self):
        import numpy as np
        import torch

        from repro_torch.data import synthetic
        from repro_torch.models import pmf

        ml = synthetic.MovieLensLikeConfig(
            n_users=ML10M["n_users"], n_movies=ML10M["n_movies"],
            n_ratings=ML10M["n_ratings"], rank=ML10M["rank"], seed=0)
        self.ml = ml
        self.users, self.movies, self.ratings = synthetic.make_movielens(ml)
        self.cfg = pmf.PMFConfig(ml.n_users, ml.n_movies, ml.rank)
        self.params0 = pmf.init(self.cfg, torch.Generator().manual_seed(0))
        self.eidx = np.random.default_rng(0).choice(
            len(self.ratings), SIM_EVAL, replace=False)

    def make(self, dev, P: int, platform: str, model: str):
        """``(simulator, batch_fn, eval_fn)`` on ``dev``."""
        from functools import partial

        import numpy as np

        from repro_torch import optim
        from repro_torch.core import consistency as cons
        from repro_torch.core import simulator as sim
        from repro_torch.core.isp import ISPConfig
        from repro_torch.data import synthetic
        from repro_torch.models import pmf

        rank, n_users = self.ml.rank, self.ml.n_users
        s = sim.ServerlessSimulator(
            sim.SimulatorConfig(
                n_workers=P, platform=sim.Platform[platform],
                consistency=cons.ConsistencyConfig(
                    model=cons.Model[model], isp=ISPConfig(v=SIM_V),
                    slack=SIM_SLACK),
                sparse_model=True),
            loss_fn=partial(pmf.loss_fn, self.cfg),
            optimizer=optim.make("nesterov", SIM_LR), params=self.params0,
            flops_per_sample=6 * rank * 3,
            update_nnz_fn=lambda b: 2 * rank * min(b, n_users), device=dev)
        ev = synthetic.ratings_batch(self.users, self.movies, self.ratings,
                                     self.eidx, dev)

        def batch_fn(step: int, n: int):
            idx = np.random.default_rng(step).integers(
                0, len(self.ratings), size=(n, SIM_B))
            return synthetic.ratings_batch(self.users, self.movies,
                                           self.ratings, idx, dev)

        return s, batch_fn, lambda p: float(pmf.rmse(p, ev))


def check_sim_kernels(dev, err: dict) -> None:
    """B1 and B6 at the simulator's stacked leaves (SIM_STACKED: P = 8's U
    and M, P = 24's M) against their plain versions, bit for bit: u 5%
    dense as a PMF update is, x and r dense, some x exactly 0 (the floor)
    and -0.0."""
    import torch

    from repro_torch.kernels import ref, significance, wire_pack

    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    v_t = 0.7 / 3 ** 0.5
    for shape in SIM_STACKED:
        u = torch.randn(shape, generator=gen, device=dev) * 1e-2
        u[torch.rand(shape, generator=gen, device=dev) >= 0.05] = 0.0
        x = torch.randn(shape, generator=gen, device=dev) * 0.2
        x[..., ::97] = 0.0
        x[..., 1::101] = -0.0
        r = torch.randn(shape, generator=gen, device=dev) * 1e-2
        sig, res = significance.significance_filter(u, x, r, v_t)
        want = ref.significance_ref(u, x, r, v_t)
        require(_same(sig, want[0]) and _same(res, want[1]),
                f"significance_filter at {shape}: differs from its plain "
                "version")
        nnz = wire_pack.wire_nnz(sig.reshape(-1))
        want_nnz = ref.wire_nnz_ref(sig.reshape(-1))
        require(int(nnz) == int(want_nnz),
                f"wire_nnz at {shape}: {int(nnz)} != {int(want_nnz)}")
        err["significance_filter"] = max(err["significance_filter"],
                                         _abs_err(sig, want[0]),
                                         _abs_err(res, want[1]))
        log("sim-kernels", shape=json.dumps(list(shape)),
            elements=u.numel(), nnz=int(nnz), bit_exact=True)
        del u, x, r, sig, res, want
    torch.cuda.empty_cache()


def _sim_job(data: SimPMF, dev, label: str, platform: str, model: str,
             tuned: bool, P: int = SIM_P) -> tuple:
    """One simulator job of SIM_STEPS steps (or until the RMSE target) on
    the card; its launches are counted from 0. Returns (result, launches,
    simulator)."""
    import torch

    from repro_torch.core.autotuner import AutoTunerConfig, ScaleInAutoTuner
    from repro_torch.kernels import build

    s, batch_fn, eval_fn = data.make(dev, P, platform, model)
    tuner = (ScaleInAutoTuner(AutoTunerConfig(sched_interval_s=2.0,
                                              delta_s=1.0), P)
             if tuned else None)
    torch.cuda.synchronize(dev)
    build.reset_launches()
    t0 = time.perf_counter()
    res = s.run(batch_fn, SIM_B, SIM_STEPS, loss_threshold=SIM_RMSE_TARGET,
                eval_fn=eval_fn, tuner=tuner)
    torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    n = len(res.records)
    rmse = [r.loss for r in res.records]
    comm = [r.comm_fraction for r in res.records]
    log("simulator", job=label, platform=platform, consistency=model, P=P,
        B=SIM_B, steps=n, converged=res.converged_at_s is not None,
        time_to_loss_s=res.converged_at_s or res.total_wall_s,
        cost_usd=res.total_cost, first_rmse=rmse[0], final_rmse=rmse[-1],
        final_workers=res.summary["final_workers"],
        mean_comm_frac=sum(comm) / n, wall_s_per_step=secs / n,
        seconds=secs, launches=json.dumps(launches))
    require(all(math.isfinite(v) for v in rmse) and rmse[-1] < rmse[0],
            f"simulator {label}: RMSE {rmse[0]} -> {rmse[-1]}")
    want = ({"significance_filter": 2 * n, "wire_nnz": 2 * n}
            if model == "ISP" else {})
    require(launches == want, f"simulator {label}: launches {launches}, "
            f"not {want}")
    if model == "BSP":
        from repro_torch import tree as tree_lib

        same = all(torch.equal(x[0], x[p]) for x in
                   tree_lib.leaves(s.replicas) for p in range(1, P))
        require(same, f"simulator {label}: replicas differ under BSP")
    if model == "ISP":
        require(all(0.0 < c < 1.0 for c in comm),
                f"simulator {label}: comm_frac outside (0, 1)")
    return res, launches, s


def sim_card_vs_cpu(data: SimPMF, dev) -> None:
    """The port at full width, P = 8, 3 ISP steps on the card and on the
    CPU from the same replica and batches: every step's eval RMSE within
    SIM_CPU_LOSS_RTOL and comm_frac within SIM_CPU_COMM_RTOL relative
    (tests/test_torch_simulator.py's CARD_LOSS_RTOL, CARD_COMM_RTOL)."""
    import torch

    out = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        s, batch_fn, eval_fn = data.make(d, SIM_P, "MLLESS", "ISP")
        t0 = time.perf_counter()
        res = s.run(batch_fn, SIM_B, 3, eval_fn=eval_fn)
        out[name] = ([r.loss for r in res.records],
                     [r.comm_fraction for r in res.records],
                     time.perf_counter() - t0)
        del s
    torch.cuda.empty_cache()
    (lc, cc, tc), (lp, cp, tp) = out["cuda"], out["cpu"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lp))
    comm_rel = max(abs(a - b) / abs(b) for a, b in zip(cc, cp))
    log("reference", what="simulator card vs CPU", P=SIM_P, steps=3,
        rmse_cuda=json.dumps(lc), rmse_cpu=json.dumps(lp),
        comm_frac_cuda=json.dumps(cc), comm_frac_cpu=json.dumps(cp),
        max_rel_diff_rmse=loss_rel, max_rel_diff_comm_frac=comm_rel,
        first_step_comm_frac_equal=cc[0] == cp[0],
        tolerance_rmse=SIM_CPU_LOSS_RTOL, tolerance_comm=SIM_CPU_COMM_RTOL,
        seconds_cuda=tc, seconds_cpu=tp)
    require(loss_rel <= SIM_CPU_LOSS_RTOL and comm_rel <= SIM_CPU_COMM_RTOL,
            f"simulator card vs CPU: RMSE {loss_rel}, comm_frac {comm_rel} "
            "relative")


def simulator_phase(dev, err: dict) -> dict:
    """examples/mlless_pmf.py's five jobs, an SSP job (slack SIM_SLACK) and
    an ISP job at P = SIM_P_MAX on the card at ML-10M width; MLLess + ISP
    twice, bit for bit; B1 and B6 at the stacked shapes; the card against
    the CPU; one steady ISP step under torch.profiler. Returns the jobs'
    summed launches."""
    import torch

    from repro_torch.kernels import build

    check_sim_kernels(dev, err)
    data = SimPMF()
    total: dict = {}

    def count(launches: dict) -> None:
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    for label, platform, model, tuned in SIM_JOBS:
        res, launches, s = _sim_job(data, dev, label, platform, model, tuned)
        count(launches)
        if label == "mlless_isp":
            first = [(r.loss, r.comm_fraction) for r in res.records]
            del s
            res, launches, s = _sim_job(data, dev, label + "_rerun",
                                        platform, model, tuned)
            count(launches)
            again = [(r.loss, r.comm_fraction) for r in res.records]
            log("simulator", job="mlless_isp_rerun", bit_identical=first ==
                again)
            require(first == again, "simulator mlless_isp: a rerun's losses "
                    "or comm_frac differ")
            # one steady ISP step (its batch, the step, the eval) profiled
            _, batch_fn, eval_fn = data.make(dev, SIM_P, platform, model)
            build.reset_launches()
            prof = _profile_steps(lambda: s.run(batch_fn, SIM_B, 1,
                                                eval_fn=eval_fn), dev)
            step_launches = dict(build.LAUNCHES)
            require(step_launches == {"significance_filter": 2,
                                      "wire_nnz": 2},
                    f"simulator profiled step: launches {step_launches}")
            if prof["device_ms"] <= 0:
                log("sim-profile", device_ms_per_step="not measured",
                    note="the profiler reported no device time")
            else:
                log("sim-profile", job=label, P=SIM_P,
                    wall_ms_per_step=prof["wall_ms"],
                    device_ms_per_step=prof["device_ms"],
                    busy_share=prof["device_ms"] / prof["wall_ms"],
                    device_ops_per_step=prof["ops"],
                    top=json.dumps(prof["top"]))
        del s
        torch.cuda.empty_cache()
    _, launches, s = _sim_job(data, dev, f"mlless_isp_p{SIM_P_MAX}",
                              "MLLESS", "ISP", False, P=SIM_P_MAX)
    count(launches)
    del s
    torch.cuda.empty_cache()
    sim_card_vs_cpu(data, dev)
    return total


# -- phase 6: times ------------------------------------------------------------


def _time(fn, dev, reps: int, cold: bool, flush) -> float:
    """Mean device milliseconds per call, CUDA events around each call."""
    import torch

    fn()  # warm-up (and first-use build)
    total = 0.0
    for _ in range(reps):
        if cold:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def _device_profile(fn, reps: int = 20) -> tuple:
    """Device milliseconds per call from torch.profiler (L2 warm): the
    kernels' own time, without the wrapper's host work that CUDA events
    around an idle card's single call also count; and the device
    operations (kernels, memsets, copies) per call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    # a warm-up step before the counted one: the tracer has been seen to
    # miss the first launches of a window
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.count]
    # each kernel's mean time times its launches per call, so that records
    # the profiler drops do not shrink the result (seen once for B7)
    us = sum(e.self_device_time_total / e.count * max(1, round(e.count / reps))
             for e in events)
    return us / 1e3, sum(e.count for e in events) / reps


def _device_ms(fn, reps: int = 20) -> float:
    """``_device_profile``'s time. A window in which the tracer recorded no
    device operation (seen for ``scaled_dot_product_attention``, and three
    times running for B6 late in a run on a slow host) is taken again, at
    most twice; after a third empty one the calls are timed back to back
    with CUDA events instead (L2 warm, launch gaps included), and a
    ``[profiler]`` line says so."""
    import torch

    for _ in range(3):
        ms, per_call = _device_profile(fn, reps)
        if per_call > 0:
            return ms
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    log("profiler", empty_windows=3, fallback="cuda_events", ms=ms)
    return ms


def _single_launch(name: str, fn) -> tuple:
    """``_device_profile`` of a wrapper that must issue exactly one device
    operation a call (no memset, no second kernel). A record the tracer
    drops reads as fewer than one, so a reading below one is taken again,
    at most twice; more than one fails at once."""
    for attempt in range(3):
        device_ms, per_call = _device_profile(fn)
        if per_call >= 1:
            break
    require(per_call == 1, f"{name}: {per_call} device operations a call, "
            f"not 1 ({attempt + 1} readings)")
    return device_ms, per_call


def profile_step(dev, steady_step_s: float, reps: int = 5) -> None:
    """Device time of one worker step's device work (gradient, optimizer,
    B1, B4 encode, B5 decode of three peers, apply) at ML-10M width, under
    torch.profiler, beside the main path's steady step time: the share of
    a worker's step the card is busy. The wire phase is not replayed."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import optim, tree as tree_lib
    from repro_torch.core.isp import ISPConfig
    from repro_torch.kernels.ops import significance_tree
    from repro_torch.runtime import sharding, workload

    torch.use_deterministic_algorithms(True)  # as the worker runs
    wl = workload.build("pmf", ML10M, device=str(dev))
    opt = optim.make("nesterov", 0.08)
    isp = ISPConfig(v=0.7)
    params, state = wl.params0, opt.init(wl.params0)
    residual = tree_lib.tree_map(torch.zeros_like, params)
    assignment = sharding.tree_assignment(params, 1)
    like = {k: (tuple(x.shape), x.dtype) for k, x in
            zip(tree_lib.tree_keys(params), tree_lib.leaves(params))}

    def step(t):
        nonlocal params, state, residual
        _, grads = wl.grad_fn(params, wl.batch(t))
        upd, state = opt.update(grads, state, params)
        u = tree_lib.tree_map(lambda a: a * 0.25, upd)
        sig, residual = significance_tree(u, params, residual,
                                          isp.threshold(t))
        (meta, parts), = sharding.encode_tree_sharded(
            sig, assignment, 1, scheme="bitmap", impl="cuda")[0]
        blob = b"".join(bytes(p) for p in parts)
        sums = sharding.LeafBuffers(like, dev)
        for _ in range(3):  # three peers' parts
            off = 0
            for m in meta:
                sums.add_encoded(m, blob[off:off + m["nbytes"]], impl="cuda")
                off += m["nbytes"]
        params = tree_lib.tree_map(lambda a, b, c: a + b + c, params, u,
                                   tree_lib.unflatten(
                                       params, [sums[k] for k in like]))
        torch.cuda.synchronize(dev)

    for t in range(1, 4):
        step(t)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(4, 4 + reps):
            step(t)
        wall = (time.perf_counter() - t0) / reps
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    dev_us = sum(e.self_device_time_total for e in kernels) / reps
    launches = sum(e.count for e in kernels) / reps
    torch.use_deterministic_algorithms(False)
    if dev_us <= 0:
        log("step-profile", device_ms_per_step="not measured",
            note="the profiler reported no device time")
        return
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    log("step-profile", device_ms_per_step=dev_us / 1e3,
        device_launches_per_step=launches, host_ms_per_step=wall * 1e3,
        busy_share_of_host_step=dev_us / 1e6 / wall,
        busy_share_of_steady_worker_step=dev_us / 1e6 / steady_step_s,
        kernels=len(kernels),
        top=json.dumps([[e.key, e.self_device_time_total / reps / 1e3]
                        for e in top]))


# the M leaf, the main path's largest; the single-launch check runs at the
# main path's density there (the PMF legs' mean sent fraction sets about 52
# of its elements) and at a denser 4%, which fills every tile's compaction
WIRE_N = 1431340
SINGLE_LAUNCH_DENSITIES = {"main path": 52 / WIRE_N, "4%": 0.04}


def _wire_inputs(dev, density: float) -> dict:
    """B4's input at the M leaf with ``density`` of it set, and B5's (its
    mask, its values, a target)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref

    n = WIRE_N
    rng = np.random.default_rng(11)
    sig_np = np.zeros(n, np.float32)
    hit = rng.random(n) < density
    sig_np[hit] = rng.standard_normal(int(hit.sum())).astype(np.float32)
    sig = torch.from_numpy(sig_np).to(dev)
    nnz = int(hit.sum())
    mask, _, cvals, _, _, _ = ref.wire_pack_ref(sig, torch.float32)
    cvals = cvals[:nnz].contiguous()
    return {"sig": sig, "nnz": nnz, "mask": mask, "cvals": cvals,
            "half": cvals.to(torch.bfloat16),
            "tgt": torch.randn(n, device=dev)}


def _wire_calls(w: dict) -> dict:
    """B4, B5 and B5's decode-only forms on ``_wire_inputs``."""
    import torch

    from repro_torch.kernels import wire_pack

    n = WIRE_N
    return {
        "wire_pack": lambda: wire_pack.wire_pack(w["sig"], torch.float32),
        "wire_unpack_add": lambda: wire_pack.wire_unpack_add(
            w["tgt"], w["mask"], w["cvals"]),
        "wire_unpack float32": lambda: wire_pack.wire_unpack(
            w["mask"], w["cvals"], n, torch.float32),
        "wire_unpack bfloat16": lambda: wire_pack.wire_unpack(
            w["mask"], w["half"], n, torch.bfloat16),
    }


def check_single_launches(dev) -> dict:
    """B4, B5 and B5's decode-only forms must each issue exactly one
    device operation a call (profiler counts: no memset, no second
    kernel), at the M leaf at each of ``SINGLE_LAUNCH_DENSITIES``. Checked
    right after the build, while the process's tracer is fresh: late in a
    long run it has been seen to record nothing at all in three windows
    running. Returns each call's count at the main path's density."""
    out = {}
    for label, density in SINGLE_LAUNCH_DENSITIES.items():
        w = _wire_inputs(dev, density)
        counts = {name: _single_launch(name, fn)[1]
                  for name, fn in _wire_calls(w).items()}
        log("single-launch", n=WIRE_N, density=label, nnz=w["nnz"],
            device_operations_a_call=json.dumps(counts))
        out.setdefault("main path", counts)
    return out["main path"]


def time_kernels(dev, density: float, single: dict) -> dict:
    """Each FaaS kernel and its plain version at the M leaf; ``single`` is
    ``check_single_launches``'s counts, logged beside B4's and B5's
    times."""
    import torch

    from repro_torch.kernels import ref, significance

    n = WIRE_N
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    u, x, r = (t.to(dev) for t in _inputs(n, seed=7))
    w = _wire_inputs(dev, density)
    sig, nnz, mask, cvals, tgt = (w[k] for k in ("sig", "nnz", "mask",
                                                  "cvals", "tgt"))
    calls = _wire_calls(w)
    cases = {
        "significance_filter": (
            lambda: significance.significance_filter(u, x, r, 0.5),
            lambda: ref.significance_ref(u, x, r, 0.5),
            20 * n, 5 * n),
        "wire_pack": (
            calls["wire_pack"],
            lambda: ref.wire_pack_ref(sig, torch.float32),
            # x read; mask, dense values, residual, nnz compacted values
            # and indices, and the count written
            4 * n + (n + 7) // 8 + 4 * n + 4 * n + 8 * nnz + 4, 2 * n),
        "wire_unpack_add": (
            calls["wire_unpack_add"],
            lambda: ref.wire_unpack_add_ref(tgt, mask, cvals),
            # target, mask and nnz values read; the sum written
            4 * n + (n + 7) // 8 + 4 * nnz + 4 * n, n),
    }
    out = {}
    for name, (kern, plain, nbytes, flops) in cases.items():
        t_cold = _time(kern, dev, 50, True, flush)
        t_warm = _time(kern, dev, 50, False, flush)
        p_cold = _time(plain, dev, 20, True, flush)
        bound = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
        bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                    >= flops / FP32_FLOPS else "operations")
        if name == "significance_filter":
            device_ms, per_call = _device_profile(kern)
        else:  # B4, B5: one single-pass launch, counted after the build
            device_ms, per_call = _device_ms(kern), single[name]
        log("kernel-time", kernel=name, n=n, nnz=nnz, ms=t_cold,
            ms_l2warm=t_warm, device_ms_l2warm=device_ms,
            launches_per_call=per_call, plain_ms=p_cold, bound_ms=bound,
            bound_by=bound_by, bytes=nbytes, library_ms=None,
            library_note="no single PyTorch call computes this function")
        out[name] = {"ms": t_cold, "plain_ms": p_cold, "bound_ms": bound,
                     "bound_by": bound_by, "library_ms": None}
    # B5's decode-only form at the same leaf: the codec's decode into a
    # float32 leaf, and into a bf16 leaf from bf16 values
    for label, nbytes in (("float32", (n + 7) // 8 + 4 * nnz + 4 * n),
                          ("bfloat16", (n + 7) // 8 + 2 * nnz + 2 * n)):
        kern = calls[f"wire_unpack {label}"]
        log("kernel-time", kernel="wire_unpack", target=label, n=n, nnz=nnz,
            ms_l2warm=_time(kern, dev, 50, False, flush),
            device_ms_l2warm=_device_ms(kern),
            launches_per_call=single[f"wire_unpack {label}"],
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes)
    out.update(time_adam(dev, flush))
    out.update(time_lm_kernels(dev, flush))
    out.update(time_pod_kernels(dev, flush))
    return out


def time_pod_kernels(dev, flush) -> dict:
    """B6 at the pod path's 75,497,472-element bf16 FF leaf (4 pods of
    (12, 768, 2048)) at the sent density of a pod step, beside one
    ``torch.count_nonzero`` call (its yardstick only); B1 on bf16 at the
    same leaf against the shared (12, 768, 2048) parameters."""
    import torch

    from repro_torch.kernels import ref, significance, wire_pack

    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    n = POD_FF_LEAF
    sent = torch.randn(n, generator=gen, device=dev)
    sent[torch.rand(n, generator=gen, device=dev) >= 0.05] = 0.0
    sent = sent.bfloat16()
    u = (torch.randn(4, n // 4, generator=gen, device=dev) * 1e-3).bfloat16()
    x = (torch.randn(n // 4, generator=gen, device=dev) * 0.03).bfloat16()
    r = (torch.randn(4, n // 4, generator=gen, device=dev) * 1e-3).bfloat16()
    cases = {
        "wire_nnz": (lambda: wire_pack.wire_nnz(sent),
                     lambda: ref.wire_nnz_ref(sent),
                     lambda: torch.count_nonzero(sent),
                     2 * n + 4, n),  # the leaf read, one int32 written
        "significance_filter_bf16": (
            lambda: significance.significance_filter(u, x, r, 0.35),
            lambda: ref.significance_ref(u, x, r, 0.35), None,
            # u, r read, sig, res written (4 pods), x read once
            4 * 2 * n + 2 * (n // 4), 5 * n),
    }
    out = {}
    for name, (kern, plain, library, nbytes, flops) in cases.items():
        t_cold = _time(kern, dev, 50, True, flush)
        t_warm = _time(kern, dev, 50, False, flush)
        p_cold = _time(plain, dev, 10, True, flush)
        lib_ms = (_time(library, dev, 50, True, flush)
                  if library is not None else None)
        bound = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
        bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                    >= flops / FP32_FLOPS else "operations")
        log("kernel-time", kernel=name, n=n, dtype="bfloat16", ms=t_cold,
            ms_l2warm=t_warm, device_ms_l2warm=_device_ms(kern),
            plain_ms=p_cold, bound_ms=bound, bound_by=bound_by, bytes=nbytes,
            library_ms=lib_ms,
            library_device_ms_l2warm=(_device_ms(library)
                                      if library is not None else None),
            library_note=("torch.count_nonzero on the same bf16 leaf"
                          if library is not None else
                          "no single PyTorch call computes this function"))
        out[name] = {"ms": t_cold, "plain_ms": p_cold, "bound_ms": bound,
                     "bound_by": bound_by, "library_ms": lib_ms}
    del sent, u, x, r
    torch.cuda.empty_cache()
    return out


def time_adam(dev, flush) -> dict:
    """B2 and B3 at the PMF M leaf (the largest float32 B2 leaf on a FaaS
    path) and at the LR ``w`` leaf (13), float32; then both at lm-100m's
    (12, 768, 2048) FF leaf in bfloat16 (the bsp and isp steps' largest
    leaves, every operand bfloat16, B3 without weight decay as there). B2's
    row keeps the M-leaf numbers, B3's the bfloat16 FF leaf's. B3's
    yardstick is one ``torch._fused_adamw_`` call on the same tensors (the
    same AdamW step in another rounding order; in place)."""
    import torch

    from repro_torch.kernels import fused_adam, ref

    out = {}
    for n in (13, 1431340):
        p, g, mu, nu, r = (t.to(dev) for t in _adam_inputs((n,), seed=70))
        s_sig = ref.adam_scalars(1e-3, 0.9, 0.999, 1e-8, 3, 0.7, 0.25)
        s_adam = ref.adam_scalars(1e-3, 0.9, 0.999, 1e-8, 3, 0.1)
        lib = [t.clone() for t in (p, g, mu, nu)]
        step_t = torch.tensor(3.0, device=dev)

        def fused_adamw():
            torch._fused_adamw_(
                [lib[0]], [lib[1]], [lib[2]], [lib[3]], [], [step_t],
                amsgrad=False, lr=1e-3, beta1=0.9, beta2=0.999,
                weight_decay=0.1, eps=1e-8, maximize=False)

        cases = {
            "adam_sig_update": (
                lambda: fused_adam.adam_sig_update(
                    p, g, mu, nu, r, 1e-3, 3, 0.7, scale=0.25),
                lambda: ref.adam_sig_ref(p, g, mu, nu, r, s_sig),
                None, 40 * n),  # 5 float32 reads, 5 writes
            "adam_update": (
                lambda: fused_adam.adam_update(p, g, mu, nu, 1e-3, 3,
                                               weight_decay=0.1),
                lambda: ref.adam_ref(p, g, mu, nu, s_adam),
                fused_adamw, 28 * n),  # 4 float32 reads, 3 writes
        }
        for name, (kern, plain, library, nbytes) in cases.items():
            flops = (20 if name == "adam_sig_update" else 16) * n
            t_cold = _time(kern, dev, 50, True, flush)
            t_warm = _time(kern, dev, 50, False, flush)
            p_cold = _time(plain, dev, 20, True, flush)
            lib_ms = (_time(library, dev, 50, True, flush)
                      if library is not None else None)
            bound = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
            bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                        >= flops / FP32_FLOPS else "operations")
            log("kernel-time", kernel=name, n=n, ms=t_cold,
                ms_l2warm=t_warm, device_ms_l2warm=_device_ms(kern),
                library_device_ms_l2warm=(_device_ms(library)
                                          if library is not None else None),
                plain_ms=p_cold, bound_ms=bound,
                bound_by=bound_by, bytes=nbytes, library_ms=lib_ms,
                library_note=("torch._fused_adamw_, float32, in place"
                              if library is not None else
                              "no single PyTorch call computes Adam plus "
                              "the significance split"))
            out[name] = {"ms": t_cold, "plain_ms": p_cold,
                         "bound_ms": bound, "bound_by": bound_by,
                         "library_ms": lib_ms}
    out["adam_update"] = _time_adam_bf16(dev, flush)
    return out


def _time_adam_bf16(dev, flush) -> dict:
    """B3 and B2 at lm-100m's FF leaf, every operand bfloat16, each beside
    its bytes bound (B3 14 B an element, B2 20 B); B3 beside one
    ``torch._fused_adamw_`` call on the same bfloat16 tensors. Returns
    B3's numbers."""
    import torch

    from repro_torch.kernels import fused_adam, ref

    n = FF_LEAF
    p, g, mu, nu, r = (t.to(dev).bfloat16() for t in _adam_inputs((n,),
                                                                  seed=71))
    v_t = 0.7 / 3 ** 0.5
    s_sig = ref.adam_scalars(3e-4, 0.9, 0.999, 1e-8, 3, v_t)
    s_adam = ref.adam_scalars(3e-4, 0.9, 0.999, 1e-8, 3, 0.0)
    lib = [t.clone() for t in (p, g, mu, nu)]
    step_t = torch.tensor(3.0, device=dev)

    def fused_adamw():
        torch._fused_adamw_(
            [lib[0]], [lib[1]], [lib[2]], [lib[3]], [], [step_t],
            amsgrad=False, lr=3e-4, beta1=0.9, beta2=0.999,
            weight_decay=0.0, eps=1e-8, maximize=False)

    cases = {
        "adam_update": (
            lambda: fused_adam.adam_update(p, g, mu, nu, 3e-4, 3),
            lambda: ref.adam_ref(p, g, mu, nu, s_adam),
            fused_adamw, 14 * n, 16 * n),  # 4 bf16 reads, 3 writes
        "adam_sig_update": (
            lambda: fused_adam.adam_sig_update(p, g, mu, nu, r, 3e-4, 3,
                                               v_t),
            lambda: ref.adam_sig_ref(p, g, mu, nu, r, s_sig),
            None, 20 * n, 20 * n),  # 5 bf16 reads, 5 writes
    }
    out = {}
    for name, (kern, plain, library, nbytes, flops) in cases.items():
        t_cold = _time(kern, dev, 50, True, flush)
        t_warm = _time(kern, dev, 50, False, flush)
        p_cold = _time(plain, dev, 10, True, flush)
        lib_ms = (_time(library, dev, 50, True, flush)
                  if library is not None else None)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
        bound = max(t_bytes, t_ops) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        log("kernel-time", kernel=name, n=n, dtype="bfloat16", ms=t_cold,
            ms_l2warm=t_warm, device_ms_l2warm=_device_ms(kern),
            library_device_ms_l2warm=(_device_ms(library)
                                      if library is not None else None),
            plain_ms=p_cold, bound_ms=bound, bound_by=bound_by,
            bytes=nbytes, library_ms=lib_ms,
            library_note=("torch._fused_adamw_, bfloat16 params, grads "
                          "and moments, in place"
                          if library is not None else
                          "no single PyTorch call computes Adam plus the "
                          "significance split"))
        out[name] = {"ms": t_cold, "plain_ms": p_cold, "bound_ms": bound,
                     "bound_by": bound_by, "library_ms": lib_ms}
    del p, g, mu, nu, r, lib
    torch.cuda.empty_cache()
    return out["adam_update"]


def sass_counts(lib) -> dict:
    """``HGMMA`` (``wgmma``) and ``UTMALDG`` (TMA tensor loads) in a
    library's SASS, from ``cuobjdump -sass`` (the toolkit's, else the one
    in Triton's package)."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        import triton

        tool = os.path.join(os.path.dirname(triton.__file__), "backends",
                            "nvidia", "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    return {op: sass.count(op) for op in ("HGMMA", "UTMALDG")}


def _repro_processes() -> list:
    """(pid, command) of every live process but this one that runs the
    port (the timed phases after the pool want the card to themselves)."""
    found = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
            with open(f"/proc/{pid}/stat") as f:
                state = f.read().rsplit(")", 1)[-1].split()[0]
        except OSError:
            continue
        if ("repro_torch" in cmd and state != "Z"
                and int(pid) != os.getpid()):
            found.append((int(pid), cmd[:200]))
    return found


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log("device", kind=json.dumps(kind), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda,
        nvidia_smi=json.dumps(smi))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    libs = build.build_all()
    log("build", seconds=round(time.perf_counter() - t0, 3),
        libs=",".join(p.name for p in libs.values()))
    for name in build.SOURCES:
        s = build.ptxas_summary(name)
        log("ptxas", source=name, registers=s["registers"],
            spill_store_bytes=s["spill_store_bytes"])
        require(s["spill_store_bytes"] == 0, f"{name}: register spills")
    sass = sass_counts(libs["flash_attention"])
    log("sass", source="flash_attention", **sass)
    require(sass["HGMMA"] > 0 and sass["UTMALDG"] > 0,
            "flash_attention: no wgmma or no TMA load in its SASS")

    def done(phase: str) -> None:  # the script's clock against its limit
        log("phase", done=phase, seconds=round(time.perf_counter() - t0, 1))

    def beside_the_pool() -> tuple:
        # bit-exactness, then the in-process trainer's legs (each in its
        # own process, one at a time), beside the invariant pool: all are
        # checked, none timed
        err = check_kernels(dev)
        check_wire_stress(dev)
        check_pod_kernels(dev, err)
        check_reintegration(dev)
        err["flash_attention"] = max(check_flash(dev),
                                     check_attention_grads(dev))
        err["slstm_scan"] = check_slstm(dev)
        done("bit-exactness")
        pods, flats = pod_paths(tmp), flat_paths(tmp)
        done("in-process legs")
        return err, pods, flats

    # alone on the card, while this process's tracer is fresh
    single = check_single_launches(dev)
    done("single launches")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        runs = main_path(tmp)
        done("main path")
        straggler_duel(tmp)
        done("straggler duel")
        chaos = chaos_leg(tmp, runs)
        done("chaos")
        tune = topology_tune_leg(tmp)
        done("topology tune")
        retune, fleets, (err, pods, flats) = invariants(
            tmp, runs, tune, beside_the_pool)
        done("invariants and the other main-path legs")
        log("processes", left_after_the_pool=json.dumps(_repro_processes()))
        served = serve_paths(tmp)
        done("serving")
    pod_in_process(dev)
    flat_in_process(dev)
    done("in-process profiles")
    train_card_vs_cpu(dev)
    card_vs_cpu(dev)
    done("card against CPU")
    profile_serve(dev)
    done("profiles and references")
    sim_launches = simulator_phase(dev, err)
    done("simulator")
    sent = [r["sent_fraction"] for r in runs["pmf_bitmap"][1]["history"]]
    times = time_kernels(dev, density=sum(sent) / len(sent), single=single)
    profile_step(dev, steady(runs["pmf_bitmap"][1], 5)["step_s"])
    done("times")

    # launches: every main-path leg, the chaos leg, both topology legs,
    # every job of both fleet runs and every serving run, each counted from
    # 0 in fresh processes, and the simulator's jobs, each from 0
    launches = {k: 0 for k in KERNELS}
    counted = [c for _, res in runs.values()
               for c in res["kernel_launches_by_worker"].values()]
    for res in (chaos, tune[1], retune):
        counted += list(res["kernel_launches_by_worker"].values())
    for res in fleets.values():
        counted += [c for job in res["jobs"].values()
                    for c in job["kernel_launches_by_worker"].values()]
    counted += [res["kernel_launches"] for res in served.values()]
    counted += [pods[label]["kernel_launches"] for label, _ in POD_LEGS]
    counted += [res["kernel_launches"] for res in flats.values()]
    counted.append(sim_launches)
    for counts in counted:
        for k, v in counts.items():
            launches[k] += v
    for name in KERNELS:
        require(launches[name] > 0, f"{name}: launched on no main path")
    rows = []
    for name, (source, replaces) in KERNELS.items():
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": err[name], "ms": times[name]["ms"],
               "plain_ms": times[name]["plain_ms"],
               "bound_ms": times[name]["bound_ms"],
               "bound_by": times[name]["bound_by"],
               "library_ms": times[name]["library_ms"]}
        rows.append(row)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
