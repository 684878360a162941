#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
   with ``nvcc`` for ``sm_90a``, one compiler process per source, all at once,
   with the binary-MMA rate probe ``benchmarks_torch/bmma_rate.cu`` beside
   them, and runs the probe: the measured ``b1.and.popc`` rate is the peak
   at which every bound prices a binary dot product (the data sheet gives
   none for this card);
3. holds each kernel against its plain PyTorch version at full width:
   * the fused kernel at the paper's H32 width (d = 8192, H = 32, C = 1)
     with K in {2, 16} slots and B = 8192 packets, in gather mode with
     ``meta_words=16`` and actions, in gather mode with ``meta_words=0``,
     and in contiguous mode, at the data plane's shape (gather,
     ``meta_words=16`` with actions, K = 16, B = 2048, ``block_b`` 256),
     and at the megastep window's shape (the same variant over the
     extended bank of K + 8 = 24 slots, B = 8 ticks x 4 queues x 2048 rows
     of one window slab, rows grouped by extended slot);
     ``xnor_matmul`` at B in {1, 256, 8192} (the control-plane replay's
     two shapes and ``inference_only``'s) and, in phase 4 once the slots
     are trained, at ``evaluate``'s B = 2048 (the line names the warps per
     CTA that ``xnor_warps`` picked).  Integers and actions must be equal,
     scores within atol 1e-5 (layer 2 sums in another order);
   * ``banked_xnor_layer1`` at H32, B = 8192, ``block_b`` = 256, on the
     (2K = 32)-slot stack of two K = 16 banks, steered with ``flip_slots``
     by a device scalar ``active`` in {0, 1}: bit-equal to its plain
     version and to the kernel on the single half;
   * ``banked_matmul`` at the banked LM config's width (smollm_360m:
     d_model 960, 2 bank slots), x (8192, 960) by W (2, 960, 960) per half,
     double-banked to 4 slots, ``block_b`` = 128, in f32 (``f32/fma``) and
     bf16 (``bf16/wgmma``; the line names the variant that ran): equal to
     the kernel on the single half bit for bit, and within a tolerance
     derived from the reduction length n = D + 1 and u = 2^-24 (f32:
     |err| <= 2 lambda sqrt(n) u (|x| |W| + |b|) with lambda = 10, the
     probabilistic bound on two f32 sums of n terms, which fails with
     probability at most 2 n exp(-lambda^2 / 2) per element; a control
     shows that the plain version on inputs rounded to TF32 breaks it;
     bf16: one bf16 ulp of the result plus the worst-case f32 bound
     2 gamma(n) (|x| |W| + |b|), gamma(n) = n u / (1 - n u), where
     cancellation makes the f32 sums differ by more than an ulp);
   * ``banked_matmul``'s ``bf16/wgmma.f32out`` as the banked LM head
     (``models.lm.banked_logits``) runs it in ``mamba2-130m-h4.chat-sat``:
     a decode step of 256 rows over 4 slots and a 512-token prefill on one,
     grouped by ``lm.group_head_rows``, D 768, H 50,288, bf16 operands, f32
     out, no bias: within 2 gamma(D) |x| |W| of its plain version (the
     line's ``call_ms`` is the whole head: grouping, kernel, row order and
     vocabulary mask);
   * ``decode_attention`` at ``zamba2-7b-instruct.chat64-sat``'s sites (64
     rows, 32 heads, D 224, L 1536, bf16, lengths from the chat mix) and at
     phase 9 (a)'s f32 smollm-360m decode (8 rows, 5 groups of 3 heads, D
     64, L 512): within 2 (D + L) u of the sums of absolute terms of its
     plain version, plus one bf16 ulp of each probability and of the output
     where those are bf16; ``library_ms`` is ``scaled_dot_product_attention``
     with the valid positions as its mask, a yardstick the port never calls;
   * ``double_buffered_forward`` (a case of the fused kernel) at H32,
     K = 16 + 16, gather mode, ``meta_words=16`` with actions: equal to
     ``fused_forward`` on the front or back bank bit for bit;
4. drives the port's main paths through their entry points, each part with
   the launch counts set to 0 just before it and read just after:
   ``repro_torch.launch.packetpath`` on an 8192-packet K = 2 boundary trace
   (must give wrong_slot = wrong_verdict = 0), ``packet_step`` with the
   fused, grouped and grouped_staged strategies on K = 2 and K = 16 random
   access traces (slots, verdicts and actions equal to the take strategy's),
   ``inference_only`` on 8192 payloads, the single-packet control-plane
   replay; the kernel-level double bank (``ops.banked_matmul``,
   ``banked_xnor_layer1`` and ``double_buffered_forward``, each called, the
   one scalar flipped, and called again: equal to the single halves); the
   data plane (``DataplaneRuntime`` playing ``emergency_phases(16,
   scale=16)`` from seed 0 with 4 queues, batch 2048, ``block_b`` 256,
   ring capacity 16384, the fused strategy, audit and record on, once with
   the double-buffered flip commit and once with the re-stage commit: zero
   wrong verdicts, conservation, identical completion streams); and a
   ``SlotCache`` churn of 32 models over the 16 slots between the same
   bursts (flip and re-stage give identical streams); then the slice of
   trained models, regimes and traces:
   * ``bnn.train_slot_pair(seed=0, epochs=4, samples_per_group=1024)`` on
     the card (the reference's defaults; its wall time is printed), each
     slot's precision, recall and F1 through ``bnn.evaluate`` on the
     ``val`` split (2 capture groups of 1024 rows: ``xnor_matmul`` at
     B = 2048, its own row), held to the paper's Fig. 6 ordering (slot 0's
     recall above slot 1's, slot 1's precision at least slot 0's) and to
     the counts from the plain ``executor.forward(..., backend="ref")``;
   * ``repro_torch.launch.packetpath --train`` on an 8192-packet boundary
     trace with the fused strategy and ``--stream`` (its own training at
     packetpath's defaults): wrong_slot = wrong_verdict = 0;
   * every regime of ``REGIME_NAMES`` at one host, 16 slots, 4 queues and
     ``scale=16`` (the synthetic file corpus for ``file-replay``, the fault
     plan armed where the regime has one), played through the emergency
     runtime's shape (batch 2048, ``block_b`` 256, ring 16384, fused, audit
     and record on) and recorded by ``record()`` into a v2 trace under
     ``build/traces/``, then loaded and replayed on a fresh
     ``make_runtime``: ok, digest equal, zero wrong verdicts, conservation
     and continuity; one line per regime gives its kpps, fused launches,
     epochs, rolled-back epochs and trace bytes;
   * the bounded epoch log: ``slot-thrash`` (an epoch every storm tick)
     with ``log_capacity=4`` and a spill file under ``build/traces/``,
     read back by ``load_epoch_spill``;
   * the megastep: the emergency scenario on the same runtime shape at
     ``megastep_ticks`` 1, 8 and 64 (``benchmarks_torch/fig8m_megastep.py``'s
     ``sweep``, best of 3): equal completion-stream digests, zero wrong
     verdicts, conservation, the engine on for 8 and 64, kpps per phase;
     then the recorded ``slot-thrash`` trace replayed on
     ``make_runtime(trace, megastep_ticks=8)`` (epochs inside windows) with
     the recorded digest.  The window's fused launches count under the
     window's own row (``fused_forward.launches`` key ``.../window``);
   * the mesh (``run_mesh_phase``), every shard on the card, the runtime's
     shape (4 queues per host, batch 2048, ``block_b`` 256, ring 16384,
     fused, audit on) on the emergency scenario: (a) ``MeshDataplane(
     hosts=1)`` against the flip-commit ``DataplaneRuntime`` above, record
     on, mismatch 0; (b) hosts 2 and 4 beside one host of 8 and 16 queues
     (the same global queue count), kpps per phase, conservation per host
     and in total, zero wrong verdicts, every applied epoch's
     ``host_ticks`` equal; (c) the four regimes that change shape at 2
     hosts (``MESH_REGIMES``, ``scale=16``, record on) recorded to
     ``build/traces/mesh-*.bswt`` and replayed from the file on
     ``make_runtime``'s mesh (digest, zero wrong verdicts, conservation,
     continuity; stranded packets, degraded commits, failover and restore
     epochs printed); (d) 2 hosts in megastep mode at windows 1 and 8 with
     equal digests, and one device-to-host copy per shard per window of
     steady traffic; (e) ``fig10_mesh.epoch_broadcast``'s ``apply_us`` per
     command kind, 2 hosts against 1; (f) ``fanout="shard_map"`` over the
     visible devices equal to ``vmap``.  The mesh's sequential launches
     count under the B = 2048 row, its windows under the window's row, and
     the stacked fan-out's (Q x 2048 = 8192 rows) under the K = 16 row;
   Every kernel must have been launched in its part, and the LM-width bf16
   ``banked_matmul`` through the ``bf16/wgmma`` kernel; the data plane's
   fused launches (the scenario, the regimes, their replays and the
   bounded log) count under the B = 2048 case;
5. profiles one fused ``packet_step`` (K = 2, B = 8192) and one data-plane
   tick at the flash-crowd size (the scenario's runtime, batch 2048 per
   queue, fed one 8192-packet burst per tick): device time by operator and
   the device's idle share, and for the tick the host time of the arrival
   edge apart from the tick's and the packets served per tick; splits that
   sequential tick's host time by the runtime's own spans; and profiles
   one 8-tick megastep window beside 8 sequential ticks at the same
   traffic: device time by operator, idle share, device-to-host copies per
   window (one, the drain's, or it fails), the host time of staging against
   the flush and the drain, and the window run once with CUDA's sync debug
   mode set to error (it fails on any host synchronisation before the
   drain); then (g) one flash-crowd mesh tick at 2 hosts (audit and record
   off): wall, device busy, idle share and the top device operations;
6. runs each paper-figure benchmark of ``benchmarks_torch`` once at its
   reference shapes (``fig4_runtime``, ``fig5_scaling``,
   ``fig6_slot_behavior``, ``fig7_fused``, ``table4_continuity``,
   ``table5_controlplane``; ``PAPER_FIGURES``) and prints every number it
   reports as one ``paper_figures`` JSON object;
7. drives observability, checkpoints and deployment
   (``run_obs_deploy_phase``) on the emergency runtime's shape
   (``emergency_phases(16, scale=16)`` from seed 0 rendered over
   ``deploy.labeled_pool(512, 0)``'s payloads, 4 queues, batch 2048,
   ``block_b`` 256, ring 16384, fused, audit on, K = 16), each part with the
   launch counts set to 0 around it: (a) the scenario played plain, with
   ``obs.attach`` and an ``AnomalyDetector`` polled after every tick, and
   with a ``PacketSampler`` alone (5 alternating runs each, each after a
   garbage collection): the deltas sum to ``telemetry.snapshot()``, the
   stream conserves its events, the detector names ``emergency``; kpps and
   overhead by the medians and the best runs, deltas per tick, the host µs
   of ``emit_delta`` and of the detector's poll per tick; (b) ``ObsServer`` over that
   run on 127.0.0.1, port 0 (a failure to bind fails the script):
   ``/healthz``, ``/metrics`` totals equal to the snapshot, ``/epochs``
   equal to ``epoch_log_doc``, ``/anomaly`` naming ``emergency``, ``/`` the
   dashboard, 404 elsewhere; (c) one ``ScheduledRollout`` that must promote
   and one with ``corrupt=True`` that must roll back, each on a
   ``DeployDriver`` with a ``PacketSampler`` (24 STE steps on the card,
   8-tick bake): exactly one terminal decision of the expected kind, every
   decision's epoch applied, zero wrong verdicts, conservation and
   continuity; fine-tune ms, canary start to decision ms; (d) the promoted trainer's checkpoint (under
   ``build/checkpoints/``) restored on the card bit-equal, and its packed
   weights' bake-window error equal to the promoted weights'; the codec;
   (e) a window-8 megastep with a sampler (``max_pending=3``) and a
   capacity-4 stream: the backlog stays at most 3 and the overflow is
   conserved.  ``xnor_matmul``'s launches in (c) and (d) count under a row
   per batch size, checked and timed as the others; then
   ``benchmarks_torch/fig13_obs.py`` and ``fig14_deploy.py`` run once at
   the reference's shapes (``obs_deploy_figures``);
8. drives the data-plane CLI (``run_cli_phase``), ``repro_torch.launch.
   dataplane.main`` in this process (``SystemExit`` caught, output
   captured, no ``--device``: the card is its default) at the paper's H32
   width and the data plane's shape, ``--slots 16 --queues 4 --batch 2048
   --ring-capacity 16384 --scale 16``, each run with the launch counts set
   to 0 around it, ``--seed 0`` unless said: (a) ``--audit`` recorded to
   ``build/cli/a.bswt``: kpps per phase, conservation, zero wrong
   verdicts, continuity; (b) the same at
   ``--megastep-ticks 8``, its trace's digest equal to (a)'s; (c) ``--hosts
   2 --queues 2 --scenario crash-mid-commit --lease-ticks 4 --audit``:
   every host conserves, a degraded commit is tagged; (d) ``--trace replay``
   of (a)'s file with ``--audit``: ``digest_ok``; (e) ``--deploy-demo
   promote`` and ``rollback`` at phase 7's warm-up 8, bake 8 and 24 steps,
   ``--seed 1`` (at seed 0 the port's random slot 0 errs on more of the
   bake window than the negated fine-tune less the canary's tolerance, so
   ``rollback`` promotes): exactly the named decision, zero wrong
   verdicts; (f) ``--slot-cache 32 --prefetch --audit``: the cache's hits,
   misses and prefetch hits printed, zero wrong verdicts; (g) ``--observe 0 --observe-linger 2
   --epoch-log-json``: one GET of ``/healthz`` while the server lingers, no
   server thread left after, the epoch log parses; (h) ``--fanout vmap``
   and ``--fanout shard_map`` (one group on one card) recorded: digests
   equal to each other and to (a)'s.  The CLI keeps the runtime's default
   ``block_b`` 32, so its fused launches count under three rows checked in
   phase 3 at that block size (one queue's 2048 rows; the four queues
   stacked, 8192 rows, for (h); the window slab for (b)), and
   ``xnor_matmul``'s (the rollouts') under a row per batch size.  Then
   ``python -m repro_torch.launch.dataplane --queues 4 --audit`` in a
   subprocess (``PYTHONPATH=src``, the built kernels reused; seconds from
   its start to its ``runtime:`` line), and ``benchmarks_torch``'s
   ``fig8_dataplane``, ``fig9_control``, ``fig11_workloads`` and
   ``fig15_swap`` once each (``cli_figures``);
9. serves LMs on the card (``run_lm_serve_phase``), each part with the
   launch counts set to 0 around it and failing if any kernel of the port
   was launched but (h)'s head and decode attention, which (a), (b), (c),
   (e) and (f) require on their cache dtype's kernel alone (counted into
   phase 3's rows) and (d) and (h) must not launch: (a) smollm-360m at its published
   width and depth in f32 (random weights, ``api.init`` seed 0) through
   ``ServeEngine(max_batch=8, max_seq=512)``, 8 requests of 4-48 prompt
   tokens and 8 new tokens, each output held against the card's own
   no-cache greedy decode through ``api.apply`` (a token may differ only
   where the greedy top-2 logit margin is under ``margin_bound``, derived
   from f32's unit roundoff and the depth); (e) on the same weights, 10
   decode steps with the int8 KV cache against the full-precision one:
   relative logit error under 0.05, the cache bytes of each, the int8
   cache's steps launching no decode attention and the f32 cache's one a
   layer; (c) the
   adapter bank (``bank_mode="adapter"``, 2 slots, slot 1's ``b`` drawn
   from a generator seeded 7): one prompt on slots 0 and 1 gives two
   outputs, each its slot's greedy decode; (b) the published bf16 model on
   (a)'s requests: tokens/s of a second run, prefill ms per bucket, decode
   ms per tick at batch 8, peak device memory, and ``profile_step`` of a
   decode tick; (d) mamba2-130m at full width and depth in f32, with two
   prompts past one 256-token SSD chunk, against greedy as in (a); (f)
   every other arch of ``ARCH_IDS`` (but the encoder-decoder) at
   ``reduced()`` in f32 (MoE at capacity factor 16), one engine run each
   against greedy; (h) mamba2-130m in bf16 with a bank of 4 output heads
   through ``ServeEngine(max_batch=256, max_seq=1536)``, 12 requests of
   20, 100 and 400 prompt tokens: ``bf16/wgmma.f32out`` launched once a
   decode step and once a prefill (as the engine's spans count them), each
   counted into phase 3's head rows; (g) ``python -m repro_torch.launch.serve`` in three
   subprocesses at once: its defaults and ``--arch mamba2-130m`` print the
   ``served`` and ``latency`` lines and exit 0, ``--arch
   seamless-m4t-medium`` exits non-zero, as the reference's does;
10. trains LMs on the card (``run_lm_train_phase``), each part with the
   launch counts set to 0 around it and failing if any BNN kernel was
   launched (the training path reaches none): (a) smollm-360m at its
   published width, depth and dtype (bf16, the f32 master copy, remat
   "full"; ``init_train_state`` seed 0), ``SyntheticTokens`` (structured,
   seed 0) at global batch 8 x sequence 512, 3 untimed and 10 timed steps
   of ``make_train_step``: every loss finite and the last below the first;
   step ms (median), tokens/s, the share of the bf16 dense peak (6 x
   ``active_param_count()`` x tokens per step / step s / 989 TFLOP/s),
   peak device memory, and ``profile_step`` of one step (idle share);
   (b) one step with remat "full" and one with "none" from (a)'s state on
   one batch: loss and grad norm within 2**-8 relative, params (master
   copies) within 2 lr and at most one element in a hundred beyond lr / 10,
   the peak memory of each; (c) one f32 step of every arch at ``reduced()``
   from the same weights on the card and on the CPU: loss and grad norm
   within 1e-5 relative, params as in (b) (the CPU tests' tolerances);
   (d) mamba2-130m at full width and depth in bf16, 4 steps: finite
   losses, step ms; (e) smollm-360m reduced (1 layer, f32) through
   ``Trainer``: 4 steps, preempted by the flag file, restored and run to 8,
   within 1e-5 of 8 uninterrupted steps; meanwhile ``python -m
   repro_torch.launch.train`` in two subprocesses, at its defaults and with
   ``--compress-gradients --microbatches 2``: both exit 0 after 100 steps.
11. runs the distribution and tooling layer (``run_lm_dist_phase``), each
   part with the launch counts set to 0 around it and failing if any BNN
   kernel was launched: (a) a one-rank NCCL group and ``make_host_mesh()``'s
   (1, 1) CUDA mesh; smollm-360m as in phase 10 (a) (bf16, master copy,
   remat "full", seed 0, ``SyntheticTokens`` 8 x 512), its state sharded by
   ``dryrun.rules_for`` and distributed as DTensors, 3 steps under
   ``implicit_replication`` beside the same 3 steps unsharded: losses, grad
   norms, params, master copies and moments bit-equal; both medians of step
   ms over steps 2 and 3 (the first fills DTensor's caches); (b)
   ``compressed_psum`` over the group on every gradient leaf of one
   step, bit-equal to ``quantize_dequantize`` (one rank: the sum is the
   codes), ms per step; (c) ``roofline.count_step`` on one unsharded step
   (not a timed one): dot FLOPs, bytes, model FLOPs, the useful ratio, the
   H100 terms, and (a)'s unsharded step ms over the bound; (d) on the host,
   ``python -m repro_torch.launch.dryrun`` on ``DRYRUN_CELLS`` (smollm-360m
   ``train_4k``, ``prefill_32k``, ``decode_32k`` on both meshes, arctic-480b
   ``prefill_32k`` and glm4-9b ``decode_32k`` single, and the repaired
   layouts' single-mesh cells: mamba2-130m, zamba2-7b and llava-next-34b
   ``prefill_32k``, seamless-m4t-medium ``decode_32k``, h2o-danube-3-4b
   ``long_500k``, olmoe-1b-7b and arctic-480b ``train_4k``; mamba2-130m
   ``train_4k``, whose 24 heads 16 ranks do not divide, and glm4-9b
   ``train_4k``, under FSDP, its attention held to its share of the
   reference's from both sides), one process per cell, into
   ``build/dryrun_torch``, every cell ``ok`` and in the aim against the
   reference's table (``dryrun.AIM``, 0.95-1.05; one ``lm_dist d ...
   against the reference`` line each); ``benchmarks_torch/
   hillclimb.py`` (started once its three baselines are written),
   ``roofline.py`` and ``report.py`` over them, each exiting 0; (e) ``python
   -m repro_torch.launch.doclint`` clean.

Lines printed before the last: the probe's binary-MMA rates (one JSON
object, ``binary_mma_rates``), the data plane's kpps per phase, the swap
epoch's ``apply_us`` committed by flip and by re-stage, the profiles, and
one JSON object listing every kernel with its launches (summed over the
parts of phase 4 that ran it), error, time, plain-version time, bound and
library time (and, for ``banked_matmul``, its ``variant``; for
``xnor_matmul``, its ``warps``), and a ``launch_floor_ms`` line: the
device time of one PyTorch kernel on 128 bytes, taken as the kernels'
times are, against which the B = 1 row reads; the megastep sweep's kpps
per phase and window, the tick split and the window profile; the mesh's
lines (a to f), ``mesh_epoch_apply_us``, ``mesh_tick_profile`` and
``paper_figures``; phase 7's ``obs_stream``, ``obs_server``, ``deploy``,
``checkpoint``, ``megastep_obs_deploy`` and ``obs_deploy_figures``; phase
8's ``cli``, ``cli_subprocess`` and ``cli_figures``; phase 9's
``lm_serve ...`` lines and its ``lm_serve`` object; phase 10's
``lm_train ...`` lines and its ``lm_train`` object; phase 11's ``lm_dist
...`` lines and its ``lm_dist`` object.  The last line is
``{"ok": true, "device": {...}}``.
A kernel's ``ms`` is its device time, from CUDA events around calls queued
behind a busy-wait kernel; ``library_ms`` is taken the same way;
``call_ms`` (the wrapper call, host overhead included) and ``plain_ms`` are
CUDA-event medians over back-to-back calls.  Inputs stay in the 50 MB L2
cache between calls where they fit.  ``xnor_matmul``'s ``library_ms`` is
``torch._int_mm`` on the +-1 int8 unpacked operands ((B, d) x (d, H) ->
int32, equal to the kernel's output, which is checked; unpacked outside
the timed window), where it takes the shape: it needs more than 16 rows,
so the B = 1 row records none.  ``banked_xnor_layer1``'s is
``torch.baddbmm`` of the gathered biases, the +-1 rows and the slots' +-1
weights as bf16 with an f32 output, checked equal to the kernel's
output.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of its bytes over the memory rate and its operations over
# the peak rate of their type.  Binary dot products have no published rate:
# they are priced at the b1 MMA rate the probe measures in the same run.
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_OPS_PER_S = 989e12
FP32_OPS_PER_S = 67e12
N, BLOCK_B = 8192, 256
ATOL, RTOL = 1e-5, 1e-6
K_DB = 16                          # slots in each half of the double bank
LM_D, LM_SLOTS, LM_BLOCK_B = 960, 2, 128   # smollm_360m: d_model, bank_slots
DP_QUEUES, DP_BATCH, DP_RING, DP_SCALE = 4, 2048, 16384, 16
MM_VARIANT = {"float32": "f32/fma", "bfloat16": "bf16/wgmma"}  # at the LM width
CHURN_MODELS = 32
TRAIN_EPOCHS, TRAIN_SAMPLES = 4, 1024   # bnn.train_slot_pair's defaults
VAL_SAMPLES = 1024                 # per capture group of the val split
LOG_CAPACITY = 4                   # the bounded epoch log's in-memory records
WINDOWS = (1, 8, 64)               # megastep_ticks of the fig8m sweep
WINDOW_TICKS = 8                   # the profiled window and the phase-3 slab
CP_PACKETS = 256                   # the control-plane replay's boundary trace
XNOR_ROWS = (1, CP_PACKETS, N)     # xnor_matmul's row counts on the main paths
INT_MM_MIN_ROWS = 16               # torch._int_mm takes more rows than this
F32_UNIT_ROUNDOFF = 2.0 ** -24
PROB_LAMBDA = 10.0                 # confidence of the probabilistic f32 bound


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def kernel_device_ms(call, iters: int = 20, repeats: int = 5) -> float:
    """Device time per call of ``call``, which launches its kernels and no
    host synchronisation: the median over ``repeats`` of CUDA events around
    ``iters`` calls.  A busy-wait kernel holds the stream while the host
    queues the calls, so the events see the kernels back to back and none
    of the wrapper's host time.  Where the busy-wait ended before the host
    had queued them all, it is doubled and that repeat is made again."""
    import numpy as np
    import torch

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    cycles, times = 1 << 24, []
    while len(times) < repeats:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            call()
        end.record()
        queued_ahead = not start.query()
        end.synchronize()
        if queued_ahead:
            times.append(start.elapsed_time(end) / iters)
        elif cycles >= 1 << 32:
            fail("the host could not queue the calls ahead of the device")
        else:
            cycles *= 2
    return float(np.median(times))


def warm_up_clocks(dev) -> None:
    """Bring the card's clocks up from idle: one second of matrix products."""
    import torch

    a = torch.randn(4096, 4096, device=dev)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:
        a @ a
        torch.cuda.synchronize()


def profile_step(step, iters: int = 20, top: int = 8) -> dict:
    """Where one call of ``step`` spends device time: each device activity
    (kernel, copy, memset) from ``torch.profiler``, and the device's idle
    share of the step's wall time, the wall time taken without the
    profiler (its host overhead would inflate the idle share)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6 / iters
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
    acts = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in acts) / iters
    return {
        "wall_us_per_step": wall_us,
        "device_busy_us_per_step": busy_us,
        "device_idle_share": 1 - busy_us / wall_us,
        "dtoh_copies_per_step": sum(e.count for e in acts if "DtoH" in e.key) / iters,
        "htod_copies_per_step": sum(e.count for e in acts if "HtoD" in e.key) / iters,
        "top_device_activities": [
            {"name": e.key[:90], "calls_per_step": e.count / iters,
             "device_us_per_step": e.self_device_time_total / iters}
            for e in acts[:top]],
    }


MESH_HOSTS = (2, 4)                # hosts of the mesh sweep, DP_QUEUES each
MESH_PROFILE_HOSTS = 2
MESH_REGIMES = ("cascading-failover", "chaos-host-failover", "barrier-straggler",
                "crash-mid-commit")
PAPER_FIGURES = ("fig4_runtime", "fig5_scaling", "fig6_slot_behavior", "fig7_fused",
                 "table4_continuity", "table5_controlplane")


def run_mesh_phase(*, counted, entries, dev, bank, scenario, single, trace_dir,
                   dp_row, win_row, win_key, out) -> dict:
    """The mesh's part of phase 4 (a to f of the module docstring), each run
    with the launch counts set to 0 around it; its fused launches count
    under the case rows of their shapes.  Fills ``out`` and returns a
    factory of the phase's meshes (``"new"``) for the profile."""
    import numpy as np
    from benchmarks_torch import fig10_mesh
    from repro_torch.dataplane import (DataplaneRuntime, FaultInjector, MeshDataplane,
                                       play, render, workloads)

    seq_key = "gather/meta16/actions"
    launched = out.setdefault("fused_launches", {})

    def add(row, n):
        """Count ``n`` of the mesh's launches under the kernel line's ``row``."""
        entries[row]["launches"] += n
        launched[row] = launched.get(row, 0) + n

    def new(hosts, qph=DP_QUEUES, **kw):
        kw = dict(dict(num_queues=qph, batch=DP_BATCH, block_b=BLOCK_B,
                       ring_capacity=DP_RING, strategy="fused", audit=True), **kw)
        return MeshDataplane(bank, hosts=hosts, device=dev, **kw)

    def check(label, mesh):
        aud, cont = mesh.audit_conservation(), mesh.control.continuity_audit()
        t = aud["totals"]
        gap = (t["offered"] - t["completed"] - t["dropped"] - t["occupancy"]
               - t["in_flight"])
        if not (aud["ok"] and all(h["ok"] for h in aud.get("per_host", ()))
                and gap == 0 and aud["wrong_verdict"] == 0 and cont["ok"]):
            fail(f"mesh {label}: conservation {aud['ok']} (gap {gap}), wrong_verdict "
                 f"{aud['wrong_verdict']}, continuity {cont['ok']}")
        if isinstance(mesh, MeshDataplane) and not mesh.health.ever_missed:
            stamps = [b["host_ticks"] for b in mesh.barrier_log]
            if any(len(set(s)) != 1 for s in stamps):
                fail(f"mesh {label}: unequal barrier stamps {stamps}")
        return aud

    def played(mesh_fn):
        def run():
            mesh = mesh_fn()
            t0 = time.perf_counter()
            reports = play(mesh, scenario)
            return mesh, reports, time.perf_counter() - t0
        return run

    # a. one host against the single-host runtime (record and audit on)
    (m1, _, _), n = counted(played(lambda: new(1, record=True)))
    mismatch = sum((m1.completed_seq != single["streams"][0],
                    m1.completed_verdicts != single["streams"][1],
                    m1.completed_slots != single["streams"][2],
                    m1.dropped_seq != single["dropped"],
                    not np.array_equal(m1.reta, single["reta"])))
    check("hosts=1", m1)
    add(dp_row, n["fused"].get(seq_key, 0))
    print(f"mesh hosts=1 against DataplaneRuntime: mismatch={mismatch}", flush=True)
    if mismatch:
        fail(f"mesh hosts=1: {mismatch} streams differ from DataplaneRuntime")
    out["hosts1_mismatch"] = mismatch

    # b. hosts 2 and 4 at DP_QUEUES queues each, beside one host with the
    # same global queue count
    sweep = {}
    for hosts in MESH_HOSTS:
        for h, q in ((1, hosts * DP_QUEUES), (hosts, DP_QUEUES)):
            (mesh, reports, dt), n = counted(played(lambda: new(h, q)))
            aud = check(f"h{h}q{q}", mesh)
            launches = n["fused"].get(seq_key, 0)
            if launches < 1:
                fail(f"mesh h{h}q{q}: the fused kernel was not launched")
            add(dp_row, launches)
            applied = [r for r in mesh.control.log if r.applied]
            if any(len(set(r.host_ticks)) != 1 for r in applied):
                fail(f"mesh h{h}q{q}: an applied epoch's host_ticks differ")
            sweep[f"h{h}q{q}"] = {
                "kpps": aud["totals"]["completed"] / dt / 1e3,
                "phase_kpps": {r["phase"]: r["kpps"] for r in reports},
                "fused_launches": launches, "epochs": len(applied)}
            print(f"mesh hosts={h} queues/host={q}: kpps="
                  f"{sweep[f'h{h}q{q}']['kpps']:.1f} per phase "
                  + " ".join(f"{r['phase']}={r['kpps']:.1f}" for r in reports)
                  + f"; fused launches={launches}; totals={aud['totals']}", flush=True)
    out["sweep"] = sweep

    # c. the four mesh regimes at 2 hosts: recorded, replayed from the file
    regimes = {}
    for name in MESH_REGIMES:
        wl = workloads.make_workload(name, num_slots=K_DB, num_queues=DP_QUEUES,
                                     scale=DP_SCALE, hosts=2)
        rendered = render(list(wl.phases), num_slots=K_DB, seed=0,
                          num_queues=2 * DP_QUEUES)
        path = os.path.join(trace_dir, f"mesh-{name}.bswt")

        def record_run():
            injector = FaultInjector(wl.fault_plan) if wl.fault_plan else None
            mesh = new(2, record=True, fault_injector=injector)
            rec = workloads.record(mesh, path=path)
            t0 = time.perf_counter()
            reports = play(rec, rendered)
            dt = time.perf_counter() - t0
            return mesh, reports, dt, rec.finish(name=name, seed=0)

        (mesh, reports, dt, st), n = counted(record_run)
        check(f"regime {name}", mesh)
        loaded = workloads.load(st.path)

        def replay_run():
            rt2 = workloads.make_runtime(loaded, audit=True, block_b=BLOCK_B,
                                         device=dev)
            return rt2, workloads.replay(loaded, rt2)

        (rt2, rep), n2 = counted(replay_run)
        if not (isinstance(rt2, MeshDataplane) and rep["ok"] and rep["digest_ok"]):
            fail(f"mesh regime {name}: replay {rep['mismatches']}, digest_ok "
                 f"{rep['digest_ok']}, runtime {type(rt2).__name__}")
        aud2 = check(f"regime {name} replay", rt2)
        launches = n["fused"].get(seq_key, 0) + n2["fused"].get(seq_key, 0)
        if launches < 2:
            fail(f"mesh regime {name}: {launches} fused launches")
        add(dp_row, launches)
        completed = sum(r["completed"] for r in reports)
        regimes[name] = {
            "kpps": completed / dt / 1e3, "stranded": aud2["stranded"]["packets"],
            "stranded_hosts": aud2["stranded"]["hosts"],
            "degraded_commits": rt2.telemetry.degraded_commits,
            "failover_epochs": len(rt2.failover_epochs),
            "restore_epochs": len(rt2.restore_epochs), "trace_bytes": st.nbytes}
        print(f"mesh regime {name}: kpps={regimes[name]['kpps']:.1f} "
              f"stranded={regimes[name]['stranded']} "
              f"degraded_commits={regimes[name]['degraded_commits']} "
              f"failover_epochs={regimes[name]['failover_epochs']} "
              f"restore_epochs={regimes[name]['restore_epochs']} "
              f"trace_bytes={st.nbytes} replay_digest_ok={rep['digest_ok']}", flush=True)
    out["regimes"] = regimes

    # d. 2 hosts in megastep mode, windows 1 and 8: equal digests, and one
    # device-to-host copy per shard per window
    digests = {}
    for w in (1, WINDOW_TICKS):
        (mesh, _, _), n = counted(played(lambda: new(2, record=True, megastep_ticks=w)))
        check(f"megastep window={w}", mesh)
        if (w > 1) != all(s._mega is not None for s in mesh.shards):
            fail(f"mesh megastep window={w}: engines {[s._mega for s in mesh.shards]}")
        digests[w] = workloads.digest(mesh)["sha256"]
        if w > 1:
            if n["fused"].get(win_key, 0) < 1:
                fail(f"mesh megastep: no window launch ({n['fused']})")
            add(win_row, n["fused"][win_key])
        add(dp_row, n["fused"].get(seq_key, 0))
    if len(set(digests.values())) != 1:
        fail(f"mesh megastep: digests differ across windows {digests}")
    mw = new(2, audit=False, megastep_ticks=WINDOW_TICKS)
    steady = scenario.bursts[0][0]

    def window():
        for _ in range(WINDOW_TICKS):
            mw.dispatch(steady)
            mw.tick()

    wprof = profile_step(window, iters=5)
    if wprof["dtoh_copies_per_step"] != 2:
        fail(f"mesh megastep: {wprof['dtoh_copies_per_step']} device-to-host copies "
             "per window over 2 shards, not one per shard")
    out["megastep"] = {"digest_equal": True, "window_profile": wprof}
    print(f"mesh megastep hosts=2 windows 1 and {WINDOW_TICKS}: digests equal; "
          f"{wprof['dtoh_copies_per_step']} device-to-host copies per window",
          flush=True)

    # e. fig10's epoch broadcast: apply_us per command kind, 2 hosts against 1
    out["epoch_apply_us"] = fig10_mesh.epoch_broadcast(
        bank, dev, num_queues=DP_QUEUES, batch=DP_BATCH, block_b=BLOCK_B,
        ring_capacity=DP_RING)
    print(json.dumps({"mesh_epoch_apply_us": out["epoch_apply_us"]}), flush=True)

    # f. the shard_map fan-out on the card's devices equals vmap
    streams = {}
    for fanout in ("vmap", "shard_map"):
        def fan_run():
            rt = DataplaneRuntime(bank, num_queues=DP_QUEUES, batch=DP_BATCH,
                                  block_b=BLOCK_B, ring_capacity=DP_RING,
                                  strategy="fused", audit=True, record=True,
                                  fanout=fanout, device=dev)
            play(rt, scenario)
            return rt
        rt, n = counted(fan_run)
        check(f"fanout={fanout}", rt)
        streams[fanout] = (rt.completed_seq, rt.completed_verdicts,
                           rt.completed_slots, rt.dropped_seq)
        launches = n["fused"].get(seq_key, 0)
        if launches < 1:
            fail(f"fanout={fanout}: the fused kernel was not launched")
        add(f"{seq_key}/K{K_DB}", launches)
    if streams["vmap"] != streams["shard_map"]:
        fail("fanout=shard_map differs from vmap")
    out["shard_map_equals_vmap"] = True
    print(f"fanout=shard_map over {len(rt._groups)} device(s) equals vmap", flush=True)
    print(json.dumps({"mesh_fused_launches": launched}), flush=True)
    return {"new": new}


def run_paper_figures(dev, names=PAPER_FIGURES) -> dict:
    """Each benchmark of ``benchmarks_torch`` in ``names`` run once at its
    reference shapes; every number it reports, by name."""
    import importlib

    numbers = {}
    for name in names:
        mod = importlib.import_module(f"benchmarks_torch.{name}")
        t0 = time.perf_counter()
        mod.run(dev, lambda key, value, note="": numbers.__setitem__(key, value))
        numbers[f"{name}.wall_s"] = time.perf_counter() - t0
    return numbers


OBS_POOL_SAMPLES = 512            # labeled_pool samples per capture group
OBS_STREAM_CAPACITY = 1 << 16
OBS_REPEATS = 5                    # alternating plain / observed / sampled runs
DEPLOY_WARMUP, DEPLOY_BAKE, DEPLOY_STEPS = 8, 8, 24
MEGA_MAX_PENDING, MEGA_STREAM_CAPACITY = 3, 4
BENCH_FIGURES = ("fig13_obs", "fig14_deploy")


def stream_sums(rt, events) -> list[str]:
    """Where the delta events do not sum to ``rt.telemetry.snapshot()``."""
    from repro_torch.dataplane import telemetry

    snap = rt.telemetry.snapshot()
    done, drop, slots, ev = {}, {}, {}, {}
    for e in events:
        if e.get("kind") != "delta":
            continue
        for q in e["queues"]:
            i = q["queue"]
            done[i] = done.get(i, 0) + q["completed"]
            drop[i] = drop.get(i, 0) + q["dropped"]
            slots[i] = [a + b for a, b in zip(slots.get(i, [0] * len(q["per_slot"])),
                                              q["per_slot"])]
        for name, d in e["events"].items():
            ev[name] = ev.get(name, 0) + d
    bad = []
    for q in snap["queues"]:
        i = q["queue"]
        if (done.get(i, 0), drop.get(i, 0)) != (q["completed"], q["dropped"]):
            bad.append(f"queue {i} counts")
        if q["completed"] and slots.get(i) != list(q["per_slot_total"]):
            bad.append(f"queue {i} slot mix")
    bad += [name for name in telemetry.EVENT_COUNTERS if ev.get(name, 0) != snap[name]]
    return bad


class _EachTick:
    """A deploy pilot that calls ``fn`` after every tick (a detector's poll,
    a watch on the sampler's backlog)."""

    def __init__(self, fn):
        self.step = fn

    def flush(self) -> None:
        pass


def run_obs_deploy_phase(*, counted, entries, dev, bank, dp_row, win_row, win_key,
                         check_xnor, out) -> None:
    """Phase 7 (a to e of the module docstring) on the emergency runtime's
    shape, each part with the launch counts set to 0 around it; the fused
    launches count under the data plane's B = DP_BATCH row (the window's
    under the window's row) and ``xnor_matmul``'s under a row per batch
    size, which ``check_xnor`` adds for sizes no earlier part ran."""
    import gc
    import shutil
    import urllib.error
    import urllib.request

    import numpy as np
    import torch
    from repro_torch import codec, deploy, obs
    from repro_torch.checkpoint import store
    from repro_torch.core import packet as pkt
    from repro_torch.dataplane import DataplaneRuntime, emergency_phases, play, render
    from repro_torch.obs.server import ObsServer, _json_default
    from repro_torch.train import bnn
    from benchmarks_torch import fig13_obs

    seq_key = "gather/meta16/actions"
    pool, labels = deploy.labeled_pool(samples_per_group=OBS_POOL_SAMPLES, seed=0)
    oracle = deploy.LabelOracle(pool, labels)
    scenario = render(emergency_phases(K_DB, scale=DP_SCALE), num_slots=K_DB, seed=0,
                      payload_pool=pool)
    packets = sum(b.shape[0] for phase in scenario.bursts for b in phase)
    xnor_launches: dict[int, int] = {}

    def new_rt(**kw):
        return DataplaneRuntime(bank, num_queues=DP_QUEUES, batch=DP_BATCH,
                                block_b=BLOCK_B, ring_capacity=DP_RING,
                                strategy="fused", audit=True, device=dev, **kw)

    def audited(label, rt):
        aud, cont = rt.audit_conservation(), rt.control.continuity_audit()
        if not aud["ok"] or aud["wrong_verdict"] or not cont["ok"]:
            fail(f"{label}: conservation {aud['ok']}, wrong_verdict "
                 f"{aud['wrong_verdict']}, continuity {cont['ok']}")

    def tally(n, row=dp_row, key=seq_key):
        entries[row]["launches"] += n["fused"].get(key, 0)
        for b, k in n["xnor"].items():
            xnor_launches[b] = xnor_launches.get(b, 0) + k

    # a. the stream: the scenario played plain, with obs.attach and a
    # detector polled after every tick, and with a sampler alone; the three
    # alternate, OBS_REPEATS each, with the previous run's garbage collected
    # before the clock starts (runs spread by +-10%, more than the stream or
    # the sampler costs, so the median and the direct host share are shown)
    def played(mode):
        rt, stream, det, acc, sampler = new_rt(), None, None, None, None
        driver, poll = rt, {"s": 0.0}
        if mode == "observed":
            stream = obs.TelemetryStream(capacity=OBS_STREAM_CAPACITY)
            obs.attach(rt, stream)
            acc = fig13_obs.time_emit_delta(rt)
            det = obs.AnomalyDetector(stream, num_queues=DP_QUEUES, num_slots=K_DB)

            def timed_poll():
                t0 = time.perf_counter()
                det.poll()
                poll["s"] += time.perf_counter() - t0

            driver = deploy.DeployDriver(rt, _EachTick(timed_poll))
        elif mode == "sampled":
            sampler = deploy.PacketSampler(oracle, num_slots=K_DB).attach(rt)
        gc.collect()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        play(driver, scenario)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if sampler is not None:
            sampler.detach()
        return rt, wall, {"stream": stream, "det": det, "acc": acc, "poll": poll}

    walls = {"plain": [], "observed": [], "sampled": []}
    for _ in range(OBS_REPEATS):
        for mode in walls:
            (rt_m, wall, parts), n = counted(lambda: played(mode))
            tally(n)
            audited(f"obs stream ({mode})", rt_m)
            walls[mode].append(wall)
            if mode == "observed":
                rt, obs_wall = rt_m, wall
                stream, det, acc, poll = (parts[k] for k in ("stream", "det", "acc",
                                                             "poll"))
    events = stream.latest(OBS_STREAM_CAPACITY)
    bad = stream_sums(rt, events)
    stats = stream.snapshot_stats()
    if bad:
        fail(f"obs stream: the deltas do not sum to the snapshot ({bad})")
    if stats["next_sid"] != stats["buffered"] + stats["dropped_events"]:
        fail(f"obs stream: events not conserved {stats}")
    det.poll()
    cls = det.classify()
    if cls["regime"] != "emergency":
        fail(f"obs detector: classified {cls['regime']!r} ({cls['evidence']})")
    ticks = rt.telemetry.runtime_ticks
    deltas = sum(e["kind"] == "delta" for e in events)
    med = {m: float(np.median(w)) for m, w in walls.items()}
    out["stream"] = {
        "kpps_plain": packets / med["plain"] / 1e3,
        "kpps_observed": packets / med["observed"] / 1e3,
        "overhead_pct_median": (med["observed"] / med["plain"] - 1.0) * 100.0,
        "overhead_pct_best": (min(walls["observed"]) / min(walls["plain"]) - 1.0) * 100.0,
        "host_share_pct": (acc["s"] + poll["s"]) / obs_wall * 100.0,
        "walls_s": walls, "deltas_per_tick": deltas / ticks, "ticks": ticks,
        "emit_delta_host_us_per_tick": acc["s"] * 1e6 / ticks,
        "detector_poll_host_us_per_tick": poll["s"] * 1e6 / ticks,
        "stream": stats, "regime": cls["regime"], "detect_tick": det.detect_tick(),
        "proposals": [c.describe() for c in det.proposals()]}
    print(json.dumps({"obs_stream": out["stream"]}), flush=True)

    # b. the server over the run of (a), on 127.0.0.1 at a port the kernel picks
    server = ObsServer(rt, stream, detector=det, host="127.0.0.1", port=0).start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        took = {}

        def get(ep, as_json=True):
            t0 = time.perf_counter()
            with urllib.request.urlopen(base + ep, timeout=10) as r:
                body = r.read()
            took[ep] = (time.perf_counter() - t0) * 1e3
            return json.loads(body) if as_json else body

        snap = rt.telemetry.snapshot()
        if get("/healthz") != {"ok": True, "port": server.port}:
            fail("obs server: /healthz")
        m = get("/metrics")
        if (m["totals"]["completed"], m["totals"]["dropped"]) != (
                snap["completed_total"], snap["dropped_total"]):
            fail(f"obs server: /metrics totals {m['totals']} against the snapshot")
        if get("/epochs") != json.loads(json.dumps(obs.epoch_log_doc(rt),
                                                   default=_json_default)):
            fail("obs server: /epochs differs from epoch_log_doc")
        if get("/anomaly")["regime"] != "emergency":
            fail("obs server: /anomaly does not name emergency")
        if b"dataplane observer" not in get("/", as_json=False):
            fail("obs server: / does not serve the dashboard")
        try:
            get("/nope")
            fail("obs server: /nope answered")
        except urllib.error.HTTPError as e:
            if e.code != 404:
                fail(f"obs server: /nope gave {e.code}")
    finally:
        server.stop()
    out["server"] = {"port": server.port, "ms": took}
    print(json.dumps({"obs_server": out["server"]}), flush=True)

    # c. deployment: one rollout that promotes and one with corrupted
    # weights that must roll back, each on a DeployDriver with a sampler
    ckpt_dir = os.path.join(ROOT, "build", "checkpoints", "promote")
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    def rollout(corrupt):
        rt = new_rt()
        sampler = deploy.PacketSampler(oracle, num_slots=K_DB).attach(rt)
        driver = deploy.DeployDriver(rt)
        pilot = deploy.ScheduledRollout(
            driver, sampler, deploy.OnlineTrainer(
                steps=DEPLOY_STEPS, seed=0, device=dev,
                checkpoint_dir=None if corrupt else ckpt_dir),
            warmup_ticks=DEPLOY_WARMUP, min_samples=48, corrupt=corrupt,
            canary_kw=dict(bake_ticks=DEPLOY_BAKE, min_samples=24))
        driver.add(pilot)
        t0 = time.perf_counter()
        play(driver, scenario)
        driver.flush_deploy()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        sampler.detach()
        return rt, sampler, pilot, wall

    out["deploy"] = {}
    runs = {}
    for corrupt, want in ((False, "promoted"), (True, "rolled_back")):
        (rt, sampler, pilot, wall), n = counted(lambda: rollout(corrupt))
        tally(n)
        audited(f"deploy ({want})", rt)
        terminal = [d for d in rt.deploy_log if d["event"] in ("promoted", "rolled_back")]
        if len(terminal) != 1 or terminal[0]["event"] != want:
            fail(f"deploy: expected one {want} decision, got {rt.deploy_log}")
        applied = {r.epoch for r in rt.control.log if r.applied}
        missing = [d["event"] for d in rt.deploy_log
                   if d["event"] in ("canary_start", "promoted", "rolled_back")
                   and d["epoch"] not in applied]
        if missing:
            fail(f"deploy ({want}): decisions without an applied epoch: {missing}")
        rec = terminal[0]
        runs[want] = (rt, sampler, pilot)
        out["deploy"][want] = {
            "fine_tune_ms": pilot.result.train_us / 1e3,
            "canary_to_decision_ms": rec["metrics"]["elapsed_us"] / 1e3,
            "bake_window_ticks": rec["metrics"]["bake_window_ticks"],
            "err_new": rec["metrics"].get("err_new"),
            "err_base": rec["metrics"].get("err_base"),
            "train_samples": pilot.result.metrics["samples"],
            "holdout_err": pilot.result.metrics["err"],
            "kpps_with_rollout": packets / wall / 1e3,
            "sampler": sampler.stats(), "xnor_launches": dict(n["xnor"])}

    out["deploy"]["kpps_sampler"] = packets / med["sampled"] / 1e3
    out["deploy"]["sampler_overhead_pct_median"] = (
        med["sampled"] / med["plain"] - 1.0) * 100.0
    out["deploy"]["kpps_no_sampler"] = out["stream"]["kpps_plain"]
    print(json.dumps({"deploy": out["deploy"]}), flush=True)

    # d. the trainer's checkpoint, restored on the card: bit-equal, and the
    # restored weights give the promoted weights' bake-window error
    _, sampler, pilot = runs["promoted"]
    step = store.latest_step(ckpt_dir)
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(step_dir, "MANIFEST.msgpack"), "rb") as f:
        manifest = codec.unpackb(f.read())

    def restored_err():
        latent, _ = store.restore(ckpt_dir, step, pilot.result.latent, device=dev)
        words, labs, _, _ = sampler.window_since(0)
        return latent, (deploy.paired_err(bnn.pack_trained(latent), words, labs),
                        deploy.paired_err(pilot.result.params, words, labs))

    (latent, errs), n = counted(restored_err)
    tally(n)
    if not all(torch.equal(latent[k], pilot.result.latent[k]) for k in latent):
        fail("checkpoint: the restored latent differs from the saved one")
    if errs[0] != errs[1]:
        fail(f"checkpoint: restored weights err {errs[0]} against {errs[1]}")
    out["checkpoint"] = {"codec": manifest["codec"], "step": step,
                         "leaves": [e["path"] for e in manifest["leaves"]],
                         "bytes": sum(os.path.getsize(os.path.join(step_dir, e))
                                      for e in os.listdir(step_dir)),
                         "window_err": errs[0]}
    print(json.dumps({"checkpoint": out["checkpoint"]}), flush=True)

    # e. a window-8 megastep with a sampler (max_pending 3) and a stream of
    # capacity 4: the backlog stays bounded, the overflow is conserved
    def mega():
        rt = new_rt(megastep_ticks=WINDOW_TICKS)
        if rt._mega is None:
            fail("megastep: the engine is off")
        sampler = deploy.PacketSampler(oracle, num_slots=K_DB, per_tick=8,
                                       max_pending=MEGA_MAX_PENDING).attach(rt)
        stream = obs.TelemetryStream(capacity=MEGA_STREAM_CAPACITY)
        obs.attach(rt, stream)
        peak = {"pending": 0, "flush": 0}
        real_flush = sampler.flush

        def flush():
            peak["flush"] = max(peak["flush"], len(sampler._pending))
            return real_flush()

        sampler.flush = flush
        watch = _EachTick(lambda: peak.__setitem__(
            "pending", max(peak["pending"], len(sampler._pending))))
        play(deploy.DeployDriver(rt, watch), scenario)
        peak["pending"] = max(peak["pending"], len(sampler._pending))
        sampler.detach()
        return rt, sampler, stream, peak

    (rt, sampler, stream, peak), n = counted(mega)
    tally(n, row=win_row, key=win_key)
    entries[dp_row]["launches"] += n["fused"].get(seq_key, 0)
    audited("megastep with sampler and stream", rt)
    s = stream.snapshot_stats()
    completed = rt.snapshot()["completed_total"]
    if max(peak.values()) > MEGA_MAX_PENDING:
        fail(f"megastep: sampler backlog {peak} above {MEGA_MAX_PENDING}")
    if sampler.seen != completed or sampler.labeled + sampler.unknown != sampler.sampled:
        fail(f"megastep: sampler saw {sampler.seen} of {completed}")
    if s["next_sid"] != s["buffered"] + s["dropped_events"] or not s["dropped_events"]:
        fail(f"megastep: stream overflow not conserved {s}")
    if n["fused"].get(win_key, 0) < 1:
        fail("megastep: the window's launch never ran")
    out["megastep"] = {"peak_pending": peak, "stream": s, "completed": completed,
                       "window_launches": n["fused"][win_key]}
    print(json.dumps({"megastep_obs_deploy": out["megastep"]}), flush=True)

    # xnor_matmul at the batch sizes (c) and (d) ran it: each a row of its own
    xin = pkt.to_device(np.tile(pool, (-(-max(xnor_launches, default=1)
                                          // pool.shape[0]), 1)), dev)
    w = pilot.result.params["w1p"]
    for b, k in sorted(xnor_launches.items()):
        if f"xnor/B{b}" not in entries:
            check_xnor(xin[:b], w)
        entries[f"xnor/B{b}"]["launches"] += k
    out["xnor_launches"] = xnor_launches

    # fig13 and fig14 at the reference's shapes, each run once
    out["figures"] = run_paper_figures(dev, BENCH_FIGURES)
    print(json.dumps({"obs_deploy_figures": out["figures"]}), flush=True)


CLI_BLOCK_B = 32                   # the runtime's default, which the CLI keeps
CLI_FIGURES = ("fig8_dataplane", "fig9_control", "fig11_workloads", "fig15_swap")
CLI_LINGER_S = 2.0
CLI_DEPLOY_SEED = 1                # (e)'s --seed: slot 0's baseline beats a negated model
CLI_TIMEOUT_S = 300


def cli_main(argv, dev, buf=None) -> tuple[str, int]:
    """``repro_torch.launch.dataplane.main(argv)`` in this process, its
    standard output captured (into ``buf`` when given): (output, exit
    status).  On the card no ``--device`` is passed (the CLI's default is
    the card)."""
    import contextlib
    import io

    from repro_torch.launch import dataplane

    buf, code = buf if buf is not None else io.StringIO(), 0
    with contextlib.redirect_stdout(buf):
        try:
            dataplane.main(list(argv) + ([] if dev.type == "cuda"
                                         else ["--device", str(dev)]))
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else 1
    return buf.getvalue(), code


def run_cli_phase(*, counted, entries, dev, check_xnor, xnor_rows, out) -> None:
    """Phase 8 (a to h of the module docstring): the data-plane CLI in
    this process at the data plane's shape, each run with the launch counts
    set to 0 around it; the fused kernel's launches count under the
    CLI_BLOCK_B rows (one queue's batch, the stacked queues, the window) and
    ``xnor_matmul``'s under a row per batch size, which ``check_xnor`` adds
    for sizes no earlier part ran (inputs from ``xnor_rows(b)``).  Then the
    shell entry point in a subprocess, and the four data-plane figures."""
    import io
    import re
    import shutil
    import threading
    import urllib.request

    from repro_torch.dataplane import workloads
    from repro_torch.dataplane.megastep import EPOCH_CAPACITY, WINDOW_TAG

    seq_key, win_key = "gather/meta16/actions", "gather/meta16/actions" + WINDOW_TAG
    row = f"{seq_key}/K{K_DB}/B{DP_BATCH}/bb{CLI_BLOCK_B}"
    stack_row = f"{seq_key}/K{K_DB}/B{DP_QUEUES * DP_BATCH}/bb{CLI_BLOCK_B}"
    win_row = f"{seq_key}/K{K_DB}+{EPOCH_CAPACITY}{WINDOW_TAG}/bb{CLI_BLOCK_B}"
    shape = ["--slots", str(K_DB), "--queues", str(DP_QUEUES), "--batch", str(DP_BATCH),
             "--ring-capacity", str(DP_RING), "--scale", str(DP_SCALE)]
    work = os.path.join(ROOT, "build", "cli")
    os.makedirs(work, exist_ok=True)
    path = lambda name: os.path.join(work, name)  # noqa: E731
    xnor_launches: dict[int, int] = {}
    res = {}

    def run(label, argv, *, fused_row=row):
        """One CLI run with the counts at 0 around it; returns its ``--json``
        document (when asked for), its output and its launch counts."""
        (text, code), n = counted(lambda: cli_main(argv, dev))
        if code:
            fail(f"cli {label}: exit {code}\n{text[-3000:]}")
        entries[fused_row]["launches"] += n["fused"].get(seq_key, 0)
        entries[win_row]["launches"] += n["fused"].get(win_key, 0)
        for b, k in n["xnor"].items():
            xnor_launches[b] = xnor_launches.get(b, 0) + k
        doc = None
        if "--json" in argv:
            with open(argv[argv.index("--json") + 1]) as f:
                doc = json.load(f)
        return doc, text, n

    def audited(label, doc):
        snap = doc["snapshot"]
        aud, cont = snap["conservation"], snap["continuity"]
        if not aud["ok"] or aud["wrong_verdict"] or not cont["ok"]:
            fail(f"cli {label}: conservation {aud['ok']}, wrong_verdict "
                 f"{aud['wrong_verdict']}, continuity {cont['ok']}")
        phases = doc["replay"]["phases"] if "replay" in doc else doc["phases"]
        return {"kpps": {r["phase"]: r.get("kpps") for r in phases},
                "totals": aud["totals"], "wrong_verdict": aud["wrong_verdict"],
                "epochs": len(snap["control_log"])}

    def digest_of(trace_path):
        return workloads.load(trace_path).expect["digest"]["sha256"]

    # a. audited, recorded (the trace is (d)'s)
    doc, _, n = run("a", shape + ["--audit", "--trace", "record", path("a.bswt"),
                                  "--json", path("a.json")])
    res["a"] = audited("a", doc)
    res["a"]["fused_launches"] = n["fused"].get(seq_key, 0)
    # b. the megastep at window 8: the same checks and the same completion streams
    doc, _, n = run("b", shape + ["--audit", "--megastep-ticks", str(WINDOW_TICKS),
                                  "--trace", "record", path("b.bswt"),
                                  "--json", path("b.json")])
    res["b"] = audited("b", doc)
    res["b"]["window_launches"] = n["fused"].get(win_key, 0)
    if res["b"]["window_launches"] < 1:
        fail("cli b: the megastep window never launched")
    if digest_of(path("b.bswt")) != digest_of(path("a.bswt")):
        fail("cli b: the window's completion streams differ from (a)'s")
    # c. two hosts, a crash in the middle of a commit, a 4-tick lease
    argv_c = shape + ["--hosts", "2", "--queues", "2", "--scenario", "crash-mid-commit",
                      "--lease-ticks", "4", "--audit", "--json", path("c.json")]
    doc, text, _ = run("c", argv_c)
    res["c"] = audited("c", doc)
    per_host = [h["ok"] for h in doc["snapshot"]["conservation"]["per_host"]]
    modes = [e.get("commit_mode") for e in doc["control_log"]]
    if not all(per_host) or "degraded" not in modes or "<degraded>" not in text:
        fail(f"cli c: per-host ok {per_host}, commit modes {modes}")
    res["c"].update(per_host_ok=per_host, commit_modes=modes)
    # d. (a)'s trace replayed from the file
    doc, _, _ = run("d", ["--trace", "replay", path("a.bswt"), "--audit",
                          "--json", path("d.json")])
    if not (doc["replay"]["ok"] and doc["replay"]["digest_ok"] is True):
        fail(f"cli d: replay ok {doc['replay']['ok']}, digest_ok "
             f"{doc['replay']['digest_ok']}, {doc['replay']['mismatches'][:3]}")
    res["d"] = audited("d", doc)
    res["d"]["digest_ok"] = True
    # e. the scripted rollouts, at phase 7's warm-up, bake and steps.  The
    # demo targets slot 0, a random model: at --seed 0 the port's slot 0
    # errs on 0.912 of the bake window, so the negated fine-tune (0.932) is
    # within the canary's 0.02 tolerance and 'rollback' promotes (the
    # reference's rule; its own seed-0 bank differs).  CLI_DEPLOY_SEED's
    # slot 0 errs on 0.595, below the negated candidate.
    for demo, want in (("promote", "promoted"), ("rollback", "rolled_back")):
        ckpt = path(f"ckpt-{demo}")
        shutil.rmtree(ckpt, ignore_errors=True)
        doc, _, n = run(f"e {demo}", shape + [
            "--seed", str(CLI_DEPLOY_SEED),
            "--deploy-demo", demo, "--deploy-warmup-ticks", str(DEPLOY_WARMUP),
            "--deploy-bake-ticks", str(DEPLOY_BAKE), "--deploy-steps", str(DEPLOY_STEPS),
            "--checkpoint-dir", ckpt, "--json", path(f"e-{demo}.json")])
        res[f"e_{demo}"] = audited(f"e {demo}", doc)
        events = [d["event"] for d in doc["snapshot"]["deployments"]]
        terminal = [e for e in events if e in ("promoted", "rolled_back")]
        if terminal != [want]:
            fail(f"cli e {demo}: deploy events {events}")
        res[f"e_{demo}"].update(events=events, xnor_launches=dict(n["xnor"]))
    # f. the slot cache: 32 models over the 16 slots, with the prefetcher
    doc, text, _ = run("f", shape + ["--slot-cache", "32", "--prefetch", "--audit",
                                     "--json", path("f.json")])
    res["f"] = audited("f", doc)
    cs = doc["snapshot"]["slot_cache"]
    line = next((ln for ln in text.splitlines() if ln.startswith("slot-cache: ")
                 and "hits=" in ln), "")
    if (not line or "misses=" not in line or "prefetch=" not in line
            or not cs["hits"] + cs["misses"]):
        fail(f"cli f: slot-cache line {line!r}, stats {cs}")
    res["f"]["slot_cache"] = cs
    # g. the observe server: one GET of /healthz while it lingers
    log_json = path("g-epochs.json")
    if os.path.exists(log_json):
        os.unlink(log_json)
    argv_g = shape + ["--observe", "0", "--observe-linger", str(CLI_LINGER_S),
                      "--epoch-log-json", log_json]
    got, buf = {}, io.StringIO()

    def serve():
        try:
            got["result"] = counted(lambda: cli_main(argv_g, dev, buf))
        except Exception as e:  # raised again below, in the main thread
            got["error"] = e

    t0 = time.perf_counter()
    th = threading.Thread(target=serve)
    th.start()
    # the epoch log is written, then "lingering" printed, then the linger
    while "observe: lingering" not in buf.getvalue() and th.is_alive():
        time.sleep(0.02)
    healthz, port = None, None
    m = re.search(r"observe: http://[^:/]+:(\d+)/", buf.getvalue())
    if th.is_alive() and m:
        port = int(m.group(1))
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=10) as r:
            healthz = json.loads(r.read())
    th.join(timeout=CLI_TIMEOUT_S)
    if th.is_alive():
        fail("cli g: the run did not end")
    if "error" in got:
        raise got["error"]
    (text, code), n = got["result"]
    entries[row]["launches"] += n["fused"].get(seq_key, 0)
    if code or healthz != {"ok": True, "port": port}:
        fail(f"cli g: exit {code}, /healthz {healthz} on port {port}")
    if any(t.name == "obs-server" and t.is_alive() for t in threading.enumerate()):
        fail("cli g: the observe server outlived the run")
    with open(log_json) as f:
        epochs = json.load(f)
    if not epochs["epochs"] or not epochs["continuity"]["ok"]:
        fail("cli g: the epoch log is empty or its continuity broken")
    res["g"] = {"healthz": healthz, "epochs": len(epochs["epochs"]),
                "wall_s": time.perf_counter() - t0}
    # h. the shard_map fan-out (one group on one card) against vmap
    digests = {}
    for fanout in ("vmap", "shard_map"):
        doc, _, n = run(f"h {fanout}", shape + [
            "--fanout", fanout, "--audit", "--trace", "record", path(f"h-{fanout}.bswt"),
            "--json", path(f"h-{fanout}.json")], fused_row=stack_row)
        res[f"h_{fanout}"] = audited(f"h {fanout}", doc)
        digests[fanout] = digest_of(path(f"h-{fanout}.bswt"))
    if digests["shard_map"] != digests["vmap"] or digests["vmap"] != digest_of(path("a.bswt")):
        fail(f"cli h: completion streams differ: {digests}")

    for b, k in sorted(xnor_launches.items()):
        if f"xnor/B{b}" not in entries:
            check_xnor(*xnor_rows(b))
        entries[f"xnor/B{b}"]["launches"] += k
    res["xnor_launches"] = xnor_launches
    out["runs"] = res
    print(json.dumps({"cli": res}), flush=True)

    # the shell entry point, reusing the kernels built above
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dataplane", "--queues", "4", "--audit"]
        + ([] if dev.type == "cuda" else ["--device", str(dev)]),
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines, ready_s = [], None
    try:
        for ln in proc.stdout:
            lines.append(ln)
            if ready_s is None and ln.startswith("runtime: "):
                ready_s = time.perf_counter() - t0
        code = proc.wait(timeout=CLI_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = "".join(lines)
    if code or "ok=True wrong_verdict=0" not in text or "continuity ok=True" not in text:
        fail(f"cli subprocess: exit {code}\n{text[-3000:]}")
    out["subprocess"] = {"start_to_runtime_ready_s": ready_s,
                         "wall_s": time.perf_counter() - t0}
    print(json.dumps({"cli_subprocess": out["subprocess"]}), flush=True)

    out["figures"] = run_paper_figures(dev, CLI_FIGURES)
    print(json.dumps({"cli_figures": out["figures"]}), flush=True)


LM_ARCH, SSM_ARCH = "smollm-360m", "mamba2-130m"
LM_BATCH, LM_SEQ = 8, 512          # ServeEngine(max_batch, max_seq) of (a) to (d)
LM_NEW = 8                         # new tokens per request
LM_SSM_LONG = (300, 450)           # (d)'s prompts past one 256-token SSD chunk
LM_INT8_STEPS, LM_INT8_REL = 10, 0.05   # (e): the reference's bound (test_int8_cache.py)
LM_PROFILE_NEW = 100               # (b)'s profiled engine: rows stay active
# The banked head as mamba2-130m-h4.chat-sat serves it (phase 3's head rows
# and (h)): HEAD_SLOTS output heads, a decode step of HEAD_ROWS rows, the
# engine's prefill buckets, HEAD_PREFILL the largest
HEAD_SLOTS, HEAD_ROWS, HEAD_SEQ = 4, 256, 1536
HEAD_BUCKETS = (32, 128, 512)
HEAD_PREFILL = HEAD_BUCKETS[-1]
HEAD_PROMPTS = (20, 100, 400)      # (h)'s prompt lengths, one per bucket, in turn
HEAD_REQUESTS = 12                 # (h)'s requests, slots in turn
HEAD_KEY = "bf16/wgmma.f32out/head"  # banked_matmul.launches of the grouped head
DECODE_ROWS = 64                   # zamba2-7b-instruct.chat64-sat's decode rows (phase 3)


def head_config():
    """mamba2-130m as ``mamba2-130m-h4`` serves it: the published
    vocabulary of 50,277 padded to a multiple of 16, and a bank of
    HEAD_SLOTS output heads."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config(SSM_ARCH), vocab_size=50277, vocab_pad_multiple=16,
                               bank_mode="head", bank_slots=HEAD_SLOTS)


def run_lm_serve_phase(*, counted, entries, dev, out) -> None:
    """Phase 9 (a to h of the module docstring): the LM serving path on the
    card, each part with the launch counts set to 0 around it (the serving
    path launches no BNN kernel; (h)'s banked head launches ``banked_matmul``
    under HEAD_KEY, counted into phase 3's head rows of ``entries``)."""
    import dataclasses
    import math

    import numpy as np
    import torch

    from repro_torch.configs.registry import ARCH_IDS, get_config
    from repro_torch.kernels import banked_matmul as bm
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models import api
    from repro_torch.serve.engine import Request, ServeEngine

    def part(label, fn, allow=(), attention=None):
        """``fn`` with the counts set to 0 around it; no kernel launched but
        the ``banked_matmul`` keys in ``allow`` and, where the part decodes
        attention, ``decode_attention`` on its cache dtype ``attention``
        alone, which it then requires (counted into phase 3's row)."""
        result, n = counted(fn)
        n["banked_matmul"] = {k: v for k, v in n["banked_matmul"].items() if k not in allow}
        if attention is not None:
            att = n.pop("decode_attention")
            if set(att) != {attention}:
                fail(f"lm_serve {label}: decode attention launched {att}, "
                     f"not on its {attention} kernel alone")
            entries[f"attn/decode/{attention}"]["launches"] += att[attention]
            result["decode_attention_launches"] = att[attention]
        launched = {k: v for k, v in n.items() if v}
        if launched:
            fail(f"lm_serve {label}: kernels launched on the LM path: {launched}")
        return result

    def requests(cfg, seed, lengths=None, n=LM_BATCH, new=LM_NEW):
        """(prompt, slot, new tokens) per request: prompts of 4-48 tokens."""
        rng = np.random.default_rng(seed)
        lengths = lengths or [int(x) for x in rng.integers(4, 49, n)]
        slots = max(cfg.bank_slots, 1)
        return [(rng.integers(0, cfg.vocab_size, m).tolist(), i % slots, new)
                for i, m in enumerate(lengths)]

    def serve(params, cfg, reqs, record=False, **kw):
        eng = ServeEngine(params, cfg, device=dev, **kw)
        for i, (prompt, slot, new) in enumerate(reqs):
            eng.submit(Request(rid=i, prompt=prompt, slot_id=slot, max_new_tokens=new))
        if record:
            eng.spans.start()
        fins = eng.run_until_done()
        torch.cuda.synchronize()
        if len(fins) != len(reqs) or any(f.rejected for f in fins):
            fail(f"lm_serve: {len(fins)} of {len(reqs)} requests finished")
        outs = {f.rid: f.output for f in fins}
        for rid, o in outs.items():
            if len(o) != reqs[rid][2] or not all(0 <= t < cfg.vocab_size for t in o):
                fail(f"lm_serve: request {rid} gave {o}")
        return outs, eng

    def margin_bound(cfg, logit_max):
        """The engine and the greedy decode sum every logit in other orders
        (cached K/V, bucket padding, one query row against the whole
        prompt).  Each of the n_layers + 1 stages adds a relative error of
        at most lambda * sqrt(K) * u (K its longest dot product, u f32's
        unit roundoff, lambda = 10), and both paths err: a top-2 margin
        above twice that times the largest |logit| cannot flip."""
        k = max(cfg.d_model, cfg.d_ff, cfg.d_inner if cfg.ssm_state else 0)
        return (2 * PROB_LAMBDA * math.sqrt(k) * F32_UNIT_ROUNDOFF
                * (cfg.n_layers + 1) * logit_max)

    @torch.inference_mode()
    def greedy(params, cfg, prompt, new, slot):
        toks, got, margins, logit_max = list(prompt), [], [], 0.0
        for _ in range(new):
            batch = {"tokens": torch.tensor([toks], device=dev)}
            if slot is not None:
                batch["slot_ids"] = torch.tensor([slot], device=dev)
            logits, _ = api.apply(params, batch, cfg)
            last = logits[0, -1, :cfg.vocab_size]
            top = torch.topk(last, 2)
            got.append(int(top.indices[0]))
            margins.append(float(top.values[0] - top.values[1]))
            logit_max = max(logit_max, float(last.abs().max()))
            toks.append(got[-1])
        return got, margins, logit_max

    def check_greedy(label, params, cfg, reqs, outs):
        """Every output equals the no-cache greedy decode through
        ``api.apply``; a token may differ only where the greedy top-2
        margin at the first difference is under ``margin_bound``."""
        routed = cfg.bank_mode in ("adapter", "head")
        worst, bound, differ = math.inf, 0.0, []
        for rid, (prompt, slot, new) in enumerate(reqs):
            want, margins, logit_max = greedy(params, cfg, prompt, new,
                                              slot if routed else None)
            bound = max(bound, margin_bound(cfg, logit_max))
            first = next((i for i, (a, b) in enumerate(zip(outs[rid], want)) if a != b),
                         None)
            worst = min(worst, min(margins if first is None else margins[:first + 1]))
            if first is not None:
                if margins[first] > margin_bound(cfg, logit_max):
                    fail(f"lm_serve {label}: request {rid} differs from greedy at "
                         f"token {first} where the top-2 margin is {margins[first]:.4g}")
                differ.append({"rid": rid, "token": first, "margin": margins[first]})
        res = {"requests": len(reqs), "equal_to_greedy": len(reqs) - len(differ),
               "min_top2_margin": worst, "margin_bound": bound, "differ": differ}
        print(f"lm_serve {label}: {res['equal_to_greedy']}/{len(reqs)} equal to greedy, "
              f"min top-2 margin {worst:.4g} (bound {bound:.4g})", flush=True)
        return res

    def free(*names):
        for name in names:
            held.pop(name, None)
        torch.cuda.empty_cache()

    res = {"card": nvidia_smi("name,power.limit")}
    held = {}
    published = get_config(LM_ARCH)
    f32 = dataclasses.replace(published, dtype="float32", remat="none")

    # a. smollm-360m at full width and depth, f32: the engine against greedy
    def a():
        t0 = time.perf_counter()
        held["f32"] = api.init(0, f32, device=dev)
        reqs = requests(f32, 0)
        outs, _ = serve(held["f32"], f32, reqs, max_batch=LM_BATCH, max_seq=LM_SEQ)
        r = check_greedy("a smollm-360m f32", held["f32"], f32, reqs, outs)
        r["params"] = sum(p.numel() for p in held["f32"].parameters())
        r["wall_s"] = time.perf_counter() - t0
        return r
    res["a_smollm_f32"] = part("a", a, attention="float32")

    # e. the int8 KV cache on the same f32 weights: 10 decode steps
    def e():
        f32_8 = dataclasses.replace(f32, cache_dtype="int8")
        caches = {c.cache_dtype: api.init_cache(c, 2, 32, device=dev) for c in (f32, f32_8)}
        nbytes = {k: sum(t.numel() * t.element_size() for t in c.values())
                  for k, c in caches.items()}
        toks = np.random.default_rng(5).integers(0, f32.vocab_size, LM_INT8_STEPS)
        worst = 0.0
        with torch.inference_mode():
            for i, t in enumerate(toks):
                tt = torch.full((2, 1), int(t), device=dev)
                lg = {}
                for c in (f32, f32_8):
                    before = sum(da.decode_attention.launches.values())
                    lg[c.cache_dtype], caches[c.cache_dtype] = api.decode_step(
                        held["f32"], tt, caches[c.cache_dtype], i, c)
                    added = sum(da.decode_attention.launches.values()) - before
                    if added != (0 if c is f32_8 else c.n_layers):
                        fail(f"lm_serve e: the {c.cache_dtype} cache's decode step launched "
                             f"decode attention {added} times")
                rel = float((lg["model"] - lg["int8"]).abs().max()
                            / (lg["model"].abs().max() + 1e-9))
                worst = max(worst, rel)
        if not worst < LM_INT8_REL:
            fail(f"lm_serve e: int8 cache relative logit error {worst:.4g}")
        r = {"steps": LM_INT8_STEPS, "max_rel_logit_err": worst, "bound": LM_INT8_REL,
             "cache_bytes": nbytes["model"], "int8_cache_bytes": nbytes["int8"],
             "int8_dots": "exact integer sums in f32 (QK, n*127^2 < 2^24) or f64 (PV beyond)"}
        print(f"lm_serve e int8 cache: max rel logit err {worst:.4g} < {LM_INT8_REL}; "
              f"cache bytes {nbytes['model']} -> {nbytes['int8']}", flush=True)
        return r
    res["e_int8_cache"] = part("e", e, attention="float32")
    free("f32")

    # c. the adapter bank at full width: slot 1's b bumped from a seeded draw
    def c():
        cfg = dataclasses.replace(f32, bank_mode="adapter", bank_slots=2)
        held["bank"] = params = api.init(0, cfg, device=dev)
        gen = torch.Generator(device=dev).manual_seed(7)
        with torch.no_grad():
            for name, p in params.named_parameters():
                if name.endswith("adapter.b"):
                    p[1] = torch.randn(p.shape[1:], generator=gen, device=dev) * 0.5
        prompt = requests(cfg, 1, n=1)[0][0]
        reqs = [(prompt, 0, LM_NEW), (prompt, 1, LM_NEW)]
        outs, _ = serve(params, cfg, reqs, max_batch=LM_BATCH, max_seq=LM_SEQ)
        if outs[0] == outs[1]:
            fail("lm_serve c: slots 0 and 1 gave the same output")
        r = check_greedy("c adapter bank", params, cfg, reqs, outs)
        r["outputs"] = [outs[0], outs[1]]
        return r
    res["c_adapter_bank"] = part("c", c, attention="float32")
    free("bank")

    # b. the published dtype, bf16: rate, prefill and decode times, memory,
    # and where one decode tick at batch 8 spends its time
    def b():
        params = held["bf16"] = api.init(0, published, device=dev)
        reqs = requests(published, 0)
        serve(params, published, reqs, max_batch=LM_BATCH, max_seq=LM_SEQ)  # warm-up
        torch.cuda.reset_peak_memory_stats(dev)
        start_bytes = torch.cuda.memory_allocated(dev)  # the weights and what earlier phases hold
        t0 = time.perf_counter()
        outs, eng = serve(params, published, reqs, max_batch=LM_BATCH, max_seq=LM_SEQ)
        wall = time.perf_counter() - t0
        tokens = sum(len(o) for o in outs.values())
        peak = torch.cuda.max_memory_allocated(dev)
        r = {"tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
             "ticks": eng.ticks, "peak_memory_gb": peak / 1e9,
             "peak_above_start_gb": (peak - start_bytes) / 1e9,
             "weights_gb": sum(p.numel() * p.element_size() for p in params.parameters()) / 1e9}
        prefill_ms = {}
        for bucket in eng.buckets:
            prompt = requests(published, bucket, [bucket], n=1)[0][0]
            times = []
            for _ in range(6):
                t0 = time.perf_counter()
                eng._prefill(bucket, prompt, 0)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            prefill_ms[bucket] = float(np.median(times[1:]))
        r["prefill_ms_per_bucket"] = prefill_ms
        busy = requests(published, 3, new=LM_PROFILE_NEW)
        eng = ServeEngine(params, published, device=dev, max_batch=LM_BATCH, max_seq=LM_SEQ)
        for i, (prompt, slot, new) in enumerate(busy):
            eng.submit(Request(rid=i, prompt=prompt, slot_id=slot, max_new_tokens=new))
        eng.step()  # admits all 8
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            if eng.step() != LM_BATCH:
                fail("lm_serve b: a row retired inside the timed ticks")
            times.append((time.perf_counter() - t0) * 1e3)
        r["decode_ms_per_tick"] = float(np.median(times))
        r["decode_tick_profile"] = profile_step(eng.step, iters=20)
        if int(eng.active.sum()) != LM_BATCH:
            fail("lm_serve b: a row retired inside the profiled ticks")
        print(f"lm_serve b smollm-360m bf16: {r['tokens_per_s']:.1f} tok/s, decode "
              f"{r['decode_ms_per_tick']:.2f} ms/tick, prefill ms {prefill_ms}, idle "
              f"{r['decode_tick_profile']['device_idle_share']:.3f}, peak "
              f"{r['peak_memory_gb']:.3f} GB", flush=True)
        return r
    res["b_smollm_bf16"] = part("b", b, attention="bfloat16")
    free("bf16")

    # d. mamba2-130m at full width and depth, f32; two prompts past one chunk
    def d():
        cfg = dataclasses.replace(get_config(SSM_ARCH), dtype="float32", remat="none")
        params = held["ssm"] = api.init(0, cfg, device=dev)
        short = requests(cfg, 4, n=LM_BATCH - len(LM_SSM_LONG))
        reqs = short + requests(cfg, 5, list(LM_SSM_LONG), n=len(LM_SSM_LONG))
        t0 = time.perf_counter()
        outs, _ = serve(params, cfg, reqs, max_batch=LM_BATCH, max_seq=LM_SEQ)
        r = check_greedy("d mamba2-130m f32", params, cfg, reqs, outs)
        r["params"] = sum(p.numel() for p in params.parameters())
        r["prompt_lengths"] = [len(q[0]) for q in reqs]
        r["wall_s"] = time.perf_counter() - t0
        return r
    res["d_mamba2_f32"] = part("d", d)
    free("ssm")

    # f. every other arch at reduced(), f32, one engine run each
    def f():
        runs = {}
        for arch in ARCH_IDS:
            if arch in ("boundswitch-h32", LM_ARCH, SSM_ARCH, "seamless-m4t-medium"):
                continue
            over = {"moe_capacity_factor": 16.0} if get_config(arch).family == "moe" else {}
            cfg = get_config(arch).reduced(remat="none", dtype="float32", **over)
            params = api.init(0, cfg, device=dev)
            reqs = requests(cfg, 6, [5, 9, 17], n=3, new=5)
            outs, _ = serve(params, cfg, reqs, max_batch=4, max_seq=64,
                            prefill_buckets=(8, 32))
            runs[arch] = check_greedy(f"f {arch} reduced", params, cfg, reqs, outs)
        return runs
    res["f_reduced"] = part("f", f, attention="float32")

    # h. mamba2-130m in its published bf16 with chat-sat's bank of output
    # heads and engine shape: the head grouped by slot on bf16/wgmma.f32out,
    # one launch a decode step (HEAD_ROWS rows) and one a prefill
    def h():
        cfg = head_config()
        params = held["head"] = api.init(0, cfg, device=dev)
        reqs = [(q[0], i % HEAD_SLOTS, q[2]) for i, q in enumerate(requests(
            cfg, 8, [HEAD_PROMPTS[i % len(HEAD_PROMPTS)] for i in range(HEAD_REQUESTS)],
            n=HEAD_REQUESTS))]
        t0 = time.perf_counter()
        _, eng = serve(params, cfg, reqs, record=True, max_batch=HEAD_ROWS,
                       max_seq=HEAD_SEQ, prefill_buckets=HEAD_BUCKETS)
        spans = eng.spans.summary()
        launches = bm.banked_matmul.launches[HEAD_KEY]
        r = {"requests": len(reqs), "decode_steps": spans["serve.decode"]["count"],
             "prefills": spans["serve.prefill"]["count"], "head_launches": launches,
             "head_spans": spans["serve.decode.head"]["count"],
             "head_rows": spans["serve.decode.head"]["rows"],
             "head_padded_rows": spans["serve.decode.head"]["padded"],
             "wall_s": time.perf_counter() - t0}
        if r["prefills"] != len(reqs) or launches != r["decode_steps"] + r["prefills"] \
                or r["head_spans"] != r["decode_steps"]:
            fail(f"lm_serve h: the grouped head ran {launches} times for "
                 f"{r['decode_steps']} decode steps and {r['prefills']} prefills: {r}")
        entries["mm/bf16.f32out/head"]["launches"] += r["decode_steps"]
        entries["mm/bf16.f32out/head/prefill"]["launches"] += r["prefills"]
        print(f"lm_serve h mamba2-130m bf16 head bank: {r}", flush=True)
        return r
    res["h_head_bank"] = part("h", h, allow=(HEAD_KEY,))
    free("head")

    # g. the shell entry point: defaults, mamba2-130m, and seamless (fails)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    extra = [] if dev.type == "cuda" else ["--device", str(dev)]
    runs = {name: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", *argv, *extra], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, argv in (("defaults", []), (SSM_ARCH, ["--arch", SSM_ARCH]),
                           ("seamless-m4t-medium", ["--arch", "seamless-m4t-medium"]))}
    g = {}
    try:
        for name, proc in runs.items():
            stdout, stderr = proc.communicate(timeout=CLI_TIMEOUT_S)
            g[name] = {"exit": proc.returncode, "lines": stdout.strip().splitlines(),
                       "stderr_tail": stderr.strip().splitlines()[-1:]}
    finally:
        for proc in runs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for name in ("defaults", SSM_ARCH):
        lines = g[name]["lines"]
        if g[name]["exit"] or len(lines) != 2 or not lines[0].startswith("served 16 requests") \
                or not lines[1].startswith("latency "):
            fail(f"lm_serve g: launcher {name}: {g[name]}")
    if g["seamless-m4t-medium"]["exit"] == 0:
        fail("lm_serve g: the launcher served the encoder-decoder")
    res["g_launcher"] = g
    print(f"lm_serve g launcher: {g}", flush=True)
    out.update(res)
    print(json.dumps({"lm_serve": res}), flush=True)


TRAIN_BATCH, TRAIN_SEQ = 8, 512    # (a)'s global batch x sequence (SyntheticTokens)
TRAIN_WARMUP, TRAIN_TIMED = 3, 10  # (a)'s untimed and timed steps
TRAIN_PROFILED = 3                 # steps of each profile_step round
TRAIN_LR = 1e-3
SSM_TRAIN_STEPS = 4                # (d)
RESUME_STEPS = 4                   # (e): steps before and after the preemption
RESUME_ATOL = 1e-5                 # (e): the reference's resume tolerance
STEP_RTOL = 1e-5                   # (b), (c): loss and grad norm
TRAIN_TIMEOUT_S = 600


def run_lm_train_phase(*, counted, dev, out) -> None:
    """Phase 10 (a to e of the module docstring): LM training on the card,
    each part with the BNN kernels' launch counts set to 0 around it (the
    training path launches none of them)."""
    import copy
    import dataclasses
    import math
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs.registry import ARCH_IDS, get_config
    from repro_torch.data.tokens import SyntheticTokens, TokenPipelineConfig
    from repro_torch.models import api
    from repro_torch.train import train_step as ts_lib
    from repro_torch.train.loop import Trainer, TrainerConfig
    from repro_torch.train.optimizer import OptimizerConfig, adamw_init

    def part(label, fn):
        result, n = counted(fn)
        launched = {k: v for k, v in n.items() if v}
        if launched:
            fail(f"lm_train {label}: BNN kernels launched on the LM path: {launched}")
        return result

    def opt_for(cfg, lr=TRAIN_LR, total=100):
        return OptimizerConfig(learning_rate=lr, warmup_steps=2, total_steps=total,
                               moments_dtype=cfg.moments_dtype,
                               master_weights=cfg.master_weights)

    def state_for(model, opt_cfg):
        return {"params": model, "opt": adamw_init(list(model.parameters()), opt_cfg),
                "step": torch.zeros((), dtype=torch.int32)}

    def to_dev(batch, device):
        return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}

    def metrics_of(m):
        return {k: float(v) for k, v in m.items()}

    def params_apart(a, b, lr):
        """(largest difference, elements beyond lr / 10, elements) of two
        models' params (f32 master copies where there are)."""
        la = a["opt"].get("master", list(a["params"].parameters()))
        lb = b["opt"].get("master", list(b["params"].parameters()))
        worst, far, total = 0.0, 0, 0
        for x, y in zip(la, lb):
            d = (x.detach().float().cpu() - y.detach().float().cpu()).abs()
            worst = max(worst, float(d.max()))
            far += int((d > 0.1 * lr).sum())
            total += d.numel()
        return worst, far, total

    def check_apart(label, a, b, lr):
        """Two first steps from one state: every element within 2 lr (a
        first step's normalised update is at most 1 in size) and at most one
        in a hundred beyond lr / 10 (an element whose gradient sits within
        rounding of 0 may move the other way), as the CPU tests hold the
        port against the reference."""
        worst, far, total = params_apart(a, b, lr)
        if worst > 2.01 * lr or far > total / 100:
            fail(f"lm_train {label}: params {worst:.3g} apart, {far} of {total} "
                 f"beyond lr/10")
        return {"max_param_diff": worst, "beyond_lr_over_10": far, "elements": total}

    res = {"card": nvidia_smi("name,power.limit")}
    published = get_config(LM_ARCH)   # bf16, master weights, remat "full"
    opt_pub = opt_for(published, total=100)
    tokens_per_step = TRAIN_BATCH * TRAIN_SEQ
    held = {}

    # a. smollm-360m at full width and depth, bf16 + master weights + remat
    def a():
        data = SyntheticTokens(TokenPipelineConfig(
            vocab_size=published.vocab_size, seq_len=TRAIN_SEQ,
            global_batch=TRAIN_BATCH, seed=0, structured=True))
        state = held["state"] = ts_lib.init_train_state(0, published, opt_pub, device=dev)
        step = ts_lib.make_train_step(published, opt_pub)
        losses, times = [], []
        torch.cuda.reset_peak_memory_stats(dev)
        start_bytes = torch.cuda.memory_allocated(dev)
        for i in range(TRAIN_WARMUP + TRAIN_TIMED):
            batch = to_dev(next(data), dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            m = metrics_of(m)  # waits for the step
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(m["loss"])
        peak = torch.cuda.max_memory_allocated(dev)
        if not all(math.isfinite(x) for x in losses):
            fail(f"lm_train a: losses {losses}")
        if not losses[-1] < losses[0]:
            fail(f"lm_train a: the loss did not fall: {losses}")
        step_ms = float(np.median(times[TRAIN_WARMUP:]))
        flops = 6 * published.active_param_count() * tokens_per_step
        held["batch"] = batch = to_dev(next(data), dev)
        r = {"params": sum(p.numel() for p in state["params"].parameters()),
             "active_params": published.active_param_count(),
             "tokens_per_step": tokens_per_step, "losses": losses,
             "step_ms": step_ms, "step_ms_all": times,
             "tokens_per_s": tokens_per_step / (step_ms / 1e3),
             "model_flops_per_step": flops,
             "bf16_peak_share": flops / (step_ms / 1e3) / BF16_TENSOR_OPS_PER_S,
             "peak_memory_gb": peak / 1e9, "start_memory_gb": start_bytes / 1e9}
        r["step_profile"] = profile_step(lambda: step(state, batch), iters=TRAIN_PROFILED)
        print(f"lm_train a smollm-360m bf16 remat full, {TRAIN_BATCH}x{TRAIN_SEQ}: "
              f"{step_ms:.2f} ms/step, {r['tokens_per_s']:.0f} tok/s, "
              f"{r['bf16_peak_share']:.4f} of the bf16 peak, peak "
              f"{r['peak_memory_gb']:.3f} GB, idle "
              f"{r['step_profile']['device_idle_share']:.3f}, loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}", flush=True)
        return r
    res["a_smollm_bf16"] = part("a", a)

    # b. one step with remat "full" and one with "none" from the same state
    def b():
        runs = {}
        base = held.pop("state")
        for remat in ("full", "none"):
            cfg = dataclasses.replace(published, remat=remat)
            state = copy.deepcopy(base)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            start = torch.cuda.memory_allocated(dev)
            state, m = ts_lib.make_train_step(cfg, opt_pub)(state, held["batch"])
            m = metrics_of(m)
            peak = torch.cuda.max_memory_allocated(dev)
            runs[remat] = (state, m, {"loss": m["loss"], "grad_norm": m["grad_norm"],
                                      "peak_memory_gb": peak / 1e9,
                                      "peak_above_start_gb": (peak - start) / 1e9})
        del base
        (sf, mf, rf), (sn, mn, rn) = runs["full"], runs["none"]
        for k in ("loss", "grad_norm"):
            # bf16 activations: the two backward passes may round otherwise
            if abs(mf[k] - mn[k]) > 2.0 ** -8 * abs(mn[k]):
                fail(f"lm_train b: {k} {mf[k]} with remat, {mn[k]} without")
        r = {"full": rf, "none": rn,
             **check_apart("b", sf, sn, float(mf["lr"]))}
        print(f"lm_train b remat full / none: loss {mf['loss']:.6f} / {mn['loss']:.6f}, "
              f"peak {rf['peak_memory_gb']:.3f} / {rn['peak_memory_gb']:.3f} GB, "
              f"params {r['max_param_diff']:.3g} apart", flush=True)
        return r
    res["b_remat"] = part("b", b)
    held.clear()
    torch.cuda.empty_cache()

    # c. one f32 step of every reduced arch on the card and on the CPU
    def c():
        runs = {}
        cpu = torch.device("cpu")
        for arch in ARCH_IDS:
            if arch == "boundswitch-h32":
                continue
            cfg = get_config(arch).reduced(remat="none", dtype="float32")
            oc = opt_for(cfg, lr=3e-4, total=10)
            host = api.init(0, cfg, device=cpu)
            card = copy.deepcopy(host).to(dev)
            rng = np.random.default_rng(0)
            bnp = {"tokens": rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)}
            if cfg.frontend == "patch":
                bnp["patch_embeds"] = rng.normal(
                    size=(2, cfg.frontend_len, cfg.d_model)).astype(np.float32)
            if cfg.family == "encdec":
                bnp["frames"] = rng.normal(size=(2, 32, cfg.d_model)).astype(np.float32)
            if cfg.bank_mode in ("adapter", "head"):
                bnp["slot_ids"] = rng.integers(0, cfg.bank_slots, (2,)).astype(np.int32)
            bnp["labels"] = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
            bnp["loss_mask"] = np.ones((2, 32), np.float32)
            got = {}
            for name, model, device in (("cuda", card, dev), ("cpu", host, cpu)):
                st, m = ts_lib.make_train_step(cfg, oc)(state_for(model, oc),
                                                        to_dev(bnp, device))
                got[name] = (st, metrics_of(m))
            (sc, mc), (sh, mh) = got["cuda"], got["cpu"]
            for k in ("loss", "grad_norm"):
                if abs(mc[k] - mh[k]) > STEP_RTOL * abs(mh[k]):
                    fail(f"lm_train c {arch}: {k} {mc[k]} on the card, {mh[k]} on the CPU")
            runs[arch] = {"loss": [mc["loss"], mh["loss"]],
                          "grad_norm": [mc["grad_norm"], mh["grad_norm"]],
                          **check_apart(f"c {arch}", sc, sh, oc.learning_rate)}
        worst = max(r["max_param_diff"] for r in runs.values())
        print(f"lm_train c card against CPU: {len(runs)} archs, loss and grad norm "
              f"within {STEP_RTOL}, params at most {worst:.3g} apart", flush=True)
        return runs
    res["c_card_vs_cpu"] = part("c", c)

    # d. mamba2-130m at full width and depth, bf16
    def d():
        cfg = get_config(SSM_ARCH)
        oc = opt_for(cfg)
        data = SyntheticTokens(TokenPipelineConfig(
            vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH))
        state = ts_lib.init_train_state(0, cfg, oc, device=dev)
        step = ts_lib.make_train_step(cfg, oc)
        losses, times = [], []
        for _ in range(SSM_TRAIN_STEPS):
            batch = to_dev(next(data), dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            times.append((time.perf_counter() - t0) * 1e3)
        if not all(math.isfinite(x) for x in losses):
            fail(f"lm_train d: losses {losses}")
        r = {"params": sum(p.numel() for p in state["params"].parameters()),
             "losses": losses, "step_ms_all": times,
             "step_ms": float(np.median(times[1:])), "remat": cfg.remat,
             "dtype": cfg.dtype}
        print(f"lm_train d mamba2-130m bf16: {r['step_ms']:.2f} ms/step, losses "
              f"{[round(x, 4) for x in losses]}", flush=True)
        return r
    res["d_mamba2_bf16"] = part("d", d)
    torch.cuda.empty_cache()

    # e. preempt and resume on the card; the launcher in subprocesses
    work = os.path.join(ROOT, "build", "train")
    os.makedirs(work, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    extra = [] if dev.type == "cuda" else ["--device", str(dev)]
    launches = {name: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *argv, *extra], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, argv in (
            ("defaults", []),
            ("compressed_microbatched", ["--compress-gradients", "--microbatches", "2",
                                         "--checkpoint-dir",
                                         os.path.join(work, "launcher_ckpt")]))}

    def e():
        cfg = get_config(LM_ARCH).reduced(n_layers=1, dtype="float32", remat="none")
        oc = OptimizerConfig(warmup_steps=0, total_steps=50, learning_rate=1e-3)
        dcfg = TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
        with tempfile.TemporaryDirectory(dir=work) as d:
            flag = os.path.join(d, "preempt")

            def trainer(name, **kw):
                return Trainer(cfg, oc, TrainerConfig(
                    total_steps=2 * RESUME_STEPS, checkpoint_every=100,
                    checkpoint_dir=os.path.join(d, name), **kw),
                    SyntheticTokens(dcfg), device=dev)
            full = trainer("full")
            if full.run() != {"status": "done", "steps_run": 2 * RESUME_STEPS}:
                fail("lm_train e: the uninterrupted run did not finish")
            cut = trainer("cut", preempt_flag_file=flag)
            real = cut.step_fn

            def step(state, batch):
                state, m = real(state, batch)
                if int(state["step"]) == RESUME_STEPS:
                    open(flag, "w").close()
                return state, m
            cut.step_fn = step
            first = cut.run()
            if first != {"status": "preempted", "steps_run": RESUME_STEPS}:
                fail(f"lm_train e: preemption gave {first}")
            os.remove(flag)
            resumed = trainer("cut")
            if not resumed.try_restore() or int(resumed.state["step"]) != RESUME_STEPS \
                    or resumed.data.cursor != RESUME_STEPS:
                fail("lm_train e: the checkpoint did not restore at the preemption")
            second = resumed.run()
            worst, _, _ = params_apart(full.state, resumed.state, 0.0)
            if worst > RESUME_ATOL:
                fail(f"lm_train e: the resumed run is {worst} from the uninterrupted one")
        return {"first": first, "second": second, "max_param_diff": worst}
    try:
        r = part("e", e)
        r["launcher"] = {}
        for name, proc in launches.items():
            stdout, stderr = proc.communicate(timeout=TRAIN_TIMEOUT_S)
            lines = stdout.strip().splitlines()
            r["launcher"][name] = {"exit": proc.returncode, "lines": lines[:1] + lines[-1:],
                                   "stderr_tail": stderr.strip().splitlines()[-1:]}
            if proc.returncode or not lines or \
                    lines[0] != "{'status': 'done', 'steps_run': 100}":
                fail(f"lm_train e: launcher {name}: {r['launcher'][name]}")
    finally:
        for proc in launches.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"lm_train e resume: {r['first']} then {r['second']}, "
          f"{r['max_param_diff']:.3g} from the uninterrupted run; launcher "
          f"{ {k: v['lines'] for k, v in r['launcher'].items()} }", flush=True)
    res["e_resume_launcher"] = r
    out.update(res)
    print(json.dumps({"lm_train": res}), flush=True)


DIST_STEPS = 3                     # (a)'s steps, sharded and unsharded
DRYRUN_CELLS = (                   # (d): (arch, shape, mesh)
    ("smollm-360m", "train_4k", "single"), ("smollm-360m", "train_4k", "multi"),
    ("smollm-360m", "prefill_32k", "single"), ("smollm-360m", "prefill_32k", "multi"),
    ("smollm-360m", "decode_32k", "single"), ("smollm-360m", "decode_32k", "multi"),
    ("arctic-480b", "prefill_32k", "single"), ("glm4-9b", "decode_32k", "single"),
    # the layouts repaired against the reference's per-rank work
    ("mamba2-130m", "prefill_32k", "single"), ("zamba2-7b", "prefill_32k", "single"),
    ("llava-next-34b", "prefill_32k", "single"),
    ("seamless-m4t-medium", "decode_32k", "single"),
    ("h2o-danube-3-4b", "long_500k", "single"), ("olmoe-1b-7b", "train_4k", "single"),
    ("arctic-480b", "train_4k", "single"),
    # the SSM block's uneven split; an FSDP cell's attention share
    ("mamba2-130m", "train_4k", "single"), ("glm4-9b", "train_4k", "single"))
HILLCLIMB_BASELINES = (("smollm-360m", "train_4k", "single"),
                       ("arctic-480b", "prefill_32k", "single"),
                       ("glm4-9b", "decode_32k", "single"))
DRYRUN_DIR = os.path.join(ROOT, "build", "dryrun_torch")
PERF_DIR = os.path.join(ROOT, "build", "perf_torch")
DRYRUN_TIMEOUT_S = 900


def run_lm_dist_phase(*, counted, dev, out) -> None:
    """Phase 11 (a to e of the module docstring): the distribution and
    tooling layer on the card, each part with the BNN kernels' launch
    counts set to 0 around it (the layer launches none of them)."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.registry import get_config
    from repro_torch.data.tokens import SyntheticTokens, TokenPipelineConfig
    from repro_torch.distributed import compress, sharding
    from repro_torch.distributed import roofline as rf
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import train_step as ts_lib
    from repro_torch.train.optimizer import OptimizerConfig

    def part(label, fn):
        result, n = counted(fn)
        launched = {k: v for k, v in n.items() if v}
        if launched:
            fail(f"lm_dist {label}: BNN kernels launched on the LM path: {launched}")
        return result

    res = {"card": nvidia_smi("name,power.limit")}
    cfg = get_config(LM_ARCH)   # bf16, master weights, remat "full"
    opt_cfg = OptimizerConfig(learning_rate=TRAIN_LR, warmup_steps=2, total_steps=100,
                              moments_dtype=cfg.moments_dtype,
                              master_weights=cfg.master_weights)
    data = SyntheticTokens(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        seed=0, structured=True))
    batches = [{k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in next(data).items()}
               for _ in range(DIST_STEPS + 1)]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    held = {}
    try:
        # a. the sharded step against the unsharded one, on a (1, 1) mesh
        def a():
            mesh = held["mesh"] = make_host_mesh()
            rules = dryrun.rules_for(cfg, "train", mesh)
            step = ts_lib.make_train_step(cfg, opt_cfg)
            plain = ts_lib.init_train_state(0, cfg, opt_cfg, device=dev)
            shard = ts_lib.init_train_state(0, cfg, opt_cfg, device=dev)
            pspecs, dropped = sharding.legalize(
                sharding.param_specs(shard["params"], rules),
                dict(shard["params"].named_parameters()), mesh)
            bspecs, _ = sharding.legalize(sharding.batch_specs(batches[0], rules),
                                          sharding.tree_paths(batches[0]), mesh)
            specs = {"params": pspecs, "batch": bspecs,
                     "opt": sharding.opt_state_specs(pspecs, shard["opt"])}
            shard, _ = sharding.distribute_state(shard, mesh, specs)
            runs = {"sharded": [], "unsharded": []}
            times = {"sharded": [], "unsharded": []}
            for batch in batches[:DIST_STEPS]:
                for name in ("unsharded", "sharded"):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    if name == "sharded":
                        with implicit_replication():
                            _, m = step(shard, sharding.distribute_tree(batch, mesh, bspecs))
                        m = {k: v.full_tensor() if hasattr(v, "full_tensor") else v
                             for k, v in m.items()}
                    else:
                        _, m = step(plain, batch)
                    m = {k: float(v) for k, v in m.items()}  # waits for the step
                    times[name].append((time.perf_counter() - t0) * 1e3)
                    runs[name].append(m)
            for i, (mp, ms) in enumerate(zip(runs["unsharded"], runs["sharded"])):
                for k in ("loss", "grad_norm"):
                    if mp[k] != ms[k]:
                        fail(f"lm_dist a: step {i} {k} {ms[k]!r} sharded, {mp[k]!r} not")
            whole = sharding.gather_state(shard)
            for key in ("params", "master", "m", "v"):
                ours = (list(whole["params"].parameters()) if key == "params"
                        else whole["opt"][key])
                theirs = (list(plain["params"].parameters()) if key == "params"
                          else plain["opt"][key])
                for x, y in zip(ours, theirs):
                    if not torch.equal(x, y):
                        fail(f"lm_dist a: {key} differ from the unsharded step's")
            held["plain"] = plain
            # steps 2 on: the first fills DTensor's sharding caches
            r = {"mesh": list(mesh.shape), "dropped_shardings": len(dropped),
                 "losses": [m["loss"] for m in runs["sharded"]],
                 "sharded_step_ms": float(np.median(times["sharded"][1:])),
                 "unsharded_step_ms": float(np.median(times["unsharded"][1:])),
                 "step_ms_all": times}
            print(f"lm_dist a smollm-360m bf16 {TRAIN_BATCH}x{TRAIN_SEQ} on a "
                  f"{tuple(mesh.shape)} NCCL mesh: {DIST_STEPS} steps bit-equal to the "
                  f"unsharded ones (losses {r['losses']}); median step "
                  f"{r['sharded_step_ms']:.2f} ms sharded, {r['unsharded_step_ms']:.2f} "
                  f"ms unsharded (steps 2 on; the first {times['sharded'][0]:.1f} / "
                  f"{times['unsharded'][0]:.1f} ms)", flush=True)
            return r
        res["a_sharded_step"] = part("a", a)

        # b. compressed_psum over the NCCL group on every gradient leaf
        def b():
            mesh = held["mesh"]
            model = held["plain"]["params"]
            total, _ = ts_lib.make_loss_fn(cfg)(model, batches[DIST_STEPS])
            total.backward()
            grads = [p.grad for p in model.parameters()]
            for p in model.parameters():
                p.grad = None
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = [compress.compressed_psum(g, mesh, "data") for g in grads]
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            for g, c in zip(grads, got):
                if not torch.equal(c, compress.quantize_dequantize(g)):
                    fail("lm_dist b: compressed_psum differs from the codec")
            r = {"leaves": len(grads), "elements": sum(g.numel() for g in grads),
                 "ms_per_step": float(np.median(times))}
            print(f"lm_dist b compressed_psum over the NCCL group: {r['leaves']} "
                  f"gradient leaves bit-equal to quantize_dequantize, "
                  f"{r['ms_per_step']:.2f} ms per step", flush=True)
            return r
        res["b_compressed_psum"] = part("b", b)
    finally:
        dist.destroy_process_group()

    # c. the roofline of phase 10's step (counted apart from the timed steps)
    def c():
        state = held.pop("plain")
        step = ts_lib.make_train_step(cfg, opt_cfg)
        _, analysis = rf.count_step(step, state, batches[0])
        torch.cuda.synchronize()
        terms = rf.roofline_terms(analysis)
        mf = 6.0 * cfg.active_param_count() * TRAIN_BATCH * TRAIN_SEQ
        step_ms = res["a_sharded_step"]["unsharded_step_ms"]
        r = {"analysis": analysis, "roofline": terms, "model_flops": mf,
             "useful_flops_ratio": mf / analysis["dot_flops"], "step_ms": step_ms,
             "bound_share": terms["step_s_lower_bound"] / (step_ms / 1e3)}
        print(f"lm_dist c roofline of one smollm-360m bf16 step: dot_flops "
              f"{analysis['dot_flops']:.4g}, hbm_bytes {analysis['hbm_bytes']:.4g}, "
              f"model_flops {mf:.4g}, useful {r['useful_flops_ratio']:.4f}; compute "
              f"{terms['compute_s'] * 1e3:.3f} ms, memory {terms['memory_s'] * 1e3:.3f} "
              f"ms, collective {terms['collective_s'] * 1e3:.3f} ms ({terms['dominant']}); "
              f"step {step_ms:.2f} ms = {r['bound_share']:.4f} of its bound", flush=True)
        return r
    res["c_roofline"] = part("c", c)

    # d. the dry-run, the hillclimb and the two reports, on the host: every
    # cell in a process of its own, all at once; the hillclimb starts once
    # its three baselines are written, beside the cells still running
    def d():
        import shutil

        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        for path in (DRYRUN_DIR, PERF_DIR):  # no cell of an earlier run
            shutil.rmtree(path, ignore_errors=True)
        os.makedirs(DRYRUN_DIR)

        def tool(name, *argv):
            return subprocess.Popen(
                [sys.executable, os.path.join(ROOT, "benchmarks_torch", f"{name}.py"),
                 *argv], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)

        def finish(label, proc):
            log = proc.communicate(timeout=DRYRUN_TIMEOUT_S)[0]
            if proc.returncode != 0:
                fail(f"lm_dist d: {label} exit {proc.returncode}: {log[-2000:]}")
            return log

        t0 = time.perf_counter()
        procs = {cell: subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", cell[0],
             "--shape", cell[1], "--mesh", cell[2], "--out", DRYRUN_DIR], cwd=ROOT,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for cell in DRYRUN_CELLS}
        hill = None
        try:
            for arch, shape, mesh in HILLCLIMB_BASELINES:
                finish(f"{arch} {shape} {mesh}", procs[(arch, shape, mesh)])
            hill = tool("hillclimb", "--baseline-dir", DRYRUN_DIR, "--out", PERF_DIR)
            for cell, proc in procs.items():
                finish(" ".join(cell), proc)
            baseline_s = time.perf_counter() - t0
            hill_log = finish("hillclimb", hill)
        finally:
            for proc in [*procs.values(), hill]:
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()
        cells = {}
        for arch, shape, mesh in DRYRUN_CELLS:
            with open(os.path.join(DRYRUN_DIR, f"{arch}_{shape}_{mesh}.json")) as f:
                cell = json.load(f)
            if cell["status"] != "ok":
                fail(f"lm_dist d: {cell['cell']} {cell['status']}: {cell.get('error')}")
            rl = cell["roofline"]
            cells[cell["cell"]] = {
                "compute_s": rl["compute_s"], "memory_s": rl["memory_s"],
                "collective_s": rl["collective_s"], "dominant": rl["dominant"],
                "gib_per_device": cell["memory"]["per_device_total"] / 2 ** 30,
                "useful_flops_ratio": cell["useful_flops_ratio"],
                "seconds": cell["compile_seconds"]}
            print(f"lm_dist d {cell['cell']}: compute {rl['compute_s']:.4g} s, memory "
                  f"{rl['memory_s']:.4g} s, collective {rl['collective_s']:.4g} s, "
                  f"{rl['dominant']}, {cells[cell['cell']]['gib_per_device']:.2f} GiB "
                  f"per device, {cell['compile_seconds']:.1f} s", flush=True)
            # the per-rank work against the reference's table (dryrun.AIM)
            fid = cell["fidelity"]
            if fid is None:
                fail(f"lm_dist d: {cell['cell']} has no entry in the reference's table")
            cells[cell["cell"]]["fidelity"] = fid
            rest = (f", without attention x{fid['rest_ratio']:.4f} (attention "
                    f"x{fid['attention_ratio']:.4f}" if "rest_ratio" in fid else "")
            if "attention_share" in fid:
                rest += f", x{fid['attention_share']:.4f} of its share"
            rest += ")" if rest else ""
            print(f"lm_dist d {cell['cell']} against the reference: dot_flops "
                  f"x{fid['dot_flops_ratio']:.4f}{rest}, argument_bytes "
                  f"{fid['argument_bytes_extra']:+d}", flush=True)
            if not fid["in_aim"]:
                fail(f"lm_dist d: {cell['cell']} misses the aim against the reference: {fid}")
        logs = {"hillclimb": hill_log,
                "roofline": finish("roofline", tool("roofline", "--dir", DRYRUN_DIR)),
                "report": finish("report", tool("report", "--dir", DRYRUN_DIR))}
        for name, log in logs.items():
            for line in log.strip().splitlines():
                if line.strip() and not line.startswith("[rank"):
                    print(f"lm_dist d {name}: {line}", flush=True)
        return {"cells": cells, "seconds": time.perf_counter() - t0,
                "baseline_seconds": baseline_s}
    res["d_dryrun"] = part("d", d)

    # e. the port's docs lint
    def e():
        proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.doclint"],
                              cwd=ROOT, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            fail(f"lm_dist e: doclint: {proc.stdout[-2000:]}")
        print(f"lm_dist e {proc.stdout.strip()}", flush=True)
        return {"clean": True}
    res["e_doclint"] = part("e", e)
    out.update(res)
    print(json.dumps({"lm_dist": res}), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    from benchmarks_torch.fig8m_megastep import sweep
    from repro_torch.control import SlotCache, load_epoch_spill
    from repro_torch.core import bank as bank_lib
    from repro_torch.core import executor, packet as pkt, pipeline, switching
    from repro_torch.data import packets as pk
    from repro_torch.dataplane import (DataplaneRuntime, FaultInjector,
                                       emergency_phases, megastep, play, render,
                                       workloads)
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import banked_matmul as bm
    from repro_torch.kernels import bnn_xnor, fused_forward as ff
    from repro_torch.kernels import decode_attention as da
    from repro_torch.launch import packetpath
    from repro_torch.train import bnn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = executor.H32
    H, C, W, D = cfg.hidden, cfg.n_out, cfg.words, cfg.d_bits

    # -- 1. the card ----------------------------------------------------------
    print(nvidia_smi("name,power.limit"), flush=True)

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    probe = os.path.join(ROOT, "build", "bmma_rate", "bmma_rate")
    os.makedirs(os.path.dirname(probe), exist_ok=True)
    probe_nvcc = subprocess.Popen(
        [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
         "-o", probe, os.path.join(ROOT, "benchmarks_torch", "bmma_rate.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        logs = _build.build_all()
    finally:
        probe_log, _ = probe_nvcc.communicate()
    if probe_nvcc.returncode:
        fail(f"nvcc failed for bmma_rate.cu:\n{probe_log}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas[{name}]: {line.strip()}")
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s", flush=True)

    def time_ms(fn, iters: int, repeats: int = 5) -> float:
        """Median over ``repeats`` of the mean time of ``iters`` calls."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / iters)
        return float(np.median(times))

    warm_up_clocks(dev)  # before the probe and the first timing
    rates = [json.loads(line) for line in subprocess.run(
        [probe], capture_output=True, text=True, check=True, timeout=120).stdout.splitlines()]
    print(json.dumps({"binary_mma_rates": rates}), flush=True)
    b1 = [r for r in rates if r["family"].startswith("b1.and.popc")]
    if len(b1) != 1 or b1[0]["err"] != "no error" or not b1[0]["bit_macs_per_s"] > 0:
        fail(f"the b1 MMA rate probe gave {rates}")
    b1_bit_macs_per_s = b1[0]["bit_macs_per_s"]

    def bound(nbytes: int, bit_macs: float, fp32_ops: float,
              bf16_ops: float = 0.0) -> tuple[float, str]:
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = (bit_macs / b1_bit_macs_per_s + fp32_ops / FP32_OPS_PER_S
                 + bf16_ops / BF16_TENSOR_OPS_PER_S)
        return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"

    def nbytes(*ts) -> int:
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    def used_slots(block_slots) -> int:
        """Distinct slots a slot table reads: the weights the work needs."""
        return int(torch.unique(block_slots).numel())

    # -- 3. each kernel against its plain version at full width ---------------
    entries = {}

    def record(key, name, source, replaces, err, run_k, run_p, b_ms, b_by,
               *, call=None, library=None):
        """Time the kernel (device time), the wrapper call, its plain
        version and the library call, and keep the kernel's line entry."""
        ms = kernel_device_ms(run_k)
        call_ms, plain_ms = time_ms(call or run_k, 20), time_ms(run_p, 3)
        library_ms = kernel_device_ms(library) if library is not None else None
        entries[key] = {"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": 0,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": library_ms, "call_ms": call_ms}
        lib = "" if library_ms is None else f" library_ms={library_ms:.5f}"
        print(f"check {name}: max_abs_err={err:.3g} ms={ms:.5f} call_ms={call_ms:.5f} "
              f"plain_ms={plain_ms:.5f} bound_ms={b_ms:.5f} ({b_by}){lib}", flush=True)

    def packets_for(rng, k, n=N):
        payload = rng.integers(0, 2**32, (n, pkt.PAYLOAD_WORDS), dtype=np.uint32)
        p = pkt.make_packets(rng.integers(0, k, n), payload)
        p[:, pkt.CONTROL_WORD_LO] = rng.integers(0, 2, n, dtype=np.uint32)
        return pkt.to_device(p, dev)

    fused_src = "src/repro_torch/kernels/csrc/fused_forward.cu"
    fused_tpu = "src/repro/kernels/fused_forward.py:229"
    banks = {}
    fused_cases = []
    for k in (2, 16):
        rng = np.random.default_rng(k)
        bank = executor.init_bank(rng, k, device=dev)
        x = packets_for(rng, k)
        banks[k] = (bank, x)
        g = bank_lib.group_by_slot_padded(pkt.slot_of(x, k), k, BLOCK_B)
        payload = pkt.payload_of(x)
        x_pad = bank_lib.scatter_padded(payload, g)
        fused_cases += [
            (k, "", bank, g, "gather/meta16/actions", x, g.row_ids, 16, True),
            (k, "", bank, g, "gather/meta0", payload, g.row_ids, 0, False),
            (k, "", bank, g, "contiguous/meta0", x_pad, None, 0, False),
        ]
    # The data plane's shape: one queue's batch of DP_BATCH packets.
    x_dp = packets_for(np.random.default_rng(DP_BATCH), K_DB, DP_BATCH)
    g_dp = bank_lib.group_by_slot_padded(pkt.slot_of(x_dp, K_DB), K_DB, BLOCK_B)
    fused_cases.append((K_DB, f"/B{DP_BATCH}", banks[K_DB][0], g_dp,
                        "gather/meta16/actions", x_dp, g_dp.row_ids, 16, True))
    # The megastep window's shape: one (WINDOW_TICKS x 4 queues x batch)
    # slab over the extended bank (K base slots + EPOCH_CAPACITY swap
    # deltas), rows grouped by their extended slot.
    k_ext = K_DB + megastep.EPOCH_CAPACITY
    rng = np.random.default_rng(k_ext)
    x_win = packets_for(rng, K_DB, WINDOW_TICKS * DP_QUEUES * DP_BATCH)
    es_win = torch.from_numpy(rng.integers(0, k_ext, x_win.shape[0])).to(dev)
    g_win = bank_lib.group_by_slot_padded(es_win, k_ext, BLOCK_B)
    bank_win = executor.init_bank(rng, k_ext, device=dev)
    fused_cases.append((f"{K_DB}+{megastep.EPOCH_CAPACITY}", megastep.WINDOW_TAG,
                        bank_win, g_win, "gather/meta16/actions", x_win, g_win.row_ids,
                        16, True))
    # The CLI's runtimes keep the runtime's default block_b (CLI_BLOCK_B):
    # one queue's batch, the four queues stacked (the vmap and shard_map
    # fan-outs), and the window slab, each grouped at that block size.
    x_st = packets_for(np.random.default_rng(DP_QUEUES * DP_BATCH), K_DB,
                       DP_QUEUES * DP_BATCH)
    for xin, es, k, bank, shape in (
            (x_dp, pkt.slot_of(x_dp, K_DB), K_DB, banks[K_DB][0],
             f"/B{DP_BATCH}/bb{CLI_BLOCK_B}"),
            (x_st, pkt.slot_of(x_st, K_DB), K_DB, banks[K_DB][0],
             f"/B{DP_QUEUES * DP_BATCH}/bb{CLI_BLOCK_B}"),
            (x_win, es_win, f"{K_DB}+{megastep.EPOCH_CAPACITY}", bank_win,
             f"{megastep.WINDOW_TAG}/bb{CLI_BLOCK_B}")):
        g = bank_lib.group_by_slot_padded(es, bank["b1"].shape[0], CLI_BLOCK_B)
        fused_cases.append((k, shape, bank, g, "gather/meta16/actions", xin,
                            g.row_ids, 16, True))
    for k, shape, bank, g, variant, xin, rows, meta, act in fused_cases:
        bb = g.b_pad // g.block_slots.numel()
        name = (f"fused_forward {variant} K={k}" + (f" B={xin.shape[0]}" if shape else "")
                + (f" block_b={bb}" if bb != BLOCK_B else ""))
        bank_args = (bank["w1p"], bank["b1"], bank["w2"], bank["b2"])
        kw = dict(block_b=bb, meta_words=meta, with_actions=act)
        run_k = lambda: ff.fused_forward(xin, *bank_args, g.block_slots, rows, **kw)  # noqa: E731
        run_p = lambda: ff.fused_forward_ref(xin, *bank_args, g.block_slots, rows, **kw)  # noqa: E731
        got, want = run_k(), run_p()
        torch.cuda.synchronize()
        if act:
            if not torch.equal(got[1], want[1]):
                fail(f"{name}: actions differ in "
                     f"{int((got[1] != want[1]).sum())} rows")
            got, want = got[0], want[0]
        if not torch.allclose(got, want, atol=ATOL, rtol=RTOL):
            fail(f"{name}: scores differ by {float((got - want).abs().max())}")
        n_rows = g.b_pad
        # With metadata, a packet's bytes read are its payload and the
        # one 32-byte sector holding the control word, not the whole row.
        x_bytes = xin.shape[0] * (W * 4 + 32) if meta else nbytes(xin)
        b_ms, b_by = bound(
            x_bytes + nbytes(rows, g.block_slots, *bank_args)
            + n_rows * C * 4 + (n_rows * 4 if act else 0),
            n_rows * H * D, 2.0 * n_rows * H * C)
        record(f"{variant}/K{k}{shape}", name, fused_src, fused_tpu,
               float((got - want).abs().max()), run_k, run_p, b_ms, b_by)

    def check_xnor(xin, w):
        """``xnor_matmul`` on (B, W) rows ``xin`` and (H, W) weights ``w``
        against its plain version, timed with ``torch._int_mm`` on the
        unpacked +-1 operands as the library yardstick, under ``xnor/B{B}``."""
        b = xin.shape[0]
        run_k = lambda: bnn_xnor.xnor_matmul(xin, w)  # noqa: E731
        run_p = lambda: ref.xnor_matmul_ref(xin, w)  # noqa: E731
        got, want = run_k(), run_p()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"xnor_matmul B={b}: {int((got != want).sum())} dot products differ")
        library, refused = None, f"it needs more than {INT_MM_MIN_ROWS} rows"
        if b > INT_MM_MIN_ROWS:
            x_pm = ref.unpack_bits(xin, D)
            w_pm = ref.unpack_bits(w, D).t()  # (d, H) +-1 int8, column-major
            try:
                y_pm = torch._int_mm(x_pm, w_pm)
            except RuntimeError as e:
                refused = str(e).splitlines()[0]
            else:
                if not torch.equal(y_pm, want):
                    fail(f"xnor_matmul B={b}: torch._int_mm on the unpacked operands differs")
                library = lambda: torch._int_mm(x_pm, w_pm)  # noqa: E731
        if library is None:
            print(f"xnor_matmul B={b}: no library time, torch._int_mm refuses the shape: "
                  f"{refused}", flush=True)
        b_ms, b_by = bound(nbytes(xin, w) + b * H * 4, b * H * D, 0.0)
        record(f"xnor/B{b}", f"xnor_matmul B={b}",
               "src/repro_torch/kernels/csrc/xnor_matmul.cu",
               "src/repro/kernels/bnn_xnor.py:79", 0.0, run_k, run_p, b_ms, b_by,
               library=library)
        entries[f"xnor/B{b}"]["warps"] = bnn_xnor.xnor_warps(b, H)

    bank, x = banks[2]
    for b in XNOR_ROWS:
        check_xnor(pkt.payload_of(x)[:b], bank["w1p"][0])
    launch_floor = torch.zeros(32, dtype=torch.int32, device=dev)  # 128 bytes
    print(json.dumps({"launch_floor_ms": kernel_device_ms(lambda: launch_floor.add_(1))}),
          flush=True)

    # The kernel-level double bank: two K = 16 banks stacked into one
    # (2K, ...) allocation, steered by the device scalar ``active``.
    rng = np.random.default_rng(31)
    front = executor.init_bank(rng, K_DB, device=dev)
    back = executor.init_bank(rng, K_DB, device=dev)
    both = bm.stack_double_bank(front, back)
    active = torch.zeros((), dtype=torch.int32, device=dev)
    halves = {}  # single-half kernel results, held against the flips of phase 4
    x_db = packets_for(rng, K_DB)
    xw = pkt.payload_of(x_db)
    bs_x = torch.from_numpy(rng.integers(0, K_DB, N // BLOCK_B)).to(dev, torch.int32)
    for act_v, half in ((0, front), (1, back)):
        active.fill_(act_v)
        fl_x = bm.flip_slots(bs_x, active, K_DB)
        run_k = lambda: bm.banked_xnor_layer1(xw, both["w1p"], both["b1"], fl_x, block_b=BLOCK_B)  # noqa: E731
        run_p = lambda: bm.banked_xnor_layer1_ref(xw, both["w1p"], both["b1"], fl_x, block_b=BLOCK_B)  # noqa: E731
        got, want = run_k(), run_p()
        single = bm.banked_xnor_layer1(xw, half["w1p"], half["b1"], bs_x, block_b=BLOCK_B)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"banked_xnor_layer1 active={act_v}: "
                 f"{int((got != want).sum())} pre-activations differ from the plain version")
        if not torch.equal(got, single):
            fail(f"banked_xnor_layer1 active={act_v}: the flip differs from the single half")
        halves[("xnor", act_v)] = single
    # the library yardstick: one batched product of the unpacked +-1 bf16
    # operands, f32 out (exact: |d| <= 8192 sums of +-1), the slots'
    # weights and biases gathered in the call as banked_matmul's is
    fl64, nb = fl_x.to(torch.int64), N // BLOCK_B
    x_pm = ref.unpack_bits(xw, D).to(torch.bfloat16).view(nb, BLOCK_B, D)
    w_pm = ref.unpack_bits(both["w1p"], D).to(torch.bfloat16).transpose(1, 2).contiguous()
    b1_db = both["b1"]
    library = lambda: torch.baddbmm(b1_db[fl64][:, None], x_pm, w_pm[fl64],  # noqa: E731
                                    out_dtype=torch.float32)
    lib_out = library()
    torch.cuda.synchronize()
    if not torch.equal(lib_out.reshape(N, H), got):
        fail("banked_xnor_layer1: torch.baddbmm on the unpacked operands differs from the kernel")
    b_ms, b_by = bound(N * W * 4 + used_slots(fl_x) * (H * W + H) * 4
                       + nbytes(fl_x) + N * H * 4, N * H * D, 0.0)
    record("banked_xnor", f"banked_xnor_layer1 K={K_DB}+{K_DB}",
           "src/repro_torch/kernels/csrc/banked_xnor_layer1.cu",
           "src/repro/kernels/banked_matmul.py:172", 0.0, run_k, run_p, b_ms, b_by,
           library=library)

    gen = torch.Generator().manual_seed(41)
    x_lm = torch.randn(N, LM_D, generator=gen)
    w_lm = [torch.randn(LM_SLOTS, LM_D, LM_D, generator=gen) / LM_D ** 0.5
            for _ in range(2)]
    b_lm = [torch.randn(LM_SLOTS, LM_D, generator=gen) * 0.1 for _ in range(2)]
    bs_mm = torch.from_numpy(rng.integers(0, LM_SLOTS, N // LM_BLOCK_B)).to(dev, torch.int32)
    gamma = (LM_D + 1) * F32_UNIT_ROUNDOFF / (1 - (LM_D + 1) * F32_UNIT_ROUNDOFF)
    # f32: the probabilistic bound on a sum of n = D + 1 rounded terms,
    # lambda sqrt(n) u sum|terms|, which fails with probability at most
    # 2 n exp(-lambda^2 / 2) per element (about 4e-19 at lambda = 10).  It
    # sits below the worst-case 2 gamma(n) bound; inputs rounded to TF32
    # (10 mantissa bits) break it, which the TF32 control below shows.
    gamma_prob = PROB_LAMBDA * (LM_D + 1) ** 0.5 * F32_UNIT_ROUNDOFF

    def tf32(t):
        """``t`` with its mantissa rounded to TF32's 10 bits (to nearest)."""
        return ((t.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)

    mm_inputs = {}
    for dtype in (torch.float32, torch.bfloat16):
        tname = str(dtype).removeprefix("torch.")
        if bm.matmul_variant(dtype, LM_D, LM_D) != MM_VARIANT[tname]:
            fail(f"banked_matmul {tname}: the LM width would not take {MM_VARIANT[tname]}")
        xm = x_lm.to(dev, dtype)
        wh = [t.to(dev, dtype) for t in w_lm]
        bh = [t.to(dev, dtype) for t in b_lm]
        w2, b2 = bm.stack_double_bank(*wh), bm.stack_double_bank(*bh)
        mm_inputs[tname] = (xm, w2, b2)
        for act_v in (0, 1):
            active.fill_(act_v)
            fl_mm = bm.flip_slots(bs_mm, active, LM_SLOTS)
            run_k = lambda: bm.banked_matmul(xm, w2, b2, fl_mm, block_b=LM_BLOCK_B)  # noqa: E731
            run_p = lambda: bm.banked_matmul_ref(xm, w2, b2, fl_mm, block_b=LM_BLOCK_B)  # noqa: E731
            got, want = run_k(), run_p()
            single = bm.banked_matmul(xm, wh[act_v], bh[act_v], bs_mm, block_b=LM_BLOCK_B)
            absref = bm.banked_matmul_ref(xm.float().abs(), w2.float().abs(),
                                          b2.float().abs(), fl_mm, block_b=LM_BLOCK_B)
            torch.cuda.synchronize()
            if not torch.equal(got, single):
                fail(f"banked_matmul {tname} active={act_v}: the flip differs "
                     "from the single half")
            diff = (got.float() - want.float()).abs()
            beyond_ulp = 0
            if dtype == torch.bfloat16:
                mag = torch.maximum(got.float().abs(), want.float().abs())
                ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(2.0 ** -126))) - 7)
                beyond_ulp = int((diff > ulp).sum())
                allowed = 2 * gamma * absref * 1.01 + ulp  # 1.01: absref's own rounding
            else:
                allowed = 2 * gamma_prob * absref * 1.01
                if act_v == 0:
                    # The control: the plain version on inputs rounded to
                    # TF32 must break the f32 limit, or the limit is too
                    # loose to tell a TF32 kernel from an f32 one.
                    ctl = bm.banked_matmul_ref(tf32(xm), tf32(w2), b2, fl_mm,
                                               block_b=LM_BLOCK_B)
                    ctl_diff = (ctl - want).abs()
                    ctl_beyond = int((ctl_diff > allowed).sum())
                    print(f"banked_matmul f32 TF32 control: max_abs_err="
                          f"{float(ctl_diff.max()):.3g}, {ctl_beyond} of {ctl.numel()} "
                          "elements beyond the f32 limit", flush=True)
                    if not ctl_beyond:
                        fail("banked_matmul f32: TF32-rounded inputs pass the f32 limit")
            if bool((diff > allowed).any()):
                fail(f"banked_matmul {tname} active={act_v}: {int((diff > allowed).sum())} "
                     f"elements beyond the tolerance (max err {float(diff.max())})")
            halves[("mm", tname, act_v)] = single
            print(f"banked_matmul {tname} active={act_v}: max_abs_err={float(diff.max()):.3g} "
                  f"max err/tolerance={float((diff / allowed).max()):.3g} "
                  f"elements beyond one ulp={beyond_ulp}", flush=True)
        fl64 = fl_mm.to(torch.int64)
        nb = N // LM_BLOCK_B
        library = lambda: torch.bmm(xm.view(nb, LM_BLOCK_B, LM_D), w2[fl64]) + b2[fl64][:, None]  # noqa: E731
        esz = xm.element_size()
        mm_bytes = esz * (N * LM_D + used_slots(fl_mm) * (LM_D * LM_D + LM_D)
                          + N * LM_D) + nbytes(fl_mm)
        mm_ops = 2.0 * N * LM_D * LM_D
        b_ms, b_by = (bound(mm_bytes, 0.0, mm_ops) if dtype == torch.float32
                      else bound(mm_bytes, 0.0, 0.0, bf16_ops=mm_ops))
        record(f"mm/{tname}", f"banked_matmul {tname} 8192x960x960 K={LM_SLOTS}+{LM_SLOTS}",
               "src/repro_torch/kernels/csrc/banked_matmul.cu",
               "src/repro/kernels/banked_matmul.py:106", float(diff.max()),
               run_k, run_p, b_ms, b_by, library=library)
        entries[f"mm/{tname}"]["variant"] = MM_VARIANT[tname]

    # The banked LM head (``models.lm.banked_logits``) on ``bf16/wgmma.f32out``
    # at chat-sat's shapes: a decode step's HEAD_ROWS rows, slots uniform
    # over HEAD_SLOTS, and a HEAD_PREFILL-token prompt on one slot, each
    # grouped as the head groups them (``lm.group_head_rows``); bf16
    # operands, f32 out, no bias.  The kernel within 2 gamma(D) sum|terms| of
    # its plain version (the same exact products summed in f32 in two
    # orders); "call" the whole head (grouping, kernel, row order, mask),
    # "library" one ``torch.bmm`` over each block's slot with an f32 output.
    from repro_torch.models import lm
    head_cfg = head_config()
    hd, hv = head_cfg.d_model, head_cfg.padded_vocab
    if bm.matmul_variant(torch.bfloat16, hd, hv, out_dtype=torch.float32) != \
            "bf16/wgmma.f32out":
        fail("banked_matmul: the head's shape would not take bf16/wgmma.f32out")
    hgen = torch.Generator(device=dev).manual_seed(43)
    head_bank = types.SimpleNamespace(w=(torch.randn(
        (HEAD_SLOTS, hd, hv), generator=hgen, device=dev) * hd ** -0.5).to(torch.bfloat16))
    gamma_head = hd * F32_UNIT_ROUNDOFF / (1 - hd * F32_UNIT_ROUNDOFF)
    hrng = np.random.default_rng(HEAD_ROWS)
    for key, rows, t, slot_np in (
            ("mm/bf16.f32out/head", HEAD_ROWS, 1, hrng.integers(0, HEAD_SLOTS, HEAD_ROWS)),
            ("mm/bf16.f32out/head/prefill", 1, HEAD_PREFILL, np.array([1]))):
        x_h = torch.randn((rows, t, hd), generator=hgen, device=dev).to(torch.bfloat16)
        ids_h = torch.from_numpy(slot_np).to(dev)
        slots_h = ids_h[:, None].expand(rows, t).reshape(-1)
        g_h, bs_h = lm.group_head_rows(slots_h, HEAD_SLOTS)
        xs_h = bank_lib.scatter_padded(x_h.reshape(-1, hd), g_h)
        kw_h = dict(block_b=lm.HEAD_BLOCK_B, out_dtype=torch.float32)
        run_k = lambda: bm.banked_matmul(xs_h, head_bank.w, None, bs_h, **kw_h)  # noqa: E731
        run_p = lambda: bm.banked_matmul_ref(xs_h, head_bank.w, None, bs_h, **kw_h)  # noqa: E731
        got, want = run_k(), run_p()
        absref = bm.banked_matmul_ref(xs_h.abs(), head_bank.w.abs(), None, bs_h, **kw_h)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        allowed = 2 * gamma_head * absref * 1.01  # 1.01: absref's own rounding
        if bool((diff > allowed).any()):
            fail(f"banked_matmul head {key}: {int((diff > allowed).sum())} elements beyond "
                 f"the tolerance (max err {float(diff.max())})")
        err = float(diff.max())
        print(f"banked_matmul head {key}: max_abs_err={err:.3g} max err/tolerance="
              f"{float((diff / allowed.clamp_min(1e-30)).max()):.3g}", flush=True)
        del want, absref, diff, allowed

        def head_call(x_h=x_h, ids_h=ids_h):
            with torch.inference_mode():
                return lm.banked_logits(head_bank, x_h, head_cfg, ids_h)

        nb_h = g_h.b_pad // lm.HEAD_BLOCK_B
        library = lambda: torch.bmm(  # noqa: E731
            xs_h.view(nb_h, lm.HEAD_BLOCK_B, hd), head_bank.w[bs_h.long()],
            out_dtype=torch.float32)
        n_h = rows * t
        b_ms, b_by = bound(used_slots(bs_h) * hd * hv * 2 + n_h * hd * 2 + n_h * hv * 4
                           + nbytes(bs_h), 0.0, 0.0, bf16_ops=2.0 * n_h * hd * hv)
        kind = "decode step" if t == 1 else f"{t}-token prefill"
        record(key, f"banked_matmul bf16 to f32 head, {kind}: {n_h} rows in {g_h.b_pad} "
               f"grouped, {hd}x{hv}, K={HEAD_SLOTS}",
               "src/repro_torch/kernels/csrc/banked_matmul.cu",
               "src/repro/models/lm.py:250", err, run_k, run_p, b_ms, b_by, call=head_call, library=library)
        entries[key]["variant"] = "bf16/wgmma.f32out"

    # Decode attention (``kernels.decode_attention``) at zamba2-7b-instruct.
    # chat64-sat's sites (64 rows, 32 groups of one head, D 224, L 1536, bf16,
    # lengths from the chat mix) and at phase 9 (a)'s f32 smollm-360m decode
    # (8 rows, 5 groups of 3 heads, D 64, L 512, lengths 4 to 55).  The kernel
    # within 2 (D + L) u of the sums of absolute terms of its plain version,
    # plus a bf16 ulp of each probability and of the output where those are
    # bf16 (tests/test_torch_cuda.py); bound: the valid K and V rows once, q,
    # the lengths and the output, and 4 D FLOPs a valid position and head in
    # f32; "library" ``scaled_dot_product_attention`` with the valid positions
    # as its mask, a yardstick the port never calls.  Launches: phase 9's
    # decodes, by the cache's dtype.
    drng = np.random.default_rng(DECODE_ROWS)
    for key, (b_a, g_a, gq_a, d_a, l_a, dt_a) in (
            ("attn/decode/bfloat16", (DECODE_ROWS, 32, 1, 224, HEAD_SEQ, torch.bfloat16)),
            ("attn/decode/float32", (LM_BATCH, 5, 3, 64, LM_SEQ, torch.float32))):
        if l_a == HEAD_SEQ:
            prompt = np.minimum(drng.lognormal(np.log(161.31) - 0.5, 1.0, b_a), 512)
            new = np.minimum(drng.lognormal(np.log(337.99) - 0.245, 0.7, b_a), 1024)
            cl_np = (prompt + drng.random(b_a) * new).astype(np.int64)
        else:
            cl_np = drng.integers(4, 48 + LM_NEW, b_a)
        agen = torch.Generator(device=dev).manual_seed(b_a)
        q_a, k_a, v_a = (torch.randn(s, generator=agen, device=dev, dtype=dt_a) for s in
                         ((b_a, g_a, gq_a, 1, d_a), (b_a, g_a, l_a, d_a), (b_a, g_a, l_a, d_a)))
        cl_a = torch.from_numpy(cl_np).to(dev)
        sc_a = d_a ** -0.5
        run_k = lambda: da.decode_attention(q_a, k_a, v_a, cl_a, sc_a, dt_a)  # noqa: E731
        run_p = lambda: da.decode_attention_ref(q_a, k_a, v_a, cl_a, sc_a, dt_a)  # noqa: E731
        got = run_k().float()
        want = da.decode_attention_ref(q_a, k_a, v_a, cl_a, sc_a, torch.float32)
        absref = da.decode_attention_ref(q_a, k_a, v_a.abs(), cl_a, sc_a, torch.float32)
        torch.cuda.synchronize()
        ulp = 2.0 ** -7 if dt_a == torch.bfloat16 else 0.0
        allowed = (2 * (d_a + l_a) * F32_UNIT_ROUNDOFF + ulp) * absref + ulp * want.abs()
        diff = (got - want).abs()
        if bool((diff > allowed).any()):
            fail(f"decode_attention {key}: {int((diff > allowed).sum())} elements beyond the "
                 f"tolerance (max err {float(diff.max())})")
        err = float(diff.max())
        del got, want, absref, diff, allowed
        mask_a = (torch.arange(l_a, device=dev)[None, :]
                  < torch.clamp(cl_a + 1, max=l_a)[:, None])[:, None, None]
        q_h = q_a.reshape(b_a, g_a * gq_a, 1, d_a)
        library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            q_h, k_a, v_a, attn_mask=mask_a, scale=sc_a, enable_gqa=gq_a > 1)
        valid = int(np.minimum(cl_np + 1, l_a).sum())
        b_ms, b_by = bound(2 * valid * g_a * d_a * k_a.element_size()
                           + 2 * nbytes(q_a) + nbytes(cl_a), 0.0,
                           4.0 * valid * g_a * gq_a * d_a)
        record(key, f"decode_attention {dt_a} cache: {b_a} rows x {g_a} groups of {gq_a}, "
               f"D {d_a}, L {l_a}, {100 * valid / (b_a * l_a):.1f} % valid",
               "src/repro_torch/kernels/csrc/decode_attention.cu",
               "src/repro/nn/modules.py:286 (jnp, no Pallas kernel)", err, run_k, run_p,
               b_ms, b_by, library=library)
        del q_a, k_a, v_a, mask_a, q_h
    torch.cuda.empty_cache()

    g_db = bank_lib.group_by_slot_padded(pkt.slot_of(x_db, K_DB), K_DB, BLOCK_B)
    kw_db = dict(block_b=BLOCK_B, meta_words=16, with_actions=True)
    both_args = (both["w1p"], both["b1"], both["w2"], both["b2"])
    for act_v, half in ((0, front), (1, back)):
        active.fill_(act_v)
        fl_db = bm.flip_slots(g_db.block_slots, active, K_DB)
        got = ff.double_buffered_forward(x_db, front, back, active, g_db.block_slots,
                                         g_db.row_ids, **kw_db)
        single = ff.fused_forward(x_db, half["w1p"], half["b1"], half["w2"], half["b2"],
                                  g_db.block_slots, g_db.row_ids, **kw_db)
        want = ff.fused_forward_ref(x_db, *both_args, fl_db, g_db.row_ids, **kw_db)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], single[0]) and torch.equal(got[1], single[1])):
            fail(f"double_buffered_forward active={act_v}: differs from the single half")
        if not torch.equal(got[1], want[1]) or not torch.allclose(
                got[0], want[0], atol=ATOL, rtol=RTOL):
            fail(f"double_buffered_forward active={act_v}: differs from the plain version")
        halves[("dbf", act_v)] = single
    run_k = lambda: ff.fused_forward(x_db, *both_args, fl_db, g_db.row_ids, **kw_db)  # noqa: E731
    run_call = lambda: ff.double_buffered_forward(  # noqa: E731
        x_db, front, back, active, g_db.block_slots, g_db.row_ids, **kw_db)
    run_p = lambda: ff.fused_forward_ref(x_db, *both_args, fl_db, g_db.row_ids, **kw_db)  # noqa: E731
    slot_bytes = (H * W + H + C * H + C) * 4
    b_ms, b_by = bound(N * (W * 4 + 32) + used_slots(fl_db) * slot_bytes
                       + nbytes(g_db.row_ids, fl_db) + g_db.b_pad * (C + 1) * 4,
                       g_db.b_pad * H * D, 2.0 * g_db.b_pad * H * C)
    record("dbf", f"fused_forward double_buffered_forward gather/meta16/actions "
           f"K={K_DB}+{K_DB}", fused_src, fused_tpu,
           float((got[0] - want[0]).abs().max()), run_k, run_p, b_ms, b_by, call=run_call)

    # -- 4. the main paths, each part with the counts set to 0 around it -------
    def counted(part):
        """Run ``part`` with every launch count set to 0 just before it;
        return its result and the counts read just after."""
        ff.fused_forward.launches.clear()
        bnn_xnor.xnor_matmul.launches.clear()
        bm.banked_matmul.launches.clear()
        bm.banked_xnor_layer1.launches = 0
        da.decode_attention.launches.clear()
        result = part()
        torch.cuda.synchronize()
        return result, {"fused": dict(ff.fused_forward.launches),
                        "xnor": dict(bnn_xnor.xnor_matmul.launches),
                        "banked_matmul": dict(bm.banked_matmul.launches),
                        "banked_xnor": bm.banked_xnor_layer1.launches,
                        "decode_attention": dict(da.decode_attention.launches)}

    end_to_end = {}

    def boundary_replay():
        res = packetpath.run(packetpath.build_parser().parse_args(
            ["--packets", str(N), "--slots", "2", "--seed", "0",
             "--strategy", "fused", "--stream"]))
        if res["wrong_slot"] or res["wrong_verdict"]:
            fail(f"boundary replay: wrong_slot={res['wrong_slot']} "
                 f"wrong_verdict={res['wrong_verdict']}")
        end_to_end["packetpath_fused_K2_mpps"] = res["mpps"]

    _, n = counted(boundary_replay)
    entries["gather/meta16/actions/K2"]["launches"] += n["fused"].get(
        "gather/meta16/actions", 0)

    strategy_variant = {"fused": "gather/meta16/actions", "grouped": "gather/meta0",
                        "grouped_staged": "contiguous/meta0"}
    for k in (2, 16):
        bank, _ = banks[k]
        rng = np.random.default_rng(100 + k)
        slots = switching.access_trace("random", N, k, seed=k)
        payload = rng.integers(0, 2**32, (N, pkt.PAYLOAD_WORDS), dtype=np.uint32)
        p = pkt.make_packets(slots, payload)
        p[:, pkt.CONTROL_WORD_LO] = rng.integers(0, 2, N, dtype=np.uint32)
        xk = pkt.to_device(p, dev)
        base = pipeline.packet_step(bank, xk, num_slots=k, strategy="take")
        for strategy, variant in strategy_variant.items():
            res, n = counted(lambda: pipeline.packet_step(
                bank, xk, num_slots=k, strategy=strategy))
            for field in ("slots", "verdicts", "actions"):
                if not torch.equal(getattr(res, field), getattr(base, field)):
                    fail(f"packet_step {strategy} K={k}: {field} differ from take")
            if not torch.allclose(res.scores, base.scores, atol=ATOL, rtol=RTOL):
                fail(f"packet_step {strategy} K={k}: scores differ from take")
            entries[f"{variant}/K{k}"]["launches"] += n["fused"].get(variant, 0)
            ms = time_ms(lambda: pipeline.packet_step(
                bank, xk, num_slots=k, strategy=strategy), 20)
            end_to_end[f"packet_step_{strategy}_K{k}_mpps"] = N / ms / 1e3
            print(f"packet_step {strategy} K={k}: {N / ms / 1e3:.3f} Mpps "
                  f"({ms:.4f} ms per {N}-packet batch)", flush=True)

    bank, x = banks[2]
    slot0, slot1 = bank_lib.select_slot(bank, 0), bank_lib.select_slot(bank, 1)
    y, n = counted(lambda: pipeline.inference_only(slot0, pkt.payload_of(x)))
    want = executor.forward(slot0, pkt.payload_of(x), backend="ref")
    if not torch.allclose(y, want, atol=ATOL, rtol=RTOL):
        fail("inference_only differs from its plain version")
    entries[f"xnor/B{N}"]["launches"] += n["xnor"].get(N, 0)

    trace = switching.boundary_trace(
        CP_PACKETS, pkt.payload_of(x)[:CP_PACKETS].cpu().numpy().view(np.uint32))
    cp, n = counted(lambda: switching.control_plane_replay(slot0, slot1, trace))
    if not 0 <= cp.wrong_verdict_packets <= cp.wrong_model_packets <= 128:
        fail(f"control-plane replay counts out of range: {cp}")
    # One packet per call, and the two B = 256 calls that precompute each
    # model's verdicts: each shape counts under its own row.
    if set(n["xnor"]) != {1, CP_PACKETS}:
        fail(f"control-plane replay: xnor_matmul launched at row counts {n['xnor']}")
    for b, launches in n["xnor"].items():
        entries[f"xnor/B{b}"]["launches"] += launches
    end_to_end["control_plane_switch_latency_us"] = cp.switch_latency_us

    # The kernel-level double bank: each kernel called, the one scalar
    # flipped (the commit), and called again.
    def double_bank_calls():
        outs = []
        for act_v in (0, 1):
            active.fill_(act_v)
            outs.append((act_v, bm.banked_xnor_layer1(
                xw, both["w1p"], both["b1"], bm.flip_slots(bs_x, active, K_DB),
                block_b=BLOCK_B), {
                tname: ops.banked_matmul(xm, w2, b2, bm.flip_slots(bs_mm, active, LM_SLOTS),
                                         block_b=LM_BLOCK_B)
                for tname, (xm, w2, b2) in mm_inputs.items()},
                ff.double_buffered_forward(x_db, front, back, active, g_db.block_slots,
                                           g_db.row_ids, **kw_db)))
        return outs

    outs, n = counted(double_bank_calls)
    for act_v, y_x, y_mm, y_db in outs:
        if not torch.equal(y_x, halves[("xnor", act_v)]):
            fail(f"double bank: banked_xnor_layer1 after the flip to {act_v} differs")
        for tname, y in y_mm.items():
            if not torch.equal(y, halves[("mm", tname, act_v)]):
                fail(f"double bank: banked_matmul {tname} after the flip to {act_v} differs")
        if not all(torch.equal(u, v) for u, v in zip(y_db, halves[("dbf", act_v)])):
            fail(f"double bank: double_buffered_forward after the flip to {act_v} differs")
    entries["banked_xnor"]["launches"] += n["banked_xnor"]
    if set(n["banked_matmul"]) != set(MM_VARIANT.values()):
        fail(f"double bank: banked_matmul ran the variants {n['banked_matmul']}, "
             f"not {sorted(MM_VARIANT.values())}")
    for tname in mm_inputs:
        entries[f"mm/{tname}"]["launches"] += n["banked_matmul"][MM_VARIANT[tname]]
    entries["dbf"]["launches"] += n["fused"].get("gather/meta16/actions", 0)

    # The data plane on the emergency scenario, committed by flip and by
    # re-stage.  Replacement weights come from the default delivery.
    scenario = render(emergency_phases(K_DB, scale=DP_SCALE), num_slots=K_DB, seed=0)

    def runtime(double_buffer, **kw):
        kw = dict(dict(num_queues=DP_QUEUES, batch=DP_BATCH, block_b=BLOCK_B,
                       ring_capacity=DP_RING, strategy="fused", audit=True,
                       record=True, double_buffer=double_buffer), **kw)
        return DataplaneRuntime(front, **kw)

    dataplane = {}
    for double_buffer in (True, False):
        mode = "flip" if double_buffer else "restage"

        def run():
            rt = runtime(double_buffer)
            return rt, play(rt, scenario)

        (rt, reports), n = counted(run)
        aud = rt.audit_conservation()
        if not aud["ok"] or aud["wrong_verdict"]:
            fail(f"data plane ({mode}): conservation {aud['ok']}, "
                 f"wrong_verdict {aud['wrong_verdict']}")
        fused_n = n["fused"].get("gather/meta16/actions", 0)
        if fused_n < 1:
            fail(f"data plane ({mode}): the fused kernel was not launched")
        swaps = [e for e in rt.control.command_log()
                 if any(c["cmd"] == "swap_slot" for c in e["commands"])]
        if len(swaps) != 1 or swaps[0]["error"]:
            fail(f"data plane ({mode}): expected one committed swap epoch, got {swaps}")
        flips = rt._bankbuf.flips if rt._bankbuf is not None else 0
        if double_buffer and flips != 1:
            fail(f"data plane (flip): {flips} flips for one swap epoch")
        dataplane[mode] = {
            "streams": (rt.completed_seq, rt.completed_verdicts, rt.completed_slots),
            "dropped": list(rt.dropped_seq), "reta": rt.reta.copy(),
            "kpps": {r["phase"]: r["kpps"] for r in reports},
            "swap_apply_us": swaps[0]["apply_us"],
            "totals": aud["totals"], "fused_launches": fused_n, "flips": flips}
        print(f"dataplane {mode}: kpps per phase "
              + " ".join(f"{r['phase']}={r['kpps']:.1f}" for r in reports)
              + f"; swap epoch apply_us={swaps[0]['apply_us']:.1f}; "
              f"fused launches={fused_n}; totals={aud['totals']}", flush=True)
    if dataplane["flip"]["streams"] != dataplane["restage"]["streams"]:
        fail("data plane: flip and re-stage commits give different completion streams")
    entries[f"gather/meta16/actions/K{K_DB}/B{DP_BATCH}"]["launches"] += \
        dataplane["flip"]["fused_launches"]
    end_to_end["dataplane_kpps"] = {m: d["kpps"] for m, d in dataplane.items()}
    end_to_end["swap_epoch_apply_us"] = {
        m: d["swap_apply_us"] for m, d in dataplane.items()}
    print(json.dumps({"swap_epoch_apply_us": end_to_end["swap_epoch_apply_us"]}))

    # The megastep: the scenario at each window of the fig8m sweep on the
    # same runtime shape; the sweep raises unless the digests are equal,
    # wrong verdicts 0, conservation holds and the engine ran for w > 1.
    win_row = f"gather/meta16/actions/K{K_DB}+{megastep.EPOCH_CAPACITY}{megastep.WINDOW_TAG}"
    win_key = "gather/meta16/actions" + megastep.WINDOW_TAG
    swept, n = counted(lambda: sweep(
        lambda w: runtime(True, megastep_ticks=w), scenario, WINDOWS, reps=3))
    if n["fused"].get(win_key, 0) < 1:
        fail(f"megastep sweep: the window's fused launch never ran ({n['fused']})")
    entries[win_row]["launches"] += n["fused"][win_key]
    entries[f"gather/meta16/actions/K{K_DB}/B{DP_BATCH}"]["launches"] += \
        n["fused"].get("gather/meta16/actions", 0)
    for w, r in swept.items():
        print(f"megastep window={w}: kpps={r['kpps']:.1f} per phase "
              + " ".join(f"{p}={v:.1f}" for p, v in r["phase_kpps"].items())
              + f"; digest {r['digest'][:16]}", flush=True)
    end_to_end["megastep_kpps"] = {w: r["phase_kpps"] for w, r in swept.items()}

    # SlotCache churn: 32 models over the 16 slots, cache operations from a
    # fixed seed between the scenario's bursts.
    model_rng = np.random.default_rng(8)
    models = [executor.init_params(model_rng, device="cpu") for _ in range(CHURN_MODELS)]
    bursts = [b for phase in scenario.bursts for b in phase]

    def churn(double_buffer):
        rt = runtime(double_buffer)
        cache = SlotCache(rt)
        names = [f"m{i}" for i in range(CHURN_MODELS)]
        for name, params in zip(names, models):
            cache.register(name, params)
        op_rng = np.random.default_rng(9)
        pinned = None
        for burst in bursts:
            for _ in range(2):
                op = op_rng.choice(["ensure", "ensure", "prefetch", "pin"])
                m = names[op_rng.integers(CHURN_MODELS)]
                if op == "ensure":
                    # At most one model is pinned, so a miss always finds a
                    # victim: a CacheError here is a fault and fails the run.
                    cache.ensure(m)
                elif op == "prefetch":
                    cache.prefetch(m)
                elif pinned == m:
                    cache.unpin(m)
                    pinned = None
                elif pinned is None and cache.is_resident(m):
                    cache.pin(m)
                    pinned = m
            rt.dispatch(burst)
            rt.tick()
        rt.drain()
        return rt, cache

    churned = {}
    for double_buffer in (True, False):
        (rt, cache), n = counted(lambda: churn(double_buffer))
        aud = rt.audit_conservation()
        if not aud["ok"] or aud["wrong_verdict"]:
            fail(f"slot-cache churn (double_buffer={double_buffer}): conservation "
                 f"{aud['ok']}, wrong_verdict {aud['wrong_verdict']}")
        if n["fused"].get("gather/meta16/actions", 0) < 1:
            fail("slot-cache churn: the fused kernel was not launched")
        stats = cache.stats()
        print(f"slotcache churn double_buffer={double_buffer}: {stats}", flush=True)
        stats.pop("prefetch_hits")  # shadow staging exists only with a double buffer
        churned[double_buffer] = (rt.completed_seq, rt.completed_verdicts,
                                  rt.completed_slots, stats,
                                  [cache.model_at(i) for i in range(K_DB)])
        # Each miss fills a slot and there are K_DB slots, so every miss
        # past the first K_DB must have evicted a model.
        if stats["evictions"] < max(1, stats["misses"] - K_DB):
            fail(f"slot-cache churn: {stats['evictions']} evictions for "
                 f"{stats['misses']} misses over {K_DB} slots")
        if stats["resident"] > K_DB:
            fail(f"slot-cache churn: {stats['resident']} models resident in {K_DB} slots")
    if churned[True] != churned[False]:
        fail("slot-cache churn: flip and re-stage commits differ")

    # Training on the card, then each slot on the val split through
    # evaluate (xnor_matmul at B = the val split's rows, its own row).
    def train():
        t0 = time.perf_counter()
        slots = bnn.train_slot_pair(seed=0, epochs=TRAIN_EPOCHS,
                                    samples_per_group=TRAIN_SAMPLES)
        torch.cuda.synchronize()
        return slots, time.perf_counter() - t0

    (trained, train_s), _ = counted(train)
    print(f"train_slot_pair(seed=0, epochs={TRAIN_EPOCHS}, samples_per_group="
          f"{TRAIN_SAMPLES}): {train_s:.2f} s wall", flush=True)
    end_to_end["train_slot_pair_s"] = train_s
    xb_val, y_val = pk.load_split("val", VAL_SAMPLES, 0)
    w_val = pk.to_payload_words(xb_val)
    val_rows = w_val.shape[0]
    metrics, n = counted(lambda: [bnn.evaluate(s, w_val, y_val) for s in trained])
    if set(n["xnor"]) != {val_rows}:
        fail(f"evaluate: xnor_matmul launched at row counts {n['xnor']}, not {val_rows}")
    x_val = pkt.to_device(w_val, dev)
    for i, (slot, m) in enumerate(zip(trained, metrics)):
        print(f"trained slot{i}: precision={m['precision']:.4f} recall={m['recall']:.4f} "
              f"f1={m['f1']:.4f}", flush=True)
        plain = executor.forward(slot, x_val, backend="ref")[:, 0].cpu().numpy() > 0
        kernel = executor.forward(slot, x_val)[:, 0].cpu().numpy() > 0
        if not np.array_equal(kernel, plain):
            fail(f"trained slot{i}: {int((kernel != plain).sum())} verdicts differ "
                 "from the plain executor")
        counts = {"tp": int((plain & (y_val == 1)).sum()),
                  "fp": int((plain & (y_val == 0)).sum()),
                  "fn": int((~plain & (y_val == 1)).sum())}
        if counts != {k: m[k] for k in counts}:
            fail(f"trained slot{i}: evaluate gave {m}, the plain executor {counts}")
    end_to_end["trained_slot_metrics"] = metrics
    if not (metrics[0]["recall"] > metrics[1]["recall"]
            and metrics[1]["precision"] >= metrics[0]["precision"]):
        fail(f"trained slots miss Fig. 6's ordering: {metrics}")
    check_xnor(x_val, trained[0]["w1p"])
    entries[f"xnor/B{val_rows}"]["launches"] += n["xnor"][val_rows]

    def trained_replay():
        return packetpath.run(packetpath.build_parser().parse_args(
            ["--train", "--packets", str(N), "--strategy", "fused", "--stream"]))

    res, n = counted(trained_replay)
    if res["wrong_slot"] or res["wrong_verdict"]:
        fail(f"trained boundary replay: wrong_slot={res['wrong_slot']} "
             f"wrong_verdict={res['wrong_verdict']}")
    entries["gather/meta16/actions/K2"]["launches"] += n["fused"].get(
        "gather/meta16/actions", 0)
    entries[f"xnor/B{val_rows}"]["launches"] += n["xnor"].get(val_rows, 0)
    end_to_end["packetpath_trained_fused_K2_mpps"] = res["mpps"]

    # Every regime at one host: played and recorded to a v2 trace, then
    # loaded and replayed on a fresh runtime built from the trace.
    trace_dir = os.path.join(ROOT, "build", "traces")
    os.makedirs(trace_dir, exist_ok=True)
    dp_row = f"gather/meta16/actions/K{K_DB}/B{DP_BATCH}"

    def regime_rendered(name):
        wl = workloads.make_workload(name, num_slots=K_DB, num_queues=DP_QUEUES,
                                     scale=DP_SCALE, hosts=1,
                                     corpus_root=workloads.SYNTHETIC_CORPUS)
        return wl, render(list(wl.phases), num_slots=K_DB, seed=0,
                          payload_pool=wl.payload_pool, num_queues=DP_QUEUES)

    regimes = {}
    for name in workloads.REGIME_NAMES:
        wl, rendered = regime_rendered(name)

        def record_run():
            injector = FaultInjector(wl.fault_plan) if wl.fault_plan else None
            rt = runtime(True, fault_injector=injector)
            rec = workloads.record(rt, path=os.path.join(trace_dir, f"{name}.bswt"))
            t0 = time.perf_counter()
            reports = play(rec, rendered)
            play_s = time.perf_counter() - t0
            return rt, reports, play_s, rec.finish(name=name, seed=0)

        (rt, reports, play_s, st), n = counted(record_run)
        fused_n = n["fused"].get("gather/meta16/actions", 0)
        aud, cont = rt.audit_conservation(), rt.control.continuity_audit()
        if not aud["ok"] or aud["wrong_verdict"] or not cont["ok"] or fused_n < 1:
            fail(f"regime {name}: conservation {aud['ok']}, wrong_verdict "
                 f"{aud['wrong_verdict']}, continuity {cont['ok']}, fused launches {fused_n}")
        loaded = workloads.load(st.path)

        def replay_run():
            rt2 = workloads.make_runtime(loaded, audit=True, block_b=BLOCK_B)
            return rt2, workloads.replay(loaded, rt2)

        (rt2, rep), n2 = counted(replay_run)
        replay_n = n2["fused"].get("gather/meta16/actions", 0)
        if not (rep["ok"] and rep["digest_ok"] and rt2.telemetry.wrong_verdict == 0
                and rt2.audit_conservation()["ok"]
                and rt2.control.continuity_audit()["ok"] and replay_n >= 1):
            fail(f"regime {name}: replay {rep['mismatches']}, digest_ok {rep['digest_ok']}, "
                 f"wrong_verdict {rt2.telemetry.wrong_verdict}, fused launches {replay_n}")
        entries[dp_row]["launches"] += fused_n + replay_n
        completed = sum(r["completed"] for r in reports)
        regimes[name] = {
            "kpps": completed / play_s / 1e3, "packets": completed,
            "dropped": aud["totals"]["dropped"], "fused_launches": fused_n,
            "epochs": len(rt.control.log),
            "rolled_back": cont["commit_modes"]["rollback"],
            "trace_bytes": st.nbytes}
        print(f"regime {name}: kpps={regimes[name]['kpps']:.1f} fused_launches={fused_n} "
              f"epochs={regimes[name]['epochs']} rolled_back={regimes[name]['rolled_back']} "
              f"trace_bytes={st.nbytes} packets={completed} "
              f"dropped={aud['totals']['dropped']} replay_digest_ok={rep['digest_ok']}",
              flush=True)
    end_to_end["regimes"] = regimes

    # The bounded epoch log: slot-thrash with LOG_CAPACITY records in
    # memory, the rest spilled to a file and read back.
    spill = os.path.join(trace_dir, "slot-thrash.bswel")
    _, rendered = regime_rendered("slot-thrash")

    def bounded_log():
        rt = runtime(True, log_capacity=LOG_CAPACITY, log_spill=spill)
        play(rt, rendered)
        return rt

    rt, n = counted(bounded_log)
    spilled, cont = load_epoch_spill(spill), rt.control.continuity_audit()
    if not (len(spilled) == cont["spilled_epochs"] == rt.control.stats()["epochs_spilled"] > 0
            and len(rt.control.log) == LOG_CAPACITY and cont["ok"]
            and [d["epoch"] for d in spilled] == list(range(1, len(spilled) + 1))):
        fail(f"bounded epoch log: {len(spilled)} records read back, continuity {cont}")
    entries[dp_row]["launches"] += n["fused"].get("gather/meta16/actions", 0)
    print(f"bounded epoch log: {len(spilled)} epochs spilled, {len(rt.control.log)} "
          f"in memory, spill {os.path.getsize(spill)} bytes, continuity ok", flush=True)

    # The recorded slot-thrash trace (an epoch every storm tick) replayed on
    # a megastep runtime: epochs land inside windows.
    thrash = workloads.load(os.path.join(trace_dir, "slot-thrash.bswt"))

    def megastep_replay():
        rt2 = workloads.make_runtime(thrash, audit=True, block_b=BLOCK_B,
                                     megastep_ticks=WINDOW_TICKS)
        return rt2, workloads.replay(thrash, rt2)

    (rt2, rep), n = counted(megastep_replay)
    if not (rt2._mega is not None and rep["ok"] and rep["digest_ok"]
            and rt2.telemetry.wrong_verdict == 0 and rt2.audit_conservation()["ok"]
            and rt2.control.continuity_audit()["ok"] and n["fused"].get(win_key, 0) >= 1):
        fail(f"slot-thrash megastep replay: {rep['mismatches']}, digest_ok {rep['digest_ok']}, "
             f"wrong_verdict {rt2.telemetry.wrong_verdict}, launches {n['fused']}")
    entries[win_row]["launches"] += n["fused"][win_key]
    print(f"slot-thrash megastep replay (window {WINDOW_TICKS}): digest_ok "
          f"{rep['digest_ok']}, {len(rt2.control.log)} epochs, "
          f"{n['fused'][win_key]} window launches", flush=True)

    # The mesh: MeshDataplane shards, each serving through the fused kernel
    # (gather, meta16, actions, B = DP_BATCH per queue), on the one card.
    mesh_out = {}
    mesh_runs = run_mesh_phase(
        counted=counted, entries=entries, dev=dev, bank=front, scenario=scenario,
        single=dataplane["flip"], trace_dir=trace_dir, dp_row=dp_row,
        win_row=win_row, win_key=win_key, out=mesh_out)
    end_to_end["mesh"] = mesh_out

    for key, e in entries.items():
        # phase 8's rows and phase 9's head and decode attention rows are counted there
        if e["launches"] < 1 and not key.endswith(f"/bb{CLI_BLOCK_B}") \
                and not key.startswith(("mm/bf16.f32out/head", "attn/decode/")):
            fail(f"{e['name']} was not launched on the main path")

    # -- 5. where the time goes -----------------------------------------------
    bank, x = banks[2]
    print(json.dumps({"profile": profile_step(
        lambda: pipeline.packet_step(bank, x, num_slots=2, strategy="fused"))}))
    # The scenario's own runtime (batch DP_BATCH per queue), fed one
    # flash-crowd burst per tick as the scenario's second phase feeds it.
    rt = runtime(True, audit=False, record=False)
    crowd_burst = scenario.bursts[1][0]
    tick_profile = profile_step(lambda: (rt.dispatch(crowd_burst), rt.tick()))
    tick_profile["packets_offered_per_tick"] = int(crowd_burst.shape[0])
    tick_profile["batch_per_queue"] = DP_BATCH
    # The host's share, which the profiler does not see: the arrival edge
    # (RSS hash, ring pushes) apart from the tick (pop, pad, copy, launch,
    # retire), each on the host clock with the device drained.
    split, served = np.zeros(2), 0
    for _ in range(10):
        t0 = time.perf_counter()
        rt.dispatch(crowd_burst)
        t1 = time.perf_counter()
        served += rt.tick()
        torch.cuda.synchronize()
        split += (t1 - t0, time.perf_counter() - t1)
    tick_profile["dispatch_ms"], tick_profile["tick_ms"] = (split / 10 * 1e3).tolist()
    tick_profile["packets_served_per_tick"] = served / 10
    print(json.dumps({"dataplane_tick_profile": tick_profile}))
    end_to_end["dataplane_tick_device_idle_share"] = tick_profile["device_idle_share"]
    # The same tick split by the program's own spans (``rt.spans``) over
    # ten recorded ticks, after ten to reach the steady backlog.
    rt = runtime(True, audit=False, record=True)
    for _ in range(10):
        rt.dispatch(crowd_burst)
        rt.tick()
    rt.spans.start()
    for _ in range(10):
        rt.dispatch(crowd_burst)
        rt.tick()
    rt.spans.stop()
    print(json.dumps({"dataplane_tick_split": rt.spans.summary()}), flush=True)

    # One megastep window of WINDOW_TICKS ticks beside as many sequential
    # ticks, on the same traffic; each step of the profile is one window.
    def ticks_of(r):
        def step():
            for _ in range(WINDOW_TICKS):
                r.dispatch(crowd_burst)
                r.tick()
        return step

    profiles = {}
    for w in (1, WINDOW_TICKS):
        r = runtime(True, audit=False, record=True, megastep_ticks=w)
        step = ticks_of(r)
        prof = profile_step(step, iters=5)
        prof["packets_offered_per_step"] = WINDOW_TICKS * int(crowd_burst.shape[0])
        if w > 1:
            if prof["dtoh_copies_per_step"] != 1:
                fail(f"megastep: {prof['dtoh_copies_per_step']} device-to-host copies "
                     "per window, not the drain's one")
            # the host's share of a window: staging (dispatch and tick),
            # the flush up to the drain, and the drain (its one copy back
            # waits for the window's device work)
            acc = {"flush": 0.0, "_drain": 0.0}
            for name in acc:
                def timed(*a, _fn=getattr(r._mega, name), _name=name, **kw):
                    t0 = time.perf_counter()
                    try:
                        return _fn(*a, **kw)
                    finally:
                        acc[_name] += time.perf_counter() - t0
                setattr(r._mega, name, timed)
            t0 = time.perf_counter()
            for _ in range(5):
                step()
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            prof["host_ms_per_window"] = {
                "staging": (total - acc["flush"]) / 5 * 1e3,
                "flush_to_drain": (acc["flush"] - acc["_drain"]) / 5 * 1e3,
                "drain": acc["_drain"] / 5 * 1e3}
            # any host synchronisation inside the window's device work raises
            real = megastep._run_window

            def strict(*a, **kw):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    return real(*a, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode("default")

            megastep._run_window = strict
            try:
                step()
            finally:
                megastep._run_window = real
            prof["sync_debug_error_window"] = "no host synchronisation"
        profiles[f"megastep_ticks={w}"] = prof
    print(json.dumps({"window_profile": profiles}), flush=True)

    # g. one flash-crowd mesh tick at 2 hosts (audit and record off)
    m2 = mesh_runs["new"](MESH_PROFILE_HOSTS, audit=False)
    mesh_profile = profile_step(lambda: (m2.dispatch(crowd_burst), m2.tick()))
    mesh_profile["hosts"] = MESH_PROFILE_HOSTS
    mesh_profile["packets_offered_per_tick"] = int(crowd_burst.shape[0])
    print(json.dumps({"mesh_tick_profile": mesh_profile}), flush=True)
    end_to_end["mesh_tick_device_idle_share"] = mesh_profile["device_idle_share"]

    # The paper's figures on the port, each benchmark run once.
    print(json.dumps({"paper_figures": run_paper_figures(dev)}), flush=True)

    # -- 7. observability, checkpoints and deployment --------------------------
    obs_out = {}
    run_obs_deploy_phase(counted=counted, entries=entries, dev=dev, bank=front,
                         dp_row=dp_row, win_row=win_row, win_key=win_key,
                         check_xnor=check_xnor, out=obs_out)
    end_to_end["obs_deploy"] = {k: obs_out[k] for k in ("stream", "deploy", "checkpoint")}

    # -- 8. the data-plane CLI ---------------------------------------------------
    def xnor_rows(b):
        payload = pkt.payload_of(banks[2][1])
        return (payload.repeat(-(-b // payload.shape[0]), 1)[:b],
                banks[2][0]["w1p"][0])

    cli_out = {}
    run_cli_phase(counted=counted, entries=entries, dev=dev, check_xnor=check_xnor,
                  xnor_rows=xnor_rows, out=cli_out)
    end_to_end["cli"] = cli_out

    # -- 9. LM serving ------------------------------------------------------------
    lm_out = {}
    run_lm_serve_phase(counted=counted, entries=entries, dev=dev, out=lm_out)
    end_to_end["lm_serve"] = {k: lm_out[k] for k in ("a_smollm_f32", "b_smollm_bf16",
                                                    "d_mamba2_f32")}

    # -- 10. LM training ----------------------------------------------------------
    train_out = {}
    run_lm_train_phase(counted=counted, dev=dev, out=train_out)
    end_to_end["lm_train"] = {k: train_out[k] for k in ("a_smollm_bf16", "d_mamba2_bf16")}

    # -- 11. LM distribution and tooling ------------------------------------------
    dist_out = {}
    run_lm_dist_phase(counted=counted, dev=dev, out=dist_out)
    end_to_end["lm_dist"] = {
        "a_sharded_step": {k: dist_out["a_sharded_step"][k]
                           for k in ("sharded_step_ms", "unsharded_step_ms")},
        "b_compressed_psum_ms": dist_out["b_compressed_psum"]["ms_per_step"],
        "c_bound_share": dist_out["c_roofline"]["bound_share"],
        "d_cells": {k: v["dominant"] for k, v in dist_out["d_dryrun"]["cells"].items()}}
    for e in entries.values():
        if e["launches"] < 1:
            fail(f"{e['name']} was not launched on the main path")
    print(json.dumps({"end_to_end": end_to_end}))
    print(json.dumps({"kernels": list(entries.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
