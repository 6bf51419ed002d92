#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU.  Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero and nothing is passed over:

1. card: the GPU's name and power limit (nvidia-smi), then every kernel
   source of ``src/repro_torch/kernels/csrc`` is built with nvcc, one
   process per source, all at once; registers, spills and shared memory
   are logged.  ``cuobjdump -sass`` must find the tensor cores' HGMMA in
   every bf16 ``tuned_matmul`` kernel and HMMA (or HGMMA) in every bf16
   ``flash_attention`` kernel.
2. kernel: each CUDA kernel against its plain PyTorch version on the card,
   at the main paths' shapes, with the kernel's time, the plain version's
   time, one library call's time where one exists, and the bound (the
   least time the card could take for the same work, from
   ``repro_torch.kernels.work``).  ``paged_attention_mq`` is held at
   stablelm-1.6b's heads (the timed config, unchanged since the kernel's
   first version), at qwen3-8b's and h2o-danube-1.8b's GQA widths (HD 128
   and 80), at qwen2-moe-a2.7b's MHA heads (16 of 128), at one slot of
   full length at the two GQA widths, in f32 and bf16, S 1
   and 3, block_k 0 and 8, each call timed with its achieved GB/s; at the
   timed config it is also timed after a ~100 us spin (the timer's
   earlier spin) and its host time per call is measured, one call
   captured into a CUDA graph must hold exactly the CUDA kernels the
   design launches per call (one; torch.profiler cross-checks),
   and one call under ``torch.cuda.set_sync_debug_mode("error")`` must
   raise nothing (the wrapper reads no device value on the host).  The
   four scan kernels are held and timed at every shape of SCAN_SHAPES
   (the fused ones also at the batch-1 re-advance, (1, 1)), the timer's
   floor is timed (a do-nothing launch, ``[timer]``), and the fused scan
   wrappers' host time a call is measured at 8 slots through
   ``kernels.ops`` (``[host]``);
   each scan's CUDA kernels a call are counted from a captured graph
   (torch.profiler cross-checks) against
   ``linear_scan.kernels_per_call`` (the fused ones one at 8 slots; the
   chunk ones three for several chunks, two for one) with one call under
   sync debug mode, and ``wkv_chunk`` is
   also held at decays down to 1e-30.  ``tuned_matmul`` is held at every
   tile of its menu at each shape of the JAX package's kernel tests, and at the default tiles on (64, 384, 256); ``flash_attention``
   at every case of those tests and the masking cases (S != Sk, rows that
   see no key); both in f32 and bf16, then timed at stablelm-1.6b's full
   width (attention also on pre-made (BH, S, D) inputs: within 10% of
   ``ops.attention``, which reads the model layout in place and allocates
   nothing but its output).  Their path, the ``kernels.ops`` entry point
   (no model of either package calls them), is then driven once at those
   shapes with the counts set to 0.
3. stablelm-1.6b at full width: parity in f32 (one paged decode step
   through the kernel against the gather path: logits and greedy tokens),
   then the paged engine in bf16 with attn_impl='paged' at spec_depth 0
   and 2.  Every request must finish, the kernel's launches must equal
   decode steps x layers, no safe-plan fallback and no leaked page.
   Then the paper loop on the same engine: the full-width bf16 paged
   decode step counted per region on the meta device (top regions and
   roofline terms; counting launches nothing and writes no page), a serve
   with online retraining and exploration that saves its tree, and a
   serve driven by that tree.  Every request must finish, no page may
   leak, the corpus must fill, a retrain must run, the tree must replan,
   and the paged kernel's launches must equal decode steps x layers.
   On the card the serves' decode steps and prefill chunks replay as CUDA
   graphs, whose replays add their captured launches to the counts.
   ``[graph]``: the paged decode step at S 1 and 3 and the prefill chunk
   (C 256), each replayed against its step function from the same random
   pages: equal tokens and finite flags, every page but the null sink
   equal bit for bit; then the host time a step of each (eager, and the
   replay with its input copy) and the replay's device time.
4. rwkv6-3b and zamba2-2.7b at full width: parity in f32 (one prefill and
   one decode step through the scan kernels against the plain scans:
   logits and greedy tokens), then the slot pool (paged='off') in bf16,
   once with scan_mode auto at spec_depth 0 and once with scan_mode chunk
   at spec_depth 2.  Every request must finish, both of the family's scan
   kernels launched, and their launches equal to the model calls (pool
   steps, replayed as CUDA graphs; prefills and re-advances, eager) x
   layers.  (The slot pool has no
   safe-plan fallback to gate on: as in the JAX engine, only the paged
   pool has one.)  ``[graph]``: the slot-pool decode step with its pool
   update at spec_depth 0 and 2 against its step function, from the same
   random state, as for the paged step.  The scan calls of both serves
   are counted by (kernel, B, T, chunk) from the wrappers' shape tally
   (``kernels.LAUNCH_SHAPES``, which replays add to); after both models
   each scan kernel is timed at every such shape, and launches x (time -
   bound) is summed over them.

5. [train]: the training path at stablelm-1.6b's full width (no kernel
   of its own: the JAX training path reaches no ``pallas_call``).  bf16
   params from ``Model.init(seed=0)``, B 8 x S 512 from the data
   pipeline, AdamW (lr 3e-4, warmup-cosine over 12 steps).  Step 0's loss
   and grads without and with every layer remat (equal loss; grads within
   2^-8 of each leaf's scale).  12 steps under ``null_plan()`` on the
   pipeline's batches 0-11, each step's loss, grad norm, lr and device ms
   (CUDA events), then the median step, tok/s, the share of the bf16
   dense peak by ``model_flops`` (6·N·D) and the peak allocated.  One
   more step under ``torch.profiler`` (busy share, cuBLAS's products
   against the rest, the top kernels), and forward+backward and the
   optimizer timed apart.  The same init on batches 0-3 three times:
   the last three losses' mean must be below the first three's (on 12
   fresh batches at this rate the loss does not fall, so that run is not
   gated on it).  2 remat steps (equal step-0 loss, a lower peak).  Every
   run: finite losses and grad norms, every weight matrix and embedding
   changed.  One step counted per region on the meta device (each layer
   2.5-3.5x its forward's flops).  Then, at the reduced config, ``python
   -m repro_torch.launch.train`` killed at step 6 (exit 42) and resumed
   from its step-4 checkpoint, and, in a process with
   ``CUBLAS_WORKSPACE_CONFIG`` set, 8 steps against 4 + save + restore +
   4 under deterministic algorithms, equal bit for bit.

6. [moe]: qwen2-moe-a2.7b (60 routed experts padded to 64, top 4, 4
   shared) at full width and depth in bf16 from ``Model.init(seed=0)``,
   drawn leaf by leaf in bf16 (the peak may exceed the params by at most
   one leaf).  In f32 on a full-width copy of its first two layers: one
   paged decode step through the kernel against the gather path (logits
   and greedy tokens), einsum against scatter dispatch at capacity factor
   8.0 (the JAX package's 2e-3), and the card's routes against the CPU's
   on the same inputs (a route may differ only at a near-tie).  The paged
   engine in bf16 on the serve trace with the einsum and the scatter
   dispatch, spec_depth 2 and prefill_chunk 256 asked for: every request
   done, no speculative step, no prefix sharing, every prompt prefilled
   in one chunk (eagerly: no prefill graph), the paged kernel's launches
   equal to decode steps x layers, no safe-plan fallback and no leaked
   page.  ``[graph]``: the MoE decode step (S 1) replayed against its
   step function.  The decode step counted per region on the meta device
   (every ``layerN/moe`` and ``shared_mlp`` region, each ``layerN/moe``
   at least its expert products plus dispatch and combine; nothing
   launched).  [train-moe]: granite-moe-1b-a400m at full width in bf16,
   4 steps of B 8 x S 512 from the pipeline: finite ce, aux and grad
   norms, every weight matrix changed.

7. [vlm]: internvl2-26b's LM backbone (48 layers, GQA 48/8 heads of 128)
   at full width and depth in bf16 from ``Model.init(seed=0)``.  In f32
   on a full-width copy of its first two layers: one paged decode step
   through the kernel against the gather path (logits and greedy tokens).
   The paged engine in bf16 on the serve trace of phase 3 at spec_depth 0
   and 2: every request done, the paged kernel's launches equal to decode
   steps x 48 in each serve, no safe-plan fallback, no leaked page.
   ``[graph]``: its decode step at S 1 and 3 replayed against its step
   function.

8. [whisper]: whisper-large-v3 (32 + 32 layers, d_model 1280, 20 heads)
   at full width in bf16.  In f32: ``prefill`` of 4 tokens and 4
   teacher-forced ``decode_step``s against ``forward`` on random frames.
   16 requests of a 4-token prompt served through ``Engine.generate`` by
   the launcher's static mode (8 rows a group, max_len 448, zero frames):
   every request done with its budget of tokens, and no hand-written
   kernel launched (whisper's attention is the einsum path in both
   packages).  A group's prefill timed by CUDA events, 8 of its decode
   steps under torch.profiler (the card's busy share), and one decode
   step timed by CUDA events and counted per region on the meta device
   (the cross-attention's K/V projection of the encoder output).  [train-whisper]: B 2 x S 448 with zero frames, 3
   steps under the null plan and 2 with every ``enc``/``dec`` layer remat
   (step 0's loss equal), then 2 remat steps at B 4 (the null plan at B 4
   does not fit: its saved activations alone, counted on the meta device,
   are ~66 GB): finite losses and grad norms, the share of the bf16 peak
   by ``model_flops`` and by the meta count of a step, and one null-plan
   step under torch.profiler.

9. [telemetry]: stablelm-1.6b at full width and depth in bf16 from
   ``Model.init(seed=0)``, the paged engine with attn_impl='paged' on the
   serve trace of phase 3 at spec_depth 0 and 2, each served once with
   telemetry off and once with ``telemetry=True, log_level="debug"`` and
   its trace, metrics and event log written under ``build/``.  Gates:
   tokens equal request by request, the paged kernel's launches equal to
   decode steps x layers in every serve, no safe-plan fallback, no leaked
   page; the trace loads and holds every span, every request's QUEUED ->
   PREFILL -> DECODE chain has no gap from its arrival and ends in one
   DONE, with each prefill chunk inside its PREFILL; the Prometheus text
   parses; every JSONL line parses and one is ``serve_done``; the ring's
   summed step time is at most the serve's wall.  Logged, not gated: tok/s
   on against off over 3 pairs in turns on one warmed engine whose
   telemetry is attached and detached (median ratio), the wall a step
   telemetry adds, and the host time a step spent inside telemetry's
   recording calls.
   [faults]: the chaos config of ``tests/test_faults.py`` at full width
   (FAULTS: 8 slots, page 16, chunk 256, spec_depth 2, lazy reservation on
   a pool of 97 pages, which preempts even without faults, prefix caching
   on, requests 8-15 repeating the prompts of 0-7, telemetry on), faults
   at 15% a site draw.  In bf16 at full depth: every request in a
   terminal state, no leaked page, the allocator's invariants, at least
   one retry, the ring's steps equal to the serve's, and where the
   safe-plan fallback ran, its step (spec 0, the gather path: a new step
   cache key) captured as a graph mid-serve and replayed.  The
   survivors' tokens are held to a fault-free run in f32 on a full-width
   copy of the first two layers: in bf16 the safe plan's gather path and
   spec 0 round differently from the kernel path at spec 2, so tokens
   equal bit for bit are not expected there.

10. [bots]: the BOTS-analog suite (``repro_torch.bots``) swept over
   ``suite.DEGREES`` with ``suite.time_workload(name, degree,
   BOTS_REPEATS, **size)`` (2 timed calls after a warm one) at BOTS_SIZES: strassen n 8192 depth 2 (f32, TF32 off),
   nqueens n 13 prefix 4 (the lock-step DFS, its blocks replayed as CUDA
   graphs), sparselu nb 50 bs 100 band 3 (the host-driven LU), health
   1,048,576 villages x 64 steps, floorplan at the JAX package's size.
   Every row is counted on the meta device; the degree-1 counters and the
   best degree make the decision tree's corpus (``train_tree``).  No
   hand-written kernel lies on this path.  Gates: no row has ``error``;
   nqueens counts 73712 at every degree; strassen's max error against the
   f64 product of the same inputs within 10x of f32 ``torch.matmul``'s, at
   every degree; sparselu's residual < 0.05 and every degree's LU equal to
   degree 1's within 1e-5 x max|LU|; health treated > 0, peak >= 0,
   treated <= villages x steps x 10; floorplan 12 <= best < 10000; every
   degree-1 row's counters with flops > 0 and bytes > 0; ``train_tree``
   returns a tree.  Logged: per (workload, degree) wall ms, device ms by
   CUDA events around the same call and the counted arithmetic intensity
   (``[bots]``), the card's Table 1 with each best degree beside the
   paper's and the tree's training accuracy (``[bots-table]``), peak
   allocated and the phase's wall.

11. [train-recurrent]: training through the scans' gradient.  First the
   four scans under grad on the card (``kernels.ops.wkv`` / ``ssd``, f32,
   B 2 at the families' head widths, T 130 and 256, segments 64 and 128,
   both modes, chunk 64, a nonzero entry state): the forward launches the
   kernel once a segment and the backward none, the output within
   ``ref.KERNEL_TOL`` and every gradient within ``ref.KERNEL_TOL`` x T of
   autograd through the plain form on the same card.  Then rwkv6-3b and
   zamba2-2.7b at full width and depth, S 512, bf16 params and f32 AdamW
   moments from ``Model.init(seed=0)``; B per plan the largest of 8, 4, 2
   whose count on the meta device fits 85% of the card.  The null plan 2
   steps for rwkv6-3b and 1 for zamba2-2.7b (device ms a step, tok/s, the
   share of the bf16 peak by ``model_flops``, peak allocated, AdamW timed
   alone), every layer remat 1 step, the chunked scans 1 step (the phase
   is held near 120 s by its steps: a sequential step takes 8-25 s).
   Gates: finite losses and grad norms, every weight matrix changed under
   the null plan; the scan kernel's launches a step
   equal to layers x segments (twice that under remat, whose backward
   recomputes each layer's forward); remat's step-0 loss (its forward)
   equal to the null plan's; the chunked scans' within 1e-3 of it; for
   rwkv6-3b, the state after step 0 carried through the checkpoint format
   in host memory gives step 1's loss (its forward) bit for bit.  The
   kernels' JSON record adds each scan's launches on this path
   (``launches_train``).

12. [tp]: tensor-parallel paged serving.  stablelm-1.6b at full width
   and depth on two ranks sharing the one card over gloo
   (``repro_torch.serve.tp.Ranks``: this process is rank 0 and runs the
   engine, rank 1 a spawned process running the step on its shard); its
   first line says so.  Every serve of the phase runs TP_SERVE, half of
   phase 3's trace with generations of 16-32 (cut to make room for phase
   13).  f32 from ``Model.init(seed=0)`` at spec_depth 0, tp 2 against a
   plain tp-1 engine, both eager: every request DONE, greedy tokens equal
   for every request, the first decode step's logits' largest difference
   printed.  bf16 at
   spec_depth 0 and 2, tp 1 (graphs) then tp 2 (eager): every request
   DONE, the paged kernel's launches on each rank equal to decode steps
   x layers with the kernel at 16 kv heads on both, each rank's pool
   bytes half of tp 1's, the allocator's invariants, no leaked page, no
   fallback, the ``"mesh"`` result at tp 2 with 2 devices and the pools'
   per-device bytes; tok/s of both printed, not gated (two ranks on one
   card over gloo: not a tensor-parallel speed).  Then granite-moe-1b-a400m
   at full width and depth (24 layers, d_model 1024, 16 heads over 8 kv
   heads x 64, 32 experts top-8) over two ranks of its own, the same
   serves and gates at spec_depth 0 only (the engine pins an MoE model's
   depth to 0), its f32 gate on weights drawn at each matrix's fan-in
   (``fan_in_params``); at ``Model.init(seed=0)``, whose stacked scale
   makes its full depth chaotic, the f32 tokens and logits of the two
   degrees on the trace's first two requests are printed, not gated,
   with how far the MoE inputs stand apart layer by layer and the first
   route call at which their experts differ (``route_flips``: its layer,
   the tokens flipped, how far the inputs and the routing probabilities
   moved, and how narrow the flipped tokens' near-ties were; printed for
   the fan-in serves too), the kernel at 4 kv heads on both ranks, and
   each rank's params copy holding 16 of the 32 experts (rank 1's count
   from its report).  A worker that dies fails the phase.  The kernel phase also
   times the paged kernel at the tp-2 shard's shape (KVH 16, G 1, HD 64,
   bf16, the timed config's lengths) with its bound, and at granite's
   heads (KVH 8, G 2, HD 64) and its tp-2 shard's (KVH 4), each held
   against the plain version and timed with its bound and SDPA's time
   (PAGED_TIMED_EXTRA); the kernels' record of the paged kernel
   gains ``launches_tp`` (both ranks' launches in the bf16 tp-2 serves of
   both models; granite's alone ``launches_tp_granite``).
   Phase 13's three children (the dry-run's and the kill and resume
   runs, from phase 11 on, and the other families' sharded training on
   the card) run beside this phase.

13. [dryrun]: the port's dry-run (``repro_torch.launch.dryrun``) in a
   subprocess that sees no card, so that its fake process group never
   meets a gloo group (started before phase 11, it counts on the host
   beside phases 11 and 12): stablelm-1.6b at full width, train_4k, prefill_32k
   and decode_32k on the 16x16 mesh over a fake world of 256 ranks and
   train_4k on 2x16x16 over 512, each row's compact lines printed as the
   JAX package's ``run_cell`` prints them; then the two-rank train cells
   of [train-sharded] on its (data, model) meshes; then train_4k
   of rwkv6-3b, zamba2-2.7b, internvl2-26b and whisper-large-v3 and
   long_500k of rwkv6-3b and zamba2-2.7b on 16x16 at full width; the MoE
   cells (train_4k, prefill_32k and decode_32k of qwen2-moe-a2.7b and
   granite-moe-1b-a400m on 16x16 and 2x16x16, experts split over
   ``model``); and the (data 1, model 2) train cells of
   [train-sharded]'s other families.  Gate: every cell ``ok``.
   [train-sharded]: the sharded trainer through the launcher
   (``repro_torch.launch.train.main``, this process rank 0): stablelm-1.6b
   at full width and depth, bf16 params and f32 moments from
   ``Model.init(seed=0)``, B 4 x S 512 from the pipeline, on two ranks
   sharing the one card over gloo (its first line says so): one step on
   one rank, then 2 steps on (data 2, model 1) with ZeRO-1 and on (data 1,
   model 2).  Gates: finite losses and grad norms on both ranks; step 0's
   loss within 1e-2 (relative) of the one-rank step's; under ZeRO-1 each
   rank's moment bytes exactly half of one rank's; rank 0's allocated
   bytes after placement (params and optimizer state) within 1% of the
   dry-run's ``argument_size_in_bytes`` for the same cell.  Printed, not
   gated: the measured peak against the dry-run's, and ms a step (two
   ranks on one card over gloo: not a speed).  A rank that dies fails the
   phase.  The other families, in a child on the card (the launcher's
   runs in turn, its rank 0 the child) that starts before phase 12 and
   runs beside it: rwkv6-3b and zamba2-2.7b at B 1 x S 128,
   whisper-large-v3 at B 2 x S 256, granite-moe-1b-a400m at B 4 x S 512,
   at full width and depth: one step on one rank, then 2 steps on (data
   1, model 2) under the train plan (every layer remat).  stablelm's runs
   start once the child has only whisper's and granite's left, and run
   beside them; the families' gates are read after them (ms a step
   beside other ranks: not a speed).  Gates as stablelm's (finite, step
   0's loss, allocated bytes against the dry-run's cell), each rank's
   scan launches (``wkv_fused`` / ``ssd_fused``) layers x segments a step
   on one rank, twice that under remat (the backward recomputes each
   layer's forward); whisper and granite launch no kernel; granite's
   ranks hold 16 of its 32 experts each, and step 0's aux loss on two
   ranks is printed beside one rank's.  (internvl2-26b and
   qwen2-moe-a2.7b are counted in the dry-run only: their f32 moments
   alone take 159 and 114 GB.)  The launcher's kill and resume over
   ranks, in a third child on the card that starts with the dry-run's,
   beside phases 11-12 (RESUME): reduced stablelm-1.6b and granite-moe-1b-a400m in f32 (a
   full-width checkpoint is 16-19 GB of npz), B 4 x S 32, 8 steps on
   (data 2) with a checkpoint every 4 and ``--fail-at-step 6``, then 8
   uninterrupted steps on (data 2), then ``--resume`` from copies of the
   step-4 checkpoint on (data 2), (data 1, model 2) and one rank.
   Gates: exit code 42 with the step-4 checkpoint alone; on (data 2)
   steps 4-7's losses, grad norms and aux losses bit for bit the
   uninterrupted run's; on the other splits the losses within 1e-5
   (relative); each resumed rank's moment bytes its ZeRO-1 share.

14. [examples]: the three user-facing examples of the port
   (``examples/quickstart_torch.py``, ``serve_batched_torch.py``,
   ``autotune_regions_torch.py``) at their default device, ``cuda``, one
   after another in a child on the card that starts with phase 13's
   first children, before phase 11, and runs beside phases 11-12 (the
   examples are small: reduced configs, counts on the meta device).
   Gates: the child exits 0; the batched-serving example's
   continuous-batching and overcommit sections end with 8/8 and 6/6
   requests ``DONE`` and no leaked page; its lockstep rwkv6-3b serve
   launches ``wkv_fused`` (the null plan runs the sequential recurrence
   in both prefill and decode, as the JAX package's example does, so
   ``wkv_chunk`` is printed, not gated); the plan JSON that the autotune
   example writes loads back with ``RegionPlan.from_json``.  Each
   example's wall time and launches by kernel are printed, and the
   kernels' record of ``wkv_fused`` and ``wkv_chunk`` gains
   ``launches_examples``.

``python3 chip_smoke.py --paged-host-time`` runs only the paged kernel's
timed config (both spins and the host time per call) and exits;
``python3 chip_smoke.py --train`` runs only the [train] phase,
``python3 chip_smoke.py --moe`` only the [moe] phase, ``--vlm`` only
the [vlm] phase and ``--serve-subsystems`` only phase 9 (each after
building the paged kernel), ``--whisper`` only the [whisper] phase and
``--bots`` only phase 10 (no kernel build), ``--train-recurrent`` only
phase 11 (after building the scan kernels), ``--tp`` only phase 12
(after building the paged kernel), ``--dryrun`` only phase 13 and
``--examples`` only phase 14 (each after building the scan kernels).

Random weights come from a seeded torch.Generator.  The launch counts of
each serve phase are set to 0 just before it and read just after.  The
line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

ARCH = "stablelm-1.6b"
# kernel vs plain version: repro_torch.kernels.ref.KERNEL_TOL, (rtol, atol)
# of f32 summation order plus, in bf16, half an ulp of the output's
# rounding.  tests/test_torch_kernels.py shows that a truncating store,
# probabilities rounded to bf16, a wrong page or dropped rows break it.
# q's spread: scores q.k/sqrt(HD) of std Q_STD * 0.5 = 2.5, so the softmax
# is peaked and the online rescale across tiles is exercised
Q_STD = 5.0
# full-width f32 logits, kernel path vs gather path: 24 layers of f32
# rounding in different summation orders
PARITY_TOL = 1e-3
SERVE = dict(max_len=1024, max_slots=8, page_size=16, prefill_chunk=256,
             n_requests=16, prompt=(64, 512), gen=(32, 64))
# paged_attention_mq: (label, B, KVH, G, HD, lengths(S)) at page_size 16
# and max_pages 64.  The first is the timed config of every PR since the
# kernel's first (stablelm-1.6b's heads, ragged lengths up to the block
# table's reach, one zero row); then qwen3-8b's GQA width (HD 128),
# qwen2-moe-a2.7b's MHA heads (16 of 128) and h2o-danube-1.8b's GQA width
# (HD 80) and internvl2-26b's (G 6, whose last row chunk is part-filled)
# on the same lengths, and one slot at full length at qwen3-8b's and
# h2o-danube-1.8b's, where every split of the table carries live data.
PAGED_PAGE_SIZE, PAGED_MAX_PAGES = 16, 64


def _ragged(S):
    return [PAGED_MAX_PAGES * PAGED_PAGE_SIZE - (S - 1), 1000, 777, 512, 300,
            64, 17, 0]


def _full(S):
    return [PAGED_MAX_PAGES * PAGED_PAGE_SIZE - (S - 1)]


PAGED_SHAPES = [("stablelm-1.6b", 8, 32, 1, 64, _ragged),
                ("qwen3-8b", 8, 8, 4, 128, _ragged),
                ("qwen2-moe-a2.7b", 8, 16, 1, 128, _ragged),
                ("h2o-danube-1.8b", 8, 8, 4, 80, _ragged),
                ("internvl2-26b", 8, 8, 6, 128, _ragged),
                ("qwen3-8b-long", 1, 8, 4, 128, _full),
                ("h2o-danube-1.8b-long", 1, 8, 4, 80, _full)]
# phase 12's MoE shapes, bf16 S 1 at the timed config's lengths, each
# held against the plain version and timed with its bound and SDPA's
# time: (record key suffix, label, KVH, G, HD) — granite-moe-1b-a400m's
# heads (GQA 16/8) and its tp-2 shard's
PAGED_TIMED_EXTRA = (("granite", "granite-moe-1b-a400m", 8, 2, 64),
                     ("granite_tp2_shard", "granite-moe-1b-a400m tp-2 shard",
                      4, 2, 64))
# recurrent serves: prompts whose fed part (prompt[:-1]) is a multiple of
# the chunk length 64 or at most 64 prefill through the chunk kernel, the
# ragged ones (99, 299, 199) through the fused kernel
RECURRENT_SERVE = dict(max_len=1024, max_slots=8, n_requests=16, gen=(32, 64),
                       prompts=(65, 129, 257, 513, 100, 300, 65, 129, 200,
                                257, 100, 513, 300, 65, 129, 200))
# the scan kernels' shapes, (B, T, chunk): decode at 8 slots (T=1, and
# T=3 for a spec_depth 2 verify, chunk 3 in chunk mode), the batch-1
# re-advance after a rejected draft (1, 1: most of the fused kernels'
# launches), one sequence's prefill aligned (T=512, 256, 64) and ragged
# (T=300), chunk 64 and 256;
# every shape is timed, the first entry of each list is the kernel's
# record.  The CUDA kernels a call are counted at the chunk kernels' first
# two shapes (several chunks, one chunk) and the fused kernels' first.
SCAN_SHAPES = {
    "wkv_fused": [(8, 1, 0), (1, 1, 0), (8, 3, 0), (1, 512, 0),
                  (1, 300, 0)],
    "wkv_chunk": [(1, 512, 64), (8, 3, 3), (1, 300, 64), (1, 256, 64),
                  (1, 64, 64), (1, 512, 256)],
    "ssd_fused": [(8, 1, 0), (1, 1, 0), (8, 3, 0), (1, 512, 0),
                  (1, 300, 0)],
    "ssd_chunk": [(1, 512, 64), (8, 3, 3), (1, 512, 256), (1, 300, 64),
                  (1, 256, 64), (1, 64, 64)],
}
# wkv_chunk with half its decays at w = 1e-30 (a 16-step sub-tile spans
# e^-1100): (B, T, chunk)
SCAN_EXTREME = (1, 512, 64)
# the families' scan widths (configs/rwkv6_3b.py, configs/zamba2_2_7b.py)
WKV_H, WKV_N = 40, 64
SSD_H, SSD_P, SSD_N = 80, 64, 64
# tuned_matmul: the JAX package's kernel tests ((M, K, N), (bm, bn, bk);
# the smoke runs every tile of the menu at each shape), then the main
# width's timed call: 8 slots x a 256-token prefill chunk against
# stablelm-1.6b's d_model x d_ff, at the default tiles
MATMUL_CASES = [((128, 128, 128), (64, 64, 64)),
                ((256, 512, 128), (128, 128, 128)),
                ((64, 384, 256), (32, 128, 128))]
MATMUL_TIMED = (2048, 2048, 5632)
# flash_attention: the JAX package's kernel tests (B = H = 2; S, D, bq, bk
# under each (causal, window)), then the masking cases, (S, Sk, D, bq, bk,
# causal, window): S != Sk on absolute positions, a non-causal window that
# sees keys past the query, and rows (qi >= Sk + window - 1) that see no
# key at all
ATTN_TESTS = [(128, 64, 64, 64), (256, 128, 128, 64), (128, 64, 32, 128)]
ATTN_MASKS = [(True, 0), (False, 0), (True, 32)]
ATTN_EXTRA = [(256, 128, 64, 64, 64, True, 16), (128, 256, 64, 32, 32,
                                                   False, 16),
              (256, 128, 64, 64, 32, False, 8)]
# the timed calls: stablelm-1.6b's heads (32 of 64) at B 8, S 512, causal,
# window 0 and 128, default tiles
# [train]: stablelm-1.6b at full width, 12 steps of B 8 x S 512 (4096
# tokens), AdamW at lr 3e-4 with the warmup-cosine schedule over the 12
TRAIN = dict(batch=8, seq=512, steps=12, lr=3e-4)
# [moe]: qwen2-moe-a2.7b served at full width and depth in bf16; its f32
# checks on a full-width copy of the first two layers.  Einsum against
# scatter dispatch at capacity factor 8.0: the JAX package's own tolerance
# (tests/test_impl_equivalence.py), rtol = atol.  A route may differ
# between the card and the CPU only at a near-tie: the CPU's
# probabilities at the first differing rank and the next within MOE_TIE.
# [train-moe]: granite-moe-1b-a400m at full width, 4 steps of B 8 x S 512
MOE_ARCH = "qwen2-moe-a2.7b"
MOE_IMPL_TOL = 2e-3
MOE_TIE = 1e-5
MOE_TRAIN_ARCH = "granite-moe-1b-a400m"
MOE_TRAIN = dict(batch=8, seq=512, steps=4, lr=3e-4)
ATTN_TIMED = dict(B=8, S=512, H=32, D=64, windows=(0, 128))
# [vlm]: internvl2-26b's backbone served at full width and depth in bf16
# on the SERVE trace; its f32 check on a full-width copy of two layers
VLM_ARCH = "internvl2-26b"
# [whisper]: whisper-large-v3 served through Engine.generate: 4-token
# prompts (the decoder's task prefix), 8 rows a group, max_len 448 (the
# decoder's context); [train-whisper]: B 2 x S 448 (null plan and remat),
# then remat at B 4
WHISPER_ARCH = "whisper-large-v3"
WHISPER_SERVE = dict(n_requests=16, prompt=4, gen=(32, 64), slots=8,
                     max_len=448)
WHISPER_TRAIN = dict(batch=2, seq=448, steps=3, lr=3e-4, remat_batch=4)
# [train-recurrent]: rwkv6-3b and zamba2-2.7b trained at full width and
# depth, S 512 (four 128-step segments of the scans' gradient), bf16
# params and f32 AdamW moments.  B per plan: the largest of `batches`
# whose count on the meta device (saved tensors, resident params, grads
# and moments, one layer's backward working set, the f32 logits and their
# gradient) fits `mem_share` of the card.  The null plan runs `steps`
# steps (3 for rwkv6-3b, whose resume is checked at step 2), every layer
# remat `remat_steps`, the chunked scans one.  The
# chunked step's loss is held to the sequential one's within CHUNK_LOSS_RTOL
# (bf16 activations downstream of two f32 scans that differ by
# reassociation).  First the scans' gradient on the card at
# SCAN_GRAD_CASES ((B, T), segment), f32, at full head width: the
# autograd Function's grads against autograd through the plain form on
# the same card, within ref.KERNEL_TOL[f32] scaled by T (the gradient sums
# over up to T steps).
RECURRENT_TRAIN = dict(archs=("rwkv6-3b", "zamba2-2.7b"), seq=512,
                       batches=(8, 4, 2),
                       steps={"rwkv6-3b": 2, "zamba2-2.7b": 1},
                       remat_steps=1, lr=3e-4, mem_share=0.85)
CHUNK_LOSS_RTOL = 1e-3
SCAN_GRAD_CASES = [((2, 130), 64), ((2, 130), 128), ((2, 256), 64),
                   ((2, 256), 128)]
# [telemetry]: the SERVE trace with telemetry off and on (debug level,
# trace, metrics and event log); tok/s on against off over TELEMETRY_PAIRS
# interleaved pairs on the warmed engines
TELEMETRY_PAIRS = 3
# [faults]: tests/test_faults.py's chaos config scaled to full width:
# SERVE's slots, page size and chunk, spec_depth 2, prefix caching on,
# lazy reservation on FAULTS["kv_pages"] pages (the first 8 requests' lazy
# admissions alone take 120), faults at FAULTS_RATE a site draw from seed
# 7; the trace's requests 8-15 repeat the prompts of 0-7
FAULTS = dict(spec_depth=2, kv_pages=97, reservation="lazy",
              mem_watermark=0.0, prefix_cache="on")
FAULTS_RATE = 0.15
# [bots]: the BOTS-analog sweep at sizes that make the card work.
# strassen: A and B 256 MiB each, 49 leaf pairs of 2048^2, 0.84 TFLOP of
# leaf products; nqueens: 6404 subtree roots (count 73712); sparselu: 100
# MB of blocks; health: a 16 MiB int32 state; floorplan: the JAX package's
# size (its small working set is the point of it)
BOTS_SIZES = {"strassen": dict(n=8192, depth=2),
              "nqueens": dict(n=13, prefix=4),
              "sparselu": dict(nb=50, bs=100, band=3),
              "health": dict(villages=1 << 20, steps=64),
              "floorplan": dict(n_cells=5)}
# the paper's best mode per workload (benchmarks/bench_bots.py: Strassen,
# SparseLU and Health at SMT2, NQueens at SMT4, Floorplan at SMT1) as a
# degree of suite.DEGREES, whose 1 / 4 / 8 / 16 stand for its 1 / 32 / 64
# / 128 threads on 32 cores: SMT1 4, SMT2 8, SMT4 16
# timed calls a (workload, degree) after the warm one (their median)
BOTS_REPEATS = 2
PAPER_BEST = {"strassen": 8, "nqueens": 16, "sparselu": 8, "health": 8,
              "floorplan": 4}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 30, flush_mb: int = 128,
            spin: int = 2_000_000) -> float:
    """Median device time of ``fn`` over ``iters`` runs, each after the L2
    cache was flushed by writing a buffer larger than it: in the decode
    step each layer's K/V comes cold from device memory.  A spin kernel of
    ``spin`` cycles (~1 ms by default) is queued after the flush, so the
    host has enqueued ``fn``'s launch before the start event runs: a kernel
    of a few microseconds is timed, not the wrapper's host-side enqueue.
    With a ~100 us spin (200,000 cycles) a call whose host time exceeds
    the spin is timed from the start event to its kernel's end, host time
    included; the paged kernel's timed config is also timed so, and its
    host time per call is measured on its own (``host_us_per_call``).  A
    ~50 ms spin and three untimed rounds come first, so that the card has
    left its idle clocks: without them a kernel's first shape, timed after
    the host had left the card idle, read 4x slower than a larger shape
    timed later."""
    flush = torch.empty(flush_mb << 20, dtype=torch.uint8, device="cuda")
    torch.cuda._sleep(100_000_000)
    times = []
    for i in range(iters + 3):
        flush.zero_()
        torch.cuda._sleep(spin)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        if i >= 3:
            times.append(a.elapsed_time(b))
    return float(np.median(times))


def timer_floor(torch) -> float:
    """``time_ms`` of a do-nothing launch (``torch.cuda._sleep(0)``): the
    floor under every time of a few microseconds, the events and one
    launch included."""
    ms = time_ms(torch, lambda: torch.cuda._sleep(0))
    log(f"[timer] time_ms of a do-nothing launch (torch.cuda._sleep(0)): "
        f"{ms:.4f} ms")
    return ms


def host_us_per_call(torch, fn, calls: int = 1000, batch: int = 100) -> float:
    """The host's wall time of one call of ``fn``, in microseconds: ``calls``
    calls with no synchronisation among them, after ``batch`` warm-up
    calls.  They run in batches of ``batch`` with a synchronisation between
    batches, outside the timed span, so the launch queue never fills and
    the host never waits on the card: what is timed is the enqueueing."""
    for _ in range(batch):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(calls // batch):
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total / (calls // batch * batch) * 1e6


def paged_host_time(torch) -> None:
    """``chip_smoke.py --paged-host-time``: only the paged kernel's timed
    config through ``kernels.ops``, timed with the ~1 ms and the ~100 us
    spin, and its host time per call.  It uses nothing of the package but
    ``ops.paged_attention_mq``, so a copy of this script placed in an
    older checkout measures that checkout's wrapper."""
    from repro_torch.kernels import ops
    _, B, KVH, G, HD, lens = PAGED_SHAPES[0]
    args = paged_inputs(torch, 12, B, 1, KVH, G, HD, PAGED_PAGE_SIZE,
                        PAGED_MAX_PAGES, lens(1), torch.bfloat16)

    def call():
        return ops.paged_attention_mq(*args)
    call()
    torch.cuda.synchronize()
    for _ in range(2):
        log(f"[host] paged_attention_mq timed config ({SRC}): "
            f"{time_ms(torch, call):.4f} ms (~1 ms spin), "
            f"{time_ms(torch, call, spin=200_000):.4f} ms (~100 us spin), "
            f"host {host_us_per_call(torch, call):.2f} us a call")


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


def paged_inputs(torch, seed, B, S, KVH, G, HD, ps, MP, lengths, dtype):
    """q from N(0, Q_STD^2), pages from N(0, 0.5^2), non-aliasing block tables
    covering lengths[b] + S - 1 positions per row (a zero-length row stays
    parked on the null page when S == 1), made on the host from ``seed``
    and moved to the card."""
    gen = torch.Generator().manual_seed(seed)
    P = 1 + B * MP
    q = torch.randn((B, S, KVH, G, HD), generator=gen) * Q_STD
    kp = torch.randn((P, ps, KVH, HD), generator=gen) * 0.5
    vp = torch.randn((P, ps, KVH, HD), generator=gen) * 0.5
    perm = torch.randperm(P - 1, generator=gen) + 1
    bt = torch.zeros((B, MP), dtype=torch.int32)
    used = 0
    for b, n_tok in enumerate(lengths):
        n = -(-(n_tok + S - 1) // ps)
        bt[b, :n] = perm[used:used + n]
        used += n
    lens = torch.tensor(lengths, dtype=torch.int32)
    return [t.to("cuda", dtype) for t in (q, kp, vp)] + [bt.cuda(),
                                                          lens.cuda()]


def paged_bytes(q, block_tables, lengths, S) -> int:
    """The bytes a paged call on these inputs must move
    (``repro_torch.kernels.work``)."""
    from repro_torch.kernels import work
    B, _, KVH, G, HD = q.shape
    return work.paged_attention(
        B, S, KVH, G, HD, q.element_size(), block_tables.shape[1], 0,
        lengths=[int(x) for x in lengths.cpu()])[0]


def paged_work(q, block_tables, lengths, S):
    """The least time the card could take for a paged call on these inputs
    (its lengths: the K/V of the positions each slot's last query sees),
    and what bounds it (``repro_torch.kernels.work``)."""
    from repro_torch.core.roofline import card_for_device
    from repro_torch.kernels import work
    B, _, KVH, G, HD = q.shape
    nbytes, ops = work.paged_attention(
        B, S, KVH, G, HD, q.element_size(), block_tables.shape[1],
        0, lengths=[int(x) for x in lengths.cpu()])
    return work.bound_ms(nbytes, ops, q.dtype, card_for_device(q.device))


def kernel_phase(torch) -> dict:
    """paged_attention_mq against its plain version at every shape of
    PAGED_SHAPES (f32 and bf16, S 1 and 3, block_k 0 and 8), each call
    timed with its achieved GB/s; at the timed config (bf16, S 1, block_k
    0) also the plain version, the library call and the bound, the CUDA
    kernels one wrapper call launches (:func:`kernels_per_call`) and one
    call under ``torch.cuda.set_sync_debug_mode("error")``.  Returns the
    kernel's record."""
    from library_yardsticks import dense_paged_inputs, paged_attention_library
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as pa
    ps, MP = PAGED_PAGE_SIZE, PAGED_MAX_PAGES
    record, timed, vlm = None, {}, {}
    for label, B, KVH, G, HD, lens in PAGED_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            rtol, atol = ref.KERNEL_TOL[dtype]
            for S in (1, 3):
                lengths = lens(S)
                args = paged_inputs(torch, 11 + S, B, S, KVH, G, HD, ps, MP,
                                    lengths, dtype)
                want = ref.paged_attention_mq(*args)
                act = args[4] > 0
                bound_ms, bound_by = paged_work(args[0], args[3], args[4], S)
                nbytes = paged_bytes(args[0], args[3], args[4], S)
                p = pa.plan(B, S, KVH, G, HD, args[0].element_size(), ps, MP,
                            pa.sm_count(args[0].device))
                for bk in (0, 8):
                    got = ops.paged_attention_mq(*args, block_k=bk)
                    torch.cuda.synchronize()
                    check(got.dtype == dtype and got.shape == args[0].shape,
                          f"kernel output {got.dtype} {tuple(got.shape)}")
                    check(bool(torch.isfinite(got.float()).all()),
                          "kernel output not finite (zero-length row "
                          "included)")
                    g, w = got.float()[act], want[act]
                    err = float((g - w).abs().max())
                    ok = ref.within_tol(g, w, dtype)
                    ms = time_ms(torch, lambda: ops.paged_attention_mq(
                        *args, block_k=bk))
                    log(f"[kernel] paged_attention_mq {label} {dname} B={B} "
                        f"S={S} KVH={KVH} G={G} HD={HD} block_k={bk}: "
                        f"max_abs_err={err:.3e} (tol {atol} + {rtol:.3g} x "
                        f"|plain|, max|plain|={float(w.abs().max()):.3f}) "
                        f"ms={ms:.4f} ({nbytes / ms / 1e6:.1f} GB/s, bound "
                        f"{bound_ms:.5f} ms {bound_by}; {p.blocks(B, KVH)} "
                        f"blocks, {p.n_split} splits of "
                        f"{p.pages_per_split} pages)")
                    check(ok, f"paged_attention_mq {label} {dname} S={S} "
                              f"block_k={bk} disagrees with its plain "
                              f"version: {err}")
                    if label == PAGED_SHAPES[0][0] and dname == "bfloat16" \
                            and bk == 0:
                        timed[S] = (ms, err, args, bound_ms, bound_by, nbytes)
                    if label == VLM_ARCH and dname == "bfloat16" and bk == 0:
                        vlm[S] = (ms, bound_ms)
    # the timed config: the main path's decode call (S 1) and verify (S 3)
    ms, err, args, bound_ms, bound_by, nbytes = timed[1]
    ms_short = time_ms(torch, lambda: ops.paged_attention_mq(*args),
                       spin=200_000)
    host_us = host_us_per_call(torch, lambda: ops.paged_attention_mq(*args))
    plain_ms = time_ms(torch, lambda: ref.paged_attention_mq(*args))
    dense = dense_paged_inputs(*args)
    lib_ms = time_ms(torch, lambda: paged_attention_library(*dense))
    n_kernels = kernels_per_call(
        torch, lambda: ops.paged_attention_mq(*args))
    check(n_kernels == pa.KERNELS_PER_CALL,
          f"one paged_attention_mq call launched {n_kernels} CUDA kernels, "
          f"the design launches {pa.KERNELS_PER_CALL}")
    # the wrapper reads no device value on the host: no synchronisation
    torch.cuda.set_sync_debug_mode("error")
    try:
        ops.paged_attention_mq(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    B, _, KVH, G, HD = args[0].shape
    lengths = [int(x) for x in args[4].cpu()]
    # the tp-2 shard's shape (phase 12): half the kv heads, same lengths
    shard = paged_inputs(torch, 12, B, 1, KVH // 2, G, HD, ps, MP, lengths,
                         torch.bfloat16)
    got = ops.paged_attention_mq(*shard)
    want = ref.paged_attention_mq(*shard)
    live = shard[4] > 0
    err_tp = float((got.float()[live] - want[live]).abs().max())
    check(ref.within_tol(got.float()[live], want[live], torch.bfloat16),
          f"paged_attention_mq at the tp-2 shard's shape disagrees: {err_tp}")
    ms_tp = time_ms(torch, lambda: ops.paged_attention_mq(*shard))
    bound_tp, by_tp = paged_work(shard[0], shard[3], shard[4], 1)
    log(f"[kernel] paged_attention_mq tp-2 shard bf16 B={B} S=1 "
        f"KVH={KVH // 2} G={G} HD={HD} (the timed config's lengths): "
        f"max_abs_err={err_tp:.3e} ms={ms_tp:.4f} bound {bound_tp:.5f} ms "
        f"({by_tp})")
    record = {
        "name": "paged_attention_mq", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:156",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
        "gb_per_s": nbytes / ms / 1e6, "ms_s3": timed[3][0],
        "ms_short_spin": ms_short, "host_us": host_us,
        "kernels_per_call": n_kernels,
        "shape": f"bf16 B={B} S=1 KVH={KVH} G={G} HD={HD} page_size={ps} "
                 f"max_pages={MP} lengths={lengths}",
        "ms_vlm": vlm[1][0], "ms_vlm_s3": vlm[3][0],
        "bound_ms_vlm": vlm[1][1],
        "ms_tp2_shard": ms_tp, "bound_ms_tp2_shard": bound_tp,
        "max_abs_err_tp2_shard": err_tp,
    }
    for key, label, kvh_x, g_x, hd_x in PAGED_TIMED_EXTRA:
        xargs = paged_inputs(torch, 13, B, 1, kvh_x, g_x, hd_x, ps, MP,
                             lengths, torch.bfloat16)
        got = ops.paged_attention_mq(*xargs)
        want = ref.paged_attention_mq(*xargs)
        live = xargs[4] > 0
        err_x = float((got.float()[live] - want[live]).abs().max())
        check(ref.within_tol(got.float()[live], want[live], torch.bfloat16),
              f"paged_attention_mq at {label}'s heads disagrees: {err_x}")
        ms_x = time_ms(torch, lambda: ops.paged_attention_mq(*xargs))
        bound_x, by_x = paged_work(xargs[0], xargs[3], xargs[4], 1)
        dense = dense_paged_inputs(*xargs)
        lib_x = time_ms(torch, lambda: paged_attention_library(*dense))
        del dense
        record.update({f"ms_{key}": ms_x, f"bound_ms_{key}": bound_x,
                       f"library_ms_{key}": lib_x,
                       f"max_abs_err_{key}": err_x})
        log(f"[kernel] paged_attention_mq {label} bf16 B={B} S=1 "
            f"KVH={kvh_x} G={g_x} HD={hd_x} (the timed config's lengths): "
            f"max_abs_err={err_x:.3e} kernel {ms_x:.4f} ms, bound "
            f"{bound_x:.5f} ms ({by_x}, {bound_x / ms_x:.1%} of its rate), "
            f"SDPA {lib_x:.4f} ms")
    log(f"[kernel] timed config {record['shape']}: kernel {ms:.4f} ms "
        f"({record['gb_per_s']:.1f} GB/s, {bound_ms / ms:.1%} of the "
        f"bound's rate; {ms_short:.4f} ms after a ~100 us spin), S=3 "
        f"{timed[3][0]:.4f} ms ({timed[3][5] / timed[3][0] / 1e6:.1f} "
        f"GB/s), plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
        f"{bound_ms:.5f} ms ({bound_by}); host {host_us:.2f} us a call; "
        f"CUDA kernels a call: {n_kernels}; a call under sync debug mode "
        f"'error' raised nothing")
    return record


def kernels_per_call(torch, fn, calls: int = 20) -> int:
    """The CUDA kernels one call of ``fn`` launches (after a warm-up call,
    which may make buffers): the kernel, copy and memset nodes of one call
    captured into a CUDA graph (:func:`graph_device_ops`), an exact count
    that needs no tracer.  torch.profiler counts the same over ``calls``
    calls as a cross-check (every device op it records, divided by
    ``calls`` and rounded): a call that ran an op the capture missed (on
    another stream) shows there as more, which fails; fewer is CUPTI
    dropping activity records (a window of none was seen on an H100), and
    is logged, not counted."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    n_graph = graph_device_ops(torch, fn)
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    log(f"[kernel] captured graph: {n_graph} device op(s) a call; profiler: "
        f"{calls} calls ran {len(names)} device op(s): "
        f"{sorted(set(n[:60] for n in names))}")
    n_prof = round(len(names) / calls)
    check(n_prof <= n_graph, f"torch.profiler counts {n_prof} CUDA kernels "
                             f"a call, the captured graph {n_graph}")
    return n_graph


def graph_device_ops(torch, fn) -> int:
    """The kernel, memcpy and memset nodes of one call of ``fn`` captured
    into a CUDA graph (``torch.cuda.graph``, read through the driver's
    ``cuGraphGetNodes`` / ``cuGraphNodeGetType``).  The capture stream
    runs one call first, as the engine's graphs warm up: a wrapper's first
    call on a stream may make (and zero) buffers it keeps for that stream.
    Capture records and runs nothing."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, stream=side):
        fn()
    try:
        raw = ctypes.c_void_p(g.raw_cuda_graph())
        n = ctypes.c_size_t(0)
        check(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)) == 0,
              "cuGraphGetNodes failed")
        nodes = (ctypes.c_void_p * n.value)()
        check(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) == 0,
              "cuGraphGetNodes failed")
        kinds = []
        for node in nodes:
            kind = ctypes.c_int(-1)
            check(cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                        ctypes.byref(kind)) == 0,
                  "cuGraphNodeGetType failed")
            kinds.append(kind.value)
    finally:
        g.reset()
    # CU_GRAPH_NODE_TYPE_KERNEL, _MEMCPY, _MEMSET
    return sum(k in (0, 1, 2) for k in kinds)


def scan_inputs(torch, name, seed, B, T):
    """Kernel-layout f32 inputs on the card, made on the host from
    ``seed``: WKV r, k, v ~ N(0, 0.3^2), decays w in (0.45, 0.95), u and
    the entry state ~ N(0, 0.1^2); SSD x, b, c ~ N(0, 0.3^2), dt =
    softplus(N(0, 1)), a = -exp(N(0, 0.3^2)), entry state ~ N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    n = rng.standard_normal
    if name.startswith("wkv"):
        H, N = WKV_H, WKV_N
        r, k, v = (n((B, H, T, N)) * 0.3 for _ in range(3))
        w = 0.45 + 0.5 / (1 + np.exp(-n((B, H, T, N))))
        arrs = (r, k, v, w, n((H, N)) * 0.1, n((B, H, N, N)) * 0.1)
    else:
        H, P, N = SSD_H, SSD_P, SSD_N
        arrs = (n((B, H, T, P)) * 0.3, n((B, T, N)) * 0.3,
                n((B, T, N)) * 0.3, np.log1p(np.exp(n((B, H, T)))),
                -np.exp(n((H,)) * 0.3), n((B, H, P, N)) * 0.1)
    return [torch.tensor(a, dtype=torch.float32, device="cuda")
            for a in arrs]


def scan_kernel_call(name, args, chunk):
    from repro_torch.kernels import linear_scan as ls
    fn = ls.wkv if name.startswith("wkv") else ls.ssd
    return lambda: fn(*args, chunk=chunk)


def scan_plain_call(name, args, chunk):
    """The kernel's plain version on the same inputs (model layout: T and
    H swapped back); returns kernel-layout output and the state."""
    from repro_torch.kernels import ref
    if name.startswith("wkv"):
        r, k, v, w, u, s0 = args
        tr = [t.transpose(1, 2) for t in (r, k, v, w)]
        fn = ((lambda: ref.wkv_chunk(*tr, u, s0, chunk)) if chunk
              else (lambda: ref.wkv_linear_scan(*tr, u, s0)))
    else:
        x, b, c, dt, a, s0 = args
        xm, dtm = x.transpose(1, 2), dt.transpose(1, 2)
        fn = ((lambda: ref.ssd_chunk(xm, b, c, dtm, a, s0, chunk)) if chunk
              else (lambda: ref.ssd_linear_scan(xm, b, c, dtm, a, s0)))

    def call():
        out, s = fn()
        return out.transpose(1, 2), s
    return call


def scan_work(torch, name, B, T):
    """The least time in ms the card could take for one scan call (f32),
    and what bounds it (``repro_torch.kernels.work``: the chunked forms
    compute the same function, so the chunk length does not enter).  The
    operations are over the rate of the units the kernels use, the f32
    CUDA cores (:func:`scan_rate`)."""
    from repro_torch.core.roofline import card_for_device
    from repro_torch.kernels import work
    nbytes, ops = (work.wkv(B, WKV_H, T, WKV_N) if name.startswith("wkv")
                   else work.ssd(B, SSD_H, T, SSD_P, SSD_N))
    return work.bound_ms(nbytes, ops, torch.float32, card_for_device("cuda"))


def scan_rate(torch) -> str:
    """The peak rate that scan_work's operations are taken at."""
    from repro_torch.core.roofline import card_for_device, peak_ops
    peak = peak_ops(torch.float32, card_for_device("cuda"))
    return f"f32 CUDA cores, {peak / 1e12:.0f} TFLOP/s"


def scan_checks(torch, name, args, chunk) -> tuple:
    """A scan kernel's CUDA kernels a call (:func:`kernels_per_call`),
    held to ``linear_scan.kernels_per_call`` (one for the fused kernels),
    and one call under sync debug mode 'error' (the wrapper reads nothing
    back and synchronises nothing)."""
    from repro_torch.kernels import linear_scan as ls
    T = args[0].shape[2]
    n = kernels_per_call(torch, scan_kernel_call(name, args, chunk))
    want = ls.kernels_per_call(T, chunk)
    check(n == want, f"{name} T={T} chunk={chunk}: {n} CUDA kernels a "
                     f"call, the design launches {want}")
    torch.cuda.set_sync_debug_mode("error")
    try:
        scan_kernel_call(name, args, chunk)()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return n, want


def scan_extreme_phase(torch) -> float:
    """wkv_chunk at SCAN_EXTREME with half its decays at 1e-30: finite and
    within ref.KERNEL_TOL of the plain chunked form and of the plain
    recurrence.  Returns the larger error."""
    from repro_torch.kernels import ref
    B, T, chunk = SCAN_EXTREME
    args = scan_inputs(torch, "wkv_chunk", 7, B, T)
    g = torch.Generator(device="cuda").manual_seed(7)
    tiny = torch.rand(args[3].shape, generator=g, device="cuda") < 0.5
    args[3] = torch.where(tiny, torch.full_like(args[3], 1e-30), args[3])
    got = scan_kernel_call("wkv_chunk", args, chunk)()
    err = 0.0
    for want in (scan_plain_call("wkv_chunk", args, chunk)(),
                 scan_plain_call("wkv_fused", args, 0)()):
        torch.cuda.synchronize()
        for g_, w_ in zip(got, want):
            check(bool(torch.isfinite(g_).all()),
                  "wkv_chunk at extreme decays: not finite")
            err = max(err, float((g_ - w_).abs().max()))
            check(ref.within_tol(g_, w_, torch.float32),
                  f"wkv_chunk at extreme decays disagrees: {err}")
    log(f"[scan] wkv_chunk B={B} T={T} chunk={chunk} with half the decays "
        f"at 1e-30: finite, max_abs_err={err:.3e} against the plain "
        f"chunked form and the plain recurrence")
    return err


def scan_kernel_phase(torch) -> dict:
    """Each scan kernel against its plain version at every shape of
    SCAN_SHAPES: output and final state within ref.KERNEL_TOL in f32
    (1e-5 + 1e-5 x |plain|: both sum in f32, in different orders).
    Returns the kernels' records, timed at each list's first shape."""
    from repro_torch.kernels import ref
    records, rate = {}, scan_rate(torch)
    for name, shapes in SCAN_SHAPES.items():
        for i, (B, T, chunk) in enumerate(shapes):
            args = scan_inputs(torch, name, 100 + i, B, T)
            kern = scan_kernel_call(name, args, chunk)
            plain = scan_plain_call(name, args, chunk)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            errs, ok = [], True
            for g, w in zip(got, want):
                check(g.shape == w.shape, f"{name}: shape {tuple(g.shape)} "
                                          f"!= {tuple(w.shape)}")
                check(bool(torch.isfinite(g).all()), f"{name}: not finite")
                errs.append(float((g - w).abs().max()))
                ok &= ref.within_tol(g, w, torch.float32)
            ms = time_ms(torch, kern)
            shape_bound, _ = scan_work(torch, name, B, T)
            log(f"[scan] {name} B={B} T={T} chunk={chunk}: max_abs_err "
                f"out={errs[0]:.3e} state={errs[1]:.3e} (tol 1e-5 + 1e-5 x "
                f"|plain|, max|plain| out={float(want[0].abs().max()):.3f} "
                f"state={float(want[1].abs().max()):.3f}) ms={ms:.4f} "
                f"(bound {shape_bound:.5f})")
            check(ok, f"{name} B={B} T={T} chunk={chunk} disagrees with its "
                      f"plain version: {errs}")
            if i < (2 if chunk else 1):
                n, _ = scan_checks(torch, name, args, chunk)
                log(f"[scan] {name} B={B} T={T} chunk={chunk}: {n} CUDA "
                    f"kernels a call; a call under sync debug mode 'error' "
                    f"raised nothing")
            if i == 0:
                plain_ms = time_ms(torch, plain, iters=5 if T > 64 else 30)
                bound_ms, bound_by = scan_work(torch, name, B, T)
                records[name] = {
                    "name": name, "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/linear_scan.cu",
                    "replaces": {
                        "wkv_fused": "src/repro/kernels/linear_scan.py:73",
                        "wkv_chunk": "src/repro/kernels/linear_scan.py:148",
                        "ssd_fused": "src/repro/kernels/linear_scan.py:209",
                        "ssd_chunk": "src/repro/kernels/linear_scan.py:286",
                    }[name],
                    "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    # no single PyTorch call computes a WKV or SSD scan
                    "library_ms": None, "bound_rate": rate,
                    "shape": f"f32 B={B} T={T} chunk={chunk}",
                    "ms_by_shape": {},
                }
                log(f"[scan] timed {name} {records[name]['shape']}: kernel "
                    f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                    f"{bound_ms:.4f} ms ({bound_by}; {rate}), library: none")
            records[name]["ms_by_shape"][f"{B},{T},{chunk}"] = ms
    records["wkv_chunk"]["extreme_max_abs_err"] = scan_extreme_phase(torch)
    return records


def scan_host_phase(torch, records: dict) -> None:
    """The fused scan wrappers' host time a call at 8 slots, T=1, through
    ``kernels.ops`` (f32 inputs in the model layout, so that no conversion
    is timed), in turns (wkv, ssd, ssd, wkv): what a CUDA graph of the
    step would no longer pay."""
    from repro_torch.kernels import ops
    calls = {}
    for name, fn in (("wkv_fused", ops.wkv), ("ssd_fused", ops.ssd)):
        args = scan_inputs(torch, name, 400, 8, 1)
        if name == "wkv_fused":
            model = [t.transpose(1, 2).contiguous() for t in args[:4]]
            model += args[4:]
        else:
            x, b, c, dt, a, s0 = args
            model = [x.transpose(1, 2).contiguous(), b, c,
                     dt.transpose(1, 2).contiguous(), a, s0]
        calls[name] = (lambda fn=fn, model=model: fn(*model))
    times: dict = {name: [] for name in calls}
    for name in ("wkv_fused", "ssd_fused", "ssd_fused", "wkv_fused"):
        times[name].append(host_us_per_call(torch, calls[name]))
    for name, us in times.items():
        records[name]["host_us"] = us
        log(f"[host] {name} B=8 T=1 through kernels.ops (f32, model "
            f"layout): host {us[0]:.2f} / {us[1]:.2f} us a call")


def launch_shapes(names) -> dict:
    """The launches so far of the kernels ``names`` by (kernel, B, T,
    chunk): the wrappers' own shape tally, to which every replay of a CUDA
    graph adds the launches it captured."""
    from repro_torch.kernels import LAUNCH_SHAPES
    return {k: n for k, n in LAUNCH_SHAPES.items() if k[0] in names}


def serve_shape_phase(torch, counts: dict, records: dict) -> None:
    """Each scan kernel at every (B, T, chunk) the serves launched, timed
    on fresh inputs: its launches by shape, the time a call and the bound
    at each, and launches x (time - bound) summed over them (the device
    time the serves lose to the kernel against its bound)."""
    by_kernel: dict = {}
    for (name, B, T, chunk), n in sorted(counts.items()):
        args = scan_inputs(torch, name, 300, B, T)
        ms = time_ms(torch, scan_kernel_call(name, args, chunk), iters=10)
        bound_ms, _ = scan_work(torch, name, B, T)
        by_kernel.setdefault(name, []).append(
            {"B": B, "T": T, "chunk": chunk, "launches": n, "ms": ms,
             "bound_ms": bound_ms})
        log(f"[serve-shapes] {name} B={B} T={T} chunk={chunk}: {n} "
            f"launches x ({ms:.4f} - {bound_ms:.5f}) ms = "
            f"{n * (ms - bound_ms):.1f} ms")
    for name, rows in by_kernel.items():
        loss = sum(r["launches"] * (r["ms"] - r["bound_ms"]) for r in rows)
        records[name]["launches_by_shape"] = rows
        records[name]["serve_loss_ms"] = loss
        log(f"[serve-shapes] {name}: {sum(r['launches'] for r in rows)} "
            f"launches over {len(rows)} shapes, launches x (time - bound) "
            f"= {loss:.1f} ms")


def _dense_check(torch, name, got, want, dtype, what) -> float:
    """Hold a kernel's output against its plain version's within
    ref.KERNEL_TOL; returns the largest error."""
    from repro_torch.kernels import ref
    check(got.dtype == dtype and got.shape == want.shape,
          f"{name} output {got.dtype} {tuple(got.shape)}")
    check(bool(torch.isfinite(got.float()).all()), f"{name} not finite")
    err = float((got.float() - want).abs().max())
    rtol, atol = ref.KERNEL_TOL[dtype]
    log(f"[kernel] {name} {what}: max_abs_err={err:.3e} (tol {atol} + "
        f"{rtol:.3g} x |plain|, max|plain|={float(want.abs().max()):.3f})")
    check(ref.within_tol(got, want, dtype),
          f"{name} {what} disagrees with its plain version: {err}")
    return err


def _outside(got, want, dtype) -> int:
    """How many elements of ``got`` lie outside ref.KERNEL_TOL of ``want``."""
    from repro_torch.kernels import ref
    rtol, atol = ref.KERNEL_TOL[dtype]
    return int(((got.float() - want).abs() > atol + rtol * want.abs()).sum())


def _randn(torch, rng, shape, std, dtype):
    return torch.tensor(rng.standard_normal(shape) * std,
                        dtype=torch.float32, device="cuda").to(dtype)


def dense_kernel_phase(torch) -> dict:
    """tuned_matmul and flash_attention against their plain versions at
    every case of the JAX package's kernel tests and the masking cases
    (f32 and bf16, within ref.KERNEL_TOL), then timed at stablelm-1.6b's
    full width in both dtypes beside their plain versions, one library
    call each and their bounds.  Returns the two kernels' records (the
    bf16 calls; f32 timings are logged)."""
    from library_yardsticks import (attention_library, dense_attention_inputs,
                                    matmul_library)
    from repro_torch.core.roofline import card_for_device
    from repro_torch.kernels import ops, ref, work
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import tuned_matmul as tm
    rng = np.random.default_rng(21)
    errs = {"tuned_matmul": 0.0, "flash_attention": 0.0}
    # every tile of the menu at the JAX test shapes, then the default tiles
    # at (64, 384, 256) (clamped to (64, 128, 128))
    mm_cases = [(shape, tiles) for shape, _ in MATMUL_CASES
                for tiles in tm.MENU] + [((64, 384, 256), None)]
    for dtype in (torch.float32, torch.bfloat16):
        for (M, K, N), tiles in mm_cases:
            x = _randn(torch, rng, (M, K), 0.5, dtype)
            y = _randn(torch, rng, (K, N), 0.5, dtype)
            if tiles is None:
                got, what = ops.matmul(x, y), "default tiles"
            else:
                got = ops.matmul(x, y, bm=tiles[0], bn=tiles[1],
                                 bk=tiles[2])
                what = f"tiles={tiles}"
            torch.cuda.synchronize()
            errs["tuned_matmul"] = max(errs["tuned_matmul"], _dense_check(
                torch, "tuned_matmul", got, ref.matmul(x, y), dtype,
                f"{dtype} M={M} K={K} N={N} {what}"))
        cases = [(S, S, D, bq, bk, causal, window)
                 for S, D, bq, bk in ATTN_TESTS
                 for causal, window in ATTN_MASKS] + ATTN_EXTRA
        for S, Sk, D, bq, bk, causal, window in cases:
            q = _randn(torch, rng, (2, S, 2, D), 0.5, dtype)
            k = _randn(torch, rng, (2, Sk, 2, D), 0.5, dtype)
            v = _randn(torch, rng, (2, Sk, 2, D), 0.5, dtype)
            got = ops.attention(q, k, v, causal=causal, window=window,
                                block_q=bq, block_k=bk)
            torch.cuda.synchronize()
            want = ref.flash_attention(q, k, v, causal=causal, window=window)
            errs["flash_attention"] = max(
                errs["flash_attention"], _dense_check(
                    torch, "flash_attention", got, want, dtype,
                    f"{dtype} S={S} Sk={Sk} D={D} bq={bq} bk={bk} "
                    f"causal={causal} window={window}"))
    records = {}
    c = card_for_device("cuda")
    M, K, N = MATMUL_TIMED
    for dtype in (torch.float32, torch.bfloat16):
        x = _randn(torch, rng, (M, K), 0.5, dtype)
        y = _randn(torch, rng, (K, N), 0.5, dtype)
        got = ops.matmul(x, y)
        torch.cuda.synchronize()
        err = _dense_check(torch, "tuned_matmul", got, ref.matmul(x, y),
                           dtype, f"{dtype} M={M} K={K} N={N} default tiles")
        if dtype == torch.bfloat16:
            # why the plain version of a bf16 product sums in f64: against
            # the f32 product even the exact product rounded to bf16 misses
            # the bound on a few elements (this draw, then two more)
            for draw in ("timed", 0, 1):
                xd, yd, gd = x, y, got
                if draw != "timed":
                    drng = np.random.default_rng(draw)
                    xd = _randn(torch, drng, (M, K), 0.5, dtype)
                    yd = _randn(torch, drng, (K, N), 0.5, dtype)
                    gd = ops.matmul(xd, yd)
                exact = ref.matmul(xd, yd)
                f32_sum = torch.matmul(xd.float(), yd.float())
                log(f"[kernel] tuned_matmul {dtype} M={M} K={K} N={N} draw "
                    f"{draw}: the f32 product strays "
                    f"{float((f32_sum - exact).abs().max()):.3e} from the "
                    f"exact one; against it, outside ref.KERNEL_TOL: the "
                    f"kernel {_outside(gd, f32_sum, dtype)}, the exact "
                    f"product rounded "
                    f"{_outside(exact.to(dtype), f32_sum, dtype)} of "
                    f"{gd.numel()}; against the exact product: the kernel "
                    f"{_outside(gd, exact, dtype)}, the library call "
                    f"{_outside(matmul_library(xd, yd), exact, dtype)}")
                check(_outside(gd, exact, dtype) == 0,
                      f"tuned_matmul draw {draw} misses ref.KERNEL_TOL")
                del xd, yd, gd, exact, f32_sum
        ms = time_ms(torch, lambda: ops.matmul(x, y), iters=10)
        plain_ms = time_ms(torch, lambda: ref.matmul(x, y), iters=10)
        lib_ms = time_ms(torch, lambda: matmul_library(x, y), iters=10)
        bound_ms, bound_by = work.bound_ms(
            *work.matmul(M, N, K, x.element_size()), dtype, c)
        shape = f"{str(dtype)[6:]} M={M} K={K} N={N} tiles=(128,128,128)"
        log(f"[kernel] timed tuned_matmul {shape}: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by})")
        records["tuned_matmul"] = {
            "name": "tuned_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/tuned_matmul.cu",
            "replaces": "src/repro/kernels/tuned_matmul.py:40",
            "max_abs_err": max(errs["tuned_matmul"], err), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms, "shape": shape}
    B, S, H, D = (ATTN_TIMED[k] for k in "BSHD")
    for dtype in (torch.float32, torch.bfloat16):
        for window in ATTN_TIMED["windows"]:
            q, k, v = (_randn(torch, rng, (B, S, H, D), 1.0, dtype)
                       for _ in range(3))
            call = lambda: ops.attention(q, k, v, window=window)  # noqa
            got = call()
            torch.cuda.synchronize()
            want = ref.flash_attention(q, k, v, window=window)
            err = _dense_check(torch, "flash_attention", got, want, dtype,
                               f"{dtype} B={B} S={S} H={H} D={D} causal "
                               f"window={window} default tiles")
            del want
            # no copy: the call allocates its output and nothing more
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = call()
            torch.cuda.synchronize()
            extra = torch.cuda.max_memory_allocated() - base
            check(extra <= out.numel() * out.element_size() + 1024,
                  f"ops.attention allocated {extra} bytes beyond its inputs "
                  f"(output {out.numel() * out.element_size()})")
            del out
            dense = dense_attention_inputs(q, k, v, True, window)
            folded = [t.transpose(1, 2).reshape(B * H, S, D).contiguous()
                      for t in (q, k, v)]
            ms = time_ms(torch, call, iters=10)
            bhsd_ms = time_ms(torch, lambda: fa.flash_attention(
                *folded, window=window), iters=10)
            plain_ms = time_ms(torch, lambda: ref.flash_attention(
                q, k, v, window=window), iters=5)
            lib_ms = time_ms(torch, lambda: attention_library(*dense),
                             iters=10)
            bound_ms, bound_by = work.bound_ms(*work.attention(
                B * H, S, S, D, q.element_size(), True, window), dtype, c)
            shape = (f"{str(dtype)[6:]} B={B} S={S} H={H} D={D} causal "
                     f"window={window} tiles=(128,128)")
            log(f"[kernel] timed flash_attention {shape}: kernel {ms:.4f} "
                f"ms (ops.attention on the model layout; {bhsd_ms:.4f} ms "
                f"on pre-made (BH, S, D) inputs), plain {plain_ms:.4f} ms, "
                f"library {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}); no copy: {extra} bytes allocated")
            check(abs(ms - bhsd_ms) <= 0.1 * bhsd_ms,
                  f"ops.attention {ms:.4f} ms vs the kernel on pre-made "
                  f"(BH, S, D) inputs {bhsd_ms:.4f} ms: more than 10% apart")
            if window == 0:
                records["flash_attention"] = {
                    "name": "flash_attention", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/"
                              "flash_attention.cu",
                    "replaces": "src/repro/kernels/flash_attention.py:76",
                    "max_abs_err": max(errs["flash_attention"], err),
                    "ms": ms, "bhsd_ms": bhsd_ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": lib_ms, "shape": shape}
            del q, k, v, dense, folded
    return records


def ops_path_phase(torch) -> dict:
    """The path of tuned_matmul and flash_attention: the ``kernels.ops``
    entry point (no model of either package calls them), driven once at
    the timed shapes in both dtypes with every count set to 0 just before.
    Returns the counts read just after."""
    from repro_torch.kernels import LAUNCHES, ops, reset_launches
    rng = np.random.default_rng(22)
    M, K, N = MATMUL_TIMED
    B, S, H, D = (ATTN_TIMED[k] for k in "BSHD")
    inputs = []
    for dtype in (torch.float32, torch.bfloat16):
        inputs.append((_randn(torch, rng, (M, K), 0.5, dtype),
                       _randn(torch, rng, (K, N), 0.5, dtype),
                       [_randn(torch, rng, (B, S, H, D), 1.0, dtype)
                        for _ in range(3)]))
    torch.cuda.synchronize()
    reset_launches()
    for x, y, (q, k, v) in inputs:
        ops.matmul(x, y)
        for window in ATTN_TIMED["windows"]:
            ops.attention(q, k, v, window=window)
    torch.cuda.synchronize()
    launched = {n: LAUNCHES[n] for n in ("tuned_matmul", "flash_attention")}
    log(f"[ops] kernels.ops path at the timed shapes: launches {launched}")
    for n, count in launched.items():
        check(count > 0, f"{n} was never launched on its path")
    return launched


def loop_phase(torch, model, params, dev, serve=SERVE) -> None:
    """The paper loop on the paged engine at full width (bf16): count the
    decode step per region on the meta device, serve with online
    retraining and exploration (spec depth, reservation, prefix cache and
    tp on auto), save the tree, then serve with that tree.  At full width
    the step's hottest regions are ``logits`` and the MLPs, so the tap
    region (the hottest attention region among the top 16, else the
    hottest region) is ``logits``, as in the JAX engine."""
    from repro_torch.core import counters, roofline
    from repro_torch.core.dtree import DecisionTree
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import layers as L
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.serve.scheduler import Request, RequestState
    cfg = model.cfg
    base = dict(max_len=serve["max_len"], max_slots=serve["max_slots"],
                page_size=serve["page_size"],
                prefill_chunk=serve["prefill_chunk"])
    eng = Engine(model, params, plan=_plan("paged"), device=dev,
                 serve_cfg=ServeConfig(**base))
    eng._ensure_pool()
    pages = L.tree_leaves(eng._pool.pages)
    before_pages = [float(t.float().abs().sum()) for t in pages]
    before = dict(LAUNCHES)
    t0 = time.perf_counter()
    rc = counters.collect(eng._pool_step, *eng._step_args(eng._spec_depth))
    t_count = time.perf_counter() - t0
    the_card = roofline.card_for_device(dev)
    rl = roofline.from_counters(rc.total, the_card)
    dname = str(L.tree_leaves(params)[0].dtype)[6:]
    log(f"[loop] counted the {cfg.name} {dname} paged decode step (B="
        f"{serve['max_slots']}, S={eng._spec_depth + 1}) on the meta device "
        f"in {t_count:.2f} s: flops={rc.total.flops:.4e} bytes="
        f"{rc.total.bytes:.4e} ops={rc.total.ops}")
    for r, f in rc.top_regions("flops", 5):
        log(f"[loop] top region {r}: flops={f:.4e} "
            f"bytes={rc.regions[r].bytes:.4e}")
    log(f"[loop] roofline ({the_card.name}): compute "
        f"{rl.compute_s * 1e3:.4f} ms, memory {rl.memory_s * 1e3:.4f} ms, "
        f"bound {rl.bound_s * 1e3:.4f} ms ({rl.dominant})")
    check(dict(LAUNCHES) == before, "counting launched a kernel")
    check([float(t.float().abs().sum()) for t in pages] == before_pages,
          "counting wrote a pool page")
    del eng, pages

    n = serve["n_requests"]
    prompts, gens = serve_trace(cfg, serve, seed=2)
    tree_path = ROOT / "build" / "smoke_tree.json"
    for phase in ("online", "tree"):
        if phase == "online":
            eng = Engine(model, params, plan=_plan("paged"), device=dev,
                         serve_cfg=ServeConfig(
                             **base, online_retrain=True, retrain_interval=8,
                             explore_eps=0.1))
        else:
            tree = DecisionTree.from_json(tree_path.read_text())
            eng = Engine(model, params, plan=_plan("paged"), device=dev,
                         dtree=tree, serve_cfg=ServeConfig(**base))
        reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=int(g))
                for i, (p, g) in enumerate(zip(prompts, gens))]
        reset_launches()
        res = eng.serve(reqs)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launched = LAUNCHES["paged_attention_mq"]
        s, at = res["stats"], res["autotune"]
        for n_active, decisions in res["decisions"]:
            log(f"[plan] {phase} load={n_active}: " + ", ".join(
                f"{r}->{c}" for r, c in decisions))
        log(f"[loop] {phase} serve: {s['n_done']}/{n} done, {s['tokens']} "
            f"tokens in {s['wall_s']:.3f} s -> {s['tok_per_s']:.1f} tok/s, "
            f"steps={res['steps']} tokens/step="
            f"{res['spec']['tokens_per_step']:.2f} max_depth="
            f"{res['spec']['max_depth']}, replans={len(res['decisions'])}, "
            f"paged kernel launches={launched}, fallbacks="
            f"{res['health']['fallbacks']}, leaked pages={res['page_leaks']}")
        log(f"[loop] {phase} autotune: {json.dumps(at)}")
        check(all(r.state is RequestState.DONE for r in reqs),
              f"not all requests DONE: {[r.state.value for r in reqs]}")
        check(res["page_leaks"] == 0 and eng._pool.leaked_pages() == 0,
              "leaked pages")
        check(res["health"]["fallbacks"] == 0, "safe-plan fallback ran")
        # every decided plan overlays the base plan's attn_impl='paged'
        # (no candidate of the menu changes it), so every decode step ran
        # the paged kernel once per layer
        check(all(json.loads(k)["regions"]["layer/attn"]["attn_impl"]
                  == "paged" for k in eng._pool_steps),
              "a decided plan left the paged kernel")
        if dev.type == "cuda":
            check(launched == res["steps"] * cfg.n_layers,
                  f"paged kernel launches {launched} != decode steps "
                  f"{res['steps']} x {cfg.n_layers} layers")
        if phase == "online":
            check(at["corpus_entries"] > 0 and len(eng.corpus) > 0,
                  "the corpus stayed empty")
            check(at["retrains"] >= 1, "no retrain was attempted")
            check(eng.dtree is not None, "no tree was trained")
            tree_path.parent.mkdir(parents=True, exist_ok=True)
            tree_path.write_text(eng.dtree.to_json())
            log(f"[loop] tree -> {tree_path.relative_to(ROOT)} (classes "
                f"{eng.dtree.classes_})")
        else:
            check(len(res["decisions"]) >= 1, "the tree never replanned")
        del eng


# ---------------------------------------------------------------------------
# parity and serve phases (also runnable on the CPU at a reduced config)
# ---------------------------------------------------------------------------


def _plan(impl: str):
    from repro_torch.core.policy import RegionConfig, RegionPlan
    return RegionPlan(region_configs={"layer/attn": RegionConfig(
        attn_impl=impl)})


def serve_trace(cfg, serve=SERVE, seed: int = 0) -> tuple:
    """A serve trace's prompts (lengths drawn from ``serve["prompt"]``)
    and budgets (from ``serve["gen"]``), from ``seed``."""
    rng = np.random.default_rng(seed)
    n = serve["n_requests"]
    plens = rng.integers(serve["prompt"][0], serve["prompt"][1] + 1, n)
    gens = rng.integers(serve["gen"][0], serve["gen"][1] + 1, n)
    prompts = [rng.integers(0, cfg.vocab_size, p).astype(np.int32)
               for p in plens]
    return prompts, gens


def parity_phase(torch, model, params, dev, *, ps=16, max_len=1024,
                 chunk=256, prompt_lens=(700, 33, 1000, 256, 1, 480, 129,
                                         64)) -> None:
    """One paged decode step through the kernel against the gather path,
    on pages filled by chunked prefill of ragged prompts."""
    from repro_torch.models import layers as L
    cfg = model.cfg
    B, MP = len(prompt_lens), max_len // ps
    shape = (1 + B * MP, ps, cfg.n_kv_heads, cfg.resolved_head_dim)
    dtype = L.tree_leaves(params)[0].dtype
    pages = {"layers": {f"l{i}": {
        "k_pages": torch.zeros(shape, dtype=dtype, device=dev),
        "v_pages": torch.zeros(shape, dtype=dtype, device=dev)}
        for i in range(cfg.n_layers)}}
    bt = torch.arange(1, 1 + B * MP, dtype=torch.int32,
                      device=dev).reshape(B, MP)
    rng = np.random.default_rng(5)
    gather = _plan("")
    for b, n in enumerate(prompt_lens):
        prompt = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
        for base in range(0, n, chunk):
            piece = np.zeros((1, chunk), np.int32)
            part = prompt[base:base + chunk]
            piece[0, :part.size] = part
            model.paged_prefill_chunk(params, pages,
                                      torch.as_tensor(piece, device=dev),
                                      bt[b], base, gather)
    lengths = torch.tensor(prompt_lens, dtype=torch.int32, device=dev)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, 1)),
                           dtype=torch.int32, device=dev)
    out = {}
    for impl in ("paged", ""):
        fresh = L.tree_map(torch.clone, pages)
        logits, _ = model.paged_decode(params, fresh, toks, bt, lengths,
                                       _plan(impl))
        out[impl] = logits.float()
        del fresh
    want, got = out[""], out["paged"]
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    same = bool((got.argmax(-1) == want.argmax(-1)).all())
    log(f"[parity] {cfg.name} f32 paged_decode_step B={B}: kernel vs "
        f"gather max_abs_err={err:.3e} (max|logit|={scale:.3f}, tol "
        f"{PARITY_TOL} x max|logit|) greedy tokens equal={same}")
    check(bool(torch.isfinite(got).all()), "kernel-path logits not finite")
    check(err <= PARITY_TOL * scale, f"logits disagree: {err}")
    check(same, "greedy tokens disagree between kernel and gather paths")


def serve_phase(torch, model, params, dev, serve=SERVE) -> dict:
    """The main path: the paged engine with attn_impl='paged' at
    spec_depth 0 and 2.  Returns the kernels' launch counts over both
    serves (set to 0 just before the first, read just after the second)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.serve.scheduler import Request, RequestState
    cfg = model.cfg
    n = serve["n_requests"]
    prompts, gens = serve_trace(cfg, serve)
    outs = {}
    reset_launches()
    for depth in (0, 2):
        eng = Engine(model, params, plan=_plan("paged"), device=dev,
                     serve_cfg=ServeConfig(
                         max_len=serve["max_len"],
                         max_slots=serve["max_slots"],
                         page_size=serve["page_size"],
                         prefill_chunk=serve["prefill_chunk"],
                         spec_depth=depth))
        reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=int(g))
                for i, (p, g) in enumerate(zip(prompts, gens))]
        before = LAUNCHES["paged_attention_mq"]
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        res = eng.serve(reqs)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launched = LAUNCHES["paged_attention_mq"] - before
        s = res["stats"]
        pool = eng._pool
        log(f"[serve] {cfg.name} bf16 spec_depth={depth}: "
            f"{s['n_done']}/{n} done, {s['tokens']} tokens in "
            f"{s['wall_s']:.3f} s -> {s['tok_per_s']:.1f} tok/s, latency "
            f"p50 {s['latency_p50_s']*1e3:.1f} ms p99 "
            f"{s['latency_p99_s']*1e3:.1f} ms, steps={res['steps']} "
            f"tokens/step={res['spec']['tokens_per_step']:.2f} "
            f"kernel launches={launched}, pool "
            f"{pool.hbm_bytes()/2**20:.1f} MiB (high-water "
            f"{pool.high_water_bytes()/2**20:.1f} MiB), fallbacks="
            f"{res['health']['fallbacks']}, leaked pages="
            f"{res['page_leaks']}, {graphs_line(eng)}")
        check(all(r.state is RequestState.DONE for r in reqs),
              f"not all requests DONE: {[r.state.value for r in reqs]}")
        check(all(len(r.out_tokens) == r.max_new_tokens for r in reqs),
              "a request stopped short of its budget")
        check(all(0 <= t < cfg.vocab_size for r in reqs
                  for t in r.out_tokens), "token outside the vocabulary")
        check(res["health"]["fallbacks"] == 0, "safe-plan fallback ran")
        check(res["page_leaks"] == 0, "leaked pages")
        check(pool.leaked_pages() == 0, "leaked pages after serve")
        if dev.type == "cuda":
            check(launched > 0, "the kernel was never launched")
            check(launched == res["steps"] * cfg.n_layers,
                  f"kernel launches {launched} != steps {res['steps']} x "
                  f"{cfg.n_layers} layers")
        outs[depth] = [r.out_tokens for r in reqs]
    same = sum(a == b for a, b in zip(outs[0], outs[2]))
    log(f"[serve] spec_depth 2 vs 0: {same}/{n} requests token-identical "
        f"(bf16 verify rows round differently; not required)")
    return dict(LAUNCHES)


@contextlib.contextmanager
def plain_scans():
    """Route the models' scans to the plain versions, called directly (on
    CUDA tensors the port's dispatch always launches a kernel): the
    reference side of the full-width parity check."""
    from repro_torch.kernels import ops, ref
    saved = ops.wkv, ops.ssd

    # ``segment`` matters only under grad, which the parity check is not
    def wkv(r, k, v, w, u, s0, *, mode="fused_recurrent", chunk=64,
            segment=0):
        if mode == "chunk":
            return ref.wkv_chunk(r, k, v, w, u, s0, chunk)
        return ref.wkv_linear_scan(r, k, v, w, u, s0)

    def ssd(x, b, c, dt, a, s0, *, mode="fused_recurrent", chunk=64,
            segment=0):
        if mode == "chunk":
            return ref.ssd_chunk(x, b, c, dt, a, s0, chunk)
        return ref.ssd_linear_scan(x, b, c, dt, a, s0)

    ops.wkv, ops.ssd = wkv, ssd
    try:
        yield
    finally:
        ops.wkv, ops.ssd = saved


def _scan_plan(model, mode: str):
    from repro_torch.core.policy import RegionConfig, RegionPlan
    region = "layer/tmix" if model.cfg.family == "ssm" else "layer/ssm"
    return RegionPlan(region_configs={region: RegionConfig(scan_mode=mode)})


def recurrent_parity_phase(torch, model, params, dev, *, B=2,
                           T=128) -> None:
    """One prefill of T tokens under scan_mode 'chunk' (the chunk kernel,
    C = 64) and one decode step (the fused kernel), against the same calls
    through the plain scans: logits within PARITY_TOL x max|logit| and
    equal greedy tokens."""
    cfg = model.cfg
    rng = np.random.default_rng(7)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, T + 1)),
                           dtype=torch.int32, device=dev)
    plan = _scan_plan(model, "chunk")

    def run():
        lp, cache = model.prefill(params, {"tokens": toks[:, :T]}, plan,
                                  max_len=T + 8)
        ld, _ = model.decode(params, cache, toks[:, T:], plan)
        return torch.cat([lp, ld], dim=1).float()

    got = run()
    with plain_scans():
        want = run()
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    same = bool((got.argmax(-1) == want.argmax(-1)).all())
    log(f"[parity] {cfg.name} f32 prefill T={T} (chunk kernel) + decode "
        f"(fused kernel), B={B}: kernels vs plain scans max_abs_err="
        f"{err:.3e} (max|logit|={scale:.3f}, tol {PARITY_TOL} x max|logit|) "
        f"greedy tokens equal={same}")
    check(bool(torch.isfinite(got).all()), "kernel-path logits not finite")
    check(err <= PARITY_TOL * scale, f"logits disagree: {err}")
    check(same, "greedy tokens disagree between kernel and plain scans")


def recurrent_serve_phase(torch, model, params, dev, kernels, shape_counts,
                          serve=RECURRENT_SERVE) -> dict:
    """The slot-pool path: scan_mode auto at spec_depth 0, then scan_mode
    chunk at spec_depth 2.  Returns the ``kernels``' launch counts over
    both serves (set to 0 just before the first, read after the second),
    and adds their calls by (kernel, B, T, chunk) to ``shape_counts``."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.serve.scheduler import Request, RequestState
    cfg = model.cfg
    rng = np.random.default_rng(1)
    gens = rng.integers(serve["gen"][0], serve["gen"][1] + 1,
                        serve["n_requests"])
    prompts = [rng.integers(0, cfg.vocab_size, p).astype(np.int32)
               for p in serve["prompts"]]
    outs = {}
    reset_launches()
    for mode, depth in (("auto", 0), ("chunk", 2)):
        eng = Engine(model, params, device=dev, serve_cfg=ServeConfig(
            max_len=serve["max_len"], max_slots=serve["max_slots"],
            paged="off", scan_mode=mode, spec_depth=depth))
        reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=int(g))
                for i, (p, g) in enumerate(zip(prompts, gens))]
        before = {k: LAUNCHES[k] for k in kernels}
        shapes0 = launch_shapes(kernels)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        res = eng.serve(reqs)
        for key, n in launch_shapes(kernels).items():
            shape_counts[key] = (shape_counts.get(key, 0) + n
                                 - shapes0.get(key, 0))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launched = {k: LAUNCHES[k] - before[k] for k in kernels}
        calls = (res["steps"] + res["slot_calls"]["prefill"]
                 + res["slot_calls"]["readvance"])
        s, mem = res["stats"], res["memory"]
        log(f"[serve] {cfg.name} bf16 paged=off scan_mode={mode} "
            f"spec_depth={depth}: {s['n_done']}/{len(reqs)} done, "
            f"{s['tokens']} tokens in {s['wall_s']:.3f} s -> "
            f"{s['tok_per_s']:.1f} tok/s")
        log(f"[serve] {cfg.name} scan_mode={mode} spec_depth={depth}: "
            f"latency p50 {s['latency_p50_s']*1e3:.1f} ms p99 "
            f"{s['latency_p99_s']*1e3:.1f} ms, steps={res['steps']} "
            f"prefill calls={res['slot_calls']['prefill']} re-advances="
            f"{res['slot_calls']['readvance']} tokens/step="
            f"{res['spec']['tokens_per_step']:.2f}, launches={launched} "
            f"(model calls {calls} x {cfg.n_layers} layers = "
            f"{calls * cfg.n_layers}), pool {mem['hbm_bytes']/2**20:.1f} "
            f"MiB, {graphs_line(eng)}")
        check(all(r.state is RequestState.DONE for r in reqs),
              f"not all requests DONE: {[r.state.value for r in reqs]}")
        check(all(len(r.out_tokens) == r.max_new_tokens for r in reqs),
              "a request stopped short of its budget")
        check(all(0 <= t < cfg.vocab_size for r in reqs
                  for t in r.out_tokens), "token outside the vocabulary")
        if dev.type == "cuda":
            for k in kernels:
                check(launched[k] > 0, f"{k} was never launched")
            check(sum(launched.values()) == calls * cfg.n_layers,
                  f"scan launches {launched} != model calls {calls} x "
                  f"{cfg.n_layers} layers")
        outs[(mode, depth)] = [r.out_tokens for r in reqs]
    same = sum(a == b for a, b in zip(*outs.values()))
    log(f"[serve] {cfg.name} chunk/spec 2 vs auto/spec 0: {same}/"
        f"{len(prompts)} requests token-identical (bf16; not required)")
    return {k: LAUNCHES[k] for k in kernels}


def recurrent_model_phase(torch, arch, kernels, dev, shape_counts) -> dict:
    """Full-width f32 parity, then the bf16 serves, of one recurrent
    model; returns its kernels' launch counts from the serves (and adds
    their calls by shape to ``shape_counts``)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import layers as L
    from repro_torch.models.model import build
    model = build(get_config(arch))
    t0 = time.perf_counter()
    params = model.init(0, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    log(f"[init] {arch} full width ({model.cfg.n_layers} layers, d_model "
        f"{model.cfg.d_model}, vocab {model.cfg.vocab_size}): "
        f"{sum(t.numel() for t in L.tree_leaves(params))/1e9:.3f} B params "
        f"in {time.perf_counter() - t0:.2f} s")
    recurrent_parity_phase(torch, model, params, dev)
    params = L.tree_map(lambda t: t.to(torch.bfloat16), params)
    torch.cuda.empty_cache()
    launches = recurrent_serve_phase(torch, model, params, dev, kernels,
                                     shape_counts)
    slot_graph_phase(torch, model, params, dev)
    del params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# graph phase: each captured step against its step function
# ---------------------------------------------------------------------------


def host_us_each(torch, fn, calls: int) -> float:
    """The host's wall time of one call of ``fn`` on an idle card, in
    microseconds: each call starts after a synchronisation and is timed
    to its return (what it enqueues, not what the card then takes)."""
    fn()
    total = 0.0
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / calls * 1e6


def _fill(torch, tree, seed, std, pos):
    """Every leaf of a pool from a seeded generator on the card: floats
    N(0, std^2), integer leaves (slot positions) uniform in ``pos``."""
    from repro_torch.models import layers as L
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for t in L.tree_leaves(tree):
        if t.dtype.is_floating_point:
            t.normal_(0.0, std, generator=gen)
        else:
            t.random_(pos[0], pos[1], generator=gen)


def graph_check(torch, eng, label, live, cut, eager, graphed) -> dict:
    """Run ``eager`` (the step function) and ``graphed`` (its graph's
    replay, captured at the first call) from the same state of ``live``
    (the pool's tree; ``cut`` selects what is compared of each leaf):
    tokens, finite flags and state must be equal bit for bit, twice (the
    capture's call, then a plain replay).  Then the host time a step of
    each, the replay's device time, and the MiB the engine's graph pool
    reserved."""
    from repro_torch.models import layers as L
    leaves = L.tree_leaves(live)
    start = [t.clone() for t in leaves]
    for run in range(2):
        want = eager()
        want_state = [cut(t).clone() for t in leaves]
        for t, s0 in zip(leaves, start):
            t.copy_(s0)
        got = graphed()
        torch.cuda.synchronize()
        if want is not None:
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"[graph] {label}: replay tokens/finite != step function")
        check(all(torch.equal(cut(t), w) for t, w in zip(leaves, want_state)),
              f"[graph] {label}: state after replay {run} != step function")
        for t, s0 in zip(leaves, start):
            t.copy_(s0)
    del start, want_state
    n_kernels, kernel_ms = replay_kernels(torch, graphed)
    rec = {"step": label,
           "eager_host_us": host_us_each(torch, eager, 10),
           "graph_host_us": host_us_each(torch, graphed, 100),
           "eager_ms": time_ms(torch, eager, iters=5),
           "graph_ms": time_ms(torch, graphed, iters=20),
           "graphs": len(eng._graphs),
           "pool_mib": sum(g.pool_bytes for g in eng._graphs.values())
           / 2**20,
           "launches": next(iter(eng._graphs.values())).launches,
           "kernels": n_kernels, "kernel_ms": kernel_ms}
    log(f"[graph] {label}: replay == step function (tokens, finite, state "
        f"bit for bit, twice); host {rec['eager_host_us']:.1f} us a step "
        f"eager, {rec['graph_host_us']:.1f} us replayed (copies included); "
        f"device {rec['graph_ms']:.4f} ms a replay (eager, host-bound: "
        f"{rec['eager_ms']:.4f} ms); graph pool {rec['pool_mib']:.1f} MiB; "
        f"launches a replay {rec['launches']}; {n_kernels} CUDA kernels and "
        f"copies a replay, {kernel_ms:.4f} ms of device time summed over "
        f"them (torch.profiler)")
    return rec


def replay_kernels(torch, graphed) -> tuple:
    """The CUDA kernels and copies one call of ``graphed`` runs on the
    card, and their device times summed (torch.profiler): what a replay's
    device time is made of."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.regions import REGION_PREFIX
    from repro_torch.serve.engine import SPAN_PREFIX
    graphed()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graphed()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.name.startswith((REGION_PREFIX, SPAN_PREFIX))]
    return len(evs), sum(e.time_range.elapsed_us() for e in evs) / 1e3


def graphs_line(eng) -> str:
    """What an engine captured: its graphs, the MiB their pool reserved,
    and the launches of their warm-ups (taken out of the counts)."""
    warm: dict = {}
    for g in eng._graphs.values():
        for k, n in g.warmup_launches.items():
            warm[k] = warm.get(k, 0) + n
    return (f"graphs captured={len(eng._graphs)} (pool "
            f"{sum(g.pool_bytes for g in eng._graphs.values())/2**20:.1f} "
            f"MiB, warm-up launches {warm}), device memory at peak "
            f"{peak_mib()}")


def peak_mib() -> str:
    """Device memory at peak since the last reset: allocated by tensors,
    and reserved by the allocator (the graphs' pool included)."""
    import torch
    return (f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB "
            f"allocated, {torch.cuda.max_memory_reserved() / 2**20:.1f} MiB "
            f"reserved")


def paged_graph_phase(torch, model, params, dev, serve=SERVE,
                      cases=(0, 2, "chunk")) -> list:
    """[graph] The paged decode step at S = 1 and 3 (7 slots live on
    ragged lengths up to the block table's reach, one parked) and the
    prefill chunk (256 tokens from position 256 of one slot), on random
    pages: each replay against its step function.  ``cases``: spec depths
    and "chunk" (an MoE model has S = 1 only and no prefill graph)."""
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = model.cfg
    rng = np.random.default_rng(12)
    recs = []
    for depth in cases:
        eng = Engine(model, params, plan=_plan("paged"), device=dev,
                     serve_cfg=ServeConfig(
                         max_len=serve["max_len"],
                         max_slots=serve["max_slots"],
                         page_size=serve["page_size"],
                         prefill_chunk=serve["prefill_chunk"],
                         spec_depth=0 if depth == "chunk" else depth))
        eng._ensure_pool()
        pool = eng._pool
        pages = pool.pages
        _fill(torch, pages, 13, 0.5, None)
        B, MP = pool.n_slots, pool.max_pages_per_slot
        bt = (1 + np.arange(B * MP, dtype=np.int32)).reshape(B, MP)
        if depth == "chunk":
            C, base = serve["prefill_chunk"], serve["prefill_chunk"]
            pool.block_tables[2] = bt[2]
            toks = rng.integers(0, cfg.vocab_size, C).astype(np.int32)

            def eager():
                model.paged_prefill_chunk(
                    eng.params, pages,
                    torch.as_tensor(toks[None], device=dev),
                    torch.as_tensor(bt[2], device=dev), base, eng.plan)

            def graphed():
                eng._paged_prefill(toks, 2, base)
            label = f"paged prefill chunk C={C}"
        else:
            S = depth + 1
            lengths = np.array(_ragged(S), np.int32)
            act = lengths > 0
            bt[~act] = 0
            toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)

            def eager():
                return eng._pool_step(eng.params, pages, *(
                    torch.as_tensor(a, device=dev)
                    for a in (toks, bt, lengths, act)), None)

            def graphed():
                return eng._paged_decode(toks, bt, lengths, act, None)
            label = f"paged decode S={S}"
        # page 0 is the null sink: parked rows and padding write it in no
        # fixed order, and nothing reads it unmasked
        recs.append(graph_check(torch, eng, f"{cfg.name} {label}", pages,
                                lambda t: t[1:], eager, graphed))
        del eng, pool, pages
        torch.cuda.empty_cache()
    return recs


def slot_graph_phase(torch, model, params, dev,
                     serve=RECURRENT_SERVE) -> list:
    """[graph] The slot-pool decode step with its pool update, at
    spec_depth 0 (scan_mode auto: the fused scan) and 2 (scan_mode chunk:
    the chunk scan at (8, 3, 3)), 7 slots live and one parked, on random
    state: each replay against its step function plus the update."""
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = model.cfg
    rng = np.random.default_rng(14)
    recs = []
    for mode, depth in (("auto", 0), ("chunk", 2)):
        eng = Engine(model, params, device=dev, serve_cfg=ServeConfig(
            max_len=serve["max_len"], max_slots=serve["max_slots"],
            paged="off", scan_mode=mode, spec_depth=depth))
        eng._ensure_pool()
        pool = eng._pool
        _fill(torch, pool.pool, 15, 0.1, (64, 512))
        B = pool.n_slots
        toks = rng.integers(0, cfg.vocab_size, (B, depth + 1))
        toks = toks.astype(np.int32)
        act = np.arange(B) != 5

        def eager():
            out, finite, caches = eng._pool_step(
                eng.params, pool.pool, torch.as_tensor(toks, device=dev),
                torch.as_tensor(act, device=dev), None)
            pool.update(caches)
            return out, finite

        def graphed():
            return eng._slot_decode(toks, act, None)
        recs.append(graph_check(
            torch, eng, f"{cfg.name} slot decode scan_mode={mode} "
            f"spec_depth={depth}", pool.pool, lambda t: t, eager, graphed))
        del eng, pool
        torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# train phase: the training path at full width
# ---------------------------------------------------------------------------


def _event_ms(torch, fn):
    """(fn's result, its span on the card in ms by CUDA events, the host's
    wall ms); synchronises after."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b), (time.perf_counter() - t0) * 1e3


def _free(torch) -> None:
    """Free what nothing references any more, cycles included, so that a
    peak read after this counts only what runs next."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _gib(n: float) -> str:
    return f"{n / 2**30:.2f} GiB"


def train_phase(torch) -> None:
    """[train] stablelm-1.6b at full width through
    ``repro_torch.train.trainer``: phase 5 of the module docstring."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core import counters, roofline
    from repro_torch.core.policy import default_plan, null_plan
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.models import layers as L
    from repro_torch.models.model import build, model_flops
    from repro_torch.optim import adamw
    from repro_torch.train import trainer
    dev = torch.device("cuda")
    _free(torch)
    log(f"[train] allocated before the phase (earlier phases freed): "
        f"{_gib(torch.cuda.memory_allocated())}")
    model = build(get_config(ARCH))
    cfg = model.cfg
    B, S, steps = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    data = DataConfig(cfg.vocab_size, seq_len=S, global_batch=B, seed=0)
    flops = model_flops(cfg, ShapeConfig("train", S, B, "train"))
    peak = roofline.peak_ops(torch.bfloat16, roofline.card_for(
        torch.cuda.get_device_name(0)))
    opt_cfg = adamw.AdamWConfig(lr=TRAIN["lr"])
    plans = {"null": null_plan(), "remat": default_plan(kind="train")}
    params = model.init(0, dtype=torch.bfloat16, device=dev)
    n_params = sum(t.numel() for t in L.tree_leaves(params))
    log(f"[train] {ARCH} full width: {n_params} params (bf16), B {B} S "
        f"{S}, model_flops 6·N·D = {flops/1e12:.2f} TFLOP a step, "
        f"{peak/1e12:.0f} TFLOP/s bf16 dense peak")

    # step 0's loss and grads, without and with remat, on the same params
    batch0 = batch_at(data, 0, dev)
    grads = {}
    for name, plan in plans.items():
        (loss, _), grads[name] = trainer.make_grad_fn(model, plan)(params,
                                                                   batch0)
        grads[name + "_loss"] = loss.item()
    worst = 0.0
    for gn, gr in zip(L.tree_leaves(grads["null"]),
                      L.tree_leaves(grads["remat"])):
        scale = gn.float().abs().max().item()
        worst = max(worst, (gr.float() - gn.float()).abs().max().item()
                    / max(scale, 1e-30))
    equal = all(torch.equal(a, b) for a, b in zip(
        L.tree_leaves(grads["null"]), L.tree_leaves(grads["remat"])))
    log(f"[train] step 0, null plan vs every layer remat: loss "
        f"{grads['null_loss']!r} vs {grads['remat_loss']!r}; grads "
        f"{'equal bit for bit' if equal else 'differ'}, largest difference "
        f"{worst:.3e} of its leaf's largest magnitude (tolerance 2^-8: one "
        f"bf16 rounding; the embedding's backward may sum in any order)")
    check(grads["null_loss"] == grads["remat_loss"],
          "remat changed step 0's loss")
    check(worst <= 2.0 ** -8, f"remat grads differ by {worst:.3e}")
    loss0 = grads["null_loss"]
    del grads

    # 12 steps under the null plan on the pipeline's batches 0-11
    params, opt, run = _train_run(torch, model, plans["null"], opt_cfg,
                                  data, range(steps), "null plan", params)
    med = float(np.median(run["ms"][1:]))
    log(f"[train] null plan: median step {med:.3f} ms over steps 2-{steps} "
        f"-> {B * S / med * 1e3:.1f} tok/s, {flops / (med * 1e-3) / 1e12:.1f}"
        f" TFLOP/s = {flops / (med * 1e-3) / peak * 100:.1f}% of the bf16 "
        f"dense peak by model_flops; peak allocated {_gib(run['peak'])} "
        f"({run['peak']} bytes); losses: first three "
        f"{np.mean(run['loss'][:3]):.4f}, last three "
        f"{np.mean(run['loss'][-3:]):.4f} (fresh batches: not gated)")
    check(run["loss"][0] == loss0, "step 0's loss differs from the grad fn's")

    # where a step's time goes: the device's kernels in one step, then
    # forward + backward and the optimizer apart, in turns
    step_fn = trainer.make_train_step(model, plans["null"], opt_cfg=opt_cfg,
                                      schedule_total=steps)
    _profile_step(torch, lambda: step_fn(params, opt, batch0))
    grad_fn = trainer.make_grad_fn(model, plans["null"])
    fb, up = [], []
    for _ in range(3):
        out, dms, _ = _event_ms(torch, lambda: grad_fn(params, batch0))
        g = out[1]
        del out
        fb.append(dms)
        up.append(_event_ms(torch, lambda: adamw.apply_updates(
            opt_cfg, params, g, opt, 1.0))[1])
        del g
    log(f"[train] null plan split: forward+backward {np.median(fb):.3f} "
        f"ms, optimizer (AdamW, {n_params} params) {np.median(up):.3f} ms "
        f"(CUDA events, median of 3 in turns)")
    del params, opt, step_fn, grad_fn

    # the same init, 12 steps on batches 0-3 three times: the loss falls
    params, opt, seen = _train_run(torch, model, plans["null"], opt_cfg,
                                   data, [s % 4 for s in range(steps)],
                                   "null plan, batches 0-3 x 3")
    log(f"[train] batches 0-3 x 3: losses first three "
        f"{np.mean(seen['loss'][:3]):.4f}, last three "
        f"{np.mean(seen['loss'][-3:]):.4f}")
    check(np.mean(seen["loss"][-3:]) < np.mean(seen["loss"][:3]),
          f"loss did not fall: {seen['loss']}")
    del params, opt

    # the same init and data, 2 steps, every layer remat
    params, opt, rem = _train_run(torch, model, plans["remat"], opt_cfg,
                                  data, range(2), "remat (every layer)")
    log(f"[train] remat (every layer): step 0 loss {rem['loss'][0]!r} (null "
        f"plan {run['loss'][0]!r}), step 1 loss {rem['loss'][1]:.4f} "
        f"({run['loss'][1]:.4f}); step {rem['ms'][0]:.3f} / "
        f"{rem['ms'][1]:.3f} ms (null plan {run['ms'][0]:.3f} / "
        f"{run['ms'][1]:.3f}); peak allocated {_gib(rem['peak'])} against "
        f"{_gib(run['peak'])} under the null plan")
    check(rem["loss"][0] == run["loss"][0], "remat changed step 0's loss")
    check(rem["peak"] < run["peak"], "remat did not lower the peak")
    del params, opt

    # one step counted per region on the meta device
    mparams = L.tree_map(lambda sp: torch.empty(
        sp.shape, dtype=torch.bfloat16, device="meta"), model.spec())
    mopt = adamw.init_state(mparams)
    mbatch = counters.to_meta(batch0)
    t0 = time.perf_counter()
    fwd = counters.collect(lambda p, b: model.forward(p, b, plans["null"]),
                           mparams, mbatch)
    rc = counters.collect(trainer.make_train_step(model, plans["null"]),
                          mparams, mopt, mbatch)
    ratios = [_layer_flops(rc, li) / _layer_flops(fwd, li)
              for li in range(cfg.n_layers)]
    log(f"[train] counted on the meta device in "
        f"{time.perf_counter() - t0:.2f} s: a step {rc.total.flops/1e12:.3f}"
        f" TFLOP = {rc.total.flops / flops:.4f} x model_flops, "
        f"{rc.total.bytes/1e9:.1f} GB; forward {fwd.total.flops/1e12:.3f} "
        f"TFLOP; each layer's step / forward flops "
        f"{min(ratios):.4f}-{max(ratios):.4f}; optimizer "
        f"{rc.regions['optimizer'].bytes/1e9:.1f} GB")
    check(all(2.5 <= r <= 3.5 for r in ratios),
          f"a layer's step / forward flops outside 2.5-3.5: {ratios}")
    del mparams, mopt

    launcher_resume_phase()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--train-resume"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"))
    for line in proc.stdout.splitlines():
        log(line)
    check(proc.returncode == 0,
          f"resume check failed: {proc.stderr[-2000:]}")


def _train_run(torch, model, plan, opt_cfg, data, batches, label,
               params=None, schedule_total=TRAIN["steps"], tag="train",
               extra=None, vectors_may_stay=False, after_step=None,
               check_changed=True):
    """Train ``model`` from ``Model.init(seed=0)`` (or ``params``) on the
    pipeline's ``batches`` (one step each, each batch with the tensors of
    ``extra`` added: a stubbed frontend's input) with fresh AdamW state; log
    each step's loss, grad norm, lr and device ms (and an MoE model's
    ce and aux) on ``[tag]`` lines; ``after_step(i, params, state)`` is
    called after step i.  Returns (params, state, {"loss", "gnorm", "ce",
    "aux", "ms", "peak"}), the peak allocated over the steps.  Gates:
    finite losses and grad norms; with ``check_changed``, every weight
    matrix and embedding changed (a norm's scale of 1.0 in bf16 keeps an
    update under half its ulp, 2^-9, rounded away, as the JAX package's
    bf16 cast does; with ``vectors_may_stay`` so may any leaf that is a
    vector per layer, as the recurrent families' ones-initialised
    ``ln_scale`` and ``d_skip``)."""
    from repro_torch.data.pipeline import batch_at
    from repro_torch.models import layers as L
    from repro_torch.optim import adamw
    from repro_torch.train import trainer
    dev = torch.device("cuda")
    if params is None:
        params = model.init(0, dtype=torch.bfloat16, device=dev)
    before = {k: t.to("cpu", copy=True)
              for k, t in _named_leaves(params).items()} if check_changed \
        else None
    opt = adamw.init_state(params)
    step_fn = trainer.make_train_step(model, plan, opt_cfg=opt_cfg,
                                      schedule_total=schedule_total)
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    run = {"loss": [], "gnorm": [], "ce": [], "aux": [], "ms": []}
    for i, s in enumerate(batches):
        batch = dict(batch_at(data, s, dev), **(extra or {}))
        (params, opt, m), dms, wall = _event_ms(
            torch, lambda: step_fn(params, opt, batch))
        run["loss"].append(m["loss"].item())
        run["gnorm"].append(m["grad_norm"].item())
        run["ce"].append(m["ce"].item())
        run["aux"].append(m["aux"].item())
        run["ms"].append(dms)
        moe = (f" (ce {run['ce'][-1]:.4f} aux {run['aux'][-1]:.4f})"
               if model.cfg.n_experts else "")
        log(f"[{tag}] {label} step {i:2d} (batch {s}): loss "
            f"{run['loss'][-1]:.4f}{moe} grad_norm {run['gnorm'][-1]:.4f} "
            f"lr {m['lr'].item():.3e} device {dms:.3f} ms (host wall "
            f"{wall:.3f} ms)")
        if after_step is not None:
            after_step(i, params, opt)
    run["peak"] = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(run["loss"])) and all(np.isfinite(run["gnorm"])),
          f"{label}: non-finite loss or grad norm: {run}")
    if before is None:
        return params, opt, run
    same = [k for k, t in _named_leaves(params).items()
            if torch.equal(before[k], t.cpu())]
    log(f"[{tag}] {label}: {len(before) - len(same)}/{len(before)} "
        f"leaves changed; unchanged: {same or 'none'}")
    vector = (lambda k: _named_leaves(params)[k].dim()
              - k.startswith("blocks/") < 2)
    check(not [k for k in same if "norm" not in k
               and not (vectors_may_stay and vector(k))],
          f"{label}: a weight matrix or embedding did not change: {same}")
    return params, opt, run


def _profile_step(torch, fn, top: int = 10, tag: str = "train-profile",
                  what: str = "one step") -> None:
    """Run ``fn`` once under ``torch.profiler`` and log the card's busy
    share of its wall time, the device time in cuBLAS's products and in
    everything else, and the ``top`` kernels by device time, on
    ``[tag]`` lines."""
    import collections
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.regions import REGION_PREFIX
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.name.startswith(REGION_PREFIX)]
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if b > end:
            busy += b - max(a, end)
            end = b
    busy /= 1e3
    by_name: dict = collections.defaultdict(lambda: [0.0, 0])
    for e in dev:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_name[e.name][1] += 1
    gemm = sum(ms for name, (ms, _) in by_name.items()
               if any(k in name.lower()
                      for k in ("gemm", "nvjet", "cutlass", "xmma")))
    total = sum(ms for ms, _ in by_name.values())
    log(f"[{tag}] {what}: wall {wall:.3f} ms (profiled), device "
        f"busy {busy:.3f} ms = {100 * busy / wall:.1f}%, {len(dev)} kernels "
        f"and copies; cuBLAS products {gemm:.3f} ms, the rest "
        f"{total - gemm:.3f} ms")
    for name, (ms, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:top]:
        log(f"[{tag}] device {ms:9.3f} ms {n:6d}x  {name[:90]}")


def _named_leaves(tree, prefix="") -> dict:
    """{"a/b/c": leaf} of a nested dict of tensors."""
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    out = {}
    for k in sorted(tree):
        out.update(_named_leaves(tree[k], f"{prefix}{k}/"))
    return out


def _layer_flops(rc, li) -> float:
    """Flops of ``layer<li>`` with the regions nested in it."""
    r = f"layer{li}"
    return sum(c.flops for k, c in rc.regions.items()
               if k == r or k.startswith(r + "/"))


def launcher_resume_phase() -> None:
    """``python -m repro_torch.launch.train`` at the reduced config on
    the card: killed at step 6 (exit 42) after a checkpoint at 4, then
    resumed from it to step 12."""
    import shutil
    import tempfile
    (ROOT / "build").mkdir(exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="smoke_train_", dir=ROOT / "build")
    base = [sys.executable, "-m", "repro_torch.launch.train", "--steps",
            "12", "--batch", "2", "--seq", "32", "--ckpt-dir", ckpt,
            "--ckpt-every", "4", "--log-every", "4"]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    try:
        runs = []
        for extra, want in ((["--fail-at-step", "6"], 42), (["--resume"], 0)):
            t0 = time.perf_counter()
            proc = subprocess.run(base + extra, cwd=ROOT, env=env,
                                  capture_output=True, text=True, timeout=600)
            runs.append(proc)
            log(f"[train] launcher {' '.join(extra)}: exit "
                f"{proc.returncode} in {time.perf_counter() - t0:.1f} s: "
                + " | ".join(proc.stdout.strip().splitlines()))
            check(proc.returncode == want,
                  f"launcher {extra}: exit {proc.returncode}, want {want}: "
                  f"{proc.stderr[-2000:]}")
        check("resumed from step 4" in runs[1].stdout
              and "done:" in runs[1].stdout, "the launcher did not resume")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def train_resume_check(torch) -> None:
    """``chip_smoke.py --train-resume`` (run by the train phase in a
    process of its own, with ``CUBLAS_WORKSPACE_CONFIG`` set before the
    first cuBLAS call): under ``torch.use_deterministic_algorithms(True)``,
    8 uninterrupted steps of reduced stablelm-1.6b (bf16, the launcher's
    default) against 4 steps, a checkpoint, a restore into a fresh init
    and 4 more: the params and moments must be equal bit for bit."""
    import shutil
    import tempfile
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.models import layers as L
    from repro_torch.models.model import build
    from repro_torch.optim import adamw
    from repro_torch.train import checkpoint as ck
    from repro_torch.train import trainer
    torch.use_deterministic_algorithms(True)
    dev = torch.device("cuda")
    model = build(get_config(ARCH).reduced())
    data = DataConfig(model.cfg.vocab_size, 32, 4, seed=0)
    step = trainer.make_train_step(model, opt_cfg=adamw.AdamWConfig(lr=3e-3),
                                   schedule_total=60)

    def fresh(seed=0):
        p = model.init(seed, dtype=torch.bfloat16, device=dev)
        return p, adamw.init_state(p)

    p1, o1 = fresh()
    for s in range(8):
        p1, o1, m1 = step(p1, o1, batch_at(data, s, dev))
    p2, o2 = fresh()
    for s in range(4):
        p2, o2, _ = step(p2, o2, batch_at(data, s, dev))
    (ROOT / "build").mkdir(exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="smoke_resume_", dir=ROOT / "build")
    try:
        ck.save(ckpt, 4, {"params": p2, "opt": o2})
        p3, o3 = fresh(1)
        state, start = ck.restore(ckpt, {"params": p3, "opt": o3})
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    p2, o2 = state["params"], state["opt"]
    for s in range(start, 8):
        p2, o2, m2 = step(p2, o2, batch_at(data, s, dev))
    same = [torch.equal(a, b) for a, b in zip(
        L.tree_leaves({"p": p1, "mu": o1["mu"], "nu": o1["nu"]}),
        L.tree_leaves({"p": p2, "mu": o2["mu"], "nu": o2["nu"]}))]
    log(f"[train] resume in process ({ARCH} reduced, bf16, deterministic "
        f"algorithms): 8 steps vs 4 + save + restore + 4: {sum(same)}/"
        f"{len(same)} leaves equal bit for bit, final loss "
        f"{m1['loss'].item():.6f} vs {m2['loss'].item():.6f}")
    check(all(same) and o2["step"].item() == o1["step"].item() == 8,
          "resumed run differs from the uninterrupted one")


# ---------------------------------------------------------------------------
# moe phase: the MoE family at full width
# ---------------------------------------------------------------------------


def _moe_plan(impl: str = ""):
    """The paged kernel on every attention region, and the MoE dispatch
    ``impl`` ('' = the default, einsum) under the bare region name the
    model looks it up by."""
    from repro_torch.core.policy import RegionConfig
    plan = _plan("paged")
    if impl:
        plan.region_configs["moe"] = RegionConfig(moe_impl=impl)
    return plan


def moe_phase(torch) -> int:
    """[moe] qwen2-moe-a2.7b at full width and depth in bf16 (phase 6 of
    the module docstring), then [train-moe].  Returns the paged kernel's
    launches over the MoE serves (counted from 0 just before them)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import layers as L
    from repro_torch.models.model import active_param_count, build
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    _free(torch)
    log(f"[moe] allocated before the phase (earlier phases freed): "
        f"{_gib(torch.cuda.memory_allocated())}")
    model = build(get_config(MOE_ARCH))
    cfg = model.cfg
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in L.tree_leaves(params))
    largest = max(t.numel() for t in L.tree_leaves(params))
    log(f"[moe] init {MOE_ARCH} full width and depth ({cfg.n_layers} "
        f"layers, d_model {cfg.d_model}, {cfg.n_experts} experts padded to "
        f"{cfg.pad_experts_to}, top {cfg.top_k}, {cfg.n_shared_experts} "
        f"shared): {n_params} params ({active_param_count(cfg)} active) in "
        f"bf16 in {time.perf_counter() - t0:.2f} s; peak allocated "
        f"{_gib(torch.cuda.max_memory_allocated())} against "
        f"{_gib(2 * n_params)} of params (largest leaf {largest} "
        f"elements)")
    check(torch.cuda.max_memory_allocated() <= 2 * n_params + 2 * largest,
          "init's transient exceeded one leaf")

    # f32 checks on a full-width copy of the first two layers
    cut, p2 = _two_layers(torch, cfg, params)
    m2 = build(cut)
    parity_phase(torch, m2, p2, dev)
    moe_impl_check(torch, cut, p2, dev)
    moe_route_check(torch, cut, p2, dev)
    del m2, p2
    _free(torch)

    launches = moe_serve_phase(torch, model, params, dev)
    paged_graph_phase(torch, model, params, dev, cases=(0,))
    moe_count_check(torch, model, params, dev)
    del model, params
    _free(torch)
    train_moe_phase(torch)
    log(f"[moe] phase done in {time.perf_counter() - t_phase:.1f} s")
    return launches


def moe_impl_check(torch, cut, params, dev) -> None:
    """Einsum against scatter dispatch on one forward of two 256-token
    rows at capacity factor 8.0 (no token dropped), within the JAX
    package's own tolerance (tests/test_impl_equivalence.py)."""
    import dataclasses
    from repro_torch.models.model import build
    model = build(dataclasses.replace(cut, capacity_factor=8.0))
    rng = np.random.default_rng(21)
    toks = torch.as_tensor(rng.integers(0, cut.vocab_size, (2, 256)),
                           dtype=torch.int32, device=dev)
    with torch.no_grad():
        le, ae = model.forward(params, {"tokens": toks}, _moe_plan())
        ls, as_ = model.forward(params, {"tokens": toks},
                                _moe_plan("scatter"))
    err = float((le - ls).abs().max())
    bad = int(((le - ls).abs() > MOE_IMPL_TOL
               + MOE_IMPL_TOL * ls.abs()).sum())
    log(f"[moe] {cut.name} 2 layers f32, capacity factor 8.0, B 2 S 256: "
        f"einsum vs scatter logits max_abs_err={err:.3e} (max|logit|="
        f"{float(ls.abs().max()):.3f}; tol {MOE_IMPL_TOL} + {MOE_IMPL_TOL} "
        f"x |scatter|: {bad} outside), aux {float(ae):.6f} vs "
        f"{float(as_):.6f}")
    check(bool(torch.isfinite(le).all()), "einsum logits not finite")
    check(bad == 0, f"einsum and scatter disagree: {err}")


def moe_route_check(torch, cut, params, dev) -> None:
    """The card's routes (expert indices) against the CPU's on the same
    f32 inputs and router: a route may differ only where the CPU's
    probabilities at the first differing rank and the next are within
    MOE_TIE (a near-tie that rounding may flip)."""
    from repro_torch.models import moe
    rng = np.random.default_rng(22)
    x = rng.standard_normal((4, 512, cut.d_model)).astype(np.float32)
    router = params["blocks"]["mlp"]["router"][0]
    _, idx_card, _ = moe.route(cut, {"router": router},
                               torch.as_tensor(x, device=dev))
    router_cpu = router.cpu()
    _, idx_cpu, _ = moe.route(cut, {"router": router_cpu},
                              torch.from_numpy(x))
    logits = (torch.from_numpy(x) @ router_cpu).float()
    logits[..., cut.n_experts:] = -1e30
    probs = torch.sort(torch.softmax(logits, -1), -1, descending=True)[0]
    differ = idx_card.cpu() != idx_cpu
    rows = differ.any(-1)
    first = differ.int().argmax(-1, keepdim=True)
    gaps = (probs.gather(-1, first) - probs.gather(-1, first + 1))[..., 0]
    gaps = gaps[rows]
    worst = float(gaps.max()) if gaps.numel() else 0.0
    log(f"[moe] routes, card vs CPU (f32, layer 0's router, "
        f"{rows.numel()} tokens x top {cut.top_k}): {int(rows.sum())} "
        f"tokens differ; CPU gap at the first differing rank, largest "
        f"{worst:.3e} (a differing route must be a near-tie: below "
        f"{MOE_TIE})")
    check(worst < MOE_TIE, f"a route differs at a CPU gap of {worst}")


def moe_serve_phase(torch, model, params, dev, serve=SERVE) -> int:
    """The paged engine in bf16 on the serve trace, with the einsum
    (default) and the scatter dispatch, spec_depth 2 and prefill_chunk
    256 asked for.  MoE pins speculation and prefix sharing off and keeps
    each prompt in one chunk.  Returns the paged kernel's launches over
    both serves."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.serve.scheduler import Request, RequestState
    cfg = model.cfg
    n = serve["n_requests"]
    prompts, gens = serve_trace(cfg, serve)
    widths: list = []
    real = model.paged_prefill_chunk

    def counted(*a, **k):
        widths.append(int(a[2].shape[1]))
        return real(*a, **k)

    outs, total = {}, 0
    model.paged_prefill_chunk = counted
    try:
        for impl in ("einsum", "scatter"):
            eng = Engine(model, params, device=dev,
                         plan=_moe_plan("" if impl == "einsum" else impl),
                         serve_cfg=ServeConfig(
                             max_len=serve["max_len"],
                             max_slots=serve["max_slots"],
                             page_size=serve["page_size"],
                             prefill_chunk=serve["prefill_chunk"],
                             spec_depth=2))
            reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=int(g))
                    for i, (p, g) in enumerate(zip(prompts, gens))]
            widths.clear()
            _free(torch)
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            res = eng.serve(reqs)
            torch.cuda.synchronize()
            launched = LAUNCHES["paged_attention_mq"]
            total += launched
            s, pool = res["stats"], eng._pool
            log(f"[moe] serve {cfg.name} bf16 {impl}: {s['n_done']}/{n} "
                f"done, {s['tokens']} tokens in {s['wall_s']:.3f} s -> "
                f"{s['tok_per_s']:.1f} tok/s, latency p50 "
                f"{s['latency_p50_s']*1e3:.1f} ms p99 "
                f"{s['latency_p99_s']*1e3:.1f} ms, steps={res['steps']} "
                f"spec_depth resolved={eng.spec_depth_for(eng.plan)} "
                f"max_depth={res['spec']['max_depth']} prefix sharing="
                f"{eng.prefix_cache_for(eng.plan)}, prefill chunks="
                f"{len(widths)} for {n} prompts, paged kernel launches="
                f"{launched}, pool {pool.hbm_bytes()/2**20:.1f} MiB, "
                f"fallbacks={res['health']['fallbacks']}, leaked pages="
                f"{res['page_leaks']}, {graphs_line(eng)}")
            check(all(r.state is RequestState.DONE for r in reqs),
                  f"not all requests DONE: {[r.state.value for r in reqs]}")
            check(all(len(r.out_tokens) == r.max_new_tokens for r in reqs),
                  "a request stopped short of its budget")
            check(all(0 <= t < cfg.vocab_size for r in reqs
                      for t in r.out_tokens), "token outside the vocabulary")
            check(eng.spec_depth_for(eng.plan) == 0
                  and res["spec"]["max_depth"] == 0
                  and res["spec"]["accepted_drafts"] == 0,
                  "an MoE serve ran a speculative step")
            check(eng.prefix_cache_for(eng.plan) is False,
                  "prefix sharing on for MoE")
            check(sorted(widths) == sorted(p.size - 1 for p in prompts),
                  f"an MoE prompt was not prefilled in one chunk: {widths}")
            check(res["health"]["fallbacks"] == 0, "safe-plan fallback ran")
            check(res["page_leaks"] == 0 and pool.leaked_pages() == 0,
                  "leaked pages")
            check(launched == res["steps"] * cfg.n_layers,
                  f"paged kernel launches {launched} != decode steps "
                  f"{res['steps']} x {cfg.n_layers} layers")
            check(not any(isinstance(k, tuple) for k in eng._graphs),
                  "a prefill chunk graph was captured for MoE")
            outs[impl] = [r.out_tokens for r in reqs]
            del eng, pool
    finally:
        del model.paged_prefill_chunk
    same = sum(a == b for a, b in zip(outs["einsum"], outs["scatter"]))
    log(f"[moe] einsum vs scatter serves: {same}/{n} requests "
        f"token-identical (bf16 products in other orders; not required)")
    return total


def moe_count_check(torch, model, params, dev, serve=SERVE) -> None:
    """The full-width bf16 paged decode step counted per region on the
    meta device: every ``layerN/moe`` and ``layerN/moe/shared_mlp``
    region present, each ``layerN/moe`` at least its expert products (3
    x 2·E·C·D·F) plus dispatch and combine (2 x 2·g·E·C·D); counting
    launches nothing."""
    from repro_torch.core import counters
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import moe
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = model.cfg
    eng = Engine(model, params, plan=_moe_plan(), device=dev,
                 serve_cfg=ServeConfig(max_len=serve["max_len"],
                                       max_slots=serve["max_slots"],
                                       page_size=serve["page_size"]))
    eng._ensure_pool()
    before = dict(LAUNCHES)
    t0 = time.perf_counter()
    rc = counters.collect(eng._pool_step, *eng._step_args(eng._spec_depth))
    t_count = time.perf_counter() - t0
    check(dict(LAUNCHES) == before, "counting launched a kernel")
    g = serve["max_slots"]
    E, C = moe.n_experts_padded(cfg), moe.capacity(cfg, g)
    D, F = cfg.d_model, cfg.d_ff
    experts = 3 * 2 * E * C * D * F
    least = experts + 2 * 2 * g * E * C * D
    want = ({f"layer{i}/moe" for i in range(cfg.n_layers)}
            | {f"layer{i}/moe/shared_mlp" for i in range(cfg.n_layers)})
    missing = sorted(want - set(rc.regions))
    check(not missing, f"MoE regions missing from the count: {missing}")
    flops = [rc.regions[f"layer{i}/moe"].flops for i in range(cfg.n_layers)]
    shared = rc.regions["layer0/moe/shared_mlp"].flops
    log(f"[moe] counted the {cfg.name} bf16 paged decode step (B={g}, S=1) "
        f"on the meta device in {t_count:.2f} s: flops={rc.total.flops:.4e} "
        f"bytes={rc.total.bytes:.4e}; layerN/moe {min(flops):.4e}-"
        f"{max(flops):.4e} flops = {min(flops) / experts:.4f}-"
        f"{max(flops) / experts:.4f} x the expert products 3 x 2·E·C·D·F "
        f"(E {E}, C {C}, D {D}, F {F}: {experts:.4e}), dispatch and "
        f"combine {least - experts:.4e}; layer0/moe/shared_mlp "
        f"{shared:.4e}; top regions "
        + ", ".join(f"{r} {f:.3e}" for r, f in rc.top_regions("flops", 4)))
    check(min(flops) >= least,
          f"a layerN/moe region counts {min(flops)} < {least}")
    del eng


def train_moe_phase(torch) -> None:
    """[train-moe] granite-moe-1b-a400m at full width in bf16, B 8 x S 512
    from the pipeline, 4 steps under the null plan: finite ce, aux and
    grad norms; the step's device ms and the peak."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.policy import null_plan
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.model import build
    from repro_torch.optim import adamw
    model = build(get_config(MOE_TRAIN_ARCH))
    cfg = model.cfg
    B, S, steps = MOE_TRAIN["batch"], MOE_TRAIN["seq"], MOE_TRAIN["steps"]
    data = DataConfig(cfg.vocab_size, seq_len=S, global_batch=B, seed=0)
    params, opt, run = _train_run(
        torch, model, null_plan(), adamw.AdamWConfig(lr=MOE_TRAIN["lr"]),
        data, range(steps), f"{MOE_TRAIN_ARCH} null plan",
        schedule_total=steps, tag="train-moe")
    med = float(np.median(run["ms"][1:]))
    log(f"[train-moe] {MOE_TRAIN_ARCH} full width bf16, B {B} S {S}: "
        f"median step {med:.3f} ms over steps 2-{steps} -> "
        f"{B * S / med * 1e3:.1f} tok/s; ce {run['ce']}, aux {run['aux']}; "
        f"peak allocated {_gib(run['peak'])}")
    check(all(np.isfinite(run["ce"])) and all(np.isfinite(run["aux"])),
          f"non-finite ce or aux: {run}")
    check(all(a > 0 for a in run["aux"]), "the aux loss is not positive")
    del params, opt


def _two_layers(torch, cfg, params):
    """A full-width copy of the first two layers of a transformer's params
    in f32, and its config."""
    import dataclasses
    from repro_torch.models import layers as L
    cut = dataclasses.replace(cfg, n_layers=2, name=f"{cfg.name}-2-layers")
    return cut, {"embed": L.tree_map(lambda t: t.float(), params["embed"]),
                 "blocks": L.tree_map(lambda t: t[:2].float(),
                                      params["blocks"]),
                 "final_norm": L.tree_map(lambda t: t.float(),
                                          params["final_norm"])}


def vlm_phase(torch) -> int:
    """[vlm] internvl2-26b's backbone at full width and depth in bf16
    (phase 7 of the module docstring).  Returns the paged kernel's
    launches over its two serves (counted from 0 just before them)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import layers as L
    from repro_torch.models.model import build
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    _free(torch)
    model = build(get_config(VLM_ARCH))
    cfg = model.cfg
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in L.tree_leaves(params))
    log(f"[vlm] init {VLM_ARCH} full width and depth ({cfg.n_layers} "
        f"layers, d_model {cfg.d_model}, heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads} of {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}): {n_params} params in bf16 in "
        f"{time.perf_counter() - t0:.2f} s; peak allocated "
        f"{_gib(torch.cuda.max_memory_allocated())} against "
        f"{_gib(2 * n_params)} of params")
    cut, p2 = _two_layers(torch, cfg, params)
    parity_phase(torch, build(cut), p2, dev)
    del p2
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    launches = serve_phase(torch, model, params, dev)["paged_attention_mq"]
    log(f"[vlm] paged kernel launches over both serves: {launches}; peak "
        f"{peak_mib()} (params {2 * n_params / 2**20:.1f} MiB)")
    paged_graph_phase(torch, model, params, dev, cases=(0, 2))
    del model, params
    _free(torch)
    log(f"[vlm] phase done in {time.perf_counter() - t_phase:.1f} s")
    return launches


def whisper_phase(torch) -> None:
    """[whisper] whisper-large-v3 at full width (phase 8 of the module
    docstring), then [train-whisper]."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.serve import run_static
    from repro_torch.models import layers as L
    from repro_torch.models.model import build
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.serve.scheduler import Request, RequestState
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    _free(torch)
    model = build(get_config(WHISPER_ARCH))
    cfg = model.cfg
    t0 = time.perf_counter()
    params = model.init(0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in L.tree_leaves(params))
    log(f"[whisper] init {WHISPER_ARCH} full width ({cfg.n_enc_layers} + "
        f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
        f"of {cfg.resolved_head_dim}, enc_len {cfg.enc_len}, vocab "
        f"{cfg.vocab_size}): {n_params} params in bf16 in "
        f"{time.perf_counter() - t0:.2f} s")
    whisper_consistency_check(torch, model, params, dev)

    sv = WHISPER_SERVE
    rng = np.random.default_rng(0)
    gens = rng.integers(sv["gen"][0], sv["gen"][1] + 1, sv["n_requests"])
    prompts = rng.integers(0, cfg.vocab_size,
                           (sv["n_requests"], sv["prompt"])).astype(np.int32)
    eng = Engine(model, params, device=dev, serve_cfg=ServeConfig(
        max_len=sv["max_len"], max_slots=sv["slots"]))
    zeros = torch.zeros((sv["slots"], cfg.enc_len, cfg.d_model),
                        dtype=torch.bfloat16, device=dev)
    eng.generate(prompts[:sv["slots"]], 2, {"frames": zeros})   # warm-up
    reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=int(g))
            for i, (p, g) in enumerate(zip(prompts, gens))]
    before = dict(LAUNCHES)
    torch.cuda.reset_peak_memory_stats()
    res = run_static(eng, reqs, sv["slots"])
    torch.cuda.synchronize()
    s = res["stats"]
    log(f"[whisper] serve {cfg.name} bf16 through Engine.generate "
        f"(launch.serve's static mode, {sv['slots']} rows a group, zero "
        f"frames, max_len {sv['max_len']}): {s['n_done']}/"
        f"{sv['n_requests']} done, {s['tokens']} tokens in "
        f"{s['wall_s']:.3f} s -> {s['tok_per_s']:.1f} tok/s, latency p50 "
        f"{s['latency_p50_s']*1e3:.1f} ms p99 "
        f"{s['latency_p99_s']*1e3:.1f} ms; peak {peak_mib()}")
    check(all(r.state is RequestState.DONE for r in reqs),
          f"not all requests DONE: {[r.state.value for r in reqs]}")
    check(all(len(r.out_tokens) == r.max_new_tokens for r in reqs),
          "a request stopped short of its budget")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens),
          "token outside the vocabulary")
    check(dict(LAUNCHES) == before,
          "a hand-written kernel was launched on whisper's path")

    # where a group's time goes: its prefill and its decode steps
    whisper_step_check(torch, model, params, dev, zeros, prompts)
    del eng, model, params, zeros
    _free(torch)
    train_whisper_phase(torch)
    log(f"[whisper] phase done in {time.perf_counter() - t_phase:.1f} s")


def whisper_consistency_check(torch, model, params, dev) -> None:
    """f32 on the card: ``prefill`` of 4 tokens and 4 teacher-forced
    ``decode_step``s against ``forward`` over the 8 tokens (B 2, frames
    N(0, 1)): every position's logits within PARITY_TOL x max|logit|, and
    the greedy token equal wherever the forward's top-2 gap exceeds twice
    the largest error (a closer pair is a tie that rounding may flip)."""
    from repro_torch.models import layers as L
    p32 = L.tree_map(lambda t: t.float(), params)
    cfg = model.cfg
    rng = np.random.default_rng(7)
    frames = torch.as_tensor(rng.standard_normal(
        (2, cfg.enc_len, cfg.d_model)), dtype=torch.float32, device=dev)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 8)),
                           dtype=torch.int32, device=dev)
    with torch.no_grad():
        full, _ = model.forward(p32, {"frames": frames, "tokens": toks})
        lg, cache = model.prefill(p32, {"frames": frames,
                                        "tokens": toks[:, :4]},
                                  max_len=WHISPER_SERVE["max_len"])
        steps = [lg[:, 0]]
        for i in range(4, 8):
            lg, cache = model.decode(p32, cache, toks[:, i:i + 1])
            steps.append(lg[:, 0])
    got = torch.stack(steps, 1).float()
    want = full[:, 3:].float()
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    top2 = want.topk(2, -1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * err
    same = (got.argmax(-1) == want.argmax(-1))
    log(f"[whisper] f32 prefill (4 tokens) + 4 decode steps vs forward, B 2: "
        f"max_abs_err={err:.3e} (max|logit|={scale:.3f}, tol {PARITY_TOL} x "
        f"max|logit|); greedy equal at {int(same[clear].sum())}/"
        f"{int(clear.sum())} positions whose top-2 gap exceeds 2 x err "
        f"({int(same.sum())}/{same.numel()} in all); pos "
        f"{cache['pos'].tolist()}")
    check(bool(torch.isfinite(got).all()), "whisper f32 logits not finite")
    check(err <= PARITY_TOL * scale, f"prefill/decode vs forward: {err}")
    check(bool(same[clear].all()), "greedy tokens disagree")
    check(cache["pos"].tolist() == [8, 8], "decode positions")
    del p32, cache, full


def whisper_step_check(torch, model, params, dev, frames, prompts) -> None:
    """A group's prefill (B 8: the encoder and the prompt) and its bf16
    decode steps: the prefill's device ms (CUDA events) against the
    host's wall ms; 8 decode steps under torch.profiler (the card's busy
    share, the top kernels), then 5 more by CUDA events (median); one
    step counted per region on the meta device: the cross-attention's
    share (it projects K/V from the whole encoder output every step)
    against the expected 2 x 2 x B x enc_len x d_model^2 flops a layer."""
    from repro_torch.core import counters
    cfg = model.cfg
    B = frames.shape[0]
    batch = {"frames": frames, "tokens": torch.as_tensor(prompts[:B],
                                                         device=dev)}
    with torch.no_grad():
        (lg, cache), pms, pwall = _event_ms(torch, lambda: model.prefill(
            params, batch, max_len=WHISPER_SERVE["max_len"]))
        tok = lg[:, -1].argmax(-1, keepdim=True).int()

        def steps(n):
            nonlocal cache
            for _ in range(n):
                _, cache = model.decode(params, cache, tok)
        _profile_step(torch, lambda: steps(8), tag="whisper-profile",
                      what=f"8 eager decode steps at B {B}")
        dms, wall = [], []
        for _ in range(5):
            _, d, w = _event_ms(torch, lambda: steps(1))
            dms.append(d)
            wall.append(w)
    rc = counters.collect(lambda p, c, t: model.decode(p, c, t), params,
                          cache, tok)
    cross = sum(c.flops for k, c in rc.regions.items() if "/cross_attn" in k)
    kv = 2 * 2 * B * cfg.enc_len * cfg.d_model ** 2 * cfg.n_layers
    log(f"[whisper] prefill B {B} bf16 (encoder over {cfg.enc_len} frames "
        f"and {prompts.shape[1]} tokens): device {pms:.3f} ms, host wall "
        f"{pwall:.3f} ms; decode step (eager): device {np.median(dms):.3f} "
        f"ms (CUDA events, first enqueue to last kernel), host wall "
        f"{np.median(wall):.3f} ms, median of 5; counted on the meta "
        f"device: {rc.total.flops / 1e12:.4f} TFLOP, "
        f"{rc.total.bytes / 1e9:.3f} GB, {rc.total.ops} ops; cross_attn "
        f"{cross / 1e12:.4f} TFLOP = {cross / rc.total.flops:.1%} (its K/V "
        f"projection of enc_out: {kv / 1e12:.4f} TFLOP)")
    check(cross >= kv, f"cross-attention counts {cross} < {kv}")
    del cache


def train_whisper_phase(torch) -> None:
    """[train-whisper] whisper-large-v3 at full width in bf16 on zero
    frames (the launcher's stub): B 2 x S 448 under the null plan (3
    steps) and with every enc/dec layer remat (2 steps, step 0's loss
    equal), then remat at B 4 (2 steps); the share of the bf16 peak by
    ``model_flops`` (6·N·B·S over decoder tokens, N with the encoder) and
    by the meta count of a step (its work)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core import counters, roofline
    from repro_torch.core.policy import default_plan, null_plan
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.models import layers as L
    from repro_torch.models.model import build, model_flops
    from repro_torch.optim import adamw
    from repro_torch.train import trainer
    dev = torch.device("cuda")
    model = build(get_config(WHISPER_ARCH))
    cfg = model.cfg
    tr = WHISPER_TRAIN
    S, steps = tr["seq"], tr["steps"]
    peak = roofline.peak_ops(torch.bfloat16, roofline.card_for(
        torch.cuda.get_device_name(0)))
    opt_cfg = adamw.AdamWConfig(lr=tr["lr"])
    runs = {}
    for name, plan, B, n in (("null", null_plan(), tr["batch"], steps),
                             ("remat", default_plan(kind="train"),
                              tr["batch"], 2),
                             ("remat-b4", default_plan(kind="train"),
                              tr["remat_batch"], 2)):
        data = DataConfig(cfg.vocab_size, seq_len=S, global_batch=B, seed=0)
        frames = {"frames": torch.zeros((B, cfg.enc_len, cfg.d_model),
                                        dtype=torch.bfloat16, device=dev)}
        params, opt, run = _train_run(
            torch, model, plan, opt_cfg, data, range(n),
            f"{WHISPER_ARCH} {name} B {B}", schedule_total=steps,
            tag="train-whisper", extra=frames)
        if name == "null":
            step_fn = trainer.make_train_step(model, plan, opt_cfg=opt_cfg,
                                              schedule_total=steps)
            batch = dict(batch_at(data, n, dev), **frames)
            _profile_step(torch, lambda: step_fn(params, opt, batch),
                          tag="train-whisper-profile",
                          what=f"one null-plan step at B {B}")
            del step_fn, batch
        del params, opt
        _free(torch)
        flops = model_flops(cfg, ShapeConfig("train", S, B, "train"))
        if name != "remat":
            mparams = L.tree_map(lambda sp: torch.empty(
                sp.shape, dtype=torch.bfloat16, device="meta"), model.spec())
            mbatch = counters.to_meta(dict(batch_at(data, 0, dev), **frames))
            rc = counters.collect(trainer.make_train_step(model, plan),
                                  mparams, adamw.init_state(mparams), mbatch)
            run["meta_flops"] = rc.total.flops
            del mparams
        med = float(np.median(run["ms"][1:]))
        log(f"[train-whisper] {name} B {B} x S {S}: median step {med:.3f} "
            f"ms over steps 2-{n} -> {B * S / med * 1e3:.1f} decoder tok/s; "
            f"model_flops 6·N·B·S {flops / 1e12:.3f} TFLOP = "
            f"{flops / (med * 1e-3) / peak:.1%} of the bf16 dense peak; "
            + (f"the meta count of a step {run['meta_flops'] / 1e12:.3f} "
               f"TFLOP = {run['meta_flops'] / (med * 1e-3) / peak:.1%} of "
               f"it; " if "meta_flops" in run else "")
            + f"peak allocated {_gib(run['peak'])}; losses {run['loss']}, "
            f"grad norms {run['gnorm']}")
        runs[name] = run
    check(runs["remat"]["loss"][0] == runs["null"]["loss"][0],
          f"remat changed step 0's loss: {runs['remat']['loss'][0]!r} vs "
          f"{runs['null']['loss'][0]!r}")
    check(runs["remat"]["peak"] < runs["null"]["peak"],
          "remat did not lower the peak")


# ---------------------------------------------------------------------------
# serve-subsystems phase: telemetry and failure domains at full width
# ---------------------------------------------------------------------------


def params_dtype(params) -> str:
    from repro_torch.models import layers as L
    return str(L.tree_leaves(params)[0].dtype).replace("torch.", "")


def _requests(pairs) -> list:
    from repro_torch.serve.scheduler import Request
    return [Request(rid=i, prompt=p.copy(), max_new_tokens=g)
            for i, (p, g) in enumerate(pairs)]


def _lifecycle_check(tracer, reqs) -> None:
    """Every request's spans nest; QUEUED -> PREFILL -> DECODE chain
    without a gap from its arrival and end in one DONE at the DECODE
    close; every PREFILL_CHUNK sits inside a PREFILL."""
    for r in reqs:
        spans = tracer.spans_for(r.rid)
        for i, (_, _, a0, a1, _) in enumerate(spans):
            for _, _, b0, b1, _ in spans[i + 1:]:
                check(a1 <= b0 or b1 <= a0 or (a0 <= b0 and b1 <= a1)
                      or (b0 <= a0 and a1 <= b1),
                      f"request {r.rid}: spans overlap without nesting")
        chain = sorted([s for s in spans if s[1] in ("QUEUED", "PREFILL",
                                                      "DECODE",
                                                      "PREEMPTED")],
                       key=lambda s: (s[2], s[3]))
        check([s[1] for s in chain][:1] == ["QUEUED"]
              and chain[0][2] == r.arrival_s,
              f"request {r.rid}: no QUEUED span from its arrival")
        check(all(b[2] == a[3] for a, b in zip(chain, chain[1:])),
              f"request {r.rid}: a gap in its lifecycle")
        check(chain[-1][1] == "DECODE", f"request {r.rid} never decoded")
        done = [s for s in spans if s[1] == "DONE"]
        check(len(done) == 1 and done[0][2] == chain[-1][3],
              f"request {r.rid}: not one DONE at the DECODE close")
        pf = [(s[2], s[3]) for s in spans if s[1] == "PREFILL"]
        check(all(any(p0 <= s[2] and s[3] <= p1 for p0, p1 in pf)
                  for s in spans if s[1] == "PREFILL_CHUNK"),
              f"request {r.rid}: a prefill chunk outside its PREFILL")


def _prometheus(text: str) -> dict:
    samples = {}
    for line in text.splitlines():
        if line.startswith("#"):
            check(line.startswith(("# TYPE ", "# HELP ")),
                  f"bad Prometheus comment {line!r}")
            continue
        name, val = line.rsplit(" ", 1)
        samples[name] = float(val)
    return samples


def telemetry_phase(torch, model, params, dev, out_dir,
                    serve=SERVE) -> None:
    """[telemetry] (phase 9 of the module docstring): the SERVE trace with
    attn_impl='paged' at spec_depth 0 and 2, telemetry off and on."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.serve.scheduler import RequestState
    cfg = model.cfg
    pairs = [(p, int(g)) for p, g in zip(*serve_trace(cfg, serve))]
    base = dict(max_len=serve["max_len"], max_slots=serve["max_slots"],
                page_size=serve["page_size"],
                prefill_chunk=serve["prefill_chunk"])
    engines = {}
    for depth in (0, 2):
        toks = {}
        for on in (False, True):
            outs = (dict(telemetry=True, log_level="debug",
                         trace_out=str(out_dir / f"trace_{depth}.json"),
                         metrics_out=str(out_dir / f"metrics_{depth}.prom"),
                         log_out=str(out_dir / f"events_{depth}.jsonl"))
                    if on else {})
            eng = Engine(model, params, plan=_plan("paged"), device=dev,
                         serve_cfg=ServeConfig(**base, spec_depth=depth,
                                               **outs))
            reqs = _requests(pairs)
            before = LAUNCHES["paged_attention_mq"]
            res = eng.serve(reqs)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            launched = LAUNCHES["paged_attention_mq"] - before
            s = res["stats"]
            log(f"[telemetry] {cfg.name} {params_dtype(params)} spec_depth="
                f"{depth} telemetry="
                f"{'on (debug, trace, metrics, event log)' if on else 'off'}"
                f": {s['n_done']}/{len(reqs)} done, {s['tokens']} tokens in "
                f"{s['wall_s']:.3f} s -> {s['tok_per_s']:.1f} tok/s, steps="
                f"{res['steps']}, kernel launches={launched}, fallbacks="
                f"{res['health']['fallbacks']}, leaked pages="
                f"{res['page_leaks']}, graphs captured={len(eng._graphs)}")
            check(all(r.state is RequestState.DONE for r in reqs),
                  f"not all requests DONE: {[r.state.value for r in reqs]}")
            check(res["health"]["fallbacks"] == 0, "safe-plan fallback ran")
            check(res["page_leaks"] == 0, "leaked pages")
            if dev.type == "cuda":
                check(launched == res["steps"] * cfg.n_layers,
                      f"kernel launches {launched} != steps {res['steps']} "
                      f"x {cfg.n_layers} layers")
            toks[on] = [r.out_tokens for r in reqs]
            engines[(depth, on)] = eng
            on_reqs = reqs
        same = sum(a == b for a, b in zip(toks[False], toks[True]))
        check(same == len(pairs), f"telemetry changed the tokens of "
                                  f"{len(pairs) - same} requests")
        tel = engines[(depth, True)].telemetry
        tm = tel.summary()
        _lifecycle_check(tel.tracer, on_reqs)
        with open(out_dir / f"trace_{depth}.json") as f:
            doc = json.load(f)
        n_ev = sum(e["ph"] != "M" for e in doc["traceEvents"])
        check(n_ev == len(tel.tracer.spans) and tm["spans_dropped"] == 0,
              f"the trace holds {n_ev} events for {len(tel.tracer.spans)} "
              f"spans")
        samples = _prometheus(
            (out_dir / f"metrics_{depth}.prom").read_text())
        check(samples["repro_serve_step_latency_seconds_count"]
              == res["steps"], "the metrics miss steps")
        lines = (out_dir / f"events_{depth}.jsonl").read_text().splitlines()
        events = [json.loads(line) for line in lines]
        check(len(events) == tel.events_total
              and [e["kind"] for e in events].count("serve_done") == 1,
              "the event log lost events or its serve_done line")
        ring, wall = tm["ring"], res["stats"]["wall_s"]
        check(ring["steps"] == res["steps"], "the ring missed steps")
        check(ring["dt_sum_s"] <= wall,
              f"the ring's summed dt_s {ring['dt_sum_s']} > wall {wall}")
        lat, ttft = tm["step_latency_s"], tm["ttft_s"]
        log(f"[telemetry] spec_depth={depth}: tokens equal {same}/"
            f"{len(pairs)}; {len(tel.tracer.spans)} spans in a trace of "
            f"{n_ev} events, every lifecycle gapless into one DONE; "
            f"{len(samples)} Prometheus samples; {len(events)} JSONL "
            f"events; ring {ring['steps']} steps, summed dt_s "
            f"{ring['dt_sum_s']:.4f} s of wall {wall:.4f} s; step p50 "
            f"{lat['p50'] * 1e3:.3f} ms p99 {lat['p99'] * 1e3:.3f} ms; "
            f"TTFT p50 {ttft['p50'] * 1e3:.1f} ms p99 "
            f"{ttft['p99'] * 1e3:.1f} ms")

    # throughput with telemetry on against off: the spec-0 telemetry
    # engine (warmed: its graphs captured, its pages placed) serves with
    # its Telemetry detached ("off"), attached ("on": debug level, the
    # event log streamed to its file) and replaced by one that keeps its
    # events in memory ("on-mem"), in turns
    from repro_torch.serve.telemetry import Telemetry
    eng = engines[(0, True)]
    tels = {"off": None, "on": eng.telemetry,
            "on-mem": Telemetry(level="debug")}

    def attach(t):
        eng.telemetry = eng.health.telemetry = eng.governor.telemetry = t

    runs = {k: {"tok/s": [], "us/step": [], "gc ms": []} for k in tels}
    order = list(tels)
    for i in range(TELEMETRY_PAIRS):
        for k in order[i % 3:] + order[:i % 3]:
            attach(tels[k])
            with _gc_clock() as gcs:
                res = eng.serve(_requests(pairs))
            runs[k]["tok/s"].append(round(res["stats"]["tok_per_s"], 1))
            runs[k]["us/step"].append(
                round(res["stats"]["wall_s"] / res["steps"] * 1e6, 1))
            runs[k]["gc ms"].append(round(gcs["s"] * 1e3, 2))
    for k in ("on", "on-mem"):
        ratio = float(np.median([a / b for a, b in zip(
            runs[k]["tok/s"], runs["off"]["tok/s"])]))
        added = float(np.median([a - b for a, b in zip(
            runs[k]["us/step"], runs["off"]["us/step"])]))
        log(f"[telemetry] spec_depth=0, {k} against off on one engine, "
            f"{TELEMETRY_PAIRS} rounds in turns: median tok/s ratio "
            f"{ratio:.4f} (the docs' >= 0.97 was set on a CPU; not "
            f"gated), median wall added {added:.1f} us a step")
    log(f"[telemetry] rounds: {runs}")
    for k in ("on", "on-mem"):
        attach(tels[k])
        with _telemetry_clock() as clock:
            res = eng.serve(_requests(pairs))
        by = {n: round(v / res["steps"] * 1e6, 1)
              for n, v in sorted(clock["by"].items())}
        log(f"[telemetry] {k}: host time inside telemetry's calls "
            f"{clock['s'] / res['steps'] * 1e6:.1f} us a step "
            f"({clock['calls'] / res['steps']:.1f} calls a step); us a "
            f"step by call {by}")
    attach(tels["on"])
    for (_, on), e in engines.items():
        if on:
            e.telemetry.close()


@contextlib.contextmanager
def _gc_clock():
    """Sum the seconds the garbage collector runs while the block runs."""
    import gc
    acc = {"s": 0.0, "t0": 0.0}

    def note(phase, info):
        if phase == "start":
            acc["t0"] = time.perf_counter()
        else:
            acc["s"] += time.perf_counter() - acc["t0"]

    gc.callbacks.append(note)
    try:
        yield acc
    finally:
        gc.callbacks.remove(note)


@contextlib.contextmanager
def _telemetry_clock():
    """Sum the host time spent inside ``serve/telemetry.py``'s recording
    calls (the outermost call of each nest) while the block runs."""
    from repro_torch.serve import telemetry as T
    acc = {"s": 0.0, "calls": 0, "depth": 0, "by": {}}
    saved = []

    def timed(fn, label):
        def call(*a, **k):
            if acc["depth"]:
                return fn(*a, **k)
            acc["depth"] = 1
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                dt = time.perf_counter() - t0
                acc["s"] += dt
                acc["by"][label] = acc["by"].get(label, 0.0) + dt
                acc["calls"] += 1
                acc["depth"] = 0
        return call

    for cls, names in ((T.Telemetry, ("on_step", "on_admit", "event",
                                      "count")),
                       (T.SpanTracer, ("begin", "end", "end_all", "add",
                                       "instant")),
                       (T.LatencySketch, ("add",))):
        for name in names:
            saved.append((cls, name, getattr(cls, name)))
            setattr(cls, name, timed(getattr(cls, name),
                                     f"{cls.__name__}.{name}"))
    try:
        yield acc
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)


def faults_phase(torch, model, params, dev, rates=(FAULTS_RATE,),
                 serve=SERVE) -> dict:
    """[faults] (phase 9 of the module docstring): the FAULTS serve on
    ``model`` at each chaos rate of ``rates`` (0 = fault-free); returns
    {rate: (result, requests)}."""
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.serve.scheduler import TERMINAL_STATES, RequestState
    cfg = model.cfg
    prompts, gens = serve_trace(cfg, serve)
    half = len(prompts) // 2
    pairs = [(prompts[i % half], int(g)) for i, g in enumerate(gens)]
    base = dict(max_len=serve["max_len"], max_slots=serve["max_slots"],
                page_size=serve["page_size"],
                prefill_chunk=serve["prefill_chunk"], **FAULTS)
    out = {}
    for rate in rates:
        eng = Engine(model, params, plan=_plan("paged"), device=dev,
                     serve_cfg=ServeConfig(**base, chaos_rate=rate,
                                           chaos_seed=7, telemetry=True))
        reqs = _requests(pairs)
        res = eng.serve(reqs)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        states = [r.state.value for r in reqs]
        mem, fl, hs = res["memory"], res["failures"], res["health"]
        log(f"[faults] {cfg.name} {params_dtype(params)} chaos_rate={rate}: "
            f"{res['stats']['n_done']}/{len(reqs)} done, states "
            f"{ {s: states.count(s) for s in sorted(set(states))} }, "
            f"steps={res['steps']}, injected "
            f"{res['faults'].get('injected', {})}, retries={fl['retries']}, "
            f"health={hs['state']} fallbacks={hs['fallbacks']}, "
            f"preemptions={mem['preemptions']} grown pages="
            f"{mem['grown_pages']} stall steps={mem['stall_steps']}, prefix "
            f"hits={mem['prefix']['hit_requests']} tokens saved="
            f"{mem['prefix']['tokens_saved']} copy-on-write="
            f"{mem['prefix']['cow_copies']}, leaked pages="
            f"{res['page_leaks']}, graphs captured={len(eng._graphs)}")
        check(all(r.state in TERMINAL_STATES for r in reqs),
              f"a request is not in a terminal state: {states}")
        check(res["page_leaks"] == 0, "leaked pages")
        eng._pool.allocator.check_invariants()
        check(res["telemetry"]["ring"]["steps"] == res["steps"],
              "the ring missed steps")
        if rate:
            check(res["faults"]["injected_total"] >= 1, "nothing injected")
            check(fl["retries"] >= 1, "no request retried")
            safe = [step for step, d, _ in eng._pool_steps.values()
                    if d == 0]
            if hs["fallbacks"] and dev.type == "cuda":
                check(safe and all(s in eng._graphs
                                   and eng._graphs[s].replays > 0
                                   for s in safe),
                      "the safe plan's step was not captured and replayed")
                log(f"[faults] safe-plan step: graph captured mid-serve, "
                    f"replayed {sum(eng._graphs[s].replays for s in safe)} "
                    f"times")
        else:
            check(all(r.state is RequestState.DONE for r in reqs),
                  "the fault-free serve did not finish every request")
        out[rate] = (res, reqs)
        eng.telemetry.close()
    return out


def serve_subsystems_phase(torch) -> int:
    """[telemetry] and [faults] at stablelm-1.6b's full width (phase 9 of
    the module docstring).  Returns the paged kernel's launches over the
    phase's serves (counted from 0 just before them)."""
    import tempfile
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.model import build
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    _free(torch)
    model = build(get_config(ARCH))
    params = model.init(0, dtype=torch.bfloat16, device=dev)
    (ROOT / "build").mkdir(exist_ok=True)
    reset_launches()
    with tempfile.TemporaryDirectory(prefix="smoke_telemetry_",
                                     dir=ROOT / "build") as tmp:
        telemetry_phase(torch, model, params, dev, Path(tmp))
    t1 = time.perf_counter()
    faults_phase(torch, model, params, dev)
    cut, p2 = _two_layers(torch, model.cfg, params)
    runs = faults_phase(torch, build(cut), p2, dev, (0.0, FAULTS_RATE))
    launches = LAUNCHES["paged_attention_mq"]
    (_, clean), (res, reqs) = runs[0.0], runs[FAULTS_RATE]
    survivors = [r for r in reqs if r.state.value == "done"]
    same = sum(r.out_tokens == clean[r.rid].out_tokens for r in survivors)
    log(f"[faults] f32 two layers at full width: {same}/{len(survivors)} "
        f"survivors' tokens equal to the fault-free run's")
    check(survivors and same == len(survivors),
          "chaos changed a survivor's tokens")
    log(f"[serve-subsystems] paged kernel launches over the phase: "
        f"{launches}; [telemetry] {t1 - t_phase:.1f} s, [faults] "
        f"{time.perf_counter() - t1:.1f} s")
    check(launches > 0, "the paged kernel was never launched")
    del model, params, p2
    _free(torch)
    return launches


# ---------------------------------------------------------------------------
# [tp]: tensor-parallel paged serving, two ranks on the one card
# ---------------------------------------------------------------------------


def _tp_serve(torch, model, params, dev, ranks, depth, grab=None,
              eager=False, serve=SERVE):
    """Phase 3's serve trace on the paged engine with attn_impl='paged' at
    ``depth``: over ``ranks`` at tp 2, or a plain engine at tp 1 (eagerly
    when ``eager``: as tp 2 runs).  ``grab`` keeps the first decode step's
    logits of the active slots.  Returns (engine, requests, result)."""
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.serve.scheduler import Request
    cfg = ServeConfig(max_len=serve["max_len"], max_slots=serve["max_slots"],
                      page_size=serve["page_size"],
                      prefill_chunk=serve["prefill_chunk"],
                      spec_depth=depth, tp=2 if ranks is not None else 1)
    where = {"ranks": ranks} if ranks is not None else {"device": dev}
    eng = Engine(model, params, plan=_plan("paged"), serve_cfg=cfg, **where)
    if eager:
        eng._use_graphs = lambda: False
    if grab is not None:
        guard = eng._guard

        def first_logits(logits, active):
            if not grab:
                grab.append(logits[active].float().clone())
            return guard(logits, active)
        eng._guard = first_logits
    prompts, gens = serve_trace(model.cfg, serve)
    reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=int(g))
            for i, (p, g) in enumerate(zip(prompts, gens))]
    res = eng.serve(reqs)
    torch.cuda.synchronize()
    return eng, reqs, res


# phase 12's serves (tp 2 over gloo runs ~30 tok/s): half of phase 3's
# trace with shorter generations, room for phase 13 in the smoke's budget
TP_SERVE = dict(SERVE, n_requests=8, gen=(16, 32))


# phase 12's models: (arch, the bf16 serves' spec depths); an MoE model
# serves at depth 0 only (the engine pins it)
TP_ARCHS = ((ARCH, (0, 2)), (MOE_TRAIN_ARCH, (0,)))


def tp_phase(torch, serve=TP_SERVE) -> dict:
    """[tp]: phase 12 of the module docstring.  Returns the paged
    kernel's launches in the bf16 tp-2 serves, rank by rank (counted from
    0 just before each serve), by arch."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import build
    from repro_torch.serve.tp import Ranks
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    by_arch = {}
    for arch, depths in TP_ARCHS:
        _free(torch)
        t_arch = time.perf_counter()
        cfg = get_config(arch)
        model = build(cfg)
        with Ranks(cfg, 2, dev) as ranks:   # one process group at a time
            by_arch[arch] = _tp_arch(torch, model, ranks, dev, serve, depths)
        log(f"[tp] {arch}: {time.perf_counter() - t_arch:.1f} s")
    _free(torch)
    log(f"[tp] phase {time.perf_counter() - t_phase:.1f} s; paged kernel "
        f"launches in the bf16 tp-2 serves by rank: {by_arch}")
    return by_arch


def fan_in_params(model, seed: int, dtype, dev) -> dict:
    """``model``'s params with every matrix drawn at its own fan-in (its
    input dim: after the layers of a stacked leaf and the experts of an
    expert leaf; ``std = scale / sqrt(fan_in)``, a ``small`` leaf at
    ``0.02 * scale``, ones and zeros as ``Model.init`` sets them), from
    one generator on ``dev`` seeded with ``seed`` in the spec's leaf
    order, so every rank that calls it draws the same weights.
    ``Model.init`` divides a layer-stacked leaf's scale by the layer
    count instead, which makes a full-depth model's forward chaotic."""
    import math

    import torch

    from repro_torch.models import layers as L
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(sp):
        if sp.init in ("zeros", "ones"):
            return torch.full(sp.shape, float(sp.init == "ones"),
                              dtype=dtype, device=dev)
        lead = len(sp.shape) >= 3 and sp.axes[0] == "layers"
        lead += lead < len(sp.axes) and sp.axes[lead] == "experts"
        fan_in = sp.shape[lead] if sp.shape else 1
        std = (0.02 * sp.scale if sp.init == "small"
               else sp.scale / math.sqrt(max(fan_in, 1)))
        x = torch.empty(sp.shape, dtype=dtype, device=dev)
        return x.normal_(0.0, std, generator=gen)
    return L.tree_map(draw, model.spec())


@contextlib.contextmanager
def routes_kept(calls: list):
    """Keeps in ``calls`` each ``models.moe.route`` call of this process
    made meanwhile: (its input, its router, its expert indices).  Rank 0
    of a tp-2 serve is this process; its input is the whole hidden state
    and its indices are the whole batch's (the logits are gathered
    before the top-k), so a tp-1 and a tp-2 serve of one trace compare
    call by call."""
    from repro_torch.models import moe
    route = moe.route

    def kept(cfg, p, x, plan=None, global_aux=False):
        w, idx, aux = route(cfg, p, x, plan, global_aux)
        calls.append((x.detach().clone(), p["router"], idx.clone()))
        return w, idx, aux
    moe.route = kept
    try:
        yield calls
    finally:
        moe.route = route


def route_flips(cfg, one: list, two: list) -> dict:
    """Where two serves' routes first part (``routes_kept`` of tp 1 in
    ``one``, of tp 2 in ``two``): how far apart the two inputs stand
    over the first forward's layers (the largest difference over the
    largest input, layer by layer: every layer routes once a forward, in
    order); the first call whose expert indices differ, its layer, the
    tokens whose ordered top-k differ and those whose top-k set differs,
    of all; the largest input and the largest difference there; and, from
    tp 1's router (whole) on each input, the largest change of a routing
    probability, the flipped tokens' widest near-tie (the smallest gap
    between neighbours among the top k+1 probabilities) and the median
    of that gap over all tokens.  A flip that rounding causes sits at a
    near-tie no wider than the probabilities moved."""
    import torch

    from repro_torch.models.moe import n_experts_padded
    k, e = cfg.top_k, n_experts_padded(cfg)

    def probs(x, router):
        logits = (x.reshape(-1, x.shape[-1]) @ router).float()
        if e > cfg.n_experts:
            logits[:, cfg.n_experts:] = -1e30
        return torch.softmax(logits, dim=-1)
    out = {"calls": [len(one), len(two)], "first_forward_input_rel_diff": [
        float((x1 - x2).abs().max() / x1.abs().max().clamp_min(1e-30))
        for (x1, _, _), (x2, _, _) in zip(one[:cfg.n_layers],
                                          two[:cfg.n_layers])
        if x1.shape == x2.shape], "first": None}
    for c, ((x1, router, i1), (x2, _, i2)) in enumerate(zip(one, two)):
        if i1.shape == i2.shape and torch.equal(i1, i2):
            continue
        i1, i2 = i1.reshape(-1, k), i2.reshape(-1, k)
        if i1.shape != i2.shape:
            out["first"] = {"call": c, "shapes": [list(i1.shape),
                                                  list(i2.shape)]}
            break
        flip = (i1 != i2).any(-1)
        sets = (i1.sort(-1).values != i2.sort(-1).values).any(-1)
        p1, p2 = probs(x1, router), probs(x2, router)
        top = p1.sort(-1, descending=True).values[:, :k + 1]
        gap = (top[:, :-1] - top[:, 1:]).min(-1).values
        out["first"] = {
            "call": c, "layer": c % cfg.n_layers,
            "tokens_flipped": int(flip.sum()), "sets_flipped":
            int(sets.sum()), "tokens": int(flip.numel()),
            "input_max_abs": float(x1.abs().max()),
            "input_max_abs_diff": float((x1 - x2).abs().max()),
            "prob_max_abs_diff": float((p1 - p2).abs().max()),
            "flipped_widest_gap": float(gap[flip].max()),
            "median_gap": float(gap.median())}
        break
    return out


def _tp_f32(torch, model, ranks, dev, serve, params, weights: str,
            keep_routes: bool = False) -> int:
    """Phase 12's f32 reading of ``params`` (``weights`` says which):
    tp 2 over ``ranks`` against tp 1 (a plain engine), both eager, every
    request DONE.  Logs the requests whose greedy tokens are equal and
    the first decode step's largest logit difference, and returns the
    count; with ``keep_routes``, also where the routes first part
    (:func:`route_flips`)."""
    from repro_torch.serve.scheduler import RequestState
    arch, n = model.cfg.name, serve["n_requests"]
    toks, first, kept = {}, {}, {}
    for tp in (1, 2):
        first[tp], kept[tp] = [], []
        t0 = time.perf_counter()
        with (routes_kept(kept[tp]) if keep_routes
              else contextlib.nullcontext()):
            eng, reqs, res = _tp_serve(torch, model, params, dev,
                                       ranks if tp == 2 else None, 0,
                                       grab=first[tp], eager=True,
                                       serve=serve)
        check(all(r.state is RequestState.DONE for r in reqs),
              f"{arch} f32 tp {tp}: not all requests DONE")
        toks[tp] = [list(r.out_tokens) for r in reqs]
        log(f"[tp] {arch} f32 spec_depth=0 tp {tp}: "
            f"{res['stats']['n_done']}/{n} done, {res['steps']} steps in "
            f"{time.perf_counter() - t0:.1f} s")
        del eng
    same = sum(a == b for a, b in zip(toks[1], toks[2]))
    a, b = first[1][0], first[2][0]
    check(a.shape == b.shape, "first decode steps differ in slots")
    log(f"[tp] {arch} f32 ({weights}) tp 2 vs tp 1: greedy tokens equal "
        f"for {same}/{n} requests; first decode step's logits "
        f"({a.shape[0]} active rows) max_abs_diff="
        f"{float((a - b).abs().max()):.3e} (max|logit|="
        f"{float(a.abs().max()):.3f})")
    if keep_routes:
        log(f"[tp] {arch} f32 ({weights}) routes, tp 2 vs tp 1: "
            + json.dumps(route_flips(model.cfg, kept[1], kept[2])))
    return same


def _tp_arch(torch, model, ranks, dev, serve, depths) -> list:
    """Phase 12 on one model over ``ranks``: the f32 parity serves, then
    the bf16 serves at each of ``depths``.  Returns the paged kernel's
    launches in the bf16 tp-2 serves, by rank."""
    from repro_torch.kernels import LAUNCHES, ops
    from repro_torch.models.moe import n_experts_padded
    from repro_torch.serve.scheduler import RequestState
    cfg = model.cfg
    arch, n, L_ = cfg.name, serve["n_requests"], cfg.n_layers
    experts = n_experts_padded(cfg) if cfg.n_experts else 0
    log(f"[tp] {arch} at full width and depth ({L_} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} kv heads "
        f"x {cfg.resolved_head_dim}, vocab {cfg.vocab_size}"
        + (f", {experts} experts top-{cfg.top_k}" if experts else "")
        + f") at tp 2 on {ranks.line()}: two ranks on one card")
    check(ranks.backend == "gloo", f"backend {ranks.backend}: two "
                                   f"ranks on one card take gloo")
    # f32: tp 2 against tp 1 (a plain engine), both eager.  An MoE model
    # is read at Model.init's weights on the trace's first two requests,
    # not gated: its full depth is chaotic there, and the two degrees'
    # f32 rounding flips near-tied routes (route_flips says where
    # first); its gate draws each matrix at its own fan-in
    # (fan_in_params), where it stays at rounding
    if experts:
        params = model.init(0, dtype=torch.float32, device=dev)
        _tp_f32(torch, model, ranks, dev, dict(serve, n_requests=2),
                params, "Model.init(seed=0), read, not gated",
                keep_routes=True)
        del params
        _free(torch)
        params = fan_in_params(model, 0, torch.float32, dev)
        weights = "drawn at each matrix's fan-in"
    else:
        params = model.init(0, dtype=torch.float32, device=dev)
        weights = "Model.init(seed=0)"
    same = _tp_f32(torch, model, ranks, dev, serve, params, weights,
                   keep_routes=bool(experts))
    check(same == n, f"{arch}: f32 greedy tokens differ between tp 2 and "
                     f"tp 1")
    del params
    _free(torch)

    # bf16: tp 1 (graphs), then tp 2 (eager), at each depth
    params = model.init(0, dtype=torch.bfloat16, device=dev)
    kvh_seen = set()
    paged = ops.paged_attention_mq

    def seen(q, *a, **k):
        kvh_seen.add(q.shape[2])
        return paged(q, *a, **k)
    by_rank = [0, 0]
    for depth in depths:
        out = {}
        for tp in (1, 2):
            ranks.report()                      # the worker's counts: 0
            kvh_seen.clear()
            before = LAUNCHES["paged_attention_mq"]
            ops.paged_attention_mq = seen
            try:
                eng, reqs, res = _tp_serve(
                    torch, model, params, dev,
                    ranks if tp == 2 else None, depth, serve=serve)
            finally:
                ops.paged_attention_mq = paged
            launched = LAUNCHES["paged_attention_mq"] - before
            pool, s = eng._pool, res["stats"]
            pool.allocator.check_invariants()
            check(all(r.state is RequestState.DONE for r in reqs),
                  f"{arch} bf16 tp {tp} spec {depth}: not all requests DONE")
            check(res["health"]["fallbacks"] == 0, "safe-plan fallback ran")
            check(res["page_leaks"] == 0 and pool.leaked_pages() == 0,
                  "leaked pages")
            check(launched == res["steps"] * L_,
                  f"{arch}: rank 0's kernel launches {launched} != steps "
                  f"{res['steps']} x {L_} layers")
            out[tp] = (s["tok_per_s"], pool.per_device_hbm_bytes())
            line = ""
            if tp == 2:
                (w,) = ranks.report()
                mesh = res["mesh"]
                check(kvh_seen == {cfg.n_kv_heads // 2} and
                      w["kv_heads"] == cfg.n_kv_heads // 2,
                      f"the kernel ran at kv heads {kvh_seen} on rank 0 "
                      f"and {w['kv_heads']} on rank 1")
                check(w["decode_steps"] == res["steps"] and
                      w["paged_launches"] == res["steps"] * L_,
                      f"rank 1: {w}, rank 0's steps {res['steps']}")
                check(2 * pool.per_device_hbm_bytes() == out[1][1]
                      and w["page_bytes"] == out[2][1],
                      f"per-device pool bytes {out[2][1]} (rank 1 "
                      f"{w['page_bytes']}) are not half of tp 1's "
                      f"{out[1][1]}")
                check(mesh["tp"] == 2 and mesh["devices"] == 2 and
                      mesh["hbm_bytes_per_device"] == out[2][1],
                      f"mesh result {mesh}")
                held = [eng._shard.experts(), w["experts"]]
                check(held == [experts // 2] * 2,
                      f"{arch}: experts a rank {held}, want {experts // 2}")
                by_rank[0] += launched
                by_rank[1] += w["paged_launches"]
                line = (f", rank 1: {w['decode_steps']} decode + "
                        f"{w['chunk_steps']} chunk steps, "
                        f"{w['paged_launches']} kernel launches at "
                        f"{w['kv_heads']} kv heads"
                        + (f", experts a rank {held} of {experts}"
                           if experts else "") + f"; mesh {mesh}")
            log(f"[tp] {arch} bf16 spec_depth={depth} tp {tp}: "
                f"{s['n_done']}/{n} done, {s['tokens']} tokens, "
                f"steps={res['steps']}, {s['tok_per_s']:.1f} tok/s, rank 0 "
                f"kernel launches={launched} at kv heads "
                f"{sorted(kvh_seen)}, pool {out[tp][1] / 2**20:.1f} MiB a "
                f"device{line}")
            del eng
            _free(torch)
        log(f"[tp] {arch} bf16 spec_depth={depth}: {out[1][0]:.1f} tok/s "
            f"at tp 1, {out[2][0]:.1f} tok/s at tp 2 (two ranks on one "
            f"card over gloo: not a tensor-parallel speed)")
    del params
    return by_rank


# ---------------------------------------------------------------------------
# [dryrun] and [train-sharded]: the dry-run over fake worlds, and the
# sharded trainer on two ranks sharing the one card
# ---------------------------------------------------------------------------

# [train-sharded]: stablelm-1.6b at full width and depth, B 4 x S 512, 2
# steps on each (data, model) mesh of two ranks after one step on one
# rank; step 0's loss within LOSS_RTOL of the one-rank step's (bf16
# products summed in another order: over two half batches, or over two
# halves of the heads, ff and vocab, each rank rounding its part)
SHARDED_TRAIN = dict(batch=4, seq=512, steps=2, meshes=((2, 1), (1, 2)),
                     loss_rtol=1e-2, alloc_rtol=0.01)
# [train-sharded], the other families: 2 steps on (data 1, model 2) after
# one step on one rank, at (B, S) by arch: the recurrent ones B 1 x S 128
# (one 128-step segment of the scans' gradient, whose plain backward is
# host-bound), whisper B 2 x S 256 (``Model.init``'s stacked weights,
# scaled by the layer count, make its grad norm ~1e9 and its step
# chaotic: its step-0 loss on two ranks stood 4.4e-3 off one rank's at B
# 2 x S 256, 8.6e-3 at B 1 x S 128, on an H100 80GB HBM3 at 700 W, and
# 3.7e-3 in f32 at B 1 x S 128; the gate's 1e-2 wants the loss over more
# tokens), granite-moe-1b-a400m B 4 x S 512 (16 of its 32 experts a
# rank); stablelm's runs start once only `beside`'s are left, whose
# ranks fit on the card beside stablelm's; [dryrun] counts train_4k
# of `train` and long_500k of `long` on 16x16, every shape of `moe` on
# 16x16 and 2x16x16, and the (1, 2) cell of each trained arch at its
# (B, S)
SHARDED_FAMILIES = dict(shapes={"rwkv6-3b": (1, 128), "zamba2-2.7b": (1, 128),
                                "whisper-large-v3": (2, 256),
                                MOE_TRAIN_ARCH: (4, 512)},
                        steps=2, mesh=(1, 2),
                        beside=("whisper-large-v3", MOE_TRAIN_ARCH),
                        train=("rwkv6-3b", "zamba2-2.7b", "internvl2-26b",
                               "whisper-large-v3"),
                        long=("rwkv6-3b", "zamba2-2.7b"),
                        moe=(MOE_ARCH, MOE_TRAIN_ARCH),
                        scans={"rwkv6-3b": "wkv_fused",
                               "zamba2-2.7b": "ssd_fused"})

_DRYRUN_CHILD = r"""
import json, sys
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
out, arch, st, fam = (sys.argv[1], sys.argv[2], json.loads(sys.argv[3]),
                      json.loads(sys.argv[4]))
runs = [[arch, "--mesh", "single"],
        [arch, "--shape", "train_4k", "--mesh", "multi"]]
runs += [[a, "--shape", "train_4k", "--mesh", "single"] for a in fam["train"]]
runs += [[a, "--shape", "long_500k", "--mesh", "single"] for a in fam["long"]]
runs += [[a, "--mesh", "both"] for a in fam["moe"]]
codes = []
for argv in runs:
    try:
        dryrun.main(["--arch", argv[0], "--out", out, "--force"] + argv[1:])
    except SystemExit as e:
        codes.append(e.code or 0)
cells = {}
for a, (b, s), dims in ([(arch, (st["batch"], st["seq"]), d)
                         for d in st["meshes"]]
                        + [(a, bs, fam["mesh"])
                           for a, bs in fam["shapes"].items()]):
    shape = ShapeConfig("train_%d" % s, s, b, "train")
    row = dryrun.run_cell(a, shape, False, verbose=False, microbatch=1,
                          mesh_dims=tuple(dims))
    cells.setdefault(a, {})["x".join(map(str, dims))] = row["memory"]
print("DRYRUN " + json.dumps({"codes": codes, "cells": cells}))
"""


def start_dryrun():
    """Start [dryrun]'s child (phase 13 of the module docstring), which
    sees no card; returns (the process, its rows' path, its start)."""
    out = ROOT / "build" / "dryrun_torch.jsonl"
    out.parent.mkdir(parents=True, exist_ok=True)
    if out.exists():
        out.unlink()
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(
        [sys.executable, "-c", _DRYRUN_CHILD, str(out), ARCH,
         json.dumps(SHARDED_TRAIN), json.dumps(SHARDED_FAMILIES)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, out, time.perf_counter()


def dryrun_phase(torch, started) -> dict:
    """[dryrun]: phase 13 of the module docstring, from the child
    ``start_dryrun`` started.  Returns the memory of the two-rank train
    cells of SHARDED_TRAIN and SHARDED_FAMILIES, by arch and mesh
    label."""
    proc, out, t0 = started
    stdout, stderr = proc.communicate(timeout=600)
    for line in stdout.splitlines():
        if line.startswith(("[", "  ", "SKIP", "dry-run")):
            log(f"[dryrun] {line}")
    check(proc.returncode == 0, f"the dry-run failed:\n{stderr[-3000:]}")
    got = json.loads([ln for ln in stdout.splitlines()
                      if ln.startswith("DRYRUN ")][-1][len("DRYRUN "):])
    rows = [json.loads(ln) for ln in out.read_text().splitlines()]
    cells = {(r["arch"], r["shape"], r["mesh"]) for r in rows if r.get("ok")}
    fam = SHARDED_FAMILIES
    want = {(ARCH, s, "16x16")
            for s in ("train_4k", "prefill_32k", "decode_32k")}
    want.add((ARCH, "train_4k", "2x16x16"))
    want |= {(a, "train_4k", "16x16") for a in fam["train"]}
    want |= {(a, "long_500k", "16x16") for a in fam["long"]}
    want |= {(a, s, m) for a in fam["moe"]
             for s in ("train_4k", "prefill_32k", "decode_32k")
             for m in ("16x16", "2x16x16")}
    runs = 2 + len(fam["train"]) + len(fam["long"]) + len(fam["moe"])
    check(got["codes"] == [0] * runs
          and cells == want and len(rows) == len(want),
          f"dry-run cells {sorted(cells)}, exit codes {got['codes']}")
    for arch, by_mesh in got["cells"].items():
        B, S = ((SHARDED_TRAIN["batch"], SHARDED_TRAIN["seq"]) if arch == ARCH
                else fam["shapes"][arch])
        for name, mem in by_mesh.items():
            log(f"[dryrun] {arch} train B {B} x S {S} on "
                f"a {name} mesh: arguments {mem['argument_size_in_bytes']} "
                f"bytes, peak {_gib(mem['peak_bytes_per_device'])} a rank")
    log(f"[dryrun] child {time.perf_counter() - t0:.1f} s (from its start)")
    return got["cells"]


def train_sharded_phase(torch, predicted: dict) -> None:
    """[train-sharded]: phase 13 of the module docstring, through the
    launcher (``repro_torch.launch.train.main``, this process rank 0)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train as launch_train
    st = SHARDED_TRAIN
    t0 = time.perf_counter()
    cfg = get_config(ARCH)
    log(f"[train-sharded] {ARCH} at full width and depth ({cfg.n_layers} "
        f"layers, d_model {cfg.d_model}), bf16 params and f32 moments, B "
        f"{st['batch']} x S {st['seq']}, on two ranks sharing one card "
        f"over gloo (ranks share a device): two ranks on one card")
    base = ["--full", "--device", "cuda", "--batch", str(st["batch"]),
            "--seq", str(st["seq"]), "--log-every", "1"]

    def run(extra, tag):
        return _launch_stats(torch, launch_train, base + extra, tag)

    (one,) = run(["--steps", "1"], "one-rank")
    check(np.isfinite(one["loss"][0]), "one-rank loss is not finite")
    log(f"[train-sharded] one rank: step 0 loss {one['loss'][0]:.6f}, grad "
        f"norm {one['grad_norm'][0]:.4f}, moments {one['moment_bytes']} "
        f"bytes, {one['step_ms'][0]:.1f} ms")
    for d, m in st["meshes"]:
        name = f"{d}x{m}"
        ranks = run(["--ranks", "2", "--data", str(d), "--model", str(m),
                     "--steps", str(st["steps"])], f"data {d} model {m}")
        check(len(ranks) == 2, f"{name}: stats of {len(ranks)} ranks")
        for r in ranks:
            check(all(np.isfinite(r["loss"])) and
                  all(np.isfinite(r["grad_norm"])),
                  f"{name} rank {r['rank']}: a loss or grad norm is not "
                  f"finite: {r['loss']} {r['grad_norm']}")
        r0 = ranks[0]
        gap = abs(r0["loss"][0] - one["loss"][0]) / abs(one["loss"][0])
        log(f"[train-sharded] {name}: losses {r0['loss']}, grad norms "
            f"{r0['grad_norm']}; step 0's loss {gap:.3e} of the one-rank "
            f"step's (tolerance {st['loss_rtol']:g})")
        check(gap <= st["loss_rtol"], f"{name}: step 0 loss {r0['loss'][0]} "
              f"against the one rank's {one['loss'][0]}")
        if d == 2:
            check(all(2 * r["moment_bytes"] == one["moment_bytes"]
                      for r in ranks),
                  f"{name}: moment bytes {[r['moment_bytes'] for r in ranks]}"
                  f" are not half of one rank's {one['moment_bytes']}")
        want = predicted[ARCH][name]["argument_size_in_bytes"]
        got = r0["allocated_after_placement"]
        log(f"[train-sharded] {name}: rank 0 allocated after placement "
            f"{got} bytes against the dry-run's arguments {want} "
            f"({got / want - 1:+.4%}); moments a rank "
            f"{[r['moment_bytes'] for r in ranks]}; peak allocated "
            f"{_gib(r0['peak_allocated'])} against the dry-run's "
            f"{_gib(predicted[ARCH][name]['peak_bytes_per_device'])}; ms a "
            f"step "
            f"(host clock to the loss's readback) "
            f"{[round(x, 1) for x in r0['step_ms']]} (two ranks on one card "
            f"over gloo: not a speed)")
        check(abs(got - want) <= st["alloc_rtol"] * want,
              f"{name}: allocated {got} against the dry-run's {want}")
    _free(torch)
    log(f"[train-sharded] phase {time.perf_counter() - t0:.1f} s")


def _launch_stats(torch, launch_train, argv, tag) -> list:
    """Every rank's stats of one launcher run (``--stats-out``)."""
    path = _stats_path(tag)
    _free(torch)
    t = time.perf_counter()
    launch_train.main(argv + ["--stats-out", str(path)])
    ranks = json.loads(path.read_text())["ranks"]
    path.unlink()
    log(f"[train-sharded] {tag}: {time.perf_counter() - t:.1f} s of "
        f"launcher")
    return ranks


def _stats_path(tag: str) -> Path:
    build_dir = ROOT / "build"
    build_dir.mkdir(parents=True, exist_ok=True)
    return build_dir / f"smoke_sharded_{tag.replace(' ', '_')}.json"


_FAMILIES_CHILD = r"""
import gc, json, sys, time
import torch
from repro_torch.launch import train as launch_train
for tag, argv in json.loads(sys.argv[1]):
    t = time.perf_counter()
    launch_train.main(argv)
    gc.collect()
    torch.cuda.empty_cache()
    print("[train-sharded] %s: %.1f s of launcher" % (
        tag, time.perf_counter() - t), flush=True)
"""


def _family_runs() -> list:
    """(arch, tag, launcher argv) of [train-sharded]'s other families, in
    the order they run: each arch's one-rank step, then its steps on
    SHARDED_FAMILIES' mesh."""
    fam = SHARDED_FAMILIES
    d, m = fam["mesh"]
    runs = []
    for arch, (B, S) in fam["shapes"].items():
        base = ["--full", "--device", "cuda", "--arch", arch, "--batch",
                str(B), "--seq", str(S), "--log-every", "1"]
        for tag, extra in (
                (f"{arch} one-rank", ["--steps", "1"]),
                (f"{arch} data {d} model {m}",
                 ["--ranks", "2", "--data", str(d), "--model", str(m),
                  "--steps", str(fam["steps"])])):
            runs.append((arch, tag, base + extra + [
                "--stats-out", str(_stats_path(tag))]))
    return runs


def start_families():
    """Start [train-sharded]'s other families (phase 13 of the module
    docstring) in a child on the card, the launcher runs of
    ``_family_runs`` in turn, its output to a log under ``build/``;
    returns (the process, the log's path, its start)."""
    runs = _family_runs()
    for _, tag, _ in runs:
        _stats_path(tag).unlink(missing_ok=True)
    path = ROOT / "build" / "smoke_sharded_families.log"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    with open(path, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-c", _FAMILIES_CHILD,
             json.dumps([[tag, argv] for _, tag, argv in runs])],
            env=env, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT,
            text=True)
    return proc, path, time.perf_counter()


def _wait_for_runs(started, archs, timeout: float = 900) -> None:
    """Wait until the child ``start_families`` started has finished the
    runs of ``archs`` (its log's line after each run)."""
    proc, path, _ = started
    d, m = SHARDED_FAMILIES["mesh"]
    lines = [f"[train-sharded] {a} data {d} model {m}:" for a in archs]
    t0 = time.perf_counter()
    while not all(any(ln.startswith(w) for ln in path.read_text()
                      .splitlines()) for w in lines):
        check(proc.poll() is None, "the other families' training ended "
                                   f"before {archs} were done")
        check(time.perf_counter() - t0 < timeout,
              f"the other families' {archs} not done in {timeout} s")
        time.sleep(1.0)


# [train-sharded]'s kill and resume: the launcher on cuda in f32 at the
# reduced configs of stablelm and granite (a full-width checkpoint is
# 16-19 GB of npz), B 4 x S 32, 8 steps, a checkpoint every 4; killed at
# step 6 on (data 2), run uninterrupted on (data 2), then resumed from
# copies of the step-4 checkpoint on each split of SPLITS
RESUME = dict(archs=(ARCH, MOE_TRAIN_ARCH), batch=4, seq=32, steps=8,
              every=4, fail=6, rtol=1e-5,
              splits={"data2": ["--ranks", "2", "--data", "2"],
                      "model2": ["--ranks", "2", "--model", "2"],
                      "one": ["--ranks", "1"]})

_RESUME_CHILD = r"""
import json, os, shutil, sys, time
from repro_torch.launch import train as launch_train
root, st = sys.argv[1], json.loads(sys.argv[2])
out = {}
for arch in st["archs"]:
    t = time.perf_counter()
    base = ["--device", "cuda", "--dtype", "float32", "--arch", arch,
            "--batch", str(st["batch"]), "--seq", str(st["seq"]),
            "--steps", str(st["steps"]), "--ckpt-every", str(st["every"]),
            "--log-every", "1"]
    d = os.path.join(root, arch)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    ck = os.path.join(d, "ck")
    rec = {}
    try:
        launch_train.main(base + st["splits"]["data2"] + [
            "--ckpt-dir", ck, "--fail-at-step", str(st["fail"])])
        rec["fail_code"] = 0
    except SystemExit as e:
        rec["fail_code"] = e.code
    rec["files"] = sorted(os.listdir(ck))

    def stats(argv, tag):
        path = os.path.join(d, tag + ".json")
        launch_train.main(argv + ["--stats-out", path])
        with open(path) as f:
            return json.load(f)["ranks"]
    rec["full"] = stats(base + st["splits"]["data2"], "full")
    for name, flags in st["splits"].items():
        shutil.copytree(ck, ck + "_" + name)
        rec[name] = stats(base + flags + ["--ckpt-dir", ck + "_" + name,
                                          "--resume"], name)
    out[arch] = rec
    print("[train-sharded] resume %s: %.1f s of launchers" % (
        arch, time.perf_counter() - t), flush=True)
print("RESUME " + json.dumps(out), flush=True)
"""


def start_resume():
    """Start [train-sharded]'s kill and resume (phase 13 of the module
    docstring) in a child on the card, its output to a log under
    ``build/``; returns (the process, the log's path, its start)."""
    root = ROOT / "build" / "smoke_resume"
    root.mkdir(parents=True, exist_ok=True)
    path = ROOT / "build" / "smoke_resume.log"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    with open(path, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-c", _RESUME_CHILD, str(root),
             json.dumps(RESUME)], env=env, cwd=ROOT, stdout=f,
            stderr=subprocess.STDOUT, text=True)
    return proc, path, time.perf_counter()


def _zero1_share(arch: str, data: int, model: int) -> list:
    """Each rank's f32 moment bytes on a (data, model) split of the
    reduced ``arch``: its blocks of mu and nu at their ZeRO-1 specs."""
    import types

    from repro_torch.configs.registry import get_config
    from repro_torch.core.policy import default_plan
    from repro_torch.distributed import sharding as shard_mod
    from repro_torch.models import layers as L
    from repro_torch.models.model import build
    model_ = build(get_config(arch).reduced())
    shapes = [tuple(sp.shape) for sp in L.tree_leaves(model_.spec())]
    out = []
    for i in range(data):
        for j in range(model):
            mesh = types.SimpleNamespace(
                shape={"data": data, "model": model},
                coords={"data": i, "model": j})
            o_sh = shard_mod.opt_state_shardings(
                model_, default_plan(mesh, "train"))["mu"]
            out.append(2 * 4 * sum(
                int(np.prod(shard_mod.local_shape(shape, spec, mesh)))
                for shape, spec in zip(shapes, L.tree_leaves(o_sh))))
    return out


def resume_phase(started) -> None:
    """[train-sharded]'s kill and resume (phase 13 of the module
    docstring), from the child ``start_resume`` started: exit code 42 and
    the step-4 checkpoint; on (data 2) steps 4-7's losses, grad norms and
    aux losses bit for bit the uninterrupted run's; on (data 1, model 2)
    and on one rank the losses within RESUME's rtol; each resumed rank's
    moment bytes its ZeRO-1 share."""
    import shutil
    proc, path, t0 = started
    rc = proc.wait(timeout=900)
    text = path.read_text()
    for line in text.splitlines():
        if line.startswith(("[train-sharded]", "resumed", "simulating",
                            "done:")):
            log(line)
    check(rc == 0, f"the kill and resume runs failed (exit {rc}):\n"
                   f"{text[-3000:]}")
    got = json.loads([ln for ln in text.splitlines()
                      if ln.startswith("RESUME ")][-1][len("RESUME "):])
    st = RESUME
    dims = {"data2": (2, 1), "model2": (1, 2), "one": (1, 1)}
    for arch, rec in got.items():
        check(rec["fail_code"] == 42 and rec["files"] == [
            "ckpt_00000004.json", "ckpt_00000004.npz"],
            f"{arch}: --fail-at-step {st['fail']} exit {rec['fail_code']}, "
            f"files {rec['files']}")
        full = rec["full"][0]
        want = full["loss"][4:]
        for name, ranks in ((n, rec[n]) for n in st["splits"]):
            losses = [r["loss"] for r in ranks]
            check(all(x == losses[0] for x in losses) and
                  all(np.isfinite(losses[0])),
                  f"{arch} {name}: ranks' losses {losses}")
            gap = max(abs(a / b - 1) for a, b in zip(losses[0], want))
            moments = [r["moment_bytes"] for r in sorted(
                ranks, key=lambda r: r["rank"])]
            share = _zero1_share(arch, *dims[name])
            log(f"[train-sharded] resume {arch} reduced f32 on {name}: "
                f"steps 4-7 losses {losses[0]} against the uninterrupted "
                f"(data 2) run's {want}, largest relative gap {gap:.3e}; "
                f"moment bytes a rank {moments} (ZeRO-1 share {share})")
            if name == "data2":
                for key in ("loss", "grad_norm", "aux"):
                    check(ranks[0][key] == full[key][4:],
                          f"{arch}: resumed on (data 2), {key} "
                          f"{ranks[0][key]} != {full[key][4:]}")
            else:
                check(gap <= st["rtol"], f"{arch} {name}: resumed losses "
                      f"{losses[0]} against {want}")
            check(moments == share, f"{arch} {name}: moment bytes "
                  f"{moments}, ZeRO-1 share {share}")
    shutil.rmtree(ROOT / "build" / "smoke_resume", ignore_errors=True)
    log(f"[train-sharded] kill and resume {time.perf_counter() - t0:.1f} s "
        f"from the child's start")


# [examples]: the port's examples in turn, in one child on the card, each
# through its main() at its default device
EXAMPLES = ("quickstart", "serve_batched", "autotune_regions")

_EXAMPLES_CHILD = r"""
import importlib.util, json, sys, time
root, out_dir = sys.argv[1], sys.argv[2]
from repro_torch.kernels import LAUNCHES
rec = {}
for name in json.loads(sys.argv[3]):
    path = "%s/examples/%s_torch.py" % (root, name)
    spec = importlib.util.spec_from_file_location(name + "_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    before = dict(LAUNCHES)
    t = time.perf_counter()
    summary = mod.main(["--out-dir", out_dir]
                       if name == "autotune_regions" else [])
    rec[name] = {"wall_s": time.perf_counter() - t, "summary": summary,
                 "launches": {k: n - before.get(k, 0)
                              for k, n in sorted(LAUNCHES.items())
                              if n - before.get(k, 0)}}
    print("[examples] %s done in %.1f s" % (name, rec[name]["wall_s"]),
          flush=True)
print("EXAMPLES " + json.dumps(rec, default=str), flush=True)
"""


def start_examples():
    """Start [examples] (phase 14 of the module docstring) in a child on
    the card, its output to a log under ``build/``; returns (the process,
    the log's path, its start)."""
    out = ROOT / "build" / "smoke_examples"
    out.mkdir(parents=True, exist_ok=True)
    path = ROOT / "build" / "smoke_examples.log"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    with open(path, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-c", _EXAMPLES_CHILD, str(ROOT), str(out),
             json.dumps(EXAMPLES)], env=env, cwd=ROOT, stdout=f,
            stderr=subprocess.STDOUT, text=True)
    return proc, path, time.perf_counter()


def examples_phase(started) -> dict:
    """[examples]: phase 14 of the module docstring, from the child
    ``start_examples`` started.  Returns the scan kernels' launches in
    the examples (``wkv_fused``, ``wkv_chunk``)."""
    import shutil

    from repro_torch.core.policy import RegionPlan
    proc, path, t0 = started
    rc = proc.wait(timeout=900)
    text = path.read_text()
    check(rc == 0, f"the examples failed (exit {rc}):\n{text[-3000:]}")
    got = json.loads([ln for ln in text.splitlines()
                      if ln.startswith("EXAMPLES ")][-1][len("EXAMPLES "):])
    for name in EXAMPLES:
        log(f"[examples] {name}: {got[name]['wall_s']:.1f} s, launches by "
            f"kernel {got[name]['launches']}")
    served = got["serve_batched"]["summary"]
    for section, want in (("continuous", 8), ("overcommit", 6)):
        rec = served[section]
        log(f"[examples] serve_batched {section}: {rec['done']}/"
            f"{rec['requests']} requests DONE in {rec['steps']} pool steps, "
            f"leaked pages {rec['page_leaks']}")
        check(rec["done"] == rec["requests"] == want
              and rec["page_leaks"] == 0,
              f"serve_batched {section}: {rec}")
    launches = got["serve_batched"]["launches"]
    counts = {k: launches.get(k, 0) for k in ("wkv_fused", "wkv_chunk")}
    check(counts["wkv_fused"] > 0,
          f"serve_batched launched no wkv_fused: {launches}")
    plan_path = Path(got["autotune_regions"]["summary"]["plan"])
    plan = RegionPlan.from_json(plan_path.read_text())
    log(f"[examples] autotune_regions: the plan at {plan_path} loads back "
        f"with {len(plan.region_configs)} region configs; the corpus holds "
        f"{got['autotune_regions']['summary']['entries']} entries")
    shutil.rmtree(ROOT / "build" / "smoke_examples", ignore_errors=True)
    log(f"[examples] {time.perf_counter() - t0:.1f} s from the child's "
        f"start")
    return counts


def stop_children(started: dict) -> None:
    """Kill whatever of ``started`` still runs."""
    for proc, *_ in started.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def train_sharded_families_phase(torch, started, predicted: dict) -> dict:
    """[train-sharded]'s other families (phase 13 of the module
    docstring): rwkv6-3b, zamba2-2.7b and whisper-large-v3 at full width
    and depth, one step on one rank, then 2 steps on (data 1, model 2),
    from the child ``start_families`` started; then the gates against
    ``predicted``, the dry-run's cells.  Returns each scan kernel's
    launches on the two ranks, by rank."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    proc, path, t0 = started
    rc = proc.wait(timeout=900)
    text = path.read_text()
    for line in text.splitlines():
        if line.startswith(("[train-sharded]", "step ", "done:")):
            log(line)
    check(rc == 0, f"the other families' training failed (exit {rc}):\n"
                   f"{text[-3000:]}")
    log(f"[train-sharded] other families {time.perf_counter() - t0:.1f} s "
        f"from the child's start (beside [tp], then stablelm's runs)")
    fam, st = SHARDED_FAMILIES, SHARDED_TRAIN
    d, m = fam["mesh"]
    name = f"{d}x{m}"
    stats = {}
    for arch, tag, _ in _family_runs():
        stats.setdefault(arch, []).append(
            json.loads(_stats_path(tag).read_text())["ranks"])
        _stats_path(tag).unlink()
    by_kernel: dict = {}
    for arch, ((one,), ranks) in stats.items():
        cfg = get_config(arch)
        B, S = fam["shapes"][arch]
        log(f"[train-sharded] {arch} at full width and depth ({cfg.n_layers} "
            f"layers, d_model {cfg.d_model}), bf16 params and f32 moments, B "
            f"{B} x S {S}, on two ranks sharing one card over gloo: two "
            f"ranks on one card")
        scan = fam["scans"].get(arch)
        n_seg = len(ops.segments(S))
        per_step = cfg.n_layers * n_seg if scan else 0
        check(np.isfinite(one["loss"][0]) and np.isfinite(one["grad_norm"][0]),
              f"{arch}: the one-rank loss or grad norm is not finite")
        got = one["launches"].get(scan, 0) if scan else sum(
            one["launches"].values())
        log(f"[train-sharded] {arch} one rank: step 0 loss "
            f"{one['loss'][0]:.6f}, grad norm {one['grad_norm'][0]:.4f}, "
            f"{one['step_ms'][0]:.1f} ms, launches {one['launches']} (want "
            f"{scan or 'none'} {per_step}: layers x segments = "
            f"{cfg.n_layers} x {n_seg})")
        check(got == per_step and (scan is None or set(one["launches"])
                                   == {scan}),
              f"{arch}: one-rank launches {one['launches']}, want {scan} "
              f"{per_step}")
        check(len(ranks) == 2, f"{arch} {name}: stats of {len(ranks)} ranks")
        want_l = 2 * per_step * fam["steps"]     # every layer remat
        for r in ranks:
            check(all(np.isfinite(r["loss"])) and
                  all(np.isfinite(r["grad_norm"])),
                  f"{arch} {name} rank {r['rank']}: a loss or grad norm is "
                  f"not finite: {r['loss']} {r['grad_norm']}")
            got = r["launches"].get(scan, 0) if scan else sum(
                r["launches"].values())
            check(got == want_l and (scan is None or set(r["launches"])
                                     == {scan}),
                  f"{arch} {name} rank {r['rank']}: launches "
                  f"{r['launches']}, want {scan} {want_l}")
        if scan:
            by_kernel[scan] = [r["launches"].get(scan, 0) for r in ranks]
        r0 = ranks[0]
        gap = abs(r0["loss"][0] - one["loss"][0]) / abs(one["loss"][0])
        want = predicted[arch][name]["argument_size_in_bytes"]
        alloc = r0["allocated_after_placement"]
        log(f"[train-sharded] {arch} {name}: losses {r0['loss']}, grad norms "
            f"{r0['grad_norm']}; step 0's loss {gap:.3e} of the one-rank "
            f"step's (tolerance {st['loss_rtol']:g}); launches a rank "
            f"{[r['launches'] for r in ranks]} (want {scan or 'none'} "
            f"{want_l}: 2 x layers x segments x steps, remat); rank 0 "
            f"allocated after placement {alloc} bytes against the dry-run's "
            f"arguments {want} ({alloc / want - 1:+.4%}); moments a rank "
            f"{[r['moment_bytes'] for r in ranks]}; peak allocated "
            f"{_gib(r0['peak_allocated'])} against the dry-run's "
            f"{_gib(predicted[arch][name]['peak_bytes_per_device'])}; ms a "
            f"step {[round(x, 1) for x in r0['step_ms']]} (two ranks on one "
            f"card over gloo beside other ranks: not a speed)")
        check(gap <= st["loss_rtol"], f"{arch} {name}: step 0 loss "
              f"{r0['loss'][0]} against the one rank's {one['loss'][0]}")
        check(abs(alloc - want) <= st["alloc_rtol"] * want,
              f"{arch} {name}: allocated {alloc} against the dry-run's "
              f"{want}")
        if cfg.n_experts:
            from repro_torch.models.moe import n_experts_padded
            e = n_experts_padded(cfg)
            held = [r["experts"] for r in ranks]
            aux = r0["aux"][0]
            log(f"[train-sharded] {arch} {name}: experts a rank {held} of "
                f"{e}; step 0's aux two ranks {aux:.6f}, one rank "
                f"{one['aux'][0]:.6f} ({aux / one['aux'][0] - 1:+.3e})")
            check(held == [e // m] * len(ranks),
                  f"{arch} {name}: experts a rank {held}, want {e // m}")
    return by_kernel


def sharded_phase(torch, started: dict) -> dict:
    """Phase 13, from its children (``start_dryrun``, ``start_families``,
    ``start_resume``): [dryrun]'s cells; stablelm-1.6b's [train-sharded]
    once the other families' child has only
    ``SHARDED_FAMILIES["beside"]`` left (whose ranks fit on the card
    beside stablelm's); then the other families' gates; then the kill
    and resume gates.  Returns the scan kernels' launches in the sharded
    training, by rank."""
    t0 = time.perf_counter()
    cells = dryrun_phase(torch, started["dryrun"])
    fam = SHARDED_FAMILIES
    _wait_for_runs(started["families"],
                   [a for a in fam["shapes"] if a not in fam["beside"]])
    train_sharded_phase(torch, cells)
    by_kernel = train_sharded_families_phase(torch, started["families"],
                                             cells)
    resume_phase(started["resume"])
    log(f"[dryrun + train-sharded] phase 13 {time.perf_counter() - t0:.1f} s")
    return by_kernel


# ---------------------------------------------------------------------------
# [bots]: the paper's degree sweep -> counter corpus -> decision tree
# ---------------------------------------------------------------------------


def bots_phase(torch, sizes=BOTS_SIZES, dev=None) -> None:
    """[bots]: phase 10 of the module docstring.  ``sizes`` gives each
    workload's ``build`` arguments, and ``dev`` the device they name (both
    set to the CPU's to rehearse the phase off the card)."""
    from repro_torch.bots import nqueens, sparselu, strassen, suite
    from repro_torch.core.dtree import features
    dev = dev or torch.device("cuda")
    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    if cuda:
        _free(torch)
        torch.cuda.reset_peak_memory_stats()
    rows = []
    for name in suite.WORKLOADS:
        for d in suite.DEGREES:
            row = suite.time_workload(name, d, BOTS_REPEATS,
                                      **sizes[name])
            check("error" not in row, f"{name} degree {d}: {row.get('error')}")
            check(not cuda or "device_s" in row,
                  f"{name} degree {d}: no device time")
            c = row["counters"]
            log(f"[bots] {name} degree {d}: wall {row['wall_s'] * 1e3:.3f} "
                f"ms, device {row.get('device_s', float('nan')) * 1e3:.3f} "
                f"ms, counted flops {c.flops:.6g}, bytes {c.bytes:.6g}, ops "
                f"{c.ops}, ai {c.flops / max(c.bytes, 1.0):.4f}, result "
                f"{row['result']}")
            rows.append(row)
    t_sweep = time.perf_counter() - t_phase

    known = {**nqueens.KNOWN, 13: 73712}
    for row in rows:
        name, d, res = row["workload"], row["degree"], row["result"]
        if row["degree"] == 1:
            c = row["counters"]
            check(c.flops > 0 and c.bytes > 0,
                  f"{name}: degree-1 counters {c.flops} flops, {c.bytes} "
                  f"bytes")
        if name == "nqueens":
            check(res == known[sizes[name]["n"]],
                  f"nqueens degree {d}: {res} solutions")
        elif name == "health":
            treated, peak = res
            size = sizes[name]
            check(0 < treated <= size["villages"] * size["steps"] * 10
                  and peak >= 0, f"health degree {d}: treated {treated}, "
                  f"peak {peak}")
        elif name == "floorplan":
            check(12 <= res < 10_000, f"floorplan degree {d}: best {res}")

    # strassen: each degree's product against the f64 product of the same
    # inputs, within 10x of one f32 torch.matmul's error against it
    fn, (a, b) = strassen.build(degree=1, **sizes["strassen"])
    ref = a.double() @ b.double()
    mm_err = float((torch.matmul(a, b).double() - ref).abs().max())
    for d in suite.DEGREES:
        fn, _ = strassen.build(degree=d, **sizes["strassen"])
        err = float((fn(a, b).double() - ref).abs().max())
        log(f"[bots] strassen degree {d}: max |C - A.B (f64)| {err:.6g}, "
            f"f32 torch.matmul's {mm_err:.6g} ({err / mm_err:.3f}x)")
        check(err <= 10 * mm_err, f"strassen degree {d}: error {err} > 10 "
              f"x matmul's {mm_err}")
    del a, b, ref, fn

    # sparselu: the residual, and every degree's LU against degree 1's
    base = None
    for d in suite.DEGREES:
        fn, (blocks,) = sparselu.build(degree=d, **sizes["sparselu"])
        lu = fn(blocks)
        res = sparselu.residual(blocks, lu, None)
        if base is None:
            base, scale = lu, float(lu.abs().max())
        diff = float((lu - base).abs().max())
        log(f"[bots] sparselu degree {d}: residual {res:.6g}, max |LU - "
            f"LU(degree 1)| {diff:.6g} (max |LU| {scale:.6g})")
        check(res < 0.05, f"sparselu degree {d}: residual {res}")
        check(diff <= 1e-5 * scale, f"sparselu degree {d}: LU differs from "
              f"degree 1's by {diff}")
    del base, lu, blocks

    tree = suite.train_tree(rows)
    check(tree is not None, "train_tree returned no tree")
    X, y = suite.training_corpus(rows)
    log(f"[bots-table] workload: wall ms | device ms by degree "
        f"{suite.DEGREES}; best degree (the paper's); the tree's class "
        f"for its degree-1 counters")
    for name in suite.WORKLOADS:
        wr = [r for r in rows if r["workload"] == name]
        best = min(wr, key=lambda r: r["wall_s"])
        cells = ", ".join(
            f"{r['wall_s'] * 1e3:.3f} | "
            f"{r.get('device_s', float('nan')) * 1e3:.3f}" for r in wr)
        log(f"[bots-table] {name}: {cells}; best degree {best['degree']} "
            f"({PAPER_BEST[name]}); tree "
            f"{tree.predict_one(features(wr[0]['counters']))}")
    log(f"[bots-table] tree: training accuracy {tree.score(X, y):.3f} on "
        f"{len(y)} workloads")
    peak = (f", peak allocated {_gib(torch.cuda.max_memory_allocated())}"
            if cuda else "")
    log(f"[bots] phase {time.perf_counter() - t_phase:.1f} s (sweep "
        f"{t_sweep:.1f} s){peak}")
    if cuda:
        _free(torch)


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# train-recurrent phase: rwkv6-3b and zamba2-2.7b trained at full width
# ---------------------------------------------------------------------------


def _model_layout(name, args):
    """scan_inputs' kernel-layout tensors in the model layout (T before
    H), contiguous."""
    if name == "wkv":
        r, k, v, w, u, s0 = args
        return [t.transpose(1, 2).contiguous() for t in (r, k, v, w)] + [
            u, s0]
    x, b, c, dt, a, s0 = args
    return [x.transpose(1, 2).contiguous(), b, c,
            dt.transpose(1, 2).contiguous(), a, s0]


def scan_grad_phase(torch) -> None:
    """The four scans' gradient on the card (``kernels.ops.wkv`` / ``ssd``
    under grad) at SCAN_GRAD_CASES, both modes, chunk 64, a nonzero entry
    state: the forward launches the kernel once a segment and the
    backward launches none; the output within ref.KERNEL_TOL of the plain
    form's and every gradient (of a random projection of the output and
    the final state) within ref.KERNEL_TOL x T of autograd through the
    plain form on the same inputs.  These launches are comparisons: no
    record counts them."""
    from repro_torch.kernels import LAUNCHES, ops, ref, reset_launches
    rtol, atol = ref.KERNEL_TOL[torch.float32]
    chunk = 64
    t0 = time.perf_counter()
    for name in ("wkv", "ssd"):
        for mode in ops.SCAN_MODES:
            chunked = mode == "chunk"
            kname = f"{name}_{'chunk' if chunked else 'fused'}"
            plain = getattr(ref, f"{name}_chunk" if chunked
                            else f"{name}_linear_scan")
            for (B, T), seg in SCAN_GRAD_CASES:
                args = _model_layout(name,
                                     scan_inputs(torch, name, 11, B, T))
                g = torch.Generator(device="cuda").manual_seed(T + seg)
                proj = [torch.randn(t.shape, generator=g, device="cuda")
                        for t in (args[0], args[5])]
                got = {}
                for label in ("kernel", "plain"):
                    leaves = [t.detach().clone().requires_grad_()
                              for t in args]
                    reset_launches()
                    if label == "kernel":
                        out, s = getattr(ops, name)(
                            *leaves, mode=mode, chunk=chunk, segment=seg)
                        fwd = LAUNCHES[kname]
                    else:
                        out, s = (plain(*leaves, chunk) if chunked
                                  else plain(*leaves))
                    loss = (out * proj[0]).sum() + (s * proj[1]).sum()
                    got[label] = ((out.detach(), s.detach()),
                                  torch.autograd.grad(loss, leaves))
                    if label == "kernel":
                        bwd = LAUNCHES[kname] - fwd
                n_seg = len(ops.segments(T, seg))
                check(fwd == n_seg and bwd == 0,
                      f"{kname} B {B} T {T} segment {seg}: {fwd} forward "
                      f"and {bwd} backward launches, want {n_seg} and 0")
                (ko, ks), kg = got["kernel"]
                (po, ps), pg = got["plain"]
                fwd_ok = (ref.within_tol(ko, po, torch.float32)
                          and ref.within_tol(ks, ps, torch.float32))
                worst = max(
                    ((a - b).abs() / (atol * T + rtol * T * b.abs()))
                    .max().item() for a, b in zip(kg, pg))
                big = max(b.abs().max().item() for b in pg)
                log(f"[train-recurrent] grad {kname} B {B} T {T} segment "
                    f"{seg}: {n_seg} segment(s), {fwd} launches; forward "
                    f"{'within' if fwd_ok else 'OUTSIDE'} KERNEL_TOL; grads "
                    f"at {worst:.3e} of KERNEL_TOL x T (largest grad "
                    f"{big:.3e})")
                check(fwd_ok, f"{kname} T {T} segment {seg}: forward "
                              f"outside KERNEL_TOL")
                check(worst <= 1.0, f"{kname} T {T} segment {seg}: grads "
                                    f"outside KERNEL_TOL x T ({worst:.3e})")
    torch.cuda.synchronize()
    log(f"[train-recurrent] scan gradient checks in "
        f"{time.perf_counter() - t0:.2f} s")


def meta_saved_bytes(torch, model, plan, B, S) -> int:
    """Bytes of the tensors the forward of a training step at B x S keeps
    for the backward beyond the params themselves, counted by storage on
    the meta device (bf16 params; a remat layer's saves are recomputed in
    the backward, so they are not counted)."""
    from repro_torch.models import layers as L
    from repro_torch.train import trainer
    params = L.tree_map(lambda sp: torch.empty(
        sp.shape, dtype=torch.bfloat16, device="meta").requires_grad_(),
        model.spec())
    own = {p.untyped_storage()._cdata for p in L.tree_leaves(params)}
    toks = torch.zeros((B, S), dtype=torch.long, device="meta")
    saved: dict = {}

    def pack(t):
        st = t.untyped_storage()
        if st._cdata not in own:
            saved[st._cdata] = st.nbytes()
        return t

    with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
            pack, lambda t: t):
        trainer.make_loss_fn(model, plan, True)(
            params, {"tokens": toks, "labels": toks})
    return sum(saved.values())


def _pick_batch(torch, model, plans, S) -> dict:
    """{plan name: the largest B of RECURRENT_TRAIN["batches"] whose meta
    count fits mem_share of the card}, each B's count logged."""
    from repro_torch.models import layers as L
    cfg = model.cfg
    total = torch.cuda.mem_get_info()[1]
    n = sum(int(np.prod(sp.shape)) for sp in L.tree_leaves(model.spec()))
    resident = n * (2 + 2 + 8)          # bf16 params and grads, f32 moments
    budget = RECURRENT_TRAIN["mem_share"] * total
    picked, null_saved = {}, {}
    t0 = time.perf_counter()
    for name, plan in plans.items():
        for B in RECURRENT_TRAIN["batches"]:
            if B not in null_saved:
                null_saved[B] = meta_saved_bytes(torch, model,
                                                 plans["null"], B, S)
            saved = (null_saved[B] if name == "null"
                     else meta_saved_bytes(torch, model, plan, B, S))
            layer = null_saved[B] / cfg.n_layers
            logits = 2 * B * S * cfg.vocab_size * 4
            need = resident + saved + layer + logits
            fits = need <= budget
            log(f"[train-recurrent] {cfg.name} {name} B {B} x S {S} on the "
                f"meta device: saved {saved / 1e9:.2f} GB + params, grads "
                f"and moments {resident / 1e9:.2f} GB + a layer's backward "
                f"{layer / 1e9:.2f} GB + logits and their grad "
                f"{logits / 1e9:.2f} GB = {need / 1e9:.2f} GB "
                f"{'<=' if fits else '>'} {budget / 1e9:.2f} GB "
                f"({RECURRENT_TRAIN['mem_share']:.0%} of the card's "
                f"{total / 1e9:.2f} GB)")
            if fits:
                picked[name] = B
                break
        check(name in picked, f"{cfg.name} {name}: no batch fits")
    log(f"[train-recurrent] {cfg.name}: counted in "
        f"{time.perf_counter() - t0:.2f} s; batch {picked}")
    return picked


def _forward_loss(torch, model, plan, params, batch) -> float:
    """The loss a train step computes on ``batch`` (its forward, with grad
    on and the params requiring it, as in ``trainer.make_grad_fn``), and
    no backward."""
    from repro_torch.models import layers as L
    from repro_torch.train import trainer
    leaves = [p.detach().requires_grad_() for p in L.tree_leaves(params)]
    it = iter(leaves)
    with torch.enable_grad():
        loss, _ = trainer.make_loss_fn(model, plan, True)(
            L.tree_map(lambda _: next(it), params), batch)
    return loss.item()


def train_recurrent_arch(torch, arch, launches: dict) -> None:
    """[train-recurrent] one recurrent config at full width and depth:
    phase 11 of the module docstring.  Adds each scan kernel's launches
    on the training path to ``launches``."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core import roofline
    from repro_torch.core.policy import (RegionConfig, RegionPlan,
                                         default_plan, null_plan)
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.kernels import LAUNCHES, ops, reset_launches
    from repro_torch.models import layers as L
    from repro_torch.models.model import build, model_flops
    from repro_torch.optim import adamw
    from repro_torch.train import checkpoint as ck
    from repro_torch.train import trainer
    t_arch = time.perf_counter()
    dev = torch.device("cuda")
    rt = RECURRENT_TRAIN
    model = build(get_config(arch))
    cfg = model.cfg
    S, steps = rt["seq"], rt["steps"][arch]
    scan = "wkv" if cfg.family == "ssm" else "ssd"
    per_step = cfg.n_layers * len(ops.segments(S))
    plans = {"null": null_plan(), "remat": default_plan(kind="train")}
    Bs = _pick_batch(torch, model, plans, S)
    peak = roofline.peak_ops(torch.bfloat16, roofline.card_for(
        torch.cuda.get_device_name(0)))
    opt_cfg = adamw.AdamWConfig(lr=rt["lr"])
    tag = "train-recurrent"
    _free(torch)

    # the null plan: steps, launches, and (rwkv6) a resume at step 1 from
    # the state after step 0 carried through the checkpoint format
    B = Bs["null"]
    data = DataConfig(cfg.vocab_size, seq_len=S, global_batch=B, seed=0)
    snap = {}

    def keep(i, p, o):
        if i == 0 and steps > 1:
            t0 = time.perf_counter()
            state = {"params": p, "opt": o}
            snap["flat"] = ck._flatten(state)
            snap["template"] = L.tree_map(
                lambda t: torch.empty(0, dtype=t.dtype, device=t.device),
                state)
            snap["s"] = time.perf_counter() - t0

    reset_launches()
    params, opt, run = _train_run(
        torch, model, plans["null"], opt_cfg, data, range(steps),
        f"{arch} null B {B}", schedule_total=steps, tag=tag,
        vectors_may_stay=True, after_step=keep)
    got = LAUNCHES[f"{scan}_fused"]
    launches[f"{scan}_fused"] += got
    log(f"[{tag}] {arch} null: {scan}_fused launched {got} times in "
        f"{steps} steps = {got / steps:g} a step (layers x segments = "
        f"{cfg.n_layers} x {len(ops.segments(S))} = {per_step}); peak "
        f"allocated {_gib(run['peak'])}")
    check(got == steps * per_step,
          f"{arch}: {got} {scan}_fused launches, want {steps * per_step}")
    flops = model_flops(cfg, ShapeConfig("train", S, B, "train"))
    med = float(np.median(run["ms"][1:] or run["ms"]))
    over = f"steps 2-{steps}" if steps > 1 else "its one step"
    log(f"[{tag}] {arch} null B {B} x S {S}: median step {med:.3f} ms over "
        f"{over} -> {B * S / med * 1e3:.1f} tok/s; model_flops "
        f"6·N·B·S {flops / 1e12:.3f} TFLOP = "
        f"{flops / (med * 1e-3) / peak:.2%} of the bf16 dense peak; peak "
        f"allocated {_gib(run['peak'])} ({run['peak']} bytes); "
        f"{card_line()}")

    # AdamW alone (on zero grads: the same reads and writes), and the
    # rest of the median step, forward + backward
    grads = L.tree_map(torch.zeros_like, params)
    up = _event_ms(torch, lambda: adamw.apply_updates(
        opt_cfg, params, grads, opt, 1.0))[1]
    del grads
    log(f"[{tag}] {arch} null split: AdamW {up:.3f} ms (CUDA events), "
        f"forward+backward the rest of the median step, {med - up:.3f} ms")
    del params, opt
    _free(torch)
    if snap:
        t0 = time.perf_counter()
        state = ck._unflatten(snap["template"], snap.pop("flat"))
        t_back = time.perf_counter() - t0
        loss1 = _forward_loss(torch, model, plans["null"], state["params"],
                              batch_at(data, 1, dev))
        log(f"[{tag}] {arch} resume: the state after step 0 through the "
            f"checkpoint format in host memory (bf16 params stored as f32, "
            f"f32 moments; {snap['s']:.1f} s to the host, {t_back:.1f} s "
            f"back), then step 1's forward: loss {loss1!r} against "
            f"{run['loss'][1]!r} uninterrupted; AdamW step "
            f"{state['opt']['step'].item()}")
        check(loss1 == run["loss"][1] and state["opt"]["step"].item() == 1,
              f"{arch}: the resumed step 1 differs from the uninterrupted")
        del state
        _free(torch)

    # every layer (and shared-attention site) remat from the same init:
    # step 0's loss on the null plan's batch (the forward, which remat
    # leaves as it is), then remat_steps steps at its own batch
    params = model.init(0, dtype=torch.bfloat16, device=dev)
    loss_r = _forward_loss(torch, model, plans["remat"], params,
                           batch_at(data, 0, dev))
    Br = Bs["remat"]
    data_r = DataConfig(cfg.vocab_size, seq_len=S, global_batch=Br, seed=0)
    reset_launches()
    params, opt, rem = _train_run(
        torch, model, plans["remat"], opt_cfg, data_r,
        range(rt["remat_steps"]), f"{arch} remat B {Br}", params,
        schedule_total=steps, tag=tag, check_changed=False)
    got = LAUNCHES[f"{scan}_fused"]
    launches[f"{scan}_fused"] += got
    flops_r = model_flops(cfg, ShapeConfig("train", S, Br, "train"))
    ms_r = rem["ms"][-1]
    log(f"[{tag}] {arch} remat B {Br} x S {S}: step 0 loss on the null "
        f"plan's batch {loss_r!r} (null {run['loss'][0]!r}); last step "
        f"{ms_r:.3f} ms -> {Br * S / ms_r * 1e3:.1f} tok/s, "
        f"{flops_r / (ms_r * 1e-3) / peak:.2%} of the bf16 dense peak by "
        f"model_flops; peak allocated {_gib(rem['peak'])} (null B {B}: "
        f"{_gib(run['peak'])}); {scan}_fused launched {got} times = "
        f"{got / rt['remat_steps']:g} a step (the backward recomputes each "
        f"layer's forward, its scan included: 2 x {per_step})")
    check(loss_r == run["loss"][0], f"{arch}: remat changed step 0's loss")
    check(got == 2 * per_step * rt["remat_steps"],
          f"{arch}: {got} {scan}_fused launches under remat, want "
          f"{2 * per_step * rt['remat_steps']}")
    del params, opt
    _free(torch)

    # one step with the chunked scans (64-step chunks, 128-step segments)
    chunk_plan = RegionPlan(region_configs={
        "layer": RegionConfig(scan_mode="chunk")})
    reset_launches()
    params, opt, chk = _train_run(
        torch, model, chunk_plan, opt_cfg, data, range(1),
        f"{arch} chunk B {B}", schedule_total=steps, tag=tag,
        check_changed=False)
    got = LAUNCHES[f"{scan}_chunk"]
    launches[f"{scan}_chunk"] += got
    rel = abs(chk["loss"][0] - run["loss"][0]) / abs(run["loss"][0])
    log(f"[{tag}] {arch} chunked scans B {B}: step 0 loss "
        f"{chk['loss'][0]!r} ({rel:.3e} of the sequential scans' "
        f"{run['loss'][0]!r}), {chk['ms'][0]:.3f} ms, peak allocated "
        f"{_gib(chk['peak'])}; {scan}_chunk launched {got} times")
    check(rel <= CHUNK_LOSS_RTOL, f"{arch}: the chunked scans' loss is "
                                  f"{rel:.3e} off the sequential one's")
    check(got == per_step, f"{arch}: {got} {scan}_chunk launches, want "
                           f"{per_step}")
    del params, opt
    _free(torch)
    log(f"[{tag}] {arch} done in {time.perf_counter() - t_arch:.1f} s")


def train_recurrent_phase(torch) -> dict:
    """[train-recurrent]: phase 11 of the module docstring.  Returns each
    scan kernel's launches on the training path."""
    from repro_torch.kernels import linear_scan as ls
    t0 = time.perf_counter()
    _free(torch)
    scan_grad_phase(torch)
    launches = {k: 0 for k in ls.NAMES}
    for arch in RECURRENT_TRAIN["archs"]:
        train_recurrent_arch(torch, arch, launches)
    log(f"[train-recurrent] phase in {time.perf_counter() - t0:.1f} s; "
        f"launches on the training path {launches}")
    return launches


def build_all(torch) -> None:
    """Build every kernel source at once (one nvcc process each), then load
    the libraries; log each build's registers, spills and shared memory."""
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import tuned_matmul as tm
    names = ("paged_attention", "linear_scan", "tuned_matmul",
             "flash_attention")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as ex:
        for name, fut in [(n, ex.submit(cuda_build.build, n))
                          for n in names]:
            fut.result()
    for mod in (pa, ls, tm, fa):
        mod.build()
    log(f"[build] {', '.join(n + '.cu' for n in names)} in "
        f"{time.perf_counter() - t0:.2f} s -> " + ", ".join(
            cuda_build.library_path(n).name for n in names))
    for name in names:
        for line in cuda_build.BUILD_LOG.get(name, "").splitlines():
            if ("registers" in line or "spill" in line or "smem" in line
                    or "Compiling entry" in line):
                log(f"[build] {name}: {line.strip()}")


def sass_phase() -> None:
    """The bf16 dense kernels run on the tensor cores: ``cuobjdump -sass``
    (from the toolkit beside nvcc) must show HGMMA (wgmma) in every bf16
    ``tuned_matmul`` kernel and HMMA (mma.sync) or HGMMA in every bf16
    ``flash_attention`` kernel."""
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import tuned_matmul as tm
    cuobjdump = Path(cuda_build.nvcc_path()).parent / "cuobjdump"
    for lib, marker, want, ops_ in (
            ("tuned_matmul", "matmul_bf16_wgmma", len(tm.MENU), ("HGMMA",)),
            ("flash_attention", "flash_bf16_mma",
             len(fa.HEAD_DIMS) * len(fa.TILES), ("HMMA", "HGMMA"))):
        out = subprocess.run(
            [str(cuobjdump), "-sass", str(cuda_build.library_path(lib))],
            capture_output=True, text=True, timeout=300, check=True).stdout
        funcs = [f for f in out.split("Function : ")[1:]
                 if marker in f.splitlines()[0]]
        counts = [sum(f.count(op) for op in ops_) for f in funcs]
        log(f"[sass] {lib}: {len(funcs)} bf16 kernels ({marker}), "
            f"{'/'.join(ops_)} instructions each: {counts}")
        check(len(funcs) == want,
              f"{lib}: {len(funcs)} bf16 kernels in the SASS, want {want}")
        check(all(counts), f"{lib}: a bf16 kernel without {ops_} in its SASS")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:] == ["--paged-host-time"]:
        log(f"[card] {card_line()}")
        paged_host_time(torch)
        return 0
    if sys.argv[1:] == ["--train-resume"]:
        train_resume_check(torch)
        return 0
    if sys.argv[1:] == ["--train"]:
        log(f"[card] {card_line()}")
        train_phase(torch)
        return 0
    only = {"--moe": moe_phase, "--vlm": vlm_phase,
            "--serve-subsystems": serve_subsystems_phase}
    if len(sys.argv) == 2 and sys.argv[1] in only:
        from repro_torch.kernels import cuda_build
        from repro_torch.kernels import paged_attention as pa
        log(f"[card] {card_line()}")
        cuda_build.build("paged_attention")
        pa.build()
        only[sys.argv[1]](torch)
        return 0
    if sys.argv[1:] == ["--whisper"]:
        log(f"[card] {card_line()}")
        whisper_phase(torch)
        return 0
    if sys.argv[1:] == ["--bots"]:
        log(f"[card] {card_line()}")
        bots_phase(torch)
        return 0
    if sys.argv[1:] == ["--tp"]:
        from repro_torch.kernels import cuda_build
        from repro_torch.kernels import paged_attention as pa
        log(f"[card] {card_line()}")
        cuda_build.build("paged_attention")
        pa.build()
        tp_phase(torch)
        return 0
    if sys.argv[1:] == ["--dryrun"]:
        from repro_torch.kernels import cuda_build
        from repro_torch.kernels import linear_scan as ls
        log(f"[card] {card_line()}")
        cuda_build.build("linear_scan")
        ls.build()
        started = {"dryrun": start_dryrun(), "families": start_families(),
                   "resume": start_resume()}
        try:
            sharded_phase(torch, started)
        finally:
            stop_children(started)
        return 0
    if sys.argv[1:] == ["--examples"]:
        from repro_torch.kernels import cuda_build
        from repro_torch.kernels import linear_scan as ls
        log(f"[card] {card_line()}")
        cuda_build.build("linear_scan")
        ls.build()
        started = {"examples": start_examples()}
        try:
            examples_phase(started["examples"])
        finally:
            stop_children(started)
        return 0
    if sys.argv[1:] == ["--train-recurrent"]:
        from repro_torch.kernels import cuda_build
        from repro_torch.kernels import linear_scan as ls
        log(f"[card] {card_line()}")
        cuda_build.build("linear_scan")
        ls.build()
        train_recurrent_phase(torch)
        return 0
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    card = card_line()
    log(f"[card] {card} | {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    build_all(torch)
    sass_phase()

    record = kernel_phase(torch)
    check(record is not None, "the timed kernel configuration never ran")
    scan_records = scan_kernel_phase(torch)
    floor_ms = timer_floor(torch)
    for name in ("wkv_fused", "ssd_fused"):
        scan_records[name]["timer_floor_ms"] = floor_ms
    scan_host_phase(torch, scan_records)
    dense_records = dense_kernel_phase(torch)
    for name, count in ops_path_phase(torch).items():
        dense_records[name]["launches"] = count

    from repro_torch.configs.registry import get_config
    from repro_torch.models import layers as L
    from repro_torch.models.model import build
    model = build(get_config(ARCH))
    t0 = time.perf_counter()
    params = model.init(0, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    log(f"[init] {ARCH} full width ({model.cfg.n_layers} layers, d_model "
        f"{model.cfg.d_model}, vocab {model.cfg.vocab_size}): "
        f"{sum(t.numel() for t in L.tree_leaves(params))/1e9:.3f} B params "
        f"in {time.perf_counter() - t0:.2f} s")
    parity_phase(torch, model, params, dev)
    params = L.tree_map(lambda t: t.to(torch.bfloat16), params)
    torch.cuda.empty_cache()
    launches = serve_phase(torch, model, params, dev)
    record["launches"] = launches["paged_attention_mq"]
    loop_phase(torch, model, params, dev)
    paged_graph_phase(torch, model, params, dev)
    del model, params
    torch.cuda.empty_cache()

    shape_counts: dict = {}
    for arch, kernels in (("rwkv6-3b", ("wkv_fused", "wkv_chunk")),
                          ("zamba2-2.7b", ("ssd_fused", "ssd_chunk"))):
        launches = recurrent_model_phase(torch, arch, kernels, dev,
                                         shape_counts)
        for k in kernels:
            scan_records[k]["launches"] = launches[k]
            check(sum(n for key, n in shape_counts.items() if key[0] == k)
                  == launches[k], f"{k}: calls by shape != launches")
    serve_shape_phase(torch, shape_counts, scan_records)
    train_phase(torch)
    record["launches_moe"] = moe_phase(torch)
    record["launches_vlm"] = vlm_phase(torch)
    whisper_phase(torch)
    record["launches_serve_subsystems"] = serve_subsystems_phase(torch)
    bots_phase(torch)
    # phase 13's children: the dry-run's count on the host and the kill
    # and resume runs (small, on the card) beside phases 11-12, the other
    # families' training beside phase 12; phase 14's examples (small, on
    # the card) beside phases 11-12
    started = {"dryrun": start_dryrun(), "resume": start_resume(),
               "examples": start_examples()}
    try:
        for name, count in train_recurrent_phase(torch).items():
            scan_records[name]["launches_train"] = count
        started["families"] = start_families()
        by_arch = tp_phase(torch)
        by_rank = [sum(r) for r in zip(*by_arch.values())]
        record["launches_tp"] = sum(by_rank)
        record["launches_tp_by_rank"] = by_rank
        record["launches_tp_granite"] = sum(by_arch[MOE_TRAIN_ARCH])
        by_kernel = sharded_phase(torch, started)
        for name, count in examples_phase(started["examples"]).items():
            scan_records[name]["launches_examples"] = count
    finally:
        stop_children(started)
    for name, by_rank in by_kernel.items():
        log(f"[train-sharded] {name} launches in the sharded steps by rank: "
            f"{by_rank}")

    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": [record, dense_records["tuned_matmul"],
                                  dense_records["flash_attention"],
                                  *scan_records.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
