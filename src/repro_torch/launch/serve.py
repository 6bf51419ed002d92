"""Serving launcher on PyTorch: request-trace-driven continuous batching.

Builds a synthetic arrival trace (poisson / staggered / burst), replays it
against the continuous-batching engine on ``--device`` (default ``cuda``)
— the paged pool, or the slot pool with ``--paged off`` and for the
recurrent families — or against the static lockstep baseline
(``--mode static``), and reports throughput and latency percentiles.
Weights are random, from a seeded ``torch.Generator``.  ``--attn-impl
paged`` runs the decode attention through the paged-attention kernel; the
recurrent families' scans always run through the WKV / SSD kernels, in
the mode ``--scan-mode`` resolves.

  PYTHONPATH=src python -m repro_torch.launch.serve --full --device cuda \\
      --attn-impl paged --requests 16 --prompt-len 128 --gen-max 64

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \\
      --full --device cuda --paged off --scan-mode chunk --spec-depth 2

  # where the device time goes, at chip_smoke.py's serve traffic
  PYTHONPATH=src python -m repro_torch.launch.serve --full --device cuda \\
      --attn-impl paged --profile --requests 16 --prompt-len 64 \\
      --prompt-max 512 --gen-min 32 --gen-max 64 --slots 8 --max-len 1024 \\
      --page-size 16 --prefill-chunk 256 --spec-depth 0 --arrival burst

  # reduced config on the CPU (the kernels' plain versions stand in)
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --dtype float32 --attn-impl paged --spec-depth 2

  # tensor-parallel paged serving: two ranks (here on the CPU, over
  # gloo; on cuda one rank a card, over nccl, clamped to the cards)
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --dtype float32 --tp 2 --prefill-chunk 8

  # the paper loop: online retraining from a cold start, then serving
  # with the saved tree
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --online-retrain --retrain-interval 8 --tree-out tree.json
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --dtree tree.json

A decision tree (``--dtree``) switches on counter-driven plan selection:
the decode step's per-region counters, scaled by the pool's occupancy,
pick each hot region's knobs per load bucket (``[plan]`` lines).
``--online-retrain`` closes the loop: measured step counters and tok/s
rewards feed a corpus (``--corpus-out``), the tree is retrained every
``--retrain-interval`` steps and hot-swapped (``--tree-out`` saves the
final tree), and ``--explore-eps`` trials serve-only candidates now and
then (``--no-explore`` keeps greedy output unchanged).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.policy import RegionConfig, RegionPlan
from repro_torch.models import model as model_mod
from repro_torch.serve.engine import SPAN_PREFIX, Engine, ServeConfig
from repro_torch.serve.scheduler import Request, RequestState, summarize


def build_trace(args, vocab_size: int) -> list[Request]:
    """Deterministic request trace from the CLI arrival model."""
    rng = np.random.default_rng(args.seed)
    if args.arrival == "poisson":
        gaps = rng.exponential(1.0 / args.rate, args.requests)
    elif args.arrival == "staggered":
        gaps = np.full(args.requests, 1.0 / args.rate)
    else:  # burst
        gaps = np.zeros(args.requests)
    arrivals = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    reqs = []
    for i in range(args.requests):
        gen = int(rng.integers(args.gen_min, args.gen_max + 1))
        n = (int(rng.integers(args.prompt_len, args.prompt_max + 1))
             if args.prompt_max > args.prompt_len else args.prompt_len)
        prompt = rng.integers(0, vocab_size, n).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=gen,
                            arrival_s=float(arrivals[i])))
    return reqs


def run_static(engine: Engine, reqs: list[Request], slots: int) -> dict:
    """Lockstep baseline: group FIFO into batches of ``slots``, wait for the
    whole group to arrive, decode everyone for the group's longest
    budget.  An encoder-decoder model gets zero frames (the stubbed
    frontend, as the JAX launcher feeds it) in the params' dtype: bf16, as
    there, unless the caller asked for another."""
    cfg = engine.model.cfg
    t0 = time.perf_counter()
    for i in range(0, len(reqs), slots):
        group = reqs[i:i + slots]
        wait = max(r.arrival_s for r in group) - (time.perf_counter() - t0)
        if wait > 0:
            time.sleep(wait)
        prompts = np.stack([r.prompt for r in group])
        extra = None
        if cfg.family == "encdec":
            extra = {"frames": torch.zeros(
                (len(group), cfg.enc_len, cfg.d_model),
                dtype=engine._param_dtype(), device=engine.device)}
        n_steps = max(r.max_new_tokens for r in group)
        t_gen0 = time.perf_counter() - t0
        res = engine.generate(prompts, n_steps, extra)
        out = res["tokens"].cpu().numpy()
        t = time.perf_counter() - t0
        # the group's first tokens land right after its prefill — TTFT is
        # prefill latency, not group completion
        for j, r in enumerate(group):
            r.out_tokens = out[j, :r.max_new_tokens].tolist()
            r.t_first = t_gen0 + res["prefill_s"]
            r.t_done = t
            r.state = RequestState.DONE
    return {"requests": reqs, "stats": summarize(reqs)}


def profile_serve(engine: Engine, reqs: list[Request],
                  top: int = 12) -> dict:
    """Serve ``reqs`` under ``torch.profiler`` (CPU and, on a GPU, CUDA
    activity) and print the device's busy share of the wall time, the
    device kernels that took it, the memory at peak, the host's time by
    the serve loop's spans (``serve.*``: prefill, decode step with its
    readback, re-advance) and the host ops that issued them."""
    import collections
    import time

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.regions import REGION_PREFIX
    acts = [ProfilerActivity.CPU]
    on_gpu = engine.device.type == "cuda"
    if on_gpu:
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    with profile(activities=acts) as prof:
        # the serve's own span: the profiler's start on entering the block
        # and its stop and event processing on leaving it are not part of it
        t0 = time.perf_counter()
        res = engine.serve(reqs)
        if on_gpu:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if on_gpu:
        # device-side kernels and copies (the device-side copies of the
        # region and span annotations excluded): busy time is the union
        # of their intervals
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith((REGION_PREFIX, SPAN_PREFIX))]
        busy, end = 0.0, float("-inf")
        for a, b in sorted((e.time_range.start, e.time_range.end)
                           for e in dev):
            if b > end:
                busy += b - max(a, end)
                end = b
        busy /= 1e6
        print(f"[profile] wall {wall:.3f} s (profiled), device busy "
              f"{busy:.3f} s = {100 * busy / wall:.1f}%, idle "
              f"{100 * (1 - busy / wall):.1f}%, {len(dev)} kernels and "
              f"copies [{torch.cuda.get_device_name(0)}]")
        by_name: dict = collections.defaultdict(lambda: [0.0, 0])
        for e in dev:
            by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
            by_name[e.name][1] += 1
        for name, (ms, n) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:top]:
            print(f"[profile] device {ms:10.3f} ms {n:7d}x  {name[:90]}")
        pool_mib = sum(g.pool_bytes
                       for g in engine._graphs.values()) / 2**20
        print(f"[profile] device memory at peak: "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB "
              f"allocated, {torch.cuda.max_memory_reserved() / 2**20:.1f} "
              f"MiB reserved; graphs {len(engine._graphs)}, their pool "
              f"{pool_mib:.1f} MiB")
    # the host's time by the serve loop's spans (each with what it calls),
    # and the rest of the loop (scheduling, drafts, acceptance, sleeps)
    spans = [e for e in prof.key_averages()
             if e.key.startswith(SPAN_PREFIX)
             and e.device_type == torch.autograd.DeviceType.CPU]
    for e in sorted(spans, key=lambda e: -e.cpu_time_total):
        print(f"[profile] host {e.key:16s} {e.cpu_time_total / 1e3:10.3f} "
              f"ms {e.count:6d}x ({e.cpu_time_total / 1e3 / e.count:.3f} "
              f"ms each)")
    rest = wall - sum(e.cpu_time_total for e in spans) / 1e6
    print(f"[profile] host rest of the loop {rest * 1e3:10.3f} ms")
    print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                    row_limit=top))
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda unless asked)")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16", help="weight and KV-pool dtype")
    ap.add_argument("--mode", choices=("continuous", "static"),
                    default="continuous",
                    help="continuous batching, or the static lockstep "
                         "generate() baseline")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--prompt-max", type=int, default=0,
                    help="draw each prompt's length from [--prompt-len, "
                         "--prompt-max] (default: every prompt --prompt-len)")
    ap.add_argument("--gen-min", type=int, default=4)
    ap.add_argument("--gen-max", type=int, default=16)
    ap.add_argument("--arrival", choices=("poisson", "staggered", "burst"),
                    default="poisson")
    ap.add_argument("--rate", type=float, default=20.0,
                    help="arrival rate, requests/s (poisson/staggered)")
    ap.add_argument("--slots", type=int, default=4,
                    help="KV pool width / static batch width")
    ap.add_argument("--prefill-bucket", type=int, default=8,
                    help="slot-pool prefill: pad prompts up to a multiple "
                         "of this where right-padding is sound (dense "
                         "caches; 0 = exact length)")
    ap.add_argument("--paged", choices=("auto", "on", "off"), default="auto",
                    help="paged KV pool (auto: wherever the family "
                         "supports it); off: the slot pool")
    ap.add_argument("--attn-impl", choices=("gather", "paged"),
                    default="gather",
                    help="decode attention: gather pages + einsum, or the "
                         "paged-attention kernel")
    ap.add_argument("--page-size", type=int, default=0,
                    help="tokens per KV page (0 = plan knob, else 16)")
    ap.add_argument("--kv-pages", type=int, default=0,
                    help="total KV pages incl. null (0 = per-slot worst "
                         "case; lower trades memory for queueing)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill piece size (0 = whole prompt)")
    ap.add_argument("--reservation", choices=("full", "lazy", "auto"),
                    default="auto",
                    help="paged KV admission: worst case up front, or "
                         "prompt pages + 1 with growth and preemption")
    ap.add_argument("--mem-watermark", type=float, default=-1.0,
                    help="lazy-admission free-page high watermark fraction "
                         "(-1 = plan knob, else 0.1)")
    ap.add_argument("--max-preempts", type=int, default=4)
    ap.add_argument("--prefix-cache", choices=("on", "off", "auto"),
                    default="auto",
                    help="cross-request KV prefix sharing with "
                         "copy-on-write")
    ap.add_argument("--spec-depth", default="auto",
                    choices=("auto", "0", "1", "2", "3", "4"),
                    help="speculative decode draft depth per pool step "
                         "(greedy only; 'auto' = the plan's knob, unset = 0)")
    ap.add_argument("--scan-mode", default="auto",
                    choices=("auto", "chunk", "fused_recurrent"),
                    help="recurrent scan kernel for ssm/hybrid slot-pool "
                         "families: 'chunk' (matmul-form chunked scan) or "
                         "'fused_recurrent' (the sequential recurrence) "
                         "for both phases; 'auto' = chunk for prefill, "
                         "fused for decode")
    ap.add_argument("--tp", default="1", choices=("1", "2", "4", "auto"),
                    help="tensor-parallel degree of the paged pool: the "
                         "launcher starts that many ranks, clamped down to "
                         "one a visible card (on cuda) and to a kv-head "
                         "divisor, over nccl (a card each) or gloo (ranks "
                         "sharing a device, as on the CPU); the paged step "
                         "runs eagerly above tp 1.  'auto' = as many ranks "
                         "as tp4 clamps to, the plan's tp1/tp2/tp4 knob "
                         "picking the degree")
    ap.add_argument("--max-len", type=int, default=0,
                    help="cache length (default: prompt+gen headroom)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--eos-id", type=int, default=-1)
    ap.add_argument("--dtree", default="",
                    help="DecisionTree json (from the autotuner corpus or "
                         "--tree-out) that picks the plan per load bucket")
    ap.add_argument("--online-retrain", action="store_true",
                    help="close the paper loop online: tap measured step "
                         "counters + tok/s rewards into a corpus, retrain "
                         "the decision tree every --retrain-interval steps "
                         "and hot-swap it (works from a cold start — no "
                         "--dtree needed)")
    ap.add_argument("--retrain-interval", type=int, default=32,
                    help="decode steps between corpus flush / retrain "
                         "attempts (with --online-retrain)")
    ap.add_argument("--explore-eps", type=float, default=0.1,
                    help="epsilon-greedy exploration rate over the "
                         "serve-only candidate menu (with --online-retrain; "
                         "0 keeps greedy output unchanged)")
    ap.add_argument("--explore-budget", type=int, default=64,
                    help="hard cap on exploration decisions per engine")
    ap.add_argument("--no-explore", action="store_true",
                    help="disable exploration (equivalent to "
                         "--explore-eps 0)")
    ap.add_argument("--corpus-in", default="",
                    help="corpus JSONL to merge before serving (requires "
                         "--online-retrain)")
    ap.add_argument("--corpus-out", default="",
                    help="write the accumulated observation corpus (JSONL) "
                         "after serving (requires --online-retrain)")
    ap.add_argument("--tree-out", default="",
                    help="write the final (possibly online-retrained) "
                         "decision tree JSON after serving")
    ap.add_argument("--telemetry", action="store_true",
                    help="enable the serve telemetry subsystem (span "
                         "tracer, step metrics ring, latency sketches) "
                         "without any file exports; implied by "
                         "--trace-out/--metrics-out/--log-out.  Greedy "
                         "output stays bit-identical with telemetry on")
    ap.add_argument("--trace-out", default="",
                    help="write the request span trace as Chrome "
                         "trace-event JSON after serving (load in "
                         "Perfetto / chrome://tracing; enables telemetry)")
    ap.add_argument("--metrics-out", default="",
                    help="write a Prometheus text-exposition metrics "
                         "snapshot after serving (enables telemetry)")
    ap.add_argument("--log-out", default="",
                    help="stream structured telemetry events as JSONL to "
                         "this file while serving (enables telemetry)")
    ap.add_argument("--log-level", choices=("debug", "info", "warning"),
                    default="info",
                    help="telemetry event threshold: debug adds per-step "
                         "and per-injection events, warning keeps only "
                         "health transitions")
    ap.add_argument("--deadline-s", type=float, default=0.0)
    ap.add_argument("--max-queue", type=int, default=0)
    ap.add_argument("--chaos-rate", type=float, default=0.0)
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="serve the trace once to warm up, then again "
                         "under torch.profiler, and print where the time "
                         "went")
    ap.add_argument("--profile-top", type=int, default=12,
                    help="device kernels and host ops --profile lists")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    world = launch_ranks(args, cfg)
    if world == 1:
        return _serve(ap, args, cfg, None)
    from repro_torch.serve.tp import Ranks
    with Ranks(cfg, world, args.device) as ranks:
        print(f"[tp] {ranks.line()}")
        return _serve(ap, args, cfg, ranks)


def launch_ranks(args, cfg) -> int:
    """The ranks ``--tp`` starts: the wanted degree (the widest candidate,
    4, for 'auto') clamped down to one rank a visible card on cuda and to
    a divisor of the kv-head count, as the engine clamps; 1 where no
    paged pool would shard (the slot pool, the static baseline)."""
    want = 4 if args.tp == "auto" else int(args.tp)
    paged = (cfg.family in ("dense", "moe", "vlm") and not cfg.swa_window
             and args.paged != "off" and args.mode == "continuous")
    if want == 1 or not paged:
        return 1
    cards = (torch.cuda.device_count() if torch.device(args.device).type
             == "cuda" else want)
    kvh = cfg.n_kv_heads or 1
    tp = want
    while tp > 1 and (tp > cards or kvh % tp):
        tp -= 1
    return tp


def _serve(ap, args, cfg, ranks):
    """Build the engine (rank 0's, over ``ranks`` when there are any),
    serve the trace and print the report."""
    model = model_mod.build(cfg)
    dtype = getattr(torch, args.dtype)
    device = ranks.device if ranks is not None else args.device
    params = model.init(args.seed, dtype=dtype, device=device)
    plan = RegionPlan(region_configs={"layer/attn": RegionConfig(
        attn_impl="paged" if args.attn_impl == "paged" else "")})
    max_len = (args.max_len
               or max(args.prompt_len, args.prompt_max) + args.gen_max + 1)
    dtree = None
    if args.dtree:
        from repro_torch.core.dtree import DecisionTree
        with open(args.dtree) as f:
            dtree = DecisionTree.from_json(f.read())
    engine = Engine(model, params, plan=plan, device=args.device,
                    dtree=dtree, ranks=ranks, serve_cfg=ServeConfig(
        max_len=max_len, temperature=args.temperature, seed=args.seed,
        max_slots=args.slots, eos_id=args.eos_id,
        prefill_bucket=args.prefill_bucket, paged=args.paged,
        scan_mode=args.scan_mode,
        page_size=args.page_size, kv_pages=args.kv_pages,
        prefill_chunk=args.prefill_chunk,
        reservation=args.reservation, mem_watermark=args.mem_watermark,
        max_preempts=args.max_preempts, prefix_cache=args.prefix_cache,
        spec_depth=-1 if args.spec_depth == "auto" else int(args.spec_depth),
        tp=0 if args.tp == "auto" else int(args.tp),
        online_retrain=args.online_retrain,
        retrain_interval=args.retrain_interval,
        explore_eps=0.0 if args.no_explore else args.explore_eps,
        explore_budget=args.explore_budget,
        deadline_s=args.deadline_s, max_queue=args.max_queue,
        chaos_rate=args.chaos_rate, chaos_seed=args.chaos_seed,
        telemetry=args.telemetry, trace_out=args.trace_out,
        metrics_out=args.metrics_out, log_out=args.log_out,
        log_level=args.log_level))

    # explicit serve knobs must route or reject, never silently drop: on
    # the slot pool chunked prefill and speculation need recurrent state
    recurrent = cfg.family in ("ssm", "hybrid") and not cfg.swa_window
    if args.scan_mode != "auto" and not recurrent:
        ap.error(f"--scan-mode {args.scan_mode}: only the recurrent "
                 f"families (ssm/hybrid) have a chunk/fused kernel "
                 f"choice; {args.arch} is family={cfg.family!r}")
    if (args.mode == "continuous" and not engine._use_paged()
            and not recurrent):
        if args.prefill_chunk > 0:
            ap.error(f"--prefill-chunk: chunked prefill on the slot pool "
                     f"requires a recurrent family (ssm/hybrid, no "
                     f"sliding window); {args.arch} is "
                     f"family={cfg.family!r}")
        if args.spec_depth not in ("auto", "0"):
            ap.error(f"--spec-depth {args.spec_depth}: the slot pool can "
                     f"only roll back rejected drafts via recurrent-state "
                     f"snapshots (ssm/hybrid, no sliding window); "
                     f"{args.arch} is family={cfg.family!r}")

    if (args.corpus_in or args.corpus_out) and engine.corpus is None:
        print("[autotune] warning: --corpus-in/--corpus-out need "
              "--online-retrain (no corpus exists without it) — ignoring")
    if args.corpus_in and engine.corpus is not None:
        from repro_torch.autotune.corpus import Corpus
        engine.corpus.merge(Corpus.load_jsonl(args.corpus_in))

    reqs = build_trace(args, cfg.vocab_size)
    if args.mode == "static":
        res = run_static(engine, reqs, args.slots)
    elif args.profile:
        engine.serve(build_trace(args, cfg.vocab_size))     # warm-up
        res = profile_serve(engine, reqs, top=args.profile_top)
    else:
        res = engine.serve(reqs)
    for n_active, decisions in res.get("decisions", []):
        print(f"[plan] load={n_active}: " + ", ".join(
            f"{r}->{c}" for r, c in decisions))

    for r in reqs:
        tail = (f"latency {(r.t_done - r.arrival_s)*1e3:7.1f} ms"
                if r.state.value == "done" else
                f"{r.state.value}" + (f" ({r.error})" if r.error else ""))
        print(f"req {r.rid:3d} arrive {r.arrival_s*1e3:7.1f} ms  "
              f"gen {len(r.out_tokens):3d} tok  " + tail)
    s = res["stats"]
    print(f"{args.mode} [{engine.device}]: {s['n_done']} requests, "
          f"{s['tokens']} tokens in {s['wall_s']:.2f} s -> "
          f"{s['tok_per_s']:.1f} tok/s  "
          f"p50 {s['latency_p50_s']*1e3:.0f} ms  "
          f"p99 {s['latency_p99_s']*1e3:.0f} ms")
    if args.mode == "static":
        if engine.telemetry is not None:
            engine.telemetry.close()
        return res
    fl = res["failures"]
    hs = res["health"]
    if any(fl.get(k, 0) for k in ("failed", "expired", "rejected", "retries")):
        print(f"[failures] failed={fl['failed']} expired={fl['expired']} "
              f"rejected={fl['rejected']} retries={fl['retries']} "
              f"health={hs.get('state', 'n/a')} "
              f"fallbacks={hs.get('fallbacks', 0)}")
    pool = engine._pool
    if engine._paged:
        mesh_info = res.get("mesh", {})
        if mesh_info:
            print(f"[mesh] tp={mesh_info['tp']} "
                  f"devices={mesh_info['devices']} "
                  f"hbm_per_device="
                  f"{mesh_info['hbm_bytes_per_device']/2**20:.1f} MiB "
                  f"high_water_per_device="
                  f"{mesh_info['high_water_bytes_per_device']/2**20:.1f} "
                  f"MiB")
        print(f"[paged] attn={args.attn_impl} page_size={pool.page_size} "
              f"pages={pool.n_pages} pool={pool.hbm_bytes()/2**20:.1f} MiB "
              f"high-water={pool.high_water_bytes()/2**20:.1f} MiB "
              f"({pool.allocator.high_water} pages) "
              f"leaks={res['page_leaks']}")
    else:
        mem = res["memory"]
        print(f"[pool] slots={pool.n_slots} "
              f"slot={mem['slot_bytes']/2**20:.2f} MiB "
              f"pool={mem['hbm_bytes']/2**20:.1f} MiB "
              f"high-water={mem['high_water_bytes']/2**20:.1f} MiB "
              f"({mem['high_water_slots']} slots)")
        if recurrent:
            print(f"[scan] mode={args.scan_mode} resolved: prefill="
                  f"{engine.scan_mode_for(engine._decided_plan, 'prefill')} "
                  f"decode={engine.scan_mode_for(engine._decided_plan)}")
    sp = res["spec"]
    if sp["max_depth"] > 0:
        print(f"[spec] depth={sp['max_depth']} committed "
              f"{sp['committed_tokens']} tokens in {res['steps']} steps "
              f"-> {sp['tokens_per_step']:.2f} tokens/step")
    if args.online_retrain:
        at = res["autotune"]
        print(f"[autotune] retrains={at['retrains']} swaps={at['swaps']} "
              f"rejected={engine.trainer.reject_count} "
              f"explored={at['explored']} "
              f"explore_fraction={at['explore_fraction']:.2f} "
              f"corpus_entries={at['corpus_entries']} "
              f"pre_swap_tok_s={at['pre_swap_tok_s']:.1f} "
              f"post_swap_tok_s={at['post_swap_tok_s']:.1f}")
    if engine.telemetry is not None:
        tm = res.get("telemetry", {})
        lat = tm.get("step_latency_s", {})
        qd = tm.get("queue_delay_s", {})
        print(f"[telemetry] level={tm.get('level', args.log_level)} "
              f"spans={tm.get('spans', 0)} "
              f"(dropped={tm.get('spans_dropped', 0)}) "
              f"events={tm.get('events', 0)} "
              f"ring={tm.get('ring', {}).get('kept', 0)}/"
              f"{tm.get('ring', {}).get('steps', 0)} steps  "
              f"step p50 {lat.get('p50', 0.0)*1e3:.1f} ms "
              f"p99 {lat.get('p99', 0.0)*1e3:.1f} ms  "
              f"queue p99 {qd.get('p99', 0.0)*1e3:.1f} ms")
        if args.trace_out:
            print(f"[telemetry] trace -> {args.trace_out} (Perfetto / "
                  f"chrome://tracing)")
        if args.metrics_out:
            print(f"[telemetry] metrics -> {args.metrics_out} "
                  f"(Prometheus text)")
        if args.log_out:
            print(f"[telemetry] events -> {args.log_out} (JSONL)")
        engine.telemetry.close()
    if args.corpus_out and engine.corpus is not None:
        n = engine.corpus.save_jsonl(args.corpus_out)
        print(f"[autotune] corpus -> {args.corpus_out} ({n} entries)")
    if args.tree_out and engine.dtree is not None:
        with open(args.tree_out, "w") as f:
            f.write(engine.dtree.to_json())
        print(f"[autotune] dtree -> {args.tree_out}")
    return res


def cli(argv=None) -> int:
    """Process entry point: 0 = every request completed; 1 = some requests
    ended FAILED / EXPIRED / REJECTED.  An exception escaping ``serve()``
    (an engine abort, a feature not ported yet) propagates."""
    res = main(argv)
    fl = res.get("failures", {})
    bad = sum(fl.get(k, 0) for k in ("failed", "expired", "rejected"))
    if bad:
        print(f"[exit] {bad} request(s) not served", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(cli())
