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

  # reduced config on the CPU (the kernels' plain versions stand in)
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --dtype float32 --attn-impl paged --spec-depth 2
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
from repro_torch.serve.engine import Engine, ServeConfig
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
        prompt = rng.integers(0, vocab_size, args.prompt_len).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=gen,
                            arrival_s=float(arrivals[i])))
    return reqs


def run_static(engine: Engine, reqs: list[Request], slots: int) -> dict:
    """Lockstep baseline: group FIFO into batches of ``slots``, wait for the
    whole group to arrive, decode everyone for the group's longest
    budget."""
    t0 = time.perf_counter()
    for i in range(0, len(reqs), slots):
        group = reqs[i:i + slots]
        wait = max(r.arrival_s for r in group) - (time.perf_counter() - t0)
        if wait > 0:
            time.sleep(wait)
        prompts = np.stack([r.prompt for r in group])
        n_steps = max(r.max_new_tokens for r in group)
        t_gen0 = time.perf_counter() - t0
        res = engine.generate(prompts, n_steps)
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
    device kernels that took it and the host ops that issued them."""
    import collections
    import time

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.regions import REGION_PREFIX
    acts = [ProfilerActivity.CPU]
    on_gpu = engine.device.type == "cuda"
    if on_gpu:
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        # the serve's own span: the profiler's start on entering the block
        # and its stop and event processing on leaving it are not part of it
        t0 = time.perf_counter()
        res = engine.serve(reqs)
        if on_gpu:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if on_gpu:
        # device-side kernels and copies (region annotations excluded):
        # busy time is the union of their intervals
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(REGION_PREFIX)]
        busy, end = 0.0, float("-inf")
        for a, b in sorted((e.time_range.start, e.time_range.end)
                           for e in dev):
            if b > end:
                busy += b - max(a, end)
                end = b
        busy /= 1e6
        print(f"[profile] wall {wall:.3f} s (profiled), device busy "
              f"{busy:.3f} s = {100 * busy / wall:.1f}%, idle "
              f"{100 * (1 - busy / wall):.1f}% "
              f"[{torch.cuda.get_device_name(0)}]")
        by_name: dict = collections.defaultdict(lambda: [0.0, 0])
        for e in dev:
            by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
            by_name[e.name][1] += 1
        for name, (ms, n) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:top]:
            print(f"[profile] device {ms:10.3f} ms {n:7d}x  {name[:90]}")
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
    ap.add_argument("--gen-min", type=int, default=4)
    ap.add_argument("--gen-max", type=int, default=16)
    ap.add_argument("--arrival", choices=("poisson", "staggered", "burst"),
                    default="poisson")
    ap.add_argument("--rate", type=float, default=20.0,
                    help="arrival rate, requests/s (poisson/staggered)")
    ap.add_argument("--slots", type=int, default=4,
                    help="KV pool width / static batch width")
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
                    help="tensor-parallel degree; only 1 is ported yet")
    ap.add_argument("--max-len", type=int, default=0,
                    help="cache length (default: prompt+gen headroom)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--eos-id", type=int, default=-1)
    ap.add_argument("--dtree", default="",
                    help="decision-tree plan selection: not ported yet")
    ap.add_argument("--online-retrain", action="store_true",
                    help="online retraining: not ported yet")
    ap.add_argument("--telemetry", action="store_true",
                    help="serve telemetry: not ported yet")
    ap.add_argument("--deadline-s", type=float, default=0.0)
    ap.add_argument("--max-queue", type=int, default=0)
    ap.add_argument("--chaos-rate", type=float, default=0.0)
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="serve the trace once to warm up, then again "
                         "under torch.profiler, and print where the time "
                         "went")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = model_mod.build(cfg)
    dtype = getattr(torch, args.dtype)
    params = model.init(args.seed, dtype=dtype, device=args.device)
    plan = RegionPlan(region_configs={"layer/attn": RegionConfig(
        attn_impl="paged" if args.attn_impl == "paged" else "")})
    max_len = args.max_len or args.prompt_len + args.gen_max + 1
    engine = Engine(model, params, plan=plan, device=args.device,
                    dtree=args.dtree or None, serve_cfg=ServeConfig(
        max_len=max_len, temperature=args.temperature, seed=args.seed,
        max_slots=args.slots, eos_id=args.eos_id, paged=args.paged,
        scan_mode=args.scan_mode,
        page_size=args.page_size, kv_pages=args.kv_pages,
        prefill_chunk=args.prefill_chunk,
        reservation=args.reservation, mem_watermark=args.mem_watermark,
        max_preempts=args.max_preempts, prefix_cache=args.prefix_cache,
        spec_depth=-1 if args.spec_depth == "auto" else int(args.spec_depth),
        tp=0 if args.tp == "auto" else int(args.tp),
        online_retrain=args.online_retrain, telemetry=args.telemetry,
        deadline_s=args.deadline_s, max_queue=args.max_queue,
        chaos_rate=args.chaos_rate, chaos_seed=args.chaos_seed))

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

    reqs = build_trace(args, cfg.vocab_size)
    if args.mode == "static":
        res = run_static(engine, reqs, args.slots)
    elif args.profile:
        engine.serve(build_trace(args, cfg.vocab_size))     # warm-up
        res = profile_serve(engine, reqs)
    else:
        res = engine.serve(reqs)

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
                  f"{engine.scan_mode_for(engine.plan, 'prefill')} "
                  f"decode={engine.scan_mode_for(engine.plan)}")
    sp = res["spec"]
    if sp["max_depth"] > 0:
        print(f"[spec] depth={sp['max_depth']} committed "
              f"{sp['committed_tokens']} tokens in {res['steps']} steps "
              f"-> {sp['tokens_per_step']:.2f} tokens/step")
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
