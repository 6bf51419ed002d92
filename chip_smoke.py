#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU.  Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero and nothing is passed over:

1. card: the GPU's name and power limit (nvidia-smi), then every kernel is
   built from ``src/repro_torch/kernels/csrc`` with nvcc, and timed.
2. kernel: each CUDA kernel against its plain PyTorch version on the card,
   at the main path's shapes, with the kernel's time, the plain version's
   time, one library call's time and the bound (the least time the card
   could take for the same work).
3. parity: full-width stablelm-1.6b in f32, one paged decode step through
   the kernel against the gather path: logits and greedy tokens.
4. serve: full-width stablelm-1.6b in bf16, random weights from a seeded
   torch.Generator, served by the paged engine with attn_impl='paged' at
   spec_depth 0 and 2 — the main path.  Every request must finish, the
   kernel's launches must equal decode steps x layers, no safe-plan
   fallback and no leaked page.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

ARCH = "stablelm-1.6b"
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bandwidth, f32 outside the
# tensor cores, bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
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


def time_ms(torch, fn, iters: int = 30, flush_mb: int = 128) -> float:
    """Median device time of ``fn`` over ``iters`` runs, each after the L2
    cache was flushed by writing a buffer larger than it: in the decode
    step each layer's K/V comes cold from device memory."""
    flush = torch.empty(flush_mb << 20, dtype=torch.uint8, device="cuda")
    fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


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


def paged_work(q, block_tables, lengths, S, dtype_name):
    """Bytes the function must move and operations it must do for these
    inputs: q read and the output written once, the block tables and
    lengths, and the K/V rows of the positions each slot's last query
    sees; QK and PV are 2 * HD operations per visible (query, position)."""
    B, _, KVH, G, HD = q.shape
    item = q.element_size()
    lens = [int(x) for x in lengths.cpu()]
    rows = sum(n + S - 1 for n in lens if n + S - 1 > 0)
    bytes_ = (2 * q.numel() * item + rows * 2 * KVH * HD * item
              + 4 * (block_tables.numel() + lengths.numel()))
    ops = sum(4 * HD * (n + s) * KVH * G for n in lens for s in range(S))
    t_bytes = bytes_ / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def kernel_phase(torch) -> dict:
    from library_yardsticks import dense_paged_inputs, paged_attention_library
    from repro_torch.kernels import ops, ref
    B, KVH, G, HD, ps, MP = 8, 32, 1, 64, 16, 64
    record = None
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        rtol, atol = ref.KERNEL_TOL[dtype]
        for S in (1, 3):
            # ragged lengths up to the block table's reach, one zero row
            lengths = [MP * ps - (S - 1), 1000, 777, 512, 300, 64, 17, 0]
            args = paged_inputs(torch, 11 + S, B, S, KVH, G, HD, ps, MP,
                                lengths, dtype)
            want = ref.paged_attention_mq(*args)
            act = args[4] > 0
            for bk in (0, 8):
                got = ops.paged_attention_mq(*args, block_k=bk)
                torch.cuda.synchronize()
                check(got.dtype == dtype and got.shape == args[0].shape,
                      f"kernel output {got.dtype} {tuple(got.shape)}")
                check(bool(torch.isfinite(got.float()).all()),
                      "kernel output not finite (zero-length row included)")
                g, w = got.float()[act], want[act]
                err = float((g - w).abs().max())
                ok = ref.within_tol(g, w, dtype)
                ms = time_ms(torch, lambda: ops.paged_attention_mq(
                    *args, block_k=bk))
                log(f"[kernel] paged_attention_mq {dname} S={S} "
                    f"block_k={bk}: max_abs_err={err:.3e} (tol {atol} + "
                    f"{rtol:.3g} x |plain|, max|plain|="
                    f"{float(w.abs().max()):.3f}) "
                    f"ms={ms:.4f}")
                check(ok, f"paged_attention_mq {dname} S={S} block_k={bk} "
                          f"disagrees with its plain version: {err}")
                if dname == "bfloat16" and S == 1 and bk == 0:
                    # the main path's decode call: time the yardsticks
                    plain_ms = time_ms(
                        torch, lambda: ref.paged_attention_mq(*args))
                    dense = dense_paged_inputs(*args)
                    lib_ms = time_ms(
                        torch, lambda: paged_attention_library(*dense))
                    bound_ms, bound_by = paged_work(args[0], args[3], args[4],
                                                    S, dname)
                    record = {
                        "name": "paged_attention_mq", "route": "cuda",
                        "source": "src/repro_torch/kernels/csrc/"
                                  "paged_attention.cu",
                        "replaces": "src/repro/kernels/paged_attention.py:156",
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": lib_ms,
                        "shape": f"bf16 B={B} S={S} KVH={KVH} G={G} HD={HD} "
                                 f"page_size={ps} max_pages={MP} "
                                 f"lengths={lengths}",
                    }
                    log(f"[kernel] timed config {record['shape']}: "
                        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                        f"library {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
                        f"({bound_by})")
    return record


# ---------------------------------------------------------------------------
# parity and serve phases (also runnable on the CPU at a reduced config)
# ---------------------------------------------------------------------------


def _plan(impl: str):
    from repro_torch.core.policy import RegionConfig, RegionPlan
    return RegionPlan(region_configs={"layer/attn": RegionConfig(
        attn_impl=impl)})


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
    rng = np.random.default_rng(0)
    n = serve["n_requests"]
    plens = rng.integers(serve["prompt"][0], serve["prompt"][1] + 1, n)
    gens = rng.integers(serve["gen"][0], serve["gen"][1] + 1, n)
    prompts = [rng.integers(0, cfg.vocab_size, p).astype(np.int32)
               for p in plens]
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
            f"{res['page_leaks']}")
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


# ---------------------------------------------------------------------------


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
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    card = card_line()
    log(f"[card] {card} | {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import paged_attention as pa
    t0 = time.perf_counter()
    pa.build()
    log(f"[build] paged_attention.cu in {time.perf_counter() - t0:.2f} s "
        f"-> {cuda_build.library_path('paged_attention').name}")
    for line in cuda_build.BUILD_LOG.get("paged_attention", "").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"[build] {line.strip()}")

    record = kernel_phase(torch)
    check(record is not None, "the timed kernel configuration never ran")

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
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
