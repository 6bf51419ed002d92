#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU.  Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero and nothing is passed over:

1. card: the GPU's name and power limit (nvidia-smi), then every kernel
   source of ``src/repro_torch/kernels/csrc`` is built with nvcc, one
   process per source, all at once; registers, spills and shared memory
   are logged.
2. kernel: each CUDA kernel against its plain PyTorch version on the card,
   at the main paths' shapes, with the kernel's time, the plain version's
   time, one library call's time where one exists, and the bound (the
   least time the card could take for the same work).
3. stablelm-1.6b at full width: parity in f32 (one paged decode step
   through the kernel against the gather path: logits and greedy tokens),
   then the paged engine in bf16 with attn_impl='paged' at spec_depth 0
   and 2.  Every request must finish, the kernel's launches must equal
   decode steps x layers, no safe-plan fallback and no leaked page.
4. rwkv6-3b and zamba2-2.7b at full width: parity in f32 (one prefill and
   one decode step through the scan kernels against the plain scans:
   logits and greedy tokens), then the slot pool (paged='off') in bf16,
   once with scan_mode auto at spec_depth 0 and once with scan_mode chunk
   at spec_depth 2.  Every request must finish, both of the family's scan
   kernels launched, and their launches equal to the model calls (pool
   steps, prefills, re-advances) x layers.  (The slot pool has no
   safe-plan fallback to gate on: as in the JAX engine, only the paged
   pool has one.)

Random weights come from a seeded torch.Generator.  The launch counts of
each serve phase are set to 0 just before it and read just after.  The
line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
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
# recurrent serves: prompts whose fed part (prompt[:-1]) is a multiple of
# the chunk length 64 or at most 64 prefill through the chunk kernel, the
# ragged ones (99, 299, 199) through the fused kernel
RECURRENT_SERVE = dict(max_len=1024, max_slots=8, n_requests=16, gen=(32, 64),
                       prompts=(65, 129, 257, 513, 100, 300, 65, 129, 200,
                                257, 100, 513, 300, 65, 129, 200))
# the scan kernels' shapes, (B, T, chunk): decode at 8 slots (T=1, and
# T=3 for a spec_depth 2 verify, chunk 3 in chunk mode), one sequence's
# prefill aligned (T=512) and ragged (T=300); the first entry of each list
# is the timed call of the kernel's record
SCAN_SHAPES = {
    "wkv_fused": [(8, 1, 0), (8, 3, 0), (1, 512, 0), (1, 300, 0)],
    "wkv_chunk": [(1, 512, 64), (8, 3, 3), (1, 300, 64)],
    "ssd_fused": [(8, 1, 0), (8, 3, 0), (1, 512, 0), (1, 300, 0)],
    "ssd_chunk": [(1, 512, 64), (8, 3, 3), (1, 512, 256), (1, 300, 64)],
}
# the families' scan widths (configs/rwkv6_3b.py, configs/zamba2_2_7b.py)
WKV_H, WKV_N = 40, 64
SSD_H, SSD_P, SSD_N = 80, 64, 64


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
    step each layer's K/V comes cold from device memory.  A ~100 us spin
    kernel is queued after the flush, so the host has enqueued ``fn``'s
    launch before the start event runs: a kernel of a few microseconds is
    timed, not the wrapper's host-side enqueue.  A ~50 ms spin and three
    untimed rounds come first, so that the card has left its idle clocks:
    without them a kernel's first shape, timed after the host had left
    the card idle, read 4x slower than a larger shape timed later."""
    flush = torch.empty(flush_mb << 20, dtype=torch.uint8, device="cuda")
    torch.cuda._sleep(100_000_000)
    times = []
    for i in range(iters + 3):
        flush.zero_()
        torch.cuda._sleep(200_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        if i >= 3:
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


def scan_work(name, B, T):
    """The least time in ms the card could take for one scan call, and
    what bounds it.  Bytes: every input read once, the output and final
    state written once (f32).  Operations: the recurrence's own count per
    step and (b, h), with a multiply-add counted as two and an exp as one
    (WKV ~7 N^2, SSD ~5 P N + 2), over f32's 67 TFLOP/s.  The chunked
    forms compute the same function: the chunk length only rearranges the
    work, so it does not enter the bound."""
    if name.startswith("wkv"):
        H, N = WKV_H, WKV_N
        nbytes = 4 * (5 * B * H * T * N + H * N + 2 * B * H * N * N)
        ops = 7 * N * N * T
    else:
        H, P, N = SSD_H, SSD_P, SSD_N
        nbytes = 4 * (2 * B * H * T * P + 2 * B * T * N + B * H * T + H
                      + 2 * B * H * P * N)
        ops = (5 * P * N + 2) * T
    ops *= B * H
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S["float32"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def scan_kernel_phase(torch) -> dict:
    """Each scan kernel against its plain version at every shape of
    SCAN_SHAPES: output and final state within ref.KERNEL_TOL in f32
    (1e-5 + 1e-5 x |plain|: both sum in f32, in different orders).
    Returns the kernels' records, timed at each list's first shape."""
    from repro_torch.kernels import ref
    records = {}
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
            log(f"[scan] {name} B={B} T={T} chunk={chunk}: max_abs_err "
                f"out={errs[0]:.3e} state={errs[1]:.3e} (tol 1e-5 + 1e-5 x "
                f"|plain|, max|plain| out={float(want[0].abs().max()):.3f} "
                f"state={float(want[1].abs().max()):.3f}) ms={ms:.4f}")
            check(ok, f"{name} B={B} T={T} chunk={chunk} disagrees with its "
                      f"plain version: {errs}")
            if i == 0:
                plain_ms = time_ms(torch, plain, iters=5 if T > 64 else 30)
                bound_ms, bound_by = scan_work(name, B, T)
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
                    "library_ms": None,
                    "shape": f"f32 B={B} T={T} chunk={chunk}",
                }
                log(f"[scan] timed {name} {records[name]['shape']}: kernel "
                    f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                    f"{bound_ms:.4f} ms ({bound_by}), library: none")
    return records


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


@contextlib.contextmanager
def plain_scans():
    """Route the models' scans to the plain versions, called directly (on
    CUDA tensors the port's dispatch always launches a kernel): the
    reference side of the full-width parity check."""
    from repro_torch.kernels import ops, ref
    saved = ops.wkv, ops.ssd

    def wkv(r, k, v, w, u, s0, *, mode="fused_recurrent", chunk=64):
        if mode == "chunk":
            return ref.wkv_chunk(r, k, v, w, u, s0, chunk)
        return ref.wkv_linear_scan(r, k, v, w, u, s0)

    def ssd(x, b, c, dt, a, s0, *, mode="fused_recurrent", chunk=64):
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


def recurrent_serve_phase(torch, model, params, dev, kernels,
                          serve=RECURRENT_SERVE) -> dict:
    """The slot-pool path: scan_mode auto at spec_depth 0, then scan_mode
    chunk at spec_depth 2.  Returns the ``kernels``' launch counts over
    both serves (set to 0 just before the first, read after the second)."""
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
        res = eng.serve(reqs)
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
            f"MiB")
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


def recurrent_model_phase(torch, arch, kernels, dev) -> dict:
    """Full-width f32 parity, then the bf16 serves, of one recurrent
    model; returns its kernels' launch counts from the serves."""
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
    launches = recurrent_serve_phase(torch, model, params, dev, kernels)
    del params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------


def build_all(torch) -> None:
    """Build every kernel source at once (one nvcc process each), then load
    the libraries; log each build's registers, spills and shared memory."""
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.kernels import paged_attention as pa
    names = ("paged_attention", "linear_scan")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as ex:
        for name, fut in [(n, ex.submit(cuda_build.build, n))
                          for n in names]:
            fut.result()
    pa.build()
    ls.build()
    log(f"[build] {', '.join(n + '.cu' for n in names)} in "
        f"{time.perf_counter() - t0:.2f} s -> " + ", ".join(
            cuda_build.library_path(n).name for n in names))
    for name in names:
        for line in cuda_build.BUILD_LOG.get(name, "").splitlines():
            if ("registers" in line or "spill" in line or "smem" in line
                    or "Compiling entry" in line):
                log(f"[build] {name}: {line.strip()}")


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
    build_all(torch)

    record = kernel_phase(torch)
    check(record is not None, "the timed kernel configuration never ran")
    scan_records = scan_kernel_phase(torch)

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
    del model, params
    torch.cuda.empty_cache()

    for arch, kernels in (("rwkv6-3b", ("wkv_fused", "wkv_chunk")),
                          ("zamba2-2.7b", ("ssd_fused", "ssd_chunk"))):
        launches = recurrent_model_phase(torch, arch, kernels, dev)
        for k in kernels:
            scan_records[k]["launches"] = launches[k]

    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": [record, *scan_records.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
