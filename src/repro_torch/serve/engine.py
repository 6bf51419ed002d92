"""Serving engine on PyTorch: static lockstep batching plus continuous
batching over the paged KV pool or the slot pool.

:meth:`Engine.generate` is the static path: prefill a ``(B, S)`` batch,
then decode every row in lockstep for a fixed number of steps.

:meth:`Engine.serve` admits requests FIFO from an arrival trace
(:mod:`repro_torch.serve.scheduler`).  Full-KV families run on the paged
pool by default: a :class:`PagedKVPool` under a
:class:`MemoryGovernor`; every pool step decodes all slots at once with a
fixed shape — inactive slots decode against the null page and their
samples are masked — so a request that finishes frees its pages at once
and the next one joins mid-flight.  Prompts prefill in ``prefill_chunk``
pieces interleaved with pool steps.  The decode attention gathers K/V
through the block tables (grouped-GQA einsum) by default, or runs the
paged-attention kernel when the plan sets ``attn_impl='paged'`` on the
attention region.

**Speculative decode** (``spec_depth`` > 0, greedy only): each step
drafts ``spec_depth`` tokens per slot by n-gram lookup over the slot's own
history (:func:`draft_ngram`), one verify step scores pending + drafts for
every slot, the longest drafted prefix matching the verify argmax chain
commits, and the rejected tail is rolled back by length truncation —
greedy output is token-identical to the non-speculative path.

**The slot pool** (``paged='off'``, and every family whose per-request
state does not grow with the sequence: the recurrent ssm/hybrid families
and sliding-window rings): whole caches on a slot axis in a
:class:`SlotKVPool`, the model's ``decode_step`` batched over the slots
with a per-slot position, prompts prefilled one slot at a time (whole, or
in ``prefill_chunk`` pieces interleaved with decode steps).  The
recurrent scans run under a resolved ``scan_mode`` per phase (chunk for
prefill, fused for decode, unless pinned), and speculation rolls a
rejected draft back by state snapshot/restore and a re-advance over the
accepted tokens.

**Failure domains**: non-finite logits (the step's finite-logits guard)
and injected faults retry per request with capped backoff and end in
FAILED past ``max_retries``; a window of faults walks the health ladder
HEALTHY -> DEGRADED -> SHEDDING, and a degraded paged engine pins the safe
plan (no speculation, the gather attention path).

Steps run eagerly; the step cache is keyed on the resolved knobs, as in
the JAX package.  Not ported yet, and raising ``NotImplementedError`` when
asked for: decision-tree plan selection and online retraining (ROADMAP
queue 1 item 7), telemetry (item 9), and tensor parallelism (item 14).
"""
from __future__ import annotations

import copy
import dataclasses
import json
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch import DeviceLike, make_generator, resolve_device
from repro_torch.core.policy import RegionConfig, RegionPlan, null_plan
from repro_torch.models import layers as L
from repro_torch.models.model import Model
from repro_torch.serve.cache import PagedKVPool, SlotKVPool, pages_for
from repro_torch.serve.faults import FaultInjector
from repro_torch.serve.health import HealthMonitor, HealthPolicy
from repro_torch.serve.memory import MemoryGovernor, MemoryPolicy
from repro_torch.serve.scheduler import (Request, RequestState, Scheduler,
                                         summarize)


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 512
    temperature: float = 0.0
    seed: int = 0
    # -- continuous batching -------------------------------------------------
    max_slots: int = 4          # max in-flight requests (pool width)
    eos_id: int = -1            # -1: no EOS (per-request eos_id overrides)
    # -- online autotuning (not ported: ROADMAP queue 1 item 7) --------------
    online_retrain: bool = False
    retrain_interval: int = 32
    explore_eps: float = 0.0
    explore_budget: int = 64
    # -- paged KV pool -------------------------------------------------------
    paged: str = "auto"         # "auto": paged wherever the family supports
                                # it; "on": require it; "off": slot pool
    page_size: int = 0          # tokens per KV page (0 = the plan's
                                # attn-region page_size knob, else 16)
    kv_pages: int = 0           # total pages incl. the null page (0 = the
                                # per-slot worst case)
    # -- elastic KV memory (repro_torch.serve.memory.MemoryGovernor) ---------
    reservation: str = "auto"   # "full" / "lazy" / "auto" (plan knob, else
                                # full)
    mem_watermark: float = -1.0  # lazy-admission free-page high watermark
                                 # fraction (-1 = auto: plan knob, else 0.1)
    max_preempts: int = 4       # per-request eviction cap
    prefix_cache: str = "auto"  # cross-request KV prefix sharing: "on" /
                                # "off" / "auto" (plan knob, else off)
    prefill_chunk: int = 0      # chunked prefill piece size (0 = whole
                                # prompt in one chunk)
    prefill_chunks_per_step: int = 1   # prefill chunks interleaved between
                                       # consecutive pool decode steps
    # -- speculative decode (greedy only) ------------------------------------
    spec_depth: int = -1        # draft tokens per pool step: -1 = auto (the
                                # plan's attn-region spec_depth knob); 0 =
                                # off; N>0 fixed
    # -- recurrent scan mode (slot pool, ssm/hybrid families) ----------------
    scan_mode: str = "auto"     # wkv/ssd kernel variant: "chunk" /
                                # "fused_recurrent" pin it for both phases;
                                # "auto" = the plan's scan-region knob,
                                # unset = chunk for prefill, fused for
                                # decode.  Greedy output agrees across
                                # modes (f32 reassociation only)
    # -- tensor parallelism (degrees > 1 not ported: item 14) ----------------
    tp: int = 0                 # 0 = auto (plan knob, else 1); N pins it
    # -- failure domains + graceful degradation (serve/{faults,health}.py) ---
    deadline_s: float = 0.0     # default time-to-admission budget (0 = none)
    max_queue: int = 0          # bound on the waiting queue (0 = unbounded)
    max_retries: int = 3        # consecutive faulted steps before FAILED
    watchdog_s: float = 0.0     # per-step wall-clock budget (0 = off)
    chaos_rate: float = 0.0     # fault-injection probability per site draw
    chaos_seed: int = 0         # FaultInjector stream seed
    chaos_sites: tuple = ()     # subset of faults.FAULT_SITES (empty = all)
    # -- telemetry (not ported: ROADMAP queue 1 item 9) ----------------------
    telemetry: bool = False
    trace_out: str = ""
    metrics_out: str = ""
    log_out: str = ""
    log_level: str = "info"


def sample_rows(logits: torch.Tensor, gen: torch.Generator,
                temperature: float) -> torch.Tensor:
    """THE sampler: (N, V) float32 logits -> (N,) int32 token per row —
    greedy argmax (first maximum on ties) at temperature <= 0, else one
    categorical draw per row from ``gen``."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


def draft_ngram(history: np.ndarray, depth: int, *, max_ngram: int = 3,
                window: int = 512) -> np.ndarray:
    """Self-speculative draft: propose ``depth`` tokens by n-gram lookup
    over the request's own token history (prompt + generated output — no
    second model).  Finds the most recent earlier occurrence of the
    current suffix (longest n first) and copies the tokens that followed
    it; with no match — or to pad a short match — it repeats the last
    token.  A bad draft costs only wasted verify compute, never a wrong
    token (the verify step's argmax chain is the ground truth)."""
    history = history[-window:]
    H = history.size
    out = np.full((depth,), history[-1], np.int32)
    for n in range(min(max_ngram, H - 1), 0, -1):
        windows = np.lib.stride_tricks.sliding_window_view(history, n)[:-1]
        hits = np.flatnonzero((windows == history[H - n:]).all(axis=1))
        if hits.size:
            i = int(hits[-1])             # most recent earlier occurrence
            cont = history[i + n:i + n + depth]
            out[:cont.size] = cont
            if cont.size < depth:
                out[cont.size:] = cont[-1]
            return out
    return out


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP queue 1 item "
        f"{item})")


class Engine:
    def __init__(self, model: Model, params, plan: Optional[RegionPlan] = None,
                 serve_cfg: Optional[ServeConfig] = None, dtree=None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = model
        self.plan = plan or null_plan()
        # a fresh ServeConfig per Engine (a dataclass default instance would
        # be shared by every Engine and mutate across instances)
        self.cfg = serve_cfg if serve_cfg is not None else ServeConfig()
        cfg = self.cfg
        if dtree is not None:
            raise _not_ported("decision-tree plan selection (dtree)", 7)
        if cfg.online_retrain or cfg.explore_eps > 0:
            raise _not_ported("online retraining / exploration", 7)
        if cfg.telemetry or cfg.trace_out or cfg.metrics_out or cfg.log_out:
            raise _not_ported("serve telemetry", 9)
        if cfg.tp > 1:
            raise _not_ported("tensor-parallel serving (tp > 1)", 14)
        self.params = L.tree_map(lambda t: t.to(self.device), params)

        # -- pool state (built lazily by _ensure_pool) -----------------------
        self._pool = None                           # PagedKVPool / SlotKVPool
        self._paged = False
        self.governor: Optional[MemoryGovernor] = None
        self._pool_steps: dict = {}                 # key -> (step, depth, tp)
        self._pool_step = None
        self._spec_depth = 0                        # depth of _pool_step

        # -- failure domains + graceful degradation --------------------------
        self.faults = None                          # FaultInjector or None
        if cfg.chaos_rate > 0:
            self.faults = FaultInjector(seed=cfg.chaos_seed,
                                        rate=cfg.chaos_rate,
                                        sites=cfg.chaos_sites or None)
        self.health = HealthMonitor(HealthPolicy(
            max_retries=cfg.max_retries, watchdog_s=cfg.watchdog_s))
        self._force_safe = False                    # pin spec0/gather
        self._fallback = None                       # (step, depth, tp) to
                                                    # restore on recovery

    def _sync(self) -> None:
        """Wait for the device (host clocks around device work)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # Static lockstep batching (the baseline path)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def generate(self, prompts, n_steps: int,
                 extra_inputs: Optional[dict] = None) -> dict:
        """prompts: (B, S) int -> generated (B, n_steps) int32 + stats."""
        batch = {"tokens": torch.as_tensor(prompts, device=self.device)}
        if extra_inputs:
            batch.update(extra_inputs)
        t0 = time.perf_counter()
        logits, cache = self.model.prefill(self.params, batch, self.plan,
                                           max_len=self.cfg.max_len)
        self._sync()
        t_prefill = time.perf_counter() - t0

        gen = make_generator(self.device, self.cfg.seed)
        sample = lambda lg: sample_rows(  # noqa: E731
            lg[:, -1, :].float(), gen, self.cfg.temperature)
        tok = sample(logits)
        out = [tok]
        t0 = time.perf_counter()
        for _ in range(n_steps - 1):
            logits, cache = self.model.decode(self.params, cache,
                                              tok[:, None], self.plan)
            tok = sample(logits)
            out.append(tok)
        self._sync()
        t_decode = time.perf_counter() - t0
        B = batch["tokens"].shape[0]
        return {
            "tokens": torch.stack(out, dim=1),
            "prefill_s": t_prefill,
            "decode_s": t_decode,
            "decode_tok_per_s": B * max(n_steps - 1, 1) / max(t_decode, 1e-9),
        }

    # ------------------------------------------------------------------
    # Knob resolution (ServeConfig pin > plan's attn-region knob > default)
    # ------------------------------------------------------------------
    def _param_dtype(self) -> torch.dtype:
        return L.tree_leaves(self.params)[0].dtype

    def page_size(self) -> int:
        """ServeConfig overrides the plan's attention-region knob, which
        overrides the default.  Consulted once, at pool build."""
        rc = self.plan.config_for("layer0/attn")
        return self.cfg.page_size or rc.page_size or 16

    def _spec_pool_ok(self) -> bool:
        """Whether the live pool can roll back a rejected draft: the paged
        pool truncates lengths; the slot pool snapshots/restores fixed-size
        recurrent state (ssm/hybrid without a sliding window).  A ring or a
        growing slot KV cache has no such rollback."""
        if self._paged:
            return True
        cfg = self.model.cfg
        return cfg.family in ("ssm", "hybrid") and not cfg.swa_window

    def _spec_knob_live(self) -> bool:
        """Whether spec_depth is the plan's to choose: auto mode, greedy
        sampling, non-MoE, on a pool that can roll a rejected draft back."""
        return (self._spec_pool_ok() and self.cfg.spec_depth < 0
                and self.cfg.temperature <= 0
                and not self.model.cfg.n_experts)

    def spec_depth_for(self, plan: RegionPlan) -> int:
        """An explicit ServeConfig value pins it; in auto mode the plan's
        attn-region knob decides; unset means off.  A degraded engine
        (``_force_safe``) pins 0 ahead of everything, and temperature
        sampling, MoE or a pool with no rollback pin 0 regardless."""
        if self._force_safe:
            return 0
        if self.cfg.temperature > 0 or self.model.cfg.n_experts:
            return 0
        if not self._spec_pool_ok():
            return 0
        if self.cfg.spec_depth >= 0:
            return self.cfg.spec_depth
        return max(plan.config_for("layer0/attn").spec_depth, 0)

    # -- recurrent scan-mode resolution (slot pool, ssm/hybrid) --------------
    def _scan_region(self) -> str:
        """The region whose scan_mode knob steers the recurrent kernels:
        rwkv6's time-mix for the ssm family, the mamba block for hybrid."""
        return "layer0/tmix" if self.model.cfg.family == "ssm" else "layer0/ssm"

    def scan_mode_for(self, plan: RegionPlan, phase: str = "decode") -> str:
        """An explicit ServeConfig value pins it; in auto mode the plan's
        scan-region knob decides; unset falls through to the phase
        heuristic — "chunk" for prefill, "fused_recurrent" for decode.
        Returns "" for families without the choice."""
        if self._paged or self.model.cfg.family not in ("ssm", "hybrid"):
            return ""
        mode = self.cfg.scan_mode
        if mode not in ("chunk", "fused_recurrent"):
            mode = plan.config_for(self._scan_region()).scan_mode or "auto"
        if mode == "auto":
            mode = "chunk" if phase == "prefill" else "fused_recurrent"
        return mode

    def _plan_with_scan_mode(self, plan: RegionPlan, mode: str) -> RegionPlan:
        """The plan a recurrent step or prefill runs under: ``plan`` with
        the scan region's mode pinned to the resolved choice, so "auto"
        never reaches the model code."""
        if not mode:
            return plan
        plan2 = copy.deepcopy(plan)
        rkey = "layer/tmix" if self.model.cfg.family == "ssm" else "layer/ssm"
        base = plan2.region_configs.get(rkey, RegionConfig())
        plan2.region_configs[rkey] = dataclasses.replace(base, scan_mode=mode)
        return plan2

    def reservation_for(self, plan: RegionPlan) -> str:
        if self.cfg.reservation in ("full", "lazy"):
            return self.cfg.reservation
        return plan.config_for("layer0/attn").reservation or "full"

    def mem_watermark_for(self, plan: RegionPlan) -> float:
        if self.cfg.mem_watermark >= 0:
            return self.cfg.mem_watermark
        wm = plan.config_for("layer0/attn").mem_watermark
        return wm if wm >= 0 else 0.1

    def prefix_cache_for(self, plan: RegionPlan) -> bool:
        """Prefix sharing: ServeConfig pin > plan knob > off; forced off
        for MoE (capacity groups route by token-group length, so
        suffix-only prefill would break bit-identity)."""
        if self.model.cfg.n_experts:
            return False
        if self.cfg.prefix_cache in ("on", "off"):
            return self.cfg.prefix_cache == "on"
        return plan.config_for("layer0/attn").prefix_cache == "on"

    def tp_for(self, plan: RegionPlan) -> int:
        """The resolved tensor-parallel degree: 1 — the only one ported."""
        want = self.cfg.tp if self.cfg.tp > 0 else (
            max(plan.config_for("layer0/attn").tp_degree, 0) or 1)
        if self._force_safe:
            want = 1
        if want > 1:
            raise _not_ported(f"tensor-parallel serving (tp={want})", 14)
        return 1

    def _step_cache_key(self, plan: RegionPlan) -> str:
        """Pool steps are cached by the plan's *step-affecting* content:
        pool-layout and memory-policy knobs are stripped, and the resolved
        spec depth (and tp degree on the paged pool, decode scan mode on
        the slot pool) ride alongside — a degraded engine's safe step
        (depth pinned to 0) never collides with the healthy one cached for
        the same plan, and "auto" shares the step of the mode it resolves
        to."""
        raw = json.loads(plan.to_json())
        for rc in raw.get("regions", {}).values():
            for k in ("page_size", "reservation", "mem_watermark",
                      "prefix_cache", "tp_degree", "scan_mode"):
                rc.pop(k, None)
            if not self._spec_knob_live():
                rc.pop("spec_depth", None)
        if self._paged:
            raw["tp"] = self.tp_for(plan)
        else:
            raw["scan"] = self.scan_mode_for(plan)
        raw["spec"] = self.spec_depth_for(plan)
        return json.dumps(raw, sort_keys=True)

    # ------------------------------------------------------------------
    # Pool and step
    # ------------------------------------------------------------------
    def _use_paged(self) -> bool:
        if self.cfg.paged == "off":
            return False
        if self.cfg.paged == "on":
            if not self.model.supports_paged:
                raise ValueError(
                    f"paged KV unsupported for family "
                    f"{self.model.cfg.family!r} (swa="
                    f"{self.model.cfg.swa_window})")
            return True
        return self.model.supports_paged

    def _ensure_pool(self):
        if self._pool is not None:
            return
        self._paged = self._use_paged()
        if not self._paged:
            self._pool = SlotKVPool(
                self.model.cache_spec(1, self.cfg.max_len,
                                      self._param_dtype()),
                self.cfg.max_slots, device=self.device)
            built = self._build_pool_step(self.plan)
            self._pool_step, self._spec_depth = built[0], built[1]
            self._pool_steps[self._step_cache_key(self.plan)] = built
            return
        ps = self.page_size()
        max_pages = pages_for(self.cfg.max_len, ps)
        n_pages = self.cfg.kv_pages or (self.cfg.max_slots * max_pages + 1)
        self._pool = PagedKVPool(
            self.model.paged_cache_spec(n_pages, ps), self.cfg.max_slots, ps,
            n_pages, max_pages, dtype=self._param_dtype(), device=self.device)
        self.governor = MemoryGovernor(self._pool, MemoryPolicy(
            reservation=self.reservation_for(self.plan),
            watermark=self.mem_watermark_for(self.plan),
            max_preempts=self.cfg.max_preempts))
        self._pool.prefix_enabled = self.prefix_cache_for(self.plan)
        # thread the (optional) fault injector through the paged hot
        # paths; None keeps them zero-overhead
        self._pool.faults = self.faults
        self.governor.faults = self.faults
        built = self._build_paged_step(self.plan)
        self._pool_step, self._spec_depth = built[0], built[1]
        self._pool_steps[self._step_cache_key(self.plan)] = built

    def _sample_pool(self, logits, active, gen, temp):
        """Pool-step sampling via :func:`sample_rows`, masked: rows of
        inactive slots (and non-finite rows, which the health guard rejects
        anyway) are zeroed before the sampler so garbage never reaches it,
        and inactive rows' tokens are pinned to 0."""
        ok = active & torch.isfinite(logits).all(dim=-1)
        logits = torch.where(ok[:, None], logits, torch.zeros_like(logits))
        tok = sample_rows(logits, gen, temp)
        return torch.where(active, tok, torch.zeros_like(tok))

    def _build_pool_step(self, plan: RegionPlan):
        """One decode(+verify)+sample step over the whole slot pool: the
        model's ``decode_step`` batched over the slot axis, each slot at its
        own position (the JAX package vmaps a single-request step).

        The plan's resolved ``spec_depth`` D sets the step's query width
        S = D+1 as on the paged pool; only the recurrent families resolve
        D > 0.  The resolved decode ``scan_mode`` is pinned into the plan
        the step runs under.  The step carries the same health guard as the
        paged step (inactive slots forced healthy).  Returns (step, D,
        tp=1); the step returns ``(tokens (B, S), finite (B,), caches)``,
        the caches to be copied into the pool."""
        model, temp = self.model, self.cfg.temperature
        depth = self.spec_depth_for(plan)
        splan = self._plan_with_scan_mode(plan, self.scan_mode_for(plan))

        def step(params, pool, tokens, active, gen):
            logits, caches = model.decode(params, pool, tokens, splan)
            B, S, V = logits.shape
            flat = logits.float().reshape(B * S, V)
            act = active.repeat_interleave(S)
            finite = (torch.isfinite(flat).all(dim=-1).reshape(B, S)
                      .all(dim=-1) | ~active)
            toks = self._sample_pool(flat, act, gen, temp).reshape(B, S)
            return toks, finite, caches

        return step, depth, 1

    def _slot_advance(self, cache, tokens: np.ndarray, mode: str):
        """Fold ``tokens`` into one request's single-slot cache (logits
        discarded) under scan mode ``mode``: a chunk of chunked state
        prefill, or the re-advance over accepted tokens after a rejected
        draft.  Exact widths: right-padding would be absorbed by
        recurrent state."""
        splan = self._plan_with_scan_mode(self.plan, mode)
        _, cache = self.model.decode(
            self.params, cache,
            torch.as_tensor(np.asarray(tokens, np.int32)[None],
                            device=self.device), splan)
        return cache

    def _prefill_slot(self, prompt: np.ndarray):
        """Fill a fresh single-request cache with prompt[:-1]; the last
        prompt token is returned to be fed through the pool decode step
        (which then yields the first generated token).  Recurrent families
        prefill under the resolved prefill-phase scan mode."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 2:
            return self._pool.empty_slot_cache(), int(prompt[-1])
        plan = self._plan_with_scan_mode(
            self.plan, self.scan_mode_for(self.plan, phase="prefill"))
        _, cache = self.model.prefill(
            self.params, {"tokens": torch.as_tensor(prompt[None, :-1],
                                                    device=self.device)},
            plan, max_len=self.cfg.max_len)
        return cache, int(prompt[-1])

    def _build_paged_step(self, plan: RegionPlan):
        """One decode(+verify)+sample step over the paged pool, natively
        batched over slots.  The plan's resolved ``spec_depth`` D sets the
        step's fixed query width S = D+1.  The step carries the always-on
        health guard: a per-slot ``finite`` flag, False when any of the
        slot's S logit rows holds a NaN/inf; inactive slots decode the null
        page and are forced healthy.  Returns (step, D, tp); the step
        returns ``(tokens (B, S) int32, finite (B,) bool)`` and writes the
        pool's pages in place."""
        model, temp = self.model, self.cfg.temperature
        depth = self.spec_depth_for(plan)
        tp = self.tp_for(plan)

        def step(params, pages, tokens, block_tables, lengths, active, gen):
            logits, _ = model.paged_decode(params, pages, tokens,
                                           block_tables, lengths, plan)
            B, S, V = logits.shape
            flat = logits.float().reshape(B * S, V)
            act = active.repeat_interleave(S)
            finite = (torch.isfinite(flat).all(dim=-1).reshape(B, S)
                      .all(dim=-1) | ~active)
            toks = self._sample_pool(flat, act, gen, temp).reshape(B, S)
            return toks, finite

        return step, depth, tp

    def _validate(self, req: Request):
        cfg = self.model.cfg
        if cfg.family == "ssm" or cfg.swa_window:
            return                  # fixed-size state: no length limit
        need = req.prompt.size - 1 + req.max_new_tokens
        if need > self.cfg.max_len:
            raise ValueError(
                f"request {req.rid}: prompt+generation ({need}) exceeds "
                f"max_len ({self.cfg.max_len})")
        if not self._paged:
            return
        # a demand no admission can ever satisfy would make the FIFO head
        # spin forever — reject it up front
        n = pages_for(need, self._pool.page_size)
        cap = min(self._pool.max_pages_per_slot, self._pool.n_pages - 1)
        if n > cap:
            raise ValueError(
                f"request {req.rid}: needs {n} KV pages but the pool can "
                f"ever grant {cap} (kv_pages={self._pool.n_pages}, "
                f"page_size={self._pool.page_size})")

    # ------------------------------------------------------------------
    # Serving
    # ------------------------------------------------------------------
    @torch.no_grad()
    def serve(self, requests: Sequence[Request]) -> dict:
        """Run a trace of Requests to completion with continuous batching.

        Arrivals are replayed on the wall clock relative to serve() entry;
        requests with arrival_s=0 are all admissible immediately.  Mutates
        the Request objects in place (out_tokens, timings) and returns
        {"requests", "stats", "steps", "failures", "health", "faults",
        "memory", "page_leaks", "spec"}.

        Runtime faults never raise: each faulted request retries with
        capped backoff and, past ``max_retries``, ends FAILED with every
        page released; waiting requests past their deadline (EXPIRED) or
        beyond ``max_queue`` (REJECTED) are shed.  Structurally infeasible
        requests raise before any state exists; an engine-internal error
        aborts the trace after releasing every resident's pages.
        """
        self._ensure_pool()
        for r in requests:
            self._validate(r)
        # fresh health window per trace; a fallback left armed by the
        # previous trace is unwound so this one starts on the live plan
        self.health.reset()
        self._exit_fallback()
        sched = Scheduler()
        for r in requests:
            sched.submit(r)
        sched.sort_queue()
        res = (self._serve_paged(sched) if self._paged
               else self._serve_slots(sched))
        out = {"requests": list(requests), **self.observability(requests)}
        out.update(res)
        return out

    def observability(self, requests: Optional[Sequence[Request]] = None
                      ) -> dict:
        """The per-subsystem ``summary()`` dicts behind one aggregate:
        health, faults, memory (the governor's on the paged pool, slot
        bytes and occupancy high-water on the slot pool) and — when
        ``requests`` is passed — the scheduler's trace stats and failure
        rollup."""
        obs: dict = {
            "health": self.health.summary(),
            "faults": (self.faults.summary() if self.faults is not None
                       else {"enabled": False, "injected_total": 0}),
        }
        if self._paged and self.governor is not None:
            obs["memory"] = self.governor.summary()
        elif self._pool is not None:
            pool = self._pool
            obs["memory"] = {"pool": "slot",
                             "slot_bytes": pool.slot_bytes(),
                             "hbm_bytes": pool.hbm_bytes(),
                             "high_water_slots": pool.high_water,
                             "high_water_bytes": pool.high_water_bytes()}
        if requests is not None:
            stats = summarize(requests)
            obs["stats"] = stats
            obs["failures"] = {
                "failed": stats.get("failed", 0),
                "expired": stats.get("expired", 0),
                "rejected": stats.get("rejected", 0),
                "retries": stats.get("retries", 0),
                "errors": {r.rid: r.error for r in requests if r.error},
            }
        return obs

    # ------------------------------------------------------------------
    # Graceful degradation: the safe-plan fallback
    # ------------------------------------------------------------------
    def _safe_plan(self) -> RegionPlan:
        """The degradation target: the live plan with the attention region
        forced to the boring-but-robust configuration — no speculation,
        the gather (non-kernel) attention path, no tensor parallelism."""
        plan = copy.deepcopy(self.plan)
        base = plan.region_configs.get("layer/attn", RegionConfig())
        plan.region_configs["layer/attn"] = dataclasses.replace(
            base, spec_depth=0, attn_impl="", tp_degree=1)
        return plan

    def _enter_fallback(self):
        """Pin the safe plan (spec0 / gather attn / tp1) through the
        regular step cache; the previous (step, depth, tp) is saved for
        :meth:`_exit_fallback`.  The slot pool has no safe plan to pin."""
        if self._fallback is not None or not self._paged:
            return
        prev = (self._pool_step, self._spec_depth, 1)
        self._force_safe = True
        plan = self._safe_plan()
        key = self._step_cache_key(plan)
        if key not in self._pool_steps:
            self._pool_steps[key] = self._build_paged_step(plan)
        self._pool_step, self._spec_depth, _ = self._pool_steps[key]
        self._fallback = prev
        self.health.taps["fallbacks"] += 1

    def _exit_fallback(self):
        """Recovered: restore the pre-fallback step."""
        if self._fallback is None:
            return
        step, depth, _ = self._fallback
        self._fallback = None
        self._force_safe = False
        self._pool_step, self._spec_depth = step, depth

    def _commit_tokens(self, sched: Scheduler, out_np, n_cand, pending,
                       active, t, on_complete) -> dict:
        """Post-step bookkeeping: walk each active slot's verified token
        chain ``out_np[slot, :n_cand[slot]]`` in order, recording tokens
        until the budget or EOS cuts the chain, then complete and release.
        n_cand=0 marks a slot that sat out this step.  Returns {slot:
        tokens consumed this step} over stepped slots."""
        consumed: dict[int, int] = {}
        for slot in list(sched.active):
            if n_cand[slot] == 0:
                continue
            req = sched.active[slot]
            eos = req.eos_id if req.eos_id is not None else self.cfg.eos_id
            c, done = 0, False
            for i in range(n_cand[slot]):
                tok = int(out_np[slot, i])
                if not req.out_tokens:
                    req.t_first = t
                req.out_tokens.append(tok)
                c += 1
                if len(req.out_tokens) >= req.max_new_tokens or tok == eos:
                    done = True
                    break
            consumed[slot] = c
            if done:
                sched.complete(req, t)
                active[slot] = False
                on_complete(slot, req)
            else:
                pending[slot] = int(out_np[slot, c - 1])
        return consumed

    def _serve_slots(self, sched: Scheduler) -> dict:
        """The slot-pool loop: batched decode over whole-cache slots.

        **Chunked state prefill** (``prefill_chunk`` > 0): the request
        binds mid-prefill (the scheduler's PREFILL lifecycle), its state
        accumulates in a host-held single-slot cache fed ``prefill_chunk``
        tokens at a time under the resolved prefill-phase scan mode, and at
        most ``prefill_chunks_per_step`` chunks run between pool steps.

        **Speculative decode on recurrent state** (resolved ``spec_depth``
        D > 0, greedy only): drafts come from :func:`draft_ngram`, one
        S = D+1 verify step scores every slot at once.  A recurrence has no
        length-truncation rollback, so each slot's state is snapshotted
        (cloned) before the verify step and, when a draft is rejected,
        re-advanced from the snapshot over exactly the inputs whose outputs
        committed.

        Faulted slots (non-finite logits, or chaos-injected) commit
        nothing, restore their pre-step snapshot when one exists, and fail
        terminally past ``max_retries``.  Besides the JAX package's keys the
        result counts the model calls outside the pool steps
        (``slot_calls``: prefill calls and re-advances)."""
        pool = self._pool
        dev = self.device
        B = pool.n_slots
        pending = np.zeros((B,), np.int32)
        active = np.zeros((B,), bool)
        prefills: list[Request] = []        # admitted, mid-prefill (FIFO)
        pcaches: dict[int, Any] = {}        # slot -> host-held prefill cache
        gen = make_generator(dev, self.cfg.seed)
        t0 = time.perf_counter()
        now = lambda: time.perf_counter() - t0  # noqa: E731
        steps = 0
        committed_total = 0                 # tokens committed by decode steps
        slot_steps = 0                      # sum of stepped slots over steps
        max_depth = 0                       # deepest speculation actually run
        calls = {"prefill": 0, "readvance": 0}
        pmode = self.scan_mode_for(self.plan, phase="prefill")
        dmode = self.scan_mode_for(self.plan)

        while not sched.done():
            t = now()
            # admit: every free slot takes the next arrived request (FIFO)
            while pool.n_free and sched.has_ready(t):
                req = sched.pop_ready(t)
                hist = req.token_history()
                slot = pool.alloc()
                if self.cfg.prefill_chunk > 0 and hist.size >= 2:
                    sched.bind_prefill(req, slot, now())
                    pcaches[slot] = pool.empty_slot_cache()
                    req.prefill_pos = 0
                    prefills.append(req)
                else:
                    cache, first_tok = self._prefill_slot(hist)
                    calls["prefill"] += hist.size >= 2
                    pool.write(slot, cache)
                    pending[slot] = first_tok
                    sched.bind(req, slot, now())
                    active[slot] = True
            sched.shed_waiting(now(), self.cfg.max_queue,
                               self.cfg.deadline_s)

            # interleaved chunked prefill: a bounded budget per loop pass
            budget = max(self.cfg.prefill_chunks_per_step, 1)
            while budget > 0 and prefills:
                req = prefills[0]
                slot = req.slot
                feed = req.token_history()[:-1]
                chunk = feed[req.prefill_pos:
                             req.prefill_pos + self.cfg.prefill_chunk]
                pcaches[slot] = self._slot_advance(pcaches[slot], chunk,
                                                   pmode)
                calls["prefill"] += 1
                budget -= 1
                req.prefill_pos += chunk.size
                if req.prefill_pos >= feed.size:
                    pool.write(slot, pcaches.pop(slot))
                    pending[slot] = int(req.token_history()[-1])
                    sched.start_decode(req, now())
                    active[slot] = True
                    prefills.pop(0)

            if not sched.active:
                if prefills:
                    continue                # keep prefilling
                nxt = sched.next_arrival()
                if nxt is None:
                    break
                dt = nxt - now()
                if dt > 0:
                    time.sleep(min(dt, 0.05))
                continue

            t_step0 = time.perf_counter()
            D = self._spec_depth
            S = D + 1
            max_depth = max(max_depth, D)

            toks_in = np.zeros((B, S), np.int32)
            toks_in[:, 0] = pending
            # snapshots make faults (and rejected drafts) recoverable; at
            # D=0 with no injector a non-finite retry would recompute the
            # identical garbage anyway, so the copies are skipped
            snaps: dict[int, Any] = {}
            if D or self.faults is not None:
                for slot, req in sched.active.items():
                    if D:
                        toks_in[slot, 1:] = draft_ngram(req.token_history(),
                                                        D)
                    snaps[slot] = pool.snapshot(slot)
            out, finite, caches = self._pool_step(
                self.params, pool.pool, torch.as_tensor(toks_in, device=dev),
                torch.as_tensor(active, device=dev), gen)
            pool.update(caches)
            steps += 1
            out_np = out.cpu().numpy()
            finite_np = finite.cpu().numpy()

            # per-step health guard + acceptance walk (paged semantics on
            # the slot pool): a faulted slot commits nothing and retries
            # from its pre-step snapshot; draft i is valid iff it equals
            # the verify argmax after draft i-1 (and every earlier draft
            # held) — the longest such prefix commits
            faulted: set[int] = set()
            for slot in list(sched.active):
                if not bool(finite_np[slot]):
                    faulted.add(slot)
            if self.faults is not None:
                for slot in list(sched.active):
                    if slot not in faulted and self.faults.fire("logits.nan"):
                        faulted.add(slot)
            n_cand = np.ones((B,), np.int32)
            slot_steps += len(sched.active)
            for slot in list(sched.active):
                req = sched.active[slot]
                if slot in faulted:
                    n_cand[slot] = 0
                    req.retries += 1
                    req.fail_streak += 1
                    had_snap = slot in snaps
                    if had_snap:
                        pool.restore(slot, snaps.pop(slot))
                    if (req.fail_streak > self.health.policy.max_retries
                            or not had_snap):
                        # no snapshot means no injector and no drafts: the
                        # NaN is the model's own deterministic blowup — a
                        # retry would recompute it bit for bit
                        pool.free(slot)
                        active[slot] = False
                        pending[slot] = 0
                        sched.fail(req, now(),
                                   "non-finite logits on slot pool")
                    continue
                req.fail_streak = 0
                a = 0
                while a < D and toks_in[slot, a + 1] == out_np[slot, a]:
                    a += 1
                n_cand[slot] = a + 1
            consumed = self._commit_tokens(sched, out_np, n_cand, pending,
                                           active, now(),
                                           lambda slot, _req: pool.free(slot))
            committed_total += sum(consumed.values())
            if D:
                for slot, c in consumed.items():
                    if slot in sched.active and c < S:
                        # rejected tail: the state already absorbed the bad
                        # drafts — re-advance the pre-step snapshot over
                        # exactly the c accepted inputs, the state a
                        # sequential decode of the committed tokens holds
                        pool.write(slot, self._slot_advance(
                            snaps[slot], toks_in[slot, :c], dmode))
                        calls["readvance"] += 1
            dt_step = time.perf_counter() - t_step0
            self.health.note_step(dt_step, n_slot_faults=len(faulted))
        return {"steps": steps,
                "slot_calls": calls,
                "spec": {"committed_tokens": committed_total,
                         "slot_steps": slot_steps,
                         "max_depth": max_depth,
                         "accepted_drafts": committed_total - slot_steps,
                         "tokens_per_step":
                             committed_total / max(steps, 1)}}

    def _serve_paged(self, sched: Scheduler) -> dict:
        """The paged-pool loop: governor-mediated admission (full or lazy
        reservation, prefix-cache hits mapped shared), prompt prefill in
        chunks interleaved with pool decode steps, elastic headroom with
        copy-on-write and victim preemption before every step, the
        draft -> verify -> commit/rollback walk, and the per-step health
        guard.  Decode-step inputs are masked per step: only non-stalled
        DECODE slots expose their block table and length."""
        pool = self._pool
        gov = self.governor
        dev = self.device
        B = pool.n_slots
        pending = np.zeros((B,), np.int32)
        active = np.zeros((B,), bool)
        prefills: list[Request] = []        # admitted, mid-prefill (FIFO)
        gen = make_generator(dev, self.cfg.seed)
        t0 = time.perf_counter()
        now = lambda: time.perf_counter() - t0  # noqa: E731
        steps = 0
        committed_total = 0                 # tokens committed by decode steps
        slot_steps = 0                      # sum of stepped slots over steps
        max_depth = 0                       # deepest speculation actually run
        prev_stall: set = set()             # last step's stalled slot set
        # the DECODE-masked block tables change only when pool composition
        # changes (admission / completion / preemption / stall / growth):
        # cache the device copy instead of re-uploading it every step
        bt_dev = {"arr": None, "act": None, "dirty": True}

        def release_slot(slot, req=None):
            # publish the finished request's fully-written pages to the
            # prefix index before unmapping
            if req is not None:
                pool.register_prefix(slot, req.token_history())
            pool.release(slot)
            bt_dev["dirty"] = True

        def preempt_victim(victim):
            """Evict a resident decode: pages back to the allocator, the
            request to the scheduler's preempted queue (re-enters as
            recompute-prefill over its committed history)."""
            sched.preempt(sched.active[victim], now())
            pool.preempt(victim)
            active[victim] = False
            pending[victim] = 0
            bt_dev["dirty"] = True

        def fail_request(slot, req, reason):
            """A resident request exhausted its retries: terminal FAILED
            with every page released; nothing is published."""
            pool.release(slot)
            active[slot] = False
            pending[slot] = 0
            bt_dev["dirty"] = True
            sched.fail(req, now(), reason)

        def admit_ready(t):
            while True:
                req = sched.peek_ready(t)
                if req is None:
                    return
                # SHEDDING: no fresh work while faults are this frequent,
                # unless the pool is empty (nothing to protect)
                if (self.health.shedding
                        and req.state is RequestState.WAITING
                        and (sched.active or sched.prefilling)):
                    return
                # duplicate-arrival dedup: hold a fresh twin of a prompt
                # still mid-prefill until the twin publishes its pages
                if (pool.prefix_enabled
                        and req.state is RequestState.WAITING):
                    pk = req.prompt_key()
                    if any(r.prompt_key() == pk
                           and np.array_equal(r.prompt, req.prompt)
                           for r in sched.prefilling.values()):
                        pool.dedup_holds += 1
                        return
                hist = req.token_history()
                total = req.prompt.size - 1 + req.max_new_tokens
                shared, matched = pool.prefix_lookup(hist)
                if (shared and gov.policy.reservation != "lazy"
                        and matched < len(shared) * pool.page_size):
                    # full reservation stays preemption-free: trim a
                    # partially-adopted boundary page (the only shared page
                    # a request could ever write) and prefill it fresh
                    shared = shared[:-1]
                    matched = len(shared) * pool.page_size
                slot = gov.admit(hist.size, total, shared_pages=shared)
                if slot is None:            # head-of-line waits for memory
                    return
                sched.pop_ready(t)
                sched.bind_prefill(req, slot, now())
                if matched:
                    pool.advance(slot, matched)  # rows adopted, not written
                    pool.prefix_hit_requests += 1
                    pool.prefix_tokens_saved += matched
                    req.prefix_hit_tokens += matched
                req.prefill_pos = matched
                if hist.size - 1 <= matched:     # nothing left to prefill
                    pending[slot] = int(hist[-1])
                    pool.register_prefix(slot, hist)
                    sched.start_decode(req, now())
                    active[slot] = True
                    bt_dev["dirty"] = True
                else:
                    prefills.append(req)

        try:
            while not sched.done():
                admit_ready(now())
                sched.shed_waiting(now(), self.cfg.max_queue,
                                   self.cfg.deadline_s)

                # interleaved chunked prefill: a bounded budget per pass
                budget = max(self.cfg.prefill_chunks_per_step, 1)
                while budget > 0 and prefills:
                    req = prefills[0]
                    slot = req.slot
                    feed = req.token_history()[:-1]
                    C = self.cfg.prefill_chunk or feed.size
                    chunk = feed[req.prefill_pos:req.prefill_pos + C]
                    true_c = chunk.size
                    if true_c < C:
                        chunk = np.pad(chunk, (0, C - true_c))
                    self.model.paged_prefill_chunk(
                        self.params, pool.pages,
                        torch.as_tensor(chunk[None], device=dev),
                        torch.as_tensor(pool.block_tables[slot], device=dev),
                        req.prefill_pos, self.plan)
                    budget -= 1
                    if (self.faults is not None
                            and self.faults.fire("prefill.nan")):
                        # the chunk's K/V is suspect: advance nothing (the
                        # retry rewrites the same rows) and rotate to the
                        # back of the prefill line
                        req.retries += 1
                        req.fail_streak += 1
                        if req.fail_streak > self.health.policy.max_retries:
                            prefills.pop(0)
                            fail_request(slot, req,
                                         "prefill fault past max_retries")
                        else:
                            prefills.append(prefills.pop(0))
                        continue
                    req.fail_streak = 0
                    pool.advance(slot, true_c)
                    req.prefill_pos += true_c
                    if req.prefill_pos >= feed.size:
                        pending[slot] = int(req.token_history()[-1])
                        pool.register_prefix(slot, req.token_history())
                        sched.start_decode(req, now())
                        active[slot] = True
                        bt_dev["dirty"] = True
                        prefills.pop(0)

                if not sched.active:
                    if prefills:
                        continue                # keep prefilling
                    nxt = sched.next_arrival()
                    if nxt is None:
                        break
                    dt = nxt - now()
                    if dt > 0:
                        time.sleep(min(dt, 0.05))
                    continue

                t_step0 = time.perf_counter()
                D = self._spec_depth
                S = D + 1

                # elastic headroom, oldest-admitted first: each stepping
                # slot's next K/V write must land inside private reserved
                # pages; the oldest may evict past the preempt cap, the
                # rest stall when nothing is reclaimable
                stalled: list[int] = []
                grown0 = gov.grown_pages
                cow0 = pool.cow_copies
                order = sorted(sched.active, key=lambda s: (
                    sched.active[s].t_admit or 0.0, sched.active[s].rid))
                for i, slot in enumerate(order):
                    if slot not in sched.active:
                        continue                # taken as an earlier victim
                    req = sched.active[slot]
                    if req.backoff > 0:
                        # capped-backoff retry: sits out like a stall
                        req.backoff -= 1
                        stalled.append(slot)
                        continue
                    cap = req.prompt.size - 1 + req.max_new_tokens
                    while (slot in sched.active
                           and (gov.ensure_headroom(slot, S, cap) < 1
                                or not pool.cow_for_write(slot, S))):
                        victim = gov.pick_victim(
                            sched.active, ignore_cap=(i == 0),
                            younger_than=(req.t_admit or 0.0, req.rid))
                        if victim is None:
                            stalled.append(slot)
                            break
                        preempt_victim(victim)
                stalled = [s for s in stalled if s in sched.active]
                if gov.grown_pages != grown0 or pool.cow_copies != cow0:
                    bt_dev["dirty"] = True      # block-table rows edited
                if sched.active and len(stalled) == len(sched.active):
                    # every decode is out of pages: only resident prefills
                    # can free the jam — keep prefilling, skip the step
                    gov.note_step(len(stalled))
                    continue

                max_depth = max(max_depth, D)
                toks_in = np.zeros((B, S), np.int32)
                toks_in[:, 0] = pending
                if D:
                    for slot, req in sched.active.items():
                        toks_in[slot, 1:] = draft_ngram(req.token_history(),
                                                        D)
                stall_arr = np.zeros((B,), bool)
                stall_arr[stalled] = True
                if set(stalled) != prev_stall:
                    prev_stall = set(stalled)
                    bt_dev["dirty"] = True
                eff = active & ~stall_arr
                if bt_dev["dirty"]:
                    bt_dev["arr"] = torch.as_tensor(
                        (pool.block_tables * eff[:, None]).astype(np.int32),
                        device=dev)
                    bt_dev["act"] = torch.as_tensor(eff, device=dev)
                    bt_dev["dirty"] = False
                out, finite = self._pool_step(
                    self.params, pool.pages,
                    torch.as_tensor(toks_in, device=dev), bt_dev["arr"],
                    torch.as_tensor((pool.lengths * eff).astype(np.int32),
                                    device=dev),
                    bt_dev["act"], gen)
                if (self.faults is not None
                        and self.faults.fire("step.latency")):
                    time.sleep(self.faults.latency_s)
                steps += 1
                gov.note_step(len(stalled))
                out_np = out.cpu().numpy()
                finite_np = finite.cpu().numpy()

                # the per-step health guard: a stepped slot whose logits
                # came back non-finite (or was chaos-flagged) commits
                # NOTHING, so the retry recomputes the very same rows
                faulted: set[int] = set()
                for slot in list(sched.active):
                    if stall_arr[slot] or bool(finite_np[slot]):
                        continue
                    faulted.add(slot)
                if self.faults is not None:
                    for slot in list(sched.active):
                        if (not stall_arr[slot] and slot not in faulted
                                and self.faults.fire("logits.nan")):
                            faulted.add(slot)

                # acceptance walk: draft i is valid iff it equals the
                # verify argmax after draft i-1 (and every earlier draft
                # held) — the longest such prefix commits
                n_cand = np.ones((B,), np.int32)
                written = {}
                slot_steps += len(sched.active) - len(stalled)
                for slot in list(sched.active):
                    if stall_arr[slot]:
                        n_cand[slot] = 0        # sat out: commit nothing
                        continue
                    req = sched.active[slot]
                    if slot in faulted:
                        n_cand[slot] = 0
                        req.retries += 1
                        req.fail_streak += 1
                        if req.fail_streak > self.health.policy.max_retries:
                            fail_request(slot, req,
                                         "non-finite logits past max_retries")
                        else:
                            req.backoff = self.health.policy.backoff(
                                req.fail_streak)
                        continue
                    req.fail_streak = 0
                    len0 = int(pool.lengths[slot])
                    # rows past the slot's reserved pages went to the null
                    # page; cap acceptance before them
                    written[slot] = min(S, pool.reserved_tokens(slot) - len0)
                    pool.advance(slot, written[slot])
                    a = 0
                    while (a < min(D, written[slot] - 1)
                           and toks_in[slot, a + 1] == out_np[slot, a]):
                        a += 1
                    n_cand[slot] = a + 1
                consumed = self._commit_tokens(sched, out_np, n_cand,
                                               pending, active, now(),
                                               release_slot)
                committed_total += sum(consumed.values())
                for slot, c in consumed.items():
                    if slot in sched.active:    # finished slots released
                        pool.rollback(slot, written[slot] - c)
                dt_step = time.perf_counter() - t_step0
                # fold the step into the health ladder, then act on it
                self.health.note_step(dt_step, n_slot_faults=len(faulted))
                if self.health.degraded:
                    self._enter_fallback()
                else:
                    self._exit_fallback()
        except BaseException as e:
            # engine-internal error mid-serve: release every resident's
            # pages (best-effort per slot) and re-raise only after the
            # allocator's invariants are re-checked
            for slot, req in (list(sched.prefilling.items())
                              + list(sched.active.items())):
                try:
                    pool.release(slot)
                except ValueError:
                    pass
                sched.fail(req, now(), f"engine aborted: "
                                       f"{type(e).__name__}: {e}")
            pool.allocator.check_invariants()
            raise
        # serve-end audit: refcounts match owners AND no live page is
        # stranded outside the prefix index
        pool.allocator.check_invariants()
        return {"steps": steps,
                "page_leaks": pool.leaked_pages(),
                "spec": {"committed_tokens": committed_total,
                         "slot_steps": slot_steps,
                         "max_depth": max_depth,
                         "accepted_drafts": committed_total - slot_steps,
                         "tokens_per_step":
                             committed_total / max(steps, 1)}}
