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
pieces interleaved with pool steps — an MoE prompt always in one piece,
since capacity groups route by token-group length, as in the JAX engine.
The decode attention gathers K/V through the block tables (grouped-GQA
einsum) by default, or runs the paged-attention kernel when the plan sets
``attn_impl='paged'`` on the attention region.

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

**The paper loop** (``dtree=``, ``online_retrain``): the decode step's
per-region counters are counted once at pool build, on the meta device
(:func:`repro_torch.core.counters.collect`).  On every change of the load
bucket (or a hot-swapped tree) the :class:`PlanDecider` scales them by the
pool's occupancy and the tree picks each hot region's
:class:`RegionConfig` — speculation depth, attention kernel, memory
policy, scan mode — for both pools.  With ``online_retrain`` a measurement
tap feeds per-bucket step counters and tok/s rewards into a corpus, a
tree is retrained every ``retrain_interval`` steps and hot-swapped in,
and ``explore_eps`` trials serve-only candidates now and then.

**Failure domains**: non-finite logits (the step's finite-logits guard)
and injected faults retry per request with capped backoff and end in
FAILED past ``max_retries``; a window of faults walks the health ladder
HEALTHY -> DEGRADED -> SHEDDING, and a degraded paged engine pins the safe
plan (no speculation, the gather attention path).

**Compiled steps**: the step cache is keyed on the resolved knobs, as in
the JAX package, and on ``cuda`` the three hot steps run as CUDA graphs
(:mod:`repro_torch.serve.graphs`), the counterpart of the JAX package's
``jax.jit(...).compile()``: the paged decode step (one graph per step-cache
key, i.e. per resolved knobs and S = D+1), the paged prefill chunk (one
graph per chunk width when prompts are chunked, ``base`` a device scalar) and
the slot-pool decode step with its pool update.  A graph is captured at
its key's first use, also mid-serve after a replan or the safe-plan
fallback, without touching live state; a failed capture raises.  At
``temperature`` > 0 the graph ends at the guarded logits and the draw runs
after it, from the engine's generator.  Whole-prompt prefill, slot
prefills and re-advances, and everything on the CPU run eagerly; the
counters (meta device) call the step functions directly.

**Telemetry** (``telemetry=True``, or any of ``trace_out`` /
``metrics_out`` / ``log_out``): :mod:`repro_torch.serve.telemetry`'s
request-lifecycle spans, bounded step-metrics ring, latency sketches and
JSONL event log, exported as a Perfetto trace and Prometheus text
(:meth:`Engine.metrics_text`).  Every hook sits in the host serve loop,
never inside a captured graph, and adds no device synchronisation: the
spans time what the loop dispatches, and a decode step's ``dt_s`` ends
after its token readback.  Off, ``Engine.telemetry`` is None and each hot
path pays one ``is not None`` check.

**Tensor parallelism** (``ranks=``, a :class:`repro_torch.serve.tp.Ranks`):
the paged pool and the step shard over the ``model`` axis of a ``(1, tp)``
mesh of ranks, as the JAX engine shards over its devices — pages on the
kv-head axis, params on their logical axes, the vocab-sharded logits
replicated once before sampling.  This process is rank 0 and runs the
host loop; before each device step it broadcasts the step's inputs to the
other ranks (:mod:`repro_torch.serve.tp`).  The degree is a plan knob,
clamped to the ranks and to a kv-head divisor; a change of degree (a
decided switch, the safe-plan fallback's tp 1) reshards the pool and
switches the params copy.  Steps at tp > 1 run eagerly: a gloo collective
cannot be captured in a CUDA graph.  An MoE model shards the same way:
each rank holds its block of the experts and of the router's columns
(the JAX package's ``experts`` -> ``model`` rule), gathers the router's
logits, dispatches the pairs routed to its experts and reduces the
combine over the ranks (:mod:`repro_torch.models.moe`); its decode step
is one flat group, and its whole-prompt prefill goes to the ranks as one
chunk.
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
from repro_torch.autotune.candidates import canonical
from repro_torch.autotune.decider import PlanDecider  # noqa: F401  (re-export)
from repro_torch.core.policy import RegionConfig, RegionPlan, null_plan
from repro_torch.models import layers as L
from repro_torch.models.model import Model
from repro_torch.serve.cache import PagedKVPool, SlotKVPool, pages_for
from repro_torch.serve.faults import FaultInjector
from repro_torch.serve.graphs import StaticInputs, StepGraph
from repro_torch.serve.health import HealthMonitor, HealthPolicy
from repro_torch.serve.memory import MemoryGovernor, MemoryPolicy
from repro_torch.serve.scheduler import (Request, RequestState, Scheduler,
                                         summarize)
from repro_torch.serve.tp import RankState, paged_logits, serve_plan


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 512
    temperature: float = 0.0
    seed: int = 0
    # -- continuous batching -------------------------------------------------
    max_slots: int = 4          # max in-flight requests (pool width)
    eos_id: int = -1            # -1: no EOS (per-request eos_id overrides)
    prefill_bucket: int = 0     # slot path: 0 = exact-length prefill; >0 =
                                # pad the prompt up to a multiple of the
                                # bucket where right-padding is sound (see
                                # Engine._prefill_slot for what it costs)
    autoplan: bool = True       # consult the dtree (when one is supplied)
    autoplan_top_n: int = 2     # hot regions consulted per (re)selection
    # -- online autotuning (repro_torch.autotune: measure -> corpus -> train
    # -> decide) -------------------------------------------------------------
    online_retrain: bool = False   # tap step counters + tok/s rewards into a
                                   # corpus, retrain the dtree, hot-swap it
    retrain_interval: int = 32     # decode steps between retrain attempts
    explore_eps: float = 0.0       # epsilon-greedy exploration over the
                                   # serve-only menu (0 = greedy output
                                   # unchanged)
    explore_budget: int = 64       # hard cap on exploration decisions
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
    # -- tensor parallelism (paged pool; serve/tp.py) ------------------------
    tp: int = 0                 # 0 = auto (plan knob, else 1); N pins it.
                                # The wanted degree clamps down to the
                                # ranks and to a kv-head divisor, as in
                                # the JAX package: 1 without ranks
    # -- failure domains + graceful degradation (serve/{faults,health}.py) ---
    deadline_s: float = 0.0     # default time-to-admission budget (0 = none)
    max_queue: int = 0          # bound on the waiting queue (0 = unbounded)
    max_retries: int = 3        # consecutive faulted steps before FAILED
    watchdog_s: float = 0.0     # per-step wall-clock budget (0 = off)
    chaos_rate: float = 0.0     # fault-injection probability per site draw
    chaos_seed: int = 0         # FaultInjector stream seed
    chaos_sites: tuple = ()     # subset of faults.FAULT_SITES (empty = all)
    # -- telemetry (serve/telemetry.py: spans + metrics ring + exporters) ----
    telemetry: bool = False     # build the Telemetry subsystem (request
                                # span tracing, bounded step-metrics ring,
                                # latency sketches).  Off = the attribute
                                # stays None and every hot path pays one
                                # `is not None` check.  Any of the three
                                # output paths below implies it on
    trace_out: str = ""         # write the last serve()'s Chrome
                                # trace-event JSON (Perfetto-loadable) here
                                # at serve() exit
    metrics_out: str = ""       # write a Prometheus text snapshot
                                # (Engine.metrics_text()) here at serve()
                                # exit
    log_out: str = ""           # stream the structured JSONL event log
                                # here ("" = bounded in-memory buffer only)
    log_level: str = "info"     # event-log threshold: debug/info/warning


def sample_rows(logits: torch.Tensor, gen: torch.Generator,
                temperature: float) -> torch.Tensor:
    """THE sampler: (N, V) float32 logits -> (N,) int32 token per row —
    greedy argmax (first maximum on ties) at temperature <= 0, else one
    categorical draw per row from ``gen``."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


def load_bucket(n_active: int) -> int:
    """Occupancy bucket for replan triggering: the next power of two >=
    n_active (1 for an empty/single-slot pool).  The decider re-runs only
    when the bucket changes, so plan churn is logarithmic in load swings
    while the counters it scales by still track occupancy."""
    return 1 << max(0, n_active - 1).bit_length()


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


#: the serve loop's host spans (prefill, decode step with its readback,
#: re-advance), labelled for ``torch.profiler`` under this prefix
SPAN_PREFIX = "serve."
_span = torch.profiler.record_function


class Engine:
    # class-level defaults so resolution helpers (tp_for/spec_depth_for)
    # stay callable on partially-constructed engine shells (tests stub
    # Engine via object.__new__ to exercise them without a model)
    _force_safe = False                 # pin spec0/gather/tp1
    _fallback = None                    # (step, depth, tp) to restore
    device = torch.device("cpu")
    ranks = None                        # tp.Ranks, or None: one rank

    def __init__(self, model: Model, params, plan: Optional[RegionPlan] = None,
                 serve_cfg: Optional[ServeConfig] = None, dtree=None,
                 device: DeviceLike = None, ranks=None):
        """``ranks``: a :class:`repro_torch.serve.tp.Ranks` this process
        is rank 0 of — the paged pool may then shard over them (its
        device is theirs); None serves on one device."""
        self.device = (resolve_device(device) if ranks is None
                       else ranks.device)
        self.ranks = ranks
        self.model = model
        self.plan = plan or null_plan()
        # a fresh ServeConfig per Engine (a dataclass default instance would
        # be shared by every Engine and mutate across instances)
        self.cfg = serve_cfg if serve_cfg is not None else ServeConfig()
        cfg = self.cfg
        self.params = L.tree_map(lambda t: t.to(self.device), params)
        # the decider is the swappable tree handle (repro_torch.autotune
        # .decider); with online_retrain it exists even before any tree
        # does (cold start: the first retrain swaps one in)
        self.decider: Optional[PlanDecider] = None
        if dtree is not None or cfg.online_retrain:
            self.decider = PlanDecider(dtree)
        self._decider_version: Optional[int] = None   # version at last replan

        # -- pool state (built lazily by _ensure_pool) -----------------------
        self._pool = None                           # PagedKVPool / SlotKVPool
        self._paged = False
        self.governor: Optional[MemoryGovernor] = None
        self._build_step = None                     # plan -> (step, D, tp)
        self._decided_plan = self.plan              # last decider output —
                                                    # prefill-phase knobs
                                                    # (scan_mode) resolve
                                                    # against it at call time
        self._pool_steps: dict = {}                 # key -> (step, depth, tp)
        self._pool_step = None
        self._spec_depth = 0                        # depth of _pool_step
        self._pool_rc = None                        # counters of base step
        self._graphs: dict = {}                     # step or (kind, width)
                                                    # -> StepGraph (cuda)
        self._graph_pool = None                     # their shared memory
        # -- tensor parallelism ----------------------------------------------
        self._serve_tp = 1                          # degree of pages/params
        self._shard: Optional[RankState] = None     # rank 0's share (ranks)
        self._load_bucket: Optional[int] = None
        self.decisions_log: list = []

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

        # -- telemetry (spans + metrics ring + exporters) --------------------
        # same zero-overhead contract as the injector: None unless asked
        # for, and every hot-path touch is one `is not None` check
        self.telemetry = None
        if cfg.telemetry or cfg.trace_out or cfg.metrics_out or cfg.log_out:
            from repro_torch.serve.telemetry import Telemetry
            self.telemetry = Telemetry(level=cfg.log_level,
                                       log_out=cfg.log_out)
        self.health.telemetry = self.telemetry
        if self.faults is not None:
            self.faults.telemetry = self.telemetry

        # -- online autotuning state (measure->corpus->train->decide) --------
        self.corpus = None
        self.trainer = None
        self.explorer = None
        self._init_autotune_state()
        self._tap_region: Optional[str] = None      # hottest attn-ish region
        self._reset_tap_state()

    def _init_autotune_state(self):
        """Fresh corpus/trainer/explorer from the ServeConfig (shared by
        __init__ and autotune_reset so the two can never drift apart)."""
        if not self.cfg.online_retrain:
            return
        from repro_torch.autotune.corpus import Corpus
        from repro_torch.autotune.explorer import EpsilonGreedyExplorer
        from repro_torch.autotune.trainer import OnlineTrainer
        self.corpus = Corpus()
        self.trainer = OnlineTrainer(interval=self.cfg.retrain_interval)
        self.explorer = EpsilonGreedyExplorer(
            eps=self.cfg.explore_eps, budget=self.cfg.explore_budget,
            seed=self.cfg.seed)

    def _reset_tap_state(self):
        """Zero the per-trace measurement-tap accumulators and stats."""
        self._tap_acc: dict = {}        # bucket -> [steps, tokens, secs,
                                        #            prefix lookups, hits]
        self._tap_lat: dict = {}        # bucket -> LatencySketch over the
                                        # window (feeds step_latency_p99)
        self._tap_qd = [0.0, 0]         # window queue-delay [sum_s, n]
                                        # over fresh admissions
        self._tap_pending = 0           # taps since the last flush
        self._tap_prefix_last = None    # (lookups, hits) at the last tap —
                                        # pool counters are monotonic, the
                                        # tap wants per-window deltas
        self._bucket_class: dict = {}   # bucket -> class in effect (tap attn
                                        # region), for reward attribution
        self._exploring = False         # current plan carries an explored class
        self._force_replan = False      # explorer wants a mid-bucket re-decide
        self.autotune_stats = {
            "retrains": 0, "swaps": 0, "explored": 0, "explore_steps": 0,
            "steps": 0, "corpus_entries": 0,
            # tok/s before the first tree swap vs after the last one
            "pre_tokens": 0, "pre_secs": 0.0,
            "post_tokens": 0, "post_secs": 0.0,
        }

    # -- the dtree is the decider's swappable handle -------------------------
    @property
    def dtree(self):
        return self.decider.tree if self.decider is not None else None

    @dtree.setter
    def dtree(self, tree):
        """Assigning a tree routes through PlanDecider.swap, so the version
        bump invalidates the load-bucket replan latch — a tree installed
        mid-bucket takes effect on the very next step."""
        if self.decider is None:
            self.decider = PlanDecider(tree)
        else:
            self.decider.swap(tree)

    def autotune_reset(self, tree=None):
        """Restart the online-autotune loop cold (fresh corpus / trainer /
        explorer / stats, ``tree`` as the incumbent) while keeping built
        pool steps cached."""
        self._init_autotune_state()
        self.dtree = tree               # swap: bumps version, busts the latch
        self._reset_tap_state()

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

    def _n_devices(self) -> int:
        """Devices a tensor-parallel step could span: the engine's ranks
        (one device each, or shares of one), else 1."""
        return self.ranks.world if self.ranks is not None else 1

    def tp_for(self, plan: RegionPlan) -> int:
        """tp-degree resolution, as in the JAX package: an explicit
        ServeConfig value pins it; in auto mode the plan's attn-region
        tp_degree knob (the PlanDecider's tp1/tp2/tp4 channel) decides;
        unset means 1.  The wanted degree then clamps DOWN to the ranks
        the engine may use and to a divisor of the kv-head count
        (:func:`repro_torch.kernels.paged_attention.shard_kv_heads`), so an
        infeasible candidate class degrades to what the host can run — on
        one device, 1.  Every family the paged pool serves, MoE included,
        takes the degree it resolves to."""
        want = self.cfg.tp if self.cfg.tp > 0 else (
            max(plan.config_for("layer0/attn").tp_degree, 0) or 1)
        if self._force_safe:
            want = 1                # degraded: safe plan outranks the pin
        kvh = getattr(self.model.cfg, "n_kv_heads", 0) or 1
        n_dev = self._n_devices()
        tp = max(int(want), 1)
        while tp > 1 and (tp > n_dev or kvh % tp):
            tp -= 1
        from repro_torch.kernels.paged_attention import shard_kv_heads
        shard_kv_heads(kvh, tp)     # the centralised divisibility rule
        return tp

    # -- tensor parallelism: placement of the pool and the params ------------
    def _serve_plan(self, plan: RegionPlan, tp: int) -> RegionPlan:
        """The plan a step at degree ``tp`` runs under
        (:func:`repro_torch.serve.tp.serve_plan`): ``plan`` itself at 1."""
        if tp <= 1:
            return plan
        return serve_plan(plan, self._shard.mesh(tp))

    @property
    def _step_params(self):
        """The params copy matching the current pool placement: this
        rank's shard at tp > 1, ``self.params`` itself at 1."""
        if self._shard is None or self._serve_tp == 1:
            return self.params
        return self._shard.params[self._serve_tp]

    def _apply_tp(self, tp: int) -> None:
        """Reshard the pool's pages and pick the params copy for degree
        ``tp`` (no-op when already there), on every rank: one reshard per
        change of degree.  Graphs captured over the old pages are
        dropped."""
        if self._shard is None or tp == self._serve_tp:
            return
        self.ranks.switch(tp)
        self._shard.switch(tp, fresh=False)
        self._pool.pages = self._shard.pages
        self._pool.tp_shards = tp
        self._serve_tp = tp
        self._graphs.clear()

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
        if self.model.cfg.family == "encdec":
            raise NotImplementedError(
                "continuous batching supports decoder-only families; "
                "use generate() for encdec")
        self._paged = self._use_paged()
        if not self._paged:
            self._pool = SlotKVPool(
                self.model.cache_spec(1, self.cfg.max_len,
                                      self._param_dtype()),
                self.cfg.max_slots, device=self.device)
            self._build_step = self._build_pool_step
            self._install_base_step()
            return
        ps = self.page_size()
        max_pages = pages_for(self.cfg.max_len, ps)
        n_pages = self.cfg.kv_pages or (self.cfg.max_slots * max_pages + 1)
        shapes = self.model.paged_cache_spec(n_pages, ps)
        dtype = self._param_dtype()
        tp = self.tp_for(self.plan)
        if self.ranks is not None:
            # every rank builds its shard of the pool in place: rank 0's
            # geometry and degree go out first, then each rank cuts the
            # page shapes by the kv-head spec
            from repro_torch.distributed.sharding import local_cache_spec
            self._shard = RankState(self.model, 0, self.device,
                                    self.ranks.meshes)
            self._shard.reset(n_pages, ps, dtype, params=self.params)
            self.ranks.init(n_pages, ps, dtype, tp)
            shapes = local_cache_spec(self._serve_plan(self.plan, tp),
                                      shapes)
        self._pool = PagedKVPool(shapes, self.cfg.max_slots, ps, n_pages,
                                 max_pages, dtype=dtype, device=self.device)
        if self._shard is not None:
            self._shard.switch(tp, fresh=True, pages=self._pool.pages)
            self._pool.tp_shards = self._serve_tp = tp
            self._pool.mirror = self.ranks.copy_page
        self.governor = MemoryGovernor(self._pool, MemoryPolicy(
            reservation=self.reservation_for(self.plan),
            watermark=self.mem_watermark_for(self.plan),
            max_preempts=self.cfg.max_preempts))
        self._pool.prefix_enabled = self.prefix_cache_for(self.plan)
        # thread the (optional) fault injector through the paged hot
        # paths; None keeps them zero-overhead
        self._pool.faults = self.faults
        self.governor.faults = self.faults
        self.governor.telemetry = self.telemetry
        self._build_step = self._build_paged_step
        self._install_base_step()

    def _step_args(self, depth: int) -> list:
        """Arguments of one pool step at query width ``depth + 1``, shaped
        as the serve loop passes them (every slot parked: zero tokens,
        block tables and lengths; no slot active)."""
        pool, B, S = self._pool, self._pool.n_slots, depth + 1
        dev = self.device
        toks = torch.zeros((B, S), dtype=torch.int32, device=dev)
        act = torch.zeros((B,), dtype=torch.bool, device=dev)
        if not self._paged:
            return [self.params, pool.pool, toks, act, None]
        return [self._step_params, pool.pages, toks,
                torch.zeros((B, pool.max_pages_per_slot), dtype=torch.int32,
                            device=dev),
                torch.zeros((B,), dtype=torch.int32, device=dev), act, None]

    def _install_base_step(self):
        """Build the step of the engine's plan and, when a decision tree
        (or the online loop) will consult them, count its per-region
        counters once on the meta device — nothing runs, no page is
        written."""
        built = self._build_step(self.plan)
        self._pool_step, self._spec_depth = built[0], built[1]
        self._pool_steps[self._step_cache_key(self.plan)] = built
        if ((self.dtree is not None and self.cfg.autoplan)
                or self.cfg.online_retrain):
            from repro_torch.core import counters as counters_mod
            self._pool_rc = counters_mod.collect(
                self._pool_step, *self._step_args(self._spec_depth))
            # the measurement tap attributes rewards to the hottest
            # attention-ish region (the decider's main lever); fall back to
            # the hottest region of any kind
            tops = self._pool_rc.top_regions("flops", 16)
            attn = [r for r, _ in tops if "attn" in r]
            self._tap_region = (attn[0] if attn
                                else (tops[0][0] if tops else None))

    def _sample_pool(self, logits, active, gen, temp):
        """Pool-step sampling via :func:`sample_rows`, masked: rows of
        inactive slots (and non-finite rows, which the health guard rejects
        anyway) are zeroed before the sampler so garbage never reaches it,
        and inactive rows' tokens are pinned to 0."""
        ok = active & torch.isfinite(logits).all(dim=-1)
        logits = torch.where(ok[:, None], logits, torch.zeros_like(logits))
        tok = sample_rows(logits, gen, temp)
        return torch.where(active, tok, torch.zeros_like(tok))

    @staticmethod
    def _guard(logits: torch.Tensor, active: torch.Tensor):
        """The always-on health guard of a pool step over its (B, S, V)
        logits: the flat f32 rows (B*S, V), each row's slot activity, and a
        per-slot ``finite`` flag, False when any of the slot's S rows holds
        a NaN/inf (inactive slots forced healthy)."""
        B, S, V = logits.shape
        flat = logits.float().reshape(B * S, V)
        act = active[:, None].expand(B, S).reshape(B * S)
        finite = (torch.isfinite(flat).all(dim=-1).reshape(B, S)
                  .all(dim=-1) | ~active)
        return flat, act, finite

    def _draw(self, flat, act, finite, gen):
        """The guarded rows' masked draw -> ``(tokens (B, S), finite)``."""
        toks = self._sample_pool(flat, act, gen, self.cfg.temperature)
        return toks.reshape(finite.shape[0], -1), finite

    def _sampled(self, forward):
        """The pool step made of ``forward`` — the model and the guard,
        returning ``(flat, act, finite, *rest)`` — and the draw: the step
        takes ``forward``'s arguments and a generator and returns
        ``(tokens (B, S), finite, *rest)``.  ``step.forward`` keeps the
        part before the draw: a CUDA graph of a sampling step ends there
        and the draw runs after the replay."""
        def step(*args):
            *args, gen = args
            flat, act, finite, *rest = forward(*args)
            return (*self._draw(flat, act, finite, gen), *rest)

        step.forward = forward
        return step

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
        model = self.model
        depth = self.spec_depth_for(plan)
        splan = self._plan_with_scan_mode(plan, self.scan_mode_for(plan))
        # each slot is a single-request call in the JAX package's vmap, so
        # an MoE layer routes each slot as a group of its own
        kw = {"moe_group": "row"} if model.cfg.n_experts else {}

        def forward(params, pool, tokens, active):
            logits, caches = model.decode(params, pool, tokens, splan, **kw)
            return (*self._guard(logits, active), caches)

        return self._sampled(forward), depth, 1

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

    def _pad_safe(self) -> bool:
        """Right-padding the prompt is sound only for positional full-KV
        caches: pad K/V land at positions >= pos (masked, then overwritten
        by decode writes).  Recurrent state (ssm/hybrid) and sliding-window
        rings would absorb the pads."""
        cfg = self.model.cfg
        return cfg.family in ("dense", "moe", "vlm") and not cfg.swa_window

    def _prefill_slot(self, prompt: np.ndarray):
        """Fill a fresh single-request cache with prompt[:-1]; the last
        prompt token is returned to be fed through the pool decode step
        (which then yields the first generated token).  Recurrent families
        prefill under the resolved prefill-phase scan mode.

        With ``ServeConfig.prefill_bucket`` set, a prompt is right-padded
        up to a multiple of the bucket (capped at max_len) where
        :meth:`_pad_safe`, and the cache's position is set back to the
        true length, so the result is that of exact-length prefill.  The
        JAX package pads to bound the number of compiled prefill shapes;
        an eager step compiles nothing, so here the pads are only extra
        work: up to ``prefill_bucket - 1`` thrown-away positions a prompt."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 2:
            return self._pool.empty_slot_cache(), int(prompt[-1])
        feed = prompt[:-1]
        true_len = feed.size
        if self.cfg.prefill_bucket and self._pad_safe():
            b = self.cfg.prefill_bucket
            padded = min(-(-true_len // b) * b, self.cfg.max_len)
            if padded > true_len:
                feed = np.pad(feed, (0, padded - true_len))
        plan = self._plan_with_scan_mode(
            self.plan, self.scan_mode_for(self._decided_plan,
                                          phase="prefill"))
        _, cache = self.model.prefill(
            self.params, {"tokens": torch.as_tensor(feed[None],
                                                    device=self.device)},
            plan, max_len=self.cfg.max_len)
        cache = dict(cache)
        cache["pos"] = torch.full_like(cache["pos"], true_len)
        return cache, int(prompt[-1])

    def _build_paged_step(self, plan: RegionPlan):
        """One decode(+verify)+sample step over the paged pool, natively
        batched over slots.  The plan's resolved ``spec_depth`` D sets the
        step's fixed query width S = D+1.  The step carries the always-on
        health guard: a per-slot ``finite`` flag, False when any of the
        slot's S logit rows holds a NaN/inf; inactive slots decode the null
        page and are forced healthy.  Returns (step, D, tp); the step
        returns ``(tokens (B, S) int32, finite (B,) bool)`` and writes the
        pool's pages in place.

        The plan's resolved tp degree shards the step over the ranks
        (:meth:`_serve_plan`): pages on kv_heads, params on their logical
        axes, block tables / lengths / tokens the same on every rank.  The
        vocab-sharded logits replicate right before sampling — the step's
        single gather — so the sampler and the host's acceptance walk do
        not depend on the degree."""
        model = self.model
        depth = self.spec_depth_for(plan)
        tp = self.tp_for(plan)
        self._apply_tp(tp)
        splan = self._serve_plan(plan, tp)

        def forward(params, pages, tokens, block_tables, lengths, active):
            logits = paged_logits(model, splan, params, pages, tokens,
                                  block_tables, lengths)
            return self._guard(logits, active)

        step = self._sampled(forward)
        step.plan = plan            # what the other ranks run it under
        return step, depth, tp

    # ------------------------------------------------------------------
    # Running the steps: the step functions on the CPU, their CUDA graphs
    # on cuda (dispatch by device, as the kernels dispatch)
    # ------------------------------------------------------------------
    def _use_graphs(self) -> bool:
        """The hot steps replay as CUDA graphs on ``cuda`` and run as the
        step functions everywhere else, and at tp > 1 (a gloo collective
        cannot be captured)."""
        return self.device.type == "cuda" and self._serve_tp == 1

    def _graph(self, key, fn, specs, warmup=None) -> StepGraph:
        """The graph of ``key``, captured at its first use over fresh
        static inputs of ``specs``, into the engine's shared pool."""
        graph = self._graphs.get(key)
        if graph is None:
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            graph = self._graphs[key] = StepGraph(
                fn, StaticInputs(specs, self.device), warmup=warmup,
                pool=self._graph_pool)
        return graph

    def _graph_outputs(self, out, gen):
        """A decode graph's outputs as ``(tokens, finite)``: greedy steps
        sample inside the graph, the others draw from ``gen`` here."""
        return out if self.cfg.temperature <= 0 else self._draw(*out, gen)

    def _paged_decode(self, toks, bt, lengths, act, gen):
        """One paged pool step of the current step function on host arrays
        (tokens (B, S), block tables (B, MP), lengths (B,), active (B,))
        -> ``(tokens (B, S), finite (B,))`` on the device.  On ``cuda`` the
        step replays its key's graph, captured at first use with every slot
        parked on the null page (the zeroed static inputs)."""
        step, pages, dev = self._pool_step, self._pool.pages, self.device
        if self._serve_tp > 1:
            # the other ranks run the same step on their shards
            self.ranks.decode(step.plan, toks, bt, lengths)
        if not self._use_graphs():
            return step(self._step_params, pages,
                        *(torch.as_tensor(a, device=dev)
                          for a in (toks, bt, lengths, act)), gen)
        fn = (step if self.cfg.temperature <= 0 else step.forward)
        tail = (None,) if fn is step else ()

        def run(*static):
            return fn(self.params, pages, *static, *tail)

        graph = self._graph(step, run, [
            (toks.shape, torch.int32), (bt.shape, torch.int32),
            (lengths.shape, torch.int32), (act.shape, torch.bool)])
        return self._graph_outputs(graph(toks, bt, lengths, act), gen)

    def _slot_decode(self, toks, act, gen):
        """One slot-pool step of the current step function on host arrays
        (tokens (B, S), active (B,)), its caches copied into the pool ->
        ``(tokens (B, S), finite (B,))`` on the device.  On ``cuda`` the
        step and the pool update replay as its key's graph; the warm-up
        before the capture runs on a zeroed copy of the pool, so a capture
        mid-serve leaves every live slot's cache as it was."""
        step, pool, dev = self._pool_step, self._pool, self.device
        if not self._use_graphs():
            out, finite, caches = step(
                self.params, pool.pool, torch.as_tensor(toks, device=dev),
                torch.as_tensor(act, device=dev), gen)
            pool.update(caches)
            return out, finite
        fn = (step if self.cfg.temperature <= 0 else step.forward)
        tail = (None,) if fn is step else ()

        def run(tokens, active):
            *out, caches = fn(self.params, pool.pool, tokens, active, *tail)
            pool.update(caches)
            return tuple(out)

        def warmup(tokens, active):
            scratch = L.tree_map(torch.zeros_like, pool.pool)
            fn(self.params, scratch, tokens, active, *tail)

        graph = self._graph(step, run, [(toks.shape, torch.int32),
                                        (act.shape, torch.bool)],
                            warmup=warmup)
        return self._graph_outputs(graph(toks, act), gen)

    def _chunked_prefill(self) -> bool:
        """Whether the paged pool prefills prompts in ``prefill_chunk``
        pieces.  Never for MoE: capacity groups route by token-group
        length, so a prompt split into chunks would route (and drop)
        tokens differently than whole-prompt prefill, as the JAX engine
        rules."""
        return bool(self.cfg.prefill_chunk) and not self.model.cfg.n_experts

    def _paged_prefill(self, chunk, slot: int, base: int) -> None:
        """Write one prefill chunk of ``slot``'s prompt (host tokens, C of
        them, from absolute position ``base``) into its pages.  On ``cuda``
        with chunked prefill every chunk has the width C, and one graph per
        width serves every slot and chunk index: the block-table row and
        ``base`` are static inputs, ``base`` a device scalar (whole-prompt
        prefill — MoE's always — has one width per prompt and runs
        eagerly)."""
        pool, dev = self._pool, self.device
        if self._serve_tp > 1:
            self.ranks.chunk(self.plan, chunk, pool.block_tables[slot], base)
        if not (self._use_graphs() and self._chunked_prefill()):
            self.model.paged_prefill_chunk(
                self._step_params, pool.pages,
                torch.as_tensor(chunk[None], device=dev),
                torch.as_tensor(pool.block_tables[slot], device=dev), base,
                self._serve_plan(self.plan, self._serve_tp))
            return

        def run(tokens, block_table, base_t):
            self.model.paged_prefill_chunk(self.params, pool.pages, tokens,
                                           block_table, base_t, self.plan)

        bt = pool.block_tables[slot]
        graph = self._graph(("prefill_chunk", chunk.size), run, [
            ((1, chunk.size), torch.int32), (bt.shape, torch.int32),
            ((), torch.int32)])
        graph(chunk[None], bt, base)

    # ------------------------------------------------------------------
    # The paper loop at serve time: counters -> decision tree -> plan
    # ------------------------------------------------------------------
    def _maybe_replan(self, n_active: int):
        """On load-bucket changes — or when the decider's tree was hot-
        swapped (version bump) or the explorer forced a re-decide — re-pick
        the decode plan via the dtree.  Without the version check a freshly
        retrained tree would silently never take effect until the next
        occupancy-bucket change."""
        if self._pool_rc is None or self.decider is None:
            return
        if self._fallback is not None:
            # degraded: the safe plan is pinned; a replan would override
            # it.  Recovery (_exit_fallback) sets _force_replan so the
            # decider re-decides promptly once healthy.
            return
        bucket = load_bucket(n_active)
        if (bucket == self._load_bucket
                and self.decider.version == self._decider_version
                and not self._force_replan):
            return
        self._load_bucket = bucket
        self._decider_version = self.decider.version
        self._force_replan = False
        load_frac = min(bucket, self._pool.n_slots) / self._pool.n_slots
        plan, decisions = self.decider.decide(
            self._pool_rc, self.plan, load_frac=load_frac,
            top_n=self.cfg.autoplan_top_n)
        # reward attribution: the class actually in effect for the tap region
        tap_prefix = (canonical(self._tap_region) if self._tap_region
                      else None)
        cls_in_effect = "keep_default"
        for prefix, cls in decisions:
            if prefix == tap_prefix:
                cls_in_effect = self.decider.applied_class(prefix, cls)
        # epsilon-greedy exploration: override the greedy choice so serve
        # traffic populates classes the offline search never tried
        self._exploring = False
        if self.explorer is not None and tap_prefix is not None:
            explored = self.explorer.maybe_explore(plan, region=tap_prefix)
            if explored is not None:
                cls_in_effect, plan = explored
                decisions = decisions + [(f"explore:{tap_prefix}",
                                          cls_in_effect)]
                self.autotune_stats["explored"] = self.explorer.explored
                self._exploring = True
        # the class for this bucket is changing mid-window: flush the steps
        # accumulated under the OLD class first, or their reward would be
        # credited to the new class at the next _tap_flush
        old_cls = self._bucket_class.get(bucket)
        if (old_cls is not None and old_cls != cls_in_effect
                and bucket in self._tap_acc):
            self._append_bucket_obs(bucket, self._tap_acc.pop(bucket),
                                    old_cls)
        self._bucket_class[bucket] = cls_in_effect
        # memory policy follows the decided (or explored) class for the
        # current bucket — an allocator-policy change, never a new step
        # (the step cache strips the knobs)
        if self.governor is not None:
            self.governor.set_policy(self.reservation_for(plan),
                                     self.mem_watermark_for(plan),
                                     max_preempts=self.cfg.max_preempts)
            self._pool.prefix_enabled = self.prefix_cache_for(plan)
        # prefill-phase knobs (slot scan_mode) resolve against the decided
        # (or explored) plan at call time
        self._decided_plan = plan
        key = self._step_cache_key(plan)
        if key not in self._pool_steps:
            self._pool_steps[key] = self._build_step(plan)
        self._pool_step, self._spec_depth, step_tp = self._pool_steps[key]
        # a cache hit can still be a tp switch (the decider flipping back
        # to a degree it built earlier): reshard the pool and the params
        # to the placement the step runs on
        self._apply_tp(step_tp)
        self.decisions_log.append((n_active, decisions))

    # ------------------------------------------------------------------
    # Online autotuning: the measurement tap (measure -> corpus -> train
    # -> decide, closed inside the serving loop)
    # ------------------------------------------------------------------
    def _tap_step(self, n_active: int, tokens: int, dt_s: float):
        """Record one decode step's work into the per-bucket accumulators;
        every ``retrain_interval`` steps, flush to the corpus and retrain."""
        if self.corpus is None or self._pool_rc is None:
            return
        st = self.autotune_stats
        st["steps"] += 1
        if self._exploring:
            st["explore_steps"] += 1
        seg = "post" if st["swaps"] else "pre"
        st[seg + "_tokens"] += tokens
        st[seg + "_secs"] += dt_s
        bucket = load_bucket(n_active)
        acc = self._tap_acc.setdefault(bucket, [0, 0, 0.0, 0, 0])
        acc[0] += 1
        acc[1] += tokens
        acc[2] += dt_s
        # latency channel: per-bucket step-latency sketch over the window
        lat = self._tap_lat.get(bucket)
        if lat is None:
            from repro_torch.serve.telemetry import LatencySketch
            lat = self._tap_lat[bucket] = LatencySketch()
        lat.add(dt_s)
        # prefix-cache hit-rate channel: per-window deltas of the pool's
        # monotonic lookup/hit counters, attributed to this step's bucket
        if self._paged and self._pool is not None:
            idx = self._pool.prefix
            cur = (idx.lookups, idx.hits)
            if self._tap_prefix_last is not None:
                acc[3] += cur[0] - self._tap_prefix_last[0]
                acc[4] += cur[1] - self._tap_prefix_last[1]
            self._tap_prefix_last = cur
        self._tap_pending += 1
        if self._tap_pending >= max(self.cfg.retrain_interval, 1):
            self._tap_flush()

    def _append_bucket_obs(self, bucket: int, acc, cls: str):
        """Append one bucket's accumulated window (``[steps, toks, secs,
        prefix_lookups, prefix_hits]``) to the corpus as a rewarded
        observation attributed to ``cls``, with the window's prefix hit
        rate, fault rate, step-latency p99 and queue delay as counter
        channels (quantized so identical windows still dedup)."""
        from repro_torch.autotune.corpus import bucket_log_ms, bucket_rate
        from repro_torch.core.dtree import features
        steps, toks, secs = acc[0], acc[1], acc[2]
        if self.corpus is None or steps == 0 or secs <= 0 or toks == 0:
            return
        region = self._tap_region
        counters = (self._pool_rc.regions.get(region) if region else None)
        if counters is None:
            return
        load_frac = min(bucket, self._pool.n_slots) / self._pool.n_slots
        scaled = counters.scaled(load_frac)
        lookups = acc[3] if len(acc) > 3 else 0
        if lookups:
            scaled = dataclasses.replace(
                scaled, prefix_hit_rate=bucket_rate(acc[4] / lookups))
        fr = self.health.fault_rate()
        if fr > 0:
            scaled = dataclasses.replace(scaled, fault_rate=bucket_rate(fr))
        # pop: a mid-window flush (_maybe_replan's class change) must not
        # leak the old class's latencies into the new class's window
        lat = self._tap_lat.pop(bucket, None)
        if lat is not None and lat.count:
            scaled = dataclasses.replace(
                scaled, step_latency_p99=bucket_log_ms(lat.quantile(0.99)))
        if self._tap_qd[1]:
            scaled = dataclasses.replace(
                scaled,
                queue_delay=bucket_log_ms(self._tap_qd[0] / self._tap_qd[1]))
        self.corpus.append(canonical(region), features(scaled),
                           cls, reward=toks / secs)

    def _tap_flush(self):
        """Corpus append (per-bucket features + class + tok/s reward) ->
        retrain -> hot-swap.  A swap bumps the decider version, which
        forces a replan on the very next step."""
        self._tap_pending = 0
        for bucket, acc in self._tap_acc.items():
            self._append_bucket_obs(
                bucket, acc, self._bucket_class.get(bucket, "keep_default"))
        self._tap_acc.clear()
        self._tap_lat.clear()
        self._tap_qd = [0.0, 0]
        self.autotune_stats["corpus_entries"] = len(self.corpus)
        new_tree = self.trainer.maybe_retrain(self.corpus, self.decider.tree)
        self.autotune_stats["retrains"] = self.trainer.retrain_count
        if new_tree is not None:
            self.decider.swap(new_tree)     # version bump busts the latch
            self.autotune_stats["swaps"] += 1
            if self.telemetry is not None:
                self.telemetry.event(
                    "tree_swap", level="info",
                    retrains=self.trainer.retrain_count,
                    corpus_entries=len(self.corpus))
        elif self.explorer is not None and self.explorer.active:
            # no swap this round: give the explorer a mid-bucket chance at
            # the retrain cadence (bounded by its eps and budget)
            self._force_replan = True

    def autotune_summary(self) -> dict:
        """Machine-readable record of the online loop (serve() returns it)."""
        st = dict(self.autotune_stats)
        pre = st.pop("pre_tokens"), st.pop("pre_secs")
        post = st.pop("post_tokens"), st.pop("post_secs")
        st["pre_swap_tok_s"] = pre[0] / pre[1] if pre[1] > 0 else 0.0
        st["post_swap_tok_s"] = post[0] / post[1] if post[1] > 0 else 0.0
        st["post_swap_tok_s_delta"] = (
            st["post_swap_tok_s"] - st["pre_swap_tok_s"]
            if pre[1] > 0 and post[1] > 0 else 0.0)
        st["explore_fraction"] = (st["explore_steps"] / st["steps"]
                                  if st["steps"] else 0.0)
        if self.explorer is not None:
            st["explored"] = self.explorer.explored
        return st

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
        # each trace re-selects from scratch (built steps stay cached);
        # only this run's decisions are returned
        self._load_bucket = None
        log_start = len(self.decisions_log)
        # fresh health window per trace; a fallback left armed by the
        # previous trace is unwound so this one starts on the decided plan
        self.health.reset()
        self._exit_fallback()
        sched = Scheduler()
        tel = self.telemetry
        if tel is not None:
            tel.start_trace()           # fresh spans/ring/sketches per trace
            sched.tracer = tel.tracer
        for r in requests:
            sched.submit(r)
        sched.sort_queue()
        res = (self._serve_paged(sched) if self._paged
               else self._serve_slots(sched))
        # flush whatever the trace accumulated, so a serve shorter than
        # retrain_interval (or ending mid-interval) still feeds the corpus
        if self.corpus is not None and (self._tap_acc or self._tap_pending):
            self._tap_flush()
        out = {"requests": list(requests),
               "decisions": list(self.decisions_log[log_start:]),
               **self.observability(requests)}
        out.update(res)
        if tel is not None:
            tel.event("serve_done", level="info",
                      steps=res.get("steps", 0),
                      n_done=out["stats"].get("n_done", 0),
                      tok_per_s=round(out["stats"].get("tok_per_s", 0.0), 3))
            if self.cfg.trace_out:
                tel.write_trace(self.cfg.trace_out)
            if self.cfg.metrics_out:
                with open(self.cfg.metrics_out, "w") as f:
                    f.write(self.metrics_text())
        return out

    def observability(self, requests: Optional[Sequence[Request]] = None
                      ) -> dict:
        """The per-subsystem ``summary()`` dicts behind one aggregate:
        autotune, health, faults, memory (the governor's on the paged pool, slot
        bytes and occupancy high-water on the slot pool), the paged pool's
        mesh placement (``mesh``), telemetry, and — when
        ``requests`` is passed — the scheduler's trace stats and failure
        rollup.  ``serve()``'s return, the launcher report and
        :meth:`metrics_text` all read from here."""
        obs: dict = {
            "autotune": self.autotune_summary(),
            "health": self.health.summary(),
            "faults": (self.faults.summary() if self.faults is not None
                       else {"enabled": False, "injected_total": 0}),
        }
        if self._paged and self.governor is not None:
            pool = self._pool
            obs["memory"] = self.governor.summary()
            # mesh placement, as the JAX package reports it: page bytes
            # are per device (pages shard on kv_heads, so each rank holds
            # 1/tp of every page); page and watermark counts are
            # tp-invariant
            obs["mesh"] = {
                "tp": pool.tp_shards,
                "devices": self._n_devices(),
                "page_bytes_per_device": pool.per_device_page_bytes(),
                "hbm_bytes_per_device": pool.per_device_hbm_bytes(),
                "high_water_bytes_per_device":
                    pool.per_device_high_water_bytes(),
            }
        elif self._pool is not None:
            pool = self._pool
            obs["memory"] = {"pool": "slot",
                             "slot_bytes": pool.slot_bytes(),
                             "hbm_bytes": pool.hbm_bytes(),
                             "high_water_slots": pool.high_water,
                             "high_water_bytes": pool.high_water_bytes()}
        if self.telemetry is not None:
            obs["telemetry"] = self.telemetry.summary()
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

    def metrics_text(self) -> str:
        """Prometheus text-exposition snapshot of :meth:`observability`
        (plus the telemetry latency quantiles when telemetry is on)."""
        from repro_torch.serve.telemetry import prometheus_text
        return prometheus_text(self.observability(),
                               telemetry=self.telemetry)

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
        prev = (self._pool_step, self._spec_depth, self._serve_tp)
        self._force_safe = True
        plan = self._safe_plan()
        key = self._step_cache_key(plan)
        if key not in self._pool_steps:
            self._pool_steps[key] = self._build_paged_step(plan)
        step, depth, tp = self._pool_steps[key]
        self._apply_tp(tp)
        self._pool_step, self._spec_depth = step, depth
        self._fallback = prev
        self.health.taps["fallbacks"] += 1

    def _exit_fallback(self):
        """Recovered: restore the pre-fallback step and placement and ask
        the decider to re-decide on the next step."""
        if self._fallback is None:
            return
        step, depth, tp = self._fallback
        self._fallback = None
        self._force_safe = False
        self._apply_tp(tp)
        self._pool_step, self._spec_depth = step, depth
        self._force_replan = True

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
                    if self.telemetry is not None:
                        self.telemetry.ttft.add(max(t - req.arrival_s, 0.0))
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

        tel = self.telemetry
        while not sched.done():
            t = now()
            # admit: every free slot takes the next arrived request (FIFO)
            while pool.n_free and sched.has_ready(t):
                req = sched.pop_ready(t)
                # queue-delay tap (slot admissions are always fresh: the
                # slot pool never preempts): feeds the Counters channel
                # and, when on, the telemetry sketch
                qd = max(t - req.arrival_s, 0.0)
                if self.corpus is not None:
                    self._tap_qd[0] += qd
                    self._tap_qd[1] += 1
                if tel is not None:
                    tel.on_admit(req.rid, qd, preempted=False)
                hist = req.token_history()
                slot = pool.alloc()
                if self.cfg.prefill_chunk > 0 and hist.size >= 2:
                    sched.bind_prefill(req, slot, now())
                    pcaches[slot] = pool.empty_slot_cache()
                    req.prefill_pos = 0
                    prefills.append(req)
                else:
                    with _span("serve.prefill"):
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
            pmode = self.scan_mode_for(self._decided_plan, phase="prefill")
            while budget > 0 and prefills:
                req = prefills[0]
                slot = req.slot
                feed = req.token_history()[:-1]
                chunk = feed[req.prefill_pos:
                             req.prefill_pos + self.cfg.prefill_chunk]
                tc0 = now() if tel is not None else 0.0
                with _span("serve.prefill"):
                    pcaches[slot] = self._slot_advance(pcaches[slot], chunk,
                                                       pmode)
                if tel is not None:
                    tel.tracer.add(req.rid, "PREFILL_CHUNK", tc0, now(),
                                   tokens=int(chunk.size))
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

            n_act = len(sched.active)
            self._maybe_replan(n_act)
            t_step0 = time.perf_counter()
            D = self._spec_depth
            S = D + 1
            max_depth = max(max_depth, D)
            dmode = self.scan_mode_for(self._decided_plan)

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
            with _span("serve.decode"):
                out, finite = self._slot_decode(toks_in, active, gen)
                out_np = out.cpu().numpy()
                finite_np = finite.cpu().numpy()
            steps += 1

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
                        with _span("serve.readvance"):
                            pool.write(slot, self._slot_advance(
                                snaps[slot], toks_in[slot, :c], dmode))
                        calls["readvance"] += 1
            dt_step = time.perf_counter() - t_step0
            self.health.note_step(dt_step, n_slot_faults=len(faulted))
            self._tap_step(n_act, sum(consumed.values()), dt_step)
            if tel is not None:
                tel.on_step(steps, t_step0 - t0, dt_step,
                            sum(consumed.values()), n_act, pool.n_free,
                            len(faulted),
                            self._bucket_class.get(load_bucket(n_act), ""))
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
        tel = self.telemetry
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
        # cache the masked table instead of remaking it every step
        bt_host = {"arr": None, "act": None, "dirty": True}

        def release_slot(slot, req=None):
            # publish the finished request's fully-written pages to the
            # prefix index before unmapping
            if req is not None:
                pool.register_prefix(slot, req.token_history())
            pool.release(slot)
            bt_host["dirty"] = True

        def preempt_victim(victim):
            """Evict a resident decode: pages back to the allocator, the
            request to the scheduler's preempted queue (re-enters as
            recompute-prefill over its committed history)."""
            sched.preempt(sched.active[victim], now())
            pool.preempt(victim)
            active[victim] = False
            pending[victim] = 0
            bt_host["dirty"] = True

        def fail_request(slot, req, reason):
            """A resident request exhausted its retries: terminal FAILED
            with every page released; nothing is published."""
            pool.release(slot)
            active[slot] = False
            pending[slot] = 0
            bt_host["dirty"] = True
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
                fresh = req.state is RequestState.WAITING
                slot = gov.admit(hist.size, total, shared_pages=shared)
                if slot is None:            # head-of-line waits for memory
                    return
                sched.pop_ready(t)
                sched.bind_prefill(req, slot, now())
                # queue-delay tap: admission wait of fresh arrivals (a
                # PREEMPTED re-entry's wait is tracked separately) feeds
                # the Counters channel and, when on, the telemetry sketch
                if fresh and self.corpus is not None:
                    self._tap_qd[0] += max(t - req.arrival_s, 0.0)
                    self._tap_qd[1] += 1
                if tel is not None:
                    tel.on_admit(req.rid, max(t - req.arrival_s, 0.0),
                                 preempted=not fresh)
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
                    bt_host["dirty"] = True
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
                    C = (self.cfg.prefill_chunk if self._chunked_prefill()
                         else feed.size)
                    chunk = feed[req.prefill_pos:req.prefill_pos + C]
                    true_c = chunk.size
                    if true_c < C:
                        chunk = np.pad(chunk, (0, C - true_c))
                    tc0 = now() if tel is not None else 0.0
                    with _span("serve.prefill"):
                        self._paged_prefill(chunk, slot, req.prefill_pos)
                    if tel is not None:
                        tel.tracer.add(req.rid, "PREFILL_CHUNK", tc0, now(),
                                       tokens=int(true_c))
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
                        bt_host["dirty"] = True
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

                n_act = len(sched.active)
                self._maybe_replan(n_act)
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
                        if req.backoff == 0 and tel is not None:
                            tel.tracer.end(req.rid, "RETRY_BACKOFF", now())
                        stalled.append(slot)
                        continue
                    cap = req.prompt.size - 1 + req.max_new_tokens
                    cow0_slot = pool.cow_copies
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
                    if tel is not None and pool.cow_copies > cow0_slot:
                        # shared pages privatised for this slot's writes
                        tel.tracer.instant(req.rid, "COW", now(),
                                           copies=pool.cow_copies - cow0_slot)
                stalled = [s for s in stalled if s in sched.active]
                if gov.grown_pages != grown0 or pool.cow_copies != cow0:
                    bt_host["dirty"] = True      # block-table rows edited
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
                    bt_host["dirty"] = True
                eff = active & ~stall_arr
                if bt_host["dirty"]:
                    bt_host["arr"] = (pool.block_tables
                                      * eff[:, None]).astype(np.int32)
                    bt_host["act"] = eff
                    bt_host["dirty"] = False
                with _span("serve.decode"):
                    out, finite = self._paged_decode(
                        toks_in, bt_host["arr"],
                        (pool.lengths * eff).astype(np.int32),
                        bt_host["act"], gen)
                    out_np = out.cpu().numpy()
                    finite_np = finite.cpu().numpy()
                if (self.faults is not None
                        and self.faults.fire("step.latency")):
                    time.sleep(self.faults.latency_s)
                steps += 1
                gov.note_step(len(stalled))

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
                            if tel is not None:
                                tel.tracer.begin(req.rid, "RETRY_BACKOFF",
                                                 now(), steps=req.backoff)
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
                self._tap_step(n_act, sum(consumed.values()), dt_step)
                if tel is not None:
                    tel.on_step(steps, t_step0 - t0, dt_step,
                                sum(consumed.values()), n_act,
                                pool.allocator.n_free, len(faulted),
                                self._bucket_class.get(load_bucket(n_act),
                                                       ""))
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
