"""The action space: named parallelism-config candidates (the "decide"
stage's vocabulary).

Each :class:`Candidate` is one class label the decision tree can predict —
the analog of one ``OMP_NUM_THREADS``/scheduling choice in the paper's
per-region menu.  The offline search trials them by re-counting; the
serve-time decider applies them by overlaying their
:class:`repro_torch.core.policy.RegionConfig` onto the live plan.
"""
from __future__ import annotations

import dataclasses
import re

from repro_torch.core.policy import RegionConfig


def canonical(region: str) -> str:
    """layer3/attn -> layer/attn (configs generalise across layer indices)."""
    return re.sub(r"\d+", "", region)


@dataclasses.dataclass
class Candidate:
    name: str                      # class label (dtree target)
    config: RegionConfig
    applies_to: str = ""           # region-kind filter substring
    serve_only: bool = False       # knob invisible to the offline evaluator
                                   # (e.g. spec_depth: it shapes the serve
                                   # engine's step, not the region graph) —
                                   # the tuner skips trialling it, but the
                                   # serve-time PlanDecider can still apply
                                   # its class


def default_candidates(kind: str = "train") -> list[Candidate]:
    """The action space (the SMT-mode menu of this hardware)."""
    cands = [
        # attention sharding alternatives
        Candidate("attn_tp_heads", RegionConfig(rules={"heads": "model"}),
                  "attn"),
        Candidate("attn_cp_seq", RegionConfig(
            rules={"heads": None, "seq": "model", "kv_heads": None}), "attn"),
        Candidate("attn_replicated", RegionConfig(
            rules={"heads": None, "kv_heads": None}), "attn"),
        # mlp/ff sharding
        Candidate("ff_tp", RegionConfig(rules={"ff": "model"}), "mlp"),
        Candidate("ff_dp_only", RegionConfig(rules={"ff": None}), "mlp"),
        # MoE expert layout
        Candidate("moe_ep", RegionConfig(rules={"experts": "model",
                                                "ff": None}), "moe"),
        Candidate("moe_tp", RegionConfig(rules={"experts": None,
                                                "ff": "model"}), "moe"),
        # SSM chunk length (recompute/memory trade)
        Candidate("ssm_chunk64", RegionConfig(chunk=64), "ssm"),
        Candidate("ssm_chunk256", RegionConfig(chunk=256), "ssm"),
        Candidate("ssm_chunk512", RegionConfig(chunk=512), "ssm"),
        # attention q-block (VMEM/score-matrix trade)
        Candidate("attn_blockq_1k", RegionConfig(block_q=1024), "attn"),
        Candidate("attn_blockq_4k", RegionConfig(block_q=4096), "attn"),
    ]
    if kind == "train":
        cands += [
            Candidate("remat_off", RegionConfig(remat=False), "layer"),
            Candidate("remat_on", RegionConfig(remat=True), "layer"),
        ]
    if kind == "decode":
        cands += [
            Candidate("kv_seq_shard", RegionConfig(
                rules={"kv_seq": "model", "heads": None}), "attn"),
            Candidate("kv_head_shard", RegionConfig(
                rules={"kv_seq": None, "kv_heads": "model"}), "attn"),
            # paged-KV layout granularity (pool rebuild) and the paged
            # kernel's inner KV tile (step rebuild only)
            Candidate("attn_page16", RegionConfig(page_size=16), "attn"),
            Candidate("attn_page64", RegionConfig(page_size=64), "attn"),
            Candidate("attn_paged_kernel", RegionConfig(attn_impl="paged"),
                      "attn"),
            Candidate("attn_paged_kernel_bk128", RegionConfig(
                attn_impl="paged", block_k=128), "attn"),
            # speculative decode depth: deep speculation wins on memory-bound
            # low-occupancy pools (drafted queries amortise KV traffic),
            # loses under compute-bound high occupancy (rejected drafts
            # burn flops) — exactly the workload-dependent knob the
            # counters-scaled-by-occupancy decider is built to choose
            Candidate("spec0", RegionConfig(spec_depth=0), "attn",
                      serve_only=True),
            Candidate("spec2", RegionConfig(spec_depth=2), "attn",
                      serve_only=True),
            Candidate("spec4", RegionConfig(spec_depth=4), "attn",
                      serve_only=True),
            # KV-memory governor policy (repro_torch.serve.memory): full
            # reservation is preemption-free but runs the pool half-empty
            # on short-generation traffic; lazy admission overcommits —
            # more in-flight requests at the same HBM — at the price of
            # preemption/recompute churn when decodes outgrow the free
            # list.  Which side wins depends on the measured load (long
            # decode tails vs short bursts), so it's the decider's call;
            # the watermark variants trade admission depth against growth
            # headroom.  Purely an allocator-policy knob: never reshapes
            # the compiled step (the step cache strips it).
            Candidate("mem_full", RegionConfig(reservation="full"), "attn",
                      serve_only=True),
            Candidate("mem_lazy", RegionConfig(reservation="lazy"), "attn",
                      serve_only=True),
            Candidate("mem_lazy_wm10", RegionConfig(
                reservation="lazy", mem_watermark=0.10), "attn",
                serve_only=True),
            Candidate("mem_lazy_wm30", RegionConfig(
                reservation="lazy", mem_watermark=0.30), "attn",
                serve_only=True),
            # cross-request prefix caching (repro_torch.serve.cache.PrefixIndex):
            # sharing wins when traffic repeats prompt prefixes (system
            # preambles, few-shot headers) — near-zero TTFT on hits — and
            # only costs index/CoW overhead plus pages pinned by the index
            # when it doesn't.  Bit-identical either way, so it's purely
            # the decider's throughput call; allocator-policy only, never
            # reshapes the compiled step (the step cache strips it).
            Candidate("mem_prefix_on", RegionConfig(prefix_cache="on"),
                      "attn", serve_only=True),
            Candidate("mem_prefix_off", RegionConfig(prefix_cache="off"),
                      "attn", serve_only=True),
            # tensor-parallel degree of the sharded serve step (the paper's
            # per-region worker count asked at cluster scale): small-batch
            # decode is latency/collective-bound and wants low tp;
            # large-batch prefill is flops-bound and wants the model axis
            # wide.  Greedy output is bit-identical across degrees, so the
            # decider trades pure throughput.  Unlike the mem_* knobs this
            # DOES reshape the compiled step (the step cache keys on it and
            # a change forces one recompile + pool reshard).  Degrees the
            # host mesh cannot satisfy clamp down at resolution time.
            Candidate("tp1", RegionConfig(tp_degree=1), "attn",
                      serve_only=True),
            Candidate("tp2", RegionConfig(tp_degree=2), "attn",
                      serve_only=True),
            Candidate("tp4", RegionConfig(tp_degree=4), "attn",
                      serve_only=True),
            # recurrent scan mode (dual-mode linear attention, the
            # flash-linear-attention mode split as a region knob): "chunk"
            # turns the wkv/ssd recurrence's intra-chunk work into causal
            # matmuls — state HBM traffic drops by the chunk length, so it
            # wins prefill-heavy buckets; "fused_recurrent" is the
            # sequential scan — no reassociation overhead, so it wins
            # decode-heavy buckets.  Greedy output is bit-identical across
            # modes — a pure code-variant choice per load bucket (ppOpen-AT
            # style), the decider's call.  Distinct names per region kind:
            # the decider's menu is name-keyed, and one applies_to string
            # cannot cover both rwkv6's time-mix and the mamba block.
            Candidate("scan_chunk", RegionConfig(scan_mode="chunk"),
                      "tmix", serve_only=True),
            Candidate("scan_fused",
                      RegionConfig(scan_mode="fused_recurrent"),
                      "tmix", serve_only=True),
            Candidate("scan_chunk_ssd", RegionConfig(scan_mode="chunk"),
                      "ssm", serve_only=True),
            Candidate("scan_fused_ssd",
                      RegionConfig(scan_mode="fused_recurrent"),
                      "ssm", serve_only=True),
        ]
    return cands


def explore_menu(kind: str = "decode") -> list[Candidate]:
    """The serve-time exploration menu: the serve-only candidates the
    offline evaluator can never trial (it skips ``serve_only`` knobs), so
    only live traffic can populate their corpus classes."""
    return [c for c in default_candidates(kind) if c.serve_only]
