"""Per-region plans — the tuner's output, the model's input.

The paper replaces the single global ``OMP_NUM_THREADS`` knob with a
per-parallel-region thread count.  A :class:`RegionPlan` carries the
default logical-axis rules plus per-region :class:`RegionConfig` overrides
of every knob (kernel block sizes, paged-KV layout, attention impl,
speculation depth, memory policy, ...).

This port runs on one device, so a plan carries no mesh:
:meth:`RegionPlan.constrain` is the identity and the ``rules`` are kept
only so plans round-trip through JSON unchanged.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Mapping, Optional, Sequence

# The "single global knob" baseline (analog of one OMP_NUM_THREADS value):
# batch -> data parallel, ff/heads/vocab -> tensor parallel, everything
# else replicated.
DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": None,
    "embed": None,
    "ff": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "vocab": "model",
    "experts": "model",
    "ssm_heads": "model",
    "ssm_dim": "model",
    "state": None,
    "enc_seq": None,
    "layers": None,
}


@dataclasses.dataclass
class RegionConfig:
    """Per-region knobs (the "thread count" analog)."""
    rules: dict[str, Any] = dataclasses.field(default_factory=dict)
    remat: bool = False
    microbatch: int = 1
    block_q: int = 0        # kernel / chunking block sizes (0 = impl default)
    block_k: int = 0
    chunk: int = 0          # SSM/linear-attention chunk length
    oversubscribe: int = 1  # kernel grid oversubscription factor ("SMT mode")
    moe_group: int = 0      # MoE dispatch group size (0 = impl default)
    moe_impl: str = ""      # '' = default ('einsum'), or 'scatter'
    ssm_impl: str = ""      # '' = default ('scan'), or 'chunked' (matmul SSD)
    page_size: int = 0      # paged-KV block granularity, tokens (0 = default)
    attn_impl: str = ""     # decode attention: '' = gather, 'paged' = the
                            # paged-attention kernel (block_k = its KV tile)
    spec_depth: int = -1    # speculative decode draft depth per pool step
                            # (-1 = knob unset; 0 = no speculation; N>0 =
                            # draft N tokens, verify with q_len N+1)
    reservation: str = ""   # paged-KV admission policy ('' = unset;
                            # 'full' = reserve worst case up front;
                            # 'lazy' = prompt pages + 1, grow + preempt)
    mem_watermark: float = -1.0  # lazy-admission free-page high watermark
                                 # as a fraction of allocatable pages
                                 # (-1 = unset; engine default 0.1)
    prefix_cache: str = ""  # cross-request KV prefix sharing ('' = unset;
                            # 'on' = share + copy-on-write; 'off' = cold
                            # pool per request)
    tp_degree: int = 0      # serve-engine tensor-parallel degree (0 = knob
                            # unset; 1 = single-shard)
    scan_mode: str = ""     # linear-attention scan variant ('' = unset;
                            # 'fused_recurrent' | 'chunk' | 'auto')

    def to_json(self):
        return dataclasses.asdict(self)


@dataclasses.dataclass
class RegionPlan:
    """Tuning plan: default rules + per-region overrides.

    ``region_configs`` keys are region-path prefixes; the longest matching
    prefix wins (so a plan can address ``"layer/attn"`` in every layer or
    ``"layer3/attn"`` in one).
    """
    rules: dict[str, Any] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_RULES))
    region_configs: dict[str, RegionConfig] = dataclasses.field(
        default_factory=dict)

    # -- lookups -----------------------------------------------------------
    def config_for(self, region: str) -> RegionConfig:
        """Longest matching prefix wins; prefixes also match the canonical
        (digit-stripped) path, so "layer/attn" addresses attn in every layer."""
        canon = re.sub(r"\d+", "", region)
        best, best_len = None, -1
        for prefix, rc in self.region_configs.items():
            if ((region.startswith(prefix) or canon.startswith(prefix))
                    and len(prefix) > best_len):
                best, best_len = rc, len(prefix)
        return best if best is not None else RegionConfig()

    def rules_for(self, region: str) -> Mapping[str, Any]:
        rc = self.config_for(region)
        if not rc.rules:
            return self.rules
        merged = dict(self.rules)
        merged.update(rc.rules)
        return merged

    def constrain(self, x, region: str, axes: Sequence[Optional[str]]):
        """Activation sharding constraint: the identity on one device."""
        return x

    # -- (de)serialisation (plans are artifacts, like PdtTagger's config file)
    def to_json(self) -> str:
        return json.dumps({
            "rules": {k: list(v) if isinstance(v, tuple) else v
                      for k, v in self.rules.items()},
            "regions": {k: rc.to_json() for k, rc in self.region_configs.items()},
        }, indent=2, default=list)

    @staticmethod
    def from_json(text: str) -> "RegionPlan":
        raw = json.loads(text)
        rules = {k: tuple(v) if isinstance(v, list) else v
                 for k, v in raw.get("rules", {}).items()}
        regions = {}
        for k, d in raw.get("regions", {}).items():
            d = dict(d)
            d["rules"] = {kk: tuple(vv) if isinstance(vv, list) else vv
                          for kk, vv in d.get("rules", {}).items()}
            regions[k] = RegionConfig(**d)
        return RegionPlan(rules={**dict(DEFAULT_RULES), **rules},
                          region_configs=regions)


def null_plan() -> RegionPlan:
    """Plan with every knob at its default."""
    return RegionPlan()


def default_plan(mesh=None, kind: str = "train") -> RegionPlan:
    """The "single global knob" baseline plan (paper's OMP_NUM_THREADS
    analog): uniform DP(batch)+TP(ff/heads/vocab) rules everywhere, remat on
    every layer for training.  ``mesh`` is accepted for the JAX package's
    signature and ignored: a port plan carries no mesh."""
    regions = {}
    rules = dict(DEFAULT_RULES)
    if kind == "train":
        regions["layer"] = RegionConfig(remat=True)   # prefix-matches layerN
        regions["enc"] = RegionConfig(remat=True)
        regions["dec"] = RegionConfig(remat=True)
        regions["shared_attn"] = RegionConfig(remat=True)
    if kind == "decode":
        rules["kv_seq"] = "model"
        rules["heads"] = None
        rules["kv_heads"] = None
    return RegionPlan(rules=rules, region_configs=regions)
