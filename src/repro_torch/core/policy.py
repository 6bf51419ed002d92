"""Per-region plans — the tuner's output, the model's input.

The paper replaces the single global ``OMP_NUM_THREADS`` knob with a
per-parallel-region thread count.  A :class:`RegionPlan` carries the
default logical-axis rules plus per-region :class:`RegionConfig` overrides
of every knob (kernel block sizes, paged-KV layout, attention impl,
speculation depth, memory policy, ...).

A plan may carry a mesh (:mod:`repro_torch.launch.mesh`): then
:func:`legal_spec` maps each leaf's logical axes onto it, replicating any
dim the mapped mesh-axis size does not divide, so every spec the port
emits is legal by construction.  Activation constraints have no eager
counterpart except where a partial sum meets them: there
:meth:`RegionPlan.constrain` all-reduces over the ``model`` axis (the
collective GSPMD inserts in the JAX package; under autograd through
:func:`repro_torch.distributed.comm.reduce_from_model`) and is otherwise
the identity.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Mapping, Optional, Sequence

# Logical axis vocabulary used by the model zoo.
LOGICAL_AXES = (
    "batch", "seq", "kv_seq", "embed", "ff", "heads", "kv_heads", "head_dim",
    "vocab", "experts", "ssm_heads", "ssm_dim", "state", "enc_seq", "layers",
)

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


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a mesh: a ``DeviceMesh``
    (:mod:`repro_torch.launch.mesh`) or any stand-in whose ``shape`` is
    already that dict."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(entry, (tuple, list)):
        n = 1
        for a in entry:
            n *= shape[a]
        return n
    return shape[entry]


def legal_spec(shape: Sequence[int], axes: Sequence[Optional[str]],
               rules: Mapping[str, Any], mesh) -> tuple:
    """The partition spec of ``shape`` with logical ``axes`` under
    ``rules``, as a tuple with one entry per dim — a mesh-axis name, a
    tuple of names, or None — and the trailing Nones dropped.

    Drops (replicates) any entry whose dim is not divisible by the
    mesh-axis size, and never assigns one mesh axis to two dims."""
    if mesh is None:
        return ()
    sizes = mesh_shape(mesh)
    entries = []
    used: set[str] = set()
    for dim, ax in zip(shape, axes):
        entry = rules.get(ax) if ax is not None else None
        if entry is None:
            entries.append(None)
            continue
        flat = tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)
        # drop axes already used or absent from the mesh
        flat = tuple(a for a in flat if a in sizes and a not in used)
        size = 1
        for a in flat:
            size *= sizes[a]
        if not flat or size == 1 or dim % size != 0:
            entries.append(None)
            continue
        used.update(flat)
        entries.append(flat[0] if len(flat) == 1 else flat)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


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
    """Sharding + tuning plan: default rules + per-region overrides.

    ``region_configs`` keys are region-path prefixes; the longest matching
    prefix wins (so a plan can address ``"layer/attn"`` in every layer or
    ``"layer3/attn"`` in one).  ``mesh`` is None on one device.
    """
    mesh: Any = None
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

    def constrain(self, x, region: str, axes: Sequence[Optional[str]],
                  partial: bool = False):
        """Activation constraint for ``x`` in ``region``.  ``partial``:
        ``x`` is this rank's partial sum of a product whose contracted dim
        is split over the ``model`` axis — it is all-reduced over that
        axis, the collective GSPMD inserts where the JAX package constrains
        a partial sum.  Otherwise (and always on a plan without a mesh, or
        whose ``model`` axis is 1) the identity: eager tensors carry no
        placement to constrain."""
        if not partial or self.model_size() == 1:
            return x
        from repro_torch.distributed import comm
        return comm.reduce_from_model(x, self.mesh)

    def model_size(self) -> int:
        """Width of the mesh's ``model`` (tensor-parallel) axis; 1 without
        a mesh."""
        if self.mesh is None:
            return 1
        return mesh_shape(self.mesh).get("model", 1)

    def param_sharding(self, shape: Sequence[int],
                       axes: Sequence[Optional[str]],
                       region: str = "") -> Optional[tuple]:
        """The spec of a parameter leaf (None without a mesh)."""
        if self.mesh is None:
            return None
        return legal_spec(shape, axes, self.rules_for(region), self.mesh)

    # -- (de)serialisation (plans are artifacts, like PdtTagger's config file)
    def to_json(self) -> str:
        return json.dumps({
            "rules": {k: list(v) if isinstance(v, tuple) else v
                      for k, v in self.rules.items()},
            "regions": {k: rc.to_json() for k, rc in self.region_configs.items()},
        }, indent=2, default=list)

    @staticmethod
    def from_json(text: str, mesh=None) -> "RegionPlan":
        raw = json.loads(text)
        rules = {k: tuple(v) if isinstance(v, list) else v
                 for k, v in raw.get("rules", {}).items()}
        regions = {}
        for k, d in raw.get("regions", {}).items():
            d = dict(d)
            d["rules"] = {kk: tuple(vv) if isinstance(vv, list) else vv
                          for kk, vv in d.get("rules", {}).items()}
            regions[k] = RegionConfig(**d)
        return RegionPlan(mesh=mesh, rules={**dict(DEFAULT_RULES), **rules},
                          region_configs=regions)


def null_plan() -> RegionPlan:
    """Plan with no mesh and every knob at its default."""
    return RegionPlan()


def default_plan(mesh=None, kind: str = "train") -> RegionPlan:
    """The "single global knob" baseline plan (paper's OMP_NUM_THREADS
    analog): uniform DP(batch)+TP(ff/heads/vocab) rules everywhere, remat on
    every layer for training."""
    regions = {}
    rules = dict(DEFAULT_RULES)
    if kind == "train":
        regions["layer"] = RegionConfig(remat=True)   # prefix-matches layerN
        regions["enc"] = RegionConfig(remat=True)
        regions["dec"] = RegionConfig(remat=True)
        regions["shared_attn"] = RegionConfig(remat=True)
    if kind == "decode":
        # decode is KV-cache-bound: shard the cache sequence dim over the
        # model axis, with head-replicated attention activations
        rules["kv_seq"] = "model"
        rules["heads"] = None
        rules["kv_heads"] = None
    return RegionPlan(mesh=mesh, rules=rules, region_configs=regions)


def default_microbatch(kind: str, global_batch: int, data_shards: int) -> int:
    """Baseline grad-accumulation factor: keep ~2 sequences per device."""
    if kind != "train":
        return 1
    per_dev = max(global_batch // max(data_shards, 1), 1)
    return max(per_dev // 2, 1)
