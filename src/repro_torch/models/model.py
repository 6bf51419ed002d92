"""Unified model API: ``build(cfg)`` returns a :class:`Model` with

  spec()                                    -> param Spec tree
  init(seed, dtype, device)                 -> params (nested dict of tensors)
  forward(params, batch, plan)              -> (logits, aux)
  prefill(params, batch, plan, max_len)     -> (last logits, cache)
  decode(params, cache, tokens, plan)       -> (logits, cache)
  cache_spec(batch, max_len, dtype)         -> slot-cache TensorSpec tree
  init_cache(batch, max_len, dtype, device) -> zeroed slot cache
  paged_cache_spec(n_pages, page_size)      -> page-pool shapes
  paged_decode(params, pages, tokens, block_tables, lengths, plan)
  paged_prefill_chunk(params, pages, tokens, block_table, base, plan)

:func:`params_from_numpy` is the weight bridge from the JAX package: its
param tree, as nested dicts of numpy arrays under the same keys, becomes
the port's params — so the two packages can be run on identical weights.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, make_generator, resolve_device
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.policy import RegionPlan, null_plan
from repro_torch.models import layers as L


N_VISION_TOKENS = 256


def _family_module(cfg: ArchConfig):
    if cfg.family in ("dense", "moe", "vlm"):
        from repro_torch.models import transformer as m
    elif cfg.family == "ssm":
        from repro_torch.models import rwkv6 as m
    elif cfg.family == "hybrid":
        from repro_torch.models import zamba2 as m
    elif cfg.family == "encdec":
        from repro_torch.models import whisper as m
    else:
        raise ValueError(f"unknown family {cfg.family}")
    return m


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    mod: Any

    def spec(self):
        return self.mod.spec(self.cfg)

    def init(self, seed: int = 0, dtype: torch.dtype = torch.bfloat16,
             device: DeviceLike = None):
        """Random params from a ``torch.Generator`` seeded with ``seed``
        (the JAX package's distributions, not its numbers)."""
        dev = resolve_device(device)
        return L.init_params(self.spec(), make_generator(dev, seed), dtype,
                             dev)

    def abstract_params(self, dtype: torch.dtype = torch.bfloat16):
        """The param tree as meta tensors (shapes and dtype only)."""
        return L.abstract_params(self.spec(), dtype)

    def logical_axes(self):
        """The param tree's logical axis names, leaf for leaf."""
        return L.logical_axes(self.spec())

    def forward(self, params, batch, plan: Optional[RegionPlan] = None,
                unroll: bool = True, final_logits_only: bool = False):
        """(logits, aux).  ``unroll`` is the JAX package's choice between
        unrolled layers and a ``lax.scan`` over them; eager PyTorch runs
        the layers one by one either way, so it has no effect."""
        return self.mod.forward(self.cfg, params, batch, plan or null_plan(),
                                final_logits_only=final_logits_only)

    # -- slot-pool serving (every family) ----------------------------------
    def prefill(self, params, batch, plan: Optional[RegionPlan] = None,
                max_len: int = 0):
        return self.mod.prefill(self.cfg, params, batch, plan or null_plan(),
                                max_len or batch["tokens"].shape[1])

    def decode(self, params, cache, tokens,
               plan: Optional[RegionPlan] = None, **kw):
        """``kw``: the family's own options (the transformer's
        ``moe_group``)."""
        return self.mod.decode_step(self.cfg, params, cache, tokens,
                                    plan or null_plan(), **kw)

    def cache_spec(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16):
        return self.mod.cache_spec(self.cfg, batch, max_len, dtype)

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16,
                   device: DeviceLike = None):
        return self.mod.init_cache(self.cfg, batch, max_len, dtype,
                                   resolve_device(device))

    # -- paged KV (full-KV attention families only) ------------------------
    @property
    def supports_paged(self) -> bool:
        """Paged KV needs a positional full-KV layout that grows with the
        sequence: sliding-window rings stay on the slot pool."""
        return (hasattr(self.mod, "paged_decode_step")
                and self.cfg.family in ("dense", "moe", "vlm")
                and not self.cfg.swa_window)

    def paged_cache_spec(self, n_pages: int, page_size: int):
        return self.mod.paged_cache_spec(self.cfg, n_pages, page_size)

    def paged_decode(self, params, pages, tokens, block_tables, lengths,
                     plan: Optional[RegionPlan] = None):
        return self.mod.paged_decode_step(self.cfg, params, pages, tokens,
                                          block_tables, lengths,
                                          plan or null_plan())

    def paged_prefill_chunk(self, params, pages, tokens, block_table, base,
                            plan: Optional[RegionPlan] = None):
        return self.mod.prefill_chunk_step(self.cfg, params, pages, tokens,
                                           block_table, base,
                                           plan or null_plan())


def build(cfg: ArchConfig) -> Model:
    return Model(cfg, _family_module(cfg))


def count_params(cfg: ArchConfig) -> int:
    return L.spec_param_count(_family_module(cfg).spec(cfg))


def active_param_count(cfg: ArchConfig) -> int:
    """Params touched per token (MoE: shared + top_k of routed)."""
    total = count_params(cfg)
    if not cfg.n_experts:
        return total
    from repro_torch.models.moe import n_experts_padded
    e = n_experts_padded(cfg)
    per_expert = cfg.d_ff * cfg.d_model * (3 if cfg.glu else 2)
    routed_all = cfg.n_layers * e * per_expert
    routed_active = cfg.n_layers * cfg.top_k * per_expert
    return total - routed_all + routed_active


def input_specs(cfg: ArchConfig, shape: ShapeConfig,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """The inputs of the step ``shape.kind`` selects, as meta tensors of
    their global shapes (dry runs: nothing is allocated)."""
    B, S = shape.global_batch, shape.seq_len

    def meta(*dims, dt=torch.int32):
        return torch.empty(dims, dtype=dt, device="meta")

    if shape.kind in ("train", "prefill"):
        batch = {"tokens": meta(B, S)}
        if shape.kind == "train":
            batch["labels"] = meta(B, S)
        if cfg.family == "encdec":
            batch["frames"] = meta(B, cfg.enc_len, cfg.d_model, dt=dtype)
        if cfg.frontend == "vision_patches":
            batch["vision_embeds"] = meta(B, N_VISION_TOKENS, cfg.d_model,
                                          dt=dtype)
        return batch
    if shape.kind == "decode":
        return {"tokens": meta(B, 1)}
    raise ValueError(shape.kind)


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """6·N·D for training, 2·N_active·D forward-only (MoE uses active)."""
    n_active = active_param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch  # one new token per row
    return 2.0 * n_active * tokens


def params_from_numpy(tree: Any, device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = torch.float32) -> Any:
    """The weight bridge: a param tree of numpy arrays (nested dicts under
    the JAX package's keys — ``embed/{tokens,unembed}``, layer-stacked
    ``blocks/...`` (``{attn,mlp,norm1,norm2}``, an MoE layer's ``mlp``
    holding ``{router,gate,up,down}`` and, with shared experts,
    ``{shared,shared_gate}``; rwkv6's ``{tmix,cmix,ln1,ln2}``, zamba2's
    ``{ssm,norm}``), rwkv6's ``ln_in``, zamba2's unstacked ``shared``
    block, whisper's layer-stacked ``enc_blocks``
    (``{attn,mlp,norm1,norm2}``) and ``dec_blocks``
    (``{self_attn,cross_attn,mlp,norm1,norm2,norm3}``) and its
    ``enc_norm``, ``final_norm``) -> the same tree of
    tensors on ``device`` in ``dtype`` (``None`` keeps each array's own
    dtype; numpy has no bfloat16, so such arrays come over as float32)."""
    dev = resolve_device(device)

    def leaf(a):
        arr = np.asarray(a)
        if arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)
        t = torch.tensor(arr)               # a copy: numpy keeps its own
        return t.to(device=dev, dtype=dtype or t.dtype)

    return L.tree_map(leaf, tree)
