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
from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import RegionPlan, null_plan
from repro_torch.models import layers as L


def _family_module(cfg: ArchConfig):
    if cfg.family == "dense":
        from repro_torch.models import transformer as m
        return m
    if cfg.family == "ssm":
        from repro_torch.models import rwkv6 as m
        return m
    if cfg.family == "hybrid":
        from repro_torch.models import zamba2 as m
        return m
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet (ROADMAP queue 1 items "
        f"11-12: MoE, enc-dec and VLM)")


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

    def forward(self, params, batch, plan: Optional[RegionPlan] = None,
                final_logits_only: bool = False):
        return self.mod.forward(self.cfg, params, batch, plan or null_plan(),
                                final_logits_only=final_logits_only)

    # -- slot-pool serving (every family) ----------------------------------
    def prefill(self, params, batch, plan: Optional[RegionPlan] = None,
                max_len: int = 0):
        return self.mod.prefill(self.cfg, params, batch, plan or null_plan(),
                                max_len or batch["tokens"].shape[1])

    def decode(self, params, cache, tokens,
               plan: Optional[RegionPlan] = None):
        return self.mod.decode_step(self.cfg, params, cache, tokens,
                                    plan or null_plan())

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


def params_from_numpy(tree: Any, device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = torch.float32) -> Any:
    """The weight bridge: a param tree of numpy arrays (nested dicts under
    the JAX package's keys — ``embed/{tokens,unembed}``, layer-stacked
    ``blocks/...`` (``{attn,mlp,norm1,norm2}``, rwkv6's ``{tmix,cmix,ln1,
    ln2}``, zamba2's ``{ssm,norm}``), rwkv6's ``ln_in``, zamba2's unstacked
    ``shared`` block, ``final_norm``) -> the same tree of
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
