"""Zamba2 (arXiv:2411.15242) on PyTorch: Mamba2 backbone + *shared-weight*
attention blocks.

After every ``attn_every``-th mamba block, one shared transformer block
(attention + MLP, one parameter set reused at every application site) runs.
Each application site keeps its own KV cache at decode time; the cache's
``pos`` is one position per batch row (per slot of the serve pool).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.policy import RegionPlan
from repro_torch.core.regions import region
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import mamba2
from repro_torch.models.layers import TensorSpec


def n_attn_sites(cfg) -> int:
    return cfg.n_layers // cfg.attn_every if cfg.attn_every else 0


def layer_spec(cfg) -> Any:
    return {"ssm": mamba2.mamba_spec(cfg), "norm": L.norm_spec(cfg)}


def shared_spec(cfg) -> Any:
    return {
        "attn": attn.attn_spec(cfg),
        "mlp": L.mlp_spec(cfg),
        "norm1": L.norm_spec(cfg),
        "norm2": L.norm_spec(cfg),
    }


def spec(cfg) -> Any:
    from repro_torch.models.transformer import _stack_spec
    return {
        "embed": L.embed_spec(cfg),
        "blocks": _stack_spec(layer_spec(cfg), cfg.n_layers),
        "shared": shared_spec(cfg),
        "final_norm": L.norm_spec(cfg),
    }


def _is_site(cfg, li: int) -> bool:
    """Whether the shared block runs after mamba block ``li``."""
    return bool(cfg.attn_every) and (li + 1) % cfg.attn_every == 0


def _mamba_block(cfg, lp, x, plan, li, state=None):
    with region(f"layer{li}"):
        h = L.apply_norm(cfg, lp["norm"], x)
        y, st = mamba2.apply_mamba(cfg, lp["ssm"], h, plan, state)
        return x + y, st


def _shared_block(cfg, sp, x, plan, site: int, cache=None, pos=None):
    """One application of the shared transformer block: full causal
    attention without a cache, else decode against ``cache`` at ``pos``."""
    with region(f"shared_attn{site}"):
        h = L.apply_norm(cfg, sp["norm1"], x)
        if cache is None:
            x = x + attn.apply_attention(cfg, sp["attn"], h, plan)
            new_cache = None
        else:
            a, new_cache = attn.apply_attention_decode(
                cfg, sp["attn"], h, cache, pos, plan)
            x = x + a
        h = L.apply_norm(cfg, sp["norm2"], x)
        x = x + L.apply_mlp(cfg, sp["mlp"], h, plan)
        return x, new_cache


def forward(cfg, params, batch, plan: RegionPlan,
            final_logits_only: bool = False):
    x = L.apply_embed(cfg, params["embed"], batch["tokens"], plan)
    site = 0
    for li in range(cfg.n_layers):
        lp = L.tree_map(lambda a: a[li], params["blocks"])
        x, _ = _mamba_block(cfg, lp, x, plan, li)
        if _is_site(cfg, li):
            x, _ = _shared_block(cfg, params["shared"], x, plan, site)
            site += 1
    x = L.apply_norm(cfg, params["final_norm"], x)
    if final_logits_only:
        x = x[:, -1:]
    logits = L.apply_unembed(cfg, params["embed"], x, plan)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


# -- serving ----------------------------------------------------------------


def cache_spec(cfg, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16) -> Any:
    kv_one = attn.kv_cache_spec(cfg, batch, max_len, dtype)
    ssm_one = mamba2.state_spec(cfg, batch, dtype)
    return {
        "ssm": {f"l{i}": ssm_one for i in range(cfg.n_layers)},
        "kv": {f"s{i}": kv_one for i in range(n_attn_sites(cfg))},
        "pos": TensorSpec((batch,), torch.int32),
    }


def init_cache(cfg, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, device=None) -> Any:
    return L.zeros_from_spec(cache_spec(cfg, batch, max_len, dtype), device)


def decode_step(cfg, params, cache, tokens, plan: RegionPlan):
    """tokens: (B, T) at each row's ``cache['pos']`` -> (logits (B, T, V),
    new cache).  The KV caches are written in place."""
    pos = cache["pos"]
    x = L.apply_embed(cfg, params["embed"], tokens, plan)
    new_ssm, new_kv = {}, {}
    site = 0
    for li in range(cfg.n_layers):
        lp = L.tree_map(lambda a: a[li], params["blocks"])
        x, new_ssm[f"l{li}"] = _mamba_block(cfg, lp, x, plan, li,
                                            cache["ssm"][f"l{li}"])
        if _is_site(cfg, li):
            x, new_kv[f"s{site}"] = _shared_block(
                cfg, params["shared"], x, plan, site,
                cache["kv"][f"s{site}"], pos)
            site += 1
    x = L.apply_norm(cfg, params["final_norm"], x)
    logits = L.apply_unembed(cfg, params["embed"], x, plan)
    return logits, {"ssm": new_ssm, "kv": new_kv,
                    "pos": pos + tokens.shape[1]}


def prefill(cfg, params, batch, plan: RegionPlan, max_len: int):
    """The prompt from zero state -> (last-token logits (B, 1, V), cache
    with every site's K/V written for positions 0..S-1)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = L.apply_embed(cfg, params["embed"], tokens, plan)
    sp = params["shared"]
    new_ssm, new_kv = {}, {}
    site = 0
    for li in range(cfg.n_layers):
        lp = L.tree_map(lambda a: a[li], params["blocks"])
        zero = L.zeros_from_spec(mamba2.state_spec(cfg, B, x.dtype),
                                 x.device)
        x, new_ssm[f"l{li}"] = _mamba_block(cfg, lp, x, plan, li, zero)
        if _is_site(cfg, li):
            with region(f"shared_attn{site}"):
                h = L.apply_norm(cfg, sp["norm1"], x)
                new_kv[f"s{site}"] = attn.prefill_kv(
                    cfg, sp["attn"], h, plan, max_len, name=f"attn{site}")
                x = x + attn.apply_attention(cfg, sp["attn"], h, plan)
                h = L.apply_norm(cfg, sp["norm2"], x)
                x = x + L.apply_mlp(cfg, sp["mlp"], h, plan)
            site += 1
    x = L.apply_norm(cfg, params["final_norm"], x[:, -1:])
    logits = L.apply_unembed(cfg, params["embed"], x, plan)
    pos = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return logits, {"ssm": new_ssm, "kv": new_kv, "pos": pos}
