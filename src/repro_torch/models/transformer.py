"""Generic dense decoder LM (qwen3-8b/32b, stablelm, h2o-danube), on
PyTorch.  Parameters are stored layer-stacked (leading ``layers`` axis),
the JAX package's layout, so its param tree bridges across unchanged
(:func:`repro_torch.models.model.params_from_numpy`).

Dense families only: MoE is not ported yet (ROADMAP queue 1 item 11).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.policy import RegionPlan
from repro_torch.core.regions import region
from repro_torch.models import attention as attn
from repro_torch.models import layers as L


def _require_dense(cfg) -> None:
    if cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet (ROADMAP queue 1 "
            f"item 11)")


def _stack_spec(spec_tree: Any, n: int) -> Any:
    return L.tree_map(
        lambda s: L.Spec((n,) + s.shape, ("layers",) + s.axes, s.init, s.scale),
        spec_tree)


def layer_spec(cfg) -> Any:
    _require_dense(cfg)
    return {
        "attn": attn.attn_spec(cfg),
        "mlp": L.mlp_spec(cfg),
        "norm1": L.norm_spec(cfg),
        "norm2": L.norm_spec(cfg),
    }


def spec(cfg) -> Any:
    return {
        "embed": L.embed_spec(cfg),
        "blocks": _stack_spec(layer_spec(cfg), cfg.n_layers),
        "final_norm": L.norm_spec(cfg),
    }


def _layer_params(blocks: Any, li: int) -> Any:
    """Layer ``li``'s slice of the stacked block params (views)."""
    return L.tree_map(lambda a: a[li], blocks)


def _block_loop(cfg, params, x, plan: RegionPlan, attn_apply):
    """Shared per-layer body of every step (forward, slot decode and
    prefill, paged decode, prefill chunk): norm1 -> attention
    (``attn_apply(li, lp, h)`` returns (out, the layer's new cache)) ->
    norm2 -> mlp.  Returns (x, {"l<i>": new cache})."""
    _require_dense(cfg)
    blocks = params["blocks"]
    new_layers = {}
    for li in range(cfg.n_layers):
        lp = _layer_params(blocks, li)
        with region(f"layer{li}"):
            h = L.apply_norm(cfg, lp["norm1"], x)
            a, new_layers[f"l{li}"] = attn_apply(li, lp, h)
            x = x + a
            h = L.apply_norm(cfg, lp["norm2"], x)
            x = x + L.apply_mlp(cfg, lp["mlp"], h, plan)
            x = plan.constrain(x, f"layer{li}", ("batch", "seq", "embed"))
    return x, new_layers


def forward(cfg, params, batch, plan: RegionPlan,
            final_logits_only: bool = False):
    """Full-sequence forward: returns (logits, aux_loss=0)."""
    x = L.apply_embed(cfg, params["embed"], batch["tokens"], plan)
    x, _ = _block_loop(cfg, params, x, plan,
                       lambda li, lp, h: (attn.apply_attention(
                           cfg, lp["attn"], h, plan), None))
    x = L.apply_norm(cfg, params["final_norm"], x)
    if final_logits_only:
        x = x[:, -1:]
    logits = L.apply_unembed(cfg, params["embed"], x, plan)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


# -- serving: the slot pool -------------------------------------------------


def cache_spec(cfg, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16) -> Any:
    """Whole per-request K/V caches; ``pos`` is one int32 per batch row."""
    one = attn.kv_cache_spec(cfg, batch, max_len, dtype)
    return {"layers": {f"l{i}": one for i in range(cfg.n_layers)},
            "pos": L.TensorSpec((batch,), torch.int32)}


def init_cache(cfg, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, device=None) -> Any:
    return L.zeros_from_spec(cache_spec(cfg, batch, max_len, dtype), device)


def decode_step(cfg, params, cache, tokens, plan: RegionPlan):
    """tokens: (B, 1) at each row's ``cache['pos']`` -> (logits (B, 1, V),
    new cache); the K/V caches are written in place."""
    pos = cache["pos"]
    x = L.apply_embed(cfg, params["embed"], tokens, plan)
    x, new_layers = _block_loop(
        cfg, params, x, plan,
        lambda li, lp, h: attn.apply_attention_decode(
            cfg, lp["attn"], h, cache["layers"][f"l{li}"], pos, plan))
    x = L.apply_norm(cfg, params["final_norm"], x)
    logits = L.apply_unembed(cfg, params["embed"], x, plan)
    return logits, {"layers": new_layers, "pos": pos + 1}


def prefill(cfg, params, batch, plan: RegionPlan, max_len: int):
    """Forward over the prompt, returning last-token logits (B, 1, V) and
    a filled cache."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = L.apply_embed(cfg, params["embed"], tokens, plan)
    x, caches = _block_loop(
        cfg, params, x, plan,
        lambda li, lp, h: (attn.apply_attention(cfg, lp["attn"], h, plan),
                           attn.prefill_kv(cfg, lp["attn"], h, plan,
                                           max_len)))
    x = L.apply_norm(cfg, params["final_norm"], x[:, -1:])
    logits = L.apply_unembed(cfg, params["embed"], x, plan)
    pos = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return logits, {"layers": caches, "pos": pos}


# -- serving: the paged pool ------------------------------------------------


def paged_cache_spec(cfg, n_pages: int, page_size: int) -> Any:
    """Global page-pool cache shapes: per-layer K/V block pools, no
    per-request axis — block tables and lengths live on the host (see
    serve/cache.py)."""
    shape = attn.paged_kv_shape(cfg, n_pages, page_size)
    return {"layers": {f"l{i}": {"k_pages": shape, "v_pages": shape}
                       for i in range(cfg.n_layers)}}


def paged_decode_step(cfg, params, pages, tokens, block_tables, lengths,
                      plan: RegionPlan):
    """One decode step for every pool slot, natively batched over slots.

    tokens: (B, S) — S=1 for plain decode, S=spec_depth+1 for the
    speculative verify step; block_tables: (B, MP) int32 (all-zero rows
    park a slot on the null page); lengths: (B,) int32 tokens already
    written per slot.  ``pages`` is updated in place.  Returns
    (logits (B, S, V), pages).
    """
    x = L.apply_embed(cfg, params["embed"], tokens, plan)
    x, _ = _block_loop(
        cfg, params, x, plan,
        lambda li, lp, h: attn.apply_attention_paged_decode(
            cfg, lp["attn"], h, pages["layers"][f"l{li}"],
            block_tables, lengths, plan))
    x = L.apply_norm(cfg, params["final_norm"], x)
    logits = L.apply_unembed(cfg, params["embed"], x, plan)
    return logits, pages


def prefill_chunk_step(cfg, params, pages, tokens, block_table, base,
                       plan: RegionPlan):
    """Prefill one chunk of one request's prompt into its pages (in place).

    tokens: (1, C); block_table: (MP,) the request's page ids; base:
    absolute position of the chunk's first token.  Returns pages — the
    first generated token comes from feeding the last prompt token through
    the shared decode step.
    """
    x = L.apply_embed(cfg, params["embed"], tokens, plan)
    _block_loop(
        cfg, params, x, plan,
        lambda li, lp, h: attn.apply_attention_paged_chunk(
            cfg, lp["attn"], h, pages["layers"][f"l{li}"],
            block_table, base, plan))
    return pages
