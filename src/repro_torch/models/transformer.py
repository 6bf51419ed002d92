"""Generic decoder LM (qwen3-8b/32b, stablelm, h2o-danube, the
internvl2 backbone; with :mod:`repro_torch.models.moe` layers, qwen2-moe
and granite-moe), on PyTorch.  Parameters are stored layer-stacked (leading ``layers`` axis),
the JAX package's layout, so its param tree bridges across unchanged
(:func:`repro_torch.models.model.params_from_numpy`).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import regions
from repro_torch.core.policy import RegionPlan
from repro_torch.core.regions import region
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod


def _stack_spec(spec_tree: Any, n: int) -> Any:
    return L.tree_map(
        lambda s: L.Spec((n,) + s.shape, ("layers",) + s.axes, s.init, s.scale),
        spec_tree)


def layer_spec(cfg) -> Any:
    return {
        "attn": attn.attn_spec(cfg),
        "mlp": moe_mod.moe_spec(cfg) if cfg.n_experts else L.mlp_spec(cfg),
        "norm1": L.norm_spec(cfg),
        "norm2": L.norm_spec(cfg),
    }


def spec(cfg) -> Any:
    return {
        "embed": L.embed_spec(cfg),
        "blocks": _stack_spec(layer_spec(cfg), cfg.n_layers),
        "final_norm": L.norm_spec(cfg),
    }


def _layer_params(blocks: Any, n: int) -> list:
    """Each layer's slice of the stacked block params (views), from one
    ``unbind`` a leaf: its backward stacks the layers' gradients into the
    stacked leaf's in one op, where indexing ``a[li]`` would zero-fill a
    full-size gradient for every layer and add them up."""
    per_leaf = L.tree_map(lambda a: a.unbind(0), blocks)
    return [L.tree_map(lambda t: t[li], per_leaf) for li in range(n)]


def _block_loop(cfg, params, x, plan: RegionPlan, attn_apply,
                moe_group: str = "seq", remat: bool = False,
                global_aux: bool = False):
    """Shared per-layer body of every step (forward, slot decode and
    prefill, paged decode, prefill chunk): norm1 -> attention
    (``attn_apply(li, lp, h)`` returns (out, the layer's new cache)) ->
    norm2 -> mlp, or MoE grouped by ``moe_group`` ('flat' for decode).
    Returns (x, {"l<i>": new cache}, the MoE aux losses summed over
    layers, or None for a dense model).  With ``remat`` (the forward's),
    a layer whose plan entry sets ``remat`` is recomputed in the backward
    (:func:`repro_torch.core.regions.remat`) when grad mode is on; its
    cache is None.  ``global_aux``: the MoE aux losses of the whole batch
    over the plan's mesh (the training forward's)."""
    layers = _layer_params(params["blocks"], cfg.n_layers)
    new_layers = {}
    aux_total = None
    for li in range(cfg.n_layers):
        lp = layers[li]

        def body(x, li=li, lp=lp):
            with region(f"layer{li}"):
                h = L.apply_norm(cfg, lp["norm1"], x)
                a, cache = attn_apply(li, lp, h)
                x = x + a
                h = L.apply_norm(cfg, lp["norm2"], x)
                if cfg.n_experts:
                    y, aux = moe_mod.apply_moe(cfg, lp["mlp"], h, plan,
                                               group=moe_group,
                                               global_aux=global_aux)
                else:
                    y, aux = L.apply_mlp(cfg, lp["mlp"], h, plan), None
                x = x + y
                x = plan.constrain(x, f"layer{li}", ("batch", "seq", "embed"))
                return x, cache, aux

        if (remat and torch.is_grad_enabled()
                and plan.config_for(f"layer{li}").remat):
            x, aux = regions.remat(lambda h, body=body: body(h)[::2], x)
            new_layers[f"l{li}"] = None
        else:
            x, new_layers[f"l{li}"], aux = body(x)
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
    return x, new_layers, aux_total


def _vision_stub(cfg, x: torch.Tensor, batch) -> torch.Tensor:
    """A VLM's stubbed vision frontend: the first
    ``vision_embeds.shape[1]`` positions of the embedded tokens are
    replaced by the given (precomputed) patch embeddings, cast to the
    activations' dtype."""
    if cfg.frontend == "vision_patches" and "vision_embeds" in batch:
        with region("vision_stub"):
            ve = batch["vision_embeds"].to(x.dtype)
            x = torch.cat([ve, x[:, ve.shape[1]:]], dim=1)
    return x


def forward(cfg, params, batch, plan: RegionPlan,
            final_logits_only: bool = False):
    """Full-sequence forward: returns (logits, the MoE aux loss summed
    over layers; 0 for a dense model).  Layers whose plan entry sets
    ``remat`` are recomputed in the backward.  A VLM's ``vision_embeds``
    (B, N, D) take the place of its first N token embeddings."""
    x = L.apply_embed(cfg, params["embed"], batch["tokens"], plan)
    x = _vision_stub(cfg, x, batch)
    x, _, aux = _block_loop(cfg, params, x, plan,
                            lambda li, lp, h: (attn.apply_attention(
                                cfg, lp["attn"], h, plan), None),
                            remat=True, global_aux=True)
    x = L.apply_norm(cfg, params["final_norm"], x)
    if final_logits_only:
        x = x[:, -1:]
    logits = L.apply_unembed(cfg, params["embed"], x, plan)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits, aux


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


def decode_step(cfg, params, cache, tokens, plan: RegionPlan,
                moe_group: str = "flat"):
    """tokens: (B, S) at each row's ``cache['pos']`` -> (logits (B, S, V),
    new cache); the K/V caches are written in place.  MoE layers route the
    whole batch as one group, or each row alone (``moe_group='row'``: the
    slot pool, whose step the JAX package vmaps over single requests)."""
    pos = cache["pos"]
    x = L.apply_embed(cfg, params["embed"], tokens, plan)
    x, new_layers, _ = _block_loop(
        cfg, params, x, plan,
        lambda li, lp, h: attn.apply_attention_decode(
            cfg, lp["attn"], h, cache["layers"][f"l{li}"], pos, plan),
        moe_group=moe_group)
    x = L.apply_norm(cfg, params["final_norm"], x)
    logits = L.apply_unembed(cfg, params["embed"], x, plan)
    return logits, {"layers": new_layers, "pos": pos + 1}


def prefill(cfg, params, batch, plan: RegionPlan, max_len: int):
    """Forward over the prompt, returning last-token logits (B, 1, V) and
    a filled cache (a VLM's ``vision_embeds`` as in :func:`forward`)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = L.apply_embed(cfg, params["embed"], tokens, plan)
    x = _vision_stub(cfg, x, batch)
    x, caches, _ = _block_loop(
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
    x, _, _ = _block_loop(
        cfg, params, x, plan,
        lambda li, lp, h: attn.apply_attention_paged_decode(
            cfg, lp["attn"], h, pages["layers"][f"l{li}"],
            block_tables, lengths, plan),
        moe_group="flat")
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
            block_table, base, plan),
        moe_group="seq")
    return pages
