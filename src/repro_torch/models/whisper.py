"""Whisper-large-v3 backbone on PyTorch: an encoder-decoder transformer.

The conv/mel frontend is a stub, as in the JAX package: the caller gives
precomputed frame embeddings ``frames`` (B, enc_len, d_model), enc_len
padded 1500 -> 1536.  Encoder and decoder both take sinusoidal positions
(whisper proper learns its decoder positions; the JAX package's configs
are shape-mechanical by design), and no attention rotates q or K.

Parameters are layer-stacked (``enc_blocks``, ``dec_blocks``), the JAX
package's layout, so its param tree bridges across unchanged
(:func:`repro_torch.models.model.params_from_numpy`).  The decoder's
cross-attention projects K/V from the encoder output on every call,
decode steps included: the JAX package keeps no cross-K/V cache, and
neither does the port.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.policy import RegionPlan
from repro_torch.core.regions import region
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.transformer import _layer_params, _stack_spec


def _angles(pos: torch.Tensor, d: int) -> torch.Tensor:
    """pos (..., 1) f32 -> (..., d/2) angles pos / 10000^(2i/d)."""
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=pos.device)
    return pos / torch.pow(10000.0, dim / d)


def _sinusoid(seq: int, d: int, dtype: torch.dtype,
              device=None) -> torch.Tensor:
    """(seq, d) sinusoidal positions 0..seq-1: sines, then cosines."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    ang = _angles(pos, d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)


def enc_layer_spec(cfg) -> Any:
    return {"attn": attn.attn_spec(cfg), "mlp": L.mlp_spec(cfg),
            "norm1": L.norm_spec(cfg), "norm2": L.norm_spec(cfg)}


def dec_layer_spec(cfg) -> Any:
    return {"self_attn": attn.attn_spec(cfg),
            "cross_attn": attn.attn_spec(cfg, cross=True),
            "mlp": L.mlp_spec(cfg),
            "norm1": L.norm_spec(cfg), "norm2": L.norm_spec(cfg),
            "norm3": L.norm_spec(cfg)}


def spec(cfg) -> Any:
    return {
        "embed": L.embed_spec(cfg),
        "enc_blocks": _stack_spec(enc_layer_spec(cfg), cfg.n_enc_layers),
        "dec_blocks": _stack_spec(dec_layer_spec(cfg), cfg.n_layers),
        "enc_norm": L.norm_spec(cfg),
        "final_norm": L.norm_spec(cfg),
    }


def encode(cfg, params, frames: torch.Tensor,
           plan: RegionPlan) -> torch.Tensor:
    """frames (B, enc_len, D) -> encoder output (B, enc_len, D): sinusoidal
    positions, ``n_enc_layers`` pre-norm layers of non-causal
    self-attention (no rope) and the GELU MLP, then ``enc_norm``."""
    def enc_fn(h_in, lp, li):
        with region(f"enc{li}"):
            h = L.apply_norm(cfg, lp["norm1"], h_in)
            h_in = h_in + attn.apply_attention(cfg, lp["attn"], h, plan,
                                               causal=False, rope=False)
            h = L.apply_norm(cfg, lp["norm2"], h_in)
            return h_in + L.apply_mlp(cfg, lp["mlp"], h, plan)

    with region("encoder"):
        x = frames + _sinusoid(frames.shape[1], cfg.d_model, frames.dtype,
                               frames.device)
        x = plan.constrain(x, "encoder", ("batch", "enc_seq", "embed"))
        layers = _layer_params(params["enc_blocks"], cfg.n_enc_layers)
        for li, lp in enumerate(layers):
            x = L.maybe_remat(lambda h, lp=lp, li=li: enc_fn(h, lp, li), x,
                             plan, f"enc{li}")
        return L.apply_norm(cfg, params["enc_norm"], x)


def _dec_layer(cfg, lp, x, enc_out, plan: RegionPlan, li: int, cache=None,
               pos=None):
    """One decoder layer: causal self-attention (on ``cache`` at ``pos``
    when given), cross-attention on ``enc_out``, the MLP.  Returns (x, the
    self-attention's cache or None)."""
    with region(f"dec{li}"):
        h = L.apply_norm(cfg, lp["norm1"], x)
        if cache is None:
            x = x + attn.apply_attention(cfg, lp["self_attn"], h, plan,
                                         causal=True, rope=False,
                                         name="self_attn")
            new_kv = None
        else:
            a, new_kv = attn.apply_attention_decode(
                cfg, lp["self_attn"], h, cache, pos, plan, name="self_attn")
            x = x + a
        h = L.apply_norm(cfg, lp["norm2"], x)
        x = x + attn.apply_attention(cfg, lp["cross_attn"], h, plan,
                                     kv_x=enc_out, causal=False, rope=False,
                                     name="cross_attn")
        h = L.apply_norm(cfg, lp["norm3"], x)
        x = x + L.apply_mlp(cfg, lp["mlp"], h, plan)
        return x, new_kv


def forward(cfg, params, batch, plan: RegionPlan,
            final_logits_only: bool = False):
    """batch {"frames" (B, enc_len, D), "tokens" (B, S)} -> (logits
    (B, S, V), 0 f32: whisper has no aux loss)."""
    enc_out = encode(cfg, params, batch["frames"], plan)
    x = L.apply_embed(cfg, params["embed"], batch["tokens"], plan)
    x = x + _sinusoid(x.shape[1], cfg.d_model, x.dtype, x.device)
    layers = _layer_params(params["dec_blocks"], cfg.n_layers)
    for li, lp in enumerate(layers):
        x = L.maybe_remat(
            lambda h, lp=lp, li=li: _dec_layer(cfg, lp, h, enc_out, plan,
                                               li)[0],
            x, plan, f"dec{li}")
    x = L.apply_norm(cfg, params["final_norm"], x)
    if final_logits_only:
        x = x[:, -1:]
    logits = L.apply_unembed(cfg, params["embed"], x, plan)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


# -- serving ----------------------------------------------------------------


def cache_spec(cfg, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16) -> Any:
    """The decoder's self-attention K/V per layer, the encoder output the
    cross-attention reads, and ``pos``: one int32 per batch row (the JAX
    package keeps one scalar for the batch)."""
    kv = attn.kv_cache_spec(cfg, batch, max_len, dtype)
    return {
        "self_kv": {f"l{i}": kv for i in range(cfg.n_layers)},
        "enc_out": L.TensorSpec((batch, cfg.enc_len, cfg.d_model), dtype),
        "pos": L.TensorSpec((batch,), torch.int32),
    }


def init_cache(cfg, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, device=None) -> Any:
    return L.zeros_from_spec(cache_spec(cfg, batch, max_len, dtype), device)


def decode_step(cfg, params, cache, tokens, plan: RegionPlan):
    """tokens (B, 1) at each row's ``cache['pos']`` -> (logits (B, 1, V),
    new cache); the self-attention caches are written in place, and each
    layer's cross-attention projects K/V from ``cache['enc_out']`` anew."""
    pos = cache["pos"]
    x = L.apply_embed(cfg, params["embed"], tokens, plan)
    ang = _angles(pos.float()[:, None], cfg.d_model)            # (B, d/2)
    pe = torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(x.dtype)
    x = x + pe[:, None, :]
    enc_out = cache["enc_out"]
    new_kv = {}
    layers = _layer_params(params["dec_blocks"], cfg.n_layers)
    for li, lp in enumerate(layers):
        x, new_kv[f"l{li}"] = _dec_layer(cfg, lp, x, enc_out, plan, li,
                                         cache["self_kv"][f"l{li}"], pos)
    x = L.apply_norm(cfg, params["final_norm"], x)
    logits = L.apply_unembed(cfg, params["embed"], x, plan)
    return logits, {"self_kv": new_kv, "enc_out": enc_out, "pos": pos + 1}


def prefill(cfg, params, batch, plan: RegionPlan, max_len: int):
    """Encode the frames and run the decoder over the prompt: last-token
    logits (B, 1, V) and a filled cache at ``pos`` = S."""
    enc_out = encode(cfg, params, batch["frames"], plan)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = L.apply_embed(cfg, params["embed"], tokens, plan)
    x = x + _sinusoid(S, cfg.d_model, x.dtype, x.device)
    caches = {}
    layers = _layer_params(params["dec_blocks"], cfg.n_layers)
    for li, lp in enumerate(layers):
        with region(f"dec{li}"):
            h = L.apply_norm(cfg, lp["norm1"], x)
            caches[f"l{li}"] = attn.prefill_kv(cfg, lp["self_attn"], h, plan,
                                               max_len, name="self_attn")
        x, _ = _dec_layer(cfg, lp, x, enc_out, plan, li)
    x = L.apply_norm(cfg, params["final_norm"], x[:, -1:])
    logits = L.apply_unembed(cfg, params["embed"], x, plan)
    pos = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return logits, {"self_kv": caches, "enc_out": enc_out, "pos": pos}
