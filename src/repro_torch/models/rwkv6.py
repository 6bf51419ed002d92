"""RWKV6 "Finch" (arXiv:2404.05892) on PyTorch: attention-free time-mix
with data-dependent decay + channel-mix.

The WKV recurrence runs through :func:`repro_torch.kernels.ops.wkv`: on
the card the hand-written kernels (the fused recurrence, or the chunked
scan under ``scan_mode='chunk'``), on the CPU their plain versions.  The
chunk length is the ``chunk`` knob of the time-mix region.  Parameters are
layer-stacked under the JAX package's keys.

Decode state is O(1) in sequence length: per layer the (B, H, N, N) WKV
state in f32 and the two token-shift rows in the model dtype.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.policy import RegionPlan
from repro_torch.core.regions import region
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.layers import Spec, TensorSpec

MIX_RANK = 32
DECAY_RANK = 64
N_MIX = 5  # r,k,v,w,g


def tmix_spec(cfg) -> Any:
    d = cfg.d_model
    h, n = cfg.n_rwkv_heads, cfg.rwkv_head_dim
    return {
        "mu": Spec((N_MIX, d), (None, "embed"), "small"),
        "mix_a": Spec((d, N_MIX * MIX_RANK), ("embed", None), "small"),
        "mix_b": Spec((N_MIX, MIX_RANK, d), (None, None, "embed"), "small"),
        "w0": Spec((d,), ("embed",), "small"),
        "w_a": Spec((d, DECAY_RANK), ("embed", None), "small"),
        "w_b": Spec((DECAY_RANK, d), (None, "embed"), "small"),
        "u": Spec((h, n), (None, None), "small"),
        "wr": Spec((d, d), ("embed", "ssm_dim")),
        "wk": Spec((d, d), ("embed", "ssm_dim")),
        "wv": Spec((d, d), ("embed", "ssm_dim")),
        "wg": Spec((d, d), ("embed", "ssm_dim")),
        "wo": Spec((d, d), ("ssm_dim", "embed")),
        "ln_scale": Spec((d,), (None,), "ones"),
        "ln_bias": Spec((d,), (None,), "zeros"),
    }


def cmix_spec(cfg) -> Any:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": Spec((d,), ("embed",), "small"),
        "mu_r": Spec((d,), ("embed",), "small"),
        "wk": Spec((d, f), ("embed", "ff")),
        "wv": Spec((f, d), ("ff", "embed")),
        "wr": Spec((d, d), ("embed", "embed")),
    }


def layer_spec(cfg) -> Any:
    return {"tmix": tmix_spec(cfg), "cmix": cmix_spec(cfg),
            "ln1": L.norm_spec(cfg), "ln2": L.norm_spec(cfg)}


def spec(cfg) -> Any:
    from repro_torch.models.transformer import _stack_spec
    return {
        "embed": L.embed_spec(cfg),
        "ln_in": L.norm_spec(cfg),
        "blocks": _stack_spec(layer_spec(cfg), cfg.n_layers),
        "final_norm": L.norm_spec(cfg),
    }


def _shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Token shift: x_{t-1} with x_prev filling t=0.  x: (B,T,D)."""
    return torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)


def _ddlerp(p, x, xs):
    """Data-dependent lerp of (x, shifted x) -> five mixed streams."""
    dx = xs - x
    base = x[:, :, None, :] + dx[:, :, None, :] * p["mu"]      # (B,T,5,D)
    lowrank = torch.tanh((x + dx * p["mu"][0]) @ p["mix_a"])
    lowrank = lowrank.reshape(*lowrank.shape[:2], N_MIX, MIX_RANK)
    adj = torch.einsum("btmr,mrd->btmd", lowrank, p["mix_b"])
    mixed = base + dx[:, :, None, :] * adj
    return [mixed[:, :, i, :] for i in range(N_MIX)]


def wkv_scan(r, k, v, w, u, s0):
    """The exact WKV recurrence (the ``fused_recurrent`` kernel).

    r,k,v,w: (B,T,H,N); u: (H,N); s0: (B,H,N,N) with S[j,i] over (key j,
    val i).  Returns out (B,T,H,N), final state, both f32.
    """
    return ops.wkv(r, k, v, w, u, s0, mode="fused_recurrent")


def wkv_chunked(r, k, v, w, u, s0, chunk: int = 64):
    """Matmul-form WKV (the ``chunk`` kernel), equivalent to
    :func:`wkv_scan` up to f32 reassociation: the state is read/written
    once per chunk of ``C = min(chunk, T)`` steps.  When C does not divide
    T this returns :func:`wkv_scan`'s result exactly (the ragged
    contract)."""
    T = r.shape[1]
    C = min(chunk, T)
    if T % C:
        return wkv_scan(r, k, v, w, u, s0)
    return ops.wkv(r, k, v, w, u, s0, mode="chunk", chunk=C)


def _group_norm(p, x, h, n, eps=1e-5):
    """Per-head LayerNorm on the WKV output (RWKV's ln_x). x: (B,T,D)."""
    B, T, D = x.shape
    xh = x.reshape(B, T, h, n).float()
    mu = xh.mean(-1, keepdim=True)
    var = xh.var(-1, keepdim=True, correction=0)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    out = xh.reshape(B, T, D) * p["ln_scale"] + p["ln_bias"]
    return out.to(x.dtype)


def apply_tmix(cfg, p, x, plan: RegionPlan, state=None, name: str = "tmix"):
    """x: (B,T,D). state: None (zeros) or dict(s, x_prev)."""
    with region(name) as rpath:
        B, T, D = x.shape
        h, n = cfg.n_rwkv_heads, cfg.rwkv_head_dim
        x_prev = (state["x_prev"] if state is not None
                  else torch.zeros((B, D), dtype=x.dtype, device=x.device))
        xs = _shift(x, x_prev)
        xr, xk, xv, xw, xg = _ddlerp(p, x, xs)
        r = (xr @ p["wr"]).reshape(B, T, h, n)
        k = (xk @ p["wk"]).reshape(B, T, h, n)
        v = (xv @ p["wv"]).reshape(B, T, h, n)
        g = xg @ p["wg"]
        logw = p["w0"] + torch.tanh(xw @ p["w_a"]) @ p["w_b"]
        w = torch.exp(-torch.exp(logw.float())).reshape(B, T, h, n)

        s0 = (state["s"] if state is not None
              else torch.zeros((B, h, n, n), dtype=torch.float32,
                               device=x.device))
        knobs = plan.config_for(rpath)
        # scan_mode 'chunk' = matmul-form parallel scan (prefill-optimal);
        # anything else = the exact sequential recurrence ('auto' is
        # resolved to a concrete mode by the serve engine before planning)
        args = (r.float(), k.float(), v.float(), w, p["u"].float(), s0)
        if knobs.scan_mode == "chunk" and T > 1:
            out, s_new = wkv_chunked(*args, knobs.chunk or 64)
        else:
            out, s_new = wkv_scan(*args)
        out = out.reshape(B, T, D).to(x.dtype)
        out = _group_norm(p, out, h, n) * F.silu(g)
        y = out @ p["wo"]
        y = plan.constrain(y, rpath, ("batch", "seq", "embed"))
        return y, {"s": s_new, "x_prev": x[:, -1, :]}


def apply_cmix(cfg, p, x, plan: RegionPlan, state=None, name: str = "cmix"):
    with region(name) as rpath:
        B, T, D = x.shape
        x_prev = (state["x_prev"] if state is not None
                  else torch.zeros((B, D), dtype=x.dtype, device=x.device))
        xs = _shift(x, x_prev)
        xk = x + (xs - x) * p["mu_k"]
        xr = x + (xs - x) * p["mu_r"]
        kk = torch.square(torch.relu(xk @ p["wk"]))
        vv = kk @ p["wv"]
        rr = torch.sigmoid(xr @ p["wr"])
        y = plan.constrain(rr * vv, rpath, ("batch", "seq", "embed"))
        return y, {"x_prev": x[:, -1, :]}


def _layer(cfg, lp, x, plan, li, state=None):
    with region(f"layer{li}"):
        st_t = state["tmix"] if state is not None else None
        st_c = state["cmix"] if state is not None else None
        h = L.apply_norm(cfg, lp["ln1"], x)
        y, st_t2 = apply_tmix(cfg, lp["tmix"], h, plan, st_t)
        x = x + y
        h = L.apply_norm(cfg, lp["ln2"], x)
        y, st_c2 = apply_cmix(cfg, lp["cmix"], h, plan, st_c)
        x = x + y
        return x, {"tmix": st_t2, "cmix": st_c2}


def _stack(cfg, params, x, plan, states):
    """ln_in, every layer (each from ``states[li]``), final norm; returns
    (x, the layers' new states)."""
    x = L.apply_norm(cfg, params["ln_in"], x)
    new = {}
    for li in range(cfg.n_layers):
        lp = L.tree_map(lambda a: a[li], params["blocks"])
        x, new[f"l{li}"] = _layer(cfg, lp, x, plan, li, states(li))
    return x, new


def forward(cfg, params, batch, plan: RegionPlan,
            final_logits_only: bool = False):
    x = L.apply_embed(cfg, params["embed"], batch["tokens"], plan)
    x, _ = _stack(cfg, params, x, plan, lambda li: None)
    x = L.apply_norm(cfg, params["final_norm"], x)
    if final_logits_only:
        x = x[:, -1:]
    logits = L.apply_unembed(cfg, params["embed"], x, plan)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


# -- serving ----------------------------------------------------------------


def cache_spec(cfg, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16) -> Any:
    """Per-slot recurrent state; ``pos`` is one int32 per batch row."""
    h, n, d = cfg.n_rwkv_heads, cfg.rwkv_head_dim, cfg.d_model
    per_layer = {
        "tmix": {"s": TensorSpec((batch, h, n, n), torch.float32),
                 "x_prev": TensorSpec((batch, d), dtype)},
        "cmix": {"x_prev": TensorSpec((batch, d), dtype)},
    }
    return {
        "layers": {f"l{i}": per_layer for i in range(cfg.n_layers)},
        "pos": TensorSpec((batch,), torch.int32),
    }


def init_cache(cfg, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, device=None) -> Any:
    return L.zeros_from_spec(cache_spec(cfg, batch, max_len, dtype), device)


def decode_step(cfg, params, cache, tokens, plan: RegionPlan):
    """tokens: (B, T) folded into the cache's state -> (logits (B, T, V),
    new cache)."""
    x = L.apply_embed(cfg, params["embed"], tokens, plan)
    x, new = _stack(cfg, params, x, plan,
                    lambda li: cache["layers"][f"l{li}"])
    x = L.apply_norm(cfg, params["final_norm"], x)
    logits = L.apply_unembed(cfg, params["embed"], x, plan)
    return logits, {"layers": new, "pos": cache["pos"] + tokens.shape[1]}


def prefill(cfg, params, batch, plan: RegionPlan, max_len: int):
    """The prompt from zero state -> (last-token logits (B, 1, V), cache)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = L.apply_embed(cfg, params["embed"], tokens, plan)
    zero = init_cache(cfg, B, max_len, x.dtype, x.device)["layers"]
    x, new = _stack(cfg, params, x, plan, lambda li: zero[f"l{li}"])
    x = L.apply_norm(cfg, params["final_norm"], x[:, -1:])
    logits = L.apply_unembed(cfg, params["embed"], x, plan)
    pos = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return logits, {"layers": new, "pos": pos}
