"""Attention on PyTorch: full-sequence causal (train / forward / prefill),
the slot pool's KV-cache decode, and the paged KV pool's decode and
chunked-prefill steps.

K/V caches and page pools are updated **in place** (``index_put_``): the
JAX package donates the cache buffers to each step, and mutating the
cache's own tensors is the PyTorch form of the same contract — a pool
keeps the same tensor objects across steps, copy-on-write copies and
rollbacks.  A caller that needs the old contents (a speculative snapshot)
clones them first.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.core.policy import RegionPlan
from repro_torch.core.regions import region
from repro_torch.kernels import ops
from repro_torch.models.layers import Spec, TensorSpec, apply_rope

NEG_INF = -1e30


def attn_spec(cfg, cross: bool = False) -> Any:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    p = {
        "wq": Spec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": Spec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": Spec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": Spec((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm and not cross:
        p["q_norm"] = Spec((hd,), (None,), "ones")
        p["k_norm"] = Spec((hd,), (None,), "ones")
    return p


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    out = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (out * scale.float()).to(x.dtype)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, D) @ (D, H, HD) -> (B, S, H, HD)."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _out_proj(attn: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """(B, S, H, HD) @ (H, HD, D) -> (B, S, D)."""
    return attn.flatten(-2) @ wo.reshape(-1, wo.shape[-1])


def _masked_softmax(s: torch.Tensor, valid: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """Scores in any dtype -> probabilities in ``dtype``: masked in f32
    with the finite ``-1e30``, softmax in f32."""
    s = s.float().masked_fill(~valid, NEG_INF)
    return torch.softmax(s, dim=-1).to(dtype)


def _qkv_rope(cfg, p, x, positions):
    """Shared decode/chunk preamble: project q and the new K/V rows,
    qk-norm, rope at the given absolute positions."""
    q = _proj(x, p["wq"])
    k_new = _proj(x, p["wk"])
    v_new = _proj(x, p["wv"])
    if cfg.qk_norm and "q_norm" in p:
        q = _rms(q, p["q_norm"])
        k_new = _rms(k_new, p["k_norm"])
    q = apply_rope(cfg, q, positions)
    k_new = apply_rope(cfg, k_new, positions)
    return q, k_new, v_new


def apply_attention(cfg, p, x: torch.Tensor, plan: RegionPlan, *,
                    name: str = "attn") -> torch.Tensor:
    """Full-sequence causal self-attention (the ``forward`` path), GQA
    grouped so K/V are never repeated to the full head count."""
    with region(name) as rpath:
        B, S, _ = x.shape
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        q, k, v = _qkv_rope(cfg, p, x, positions)
        hd = q.shape[-1]
        kvh, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
        qg = q.reshape(B, S, kvh, g, hd)
        s = torch.einsum("bqhge,bkhe->bhgqk", qg, k) / math.sqrt(hd)
        valid = torch.ones((S, S), dtype=torch.bool, device=x.device)
        if cfg.causal:
            valid = torch.tril(valid)
        if cfg.swa_window:
            idx = torch.arange(S, device=x.device)
            valid &= (idx[:, None] - idx[None, :]) < cfg.swa_window
        probs = _masked_softmax(s, valid, x.dtype)
        attn = torch.einsum("bhgqk,bkhe->bqhge", probs, v)
        out = _out_proj(attn.reshape(B, S, cfg.n_heads, hd), p["wo"])
        return plan.constrain(out, rpath, ("batch", "seq", "embed"))


# ---------------------------------------------------------------------------
# KV cache (slot-pool decode)
# ---------------------------------------------------------------------------


def kv_cache_spec(cfg, batch: int, max_len: int,
                  dtype: torch.dtype = torch.bfloat16):
    """Cache shapes for one attention instance.  SWA uses a ring of window
    size."""
    size = min(max_len, cfg.swa_window) if cfg.swa_window else max_len
    shape = (batch, size, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": TensorSpec(shape, dtype), "v": TensorSpec(shape, dtype)}


def init_kv_cache(cfg, batch: int, max_len: int,
                  dtype: torch.dtype = torch.bfloat16, device=None):
    return {name: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for name, s in kv_cache_spec(cfg, batch, max_len,
                                         dtype).items()}


def _is_ring(cfg, cache) -> bool:
    return bool(cfg.swa_window) and cache["k"].shape[1] == cfg.swa_window


def _cache_write(cache, k_new, v_new, start) -> None:
    """Write T new rows per batch row b at ``start[b]..start[b]+T-1`` of
    the cache, in place.  k_new/v_new: (B, T, KV, HD); start: (B,) long,
    already inside [0, C - T]."""
    B, T = k_new.shape[:2]
    rows = start[:, None] + torch.arange(T, device=start.device)[None, :]
    bidx = torch.arange(B, device=start.device)[:, None].expand(B, T)
    cache["k"].index_put_((bidx, rows), k_new.to(cache["k"].dtype))
    cache["v"].index_put_((bidx, rows), v_new.to(cache["v"].dtype))


def _clamp_start(pos, C: int, T: int):
    """Where T rows starting at ``pos`` land in a C-row cache: ``pos``
    clamped into [0, C - T], as ``jax.lax.dynamic_update_slice`` clamps a
    start index.  A parked pool slot keeps decoding and its position grows
    past the cache; its rows then pile up at the end instead of indexing
    out of bounds."""
    return pos.long().clamp(0, C - T)


def apply_attention_decode(cfg, p, x, cache, pos, plan: RegionPlan,
                           name: str = "attn"):
    """Decode a short block of T tokens against a KV cache.

    x: (B, T, D); cache: {"k","v"}: (B, C, KV, HD), written in place;
    pos: (B,) int32 — tokens already in each row's cache (rows decode at
    their own positions, each with its own RoPE angles and mask).  T=1 is
    the classic single-token step (SWA rings supported); T>1 writes T rows
    at pos..pos+T-1 and attends under the staircase mask (chunked
    state-prefill and speculative verify; rings unsupported).  Returns
    (out (B, T, D), cache).
    """
    if x.shape[1] > 1:
        return _attention_decode_block(cfg, p, x, cache, pos, plan, name)
    with region(name) as rpath:
        B = x.shape[0]
        C = cache["k"].shape[1]
        ring = _is_ring(cfg, cache)
        positions = pos.long()[:, None]                       # (B, 1)
        q, k_new, v_new = _qkv_rope(cfg, p, x, positions)
        start = (torch.remainder(positions[:, 0], C) if ring
                 else _clamp_start(pos, C, 1))
        _cache_write(cache, k_new, v_new, start)
        # absolute position of each cache row
        idx = torch.arange(C, device=x.device)[None, :]
        if ring:
            # rows hold positions pos-C+1..pos once full; invalid before
            k_pos = positions - torch.remainder(positions - idx, C)
        else:
            k_pos = idx.expand(B, C)
        valid = (k_pos <= positions) & (k_pos >= 0)            # (B, C)
        hd = q.shape[-1]
        kvh, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
        qg = q.reshape(B, 1, kvh, g, hd)
        s = torch.einsum("bqhge,bkhe->bhgqk", qg, cache["k"]) / math.sqrt(hd)
        probs = _masked_softmax(s, valid[:, None, None, None, :], x.dtype)
        attn = torch.einsum("bhgqk,bkhe->bqhge", probs, cache["v"])
        out = _out_proj(attn.reshape(B, 1, cfg.n_heads, hd), p["wo"])
        return plan.constrain(out, rpath, ("batch", "seq", "embed")), cache


def _attention_decode_block(cfg, p, x, cache, pos, plan: RegionPlan,
                            name: str = "attn"):
    """T>1 branch of :func:`apply_attention_decode`: contiguous rows at
    pos..pos+T-1 per batch row, staircase-masked (query i sees every cache
    row through its own write).  Non-ring caches only."""
    with region(name) as rpath:
        B, T, _ = x.shape
        C = cache["k"].shape[1]
        if _is_ring(cfg, cache):
            raise ValueError("multi-token decode unsupported on SWA ring "
                             "caches")
        positions = (pos.long()[:, None]
                     + torch.arange(T, device=x.device)[None, :])  # (B, T)
        q, k_new, v_new = _qkv_rope(cfg, p, x, positions)
        _cache_write(cache, k_new, v_new, _clamp_start(pos, C, T))
        k_pos = torch.arange(C, device=x.device)
        valid = k_pos[None, None, :] <= positions[:, :, None]   # (B, T, C)
        hd = q.shape[-1]
        kvh, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
        qg = q.reshape(B, T, kvh, g, hd)
        s = torch.einsum("bshge,bkhe->bhsgk", qg, cache["k"]) / math.sqrt(hd)
        probs = _masked_softmax(s, valid[:, None, :, None, :], x.dtype)
        attn = torch.einsum("bhsgk,bkhe->bshge", probs, cache["v"])
        out = _out_proj(attn.reshape(B, T, cfg.n_heads, hd), p["wo"])
        return plan.constrain(out, rpath, ("batch", "seq", "embed")), cache


def prefill_kv(cfg, p, x, plan: RegionPlan, max_len: int,
               name: str = "attn"):
    """K/V of a full prompt written into a fresh cache: positions 0..S-1
    (zero-padded to the cache length), or the last window of a ring with
    position t at row t mod C."""
    with region(name + ".fill"):
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device)
        k = _proj(x, p["wk"])
        if cfg.qk_norm and "k_norm" in p:
            k = _rms(k, p["k_norm"])
        k = apply_rope(cfg, k, positions)
        v = _proj(x, p["wv"])
        C = min(max_len, cfg.swa_window) if cfg.swa_window else max_len
        ring = bool(cfg.swa_window) and C == cfg.swa_window
        if S >= C:
            k_c, v_c = k[:, S - C:], v[:, S - C:]
            if ring:
                # ring invariant: row j holds absolute position t, t mod C == j
                k_c = torch.roll(k_c, S % C, dims=1)
                v_c = torch.roll(v_c, S % C, dims=1)
            return {"k": k_c.contiguous(), "v": v_c.contiguous()}
        pad = (0, 0, 0, 0, 0, C - S)
        return {"k": torch.nn.functional.pad(k, pad),
                "v": torch.nn.functional.pad(v, pad)}


# ---------------------------------------------------------------------------
# Paged KV cache (block-pool decode + chunked prefill)
# ---------------------------------------------------------------------------


def paged_kv_shape(cfg, n_pages: int, page_size: int) -> tuple:
    """Shape of one layer's K (or V) page pool."""
    return (n_pages, page_size, cfg.n_kv_heads, cfg.resolved_head_dim)


def _paged_write(pages: torch.Tensor, new: torch.Tensor,
                 block_tables: torch.Tensor, offsets: torch.Tensor) -> None:
    """Scatter per-token K or V rows into the page pool, in place.

    pages: (P, ps, KV, HD); new: (N, KV, HD); block_tables: (N, MP) — the
    owning slot's block-table row per written token; offsets: (N,) absolute
    token offsets within each token's sequence.  Live slots never share
    pages (allocator invariant); slots parked on the all-zero block table,
    and offsets beyond the block table's reach (a padded final prefill
    chunk overhanging max_len), are routed explicitly to page 0 — the sink.
    Several parked rows may hit page 0 at once, in unspecified order; page
    0 is never read unmasked, so that is harmless.
    """
    ps = pages.shape[1]
    mp = block_tables.shape[1]
    offsets = offsets.long()
    idx = offsets // ps
    in_range = idx < mp
    page_ids = torch.gather(block_tables.long(), 1,
                            idx.clamp(0, mp - 1)[:, None])[:, 0]
    zero = torch.zeros_like(page_ids)
    page_ids = torch.where(in_range, page_ids, zero)
    slot_off = torch.where(in_range, offsets % ps, zero)
    pages.index_put_((page_ids, slot_off), new.to(pages.dtype))


def _paged_gather(pages: torch.Tensor, block_table: torch.Tensor):
    """(P, ps, KV, HD) gathered through (..., MP) -> (..., MP*ps, KV, HD)."""
    g = pages[block_table.long()]
    return g.reshape(g.shape[:-4] + (g.shape[-4] * g.shape[-3],) + g.shape[-2:])


def apply_attention_paged_decode(cfg, p, x, pages, block_tables, lengths,
                                 plan: RegionPlan, name: str = "attn"):
    """Decode a short block of S tokens for every pool slot against the
    paged KV pool (S=1: plain decode; S=spec_depth+1: the speculative
    verify step scoring a drafted block in one pass).

    x: (B, S, D) — B is the slot axis; pages: {"k_pages","v_pages"}:
    (P, ps, KV, HD), written in place; block_tables: (B, MP) int32;
    lengths: (B,) int32 tokens already written per slot.  Token i of a slot
    lands at offset ``lengths[b] + i`` and its query attends causally up to
    and including its own row (the staircase mask).  Returns
    (out (B, S, D), pages).

    The attention impl is a region knob: the default gathers each slot's
    pages dense and runs the grouped-GQA einsum; ``attn_impl='paged'``
    calls the paged-attention kernel (:mod:`repro_torch.kernels.ops`),
    which reads K/V page by page through the block table in ``block_k``-row
    tiles, all S queries sharing each tile.
    """
    with region(name) as rpath:
        B, S, _ = x.shape
        positions = (lengths[:, None].long()
                     + torch.arange(S, device=x.device)[None, :])
        q, k_new, v_new = _qkv_rope(cfg, p, x, positions)

        kvh, hd = cfg.n_kv_heads, q.shape[-1]
        bt_rows = block_tables.repeat_interleave(S, dim=0)       # (B*S, MP)
        offsets = positions.reshape(-1)
        _paged_write(pages["k_pages"], k_new.reshape(B * S, kvh, hd),
                     bt_rows, offsets)
        _paged_write(pages["v_pages"], v_new.reshape(B * S, kvh, hd),
                     bt_rows, offsets)
        k_pages, v_pages = pages["k_pages"], pages["v_pages"]

        grp = cfg.n_heads // kvh
        qg = q.reshape(B, S, kvh, grp, hd)
        rc = plan.config_for(rpath)
        if rc.attn_impl == "paged":
            attn = ops.paged_attention_mq(qg.contiguous(), k_pages, v_pages,
                                          block_tables, lengths + 1,
                                          block_k=rc.block_k)
            attn = attn.to(x.dtype)
        else:
            k = _paged_gather(k_pages, block_tables)        # (B, T, KV, HD)
            v = _paged_gather(v_pages, block_tables)
            T = k.shape[1]
            # staircase: query i sees every written position through its own
            valid = (torch.arange(T, device=x.device)[None, None, :]
                     <= positions[:, :, None])              # (B, S, T)
            s = torch.einsum("bshge,bkhe->bhsgk", qg, k) / math.sqrt(hd)
            probs = _masked_softmax(s, valid[:, None, :, None, :], x.dtype)
            attn = torch.einsum("bhsgk,bkhe->bshge", probs, v)
        out = _out_proj(attn.reshape(B, S, cfg.n_heads, hd), p["wo"])
        return plan.constrain(out, rpath, ("batch", "seq", "embed")), pages


def apply_attention_paged_chunk(cfg, p, x, pages, block_table, base,
                                plan: RegionPlan, name: str = "attn"):
    """One prefill chunk of a single request against its paged KV range.

    x: (1, C, D) — C prompt tokens starting at absolute position ``base``;
    the chunk's K/V are written into the request's pages first (in place),
    then its queries attend causally over everything the request has
    written so far (earlier chunks + itself), gathered through
    ``block_table`` (MP,).  Padded tail tokens write beyond the true
    length: within the block table's reach they land in the request's own
    reserved pages (positions a later write always overwrites before any
    masked-in read); beyond it the write scatter routes them to the null
    page explicitly.  Returns (out (1, C, D), pages).
    """
    with region(name) as rpath:
        C = x.shape[1]
        positions = base + torch.arange(C, device=x.device)     # (C,)
        q, k_new, v_new = _qkv_rope(cfg, p, x, positions)

        bt_rows = block_table[None, :].expand(C, block_table.shape[0])
        _paged_write(pages["k_pages"], k_new[0], bt_rows, positions)
        _paged_write(pages["v_pages"], v_new[0], bt_rows, positions)

        k = _paged_gather(pages["k_pages"], block_table[None, :])  # (1, T, KV, HD)
        v = _paged_gather(pages["v_pages"], block_table[None, :])
        T = k.shape[1]
        hd = q.shape[-1]
        kvh, grp = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
        qg = q.reshape(1, C, kvh, grp, hd)
        s = torch.einsum("bqhge,bkhe->bhgqk", qg, k) / math.sqrt(hd)
        kpos = torch.arange(T, device=x.device)
        causal = kpos[None, :] <= positions[:, None]            # (C, T)
        probs = _masked_softmax(s, causal, x.dtype)
        attn = torch.einsum("bhgqk,bkhe->bqhge", probs, v)
        out = _out_proj(attn.reshape(1, C, cfg.n_heads, hd), p["wo"])
        return plan.constrain(out, rpath, ("batch", "seq", "embed")), pages
