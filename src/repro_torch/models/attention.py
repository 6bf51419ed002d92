"""Attention on PyTorch: full-sequence attention (train / forward /
prefill, whisper's encoder and cross-attention), the slot pool's KV-cache
decode, and the paged KV pool's decode and chunked-prefill steps.

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
from repro_torch.distributed import comm
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


def _heads(cfg, p) -> tuple:
    """(heads, kv heads, GQA group) of this rank's attention params: the
    counts come from the weights, so a tensor-parallel shard (heads and
    kv heads split over the ``model`` axis) runs the same code on its
    share.  A shard with only one of the two split has no local GQA
    grouping and raises; the serve engine's degree clamp never builds
    one."""
    h, kvh = p["wq"].shape[-2], p["wk"].shape[-2]
    if (h != cfg.n_heads) != (kvh != cfg.n_kv_heads):
        raise NotImplementedError(
            "q heads and kv heads split over the model axis differently")
    return h, kvh, h // kvh


def _kv_block(cfg, p, plan: RegionPlan):
    """(first, end) of the kv heads this rank's q heads read, where the
    q heads are split over the ``model`` axis and the kv heads are not (a
    kv-head count the axis does not divide: the JAX package's GSPMD
    replicates them there); None otherwise.  Rank i holds q heads
    ``[i*h, (i+1)*h)``, and q head j reads kv head ``j // G``."""
    h, kvh = p["wq"].shape[-2], p["wk"].shape[-2]
    if h == cfg.n_heads or kvh != cfg.n_kv_heads:
        return None
    g = cfg.n_heads // cfg.n_kv_heads
    start = comm.model_index(plan.mesh) * h
    k0, k1 = start // g, (start + h - 1) // g + 1
    if h % g and g % h:
        raise NotImplementedError(
            f"{h} q heads a rank do not tile GQA groups of {g}")
    return k0, k1


def _shard_qkv_params(cfg, p, plan: RegionPlan):
    """The attention params as a rank of a heads-split step reads them,
    differentiably: the kv projections of a replicated-kv rank narrowed to
    :func:`_kv_block`, and every replicated leaf the rank's heads read
    (those projections, the qk-norm scales) behind
    :func:`repro_torch.distributed.comm.copy_to_model`, whose backward sums
    the ranks' parts of its gradient."""
    if p["wq"].shape[-2] == cfg.n_heads:
        return p
    mesh = plan.mesh
    p = dict(p)
    blk = _kv_block(cfg, p, plan)
    if blk is not None:
        for name in ("wk", "wv"):
            p[name] = comm.copy_to_model(p[name], mesh).narrow(
                -2, blk[0], blk[1] - blk[0])
    for name in ("q_norm", "k_norm"):
        if name in p:
            p[name] = comm.copy_to_model(p[name], mesh)
    return p


def _finish(cfg, p, attn, plan: RegionPlan, rpath: str) -> torch.Tensor:
    """(B, S, H, HD) attention output -> (B, S, D) through ``wo``; a
    heads-split ``wo`` leaves a partial sum, all-reduced over the model
    axis by the constraint."""
    out = _out_proj(attn, p["wo"])
    return plan.constrain(out, rpath, ("batch", "seq", "embed"),
                          partial=p["wo"].shape[0] != cfg.n_heads)


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


def _masked_softmax(s: torch.Tensor, valid,
                    dtype: torch.dtype) -> torch.Tensor:
    """Scores in any dtype -> probabilities in ``dtype``: masked in f32
    with the finite ``-1e30`` (``valid`` None: nothing masked), softmax in
    f32."""
    s = s.float()
    if valid is not None:
        s = s.masked_fill(~valid, NEG_INF)
    return torch.softmax(s, dim=-1).to(dtype)


def _project_qkv(cfg, p, x, kv_x, positions, kv_positions, rope: bool):
    """q from ``x``, K/V from ``kv_x`` (the same tensor for
    self-attention), qk-norm where the params hold it (a cross-attention's
    do not), rope at the given absolute positions when ``rope``."""
    q = _proj(x, p["wq"])
    k = _proj(kv_x, p["wk"])
    v = _proj(kv_x, p["wv"])
    if cfg.qk_norm and "q_norm" in p:
        q = _rms(q, p["q_norm"])
        k = _rms(k, p["k_norm"])
    if rope:
        q = apply_rope(cfg, q, positions)
        k = apply_rope(cfg, k, kv_positions)
    return q, k, v


def _qkv_rope(cfg, p, x, positions):
    """Shared decode/chunk preamble: project q and the new K/V rows,
    qk-norm, rope at the given absolute positions."""
    return _project_qkv(cfg, p, x, x, positions, positions, True)


def apply_attention(cfg, p, x: torch.Tensor, plan: RegionPlan, *,
                    positions=None, kv_x=None, kv_positions=None,
                    causal=None, rope: bool = True,
                    name: str = "attn") -> torch.Tensor:
    """Full-sequence attention (train / forward / prefill / encoder /
    cross), GQA grouped so K/V are never repeated to the full head count.

    ``kv_x`` (B, Sk, D): the sequence K/V are projected from (a
    cross-attention's encoder output; default ``x``).  ``positions`` and
    ``kv_positions`` default to 0..S-1 and 0..Sk-1; ``causal`` to
    ``cfg.causal``; ``rope=False`` leaves q and K unrotated.  Query i sees
    key j where ``positions[i] >= kv_positions[j]`` when causal, and within
    ``cfg.swa_window`` of it when the config has a window; a call with
    neither masks nothing."""
    with region(name) as rpath:
        B, S, _ = x.shape
        causal = cfg.causal if causal is None else causal
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32, device=x.device)
        if p["wq"].shape[-2] != cfg.n_heads:
            # heads split over the model axis: the column-parallel q/k/v
            # products' inputs, whose gradients the ranks sum
            x = comm.copy_to_model(x, plan.mesh)
            if kv_x is not None:
                kv_x = comm.copy_to_model(kv_x, plan.mesh)
        if kv_x is None:
            kv_x, kv_positions = x, positions
        elif kv_positions is None:
            kv_positions = torch.arange(kv_x.shape[1], dtype=torch.int32,
                                        device=x.device)
        p = _shard_qkv_params(cfg, p, plan)
        q, k, v = _project_qkv(cfg, p, x, kv_x, positions, kv_positions,
                               rope)
        hd = q.shape[-1]
        h, kvh, g = _heads(cfg, p)
        qg = q.reshape(B, S, kvh, g, hd)
        s = torch.einsum("bqhge,bkhe->bhgqk", qg, k) / math.sqrt(hd)
        valid = None
        if causal or cfg.swa_window:
            dist = positions[:, None].long() - kv_positions[None, :].long()
            valid = torch.ones(dist.shape, dtype=torch.bool,
                               device=x.device)
            if causal:
                valid &= dist >= 0
            if cfg.swa_window:
                valid &= dist < cfg.swa_window
        probs = _masked_softmax(s, valid, x.dtype)
        attn = torch.einsum("bhgqk,bkhe->bqhge", probs, v)
        return _finish(cfg, p, attn.reshape(B, S, h, hd), plan, rpath)


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


def _cache_write(cache, k_new, v_new, start, r0=None) -> None:
    """Write T new rows per batch row b at ``start[b]..start[b]+T-1`` of
    the cache, in place.  k_new/v_new: (B, T, KV, HD); start: (B,) long,
    already inside [0, C - T].  ``r0``: the cache holds rows
    ``[r0, r0 + Cl)`` of a sequence split over ranks, and takes only the
    rows it holds (the others keep their contents)."""
    B, T = k_new.shape[:2]
    rows = start[:, None] + torch.arange(T, device=start.device)[None, :]
    bidx = torch.arange(B, device=start.device)[:, None].expand(B, T)
    if r0 is None:
        cache["k"].index_put_((bidx, rows), k_new.to(cache["k"].dtype))
        cache["v"].index_put_((bidx, rows), v_new.to(cache["v"].dtype))
        return
    Cl = cache["k"].shape[1]
    local = rows - r0
    held = ((local >= 0) & (local < Cl))[..., None, None]
    local = local.clamp(0, Cl - 1)
    for name, new in (("k", k_new), ("v", v_new)):
        new = torch.where(held, new.to(cache[name].dtype),
                          cache[name][bidx, local])
        cache[name].index_put_((bidx, local), new)


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
        Cl = cache["k"].shape[1]
        m, r0 = _seq_shard(plan, rpath, Cl)
        C = Cl * m
        ring = bool(cfg.swa_window) and C == cfg.swa_window
        positions = pos.long()[:, None]                       # (B, 1)
        q, k_new, v_new = _qkv_rope(cfg, p, x, positions)
        start = (torch.remainder(positions[:, 0], C) if ring
                 else _clamp_start(pos, C, 1))
        _cache_write(cache, k_new, v_new, start, r0 if m > 1 else None)
        # absolute position of each cache row (this rank's rows)
        idx = r0 + torch.arange(Cl, device=x.device)[None, :]
        if ring:
            # rows hold positions pos-C+1..pos once full; invalid before
            k_pos = positions - torch.remainder(positions - idx, C)
        else:
            k_pos = idx.expand(B, Cl)
        valid = (k_pos <= positions) & (k_pos >= 0)            # (B, Cl)
        hd = q.shape[-1]
        h, kvh, g = _heads(cfg, p)
        qg = q.reshape(B, 1, kvh, g, hd)
        s = torch.einsum("bqhge,bkhe->bhgqk", qg, cache["k"]) / math.sqrt(hd)
        mask = valid[:, None, None, None, :]
        if m > 1:
            attn = _attend_seq_split(s, mask, cache["v"],
                                     "bhgqk,bkhe->bqhge", x.dtype, plan)
        else:
            probs = _masked_softmax(s, mask, x.dtype)
            attn = torch.einsum("bhgqk,bkhe->bqhge", probs, cache["v"])
        return _finish(cfg, p, attn.reshape(B, 1, h, hd), plan, rpath), cache


def _seq_shard(plan: RegionPlan, rpath: str, rows: int) -> tuple:
    """(shards, first row) of a slot cache's sequence: the plan's rules
    for ``rpath`` split ``kv_seq`` over a ``model`` axis of m > 1 ranks
    (the JAX package's default decode plan) — this rank's ``rows`` are
    then rows ``[i*rows, (i+1)*rows)`` of the full cache — or (1, 0).  The
    cache handed in holds a legal split: a full length the axis divides."""
    m = plan.model_size()
    if m == 1 or plan.rules_for(rpath).get("kv_seq") != "model":
        return 1, 0
    return m, comm.model_index(plan.mesh) * rows


def _attend_seq_split(s, mask, v, eq: str, dtype, plan: RegionPlan):
    """Attention over keys split across the ``model`` axis, from this
    rank's scores ``s`` (keys last), its ``mask`` and its value rows:
    the scores' max over every rank's keys (an all-reduce), each rank's
    exp-sums summed (an all-reduce), then each rank's probabilities times
    its value rows, summed (an all-reduce) — the log-sum-exp combine."""
    s = s.float().masked_fill(~mask, NEG_INF)
    top = comm.all_reduce(s.amax(-1, keepdim=True), plan.mesh, op="max")
    e = torch.exp(s - top)
    total = comm.all_reduce(e.sum(-1, keepdim=True), plan.mesh)
    probs = torch.div(e, total, out=e).to(dtype)
    return comm.all_reduce(torch.einsum(eq, probs, v).contiguous(),
                           plan.mesh)


def _attention_decode_block(cfg, p, x, cache, pos, plan: RegionPlan,
                            name: str = "attn"):
    """T>1 branch of :func:`apply_attention_decode`: contiguous rows at
    pos..pos+T-1 per batch row, staircase-masked (query i sees every cache
    row through its own write).  Non-ring caches only."""
    with region(name) as rpath:
        B, T, _ = x.shape
        Cl = cache["k"].shape[1]
        m, r0 = _seq_shard(plan, rpath, Cl)
        C = Cl * m
        if cfg.swa_window and C == cfg.swa_window:
            raise ValueError("multi-token decode unsupported on SWA ring "
                             "caches")
        positions = (pos.long()[:, None]
                     + torch.arange(T, device=x.device)[None, :])  # (B, T)
        q, k_new, v_new = _qkv_rope(cfg, p, x, positions)
        _cache_write(cache, k_new, v_new, _clamp_start(pos, C, T),
                     r0 if m > 1 else None)
        k_pos = r0 + torch.arange(Cl, device=x.device)
        valid = k_pos[None, None, :] <= positions[:, :, None]   # (B, T, Cl)
        hd = q.shape[-1]
        h, kvh, g = _heads(cfg, p)
        qg = q.reshape(B, T, kvh, g, hd)
        s = torch.einsum("bshge,bkhe->bhsgk", qg, cache["k"]) / math.sqrt(hd)
        mask = valid[:, None, :, None, :]
        if m > 1:
            attn = _attend_seq_split(s, mask, cache["v"],
                                     "bhsgk,bkhe->bshge", x.dtype, plan)
        else:
            probs = _masked_softmax(s, mask, x.dtype)
            attn = torch.einsum("bhsgk,bkhe->bshge", probs, cache["v"])
        return _finish(cfg, p, attn.reshape(B, T, h, hd), plan, rpath), cache


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


def _paged_gather_heads(pages: torch.Tensor, block_tables: torch.Tensor):
    """(P, ps, KV, HD) gathered through (B, MP) -> (KV, B, MP*ps, HD),
    contiguous (one ``index_select`` of the pool seen heads first)."""
    B, mp = block_tables.shape
    g = torch.index_select(pages.permute(2, 0, 1, 3), 1,
                           block_tables.long().reshape(-1))
    return g.view(pages.shape[2], B, mp * pages.shape[1], pages.shape[3])


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

    On a tensor-parallel shard ``p`` and ``pages`` hold the rank's heads
    and kv heads (pages are split on the kv-head axis only: page ids,
    block tables and lengths are the same on every rank), and the output
    is all-reduced after ``wo``.
    """
    with region(name) as rpath:
        B, S, _ = x.shape
        positions = (lengths[:, None].long()
                     + torch.arange(S, device=x.device)[None, :])
        q, k_new, v_new = _qkv_rope(cfg, p, x, positions)

        h, kvh, grp = _heads(cfg, p)
        hd = q.shape[-1]
        bt_rows = block_tables.repeat_interleave(S, dim=0)       # (B*S, MP)
        offsets = positions.reshape(-1)
        _paged_write(pages["k_pages"], k_new.reshape(B * S, kvh, hd),
                     bt_rows, offsets)
        _paged_write(pages["v_pages"], v_new.reshape(B * S, kvh, hd),
                     bt_rows, offsets)
        k_pages, v_pages = pages["k_pages"], pages["v_pages"]

        qg = q.reshape(B, S, kvh, grp, hd)
        rc = plan.config_for(rpath)
        if rc.attn_impl == "paged":
            attn = ops.paged_attention_mq(qg.contiguous(), k_pages, v_pages,
                                          block_tables, lengths + 1,
                                          block_k=rc.block_k)
            attn = attn.to(x.dtype)
        else:
            # gathered in the layout the batched products read, heads
            # first: (KV, B, T, HD).  XLA fuses the same transpose into
            # its gather, so neither package writes K/V twice; a gather in
            # the pool's (B, T, KV, HD) order would make the products copy
            # both to (B, KV, T, HD) first.
            k = _paged_gather_heads(k_pages, block_tables)
            v = _paged_gather_heads(v_pages, block_tables)
            T = k.shape[2]
            # staircase: query i sees every written position through its own
            valid = (torch.arange(T, device=x.device)[None, None, :]
                     <= positions[:, :, None])              # (B, S, T)
            qh = qg.permute(2, 0, 1, 3, 4).reshape(kvh, B, S * grp, hd)
            s = (qh @ k.transpose(-1, -2)).view(kvh, B, S, grp, T)
            s = s / math.sqrt(hd)
            probs = _masked_softmax(s, valid[None, :, :, None, :], x.dtype)
            attn = (probs.view(kvh, B, S * grp, T) @ v).view(
                kvh, B, S, grp, hd).permute(1, 2, 0, 3, 4)
        return (_finish(cfg, p, attn.reshape(B, S, h, hd), plan, rpath),
                pages)


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
        h, kvh, grp = _heads(cfg, p)
        qg = q.reshape(1, C, kvh, grp, hd)
        s = torch.einsum("bqhge,bkhe->bhgqk", qg, k) / math.sqrt(hd)
        kpos = torch.arange(T, device=x.device)
        causal = kpos[None, :] <= positions[:, None]            # (C, T)
        probs = _masked_softmax(s, causal, x.dtype)
        attn = torch.einsum("bhgqk,bkhe->bqhge", probs, v)
        return (_finish(cfg, p, attn.reshape(1, C, h, hd), plan, rpath),
                pages)
