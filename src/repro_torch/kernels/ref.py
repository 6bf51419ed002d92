"""Plain PyTorch versions of the port's kernels: the CPU path of every
wrapper in :mod:`repro_torch.kernels.ops`, and what ``chip_smoke.py``
holds each CUDA kernel against on the card."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30

#: (rtol, atol) of a kernel's output against its plain version here, on
#: ``|kernel - plain| <= atol + rtol * |plain|``.  Both read the same
#: inputs and sum in f32 (the plain matmul of bf16 operands exactly, see
#: :func:`matmul`), so they differ by f32 summation order (atol) and, in
#: bf16, by the kernel's one round-to-nearest of its output: at most half a
#: bf16 ulp, 2^-8 of the value.
KERNEL_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0 ** -8, 1e-5)}


def within_tol(got, want, dtype) -> bool:
    """Whether ``got`` (a kernel's output) agrees with ``want`` (its plain
    version's, in f32) under :data:`KERNEL_TOL` of ``dtype``."""
    rtol, atol = KERNEL_TOL[dtype]
    return bool(((got.float() - want).abs() <= atol + rtol * want.abs()).all())


def matmul(x, y):
    """(M, K) @ (K, N) -> (M, N) float32.  f32 operands: the product summed
    in f32.  bf16 operands: the exact product (summed in f64) rounded once
    to f32.  A bf16 output is held to half an ulp of its value, and an f32
    sum in one more order strays further than that bound allows at long K:
    at (2048, 2048) @ (2048, 5632) the f32 product strays ~1e-4 from the
    exact one, and the exact product rounded to bf16 then misses
    :data:`KERNEL_TOL` against it on a few elements (``chip_smoke.py`` logs
    both on the card)."""
    if x.dtype == torch.bfloat16:
        return torch.matmul(x.double(), y.double()).float()
    return torch.matmul(x.float(), y.float())


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, S, H, D); k, v: (B, Sk, H, D) -> (B, S, H, D) float32: plain
    masked softmax attention on absolute positions (query i sees key j
    where ``i >= j`` when causal and ``i - j < window`` when window > 0).
    Masked scores take the finite ``-1e30``, so a row that sees no key
    gets a uniform softmax over every key."""
    S, Sk, D = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("bqhe,bkhe->bhqk", q.float(), k.float()) / math.sqrt(D)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((S, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhe->bqhe", p, v.float())


def paged_attention_mq(q, k_pages, v_pages, block_tables, lengths):
    """Multi-query paged decode attention (the speculative verify step's
    attention).  q: (B, S, KVH, G, HD); pages: (P, ps, KVH, HD);
    block_tables: (B, MP) int32; lengths: (B,) int32 -> float32, shaped
    like q.

    Gathers every sequence's pages dense and runs grouped-GQA softmax
    attention in f32 with the staircase mask: query ``s`` sees
    ``lengths + s`` positions (the speculative block's own K/V rows are
    already written, each query attending causally up to and including its
    own row).  Masked scores take the finite ``-1e30``, so a row with no
    visible position returns a finite (garbage) average.
    """
    B, S, KVH, G, D = q.shape
    ps = k_pages.shape[1]
    bt = block_tables.long()
    k = k_pages[bt]                            # (B, MP, ps, KVH, HD)
    v = v_pages[bt]
    T = k.shape[1] * ps
    k = k.reshape(B, T, KVH, D).float()
    v = v.reshape(B, T, KVH, D).float()
    s = torch.einsum("bshge,bkhe->bshgk", q.float(), k) / math.sqrt(D)
    qpos = (lengths.long()[:, None]
            + torch.arange(S, device=q.device)[None, :])      # (B, S)
    valid = (torch.arange(T, device=q.device)[None, None, :]
             < qpos[:, :, None])
    s = torch.where(valid[:, :, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bshgk,bkhe->bshge", p, v)


def paged_attention(q, k_pages, v_pages, block_tables, lengths):
    """Paged decode attention, one query per sequence.  q: (B, KVH, G, HD);
    pages: (P, ps, KVH, HD); block_tables: (B, MP) int32; lengths: (B,)
    int32 -> (B, KVH, G, HD) float32.  The S=1 case of
    :func:`paged_attention_mq`."""
    return paged_attention_mq(q[:, None], k_pages, v_pages, block_tables,
                              lengths)[:, 0]


# ---------------------------------------------------------------------------
# Linear-attention scans (RWKV6 WKV, Mamba2 SSD), model layout, f32
# ---------------------------------------------------------------------------


def wkv_linear_scan(r, k, v, w, u, s0):
    """RWKV6 WKV, the sequential recurrence.  r,k,v,w: (B,T,H,N); u: (H,N);
    s0: (B,H,N,N) with S[j,i] over (key j, value i) -> out (B,T,H,N),
    final state (B,H,N,N), both f32:

        out_t = r_t . (S + u (x) k_t v_t^T);   S <- diag(w_t) S + k_t v_t^T
    """
    u = u.float()
    s = s0.float()
    outs = []
    # one unbind a stream, not an index a step: its backward is one stack,
    # where indexing would zero-fill a T-step gradient at every step
    for rt, kt, vt, wt in zip(*(t.float().unbind(1) for t in (r, k, v, w))):
        kv = kt[:, :, :, None] * vt[:, :, None, :]            # (B,H,N,N)
        outs.append(torch.einsum("bhj,bhji->bhi", rt,
                                 s + u[..., :, None] * kv))
        s = wt[:, :, :, None] * s + kv
    return torch.stack(outs, dim=1), s


def ssd_linear_scan(x, b, c, dt, a, s0):
    """Mamba2 SSD, the sequential recurrence.  x: (B,T,H,P); b,c: (B,T,N)
    shared across heads; dt: (B,T,H); a: (H,); s0: (B,H,P,N) -> y
    (B,T,H,P), final state (B,H,P,N), both f32:

        S <- exp(dt_t a) S + (dt_t x_t) (x) b_t;   y_t = S c_t
    """
    a = a.float()
    s = s0.float()
    ys = []
    # one unbind a stream (see wkv_linear_scan)
    for xt, bt, ct, dtt in zip(*(t.float().unbind(1) for t in (x, b, c, dt))):
        decay = torch.exp(dtt * a)                            # (B,H)
        upd = (dtt[:, :, None] * xt)[..., :, None] * bt[:, None, None, :]
        s = decay[..., None, None] * s + upd
        ys.append(torch.einsum("bhpn,bn->bhp", s, ct))
    return torch.stack(ys, dim=1), s


def wkv_chunk(r, k, v, w, u, s0, chunk: int = 64):
    """Chunked parallel-scan WKV: the recurrence of
    :func:`wkv_linear_scan` reassociated into matmul form per ``chunk``
    steps (a shorter last chunk when ``chunk`` does not divide T).

    Per chunk, with L the inclusive log-decay cumsum over local time: the
    state r_t reads excludes kv_t, so the intra-chunk term is strictly
    causal and the ``u`` bonus supplies the diagonal.  Masked exponents
    are set to -inf before ``exp``; every one that survives is <= 0.
    The log-decays, their cumsums and the exponents are float64 (the
    exponentials are rounded to f32 before the products): a decay
    exponent is a difference of two cumsums, and in f32 that difference
    loses about |L| ulp, which at long chunks or extreme decays exceeds
    :data:`KERNEL_TOL` against the sequential recurrence.
    """
    B, T, H, N = r.shape
    uf = u.float()
    s = s0.float()
    outs = []
    for lo in range(0, T, chunk):
        C = min(chunk, T - lo)
        rc, kc, vc, wc = (t[:, lo:lo + C].float() for t in (r, k, v, w))
        lw = torch.log(wc.double())                           # (B,C,H,N)
        linc = torch.cumsum(lw, dim=1)          # decay through step t
        lexc = linc - lw                        # decay through step t-1
        # cross-chunk: r_t reads the entry state decayed by w_0..w_{t-1}
        out = torch.einsum("bthj,bhji->bthi",
                           rc * torch.exp(lexc).float(), s)
        # intra-chunk (strictly causal): kv_s decays by w_{s+1}..w_{t-1}
        tidx = torch.arange(C, device=r.device)
        causal = tidx[:, None] > tidx[None, :]
        expnt = lexc[:, :, None] - linc[:, None]              # (B,C,C,H,N)
        expnt = expnt.masked_fill(~causal[None, :, :, None, None],
                                  float("-inf"))
        att = torch.einsum("bthj,btshj,bshj->bths", rc,
                           torch.exp(expnt).float(), kc)
        out = out + torch.einsum("bths,bshi->bthi", att, vc)
        # diagonal bonus: out_t also reads u * kv_t
        dcoef = torch.einsum("bthj,hj->bth", rc * kc, uf)
        out = out + dcoef[..., None] * vc
        # carry: S <- exp(L_C) S + sum_s exp(L_C - L_s) k_s v_s^T
        wlast = linc[:, -1]                                   # (B,H,N)
        kw = kc * torch.exp(wlast[:, None] - linc).float()
        s = (torch.exp(wlast).float()[..., :, None] * s
             + torch.einsum("bthj,bthi->bhji", kw, vc))
        outs.append(out)
    return torch.cat(outs, dim=1), s


def ssd_chunk(x, b, c, dt, a, s0, chunk: int = 64):
    """Chunked parallel-scan SSD: the recurrence of :func:`ssd_linear_scan`
    in matmul form per ``chunk`` steps (a shorter last chunk when
    ``chunk`` does not divide T), all streams f32.  The output is read
    after the state update, so the intra-chunk mask includes the
    diagonal (s <= t).  The log-decays dt a, their cumsums and the
    exponents are float64, as in :func:`wkv_chunk`."""
    B, T, H, P = x.shape
    s = s0.float()
    af = a.double()
    ys = []
    for lo in range(0, T, chunk):
        C = min(chunk, T - lo)
        xc, bc, cc, dtc = (t[:, lo:lo + C].float() for t in (x, b, c, dt))
        la = dtc.double() * af[None, None, :]                 # (B,C,H)
        linc = torch.cumsum(la, dim=1)
        # cross-chunk: y_t reads the entry state decayed through step t
        y = (torch.exp(linc).float()[..., None]
             * torch.einsum("bhpn,btn->bthp", s, cc))
        # intra-chunk (inclusive): upd_s decays by la_{s+1}..la_t
        tidx = torch.arange(C, device=x.device)
        mask = tidx[:, None] >= tidx[None, :]
        cb = torch.einsum("btn,bsn->bts", cc, bc)
        expnt = linc[:, :, None] - linc[:, None]              # (B,C,C,H)
        expnt = expnt.masked_fill(~mask[None, :, :, None], float("-inf"))
        M = cb[..., None] * torch.exp(expnt).float() * dtc[:, None]
        y = y + torch.einsum("btsh,bshp->bthp", M, xc)
        # carry: S <- exp(L_C) S + sum_s exp(L_C - L_s) dt_s x_s (x) b_s
        wlast = linc[:, -1]                                   # (B,H)
        wgt = torch.exp(wlast[:, None] - linc).float() * dtc  # (B,C,H)
        s = (torch.exp(wlast).float()[..., None, None] * s
             + torch.einsum("bthp,btn,bth->bhpn", xc, bc, wgt))
        ys.append(y)
    return torch.cat(ys, dim=1), s


# ---------------------------------------------------------------------------
# The chunk kernels' algorithm, step for step, in plain PyTorch (used by the
# tests only: it shows on the CPU that the kernels' decomposition computes
# wkv_chunk / ssd_chunk, ragged chunks and extreme decays included)
# ---------------------------------------------------------------------------

#: time steps of a kernel tile, and of a WKV sub-tile
SCAN_TILE, SCAN_SUB = 64, 16


def _suffix_excl(x, dim: int = 1):
    """Exclusive suffix sums along ``dim``: out[s] = sum of x[s+1:]."""
    return torch.flip(torch.cumsum(torch.flip(x, [dim]), dim), [dim]) - x


def _tiles(lo: int, C: int):
    """(start, rows) of each SCAN_TILE-step tile of the chunk [lo, lo+C)."""
    return [(lo + t0, min(SCAN_TILE, C - t0))
            for t0 in range(0, C, SCAN_TILE)]


def _pad_rows(x, n: int, fill: float = 0.0):
    """Pad dim 1 of x (n rows) to SCAN_TILE rows with ``fill`` (a kernel
    tile's padding)."""
    if n == SCAN_TILE:
        return x
    shape = list(x.shape)
    shape[1] = SCAN_TILE - n
    return torch.cat([x, x.new_full(shape, fill)], dim=1)


def _state_pass(s0, dS, decay):
    """Phase B: the entry state of every chunk and the final state,
    S_{c+1} = decay_c * S_c + dS_c, serially over chunks."""
    S, entries = s0, []
    for d, g in zip(dS, decay):
        entries.append(S)
        S = g * S + d
    return entries, S


def _sub_products(w):
    """Per 16-step sub-tile of a (B, 64, H, N) tile of decays: the
    exclusive prefix products from the sub-tile's start, the exclusive
    suffix products to its end, and the sub-tile's total product
    (B, 4, H, N), each a product of at most 16 decays."""
    ws = w.unflatten(1, (SCAN_TILE // SCAN_SUB, SCAN_SUB))
    incl = torch.cumprod(ws, 2)
    pre = torch.cat([torch.ones_like(ws[:, :, :1]), incl[:, :, :-1]], 2)
    suf = torch.flip(torch.cumprod(torch.flip(ws, [2]), 2), [2])
    suf = torch.cat([suf[:, :, 1:], torch.ones_like(ws[:, :, :1])], 2)
    return pre.flatten(1, 2), suf.flatten(1, 2), incl[:, :, -1]


def _tile_suffix(w):
    """Exclusive suffix products over a (B, 64, H, N) tile of decays, as
    sub-tile suffix products times the totals of the later sub-tiles;
    and the tile's total product."""
    _, suf, tot = _sub_products(w)
    n = tot.shape[1]
    later = [torch.prod(tot[:, c + 1:], 1) for c in range(n)]
    later = torch.stack(later, 1).repeat_interleave(SCAN_SUB, 1)
    return suf * later, torch.prod(tot, 1)


def wkv_chunk_phased(r, k, v, w, u, s0, chunk: int = 64):
    """The CUDA ``wkv_chunk`` kernels' decomposition of :func:`wkv_chunk`
    (model layout in and out, f32).  Every decay factor is a product of
    decays, never an exponential of a difference of cumsums, so nothing
    cancels and nothing overflows (every factor is <= 1); tiles are
    zero-padded to 64 steps with decay 1.

    * A, per chunk: walking its 64-step tiles from the last, with the
      decays of the later tiles multiplied into ``carry``,
      dS = sum_t (k_t prod_{m>t} w_m) v_t^T and the decay prod_t w_t;
    * B: the entry state of every chunk;
    * C, per 64-step query tile: keys of earlier tiles of the chunk by
      one product, (r_t prod_{q0<=m<t} w_m) . (k_s prod_{s<m<q0} w_m);
      keys of its own tile by 16-step sub-tiles, an earlier sub-tile b
      through three factors (r_t's prefix product in its sub-tile a, the
      totals of the sub-tiles between, k_s's suffix product in b), its
      own sub-tile by running products over t for each key s; then the
      u bonus and the cross term (r_t prod_{m<t} w_m) S.
    """
    B, T, H, N = r.shape
    r, k, v, w = (t.float() for t in (r, k, v, w))
    uf = u.float()
    chunks = [(lo, min(chunk, T - lo)) for lo in range(0, T, chunk)]

    def tile(t, t0, n, fill=0.0):
        return _pad_rows(t[:, t0:t0 + n], n, fill)

    dS, decay = [], []
    for lo, C in chunks:                                      # phase A
        acc = r.new_zeros((B, H, N, N))
        carry = r.new_ones((B, H, N))
        for t0, n in reversed(_tiles(lo, C)):
            suf, tot = _tile_suffix(tile(w, t0, n, 1.0))
            kd = tile(k, t0, n) * suf * carry[:, None]
            acc = acc + torch.einsum("bthj,bthi->bhji", kd, tile(v, t0, n))
            carry = carry * tot
        dS.append(acc)
        decay.append(carry[..., None])
    entries, s_final = _state_pass(s0.float(), dS, decay)     # phase B
    outs = []
    nsub = SCAN_TILE // SCAN_SUB
    for (lo, C), S in zip(chunks, entries):                   # phase C
        tiles = _tiles(lo, C)
        for qi, (q0, nq) in enumerate(tiles):
            rq, kq, vq = (tile(t, q0, nq) for t in (r, k, v))
            wq = tile(w, q0, nq, 1.0)
            pre, suf, tot = _sub_products(wq)
            before = [torch.prod(tot[:, :a], 1) for a in range(nsub)]
            rqf = rq * pre * torch.stack(before, 1).repeat_interleave(
                SCAN_SUB, 1)                   # r_t prod_{q0<=m<t} w_m
            rd, kd = rq * pre, kq * suf
            A = r.new_zeros((B, H, SCAN_TILE, SCAN_TILE))
            for a in range(nsub):
                ta = slice(a * SCAN_SUB, (a + 1) * SCAN_SUB)
                for b in range(a):
                    sb = slice(b * SCAN_SUB, (b + 1) * SCAN_SUB)
                    D = torch.prod(tot[:, b + 1:a], 1)        # (B,H,N)
                    A[:, :, ta, sb] = torch.einsum(
                        "bthj,bhj,bshj->bhts", rd[:, ta], D, kd[:, sb])
                # own sub-tile: run[s] = prod_{s<m<t} w_m, over t
                P = r.new_zeros((B, SCAN_SUB, SCAN_SUB, H, N))
                run = r.new_ones((B, SCAN_SUB, H, N))
                for t in range(SCAN_SUB):
                    P[:, t, :t] = run[:, :t]
                    run[:, :t] = run[:, :t] * wq[:, a * SCAN_SUB + t, None]
                A[:, :, ta, ta] = torch.einsum(
                    "bthj,btshj,bshj->bhts", rq[:, ta], P, kq[:, ta])
            out = torch.einsum("bhts,bshi->bthi", A, vq)
            out = out + torch.einsum("bthj,hj,bthj->bth", rq, uf,
                                     kq)[..., None] * vq
            carry = r.new_ones((B, H, N))
            for t0, n in reversed(tiles[:qi]):
                ksuf, ktot = _tile_suffix(w[:, t0:t0 + n])
                kf = k[:, t0:t0 + n] * ksuf * carry[:, None]
                At = torch.einsum("bthj,bshj->bhts", rqf, kf)
                out = out + torch.einsum("bhts,bshi->bthi", At,
                                         v[:, t0:t0 + n])
                carry = carry * ktot
            out = out + torch.einsum("bthj,bhji->bthi",
                                     rqf * carry[:, None], S)
            outs.append(out[:, :nq])
    return torch.cat(outs, dim=1), s_final


def ssd_chunk_phased(x, b, c, dt, a, s0, chunk: int = 64):
    """The CUDA ``ssd_chunk`` kernels' decomposition of :func:`ssd_chunk`
    (model layout in and out, f32 streams; the scalar log-decays dt a are
    summed in float64, whose exponentials are rounded to f32): A, per
    chunk, walking its 64-step
    tiles from the last, dS = sum_t exp(L_C - L_t) dt_t x_t b_t^T and
    exp(L_C); B, the entry states; C, per 64-step query tile, G = c b^T
    once per tile pair for every head, M = G exp(L_t - L_s) dt_s (its own
    tile directly, s <= t; earlier tiles as exp(L_t - L_ref) times
    exp(L_ref - L_s) dt_s, L_ref the tile's start), y += M x, then the
    cross term exp(L_t) (c_t . S)."""
    B, T, H, P = x.shape
    x, b, c, dt = (t.float() for t in (x, b, c, dt))
    la = dt.double() * a.double()                             # (B,T,H)
    chunks = [(lo, min(chunk, T - lo)) for lo in range(0, T, chunk)]
    dS, decay = [], []
    for lo, C in chunks:                                      # phase A
        acc = x.new_zeros((B, H, P, b.shape[-1]))
        carry = la.new_zeros((B, H))
        for t0, n in reversed(_tiles(lo, C)):
            sl = slice(t0, t0 + n)
            wgt = torch.exp(_suffix_excl(la[:, sl])
                            + carry[:, None]).float() * dt[:, sl]
            acc = acc + torch.einsum("bthp,btn,bth->bhpn", x[:, sl],
                                     b[:, sl], wgt)
            carry = carry + la[:, sl].sum(1)
        dS.append(acc)
        decay.append(torch.exp(carry).float()[..., None, None])
    entries, s_final = _state_pass(s0.float(), dS, decay)     # phase B
    ys = []
    incl = torch.tril(torch.ones(SCAN_TILE, SCAN_TILE, dtype=torch.bool,
                                 device=x.device))
    for (lo, C), S in zip(chunks, entries):                   # phase C
        tiles = _tiles(lo, C)
        for qi, (q0, nq) in enumerate(tiles):
            cq, xq, dq, lq = (_pad_rows(t[:, q0:q0 + nq], nq)
                              for t in (c, x, dt, la))
            bq = _pad_rows(b[:, q0:q0 + nq], nq)
            Lq = torch.cumsum(lq, 1)                          # (B,t,H)
            G = torch.einsum("btn,bsn->bts", cq, bq)
            ex = (Lq[:, :, None] - Lq[:, None]).masked_fill(
                ~incl[None, :, :, None], float("-inf"))
            M = G[..., None] * torch.exp(ex).float() * dq[:, None]
            y = torch.einsum("btsh,bshp->bthp", M, xq)
            rowf = torch.exp(Lq).float()
            carry = la.new_zeros((B, H))
            for t0, n in reversed(tiles[:qi]):
                sl = slice(t0, t0 + n)
                colf = torch.exp(_suffix_excl(la[:, sl])
                                 + carry[:, None]).float() * dt[:, sl]
                G = torch.einsum("btn,bsn->bts", cq, b[:, sl])
                M = G[..., None] * rowf[:, :, None] * colf[:, None]
                y = y + torch.einsum("btsh,bshp->bthp", M, x[:, sl])
                carry = carry + la[:, sl].sum(1)
            cross = torch.einsum("btn,bhpn->bthp", cq, S)
            y = y + torch.exp(carry[:, None] + Lq).float()[..., None] * cross
            ys.append(y[:, :nq])
    return torch.cat(ys, dim=1), s_final


# ---------------------------------------------------------------------------
# The fused kernels' decomposition, in plain PyTorch (used by the tests only:
# it shows on the CPU that splitting a state over blocks and summing by
# shuffle trees computes wkv_linear_scan / ssd_linear_scan)
# ---------------------------------------------------------------------------

#: lanes of a warp, rows j of S a ``wkv_fused`` warp holds, and the fewest
#: blocks a fused call keeps (two for each of an H100's 132 SMs)
WARP, FUSED_WARP_ROWS, FUSED_MIN_BLOCKS = 32, 16, 264


def fused_per_thread(blocks_least: int, least: int, most: int) -> int:
    """The float4s of state a fused kernel's thread holds (the CUDA
    launchers' rule): the largest power of two from ``least`` to ``most``
    that leaves the grid (``blocks_least`` blocks at ``least``) at least
    :data:`FUSED_MIN_BLOCKS` blocks."""
    r = least
    while 2 * r <= most and blocks_least * least // (2 * r) >= \
            FUSED_MIN_BLOCKS:
        r *= 2
    return r


def _xor_tree(p):
    """The sum over the last dim (a power of two of lanes) as an
    xor-shuffle butterfly takes it: lanes l and l ^ (L/2) add first, then
    l ^ (L/4), down to l ^ 1."""
    while p.shape[-1] > 1:
        half = p.shape[-1] // 2
        p = p[..., :half] + p[..., half:]
    return p[..., 0]


def ssd_fused_tiled(x, b, c, dt, a, s0, rows: int | None = None):
    """The CUDA ``ssd_fused`` kernel's decomposition of
    :func:`ssd_linear_scan` (model layout in and out, f32): the rows p of
    S in tiles of 8 ``rows`` (rows a thread; by default the launcher's
    choice for these shapes), each a block that walks the sequence alone;
    per step the decay exp(dt a) once per (b, h, t), S <- decay S +
    (dt x_p) b, then y_p as each lane's sum of its 4 columns (N / 4 lanes
    a row) and an xor tree over the row's lanes."""
    x, b, c, dt = (t.float() for t in (x, b, c, dt))
    a = a.float()
    B, T, H, P = x.shape
    N = b.shape[-1]
    if rows is None:
        rows = fused_per_thread(B * H * (P // 16), 2, min(8, P // 8))
    ys, states = [], []
    for p0 in range(0, P, 8 * rows):
        tile = slice(p0, p0 + 8 * rows)
        s = s0[:, :, tile].float()                            # (B,H,R,N)
        yt = []
        for t in range(T):
            decay = torch.exp(dt[:, t] * a)                   # (B,H)
            dx = dt[:, t, :, None] * x[:, t, :, tile]         # (B,H,R)
            s = (decay[..., None, None] * s
                 + dx[..., None] * b[:, t, None, None, :])
            prod = (s * c[:, t, None, None, :]).unflatten(-1, (N // 4, 4))
            lane = ((prod[..., 0] + prod[..., 1]) + prod[..., 2]) \
                + prod[..., 3]                                # (B,H,R,N/4)
            yt.append(_xor_tree(lane))
        ys.append(torch.stack(yt, 1))                         # (B,T,H,R)
        states.append(s)
    return torch.cat(ys, -1), torch.cat(states, 2)


def wkv_fused_tiled(r, k, v, w, u, s0, rows: int | None = None):
    """The CUDA ``wkv_fused`` kernel's decomposition of
    :func:`wkv_linear_scan` (model layout in and out, f32): the value
    columns i of S in tiles of 8 ``rows`` (rows j of S a thread; by
    default the launcher's choice for these shapes), each a block that
    walks the sequence alone.  Per step: out_i = sum_j r_j S[j][i] as the
    kernel sums it (each thread its rows jr + m N / rows in order, then a
    tree over the 16 / rows lanes of a warp that share a column group,
    lanes 16 apart first, and the warps' sums added in order), + bonus
    v_i, the bonus sum_j r_j u_j k_j taken once per (b, h, t) (each of a
    warp's 32 lanes sums j = lane, lane + 32, ..., then an xor tree over
    the lanes); then S <- w_j S + k_j v_i."""
    r, k, v, w = (t.float() for t in (r, k, v, w))
    u = u.float()
    B, T, H, N = r.shape
    if rows is None:
        rows = fused_per_thread(B * H * (N // 8), 1, min(4, N // 8))
    lanes = FUSED_WARP_ROWS // rows
    outs, states = [], []
    for c0 in range(0, N, 8 * rows):
        cols = slice(c0, c0 + 8 * rows)
        s = s0[..., cols].float()                             # (B,H,N,C)
        ot = []
        for t in range(T):
            ruk = torch.nn.functional.pad(r[:, t] * u * k[:, t],
                                          (0, -N % WARP))
            ruk = ruk.unflatten(-1, (-1, WARP))               # (B,H,m,32)
            lane = ruk[..., 0, :]
            for m in range(1, ruk.shape[-2]):
                lane = lane + ruk[..., m, :]
            bonus = _xor_tree(lane)                           # (B,H)
            prod = (r[:, t, :, :, None] * s).unflatten(
                2, (rows, N // rows))                         # (B,H,m,jr,C)
            mine = prod[:, :, 0]
            for m in range(1, rows):
                mine = mine + prod[:, :, m]                   # (B,H,jr,C)
            warps = mine.unflatten(2, (-1, lanes))            # (B,H,W,l,C)
            wsum = _xor_tree(warps.movedim(3, -1))            # (B,H,W,C)
            o = wsum[:, :, 0]
            for q in range(1, wsum.shape[2]):
                o = o + wsum[:, :, q]
            vt = v[:, t, :, cols]                             # (B,H,C)
            ot.append(o + bonus[..., None] * vt)
            s = w[:, t, :, :, None] * s + k[:, t, :, :, None] * vt[:, :, None]
        outs.append(torch.stack(ot, 1))                       # (B,T,H,C)
        states.append(s)
    return torch.cat(outs, -1), torch.cat(states, -1)
