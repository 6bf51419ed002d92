"""Plain PyTorch versions of the port's kernels: the CPU path of every
wrapper in :mod:`repro_torch.kernels.ops`, and what ``chip_smoke.py``
holds each CUDA kernel against on the card."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30

#: (rtol, atol) of a kernel's output against its plain version here, on
#: ``|kernel - plain| <= atol + rtol * |plain|``.  Both read the same
#: inputs and sum in f32, so they differ by f32 summation order (atol) and,
#: in bf16, by the kernel's one round-to-nearest of its output: at most half
#: a bf16 ulp, 2^-8 of the value.
KERNEL_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0 ** -8, 1e-5)}


def within_tol(got, want, dtype) -> bool:
    """Whether ``got`` (a kernel's output) agrees with ``want`` (its plain
    version's, in f32) under :data:`KERNEL_TOL` of ``dtype``."""
    rtol, atol = KERNEL_TOL[dtype]
    return bool(((got.float() - want).abs() <= atol + rtol * want.abs()).all())


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
    r, k, v, w = (t.float() for t in (r, k, v, w))
    u = u.float()
    s = s0.float()
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]        # (B,H,N,N)
        outs.append(torch.einsum("bhj,bhji->bhi", r[:, t],
                                 s + u[..., :, None] * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(outs, dim=1), s


def ssd_linear_scan(x, b, c, dt, a, s0):
    """Mamba2 SSD, the sequential recurrence.  x: (B,T,H,P); b,c: (B,T,N)
    shared across heads; dt: (B,T,H); a: (H,); s0: (B,H,P,N) -> y
    (B,T,H,P), final state (B,H,P,N), both f32:

        S <- exp(dt_t a) S + (dt_t x_t) (x) b_t;   y_t = S c_t
    """
    x, b, c, dt = (t.float() for t in (x, b, c, dt))
    a = a.float()
    s = s0.float()
    ys = []
    for t in range(x.shape[1]):
        decay = torch.exp(dt[:, t] * a)                       # (B,H)
        upd = ((dt[:, t, :, None] * x[:, t])[..., :, None]
               * b[:, t, None, None, :])
        s = decay[..., None, None] * s + upd
        ys.append(torch.einsum("bhpn,bn->bhp", s, c[:, t]))
    return torch.stack(ys, dim=1), s


def wkv_chunk(r, k, v, w, u, s0, chunk: int = 64):
    """Chunked parallel-scan WKV: the recurrence of
    :func:`wkv_linear_scan` reassociated into matmul form per ``chunk``
    steps (a shorter last chunk when ``chunk`` does not divide T).

    Per chunk, with L the inclusive log-decay cumsum over local time: the
    state r_t reads excludes kv_t, so the intra-chunk term is strictly
    causal and the ``u`` bonus supplies the diagonal.  Masked exponents
    are set to -inf before ``exp``; every one that survives is <= 0.
    """
    B, T, H, N = r.shape
    uf = u.float()
    s = s0.float()
    outs = []
    for lo in range(0, T, chunk):
        C = min(chunk, T - lo)
        rc, kc, vc, wc = (t[:, lo:lo + C].float() for t in (r, k, v, w))
        lw = torch.log(wc)                                    # (B,C,H,N)
        linc = torch.cumsum(lw, dim=1)          # decay through step t
        lexc = linc - lw                        # decay through step t-1
        # cross-chunk: r_t reads the entry state decayed by w_0..w_{t-1}
        out = torch.einsum("bthj,bhji->bthi", rc * torch.exp(lexc), s)
        # intra-chunk (strictly causal): kv_s decays by w_{s+1}..w_{t-1}
        tidx = torch.arange(C, device=r.device)
        causal = tidx[:, None] > tidx[None, :]
        expnt = lexc[:, :, None] - linc[:, None]              # (B,C,C,H,N)
        expnt = expnt.masked_fill(~causal[None, :, :, None, None],
                                  float("-inf"))
        att = torch.einsum("bthj,btshj,bshj->bths", rc, torch.exp(expnt), kc)
        out = out + torch.einsum("bths,bshi->bthi", att, vc)
        # diagonal bonus: out_t also reads u * kv_t
        dcoef = torch.einsum("bthj,hj->bth", rc * kc, uf)
        out = out + dcoef[..., None] * vc
        # carry: S <- exp(L_C) S + sum_s exp(L_C - L_s) k_s v_s^T
        wlast = linc[:, -1]                                   # (B,H,N)
        kw = kc * torch.exp(wlast[:, None] - linc)
        s = (torch.exp(wlast)[..., :, None] * s
             + torch.einsum("bthj,bthi->bhji", kw, vc))
        outs.append(out)
    return torch.cat(outs, dim=1), s


def ssd_chunk(x, b, c, dt, a, s0, chunk: int = 64):
    """Chunked parallel-scan SSD: the recurrence of :func:`ssd_linear_scan`
    in matmul form per ``chunk`` steps (a shorter last chunk when
    ``chunk`` does not divide T), all streams f32.  The output is read
    after the state update, so the intra-chunk mask includes the
    diagonal (s <= t)."""
    B, T, H, P = x.shape
    s = s0.float()
    af = a.float()
    ys = []
    for lo in range(0, T, chunk):
        C = min(chunk, T - lo)
        xc, bc, cc, dtc = (t[:, lo:lo + C].float() for t in (x, b, c, dt))
        la = dtc * af[None, None, :]                          # (B,C,H)
        linc = torch.cumsum(la, dim=1)
        # cross-chunk: y_t reads the entry state decayed through step t
        y = torch.exp(linc)[..., None] * torch.einsum("bhpn,btn->bthp", s, cc)
        # intra-chunk (inclusive): upd_s decays by la_{s+1}..la_t
        tidx = torch.arange(C, device=x.device)
        mask = tidx[:, None] >= tidx[None, :]
        cb = torch.einsum("btn,bsn->bts", cc, bc)
        expnt = linc[:, :, None] - linc[:, None]              # (B,C,C,H)
        expnt = expnt.masked_fill(~mask[None, :, :, None], float("-inf"))
        M = cb[..., None] * torch.exp(expnt) * dtc[:, None]
        y = y + torch.einsum("btsh,bshp->bthp", M, xc)
        # carry: S <- exp(L_C) S + sum_s exp(L_C - L_s) dt_s x_s (x) b_s
        wlast = linc[:, -1]                                   # (B,H)
        wgt = torch.exp(wlast[:, None] - linc) * dtc          # (B,C,H)
        s = (torch.exp(wlast)[..., None, None] * s
             + torch.einsum("bthp,btn,bth->bhpn", xc, bc, wgt))
        ys.append(y)
    return torch.cat(ys, dim=1), s
