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
