"""PyTorch library calls that ``chip_smoke.py`` times beside each of the
port's kernels, as the ``library_ms`` yardstick.  The port itself never
calls them: they live outside ``src/repro_torch/`` on purpose."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def dense_paged_inputs(q, k_pages, v_pages, block_tables, lengths):
    """Gather a paged-attention call's K/V dense and build its staircase
    mask, in the layout of PyTorch's fused attention: q (B, KVH*G, S, HD),
    k/v (B, KVH*G, T, HD), mask (B, 1, S, T).  Done once, outside any timed
    region."""
    B, S, KVH, G, HD = q.shape
    ps = k_pages.shape[1]
    bt = block_tables.long()
    T = bt.shape[1] * ps

    def dense(pages):                       # (B, T, KVH, HD) -> (B, H, T, HD)
        x = pages[bt].reshape(B, T, KVH, HD).permute(0, 2, 1, 3)
        return x.repeat_interleave(G, dim=1).contiguous()

    qd = q.reshape(B, S, KVH * G, HD).permute(0, 2, 1, 3).contiguous()
    qpos = lengths.long()[:, None] + torch.arange(S, device=q.device)
    mask = torch.arange(T, device=q.device)[None, None, :] < qpos[:, :, None]
    return qd, dense(k_pages), dense(v_pages), mask[:, None]


def paged_attention_library(qd, kd, vd, mask):
    """The same function as ``paged_attention_mq`` in one library call."""
    return F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)


def matmul_library(x, y):
    """The same product as ``tuned_matmul`` in one library call, in the
    inputs' dtype (TF32 stays off: the caller sets
    ``torch.backends.cuda.matmul.allow_tf32 = False``)."""
    return torch.matmul(x, y)


def dense_attention_inputs(q, k, v, causal: bool, window: int):
    """A ``flash_attention`` call's inputs in the layout of PyTorch's fused
    attention, (B, H, S, D), with its mask (S, Sk) as booleans (True =
    attend).  Done once, outside any timed region."""
    S, Sk = q.shape[1], k.shape[1]
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((S, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    tr = lambda t: t.transpose(1, 2).contiguous()  # noqa: E731
    return tr(q), tr(k), tr(v), mask


def attention_library(qd, kd, vd, mask):
    """The same function as ``flash_attention`` in one library call."""
    return F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)
