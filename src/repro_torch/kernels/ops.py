"""The wrappers the model calls, dispatching on the device of the tensors
they are given: CPU tensors go to the plain version in :mod:`.ref`, CUDA
tensors to the hand-written kernel — which launches or raises.  There is no
fallback from one to the other.  Kernel knobs from ``RegionConfig`` (block
sizes) surface here as keyword arguments."""
from __future__ import annotations

import torch

from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import ref


def paged_attention_mq(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, block_tables: torch.Tensor,
                       lengths: torch.Tensor, *,
                       block_k: int = 0) -> torch.Tensor:
    """Multi-query paged decode attention (speculative verify), kernel
    layout q: (B, S, KVH, G, HD); query s sees lengths + s positions.
    Returns q's shape and dtype."""
    if q.device.type == "cuda":
        return _paged.paged_attention_mq(q, k_pages, v_pages, block_tables,
                                         lengths, block_k=block_k)
    if q.device.type == "cpu":
        _paged.resolve_block_k(block_k, k_pages.shape[1])
        return ref.paged_attention_mq(q, k_pages, v_pages, block_tables,
                                      lengths).to(q.dtype)
    raise ValueError(f"paged_attention_mq: no version for device {q.device}")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor, *,
                    block_k: int = 0) -> torch.Tensor:
    """Paged decode attention, one query per slot: q (B, KVH, G, HD) — the
    S=1 case of :func:`paged_attention_mq`."""
    return paged_attention_mq(q[:, None].contiguous(), k_pages, v_pages,
                              block_tables, lengths, block_k=block_k)[:, 0]
