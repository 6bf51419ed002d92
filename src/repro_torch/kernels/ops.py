"""The wrappers the model calls, dispatching on the device of the tensors
they are given: CPU tensors go to the plain version in :mod:`.ref`, CUDA
tensors to the hand-written kernel — which launches or raises.  There is no
fallback from one to the other.  Kernel knobs from ``RegionConfig`` (block
sizes, the scan mode and chunk length) surface here as keyword
arguments."""
from __future__ import annotations

import torch

from repro_torch.kernels import linear_scan as _scan
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


SCAN_MODES = ("fused_recurrent", "chunk")


def _scan_mode(mode: str) -> bool:
    """Whether ``mode`` is the chunked scan; raises on an unknown mode."""
    if mode not in SCAN_MODES:
        raise ValueError(f"scan mode {mode!r} unknown ({SCAN_MODES})")
    return mode == "chunk"


def wkv(r, k, v, w, u, s0, *, mode: str = "fused_recurrent",
        chunk: int = 64):
    """RWKV6 WKV in the model layout: r, k, v, w (B, T, H, N); u (H, N);
    s0 (B, H, N, N) -> out (B, T, H, N), final state, both f32.

    ``mode``: 'fused_recurrent' runs the sequential recurrence; 'chunk'
    the matmul-form chunked scan with ``chunk``-step chunks (as given: the
    model's chunk length reaches the kernel unclamped).  On CUDA the
    streams move to the kernel layout (B, H, T, N) in f32 and back."""
    chunked = _scan_mode(mode)
    if r.device.type == "cuda":
        tr = lambda t: t.transpose(1, 2).float().contiguous()  # noqa: E731
        out, s = _scan.wkv(tr(r), tr(k), tr(v), tr(w),
                           u.float().contiguous(), s0.float().contiguous(),
                           chunk=chunk if chunked else 0)
        return out.transpose(1, 2), s
    if r.device.type == "cpu":
        if chunked:
            return ref.wkv_chunk(r, k, v, w, u, s0, chunk)
        return ref.wkv_linear_scan(r, k, v, w, u, s0)
    raise ValueError(f"wkv: no version for device {r.device}")


def ssd(x, b, c, dt, a, s0, *, mode: str = "fused_recurrent",
        chunk: int = 64):
    """Mamba2 SSD in the model layout: x (B, T, H, P); b, c (B, T, N);
    dt (B, T, H); a (H,); s0 (B, H, P, N) -> y (B, T, H, P), final state,
    both f32.  ``mode`` and ``chunk`` as in :func:`wkv`."""
    chunked = _scan_mode(mode)
    if x.device.type == "cuda":
        f32 = lambda t: t.float().contiguous()  # noqa: E731
        y, s = _scan.ssd(f32(x.transpose(1, 2)), f32(b), f32(c),
                         f32(dt.transpose(1, 2)), f32(a), f32(s0),
                         chunk=chunk if chunked else 0)
        return y.transpose(1, 2), s
    if x.device.type == "cpu":
        if chunked:
            return ref.ssd_chunk(x, b, c, dt, a, s0, chunk)
        return ref.ssd_linear_scan(x, b, c, dt, a, s0)
    raise ValueError(f"ssd: no version for device {x.device}")
