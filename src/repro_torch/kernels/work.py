"""The work each hand-written kernel must do: the bytes it must move (each
input read once, each output written once) and the operations it must
compute, from the call's shapes (and, where the work depends on the data,
its lengths).  One source of truth for ``chip_smoke.py``'s bounds and for
the shape-only counters (:mod:`repro_torch.core.counters`), which note a
kernel call's work when its wrapper is handed meta tensors.

Each function returns ``(bytes, ops)``; :func:`bound_ms` turns that into
the least time the card could take and names what bounds it.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.core import roofline


def paged_attention(B: int, S: int, KVH: int, G: int, HD: int, item: int,
                    max_pages: int, page_size: int,
                    lengths: Optional[Sequence[int]] = None):
    """Paged multi-query decode attention: q read and the output written
    once, the block tables and lengths, and the K/V rows of the positions
    each slot's last query sees; QK and PV are 2 * HD operations each per
    visible (query, position).  ``lengths=None`` (shapes only) counts every
    page of the block table as seen."""
    if lengths is None:
        lengths = [max_pages * page_size - (S - 1)] * B
    lens = [int(n) for n in lengths]
    rows = sum(n + S - 1 for n in lens if n + S - 1 > 0)
    nbytes = (2 * B * S * KVH * G * HD * item + rows * 2 * KVH * HD * item
              + 4 * (B * max_pages + B))
    ops = sum(4 * HD * max(n + s, 0) * KVH * G for n in lens
              for s in range(S))
    return nbytes, ops


def wkv(B: int, H: int, T: int, N: int):
    """RWKV6 WKV, either form (f32): r, k, v, w, u and the entry state read
    once, the output and final state written once; ~7 N^2 operations per
    step and (b, h) (a multiply-add counts two, an exp one).  The chunked
    form computes the same function, so the chunk does not enter."""
    nbytes = 4 * (5 * B * H * T * N + H * N + 2 * B * H * N * N)
    return nbytes, 7 * N * N * T * B * H


def ssd(B: int, H: int, T: int, P: int, N: int):
    """Mamba2 SSD, either form (f32): x, b, c, dt, a and the entry state
    read once, y and the final state written once; 5 P N + 2 operations
    per step and (b, h)."""
    nbytes = 4 * (2 * B * H * T * P + 2 * B * T * N + B * H * T + H
                  + 2 * B * H * P * N)
    return nbytes, (5 * P * N + 2) * T * B * H


def matmul(M: int, N: int, K: int, item: int):
    """(M, K) @ (K, N): both inputs read once and the output written once,
    2 M N K operations."""
    return (M * K + K * N + M * N) * item, 2 * M * N * K


def visible_pairs(S: int, Sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the attention mask keeps: query i sees key j
    where ``i >= j`` (causal) and ``i - j < window`` (window > 0)."""
    n = 0
    for i in range(S):
        lo = max(0, i - window + 1) if window > 0 else 0
        hi = min(i, Sk - 1) if causal else Sk - 1
        n += max(hi - lo + 1, 0)
    return n


def attention(BH: int, S: int, Sk: int, D: int, item: int, causal: bool,
              window: int):
    """Masked softmax attention on (BH, S, D) queries over (BH, Sk, D)
    keys and values: q, k, v read and the output written once; QK and PV
    are 2 D operations each per visible pair (the softmax's few operations
    per pair are left out: they are not on the tensor cores' path)."""
    nbytes = 2 * BH * S * D * item + 2 * BH * Sk * D * item
    return nbytes, 4 * D * visible_pairs(S, Sk, causal, window) * BH


def bound_ms(nbytes: float, ops: float, dtype,
             card: roofline.Card = roofline.H100_SXM, tf32_passes: int = 0):
    """The least time in ms the card could take for this work, the larger
    of the bytes over device-memory bandwidth and the operations over the
    peak rate for ``dtype``; and which of the two it is.  ``tf32_passes``
    > 0 bounds an f32 call that runs on the tensor cores in that many TF32
    products (3 for a 3xTF32 split): that many times the operations at the
    card's TF32 rate."""
    t_bytes = nbytes / card.hbm_bw
    if tf32_passes:
        t_ops = tf32_passes * ops / card.tf32_flops
    else:
        t_ops = ops / roofline.peak_ops(dtype, card)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")
