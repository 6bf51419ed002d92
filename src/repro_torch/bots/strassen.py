"""BOTS Strassen analog: dense linear algebra, compute-bound.

Strassen's 7-product recursion to a fixed depth; the leaves are batched
matmuls.  ``degree`` controls how finely the leaf products are split into
batched calls — the thread-count analog (1 = one coarse batched matmul,
higher = more, smaller parallel units).
"""
from __future__ import annotations

import torch

from repro_torch import DeviceLike, make_generator, resolve_device


def _split(m):
    n = m.shape[-1] // 2
    return m[..., :n, :n], m[..., :n, n:], m[..., n:, :n], m[..., n:, n:]


def _strassen_leaves(a, b, depth):
    """Return stacked (7^depth, n, n) leaf operand pairs."""
    if depth == 0:
        return a[None], b[None]
    a11, a12, a21, a22 = _split(a)
    b11, b12, b21, b22 = _split(b)
    pairs = [
        (a11 + a22, b11 + b22), (a21 + a22, b11), (a11, b12 - b22),
        (a22, b21 - b11), (a11 + a12, b22), (a21 - a11, b11 + b12),
        (a12 - a22, b21 + b22),
    ]
    las, lbs = [], []
    for pa, pb in pairs:
        la, lb = _strassen_leaves(pa, pb, depth - 1)
        las.append(la)
        lbs.append(lb)
    return torch.cat(las), torch.cat(lbs)


def _strassen_combine(m, depth):
    """m: (7^depth, n, n) leaf products -> full product."""
    if depth == 0:
        return m[0]
    step = m.shape[0] // 7
    p = [_strassen_combine(m[i * step:(i + 1) * step], depth - 1)
         for i in range(7)]
    c11 = p[0] + p[3] - p[4] + p[6]
    c12 = p[2] + p[4]
    c21 = p[1] + p[3]
    c22 = p[0] - p[1] + p[2] + p[5]
    top = torch.cat([c11, c12], dim=-1)
    bot = torch.cat([c21, c22], dim=-1)
    return torch.cat([top, bot], dim=-2)


def build(n: int = 256, depth: int = 2, degree: int = 1,
          device: DeviceLike = None):
    """Returns (fn, args). degree splits the 7^depth leaf matmuls."""
    dev = resolve_device(device)
    leaves = 7 ** depth
    degree = min(degree, leaves)

    def fn(a, b):
        la, lb = _strassen_leaves(a, b, depth)
        chunk = max(leaves // degree, 1)
        outs = []
        for i in range(0, leaves, chunk):   # `degree` parallel units
            outs.append(torch.matmul(la[i:i + chunk], lb[i:i + chunk]))
        prod = torch.cat(outs) if len(outs) > 1 else outs[0]
        return _strassen_combine(prod, depth)

    g = make_generator(dev, 0)
    a = torch.randn((n, n), generator=g, dtype=torch.float32, device=dev)
    b = torch.randn((n, n), generator=g, dtype=torch.float32, device=dev)
    return fn, (a, b)


def reference(a, b):
    return a @ b


def flops(n: int, depth: int) -> float:
    return 7 ** depth * 2 * (n // 2 ** depth) ** 3
