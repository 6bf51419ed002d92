"""Time scans for recurrent blocks, on PyTorch.

The JAX package's ``chunked_scan`` nests two ``lax.scan``s with a
``jax.checkpoint`` around each chunk, so that the backward pass keeps only
chunk-boundary carries.  In the forward pass it computes exactly a plain
scan, which is what :func:`chunked_scan` here gives: a loop over the
leading (time) axis.  The recurrent families' own scans run through
:func:`repro_torch.kernels.ops.wkv` / ``ssd``, whose gradient keeps the
same segments: the kernels run one segment at a time and only the
segment-boundary states are kept for the backward, which recomputes each
segment (``repro_torch.kernels.ops._ScanGrad``).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels.ops import DEFAULT_SEGMENT as DEFAULT_CHUNK


def chunked_scan(step_fn: Callable, carry, xs, chunk: int = DEFAULT_CHUNK):
    """``carry, y_t = step_fn(carry, x_t)`` over the leading axis of every
    tensor of the tuple ``xs``; returns (final carry, the y_t stacked on a
    new leading axis).  ``chunk`` is accepted for the JAX signature and
    changes nothing in a forward pass."""
    ys = []
    for t in range(xs[0].shape[0]):
        carry, y = step_fn(carry, tuple(x[t] for x in xs))
        ys.append(y)
    return carry, torch.stack(ys)
