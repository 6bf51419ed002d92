"""Time scans for recurrent blocks, on PyTorch.

The JAX package's ``chunked_scan`` nests two ``lax.scan``s with a
``jax.checkpoint`` around each chunk, so that the backward pass keeps only
chunk-boundary carries.  That is a device for backward memory; in the
forward pass it computes exactly a plain scan, which is what this module
gives: a loop over the leading (time) axis.  The recurrent families' own
scans run through :func:`repro_torch.kernels.ops.wkv` / ``ssd``.
"""
from __future__ import annotations

from typing import Callable

import torch

DEFAULT_CHUNK = 128


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
