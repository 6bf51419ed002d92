"""PyTorch/CUDA port of the ``repro`` package.

The package mirrors ``src/repro/`` path for path (``repro/serve/cache.py``
becomes ``repro_torch/serve/cache.py``).  It imports ``torch`` and numpy,
never ``jax`` and nothing of ``repro``.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; :func:`resolve_device` is the one
place that rule lives.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another one.  Raises when CUDA is wanted and absent — nothing
    continues on the CPU unless the CPU was asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev


def make_generator(device: torch.device, seed: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed`` — the
    port's only source of randomness."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g
