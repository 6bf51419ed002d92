"""Hand-written Hopper kernels of the port, their plain PyTorch versions
(:mod:`.ref`) and the device-dispatching wrappers the model calls
(:mod:`.ops`).

``LAUNCHES`` counts, per kernel name, the launches each CUDA wrapper has
made — incremented where the kernel is launched and nowhere else, so a run
can show that its main path went through the kernels.
"""
from __future__ import annotations

LAUNCHES: dict[str, int] = {}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
