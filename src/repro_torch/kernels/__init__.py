"""Hand-written Hopper kernels of the port, their plain PyTorch versions
(:mod:`.ref`) and the device-dispatching wrappers the model calls
(:mod:`.ops`).

``LAUNCHES`` counts, per kernel name, the launches each CUDA wrapper has
made — incremented where the kernel is launched and nowhere else, so a run
can show that its main path went through the kernels.  ``LAUNCH_SHAPES``
keeps the same launches by (kernel name, shape), the shapes a run really
launched.  A step captured as a CUDA graph (:mod:`repro_torch.serve.graphs`)
launches its kernels on every replay without calling the wrappers: the
graph takes its capture's launches back out of both tallies and adds them
at every replay.

``WORKSPACES`` lists the dicts in which a wrapper keeps buffers from one
call to the next (per device and stream).  A wrapper may replace such a
buffer with a larger one; a captured graph keeps every buffer it may have
read alive for as long as it lives.
"""
from __future__ import annotations

LAUNCHES: dict[str, int] = {}
LAUNCH_SHAPES: dict[tuple, int] = {}
WORKSPACES: list[dict] = []


def count_launch(name: str, *shape: int) -> None:
    """Note one launch of kernel ``name`` at ``shape`` in both tallies."""
    LAUNCHES[name] += 1
    key = (name, *shape)
    LAUNCH_SHAPES[key] = LAUNCH_SHAPES.get(key, 0) + 1


def reset_launches() -> None:
    """Set every kernel's launch count to 0 and forget the shapes."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LAUNCH_SHAPES.clear()
