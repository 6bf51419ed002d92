"""BOTS Floorplan analog: branch-and-bound optimization, small working set.

Place rectangular cells on a grid minimizing bounding-box area, exploring a
batched frontier of partial placements with bound pruning.  ``degree`` =
frontier width expanded per step (thread-count analog; unlike Strassen,
more width means more *wasted* speculative work — the paper's Floorplan is
the workload that does NOT benefit from higher SMT modes).

The ``degree`` lanes are vectorised; each runs ``256 // degree`` samples
in sequence, drawn inside ``fn`` from a ``torch.Generator`` seeded from
``seed`` (so every call draws the same samples).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import DeviceLike, make_generator, resolve_device

CELLS = np.array([[2, 3], [3, 2], [1, 4], [2, 2], [4, 1]], np.int32)
GRID = 8
SAMPLES = 256
NO_FIT = 10_000


def place_cost(positions, cells):
    """positions: (..., n_cells, 2) top-left corners, cells: (n_cells, 2)
    sizes -> (area, overlap), each of shape (...)."""
    x0 = positions[..., 0]
    y0 = positions[..., 1]
    x1 = x0 + cells[:, 0]
    y1 = y0 + cells[:, 1]
    area = (x1.amax(-1) - x0.amin(-1)) * (y1.amax(-1) - y0.amin(-1))
    # pairwise overlap
    ox = (torch.minimum(x1[..., :, None], x1[..., None, :])
          - torch.maximum(x0[..., :, None], x0[..., None, :])).clamp(min=0)
    oy = (torch.minimum(y1[..., :, None], y1[..., None, :])
          - torch.maximum(y0[..., :, None], y0[..., None, :])).clamp(min=0)
    ov = ox * oy
    overlap = torch.div(ov.sum((-1, -2)) - ov.diagonal(0, -2, -1).sum(-1),
                        2, rounding_mode="floor")
    return area, overlap


def build(n_cells: int = 5, degree: int = 4, seed: int = 0,
          device: DeviceLike = None):
    """Returns (fn, args); ``fn(best0, cells)`` -> the best score over
    the lanes, from the (degree,) int32 starting bounds and the
    (n_cells, 2) cell sizes in ``args``."""
    dev = resolve_device(device)
    degree = max(1, degree)

    def fn(best0, cells):
        """Randomized branch-and-bound: `degree` parallel frontier lanes."""
        d = best0.device
        # a meta tensor draws nothing: no generator there
        gen = None if d.type == "meta" else make_generator(d, seed)
        best = best0
        for _ in range(SAMPLES // degree):          # fixed total work
            pos = torch.randint(0, GRID - 1, (degree, n_cells, 2),
                                generator=gen, dtype=torch.int32, device=d)
            area, overlap = place_cost(pos, cells)
            score = torch.where(overlap > 0, NO_FIT, area)
            best = torch.minimum(best, score)
        return best.min()

    best0 = torch.full((degree,), NO_FIT, dtype=torch.int32, device=dev)
    cells = torch.tensor(CELLS[:n_cells], device=dev)
    return fn, (best0, cells)
