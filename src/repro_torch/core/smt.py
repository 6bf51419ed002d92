"""Oversubscription model — the Hopper analog of Power7 SMT modes.

Power7 SMT interleaves 1/2/4 hardware thread contexts per core to hide
stalls.  On Hopper the structurally equivalent latency-hiding knob is
oversubscription of a kernel's grid: launching ``oversubscribe`` x more
(smaller) thread blocks than minimally needed, so that while one block's
warps wait on device memory another block's warps on the same SM compute.
Blocks that share an SM also share its shared memory, so the number of
blocks in flight is bounded by that budget, as SMT modes are bounded by
register and issue resources.

Like SMT, oversubscription never raises peak FLOPs — it trades on-chip
memory for stall hiding, helps memory-latency-bound regions (SMT2/SMT4
winners in the paper: NQueens), and *hurts* regions that are already
bandwidth-saturated (the paper's Floorplan, GPAW).

The names keep the JAX package's (``fits_vmem``, ``VMEM_BYTES``) so a
reader finds the counterpart; "VMEM" stands here for the shared memory of
one SM that the blocks in flight on it share.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

VMEM_BYTES = 228 * 1024            # shared memory per Hopper SM
BLOCK_SMEM_BYTES = 227 * 1024      # shared memory one block may hold
MXU_TILE = 16                      # tile edge the port's kernels take
                                   # (16 x 16 thread grids; a warp's k-run)
DEFAULT_BUFFERS = 2                # double buffering


@dataclasses.dataclass(frozen=True)
class BlockChoice:
    block_shape: tuple
    oversubscribe: int             # 1 (SMT1), 2 (SMT2), 4 (SMT4) analog
    buffers: int = DEFAULT_BUFFERS

    def vmem_bytes(self, dtype_bytes: int = 2, operands: int = 3) -> int:
        elems = math.prod(self.block_shape)
        return elems * dtype_bytes * operands * self.buffers * self.oversubscribe


def fits_vmem(choice: BlockChoice, dtype_bytes: int = 2,
              operands: int = 3) -> bool:
    """Whether ``oversubscribe`` blocks of this choice fit one SM's shared
    memory together, each within the per-block limit."""
    total = choice.vmem_bytes(dtype_bytes, operands)
    return (total <= VMEM_BYTES
            and total // choice.oversubscribe <= BLOCK_SMEM_BYTES)


def aligned(block_shape: Sequence[int]) -> bool:
    """Whether the port's tiled kernels take the block: every dim a
    multiple of MXU_TILE (their 16 x 16 thread grids stride by 16)."""
    return all(d % MXU_TILE == 0 for d in block_shape)


def legal_modes(base_block: tuple, dtype_bytes: int = 2,
                operands: int = 3) -> list[BlockChoice]:
    """Enumerate SMT-analog modes for a kernel block: oversubscribing by k
    shrinks the leading block dim by k (more, smaller blocks)."""
    out = []
    for k in (1, 2, 4):
        lead = base_block[0] // k
        if lead < MXU_TILE:
            continue
        shape = (lead,) + tuple(base_block[1:])
        if not aligned(shape):
            continue
        choice = BlockChoice(shape, k)
        if fits_vmem(choice, dtype_bytes, operands):
            out.append(choice)
    return out


def stall_hiding_model(compute_s: float, memory_s: float, oversubscribe: int,
                       latency_fraction: float = 0.3) -> float:
    """Analytic step-time under oversubscription (tuner napkin math).

    Memory time splits into a bandwidth part (cannot be hidden — the paper's
    GPAW/Floorplan case: higher SMT modes don't help saturated bandwidth)
    and a latency part that k in-flight blocks divide down (the NQueens
    case: SMT4 keeps winning)."""
    bw_s = memory_s * (1 - latency_fraction)
    lat_s = memory_s * latency_fraction / max(oversubscribe, 1)
    return max(compute_s, bw_s) + lat_s
