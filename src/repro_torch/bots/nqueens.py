"""BOTS N Queens analog: search, branch-heavy, integer ops.

Vectorized bitboard DFS: the frontier of partial placements is expanded
breadth-first for the first ``prefix`` rows (giving a batch of independent
subtrees), then each subtree is counted by a vectorized iterative DFS.
``degree`` = frontier batch width processed per call (thread-count analog).

The JAX package counts each subtree with a ``while_loop`` under ``vmap``:
XLA runs the batched loop until no lane is live and freezes a finished
lane.  :class:`LockstepDFS` is that loop in PyTorch: every lane's stacks
live in ``(lanes, rows_left + 1)`` int32 tensors, one step moves every live
lane (backtrack or descend, chosen by ``torch.where``), and a lane whose
depth fell below 0 is left as it is.  Steps run in blocks of ``block``;
after each block the host reads one flag, "any lane live" — the loop's
condition.  On ``cuda`` a block is captured as a CUDA graph at first use
and replayed, the counterpart of XLA's compiled loop.  Steps past the last
live lane change nothing, so a block size need not divide the step count.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device

#: DFS steps a block (one host read of the loop's condition per block)
BLOCK = 64


def _expand_frontier(n: int, prefix: int):
    """All legal (cols, diag1, diag2) states after `prefix` rows (numpy-side)."""
    states = [(0, 0, 0)]
    for _ in range(prefix):
        nxt = []
        for cols, d1, d2 in states:
            free = (~(cols | d1 | d2)) & ((1 << n) - 1)
            while free:
                bit = free & (-free)
                free ^= bit
                nxt.append((cols | bit, ((d1 | bit) << 1) & ((1 << n) - 1),
                            (d2 | bit) >> 1))
        states = nxt
    return np.array(states, np.int32).reshape(-1, 3)


def _init(n: int, rows_left: int, states):
    """(depth, cols, diag1, diag2, free stacks, count) of each lane, its
    root at stack row 0."""
    lanes, dev = states.shape[0], states.device
    full = (1 << n) - 1
    stacks = [torch.zeros((lanes, rows_left + 1), dtype=torch.int32,
                          device=dev) for _ in range(4)]
    sc, s1, s2, sf = stacks
    sc[:, 0] = states[:, 0]
    s1[:, 0] = states[:, 1]
    s2[:, 0] = states[:, 2]
    sf[:, 0] = ~(states[:, 0] | states[:, 1] | states[:, 2]) & full
    depth = torch.zeros(lanes, dtype=torch.int64, device=dev)
    count = torch.zeros(lanes, dtype=torch.int32, device=dev)
    return depth, sc, s1, s2, sf, count


def _step(n: int, rows_left: int, st, rows) -> None:
    """One DFS step of every lane, in place.  ``rows`` is
    ``arange(rows_left + 1)``."""
    depth, sc, s1, s2, sf, count = st
    full = (1 << n) - 1
    live = depth >= 0
    d = depth.clamp(min=0)[:, None]
    free = sf.gather(1, d)[:, 0]
    go = live & (free != 0)                 # descend; live & ~go: backtrack
    bit = free & -free
    cols = sc.gather(1, d)[:, 0] | bit
    d1 = ((s1.gather(1, d)[:, 0] | bit) << 1) & full
    d2 = (s2.gather(1, d)[:, 0] | bit) >> 1
    done = depth + 1 == rows_left
    here = (rows == d) & go[:, None]
    below = (rows == d + 1) & go[:, None]
    sf.copy_(torch.where(here, (free ^ bit)[:, None], torch.where(
        below & ~done[:, None], (~(cols | d1 | d2) & full)[:, None], sf)))
    sc.copy_(torch.where(below, cols[:, None], sc))
    s1.copy_(torch.where(below, d1[:, None], s1))
    s2.copy_(torch.where(below, d2[:, None], s2))
    count.add_((go & done).to(torch.int32))
    depth.add_(torch.where(go, (~done).long(), -live.long()))


class LockstepDFS:
    """Completions of each of a batch of subtree roots ((lanes, 3) int32
    (cols, diag1, diag2) states, ``rows_left`` rows still to place), by the
    lock-step DFS of the module docstring.  On ``cuda`` it holds one CUDA
    graph of a block per (device, lanes)."""

    def __init__(self, n: int, rows_left: int, block: int = BLOCK):
        self.n, self.rows_left, self.block = n, rows_left, block
        self._graphs: dict = {}

    def _block(self, st, rows, live) -> None:
        for _ in range(self.block):
            _step(self.n, self.rows_left, st, rows)
        live.copy_((st[0] >= 0).any())

    def __call__(self, states):
        """Per-lane counts, (lanes,) int32."""
        dev = states.device
        st = _init(self.n, self.rows_left, states)
        rows = torch.arange(self.rows_left + 1, device=dev)
        if dev.type == "meta":
            # counters.collect: a meta tensor has no value, so the loop's
            # condition cannot be read.  The JAX package's count runs into
            # the same unknown and counts a `while` whose bound is data
            # once (`_trip_count` in src/repro/core/counters.py finds the
            # constant 0 of `depth >= 0` and returns max(0, 1)); so here
            # the body runs once and nothing is read.
            _step(self.n, self.rows_left, st, rows)
            return st[-1]
        if dev.type == "cuda":
            return self._replay(st, rows)
        live = torch.ones((), dtype=torch.bool, device=dev)
        while bool(live):
            self._block(st, rows, live)
        return st[-1]

    def _replay(self, st, rows):
        key = (rows.device, st[0].shape[0])
        if key not in self._graphs:
            # the graph reads and writes these tensors' memory: they live
            # as long as it does
            static = tuple(t.clone() for t in st)
            rows = rows.clone()
            live = torch.ones((), dtype=torch.bool, device=rows.device)
            side = torch.cuda.Stream(device=rows.device)
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):       # warm-up before capture
                self._block(static, rows, live)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self._block(static, rows, live)
            self._graphs[key] = (graph, static, rows, live)
        graph, static, _, live = self._graphs[key]
        for s, v in zip(static, st):
            s.copy_(v)
        graph.replay()
        while bool(live):
            graph.replay()
        return static[-1].clone()


def build(n: int = 8, prefix: int = 2, degree: int = 1,
          device: DeviceLike = None):
    """Returns (fn, args): counts n-queens solutions."""
    dev = resolve_device(device)
    frontier = _expand_frontier(n, prefix)
    degree = max(1, min(degree, len(frontier)))
    chunk = (len(frontier) + degree - 1) // degree
    pad = degree * chunk - len(frontier)
    if pad:
        frontier = np.concatenate(
            [frontier, np.full((pad, 3), (1 << n) - 1, np.int32)])

    batches = torch.from_numpy(frontier.reshape(degree, chunk, 3)).to(dev)
    dfs = LockstepDFS(n, n - prefix)

    def fn(batches):
        return dfs(batches.reshape(-1, 3)).sum()

    return fn, (batches,)


KNOWN = {6: 4, 7: 40, 8: 92, 9: 352, 10: 724}
