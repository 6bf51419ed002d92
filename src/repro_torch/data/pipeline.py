"""Deterministic synthetic token pipeline, on PyTorch.

The pipeline is a stateless function of (seed, step, shard), so any host
can regenerate any step's shard: checkpoint-restart and elastic
re-sharding are exact.  The tokens come from numpy's Philox exactly as in
the JAX package's ``repro/data/pipeline.py``, so :func:`batch_at` gives the
same values, byte for byte once cast back to int32.  Batches are int64
tensors (the dtype embedding indexing takes) on the device the caller
names.

Synthetic text is an order-2 Markov chain over the vocab so the LM loss has
learnable structure (used by examples/train_100m_torch.py).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0


def _host_slice(cfg: DataConfig):
    per_host = cfg.global_batch // cfg.n_hosts
    lo = cfg.host_id * per_host
    return lo, per_host


def batch_at(cfg: DataConfig, step: int, device: DeviceLike = None) -> dict:
    """Regenerate the (host-local) batch for an arbitrary step, as int64
    tensors on ``device`` (``cuda`` unless the caller names another).

    The full global batch is generated from the step-keyed counter RNG and
    row-sliced per host, so any (n_hosts, host_id) split of the same
    global_batch yields byte-identical global data — the elastic invariant.
    """
    dev = resolve_device(device)
    lo, per_host = _host_slice(cfg)
    rng = np.random.Generator(np.random.Philox(key=cfg.seed + 7919 * step))
    T = cfg.seq_len + 1
    # skewed unigram draw (u^3 -> heavy head) + 50% repetition structure:
    # both are quickly learnable, so short smoke-training shows loss drop
    u = rng.random(size=(cfg.global_batch, T))
    draws = np.minimum((u ** 3 * cfg.vocab_size).astype(np.int64),
                       cfg.vocab_size - 1)
    repeat = rng.random(size=(cfg.global_batch, T)) < 0.5
    toks = draws.copy()
    for t in range(1, T):
        toks[:, t] = np.where(repeat[:, t], toks[:, t - 1], draws[:, t])
    toks = torch.from_numpy(toks[lo:lo + per_host]).to(dev)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def iterate(cfg: DataConfig, start_step: int = 0,
            device: DeviceLike = None) -> Iterator[dict]:
    step = start_step
    while True:
        yield batch_at(cfg, step, device)
        step += 1


class Prefetcher:
    """One-step lookahead prefetch (a host thread), hiding input latency.

    This is the data-side straggler mitigation: a slow host never adds input
    time on top of compute because batch t+1 is materialised during step t.
    With ``device`` set, the thread pins each host batch (on CUDA) and
    :meth:`__next__` moves it there with one non-blocking copy a tensor;
    without it, items are handed on as they are.
    """

    def __init__(self, it: Iterator[dict], depth: int = 2,
                 device: DeviceLike = None):
        import queue
        import threading
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._it = it
        self._device = None if device is None else resolve_device(device)
        pin = self._device is not None and self._device.type == "cuda"

        def worker():
            for item in it:
                if pin:
                    item = {k: v.pin_memory() for k, v in item.items()}
                self._q.put(item)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if self._device is None:
            return item
        return {k: v.to(self._device, non_blocking=True)
                for k, v in item.items()}
