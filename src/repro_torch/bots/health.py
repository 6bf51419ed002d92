"""BOTS Health analog: discrete-event-ish simulation, memory-bound streaming.

A multi-level health system: patients arrive at villages, queue, are treated
or referred up a hospital hierarchy — modelled as batched counter states
updated per timestep (a loop over time; state streams through memory with
little compute per byte).  ``degree`` = number of independent village batches
updated per call.

Each unit draws from its own ``torch.Generator``, seeded from ``seed`` and
the unit's index inside ``fn``, so every call of ``fn`` draws the same
numbers.  The JAX package's PRNG streams cannot be reproduced: the two
packages agree in distribution, not draw for draw.
"""
from __future__ import annotations

import torch

from repro_torch import DeviceLike, make_generator, resolve_device

LEVELS = 4
CAPACITY = (4, 3, 2, 1)
REFER_P = 0.25


def step(queues, treated, capacity, gen):
    """One timestep of (V, LEVELS) queues and (V,) treated counts, with
    the (LEVELS,) capacity of each level.  Returns (queues, treated,
    arrivals, service, refer)."""
    dev = queues.device
    arrivals = torch.poisson(
        torch.full((queues.shape[0],), 3.0, device=dev),
        generator=gen).to(torch.int32)
    queues = queues + torch.nn.functional.pad(arrivals[:, None],
                                              (0, LEVELS - 1))
    service = torch.minimum(queues, capacity)
    queues = queues - service
    # referral: 25% of served move up a level.  Binomial(service, 0.25)
    # drawn as the sum of `service` Bernoulli(0.25) draws: service is at
    # most max(CAPACITY) = 4, and aten::binomial has no meta kernel, so
    # this form is also the one counters.collect can count
    cap = max(CAPACITY)
    u = torch.rand((queues.shape[0], LEVELS - 1, cap), generator=gen,
                   device=dev)
    tries = torch.arange(cap, device=dev) < service[:, :-1, None]
    refer = ((u < REFER_P) & tries).sum(-1, dtype=torch.int32)
    queues = queues + torch.nn.functional.pad(refer, (1, 0))
    treated = treated + service.sum(-1, dtype=torch.int32) \
        - refer.sum(-1, dtype=torch.int32)
    return queues, treated, arrivals, service, refer


def build(villages: int = 4096, steps: int = 64, degree: int = 1,
          seed: int = 0, device: DeviceLike = None):
    """Returns (fn, args); ``fn(queues0, treated0, capacity)`` ->
    (total_treated, peak_load) from the (degree, per, LEVELS) and (degree,
    per) initial states in ``args`` (zeros) and the levels' capacity,
    none of which it writes."""
    dev = resolve_device(device)
    degree = max(1, min(degree, villages))
    per = villages // degree

    def run_batch(init_q, init_t, capacity, gen):
        q, t = init_q, init_t
        load = []
        for _ in range(steps):
            q, t, *_ = step(q, t, capacity, gen)
            load.append(q.sum())
        return q, t, torch.stack(load)

    def fn(queues0, treated0, capacity):
        d = queues0.device
        outs = []
        for u in range(degree):                      # `degree` parallel units
            # one stream per unit; a meta tensor draws nothing, so no
            # generator there
            gen = None if d.type == "meta" else make_generator(
                d, seed * 1_000_003 + u)
            outs.append(run_batch(queues0[u], treated0[u], capacity, gen))
        total_treated = sum(o[1].sum() for o in outs)
        peak_load = torch.stack([o[2].max() for o in outs]).max()
        return total_treated, peak_load

    queues0 = torch.zeros((degree, per, LEVELS), dtype=torch.int32,
                          device=dev)
    treated0 = torch.zeros((degree, per), dtype=torch.int32, device=dev)
    capacity = torch.tensor(CAPACITY, dtype=torch.int32, device=dev)
    return fn, (queues0, treated0, capacity)
