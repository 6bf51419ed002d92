"""AdamW from scratch, on PyTorch — the JAX package's step, not
``torch.optim.AdamW``'s:

* gradients are clipped by their global norm first,
* bias correction uses the incremented step,
* the decoupled weight decay is added to the update of matrices only
  (``ndim >= 2``),
* the update runs in f32 and is cast back to each param's dtype.

Params are the model's nested dict of tensors.  The state is
``{"step", "mu", "nu"}``: ``step`` a 0-dim int32 tensor, ``mu``/``nu`` f32
trees shaped like the params — the layout checkpoints store
(:mod:`repro_torch.train.checkpoint`), so a state saved by either package
restores into the other.  Updates are made in place; nothing is read back
to the host.  Under ZeRO-1 the sharded trainer hands :func:`apply_updates`
each rank's shard of every param, gradient and moment, and the global norm
of the sharded gradients (:func:`global_norm` with each leaf's split
axes).  Gradient compression is not ported.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def init_state(params) -> dict:
    leaves = L.tree_leaves(params)
    dev = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "mu": L.tree_map(zeros, params),
        "nu": L.tree_map(zeros, params),
    }


def abstract_state(param_specs) -> dict:
    """The state :func:`init_state` makes for params shaped like
    ``param_specs`` (tensors or anything with a ``shape``), as meta
    tensors: nothing is allocated."""
    z = lambda p: torch.empty(tuple(p.shape), dtype=torch.float32,  # noqa: E731
                              device="meta")
    return {
        "step": torch.empty((), dtype=torch.int32, device="meta"),
        "mu": L.tree_map(z, param_specs),
        "nu": L.tree_map(z, param_specs),
    }


def global_norm(tree, split_axes=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, summed in f32.

    ``split_axes``: for each leaf, in tree order, the mesh axes its
    block is split over (a sharded step's gradients).  The squares of the
    leaves split alike are summed here, then over those axes' ranks (one
    all-reduce an axis), so a leaf replicated over an axis counts once:
    every rank gets the norm of the whole, unsharded gradient."""
    sq = [torch.linalg.vector_norm(x, dtype=torch.float32).square()
          for x in L.tree_leaves(tree)]
    if split_axes is None:
        return torch.sqrt(torch.sum(torch.stack(sq)))
    from repro_torch.distributed import comm
    groups: dict = {}
    for s, axes in zip(sq, split_axes):
        groups.setdefault(tuple(sorted(axes)), []).append(s)
    parts = []
    for axes in sorted(groups):
        part = torch.sum(torch.stack(groups[axes]))
        for a in axes:
            part = comm.all_reduce(part, mesh, a)
        parts.append(part)
    return torch.sqrt(torch.sum(torch.stack(parts)))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state, lr_scale=1.0,
                  gnorm=None):
    """One AdamW step, in place; returns (params, state, metrics) — the
    same param and moment tensors, a new ``step`` and ``{"grad_norm",
    "lr"}`` as 0-dim f32 tensors (``grad_norm`` before clipping).  A
    sharded step passes its global ``gnorm`` (the leaves here are its
    shards)."""
    step = state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    stepf = step.to(torch.float32)
    b1t = 1.0 - torch.pow(cfg.b1, stepf)
    b2t = 1.0 - torch.pow(cfg.b2, stepf)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=stepf.device)

    for p, g, mu, nu in zip(L.tree_leaves(params), L.tree_leaves(grads),
                            L.tree_leaves(state["mu"]),
                            L.tree_leaves(state["nu"])):
        g = g.to(torch.float32, copy=True).mul_(scale)
        mu.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        nu.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        delta = (nu / b2t).sqrt_().add_(cfg.eps)
        delta = torch.div(mu / b1t, delta, out=delta)
        if p.ndim >= 2:   # decoupled weight decay on matrices only
            delta.add_(p, alpha=cfg.weight_decay)
        delta.mul_(lr)
        p.copy_(torch.sub(p, delta, out=delta))
    new_state = {"step": step, "mu": state["mu"], "nu": state["nu"]}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
