"""Train/eval step factories, on PyTorch.

``make_train_step`` builds a function (params, opt_state, batch) ->
(params, opt_state, metrics) with:

* cross-entropy in f32 (:func:`cross_entropy`),
* gradients from ``torch.autograd.grad`` over the param leaves — the
  model's own tensors, aliased by ``detach().requires_grad_()`` for the
  step, so the tree stays shared with the serve engine and the bridge,
* gradient accumulation over ``microbatch`` slices (``accum="scan"``: one
  f32 accumulator; otherwise summed in the params' dtype, as the JAX
  package's unrolled form),
* remat controlled per layer by the plan (the model consults it),
* AdamW from :mod:`repro_torch.optim.adamw`, in place, under the
  ``optimizer`` region.

Every family trains (an MoE model's load-balancing aux loss joins the
loss at ``AUX_WEIGHT``; a VLM scores only the tokens after its vision
prefix).  The recurrent and hybrid models' scans run forward on the
hand-written kernels one segment at a time, and their gradient
recomputes each segment with the plain differentiable form
(:func:`repro_torch.kernels.ops.wkv` / ``ssd``); the attention and
matmul kernels have no backward, and training takes the einsum paths for
them.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core.policy import RegionPlan, null_plan
from repro_torch.core.regions import region
from repro_torch.models import layers as L
from repro_torch.models.model import N_VISION_TOKENS, Model
from repro_torch.optim import adamw
from repro_torch.optim.schedule import warmup_cosine

AUX_WEIGHT = 0.01


class _CrossEntropy(torch.autograd.Function):
    """mean(logsumexp(logits) - logits[label]) in f32.  It keeps only the
    logits it was given and the per-row logsumexp for the backward, which
    forms (softmax - onehot) / n in f32 in one buffer and casts it to the
    logits' dtype: no f32 copy of the logits outlives either pass."""

    @staticmethod
    def forward(ctx, logits, labels):
        x = logits.float()
        logz = torch.logsumexp(x, dim=-1)
        gold = torch.gather(x, -1, labels[..., None])[..., 0]
        ctx.save_for_backward(logits, labels, logz)
        return torch.mean(logz - gold)

    @staticmethod
    def backward(ctx, g):
        logits, labels, logz = ctx.saved_tensors
        p = torch.sub(logits.float(), logz[..., None]).exp_()
        p.scatter_add_(-1, labels[..., None],
                       torch.full_like(p[..., :1], -1.0))
        p.mul_(g / logz.numel())
        return p.to(logits.dtype), None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy of ``logits`` (..., V) against ``labels``
    (...), in f32."""
    return _CrossEntropy.apply(logits, labels.long())


def make_loss_fn(model: Model, plan: Optional[RegionPlan], unroll: bool):
    """loss_fn(params, batch) -> (loss, {"ce", "aux"}).  ``unroll`` is
    accepted for the JAX package's signature and has no effect: eager
    PyTorch runs the layers one by one either way."""
    plan = plan or null_plan()

    def loss_fn(params, batch):
        logits, aux = model.forward(params, batch, plan, unroll=unroll)
        labels = batch["labels"]
        if model.cfg.frontend == "vision_patches":
            # the stubbed vision prefix replaces the first tokens; score the
            # rest (N_VISION_TOKENS whatever the prefix's length, as the
            # JAX package does)
            logits = logits[:, N_VISION_TOKENS:]
            labels = labels[:, N_VISION_TOKENS:]
        ce = cross_entropy(logits, labels)
        return ce + AUX_WEIGHT * aux, {"ce": ce, "aux": aux}

    return loss_fn


def _unflatten_like(tree, leaves):
    it = iter(leaves)
    return L.tree_map(lambda _: next(it), tree)


def make_grad_fn(model: Model, plan: Optional[RegionPlan] = None, *,
                 unroll: bool = True):
    """grad_fn(params, batch) -> ((loss, metrics), grads): the counterpart
    of ``jax.value_and_grad(loss_fn, has_aux=True)``.  Grads have the
    params' tree and dtypes; nothing is written to the params."""
    loss_fn = make_loss_fn(model, plan, unroll)

    def grad_fn(params, batch):
        leaves = [p.detach().requires_grad_() for p in L.tree_leaves(params)]
        with torch.enable_grad():
            loss, metrics = loss_fn(_unflatten_like(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (loss.detach(), metrics), _unflatten_like(params, grads)

    return grad_fn


def _split_microbatch(batch, i, n):
    def slc(x):
        mb = x.shape[0] // n
        return x[i * mb:(i + 1) * mb]
    return {k: slc(v) for k, v in batch.items()}


def make_train_step(model: Model, plan: Optional[RegionPlan] = None, *,
                    opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
                    unroll: bool = True, microbatch: int = 1,
                    accum: str = "scan", schedule_total: int = 10_000,
                    grad_shardings: Any = None, opt_shardings: Any = None):
    """The train step.  ``unroll`` has no effect eagerly (see
    :func:`make_loss_fn`).  ``grad_shardings``/``opt_shardings`` are the
    JAX package's ZeRO-1 layouts; a port plan has no mesh, so they must be
    None (ROADMAP queue 1 item 14).  The params and moments are updated in
    place and returned; metrics are 0-dim tensors on the params' device,
    read back by nothing here."""
    if grad_shardings is not None or opt_shardings is not None:
        raise NotImplementedError(
            "sharded gradients and optimizer state are not ported yet "
            "(ROADMAP queue 1 item 14)")
    grad_fn = make_grad_fn(model, plan, unroll=unroll)

    def train_step(params, opt_state, batch):
        if microbatch <= 1:
            (loss, metrics), grads = grad_fn(params, batch)
        else:
            loss, metrics, grads = None, None, None
            for i in range(microbatch):
                (l2, m2), g2 = grad_fn(
                    params, _split_microbatch(batch, i, microbatch))
                if grads is None:
                    # scan: one f32 accumulator; unrolled: the grads' dtype
                    grads = (L.tree_map(lambda g: g.float(), g2)
                             if accum == "scan" else g2)
                    loss, metrics = l2, m2
                    continue
                for a, g in zip(L.tree_leaves(grads), L.tree_leaves(g2)):
                    a.add_(g)
                loss = loss + l2
                metrics = {k: metrics[k] + m2[k] for k in metrics}
            inv = 1.0 / microbatch
            loss = loss * inv
            metrics = {k: v * inv for k, v in metrics.items()}
            for g in L.tree_leaves(grads):
                g.mul_(inv)
        with region("optimizer"):
            lr_scale = warmup_cosine(
                opt_state["step"] + 1,
                warmup=max(min(100, schedule_total // 10), 1),
                total=schedule_total)
            params2, opt2, om = adamw.apply_updates(
                opt_cfg, params, grads, opt_state, lr_scale)
        metrics = dict(metrics, loss=loss, **om)
        return params2, opt2, metrics

    return train_step


def make_eval_step(model: Model, plan: Optional[RegionPlan] = None, *,
                   unroll: bool = True):
    loss_fn = make_loss_fn(model, plan, unroll)

    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = loss_fn(params, batch)
        return dict(metrics, loss=loss)

    return eval_step
