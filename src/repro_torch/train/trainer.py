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

Every family trains on one device (an MoE model's load-balancing aux
loss joins the loss at ``AUX_WEIGHT``; a VLM scores only the tokens after
its vision prefix).  Every family also trains over a mesh of ranks,
each holding its block of every leaf (``grad_shardings`` /
``opt_shardings``, the JAX package's ZeRO-1 layouts): the layers'
collectives make each rank's gradient that of its block (an MoE layer's
experts split over ``model``, its aux loss that of the whole batch on
every rank, :mod:`repro_torch.models.moe`), the loss over
vocab-split logits is a vocab-parallel cross-entropy, each gradient is
reduced over the batch axes — reduce-scattered over ``data`` to its
moments' shard under ZeRO-1 — AdamW updates the shard, and the updated
param is all-gathered over ``data``.  The recurrent and hybrid models' scans run forward on the
hand-written kernels one segment at a time, and their gradient
recomputes each segment with the plain differentiable form
(:func:`repro_torch.kernels.ops.wkv` / ``ssd``); the attention and
matmul kernels have no backward, and training takes the einsum paths for
them.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core.policy import RegionPlan, mesh_shape, null_plan
from repro_torch.core.regions import region
from repro_torch.distributed import comm
from repro_torch.distributed import sharding as shard_mod
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


class _VocabParallelCE(torch.autograd.Function):
    """:class:`_CrossEntropy` over logits split on the vocab across the
    ``model`` axis: each rank holds columns ``[i*Vl, (i+1)*Vl)``.  The
    rows' max and their exp-sums are all-reduced over ``model`` (max,
    then sum), and the gold logit is taken where it lives and summed over
    ``model``; nothing of the full vocab is formed.  The backward is each
    rank's block of (softmax - onehot) / n, with no collective."""

    @staticmethod
    def forward(ctx, logits, labels, mesh):
        x = logits.float()
        vl = x.shape[-1]
        top = comm.all_reduce(x.amax(-1), mesh, op="max")
        e = torch.sub(x, top[..., None]).exp_()
        logz = comm.all_reduce(e.sum(-1), mesh).log_().add_(top)
        del e
        ids = labels - comm.model_index(mesh) * vl
        hit = (ids >= 0) & (ids < vl)
        ids = ids.clamp(0, vl - 1)
        gold = torch.gather(x, -1, ids[..., None])[..., 0]
        gold = comm.all_reduce(torch.where(hit, gold, torch.zeros_like(gold)),
                               mesh)
        ctx.save_for_backward(logits, ids, hit, logz)
        return torch.mean(logz - gold)

    @staticmethod
    def backward(ctx, g):
        logits, ids, hit, logz = ctx.saved_tensors
        p = torch.sub(logits.float(), logz[..., None]).exp_()
        p.scatter_add_(-1, ids[..., None], -hit[..., None].float())
        p.mul_(g / logz.numel())
        return p.to(logits.dtype), None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 mesh) -> torch.Tensor:
    """:func:`cross_entropy` of vocab-split ``logits`` (..., V/m) on a
    mesh whose ``model`` axis is m: every rank gets the loss of the full
    logits."""
    return _VocabParallelCE.apply(logits, labels.long(), mesh)


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
        if logits.shape[-1] != model.cfg.vocab_size:
            ce = vocab_parallel_cross_entropy(logits, labels, plan.mesh)
        else:
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
    :func:`make_loss_fn`).  The params and moments are updated in place
    and returned; metrics are 0-dim tensors on the params' device, read
    back by nothing here.

    ``grad_shardings``/``opt_shardings``: the specs of the params and of
    the moments (``sharding.param_shardings`` and
    ``opt_state_shardings(...)["mu"]``) on ``plan.mesh``; the step then
    runs on every rank of the mesh (the same collectives in the same
    order), on this rank's blocks: params and grads at the param specs'
    local shapes, moments at the moment specs'.  The rows are split
    over the plan's batch axes; at ``microbatch`` > 1 each rank slices
    its own rows, which must be laid out as
    :func:`repro_torch.distributed.sharding.microbatch_rows` lays them
    (the launcher's): the ranks' local microbatch ``i`` is then the JAX
    package's microbatch ``i`` of the global batch, so that an MoE
    model's aux loss and its token groups spanning ranks are taken over
    the same tokens."""
    grad_fn = make_grad_fn(model, plan, unroll=unroll)
    sync = None
    if grad_shardings is not None or opt_shardings is not None:
        sync = _GradSync(model, plan, grad_shardings, opt_shardings)

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
            if sync is None:
                params2, opt2, om = adamw.apply_updates(
                    opt_cfg, params, grads, opt_state, lr_scale)
            else:
                loss, metrics = sync.mean_metrics(loss, metrics)
                params2, opt2, om = sync.update(opt_cfg, params, grads,
                                                opt_state, lr_scale)
        metrics = dict(metrics, loss=loss, **om)
        return params2, opt2, metrics

    return train_step


class _GradSync:
    """The sharded step's side of the update: each rank's gradients
    reduced over the batch axes — reduce-scattered over ``data`` to the
    moments' shard where ZeRO-1 split the moments, all-reduced where it
    could not — AdamW on the shards with the norm of the whole gradient,
    and every ZeRO-1 param all-gathered over ``data``.  Every rank walks
    the leaves in the same order, so the collectives match."""

    def __init__(self, model: Model, plan: Optional[RegionPlan],
                 grad_shardings, opt_shardings):
        if plan is None or plan.mesh is None:
            raise ValueError("sharded gradients need a plan with a mesh")
        self.mesh = plan.mesh
        sizes = mesh_shape(self.mesh)
        if grad_shardings is None:
            grad_shardings = shard_mod.param_shardings(model, plan)
        if opt_shardings is None:
            opt_shardings = grad_shardings
        pspecs = L.tree_leaves(grad_shardings)
        ospecs = L.tree_leaves(opt_shardings)
        self.zdims = [shard_mod.zero1_dim(p, o)
                      for p, o in zip(pspecs, ospecs)]
        if sizes.get("data", 1) == 1:
            self.zdims = [None] * len(pspecs)
        self.split = [tuple(a for a in shard_mod.spec_axes(
            o if z is not None else p) if sizes.get(a, 1) > 1)
            for p, o, z in zip(pspecs, ospecs, self.zdims)]
        self.batch_axes = comm.batch_axes(self.mesh, plan.rules)
        self.n_batch = 1
        for a in self.batch_axes:
            self.n_batch *= sizes[a]

    def mean_metrics(self, loss, metrics):
        """The loss and metrics averaged over the batch axes (each rank's
        are its own rows' means, an MoE model's aux loss that of the whole
        batch on every rank)."""
        if not self.batch_axes:
            return loss, metrics
        keys = sorted(metrics)
        v = torch.stack([loss.float()] + [metrics[k].float() for k in keys])
        for a in self.batch_axes:
            v = comm.all_reduce(v, self.mesh, a)
        v = v / self.n_batch
        return v[0], {k: v[i + 1] for i, k in enumerate(keys)}

    def _reduce(self, g, zdim):
        axes = self.batch_axes
        if zdim is not None:
            g = comm.reduce_scatter(g, zdim, self.mesh, "data")
            axes = tuple(a for a in axes if a != "data")
        for a in axes:
            g = comm.all_reduce(g.contiguous(), self.mesh, a)
        return g / self.n_batch if self.n_batch > 1 else g

    @torch.no_grad()
    def update(self, opt_cfg, params, grads, opt_state, lr_scale):
        leaves = L.tree_leaves(params)
        gs = [self._reduce(g, z)
              for g, z in zip(L.tree_leaves(grads), self.zdims)]
        gnorm = adamw.global_norm(_unflatten_like(params, gs), self.split,
                                  self.mesh)
        i_data = comm.axis_index(self.mesh, "data")
        views = []
        for p, g, z in zip(leaves, gs, self.zdims):
            n = g.shape[z] if z is not None else 0
            views.append(p.narrow(z, i_data * n, n) if z is not None else p)
        _, opt2, om = adamw.apply_updates(
            opt_cfg, _unflatten_like(params, views),
            _unflatten_like(params, gs), opt_state, lr_scale, gnorm=gnorm)
        for p, v, z in zip(leaves, views, self.zdims):
            if z is not None:
                p.copy_(comm.all_gather(v.contiguous(), z, self.mesh,
                                        "data"))
        return params, opt2, om


def make_eval_step(model: Model, plan: Optional[RegionPlan] = None, *,
                   unroll: bool = True):
    loss_fn = make_loss_fn(model, plan, unroll)

    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = loss_fn(params, batch)
        return dict(metrics, loss=loss)

    return eval_step
