"""The collectives of a sharded step, over one named axis of a plan's mesh.

* ``all_reduce`` (sum or max) and ``broadcast`` — what a tensor-parallel
  serve step issues, in place, under ``no_grad``;
* ``reduce_from_model`` / ``copy_to_model`` — the autograd-aware pair of
  a tensor-parallel training step: the row-parallel output's all-reduce
  (identity in the backward), and the identity at the replicated input
  of a column-parallel product (an all-reduce of its gradient);
* ``gather_from_model`` — a column-parallel output made whole on every
  rank (an all-gather on the last dim), whose gradient — each rank's
  part of it — is reduce-scattered back to the rank's columns; and
  ``sum_over_model`` — a sum over the ``model`` axis (an all-reduce) of a
  partial reduction that every rank reads, such as the sum of squares of
  a norm over a split dim, whose gradient is all-reduced too;
* ``reduce_scatter`` / ``all_gather`` along one dim over the ``data``
  axis — ZeRO-1's gradient shard and the updated parameter's regather;
* over the batch axes (:func:`batch_axes`, the mesh axes the rows are
  split over): ``mean_over_batch`` — a mean of every rank's per-row
  means (an all-reduce), autograd-aware, for statistics of the whole
  batch such as an MoE layer's load-balancing means — and
  ``gather_over_batch``, every rank's tensor stacked in row order (an
  all-gather), such as the per-expert counts of a token group that spans
  ranks.
  Under NCCL they are ``reduce_scatter_tensor`` / ``all_gather_into_tensor``
  on the dim moved to the front; gloo has no reduce-scatter, so there it
  is an all-reduce and a ``narrow``.

On the meta device (:func:`repro_torch.core.counters.collect`) a
collective runs nothing: it notes what the NCCL path issues into the
count, with the JAX package's ring-cost rules, and returns a tensor of
its output's shape.
"""
from __future__ import annotations

import torch

from repro_torch.core.policy import mesh_shape


def axis_size(mesh, axis: str) -> int:
    """Ranks on the mesh's ``axis`` (1 without a mesh or that axis)."""
    if mesh is None:
        return 1
    return mesh_shape(mesh).get(axis, 1)


def axis_index(mesh, axis: str) -> int:
    """This rank's index on the mesh's ``axis`` (0 without a mesh, on a
    stand-in mesh without coordinates, or on an axis it lacks)."""
    if mesh is None or axis not in mesh_shape(mesh):
        return 0
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return mesh.get_local_rank(axis)
    return getattr(mesh, "coords", {}).get(axis, 0)


def model_index(mesh) -> int:
    """This rank's index on the mesh's ``model`` axis."""
    return axis_index(mesh, "model")


def batch_axes(mesh, rules) -> tuple:
    """The mesh axes of more than one rank that the ``batch`` rule of
    ``rules`` splits the rows over, in the rule's order (outermost
    first); () without a mesh."""
    entry = rules.get("batch")
    names = (entry,) if isinstance(entry, str) else tuple(entry or ())
    return tuple(a for a in names if axis_size(mesh, a) > 1)


def batch_index(mesh, axes: tuple) -> int:
    """This rank's row-major index over ``axes``: the place of its rows
    in the batch."""
    index = 0
    for a in axes:
        index = index * axis_size(mesh, a) + axis_index(mesh, a)
    return index


def _note(kind: str, x: torch.Tensor, n: int) -> None:
    from repro_torch.core import counters
    counters.note_collective(kind, x.numel() * x.element_size(), n,
                             tuple(x.shape))


def all_reduce(x: torch.Tensor, mesh, axis: str = "model",
               op: str = "sum") -> torch.Tensor:
    """Reduce ``x`` (``op``: ``sum`` or ``max``) over the mesh's ``axis``,
    in place; returns it."""
    n = axis_size(mesh, axis)
    if x.device.type == "meta":
        _note("all-reduce", x, n)
        return x
    if n == 1:
        return x
    import torch.distributed as dist
    if op == "sum":
        dist.all_reduce(x, group=mesh.get_group(axis))
    else:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.get_group(axis))
    return x


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mark_dirty(x)
        return all_reduce(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.mesh), None


def _differentiable(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The row-parallel output: ``x``, this rank's partial sum, summed
    over the ``model`` axis (in place); the gradient passes through
    unchanged.  Outside autograd it is :func:`all_reduce`."""
    if not _differentiable(x):
        return all_reduce(x, mesh)
    if x._is_view():
        x = x.clone()
    return _ReduceFromModel.apply(x, mesh)


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The replicated input of a column-parallel product: ``x`` itself,
    whose gradient — each rank's part from its columns — is summed over
    the ``model`` axis in the backward.  The identity outside autograd or
    on a mesh whose ``model`` axis is 1."""
    if not _differentiable(x) or axis_size(mesh, "model") == 1:
        return x
    return _CopyToModel.apply(x, mesh)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_gather(x, x.dim() - 1, mesh, "model")

    @staticmethod
    def backward(ctx, g):
        # a copy: gloo's reduce-scatter is an all-reduce in place
        return reduce_scatter(g.clone(memory_format=torch.contiguous_format),
                              g.dim() - 1, ctx.mesh, "model"), None


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_reduce(x.clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.mesh), None


def gather_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's columns of ``x`` (..., C/m), concatenated on the last
    dim in ``model`` order: the whole (..., C) on every rank.  Under
    autograd each rank's gradient of the whole is its own part of the
    true one (every rank goes on from the same whole), so the backward
    sums the parts over ``model`` and keeps the rank's columns: a
    reduce-scatter.  The identity on a ``model`` axis of 1."""
    if axis_size(mesh, "model") == 1:
        return x
    if not _differentiable(x):
        return all_gather(x, x.dim() - 1, mesh, "model")
    return _GatherFromModel.apply(x, mesh)


def sum_over_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over the ``model`` axis, out of place: each rank's
    partial reduction of a dim split over ``model`` (a sum of squares over
    its columns) made the whole one.  Every rank reads the sum for its
    own columns only, so each rank's gradient of it is a part of the true
    one and the backward all-reduces it as well.  The identity on a
    ``model`` axis of 1."""
    if axis_size(mesh, "model") == 1:
        return x
    if not _differentiable(x):
        return all_reduce(x.clone(), mesh)
    return _SumOverModel.apply(x, mesh)


class _MeanOverBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _mean_over(x.clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _mean_over(g.clone(), ctx.mesh, ctx.axes), None, None


def _mean_over(x: torch.Tensor, mesh, axes: tuple) -> torch.Tensor:
    n = 1
    for a in axes:
        x = all_reduce(x, mesh, a)
        n *= axis_size(mesh, a)
    return x / n


def mean_over_batch(x: torch.Tensor, mesh, axes: tuple) -> torch.Tensor:
    """The mean of every rank's ``x`` over the batch ``axes``, out of
    place: each rank's mean over its own rows made the mean over the
    whole batch (equal rows a rank).  Under autograd the backward is the
    same mean of the ranks' gradients: each rank's loss reads the whole
    mean, and the sharded step (``trainer._GradSync``) averages the
    ranks' gradients, so that rank ``r``'s part of the whole mean gets
    the sum of every rank's gradient over ``len(ranks)``, its share.
    The identity on no axes."""
    if not axes:
        return x
    if not _differentiable(x):
        return _mean_over(x.clone(), mesh, axes)
    return _MeanOverBatch.apply(x, mesh, axes)


def gather_over_batch(x: torch.Tensor, mesh, axes: tuple) -> torch.Tensor:
    """Every rank's ``x`` over the batch ``axes``, stacked on a new
    leading dim in the order of the ranks' rows (:func:`batch_index`)."""
    x = x[None]
    for a in reversed(axes):
        x = all_gather(x, 0, mesh, a)
    return x


def _backend(mesh, axis: str) -> str:
    import torch.distributed as dist
    return dist.get_backend(mesh.get_group(axis))


def reduce_scatter(x: torch.Tensor, dim: int, mesh,
                   axis: str = "data") -> torch.Tensor:
    """``x`` summed over the mesh's ``axis``, of which this rank keeps
    block ``axis_index`` along ``dim`` (``x.shape[dim]`` divisible by the
    axis size)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    part = x.shape[dim] // n
    if x.device.type == "meta":
        _note("reduce-scatter", x, n)
        shape = list(x.shape)
        shape[dim] = part
        return x.new_empty(shape)
    import torch.distributed as dist
    group = mesh.get_group(axis)
    i = axis_index(mesh, axis)
    if _backend(mesh, axis) != "nccl":
        full = all_reduce(x.contiguous(), mesh, axis)
        return full.narrow(dim, i * part, part)
    inp = x.movedim(dim, 0).contiguous()
    out = inp.new_empty((part,) + inp.shape[1:])
    dist.reduce_scatter_tensor(out, inp, group=group)
    return out.movedim(0, dim)


def all_gather(x: torch.Tensor, dim: int, mesh,
               axis: str = "data") -> torch.Tensor:
    """Every rank's ``x`` of the mesh's ``axis``, concatenated along
    ``dim`` in axis order."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    if x.device.type == "meta":
        _note("all-gather", x, n)
        shape = list(x.shape)
        shape[dim] *= n
        return x.new_empty(shape)
    import torch.distributed as dist
    group = mesh.get_group(axis)
    inp = x.movedim(dim, 0).contiguous()
    if _backend(mesh, axis) != "nccl":
        parts = [torch.empty_like(inp) for _ in range(n)]
        dist.all_gather(parts, inp, group=group)
        out = torch.cat(parts, 0)
    else:
        out = inp.new_empty((n * inp.shape[0],) + inp.shape[1:])
        dist.all_gather_into_tensor(out, inp, group=group)
    return out.movedim(0, dim)


def replicate_vocab(x: torch.Tensor, vocab: int, mesh) -> torch.Tensor:
    """Vocab-sharded ``(..., V/tp)`` rows -> the full ``(..., V)`` rows on
    every rank: this rank's block written into a zero-filled full-vocab
    buffer, then one all-reduce.  A leaf that was never split (a vocab the
    degree does not divide) comes back as it is."""
    vl = x.shape[-1]
    if vl == vocab:
        return x
    buf = torch.zeros(x.shape[:-1] + (vocab,), dtype=x.dtype,
                      device=x.device)
    buf.narrow(-1, model_index(mesh) * vl, vl).copy_(x)
    return all_reduce(buf, mesh)
