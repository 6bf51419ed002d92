"""Sharding specs for step functions: params, optimizer state, batches
and serving caches, derived from logical axes + a RegionPlan (legality
enforced by :func:`repro_torch.core.policy.legal_spec`), as in the JAX
package leaf for leaf.

A spec is a tuple with one entry per leading dim — a mesh-axis name, a
tuple of names, or None — with the trailing Nones dropped (the content of
the JAX package's ``PartitionSpec``).  These functions return specs, not
placed tensors: :func:`shard_leaf` cuts one rank's piece of a full leaf
from its spec and the rank's mesh coordinates.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core.policy import RegionPlan, legal_spec, mesh_shape
from repro_torch.models.model import Model

BATCH_AXES = {
    "tokens": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "frames": ("batch", "enc_seq", "embed"),
    "vision_embeds": ("batch", None, "embed"),
}

# serving-cache leaf axes, by leaf key (caches are per-layer dict entries)
CACHE_AXES = {
    "k": ("batch", "kv_seq", "kv_heads", "head_dim"),
    "v": ("batch", "kv_seq", "kv_heads", "head_dim"),
    # paged pools: (n_pages, page_size, kv_heads, head_dim).  Page id and
    # in-page position stay replicated — the host-side block table indexes
    # them on every shard — so tensor parallelism splits only the kv-head
    # dim: each shard holds kv_heads/tp heads of EVERY page.
    "k_pages": (None, None, "kv_heads", "head_dim"),
    "v_pages": (None, None, "kv_heads", "head_dim"),
    "s": ("batch", "ssm_heads", None, None),
    "x_prev": ("batch", "embed"),
    "conv_x": ("batch", None, "ssm_dim"),
    "conv_bc": ("batch", None, None),
    "enc_out": ("batch", "enc_seq", "embed"),
    "pos": (),
}


def _shape(leaf) -> tuple:
    """A leaf's shape: a tensor's or a TensorSpec's, or the leaf itself
    when it is a shape tuple."""
    return tuple(getattr(leaf, "shape", leaf))


def _sh(plan: RegionPlan, shape, axes) -> tuple:
    axes = tuple(axes)[: len(shape)] + (None,) * (len(shape) - len(axes))
    return legal_spec(shape, axes, plan.rules, plan.mesh)


def _map2(fn, a: Any, b: Any) -> Any:
    """``fn`` over the leaves of two nested dicts of one structure."""
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in sorted(a)}
    return fn(a, b)


def param_shardings(model: Model, plan: RegionPlan) -> Any:
    return _map2(lambda s, a: _sh(plan, s.shape, a), model.abstract_params(),
                 model.logical_axes())


def _zero1(plan: RegionPlan, shape, spec: tuple) -> tuple:
    """ZeRO-1: additionally split moments over the data axis on the first
    dim that is still replicated and divisible — optimizer state memory
    drops ~data-fold."""
    sizes = mesh_shape(plan.mesh)
    if "data" not in sizes:
        return spec
    used = {a for e in spec if e for a in ((e,) if isinstance(e, str) else e)}
    if "data" in used:
        return spec
    n = sizes["data"]
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for i, (dim, e) in enumerate(zip(shape, entries)):
        if e is None and dim % n == 0 and dim >= n:
            entries[i] = "data"
            return tuple(entries)
    return spec


def opt_state_shardings(model: Model, plan: RegionPlan,
                        zero1: bool = True) -> Any:
    """AdamW moments inherit parameter shardings (+ ZeRO-1 data split)."""
    ps = param_shardings(model, plan)
    if not zero1:
        ms = ps
    else:
        ms = _map2(lambda s, sp: _zero1(plan, s.shape, sp),
                   model.abstract_params(), ps)
    return {"step": (), "mu": ms, "nu": ms}


def batch_shardings(plan: RegionPlan, batch_specs: dict) -> dict:
    return {k: _sh(plan, _shape(v), BATCH_AXES.get(k, ("batch",)))
            for k, v in batch_specs.items()}


def cache_shardings(plan: RegionPlan, cache_spec: Any,
                    key: Optional[str] = None) -> Any:
    """The spec of every cache leaf, from the key it sits under."""
    if isinstance(cache_spec, dict):
        return {k: cache_shardings(plan, cache_spec[k], k)
                for k in sorted(cache_spec)}
    return _sh(plan, _shape(cache_spec), CACHE_AXES.get(key, ()))


def local_cache_spec(plan: RegionPlan, cache_spec: Any) -> Any:
    """The cache shapes of one rank's shard: each leaf's shape cut by its
    spec (:func:`cache_shardings`) on the plan's mesh."""
    return _map2(lambda leaf, spec: local_shape(_shape(leaf), spec,
                                                plan.mesh),
                 cache_spec, cache_shardings(plan, cache_spec))


def logits_sharding(plan: RegionPlan, shape) -> tuple:
    return _sh(plan, shape, ("batch", "seq", "vocab"))


# ---------------------------------------------------------------------------
# One rank's piece of a leaf
# ---------------------------------------------------------------------------


def _split(entry, sizes: dict, coords: dict) -> tuple:
    """(parts, index) of one spec entry: the product of its axes' sizes,
    and this rank's row-major index over them."""
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    parts, index = 1, 0
    for a in names:
        parts *= sizes[a]
        index = index * sizes[a] + coords[a]
    return parts, index


def local_shape(shape, spec: tuple, mesh) -> tuple:
    """The shape of one rank's piece of a leaf of ``shape`` under
    ``spec``."""
    sizes = mesh_shape(mesh) if mesh is not None else {}
    out = list(shape)
    for i, entry in enumerate(spec):
        if entry is not None:
            out[i] //= _split(entry, sizes, {a: 0 for a in sizes})[0]
    return tuple(out)


def leaf_block(t: torch.Tensor, spec: tuple, mesh,
               coords: dict) -> torch.Tensor:
    """The block of the full leaf ``t`` that the rank at mesh coordinates
    ``coords`` (``{axis name: index}``) holds under ``spec``, as a view:
    each split dim narrowed to the rank's block."""
    if not any(e is not None for e in spec):
        return t
    sizes = mesh_shape(mesh)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        parts, index = _split(entry, sizes, coords)
        n = t.shape[i] // parts
        t = t.narrow(i, index * n, n)
    return t


def shard_leaf(t: torch.Tensor, spec: tuple, mesh,
               coords: dict) -> torch.Tensor:
    """One rank's piece of the full leaf ``t`` (:func:`leaf_block`),
    contiguous.  A leaf that ``spec`` leaves whole comes back as it is."""
    return leaf_block(t, spec, mesh, coords).contiguous()


def microbatch_rows(t: torch.Tensor, spec: tuple, mesh, coords: dict,
                    microbatch: int = 1) -> torch.Tensor:
    """This rank's rows of the global batch leaf ``t`` (rows on dim 0,
    split by ``spec``) for a step that accumulates over ``microbatch``
    slices: its local microbatch ``i`` is its block of the global
    microbatch ``i`` (rows ``[i*B/mb, (i+1)*B/mb)``, the JAX package's
    trainer's slice), the blocks stacked in microbatch order — so that
    the ranks' local microbatch ``i`` together hold the JAX package's
    microbatch ``i``.  At ``microbatch`` 1 :func:`shard_leaf`."""
    if microbatch <= 1:
        return shard_leaf(t, spec, mesh, coords)
    B = t.shape[0]
    ranks = (_split(spec[0], mesh_shape(mesh), coords)[0]
             if spec and spec[0] is not None else 1)
    if B % (microbatch * ranks):
        raise ValueError(f"a batch of {B} rows does not split into "
                         f"{microbatch} microbatches over {ranks} ranks")
    slices = t.reshape((microbatch, B // microbatch) + tuple(t.shape[1:]))
    blocks = shard_leaf(slices, (None,) + tuple(spec), mesh, coords)
    return blocks.reshape((-1,) + tuple(t.shape[1:]))


def spec_axes(spec: tuple) -> tuple:
    """The mesh axes a spec splits its leaf over, in order."""
    out = []
    for e in spec:
        if e is not None:
            out.extend((e,) if isinstance(e, str) else e)
    return tuple(out)


def zero1_dim(param_spec: tuple, opt_spec: tuple) -> Optional[int]:
    """The dim ZeRO-1 split a leaf's moments on over ``data``
    (:func:`_zero1`), or None where the moments follow the param."""
    for i, e in enumerate(opt_spec):
        p = param_spec[i] if i < len(param_spec) else None
        if e == "data" and p is None:
            return i
    return None


def mesh_coords(mesh) -> dict:
    """``{axis name: this rank's index}`` on ``mesh``."""
    if mesh is None:
        return {}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return dict(getattr(mesh, "coords", {}))
    return {a: mesh.get_local_rank(a) for a in names}
