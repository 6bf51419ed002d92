"""The collectives of a tensor-parallel step, over the ``model`` axis of
a plan's mesh: only ``all_reduce`` and ``broadcast``, which both the NCCL
and the gloo backend take on CUDA tensors.

On the meta device (:func:`repro_torch.core.counters.collect`) a
collective runs nothing: it notes its bytes into the count, with the JAX
package's ring-cost rule, and returns its input.
"""
from __future__ import annotations

import torch

from repro_torch.core.policy import mesh_shape


def model_index(mesh) -> int:
    """This rank's index on the mesh's ``model`` axis (0 on a stand-in
    mesh without coordinates)."""
    if mesh is None:
        return 0
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return mesh.get_local_rank("model")
    return getattr(mesh, "coords", {}).get("model", 0)


def all_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum ``x`` over the mesh's ``model`` axis, in place; returns it."""
    n = mesh_shape(mesh).get("model", 1)
    if x.device.type == "meta":
        from repro_torch.core import counters
        counters.note_collective("all-reduce",
                                 x.numel() * x.element_size(), n)
        return x
    import torch.distributed as dist
    dist.all_reduce(x, group=mesh.get_group("model"))
    return x


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
