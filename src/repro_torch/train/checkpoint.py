"""Fault-tolerant checkpointing, on PyTorch, in the JAX package's format.

Checkpoints are written atomically (tmp + rename) as ``.npz`` of the
flattened train-state tree — keys the ``::``-joined dict path, bf16 stored
as f32 — plus a JSON manifest carrying step, meta and a sha256 over the
sorted keys and bytes.  ``latest_valid`` scans a directory, verifies
manifests, and skips torn/corrupt files — a killed run restarts from the
newest intact checkpoint.  The format is ``repro/train/checkpoint.py``'s
byte for byte, so a checkpoint written by either package restores into the
other.  Restore casts each array to its template leaf's dtype and device.

A state held in blocks over a mesh of ranks (the sharded trainer's:
params at their specs, AdamW moments at their ZeRO-1 specs) saves the
same file: every rank calls :func:`save` with the leaves' specs, each
leaf is gathered whole over the mesh axes its spec splits it on, one leaf
at a time, rank 0 writes, and the others wait at a barrier.  The file is
logically unsharded, so a checkpoint written on one mesh restores onto
any other, one device included, and into the JAX package's launcher:
:func:`restore` with the specs of the mesh resumed on reads one leaf at a
time and keeps only this rank's block of it (``elastic.block``).
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Any, Optional, Tuple

import numpy as np
import torch

SEP = "::"


def _items(tree, prefix=()):
    """(path, leaf) pairs in the JAX package's flattening order: dict keys
    sorted, sequences by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:  # npz can't store bfloat16:
            leaf = leaf.float()           # lossless upcast, restored via
        return leaf.cpu().numpy()         # the template leaf's dtype
    return np.asarray(leaf)


def _flatten(tree) -> dict:
    return {SEP.join(path): _to_numpy(leaf) for path, leaf in _items(tree)}


def _spec_items(tree, specs, prefix=()):
    """(path, leaf, spec) triples of a dict tree and the tree of its
    leaves' specs, in :func:`_items`'s order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_items(tree[k], specs[k], prefix + (str(k),))
    else:
        yield prefix, tree, specs


def _whole_leaf(block: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The whole leaf of which ``block`` is this rank's block under
    ``spec`` on ``mesh``: all-gathered along each split dim over its
    axes, the innermost axis of an entry first (the row-major order of
    ``sharding.leaf_block``).  Collective: every rank of the mesh calls
    it with its block."""
    from repro_torch.distributed import comm
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in reversed((entry,) if isinstance(entry, str)
                             else tuple(entry)):
            block = comm.all_gather(block.contiguous(), dim, mesh, axis)
    return block


def _gather_flat(state, specs, mesh) -> Optional[dict]:
    """``_flatten`` of the whole state on rank 0 (None elsewhere), from
    every rank's blocks, leaf by leaf: a gathered leaf is copied to host
    memory on rank 0 and dropped before the next."""
    import torch.distributed as dist
    root = dist.get_rank() == 0
    flat = {}
    for path, leaf, spec in _spec_items(state, specs):
        whole = _whole_leaf(leaf.detach(), spec, mesh)
        if root:
            flat[SEP.join(path)] = _to_numpy(whole)
    return flat if root else None


def _unflatten(template, flat, cut=None, specs=None):
    """``template``'s tree of the arrays of ``flat`` (a dict, or an open
    ``.npz`` that reads each array when it is asked for), a tensor leaf
    cast to its template leaf's dtype and device; with ``cut``, the
    tensor ``cut(whole, spec, leaf)`` of each leaf and its spec in
    ``specs`` (a dict tree of the template's structure)."""
    def build(tree, prefix, spec):
        if isinstance(tree, dict):
            return {k: build(tree[k], prefix + (str(k),),
                             spec[k] if spec is not None else None)
                    for k in tree}
        if isinstance(tree, (list, tuple)):
            return type(tree)(build(v, prefix + (str(i),), None)
                              for i, v in enumerate(tree))
        arr = flat[SEP.join(prefix)]
        if not isinstance(tree, torch.Tensor):
            return arr
        if cut is not None:
            return cut(torch.as_tensor(arr), spec, tree)
        return torch.as_tensor(arr).to(device=tree.device, dtype=tree.dtype)
    return build(template, (), specs)


def _digest(flat: dict) -> str:
    digest = hashlib.sha256()
    for k in sorted(flat):
        digest.update(k.encode())
        digest.update(np.ascontiguousarray(flat[k]).tobytes())
    return digest.hexdigest()


def save(ckpt_dir: str, step: int, state: Any, *, meta: Optional[dict] = None,
         keep: int = 3, specs: Any = None, mesh=None) -> Optional[str]:
    """Write ``state`` as checkpoint ``step``; returns its name.  With
    ``specs`` (a tree of ``state``'s structure whose leaves are specs,
    such as ``{"params": sharding.param_shardings(...), "opt":
    sharding.opt_state_shardings(...)}``) and ``mesh``, ``state``
    holds this rank's blocks and every rank of the mesh calls ``save``
    in step: the leaves are gathered whole, rank 0 writes, every rank
    returns after the file is in place (None on the other ranks)."""
    if specs is not None and mesh is not None:
        import torch.distributed as dist
        flat = _gather_flat(state, specs, mesh)
        name = (_write(ckpt_dir, step, flat, meta, keep)
                if flat is not None else None)
        dist.barrier()
        return name
    return _write(ckpt_dir, step, _flatten(state), meta, keep)


def _write(ckpt_dir: str, step: int, flat: dict, meta: Optional[dict],
           keep: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"ckpt_{step:08d}"
    # atomic npz (suffix must be .npz or np.savez writes to tmp + ".npz"
    # and the rename would move an empty file)
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp.npz")
    os.close(fd)
    np.savez(tmp, **flat)
    os.replace(tmp, os.path.join(ckpt_dir, name + ".npz"))
    manifest = {"step": step, "hash": _digest(flat),
                "meta": meta or {}, "file": name + ".npz"}
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, os.path.join(ckpt_dir, name + ".json"))
    _gc(ckpt_dir, keep)
    return name


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(int(f[5:13]) for f in os.listdir(ckpt_dir)
                   if f.startswith("ckpt_") and f.endswith(".json"))
    for s in steps[:-keep] if keep else []:
        for ext in (".json", ".npz"):
            try:
                os.remove(os.path.join(ckpt_dir, f"ckpt_{s:08d}{ext}"))
            except OSError:
                pass


def _verify(ckpt_dir: str, manifest: dict) -> bool:
    path = os.path.join(ckpt_dir, manifest["file"])
    if not os.path.exists(path):
        return False
    try:
        with np.load(path) as npz:      # one array at a time
            return _digest(npz) == manifest["hash"]
    except Exception:
        return False


def latest_valid(ckpt_dir: str) -> Optional[Tuple[int, dict]]:
    """Newest checkpoint that passes integrity verification."""
    if not os.path.isdir(ckpt_dir):
        return None
    manifests = sorted((f for f in os.listdir(ckpt_dir) if f.endswith(".json")),
                       reverse=True)
    for mf in manifests:
        try:
            with open(os.path.join(ckpt_dir, mf)) as f:
                manifest = json.load(f)
        except Exception:
            continue
        if _verify(ckpt_dir, manifest):
            return manifest["step"], manifest
    return None


def restore(ckpt_dir: str, template: Any, *, manifest: Optional[dict] = None,
            specs: Any = None, mesh=None):
    """(the state of checkpoint ``manifest``, or of the newest intact
    one, in ``template``'s tree, dtypes and devices; its step), read one
    leaf at a time.  With ``specs`` and ``mesh`` (as :func:`save` takes
    them), ``template`` holds this rank's blocks: each leaf is read
    whole, cut to this rank's block and dropped before the next is read,
    so a rank holds at most one whole leaf besides its blocks."""
    if manifest is None:
        found = latest_valid(ckpt_dir)
        if found is None:
            raise FileNotFoundError(f"no valid checkpoint in {ckpt_dir}")
        _, manifest = found
    cut = None
    if specs is not None and mesh is not None:
        from repro_torch.distributed.sharding import mesh_coords
        from repro_torch.train.elastic import block
        coords = mesh_coords(mesh)

        def cut(whole, spec, leaf):
            return block(whole, spec, mesh, coords, leaf.device, leaf.dtype)
    with np.load(os.path.join(ckpt_dir, manifest["file"])) as npz:
        return _unflatten(template, npz, cut, specs), manifest["step"]
