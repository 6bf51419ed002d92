"""Fault-tolerant checkpointing, on PyTorch, in the JAX package's format.

Checkpoints are written atomically (tmp + rename) as ``.npz`` of the
flattened train-state tree — keys the ``::``-joined dict path, bf16 stored
as f32 — plus a JSON manifest carrying step, meta and a sha256 over the
sorted keys and bytes.  ``latest_valid`` scans a directory, verifies
manifests, and skips torn/corrupt files — a killed run restarts from the
newest intact checkpoint.  The format is ``repro/train/checkpoint.py``'s
byte for byte, so a checkpoint written by either package restores into the
other.  Restore casts each array to its template leaf's dtype and device.
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


def _unflatten(template, flat: dict):
    def build(tree, prefix):
        if isinstance(tree, dict):
            return {k: build(tree[k], prefix + (str(k),)) for k in tree}
        if isinstance(tree, (list, tuple)):
            return type(tree)(build(v, prefix + (str(i),))
                              for i, v in enumerate(tree))
        arr = flat[SEP.join(prefix)]
        if isinstance(tree, torch.Tensor):
            return torch.as_tensor(arr).to(device=tree.device,
                                           dtype=tree.dtype)
        return arr
    return build(template, ())


def _digest(flat: dict) -> str:
    digest = hashlib.sha256()
    for k in sorted(flat):
        digest.update(k.encode())
        digest.update(np.ascontiguousarray(flat[k]).tobytes())
    return digest.hexdigest()


def save(ckpt_dir: str, step: int, state: Any, *, meta: Optional[dict] = None,
         keep: int = 3) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(state)
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
        flat = dict(np.load(path))
    except Exception:
        return False
    return _digest(flat) == manifest["hash"]


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


def restore(ckpt_dir: str, template: Any, *, manifest: Optional[dict] = None):
    if manifest is None:
        found = latest_valid(ckpt_dir)
        if found is None:
            raise FileNotFoundError(f"no valid checkpoint in {ckpt_dir}")
        _, manifest = found
    with np.load(os.path.join(ckpt_dir, manifest["file"])) as npz:
        flat = dict(npz)
    return _unflatten(template, flat), manifest["step"]
