"""Paged multi-query decode attention on Hopper: the wrapper of the CUDA
kernel in ``csrc/paged_attention.cu`` (which replaces the Pallas TPU kernel
``paged_attention_mq`` of the JAX package).

Layout: q is (B, S, KVH, G, HD) — S is the per-slot query length (1 for
plain decode, ``spec_depth + 1`` for the speculative verify step) and the
heads are GQA-grouped so K/V are never materialised at the full head count;
k_pages/v_pages are (P, page_size, KVH, HD); the block table is
(B, max_pages) int32 page ids (zero-padded — page 0 is the pool's null
sink) and lengths is (B,) int32: the number of KV positions visible to
query 0 (each later query sees one more).

The kernel runs one thread block per (slot, kv-head), walks only the pages
the slot occupies in ``block_k``-row tiles staged through shared memory,
and shares each tile among all S * G query rows (see the source's note).
Rows whose length is 0 return finite garbage that the engine masks out at
sampling.  This module holds the CUDA path only; the plain version is
:func:`repro_torch.kernels.ref.paged_attention_mq` and the device dispatch
lives in :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import LAUNCHES, cuda_build

NAME = "paged_attention_mq"
LAUNCHES.setdefault(NAME, 0)

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232448            # bytes of shared memory a Hopper block may use


def shard_kv_heads(kv_heads: int, tp: int) -> int:
    """KV heads each shard sees under a ``tp``-way split of the page pool.

    Tensor parallelism splits the page pool on the kv-head dim only (pages:
    ``(P, page_size, KVH/tp, HD)`` per shard) — page ids, in-page positions
    and the host-side block table are identical on every shard, so each
    shard runs the same kernel over ``kv_heads // tp`` heads.  Raises when
    the head count cannot split evenly.
    """
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if kv_heads % tp:
        raise ValueError(
            f"tp={tp} does not divide kv_heads={kv_heads}: pages shard on "
            f"the kv-head axis, so the degree must split heads evenly")
    return kv_heads // tp


_lib = None


def _library() -> ctypes.CDLL:
    """The kernel's library with its C signatures declared (built and
    loaded at first use)."""
    global _lib
    if _lib is None:
        lib = cuda_build.load("paged_attention")
        lib.paged_attention_mq_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_void_p])
        lib.paged_attention_mq_launch.restype = ctypes.c_int
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        lib.paged_attention_mq_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.paged_attention_mq_smem_bytes.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def build() -> None:
    """Compile and load the kernel now (it is otherwise built at first
    launch)."""
    _library()


def resolve_block_k(block_k: int, page_size: int) -> int:
    """The K/V tile in rows: ``block_k`` capped at the page, 0 = a page."""
    bk = min(block_k, page_size) if block_k else page_size
    if page_size % bk:
        raise ValueError(f"block_k={block_k} must divide page_size={page_size}")
    return bk


def paged_attention_mq(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, block_tables: torch.Tensor,
                       lengths: torch.Tensor, *,
                       block_k: int = 0) -> torch.Tensor:
    """Launch the CUDA kernel: q (B, S, KVH, G, HD); pages (P, page_size,
    KVH, HD) -> a new tensor shaped and typed like q.  Every tensor must be
    a contiguous CUDA tensor on one device; anything the kernel does not
    take raises."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged_attention_mq kernel needs CUDA tensors, "
                         f"got q on {dev}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"q dtype {q.dtype} unsupported (float32/bfloat16)")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError("q, k_pages and v_pages must share one dtype")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("block_tables and lengths must be int32")
    if q.dim() != 5 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"bad shapes q={tuple(q.shape)} "
                         f"k_pages={tuple(k_pages.shape)} "
                         f"v_pages={tuple(v_pages.shape)}")
    B, S, kvh, g, hd = q.shape
    _, page_size, kvh_p, hd_p = k_pages.shape
    if (kvh_p, hd_p) != (kvh, hd):
        raise ValueError("page layout mismatch")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} unsupported ({HEAD_DIMS})")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"block_tables must be (B={B}, max_pages)")
    if lengths.shape != (B,):
        raise ValueError(f"lengths must be (B={B},)")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    bk = resolve_block_k(block_k, page_size)
    max_pages = block_tables.shape[1]
    lib = _library()
    smem = lib.paged_attention_mq_smem_bytes(S, g, hd, bk)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"S*G={S * g}, head_dim={hd}, block_k={bk} need "
                         f"{smem} bytes of shared memory (> {_SMEM_LIMIT})")
    out = torch.empty_like(q)
    if B == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.paged_attention_mq_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, S, kvh, g, hd, page_size, max_pages, bk, _DTYPES[q.dtype],
            1.0 / math.sqrt(hd), stream)
    if rc != 0:
        msg = lib.paged_attention_error_string(rc).decode()
        raise RuntimeError(f"paged_attention_mq launch failed: {msg} ({rc})")
    LAUNCHES[NAME] += 1
    return out
