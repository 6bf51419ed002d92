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

The kernel splits each slot's block table into runs of pages (split-KV),
one thread block per (slot, kv-head, row chunk) and run; each block walks
only the visible pages of its run with 16-byte loads, several positions in
flight per lane group, and the last block of a (slot, kv-head, row chunk)
to finish merges the runs' partial softmax states in the same launch (see
the source's note).  :func:`plan` picks the split from shapes alone, so a
call never reads a device value on the host.  Rows whose length is 0
return finite output (0) that the engine masks out at sampling.  This
module holds the CUDA path only; the plain version is
:func:`repro_torch.kernels.ref.paged_attention_mq` and the device dispatch
lives in :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from repro_torch.kernels import (LAUNCHES, WORKSPACES, count_launch,
                                 cuda_build)

NAME = "paged_attention_mq"
LAUNCHES.setdefault(NAME, 0)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's block and the positions each lane group loads before it
#: uses any (``kThreads`` and ``kUnroll`` of the source)
THREADS, UNROLL = 128, 4
#: the widest head a lane group holds in registers: 32 lanes x 2 vectors of
#: 4 f32 (bf16 rows up to 256 need one vector a lane)
MAX_HEAD_DIM = 256
#: floats of accumulator a lane keeps per set of query rows (q as many)
_LANE_FLOATS = 32
#: rounds of loads (``THREADS / lanes * UNROLL`` positions each) a block
#: aims to walk: fewer splits mean less to merge, more mean shorter walks
ROUNDS_PER_BLOCK = 4
#: the split aims at this many blocks per SM at least
MIN_BLOCKS_PER_SM = 1
#: at most this many splits of a block table: the merge reads them all
MAX_SPLITS = 64
#: CUDA kernels one call launches: the splits merge in the same launch
KERNELS_PER_CALL = 1


def check_head_dim(head_dim: int) -> None:
    """Raise unless the kernel takes ``head_dim``: a multiple of 8 (a row
    splits into 16-byte vectors of 8 bf16 or 4 f32) from 8 to
    :data:`MAX_HEAD_DIM`."""
    if head_dim % 8 or not 8 <= head_dim <= MAX_HEAD_DIM:
        raise ValueError(
            f"head_dim {head_dim} unsupported: the paged kernel takes a "
            f"multiple of 8 from 8 to {MAX_HEAD_DIM} (16-byte loads)")


def _pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


#: query rows a block may hold (the source's instantiations)
_ROWS = (1, 2, 3, 4, 8)


@dataclass(frozen=True)
class Plan:
    """How one call is laid out on the card, from shapes alone."""
    lanes: int            # lanes holding one K/V row (a power of two <= 32)
    vecs: int             # 16-byte vectors of a row each lane loads
    rows: int             # query rows a block holds (RC)
    row_chunks: int       # ceil(S * G / rows)
    pages_per_split: int  # pages of the block table one block walks
    n_split: int          # ceil(max_pages / pages_per_split)

    def blocks(self, B: int, KVH: int) -> int:
        """Thread blocks in the grid (those past a slot's pages exit at
        once)."""
        return B * KVH * self.row_chunks * self.n_split


@functools.lru_cache(maxsize=256)
def plan(B: int, S: int, KVH: int, G: int, HD: int, item: int,
         page_size: int, max_pages: int, n_sm: int) -> Plan:
    """The split of one call, a pure function of shapes and the SM count
    (memoised: the engine makes the same call every layer of every step).

    A row of HD elements is HD * item / 16 vectors; it takes the next power
    of two of lanes (at most 32) and as many vectors a lane as that leaves.
    A block holds as many of the S * G query rows as keep q and its
    accumulator at :data:`_LANE_FLOATS` floats a lane each, and the rest go
    to further row chunks.  A block walks the pages its lane groups load in
    :data:`ROUNDS_PER_BLOCK` rounds (``THREADS / lanes * UNROLL`` positions
    each), fewer where the grid would hold under :data:`MIN_BLOCKS_PER_SM`
    blocks per SM, never fewer than one page and never so few that the
    table splits more than :data:`MAX_SPLITS` ways."""
    check_head_dim(HD)
    vec = 16 // item
    nvec = HD // vec
    lanes = min(32, _pow2_at_least(nvec))
    vecs = -(-nvec // lanes)
    R = S * G
    most = _LANE_FLOATS // (vecs * vec)
    rows = min([n for n in _ROWS if n >= min(R, most)])
    row_chunks = -(-R // rows)
    units = B * KVH * row_chunks
    positions = (THREADS // lanes) * UNROLL * ROUNDS_PER_BLOCK
    pps = max(1, min(max_pages, positions // page_size))
    least = -(-max_pages // MAX_SPLITS)
    while pps > least and (units * -(-max_pages // pps)
                           < MIN_BLOCKS_PER_SM * n_sm):
        pps -= 1
    pps = max(pps, least)
    return Plan(lanes, vecs, rows, row_chunks, pps, -(-max_pages // pps))


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
_n_sm: dict[int, int] = {}
#: per (device, stream): the merge counters (zero between calls) and the
#: f32 workspace of the splits' partial states, grown as calls need
_tickets: dict[tuple[int, int], torch.Tensor] = {}
_partials: dict[tuple[int, int], torch.Tensor] = {}
WORKSPACES.extend((_tickets, _partials))


def _library() -> ctypes.CDLL:
    """The kernel's library with its C signatures declared (built and
    loaded at first use)."""
    global _lib
    if _lib is None:
        lib = cuda_build.load("paged_attention")
        lib.paged_attention_mq_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 14
            + [ctypes.c_float, ctypes.c_void_p])
        lib.paged_attention_mq_launch.restype = ctypes.c_int
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
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


def sm_count(dev: torch.device) -> int:
    """The device's SM count (a property the host holds: no sync)."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _n_sm:
        props = torch.cuda.get_device_properties(idx)
        _n_sm[idx] = props.multi_processor_count
    return _n_sm[idx]


def _stream_buffer(bufs: dict, dev: torch.device, stream: int, n: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """A zeroed buffer of at least ``n`` elements kept for ``stream``: calls
    on one stream run in order, so each may reuse what the last one left.
    The kernel leaves the merge counters zero, so they are zeroed only when
    first made or grown."""
    key = (dev.index, stream)
    buf = bufs.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=dtype, device=dev)
        bufs[key] = buf
    return buf


def paged_attention_mq(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, block_tables: torch.Tensor,
                       lengths: torch.Tensor, *,
                       block_k: int = 0) -> torch.Tensor:
    """Launch the CUDA kernel: q (B, S, KVH, G, HD); pages (P, page_size,
    KVH, HD) -> a new tensor shaped and typed like q.  Every tensor must be
    a contiguous CUDA tensor on one device; anything the kernel does not
    take raises.  ``block_k`` is validated (it must divide the page) and
    does not change the kernel's walk.  One kernel launch; nothing is read
    back to the host."""
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
    check_head_dim(hd)
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"block_tables must be (B={B}, max_pages)")
    if lengths.shape != (B,):
        raise ValueError(f"lengths must be (B={B},)")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    resolve_block_k(block_k, page_size)
    max_pages = block_tables.shape[1]
    p = plan(B, S, kvh, g, hd, q.element_size(), page_size, max_pages,
             sm_count(dev))
    lib = _library()
    out = torch.empty_like(q)
    if B == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    units = B * kvh * p.row_chunks
    part = _stream_buffer(_partials, dev, stream,
                          units * p.n_split * p.rows * (hd + 2)
                          if p.n_split > 1 else 1, torch.float32)
    tickets = _stream_buffer(_tickets, dev, stream, units, torch.int32)
    with torch.cuda.device(dev):
        rc = lib.paged_attention_mq_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            part.data_ptr(), tickets.data_ptr(), B, S, kvh, g, hd,
            page_size, max_pages, p.n_split, p.pages_per_split,
            p.row_chunks, p.lanes, p.vecs, p.rows, _DTYPES[q.dtype],
            math.log2(math.e) / math.sqrt(hd), stream)
    if rc != 0:
        msg = lib.paged_attention_error_string(rc).decode()
        raise RuntimeError(f"paged_attention_mq launch failed: {msg} ({rc})")
    count_launch(NAME, B, S)
    return out
