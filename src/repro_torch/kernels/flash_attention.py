"""Online-softmax attention on Hopper: the wrapper of the CUDA kernel in
``csrc/flash_attention.cu`` (which replaces the Pallas TPU kernel
``flash_attention`` of the JAX package).

Layout (BH, S, D) for q and (BH, Sk, D) for k and v, batch and heads
folded; :func:`repro_torch.kernels.ops.attention` folds the model layout
(B, S, H, D) into it and back.  Query i sees key j where ``i >= j``
(causal) and ``i - j < window`` (window > 0), on absolute positions, also
when S != Sk.  The tiles ``(bq, bk)`` are the caller's, clamped to S and
Sk and required to divide them, as the TPU kernel asserts.  This module
holds the CUDA path only: the plain version is
:func:`repro_torch.kernels.ref.flash_attention`.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import LAUNCHES, cuda_build

NAME = "flash_attention"
LAUNCHES.setdefault(NAME, 0)

HEAD_DIMS = (32, 64, 128)
MAX_TILE = 128              # bq and bk at most this (shared memory)
SUB_TILE = 32               # K/V rows the kernel stages at once
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232448        # bytes of shared memory a Hopper block may use

_lib = None


def _library() -> ctypes.CDLL:
    """The kernel's library with its C signatures declared (built and
    loaded at first use)."""
    global _lib
    if _lib is None:
        lib = cuda_build.load("flash_attention")
        lib.flash_attention_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.flash_attention_smem_bytes.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def build() -> None:
    """Compile and load the kernel now (it is otherwise built at first
    launch)."""
    _library()


def resolve_tiles(S: int, Sk: int, bq: int, bk: int):
    """The tiles clamped to S and Sk; raises when they do not divide."""
    bq, bk = min(bq, S), min(bk, Sk)
    if bq < 1 or bk < 1 or S % bq or Sk % bk:
        raise ValueError(f"tiles (bq={bq}, bk={bk}) must divide "
                         f"(S={S}, Sk={Sk})")
    return bq, bk


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, bq: int = 128,
                    bk: int = 128) -> torch.Tensor:
    """Launch the CUDA kernel: q (BH, S, D), k/v (BH, Sk, D) -> a new
    tensor shaped and typed like q.  Every tensor must be a contiguous
    CUDA tensor of one dtype on one device; anything the kernel does not
    take raises."""
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape or (
            k.shape[0], k.shape[2]) != (q.shape[0], q.shape[2]):
        raise ValueError(f"bad shapes q={tuple(q.shape)} k={tuple(k.shape)} "
                         f"v={tuple(v.shape)}")
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"flash_attention kernel needs CUDA tensors on one "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype} "
                         f"unsupported (one of float32, bfloat16)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    BH, S, D = q.shape
    Sk = k.shape[1]
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} unsupported ({HEAD_DIMS})")
    bq, bk = resolve_tiles(S, Sk, bq, bk)
    if bq > MAX_TILE or bk > MAX_TILE or (bk > SUB_TILE and bk % SUB_TILE):
        raise ValueError(f"tiles (bq={bq}, bk={bk}) unsupported: both at "
                         f"most {MAX_TILE}, and bk below {SUB_TILE} or a "
                         f"multiple of it")
    lib = _library()
    smem = lib.flash_attention_smem_bytes(D, bq, bk)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"D={D}, bq={bq}, bk={bk} need {smem} bytes of "
                         f"shared memory (> {_SMEM_LIMIT})")
    out = torch.empty_like(q)
    if BH * S == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, S,
            Sk, D, bq, bk, int(bool(causal)), int(window),
            _DTYPES[q.dtype], 1.0 / math.sqrt(D), stream)
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg} ({rc})")
    LAUNCHES[NAME] += 1
    return out
