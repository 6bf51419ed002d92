"""Tiled matrix product on Hopper: the wrapper of the CUDA kernel in
``csrc/tuned_matmul.cu`` (which replaces the Pallas TPU kernel
``tuned_matmul`` of the JAX package).

x (M, K) @ y (K, N) -> (M, N) in x's dtype, f32 accumulator.  The tiles
``(bm, bn, bk)`` are the caller's: they are clamped to the dims
(``min(b, dim)``) and must divide them, as the TPU kernel asserts.  The
kernel is instantiated for a fixed menu of tiles (:data:`MENU`: bm in
{32, 64, 128}, bn and bk in {64, 128}, in both dtypes); a tile outside it
raises and names the menu, never silently becoming another.  The kernel
loads its tiles by 16-byte copies (TMA in bf16, 16-byte loads in f32), so
x and y must be 16-byte aligned with rows of a multiple of 16 bytes (every
menu tile makes K and N multiples of 64, so only a view's offset can
break it); anything else raises (there is no fallback).  This module
holds the CUDA path only: the plain version is
:func:`repro_torch.kernels.ref.matmul` and the device dispatch lives in
:mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, count_launch, cuda_build

NAME = "tuned_matmul"
LAUNCHES.setdefault(NAME, 0)

#: the (bm, bn, bk) tiles ``csrc/tuned_matmul.cu`` instantiates: the
#: default tiles clamped to any dim of 64 or a multiple of 128, and the JAX
#: package's test tiles
MENU = tuple((bm, bn, bk) for bm in (32, 64, 128) for bn in (64, 128)
             for bk in (64, 128))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lib = None


def _library() -> ctypes.CDLL:
    """The kernel's library with its C signatures declared (built and
    loaded at first use)."""
    global _lib
    if _lib is None:
        lib = cuda_build.load("tuned_matmul")
        lib.tuned_matmul_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.tuned_matmul_launch.restype = ctypes.c_int
        lib.tuned_matmul_error_string.argtypes = [ctypes.c_int]
        lib.tuned_matmul_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def build() -> None:
    """Compile and load the kernel now (it is otherwise built at first
    launch)."""
    _library()


def resolve_tiles(M: int, N: int, K: int, bm: int, bn: int, bk: int):
    """The tiles clamped to the dims; raises when they do not divide."""
    bm, bn, bk = min(bm, M), min(bn, N), min(bk, K)
    if bm < 1 or bn < 1 or bk < 1 or M % bm or N % bn or K % bk:
        raise ValueError(f"tiles (bm={bm}, bn={bn}, bk={bk}) must divide "
                         f"(M={M}, N={N}, K={K})")
    return bm, bn, bk


def menu_tiles(M: int, N: int, K: int, bm: int, bn: int, bk: int):
    """The tiles the kernel runs for this call: clamped to the dims,
    dividing them, and in :data:`MENU`; raises naming the menu otherwise."""
    tiles = resolve_tiles(M, N, K, bm, bn, bk)
    if tiles not in MENU:
        raise ValueError(f"tile {tiles} is not instantiated; the kernel "
                         f"takes (bm, bn, bk) in {MENU}")
    return tiles


def check_shapes(x: torch.Tensor, y: torch.Tensor):
    """(M, N, K) of ``x @ y``; raises on anything but two matrices with a
    shared inner dim."""
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"matmul needs (M, K) @ (K, N), got "
                         f"{tuple(x.shape)} @ {tuple(y.shape)}")
    return x.shape[0], y.shape[1], x.shape[1]


def check_aligned_operands(x: torch.Tensor, y: torch.Tensor) -> None:
    """Raise unless the kernel's 16-byte copies can read x and y: 16-byte
    aligned data and rows (K and N elements) of a multiple of 16 bytes."""
    for name, t in (("x", x), ("y", y)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the "
                             f"kernel's 16-byte copies")
        if t.shape[1] * t.element_size() % 16:
            raise ValueError(f"{name}'s rows ({t.shape[1]} elements) must "
                             f"be a multiple of 16 bytes for the kernel's "
                             f"16-byte copies")


def tuned_matmul(x: torch.Tensor, y: torch.Tensor, *, bm: int = 128,
                 bn: int = 128, bk: int = 128) -> torch.Tensor:
    """Launch the CUDA kernel: x (M, K) @ y (K, N) -> a new (M, N) tensor
    in x's dtype.  Both must be contiguous CUDA tensors of one dtype on one
    device; anything the kernel does not take raises."""
    M, N, K = check_shapes(x, y)
    if x.device.type != "cuda" or y.device != x.device:
        raise ValueError(f"tuned_matmul kernel needs CUDA tensors on one "
                         f"device, got {x.device} and {y.device}")
    if x.dtype not in _DTYPES or y.dtype != x.dtype:
        raise ValueError(f"dtypes {x.dtype}, {y.dtype} unsupported (both "
                         f"float32 or both bfloat16)")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("x and y must be contiguous")
    tiles = menu_tiles(M, N, K, bm, bn, bk)
    check_aligned_operands(x, y)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M * N == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.tuned_matmul_launch(x.data_ptr(), y.data_ptr(),
                                     out.data_ptr(), M, N, K, *tiles,
                                     _DTYPES[x.dtype], stream)
    if rc != 0:
        msg = lib.tuned_matmul_error_string(rc).decode()
        raise RuntimeError(f"tuned_matmul launch failed: {msg} ({rc})")
    count_launch(NAME, M, N, K)
    return out
