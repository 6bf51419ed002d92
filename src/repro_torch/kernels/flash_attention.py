"""Online-softmax attention on Hopper: the wrapper of the CUDA kernel in
``csrc/flash_attention.cu`` (which replaces the Pallas TPU kernel
``flash_attention`` of the JAX package).

Two layouts, both read and written in place through their strides:
:func:`flash_attention` takes the JAX kernel's (BH, S, D) for q and
(BH, Sk, D) for k and v, batch and heads folded; :func:`flash_attention_bshd`
takes the model layout (B, S, H, D), as
:func:`repro_torch.kernels.ops.attention` hands it over, without a copy.
Query i sees key j where ``i >= j`` (causal) and ``i - j < window``
(window > 0), on absolute positions, also when S != Sk.  The tiles
``(bq, bk)`` are the caller's, clamped to S and Sk and required to divide
them, as the TPU kernel asserts; the kernel takes each of them in
:data:`TILES`.  K and V rows arrive by 16-byte copies, so k and v (and
bf16 q) must be 16-byte aligned with strides of a multiple of 16 bytes
(:func:`check_aligned`); anything else raises.  f32 runs on the tensor
cores as a 3xTF32 split.  This module holds the CUDA path only: the plain
version is :func:`repro_torch.kernels.ref.flash_attention`.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import LAUNCHES, count_launch, cuda_build

NAME = "flash_attention"
LAUNCHES.setdefault(NAME, 0)

HEAD_DIMS = (32, 64, 128)
TILES = (32, 64, 128)       # bq and bk the kernel takes, after clamping
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lib = None


def _library() -> ctypes.CDLL:
    """The kernel's library with its C signatures declared (built and
    loaded at first use)."""
    global _lib
    if _lib is None:
        lib = cuda_build.load("flash_attention")
        lib.flash_attention_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
            + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
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


def kernel_strides(strides, layout: str):
    """The (batch, head, row) strides in elements that the kernel takes,
    from a tensor's ``stride()``: ``"bhsd"`` is the folded (BH, S, D)
    layout (one head per batch entry, so the head stride is 0), ``"bshd"``
    the model layout (B, S, H, D).  Raises unless the last dim is
    contiguous."""
    if strides[-1] != 1:
        raise ValueError(f"the head dim must be contiguous, strides "
                         f"{tuple(strides)}")
    if layout == "bhsd":
        return strides[0], 0, strides[1]
    if layout == "bshd":
        return strides[0], strides[2], strides[1]
    raise ValueError(f"unknown layout {layout!r}")


def _check(q, k, v, bq: int, bk: int):
    """Device, dtype and tile checks shared by both layouts; returns the
    clamped tiles."""
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"flash_attention kernel needs CUDA tensors on one "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype} "
                         f"unsupported (one of float32, bfloat16)")
    D = q.shape[-1]
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} unsupported ({HEAD_DIMS})")
    bq, bk = resolve_tiles(q.shape[1], k.shape[1], bq, bk)
    if bq not in TILES or bk not in TILES:
        raise ValueError(f"tiles (bq={bq}, bk={bk}) unsupported: the kernel "
                         f"takes bq and bk in {TILES}")
    return bq, bk


def check_aligned(q, k, v, strides) -> None:
    """Raise unless the kernel's 16-byte copies can read K and V rows
    (both dtypes) and, in bf16, Q's 4-byte words: 16-byte aligned data and
    (batch, head, row) strides (``strides``, 12 as the kernel takes them)
    of a multiple of 16 bytes.  f32 Q is read one element at a time."""
    named = [("k", k, strides[3:6]), ("v", v, strides[6:9])]
    if q.dtype == torch.bfloat16:
        named.insert(0, ("q", q, strides[0:3]))
    for name, t, st in named:
        if t.data_ptr() % 16 or any(s * t.element_size() % 16 for s in st):
            raise ValueError(f"{str(t.dtype)[6:]} {name} must be 16-byte "
                             f"aligned with strides of a multiple of 16 "
                             f"bytes, got {tuple(t.stride())}")


def _launch(q, k, v, out, B, H, layout, causal, window, bq, bk):
    """Launch on q's current stream, reading and writing every tensor
    through its strides; counts the launch."""
    strides = [s for t in (q, k, v, out)
               for s in kernel_strides(t.stride(), layout)]
    check_aligned(q, k, v, strides)
    S, Sk, D = q.shape[1], k.shape[1], q.shape[-1]
    if B * H * S == 0:
        return out
    lib = _library()
    dev = q.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
            S, Sk, D, bq, bk, int(bool(causal)), int(window),
            _DTYPES[q.dtype], 1.0 / math.sqrt(D),
            ctypes.cast((ctypes.c_longlong * 12)(*strides), ctypes.c_void_p),
            stream)
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg} ({rc})")
    count_launch(NAME, B, H, S, Sk, D)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, bq: int = 128,
                    bk: int = 128) -> torch.Tensor:
    """Launch the CUDA kernel: q (BH, S, D), k/v (BH, Sk, D) -> a new
    contiguous tensor shaped and typed like q.  Every tensor must be a CUDA
    tensor of one dtype on one device with a contiguous last dim; anything
    the kernel does not take raises."""
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape or (
            k.shape[0], k.shape[2]) != (q.shape[0], q.shape[2]):
        raise ValueError(f"bad shapes q={tuple(q.shape)} k={tuple(k.shape)} "
                         f"v={tuple(v.shape)}")
    bq, bk = _check(q, k, v, bq, bk)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    return _launch(q, k, v, out, q.shape[0], 1, "bhsd", causal, window, bq,
                   bk)


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         bq: int = 128, bk: int = 128) -> torch.Tensor:
    """Launch the CUDA kernel on the model layout: q (B, S, H, D), k/v
    (B, Sk, H, D), read in place through their strides (views included) ->
    a new contiguous (B, S, H, D) tensor typed like q.  One launch, no
    copy of q, k or v."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape or (
            k.shape[0], k.shape[2], k.shape[3]) != (
            q.shape[0], q.shape[2], q.shape[3]):
        raise ValueError(f"bad shapes q={tuple(q.shape)} k={tuple(k.shape)} "
                         f"v={tuple(v.shape)}")
    bq, bk = _check(q, k, v, bq, bk)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    return _launch(q, k, v, out, q.shape[0], q.shape[2], "bshd", causal,
                   window, bq, bk)
