"""Linear-attention scans on Hopper: the wrappers of the CUDA kernels in
``csrc/linear_scan.cu``, which replace the four Pallas TPU kernels of the
JAX package's ``kernels/linear_scan.py``.

Two modes of each recurrence:

* ``wkv_fused`` / ``ssd_fused`` — the sequential recurrence, one thread
  block per (batch row, head) holding the state in registers for the whole
  sequence (decode, speculative verify, ragged prefill);
* ``wkv_chunk`` / ``ssd_chunk`` — the same recurrence reassociated into
  matmul form per ``chunk`` steps, the state in shared memory and carried
  from chunk to chunk (aligned prefill, chunk-mode verify).

Kernel layout, all float32 and contiguous: WKV r, k, v, w ``(B, H, T, N)``,
u ``(H, N)``, state ``(B, H, N, N)``; SSD x ``(B, H, T, P)``, b, c
``(B, T, N)``, dt ``(B, H, T)``, a ``(H,)``, state ``(B, H, P, N)``.  Each
returns (output, final state) as new tensors.  Any T is taken; a chunk that
does not divide T leaves a shorter last chunk.  This module holds the CUDA
path only: the plain versions are in :mod:`repro_torch.kernels.ref` and the
device dispatch (with the model-layout moves) in
:mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, cuda_build

NAMES = ("wkv_fused", "wkv_chunk", "ssd_fused", "ssd_chunk")
for _name in NAMES:
    LAUNCHES.setdefault(_name, 0)

#: state widths (N, and P for SSD) the kernels are instantiated for
DIMS = (16, 64)

_lib = None


def _library() -> ctypes.CDLL:
    """The kernels' library with its C signatures declared (built and
    loaded at first use)."""
    global _lib
    if _lib is None:
        lib = cuda_build.load("linear_scan")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        sigs = {
            "wkv_fused_launch": [ptr] * 8 + [i32] * 4 + [ptr],
            "wkv_chunk_launch": [ptr] * 9 + [i32] * 5 + [ptr],
            "ssd_fused_launch": [ptr] * 8 + [i32] * 5 + [ptr],
            "ssd_chunk_launch": [ptr] * 9 + [i32] * 6 + [ptr],
        }
        for fn, args in sigs.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        lib.linear_scan_error_string.argtypes = [i32]
        lib.linear_scan_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def build() -> None:
    """Compile and load the kernels now (they are otherwise built at first
    launch)."""
    _library()


def _check(tensors: dict, shapes: dict) -> torch.device:
    """Every tensor a contiguous f32 CUDA tensor on one device, of the
    shape given; raises on anything the kernels do not take."""
    dev = None
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"linear_scan kernel needs CUDA tensors, got "
                             f"{name} on {t.device}")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name} is on {t.device}, not {dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shapes[name]}")
    return dev


def _launch(name: str, fn: str, dev: torch.device, *args) -> None:
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        msg = lib.linear_scan_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({rc})")
    LAUNCHES[name] += 1


def _check_dim(what: str, n: int) -> None:
    if n not in DIMS:
        raise ValueError(f"{what}={n} unsupported (the kernels take {DIMS})")


def _check_chunk(chunk: int) -> None:
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")


def wkv(r, k, v, w, u, s0, *, chunk: int = 0):
    """RWKV6 WKV on the card: the fused recurrence when ``chunk`` is 0,
    else the chunked scan with ``chunk``-step chunks.  Returns
    (out (B, H, T, N), final state (B, H, N, N))."""
    B, H, T, N = r.shape
    seq = (B, H, T, N)
    dev = _check(dict(r=r, k=k, v=v, w=w, u=u, s0=s0),
                 dict(r=seq, k=seq, v=seq, w=seq, u=(H, N), s0=(B, H, N, N)))
    _check_dim("N", N)
    out = torch.empty_like(r)
    s_out = torch.empty_like(s0)
    if B * H == 0:
        return out, s_out
    ptrs = [t.data_ptr() for t in (r, k, v, w, u, s0, out, s_out)]
    if chunk:
        _check_chunk(chunk)
        scratch = torch.empty_like(r)   # per-chunk log-decay cumsums
        _launch("wkv_chunk", "wkv_chunk_launch", dev, *ptrs,
                scratch.data_ptr(), B, H, T, N, chunk)
    else:
        _launch("wkv_fused", "wkv_fused_launch", dev, *ptrs, B, H, T, N)
    return out, s_out


def ssd(x, b, c, dt, a, s0, *, chunk: int = 0):
    """Mamba2 SSD on the card: the fused recurrence when ``chunk`` is 0,
    else the chunked scan (f32 streams, inclusive diagonal).  Returns
    (y (B, H, T, P), final state (B, H, P, N))."""
    B, H, T, P = x.shape
    N = b.shape[-1]
    dev = _check(dict(x=x, b=b, c=c, dt=dt, a=a, s0=s0),
                 dict(x=(B, H, T, P), b=(B, T, N), c=(B, T, N),
                      dt=(B, H, T), a=(H,), s0=(B, H, P, N)))
    _check_dim("P", P)
    _check_dim("N", N)
    y = torch.empty_like(x)
    s_out = torch.empty_like(s0)
    if B * H == 0:
        return y, s_out
    ptrs = [t.data_ptr() for t in (x, b, c, dt, a, s0, y, s_out)]
    if chunk:
        _check_chunk(chunk)
        scratch = torch.empty_like(dt)  # per-chunk log-decay cumsums
        _launch("ssd_chunk", "ssd_chunk_launch", dev, *ptrs,
                scratch.data_ptr(), B, H, T, P, N, chunk)
    else:
        _launch("ssd_fused", "ssd_fused_launch", dev, *ptrs, B, H, T, P, N)
    return y, s_out
