"""Linear-attention scans on Hopper: the wrappers of the CUDA kernels in
``csrc/linear_scan.cu``, which replace the four Pallas TPU kernels of the
JAX package's ``kernels/linear_scan.py``.

Two modes of each recurrence:

* ``wkv_fused`` / ``ssd_fused`` — the sequential recurrence, each (batch
  row, head) state split over blocks along its independent axis (SSD's
  rows, WKV's value columns; tiles of 16 rows or 8 columns at batch 1,
  wider where the batch alone fills the card), each block holding its
  slice in registers for the whole sequence and the step inputs staged
  ahead in shared memory (decode, speculative verify, ragged prefill);
* ``wkv_chunk`` / ``ssd_chunk`` — the same recurrence reassociated into
  matmul form per ``chunk`` steps, as a chunk-parallel scan: a kernel for
  every chunk's state contribution, a state pass that carries the state
  from chunk to chunk, and a kernel for the outputs of every chunk and
  64-step query tile (aligned prefill, chunk-mode verify).  A call that
  fits one chunk skips the state pass, and one that fits one tile is one
  kernel (:func:`kernels_per_call`).

Kernel layout, all float32, contiguous and 16-byte aligned (the kernels
move rows as 16-byte copies): WKV r, k, v, w ``(B, H, T, N)``,
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

from repro_torch.kernels import LAUNCHES, count_launch, cuda_build

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
            "wkv_chunk_launch": [ptr] * 10 + [i32] * 5 + [ptr],
            "ssd_fused_launch": [ptr] * 8 + [i32] * 5 + [ptr],
            "ssd_chunk_launch": [ptr] * 10 + [i32] * 6 + [ptr],
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
    """Every tensor a contiguous, 16-byte aligned f32 CUDA tensor on one
    device, of the shape given; raises on anything the kernels do not
    take."""
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
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shapes[name]}")
    return dev


def _launch(name: str, fn: str, dev: torch.device, shape: tuple,
            *args) -> None:
    """Launch ``fn`` on the current stream and count it at ``shape``, the
    call's (B, T, chunk)."""
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        msg = lib.linear_scan_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({rc})")
    count_launch(name, *shape)


def _check_dim(what: str, n: int) -> None:
    if n not in DIMS:
        raise ValueError(f"{what}={n} unsupported (the kernels take {DIMS})")


def _check_chunk(chunk: int) -> None:
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")


#: time steps of the chunk kernels' tiles
TILE = 64


def kernels_per_call(T: int, chunk: int) -> int:
    """CUDA kernels one call launches: 1 for the fused recurrence (chunk
    0).  The chunked scan: 3 when the call is more than one chunk (chunk
    states, the state pass, outputs), 2 when it is one chunk of more than
    one 64-step tile, and 1 when it is one tile (the output kernel then
    writes the final state too)."""
    if chunk == 0:
        return 1
    if -(-T // chunk) > 1:
        return 3
    return 2 if T > TILE else 1


def _chunk_workspace(dev: torch.device, B: int, H: int, T: int,
                     chunk: int, state: int, decay: int):
    """The chunked scan's f32 workspace, (B, H, chunks, state) for each
    chunk's state contribution (overwritten by its entry state) and
    (B, H, chunks, decay) for its decay; none for a single chunk.  The
    kernel allocates nothing: the tensors come from the caching allocator
    and may be dropped once the call is enqueued (stream order)."""
    nc = -(-T // chunk)
    if nc <= 1:
        return None, None
    ws = torch.empty((B, H, nc, state), dtype=torch.float32, device=dev)
    dec = torch.empty((B, H, nc, decay), dtype=torch.float32, device=dev)
    return ws, dec


def _ptr(t) -> int | None:
    """A tensor's data pointer, or NULL for none."""
    return None if t is None else t.data_ptr()


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
        if T == 0:
            s_out.copy_(s0)
            return out, s_out
        ws, dec = _chunk_workspace(dev, B, H, T, chunk, N * N, N)
        _launch("wkv_chunk", "wkv_chunk_launch", dev, (B, T, chunk), *ptrs,
                _ptr(ws), _ptr(dec), B, H, T, N, chunk)
    else:
        _launch("wkv_fused", "wkv_fused_launch", dev, (B, T, 0), *ptrs,
                B, H, T, N)
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
        if T == 0:
            s_out.copy_(s0)
            return y, s_out
        ws, dec = _chunk_workspace(dev, B, H, T, chunk, P * N, 1)
        _launch("ssd_chunk", "ssd_chunk_launch", dev, (B, T, chunk), *ptrs,
                _ptr(ws), _ptr(dec), B, H, T, P, N, chunk)
    else:
        _launch("ssd_fused", "ssd_fused_launch", dev, (B, T, 0), *ptrs,
                B, H, T, P, N)
    return y, s_out
