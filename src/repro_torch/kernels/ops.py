"""The wrappers the model calls, dispatching on the device of the tensors
they are given: CPU tensors go to the plain version in :mod:`.ref`, CUDA
tensors to the hand-written kernel — which launches or raises.  There is no
fallback from one to the other.  Meta tensors (the shape-only device the
counters run a step on, :mod:`repro_torch.core.counters`) get an empty
output of the right shape and dtype, and the call's work from
:mod:`.work` is noted into the counting region as one op.  Kernel knobs
from ``RegionConfig`` (block sizes, the scan mode and chunk length)
surface here as keyword arguments.

The scans (:func:`wkv`, :func:`ssd`) are differentiable: under grad they
run through an autograd Function that mirrors the JAX package's
``chunked_scan``, whose ``jax.checkpoint`` keeps only the states at
segment boundaries for the backward (:class:`_ScanGrad`).  The other
kernels refuse to be differentiated (:func:`_no_grad_path`)."""
from __future__ import annotations

import torch

from repro_torch.core import counters
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import linear_scan as _scan
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import ref, work
from repro_torch.kernels import tuned_matmul as _mm


def _meta(shapes, dtype, work_done):
    """The meta path of a wrapper: note ``work_done`` (bytes, ops) and
    return empty meta tensors of ``shapes``."""
    counters.note_work(*work_done)
    outs = tuple(torch.empty(s, dtype=dtype, device="meta") for s in shapes)
    return outs if len(outs) > 1 else outs[0]


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def _no_grad_path(name, *tensors) -> None:
    """Raise when ``name`` would be differentiated: the paged attention,
    matmul and attention kernels have no backward, and a CUDA kernel's
    output carries no ``grad_fn``, so the gradients of everything upstream
    would be dropped on the card while the plain version gave them on the
    CPU.  The rule is the same on every device; training takes the
    models' einsum paths for these (and ``torch.no_grad()`` serving is
    unaffected).  The scans have a gradient (:class:`_ScanGrad`)."""
    if _wants_grad(*tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward, and an input requires "
            f"grad; call it under torch.no_grad() or on detached inputs")


def _no_version(name, dev):
    return ValueError(f"{name}: no version for device {dev}")


def paged_attention_mq(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, block_tables: torch.Tensor,
                       lengths: torch.Tensor, *,
                       block_k: int = 0) -> torch.Tensor:
    """Multi-query paged decode attention (speculative verify), kernel
    layout q: (B, S, KVH, G, HD); query s sees lengths + s positions.
    Returns q's shape and dtype."""
    _no_grad_path("paged_attention_mq", q, k_pages, v_pages)
    if q.device.type == "cuda":
        return _paged.paged_attention_mq(q, k_pages, v_pages, block_tables,
                                         lengths, block_k=block_k)
    _paged.resolve_block_k(block_k, k_pages.shape[1])
    if q.device.type == "cpu":
        return ref.paged_attention_mq(q, k_pages, v_pages, block_tables,
                                      lengths).to(q.dtype)
    if q.device.type == "meta":
        B, S, KVH, G, HD = q.shape
        return _meta([q.shape], q.dtype, work.paged_attention(
            B, S, KVH, G, HD, q.element_size(), block_tables.shape[1],
            k_pages.shape[1]))
    raise _no_version("paged_attention_mq", q.device)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor, *,
                    block_k: int = 0) -> torch.Tensor:
    """Paged decode attention, one query per slot: q (B, KVH, G, HD) — the
    S=1 case of :func:`paged_attention_mq`."""
    _no_grad_path("paged_attention", q, k_pages, v_pages)
    return paged_attention_mq(q[:, None].contiguous(), k_pages, v_pages,
                              block_tables, lengths, block_k=block_k)[:, 0]


SCAN_MODES = ("fused_recurrent", "chunk")


def _scan_f32(t):
    """``t`` as a contiguous, 16-byte aligned f32 tensor (the scan kernels'
    layout): a view that is already so is passed as it is."""
    t = t.float().contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _scan_mode(mode: str) -> bool:
    """Whether ``mode`` is the chunked scan; raises on an unknown mode."""
    if mode not in SCAN_MODES:
        raise ValueError(f"scan mode {mode!r} unknown ({SCAN_MODES})")
    return mode == "chunk"


#: the segment of a scan's gradient when none is given: the JAX
#: package's ``scan_utils.DEFAULT_CHUNK``
DEFAULT_SEGMENT = 128


def segments(T: int, segment: int = 0) -> list:
    """(start, length) of each segment of a T-step scan under grad:
    ``segment`` steps each (``DEFAULT_SEGMENT`` for 0), or the whole T in
    one when ``T <= segment`` or ``segment`` does not divide T — the JAX
    package's ``chunked_scan`` rule."""
    seg = segment or DEFAULT_SEGMENT
    if seg <= 0 or T <= seg or T % seg:
        return [(0, T)]
    return [(lo, seg) for lo in range(0, T, seg)]


def _wkv_call(r, k, v, w, u, s0, chunked, chunk):
    """One WKV call on the device of ``r``: the CUDA kernel, the plain
    version on the CPU, an empty output on meta."""
    if r.device.type == "cuda":
        tr = lambda t: _scan_f32(t.transpose(1, 2))  # noqa: E731
        out, s = _scan.wkv(tr(r), tr(k), tr(v), tr(w), _scan_f32(u),
                           _scan_f32(s0), chunk=chunk if chunked else 0)
        return out.transpose(1, 2), s
    if r.device.type == "cpu":
        if chunked:
            return ref.wkv_chunk(r, k, v, w, u, s0, chunk)
        return ref.wkv_linear_scan(r, k, v, w, u, s0)
    if r.device.type == "meta":
        B, T, H, N = r.shape
        return _meta([r.shape, s0.shape], torch.float32, work.wkv(B, H, T, N))
    raise _no_version("wkv", r.device)


def _ssd_call(x, b, c, dt, a, s0, chunked, chunk):
    """One SSD call on the device of ``x``, as :func:`_wkv_call`."""
    if x.device.type == "cuda":
        f32 = _scan_f32
        y, s = _scan.ssd(f32(x.transpose(1, 2)), f32(b), f32(c),
                         f32(dt.transpose(1, 2)), f32(a), f32(s0),
                         chunk=chunk if chunked else 0)
        return y.transpose(1, 2), s
    if x.device.type == "cpu":
        if chunked:
            return ref.ssd_chunk(x, b, c, dt, a, s0, chunk)
        return ref.ssd_linear_scan(x, b, c, dt, a, s0)
    if x.device.type == "meta":
        B, T, H, P = x.shape
        return _meta([x.shape, s0.shape], torch.float32,
                     work.ssd(B, H, T, P, b.shape[-1]))
    raise _no_version("ssd", x.device)


#: per scan: (the call on any device, the plain forms (sequential,
#: chunked)); the inputs are four (B, T, ...) streams, one per-head
#: parameter and the entry state
_SCANS = {"wkv": (_wkv_call, (ref.wkv_linear_scan, ref.wkv_chunk)),
          "ssd": (_ssd_call, (ref.ssd_linear_scan, ref.ssd_chunk))}


class _ScanGrad(torch.autograd.Function):
    """A scan with a gradient, as the JAX package's ``chunked_scan``
    under ``jax.checkpoint``.  The forward runs the scan's call (the CUDA
    kernel on the card) one segment at a time, each from the last one's
    final state, and keeps only the inputs and the states at segment
    boundaries.  The backward goes through the segments last first: it
    recomputes each with the plain differentiable form of the same mode
    (:mod:`.ref`) and backpropagates into the segment's inputs and its
    entry state, whose gradient the segment before receives.  It is plain
    PyTorch, as the JAX package's backward is XLA's autodiff of its
    ``lax.scan``: there is no backward kernel."""

    @staticmethod
    def forward(ctx, name, chunked, chunk, segment, s1, s2, s3, s4, p, s0):
        call, _ = _SCANS[name]
        bounds = segments(s1.shape[1], segment)
        outs, entry, s = [], [], s0
        for lo, n in bounds:
            entry.append(s)
            o, s = call(*(t[:, lo:lo + n] for t in (s1, s2, s3, s4)), p, s,
                        chunked, chunk)
            outs.append(o)
        ctx.scan = (name, chunked, chunk, bounds)
        ctx.save_for_backward(s1, s2, s3, s4, p, *entry)
        ctx.set_materialize_grads(False)     # an unused output's grad: None
        return (outs[0] if len(outs) == 1 else torch.cat(outs, 1)), s

    @staticmethod
    def backward(ctx, g_out, g_s):
        name, chunked, chunk, bounds = ctx.scan
        s1, s2, s3, s4, p, *entry = ctx.saved_tensors
        plain = _SCANS[name][1][chunked]

        def segment_grad(lo, n, s_in, g_s, src=(s1, s2, s3, s4, g_out)):
            *streams, g_o = src
            with torch.enable_grad():
                xs = [t[:, lo:lo + n].detach().requires_grad_()
                      for t in streams]
                pd = p.detach().requires_grad_()
                sd = s_in.detach().requires_grad_()
                o, s = plain(*xs, pd, sd, chunk) if chunked else \
                    plain(*xs, pd, sd)
                outs, gs = [], []
                for t, g in ((o, g_o), (s, g_s)):
                    if g is not None:
                        outs.append(t)
                        gs.append(g if t is s else g[:, lo:lo + n])
                return torch.autograd.grad(
                    outs, xs + [pd, sd], gs, allow_unused=True,
                    materialize_grads=True)

        if s1.device.type == "meta":
            # counted, not run: every segment's recompute and gradient,
            # the plain forms' loops, step by step or from a few steps of
            # it (chunks in 'chunk' mode; counters.count_steps); a segment
            # of the whole sequence samples from streams of the sample's
            # length, whose whole-length slices are aliases as the
            # segment's are, and whose bytes stand in for streams that
            # exist (the sample returns them, for its peak to leave out)
            unit = chunk if chunked else 1
            T = s1.shape[1]

            def sample(k, lo, n, s_in, g_s):
                src = (s1, s2, s3, s4, g_out)
                if n == T and k * unit != n:
                    src = tuple(None if t is None else t.new_empty(
                        (t.shape[0], k * unit) + t.shape[2:]) for t in src)
                    segment_grad(lo, k * unit, s_in, g_s, src)
                    return sum(t.numel() * t.element_size() for t in src
                               if t is not None)
                segment_grad(lo, k * unit, s_in, g_s, src)
                return 0

            # the last segment alone (the final state's gradient may be
            # None), then every other one at once: they differ only in
            # where they start
            rev = list(zip(reversed(bounds), reversed(entry)))
            for ((lo, n), s_in), times in zip(rev[:2], (1, len(rev) - 1)):
                if n % unit:
                    for _ in range(times):
                        segment_grad(lo, n, s_in, g_s)
                else:
                    key = (name, chunked, chunk, n, n == T, g_s is None,
                           g_out is None, s1.shape, s2.shape, p.shape,
                           s_in.shape, s1.dtype)
                    counters.count_steps(
                        lambda k, a=(lo, n, s_in, g_s): sample(k, *a),
                        n // unit, times=times, key=key)
                g_s = torch.empty_like(s_in)
            g_s = torch.empty_like(entry[0])
            return (None, None, None, None,
                    *(torch.empty_like(t) for t in (s1, s2, s3, s4)),
                    torch.empty_like(p), g_s)
        g_streams, g_p = [], torch.zeros_like(p)
        for (lo, n), s_in in zip(reversed(bounds), reversed(entry)):
            *g_x, g_pi, g_s = segment_grad(lo, n, s_in, g_s)
            g_streams.append(g_x)
            g_p = g_p + g_pi
        g_streams.reverse()
        g_streams = [g[0] if len(g) == 1 else torch.cat(g, 1)
                     for g in zip(*g_streams)]
        return (None, None, None, None, *g_streams, g_p, g_s)


def wkv(r, k, v, w, u, s0, *, mode: str = "fused_recurrent",
        chunk: int = 64, segment: int = 0):
    """RWKV6 WKV in the model layout: r, k, v, w (B, T, H, N); u (H, N);
    s0 (B, H, N, N) -> out (B, T, H, N), final state, both f32.

    ``mode``: 'fused_recurrent' runs the sequential recurrence; 'chunk'
    the matmul-form chunked scan with ``chunk``-step chunks (as given: the
    model's chunk length reaches the kernel unclamped).  On CUDA the
    streams move to the kernel layout (B, H, T, N) in f32 and back.

    Without grad it is one call on the whole T.  Under grad (an input
    requires it) the call runs once a ``segment`` (:func:`segments`), and
    the gradient recomputes each segment with the plain form of ``mode``
    (:class:`_ScanGrad`); ``segment`` must then be a multiple of
    ``chunk`` in 'chunk' mode, so that segments split no chunk."""
    chunked = _scan_mode(mode)
    if _wants_grad(r, k, v, w, u, s0):
        return _ScanGrad.apply("wkv", chunked, chunk, segment,
                               r, k, v, w, u, s0)
    return _wkv_call(r, k, v, w, u, s0, chunked, chunk)


def ssd(x, b, c, dt, a, s0, *, mode: str = "fused_recurrent",
        chunk: int = 64, segment: int = 0):
    """Mamba2 SSD in the model layout: x (B, T, H, P); b, c (B, T, N);
    dt (B, T, H); a (H,); s0 (B, H, P, N) -> y (B, T, H, P), final state,
    both f32.  ``mode``, ``chunk`` and ``segment`` as in :func:`wkv`."""
    chunked = _scan_mode(mode)
    if _wants_grad(x, b, c, dt, a, s0):
        return _ScanGrad.apply("ssd", chunked, chunk, segment,
                               x, b, c, dt, a, s0)
    return _ssd_call(x, b, c, dt, a, s0, chunked, chunk)


def matmul(x, y, *, bm: int = 128, bn: int = 128, bk: int = 128):
    """x (M, K) @ y (K, N) -> (M, N) in x's dtype, in ``(bm, bn, bk)``
    tiles (clamped to the dims; they must divide them) with an f32
    accumulator."""
    _no_grad_path("matmul", x, y)
    M, N, K = _mm.check_shapes(x, y)
    if x.device.type == "cuda":
        return _mm.tuned_matmul(x, y, bm=bm, bn=bn, bk=bk)
    _mm.resolve_tiles(M, N, K, bm, bn, bk)
    if x.device.type == "cpu":
        return ref.matmul(x, y).to(x.dtype)
    if x.device.type == "meta":
        return _meta([(M, N)], x.dtype,
                     work.matmul(M, N, K, x.element_size()))
    raise _no_version("matmul", x.device)


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              block_q: int = 128, block_k: int = 128):
    """q: (B, S, H, D), k/v: (B, Sk, H, D) model layout -> (B, S, H, D)
    in q's dtype.  On CUDA the kernel reads the model layout in place
    through its strides and writes a (B, S, H, D) tensor: one launch and
    no copy (the JAX package's ``ops.attention`` folds the heads into
    (B*H, S, D) and back instead; the result is the same)."""
    _no_grad_path("attention", q, k, v)
    B, S, H, D = q.shape
    Sk = k.shape[1]
    if q.device.type == "cuda":
        return _flash.flash_attention_bshd(q, k, v, causal=causal,
                                           window=window, bq=block_q,
                                           bk=block_k)
    _flash.resolve_tiles(S, Sk, block_q, block_k)
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal,
                                   window=window).to(q.dtype)
    if q.device.type == "meta":
        return _meta([q.shape], q.dtype, work.attention(
            B * H, S, Sk, D, q.element_size(), causal, window))
    raise _no_version("attention", q.device)
