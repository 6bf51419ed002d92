"""CUDA graphs of the serve engine's fixed-shape steps.

The JAX package compiles each serve step once per shape and set of knobs
(``jax.jit(step).lower(*args).compile()`` in its ``serve/engine.py``) and
calls the executable every step.  On PyTorch and CUDA the counterpart is a
captured CUDA graph: the step's kernels are recorded once and replayed with
one launch, so a step no longer pays the host time of every op and kernel
wrapper it runs.

:class:`StaticInputs` holds a step's per-call inputs as views of one device
buffer, fed from one host buffer (pinned on ``cuda``) by a single
non-blocking copy.  :class:`StepGraph` captures a step function over those
inputs: a warm-up run on the capture stream (which loads the kernels'
libraries and makes the wrappers' per-stream workspaces), the capture, into
a memory pool that all of an engine's graphs share (one replays at a time),
then a replay per call.

The kernels' launch tallies (:data:`repro_torch.kernels.LAUNCHES` and
``LAUNCH_SHAPES``) count on the host, where a wrapper launches: a replay
calls no wrapper, and the capture counts launches that never ran.  So a
graph takes the warm-up's and the capture's launches back out of both
tallies, keeps the capture's, and adds them at every replay.  A graph also
holds every buffer of the wrappers' ``WORKSPACES`` that existed when it was
captured, so that a later call that grows one cannot free memory the graph
reads.

A failed capture raises: nothing here falls back to running eagerly.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.kernels import LAUNCH_SHAPES, LAUNCHES, WORKSPACES

#: byte alignment of each input inside the flat buffers
ALIGN = 16

_streams: dict[int, torch.cuda.Stream] = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream every graph on ``device`` is warmed up and captured
    on: one per device, so the wrappers' per-stream workspaces are made
    once and shared by all graphs."""
    idx = (device.index if device.index is not None
           else torch.cuda.current_device())
    if idx not in _streams:
        _streams[idx] = torch.cuda.Stream(device=idx)
    return _streams[idx]


def _tallies() -> tuple[dict, dict]:
    return dict(LAUNCHES), dict(LAUNCH_SHAPES)


def _restore(saved: tuple[dict, dict]) -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = saved[0].get(name, 0)
    LAUNCH_SHAPES.clear()
    LAUNCH_SHAPES.update(saved[1])


def _delta(after: dict, before: dict) -> dict:
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}


class StaticInputs:
    """A step's fixed-shape inputs: device tensors that are views of one
    flat buffer, loaded from a host staging buffer by one copy.

    ``specs`` lists each input's (shape, dtype).  :attr:`tensors` are the
    device views a step is captured over; they keep their storage for the
    object's life."""

    def __init__(self, specs: Sequence[tuple[tuple, torch.dtype]],
                 device: torch.device):
        device = torch.device(device)
        spans, total = [], 0
        for shape, dtype in specs:
            n = math.prod(shape) * dtype.itemsize
            spans.append((total, n))
            total += -(-n // ALIGN) * ALIGN
        cuda = device.type == "cuda"
        self.host = torch.zeros(max(total, ALIGN), dtype=torch.uint8,
                                pin_memory=cuda)
        self.buffer = torch.zeros(max(total, ALIGN), dtype=torch.uint8,
                                  device=device)

        def views(buf):
            return [buf[o:o + n].view(dtype).view(shape)
                    for (o, n), (shape, dtype) in zip(spans, specs)]

        self.tensors = views(self.buffer)
        self._staging = [t.numpy() for t in views(self.host)]
        # the last copy out of the staging buffer: the host waits for it
        # before writing the buffer again
        self._copied = torch.cuda.Event() if cuda else None

    def load(self, *arrays) -> None:
        """Write ``arrays`` (one array-like per input, in order) into the
        staging buffer and queue its copy to the device buffer on the
        current stream."""
        if len(arrays) != len(self._staging):
            raise ValueError(f"{len(arrays)} inputs for "
                             f"{len(self._staging)} buffers")
        if self._copied is not None:
            self._copied.synchronize()
        for dst, src in zip(self._staging, arrays):
            dst[...] = src
        self.buffer.copy_(self.host, non_blocking=True)
        if self._copied is not None:
            self._copied.record()


class StepGraph:
    """A step function over :class:`StaticInputs`, captured as a CUDA graph
    and replayed by every call.

    ``fn(*inputs.tensors)`` returns a tensor, a tuple of tensors or None:
    its outputs from the capture are the graph's output tensors, which
    every replay rewrites (read them before the next call).  ``warmup``
    runs instead of ``fn`` before the capture where running ``fn`` would
    change live state; it must launch what ``fn`` launches.  ``pool`` is
    the memory pool handle the engine's graphs share.

    Attributes: :attr:`launches` and :attr:`launch_shapes`, the kernel
    launches of one replay; :attr:`warmup_launches`, those of the warm-up
    (taken back out of the tallies too); :attr:`pool_bytes`, the device
    memory the capture reserved in the pool; :attr:`replays`, the calls
    so far."""

    def __init__(self, fn: Callable, inputs: StaticInputs, *,
                 warmup: Optional[Callable] = None, pool: Any = None):
        self.fn = fn
        self.inputs = inputs
        self.device = inputs.buffer.device
        self.pool = pool
        self.pool_bytes = 0
        self.replays = 0
        self._graph = None
        self._keep: list = []
        before = _tallies()
        try:
            self._warmup(warmup or fn)
            warm = _tallies()
            self.outputs = self._record()
            after = _tallies()
        finally:
            _restore(before)
        self.warmup_launches = _delta(warm[0], before[0])
        self.launches = _delta(after[0], warm[0])
        self.launch_shapes = _delta(after[1], warm[1])

    def __call__(self, *arrays):
        """Load ``arrays`` into the static inputs, replay, count the
        replay's launches, and return the output tensors."""
        self.inputs.load(*arrays)
        self._replay()
        self.replays += 1
        for name, n in self.launches.items():
            LAUNCHES[name] += n
        for key, n in self.launch_shapes.items():
            LAUNCH_SHAPES[key] = LAUNCH_SHAPES.get(key, 0) + n
        return self.outputs

    # -- the CUDA graph ------------------------------------------------------
    def _warmup(self, fn: Callable) -> None:
        """Run ``fn`` once on the capture stream, ordered after the work
        already queued on the current stream and before what follows."""
        stream = capture_stream(self.device)
        current = torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            fn(*self.inputs.tensors)
        current.wait_stream(stream)

    def _record(self):
        """Capture ``fn`` on the capture stream into the shared pool."""
        dev = self.device
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool,
                              stream=capture_stream(dev)):
            outputs = self.fn(*self.inputs.tensors)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self._graph = graph
        self._keep = [t for ws in WORKSPACES for t in ws.values()]
        return outputs

    def _replay(self) -> None:
        self._graph.replay()
