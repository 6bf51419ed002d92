"""Per-region performance counters (the libhpm/pmapi analog), on PyTorch.

The JAX package parses the compiled step's post-SPMD HLO; nothing in
PyTorch corresponds to it.  Here :func:`collect` runs the step itself on
the **meta device** — every tensor argument moved there with
``.to("meta")`` — under a ``TorchDispatchMode`` that sees each aten op as
it is dispatched and attributes it to the region path the op runs under
(:func:`repro_torch.core.regions.current_region`).  Like the JAX package's
count from the compiled artifact, it runs nothing: no kernel launches, no
pool page is written, and the numbers are the same on the CPU and on the
card.

  * flops — 2·M·N·K for ``mm``, ``bmm``, ``addmm``, ``baddbmm`` (and the
    products ``einsum``/``matmul``/``linear`` decompose into), batch
    included; one per output element for every other op.  The HLO count
    takes a ``broadcast`` and a ``slice`` as one flop an element, so the
    views ``expand``, ``slice`` and ``select`` count so here (moving no
    bytes), and so does the broadcast of each smaller tensor operand of a
    pointwise op (:data:`_MOVES`, :func:`_broadcasts`).  Other view and
    metadata ops are free, ``_unsafe_view`` among them (a reshape whose
    schema lacks the alias mark), as ``parameter``/``bitcast``/``tuple``
    are in the HLO count.  A random draw counts :data:`RANDOM_FLOPS` an element:
    the HLO count of the JAX package's threefry and sampler.
  * bytes — operand bytes plus output bytes per op.  In-place slice
    writes (``index_put_``, ``copy_``, ``scatter``, ``index_copy``) count
    twice the update, not the buffer; gathers of a slice (``index``,
    ``index_select``, ``gather``, ``embedding``) twice the output, and
    one flop an element of it — the dynamic-update-slice and
    dynamic-slice rules of the HLO count.
  * ops — one per counted op.
  * collectives — each collective of :mod:`repro_torch.distributed.comm`
    notes itself (:func:`note_collective`) with the JAX package's
    ring-cost rules (:func:`collective_cost`): its bytes in and out, the
    shard bytes, and the bytes through the busiest link of a ring of n
    ranks; the census counts it by kind, and :attr:`RegionCounters.
    collectives` keeps each one (kind, bytes, shape, region, group size).
  * live bytes — the arguments, plus every output of a non-view op from
    its creation until the last tensor that shares its storage is freed
    (a tensor autograd saves for the backward stays live): their peak is
    :attr:`RegionCounters.peak_bytes`, the meta-device counterpart of
    XLA's argument plus temp sizes.
  * The hand-written kernels are ``ctypes`` calls on ``data_ptr()``s,
    invisible to a dispatch mode.  Their wrappers, handed meta tensors,
    return an empty output and note their work from
    :mod:`repro_torch.kernels.work` here as one op (:func:`note_work`),
    counted from shapes only.

Every number is per device.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Any, Callable, Dict, Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import regions
from repro_torch.core.regions import current_region


@dataclasses.dataclass
class Counters:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0   # sum of shard bytes through collectives
    link_bytes: float = 0.0         # ring-cost bytes through the busiest link
    collective_ops: int = 0
    ops: int = 0
    prefix_hit_rate: float = 0.0    # serve-side channel (not from HLO):
                                    # prefix-cache hits/lookups observed over
                                    # the tap window, so the decider can see
                                    # why mem_prefix_* classes earn reward
    fault_rate: float = 0.0         # serve-side channel (not from HLO):
                                    # HealthMonitor faulted-step fraction
                                    # over the tap window, so the decider
                                    # can learn degradation responses from
                                    # the corpus like any other knob
    step_latency_p99: float = 0.0   # serve-side channel (not from HLO):
                                    # windowed p99 decode-step latency,
                                    # quantized to coarse log10(1+ms)
                                    # steps (corpus.bucket_log_ms) so the
                                    # decider can learn from observed
                                    # tail latency, not just tok/s
    queue_delay: float = 0.0        # serve-side channel (not from HLO):
                                    # mean admission wait over the tap
                                    # window, same log-ms quantization

    def scaled(self, mult: float) -> "Counters":
        """A copy with flops/bytes terms scaled (e.g. by pool occupancy:
        the serve-time decider attributes a fixed-shape step's measured
        counters to the fraction of slots doing useful work).  Rates
        (prefix_hit_rate, fault_rate) and latency channels
        (step_latency_p99, queue_delay) are occupancy-invariant and
        copied through."""
        return Counters(flops=self.flops * mult, bytes=self.bytes * mult,
                        collective_bytes=self.collective_bytes * mult,
                        link_bytes=self.link_bytes * mult,
                        collective_ops=self.collective_ops, ops=self.ops,
                        prefix_hit_rate=self.prefix_hit_rate,
                        fault_rate=self.fault_rate,
                        step_latency_p99=self.step_latency_p99,
                        queue_delay=self.queue_delay)

    def add(self, other: "Counters", mult: float = 1.0,
            skip_bytes: bool = False):
        self.flops += other.flops * mult
        if not skip_bytes:
            self.bytes += other.bytes * mult
        self.collective_bytes += other.collective_bytes * mult
        self.link_bytes += other.link_bytes * mult
        self.collective_ops += int(other.collective_ops * mult)
        self.ops += int(other.ops * mult)


@dataclasses.dataclass
class RegionCounters:
    """Per-region + total counters for one compiled step (per-device)."""
    total: Counters
    regions: Dict[str, Counters]
    collective_census: Dict[str, int]
    xla_flops: float = 0.0      # cost_analysis cross-check (scan bodies 1x)
    xla_bytes: float = 0.0
    argument_bytes: int = 0     # the tensor arguments' bytes
    output_bytes: int = 0       # the returned tensors' bytes
    peak_bytes: int = 0         # peak of the arguments + live op outputs
    collectives: list = dataclasses.field(default_factory=list)

    def top_regions(self, key: str = "flops", n: int = 10):
        items = [(r, getattr(c, key)) for r, c in self.regions.items() if r]
        return sorted(items, key=lambda kv: -kv[1])[:n]


_aten = torch.ops.aten

#: products: flops = 2 x output elements x the contracted length
_MATMULS = {
    _aten.mm.default: lambda a: a[0].shape[-1],
    _aten.bmm.default: lambda a: a[0].shape[-1],
    _aten.addmm.default: lambda a: a[1].shape[-1],
    _aten.baddbmm.default: lambda a: a[1].shape[-1],
    _aten.mv.default: lambda a: a[0].shape[-1],
    _aten.dot.default: lambda a: a[0].shape[-1],
}

#: in-place slice writes: bytes = 2 x the update (the operand at this index)
_SLICE_WRITES = {"index_put_": 2, "_index_put_impl_": 2, "copy_": 1,
                 "scatter_": 3, "scatter": 3, "index_copy_": 3,
                 "index_copy": 3}

#: gathers of a slice: bytes = 2 x the output
_SLICE_READS = {"index", "index_select", "gather", "embedding"}

#: factory ops that allocate without writing, and ``_unsafe_view``: a
#: reshape of a fresh result (``matmul`` of a 3-D input emits ``mm`` and
#: then this) whose schema carries no alias annotation, though its
#: output shares its input's storage — free, as a ``bitcast`` in HLO
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_unsafe_view"}
#: ops whose output shares an input's storage without an alias
#: annotation in the schema
_ALIASES = {"_unsafe_view"}

#: views that the HLO count takes as data movement (``broadcast``,
#: ``slice``): one flop an element, no bytes, when the view has more or
#: fewer elements than its input (a view of all of it is free)
_MOVES = {"expand", "slice", "select"}

#: flops an element of a random draw: the JAX package's HLO count of the
#: same draw, threefry bits and sampler, per element at 4096 elements on
#: the CPU (``jax.random.uniform``, ``randint``, ``poisson`` at rate 3 and
#: ``binomial`` at p 0.25; ``tests/test_torch_bots.py`` holds each)
RANDOM_FLOPS = {"rand": 310, "randint": 610, "poisson": 325,
                "binomial": 1412}


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


def _nbytes(obj) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(obj))


def _is_view(func) -> bool:
    """Whether ``func`` returns an alias of an input without writing it."""
    rets = func._schema.returns
    if not rets:
        return True
    info = rets[0].alias_info
    return info is not None and not info.is_write


def _numel(obj) -> int:
    return sum(t.numel() for t in _tensors(obj))


def _broadcasts(func, args, kwargs, out) -> int:
    """The elements a pointwise op broadcasts: its output's once for each
    tensor operand smaller than it (the HLO ``broadcast`` of that
    operand); 0 for any other op."""
    if torch.Tag.pointwise not in func.tags:
        return 0
    n = _numel(out)
    return n * sum(1 for t in _tensors((args, kwargs)) if t.numel() < n)


def op_counters(func, args, kwargs, out) -> Optional[Counters]:
    """The counters of one dispatched aten op, or None when it is free."""
    if func.namespace != "aten":
        return None
    name = func._schema.name.split("::")[-1]
    if name in _MOVES:
        n = _numel(out)
        return (Counters(flops=float(n), ops=1) if n != args[0].numel()
                else None)
    if name in _FREE or _is_view(func):
        return None
    c = Counters(ops=1)
    if func in _MATMULS:
        c.flops = 2.0 * _numel(out) * _MATMULS[func](args)
        c.bytes = float(_nbytes(args) + _nbytes(out))
    elif name in _SLICE_WRITES:
        i = _SLICE_WRITES[name]
        upd = args[i] if len(args) > i else next(
            iter(kwargs.values()), None)
        c.bytes = 2.0 * _nbytes(upd)
    elif name in _SLICE_READS:
        c.flops = float(_numel(out))
        c.bytes = 2.0 * _nbytes(out)
    else:
        c.flops = float(_numel(out) * RANDOM_FLOPS.get(name, 1)
                        + _broadcasts(func, args, kwargs, out))
        c.bytes = float(_nbytes(args) + _nbytes(kwargs) + _nbytes(out))
    return c


class _Alloc:
    """One op output's storage while any tensor sharing it lives: the
    tensors carry it as an attribute, and its last reference going frees
    its bytes from the count."""
    __slots__ = ("mode", "nbytes")

    def __init__(self, mode: "CountingMode", nbytes: int):
        self.mode, self.nbytes = mode, nbytes
        mode.live += nbytes
        mode.peak_live = max(mode.peak_live, mode.live)

    def __del__(self):
        self.mode.live -= self.nbytes


_ALLOC = "_counted_alloc"


class CountingMode(TorchDispatchMode):
    """Attributes each dispatched aten op's counters to the region path it
    runs under, and tracks the live bytes of the op outputs."""

    def __init__(self):
        super().__init__()
        self.total = Counters()
        self.regions: Dict[str, Counters] = defaultdict(Counters)
        self.census: Dict[str, int] = defaultdict(int)
        self.collectives: list = []
        self.live = 0
        self.peak_live = 0
        #: count_steps' counts by the caller's key, for this count only:
        #: (the count of one run, its peak over the live bytes it starts
        #: from)
        self.step_counts: Dict[Any, tuple] = {}

    def note(self, c: Counters) -> None:
        self.total.add(c)
        self.regions[current_region()].add(c)

    def track(self, func, args, kwargs, out) -> None:
        """Live bytes: a view's outputs share its input's allocation; a new
        tensor among another op's outputs starts one of its own (an
        in-place op returns its input, which is not new)."""
        if func.namespace != "aten":
            return
        name = func._schema.name.split("::")[-1]
        if _is_view(func) or name in _ALIASES:
            base = next((getattr(t, _ALLOC, None)
                         for t in _tensors((args, kwargs))), None)
            for t in _tensors(out):
                if base is not None and getattr(t, _ALLOC, None) is None:
                    setattr(t, _ALLOC, base)
            return
        inputs = {id(t) for t in _tensors((args, kwargs))}
        for t in _tensors(out):
            if id(t) not in inputs and getattr(t, _ALLOC, None) is None:
                setattr(t, _ALLOC, _Alloc(
                    self, t.untyped_storage().nbytes()))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        c = op_counters(func, args, kwargs, out)
        if c is not None:
            self.note(c)
        self.track(func, args, kwargs, out)
        return out


class BackwardRegions(TorchFunctionMode):
    """Labels every autograd node a function call makes with the region
    state the call ran under, and hooks the node so that the engine runs
    it under that state again: a pre-hook enters it and a post-hook
    leaves it.  A call's new nodes are those reachable from its outputs'
    ``grad_fn`` that carry no label yet, composite calls' inner nodes
    included.  Where the engine runs the backward in the calling thread
    — the CPU and the meta device, where :func:`collect` counts — the
    thread-local region state is the one :class:`CountingMode` reads."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if torch.is_grad_enabled():
            snap = None
            for t in _tensors(out):
                if t.grad_fn is not None:
                    snap = snap or regions.snapshot()
                    _label(t.grad_fn, snap)
        return out


def _label(node, snap) -> None:
    todo = [node]
    while todo:
        n = todo.pop()
        if n is None or "region" in n.metadata:
            continue
        n.metadata["region"] = snap
        n.register_prehook(lambda grads, snap=snap: regions.push_path(snap))
        n.register_hook(lambda grads_in, grads_out: regions.pop_path())
        todo.extend(f for f, _ in n.next_functions)


_active: list = []


def note_work(nbytes: float, ops: float) -> None:
    """Note one hand-written kernel call's work (from
    :mod:`repro_torch.kernels.work`) into the counting region as one op;
    nothing when no count is running."""
    if _active:
        _active[-1].note(Counters(flops=float(ops), bytes=float(nbytes),
                                  ops=1))


#: the step counts :func:`count_steps` runs: a quadratic through their
#: counts gives every other one
STEP_SAMPLES = (3, 4, 5)


def _at(n: int) -> tuple:
    """The weights of the counts at ``STEP_SAMPLES`` in the count at n
    (Newton's forward differences: exact for a quadratic in n)."""
    x = n - STEP_SAMPLES[0]
    return (1 - x + x * (x - 1) // 2, x - x * (x - 1), x * (x - 1) // 2)


def _combine(counts: list, weights: tuple) -> Counters:
    c = Counters()
    for ci, wi in zip(counts, weights):
        c.add(ci, wi)
    return c


#: loops of at most this many steps are counted step by step: exact, and
#: cheap once a key (the scans' gradients run segments of 128 steps)
EXACT_STEPS = 256


def count_steps(run: Callable[[int], Any], n: int, times: int = 1,
                key: Any = None) -> None:
    """Count ``times`` runs of ``run(n)``, a loop of n steps, into the
    region current at the call, where every op of ``run`` must fall.  A
    ``key`` names runs whose counts are equal (the same shapes): the
    first one's count is kept and given again within the running count.
    A loop of at most ``EXACT_STEPS`` steps is counted step by step,
    with its peak of live bytes over those it starts from (less what
    ``run`` returns: the bytes of tensors it made only to stand in for
    ones that exist).  A longer one is counted without dispatching n
    steps: ``run(k)`` is counted apart for each k of ``STEP_SAMPLES``,
    and the count is the quadratic in n through those counts — exact
    where a step's count is constant from the third step on (the plain
    sequential scans' loops, whose autograd differs in the first steps)
    or grows by a constant (the plain chunked scans, whose slices'
    gradients span the whole sequence) — and its peak the same quadratic
    through the samples' peaks, an estimate: a loop's peak is where the largest of several lines in n
    peaks (the last step's transients, or the stack of every step's
    outputs), and the samples see only the lines that lead at 3-5 steps
    (the scans' gradients at the tests' shapes: -9.6% to +4.5% of the
    count step by step).  Runs ``run(n)`` as it is when no count is
    running (the meta device, where only counting needs the ops)."""
    if not _active:
        for _ in range(times):
            run(n)
        return
    mode = _active[-1]
    live = mode.live
    hit = mode.step_counts.get(key) if key is not None else None
    if hit is None:
        total, regions_, peak = mode.total, mode.regions, mode.peak_live
        exact = n <= EXACT_STEPS
        got = []
        for k in ((n,) if exact else STEP_SAMPLES):
            mode.total, mode.regions = Counters(), defaultdict(Counters)
            mode.peak_live = live
            stand_in = run(k) or 0
            got.append((mode.total, mode.peak_live - live - stand_in))
        mode.total, mode.regions, mode.peak_live = total, regions_, peak
        w = (1,) if exact else _at(n)
        hit = (_combine([g[0] for g in got], w),
               sum(wi * g[1] for wi, g in zip(w, got)))
        if key is not None:
            mode.step_counts[key] = hit
    mode.peak_live = max(mode.peak_live, live + hit[1])
    mode.note(_combine([hit[0]], (times,)))


def _out_bytes(kind: str, nbytes: float, n: int) -> float:
    """A rank's output bytes of a collective with ``nbytes`` of input."""
    if kind == "all-gather":
        return nbytes * n
    if kind == "reduce-scatter":
        return nbytes / n
    return nbytes


def collective_cost(kind: str, nbytes: float, n: int) -> tuple:
    """(shard bytes, ring link bytes) of one collective over ``n`` ranks
    whose input is ``nbytes`` a rank: the JAX package's ring-cost rules
    (``_collective_cost``).  An all-reduce's shard is its input and its
    busiest link carries 2·(n-1)/n of it; an all-gather's shard is its
    input and the link (n-1) of it; a reduce-scatter's shard is its
    output and the link (n-1) of that."""
    n = max(n, 1)
    if kind == "all-reduce":
        return nbytes, 2.0 * nbytes * (n - 1) / n
    if kind == "all-gather":
        return nbytes, nbytes * (n - 1)
    if kind == "reduce-scatter":
        out = nbytes / n
        return out, out * (n - 1)
    raise ValueError(f"no cost rule for {kind!r}")


def note_collective(kind: str, nbytes: float, n: int,
                    shape: tuple = ()) -> None:
    """Note one collective of ``kind`` over ``n`` ranks with ``nbytes`` of
    input a rank (an input of ``shape``) into the counting region, and
    keep it in the count's list of collectives; nothing when no count is
    running."""
    if _active:
        shard, link = collective_cost(kind, float(nbytes), n)
        mode = _active[-1]
        mode.note(Counters(bytes=nbytes + _out_bytes(kind, nbytes, n),
                           collective_bytes=shard, link_bytes=link,
                           collective_ops=1, ops=1))
        mode.census[kind] += 1
        mode.collectives.append({
            "kind": kind, "link_bytes": link, "shard_bytes": shard,
            "shape": list(shape), "region": current_region(), "group": n})


def to_meta(obj):
    """``obj`` with every tensor in it (nested dicts, lists, tuples) moved
    to the meta device; anything else as it is."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("meta")
    if isinstance(obj, dict):
        return {k: to_meta(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_meta(v) for v in obj)
    return obj


def collect(fn: Callable, *args: Any, **kwargs: Any) -> RegionCounters:
    """Count ``fn(*args, **kwargs)`` per region without running it: its
    tensor arguments go to the meta device, and every aten op it
    dispatches is counted (:func:`op_counters`) under the region it runs
    in.  ``fn`` runs under ``torch.no_grad()``; one that differentiates
    (a train step) enables grad itself, and its backward ops are counted
    under the regions of the forward ops they differentiate.  ``fn`` must
    not synchronise with the host (``.item()``, ``.cpu()``): a meta tensor
    has no value, so such a call raises."""
    margs, mkwargs = to_meta(args), to_meta(kwargs)
    mode = CountingMode()
    _active.append(mode)
    try:
        with torch.no_grad(), BackwardRegions(), mode:
            out_bytes = _nbytes(fn(*margs, **mkwargs))
    finally:
        _active.pop()
    arg_bytes = _nbytes((margs, mkwargs))
    return RegionCounters(total=mode.total, regions=dict(mode.regions),
                          collective_census=dict(mode.census),
                          argument_bytes=arg_bytes,
                          output_bytes=out_bytes,
                          peak_bytes=arg_bytes + mode.peak_live,
                          collectives=mode.collectives)

