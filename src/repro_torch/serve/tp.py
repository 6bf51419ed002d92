"""Tensor-parallel paged serving over ``torch.distributed`` ranks.

The JAX engine is single-controller: GSPMD partitions one program over the
mesh.  Here each rank is a process with a device of its own (or a share of
one), holding its shard of the params and of the page pool:

* **Rank 0** is the caller's process.  It runs the engine's host loop
  unchanged — scheduler, governor, health ladder, telemetry, decider — and
  before each device step broadcasts the host-built inputs (tokens, block
  tables, lengths) and the step's plan to the other ranks.
* **Ranks 1 and up** are processes :class:`Ranks` spawns.  They run
  :func:`worker_loop`: the same step functions on their shards, until rank
  0 broadcasts a stop.  A worker takes no host decision: deadlines,
  shedding, fault draws and replans depend on the wall clock or a random
  draw and would diverge across ranks.

Pages split on the kv-head axis only, so page ids, block tables and the
allocator are the same on every rank: rank 0's allocator decides, and the
other ranks follow the broadcast block tables (and the copy-on-write page
copies rank 0 mirrors to them).  A change of degree reshards the pool
through rank 0 and switches each rank's params copy (:meth:`RankState.switch`).

The backend follows :func:`repro_torch.launch.mesh.backend_for`: ``nccl``
where each rank has a card of its own, ``gloo`` where ranks share a device.
Control messages travel as CPU tensors under gloo and as device tensors
under NCCL; the step's collectives (:mod:`repro_torch.distributed.comm`)
are ``all_reduce`` on device tensors, and the transfers ``broadcast``.
"""
from __future__ import annotations

import datetime
import json
import os
import sys
import traceback
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.policy import RegionPlan
from repro_torch.distributed import comm
from repro_torch.distributed.sharding import (cache_shardings, leaf_block,
                                              local_shape, param_shardings,
                                              shard_leaf)
from repro_torch.launch.mesh import (backend_for, make_host_mesh,
                                     rank_device, start_ranks, worker_store)
from repro_torch.models import layers as L

# control messages: a header of HEADER int64s, [op, args...]
(OP_STOP, OP_INIT, OP_DEGREE, OP_PLAN, OP_DECODE, OP_CHUNK, OP_COPY,
 OP_REPORT) = range(8)
HEADER = 8
DTYPES = (torch.float32, torch.bfloat16)


def serve_plan(plan: RegionPlan, mesh) -> RegionPlan:
    """The plan a sharded serve step runs under: the decided plan's rules
    with the pool-layout axes pinned — pages shard on kv_heads (never
    kv_seq: the block table indexes page ids and in-page positions the
    same on every shard), q heads follow their GQA groups, ff and vocab
    keep the plan's rules.  Without a mesh the plan itself."""
    if mesh is None:
        return plan
    rules = dict(plan.rules)
    rules.update({"kv_seq": None, "kv_heads": "model", "heads": "model"})
    return RegionPlan(mesh=mesh, rules=rules,
                      region_configs=plan.region_configs)


def paged_logits(model, plan: RegionPlan, params, pages, tokens,
                 block_tables, lengths) -> torch.Tensor:
    """One paged decode step's logits (B, S, V), the same on every rank:
    a vocab-sharded unembedding's rows are replicated here, once, before
    sampling — the step's single gather."""
    logits, _ = model.paged_decode(params, pages, tokens, block_tables,
                                   lengths, plan)
    if plan.mesh is None:
        return logits
    return comm.replicate_vocab(logits.float(), model.cfg.vocab_size,
                                plan.mesh)


class Channel:
    """Rank 0's control messages to the other ranks, over the default
    group: a fixed header, then the payload it announces."""

    def __init__(self, backend: str, device: torch.device):
        self.device = device if backend == "nccl" else torch.device("cpu")

    def _bcast(self, t: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        dist.broadcast(t, src=0)
        return t

    def send(self, op: int, *args: int) -> None:
        h = torch.zeros(HEADER, dtype=torch.int64)
        h[0] = op
        h[1:1 + len(args)] = torch.tensor(args, dtype=torch.int64)
        self._bcast(h.to(self.device))

    def recv(self) -> tuple:
        h = self._bcast(torch.zeros(HEADER, dtype=torch.int64,
                                    device=self.device)).cpu().tolist()
        return h[0], h[1:]

    def send_ints(self, *arrays) -> None:
        flat = np.concatenate([np.asarray(a, np.int32).reshape(-1)
                               for a in arrays])
        self._bcast(torch.from_numpy(flat).to(self.device))

    def recv_ints(self, n: int) -> torch.Tensor:
        return self._bcast(torch.zeros(n, dtype=torch.int32,
                                       device=self.device))

    def send_bytes(self, data: bytes) -> None:
        self._bcast(torch.frombuffer(bytearray(data), dtype=torch.uint8)
                    .to(self.device))

    def recv_bytes(self, n: int) -> bytes:
        t = self._bcast(torch.zeros(n, dtype=torch.uint8,
                                    device=self.device))
        return bytes(t.cpu().numpy())


class RankState:
    """One rank's share of a served model: its params copy per degree and
    its page shard at the current degree.  Rank 0 (an engine's) and the
    workers hold one each and change degree in lockstep, so their
    transfers pair up; rank 0's degree-1 params are the full params.
    ``meshes`` (degree -> mesh) belongs to the rank's process group and
    outlives the engines: building a mesh is collective, so each rank
    builds each degree's once."""

    def __init__(self, model, rank: int, device: torch.device,
                 meshes: dict):
        self.model, self.rank, self.device = model, rank, device
        self.meshes = meshes
        self.reset(0, 0, torch.float32)

    def reset(self, n_pages: int, page_size: int, dtype: torch.dtype,
              params: Any = None) -> None:
        """A new pool: no pages, no params copy but ``params`` (rank 0's
        full params) at degree 1."""
        self.n_pages, self.page_size, self.dtype = n_pages, page_size, dtype
        self.params: dict = {1: params} if params is not None else {}
        self.pages: Any = None
        self.degree = 1

    def mesh(self, d: int):
        """The ``(1, d)`` mesh of degree ``d`` (None at 1).  Collective the
        first time: every rank builds it in the same order."""
        if d == 1:
            return None
        if d not in self.meshes:
            self.meshes[d] = make_host_mesh(1, d)
        return self.meshes[d]

    def _page_specs(self, d: int) -> list:
        """(global shape, spec) of every page leaf at degree ``d``, in
        leaf order."""
        spec = self.model.paged_cache_spec(self.n_pages, self.page_size)
        plan = serve_plan(RegionPlan(), self.mesh(d))
        return list(zip(L.tree_leaves(spec),
                        L.tree_leaves(cache_shardings(plan, spec))))

    def _holds(self, d: int) -> bool:
        return self.rank < d

    def _empty(self, shape) -> torch.Tensor:
        return torch.empty(shape, dtype=self.dtype, device=self.device)

    def _bcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        import torch.distributed as dist
        dist.broadcast(t, src=src)
        return t

    def _page_tree(self, leaves: list) -> Any:
        spec = self.model.paged_cache_spec(self.n_pages, self.page_size)
        it = iter(leaves)
        return L.tree_map(lambda _: next(it), spec)

    def switch(self, d: int, fresh: bool, pages: Any = None) -> None:
        """Move to degree ``d``: the page shard (``pages``, or zeros, when
        ``fresh``; else resharded through rank 0, contents kept) and the
        params copy (sent by rank 0 the first time a degree is used)."""
        mesh = self.mesh(d)
        if fresh:
            self.pages = pages
            if pages is None and self._holds(d):
                self.pages = self._page_tree([
                    torch.zeros(local_shape(shape, spec, mesh),
                                dtype=self.dtype, device=self.device)
                    for shape, spec in self._page_specs(d)])
        elif d != self.degree:
            self.pages = self._scatter(self._gather_pages(), d)
        if d > 1 and d not in self.params:
            self.params[d] = self._scatter_params(d)
        self.degree = d

    def _gather_pages(self) -> Optional[list]:
        """The full page leaves on rank 0 (None elsewhere), from the
        shards of the current degree."""
        d, mesh = self.degree, self.mesh(self.degree)
        mine = L.tree_leaves(self.pages) if self.pages is not None else []
        if d == 1:
            return mine if self.rank == 0 else None
        full = []
        for i, (shape, spec) in enumerate(self._page_specs(d)):
            out = self._empty(shape) if self.rank == 0 else None
            for r in range(d):
                coords = {"data": 0, "model": r}
                if r == 0:
                    if out is not None:
                        leaf_block(out, spec, mesh, coords).copy_(mine[i])
                    continue
                buf = (mine[i] if self.rank == r
                       else self._empty(local_shape(shape, spec, mesh)))
                self._bcast(buf, r)
                if out is not None:
                    leaf_block(out, spec, mesh, coords).copy_(buf)
            full.append(out)
        self.pages = None
        return full if self.rank == 0 else None

    def _scatter(self, full: Optional[list], d: int) -> Any:
        """Cut rank 0's full page leaves into degree-``d`` shards: this
        rank's shard tree (None on a rank that holds none)."""
        mesh = self.mesh(d)
        if d == 1:
            return self._page_tree(full) if self.rank == 0 else None
        mine = []
        for i, (shape, spec) in enumerate(self._page_specs(d)):
            mine.append(self._send_shards(
                full[i] if self.rank == 0 else None, shape, spec, mesh, d))
        return self._page_tree(mine) if self._holds(d) else None

    def _send_shards(self, leaf, shape, spec, mesh, d: int):
        """Rank 0 broadcasts rank r's piece of ``leaf`` for r = 1..d-1;
        returns this rank's piece (None on a rank that holds none)."""
        local = local_shape(shape, spec, mesh)
        own = None
        for r in range(1, d):
            if self.rank == 0:
                buf = shard_leaf(leaf, spec, mesh, {"data": 0, "model": r})
            else:
                buf = self._empty(local)
            self._bcast(buf, 0)
            if self.rank == r:
                own = buf
        if self.rank == 0:
            own = shard_leaf(leaf, spec, mesh, {"data": 0, "model": 0})
        return own

    def _scatter_params(self, d: int) -> Any:
        """This rank's params copy at degree ``d``, cut by rank 0 from the
        full params leaf by leaf.  An MoE model's expert leaves and
        router columns split on the experts (padded ones included: the
        router masks the pads by their global index after it gathers its
        columns, :func:`repro_torch.models.moe.route`), the shared
        experts' on ``ff``."""
        mesh = self.mesh(d)
        plan = serve_plan(RegionPlan(), mesh)
        specs = L.tree_leaves(param_shardings(self.model, plan))
        shapes = [s.shape for s in L.tree_leaves(self.model.spec())]
        full = L.tree_leaves(self.params[1]) if self.rank == 0 else None
        mine = [self._send_shards(full[i] if full else None, shape, spec,
                                  mesh, d)
                for i, (shape, spec) in enumerate(zip(shapes, specs))]
        if not self._holds(d):
            return None
        it = iter(mine)
        return L.tree_map(lambda _: next(it), self.model.spec())

    def experts(self) -> int:
        """The experts of the expert leaves this rank's params copy at the
        current degree holds (``n_experts_padded / degree`` over ranks): 0
        for a model without experts or a rank that holds no copy."""
        params = self.params.get(self.degree)
        if not self.model.cfg.n_experts or params is None:
            return 0
        return params["blocks"]["mlp"]["gate"].shape[1]

    def copy_page(self, old: int, new: int) -> None:
        """A copy-on-write copy of page ``old`` into ``new`` on this
        rank's shard."""
        if self.pages is not None:
            for t in L.tree_leaves(self.pages):
                t[new].copy_(t[old])


class Ranks:
    """``world`` ranks serving one model on ``device``: this process is
    rank 0, ranks 1.. are spawned processes in :func:`worker_loop`.

    Use as a context manager: on a clean exit the workers are stopped and
    joined (a worker that exited with an error raises here), after an
    error they are terminated; the process group is destroyed either way.
    A worker that dies before it joins the group fails the start at once;
    ``timeout_s`` bounds every collective after."""

    def __init__(self, cfg, world: int, device, *, timeout_s: float = 300):
        import torch.distributed as dist
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.cfg, self.world = cfg, int(world)
        self.backend = backend_for(device, self.world)
        self.device = rank_device(device, 0, self.backend)
        try:
            store, self.procs = start_ranks(
                self.world, _worker_main,
                (self.backend, str(device), cfg, timeout_s), timeout_s)
        except RuntimeError as e:
            raise RuntimeError(f"tensor-parallel {e}") from None
        dist.init_process_group(
            self.backend, store=store, rank=0, world_size=self.world,
            timeout=datetime.timedelta(seconds=timeout_s))
        self.channel = Channel(self.backend, self.device)
        self.meshes: dict = {}          # degree -> mesh, for rank 0's engines
        self._plans: dict = {}          # plan message -> id, since init()
        self._closed = False

    def line(self) -> str:
        """What the ranks are, for the log: the backend and why."""
        why = ("each rank has a card of its own" if self.backend == "nccl"
               else "ranks share a device")
        return (f"{self.world} ranks on {self.device.type} over "
                f"{self.backend} ({why})")

    # -- rank 0's commands (the engine's side of worker_loop) ----------------
    def init(self, n_pages: int, page_size: int, dtype: torch.dtype,
             degree: int) -> None:
        """A new pool of ``n_pages`` pages in ``dtype``, sharded at
        ``degree``: the workers drop what an earlier engine left and
        build their shards (``RankState.switch`` with ``fresh``)."""
        self._plans.clear()
        self.channel.send(OP_INIT, n_pages, page_size, DTYPES.index(dtype))
        self.channel.send(OP_DEGREE, degree, 1)

    def switch(self, degree: int) -> None:
        """The workers' side of a change of degree (pages resharded)."""
        self.channel.send(OP_DEGREE, degree, 0)

    def _plan_id(self, plan: RegionPlan) -> int:
        """The workers' id of ``plan``, sent to them at its first use."""
        msg = plan_message(plan)
        pid = self._plans.get(msg)
        if pid is None:
            pid = self._plans[msg] = len(self._plans)
            self.channel.send(OP_PLAN, pid, len(msg))
            self.channel.send_bytes(msg)
        return pid

    def decode(self, plan: RegionPlan, tokens, block_tables,
               lengths) -> None:
        """The workers run the paged decode step of ``plan`` on these host
        inputs (tokens (B, S), block tables (B, MP), lengths (B,))."""
        B, S = tokens.shape
        self.channel.send(OP_DECODE, self._plan_id(plan), B, S,
                          block_tables.shape[1])
        self.channel.send_ints(tokens, block_tables, lengths)

    def chunk(self, plan: RegionPlan, tokens, block_table,
              base: int) -> None:
        """The workers write one prefill chunk (tokens (C,), from absolute
        position ``base``, through the block-table row (MP,))."""
        self.channel.send(OP_CHUNK, self._plan_id(plan), tokens.size,
                          block_table.size, base)
        self.channel.send_ints(tokens, block_table)

    def copy_page(self, old: int, new: int) -> None:
        """The workers copy page ``old`` into ``new`` (copy-on-write)."""
        self.channel.send(OP_COPY, old, new)

    def report(self) -> list:
        """Each worker's counts since its last report, rank by rank: the
        paged kernel's launches, its decode and chunk steps, its page
        shard's bytes and kv heads, and the experts its params copy holds
        (an MoE model's; 0 otherwise)."""
        import torch.distributed as dist
        self.channel.send(OP_REPORT)
        out = []
        for r in range(1, self.world):
            t = torch.zeros(6, dtype=torch.int64, device=self.channel.device)
            dist.broadcast(t, src=r)
            launches, decode, chunk, nbytes, kvh, experts = t.cpu().tolist()
            out.append({"rank": r, "paged_launches": launches,
                        "decode_steps": decode, "chunk_steps": chunk,
                        "page_bytes": nbytes, "kv_heads": kvh,
                        "experts": experts})
        return out

    def close(self, error: bool = False) -> None:
        import torch.distributed as dist
        if self._closed:
            return
        self._closed = True
        try:
            if not error:
                self.channel.send(OP_STOP)
                for p in self.procs:
                    p.join(timeout=120)
        finally:
            for p in self.procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=30)
            if dist.is_initialized():
                dist.destroy_process_group()
        bad = [(r + 1, p.exitcode) for r, p in enumerate(self.procs)
               if p.exitcode != 0]
        if bad and not error:
            raise RuntimeError(f"tensor-parallel worker ranks failed "
                               f"(rank, exit code): {bad}")

    def __enter__(self) -> "Ranks":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(error=exc_type is not None)


def _worker_main(rank: int, world: int, port: int, backend: str,
                 device: str, cfg, timeout_s: float) -> None:
    """A spawned rank: join the group, serve commands, leave."""
    import torch.distributed as dist
    try:
        dev = rank_device(torch.device(device), rank, backend)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        store = worker_store(rank, world, port, timeout_s)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        from repro_torch.models.model import build
        worker_loop(build(cfg), rank, dev, Channel(backend, dev))
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


@torch.no_grad()
def worker_loop(model, rank: int, device: torch.device,
                channel: Channel) -> None:
    """Serve rank 0's commands on this rank's shard until it says stop."""
    import torch.distributed as dist
    from repro_torch.kernels import LAUNCHES
    state = RankState(model, rank, device, {})
    plans: dict = {}            # plan id -> RegionPlan (no mesh)
    counts = {"decode": 0, "chunk": 0, "launches0": 0}
    while True:
        op, a = channel.recv()
        if op == OP_STOP:
            return
        if op == OP_INIT:
            state.reset(a[0], a[1], DTYPES[a[2]])
            plans.clear()
        elif op == OP_DEGREE:
            state.switch(a[0], fresh=bool(a[1]))
        elif op == OP_PLAN:
            plans[a[0]] = RegionPlan.from_json(
                channel.recv_bytes(a[1]).decode())
        elif op == OP_DECODE:
            pid, B, S, MP = a[:4]
            data = channel.recv_ints(B * S + B * MP + B).to(device)
            toks, bt, lengths = data.split([B * S, B * MP, B])
            if state.pages is not None:
                paged_logits(model, serve_plan(plans[pid],
                                               state.mesh(state.degree)),
                             state.params[state.degree], state.pages,
                             toks.view(B, S), bt.view(B, MP), lengths)
                counts["decode"] += 1
        elif op == OP_CHUNK:
            pid, C, MP, base = a[:4]
            data = channel.recv_ints(C + MP).to(device)
            toks, bt = data.split([C, MP])
            if state.pages is not None:
                model.paged_prefill_chunk(
                    state.params[state.degree], state.pages, toks.view(1, C),
                    bt, base, serve_plan(plans[pid],
                                         state.mesh(state.degree)))
                counts["chunk"] += 1
        elif op == OP_COPY:
            state.copy_page(a[0], a[1])
        elif op == OP_REPORT:
            launches = LAUNCHES.get("paged_attention_mq", 0)
            nbytes = sum(t.numel() * t.element_size()
                         for t in L.tree_leaves(state.pages or {}))
            kvh = (L.tree_leaves(state.pages)[0].shape[2]
                   if state.pages is not None else 0)
            experts = state.experts()
            for r in range(1, dist.get_world_size()):
                t = torch.tensor([launches - counts["launches0"],
                                  counts["decode"], counts["chunk"],
                                  nbytes, kvh, experts], dtype=torch.int64)
                dist.broadcast(t.to(channel.device), src=r)
            counts.update(decode=0, chunk=0, launches0=launches)
        else:
            raise ValueError(f"unknown tensor-parallel command {op}")


def plan_message(plan: RegionPlan) -> bytes:
    """A plan as the workers receive it (its rules and region knobs; the
    mesh is each rank's own)."""
    return json.dumps(json.loads(plan.to_json()), sort_keys=True).encode()
