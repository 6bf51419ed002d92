"""Mesh definitions over ``torch.distributed`` ranks (functions, not
module constants: importing this module touches no device and no process
group).

A mesh is a ``DeviceMesh`` with named axes, ``("data", "model")`` — or
``("pod", "data", "model")`` across pods — over the ranks of the default
process group: one rank a device.  :func:`backend_for` is the one place
the process-group backend is chosen.
"""
from __future__ import annotations

import torch


def _world() -> int:
    """Ranks of the default process group (1 when none is initialised)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _device_type() -> str:
    """The mesh's device type: ``cuda`` under the NCCL and gloo backends
    when a card is visible, else ``cpu`` (the fake process group's
    production meshes are built on the CPU)."""
    import torch.distributed as dist
    if dist.get_backend() == "fake" or not torch.cuda.is_available():
        return "cpu"
    return "cuda"


def _mesh(shape: tuple, names: tuple):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(), shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 ``("data", "model")``, or 2x16x16 with ``"pod"`` in front.
    Builds only where a world of that size (256 or 512 ranks) exists."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1):
    """Small ``("data", "model")`` mesh over the ranks that exist.

    The requested ``model`` (tensor-parallel) degree takes priority: it is
    clamped only by the rank count, and ``data`` then fits into whatever
    remains (clamping ``data`` first would funnel ``model`` through
    ``n // data`` and drop a degree the ranks can satisfy).  Collective:
    every rank of the default group calls it."""
    n = _world()
    model = max(min(model, n), 1)
    data = max(min(data, n // model), 1)
    return _mesh((data, model), ("data", "model"))


def backend_for(device: torch.device, world: int) -> str:
    """The process-group backend for ``world`` ranks on ``device``:
    ``nccl`` where each rank has a card of its own, ``gloo`` where ranks
    share a device (the CPU, or more ranks than cards)."""
    if device.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device: torch.device, rank: int, backend: str
                ) -> torch.device:
    """The device rank ``rank`` runs on: its own card under NCCL, the
    shared ``device`` otherwise."""
    if device.type == "cuda" and backend == "nccl":
        return torch.device("cuda", rank)
    return device


def start_ranks(world: int, target, args: tuple, timeout_s: float = 300):
    """This process as rank 0 of ``world`` ranks: ranks 1.. are spawned
    processes (the ``spawn`` start method) running ``target(rank, world,
    port, *args)``, which meet this process through a TCP store on a free
    port (:func:`worker_store`).  Returns (store, processes) once every
    worker has reached the store; a worker that died on the way fails the
    start at once, and the rest are terminated."""
    import datetime
    import time

    import torch.distributed as dist
    import torch.multiprocessing as mp
    store = dist.TCPStore("localhost", 0, world, is_master=True,
                          wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=timeout_s))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, daemon=True,
                         args=(r, world, store.port) + tuple(args))
             for r in range(1, world)]
    for p in procs:
        p.start()
    keys = [f"ready{r}" for r in range(1, world)]
    t0 = time.monotonic()
    while not store.check(keys):
        dead = [(r + 1, p.exitcode) for r, p in enumerate(procs)
                if not p.is_alive()]
        if dead or time.monotonic() - t0 > timeout_s:
            for p in procs:
                p.terminate()
            raise RuntimeError(
                f"worker ranks did not start (rank, exit code): "
                f"{dead or 'timed out'}")
        time.sleep(0.05)
    return store, procs


def worker_store(rank: int, world: int, port: int, timeout_s: float = 300):
    """A spawned rank's side of :func:`start_ranks`: the store, with this
    rank marked ready."""
    import datetime

    import torch.distributed as dist
    store = dist.TCPStore("localhost", port, world, is_master=False,
                          timeout=datetime.timedelta(seconds=timeout_s))
    store.set(f"ready{rank}", "1")
    return store
