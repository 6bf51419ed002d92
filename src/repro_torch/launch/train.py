"""End-to-end training launcher on PyTorch.

Reduced configs by default (``--full`` for the published widths), on
``--device`` (default ``cuda``; ``--device cpu`` runs on the CPU, nothing
else does).  Handles checkpoint/restart (``--resume``), straggler
telemetry and plan files from the autotuner.  On one rank — as the JAX
launcher does on one device — any plan, a ``--plan`` file included, is
replaced by ``null_plan()``: the launcher never remats.

``--ranks N`` trains over N ranks (every family; an MoE model's experts
split over ``model``): this process is
rank 0 and spawns the others, each runs the same loop on its blocks of a
``(data, model)`` mesh (``--data``/``--model``; the model degree first,
the data degree in what is left, as ``make_host_mesh`` resolves them)
under ``default_plan(mesh, "train")`` or the ``--plan`` file, with
ZeRO-1 moments; the backend follows ``launch.mesh.backend_for`` (gloo
where ranks share a device).  Rank 0 prints what the one-rank launcher
prints.  Checkpoints over ranks are the one-rank format: every rank
sends its blocks, rank 0 writes the whole state (``checkpoint.save``
with the train state's specs), and ``--resume`` reads it leaf by leaf,
each rank keeping its blocks (``checkpoint.restore`` with the specs, the
moments at their ZeRO-1 blocks), so
a checkpoint written on any split resumes on any other, one rank and
the JAX package's launcher included; ``--fail-at-step`` ends every rank
with exit code 42, and this process with it.  Every family trains: the
VLM and the encoder-decoder on zero vision embeddings and zero frames
(the stubbed frontends, as the JAX launcher feeds them, in the params'
dtype), rwkv6 and zamba2 through the scan kernels' gradient
(:func:`repro_torch.kernels.ops.wkv` / ``ssd``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \\
      --steps 50 --batch 8 --seq 128 --ckpt-dir run1

  # the CPU, reduced, f32
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --dtype float32 --steps 12 --batch 2 --seq 32

  # two ranks on the CPU: data 2 with ZeRO-1, or --model 2
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --dtype float32 --ranks 2 --data 2 --steps 4 --batch 4 --seq 32

  # two ranks killed at step 6, resumed on the other split
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --dtype float32 --ranks 2 --data 2 --steps 8 --batch 4 --seq 32 \\
      --ckpt-dir run2 --ckpt-every 4 --fail-at-step 6
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --dtype float32 --ranks 2 --model 2 --steps 8 --batch 4 --seq 32 \\
      --ckpt-dir run2 --ckpt-every 4 --resume

  # rwkv6 over two ranks at model 2 (its WKV scan head-replicated)
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --dtype float32 --arch rwkv6-3b --ranks 2 --model 2 --steps 4 \\
      --batch 4 --seq 32

The host reads the device once per logged step (the loss), and at a
checkpoint; other steps are only enqueued, so the watchdog times the
host's side of them.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config
from repro_torch.core.policy import RegionPlan, default_plan, null_plan
from repro_torch.data.pipeline import DataConfig, Prefetcher, iterate
from repro_torch.models import model as model_mod
from repro_torch.optim import adamw
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import trainer
from repro_torch.train.elastic import StepWatchdog


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--plan", default="", help="tuned RegionPlan json")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--fail-at-step", type=int, default=0,
                    help="simulate a node failure (tests)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda unless asked)")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16", help="param dtype")
    ap.add_argument("--ranks", type=int, default=1,
                    help="ranks to train over (this process and N-1 "
                         "spawned ones)")
    ap.add_argument("--data", type=int, default=0,
                    help="data-parallel degree (default: the ranks the "
                         "model degree leaves)")
    ap.add_argument("--model", type=int, default=1,
                    help="tensor-parallel degree")
    ap.add_argument("--stats-out", default="",
                    help="write every rank's step losses, grad norms, aux "
                         "losses, step ms, moment bytes, kernel launches, "
                         "device memory and an MoE model's experts a rank "
                         "as JSON")
    return ap.parse_args(argv)


#: the exit code of a simulated node failure (``--fail-at-step``)
FAIL_EXIT = 42


def main(argv=None):
    args = parse_args(argv)
    if args.ranks <= 1:
        return train_loop(args, resolve_device(args.device))
    import torch.distributed as dist
    from repro_torch.launch.mesh import backend_for, rank_device, start_ranks
    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    backend = backend_for(device, args.ranks)
    store, procs = start_ranks(args.ranks, _rank_main,
                               (backend, str(device), argv))
    dist.init_process_group(backend, store=store, rank=0,
                            world_size=args.ranks)
    ok, failed = False, None
    try:
        loss = train_loop(args, rank_device(device, 0, backend))
        ok = True
    except SystemExit as e:
        if e.code != FAIL_EXIT:
            raise
        failed = e          # every rank simulates the failure
    finally:
        dist.destroy_process_group()
        for p in procs:
            if ok or failed:
                p.join(timeout=300)
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
    want = FAIL_EXIT if failed else 0
    bad = [(r + 1, p.exitcode) for r, p in enumerate(procs)
           if p.exitcode != want]
    if bad:
        raise RuntimeError(f"training ranks failed (rank, exit code): {bad}")
    if failed:
        raise failed
    return loss


def _rank_main(rank: int, world: int, port: int, backend: str, device: str,
               argv) -> None:
    """A spawned rank: join the group, run the loop, leave."""
    import os
    import sys
    import traceback

    import torch.distributed as dist
    from repro_torch.launch.mesh import rank_device, worker_store
    try:
        dev = rank_device(torch.device(device), rank, backend)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        store = worker_store(rank, world, port)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world)
        train_loop(parse_args(argv), dev)
        dist.destroy_process_group()
    except SystemExit as e:     # the simulated failure: rank 0's code
        sys.stdout.flush()
        os._exit(FAIL_EXIT if e.code == FAIL_EXIT else 1)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def _placed(model, args, dev, dtype):
    """(params, opt_state, plan, step keywords, local batch rows, the
    train state's specs) of this rank: on one rank the whole state,
    ``null_plan()`` and no specs; over ranks its blocks
    (``elastic.reshard`` of the seeded init) under the train plan, the
    moments at their ZeRO-1 blocks, and each rank's rows of a global
    microbatch as the JAX package's trainer slices it
    (``sharding.microbatch_rows``)."""
    if args.ranks <= 1:
        if args.plan:   # read, as the JAX launcher does, then replaced:
            with open(args.plan) as f:
                RegionPlan.from_json(f.read())
        params = model.init(args.seed, dtype=dtype, device=dev)
        return (params, adamw.init_state(params), null_plan(), {},
                lambda b: b, None)
    from repro_torch.distributed import sharding as shard_mod
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import elastic
    mesh = make_host_mesh(data=args.data or args.ranks // args.model,
                          model=args.model)
    if args.plan:
        with open(args.plan) as f:
            plan = RegionPlan.from_json(f.read(), mesh=mesh)
    else:
        plan = default_plan(mesh, "train")
    p_sh = shard_mod.param_shardings(model, plan)
    o_sh = shard_mod.opt_state_shardings(model, plan)
    full = model.init(args.seed, dtype=dtype, device=dev)
    params = elastic.reshard(full, model.logical_axes(), plan, device=dev)
    del full
    zeros = lambda p, sp: torch.zeros(  # noqa: E731
        shard_mod.local_shape(tuple(p.shape), sp, mesh),
        dtype=torch.float32, device=dev)
    abstract = model.abstract_params()
    opt_state = {"step": torch.zeros((), dtype=torch.int32, device=dev),
                 "mu": _map2(zeros, abstract, o_sh["mu"]),
                 "nu": _map2(zeros, abstract, o_sh["nu"])}
    coords = shard_mod.mesh_coords(mesh)
    b_specs = shard_mod.batch_shardings(
        plan, {"tokens": (args.batch, args.seq),
               "labels": (args.batch, args.seq)})

    def rows(batch):
        return {k: shard_mod.microbatch_rows(v, b_specs[k], mesh, coords,
                                             args.microbatch)
                for k, v in batch.items()}
    kw = dict(grad_shardings=p_sh, opt_shardings=o_sh["mu"])
    return params, opt_state, plan, kw, rows, {"params": p_sh, "opt": o_sh}


def _map2(fn, a, b):
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in sorted(a)}
    return fn(a, b)


def _nbytes(tree) -> int:
    from repro_torch.models import layers as L
    return sum(t.numel() * t.element_size() for t in L.tree_leaves(tree))


def train_loop(args, dev):
    """The training loop of this rank (every rank runs it, in step)."""
    import torch.distributed as dist
    multi = args.ranks > 1
    rank = dist.get_rank() if multi else 0
    cuda = dev.type == "cuda"
    mem0 = torch.cuda.memory_allocated(dev) if cuda else 0
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = model_mod.build(cfg)
    dtype = getattr(torch, args.dtype)
    params, opt_state, plan, kw, rows, specs = _placed(model, args, dev,
                                                       dtype)
    start_step = 0
    if cuda:
        torch.cuda.synchronize(dev)
        placed = torch.cuda.memory_allocated(dev) - mem0
    if args.resume and args.ckpt_dir:
        found = _latest(args.ckpt_dir, multi)
        if found:
            params, opt_state, start_step = _restore(
                args.ckpt_dir, found, params, opt_state, plan, specs)
            if rank == 0:
                print(f"resumed from step {start_step}")
    stats = {"rank": rank,
             "moment_bytes": _nbytes({"mu": opt_state["mu"],
                                      "nu": opt_state["nu"]}),
             "param_bytes": _nbytes(params),
             "loss": [], "grad_norm": [], "aux": [], "step_ms": []}
    if cfg.n_experts:   # the experts of this rank's expert leaves
        stats["experts"] = params["blocks"]["mlp"]["gate"].shape[1]
    if cuda:
        stats["allocated_after_placement"] = placed
        torch.cuda.reset_peak_memory_stats(dev)

    opt_cfg = adamw.AdamWConfig(lr=args.lr)
    step_fn = trainer.make_train_step(
        model, plan, opt_cfg=opt_cfg, unroll=False,
        microbatch=args.microbatch, schedule_total=args.steps, **kw)

    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch, seed=args.seed)
    data = Prefetcher(map(rows, iterate(data_cfg, start_step, device="cpu")),
                      device=dev)
    watchdog = StepWatchdog()

    from repro_torch import kernels
    launched = dict(kernels.LAUNCHES)
    t_start = time.time()
    metrics = None
    for step in range(start_step, args.steps):
        batch = next(data)
        rows_here = batch["tokens"].shape[0]   # this rank's rows
        if cfg.family == "encdec":
            batch = dict(batch, frames=torch.zeros(
                (rows_here, cfg.enc_len, cfg.d_model), dtype=dtype,
                device=dev))
        if cfg.frontend == "vision_patches":
            batch = dict(batch, vision_embeds=torch.zeros(
                (rows_here, 8, cfg.d_model), dtype=dtype, device=dev))
        watchdog.start()
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if args.stats_out:
            loss_v = float(metrics["loss"])   # waits for the step
            stats["step_ms"].append((time.perf_counter() - t0) * 1e3)
            stats["loss"].append(loss_v)
            stats["grad_norm"].append(float(metrics["grad_norm"]))
            stats["aux"].append(float(metrics["aux"]))
        straggler = watchdog.stop(step)
        if straggler and rank == 0:
            print(f"[watchdog] step {step} flagged as straggler")
        if rank == 0 and (step % args.log_every == 0
                          or step == args.steps - 1):
            print(f"step {step:5d} loss {metrics['loss'].item():.4f} "
                  f"gnorm {metrics['grad_norm'].item():.3f} "
                  f"lr {metrics['lr'].item():.2e}")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt_mod.save(args.ckpt_dir, step + 1,
                          {"params": params, "opt": opt_state},
                          meta={"arch": cfg.name}, specs=specs,
                          mesh=plan.mesh)
        if args.fail_at_step and step + 1 == args.fail_at_step:
            if rank == 0:
                print(f"simulating node failure at step {step + 1}")
            raise SystemExit(FAIL_EXIT)
    loss = float(metrics["loss"]) if metrics else float("nan")
    dt = time.time() - t_start
    # this rank's kernel launches in its steps
    stats["launches"] = {k: n - launched.get(k, 0)
                         for k, n in kernels.LAUNCHES.items()
                         if n != launched.get(k, 0)}
    if cuda:
        stats["peak_allocated"] = torch.cuda.max_memory_allocated(dev) - mem0
    if args.stats_out:
        _write_stats(args.stats_out, stats, multi)
    if rank == 0:
        tok = (args.steps - start_step) * args.batch * args.seq
        print(f"done: {dt:.1f}s, {tok/dt:.0f} tok/s, final loss {loss:.4f}")
    return loss


def _latest(ckpt_dir: str, multi: bool):
    """The newest intact checkpoint's (step, manifest), or None: rank 0's
    choice, sent to every rank."""
    if not multi:
        return ckpt_mod.latest_valid(ckpt_dir)
    import torch.distributed as dist
    found = [ckpt_mod.latest_valid(ckpt_dir) if dist.get_rank() == 0
             else None]
    dist.broadcast_object_list(found, src=0)
    return found[0]


def _restore(ckpt_dir: str, found, params, opt_state, plan, specs):
    """(params, opt_state, step) restored from the checkpoint ``found``
    into this rank's state: whole on one rank; over ranks each rank's
    blocks, each leaf read whole on the host, cut to the rank's block and
    dropped before the next."""
    state, step = ckpt_mod.restore(
        ckpt_dir, {"params": params, "opt": opt_state}, manifest=found[1],
        specs=specs, mesh=plan.mesh)
    return state["params"], state["opt"], step


def _write_stats(path: str, stats: dict, multi: bool) -> None:
    """Rank 0 writes every rank's stats (gathered over the group)."""
    import json
    if multi:
        import torch.distributed as dist
        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, stats)
        if dist.get_rank() != 0:
            return
    else:
        out = [stats]
    with open(path, "w") as f:
        json.dump({"ranks": out}, f)


if __name__ == "__main__":
    main()
