#!/usr/bin/env python3
"""Step 0's gradient of the sharded trainer against one rank's, leaf by
leaf, on the launcher's first batch.

    PYTHONPATH=src python3 sharded_grads.py --arch whisper-large-v3 \\
        --dtype float32 --batch 1 --seq 128 [--fan-in]

This process first computes the loss and the gradient on one rank under
``null_plan()`` (what ``launch.train`` does on one rank), then runs as
rank 0 of two ranks on (data 1, model 2) (gloo where they share a card),
each computing the same under ``default_plan(mesh, "train")`` on its
blocks (``elastic.reshard``) and its rows, and reducing its gradient as
the sharded step does (``trainer._GradSync``).  A leaf's norm is taken
over its blocks as ``adamw.global_norm`` takes the whole one.  The last
line printed is one JSON object: both losses and global norms, and each
leaf's two norms, worst ratio first.  A leaf that got ``1/model`` or
``model`` times its gradient stands out at a ratio of 0.5 or 2; rounding
moves every leaf a little.

The weights are the package's init from seed 0 (a layer-stacked
leaf's scale divides by its layer count, so at full depth the weights
are several times larger than their fan-in asks), or with ``--fan-in``
drawn at each matrix's own fan-in (a stacked leaf's second dim, an
expert leaf's (L, E, d, f) third), from a generator seeded the same on
every rank.  An MoE model's experts split over ``model`` (granite-moe-1b-a400m:
16 of 32 a rank at full width), its aux loss that of the whole batch;
both aux losses are printed.  ``--reduced`` takes the
reduced config.  Frames and vision embeddings are zeros, as the
launcher feeds them.  Runs on ``--device`` (``cuda`` unless asked).
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

SEED = 0          # the launcher's default
MESH = (1, 2)     # (data, model)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="whisper-large-v3")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="float32")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--fan-in", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _model(args):
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import build
    cfg = get_config(args.arch)
    return build(cfg.reduced() if args.reduced else cfg)


def _params(model, args, dev):
    import torch
    dtype = getattr(torch, args.dtype)
    if not args.fan_in:
        return model.init(SEED, dtype=dtype, device=dev)
    from chip_smoke import fan_in_params
    return fan_in_params(model, SEED, dtype, dev)


def _batch(model, args, dev):
    import torch

    from repro_torch.data.pipeline import DataConfig, batch_at
    cfg = model.cfg
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch, seed=SEED)
    batch = dict(batch_at(dc, 0, "cpu"))
    dtype = getattr(torch, args.dtype)
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros((args.batch, cfg.enc_len, cfg.d_model),
                                      dtype=dtype)
    if cfg.frontend == "vision_patches":
        batch["vision_embeds"] = torch.zeros((args.batch, 8, cfg.d_model),
                                             dtype=dtype)
    return batch


def _names(tree, prefix=""):
    out = []
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out += _names(tree[k], prefix + k + "/")
        else:
            out.append(prefix + k)
    return out


def one_rank(args, dev) -> dict:
    """Loss, global norm and leaf norms on one rank, null plan."""
    import torch

    from repro_torch.core.policy import null_plan
    from repro_torch.models import layers as L
    from repro_torch.train import trainer
    model = _model(args)
    params = _params(model, args, dev)
    batch = {k: v.to(dev) for k, v in _batch(model, args, dev).items()}
    (loss, metrics), grads = trainer.make_grad_fn(model, null_plan())(
        params, batch)
    norms = [float(torch.linalg.vector_norm(g.double()))
             for g in L.tree_leaves(grads)]
    return {"loss": float(loss), "aux": float(metrics["aux"]),
            "leaves": dict(zip(_names(grads), norms))}


def sharded(args, dev) -> dict:
    """This rank's view of the same on the mesh: loss averaged over the
    batch axes, each leaf's norm over its blocks."""
    import torch

    from repro_torch.core.policy import default_plan
    from repro_torch.distributed import comm
    from repro_torch.distributed import sharding as shard_mod
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L
    from repro_torch.train import elastic, trainer
    model = _model(args)
    mesh = make_host_mesh(*MESH)
    plan = default_plan(mesh, "train")
    full = _params(model, args, dev)
    params = elastic.reshard(full, model.logical_axes(), plan, device=dev)
    del full
    batch = _batch(model, args, dev)
    coords = shard_mod.mesh_coords(mesh)
    b_specs = shard_mod.batch_shardings(
        plan, {k: tuple(v.shape) for k, v in batch.items()})
    batch = {k: shard_mod.shard_leaf(v, b_specs[k], mesh, coords).to(dev)
             for k, v in batch.items()}
    p_sh = shard_mod.param_shardings(model, plan)
    o_sh = shard_mod.opt_state_shardings(model, plan)
    sync = trainer._GradSync(model, plan, p_sh, o_sh["mu"])
    (loss, metrics), grads = trainer.make_grad_fn(model, plan)(params,
                                                               batch)
    loss, metrics = sync.mean_metrics(loss, metrics)
    norms = []
    for g, z, axes in zip(L.tree_leaves(grads), sync.zdims, sync.split):
        sq = sync._reduce(g, z).double().square().sum()
        for a in axes:
            sq = comm.all_reduce(sq, mesh, a)
        norms.append(float(torch.sqrt(sq)))
    return {"loss": float(loss), "aux": float(metrics["aux"]),
            "leaves": dict(zip(_names(grads), norms))}


def _rank_main(rank, world, port, backend, device, argv):
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import rank_device, worker_store
    dev = rank_device(torch.device(device), rank, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = worker_store(rank, world, port)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)
    got = sharded(parse_args(argv), dev)
    dist.all_gather_object([None] * world, got)
    dist.destroy_process_group()


def main(argv=None) -> int:
    import torch
    import torch.distributed as dist

    from repro_torch import resolve_device
    from repro_torch.launch.mesh import backend_for, rank_device, start_ranks
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    one = one_rank(args, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    world = MESH[0] * MESH[1]
    backend = backend_for(dev, world)
    store, procs = start_ranks(world, _rank_main,
                               (backend, str(dev), argv))
    dist.init_process_group(backend, store=store, rank=0, world_size=world)
    try:
        mine = sharded(args, rank_device(dev, 0, backend))
        ranks = [None] * world
        dist.all_gather_object(ranks, mine)
    finally:
        dist.destroy_process_group()
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.terminate()
    if any(p.exitcode != 0 for p in procs):
        print(f"ranks failed: {[p.exitcode for p in procs]}", file=sys.stderr)
        return 1
    two = ranks[0]
    rows = sorted(((two["leaves"][k] / one["leaves"][k]
                    if one["leaves"][k] else float("nan"), k,
                    one["leaves"][k], two["leaves"][k])
                   for k in one["leaves"]),
                  key=lambda r: -abs(math.log(r[0])) if r[0] > 0 else 0.0)
    norm = {name: math.sqrt(sum(v * v for v in run["leaves"].values()))
            for name, run in (("one", one), ("two", two))}
    print(json.dumps({
        "arch": args.arch, "dtype": args.dtype, "fan_in": args.fan_in,
        "mesh": list(MESH),
        "loss": {"one": one["loss"], "two": [r["loss"] for r in ranks]},
        "aux": {"one": one["aux"], "two": [r["aux"] for r in ranks]},
        "grad_norm": norm,
        "same_on_every_rank": all(r == two for r in ranks),
        "leaves": [{"leaf": k, "ratio": r, "one": a, "two": b}
                   for r, k, a, b in rows]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
