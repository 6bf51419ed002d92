"""Multi-pod dry-run, on PyTorch: count every (arch x input-shape x mesh)
cell of one rank on the meta device, over a fake process group of 256 or
512 ranks.

The JAX package lowers and compiles each cell for 512 forced host
devices and reads XLA's memory analysis and the compiled HLO.  Here one
process plays rank 0 of a ``fake`` process group of the mesh's size
(``torch.distributed``'s ``FakeStore``: no communication), builds the
production mesh over it (:func:`repro_torch.launch.mesh.make_production_mesh`),
and runs the rank's step on meta tensors at the local shapes of every
leaf's spec (:mod:`repro_torch.distributed.sharding`) under
:func:`repro_torch.core.counters.collect`.  Nothing is computed or
allocated; no card is needed.  For each cell this prints/records:

  * memory — the rank's argument bytes (exactly the sum of its blocks of
    params, optimizer state, batch and cache), the bytes it returns, and
    the counted peak of live bytes less the arguments as the temp size;
  * the census counters — per-rank flops, bytes, collective shard and
    ring-link bytes, per-region attribution, the collectives by kind;
  * roofline terms (:mod:`repro_torch.core.roofline`) + dominant term.

Every family runs its step over a mesh: the dense and VLM decoders,
the MoE decoders (experts split over ``model``; decode's one token group
spans every data rank, whose slots are offset by an all-gather of the
lower ranks' per-expert counts), whisper's encoder-decoder, rwkv6's
time-mix (its WKV scan head-replicated) and zamba2's mamba blocks (the
SSD scan on the rank's heads); decode cells run over the recurrent
caches (``s``, ``x_prev``, ``conv_x``, ``conv_bc``) at their specs'
local shapes, and the ``long_500k`` cells of rwkv6-3b and zamba2-2.7b
replicate their batch of one.  A scan's gradient is counted from a few
steps of its plain form (:func:`repro_torch.core.counters.count_steps`).
A cell that fails is recorded as an ``ok: false`` row with its error, as
the JAX sweep records a failure.  Results
append to ``experiments/dryrun_torch.jsonl`` (apart from the JAX
package's ``experiments/dryrun.jsonl``); completed cells are skipped
unless ``--force``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k --mesh both
  python -m repro_torch.launch.dryrun --all --mesh single
  python -m repro_torch.launch.dryrun --all --mesh multi --plan plans/tuned.json
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
from typing import Optional, Union

import torch

from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.configs.registry import ARCH_IDS, get_config, get_shape
from repro_torch.core import counters as counters_mod
from repro_torch.core import roofline as roofline_mod
from repro_torch.core.policy import (RegionPlan, default_microbatch,
                                     default_plan, mesh_shape)
from repro_torch.distributed import sharding as shard_mod
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import layers as L
from repro_torch.models import model as model_mod
from repro_torch.optim import adamw
from repro_torch.train import trainer

OUT_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                        "experiments", "dryrun_torch.jsonl")


@contextlib.contextmanager
def fake_world(n: int):
    """This process as rank 0 of a fake process group of ``n`` ranks,
    destroyed on the way out."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local(leaf, spec: tuple, mesh, dtype: Optional[torch.dtype] = None):
    """A meta tensor of one rank's block of ``leaf`` (a tensor or a
    ``TensorSpec``) under ``spec``."""
    shape = shard_mod.local_shape(tuple(leaf.shape), spec, mesh)
    return torch.empty(shape, dtype=dtype or leaf.dtype, device="meta")


def _map2(fn, a, b):
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in sorted(a)}
    return fn(a, b)


def build_step(arch_id: str, shape: Union[str, ShapeConfig], mesh,
               plan: Optional[RegionPlan] = None, microbatch: int = 0,
               unroll: bool = False):
    """The rank-local step selected by the shape's kind, and its meta
    arguments: (fn, args, {"cfg", "shape"}).  The counterpart of the JAX
    package's ``build_lowered``: params at the local shapes of
    ``param_shardings``; under train the ZeRO-1 moments and the batch
    (with whisper's ``frames`` and a VLM's ``vision_embeds``) at
    ``batch_shardings``; under decode the cache — K/V, recurrent state or
    both, and whisper's ``enc_out`` — at the local shapes of
    ``cache_shardings``."""
    cfg = get_config(arch_id)
    shape = get_shape(shape) if isinstance(shape, str) else shape
    if not cfg.supports_shape(shape):
        raise ValueError(f"{arch_id} skips {shape.name} (see DESIGN.md §7)")
    model = model_mod.build(cfg)
    if plan is None:
        plan = default_plan(mesh, shape.kind)
    plan.mesh = mesh
    if not microbatch:
        microbatch = default_microbatch(shape.kind, shape.global_batch,
                                        mesh_shape(mesh).get("data", 1))
    specs = model_mod.input_specs(cfg, shape)
    p_sh = shard_mod.param_shardings(model, plan)
    abstract = model.abstract_params()
    params = _map2(lambda a, sp: _local(a, sp, mesh), abstract, p_sh)
    b_sh = shard_mod.batch_shardings(plan, specs)
    batch = {k: _local(v, b_sh[k], mesh) for k, v in specs.items()}
    meta = {"cfg": cfg, "shape": shape}

    if shape.kind == "train":
        o_sh = shard_mod.opt_state_shardings(model, plan)
        step = trainer.make_train_step(model, plan, unroll=unroll,
                                       microbatch=microbatch,
                                       grad_shardings=p_sh,
                                       opt_shardings=o_sh["mu"])
        full = adamw.abstract_state(abstract)
        opt = {"step": full["step"],
               "mu": _map2(lambda a, sp: _local(a, sp, mesh), full["mu"],
                           o_sh["mu"]),
               "nu": _map2(lambda a, sp: _local(a, sp, mesh), full["nu"],
                           o_sh["nu"])}
        return step, (params, opt, batch), meta
    if shape.kind == "prefill":
        def prefill_fn(params, batch):
            return model.prefill(params, batch, plan, max_len=shape.seq_len)
        return prefill_fn, (params, batch), meta
    # the JAX package's decode cell holds one position for every row (its
    # cache's ``pos`` is a scalar); the port's slot cache keeps one a row,
    # so the cell passes the scalar and the step reads it for each row
    cache_spec = dict(model.cache_spec(shape.global_batch, shape.seq_len),
                      pos=L.TensorSpec((), torch.int32))
    c_sh = shard_mod.cache_shardings(plan, cache_spec)
    cache = _map2(lambda a, sp: _local(a, sp, mesh), cache_spec, c_sh)

    def decode_fn(params, cache, tokens):
        rows = dict(cache, pos=cache["pos"].expand(tokens.shape[0]))
        return model.decode(params, rows, tokens, plan)
    return decode_fn, (params, cache, batch["tokens"]), meta


def mesh_label(multi_pod: bool, mesh_dims=None) -> str:
    if mesh_dims:
        return "x".join(str(d) for d in mesh_dims)
    return "2x16x16" if multi_pod else "16x16"


def count_cell(arch_id: str, shape: Union[str, ShapeConfig],
               multi_pod: bool = False, plan_path: Optional[str] = None,
               microbatch: int = 0, unroll: bool = False, mesh_dims=None):
    """Count one cell over a fake world: the production mesh (16x16, or
    2x16x16 with ``multi_pod``), or a ``("data", "model")`` host mesh of
    ``mesh_dims``.  Returns (RegionCounters, meta, seconds, ranks)."""
    n = (math.prod(mesh_dims) if mesh_dims
         else (512 if multi_pod else 256))
    with fake_world(n):
        mesh = (make_host_mesh(*mesh_dims) if mesh_dims
                else make_production_mesh(multi_pod=multi_pod))
        plan = None
        if plan_path:
            with open(plan_path) as f:
                plan = RegionPlan.from_json(f.read(), mesh=mesh)
        t0 = time.time()
        fn, args, meta = build_step(arch_id, shape, mesh, plan, microbatch,
                                    unroll=unroll)
        rc = counters_mod.collect(fn, *args)
        return rc, meta, time.time() - t0, n


def run_cell(arch_id: str, shape_id: Union[str, ShapeConfig],
             multi_pod: bool, plan_path: Optional[str] = None,
             microbatch: int = 0, verbose: bool = True,
             unroll: bool = False, mesh_dims=None) -> dict:
    """One cell's row (the JAX row's keys, without ``xla_cost``,
    ``lower_s`` and ``compile_s``, with ``count_s``)."""
    rc, meta, count_s, n_chips = count_cell(
        arch_id, shape_id, multi_pod, plan_path, microbatch, unroll,
        mesh_dims)
    mem = {"argument_size_in_bytes": int(rc.argument_bytes),
           "output_size_in_bytes": int(rc.output_bytes),
           "temp_size_in_bytes": int(rc.peak_bytes - rc.argument_bytes),
           "generated_code_size_in_bytes": 0}
    mem["peak_bytes_per_device"] = int(rc.peak_bytes)
    rl = roofline_mod.from_counters(rc.total)
    cfg, shape = meta["cfg"], meta["shape"]
    mf = model_mod.model_flops(cfg, shape)
    flops_global = rc.total.flops * n_chips
    label = mesh_label(multi_pod, mesh_dims)
    row = {
        "arch": arch_id, "shape": shape.name, "mesh": label,
        "chips": n_chips, "kind": shape.kind,
        "plan": plan_path or "baseline",
        "microbatch": microbatch,
        "count_s": round(count_s, 2),
        "memory": mem,
        "census_flops_per_dev": rc.total.flops,
        "census_bytes_per_dev": rc.total.bytes,
        "census_collective_bytes_per_dev": rc.total.collective_bytes,
        "census_link_bytes_per_dev": rc.total.link_bytes,
        "collective_census": rc.collective_census,
        "roofline": rl.to_json(),
        "model_flops": mf,
        "useful_flops_ratio": (mf / flops_global) if flops_global else 0.0,
        "top_regions_flops": rc.top_regions("flops", 6),
        "top_regions_link_bytes": rc.top_regions("link_bytes", 6),
        "ok": True,
    }
    if verbose:
        print(f"[{arch_id} x {shape.name} x {label}] "
              f"count {count_s:.1f}s  "
              f"peak/dev {mem['peak_bytes_per_device']/2**30:.2f} GiB  "
              f"roofline: c={rl.compute_s*1e3:.2f}ms m={rl.memory_s*1e3:.2f}ms "
              f"coll={rl.collective_s*1e3:.2f}ms dom={rl.dominant} "
              f"frac={rl.fraction():.2f} useful={row['useful_flops_ratio']:.2f}")
        print("  memory:", {k: f"{v/2**30:.2f}GiB" for k, v in mem.items()
                            if k != "generated_code_size_in_bytes"})
        print("  collective schedule:", dict(rc.collective_census))
    return row


def _done_cells(path: str) -> set:
    done = set()
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    if r.get("ok"):
                        done.add((r["arch"], r["shape"], r["mesh"],
                                  r.get("plan", "baseline")))
                except json.JSONDecodeError:
                    pass
    return done


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--plan", default=None, help="RegionPlan json path")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--out", default=os.path.abspath(OUT_PATH))
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    cells = []
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    for a in archs:
        cfg = get_config(a)
        for s in shapes:
            if not cfg.supports_shape(get_shape(s)):
                print(f"SKIP {a} x {s}: long-context inapplicable "
                      f"(full attention)")
                continue
            for mp in meshes:
                cells.append((a, s, mp))

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    done = set() if args.force else _done_cells(args.out)
    plan_tag = args.plan or "baseline"
    failures = 0
    for a, s, mp in cells:
        key = (a, s, mesh_label(mp), plan_tag)
        if key in done:
            print(f"skip (done): {key}")
            continue
        try:
            row = run_cell(a, s, mp, args.plan, args.microbatch)
        except Exception as e:
            failures += 1
            row = {"arch": a, "shape": s, "mesh": mesh_label(mp),
                   "plan": plan_tag, "ok": False,
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
            print(f"FAIL [{a} x {s} x {row['mesh']}]: {row['error']}")
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
    print(f"dry-run sweep complete; failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
