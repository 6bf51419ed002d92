"""End-to-end training launcher on PyTorch.

Reduced configs by default (``--full`` for the published widths), on
``--device`` (default ``cuda``; ``--device cpu`` runs on the CPU, nothing
else does).  Handles checkpoint/restart (``--resume``), straggler
telemetry and plan files from the autotuner.  The port trains on one
device, and there — as the JAX launcher does on one device — any plan,
a ``--plan`` file included, is replaced by ``null_plan()``: the launcher
never remats.  Every family trains: the VLM and the encoder-decoder on
zero vision embeddings and zero frames (the stubbed frontends, as the
JAX launcher feeds them, in the params' dtype), rwkv6 and zamba2 through
the scan kernels' gradient (:func:`repro_torch.kernels.ops.wkv` /
``ssd``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \\
      --steps 50 --batch 8 --seq 128 --ckpt-dir run1

  # the CPU, reduced, f32
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --dtype float32 --steps 12 --batch 2 --seq 32

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
from repro_torch.core.policy import RegionPlan, null_plan
from repro_torch.data.pipeline import DataConfig, Prefetcher, iterate
from repro_torch.models import model as model_mod
from repro_torch.optim import adamw
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import trainer
from repro_torch.train.elastic import StepWatchdog


def main(argv=None):
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
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = model_mod.build(cfg)

    if args.plan:   # read, as the JAX launcher does, then replaced:
        with open(args.plan) as f:
            RegionPlan.from_json(f.read())
    plan = null_plan()   # on one device any plan is the null plan

    params = model.init(args.seed, dtype=getattr(torch, args.dtype),
                        device=dev)
    opt_state = adamw.init_state(params)
    start_step = 0

    if args.resume and args.ckpt_dir:
        found = ckpt_mod.latest_valid(args.ckpt_dir)
        if found:
            state, start_step = ckpt_mod.restore(
                args.ckpt_dir, {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            print(f"resumed from step {start_step}")

    opt_cfg = adamw.AdamWConfig(lr=args.lr)
    step_fn = trainer.make_train_step(
        model, plan, opt_cfg=opt_cfg, unroll=False,
        microbatch=args.microbatch, schedule_total=args.steps)

    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch, seed=args.seed)
    data = Prefetcher(iterate(data_cfg, start_step, device="cpu"),
                      device=dev)
    watchdog = StepWatchdog()

    t_start = time.time()
    metrics = None
    dtype = getattr(torch, args.dtype)
    for step in range(start_step, args.steps):
        batch = next(data)
        if cfg.family == "encdec":
            batch = dict(batch, frames=torch.zeros(
                (args.batch, cfg.enc_len, cfg.d_model), dtype=dtype,
                device=dev))
        if cfg.frontend == "vision_patches":
            batch = dict(batch, vision_embeds=torch.zeros(
                (args.batch, 8, cfg.d_model), dtype=dtype, device=dev))
        watchdog.start()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        straggler = watchdog.stop(step)
        if straggler:
            print(f"[watchdog] step {step} flagged as straggler")
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {metrics['loss'].item():.4f} "
                  f"gnorm {metrics['grad_norm'].item():.3f} "
                  f"lr {metrics['lr'].item():.2e}")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt_mod.save(args.ckpt_dir, step + 1,
                          {"params": params, "opt": opt_state},
                          meta={"arch": cfg.name})
        if args.fail_at_step and step + 1 == args.fail_at_step:
            print(f"simulating node failure at step {step + 1}")
            raise SystemExit(42)
    loss = float(metrics["loss"]) if metrics else float("nan")
    dt = time.time() - t_start
    tok = (args.steps - start_step) * args.batch * args.seq
    print(f"done: {dt:.1f}s, {tok/dt:.0f} tok/s, final loss {loss:.4f}")
    return loss


if __name__ == "__main__":
    main()
