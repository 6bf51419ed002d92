"""End-to-end example on the PyTorch port: train a ~100M-param dense LM for
a few hundred steps on synthetic Markov data, with checkpointing and
straggler telemetry — ``examples/train_100m.py`` on ``repro_torch``'s
trainer, data pipeline, checkpoint and watchdog.

Default invocation uses a ~25M model; pass --hundred-m for the full ~100M
run (same code path).  Runs on ``--device`` (default ``cuda``).

  PYTHONPATH=src python examples/train_100m_torch.py --steps 300
  PYTHONPATH=src python examples/train_100m_torch.py --device cpu --steps 3
"""
import argparse
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.data.pipeline import DataConfig, Prefetcher, iterate  # noqa: E402
from repro_torch.models.model import build, count_params  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import checkpoint as ck  # noqa: E402
from repro_torch.train import trainer  # noqa: E402
from repro_torch.train.elastic import StepWatchdog  # noqa: E402


def make_cfg(hundred_m: bool) -> ArchConfig:
    if hundred_m:  # ~100M params
        return ArchConfig(name="lm-100m", family="dense", n_layers=12,
                          d_model=768, n_heads=12, n_kv_heads=12, d_ff=2048,
                          vocab_size=32_000, glu=True)
    return ArchConfig(name="lm-25m", family="dense", n_layers=8,
                      d_model=384, n_heads=6, n_kv_heads=6, d_ff=1024,
                      vocab_size=8_192, glu=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--hundred-m", action="store_true")
    ap.add_argument("--ckpt-dir",
                    default=str(ROOT / "build" / "train_100m_torch_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda unless asked)")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = make_cfg(args.hundred_m)
    model = build(cfg)
    print(f"{cfg.name}: {count_params(cfg)/1e6:.1f}M params [{dev}]")
    params = model.init(0, dtype=torch.bfloat16, device=dev)
    opt = adamw.init_state(params)
    step = trainer.make_train_step(
        model, unroll=False, opt_cfg=adamw.AdamWConfig(lr=6e-4),
        schedule_total=args.steps)

    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch, seed=0)
    data = Prefetcher(iterate(data_cfg, device="cpu"), device=dev)
    watchdog = StepWatchdog()
    t0 = time.time()
    for s in range(args.steps):
        batch = next(data)
        watchdog.start()
        params, opt, m = step(params, opt, batch)
        watchdog.stop(s)
        if s % 20 == 0 or s == args.steps - 1:
            print(f"step {s:4d} loss {m['loss'].item():.4f} "
                  f"lr {m['lr'].item():.2e}")
        if (s + 1) % 100 == 0:
            ck.save(args.ckpt_dir, s + 1, {"params": params, "opt": opt})
    dt = time.time() - t0
    print(f"finished {args.steps} steps in {dt:.0f}s "
          f"({args.steps*args.batch*args.seq/dt:.0f} tok/s); "
          f"stragglers flagged: {len(watchdog.flagged)}")


if __name__ == "__main__":
    main()
