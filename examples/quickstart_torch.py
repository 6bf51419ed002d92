"""Quickstart on the PyTorch port: the paper's loop in 60 lines —
``examples/quickstart.py`` on ``repro_torch``.

Builds a small model, lets the region system instrument it automatically,
collects per-region counters from a count of the step on the meta device
(the JAX package reads them from the compiled artifact; here nothing runs
on the card), and shows the counter features the tuner decides from.

  PYTHONPATH=src python examples/quickstart_torch.py
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch import make_generator, resolve_device  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import counters  # noqa: E402
from repro_torch.core.dtree import features  # noqa: E402
from repro_torch.core.regions import discover_regions  # noqa: E402
from repro_torch.models.model import build  # noqa: E402

ARCH = "qwen3-8b"
FEATURES = ("log_flops", "log_bytes", "log_coll", "log_link", "AI",
            "coll_frac", "ops")


def make_batch(cfg, device) -> dict:
    """A (2, 64) int32 token batch from a generator seeded 1."""
    return {"tokens": torch.randint(0, cfg.vocab_size, (2, 64),
                                    generator=make_generator(device, 1),
                                    device=device, dtype=torch.int32)}


def instrument(model, params, device) -> set:
    """2. instrumentation is automatic: every module enters a named
    region.  The forward runs on the meta device (nothing computed)."""
    batch = make_batch(model.cfg, device)
    regions = discover_regions(lambda p, b: model.forward(p, b), params,
                               batch)
    print(f"instrumented {len(regions)} regions, e.g. "
          f"{sorted(regions)[:4]} ...")
    return regions


def profile(model, params, device) -> counters.RegionCounters:
    """3. profile: per-region counters of the step (libhpm analog),
    counted op by op on the meta device."""
    batch = make_batch(model.cfg, device)
    fwd = lambda p, b: model.forward(p, b)[0].float().mean()  # noqa: E731
    rc = counters.collect(fwd, params, batch)
    print("\nper-region counters (top by flops):")
    for name, flops in rc.top_regions("flops", 5):
        c = rc.regions[name]
        print(f"  {name:24s} flops={flops:.3e} bytes={c.bytes:.3e} "
              f"AI={flops/max(c.bytes,1):.1f}")
    return rc


def decide(rc: counters.RegionCounters) -> dict:
    """4. decide: the same counters feed the decision tree / tuner."""
    hot = rc.top_regions("flops", 1)[0][0]
    feat = dict(zip(FEATURES, [round(float(v), 2)
                               for v in features(rc.regions[hot])]))
    print("\ncounter feature vector for the hottest region:")
    print(" ", feat)
    return feat


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device the weights live on (cuda unless "
                         "asked)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. build a model from the assigned-architecture registry (reduced)
    model = build(get_config(ARCH).reduced())
    params = model.init(0, dtype=torch.bfloat16, device=dev)
    instrument(model, params, dev)
    decide(profile(model, params, dev))
    print("\n(for the full search loop see "
          "examples/autotune_regions_torch.py)")


if __name__ == "__main__":
    main()
