"""Hillclimb driver, on PyTorch: diagnose a dry-run cell in depth
(per-region bytes, the largest single collectives with their shapes) and
evaluate candidate plans, logging hypothesis -> change -> before -> after
rows to ``experiments/perf_log_torch.jsonl``.  The cells are counted as
:mod:`repro_torch.launch.dryrun` counts them, on the meta device over a
fake 16x16 world; the largest collectives come from the count's noted
collectives (``RegionCounters.collectives``), not from HLO text.

  python -m repro_torch.launch.hillclimb diagnose --arch stablelm-1.6b --shape train_4k
  python -m repro_torch.launch.hillclimb try --arch ... --shape ... --plan plans/x.json \\
      --hypothesis "..."
"""
from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch.core import roofline as roofline_mod
from repro_torch.launch.dryrun import count_cell

PERF_LOG = "experiments/perf_log_torch.jsonl"


def largest_collectives(rc, n: int = 12) -> list:
    """The ``n`` noted collectives with the most ring-link bytes: (link
    bytes, kind, shape, region, group size), largest first."""
    found = [(c["link_bytes"], c["kind"], tuple(c["shape"]), c["region"],
              c["group"]) for c in rc.collectives]
    found.sort(key=lambda t: (-t[0], t[1], t[3]))
    return found[:n]


def diagnose(arch: str, shape: str, plan_path=None, microbatch=0):
    rc, meta, count_s, _ = count_cell(arch, shape, False, plan_path,
                                      microbatch)
    rl = roofline_mod.from_counters(rc.total)
    print(f"== {arch} x {shape} ==")
    print(f"roofline: compute={rl.compute_s:.2f}s memory={rl.memory_s:.2f}s "
          f"collective={rl.collective_s:.2f}s dominant={rl.dominant}")
    print(f"memory: args={rc.argument_bytes/2**30:.1f}GiB "
          f"temp={(rc.peak_bytes - rc.argument_bytes)/2**30:.1f}GiB")
    print("\ntop regions by bytes:")
    for r, b in rc.top_regions("bytes", 10):
        c = rc.regions[r]
        print(f"  {r:28s} bytes={b:.3e} ({b/max(rc.total.bytes,1)*100:4.1f}%) "
              f"flops={c.flops:.2e} AI={c.flops/max(b,1):.1f}")
    print("\ntop regions by link bytes:")
    for r, b in rc.top_regions("link_bytes", 8):
        print(f"  {r:28s} link={b:.3e} ({b/max(rc.total.link_bytes,1)*100:4.1f}%)")
    print("\nlargest single collectives (per-device link bytes):")
    for link, op, shp, region, grp in largest_collectives(rc):
        print(f"  {op:18s} {link:.3e}B groups={grp:3d} region={region:24s} "
              f"{list(shp)}")
    return rc, rl


def try_plan(arch: str, shape: str, plan_path: str, hypothesis: str,
             microbatch=0, label=""):
    t0 = time.time()
    rc, meta, count_s, _ = count_cell(arch, shape, False, plan_path,
                                      microbatch)
    rl = roofline_mod.from_counters(rc.total)
    row = {
        "arch": arch, "shape": shape, "plan": plan_path, "label": label,
        "hypothesis": hypothesis, "count_s": round(time.time() - t0, 1),
        "roofline": rl.to_json(),
        "peak_gib": rc.peak_bytes / 2**30,
    }
    os.makedirs(os.path.dirname(PERF_LOG), exist_ok=True)
    with open(PERF_LOG, "a") as f:
        f.write(json.dumps(row) + "\n")
    print(json.dumps(row, indent=2))
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("cmd", choices=["diagnose", "try"])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--plan", default=None)
    ap.add_argument("--hypothesis", default="")
    ap.add_argument("--label", default="")
    ap.add_argument("--microbatch", type=int, default=0)
    args = ap.parse_args(argv)
    if args.cmd == "diagnose":
        diagnose(args.arch, args.shape, args.plan, args.microbatch)
    else:
        try_plan(args.arch, args.shape, args.plan, args.hypothesis,
                 args.microbatch, args.label)


if __name__ == "__main__":
    main()
