"""The dry-run tables from the port's ``experiments/dryrun_torch.jsonl``
(:mod:`repro_torch.launch.dryrun`): a summary, the roofline table of one
mesh and plan, and the hillclimb candidates — the JAX package's
``launch/report.py`` over the port's rows.  Whether a cell fits is read
against the card's memory from its data sheet (``roofline.Card``, the
SXM part unless the caller names another), not the TPU's 16 GiB.

  python -m repro_torch.launch.report [--path experiments/dryrun_torch.jsonl]
"""
from __future__ import annotations

import argparse
import json
from collections import defaultdict

from repro_torch.core import roofline


def load(path: str) -> list[dict]:
    rows = []
    with open(path) as f:
        for line in f:
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                pass
    # last result per cell wins
    dedup = {}
    for r in rows:
        dedup[(r["arch"], r["shape"], r["mesh"], r.get("plan", "baseline"))] = r
    return list(dedup.values())


def roofline_table(rows: list[dict], mesh: str = "16x16",
                   plan: str = "baseline") -> str:
    out = ["| arch | shape | kind | compute_s | memory_s | collective_s | "
           "dominant | frac | useful | peak GiB |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    sel = sorted((r for r in rows if r.get("ok") and r["mesh"] == mesh
                  and r.get("plan", "baseline") == plan),
                 key=lambda r: (r["arch"], r["shape"]))
    for r in sel:
        rl = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['kind']} "
            f"| {rl['compute_s']:.3f} | {rl['memory_s']:.3f} "
            f"| {rl['collective_s']:.3f} | **{rl['dominant']}** "
            f"| {rl['fraction']:.3f} | {r['useful_flops_ratio']:.2f} "
            f"| {r['memory']['peak_bytes_per_device']/2**30:.1f} |")
    return "\n".join(out)


def dryrun_summary(rows: list[dict],
                   card: roofline.Card = roofline.H100_SXM) -> str:
    ok = [r for r in rows if r.get("ok")]
    bad = [r for r in rows if not r.get("ok")]
    by_mesh = defaultdict(int)
    for r in ok:
        by_mesh[r["mesh"]] += 1
    lines = [f"- counted cells: {len(ok)} "
             f"({dict(by_mesh)}); failures: {len(bad)}"]
    for r in bad:
        lines.append(f"  - FAIL {r['arch']} x {r['shape']} x {r['mesh']}: "
                     f"{r.get('error', '')[:160]}")
    fits = [r for r in ok
            if r["memory"]["peak_bytes_per_device"] <= card.hbm_bytes]
    lines.append(f"- cells fitting {card.hbm_bytes / 1e9:.0f} GB/card "
                 f"({card.name}): {len(fits)}/{len(ok)}")
    worst = sorted(ok, key=lambda r: -r["memory"]["peak_bytes_per_device"])[:5]
    lines.append("- largest peak/device: " + ", ".join(
        f"{r['arch']}/{r['shape']}/{r['mesh']}="
        f"{r['memory']['peak_bytes_per_device']/2**30:.1f}GiB" for r in worst))
    return "\n".join(lines)


def pick_hillclimb(rows: list[dict]) -> str:
    """The three §Perf cells: worst fraction, most collective-bound, most
    paper-representative."""
    ok = [r for r in rows if r.get("ok") and r["mesh"] == "16x16"
          and r.get("plan", "baseline") == "baseline"]
    if not ok:
        return "(no data)"
    worst = min(ok, key=lambda r: r["roofline"]["fraction"])
    coll = max(ok, key=lambda r: r["roofline"]["collective_s"]
               / max(r["roofline"]["bound_s"], 1e-12))
    return (f"- worst roofline fraction: {worst['arch']} x {worst['shape']} "
            f"(frac={worst['roofline']['fraction']:.3f})\n"
            f"- most collective-bound: {coll['arch']} x {coll['shape']} "
            f"(coll={coll['roofline']['collective_s']:.2f}s of "
            f"bound={coll['roofline']['bound_s']:.2f}s)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", default="experiments/dryrun_torch.jsonl")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--plan", default="baseline")
    args = ap.parse_args(argv)
    rows = load(args.path)
    print("## Summary\n")
    print(dryrun_summary(rows))
    print(f"\n## Roofline ({args.mesh}, {args.plan})\n")
    print(roofline_table(rows, args.mesh, args.plan))
    print("\n## Hillclimb candidates\n")
    print(pick_hillclimb(rows))


if __name__ == "__main__":
    main()
