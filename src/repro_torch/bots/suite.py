"""BOTS-analog suite: run each workload at the paper's parallelism
degrees, measure walltime + collect counters, and emit the decision-tree
training corpus (counters -> best degree class), reproducing the paper's
"gather counters for different types of applications" methodology.
"""
from __future__ import annotations

import importlib
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import counters as counters_mod
from repro_torch.core.dtree import DecisionTree, features

# paper Table 1 used 1 / 32 / 64 / 128 threads on 32 cores; we sweep the
# same oversubscription RATIOS (1x, 1x cores, 2x, 4x)
DEGREES = (1, 4, 8, 16)

WORKLOADS = ("strassen", "nqueens", "sparselu", "health", "floorplan")


def get_builder(name: str) -> Callable:
    return importlib.import_module(f"repro_torch.bots.{name}").build


def _result(out):
    """``out`` (a tensor or a tuple of them) as Python numbers when its
    first tensor has under 10 elements, else None."""
    if isinstance(out, tuple):
        return tuple(t.tolist() for t in out) if out[0].numel() < 10 else None
    return out.tolist() if out.numel() < 10 else None


def time_workload(name: str, degree: int, repeats: int = 3,
                  **size_kw) -> dict:
    """One warm call of the workload's ``fn``, then ``repeats`` timed calls
    on the same args (median wall), and its counters counted on the meta
    device.  ``size_kw`` goes to the workload's ``build`` (``device``
    included).  On ``cuda`` each timed call is also timed by CUDA events
    around it (``device_s``, the median)."""
    fn, args = get_builder(name)(degree=degree, **size_kw)
    cuda = args[0].device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    out = fn(*args)
    sync()  # warm: first launches, CUDA graph capture
    times, device_times = [], []
    for _ in range(repeats):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        out = fn(*args)
        if cuda:
            end.record()
        sync()
        times.append(time.perf_counter() - t0)
        if cuda:
            device_times.append(start.elapsed_time(end) / 1e3)
    rc = counters_mod.collect(fn, *args)
    row = {
        "workload": name, "degree": degree,
        "wall_s": float(np.median(times)),
        "counters": rc.total,
        "result": _result(out),
    }
    if cuda:
        row["device_s"] = float(np.median(device_times))
    return row


def sweep(workloads=WORKLOADS, degrees=DEGREES, repeats: int = 3,
          verbose: bool = True) -> list:
    rows = []
    for w in workloads:
        for d in degrees:
            try:
                row = time_workload(w, d, repeats)
            except Exception as e:
                row = {"workload": w, "degree": d, "error": str(e)}
            rows.append(row)
            if verbose and "wall_s" in row:
                print(f"{w:10s} degree={d:4d}  {row['wall_s']*1e3:8.2f} ms")
    return rows


def training_corpus(rows: list):
    """(features of degree-1 counters) -> best-degree class, per workload."""
    X, y = [], []
    for w in {r["workload"] for r in rows if "wall_s" in r}:
        wrows = [r for r in rows if r["workload"] == w and "wall_s" in r]
        base = next((r for r in wrows if r["degree"] == min(DEGREES)), None)
        best = min(wrows, key=lambda r: r["wall_s"])
        if base is None:
            continue
        X.append(features(base["counters"]))
        y.append(f"degree_{best['degree']}")
    return np.stack(X), y


def train_tree(rows: list) -> Optional[DecisionTree]:
    X, y = training_corpus(rows)
    if len(y) < 2:
        return None
    return DecisionTree(max_depth=4).fit(X, y)
