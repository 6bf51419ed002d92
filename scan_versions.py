#!/usr/bin/env python3
"""Time an older ``linear_scan.cu`` against the package's scans on one
NVIDIA GPU, at the same inputs and in turns (old, new, new, old).

    git show 60c0707:src/repro_torch/kernels/csrc/linear_scan.cu \\
        > build/linear_scan_old.cu
    python3 scan_versions.py build/linear_scan_old.cu

times the chunk scans at (B, T, chunk) = SHAPES.  The older source must
have the earlier chunk launchers' interface, which takes one f32 scratch
tensor: ``wkv_chunk_launch(r, k, v, w, u, s0, out, s_out, scratch, B, H,
T, N, chunk, stream)`` and ``ssd_chunk_launch(x, b, c, dt, a, s0, y,
s_out, scratch, B, H, T, P, N, chunk, stream)``.

    git show 3e21b83:src/repro_torch/kernels/csrc/linear_scan.cu \\
        > build/linear_scan_fused_old.cu
    python3 scan_versions.py --fused build/linear_scan_fused_old.cu

times the fused scans at (B, T) = FUSED_SHAPES (the batch-1 re-advance,
decode at 8 slots, the verify block, a ragged prefill), through the
fused launchers, whose C interface every version shares:
``wkv_fused_launch(r, k, v, w, u, s0, out, s_out, B, H, T, N, stream)``
and ``ssd_fused_launch(x, b, c, dt, a, s0, y, s_out, B, H, T, P, N,
stream)``.  It also times the timer's floor (a do-nothing launch) and,
at each shape, one ``copy_`` of the entry state (the state's bytes alone,
read once and written once).

The older source is built with the package's nvcc flags into
``build/scan_versions/``.  The package's kernels run through
``repro_torch.kernels.linear_scan``.  Widths are ``chip_smoke.py``'s
(rwkv6-3b, zamba2-2.7b), inputs its ``scan_inputs`` and the timer its
``time_ms``.  Each version's output and final state are held against the
plain version (``ref.KERNEL_TOL``, f32); only the package's must agree.
Both versions' kernels are also timed one by one (torch.profiler's device
time of each CUDA kernel a call, after an L2 flush).
Prints the card line, one line per (kernel, shape) and a JSON summary,
also written to ``build/scan_versions.json``.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SHAPES = [(1, 512, 64), (1, 256, 64), (1, 512, 256), (8, 3, 3), (1, 64, 64)]
FUSED_SHAPES = [(1, 1, 0), (8, 1, 0), (8, 3, 0), (1, 300, 0)]


def build_old(src: Path) -> ctypes.CDLL:
    from repro_torch.kernels import cuda_build
    text = src.read_bytes()
    tag = hashlib.sha1(text + " ".join(cuda_build.NVCC_FLAGS).encode())
    out = ROOT / "build" / "scan_versions" / f"libold_{tag.hexdigest()[:12]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                               "-o", str(out), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # the chunk launchers as PRs 12-15 declared them (only the chunk mode
    # calls them), the fused ones as every version does
    lib.wkv_chunk_launch.argtypes = [ptr] * 9 + [i32] * 5 + [ptr]
    lib.ssd_chunk_launch.argtypes = [ptr] * 9 + [i32] * 6 + [ptr]
    lib.wkv_fused_launch.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
    lib.ssd_fused_launch.argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
    for fn in ("wkv_chunk_launch", "ssd_chunk_launch", "wkv_fused_launch",
               "ssd_fused_launch"):
        getattr(lib, fn).restype = i32
    return lib


def old_call(torch, lib, name, args, chunk):
    """The older kernel on kernel-layout ``args``: (out, final state)."""
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    if name == "wkv_fused":
        r, k, v, w, u, s0 = args

        def call():
            out, s_out = torch.empty_like(r), torch.empty_like(s0)
            rc = lib.wkv_fused_launch(*[t.data_ptr() for t in (
                r, k, v, w, u, s0, out, s_out)], *r.shape, stream())
            assert rc == 0, rc
            return out, s_out
    elif name == "ssd_fused":
        x, b, c, dt, a, s0 = args

        def call():
            y, s_out = torch.empty_like(x), torch.empty_like(s0)
            rc = lib.ssd_fused_launch(*[t.data_ptr() for t in (
                x, b, c, dt, a, s0, y, s_out)], *x.shape, b.shape[-1],
                stream())
            assert rc == 0, rc
            return y, s_out
    elif name == "wkv_chunk":
        r, k, v, w, u, s0 = args
        B, H, T, N = r.shape

        def call():
            out, s_out, scratch = (torch.empty_like(r), torch.empty_like(s0),
                                   torch.empty_like(r))
            rc = lib.wkv_chunk_launch(*[t.data_ptr() for t in (
                r, k, v, w, u, s0, out, s_out, scratch)], B, H, T, N, chunk,
                stream())
            assert rc == 0, rc
            return out, s_out
    else:
        x, b, c, dt, a, s0 = args
        B, H, T, P = x.shape

        def call():
            y, s_out, scratch = (torch.empty_like(x), torch.empty_like(s0),
                                 torch.empty_like(dt))
            rc = lib.ssd_chunk_launch(*[t.data_ptr() for t in (
                x, b, c, dt, a, s0, y, s_out, scratch)], B, H, T, P,
                b.shape[-1], chunk, stream())
            assert rc == 0, rc
            return y, s_out
    return call


def phase_times(torch, fn, calls: int = 20) -> dict:
    """Mean device time in ms of each CUDA kernel one call of ``fn``
    launches, by kernel name (torch.profiler over ``calls`` calls, each
    after an L2 flush)."""
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    times: dict = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and "fill" not in e.name.lower()):
            m = re.search(r"(\w+_kernel)", e.name)
            name = m.group(1) if m else e.name[:40]
            times[name] = times.get(name, 0.0) + e.device_time / 1e3 / calls
    return times


def main() -> int:
    import torch
    argv = sys.argv[1:]
    fused = argv[:1] == ["--fused"]
    if fused:
        argv = argv[1:]
    if not torch.cuda.is_available() or len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.kernels import ref
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(f"[card] {card}", flush=True)
    lib = build_old(Path(argv[0]))
    ls.build()
    summary = {"card": card, "rows": []}
    if fused:
        summary["timer_floor_ms"] = cs.timer_floor(torch)
    rows = summary["rows"]
    names, shapes = ((("wkv_fused", "ssd_fused"), FUSED_SHAPES) if fused
                     else (("wkv_chunk", "ssd_chunk"), SHAPES))
    for name in names:
        for i, (B, T, chunk) in enumerate(shapes):
            args = cs.scan_inputs(torch, name, 500 + i, B, T)
            old = old_call(torch, lib, name, args, chunk)
            new = cs.scan_kernel_call(name, args, chunk)
            want = cs.scan_plain_call(name, args, chunk)()
            errs = {}
            for label, fn in (("old", old), ("new", new)):
                got = fn()
                torch.cuda.synchronize()
                errs[label] = (max(float((g - w).abs().max())
                                   for g, w in zip(got, want)),
                               all(ref.within_tol(g, w, torch.float32)
                                   for g, w in zip(got, want)))
            cs.check(errs["new"][1], f"{name} {B, T, chunk}: the package's "
                                     f"kernel disagrees: {errs['new'][0]}")
            times = {"old": [], "new": []}
            for label in ("old", "new", "new", "old"):
                times[label].append(cs.time_ms(torch, old if label == "old"
                                               else new))
            bound, _ = cs.scan_work(torch, name, B, T)
            phases = phase_times(torch, new)
            old_phases = phase_times(torch, old)
            if fused:   # the state's bytes alone: one copy, read and write
                s_in = args[5]
                s_copy = torch.empty_like(s_in)
                copy = lambda: s_copy.copy_(s_in)  # noqa: E731
                copy_ms = cs.time_ms(torch, copy)
                phases["state copy"] = sum(phase_times(torch, copy).values())
            row = {"name": name, "B": B, "T": T, "chunk": chunk,
                   "old_ms": times["old"], "new_ms": times["new"],
                   "bound_ms": bound, "new_phase_ms": phases,
                   "old_phase_ms": old_phases,
                   "state_copy_ms": copy_ms if fused else None,
                   "kernels_per_call": ls.kernels_per_call(T, chunk),
                   "old_max_abs_err": errs["old"][0],
                   "old_within_tol": errs["old"][1],
                   "new_max_abs_err": errs["new"][0]}
            rows.append(row)
            copied = (f", state copy {copy_ms:.4f} ms" if fused else "")
            print(f"[versions] {name} B={B} T={T} chunk={chunk}: old "
                  f"{times['old'][0]:.4f}/{times['old'][1]:.4f} ms, new "
                  f"{times['new'][0]:.4f}/{times['new'][1]:.4f} ms, bound "
                  f"{bound:.5f} ms{copied}; max_abs_err old {errs['old'][0]:.2e} "
                  f"(within tol: {errs['old'][1]}) new {errs['new'][0]:.2e}; "
                  f"device time by kernel: new " + ", ".join(
                      f"{k} {v:.4f}" for k, v in phases.items())
                  + "; old " + ", ".join(
                      f"{k} {v:.4f}" for k, v in old_phases.items()),
                  flush=True)
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "scan_versions.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
