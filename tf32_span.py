#!/usr/bin/env python3
"""The 3xTF32 f32 matrix product (``tf32_span.cu``) against the gate that
the f32 ``tuned_matmul`` kernel is held to, on one NVIDIA GPU: how long a K
span the tensor cores may sum before their sum must go to a
round-to-nearest f32 add, and whether any span meets ``ref.KERNEL_TOL`` of
the plain f32 product.

    python3 tf32_span.py

builds ``tf32_span.cu`` once per span in SPANS (``-DTM_F32_SPAN=N``: each
fresh register tile sums N of K, three TF32 products a step of 8) and once
as a single TF32 pass (``-DTM_F32_PASSES=1``, span 8), with the package's
nvcc flags, into ``build/tf32_span/``.  Each build runs the f32 product at
``chip_smoke.MATMUL_TIMED`` (2048 x 2048 @ 2048 x 5632, std 0.5) at the
tiles (128, 128) on DRAWS seeds, and counts the outputs
outside ``ref.KERNEL_TOL`` (f32: 1e-5 + 1e-5 x |plain|) of the plain
version (``ref.matmul``, ``torch.matmul`` in f32 with TF32 off) and of the
exact product (summed in f64), beside ``torch.matmul`` f32's own count
against the exact product.  Each build is also timed (``chip_smoke.time_ms``,
L2 flushed).  Prints the card line, one line per build and draw, and a
JSON summary, also written to ``build/tf32_span.json``.  The package's
kernel (the CUDA cores' f32 FMA chain, ``chip_smoke.py --dense``) is held
to the same gate.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SPANS = (8, 16, 32, 64, 128)
DRAWS = (0, 1, 2)


def build(defines) -> ctypes.CDLL:
    from repro_torch.kernels import cuda_build
    src = ROOT / "tf32_span.cu"
    flags = [*cuda_build.NVCC_FLAGS, *defines]
    tag = hashlib.sha1(src.read_bytes() + " ".join(flags).encode())
    out = ROOT / "build" / "tf32_span" / f"lib_{tag.hexdigest()[:12]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([cuda_build.nvcc_path(), *flags, "-o",
                               str(out), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {defines}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.tf32_matmul_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.tf32_matmul_launch.restype = ctypes.c_int
    return lib


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("tf32_span: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.kernels import ref
    from concurrent.futures import ThreadPoolExecutor

    builds = {f"span {s}": [f"-DTM_F32_SPAN={s}"] for s in SPANS}
    builds["one pass, span 8"] = ["-DTM_F32_PASSES=1", "-DTM_F32_SPAN=8"]
    with ThreadPoolExecutor(len(builds)) as ex:
        libs = dict(zip(builds, ex.map(build, builds.values())))
    print(cs.card_line(), flush=True)
    M, K, N = cs.MATMUL_TIMED
    f32 = torch.float32
    summary = {}
    for draw in DRAWS:
        rng = np.random.default_rng(draw)
        x = cs._randn(torch, rng, (M, K), 0.5, f32)
        y = cs._randn(torch, rng, (K, N), 0.5, f32)
        plain = ref.matmul(x, y)
        exact = torch.matmul(x.double(), y.double()).float()
        lib_out = cs._outside(plain, exact, f32)
        print(f"[span] draw {draw}: torch.matmul f32 outside the tolerance "
              f"of the exact product: {lib_out} of {plain.numel()}",
              flush=True)
        for name, lib in libs.items():
            out = torch.empty((M, N), dtype=f32, device="cuda")

            def call():
                rc = lib.tf32_matmul_launch(
                    x.data_ptr(), y.data_ptr(), out.data_ptr(), M, N, K,
                    torch.cuda.current_stream().cuda_stream)
                assert rc == 0, rc
            call()
            torch.cuda.synchronize()
            row = summary.setdefault(name, {"outside_plain": [],
                                            "outside_exact": [],
                                            "max_abs_err": [], "ms": []})
            row["outside_plain"].append(cs._outside(out, plain, f32))
            row["outside_exact"].append(cs._outside(out, exact, f32))
            row["max_abs_err"].append(float((out - plain).abs().max()))
            if draw == DRAWS[0]:
                row["ms"].append(cs.time_ms(torch, call, iters=10))
            print(f"[span] {name} draw {draw}: outside against the plain "
                  f"version {row['outside_plain'][-1]}, against the exact "
                  f"product {row['outside_exact'][-1]}, max_abs_err "
                  f"{row['max_abs_err'][-1]:.3e}"
                  + (f", {row['ms'][-1]:.4f} ms" if draw == DRAWS[0] else ""),
                  flush=True)
        summary.setdefault("torch.matmul f32", {"outside_exact": []})[
            "outside_exact"].append(lib_out)
        del x, y, plain, exact
    text = json.dumps(summary)
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "tf32_span.json").write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
