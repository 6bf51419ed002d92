"""Batched serving on the PyTorch port — ``examples/serve_batched.py`` on
``repro_torch``: prefill + KV-cache decode on three model families (dense
GQA, sliding-window, attention-free RNN) through one Engine API — each
family gets a different cache layout automatically — then the same dense
model served with continuous batching: staggered arrivals and mixed
generation lengths share one fixed-shape decode step over a paged KV pool
(block tables into a global page pool; prompts prefill in chunks
interleaved with decode steps), with requests joining mid-flight as others
finish; then overcommit on a deliberately tight pool.

On ``cuda`` the RNN's scans run the hand-written kernels
(``kernels/csrc/linear_scan.cu``); the launches by kernel are printed
after each section.

  PYTHONPATH=src python examples/serve_batched_torch.py
  PYTHONPATH=src python examples/serve_batched_torch.py --device cpu
"""
import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import make_generator, resolve_device  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402
from repro_torch.serve.scheduler import Request  # noqa: E402

LOCKSTEP_ARCHS = ("qwen3-8b", "h2o-danube-1.8b", "rwkv6-3b")
DENSE_ARCH = "qwen3-8b"
CONTINUOUS_CFG = dict(max_len=64, max_slots=3, prefill_bucket=8)
# Full reservation would fit only 2 of these decode-heavy requests into 14
# allocatable pages; lazy admission starts each with its prompt pages + one
# decode page, grows at page boundaries, and when the free list runs dry the
# governor preempts the youngest decode — it re-enters as recompute-prefill
# over prompt + generated-so-far, so every token stream is exactly what an
# uncontended pool would have produced.
OVERCOMMIT_CFG = dict(max_len=32, max_slots=4, page_size=4, kv_pages=15,
                      reservation="lazy", mem_watermark=0.0)


def print_launches(section: str) -> dict:
    """The kernel launches so far, by kernel (nonzero only)."""
    got = {k: n for k, n in sorted(LAUNCHES.items()) if n}
    print(f"  [launches] after {section}: {got}")
    return got


def lockstep(model, params, device, temperature: float = 0.8,
             prompts=None) -> dict:
    """Static lockstep batching: one batched prefill, then 16 decode steps
    of every row.  ``prompts``: (4, 32) int32, drawn from a generator
    seeded 1 when not given."""
    cfg = model.cfg
    engine = Engine(model, params, device=device, serve_cfg=ServeConfig(
        max_len=96, temperature=temperature, seed=0))
    if prompts is None:
        prompts = torch.randint(0, cfg.vocab_size, (4, 32),
                                generator=make_generator(device, 1),
                                device=device, dtype=torch.int32)
    out = engine.generate(prompts, 16)
    cache_kind = ("O(1) state" if cfg.family == "ssm" else
                  f"ring[{cfg.swa_window}]" if cfg.swa_window else "full KV")
    arch = cfg.name.removesuffix("-reduced")
    print(f"{arch:18s} [{cache_kind:12s}] generated "
          f"{tuple(out['tokens'].shape)} "
          f"prefill {out['prefill_s']*1e3:6.1f} ms  "
          f"decode {out['decode_tok_per_s']:7.0f} tok/s")
    return out


def continuous_requests(rng: np.random.Generator, vocab: int,
                        gap_s: float = 0.02, cls=Request) -> list:
    """8 requests of 12-token prompts and 4-16 new tokens, arriving every
    ``gap_s`` seconds (``cls`` builds each: the JAX package's ``Request``
    takes the same fields)."""
    return [cls(rid=i, prompt=rng.integers(0, vocab, 12).astype(np.int32),
                max_new_tokens=int(rng.integers(4, 17)),
                arrival_s=gap_s * i)
            for i in range(8)]


def overcommit_requests(rng: np.random.Generator, vocab: int,
                        cls=Request) -> list:
    """6 decode-heavy requests of 6-token prompts and 14-18 new tokens."""
    return [cls(rid=i, prompt=rng.integers(0, vocab, 6).astype(np.int32),
                max_new_tokens=int(rng.integers(14, 19)))
            for i in range(6)]


def continuous(model, params, device, reqs: list) -> dict:
    """Continuous batching: paged KV pool + in-flight admission."""
    engine = Engine(model, params, device=device,
                    serve_cfg=ServeConfig(**CONTINUOUS_CFG))
    res = engine.serve(reqs)
    s = res["stats"]
    print(f"\ncontinuous batching: {len(reqs)} requests over "
          f"{CONTINUOUS_CFG['max_slots']} slots, "
          f"{res['steps']} pool decode steps")
    for r in reqs:
        print(f"  req {r.rid} arrive {r.arrival_s*1e3:5.1f} ms  "
              f"gen {len(r.out_tokens):2d} tok  "
              f"done {r.t_done*1e3:7.1f} ms")
    print(f"  {s['tokens']} tokens -> {s['tok_per_s']:.0f} tok/s, "
          f"p50 latency {s['latency_p50_s']*1e3:.0f} ms")
    return res


def overcommit(model, params, device, reqs: list) -> dict:
    """Overcommit: lazy admission + preemption on a deliberately tight
    pool."""
    engine = Engine(model, params, device=device,
                    serve_cfg=ServeConfig(**OVERCOMMIT_CFG))
    res = engine.serve(reqs)
    mem = res["memory"]
    s = res["stats"]
    print(f"\novercommit (14 allocatable pages, lazy reservation): "
          f"{s['n_done']}/{len(reqs)} requests completed")
    print(f"  peak in-flight {mem['peak_resident']} (full reservation fits "
          f"2), {mem['preemptions']} preemptions, "
          f"{mem['grown_pages']} pages lazily grown, "
          f"{s['preempts']} evictions over "
          f"{s['preempted_requests']} requests "
          f"(requeue wait p50 {s['requeue_wait_p50_s']*1e3:.1f} ms)")
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda unless asked)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    summary = {}

    # -- static lockstep batching across cache layouts ----------------------
    for arch in LOCKSTEP_ARCHS:
        model = build(get_config(arch).reduced())
        lockstep(model, model.init(0, device=dev), dev)
    summary["lockstep"] = print_launches("lockstep")

    # -- continuous batching, then overcommit, on the dense model -----------
    model = build(get_config(DENSE_ARCH).reduced())
    params = model.init(0, device=dev)
    rng = np.random.default_rng(0)
    for name, reqs, section in (
            ("continuous", continuous_requests(rng, model.cfg.vocab_size),
             continuous),
            ("overcommit", overcommit_requests(rng, model.cfg.vocab_size),
             overcommit)):
        res = section(model, params, dev, reqs)
        summary[name] = {
            "done": res["stats"]["n_done"], "requests": len(reqs),
            "page_leaks": res["page_leaks"], "steps": res["steps"],
            "launches": print_launches(name)}
    return summary


if __name__ == "__main__":
    main()
