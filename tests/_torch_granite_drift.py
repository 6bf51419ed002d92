"""Layer 0 of full-width ``granite-moe-1b-a400m`` op by op, tensor-parallel
over two gloo ranks against one rank, on the CPU or on one card.

    PYTHONPATH=src python tests/_torch_granite_drift.py OUT_DIR [DEVICE]

A one-layer model of granite's width runs its forward (f32, B 1 x S 256
tokens from a numpy seed: the shape of the paged serve's first prefill
chunk) on one rank, then on two ranks sharing DEVICE (``cpu`` unless
given) over gloo (this process rank 0, rank 1 spawned), with the params
cut as the serve engine cuts them at tp 2 (``serve.tp.serve_plan``:
heads, kv heads and experts split).  The forward stops at layer 0's router; on the
way each op's output is kept: the embedding ``x`` and its norm ``h1``, q,
k and v, the scores and the softmax, the attention ``attn``, the ``wo``
partial sums and their all-reduce ``wo``, the residual, and the MoE input
(layer 0's second norm, the router's input).  Two weight draws: ``init``,
the scale ``Model.init`` gives layer 0 of the 24-layer model (a stacked
matrix at 1/sqrt(24), whatever its fan-in), and ``fan_in``, each matrix
at its own fan-in (``chip_smoke.fan_in_params``).

The JSON line printed last holds, for each draw and op: ``gap``, the two
ranks' output (assembled) against the one rank's, relative to the one
rank's largest magnitude (``chip_smoke.route_flips``' measure); ``own``,
the one rank's output against the same op recomputed in float64 from the
one rank's own f32 inputs, on the same scale (the op's f32 rounding at
its magnitude); ``max``, the one rank's largest magnitude; and, per draw,
the MoE input's ``amplification`` of a one-ulp change of q, k, v and the
``wo`` output.
"""
import contextlib
import dataclasses
import json
import math
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

ARCH, FULL_LAYERS, SEED, SEQ = "granite-moe-1b-a400m", 24, 0, 256
DRAWS = ("init", "fan_in")
# the tensors a rank holds a block of, and the dim of the block
SPLIT = {"q": -2, "k": -2, "v": -2, "attn": -2, "scores": 1, "probs": 1}
OPS = ("x", "h1", "q", "k", "v", "scores", "probs", "attn", "wo_partial",
       "wo", "residual", "moe_in")


class Stop(Exception):
    """Raised at layer 0's router on every rank, before any collective of
    the MoE layer: the trace ends there."""


def one_layer_model():
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import build
    return build(dataclasses.replace(get_config(ARCH), n_layers=1))


def weights(model, draw: str, dev: torch.device) -> dict:
    """The one-layer model's f32 params on ``dev`` under ``draw`` (module
    docstring), the same on every rank."""
    from chip_smoke import fan_in_params
    from repro_torch.models import layers as L
    if draw == "fan_in":
        return fan_in_params(model, SEED, torch.float32, dev)
    params = model.init(SEED, dtype=torch.float32, device=dev)
    # Model.init draws a stacked leaf at scale / sqrt(its layer count):
    # scale here, scale / sqrt(24) in the full model
    leaves = [t / math.sqrt(FULL_LAYERS)
              if sp.init == "normal" and sp.axes[0] == "layers" else t
              for t, sp in zip(L.tree_leaves(params),
                               L.tree_leaves(model.spec()))]
    it = iter(leaves)
    return L.tree_map(lambda _: next(it), model.spec())


def tokens(model, dev: torch.device) -> torch.Tensor:
    rng = np.random.default_rng(SEED)
    return torch.from_numpy(rng.integers(0, model.cfg.vocab_size, (1, SEQ))
                            .astype(np.int32)).to(dev)


@contextlib.contextmanager
def kept(rec: dict):
    """Keep in ``rec`` the ops' outputs (module docstring) while the
    forward runs; stop it at the router."""
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import moe
    names = ("_project_qkv", "_masked_softmax", "_out_proj", "_finish")
    saved = {n: getattr(A, n) for n in names}
    norm, route = L.apply_norm, moe.route

    def project_qkv(*a, **kw):
        q, k, v = saved["_project_qkv"](*a, **kw)
        rec.update(q=q.clone(), k=k.clone(), v=v.clone())
        return q, k, v

    def masked_softmax(s, valid, dtype):
        probs = saved["_masked_softmax"](s, valid, dtype)
        rec.update(scores=s.clone(), probs=probs.clone())
        return probs

    def out_proj(attn, wo):
        out = saved["_out_proj"](attn, wo)
        rec.update(attn=attn.clone(), wo_partial=out.clone())
        return out

    def finish(*a, **kw):
        out = saved["_finish"](*a, **kw)      # all-reduced at tp 2
        rec["wo"] = out.clone()
        return out

    def apply_norm(cfg, p, x, *a, **kw):
        y = norm(cfg, p, x, *a, **kw)
        first = "h1" not in rec
        rec.update({"x" if first else "residual": x.clone(),
                    "h1" if first else "moe_in": y.clone()})
        return y

    def stop(*a, **kw):
        raise Stop

    patches = {**{(A, n): f for n, f in zip(
        names, (project_qkv, masked_softmax, out_proj, finish))},
        (L, "apply_norm"): apply_norm, (moe, "route"): stop}
    for (mod, name), f in patches.items():
        setattr(mod, name, f)
    try:
        yield rec
    finally:
        for n in names:
            setattr(A, n, saved[n])
        L.apply_norm, moe.route = norm, route


def trace(model, params, toks, plan) -> dict:
    rec: dict = {}
    with kept(rec), torch.no_grad():
        try:
            model.forward(params, {"tokens": toks}, plan)
        except Stop:
            pass
    return rec


def ranks_trace(rank: int, out_dir: str, dev: torch.device) -> None:
    """This rank's traces at tp 2 (the group exists), saved per draw."""
    from repro_torch.core.policy import RegionPlan
    from repro_torch.distributed.sharding import param_shardings, shard_leaf
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L
    from repro_torch.serve.tp import serve_plan
    model = one_layer_model()
    mesh = make_host_mesh(1, 2)
    plan = serve_plan(RegionPlan(), mesh)
    specs = L.tree_leaves(param_shardings(model, plan))
    coords = {"data": 0, "model": rank}
    for draw in DRAWS:
        mine = [shard_leaf(t, sp, mesh, coords) for t, sp in
                zip(L.tree_leaves(weights(model, draw, dev)), specs)]
        it = iter(mine)
        params = L.tree_map(lambda _: next(it), model.spec())
        torch.save(trace(model, params, tokens(model, dev), plan),
                   f"{out_dir}/{draw}_rank{rank}.pt")


def _worker(rank: int, world: int, port: int, out_dir: str,
            dev: str) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import worker_store
    store = worker_store(rank, world, port)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    ranks_trace(rank, out_dir, torch.device(dev))
    dist.barrier()
    dist.destroy_process_group()


def _rms64(x, scale):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-5) * scale


def own_f64(model, params, one: dict) -> dict:
    """Each op recomputed in float64 from the one rank's f32 inputs."""
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    cfg = model.cfg
    lp = L.tree_map(lambda t: t[0].double(), params["blocks"])
    d = {k: v.double() for k, v in one.items()}
    pos = torch.arange(SEQ, dtype=torch.int32, device=d["x"].device)
    hd = d["q"].shape[-1]
    out = {"x": d["x"], "h1": _rms64(d["x"], lp["norm1"]["scale"])}
    out["q"] = L.apply_rope(cfg, A._proj(d["h1"], lp["attn"]["wq"]), pos)
    out["k"] = L.apply_rope(cfg, A._proj(d["h1"], lp["attn"]["wk"]), pos)
    out["v"] = A._proj(d["h1"], lp["attn"]["wv"])
    B, S, H, _ = d["q"].shape
    kvh = d["k"].shape[-2]
    qg = d["q"].reshape(B, S, kvh, H // kvh, hd)
    out["scores"] = torch.einsum("bqhge,bkhe->bhgqk", qg, d["k"]) / math.sqrt(
        hd)
    causal = pos[:, None] >= pos[None, :]
    out["probs"] = torch.softmax(d["scores"].masked_fill(~causal, -1e30), -1)
    out["attn"] = torch.einsum("bhgqk,bkhe->bqhge", d["probs"], d["v"]
                               ).reshape(B, S, H, hd)
    out["wo"] = out["wo_partial"] = A._out_proj(d["attn"], lp["attn"]["wo"])
    out["residual"] = d["x"] + d["wo"]
    out["moe_in"] = _rms64(d["residual"], lp["norm2"]["scale"])
    return out


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """route_flips' measure: the largest difference over b's largest
    magnitude."""
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp_min(1e-300))


def moe_input(model, params, d: dict) -> torch.Tensor:
    """Layer 0's MoE input from its q, k, v (or its ``wo`` output, where
    ``d`` holds one) and its embedding, in f32 through the model's ops."""
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    lp = L.tree_map(lambda t: t[0], params["blocks"])
    if "wo" not in d:
        q, k, v = d["q"], d["k"], d["v"]
        B, S, H, hd = q.shape
        kvh = k.shape[-2]
        s = torch.einsum("bqhge,bkhe->bhgqk",
                         q.reshape(B, S, kvh, H // kvh, hd), k) / math.sqrt(hd)
        pos = torch.arange(S, device=q.device)
        probs = A._masked_softmax(s, pos[:, None] >= pos[None, :], q.dtype)
        attn = torch.einsum("bhgqk,bkhe->bqhge", probs, v).reshape(B, S, H,
                                                                   hd)
        d = dict(d, wo=A._out_proj(attn, lp["attn"]["wo"]))
    return L.apply_norm(model.cfg, lp["norm2"], d["x"] + d["wo"])


def amplification(model, params, one: dict) -> dict:
    """For q, k, v and the ``wo`` output: the MoE input's relative change
    over the op's, when a random half of the op's elements move by one
    f32 ulp (a rounding difference, such as another split of a product
    gives)."""
    gen = torch.Generator().manual_seed(SEED)
    base = moe_input(model, params, one)
    assert torch.equal(base, one["moe_in"])
    out = {}
    for op in ("q", "k", "v", "wo"):
        t = one[op]
        up = (torch.rand(t.shape, generator=gen) < 0.5).to(t.device)
        moved = torch.where(
            up, torch.nextafter(t, torch.full_like(t, math.inf)), t)
        inputs = {"x": one["x"], **{o: one[o] for o in ("q", "k", "v")}}
        if op == "wo":
            inputs["wo"] = one["wo"]
        inputs[op] = moved
        out[op] = rel(moe_input(model, params, inputs), base) / rel(moved, t)
    return out


def main(out_dir: str, device: str = "cpu") -> dict:
    """The per-op report (module docstring) of both draws on ``device``,
    with each draw's ``amplification``."""
    import torch.distributed as dist

    from repro_torch.core.policy import null_plan
    from repro_torch.launch.mesh import start_ranks
    from repro_torch.models.attention import _out_proj
    dev = torch.device(device)
    model = one_layer_model()
    toks = tokens(model, dev)
    one = {draw: trace(model, weights(model, draw, dev), toks, null_plan())
           for draw in DRAWS}
    store, procs = start_ranks(2, _worker, (out_dir, device))
    dist.init_process_group("gloo", store=store, rank=0, world_size=2)
    ranks_trace(0, out_dir, dev)
    dist.barrier()
    dist.destroy_process_group()
    for p in procs:
        p.join(timeout=120)
        assert p.exitcode == 0, p.exitcode
    report = {}
    for draw in DRAWS:
        r0, r1 = (torch.load(f"{out_dir}/{draw}_rank{r}.pt",
                             map_location=dev) for r in (0, 1))
        two = {op: (torch.cat([r0[op], r1[op]], SPLIT[op]) if op in SPLIT
                    else r0[op]) for op in OPS}
        params = weights(model, draw, dev)
        ref = own_f64(model, params, one[draw])
        wo = params["blocks"]["attn"]["wo"][0].double()
        h = r0["attn"].shape[-2]
        rows = {}
        for op in OPS:
            want = one[draw][op]
            scale = want.double().abs().max()
            row = {"max": float(scale), "own": rel(want, ref[op])}
            if op == "wo_partial":
                # each rank's partial sum (its heads' rows of wo) against
                # the same product in float64, on the whole sum's scale
                row["own"] = max(float(
                    (r[op].double() - _out_proj(r["attn"].double(),
                                                wo[i * h:(i + 1) * h])
                     ).abs().max() / scale) for i, r in enumerate((r0, r1)))
            else:
                row["gap"] = rel(two[op], want)
            rows[op] = row
        report[draw] = {"ops": rows,
                        "amplification": amplification(model, params,
                                                       one[draw])}
    return report


if __name__ == "__main__":
    print(json.dumps(main(*sys.argv[1:3])))
