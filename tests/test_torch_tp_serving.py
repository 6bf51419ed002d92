"""Tensor-parallel paged serving of the port over two gloo ranks on the
CPU, held against the JAX engine on a forced 2-device mesh (the port of
``tests/test_tp_serving.py``, plus a GQA config whose tp 4 clamps to 2,
chunked prefill with spec_depth 2, a seeded ``logits.nan`` injection that
walks the safe-plan fallback to tp 1 and back, the VLM backbone, and the
tp-2 step's counters against the JAX package's HLO census of its tp-2
step).

The weights come from the JAX package's ``init`` in this process and go
to both children as one ``.npz`` a config.  Two subprocesses run side by
side: the JAX child (``XLA_FLAGS`` must predate jax's backend init) and
the port child, whose rank 0 spawns rank 1 and meets it over a TCP store
on a free port.  Their JSON is shared module-wide.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: name -> (arch, degrees served, ServeConfig keywords, trace)
SCENARIOS = {
    "stablelm": ("stablelm-1.6b", [1, 2],
                 dict(max_len=48, max_slots=3, prefill_chunk=4),
                 dict(n=4, prompt=9, gen=6)),
    "gqa": ("qwen3-8b", [1, 4],
            dict(max_len=48, max_slots=3, prefill_chunk=4),
            dict(n=4, prompt=9, gen=6)),
    "spec2": ("stablelm-1.6b", [1, 2],
              dict(max_len=64, max_slots=3, prefill_chunk=4, spec_depth=2),
              dict(n=4, prompt=11, gen=12, repeat=True)),
    "faults": ("stablelm-1.6b", [2],
               dict(max_len=64, max_slots=3, prefill_chunk=4,
                    chaos_rate=0.03, chaos_seed=2,
                    chaos_sites=["logits.nan"]),
               dict(n=8, prompt=9, gen=24)),
    "vlm": ("internvl2-26b", [1, 2],
            dict(max_len=48, max_slots=3, prefill_chunk=4),
            dict(n=3, prompt=9, gen=5)),
}

_TRACE = r"""
def trace(cfg, n, prompt, gen, repeat=False):
    rng = np.random.RandomState(0)
    out = []
    for i in range(n):
        p = rng.randint(1, cfg.vocab_size, size=prompt).astype(np.int32)
        if repeat:          # a repeating prompt: the n-gram drafts hit
            p = np.resize(p[:4], prompt).astype(np.int32)
        out.append(Request(rid=i, prompt=p, max_new_tokens=gen,
                           arrival_s=0.0))
    return out


def load(arch, d):
    z = np.load(os.path.join(d, arch + ".npz"))
    tree = {}
    for k in z.files:
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = z[k]
    return tree


def serve_cfg(kw, tp):
    kw = dict(kw, tp=tp, temperature=0.0)
    if "chaos_sites" in kw:
        kw["chaos_sites"] = tuple(kw["chaos_sites"])
    return ServeConfig(**kw)


def record(res, pool):
    pool.allocator.check_invariants()
    return {
        "tokens": [[int(t) for t in r.out_tokens] for r in res["requests"]],
        "states": [r.state.name for r in res["requests"]],
        "health": {k: v for k, v in res["health"].items()
                   if k != "fault_rate"},
        "mesh": res["mesh"], "n_pages": int(pool.n_pages),
        "free_pages": int(pool.allocator.n_free),
        "live_pages": int(pool.allocator.n_live),
        "leaks": int(res["page_leaks"]),
        "hbm_bytes": int(pool.hbm_bytes()),
        "per_device_hbm_bytes": int(pool.per_device_hbm_bytes()),
        "high_water_bytes": int(pool.high_water_bytes()),
        "per_device_high_water_bytes":
            int(pool.per_device_high_water_bytes()),
    }


def counts(rc):
    return {"flops": rc.total.flops, "bytes": rc.total.bytes,
            "collective_bytes": rc.total.collective_bytes,
            "link_bytes": rc.total.link_bytes,
            "collective_ops": rc.total.collective_ops,
            "census": dict(rc.collective_census),
            "regions": {r: [c.flops, c.bytes] for r, c in rc.regions.items()},
            "top": rc.top_regions("flops", 5)}
"""

_JAX_CHILD = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax
import numpy as np
from repro.configs.registry import get_config
from repro.models.model import build
from repro.serve.engine import Engine, ServeConfig
from repro.serve.scheduler import Request
""" + _TRACE + r"""
d, scen = sys.argv[1], json.loads(sys.argv[2])
out = {"n_devices": len(jax.devices())}
for name, (arch, tps, kw, tr) in scen.items():
    cfg = get_config(arch).reduced()
    model = build(cfg)
    params = jax.tree.map(jax.numpy.asarray, load(arch, d))
    for tp in tps:
        eng = Engine(model, params, serve_cfg=serve_cfg(kw, tp))
        res = eng.serve(trace(cfg, **tr))
        rec = record(res, eng._pool)
        rec["page_specs"] = sorted({str(getattr(l.sharding, "spec", "single"))
                                    for l in jax.tree.leaves(eng._pool.pages)})
        out[f"{name}/tp{tp}"] = rec
cfg = get_config("stablelm-1.6b").reduced()
for tp in (1, 2):
    eng = Engine(build(cfg), jax.tree.map(jax.numpy.asarray,
                                          load("stablelm-1.6b", d)),
                 serve_cfg=ServeConfig(max_len=32, max_slots=2, page_size=8,
                                       online_retrain=True, tp=tp))
    eng._ensure_pool()
    out[f"counts/tp{tp}"] = counts(eng._pool_rc)
print("TPJSON " + json.dumps(out))
"""

_PORT_CHILD = r"""
import os, sys, json
import numpy as np
import torch
torch.set_num_threads(2)
from repro_torch.configs.registry import get_config
from repro_torch.models import layers as L
from repro_torch.models.model import build, params_from_numpy
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.scheduler import Request
from repro_torch.core.policy import RegionConfig
from repro_torch.serve.tp import Ranks


class ByLoad:
    # the decider's interface: tp 2 above one active slot, else tp 1
    tree, version = "stand-in", 0

    def decide(self, rc, plan, load_frac, top_n):
        cls = "tp2" if load_frac > 0.34 else "tp1"
        plan = type(plan)(rules=dict(plan.rules), region_configs={
            **plan.region_configs,
            "layer/attn": RegionConfig(tp_degree=int(cls[2:]))})
        return plan, [("layer/attn", cls)]

    def applied_class(self, prefix, cls):
        return cls
""" + _TRACE + r"""
if __name__ == "__main__":
    import repro_torch.serve.tp as tp_mod
    builds, make = [], tp_mod.make_host_mesh
    tp_mod.make_host_mesh = lambda d, m: (builds.append(m), make(d, m))[1]
    d, scen = sys.argv[1], json.loads(sys.argv[2])
    out = {"mesh_builds": builds}
    archs = []
    for arch, *_ in scen.values():
        if arch not in archs:
            archs.append(arch)
    for arch in archs:             # one process group at a time
        cfg = get_config(arch).reduced()
        model = build(cfg)
        params = params_from_numpy(load(arch, d), device="cpu")
        with Ranks(cfg, 2, "cpu") as ranks:
            out["line"] = ranks.line()
            for name, (a, tps, kw, tr) in scen.items():
                if a != arch:
                    continue
                for tp in [1] + [t for t in tps if t > 1]:
                    eng = Engine(model, params, serve_cfg=serve_cfg(kw, tp),
                                 **({"ranks": ranks} if tp > 1 else
                                    {"device": "cpu"}))
                    degrees = []
                    if tp > 1:
                        apply = eng._apply_tp

                        def logged(t, apply=apply, eng=eng):
                            if t != eng._serve_tp:
                                degrees.append(t)
                            apply(t)
                        eng._apply_tp = logged
                    res = eng.serve(trace(cfg, **tr))
                    rec = record(res, eng._pool)
                    rec["degrees"] = degrees
                    rec["rank0_page_shapes"] = sorted(
                        {tuple(t.shape) for t in
                         L.tree_leaves(eng._pool.pages)})
                    rec["workers"] = ranks.report() if tp > 1 else []
                    out[f"{name}/tp{tp}"] = rec
            if arch != "stablelm-1.6b":
                continue
            # auto mode: a stand-in decider picks tp 2 above one active
            # slot and tp 1 at one, so the serve switches degree mid-trace
            arch_, _, kw, tr = scen["stablelm"]
            eng = Engine(model, params, serve_cfg=serve_cfg(kw, 0),
                         ranks=ranks)
            eng.decider = ByLoad()
            degrees = []
            apply = eng._apply_tp

            def logged(t, apply=apply, eng=eng):
                if t != eng._serve_tp:
                    degrees.append(t)
                apply(t)
            eng._apply_tp = logged
            res = eng.serve(trace(cfg, **tr))
            out["auto"] = dict(record(res, eng._pool), degrees=degrees,
                               decisions=[d for _, d in res["decisions"]])
            for tp in (1, 2):
                eng = Engine(model, params,
                             serve_cfg=ServeConfig(max_len=32, max_slots=2,
                                                   page_size=8,
                                                   online_retrain=True,
                                                   tp=tp),
                             **({"ranks": ranks} if tp > 1 else
                                {"device": "cpu"}))
                eng._ensure_pool()
                out[f"counts/tp{tp}"] = counts(eng._pool_rc)
    print("TPJSON " + json.dumps(out))
"""


def _save_params(d):
    """Each config's JAX-initialised f32 params, flattened to '/' keys."""
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import get_config
    from repro.models.model import build
    for arch in sorted({a for a, *_ in SCENARIOS.values()}):
        params = build(get_config(arch).reduced()).init(
            jax.random.PRNGKey(0), dtype=jnp.float32)
        flat = {"/".join(str(getattr(k, "key", k)) for k in path):
                np.asarray(leaf)
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                    params)[0]}
        np.savez(os.path.join(d, arch + ".npz"), **flat)


def _parse(proc, name):
    out, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, f"{name} child failed:\n{err[-6000:]}"
    line = [l for l in out.splitlines() if l.startswith("TPJSON ")][-1]
    return json.loads(line[len("TPJSON "):])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tp_params"))
    _save_params(d)
    scen = json.dumps(SCENARIOS)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", code, d, scen], env=env, cwd=d,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, code in (("jax", _JAX_CHILD), ("port", _PORT_CHILD))}
    return {name: _parse(p, name) for name, p in procs.items()}


def _pair(runs, key):
    return runs["port"][key], runs["jax"][key]


@pytest.mark.parametrize("name", ["stablelm", "gqa", "vlm"])
def test_tp2_greedy_tokens_equal_tp1_and_jax(runs, name):
    """Port tp 2 serves the greedy tokens of port tp 1, of JAX at tp 1 and
    of JAX at tp 2 (qwen3-8b reduced has 2 kv heads: tp 4 clamps to 2)."""
    assert runs["jax"]["n_devices"] == 2
    tps = SCENARIOS[name][1]
    port1, jax1 = _pair(runs, f"{name}/tp1")
    port2, jax2 = _pair(runs, f"{name}/tp{tps[-1]}")
    assert port1["tokens"] and all(port1["tokens"])
    assert port2["tokens"] == port1["tokens"] == jax1["tokens"] \
        == jax2["tokens"]
    assert port2["mesh"]["tp"] == jax2["mesh"]["tp"] == 2
    assert set(port2["states"]) == {"DONE"}


def test_ranks_use_gloo_on_a_shared_device(runs):
    assert runs["port"]["line"] == ("2 ranks on cpu over gloo (ranks share "
                                    "a device)")


def test_rank_0_builds_each_mesh_once_per_process_group(runs):
    """Building a mesh is collective and a worker builds each degree's
    once, so rank 0 does too, however many engines use the ranks: one
    (1, 2) mesh for each config's process group."""
    n_groups = len({arch for arch, *_ in SCENARIOS.values()})
    assert runs["port"]["mesh_builds"] == [2] * n_groups


def test_tp_mesh_report_and_per_device_accounting(runs):
    """As tests/test_tp_serving.py: per-device bytes are the pool split tp
    ways, and a tp-2 device holds half a tp-1 device's pages; the mesh
    result equals the JAX engine's."""
    p1, p2 = runs["port"]["stablelm/tp1"], runs["port"]["stablelm/tp2"]
    assert p1["mesh"]["tp"] == 1 and p2["mesh"]["tp"] == 2
    assert p2["mesh"] == runs["jax"]["stablelm/tp2"]["mesh"]
    assert p1["mesh"] == {**runs["jax"]["stablelm/tp1"]["mesh"],
                          "devices": 1}
    for tp, d in ((1, p1), (2, p2)):
        assert d["per_device_hbm_bytes"] * tp == d["hbm_bytes"]
        assert d["per_device_high_water_bytes"] * tp == d["high_water_bytes"]
        assert d["mesh"]["hbm_bytes_per_device"] == d["per_device_hbm_bytes"]
    assert p2["high_water_bytes"] == p1["high_water_bytes"]
    assert (p2["per_device_high_water_bytes"] * 2
            == p1["per_device_high_water_bytes"])
    # the worker's shard is as large as rank 0's
    assert [w["page_bytes"] for w in p2["workers"]] == [
        p2["per_device_hbm_bytes"]]


def test_sharded_pool_conserves_pages(runs):
    for key, d in runs["port"].items():
        if "/" not in key or key.startswith("counts"):
            continue
        assert d["free_pages"] + d["live_pages"] == d["n_pages"] - 1, key
        assert d["leaks"] == 0, key
    assert (runs["port"]["stablelm/tp2"]["n_pages"]
            == runs["port"]["stablelm/tp1"]["n_pages"])


def test_pages_shard_on_kv_head_axis_only(runs):
    """Rank 0 holds (P, page_size, KVH/2, HD) pages at tp 2 — every page,
    half the kv heads — as the JAX engine's PartitionSpec(None, None,
    'model') says."""
    for name in ("stablelm", "gqa"):
        tps = SCENARIOS[name][1]
        (s1,) = runs["port"][f"{name}/tp1"]["rank0_page_shapes"]
        (s2,) = runs["port"][f"{name}/tp{tps[-1]}"]["rank0_page_shapes"]
        assert s2 == [s1[0], s1[1], s1[2] // 2, s1[3]]
        assert runs["jax"][f"{name}/tp{tps[-1]}"]["page_specs"] == [
            "PartitionSpec(None, None, 'model')"]


def test_worker_runs_every_step(runs):
    """Rank 1 ran one decode step per rank-0 step and one chunk step per
    prefill chunk (the counts since the previous report)."""
    for key in ("stablelm/tp2", "spec2/tp2", "vlm/tp2"):
        (w,) = runs["port"][key]["workers"]
        assert w["decode_steps"] > 0 and w["chunk_steps"] > 0, key


def test_chunked_prefill_and_spec_depth2_at_tp2(runs):
    p1, p2 = runs["port"]["spec2/tp1"], runs["port"]["spec2/tp2"]
    j2 = runs["jax"]["spec2/tp2"]
    assert p2["tokens"] == p1["tokens"] == j2["tokens"]
    assert set(p2["states"]) == {"DONE"}


def test_logits_nan_fallback_walks_to_tp1_and_back(runs):
    """A seeded logits.nan injection at tp 2 degrades the engine, whose
    safe plan pins tp 1 (the pool resharded onto rank 0), and recovers to
    tp 2; tokens and the health ladder's counts equal the JAX engine's."""
    p, j = runs["port"]["faults/tp2"], runs["jax"]["faults/tp2"]
    assert p["health"]["fallbacks"] >= 1
    assert p["health"] == j["health"]
    assert p["tokens"] == j["tokens"] and p["states"] == j["states"]
    assert p["degrees"][:2] == [1, 2], p["degrees"]
    assert p["mesh"]["tp"] == j["mesh"]["tp"]


def test_a_decided_degree_switch_reshards_and_keeps_tokens(runs):
    """In auto mode the decider's tp channel moves the serve between tp 1
    and tp 2 with requests in flight: the pool is resharded each time,
    and the tokens are those of the fixed-degree serves."""
    a = runs["port"]["auto"]
    assert 2 in a["degrees"] and 1 in a["degrees"], a["degrees"]
    assert {c for d in a["decisions"] for _, c in d} == {"tp1", "tp2"}
    assert a["tokens"] == runs["port"]["stablelm/tp1"]["tokens"]
    assert a["leaks"] == 0 and set(a["states"]) == {"DONE"}


def test_tp2_step_counters_match_jax_census(runs):
    """The tp-2 decode step counted on the meta device (one rank's shard
    and its collectives) against the JAX package's HLO count of its tp-2
    step, per device, in the counters' 25% band: the total flops and each
    of the top regions' flops; the bytes as the cut each rank takes (tp-2
    over tp-1 bytes) and on the MLP and logits regions.  At tp 1 the
    attention, MLP and logits regions' bytes agree within the band too,
    and the top level's and ``embed``'s do not, by the JAX count's rules
    (each layer's slice of the stacked weights is a copy there, and a
    gather fusion is charged its whole table):
    ``tests/test_torch_counters.py`` pins each region's ratio.  The
    port's collectives are all-reduces — the partial sums, and the
    logits' replication through a zero-filled full-vocab buffer — where
    JAX gathers the logits."""
    p1, p2 = runs["port"]["counts/tp1"], runs["port"]["counts/tp2"]
    j1, j2 = runs["jax"]["counts/tp1"], runs["jax"]["counts/tp2"]
    band = lambda a, b: abs(a - b) <= 0.25 * b  # noqa: E731
    assert band(p2["flops"], j2["flops"]), (p2["flops"], j2["flops"])
    assert [r for r, _ in p2["top"]] == [r for r, _ in j2["top"]]
    for (r, f), (_, jf) in zip(p2["top"], j2["top"]):
        assert band(f, jf), (r, f, jf)
    assert band(p2["bytes"] / p1["bytes"], j2["bytes"] / j1["bytes"])
    for r in ("layer0/mlp", "layer1/mlp", "logits"):
        assert band(p2["regions"][r][1], j2["regions"][r][1]), r
    # embed, 2 per layer (wo, down), the logits: reduced stablelm has 2
    assert p2["census"] == {"all-reduce": 1 + 2 * 2 + 1}
    assert p2["collective_ops"] == 6 and p2["collective_bytes"] > 0
    assert p1["census"] == {} and p1["collective_bytes"] == 0
    assert j2["census"] == {"all-reduce": 5, "all-gather": 1}
    print(f"\n[tp counters] port {p2['flops']:.0f} flops {p2['bytes']:.0f} "
          f"bytes census {p2['census']}; JAX {j2['flops']:.0f} flops "
          f"{j2['bytes']:.0f} bytes census {j2['census']}")


_DIES = r"""
import dataclasses, sys
from repro_torch.configs.registry import get_config
from repro_torch.serve.tp import Ranks
if __name__ == "__main__":
    bad = dataclasses.replace(get_config("stablelm-1.6b").reduced(),
                              family="unknown")
    try:
        with Ranks(bad, 2, "cpu") as ranks:
            ranks.report()
    except RuntimeError as e:
        print("RANK0FAILED", str(e)[:200])
        sys.exit(3)
"""


def _child_env():
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    return env


def test_a_worker_that_dies_fails_rank_0(tmp_path):
    """Rank 1 cannot build the model and dies: rank 0's next collective
    raises at once (no timeout) and the ranks are torn down."""
    res = subprocess.run([sys.executable, "-c", _DIES], env=_child_env(),
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 3, res.stderr[-3000:]
    assert "RANK0FAILED" in res.stdout
    assert "unknown family" in res.stderr


def test_launcher_starts_the_clamped_ranks(tmp_path):
    """``launch.serve --tp 2`` on the CPU starts two gloo ranks itself;
    rank 0 prints the summary and the ``[mesh]`` line, and the tokens
    equal the launcher's at tp 1."""
    def run(tp):
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--device",
             "cpu", "--dtype", "float32", "--tp", tp, "--requests", "4",
             "--gen-min", "3", "--gen-max", "6", "--prefill-chunk", "8"],
            env=_child_env(), cwd=tmp_path, capture_output=True, text=True,
            timeout=300)
        assert res.returncode == 0, res.stderr[-3000:]
        return res.stdout.splitlines()
    one, two = run("1"), run("2")
    assert "[tp] 2 ranks on cpu over gloo (ranks share a device)" in two
    assert any(l.startswith("[mesh] tp=2 devices=2") for l in two)
    assert any(l.startswith("[mesh] tp=1 devices=1") for l in one)
    gen = lambda lines: [l.split("latency")[0] for l in lines  # noqa: E731
                         if l.startswith("req ")]
    assert gen(one) == gen(two) and len(gen(two)) == 4
