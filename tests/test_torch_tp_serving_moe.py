"""Tensor-parallel paged serving of the port's MoE family over two gloo
ranks on the CPU, held against the JAX engine on a forced 2-device mesh,
as ``tests/test_torch_tp_serving.py`` holds the dense family (whose
trace and record helpers the children here reuse).

Scenarios (``SCENARIOS``), reduced configs in f32 on JAX-initialised
params bridged through one ``.npz`` a config: qwen2-moe-a2.7b (4 kv
heads, 8 experts top-2, its shared experts an ff-split MLP), under the
einsum dispatch and under the scatter dispatch; granite-moe-1b-a400m
(GQA 4/2: tp 2); a qwen2 of 6 experts padded to 8, whose second rank
holds both pads; and granite at tp 2 with a seeded ``logits.nan``
injection that walks the safe plan to tp 1 and back.  On the port
alone: a stand-in decider that moves granite's serve between tp 1 and
tp 2 mid-trace, each rank's expert count, and the serve launcher at
``--tp 2``.  Then the tp-2 granite decode step's counters against the
JAX package's HLO census of its tp-2 step.
"""
import json
import os
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_tp_serving as tps  # noqa: E402

QWEN2, GRANITE = "qwen2-moe-a2.7b", "granite-moe-1b-a400m"
KW = dict(max_len=48, max_slots=3)
TRACE = dict(n=4, prompt=9, gen=6)
#: name -> (arch, reduced config's fields replaced, degrees served,
#: moe_impl, ServeConfig keywords, trace)
SCENARIOS = {
    "qwen2": (QWEN2, {}, [1, 2], "", KW, TRACE),
    "qwen2_scatter": (QWEN2, {}, [1, 2], "scatter", KW, TRACE),
    "granite": (GRANITE, {}, [1, 2], "", KW, TRACE),
    "granite_scatter": (GRANITE, {}, [1, 2], "scatter", KW, TRACE),
    "qwen2_pad": (QWEN2, {"n_experts": 6, "pad_experts_to": 8}, [1, 2], "",
                  KW, TRACE),
    "faults": (GRANITE, {}, [2], "",
               dict(max_len=64, max_slots=3, chaos_rate=0.03, chaos_seed=2,
                    chaos_sites=["logits.nan"]),
               dict(n=8, prompt=9, gen=24)),
}

_COMMON = tps._TRACE + r"""
import dataclasses


def config(get_config, arch, fields):
    return dataclasses.replace(get_config(arch).reduced(), **fields)


def tag(arch, fields):
    return "_".join([arch] + [f"{k}{v}" for k, v in sorted(fields.items())])


def moe_plan(RegionPlan, RegionConfig, impl):
    knobs = {"moe": RegionConfig(moe_impl=impl)} if impl else {}
    return RegionPlan(region_configs=knobs)
"""

_JAX_CHILD = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax
import numpy as np
from repro.configs.registry import get_config
from repro.core.policy import RegionConfig, RegionPlan
from repro.models.model import build
from repro.serve.engine import Engine, ServeConfig
from repro.serve.scheduler import Request
""" + _COMMON + r"""
d, scen = sys.argv[1], json.loads(sys.argv[2])
out = {"n_devices": len(jax.devices())}
for name, (arch, fields, degrees, impl, kw, tr) in scen.items():
    cfg = config(get_config, arch, fields)
    model = build(cfg)
    params = jax.tree.map(jax.numpy.asarray, load(tag(arch, fields), d))
    for tp in degrees:
        eng = Engine(model, params, plan=moe_plan(RegionPlan, RegionConfig,
                                                  impl),
                     serve_cfg=serve_cfg(kw, tp))
        res = eng.serve(trace(cfg, **tr))
        out[f"{name}/tp{tp}"] = record(res, eng._pool)
cfg = get_config(GRANITE).reduced()
for tp in (1, 2):
    eng = Engine(build(cfg), jax.tree.map(jax.numpy.asarray,
                                          load(GRANITE, d)),
                 serve_cfg=ServeConfig(max_len=32, max_slots=2, page_size=8,
                                       online_retrain=True, tp=tp))
    eng._ensure_pool()
    out[f"counts/tp{tp}"] = counts(eng._pool_rc)
print("TPJSON " + json.dumps(out))
""".replace("GRANITE", repr(GRANITE))

_PORT_CHILD = r"""
import os, sys, json
import numpy as np
import torch
torch.set_num_threads(2)
from repro_torch.configs.registry import get_config
from repro_torch.core.policy import RegionConfig, RegionPlan
from repro_torch.models import layers as L
from repro_torch.models.model import build, params_from_numpy
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.scheduler import Request
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
""" + _COMMON + r"""


def logged(eng, degrees):
    # note every change of degree the engine applies
    apply = eng._apply_tp

    def wrapped(t):
        if t != eng._serve_tp:
            degrees.append(t)
        apply(t)
    eng._apply_tp = wrapped


if __name__ == "__main__":
    d, scen = sys.argv[1], json.loads(sys.argv[2])
    out = {}
    groups = {}
    for name, (arch, fields, *_) in scen.items():
        groups.setdefault(tag(arch, fields), (arch, fields, []))[2].append(
            name)
    for t, (arch, fields, names) in groups.items():  # one group at a time
        cfg = config(get_config, arch, fields)
        model = build(cfg)
        params = params_from_numpy(load(t, d), device="cpu")
        with Ranks(cfg, 2, "cpu") as ranks:
            for name in names:
                _, _, degrees, impl, kw, tr = scen[name]
                plan = moe_plan(RegionPlan, RegionConfig, impl)
                for tp in [1] + [x for x in degrees if x > 1]:
                    eng = Engine(model, params, plan=plan,
                                 serve_cfg=serve_cfg(kw, tp),
                                 **({"ranks": ranks} if tp > 1 else
                                    {"device": "cpu"}))
                    switched = []
                    if tp > 1:
                        logged(eng, switched)
                    res = eng.serve(trace(cfg, **tr))
                    rec = record(res, eng._pool)
                    rec["degrees"] = switched
                    rec["workers"] = ranks.report() if tp > 1 else []
                    rec["rank0_experts"] = (eng._shard.experts()
                                            if eng._shard is not None
                                            else 0)
                    rec["rank0_page_shapes"] = sorted(
                        {tuple(x.shape) for x in
                         L.tree_leaves(eng._pool.pages)})
                    out[f"{name}/tp{tp}"] = rec
            if t != GRANITE:
                continue
            # auto mode: the stand-in decider picks tp 2 above one active
            # slot and tp 1 at one, so the serve switches degree mid-trace
            _, _, _, impl, kw, tr = scen["granite"]
            eng = Engine(model, params, serve_cfg=serve_cfg(kw, 0),
                         ranks=ranks)
            eng.decider = ByLoad()
            switched = []
            logged(eng, switched)
            res = eng.serve(trace(cfg, **tr))
            out["auto"] = dict(record(res, eng._pool), degrees=switched,
                               decisions=[x for _, x in res["decisions"]])
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
""".replace("GRANITE", repr(GRANITE))


def _save_params(d):
    """Each config's JAX-initialised f32 params, flattened to '/' keys."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs.registry import get_config
    from repro.models.model import build
    done = set()
    for arch, fields, *_ in SCENARIOS.values():
        name = "_".join([arch] + [f"{k}{v}" for k, v in
                                  sorted(fields.items())])
        if name in done:
            continue
        done.add(name)
        cfg = dataclasses.replace(get_config(arch).reduced(), **fields)
        params = build(cfg).init(jax.random.PRNGKey(0), dtype=jnp.float32)
        flat = {"/".join(str(getattr(k, "key", k)) for k in path):
                np.asarray(leaf)
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                    params)[0]}
        np.savez(os.path.join(d, name + ".npz"), **flat)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tp_moe_params"))
    _save_params(d)
    scen = json.dumps(SCENARIOS)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.path.join(tps.ROOT, "src")
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", code, d, scen], env=env, cwd=d,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, code in (("jax", _JAX_CHILD), ("port", _PORT_CHILD))}
    # the serve launcher on granite at tp 2, beside them
    launch = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--dtype", "float32", "--arch", GRANITE, "--tp", "2", "--requests",
         "4", "--gen-min", "3", "--gen-max", "6"], env=env, cwd=d,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out = {name: tps._parse(p, name) for name, p in procs.items()}
        stdout, stderr = launch.communicate(timeout=600)
        assert launch.returncode == 0, f"launcher:\n{stderr[-3000:]}"
        out["launch/tp2"] = stdout.splitlines()
    finally:
        for p in (*procs.values(), launch):
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def _experts(name) -> int:
    arch, fields, *_ = SCENARIOS[name]
    return max(fields.get("n_experts", 8), fields.get("pad_experts_to", 0))


@pytest.mark.parametrize("name", sorted(n for n in SCENARIOS
                                        if n != "faults"))
def test_tp2_greedy_tokens_equal_tp1_and_jax(runs, name):
    """Port tp 2 serves the greedy tokens of port tp 1, of JAX at tp 1
    and of JAX at tp 2, under both dispatches and with padded experts;
    every request DONE, the mesh at tp 2 as JAX's."""
    assert runs["jax"]["n_devices"] == 2
    port1, jax1 = (runs[k][f"{name}/tp1"] for k in ("port", "jax"))
    port2, jax2 = (runs[k][f"{name}/tp2"] for k in ("port", "jax"))
    assert port1["tokens"] and all(port1["tokens"])
    assert port2["tokens"] == port1["tokens"] == jax1["tokens"] \
        == jax2["tokens"]
    assert set(port2["states"]) == {"DONE"}
    assert port2["mesh"] == jax2["mesh"] and port2["mesh"]["tp"] == 2


@pytest.mark.parametrize("name", sorted(n for n in SCENARIOS
                                        if n != "faults"))
def test_each_rank_holds_half_the_experts(runs, name):
    """At tp 2 rank 0's params copy and rank 1's hold
    ``n_experts_padded / 2`` experts each (the padded qwen2: 4 of 8, its
    pads both on rank 1); a tp-1 engine holds no shard."""
    p2 = runs["port"][f"{name}/tp2"]
    (w,) = p2["workers"]
    assert p2["rank0_experts"] == w["experts"] == _experts(name) // 2
    assert runs["port"][f"{name}/tp1"]["rank0_experts"] == 0


@pytest.mark.parametrize("name", sorted(n for n in SCENARIOS
                                        if n != "faults"))
def test_pool_bytes_halve_and_pages_are_conserved(runs, name):
    """Per-device pool bytes at tp 2 are half tp 1's (rank 1's shard as
    large as rank 0's), pages split on the kv-head axis only, and both
    pools end with every page free or live and none leaked."""
    p1, p2 = (runs["port"][f"{name}/tp{t}"] for t in (1, 2))
    assert 2 * p2["per_device_hbm_bytes"] == p1["per_device_hbm_bytes"]
    assert 2 * p2["per_device_high_water_bytes"] \
        == p1["per_device_high_water_bytes"]
    (w,) = p2["workers"]
    assert w["page_bytes"] == p2["per_device_hbm_bytes"]
    (s1,), (s2,) = p1["rank0_page_shapes"], p2["rank0_page_shapes"]
    assert s2 == [s1[0], s1[1], s1[2] // 2, s1[3]]
    assert w["kv_heads"] == s2[2]
    for d in (p1, p2):
        assert d["free_pages"] + d["live_pages"] == d["n_pages"] - 1
        assert d["leaks"] == 0


def test_workers_run_moe_decode_and_whole_prompt_prefill(runs):
    """Rank 1 ran one decode step per rank-0 step and one chunk step per
    prompt: an MoE prompt prefills whole, as one chunk."""
    for name in ("granite", "qwen2_scatter"):
        (w,) = runs["port"][f"{name}/tp2"]["workers"]
        assert w["decode_steps"] > 0, name
        assert w["chunk_steps"] == TRACE["n"], (name, w)


def test_logits_nan_fallback_walks_to_tp1_and_back(runs):
    """A seeded logits.nan injection at tp 2 degrades the engine, whose
    safe plan pins tp 1 (the pool and the experts back on rank 0), and
    recovers to tp 2; tokens and the health ladder's counts equal the
    JAX engine's."""
    p, j = runs["port"]["faults/tp2"], runs["jax"]["faults/tp2"]
    assert p["health"]["fallbacks"] >= 1
    assert p["health"] == j["health"]
    assert p["tokens"] == j["tokens"] and p["states"] == j["states"]
    assert p["degrees"][:2] == [1, 2], p["degrees"]
    assert p["mesh"]["tp"] == j["mesh"]["tp"]
    assert p["leaks"] == 0


def test_a_decided_degree_switch_reshards_and_keeps_tokens(runs):
    """In auto mode the decider's tp channel moves granite's serve
    between tp 1 and tp 2 with requests in flight: the pool is resharded
    each time, and the tokens are those of the fixed-degree serves."""
    a = runs["port"]["auto"]
    assert 2 in a["degrees"] and 1 in a["degrees"], a["degrees"]
    assert {c for d in a["decisions"] for _, c in d} == {"tp1", "tp2"}
    assert a["tokens"] == runs["port"]["granite/tp1"]["tokens"]
    assert a["leaks"] == 0 and set(a["states"]) == {"DONE"}


def test_tp2_moe_step_counters_match_jax_census(runs):
    """granite's tp-2 decode step counted on the meta device (one rank's
    shard and its collectives) against the JAX package's HLO count of
    its tp-2 step, per device, in the counters' 25% band, under the
    rules of ``tests/test_torch_tp_serving.py``: the total flops and the
    top regions' flops; the bytes as the cut each rank takes (tp-2 over
    tp-1 bytes) and on the logits region; the MoE regions' bytes at tp 1
    and tp 2 too.  The top five regions are the same five, region by
    region in the band, and not in the same order: JAX's count puts
    ``layer1/attn`` 7% under ``layer0/attn`` (its fusions differ by
    layer), below ``logits``, where the port's layers count alike.  The
    collectives differ by design: the port gathers each layer's router
    logits (an all-gather) and normalises them on every rank, where
    GSPMD's softmax over the split experts all-reduces their max and
    their sum and gathers the probabilities for the top-k (two
    all-reduces and an all-gather a layer); and the port replicates the
    logits with an all-reduce, where JAX gathers them."""
    p1, p2 = runs["port"]["counts/tp1"], runs["port"]["counts/tp2"]
    j1, j2 = runs["jax"]["counts/tp1"], runs["jax"]["counts/tp2"]
    band = lambda a, b: abs(a - b) <= 0.25 * b  # noqa: E731
    assert band(p2["flops"], j2["flops"]), (p2["flops"], j2["flops"])
    assert {r for r, _ in p2["top"]} == {r for r, _ in j2["top"]}
    for r, f in p2["top"]:
        assert band(f, j2["regions"][r][0]), (r, f, j2["regions"][r])
    assert band(p2["bytes"] / p1["bytes"], j2["bytes"] / j1["bytes"])
    assert band(p2["regions"]["logits"][1], j2["regions"]["logits"][1])
    for p, j in ((p1, j1), (p2, j2)):
        for r in ("layer0/moe", "layer1/moe"):
            assert band(p["regions"][r][1], j["regions"][r][1]), r
    n_layers = 2
    # embed, wo and the combine a layer, the logits; the router a layer
    assert p2["census"] == {"all-reduce": 1 + 2 * n_layers + 1,
                            "all-gather": n_layers}
    # embed, wo, the softmax's max and sum, the combine a layer; the
    # probabilities a layer and the logits
    assert j2["census"] == {"all-reduce": 1 + 4 * n_layers,
                            "all-gather": n_layers + 1}
    assert p1["census"] == {} and p1["collective_bytes"] == 0
    print(f"\n[tp moe counters] port {p2['flops']:.0f} flops "
          f"{p2['bytes']:.0f} bytes census {p2['census']}; JAX "
          f"{j2['flops']:.0f} flops {j2['bytes']:.0f} bytes census "
          f"{j2['census']}")


def test_launcher_serves_moe_over_two_ranks(runs):
    """``launch.serve --arch granite-moe-1b-a400m --tp 2`` on the CPU
    starts two gloo ranks and serves every request to its length (3 to
    6 tokens), and the ``[mesh]`` line says tp 2.  The tokens of tp 2
    against tp 1 are the engine tests' above."""
    two = runs["launch/tp2"]
    assert "[tp] 2 ranks on cpu over gloo (ranks share a device)" in two
    assert any(ln.startswith("[mesh] tp=2 devices=2") for ln in two)
    gen = [int(ln.split(" gen ")[1].split()[0]) for ln in two
           if ln.startswith("req ")]
    assert len(gen) == 4 and all(3 <= g <= 6 for g in gen), gen
    assert any(ln.startswith("continuous [cpu]: 4 requests, "
                             f"{sum(gen)} tokens") for ln in two)


def test_route_flips_finds_the_first_flipped_near_tie():
    """``chip_smoke.route_flips``, which says where a tp-2 serve's routes
    first part from tp 1's on the card, on route calls kept by
    ``routes_kept`` from hand-made inputs: two of reduced granite's
    experts tie on the input's first dim and its second breaks the tie;
    the second call's input breaks eleven of twelve tokens' ties the
    other way.  The witness names call 1 (layer 1), the eleven tokens,
    and a near-tie no wider than the probabilities moved."""
    import torch

    sys.path.insert(0, tps.ROOT)
    import chip_smoke as cs

    from repro_torch.configs.registry import get_config
    from repro_torch.models import moe
    cfg = get_config(GRANITE).reduced()
    e, k, d = moe.n_experts_padded(cfg), cfg.top_k, cfg.d_model
    router = torch.zeros(d, e)
    router[0] = torch.linspace(1.0, 0.0, e)
    router[0, k] = router[0, k - 1]
    router[1, k] = 1.0
    x = torch.zeros(3, 4, d)
    x[..., 0] = 1.0
    x[..., 1] = 1e-6 * torch.randn(
        3, 4, generator=torch.Generator().manual_seed(0))
    nudged = x.clone()
    nudged[..., 1] = -x[..., 1]
    nudged[0, 0, 1] = x[0, 0, 1]
    kept = {1: [], 2: []}
    for tp in (1, 2):
        with cs.routes_kept(kept[tp]):
            for call in range(cfg.n_layers + 1):
                inp = nudged if tp == 2 and call == 1 else x
                moe.route(cfg, {"router": router}, inp)
    flips = cs.route_flips(cfg, kept[1], kept[2])
    drift = flips["first_forward_input_rel_diff"]
    assert drift[0] == 0 and 0 < drift[1] < 1e-5 and len(drift) == 2
    first = flips["first"]
    assert (first["call"], first["layer"]) == (1, 1)
    assert first["input_max_abs"] == 1.0
    assert (first["tokens_flipped"], first["sets_flipped"],
            first["tokens"]) == (11, 11, 12)
    assert 0 < first["flipped_widest_gap"] <= first["prob_max_abs_diff"]
    assert cs.route_flips(cfg, kept[1], kept[1]) == {
        "calls": [cfg.n_layers + 1] * 2,
        "first_forward_input_rel_diff": [0.0] * cfg.n_layers,
        "first": None}
    assert moe.route is not None and moe.route.__name__ == "route"
