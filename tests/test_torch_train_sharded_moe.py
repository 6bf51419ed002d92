"""The port's sharded trainer on the MoE family over two gloo ranks on the
CPU, held against the JAX package's GSPMD train step on a forced
2-device mesh, as ``tests/test_torch_train_sharded_families.py`` holds
the other families (whose children and helpers this file runs).

Cases (``CASES``), reduced configs in f32 (8 experts, top-2):
granite-moe-1b-a400m at (data 1, model 2) (4 experts a rank, router
columns split) and at (data 2, model 1), batch 4 x seq 16: 64 global
tokens make one 64-token group across both data ranks, whose slots the
upper rank offsets by the lower's per-expert counts, at capacity factor
0.5 so that pairs overflow (``slot_peak`` >= capacity); qwen2-moe-a2.7b
at (1, 2) with its shared experts (an ff-split MLP and a replicated
gate); and a qwen2 of 6 experts padded to 8 at (1, 2), whose second rank
holds both pads.  Per case, as the families' file holds them, within
``GRAD_TOL``: two steps' losses, cross-entropies, aux losses and grad
norms; the params after them; and step 0's gradient leaf by leaf
(router, gate, up, down, shared/* and shared_gate among them: an aux
gradient counted once a rank, or a shared gate's once a rank, shows
there).  At (data 2, microbatch 2) (``MICRO``): granite (capacity
factor 0.5) and stablelm, two steps' losses and the params after them
against JAX's steps with ``microbatch=2``, each rank's rows laid out by
``sharding.microbatch_rows`` as the launcher lays them out.

Then, on the port alone: a decode step (``group='flat'``: one group of
the 8 rows) at (1, 2) and (2, 1) — and the scatter dispatch at (2, 1) —
over the default decode plan gives the one-rank decode's logits and
cache, at capacity factor 0.5 (pairs overflow); the scatter dispatch's
training gradient at (1, 2) equals its one-rank gradient leaf by leaf;
``param_shardings`` splits the router and the expert leaves on experts
(``ff`` whole) for both archs at 16x16 and (1, 2); ``elastic.reshard``
tiles them; and the launcher trains granite at model 2.
"""
import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_train_sharded_families as fam  # noqa: E402

GRANITE, QWEN2 = "granite-moe-1b-a400m", "qwen2-moe-a2.7b"
#: case -> (arch, fields of the reduced config replaced, (data, model))
CASES = {"granite_model2": (GRANITE, {}, (1, 2)),
         "granite_data2": (GRANITE, {"capacity_factor": 0.5}, (2, 1)),
         "qwen2_model2": (QWEN2, {}, (1, 2)),
         "qwen2_pad_model2": (QWEN2, {"n_experts": 6, "pad_experts_to": 8},
                              (1, 2))}
STABLELM = "stablelm-1.6b"
#: microbatches over data ranks: (arch, fields, (data, model, microbatch))
MICRO = {"granite_data2_mb2": (GRANITE, {"capacity_factor": 0.5},
                               (2, 1, 2)),
         "stablelm_data2_mb2": (STABLELM, {}, (2, 1, 2))}
DATA = {GRANITE: dict(seq=16, batch=4, seed=3),
        QWEN2: dict(seq=16, batch=4, seed=3),
        STABLELM: dict(seq=16, batch=4, seed=3)}
#: decode cases: (arch, fields, (data, model), moe_impl); 8 rows
DECODE = {"einsum_model2": (GRANITE, {"capacity_factor": 0.5}, (1, 2), ""),
          "einsum_data2": (GRANITE, {"capacity_factor": 0.5}, (2, 1), ""),
          "scatter_data2": (QWEN2, {"capacity_factor": 0.5}, (2, 1),
                            "scatter")}
#: the scatter dispatch's training step: (arch, fields, (data, model))
SCATTER = (QWEN2, {"n_experts": 6, "pad_experts_to": 8}, (1, 2))

_PORT_MOE = r"""
from repro_torch.models import moe as moe_mod

# the largest slot any (token, k) pair got, over the calls of a case: at
# or above the capacity, some pairs overflowed
_PEAK = [0]
_real_slots = moe_mod._slots


def _slots(*a, **k):
    s = _real_slots(*a, **k)
    _PEAK[0] = max(_PEAK[0], int(s.max()))
    return s


moe_mod._slots = _slots


def slot_peak():
    peak, _PEAK[0] = _PEAK[0], 0
    return peak


def plans(mesh, kind, impl):
    from repro_torch.core.policy import RegionConfig, RegionPlan, default_plan
    knob = {"moe": RegionConfig(moe_impl=impl)} if impl else {}
    plan = default_plan(mesh, kind)
    plan.region_configs.update(knob)
    return RegionPlan(region_configs=dict(knob)), plan


def decode_case(arch, fields, dims, impl):
    # one decode step over the default decode plan against the one-rank
    # step on the full cache; each rank's rows and cache blocks
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import comm
    from repro_torch.distributed import sharding as shard_mod
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L
    from repro_torch.models.model import build
    from repro_torch.train import elastic
    cfg = config(get_config, arch, fields)
    model = build(cfg)
    full = model.init(0, dtype=torch.float32, device="cpu")
    mesh = make_host_mesh(data=dims[0], model=dims[1])
    one_plan, plan = plans(mesh, "decode", impl)
    B, C = 8, 16
    gen = torch.Generator().manual_seed(1)
    cache = model.init_cache(B, C, dtype=torch.float32, device="cpu")
    for t in L.tree_leaves({k: v for k, v in cache.items() if k != "pos"}):
        t.normal_(generator=gen)
    cache["pos"] = torch.randint(1, C - 1, (B,), generator=gen,
                                 dtype=torch.int32)
    tokens = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen)
    slot_peak()
    want, want_cache = model.decode(full, L.tree_map(torch.clone, cache),
                                    tokens, one_plan)
    peak = slot_peak()
    c_sh = shard_mod.cache_shardings(plan, cache)
    t_sh = shard_mod.batch_shardings(plan, {"tokens": tokens})["tokens"]
    coords = shard_mod.mesh_coords(mesh)
    local = shard_mod._map2(
        lambda t, sp: shard_mod.shard_leaf(t.clone(), sp, mesh, coords),
        cache, c_sh)
    # the slot cache's one position a row, whose spec is the JAX
    # package's scalar's (whole), goes with the rank's rows
    local["pos"] = shard_mod.shard_leaf(cache["pos"], t_sh, mesh, coords)
    params = elastic.reshard(full, model.logical_axes(), plan, device="cpu")
    logits, new = model.decode(
        params, local, shard_mod.shard_leaf(tokens, t_sh, mesh, coords),
        plan)
    logits = comm.replicate_vocab(logits.contiguous(), cfg.vocab_size, mesh)
    want = shard_mod.leaf_block(want, t_sh, mesh, coords)
    errs = {}
    c_sh["pos"] = t_sh
    for k, got in flat(new).items():
        w = shard_mod.leaf_block(flat(want_cache)[k], flat(c_sh)[k], mesh,
                                 coords)
        assert got.shape == w.shape, (k, got.shape, w.shape)
        errs[k] = float((got.float() - w.float()).abs().max()
                        / max(float(w.float().abs().max()), 1.0))
    return {"max_abs": float((logits - want).abs().max()),
            "scale": float(want.abs().max()), "rows": int(logits.shape[0]),
            "cache_err": max(errs.values()), "slot_peak": peak,
            "capacity": moe_mod.capacity(cfg, B)}


def scatter_case(d, arch, fields, dims, dd):
    # the scatter dispatch's step-0 loss and gradient over the mesh (each
    # rank's reduced blocks reassembled) and on one rank
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.distributed import sharding as shard_mod
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L
    from repro_torch.models.model import build, params_from_numpy
    from repro_torch.train import elastic, trainer
    cfg = config(get_config, arch, fields)
    model = build(cfg)
    full = params_from_numpy(load(os.path.join(
        d, cfg_tag(arch, fields) + ".npz")), device="cpu")
    batch = dict(batch_at(DataConfig(cfg.vocab_size, dd["seq"], dd["batch"],
                                     seed=dd["seed"]), 0, "cpu"))
    mesh = make_host_mesh(data=dims[0], model=dims[1])
    one_plan, plan = plans(mesh, "train", "scatter")
    (loss1, m1), g1 = trainer.make_grad_fn(model, one_plan)(full, batch)
    p_sh = shard_mod.param_shardings(model, plan)
    o_sh = shard_mod.opt_state_shardings(model, plan)
    sync = trainer._GradSync(model, plan, p_sh, o_sh["mu"])
    params = elastic.reshard(L.tree_map(torch.clone, full),
                             model.logical_axes(), plan, device="cpu")
    coords = shard_mod.mesh_coords(mesh)
    b_sh = shard_mod.batch_shardings(plan, batch)
    local = {k: shard_mod.shard_leaf(v, b_sh[k], mesh, coords)
             for k, v in batch.items()}
    (loss2, m2), g2 = trainer.make_grad_fn(model, plan)(params, local)
    loss2, m2 = sync.mean_metrics(loss2, m2)
    assert all(z is None for z in sync.zdims)
    g2 = gather_full(g2, p_sh, mesh, shard_mod)
    return ({"loss": [loss1.item(), loss2.item()],
             "aux": [m1["aux"].item(), m2["aux"].item()]},
            {k: v.numpy() for k, v in flat(g1).items()}, g2)


def run(d, cases, opt, data, decode, scatter):
    import torch.distributed as dist
    out = {}
    for name, (arch, fields, dims) in cases.items():
        slot_peak()
        out[name], got, grads = train_case(d, arch, fields, dims, opt,
                                           data[arch])
        out[name]["slot_peak"] = slot_peak()
        if dist.get_rank() == 0:
            np.savez(os.path.join(d, f"port_{name}.npz"), **got)
            np.savez(os.path.join(d, f"portgrad_{name}.npz"), **grads)
    out["decode"] = {name: decode_case(*a) for name, a in decode.items()}
    out["scatter"], one, two = scatter_case(d, *scatter, data[scatter[0]])
    if dist.get_rank() == 0:
        np.savez(os.path.join(d, "scatter_one.npz"), **one)
        np.savez(os.path.join(d, "scatter_two.npz"), **two)
    res = [None] * dist.get_world_size()
    dist.all_gather_object(res, out)
    if dist.get_rank() == 0:
        print("SHJSON " + json.dumps(res))


if __name__ == "__main__":
    from repro_torch.launch.mesh import start_ranks
    import torch.distributed as dist
    args = (sys.argv[1],) + tuple(json.loads(a) for a in sys.argv[2:])
    store, procs = start_ranks(2, rank_main, args)
    dist.init_process_group("gloo", store=store, rank=0, world_size=2)
    run(*args)
    dist.destroy_process_group()
    for p in procs:
        p.join(timeout=120)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port child beside two JAX children, each of which compiles
    half of the cases' GSPMD steps."""
    d = str(tmp_path_factory.mktemp("sharded_moe"))
    cases = {**CASES, **MICRO}
    for arch, fields, _ in list(cases.values()) + [SCATTER]:
        np.savez(os.path.join(d, fam._CHILD["cfg_tag"](arch, fields)
                              + ".npz"), **fam._numpy_params(arch, fields))
    script = os.path.join(d, "port_child.py")
    with open(script, "w") as f:
        f.write(fam._PORT_TRAIN + _PORT_MOE)
    names = sorted(cases)
    halves = [{n: cases[n] for n in names[i::2]} for i in range(2)]
    tail = [json.dumps(fam.OPT), json.dumps(DATA)]
    procs = {f"jax{i}": subprocess.Popen(
        [sys.executable, "-c", fam._JAX_CHILD, d, json.dumps(h)] + tail,
        env=fam._env(), cwd=d, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i, h in enumerate(halves)}
    procs["port"] = subprocess.Popen(
        [sys.executable, script, d, json.dumps(cases)] + tail
        + [json.dumps(DECODE), json.dumps(SCATTER)], env=fam._env(), cwd=d,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    got = {name: fam._parse(p, name) for name, p in procs.items()}
    jax_res = {}
    for i in range(2):
        jax_res.update(got[f"jax{i}"])
    return {"jax": jax_res, "port": got["port"], "dir": d}


def _cfg(arch, fields):
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config(arch).reduced(), **fields)


def _worst_leaf(got, want) -> tuple:
    """The worst leaf's |got - want| norm over its ``GRAD_TOL`` band at
    the leaf's norm, and its name."""
    assert sorted(got.files) == sorted(want.files)
    worst = (0.0, None)
    for k in want.files:
        w = want[k].astype(np.float64)
        assert got[k].shape == w.shape, k
        gap = np.linalg.norm(got[k].astype(np.float64) - w)
        band = (fam.GRAD_TOL["atol"] * np.sqrt(w.size)
                + fam.GRAD_TOL["rtol"] * np.linalg.norm(w))
        worst = max(worst, (gap / band, k))
    return worst


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_steps_match_jax(runs, case):
    """Losses, cross-entropies, aux losses and grad norms of two steps
    against the JAX package's GSPMD steps on both ranks, within
    ``GRAD_TOL`` at each value's scale; step 0's loss equals the port's
    one-rank step's (rtol 1e-5), its aux and grad norm too (rtol 1e-4).
    The data-2 case's one group across ranks overflows its capacity."""
    assert runs["jax"]["n_devices"] == 2
    want = runs["jax"][case]
    assert want["mesh"] == dict(zip(("data", "model"), CASES[case][2]))
    for rank in runs["port"]:
        got = rank[case]
        assert got["mesh"] == list(CASES[case][2])
        for key in fam._CHILD["METRICS"]:
            for i in range(2):
                gap = abs(got[key][i] - want[key][i])
                assert gap <= fam._tol(want[key][i]), (key, i, got[key],
                                                       want[key])
        assert got["aux"][0] > 0
        np.testing.assert_allclose(got["loss"][0], got["one"]["loss"][0],
                                   rtol=1e-5)
        for key in ("aux", "grad_norm"):
            np.testing.assert_allclose(got[key][0], got["one"][key][0],
                                       rtol=1e-4)
    if case == "granite_data2":
        from repro_torch.models import moe
        cfg = _cfg(*CASES[case][:2])
        tokens = DATA[GRANITE]["batch"] * DATA[GRANITE]["seq"]
        assert runs["port"][0][case]["slot_peak"] >= moe.capacity(cfg, tokens)


@pytest.mark.parametrize("case", sorted(MICRO))
def test_microbatches_over_data_ranks_match_jax(runs, case):
    """At (data 2, microbatch 2) each rank's local microbatch i is its
    half of the JAX package's microbatch i of the global batch
    (``sharding.microbatch_rows``, as the launcher hands the rows out):
    two steps' losses within 1e-5 (relative) of the JAX package's GSPMD
    steps with ``microbatch=2``, their aux losses, cross-entropies and
    grad norms within ``GRAD_TOL``, and every param after them within
    ``GRAD_TOL``; step 0's loss equals the port's one-rank step's at
    microbatch 2.  granite's microbatch of 32 tokens is one group across
    both ranks at capacity factor 0.5 (pairs overflow), so a microbatch
    of other rows would route, drop and balance other tokens: with each
    rank slicing microbatches out of its own contiguous rows, step 0's
    loss stands 2.6e-4 (relative) off JAX's.  stablelm's loss is the
    same for any split of the rows."""
    want = runs["jax"][case]
    assert want["mesh"] == {"data": 2, "model": 1}
    for rank in runs["port"]:
        got = rank[case]
        assert got["mesh"] == [2, 1]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        for key in fam._CHILD["METRICS"]:
            for i in range(2):
                gap = abs(got[key][i] - want[key][i])
                assert gap <= fam._tol(want[key][i]), (key, i, got[key],
                                                       want[key])
        np.testing.assert_allclose(got["loss"][0], got["one"]["loss"][0],
                                   rtol=1e-5)
    if MICRO[case][0] == GRANITE:
        from repro_torch.models import moe
        cfg = _cfg(*MICRO[case][:2])
        tokens = DATA[GRANITE]["batch"] * DATA[GRANITE]["seq"] // 2
        assert runs["port"][0][case]["aux"][0] > 0
        assert runs["port"][0][case]["slot_peak"] >= moe.capacity(cfg,
                                                                  tokens)
    d = runs["dir"]
    got = np.load(os.path.join(d, f"port_{case}.npz"))
    want = np.load(os.path.join(d, f"jax_{case}.npz"))
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        gap = np.abs(got[k].astype(np.float64) - want[k]).max()
        assert gap <= fam._tol(want[k]), (k, gap)


def test_microbatch_rows_lay_out_the_global_microbatches():
    """``microbatch_rows`` over (data 2): rank r's local microbatch i is
    rows ``[i*B/mb + r*B/(mb*R), i*B/mb + (r+1)*B/(mb*R))`` of the global
    batch; at microbatch 1 it is ``shard_leaf``'s contiguous block."""
    from repro_torch.core.policy import default_plan
    from repro_torch.distributed import sharding as shard_mod
    B, mb, R = 8, 2, 2
    x = torch.arange(B * 3).reshape(B, 3)
    for r in range(R):
        mesh = types.SimpleNamespace(shape={"data": R, "model": 1},
                                     coords={"data": r, "model": 0})
        spec = shard_mod.batch_shardings(default_plan(mesh, "train"),
                                         {"tokens": x})["tokens"]
        got = shard_mod.microbatch_rows(x, spec, mesh, mesh.coords, mb)
        rows = [i * B // mb + r * B // (mb * R) + j for i in range(mb)
                for j in range(B // (mb * R))]
        assert torch.equal(got, x[rows])
        assert torch.equal(
            shard_mod.microbatch_rows(x, spec, mesh, mesh.coords, 1),
            shard_mod.shard_leaf(x, spec, mesh, mesh.coords))
    with pytest.raises(ValueError, match="microbatches"):
        shard_mod.microbatch_rows(x[:6], spec, mesh, mesh.coords, 2)


@pytest.mark.parametrize("case", sorted(CASES))
def test_step0_gradient_leaf_by_leaf_matches_jax(runs, case):
    """Step 0's gradient of every leaf, as the sharded step reduces it
    (each rank's blocks reassembled), against the JAX package's GSPMD
    gradient under the same specs: the difference's norm within
    ``GRAD_TOL`` of the leaf's norm.  The router's gradient is almost all
    the combine weights' and the aux's: one counted once a rank would be
    off by a multiple of its norm here."""
    d = runs["dir"]
    worst = _worst_leaf(np.load(os.path.join(d, f"portgrad_{case}.npz")),
                        np.load(os.path.join(d, f"jaxgrad_{case}.npz")))
    assert worst[0] <= 1.0, worst


@pytest.mark.parametrize("case", sorted(CASES))
def test_params_after_two_steps_match_jax(runs, case):
    """Every param after two steps, each rank's blocks reassembled,
    within ``GRAD_TOL`` at the leaf's scale of JAX's."""
    d = runs["dir"]
    got = np.load(os.path.join(d, f"port_{case}.npz"))
    want = np.load(os.path.join(d, f"jax_{case}.npz"))
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        w = want[k]
        assert got[k].shape == w.shape, k
        gap = np.abs(got[k].astype(np.float64) - w).max()
        assert gap <= fam._tol(w), (k, gap)


@pytest.mark.parametrize("name", sorted(DECODE))
def test_decode_over_the_mesh_gives_the_one_rank_step(runs, name):
    """The default decode plan's step (``group='flat'``: the 8 rows one
    group, across both data ranks at (2, 1)): each rank's rows' logits
    within 1e-5 at their scale of the one-rank decode's and every leaf of
    its cache within 1e-5 of that block of the one-rank cache's; the
    group overflows its capacity."""
    _, _, (data, _), _ = DECODE[name]
    for rank in runs["port"]:
        d = rank["decode"][name]
        assert d["rows"] == 8 // data
        assert d["max_abs"] <= 1e-5 + 1e-5 * d["scale"], d
        assert d["cache_err"] <= 1e-5, d
        assert d["slot_peak"] >= d["capacity"], d


def test_scatter_dispatch_over_the_mesh_gives_the_one_rank_step(runs):
    """``moe_impl='scatter'`` at (1, 2) on the padded qwen2: step 0's loss
    and aux within 1e-5 of the one-rank step's, and its gradient leaf by
    leaf within ``GRAD_TOL``."""
    for rank in runs["port"]:
        for key in ("loss", "aux"):
            one, two = rank["scatter"][key]
            assert abs(two - one) <= 1e-5 * abs(one), (key, one, two)
    d = runs["dir"]
    worst = _worst_leaf(np.load(os.path.join(d, "scatter_two.npz")),
                        np.load(os.path.join(d, "scatter_one.npz")))
    assert worst[0] <= 1.0, worst


@pytest.mark.parametrize("dims", [(16, 16), (1, 2)])
@pytest.mark.parametrize("arch", [GRANITE, QWEN2])
def test_param_shardings_split_the_experts(arch, dims):
    """At full width, the router's columns and the expert leaves' experts
    split over ``model`` (``ff`` whole: the axis is taken), the shared
    experts' ff split and their gate replicated."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.policy import default_plan
    from repro_torch.distributed import sharding as shard_mod
    from repro_torch.models.model import build
    mesh = types.SimpleNamespace(shape=dict(zip(("data", "model"), dims)))
    specs = shard_mod.param_shardings(build(get_config(arch)),
                                      default_plan(mesh, "train"))
    mlp = specs["blocks"]["mlp"]
    assert mlp["router"] == (None, None, "model")
    for k in ("gate", "up", "down"):
        assert mlp[k] == (None, "model"), (k, mlp[k])
    if arch == QWEN2:
        assert mlp["shared"]["up"] == mlp["shared"]["gate"] == (
            None, None, "model")
        assert mlp["shared"]["down"] == (None, "model")
        assert mlp["shared_gate"] == ()


@pytest.mark.parametrize("arch", [GRANITE, QWEN2])
@pytest.mark.parametrize("data,model", [(2, 1), (1, 2)])
def test_reshard_tiles_the_expert_leaves(arch, data, model):
    """``elastic.reshard`` on every rank of a (data, model) stand-in mesh:
    each leaf's blocks have the spec's local shape and tile the leaf."""
    from repro_torch.core.policy import default_plan
    from repro_torch.distributed import sharding as shard_mod
    from repro_torch.models import layers as L
    from repro_torch.models.model import build
    from repro_torch.train import elastic
    model_ = build(_cfg(arch, {}))
    full = model_.init(0, dtype=torch.float32, device="cpu")
    bufs = L.tree_map(torch.zeros_like, full)
    experts = 0
    for i in range(data):
        for j in range(model):
            mesh = types.SimpleNamespace(shape={"data": data, "model": model},
                                         coords={"data": i, "model": j})
            plan = default_plan(mesh, "train")
            blocks = elastic.reshard(full, model_.logical_axes(), plan,
                                     device="cpu")
            specs = shard_mod.param_shardings(model_, plan)
            for buf, blk, sp, w in zip(
                    L.tree_leaves(bufs), L.tree_leaves(blocks),
                    L.tree_leaves(specs), L.tree_leaves(full)):
                assert blk.shape == shard_mod.local_shape(w.shape, sp, mesh)
                shard_mod.leaf_block(buf, sp, mesh, mesh.coords).copy_(blk)
            experts = blocks["blocks"]["mlp"]["gate"].shape[1]
    for buf, w in zip(L.tree_leaves(bufs), L.tree_leaves(full)):
        assert torch.equal(buf, w)
    assert experts == 8 // model


def test_launcher_trains_granite_over_two_ranks(tmp_path):
    """``launch.train --ranks 2 --model 2`` on granite: each rank holds 4
    of the 8 experts, both end with the same finite losses and aux
    losses, each step's aux > 0."""
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--dtype", "float32", "--arch", GRANITE, "--ranks", "2", "--model",
         "2", "--steps", "2", "--batch", "2", "--seq", "16", "--log-every",
         "1", "--stats-out", str(tmp_path / "stats.json")],
        env=fam._env(), cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    stats = json.loads((tmp_path / "stats.json").read_text())["ranks"]
    assert [s["rank"] for s in stats] == [0, 1]
    assert [s["experts"] for s in stats] == [4, 4]
    for key in ("loss", "aux"):
        assert stats[0][key] == stats[1][key]
        assert np.all(np.isfinite(stats[0][key]))
    assert min(stats[0]["aux"]) > 0
