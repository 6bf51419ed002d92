"""The port's sharded trainer over two gloo ranks on the CPU, held
against the JAX package's trainer on a forced 2-device mesh: reduced
stablelm-1.6b in f32 on the same params (the JAX package's ``init``,
bridged through one ``.npz``) and the same pipeline batches.

Cases: (data 2) with ZeRO-1 moments, and (model 2).  Two steps' losses
within rtol 1e-5; the params after them, each rank's blocks reassembled,
within ``GRAD_TOL`` of ``tests/test_torch_train.py`` (at the leaf's
scale) of JAX's; the step-0 grad norm equal (rtol 1e-5) to the unsharded
step's.  AdamW runs at eps 1e-3 on both sides: at the default 1e-8 the
first updates are about lr * sign(g), and gradient elements at rounding
level would move a param by up to lr in either package.  Then, on the
port alone: a decode step over a cache whose ``kv_seq`` is split over
``model`` (the JAX package's default decode plan) gives the one-rank
decode's logits and cache, ``elastic.reshard``'s blocks reassemble to
the full leaves, and ``launch.train --ranks 2`` ends with a finite loss.

Two subprocesses run side by side, as in ``tests/test_torch_tp_serving.py``:
the JAX child (``XLA_FLAGS`` must predate jax's backend init) and the
port child, a script whose rank 0 spawns rank 1 and meets it through a
TCP store on a free port.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "stablelm-1.6b"
CASES = {"data2": (2, 1), "model2": (1, 2)}
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
OPT = dict(lr=1e-3, eps=1e-3)
DATA = dict(seq=16, batch=4, seed=3)

_COMMON = r"""
import json, os, sys
import numpy as np


def load(path):
    z = np.load(path)
    tree = {}
    for k in z.files:
        node = tree
        *path_, leaf = k.split("/")
        for p in path_:
            node = node.setdefault(p, {})
        node[leaf] = z[k]
    return tree


def flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out
"""

_JAX_CHILD = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax
import jax.numpy as jnp
""" + _COMMON + r"""
from repro.configs.registry import get_config
from repro.core.policy import default_plan, null_plan
from repro.data.pipeline import DataConfig, batch_at
from repro.distributed import sharding as sh
from repro.launch.mesh import make_host_mesh
from repro.models.model import build
from repro.optim import adamw
from repro.train import trainer

d, cases, opt, data = (sys.argv[1], json.loads(sys.argv[2]),
                       json.loads(sys.argv[3]), json.loads(sys.argv[4]))
cfg = get_config(sys.argv[5]).reduced()
model = build(cfg)
full = jax.tree.map(jnp.asarray, load(os.path.join(d, "params.npz")))
dc = DataConfig(cfg.vocab_size, data["seq"], data["batch"], seed=data["seed"])
batches = [jax.tree.map(jnp.asarray, batch_at(dc, s)) for s in range(2)]
ocfg = adamw.AdamWConfig(**opt)
out = {"n_devices": len(jax.devices())}
step = jax.jit(trainer.make_train_step(model, null_plan(), opt_cfg=ocfg,
                                       schedule_total=2))
p, o, m = step(full, adamw.init_state(full), batches[0])
out["unsharded"] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
for name, (data_, model_) in cases.items():
    mesh = make_host_mesh(data=data_, model=model_)
    plan = default_plan(mesh, "train")
    p_sh = sh.param_shardings(model, plan)
    o_sh = sh.opt_state_shardings(model, plan)
    b_sh = sh.batch_shardings(plan, batches[0])
    fn = jax.jit(trainer.make_train_step(
        model, plan, opt_cfg=ocfg, schedule_total=2, grad_shardings=p_sh,
        opt_shardings=o_sh["mu"]), in_shardings=(p_sh, o_sh, b_sh),
        out_shardings=(p_sh, o_sh, None))
    p = jax.device_put(full, p_sh)
    o = jax.device_put(adamw.init_state(full), o_sh)
    losses, norms = [], []
    for b in batches:
        p, o, m = fn(p, o, jax.device_put(b, b_sh))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out[name] = {"loss": losses, "grad_norm": norms,
                 "mesh": dict(mesh.shape)}
    np.savez(os.path.join(d, f"jax_{name}.npz"),
             **flat(jax.tree.map(np.asarray, p)))
print("SHJSON " + json.dumps(out))
"""

_PORT_CHILD = r"""
import os, sys, json
import numpy as np
import torch
torch.set_num_threads(2)
""" + _COMMON + r"""


def rank_main(rank, world, port, d, cases, opt, data, arch):
    import torch.distributed as dist
    from repro_torch.launch.mesh import worker_store
    store = worker_store(rank, world, port)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    run(d, cases, opt, data, arch)
    dist.destroy_process_group()


def gather_full(params, specs, mesh, L, shard_mod):
    # every rank's blocks, written into full leaves on rank 0
    import torch.distributed as dist
    mine = (shard_mod.mesh_coords(mesh),
            {k: v.numpy() for k, v in flat_t(params, L).items()})
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, mine)
    spec_of = flat_specs(specs)
    full = {}
    for coords, blocks in got:
        for k, blk in blocks.items():
            shape = list(blk.shape)
            for i, e in enumerate(spec_of[k]):
                if e is not None:
                    shape[i] *= shard_mod.mesh_shape(mesh)[e]
            buf = full.setdefault(k, torch.zeros(shape))
            shard_mod.leaf_block(buf, spec_of[k], mesh, coords).copy_(
                torch.from_numpy(blk))
    return {k: v.numpy() for k, v in full.items()}


def flat_specs(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat_specs(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def flat_t(tree, L, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat_t(v, L, prefix + k + "/"))
        else:
            out[prefix + k] = v.detach()
    return out


def run(d, cases, opt, data, arch):
    import torch.distributed as dist
    from repro_torch.configs.registry import get_config
    from repro_torch.core.policy import default_plan, null_plan
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.distributed import comm
    from repro_torch.distributed import sharding as shard_mod
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L
    from repro_torch.models.model import build, params_from_numpy
    from repro_torch.optim import adamw
    from repro_torch.train import elastic, trainer
    cfg = get_config(arch).reduced()
    model = build(cfg)
    full = params_from_numpy(load(os.path.join(d, "params.npz")),
                             device="cpu")
    dc = DataConfig(cfg.vocab_size, data["seq"], data["batch"],
                    seed=data["seed"])
    ocfg = adamw.AdamWConfig(**opt)
    p1 = L.tree_map(torch.clone, full)
    _, _, m = trainer.make_train_step(model, null_plan(), opt_cfg=ocfg,
                                      schedule_total=2)(
        p1, adamw.init_state(p1), batch_at(dc, 0, "cpu"))
    out = {"unsharded": {"loss": m["loss"].item(),
                         "grad_norm": m["grad_norm"].item()}}
    for name, (data_, model_) in cases.items():
        mesh = make_host_mesh(data=data_, model=model_)
        plan = default_plan(mesh, "train")
        p_sh = shard_mod.param_shardings(model, plan)
        o_sh = shard_mod.opt_state_shardings(model, plan)
        coords = shard_mod.mesh_coords(mesh)
        params = elastic.reshard(L.tree_map(torch.clone, full),
                                 model.logical_axes(), plan, device="cpu")
        zeros = lambda a, sp: torch.zeros(shard_mod.local_shape(
            tuple(a.shape), sp, mesh))
        ab = model.abstract_params()
        opt_state = {"step": torch.zeros((), dtype=torch.int32),
                     "mu": shard_mod._map2(zeros, ab, o_sh["mu"]),
                     "nu": shard_mod._map2(zeros, ab, o_sh["nu"])}
        step = trainer.make_train_step(model, plan, opt_cfg=ocfg,
                                       schedule_total=2, grad_shardings=p_sh,
                                       opt_shardings=o_sh["mu"])
        b_sh = shard_mod.batch_shardings(
            plan, {"tokens": (data["batch"], data["seq"]),
                   "labels": (data["batch"], data["seq"])})
        losses, norms = [], []
        for s in range(2):
            b = {k: shard_mod.shard_leaf(v, b_sh[k], mesh, coords)
                 for k, v in batch_at(dc, s, "cpu").items()}
            params, opt_state, m = step(params, opt_state, b)
            losses.append(m["loss"].item())
            norms.append(m["grad_norm"].item())
        moment = sum(t.numel() * 4 for t in
                     L.tree_leaves({"mu": opt_state["mu"],
                                    "nu": opt_state["nu"]}))
        got = gather_full(params, p_sh, mesh, L, shard_mod)
        out[name] = {"loss": losses, "grad_norm": norms,
                     "moment_bytes": moment, "mesh": list(mesh.shape)}
        if dist.get_rank() == 0:
            np.savez(os.path.join(d, f"port_{name}.npz"), **got)

    # decode over a cache whose kv_seq is split over model (the default
    # decode plan), against the one-rank decode on the full cache
    mesh = make_host_mesh(data=1, model=2)
    plan = default_plan(mesh, "decode")
    B, C = 2, 16
    gen = torch.Generator().manual_seed(1)
    cache = model.init_cache(B, C, dtype=torch.float32, device="cpu")
    for t in L.tree_leaves(cache["layers"]):
        t.normal_(generator=gen)
    cache["pos"] = torch.tensor([5, 12], dtype=torch.int32)
    tokens = torch.tensor([[7], [200]])
    want, want_cache = model.decode(full, L.tree_map(torch.clone, cache),
                                    tokens, null_plan())
    p_sh = shard_mod.param_shardings(model, plan)
    c_sh = shard_mod.cache_shardings(plan, cache)
    coords = shard_mod.mesh_coords(mesh)
    local = shard_mod._map2(
        lambda t, sp: shard_mod.shard_leaf(t.clone(), sp, mesh, coords),
        cache, c_sh)
    params = elastic.reshard(full, model.logical_axes(), plan, device="cpu")
    before = [t.clone() for t in L.tree_leaves(local["layers"])]
    logits, new = model.decode(params, local, tokens, plan)
    changed = sum(int((a != b).any(-1).any(-1).sum())
                  for a, b in zip(before, L.tree_leaves(new["layers"])))
    logits = comm.replicate_vocab(logits.contiguous(), cfg.vocab_size, mesh)
    k_rows = [blk.shape[1] for blk in L.tree_leaves(new["layers"])]
    cache_err = max(
        float((got - shard_mod.shard_leaf(w, sp, mesh, coords)).abs().max())
        for got, w, sp in zip(L.tree_leaves(new["layers"]),
                              L.tree_leaves(want_cache["layers"]),
                              L.tree_leaves(c_sh["layers"])))
    out["decode"] = {"max_abs": float((logits - want).abs().max()),
                     "scale": float(want.abs().max()),
                     "cache_rows": sorted(set(k_rows)),
                     "cache_err": cache_err, "changed_rows": changed,
                     "spec": [list(map(str, s)) for s in
                              L.tree_leaves(c_sh["layers"])][:1]}
    res = [None] * dist.get_world_size()
    dist.all_gather_object(res, out)
    if dist.get_rank() == 0:
        print("SHJSON " + json.dumps(res))


if __name__ == "__main__":
    from repro_torch.launch.mesh import start_ranks
    import torch.distributed as dist
    args = (sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3]),
            json.loads(sys.argv[4]), sys.argv[5])
    store, procs = start_ranks(2, rank_main, args)
    dist.init_process_group("gloo", store=store, rank=0, world_size=2)
    run(*args)
    dist.destroy_process_group()
    for p in procs:
        p.join(timeout=120)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
"""


def _parse(proc, name):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, f"{name} child failed:\n{err[-6000:]}"
    line = [ln for ln in out.splitlines() if ln.startswith("SHJSON ")][-1]
    return json.loads(line[len("SHJSON "):])


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import get_config
    from repro.models.model import build
    d = str(tmp_path_factory.mktemp("sharded"))
    params = build(get_config(ARCH).reduced()).init(jax.random.PRNGKey(0),
                                                    dtype=jnp.float32)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(os.path.join(d, "params.npz"), **flat)
    script = os.path.join(d, "port_child.py")
    with open(script, "w") as f:
        f.write(_PORT_CHILD)
    argv = [d, json.dumps(CASES), json.dumps(OPT), json.dumps(DATA), ARCH]
    procs = {"jax": subprocess.Popen(
        [sys.executable, "-c", _JAX_CHILD] + argv, env=_env(), cwd=d,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        "port": subprocess.Popen(
        [sys.executable, script] + argv, env=_env(), cwd=d,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
    res = {name: _parse(p, name) for name, p in procs.items()}
    res["dir"] = d
    return res


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_steps_losses_match_jax(runs, case):
    assert runs["jax"]["n_devices"] == 2
    want = runs["jax"][case]
    assert runs["jax"][case]["mesh"] == dict(zip(("data", "model"),
                                                 CASES[case]))
    for rank in runs["port"]:
        got = rank[case]
        assert got["mesh"] == list(CASES[case])
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert np.all(np.isfinite(got["grad_norm"]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_grad_norm_is_the_unsharded_steps(runs, case):
    """Every rank clips by the norm of the whole gradient: a replicated
    leaf counted once, a split one summed over its ranks.  Step 0's norm
    equals the port's unsharded step's (rtol 1e-5); that one and each
    step's against JAX's within 1e-4 (the two packages' f32 gradients
    differ at that level: ``tests/test_torch_train.py``)."""
    for rank in runs["port"]:
        one = rank["unsharded"]
        np.testing.assert_allclose(rank[case]["grad_norm"][0],
                                   one["grad_norm"], rtol=1e-5)
        np.testing.assert_allclose(rank[case]["loss"][0], one["loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(one["grad_norm"],
                                   runs["jax"]["unsharded"]["grad_norm"],
                                   rtol=1e-4)
        np.testing.assert_allclose(rank[case]["grad_norm"],
                                   runs["jax"][case]["grad_norm"], rtol=1e-4)


@pytest.mark.parametrize("case", sorted(CASES))
def test_params_after_two_steps_match_jax(runs, case):
    got = np.load(os.path.join(runs["dir"], f"port_{case}.npz"))
    want = np.load(os.path.join(runs["dir"], f"jax_{case}.npz"))
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        w = want[k]
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(
            got[k], w, rtol=0,
            atol=GRAD_TOL["atol"] + GRAD_TOL["rtol"] * np.abs(w).max(),
            err_msg=k)


def test_zero1_halves_each_ranks_moments(runs):
    """Under (data 2) every moment leaf of reduced stablelm has a dim 2
    divides: each rank holds half of the unsharded moments' bytes; under
    (model 2) a rank holds the moments of its param blocks."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import layers as L
    from repro_torch.models.model import build
    model = build(get_config(ARCH).reduced())
    full = 2 * 4 * sum(int(np.prod(s.shape))
                       for s in L.tree_leaves(model.spec()))
    for rank in runs["port"]:
        assert rank["data2"]["moment_bytes"] * 2 == full
        assert rank["model2"]["moment_bytes"] < full


def test_decode_over_a_split_kv_seq_gives_the_one_rank_logits(runs):
    """The default decode plan splits the cache's kv_seq over model: each
    rank holds 8 of 16 rows, writes the new row only where it holds it,
    and the log-sum-exp combine gives the one-rank decode's logits (f32,
    1e-5 at their scale); each rank's cache block is that block of the
    one-rank cache after the step (the rows written from layer 1 on carry
    the rounding of the combine's other summation order)."""
    for rank in runs["port"]:
        d = rank["decode"]
        assert d["cache_rows"] == [8]
        assert d["max_abs"] <= 1e-5 + 1e-5 * d["scale"], d
        assert d["cache_err"] <= 1e-5, d
    # one new row a batch row, k and v, each layer: written on one rank
    assert sum(r["decode"]["changed_rows"] for r in runs["port"]) == 2 * 2 * 2


@pytest.mark.parametrize("data,model", [(2, 1), (1, 2), (2, 2)])
def test_reshard_blocks_reassemble_to_the_full_leaf(data, model):
    """``elastic.reshard`` on every rank of a (data, model) mesh (stand-in
    meshes with coordinates): the blocks of each leaf tile it exactly,
    and each split block has a storage of its own."""
    import types

    from repro_torch.configs.registry import get_config
    from repro_torch.core.policy import default_plan
    from repro_torch.distributed import sharding as shard_mod
    from repro_torch.models import layers as L
    from repro_torch.models.model import build
    from repro_torch.train import elastic
    model_ = build(get_config(ARCH).reduced())
    full = model_.init(0, dtype=torch.float32, device="cpu")
    axes = model_.logical_axes()
    bufs = L.tree_map(torch.zeros_like, full)
    cover = L.tree_map(torch.zeros_like, full)
    split = 0
    for i in range(data):
        for j in range(model):
            mesh = types.SimpleNamespace(shape={"data": data, "model": model},
                                         coords={"data": i, "model": j})
            plan = default_plan(mesh, "train")
            blocks = elastic.reshard(full, axes, plan, device="cpu")
            specs = shard_mod.param_shardings(model_, plan)
            for buf, cov, blk, sp, w in zip(
                    L.tree_leaves(bufs), L.tree_leaves(cover),
                    L.tree_leaves(blocks), L.tree_leaves(specs),
                    L.tree_leaves(full)):
                assert blk.shape == shard_mod.local_shape(w.shape, sp, mesh)
                split += blk.shape != w.shape
                # a block holds its own storage, never a view of the full
                # leaf (which would keep all of it alive)
                assert (blk.untyped_storage().nbytes()
                        == blk.numel() * blk.element_size())
                shard_mod.leaf_block(buf, sp, mesh, mesh.coords).copy_(blk)
                shard_mod.leaf_block(cov, sp, mesh, mesh.coords).add_(1)
    for buf, cov, w in zip(L.tree_leaves(bufs), L.tree_leaves(cover),
                           L.tree_leaves(full)):
        assert torch.equal(buf, w) and cov.min() >= 1
    assert split > 0 or model == 1
    whole = elastic.reshard(full, axes, None, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(L.tree_leaves(whole),
                                                 L.tree_leaves(full)))


def test_launcher_trains_over_two_ranks(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--dtype", "float32", "--ranks", "2", "--model", "2", "--steps",
         "2", "--batch", "2", "--seq", "16", "--log-every", "1",
         "--stats-out", str(tmp_path / "stats.json")],
        env=_env(), cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.splitlines()
    assert sum(ln.startswith("step ") for ln in lines) == 2
    done = [ln for ln in lines if ln.startswith("done:")]
    assert len(done) == 1 and np.isfinite(float(done[0].split()[-1]))
    stats = json.loads((tmp_path / "stats.json").read_text())["ranks"]
    assert [s["rank"] for s in stats] == [0, 1]
    assert stats[0]["loss"] == stats[1]["loss"]
