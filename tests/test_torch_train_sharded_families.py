"""The port's sharded trainer on the recurrent, hybrid, VLM and
encoder-decoder families over two gloo ranks on the CPU, held against
the JAX package's GSPMD train step on a forced 2-device mesh: reduced
rwkv6-3b, zamba2-2.7b, internvl2-26b and whisper-large-v3 in f32 on the
same params (bridged through one ``.npz`` a config) and the same
batches (the pipeline's tokens; frames and vision
embeddings drawn with numpy from a seed).

Cases (``CASES``): every family at (data 1, model 2); internvl2 and
whisper also at (data 2, model 1), whose ``vision_embeds`` and
``frames`` are split over ``data``; and an rwkv6 of d_model 48 — three
heads of 16, whose 24-column ``ssm_dim`` blocks cut a head in two at
model 2, as rwkv6-3b's 160-column blocks cut its heads at model 16.
Two steps' losses and grad norms, the params after them (each rank's
blocks reassembled) and step 0's gradient leaf by leaf (each rank's
reduced blocks reassembled, against JAX's GSPMD gradient) within
``GRAD_TOL`` of JAX's.  Step 0's loss and grad norm are the port's own
one-rank step's.  AdamW at lr 1e-4 and eps 1e-3 on both sides (eps as
in ``tests/test_torch_train_sharded.py``).  The VLM scores the tokens
after its 256-token vision prefix, so its sequence is 264.  The weights
are drawn with numpy from a seed, from each leaf's spec, at each
matrix's own fan-in (``_numpy_params``).

Then, on the port alone: a decode step of rwkv6 (its ``s`` cache split
over ``model`` on heads), of the d_model-48 rwkv6 (``s`` replicated: 3
heads) and of zamba2 (``s`` and ``conv_x`` split, the shared block's
``kv_seq`` split) over the default decode plan gives the one-rank
decode's logits and new cache; ``elastic.reshard`` tiles every family's
leaves; and the launcher trains rwkv6 at model 2 and whisper at data 2.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: case -> (arch, fields of the reduced config replaced, (data, model))
CASES = {"rwkv6_model2": ("rwkv6-3b", {}, (1, 2)),
         "rwkv6_d48_model2": ("rwkv6-3b", {"d_model": 48}, (1, 2)),
         "zamba2_model2": ("zamba2-2.7b", {}, (1, 2)),
         "internvl2_model2": ("internvl2-26b", {}, (1, 2)),
         "internvl2_data2": ("internvl2-26b", {}, (2, 1)),
         "whisper_model2": ("whisper-large-v3", {}, (1, 2)),
         "whisper_data2": ("whisper-large-v3", {}, (2, 1))}
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
#: lr 1e-4 and eps 1e-3: the moments' update stays far from the
#: rounding of a small second moment
OPT = dict(lr=1e-4, eps=1e-3)
#: per arch: the pipeline's sequence, global batch and seed
DATA = {"rwkv6-3b": dict(seq=16, batch=4, seed=3),
        "zamba2-2.7b": dict(seq=16, batch=4, seed=3),
        "internvl2-26b": dict(seq=264, batch=4, seed=3),
        "whisper-large-v3": dict(seq=16, batch=4, seed=3)}
#: decode cases: (arch, fields replaced); cache of 16 rows, rows at 5
#: and 12
DECODE = {"rwkv6": ("rwkv6-3b", {}),
          "rwkv6_d48": ("rwkv6-3b", {"d_model": 48}),
          "zamba2": ("zamba2-2.7b", {})}

_COMMON = r"""
import dataclasses, json, os, sys
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
            out[prefix + k] = v
    return out


def config(get_config, arch, fields):
    return dataclasses.replace(get_config(arch).reduced(), **fields)


def cfg_tag(arch, fields):
    return "_".join([arch] + [f"{k}{v}" for k, v in sorted(fields.items())])


METRICS = ("loss", "grad_norm", "ce", "aux")


def extras(cfg, batch, step):
    # the stubbed frontends' inputs, drawn from a numpy seed per step
    rng = np.random.default_rng(100 + step)
    out = {}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (batch, cfg.enc_len, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision_patches":
        out["vision_embeds"] = rng.standard_normal(
            (batch, 8, cfg.d_model)).astype(np.float32)
    return out
"""

#: the children's helpers, for this module's own use
_CHILD: dict = {}
exec(_COMMON, _CHILD)

_JAX_CHILD = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax
import jax.numpy as jnp
""" + _COMMON + r"""
from repro.configs.registry import get_config
from repro.core.policy import default_plan
from repro.data.pipeline import DataConfig, batch_at
from repro.distributed import sharding as sh
from repro.launch.mesh import make_host_mesh
from repro.models.model import build
from repro.optim import adamw
from repro.train import trainer

d, cases, opt, data = (sys.argv[1], json.loads(sys.argv[2]),
                       json.loads(sys.argv[3]), json.loads(sys.argv[4]))
ocfg = adamw.AdamWConfig(**opt)
out = {"n_devices": len(jax.devices())}
for name, (arch, fields, dims) in cases.items():
    # (data, model), or (data, model, microbatch)
    data_, model_, mb = (list(dims) + [1])[:3]
    cfg = config(get_config, arch, fields)
    model = build(cfg)
    full = jax.tree.map(jnp.asarray, load(os.path.join(
        d, cfg_tag(arch, fields) + ".npz")))
    dd = data[arch]
    dc = DataConfig(cfg.vocab_size, dd["seq"], dd["batch"], seed=dd["seed"])
    batches = [dict(batch_at(dc, s), **extras(cfg, dd["batch"], s))
               for s in range(2)]
    batches = [jax.tree.map(jnp.asarray, b) for b in batches]
    mesh = make_host_mesh(data=data_, model=model_)
    plan = default_plan(mesh, "train")
    p_sh = sh.param_shardings(model, plan)
    o_sh = sh.opt_state_shardings(model, plan)
    b_sh = sh.batch_shardings(plan, batches[0])
    fn = jax.jit(trainer.make_train_step(
        model, plan, opt_cfg=ocfg, schedule_total=2, grad_shardings=p_sh,
        opt_shardings=o_sh["mu"], microbatch=mb),
        in_shardings=(p_sh, o_sh, b_sh),
        out_shardings=(p_sh, o_sh, None))
    p = jax.device_put(full, p_sh)
    # step 0's gradient as GSPMD computes it under the same specs
    gfn = jax.jit(jax.value_and_grad(trainer.make_loss_fn(model, plan, True),
                                     has_aux=True),
                  in_shardings=(p_sh, b_sh), out_shardings=(None, p_sh))
    _, g0 = gfn(p, jax.device_put(batches[0], b_sh))
    np.savez(os.path.join(d, f"jaxgrad_{name}.npz"),
             **{k: np.asarray(v) for k, v in flat(g0).items()})
    o = jax.device_put(adamw.init_state(full), o_sh)
    steps = {k: [] for k in METRICS}
    for b in batches:
        p, o, m = fn(p, o, jax.device_put(b, b_sh))
        for k in METRICS:
            steps[k].append(float(m[k]))
    out[name] = {**steps, "mesh": dict(mesh.shape),
                 "batch_specs": {k: [str(e) for e in v.spec]
                                 for k, v in b_sh.items()}}
    np.savez(os.path.join(d, f"jax_{name}.npz"),
             **{k: np.asarray(v) for k, v in flat(p).items()})
print("SHJSON " + json.dumps(out))
"""

#: the port child's training side: rank 1's entry, the blocks of every
#: rank reassembled, and one train case
_PORT_TRAIN = r"""
import os, sys, json
import numpy as np
import torch
torch.set_num_threads(2)
""" + _COMMON + r"""


def rank_main(rank, world, port, *args):
    import torch.distributed as dist
    from repro_torch.launch.mesh import worker_store
    store = worker_store(rank, world, port)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    run(*args)
    dist.destroy_process_group()


def gather_full(params, specs, mesh, shard_mod):
    # every rank's blocks, written into full leaves on rank 0
    import torch.distributed as dist
    mine = (shard_mod.mesh_coords(mesh),
            {k: v.detach().numpy() for k, v in flat(params).items()})
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, mine)
    spec_of = flat(specs)
    sizes = shard_mod.mesh_shape(mesh)
    full = {}
    for coords, blocks in got:
        for k, blk in blocks.items():
            shape = list(blk.shape)
            for i, e in enumerate(spec_of[k]):
                if e is not None:
                    shape[i] *= sizes[e]
            buf = full.setdefault(k, torch.zeros(shape))
            shard_mod.leaf_block(buf, spec_of[k], mesh, coords).copy_(
                torch.from_numpy(blk))
    return {k: v.numpy() for k, v in full.items()}


def train_case(d, arch, fields, dims, opt, dd):
    from repro_torch.configs.registry import get_config
    from repro_torch.core.policy import default_plan, null_plan
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.distributed import sharding as shard_mod
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L
    from repro_torch.models.model import build, params_from_numpy
    from repro_torch.optim import adamw
    from repro_torch.train import elastic, trainer
    cfg = config(get_config, arch, fields)
    model = build(cfg)
    full = params_from_numpy(load(os.path.join(
        d, cfg_tag(arch, fields) + ".npz")), device="cpu")
    dc = DataConfig(cfg.vocab_size, dd["seq"], dd["batch"], seed=dd["seed"])
    batches = []
    for s in range(2):
        b = dict(batch_at(dc, s, "cpu"))
        b.update({k: torch.from_numpy(v)
                  for k, v in extras(cfg, dd["batch"], s).items()})
        batches.append(b)
    ocfg = adamw.AdamWConfig(**opt)
    mb = dims[2] if len(dims) > 2 else 1    # microbatches a step
    p1 = L.tree_map(torch.clone, full)
    step1 = trainer.make_train_step(model, null_plan(), opt_cfg=ocfg,
                                    schedule_total=2, microbatch=mb)
    _, _, m = step1(p1, adamw.init_state(p1), batches[0])
    one = {k: [m[k].item()] for k in METRICS}
    mesh = make_host_mesh(data=dims[0], model=dims[1])
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
                                   opt_shardings=o_sh["mu"], microbatch=mb)
    b_sh = shard_mod.batch_shardings(plan, batches[0])
    # each rank's rows as the launcher hands them out
    local = [{k: shard_mod.microbatch_rows(v, b_sh[k], mesh, coords, mb)
              for k, v in b.items()} for b in batches]
    # step 0's gradient as the step reduces it: each rank's block of the
    # param spec, or of the moment spec where ZeRO-1 reduce-scatters it
    sync = trainer._GradSync(model, plan, p_sh, o_sh["mu"])
    _, g0 = trainer.make_grad_fn(model, plan)(params, local[0])
    g0 = [sync._reduce(g, z) for g, z in zip(L.tree_leaves(g0), sync.zdims)]
    zdims = iter(sync.zdims)
    g_specs = shard_mod._map2(
        lambda ps, os_: os_ if next(zdims) is not None else ps, p_sh,
        o_sh["mu"])
    grads = gather_full(trainer._unflatten_like(params, g0), g_specs, mesh,
                        shard_mod)
    steps = {k: [] for k in METRICS}
    for b in local:
        params, opt_state, m2 = step(params, opt_state, b)
        for k in METRICS:
            steps[k].append(m2[k].item())
    return ({**steps, "one": one,
             "mesh": list(mesh.shape),
             "batch_specs": {k: [str(e) for e in v]
                             for k, v in b_sh.items()}},
            gather_full(params, p_sh, mesh, shard_mod), grads)


"""

_PORT_FAMILIES = r"""


def decode_case(arch, fields):
    # one decode step over the default decode plan's (1, 2) mesh against
    # the one-rank step on the full cache
    from repro_torch.configs.registry import get_config
    from repro_torch.core.policy import default_plan, null_plan
    from repro_torch.distributed import comm
    from repro_torch.distributed import sharding as shard_mod
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L
    from repro_torch.models.model import build
    from repro_torch.train import elastic
    cfg = config(get_config, arch, fields)
    model = build(cfg)
    full = model.init(0, dtype=torch.float32, device="cpu")
    mesh = make_host_mesh(data=1, model=2)
    plan = default_plan(mesh, "decode")
    B, C = 2, 16
    gen = torch.Generator().manual_seed(1)
    cache = model.init_cache(B, C, dtype=torch.float32, device="cpu")
    for t in L.tree_leaves({k: v for k, v in cache.items() if k != "pos"}):
        t.normal_(generator=gen)
    cache["pos"] = torch.tensor([5, 12], dtype=torch.int32)
    tokens = torch.tensor([[7], [200]])
    want, want_cache = model.decode(full, L.tree_map(torch.clone, cache),
                                    tokens, null_plan())
    c_sh = shard_mod.cache_shardings(plan, cache)
    coords = shard_mod.mesh_coords(mesh)
    local = shard_mod._map2(
        lambda t, sp: shard_mod.shard_leaf(t.clone(), sp, mesh, coords),
        cache, c_sh)
    params = elastic.reshard(full, model.logical_axes(), plan, device="cpu")
    logits, new = model.decode(params, local, tokens, plan)
    logits = comm.replicate_vocab(logits.contiguous(), cfg.vocab_size, mesh)
    errs = {}
    for k, got in flat(new).items():
        w = shard_mod.leaf_block(flat(want_cache)[k], flat(c_sh)[k], mesh,
                                 coords)
        assert got.shape == w.shape, (k, got.shape, w.shape)
        errs[k] = float((got.float() - w.float()).abs().max()
                        / max(float(w.float().abs().max()), 1.0))
    return {"max_abs": float((logits - want).abs().max()),
            "scale": float(want.abs().max()),
            "cache_err": max(errs.values()),
            "split": sorted({k.split("/")[-1] for k, sp in flat(c_sh).items()
                             if any(e == "model" for e in sp)})}


def run(d, cases, opt, data, decode):
    import torch.distributed as dist
    out = {}
    for name, (arch, fields, dims) in cases.items():
        out[name], got, grads = train_case(d, arch, fields, dims, opt,
                                           data[arch])
        if dist.get_rank() == 0:
            np.savez(os.path.join(d, f"port_{name}.npz"), **got)
            np.savez(os.path.join(d, f"portgrad_{name}.npz"), **grads)
    out["decode"] = {name: decode_case(*a) for name, a in decode.items()}
    res = [None] * dist.get_world_size()
    dist.all_gather_object(res, out)
    if dist.get_rank() == 0:
        print("SHJSON " + json.dumps(res))


if __name__ == "__main__":
    from repro_torch.launch.mesh import start_ranks
    import torch.distributed as dist
    args = (sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3]),
            json.loads(sys.argv[4]), json.loads(sys.argv[5]))
    store, procs = start_ranks(2, rank_main, args)
    dist.init_process_group("gloo", store=store, rank=0, world_size=2)
    run(*args)
    dist.destroy_process_group()
    for p in procs:
        p.join(timeout=120)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
"""
_PORT_CHILD = _PORT_TRAIN + _PORT_FAMILIES


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


def _numpy_params(arch, fields, seed=0):
    """The config's params drawn with numpy from ``seed``, leaf by leaf in
    the sorted key order of the param spec (the JAX package's keys), each
    from its spec's initializer: zeros, ones, N(0, 0.02 scale) for
    'small', N(0, scale / sqrt(fan-in)) otherwise, the fan-in being a
    layer-stacked matrix's input dim (an expert leaf's (L, E, d, f): d).
    (Both packages' own init divides by the stacked leaf's first dim,
    the layer count: at 2 layers its weights
    are several times too large, the reduced whisper's residual stream
    reaches ~1e2, and f32 reorderings of its sums move its gradients by
    ~5e-3 of a leaf's norm, in float64 too, as both packages take the
    norms' statistics in f32.)"""
    import dataclasses
    import math

    from repro_torch.configs.registry import get_config
    from repro_torch.models import layers as L
    from repro_torch.models.model import build
    cfg = dataclasses.replace(get_config(arch).reduced(), **fields)
    rng = np.random.default_rng(seed)
    out = {}

    def draw(path, sp):
        if sp.init in ("zeros", "ones"):
            leaf = np.full(sp.shape, float(sp.init == "ones"), np.float32)
        else:
            # the input dim: after the layers and an expert leaf's experts
            lead = len(sp.shape) >= 3 and sp.axes[0] == "layers"
            lead += lead < len(sp.axes) and sp.axes[lead] == "experts"
            fan_in = sp.shape[lead] if sp.shape else 1
            std = (0.02 * sp.scale if sp.init == "small" else
                   sp.scale / math.sqrt(max(fan_in, 1)))
            leaf = (rng.standard_normal(sp.shape) * std).astype(np.float32)
        out[path] = leaf

    def walk(tree, prefix):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                walk(tree[k], prefix + k + "/")
            else:
                draw(prefix + k, tree[k])
    walk(build(cfg).spec(), "")
    assert all(isinstance(v, np.ndarray) for v in out.values())
    assert len(out) == len(L.tree_leaves(build(cfg).spec()))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port child beside two JAX children, each of which compiles
    half of the cases' GSPMD steps."""
    d = str(tmp_path_factory.mktemp("sharded_families"))
    for arch, fields, _ in CASES.values():
        np.savez(os.path.join(d, _CHILD["cfg_tag"](arch, fields) + ".npz"),
                 **_numpy_params(arch, fields))
    script = os.path.join(d, "port_child.py")
    with open(script, "w") as f:
        f.write(_PORT_CHILD)
    names = sorted(CASES)
    halves = [{n: CASES[n] for n in names[i::2]} for i in range(2)]
    tail = [json.dumps(OPT), json.dumps(DATA)]
    procs = {f"jax{i}": subprocess.Popen(
        [sys.executable, "-c", _JAX_CHILD, d, json.dumps(h)] + tail,
        env=_env(), cwd=d, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i, h in enumerate(halves)}
    procs["port"] = subprocess.Popen(
        [sys.executable, script, d, json.dumps(CASES)] + tail
        + [json.dumps(DECODE)], env=_env(), cwd=d, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    got = {name: _parse(p, name) for name, p in procs.items()}
    jax_res = {}
    for i in range(2):
        jax_res.update(got[f"jax{i}"])
    return {"jax": jax_res, "port": got["port"], "dir": d}


def _trim(spec):
    """A spec's entries as strings, without the trailing replicated ones."""
    spec = list(spec)
    while spec and spec[-1] == "None":
        spec.pop()
    return spec


def _tol(want):
    """|port - JAX| allowed at ``want``: the ``GRAD_TOL`` band at its
    scale."""
    return GRAD_TOL["atol"] + GRAD_TOL["rtol"] * np.abs(
        np.asarray(want, np.float64)).max()


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_steps_match_jax(runs, case):
    """Losses, cross-entropies, aux losses and grad norms of two steps
    against the JAX package's GSPMD steps on both ranks, whose batch
    leaves split as JAX's do: within ``GRAD_TOL`` (each step's value at
    its scale).  Step 0's loss equals
    the port's one-rank step's (rtol 1e-5), and its grad norm too (rtol
    1e-4)."""
    assert runs["jax"]["n_devices"] == 2
    want = runs["jax"][case]
    assert want["mesh"] == dict(zip(("data", "model"), CASES[case][2]))
    for rank in runs["port"]:
        got = rank[case]
        assert got["mesh"] == list(CASES[case][2])
        assert ({k: _trim(v) for k, v in got["batch_specs"].items()}
                == {k: _trim(v) for k, v in want["batch_specs"].items()})
        for key in _CHILD["METRICS"]:
            for i in range(2):
                gap = abs(got[key][i] - want[key][i])
                assert gap <= _tol(want[key][i]), (key, i, got[key],
                                                   want[key])
        np.testing.assert_allclose(got["loss"][0], got["one"]["loss"][0],
                                   rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"][0],
                                   got["one"]["grad_norm"][0], rtol=1e-4)


@pytest.mark.parametrize("case", sorted(CASES))
def test_step0_gradient_leaf_by_leaf_matches_jax(runs, case):
    """Step 0's gradient of every leaf, as the sharded step reduces it
    (each rank's blocks reassembled), against the JAX package's GSPMD
    gradient under the same specs: the difference's norm within
    ``GRAD_TOL`` of the leaf's norm.  AdamW's update is blind to a
    gradient scaled by a constant, and the global norm to a small leaf's
    fault; a leaf that got 1/tp or tp times its gradient is off by 0.5
    or 1 of its norm here."""
    d = runs["dir"]
    got = np.load(os.path.join(d, f"portgrad_{case}.npz"))
    want = np.load(os.path.join(d, f"jaxgrad_{case}.npz"))
    assert sorted(got.files) == sorted(want.files)
    worst = (0.0, None)
    for k in want.files:
        w = want[k].astype(np.float64)
        assert got[k].shape == w.shape, k
        gap = np.linalg.norm(got[k].astype(np.float64) - w)
        band = (GRAD_TOL["atol"] * np.sqrt(w.size)
                + GRAD_TOL["rtol"] * np.linalg.norm(w))
        worst = max(worst, (gap / band, k))
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
        assert gap <= _tol(w), (k, gap)


def test_a_head_cut_in_two_is_the_case_at_d48():
    """The d_model-48 rwkv6 splits its 48 ``ssm_dim`` columns into blocks
    of 24 at model 2: a block ends inside its second head of 16, and its
    3 heads leave the ``s`` cache replicated; the reduced rwkv6's blocks
    of 32 hold whole heads."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    cfg = get_config("rwkv6-3b").reduced()
    for d_model, cut in ((48, True), (0, False)):
        c = dataclasses.replace(cfg, d_model=d_model) if d_model else cfg
        assert ((c.d_model // 2) % c.rwkv_head_dim != 0) == cut
    full = get_config("rwkv6-3b")
    assert (full.d_model // 16) % full.rwkv_head_dim != 0


@pytest.mark.parametrize("name", sorted(DECODE))
def test_decode_over_the_mesh_gives_the_one_rank_step(runs, name):
    """The default decode plan on (data 1, model 2): logits within 1e-5
    at their scale of the one-rank decode's, and every leaf of each
    rank's new cache within 1e-5 of that block of the one-rank cache's
    (at the leaf's scale, below);
    the recurrent leaves the spec splits are split.  (Cache errors are
    at the leaf's scale, or absolute below 1: the WKV state grows by
    outer products to ~25.)"""
    split = {"rwkv6": ["s"], "rwkv6_d48": [],
             "zamba2": ["conv_x", "k", "s", "v"]}[name]
    for rank in runs["port"]:
        d = rank["decode"][name]
        assert d["split"] == split, d
        assert d["max_abs"] <= 1e-5 + 1e-5 * d["scale"], d
        assert d["cache_err"] <= 1e-5, d


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-2.7b",
                                  "internvl2-26b", "whisper-large-v3"])
@pytest.mark.parametrize("data,model", [(2, 1), (1, 2)])
def test_reshard_tiles_every_family(arch, data, model):
    """``elastic.reshard`` on every rank of a (data, model) stand-in mesh:
    each leaf's blocks have the spec's local shape and tile the leaf."""
    import types

    from repro_torch.configs.registry import get_config
    from repro_torch.core.policy import default_plan
    from repro_torch.distributed import sharding as shard_mod
    from repro_torch.models import layers as L
    from repro_torch.models.model import build
    from repro_torch.train import elastic
    model_ = build(get_config(arch).reduced())
    full = model_.init(0, dtype=torch.float32, device="cpu")
    bufs = L.tree_map(torch.zeros_like, full)
    split = 0
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
                split += blk.shape != w.shape
                shard_mod.leaf_block(buf, sp, mesh, mesh.coords).copy_(blk)
    for buf, w in zip(L.tree_leaves(bufs), L.tree_leaves(full)):
        assert torch.equal(buf, w)
    assert split > 0 or model == 1


@pytest.mark.parametrize("arch,mesh", [("rwkv6-3b", ["--model", "2"]),
                                       ("whisper-large-v3", ["--data", "2"])])
def test_launcher_trains_over_two_ranks(tmp_path, arch, mesh):
    """``launch.train --ranks 2`` on rwkv6 at model 2 and on whisper at
    data 2 (each rank's rows of the zero frames): both ranks end with the
    same finite losses."""
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--dtype", "float32", "--arch", arch, "--ranks", "2", *mesh,
         "--steps", "2", "--batch", "2", "--seq", "16", "--log-every", "1",
         "--stats-out", str(tmp_path / "stats.json")],
        env=_env(), cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    stats = json.loads((tmp_path / "stats.json").read_text())["ranks"]
    assert [s["rank"] for s in stats] == [0, 1]
    assert stats[0]["loss"] == stats[1]["loss"]
    assert np.all(np.isfinite(stats[0]["loss"]))
