"""Checkpoint and elastic resume of the port's sharded trainer, through
the launcher (``repro_torch.launch.train.main``) over two gloo ranks on
the CPU, reduced stablelm-1.6b and granite-moe-1b-a400m in f32, batch 4
x seq 16.

Per arch, in a child of its own (the two side by side): 8 steps on
(data 2) with ``--ckpt-every 4 --fail-at-step 6`` exit 42 on every rank,
leaving the step-4 checkpoint; an uninterrupted 8 steps on (data 2);
then ``--resume`` from copies of the step-4 checkpoint on (data 2), on
(data 1, model 2) and on one rank.  The child wraps
``checkpoint.save`` to keep every rank's blocks at each save, and the
launcher's ``_restore`` to keep the shapes of what each rank restored
(both wraps at module level, so that the spawned rank runs them too),
and starts the JAX launcher's ``--resume`` from a copy of the step-4
checkpoint beside its resumes.  Then the JAX package's
``checkpoint.restore`` reads the checkpoint into its own template.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("stablelm-1.6b", "granite-moe-1b-a400m")
BASE = ["--device", "cpu", "--dtype", "float32", "--steps", "8",
        "--batch", "4", "--seq", "16", "--log-every", "1",
        "--ckpt-every", "4"]
#: the splits a resume runs on: name -> launcher flags
SPLITS = {"data2": ["--ranks", "2", "--data", "2"],
          "model2": ["--ranks", "2", "--model", "2"],
          "one": ["--ranks", "1"]}

_CHILD = r"""
import json, os, shutil, sys
import numpy as np
import torch
torch.set_num_threads(2)
from repro_torch.launch import train as T
from repro_torch.train import checkpoint as C

_save, _restore = C.save, T._restore


def _rank():
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def save(ckpt_dir, step, state, **kw):
    # every rank's blocks as it holds them, beside the checkpoint
    keep = ckpt_dir + "_blocks"
    os.makedirs(keep, exist_ok=True)
    np.savez(os.path.join(keep, "rank%d_step%d.npz" % (_rank(), step)),
             **C._flatten(state))
    return _save(ckpt_dir, step, state, **kw)


def restore(ckpt_dir, *a, **kw):
    params, opt, step = _restore(ckpt_dir, *a, **kw)
    shapes = {k: list(v.shape) for k, v in C._flatten(
        {"params": params, "opt": opt}).items()}
    with open(ckpt_dir + "_restored_rank%d.json" % _rank(), "w") as f:
        json.dump(shapes, f)
    return params, opt, step


C.save = save
T._restore = restore

if __name__ == "__main__":
    d, arch, base, splits = (sys.argv[1], sys.argv[2],
                             json.loads(sys.argv[3]),
                             json.loads(sys.argv[4]))
    base = base + ["--arch", arch]
    data2 = splits["data2"]
    out = {}
    ck = os.path.join(d, "ck")
    try:
        T.main(base + data2 + ["--ckpt-dir", ck, "--fail-at-step", "6"])
        out["fail_code"] = 0
    except SystemExit as e:
        out["fail_code"] = e.code
    out["files"] = sorted(os.listdir(ck))
    # the JAX launcher resumes a copy on its one device meanwhile
    import subprocess
    shutil.copytree(ck, ck + "_jax")
    jax = subprocess.Popen(
        [sys.executable, "-m", "repro.launch.train", "--arch", arch,
         "--reduced", "--steps", "6", "--batch", "4", "--seq", "16",
         "--log-every", "1", "--ckpt-dir", ck + "_jax", "--resume"],
        env=dict(os.environ, JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)

    def stats(argv, tag):
        path = os.path.join(d, tag + ".json")
        T.main(argv + ["--stats-out", path])
        with open(path) as f:
            return json.load(f)["ranks"]
    out["full"] = stats(base + data2, "full")
    for name, flags in splits.items():
        shutil.copytree(ck, ck + "_" + name)
        out[name] = stats(base + flags + ["--ckpt-dir", ck + "_" + name,
                                          "--resume"], name)
    stdout, stderr = jax.communicate(timeout=600)
    assert jax.returncode == 0, "JAX launcher:\n" + stderr[-6000:]
    out["jax_launcher"] = stdout.splitlines()
    print("CKJSON " + json.dumps(out))
"""


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    return env


def _parse(proc, tag):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, f"{tag} failed:\n{err[-6000:]}"
    line = [ln for ln in out.splitlines() if ln.startswith("CKJSON ")][-1]
    return json.loads(line[len("CKJSON "):])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("ckpt_ranks")
    script = base / "child.py"
    script.write_text(_CHILD)
    procs = {}
    for arch in ARCHS:
        d = base / arch
        d.mkdir()
        procs[arch] = subprocess.Popen(
            [sys.executable, str(script), str(d), arch, json.dumps(BASE),
             json.dumps(SPLITS)], env=_env(), cwd=d, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    got = {arch: _parse(p, arch) for arch, p in procs.items()}
    return {"dir": base, "runs": got}


def _losses(ranks, steps):
    """Every rank's losses, the same on each, at ``steps``."""
    first = ranks[0]["loss"]
    for r in ranks:
        assert r["loss"] == first
    return first[-len(steps):]


@pytest.mark.parametrize("arch", ARCHS)
def test_fail_at_step_exits_42_after_the_step_4_checkpoint(runs, arch):
    """``--fail-at-step 6`` ends the two-rank launcher with exit code 42
    (every rank: the launcher raises anything else as a failed rank),
    after one checkpoint at step 4."""
    r = runs["runs"][arch]
    assert r["fail_code"] == 42
    assert r["files"] == ["ckpt_00000004.json", "ckpt_00000004.npz"]


@pytest.mark.parametrize("arch", ARCHS)
def test_resume_on_the_same_split_is_bit_for_bit(runs, arch):
    """Resumed on (data 2), steps 4-7's losses, grad norms and aux
    losses equal the uninterrupted run's bit for bit."""
    r = runs["runs"][arch]
    full, res = r["full"][0], r["data2"][0]
    assert len(full["loss"]) == 8 and len(res["loss"]) == 4
    for key in ("loss", "grad_norm", "aux"):
        assert res[key] == full[key][4:], key
    assert _losses(r["data2"], range(4)) == _losses(r["full"], range(8))[4:]


@pytest.mark.parametrize("split", ["model2", "one"])
@pytest.mark.parametrize("arch", ARCHS)
def test_resume_on_another_split_within_1e5(runs, arch, split):
    """Resumed on (data 1, model 2) and on one rank: steps 4-7's losses
    within 1e-5 (relative) of the uninterrupted (data 2) run's."""
    r = runs["runs"][arch]
    want = _losses(r["full"], range(8))[4:]
    got = _losses(r[split], range(4))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert np.all(np.isfinite(got))


def _specs(arch, data, model):
    """(the train state's specs by '::' key, the stand-in meshes of the
    ranks) on a (data, model) split."""
    import types

    from repro_torch.configs.registry import get_config
    from repro_torch.core.policy import default_plan
    from repro_torch.distributed import sharding as shard_mod
    from repro_torch.models.model import build
    model_ = build(get_config(arch).reduced())
    meshes = [types.SimpleNamespace(shape={"data": data, "model": model},
                                    coords={"data": i, "model": j})
              for i in range(data) for j in range(model)]
    plan = default_plan(meshes[0], "train")
    specs = {"params": shard_mod.param_shardings(model_, plan),
             "opt": shard_mod.opt_state_shardings(model_, plan)}
    flat = {}

    def walk(tree, prefix):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                walk(tree[k], prefix + (k,))
            else:
                flat["::".join(prefix + (k,))] = tree[k]
    walk(specs, ())
    return flat, meshes


@pytest.mark.parametrize("arch", ARCHS)
def test_the_checkpoint_is_the_ranks_blocks_put_together(runs, arch):
    """The step-4 checkpoint written on (data 2), leaf for leaf and bit
    for bit: each rank's block of every leaf (params at their specs, the
    moments at their ZeRO-1 specs, ``step`` whole) is the block the rank
    held when it saved."""
    import torch

    from repro_torch.distributed import sharding as shard_mod
    d = runs["dir"] / arch
    specs, meshes = _specs(arch, 2, 1)
    whole = np.load(d / "ck" / "ckpt_00000004.npz")
    assert sorted(whole.files) == sorted(specs)
    assert whole["opt::step"].shape == () and int(whole["opt::step"]) == 4
    for r, mesh in enumerate(meshes):
        held = np.load(d / "ck_blocks" / f"rank{r}_step4.npz")
        assert sorted(held.files) == sorted(specs)
        for k, spec in specs.items():
            blk = shard_mod.leaf_block(torch.from_numpy(whole[k]), spec,
                                       mesh, mesh.coords).numpy()
            assert blk.shape == held[k].shape, k
            assert np.array_equal(blk, held[k]), k
    # ZeRO-1 split the moments over data: the ranks' moment blocks are
    # halves of the leaves, the params whole on both
    mu = [k for k in specs if k.startswith("opt::mu::")]
    assert any("data" in str(specs[k]) for k in mu)


@pytest.mark.parametrize("split,dims", [("data2", (2, 1)),
                                        ("model2", (1, 2)), ("one", None)])
@pytest.mark.parametrize("arch", ARCHS)
def test_restored_blocks_have_the_splits_shapes(runs, arch, split, dims):
    """What each rank restored has the shapes of its blocks on the split
    it resumed on: the params at their specs, the moments at their
    ZeRO-1 specs ((data 2): half of each split leaf's moments a rank),
    ``step`` 0-dim; on one rank every leaf whole."""
    from repro_torch.distributed import sharding as shard_mod
    d = runs["dir"] / arch
    whole = np.load(d / "ck" / "ckpt_00000004.npz")
    if dims is None:
        got = json.loads((d / "ck_one_restored_rank0.json").read_text())
        assert got == {k: list(whole[k].shape) for k in whole.files}
        return
    specs, meshes = _specs(arch, *dims)
    for r, mesh in enumerate(meshes):
        got = json.loads(
            (d / f"ck_{split}_restored_rank{r}.json").read_text())
        assert got == {k: list(shard_mod.local_shape(whole[k].shape,
                                                     spec, mesh))
                       for k, spec in specs.items()}, r
        assert got["opt::step"] == []
        # the launcher's moment bytes: the rank's ZeRO-1 share, in f32
        share = sum(4 * int(np.prod(got[k])) for k in got
                    if k.startswith(("opt::mu::", "opt::nu::")))
        (stats,) = [s for s in runs["runs"][arch][split] if s["rank"] == r]
        assert stats["moment_bytes"] == share, r


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_package_restores_and_resumes_the_checkpoint(runs, arch):
    """The JAX package's ``checkpoint.restore`` reads the two-rank
    checkpoint into its own template (the JAX launcher's: bf16 params,
    f32 moments) with every leaf's shape, and the JAX launcher's
    ``--resume`` continues from step 4 with finite losses."""
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import get_config
    from repro.models.model import build
    from repro.optim import adamw
    from repro.train import checkpoint as jckpt
    d = runs["dir"] / arch
    params = build(get_config(arch).reduced()).init(jax.random.PRNGKey(0))
    template = {"params": params, "opt": adamw.init_state(params)}
    state, step = jckpt.restore(str(d / "ck"), template)
    assert step == 4
    whole = np.load(d / "ck" / "ckpt_00000004.npz")
    flat = dict(jckpt._flatten(state))
    assert sorted(flat) == sorted(whole.files)
    for k in whole.files:
        assert flat[k].shape == whole[k].shape, k
        if k.startswith("opt::"):   # f32 in both: the same bits
            assert np.array_equal(np.asarray(flat[k]), whole[k]), k
        else:                       # the template's bf16
            np.testing.assert_array_equal(
                np.asarray(flat[k], np.float32),
                np.asarray(jnp.asarray(whole[k]).astype(jnp.bfloat16),
                           np.float32))
    lines = runs["runs"][arch]["jax_launcher"]
    assert "resumed from step 4" in lines
    losses = [float(ln.split()[3]) for ln in lines
              if ln.startswith("step ")]
    assert len(losses) == 2 and np.all(np.isfinite(losses))
