"""The port's training path against the JAX package's, on the CPU.

Reduced dense configs (and reduced granite-moe-1b-a400m) with f32
weights from the JAX package's
``Model.init`` carried across by ``params_from_numpy``; batches come from
the data pipeline (numpy Philox, the same bytes in both packages) or
from numpy with a seed.  Tolerances, both sides in f32 with different
summation orders: the loss within rtol 1e-5; gradients within atol 1e-6 +
rtol 1e-4 of the leaf's largest magnitude.  The rtol is taken against the
leaf's scale, not each element's: the first layer's attention and norm
gradients pass through a LayerNorm of embeddings of std 0.02 and a causal
softmax, and an element that cancels to near zero carries the rounding of
the terms it sums.  JAX's own f32 gradients miss the per-element form
against the port's float64 gradients as often as the port's f32 ones do
(reduced stablelm-1.6b: 177 of 4096 elements of ``blocks/attn/wk``
against the port's 348, at errors of 2.3e-5 and 3.6e-5 on a leaf whose
largest element is 0.22).  One AdamW step
on identical grads and state within atol 1e-6 (compared on the same
grads, not after separate backward passes: Adam's first step is about
lr * sign(g), so rounding-level grad differences near 0 move a param by
up to lr).  Then the port's counterparts of ``tests/test_optim.py`` and of
``tests/test_system.py``'s training tests, the launcher's fail-and-resume,
remat and microbatching against the plain step, and the kernels' refusal
to be differentiated.
"""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    import hypothesis.strategies as st
    from hypothesis import given, settings
except ImportError:  # fall back to the deterministic local shim
    from _hypothesis_compat import given, settings
    from _hypothesis_compat import strategies as st

from repro.configs.registry import get_config as jget_config
from repro.models.model import build as jbuild
from repro.optim import adamw as jadamw
from repro.optim.schedule import warmup_cosine as jwarmup_cosine
from repro.train import trainer as jtrainer
from repro_torch.configs.registry import get_config
from repro_torch.core.policy import default_plan, null_plan
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L
from repro_torch.models.model import build, params_from_numpy
from repro_torch.optim import adamw
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.train import checkpoint as ck
from repro_torch.train import trainer

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ["stablelm-1.6b", "qwen3-8b", "h2o-danube-1.8b"]
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _assert_close_at_scale(got, want, rtol, atol):
    """|got - want| <= atol + rtol * max|want|, elementwise."""
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=atol + rtol * np.abs(want).max())


def _jbatch(batch):
    return {k: jnp.asarray(v.numpy().astype(np.int32))
            for k, v in batch.items()}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(JAX loss fn, JAX params, port model, port params, batch) for one
    reduced arch; h2o-danube-1.8b's sliding window (reduced: 4096) is cut
    to 8 on both sides so that it masks inside the 24-token batch."""
    import dataclasses
    jcfg = jget_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    if cfg.swa_window:
        jcfg = dataclasses.replace(jcfg, swa_window=8)
        cfg = dataclasses.replace(cfg, swa_window=8)
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    model = build(cfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    batch = batch_at(DataConfig(cfg.vocab_size, 24, 3, seed=5), 2, "cpu")
    jloss = jtrainer.make_loss_fn(jmodel, None, unroll=True)
    return jloss, jparams, model, params, batch


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, size=(3, 7))
    want = jtrainer.cross_entropy(jnp.asarray(logits),
                                  jnp.asarray(labels, jnp.int32))
    x = torch.tensor(logits, requires_grad=True)
    got = trainer.cross_entropy(x, torch.tensor(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    jg = jax.grad(lambda z: jtrainer.cross_entropy(
        z, jnp.asarray(labels, jnp.int32)))(jnp.asarray(logits))
    g, = torch.autograd.grad(got, x)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **GRAD_TOL)


def test_loss_matches_jax(pair):
    jloss, jparams, model, params, batch = pair
    want, jm = jloss(jparams, _jbatch(batch))
    got, m = trainer.make_loss_fn(model, None, unroll=True)(params, batch)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(m["ce"].item(), float(jm["ce"]), rtol=1e-5)


def test_grads_match_jax(pair):
    jloss, jparams, model, params, batch = pair
    jgrads = jax.grad(lambda p: jloss(p, _jbatch(batch))[0])(jparams)
    (loss, _), grads = trainer.make_grad_fn(model)(params, batch)
    want = jax.tree.map(np.asarray, jgrads)
    assert len(L.tree_leaves(grads)) == len(jax.tree.leaves(want))
    for g, w in zip(L.tree_leaves(grads), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == torch.float32
        _assert_close_at_scale(g.numpy(), w, **GRAD_TOL)
    assert all(not p.requires_grad for p in L.tree_leaves(params))


def _numpy_tree(rng, like, scale=1.0, positive=False):
    def leaf(a):
        x = rng.normal(size=np.shape(a)).astype(np.float32) * scale
        return np.abs(x) if positive else x
    return jax.tree.map(leaf, like)


@pytest.mark.parametrize("lr_scale", [1.0, 0.37])
def test_apply_updates_matches_jax(pair, lr_scale):
    """One AdamW step on the same numpy params, grads and state (step 3,
    grads scaled past the clip norm so that clipping acts)."""
    _, jparams, *_ = pair
    rng = np.random.default_rng(1)
    np_params = jax.tree.map(np.asarray, jparams)
    np_grads = _numpy_tree(rng, np_params, 0.5)
    mu = _numpy_tree(rng, np_params, 1e-2)
    nu = _numpy_tree(rng, np_params, 1e-3, positive=True)
    cfg = dict(lr=1e-2, weight_decay=0.1, clip_norm=1.0)
    jp, jstate, jm = jadamw.apply_updates(
        jadamw.AdamWConfig(**cfg), jax.tree.map(jnp.asarray, np_params),
        jax.tree.map(jnp.asarray, np_grads),
        {"step": jnp.asarray(3, jnp.int32),
         "mu": jax.tree.map(jnp.asarray, mu),
         "nu": jax.tree.map(jnp.asarray, nu)},
        jnp.float32(lr_scale))
    t = lambda tree: params_from_numpy(tree, device="cpu")  # noqa: E731
    params, grads = t(np_params), t(np_grads)
    state = {"step": torch.tensor(3, dtype=torch.int32), "mu": t(mu),
             "nu": t(nu)}
    p2, s2, m = adamw.apply_updates(adamw.AdamWConfig(**cfg), params, grads,
                                    state, torch.tensor(lr_scale))
    assert p2 is params and s2["mu"] is state["mu"]
    assert s2["step"].item() == int(jstate["step"]) == 4
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]),
                               rtol=1e-6)
    assert float(jm["grad_norm"]) > 1.0
    np.testing.assert_allclose(m["lr"].item(), float(jm["lr"]), rtol=1e-7)
    for tree, jtree in ((p2, jp), (s2["mu"], jstate["mu"]),
                        (s2["nu"], jstate["nu"])):
        for a, b in zip(L.tree_leaves(tree), jax.tree.leaves(jtree)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6)
    for g, w in zip(L.tree_leaves(grads), jax.tree.leaves(np_grads)):
        np.testing.assert_array_equal(g.numpy(), w)   # grads untouched


@given(step=st.integers(0, 20000))
@settings(max_examples=50, deadline=None)
def test_warmup_cosine_matches_jax(step):
    for kw in (dict(warmup=100, total=10000), dict(warmup=1, total=12)):
        want = float(jwarmup_cosine(jnp.asarray(step), **kw))
        got = warmup_cosine(torch.tensor(step, dtype=torch.int32), **kw)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(got.item(), want, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(warmup_cosine(step, **kw).item(), want,
                                   rtol=1e-6, atol=1e-7)


# -- tests/test_optim.py's five, on the port ------------------------------


def test_adamw_converges_quadratic():
    target = torch.randn(16, generator=torch.Generator().manual_seed(0))
    params = {"w": torch.zeros(16)}
    state = adamw.init_state(params)
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0)
    for _ in range(300):
        w = params["w"].detach().requires_grad_()
        g, = torch.autograd.grad(torch.sum((w - target) ** 2), w)
        params, state, m = adamw.apply_updates(cfg, params, {"w": g}, state)
    assert float(torch.max(torch.abs(params["w"] - target))) < 0.05


def test_grad_clipping_bounds_update():
    params = {"w": torch.zeros(4)}
    state = adamw.init_state(params)
    cfg = adamw.AdamWConfig(lr=1e-3, clip_norm=1.0, weight_decay=0)
    grads = {"w": torch.full((4,), 1e9)}
    p2, _, metrics = adamw.apply_updates(cfg, params, grads, state)
    assert float(metrics["grad_norm"]) > 1e8  # reported pre-clip
    assert float(p2["w"].abs().max()) <= 1e-3 * 1.0001


def test_weight_decay_only_on_matrices():
    params = {"w": torch.ones(4, 4), "b": torch.ones(4)}
    state = adamw.init_state(params)
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=1.0)
    grads = L.tree_map(torch.zeros_like, params)
    p2, _, _ = adamw.apply_updates(cfg, params, grads, state)
    assert float((p2["b"] - 1.0).abs().max()) < 1e-6   # bias untouched
    assert float(p2["w"].max()) < 1.0                   # matrix decayed


@given(step=st.integers(1, 20000))
@settings(max_examples=50, deadline=None)
def test_schedule_bounded(step):
    v = float(warmup_cosine(torch.tensor(step), warmup=100, total=10000))
    assert 0.0 <= v <= 1.0


def test_schedule_warmup_ramps():
    vals = [float(warmup_cosine(torch.tensor(s), warmup=100, total=10000))
            for s in (1, 50, 100)]
    assert vals[0] < vals[1] < vals[2] <= 1.0


# -- tests/test_system.py's training tests, on the port --------------------


def _make(arch="stablelm-1.6b", **kw):
    cfg = get_config(arch).reduced()
    model = build(cfg)
    params = model.init(0, dtype=torch.float32, device="cpu")
    opt = adamw.init_state(params)
    step = trainer.make_train_step(
        model, unroll=False, opt_cfg=adamw.AdamWConfig(lr=3e-3),
        schedule_total=60, **kw)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4,
                      seed=0)
    return cfg, model, params, opt, step, data


def test_loss_decreases():
    cfg, model, params, opt, step, data = _make()
    losses = []
    for s in range(30):
        params, opt, m = step(params, opt, batch_at(data, s, "cpu"))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses


def test_kill_and_resume_is_exact(tmp_path):
    """Checkpoint restart reproduces the uninterrupted run bit for bit
    (deterministic pipeline, exact state restore, deterministic CPU
    kernels)."""
    cfg, model, p1, o1, step, data = _make()
    for s in range(8):
        p1, o1, m1 = step(p1, o1, batch_at(data, s, "cpu"))

    cfg, model, params, opt, step, data = _make()
    p2, o2 = params, opt
    for s in range(4):
        p2, o2, m2 = step(p2, o2, batch_at(data, s, "cpu"))
    ck.save(str(tmp_path), 4, {"params": p2, "opt": o2})
    template = {"params": model.init(1, dtype=torch.float32, device="cpu"),
                "opt": adamw.init_state(p2)}
    restored, start = ck.restore(str(tmp_path), template)
    p2, o2 = restored["params"], restored["opt"]
    assert start == 4 and o2["step"].dtype == torch.int32
    for s in range(start, 8):
        p2, o2, m2 = step(p2, o2, batch_at(data, s, "cpu"))
    for a, b in zip(L.tree_leaves(p1), L.tree_leaves(p2)):
        assert torch.equal(a, b)
    assert float(m1["loss"]) == float(m2["loss"])


def test_train_launcher_failure_and_resume(tmp_path):
    """The launcher process dies mid-run (simulated node failure) and a
    new process resumes from the checkpoint, on the CPU."""
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "stablelm-1.6b", "--steps", "12", "--batch", "2", "--seq", "32",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "4",
            "--log-every", "50", "--device", "cpu", "--dtype", "float32"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r1 = subprocess.run(base + ["--fail-at-step", "6"], cwd=ROOT, env=env,
                        capture_output=True, text=True, timeout=300)
    assert r1.returncode == 42, r1.stderr[-800:]
    found = ck.latest_valid(str(tmp_path))
    assert found is not None and found[0] == 4
    r2 = subprocess.run(base + ["--resume"], cwd=ROOT, env=env,
                        capture_output=True, text=True, timeout=300)
    assert r2.returncode == 0, r2.stderr[-800:]
    assert "resumed from step 4" in r2.stdout
    assert "done:" in r2.stdout and "step    11 loss" in r2.stdout


def test_example_train_100m_torch_runs(tmp_path):
    r = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "train_100m_torch.py"),
         "--steps", "3", "--batch", "2", "--seq", "32", "--device", "cpu",
         "--ckpt-dir", str(tmp_path)],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-800:]
    assert "step    0 loss" in r.stdout and "finished 3 steps" in r.stdout


# -- plan and microbatching -------------------------------------------------


def test_remat_plan_gives_the_null_plans_loss_and_grads():
    cfg, model, params, *_ = _make()
    batch = batch_at(DataConfig(cfg.vocab_size, 32, 4, seed=0), 0, "cpu")
    plan = default_plan(kind="train")
    assert plan.config_for("layer1").remat
    (l0, _), g0 = trainer.make_grad_fn(model, null_plan())(params, batch)
    (l1, _), g1 = trainer.make_grad_fn(model, plan)(params, batch)
    assert torch.equal(l0, l1)
    for a, b in zip(L.tree_leaves(g0), L.tree_leaves(g1)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("accum", ["scan", "unrolled"])
def test_microbatch_2_matches_microbatch_1(accum):
    """Two halves of a batch accumulated give the whole batch's step: the
    mean loss over equal halves is the mean over the whole, and so are the
    gradients, compared through the moments one step leaves (mu is
    (1 - b1) x the clipped gradient, nu (1 - b2) x its square)."""
    _, _, pa, oa, one, data = _make()
    _, _, pb, ob, two, _ = _make(microbatch=2, accum=accum)
    batch = batch_at(data, 0, "cpu")
    pa, oa, ma = one(pa, oa, batch)
    pb, ob, mb = two(pb, ob, batch)
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(mb[k].item(), ma[k].item(), rtol=1e-5)
    for key in ("mu", "nu"):
        for a, b in zip(L.tree_leaves(oa[key]), L.tree_leaves(ob[key])):
            _assert_close_at_scale(b.numpy(), a.numpy(), **GRAD_TOL)


def test_moe_loss_aux_and_grads_match_jax():
    """Reduced granite-moe-1b-a400m: the loss with its load-balancing aux
    term, ce and aux against the JAX package's, and every gradient
    (router and experts included) against ``jax.grad`` at the tolerance
    above; under the train plan (every layer remat) the same loss and
    grads."""
    jcfg = jget_config("granite-moe-1b-a400m").reduced()
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    model = build(get_config("granite-moe-1b-a400m").reduced())
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    batch = batch_at(DataConfig(jcfg.vocab_size, 24, 3, seed=5), 2, "cpu")
    jloss = jtrainer.make_loss_fn(jmodel, None, unroll=True)
    want, jm = jloss(jparams, _jbatch(batch))
    jgrads = jax.grad(lambda p: jloss(p, _jbatch(batch))[0])(jparams)
    (loss, m), grads = trainer.make_grad_fn(model)(params, batch)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(m["ce"].item(), float(jm["ce"]), rtol=1e-5)
    np.testing.assert_allclose(m["aux"].item(), float(jm["aux"]), rtol=1e-5)
    assert m["aux"].item() > 0
    want_g = jax.tree.map(np.asarray, jgrads)
    assert len(L.tree_leaves(grads)) == len(jax.tree.leaves(want_g))
    for g, w in zip(L.tree_leaves(grads), jax.tree.leaves(want_g)):
        assert g.shape == w.shape
        _assert_close_at_scale(g.numpy(), w, **GRAD_TOL)
    assert float(grads["blocks"]["mlp"]["router"].abs().max()) > 0
    (loss_r, m_r), grads_r = trainer.make_grad_fn(
        model, default_plan(kind="train"))(params, batch)
    assert loss_r.item() == loss.item() and m_r["aux"] == m["aux"]
    for a, b in zip(L.tree_leaves(grads_r), L.tree_leaves(grads)):
        _assert_close_at_scale(a.numpy(), b.numpy(), **GRAD_TOL)


def test_train_launcher_trains_moe(tmp_path):
    """``launch/train.py --arch granite-moe-1b-a400m`` trains with no new
    flag."""
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "granite-moe-1b-a400m", "--steps", "3", "--batch", "2", "--seq",
         "32", "--log-every", "1", "--device", "cpu", "--dtype", "float32"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-800:]
    assert "step     2 loss" in r.stdout and "done:" in r.stdout


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-2.7b"])
def test_non_dense_families_raise(arch):
    """The recurrent and hybrid families, once refused, now build a train
    and an eval step, and each runs one step (their losses and grads
    against the JAX package: ``tests/test_torch_train_recurrent.py``)."""
    model = build(get_config(arch).reduced())
    params = model.init(0, dtype=torch.float32, device="cpu")
    opt = adamw.init_state(params)
    batch = batch_at(DataConfig(model.cfg.vocab_size, 16, 2, seed=0), 0,
                     "cpu")
    _, opt, m = trainer.make_train_step(model)(params, opt, batch)
    assert np.isfinite(m["loss"].item()) and opt["step"].item() == 1
    m = trainer.make_eval_step(model)(params, batch)
    assert np.isfinite(m["loss"].item()) and not m["loss"].requires_grad


def test_eval_step_matches_the_loss():
    cfg, model, params, *_ = _make()
    batch = batch_at(DataConfig(cfg.vocab_size, 32, 4, seed=0), 3, "cpu")
    m = trainer.make_eval_step(model)(params, batch)
    loss, _ = trainer.make_loss_fn(model, None, True)(params, batch)
    assert torch.equal(m["loss"], loss.detach()) and not m["loss"].requires_grad


# -- the kernels have no backward, but for the scans -------------------------


def _kernel_calls():
    """Every ``kernels.ops`` wrapper without a gradient on small CPU inputs
    (the first argument of each the one made to require grad)."""
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    bt = torch.tensor([[1, 2]], dtype=torch.int32)
    lens = torch.tensor([5], dtype=torch.int32)
    pages = r(3, 4, 2, 8)
    return {
        "paged_attention_mq": lambda x: ops.paged_attention_mq(
            x, pages, pages, bt, lens), "paged_attention_mq_arg": (1, 1, 2, 2, 8),
        "paged_attention": lambda x: ops.paged_attention(
            x, pages, pages, bt, lens), "paged_attention_arg": (1, 2, 2, 8),
        "matmul": lambda x: ops.matmul(x, r(16, 16), bm=16, bn=16, bk=16),
        "matmul_arg": (16, 16),
        "attention": lambda x: ops.attention(x, x, x, block_q=8, block_k=8),
        "attention_arg": (1, 8, 2, 16),
    }


@pytest.mark.parametrize("name", ["paged_attention_mq", "paged_attention",
                                  "matmul", "attention"])
def test_kernel_wrappers_refuse_to_be_differentiated(name):
    calls = _kernel_calls()
    x = torch.randn(*calls[name + "_arg"])
    calls[name](x)                                  # no grad wanted: runs
    with torch.no_grad():
        calls[name](x.requires_grad_())             # grad mode off: runs
    with pytest.raises(RuntimeError, match="no backward"):
        calls[name](x)


def _scan_call(scan, x):
    """``scan`` (a wrapper of ``kernels.ops`` or its plain form) on x
    (1, 3, 2, 4) and fixed small inputs."""
    if scan in (ops.wkv, ref.wkv_linear_scan):
        return scan(x, x, x, torch.sigmoid(x), torch.full((2, 4), 0.3),
                    torch.zeros(1, 2, 4, 4))
    return scan(x, torch.full((1, 3, 4), 0.5), torch.full((1, 3, 4), -0.25),
                torch.full((1, 3, 2), 0.2), torch.full((2,), -1.0),
                torch.zeros(1, 2, 4, 4))


@pytest.mark.parametrize("name", ["wkv", "ssd"])
def test_scan_wrappers_give_the_plain_forms_grads(name):
    """``ops.wkv`` and ``ops.ssd``, which refused to be differentiated
    until their gradient was ported, give the gradient of autograd through
    their plain forms (held against the JAX package in
    ``tests/test_torch_train_recurrent.py``)."""
    x = torch.randn(1, 3, 2, 4, generator=torch.Generator().manual_seed(0))
    grads = []
    for scan in (getattr(ops, name), getattr(ref, f"{name}_linear_scan")):
        t = x.clone().requires_grad_()
        out, s = _scan_call(scan, t)
        g, = torch.autograd.grad(out.square().sum() + s.sum(), t)
        grads.append(g)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-6, atol=1e-7)


def test_stacked_leaves_get_one_gradient_op_each():
    """A layer-stacked leaf's gradient is built by one ``stack`` of the
    layers' gradients (the backward of ``unbind``), not by a full-size
    zero-fill and add for each layer (the backward of ``a[li]``)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(func._schema.name.split("::")[-1])
            return func(*args, **(kwargs or {}))

    cfg, model, params, *_ = _make()
    batch = batch_at(DataConfig(cfg.vocab_size, 8, 2, seed=0), 0, "cpu")
    with Ops() as ops_seen:
        trainer.make_grad_fn(model)(params, batch)
    n_stacked = len(L.tree_leaves(params["blocks"]))
    assert "select_backward" not in ops_seen.names
    assert ops_seen.names.count("stack") == n_stacked


@pytest.mark.gpu
def test_train_step_on_the_card_matches_the_cpu():
    """Reduced stablelm-1.6b in f32 (TF32 off): the loss and grads of one
    step on the card against the same step on the CPU, at the grads'
    tolerance (skips without a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, model, params, *_ = _make()
    batch = batch_at(DataConfig(cfg.vocab_size, 32, 4, seed=0), 0, "cpu")
    grad_fn = trainer.make_grad_fn(model)
    (l0, _), g0 = grad_fn(params, batch)
    on = lambda tree: L.tree_map(lambda t: t.to("cuda"), tree)  # noqa: E731
    (l1, _), g1 = grad_fn(on(params), on(batch))
    np.testing.assert_allclose(l1.item(), l0.item(), rtol=1e-5)
    for a, b in zip(L.tree_leaves(g1), L.tree_leaves(g0)):
        assert a.device.type == "cuda"
        _assert_close_at_scale(a.cpu().numpy(), b.numpy(), **GRAD_TOL)
