"""Recurrent and hybrid training on the port (rwkv6-3b, zamba2-2.7b)
against the JAX package's, on the CPU.

The scans' gradient (``repro_torch.kernels.ops.wkv`` / ``ssd`` under
grad) is held against ``jax.grad`` of the JAX package's scans: the
sequential ones (``chunked_scan`` under ``jax.checkpoint``, segments of
``chunk`` steps) and the chunked matmul forms, at T a multiple of the
segment, T not a multiple of it (one segment) and T shorter than it, from
a nonzero entry state.  Then reduced rwkv6-3b and zamba2-2.7b with f32
weights from the JAX package's ``Model.init``: the loss and every
gradient leaf under four plans, three train steps, checkpoints across the
two packages and the launcher.

Tolerances, both sides in f32 with different summation orders: the scans'
gradients within 1e-5 + 1e-5 x the largest magnitude of the leaf (they
stand within ~1e-6 of it: the same recurrence, step for step); the loss
within rtol 1e-5; the models' gradients within 1e-6 + rtol x the leaf's
largest magnitude, rtol 1e-4 for zamba2-2.7b (the tolerance of
``tests/test_torch_train.py``, for the reasons it gives) and 3e-3 for
rwkv6-3b: against a float64 run of the port on this batch, the JAX
package's f32 gradients stand up to 2.3e-3 of a leaf's scale off
(``blocks/tmix/u``, the WKV bonus, whose gradient sums r k v products
through the per-head GroupNorm) and the port's up to 3.8e-3, every other
leaf under 5e-4 in both; train-step losses within rtol 1e-5.
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

from repro.configs.registry import get_config as jget_config
from repro.core.policy import RegionConfig as JRegionConfig
from repro.core.policy import RegionPlan as JRegionPlan
from repro.core.policy import default_plan as jdefault_plan
from repro.models import mamba2 as jmamba2
from repro.models import rwkv6 as jrwkv6
from repro.models.model import build as jbuild
from repro.optim import adamw as jadamw
from repro.train import checkpoint as jck
from repro.train import trainer as jtrainer
from repro_torch.configs.registry import get_config
from repro_torch.core.policy import RegionConfig, RegionPlan, default_plan
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.model import build, params_from_numpy
from repro_torch.optim import adamw
from repro_torch.train import checkpoint as ck
from repro_torch.train import trainer

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ["rwkv6-3b", "zamba2-2.7b"]
SCAN_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL = {"rwkv6-3b": 3e-3, "zamba2-2.7b": 1e-4}


def _close_at_scale(got, want, rtol, atol):
    """|got - want| <= atol + rtol * max|want|, elementwise."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=atol + rtol * np.abs(want).max())


# ---------------------------------------------------------------------------
# (a) the four scans' gradient against jax.grad
# ---------------------------------------------------------------------------

def _scan_inputs(name, T, seed=0):
    """Numpy inputs of one scan in the model layout, from a seed: WKV r,
    k, v, w (decays in (0.37, 0.96)), u, s0; SSD x, b, c, dt > 0, a < 0,
    s0.  Both entry states are nonzero."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    B, H = 2, 2
    if name == "wkv":
        N = 4
        w = np.exp(-np.exp(rng.uniform(-3.0, 0.0, (B, T, H, N))))
        return [n(B, T, H, N) * 0.5, n(B, T, H, N) * 0.5,
                n(B, T, H, N) * 0.5, w.astype(np.float32), n(H, N) * 0.5,
                n(B, H, N, N) * 0.5]
    P, N = 4, 3
    return [n(B, T, H, P), n(B, T, N) * 0.5, n(B, T, N) * 0.5,
            rng.uniform(0.01, 0.5, (B, T, H)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (H,)).astype(np.float32),
            n(B, H, P, N) * 0.5]


def _jax_scan(name, chunked, chunk, seg):
    """The JAX package's scan of ``name``: the sequential one with
    ``seg``-step checkpointed segments, or the chunked form."""
    if name == "wkv":
        if chunked:
            return lambda *a: jrwkv6.wkv_chunked(*a, chunk=chunk)
        return lambda *a: jrwkv6.wkv_scan(*a, chunk=seg)
    if chunked:
        return lambda *a: jmamba2.ssd_chunked(*a, chunk=chunk, precise=True)
    return lambda *a: jmamba2.ssd_scan(*a, chunk=seg)


# (T, chunk, segment): 3 segments; a segment that does not divide T (one
# segment); T shorter than the segment
SCAN_CASES = [(24, 4, 8), (20, 4, 8), (6, 3, 8)]


@pytest.mark.parametrize("T,chunk,seg", SCAN_CASES)
@pytest.mark.parametrize("mode", ops.SCAN_MODES)
@pytest.mark.parametrize("name", ["wkv", "ssd"])
def test_scan_grads_match_jax(name, mode, T, chunk, seg):
    chunked = mode == "chunk"
    assert len(ops.segments(T, seg)) == (3 if T == 24 else 1)
    arrs = _scan_inputs(name, T)
    rng = np.random.default_rng(1)
    outs_shape = (arrs[0].shape, arrs[5].shape)
    g_out, g_s = (rng.standard_normal(s).astype(np.float32)
                  for s in outs_shape)
    jfn = _jax_scan(name, chunked, chunk, seg)

    def jloss(*a):
        out, s = jfn(*a)
        return jnp.sum(out * g_out) + jnp.sum(s * g_s)

    jvals = jax.value_and_grad(jloss, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in arrs))
    ts = [torch.tensor(a, requires_grad=True) for a in arrs]
    out, s = getattr(ops, name)(*ts, mode=mode, chunk=chunk, segment=seg)
    assert out.grad_fn is not None and s.grad_fn is not None
    loss = (out * torch.from_numpy(g_out)).sum() \
        + (s * torch.from_numpy(g_s)).sum()
    grads = torch.autograd.grad(loss, ts)
    np.testing.assert_allclose(loss.item(), float(jvals[0]), rtol=1e-5)
    for g, w in zip(grads, jvals[1]):
        _close_at_scale(g.numpy(), w, **SCAN_TOL)


def test_segments_follow_chunked_scan():
    """The JAX package's rule: segments of ``seg`` steps only when seg
    divides T and T is longer than one; 0 means 128."""
    assert ops.segments(512) == [(0, 128), (128, 128), (256, 128),
                                 (384, 128)]
    assert ops.segments(512, 256) == [(0, 256), (256, 256)]
    assert ops.segments(130) == [(0, 130)]
    assert ops.segments(128) == [(0, 128)]
    assert ops.segments(96, 32) == [(0, 32), (32, 32), (64, 32)]


def test_scan_grad_keeps_only_segment_boundaries():
    """Under grad the forward saves the inputs and one state a segment,
    and the scan's call runs once a segment (the kernel on the card)."""
    arrs = _scan_inputs("wkv", 24)
    calls = []
    real = ops._SCANS["wkv"]

    def counted(*a):
        calls.append(a[0].shape[1])
        return real[0](*a)

    ops._SCANS["wkv"] = (counted, real[1])
    try:
        ts = [torch.tensor(a, requires_grad=True) for a in arrs]
        out, _ = ops.wkv(*ts, segment=8)
        saved = out.grad_fn.saved_tensors
    finally:
        ops._SCANS["wkv"] = real
    assert calls == [8, 8, 8]
    states = [t for t in saved if t.shape == arrs[5].shape]
    assert len(saved) == 5 + 3 and len(states) == 3
    assert torch.equal(states[0], ts[5])


# ---------------------------------------------------------------------------
# (b)-(e) reduced rwkv6-3b and zamba2-2.7b through the trainer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(JAX model, JAX params, port model, port params, batch) of one
    reduced arch, f32 weights from the JAX package's init; the batch is
    3 x 24 tokens of the data pipeline."""
    jmodel = jbuild(jget_config(request.param).reduced())
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    model = build(get_config(request.param).reduced())
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    batch = batch_at(DataConfig(model.cfg.vocab_size, 24, 3, seed=5), 2,
                     "cpu")
    return jmodel, jparams, model, params, batch


def _jbatch(batch):
    return {k: jnp.asarray(v.numpy().astype(np.int32))
            for k, v in batch.items()}


def _plans(name):
    """(JAX plan, port plan) of each case: every knob at its default; the
    train plan (every layer and shared-attention site remat); remat with
    8-step scan segments; the chunked scans (4-step chunks, 8-step
    segments)."""
    if name == "null":
        return None, None
    if name == "train":
        return jdefault_plan(None, kind="train"), default_plan(kind="train")
    kw = (dict(remat=True, chunk=8) if name == "segments" else
          dict(scan_mode="chunk", chunk=8))
    return (JRegionPlan(region_configs={"layer": JRegionConfig(**kw)}),
            RegionPlan(region_configs={"layer": RegionConfig(**kw)}))


@pytest.mark.parametrize("plan", ["null", "train", "segments", "chunk"])
def test_loss_and_grads_match_jax(pair, plan):
    jmodel, jparams, model, params, batch = pair
    arch = model.cfg.name.removesuffix("-reduced")
    jplan, tplan = _plans(plan)
    jloss = jtrainer.make_loss_fn(jmodel, jplan, unroll=True)
    (want, jm), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jparams, _jbatch(batch))
    (loss, m), grads = trainer.make_grad_fn(model, tplan)(params, batch)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(m["ce"].item(), float(jm["ce"]), rtol=1e-5)
    want_g = jax.tree.leaves(jax.tree.map(np.asarray, jgrads))
    got_g = L.tree_leaves(grads)
    assert len(got_g) == len(want_g)
    for g, w in zip(got_g, want_g):
        assert g.dtype == torch.float32
        _close_at_scale(g.numpy(), w, rtol=GRAD_RTOL[arch], atol=1e-6)
    assert all(not p.requires_grad for p in L.tree_leaves(params))


def test_remat_gives_the_null_plans_loss(pair):
    """Remat recomputes the same forward: step 0's loss equal bit for bit,
    the grads at rounding."""
    *_, model, params, batch = pair
    (l0, _), g0 = trainer.make_grad_fn(model)(params, batch)
    (l1, _), g1 = trainer.make_grad_fn(
        model, default_plan(kind="train"))(params, batch)
    assert l1.item() == l0.item()
    for a, b in zip(L.tree_leaves(g1), L.tree_leaves(g0)):
        _close_at_scale(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7)


def test_three_train_steps_match_jax(pair):
    """Three ``make_train_step`` steps (AdamW lr 1e-3, warmup-cosine over
    3 steps) on the pipeline's batches 0-2: each step's loss against the
    JAX trainer's."""
    jmodel, jparams, model, params, _ = pair
    data = DataConfig(model.cfg.vocab_size, 16, 2, seed=3)
    jstep = jax.jit(jtrainer.make_train_step(
        jmodel, opt_cfg=jadamw.AdamWConfig(lr=1e-3), schedule_total=3))
    step = trainer.make_train_step(model, opt_cfg=adamw.AdamWConfig(lr=1e-3),
                                   schedule_total=3)
    jp, jo = jparams, jadamw.init_state(jparams)
    p = L.tree_map(torch.clone, params)
    o = adamw.init_state(p)
    for s in range(3):
        b = batch_at(data, s, "cpu")
        jp, jo, jm = jstep(jp, jo, _jbatch(b))
        p, o, m = step(p, o, b)
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   rtol=1e-5)
        assert np.isfinite(m["grad_norm"].item())


def test_checkpoints_cross_both_ways(pair, tmp_path):
    """A port train state after one step, saved by the port, restores into
    the JAX package's template bit for bit; and a JAX state, saved by the
    JAX package, into the port's."""
    jmodel, jparams, model, params, batch = pair
    p = L.tree_map(torch.clone, params)
    o = adamw.init_state(p)
    p, o, _ = trainer.make_train_step(model)(p, o, batch)
    ck.save(str(tmp_path / "port"), 1, {"params": p, "opt": o})
    jtemplate = jax.tree.map(jnp.zeros_like, {
        "params": jparams, "opt": jadamw.init_state(jparams)})
    jrest, step = jck.restore(str(tmp_path / "port"), jtemplate)
    assert step == 1
    for a, b in zip(jax.tree.leaves(jrest),
                    L.tree_leaves({"params": p, "opt": o})):
        assert np.asarray(a).tobytes() == b.numpy().tobytes()
    jstate = {"params": jparams, "opt": jadamw.init_state(jparams)}
    jstate["opt"]["step"] = jnp.asarray(7, jnp.int32)
    jck.save(str(tmp_path / "jax"), 7, jstate)
    template = L.tree_map(torch.zeros_like, {"params": p, "opt": o})
    rest, step = ck.restore(str(tmp_path / "jax"), template)
    assert step == 7
    for a, b in zip(L.tree_leaves(rest), jax.tree.leaves(jstate)):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_counts_on_the_meta_device(arch):
    """A train step of the reduced model counted on the meta device (the
    scans' forward noted once a segment, their backward op by op under the
    layer's regions): every layer region is counted, and each holds more
    than its forward's flops."""
    from repro_torch.core import counters
    model = build(get_config(arch).reduced())
    params = L.tree_map(lambda sp: torch.empty(sp.shape, device="meta"),
                        model.spec())
    toks = torch.zeros((2, 24), dtype=torch.long, device="meta")
    batch = {"tokens": toks, "labels": toks}
    plan = RegionPlan(region_configs={"layer": RegionConfig(chunk=8)})
    fwd = counters.collect(lambda p, b: model.forward(p, b, plan), params,
                           batch)
    step = counters.collect(trainer.make_train_step(model, plan), params,
                            adamw.init_state(params), batch)
    for li in range(model.cfg.n_layers):
        r = f"layer{li}"
        got, want = (sum(c.flops for k, c in rc.regions.items()
                         if k == r or k.startswith(r + "/"))
                     for rc in (step, fwd))
        assert want > 0 and got > 2 * want, (r, got, want)
    assert "optimizer" in step.regions


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_trains_recurrent(arch):
    """``launch/train.py --arch rwkv6-3b`` / ``zamba2-2.7b`` runs 3 steps
    at the reduced config on the CPU."""
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--reduced", "--steps", "3", "--batch", "2", "--seq", "32",
         "--log-every", "1", "--device", "cpu", "--dtype", "float32"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-800:]
    assert "step     2 loss" in r.stdout and "done:" in r.stdout


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ops.SCAN_MODES)
@pytest.mark.parametrize("name", ["wkv", "ssd"])
def test_scan_grads_on_the_card_match_the_cpu(name, mode):
    """The scans under grad on the card (the CUDA kernel a segment, the
    plain form's backward) against the same on the CPU, at the kernels'
    head width 16, T 256 in 128-step segments, within 1e-5 + 1e-5 x the
    leaf's scale (skips without a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import LAUNCHES, reset_launches
    rng = np.random.default_rng(2)
    B, T, H, W = 2, 256, 2, 16
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    if name == "wkv":
        w = np.exp(-np.exp(rng.uniform(-3.0, 0.0, (B, T, H, W))))
        arrs = [n(B, T, H, W) * 0.5, n(B, T, H, W) * 0.5,
                n(B, T, H, W) * 0.5, w.astype(np.float32), n(H, W) * 0.5,
                n(B, H, W, W) * 0.5]
    else:
        arrs = [n(B, T, H, W), n(B, T, W) * 0.5, n(B, T, W) * 0.5,
                rng.uniform(0.01, 0.5, (B, T, H)).astype(np.float32),
                -rng.uniform(0.5, 2.0, (H,)).astype(np.float32),
                n(B, H, W, W) * 0.5]
    proj = [n(*arrs[0].shape), n(*arrs[5].shape)]
    grads = {}
    for dev in ("cpu", "cuda"):
        ts = [torch.tensor(a, device=dev, requires_grad=True) for a in arrs]
        reset_launches()
        out, s = getattr(ops, name)(*ts, mode=mode, segment=128)
        kname = f"{name}_{'chunk' if mode == 'chunk' else 'fused'}"
        assert LAUNCHES[kname] == (2 if dev == "cuda" else 0)
        loss = (out * torch.tensor(proj[0], device=dev)).sum() \
            + (s * torch.tensor(proj[1], device=dev)).sum()
        grads[dev] = [g.cpu().numpy() for g in torch.autograd.grad(loss, ts)]
    for g, w in zip(grads["cuda"], grads["cpu"]):
        _close_at_scale(g, w, **SCAN_TOL)
