"""The port's per-region counters (``repro_torch.core.counters``), its
roofline and its oversubscription model, against the JAX package's.

The JAX package counts the compiled step's HLO; the port runs the step on
the meta device under a dispatch mode, and counts a train step's backward
ops under the regions of the forward ops they differentiate.  Products agree exactly (2·M·N·K);
elementwise work is counted per aten op here and per fused HLO op there,
so per-region flops agree within 25% and byte counts differ in kind (the
ratio is printed: ``pytest -s``).  Region sets, the order of the hottest
regions and the tap region are the same.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.core import counters as jcounters
from repro.core.policy import null_plan as jnull_plan
from repro.core.regions import discover_regions as jdiscover_regions
from repro.core.regions import region as jregion
from repro.models.model import build as jbuild
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import counters, roofline, smt
from repro_torch.core import regions as regions_mod
from repro_torch.core.policy import default_plan, null_plan
from repro_torch.core.regions import (collect_regions, current_region,
                                      discover_regions, region,
                                      set_region_filter)
from repro_torch.kernels import LAUNCHES, ops, work
from repro_torch.models import layers as L
from repro_torch.models.model import build, params_from_numpy
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.train import trainer
from repro_torch.optim import adamw


def test_dot_flops_exact():
    """2·M·N·K in both packages (the JAX count within its own test's 5%)."""
    M, K, N = 64, 128, 32
    want = 2 * M * K * N

    def jf(x, w):
        with jregion("mm"):
            return jnp.sum(x @ w)

    jrc = jcounters.collect(jax.jit(jf).lower(jnp.ones((M, K)),
                                              jnp.ones((K, N))).compile())

    def f(x, w):
        with region("mm"):
            return torch.sum(x @ w)

    rc = counters.collect(f, torch.ones(M, K), torch.ones(K, N))
    assert abs(jrc.regions["mm"].flops - want) / want < 0.05
    # the product exactly, plus one flop for the sum's single output
    assert rc.regions["mm"].flops == want + 1
    assert rc.regions["mm"].bytes == 4 * (M * K + K * N + 2 * M * N) + 4


@pytest.mark.parametrize("op,args,flops", [
    ("bmm", ((3, 8, 16), (3, 16, 4)), 2 * 3 * 8 * 4 * 16),
    ("einsum", ((2, 5, 6), (6, 7)), 2 * 2 * 5 * 7 * 6),
    ("linear", ((4, 10), (12, 10)), 2 * 4 * 12 * 10),
])
def test_products_count_batch_included(op, args, flops):
    a, b = (torch.ones(s) for s in args)
    fn = {"bmm": torch.bmm,
          "einsum": lambda x, y: torch.einsum("bij,jk->bik", x, y),
          "linear": torch.nn.functional.linear}[op]
    assert counters.collect(fn, a, b).total.flops == flops


def test_slice_rules_and_free_views():
    """In-place slice writes count twice the update, gathers twice the
    output; a slice one flop an element of it and no bytes (the HLO
    ``slice``), a reshape nothing."""
    buf = torch.zeros(1000, 64)
    upd = torch.ones(4, 64)
    idx = torch.tensor([1, 5, 9, 700])

    def write(b, u, i):
        b[i] = u                    # index_put_
        b[10:14].copy_(u)           # copy_ into a slice
        b.view(-1)[:5]              # a reshape (free) and a slice

    rc = counters.collect(write, buf, upd, idx)
    assert rc.total.bytes == 2 * 2 * upd.numel() * 4
    assert rc.total.flops == upd.numel() + 5 and rc.total.ops == 4

    rc = counters.collect(lambda b, i: b[i], buf, idx)
    assert rc.total.bytes == 2 * 4 * 64 * 4 and rc.total.ops == 1


def test_region_discovery():
    """The JAX package's case, and equal region sets for the forward pass
    of reduced stablelm-1.6b and qwen3-8b in both packages."""
    def f(x):
        with region("a"):
            with region("b"):
                return x * 2

    assert discover_regions(f, torch.ones(4)) == {"a", "a/b"}
    toks = np.zeros((2, 8), np.int32)
    for arch in ("stablelm-1.6b", "qwen3-8b"):
        jmodel = jbuild(jget_config(arch).reduced())
        want = jdiscover_regions(
            lambda p, t: jmodel.forward(p, {"tokens": t}, jnull_plan()),
            jmodel.abstract_params(jnp.float32), jnp.asarray(toks))
        model = build(get_config(arch).reduced())
        params = model.init(0, dtype=torch.float32, device="cpu")
        got = discover_regions(
            lambda p, t: model.forward(p, {"tokens": t}, null_plan()),
            params, torch.as_tensor(toks))
        assert got == want and len(got) >= 8, (arch, got ^ want)


def test_region_filter_attributes_to_the_nearest_tagged_region():
    set_region_filter(lambda path: not path.endswith("/inner"))
    try:
        def f(x):
            with region("outer"):
                with region("inner"):
                    assert current_region() == "outer"
                    return x + 1

        with collect_regions() as seen:
            rc = counters.collect(f, torch.ones(8))
        assert seen == {"outer", "outer/inner"}
        assert set(rc.regions) == {"outer"}
    finally:
        set_region_filter(None)


def test_backward_ops_attributed_to_region():
    """The JAX package's case: the forward matmul and the w-grad matmul
    both count in the region of the forward op."""
    def jf(w, x):
        with jregion("lyr"):
            return jnp.sum(jnp.tanh(x @ w))

    jrc = jcounters.collect(jax.jit(jax.grad(jf)).lower(
        jnp.ones((64, 64)), jnp.ones((32, 64))).compile())

    def f(w, x):
        w = w.requires_grad_()
        with torch.enable_grad():
            with region("lyr"):
                y = torch.sum(torch.tanh(x @ w))
            return torch.autograd.grad(y, w)

    rc = counters.collect(f, torch.ones(64, 64), torch.ones(32, 64))
    for r in (jrc, rc):
        assert r.regions["lyr"].flops >= 2 * 2 * 32 * 64 * 64 * 0.9
    assert rc.regions.get("", counters.Counters()).flops < 2 * 32 * 64 * 64
    assert regions_mod.snapshot() == ((), ())     # the hooks left no state


def _layer_flops(rc, li):
    """Flops of ``layer<li>`` with the regions nested in it."""
    r = f"layer{li}"
    return sum(c.flops for k, c in rc.regions.items()
               if k == r or k.startswith(r + "/"))


@pytest.fixture(scope="module")
def train_counts():
    """Reduced stablelm-1.6b: its forward and one train step (null plan and
    every layer remat), counted on the meta device."""
    model = build(get_config("stablelm-1.6b").reduced())
    params = model.init(0, dtype=torch.float32, device="cpu")
    opt = adamw.init_state(params)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, 256, size=(2, 17)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    fwd = counters.collect(
        lambda p, b: model.forward(p, b, null_plan()), params, batch)
    steps = {name: counters.collect(trainer.make_train_step(model, plan),
                                    params, opt, batch)
             for name, plan in (("null", null_plan()),
                                ("remat", default_plan(kind="train")))}
    return model, params, opt, batch, fwd, steps


def test_train_step_counts_backward_per_layer(train_counts):
    """Each layer's flops in a train step are 2.5-3.5x its forward's (the
    backward's products are twice the forward's); with every layer remat
    the forward is counted again (3.5-4.5x), under the same regions."""
    model, *_, fwd, steps = train_counts
    assert "optimizer" in steps["null"].regions
    for li in range(model.cfg.n_layers):
        ratio = _layer_flops(steps["null"], li) / _layer_flops(fwd, li)
        assert 2.5 <= ratio <= 3.5, (li, ratio)
        ratio = _layer_flops(steps["remat"], li) / _layer_flops(fwd, li)
        assert 3.5 <= ratio <= 4.5, (li, ratio)
    assert set(steps["remat"].regions) == set(steps["null"].regions)
    assert set(fwd.regions) | {"optimizer"} >= set(steps["null"].regions)


def test_remat_recompute_enters_the_forwards_regions(train_counts):
    """discover_regions of a train step: the remat plan's recompute, which
    runs inside the backward, enters the forward's region paths and no
    other."""
    model, params, opt, batch, *_ = train_counts
    found = {name: discover_regions(trainer.make_train_step(model, plan),
                                    params, opt, batch)
             for name, plan in (("null", null_plan()),
                                ("remat", default_plan(kind="train")))}
    assert found["remat"] == found["null"]
    assert "layer1/mlp" in found["null"] and "optimizer" in found["null"]


def test_grad_free_count_is_the_dispatch_count(engines):
    """A step without a backward counts exactly what the dispatch mode
    alone counts under no_grad — the count the serve loop's tree features
    were built on."""
    _, eng, _ = engines
    args = counters.to_meta(eng._step_args(eng._spec_depth))
    mode = counters.CountingMode()
    counters._active.append(mode)
    try:
        with torch.no_grad(), mode:
            eng._pool_step(*args)
    finally:
        counters._active.pop()
    rc = counters.collect(eng._pool_step, *args)
    assert rc.total == mode.total and rc.regions == dict(mode.regions)


@pytest.fixture(scope="module")
def engines():
    """The gather decode step of reduced stablelm-1.6b, counted by both
    engines (online_retrain makes each collect its step's counters)."""
    jcfg = jget_config("stablelm-1.6b").reduced()
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    kw = dict(max_len=32, max_slots=2, page_size=8, online_retrain=True)
    jeng = JEngine(jmodel, jparams, serve_cfg=JServeConfig(**kw))
    jeng._ensure_pool()
    model = build(get_config("stablelm-1.6b").reduced())
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    eng = Engine(model, params, serve_cfg=ServeConfig(**kw), device="cpu")
    eng._ensure_pool()
    weight_bytes = sum(x.size * x.dtype.itemsize
                       for x in jax.tree.leaves(jparams))
    return jeng, eng, weight_bytes


#: port bytes / JAX bytes of each region of the reduced stablelm-1.6b
#: gather decode step.  The attention, MLP and logits regions agree within
#: the counters' 25% band.  The top level and ``embed`` do not, by the JAX
#: count's rules: it charges every gather fusion its whole operand (the
#: embedding table), and each unrolled layer's slice of the stacked
#: weights is a copy there, a view here.  Pinned so that a change of either
#: package's rules shows here.
BYTES_RATIO = {"": 0.0527, "embed": 0.0156, "layer0": 1.5400,
               "layer0/attn": 0.9984, "layer0/mlp": 1.0192, "layer1": 1.5440,
               "layer1/attn": 0.9987, "layer1/mlp": 1.0192, "logits": 1.0}


def test_gather_decode_step_counts_match_jax(engines):
    jeng, eng, weight_bytes = engines
    jrc, rc = jeng._pool_rc, eng._pool_rc
    jtop, top = jrc.top_regions("flops", 5), rc.top_regions("flops", 5)
    assert [r for r, _ in top] == [r for r, _ in jtop]
    assert eng._tap_region == jeng._tap_region == "layer0/attn"
    for (r, f), (_, jf) in zip(top, jtop):
        assert abs(f - jf) <= 0.25 * jf, (r, f, jf)
    assert set(rc.regions) == set(jrc.regions)
    assert rc.total.bytes >= weight_bytes and jrc.total.bytes >= weight_bytes
    assert rc.total.collective_bytes == rc.total.link_bytes == 0
    print(f"\n[counters] reduced stablelm-1.6b gather decode step: bytes "
          f"port/JAX = {rc.total.bytes / jrc.total.bytes:.4f} "
          f"({rc.total.bytes:.0f} / {jrc.total.bytes:.0f}), flops "
          f"{rc.total.flops / jrc.total.flops:.4f}, weights "
          f"{weight_bytes} bytes")


@pytest.mark.parametrize("region", sorted(BYTES_RATIO))
def test_gather_decode_step_bytes_by_region(engines, region):
    """Each region's port/JAX bytes at its pinned ratio; the tap region
    (the tree's ``log_bytes`` and ``arithmetic_intensity``), the MLP and
    the logits within the 25% band."""
    jeng, eng, _ = engines
    ratio = (eng._pool_rc.regions[region].bytes
             / jeng._pool_rc.regions[region].bytes)
    assert ratio == pytest.approx(BYTES_RATIO[region], rel=0.02)
    if "attn" in region or "mlp" in region or region == "logits":
        assert 0.75 <= ratio <= 1.25, ratio


def test_unsafe_view_is_free():
    """``matmul`` of a 3-D input emits ``mm`` and then ``_unsafe_view``:
    only the product is counted, as the HLO count takes a reshape for a
    free ``bitcast``."""
    x, w = torch.ones(2, 3, 8), torch.ones(8, 4)
    rc = counters.collect(lambda a, b: a @ b, x, w)
    assert rc.total.ops == 1
    assert rc.total.flops == 2 * 2 * 3 * 4 * 8
    assert rc.total.bytes == 4 * (2 * 3 * 8 + 8 * 4 + 2 * 3 * 4)


def test_counts_equal_from_cpu_or_meta_and_run_nothing(engines):
    """Counting from CPU tensors or from meta tensors gives identical
    counters; it launches no kernel and writes no pool page."""
    _, eng, _ = engines
    args = eng._step_args(eng._spec_depth)
    for t in L.tree_leaves(eng._pool.pages):
        t.normal_()
    pages = [t.clone() for t in L.tree_leaves(eng._pool.pages)]
    before = dict(LAUNCHES)
    from_cpu = counters.collect(eng._pool_step, *args)
    from_meta = counters.collect(eng._pool_step, *counters.to_meta(args))
    assert from_cpu.total == from_meta.total
    assert from_cpu.regions == from_meta.regions
    assert from_cpu.regions == eng._pool_rc.regions
    assert dict(LAUNCHES) == before
    for a, b in zip(pages, L.tree_leaves(eng._pool.pages)):
        assert torch.equal(a, b)


def test_kernel_wrappers_note_shape_only_work():
    """The paged and scan kernels, handed meta tensors, note the work of
    every page of the block table and every step of T as one op."""
    B, S, KVH, G, HD, P, ps, MP = 3, 2, 2, 4, 32, 13, 8, 4
    q = torch.zeros(B, S, KVH, G, HD)
    pages = torch.zeros(P, ps, KVH, HD)
    bt = torch.zeros(B, MP, dtype=torch.int32)
    lens = torch.zeros(B, dtype=torch.int32)
    rc = counters.collect(lambda *a: ops.paged_attention_mq(*a), q, pages,
                          pages, bt, lens)
    nbytes, flops = work.paged_attention(B, S, KVH, G, HD, 4, MP, ps)
    assert (rc.total.bytes, rc.total.flops, rc.total.ops) == (nbytes, flops, 1)
    r = torch.zeros(2, 7, 3, 16)

    def scan(x, u, s0):
        out, s = ops.wkv(x, x, x, x, u, s0)
        assert out.shape == x.shape and s.shape == s0.shape
        return out

    rc = counters.collect(scan, r, torch.zeros(3, 16),
                          torch.zeros(2, 3, 16, 16))
    assert (rc.total.bytes, rc.total.flops) == work.wkv(2, 3, 7, 16)


def test_roofline_picks_the_card_by_name():
    assert roofline.card_for("NVIDIA H100 80GB HBM3") is roofline.H100_SXM
    assert roofline.card_for("NVIDIA H100 PCIe") is roofline.H100_PCIE
    assert roofline.card_for("NVIDIA H100 NVL") is roofline.H100_NVL
    for dev in ("cpu", "meta", None):
        assert roofline.card_for_device(dev) is roofline.H100_SXM
    c = counters.Counters(flops=989e12, bytes=3.35e12 * 2, link_bytes=450e9)
    rl = roofline.from_counters(c)
    assert np.isclose(rl.compute_s, 1.0) and np.isclose(rl.memory_s, 2.0)
    assert np.isclose(rl.collective_s, 1.0) and rl.dominant == "memory"
    assert roofline.peak_ops(torch.float32) == 67e12
    assert roofline.peak_ops("bfloat16") == 989e12
    ms, by = work.bound_ms(*work.matmul(2048, 5632, 2048, 2), torch.bfloat16)
    assert by == "operations" and np.isclose(
        ms, 2 * 2048 * 5632 * 2048 / 989e12 * 1e3)


def test_smt_budget_is_hoppers_shared_memory():
    """The oversubscription model keeps the JAX package's API with
    Hopper's budget: 228 KB per SM, 227 KB a block."""
    modes = smt.legal_modes((128, 128))
    assert [m.oversubscribe for m in modes] == [1, 2, 4]
    assert all(smt.fits_vmem(m) for m in modes)
    assert smt.legal_modes((256, 256)) == []
    assert not smt.fits_vmem(smt.BlockChoice((256, 128), 1))
    assert smt.aligned((32, 128)) and not smt.aligned((24, 128))
    assert smt.stall_hiding_model(1.0, 2.0, 4) < smt.stall_hiding_model(
        1.0, 2.0, 1)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "qwen2-moe-a2.7b"])
def test_moe_decode_step_counts_match_jax(arch):
    """The paged decode step of a reduced MoE model, counted by both
    engines: the same region set (``layerN/moe`` and, with shared experts,
    ``layerN/moe/shared_mlp``), and each MoE region's flops within 25% of
    the JAX package's."""
    jmodel = jbuild(jget_config(arch).reduced())
    jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    kw = dict(max_len=32, max_slots=4, page_size=8, online_retrain=True)
    jeng = JEngine(jmodel, jparams, serve_cfg=JServeConfig(**kw))
    jeng._ensure_pool()
    eng = Engine(build(get_config(arch).reduced()),
                 params_from_numpy(jax.tree.map(np.asarray, jparams),
                                   device="cpu"),
                 serve_cfg=ServeConfig(**kw), device="cpu")
    eng._ensure_pool()
    jrc, rc = jeng._pool_rc, eng._pool_rc
    assert set(rc.regions) == set(jrc.regions)
    moe_regions = sorted(r for r in rc.regions if "/moe" in r)
    shared = get_config(arch).n_shared_experts
    assert len(moe_regions) == 2 * (2 if shared else 1), moe_regions
    for r in moe_regions:
        f, jf = rc.regions[r].flops, jrc.regions[r].flops
        assert abs(f - jf) <= 0.25 * jf, (r, f, jf)


def _inclusive_flops(rc, r):
    """Flops of region ``r`` with the regions nested in it."""
    return sum(c.flops for k, c in rc.regions.items()
               if k == r or k.startswith(r + "/"))


def _bridged(arch):
    jmodel = jbuild(jget_config(arch).reduced())
    jparams = jax.jit(lambda k: jmodel.init(k, dtype=jnp.float32))(
        jax.random.PRNGKey(0))
    return jmodel, jparams, build(get_config(arch).reduced()), \
        params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.mark.parametrize("step", ["decode_step", "encode"])
def test_whisper_step_counts_match_jax(step):
    """Reduced whisper-large-v3's ``decode_step`` (B 2 on a 16-row cache)
    and ``encode`` (B 2 x 32 frames), counted by both packages: every
    region of the port's count is one of JAX's (JAX's HLO also carries
    nested copies of a scope's name, ``dec0/self_attn/dec0/self_attn``,
    which the port has no counterpart of), and ``encoder``, each
    ``encoder/enc{li}``, ``dec{li}``, ``dec{li}/self_attn`` and
    ``dec{li}/cross_attn``, with the regions nested in them, within 25% of
    JAX's flops.  The cross-attention, which projects K/V from the whole
    encoder output on every step, takes most of a decode step's."""
    from repro.core.policy import null_plan as jplan
    from repro.models import whisper as jwhisper
    from repro_torch.models import whisper
    jmodel, jparams, model, params = _bridged("whisper-large-v3")
    cfg, B = model.cfg, 2
    if step == "decode_step":
        jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                              jmodel.cache_spec(B, 16, dtype=jnp.float32))
        jrc = jcounters.collect(jax.jit(jmodel.decode).lower(
            jparams, jcache, jnp.zeros((B, 1), jnp.int32)).compile())
        rc = counters.collect(
            lambda p, c, t: model.decode(p, c, t), params,
            model.init_cache(B, 16, dtype=torch.float32, device="cpu"),
            torch.zeros((B, 1), dtype=torch.int32))
        named = [f"dec{i}{r}" for i in range(cfg.n_layers)
                 for r in ("", "/self_attn", "/cross_attn")]
    else:
        frames = (B, cfg.enc_len, cfg.d_model)
        jrc = jcounters.collect(jax.jit(
            lambda p, f: jwhisper.encode(jmodel.cfg, p, f, jplan())).lower(
                jparams, jnp.zeros(frames, jnp.float32)).compile())
        rc = counters.collect(
            lambda p, f: whisper.encode(cfg, p, f, null_plan()), params,
            torch.zeros(frames))
        named = ["encoder"] + [f"encoder/enc{i}"
                               for i in range(cfg.n_enc_layers)]
    assert set(rc.regions) - {""} <= set(jrc.regions)
    for r in named:
        f, jf = _inclusive_flops(rc, r), _inclusive_flops(jrc, r)
        assert jf > 0 and abs(f - jf) <= 0.25 * jf, (r, f, jf)
    if step == "decode_step":
        assert _inclusive_flops(rc, "dec0/cross_attn") > 0.8 * \
            _inclusive_flops(rc, "dec0")


def test_internvl2_counts_match_jax():
    """Reduced internvl2-26b: its paged decode step counted by both
    engines (the same region set, each layer's flops within 25% of
    JAX's), and a forward with vision embeddings, whose ``vision_stub``
    region both packages count (at least the embeddings' bytes)."""
    jmodel, jparams, model, params = _bridged("internvl2-26b")
    kw = dict(max_len=32, max_slots=4, page_size=8, online_retrain=True)
    jeng = JEngine(jmodel, jparams, serve_cfg=JServeConfig(**kw))
    jeng._ensure_pool()
    eng = Engine(model, params, serve_cfg=ServeConfig(**kw), device="cpu")
    eng._ensure_pool()
    jrc, rc = jeng._pool_rc, eng._pool_rc
    assert set(rc.regions) == set(jrc.regions)
    for li in range(model.cfg.n_layers):
        f, jf = _layer_flops(rc, li), _layer_flops(jrc, li)
        assert abs(f - jf) <= 0.25 * jf, (li, f, jf)
    ve = (2, 8, model.cfg.d_model)
    jrc = jcounters.collect(jax.jit(jmodel.forward).lower(jparams, {
        "tokens": jnp.zeros((2, 12), jnp.int32),
        "vision_embeds": jnp.zeros(ve, jnp.float32)}).compile())
    rc = counters.collect(lambda p, b: model.forward(p, b), params, {
        "tokens": torch.zeros((2, 12), dtype=torch.int32),
        "vision_embeds": torch.zeros(ve)})
    assert set(rc.regions) == set(jrc.regions)
    for r in (rc, jrc):
        assert r.regions["vision_stub"].bytes >= 4 * np.prod(ve)
