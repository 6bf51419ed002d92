"""The port's MoE family against the JAX package's, on identical weights.

Two reduced MoE configs: ``granite-moe-1b-a400m`` (8 experts top-2, no
shared experts) and ``qwen2-moe-a2.7b`` with ``n_experts=6,
pad_experts_to=8`` (shared experts, and the padded experts masked out of
the router's softmax; ``reduced()`` sets no padding).  Weights come from
the JAX package's ``Model.init`` (f32) through
:func:`repro_torch.models.model.params_from_numpy`; inputs are made with
numpy from a seed.  Routes (expert indices) must be exactly equal: the
inputs keep every token's k-th and (k+1)-th router probabilities more than
1e-6 apart (f32 rounding between the packages is ~1e-7), so a differing
route is a fault, not a tie.  Outputs agree within rtol=1e-4, atol=1e-5
(f32, summation order only).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.core.policy import RegionConfig as JRegionConfig
from repro.core.policy import RegionPlan as JRegionPlan
from repro.models import model as jmodel_mod
from repro.models import moe as jmoe
from repro.models.model import build as jbuild
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.scheduler import Request as JRequest
from repro_torch.configs.registry import get_config
from repro_torch.core.policy import RegionConfig, RegionPlan, default_plan
from repro_torch.models import layers as L
from repro_torch.models import model as model_mod
from repro_torch.models import moe
from repro_torch.models.model import build, params_from_numpy
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.scheduler import Request, RequestState

TOL = dict(rtol=1e-4, atol=1e-5)
MARGIN = 1e-6
PS, MP = 8, 6                         # page size, pages per slot
ARCHS = ["granite", "qwen2-moe"]


def _cfgs(arch, **kw):
    """(JAX cfg, port cfg) of one reduced test config."""
    name = ("granite-moe-1b-a400m" if arch == "granite"
            else "qwen2-moe-a2.7b")
    if arch == "qwen2-moe":
        kw = dict(dict(n_experts=6, pad_experts_to=8), **kw)
    return (dataclasses.replace(jget_config(name).reduced(), **kw),
            dataclasses.replace(get_config(name).reduced(), **kw))


_PAIRS: dict = {}


def _pair(arch):
    """(JAX cfg, JAX model, JAX params, port cfg, port model, port
    params), f32, built once per arch."""
    if arch not in _PAIRS:
        jcfg, cfg = _cfgs(arch)
        jmodel = jbuild(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
        _PAIRS[arch] = (jcfg, jmodel, jparams, cfg, build(cfg), tparams)
    return _PAIRS[arch]


def _layer0(arch):
    """Layer 0's MoE params in both packages."""
    _, _, jparams, _, _, tparams = _pair(arch)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["mlp"])
    return jp, L.tree_map(lambda t: t[0], tparams["blocks"]["mlp"])


def _inputs(shape, seed, common=0.0):
    """N(0, 1) activations; ``common`` adds one shared direction to every
    token, so that tokens crowd the same experts and overflow."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x += common * rng.standard_normal(shape[-1]).astype(np.float32)
    return x


def _jplan(**kw):
    return JRegionPlan(region_configs={"moe": JRegionConfig(**kw)})


def _plan(**kw):
    return RegionPlan(region_configs={"moe": RegionConfig(**kw)})


def _assert_margin(jcfg, jp, x):
    """Every token's k-th and (k+1)-th probabilities (JAX's) are more
    than MARGIN apart: no route of these inputs is a near-tie."""
    e = jmoe.n_experts_padded(jcfg)
    logits = np.array(jnp.einsum("gsd,de->gse", x, jp["router"]),
                      np.float32)
    if jcfg.pad_experts_to > jcfg.n_experts:
        logits[..., jcfg.n_experts:] = -1e30
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    top = -np.sort(-probs, axis=-1)
    k = jcfg.top_k
    assert k < e
    gap = top[..., k - 1] - top[..., k]
    assert gap.min() > MARGIN, gap.min()


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_jax(arch):
    """Weights and aux within f32 rounding, expert indices exactly."""
    jcfg, _, _, cfg, _, _ = _pair(arch)
    jp, tp = _layer0(arch)
    x = _inputs((3, 16, cfg.d_model), 0)
    _assert_margin(jcfg, jp, x)
    jw, jidx, jaux = jmoe.route(jcfg, jp, jnp.asarray(x))
    w, idx, aux = moe.route(cfg, tp, torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    if cfg.pad_experts_to:
        assert int(idx.max()) < cfg.n_experts      # padded experts masked


@pytest.mark.parametrize("arch", ARCHS)
def test_route_breaks_ties_to_the_lower_index(arch):
    """Experts with equal router columns tie exactly; jax.lax.top_k ranks
    the lower index first, and so must the port."""
    jcfg, _, _, cfg, _, _ = _pair(arch)
    jp, tp = _layer0(arch)
    router = np.asarray(jp["router"]).copy()
    for col in (3, 5):                 # experts 1, 3 and 5 tie
        router[:, col] = router[:, 1]
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    x = _inputs((2, 12, cfg.d_model), 1)
    _, jidx, _ = jmoe.route(jcfg, jp, jnp.asarray(x))
    _, idx, _ = moe.route(cfg, tp, torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    # tokens whose top k is all tie group: its lowest indices, in order
    top = idx.numpy()
    in_group = np.isin(top, [1, 3, 5]).all(-1)
    assert in_group.sum() > 0
    assert (top[in_group] == [1, 3]).all()
    # all-equal logits: experts 0..k-1, in order
    zero = dict(tp, router=torch.zeros_like(tp["router"]))
    _, idx, _ = moe.route(cfg, zero, torch.from_numpy(x))
    assert (idx == torch.arange(cfg.top_k)).all()


def test_capacity_matches_jax():
    for arch in ARCHS:
        for cf in (1.0, 1.25, 2.0, 8.0):
            jcfg, cfg = _cfgs(arch, capacity_factor=cf)
            for full in (False, True):
                if full:
                    name = jcfg.name.replace("-reduced", "")
                    jcfg = dataclasses.replace(jget_config(name),
                                               capacity_factor=cf)
                    cfg = dataclasses.replace(get_config(name),
                                              capacity_factor=cf)
                for g in list(range(1, 70)) + [100, 255, 256, 257, 512,
                                                4096]:
                    assert moe.capacity(cfg, g) == jmoe.capacity(jcfg, g)
    qwen = get_config("qwen2-moe-a2.7b")
    assert moe.n_experts_padded(qwen) == 64
    assert moe.capacity(qwen, 8) == 4 and moe.capacity(qwen, 256) == 21


# ---------------------------------------------------------------------------
# dispatch: both implementations against the JAX package's
# ---------------------------------------------------------------------------


def _groups(cfg, impl, group, moe_group, B, S):
    """The token groups the implementation routes over: (n, g)."""
    if impl == "einsum":
        g = min(moe_group, B * S)
        if (B * S) % g:
            g = S
        return B * S // g, g
    return (1, B * S) if group == "flat" else (B, S)


@pytest.mark.parametrize("moe_group", [4, 8])
@pytest.mark.parametrize("group", ["seq", "flat"])
@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("impl", ["einsum", "scatter"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_matches_jax(arch, impl, cf, group, moe_group):
    """``apply_moe`` under the plan's ``moe_impl``/``moe_group``: output
    and aux against the JAX package's.  At capacity factor 1.25 tokens
    crowd the same experts and some overflow (asserted); at 8.0 none
    does."""
    jcfg, cfg = _cfgs(arch, capacity_factor=cf)
    jp, tp = _layer0(arch)
    B, S = 2, 8
    x = _inputs((B, S, cfg.d_model), 2, common=1.0)
    n, g = _groups(cfg, impl, group, moe_group, B, S)
    _assert_margin(jcfg, jp, x.reshape(n, g, -1))
    _, idx, _ = moe.route(cfg, tp, torch.from_numpy(x).reshape(n, g, -1))
    dropped = int((moe._slots(cfg, idx) >= moe.capacity(cfg, g)).sum())
    assert (dropped > 0) == (cf < 8.0), dropped
    jy, jaux = jmoe.apply_moe(jcfg, jp, jnp.asarray(x),
                              _jplan(moe_impl=impl, moe_group=moe_group),
                              group=group)
    y, aux = moe.apply_moe(cfg, tp, torch.from_numpy(x),
                           _plan(moe_impl=impl, moe_group=moe_group),
                           group=group)
    assert y.shape == (B, S, cfg.d_model)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_einsum_matches_scatter(arch):
    """The port's two implementations on one forward at capacity factor
    8.0 (no drops), within the JAX package's own 2e-3
    (tests/test_impl_equivalence.py)."""
    _, _, _, cfg, _, tparams = _pair(arch)
    model = build(dataclasses.replace(cfg, capacity_factor=8.0))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32))
    batch = {"tokens": torch.from_numpy(toks.astype(np.int32))}
    le, ae = model.forward(tparams, batch)
    ls, as_ = model.forward(tparams, batch, _plan(moe_impl="scatter"))
    np.testing.assert_allclose(le.numpy(), ls.numpy(), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(float(ae), float(as_), rtol=1e-6)


@pytest.mark.parametrize("impl", ["einsum", "scatter"])
def test_row_groups_route_each_row_alone(impl):
    """``group='row'`` (the slot pool's decode) equals one call a row,
    as the JAX package's vmap over single-request steps computes it; at
    capacity factor 1.25 'flat' differs (the rows share capacity)."""
    _, cfg = _cfgs("granite", capacity_factor=1.25)
    _, tp = _layer0("granite")
    x = torch.from_numpy(_inputs((4, 3, cfg.d_model), 9, common=1.0))
    plan = _plan(moe_impl=impl)
    y, _ = moe.apply_moe(cfg, tp, x, plan, group="row")
    each = torch.cat([moe.apply_moe(cfg, tp, x[b:b + 1], plan,
                                    group="flat")[0] for b in range(4)])
    torch.testing.assert_close(y, each, rtol=0, atol=1e-6)
    flat, _ = moe.apply_moe(cfg, tp, x, plan, group="flat")
    assert float((flat - y).abs().max()) > 1e-2


def test_knobs_are_looked_up_under_the_bare_region_name():
    """As in the JAX package, ``apply_moe`` reads ``config_for("moe")``:
    an entry keyed ``"layer/moe"`` does not reach it."""
    jcfg, cfg = _cfgs("granite")
    _, tp = _layer0("granite")
    x = torch.from_numpy(_inputs((1, 8, cfg.d_model), 3))
    calls = []
    real = moe.apply_moe_scatter
    moe.apply_moe_scatter = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        moe.apply_moe(cfg, tp, x, RegionPlan(region_configs={
            "layer/moe": RegionConfig(moe_impl="scatter")}))
        assert calls == []
        moe.apply_moe(cfg, tp, x, _plan(moe_impl="scatter"))
        assert calls == [1]
    finally:
        moe.apply_moe_scatter = real


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux_match(arch):
    """Logits and the aux loss summed over layers, also when every layer
    is rematerialised under grad mode (the train plan)."""
    _, jmodel, jparams, cfg, model, tparams = _pair(arch)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 12))
    toks = toks.astype(np.int32)
    want, jaux = jax.jit(jmodel.forward)(jparams,
                                         {"tokens": jnp.asarray(toks)})
    got, aux = model.forward(tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    assert float(aux) > 0
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in
                  L.tree_leaves(tparams)]
        it = iter(leaves)
        p = L.tree_map(lambda _: next(it), tparams)
        got_r, aux_r = model.forward(p, {"tokens": torch.from_numpy(toks)},
                                     default_plan(kind="train"))
        assert aux_r.requires_grad
    np.testing.assert_allclose(got_r.detach().numpy(), got.numpy(),
                               rtol=0, atol=0)
    assert float(aux_r.detach()) == float(aux)


def _pools(cfg, jmodel, B):
    n_pages = 1 + B * MP
    jpages = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          jmodel.paged_cache_spec(n_pages, PS, jnp.float32))
    shape = (n_pages, PS, cfg.n_kv_heads, cfg.resolved_head_dim)
    tpages = {"layers": {f"l{i}": {"k_pages": torch.zeros(shape),
                                   "v_pages": torch.zeros(shape)}
                         for i in range(cfg.n_layers)}}
    bt = (1 + np.arange(B * MP, dtype=np.int32)).reshape(B, MP)
    return jpages, tpages, bt


def _assert_pages_close(jpages, tpages, first_page=0):
    for li, layer in tpages["layers"].items():
        for name, t in layer.items():
            want = np.asarray(jpages["layers"][li][name])[first_page:]
            np.testing.assert_allclose(
                t.numpy()[first_page:], want, rtol=TOL["rtol"],
                atol=TOL["atol"] * max(1.0, float(np.abs(want).max())),
                err_msg=f"{li}/{name}")


def _prefill_both(arch, prompts, chunk, jplan=None, plan=None):
    """Each prompt prefilled through both packages' prefill_chunk_step,
    in chunks of ``chunk`` (0: one chunk of the whole prompt)."""
    _, jmodel, jparams, cfg, model, tparams = _pair(arch)
    jpages, tpages, bt = _pools(cfg, jmodel, len(prompts))
    jchunk = jax.jit(lambda *a: jmodel.paged_prefill_chunk(
        *a, jplan or JRegionPlan()))
    for b, prompt in enumerate(prompts):
        c = chunk or prompt.size
        for base in range(0, prompt.size, c):
            piece = np.zeros((1, c), np.int32)
            part = prompt[base:base + c]
            piece[0, :part.size] = part
            jpages = jchunk(jparams, jpages, jnp.asarray(piece),
                            jnp.asarray(bt[b]), jnp.asarray(base, jnp.int32))
            out = model.paged_prefill_chunk(
                tparams, tpages, torch.from_numpy(piece),
                torch.from_numpy(bt[b]), base, plan)
            assert out is tpages
    return jpages, tpages, bt


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_prefill_chunk_and_decode_match(arch):
    """Whole-prompt prefill chunks (as the engine runs MoE prompts), then
    one paged decode step over three slots, one parked: pages and
    logits."""
    _, jmodel, jparams, cfg, model, tparams = _pair(arch)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (21, 9)]
    jpages, tpages, bt = _prefill_both(arch, prompts, chunk=0)
    _assert_pages_close(jpages, tpages)
    bt = np.concatenate([bt, np.zeros((1, MP), np.int32)])
    lengths = np.array([21, 9, 0], np.int32)
    n_pages = 1 + 3 * MP
    grow = lambda a: jnp.pad(a, ((0, n_pages - a.shape[0]),) +  # noqa
                             ((0, 0),) * (a.ndim - 1))
    jpages = jax.tree.map(grow, jpages)
    tpages = L.tree_map(lambda t: torch.cat(
        [t, t.new_zeros((n_pages - t.shape[0],) + t.shape[1:])]), tpages)
    toks = rng.integers(0, cfg.vocab_size, (3, 1)).astype(np.int32)
    want, jpages = jax.jit(lambda *a: jmodel.paged_decode(*a))(
        jparams, jpages, jnp.asarray(toks), jnp.asarray(bt),
        jnp.asarray(lengths))
    got, _ = model.paged_decode(tparams, tpages, torch.from_numpy(toks),
                                torch.from_numpy(bt),
                                torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy()[:2], np.asarray(want)[:2], **TOL)
    _assert_pages_close(jpages, tpages, first_page=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    """The port's own: greedy decode after prefill along the true
    continuation gives the teacher-forced forward's logits (capacity
    factor 8.0: no drops, as tests/test_models.py sets it)."""
    _, _, _, cfg, _, tparams = _pair(arch)
    model = build(dataclasses.replace(cfg, capacity_factor=8.0))
    B, S, extra = 2, 16, 4
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size,
                                             (B, S + extra))
    toks = torch.from_numpy(toks.astype(np.int32))
    full, _ = model.forward(tparams, {"tokens": toks})
    pre, cache = model.prefill(tparams, {"tokens": toks[:, :S]},
                               max_len=S + extra + 1)
    np.testing.assert_allclose(pre[:, -1].numpy(), full[:, S - 1].numpy(),
                               rtol=1e-4, atol=1e-4)
    for t in range(extra):
        dec, cache = model.decode(tparams, cache, toks[:, S + t][:, None])
        np.testing.assert_allclose(dec[:, 0].numpy(),
                                   full[:, S + t].numpy(),
                                   rtol=1e-4, atol=1e-4)


def test_param_counts_match_jax(monkeypatch):
    """count_params and active_param_count of both full configs equal the
    JAX package's, from the spec alone (nothing is materialised)."""
    def boom(*a, **k):
        raise AssertionError("a param was materialised")
    monkeypatch.setattr(L.Spec, "materialise", boom)
    for name in ("qwen2-moe-a2.7b", "granite-moe-1b-a400m"):
        cfg, jcfg = get_config(name), jget_config(name)
        assert (model_mod.count_params(cfg)
                == jmodel_mod.count_params(jcfg))
        assert (model_mod.active_param_count(cfg)
                == jmodel_mod.active_param_count(jcfg))
    assert model_mod.count_params(get_config("qwen2-moe-a2.7b")) \
        == 15146305536
    assert model_mod.count_params(get_config("granite-moe-1b-a400m")) \
        == 1334628352


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_chunked_prefill_routes_differently():
    """Why the engine keeps an MoE prompt in one chunk: at capacity factor
    1.25 a prompt prefilled in 8-token chunks writes other K/V into the
    pages after the first MoE layer than the same prompt in one chunk
    (layer 0's K/V precede every MoE layer and agree); at 8.0, with
    nothing dropped, both agree to rounding."""
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, 256, 24).astype(np.int32)
    for cf in (1.25, 8.0):
        _, cfg = _cfgs("granite", capacity_factor=cf)
        _, _, _, _, _, tparams = _pair("granite")
        model = build(cfg)
        pages = {}
        for chunk in (8, 24):
            shape = (1 + MP, PS, cfg.n_kv_heads, cfg.resolved_head_dim)
            p = {"layers": {f"l{i}": {"k_pages": torch.zeros(shape),
                                      "v_pages": torch.zeros(shape)}
                            for i in range(cfg.n_layers)}}
            bt = torch.arange(1, 1 + MP, dtype=torch.int32)
            for base in range(0, 24, chunk):
                model.paged_prefill_chunk(
                    tparams, p, torch.from_numpy(prompt[None, base:base
                                                        + chunk]),
                    bt, base)
            pages[chunk] = p["layers"]
        for li in ("l0", "l1"):
            diff = float((pages[8][li]["k_pages"]
                          - pages[24][li]["k_pages"]).abs().max())
            if li == "l0" or cf == 8.0:
                assert diff < 1e-5, (cf, li, diff)
            else:
                assert diff > 1e-2, (cf, li, diff)


_JSERVES: dict = {}


def _serve(arch, paged, **kw):
    """One trace served greedily by the JAX engine (once per case) and
    the port's on the CPU; returns the port's engine and result after
    asserting equal tokens and steps."""
    jcfg, jmodel, jparams, cfg, model, tparams = _pair(arch)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 256, n).astype(np.int32)
               for n in (11, 20, 11, 6, 20)]
    gens = [5, 7, 4, 8, 6]
    scfg = dict(max_len=40, max_slots=3, paged="on" if paged else "off",
                **kw)
    key = (arch, paged, tuple(sorted(kw.items())))
    if key not in _JSERVES:
        jreqs = [JRequest(rid=i, prompt=p.copy(), max_new_tokens=g)
                 for i, (p, g) in enumerate(zip(prompts, gens))]
        jres = JEngine(jmodel, jparams,
                       serve_cfg=JServeConfig(**scfg)).serve(jreqs)
        _JSERVES[key] = ([r.out_tokens for r in jreqs], jres["steps"])
    want, steps = _JSERVES[key]
    treqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=g)
             for i, (p, g) in enumerate(zip(prompts, gens))]
    eng = Engine(model, tparams, device="cpu",
                 serve_cfg=ServeConfig(**scfg))
    widths = []
    real = model.paged_prefill_chunk
    model.paged_prefill_chunk = lambda *a, **k: (
        widths.append(a[2].shape[1]) or real(*a, **k))
    try:
        res = eng.serve(treqs)
    finally:
        del model.paged_prefill_chunk
    for a, b in zip(want, treqs):
        assert b.state is RequestState.DONE, (b.rid, b.state, b.error)
        assert b.out_tokens == a, f"req {b.rid} diverged"
    assert res["steps"] == steps
    if paged:
        # every prompt in one chunk of its whole feed, prefill_chunk or no
        assert sorted(widths) == sorted(p.size - 1 for p in prompts)
        assert res["page_leaks"] == 0
    return eng, res


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slot"])
@pytest.mark.parametrize("arch", ARCHS)
def test_served_tokens_match_jax(arch, paged):
    """Greedy tokens equal the JAX engine's: on the paged pool with
    ``prefill_chunk`` 8, which both engines ignore for MoE, and on the
    slot pool."""
    _serve(arch, paged, prefill_chunk=8 if paged else 0)


def test_spec_depth_resolves_to_zero():
    """MoE pins speculation off, as the JAX engine does: spec_depth 2 is
    asked for and no draft is ever verified."""
    eng, res = _serve("granite", True, prefill_chunk=8, spec_depth=2)
    assert eng.spec_depth_for(eng.plan) == 0
    assert res["spec"]["max_depth"] == 0
    assert res["spec"]["accepted_drafts"] == 0


def test_moe_prefix_cache_forced_off_bit_identical():
    """As tests/test_prefix_cache.py holds the JAX engine: prefix sharing
    asked for is forced off for MoE, and three requests with one prompt
    give the tokens of a cold pool."""
    _, _, _, cfg, model, tparams = _pair("granite")
    prompt = np.random.default_rng(3).integers(0, 256, 24).astype(np.int32)
    outs = {}
    for mode in ("off", "on"):
        eng = Engine(model, tparams, device="cpu", serve_cfg=ServeConfig(
            max_len=40, max_slots=3, page_size=8, prefix_cache=mode))
        reqs = [Request(rid=i, prompt=prompt.copy(), max_new_tokens=6)
                for i in range(3)]
        res = eng.serve(reqs)
        assert eng.prefix_cache_for(eng.plan) is False
        pf = res["memory"]["prefix"]
        assert not pf["enabled"]
        assert pf["hit_requests"] == 0 and pf["tokens_saved"] == 0
        assert all(r.state is RequestState.DONE for r in reqs)
        outs[mode] = [r.out_tokens for r in reqs]
    assert outs["on"] == outs["off"]
