"""The serve engine's compiled steps (``repro_torch.serve.graphs``): on
``cuda`` the paged decode step, the paged prefill chunk and the slot-pool
decode step replay as CUDA graphs; on the CPU they run as the step
functions.

On the CPU the graph's own logic is held with an eager stand-in for the
CUDA part (:class:`EagerGraph`: the warm-up and the "capture" run the step
function, a "replay" runs it again over the same static inputs and copies
into the captured outputs), driven by the engine's real step functions:
the static inputs keep their buffers, the outputs equal the direct call bit
for bit, the launch and shape tallies add per replay, and a warm-up leaves
every live slot as it was.  Through the engine, served tokens equal the
JAX package's, eagerly (no graph is built) and through the stand-in.
Reduced configs, f32 weights from the JAX package's ``Model.init``.  The
``gpu`` tests hold the real graphs against the step functions on the card
(they skip here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.core.policy import RegionConfig as JRegionConfig
from repro.core.policy import RegionPlan as JRegionPlan
from repro.models.model import build as jbuild
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.scheduler import Request as JRequest
from repro_torch.configs.registry import get_config
from repro_torch.core.policy import RegionConfig, RegionPlan
from repro_torch.kernels import LAUNCH_SHAPES, LAUNCHES, count_launch
from repro_torch.kernels import paged_attention as tpa
from repro_torch.models import layers as L
from repro_torch.models.model import build, params_from_numpy
from repro_torch.serve import engine as engine_mod
from repro_torch.serve import graphs
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.scheduler import Request, RequestState

# pages against the JAX package's, as tests/test_torch_model.py holds them
# (the f32 tolerances of tests/test_kernels.py, 1e-4 relative and 1e-5 of
# the tensor's largest magnitude: deeper layers' K rows are sums of O(1)
# terms that can cancel)
RTOL, ATOL = 1e-4, 1e-5
PROMPTS = (5, 12, 20, 9, 17)
GENS = (6, 10, 8, 12, 7)


def _leaves(out):
    if out is None:
        return []
    return [out] if isinstance(out, torch.Tensor) else list(out)


class EagerGraph(graphs.StepGraph):
    """The CPU stand-in for the CUDA graph; the static inputs, the tallies
    and the calls are :class:`graphs.StepGraph`'s own.  As in a capture,
    nothing runs at :meth:`_record`: the first replay's outputs become the
    output tensors, and later replays copy into them."""

    def _warmup(self, fn):
        fn(*self.inputs.tensors)

    def _record(self):
        return None

    def _replay(self):
        saved = graphs._tallies()
        out = self.fn(*self.inputs.tensors)
        graphs._restore(saved)
        if self.outputs is None:
            self.outputs = out
        for dst, src in zip(_leaves(self.outputs), _leaves(out)):
            if dst is not src:
                dst.copy_(src)


class CountingGraph(EagerGraph):
    """A stand-in whose capture runs the (pure) step, so that the
    launches its wrappers count at capture can be followed."""

    def _record(self):
        return self.fn(*self.inputs.tensors)


@pytest.fixture
def standin(monkeypatch):
    """The engine takes its graph path on the CPU, with :class:`EagerGraph`
    standing in for the CUDA graph."""
    monkeypatch.setattr(engine_mod, "StepGraph", EagerGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(Engine, "_use_graphs", lambda self: True)


_MODELS: dict = {}


def _models(arch):
    if arch not in _MODELS:
        jmodel = jbuild(jget_config(arch).reduced())
        jparams = jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32)
        model = build(get_config(arch).reduced())
        _MODELS[arch] = (jmodel, jparams, model, params_from_numpy(
            jax.tree.map(np.asarray, jparams), device="cpu"))
    return _MODELS[arch]


def _paged_plan():
    return RegionPlan(region_configs={"layer/attn": RegionConfig(
        attn_impl="paged")})


def _random_state(tree, seed):
    """Fill every leaf of a pool in place from a numpy seed: floats
    N(0, 0.5^2), integer leaves (slot positions) in [4, 24)."""
    rng = np.random.default_rng(seed)
    for t in L.tree_leaves(tree):
        if t.dtype.is_floating_point:
            a = rng.normal(0, 0.5, tuple(t.shape))
        else:
            a = rng.integers(4, 24, tuple(t.shape))
        t.copy_(torch.as_tensor(a, dtype=t.dtype))


def _clone(tree):
    return [t.clone() for t in L.tree_leaves(tree)]


def _assert_equal(got, want, what):
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), f"{what}: leaf {i} differs"


# ---------------------------------------------------------------------------
# graphs.py on its own
# ---------------------------------------------------------------------------


def test_static_inputs_load_into_fixed_buffers():
    specs = [((2, 3), torch.int32), ((4,), torch.bool), ((), torch.int32),
             ((3, 5), torch.int32)]
    inp = graphs.StaticInputs(specs, torch.device("cpu"))
    ptrs = [t.data_ptr() for t in inp.tensors]
    assert all(p % graphs.ALIGN == 0 for p in ptrs)
    rng = np.random.default_rng(0)
    for _ in range(2):
        arrays = [rng.integers(-9, 9, (2, 3)).astype(np.int32),
                  rng.random(4) < 0.5, np.int32(rng.integers(0, 99)),
                  rng.integers(0, 9, (3, 5)).astype(np.int32)]
        inp.load(*arrays)
        for t, a, (shape, dtype) in zip(inp.tensors, arrays, specs):
            assert (t.shape, t.dtype) == (shape, dtype)
            np.testing.assert_array_equal(t.numpy(), a)
        assert [t.data_ptr() for t in inp.tensors] == ptrs
    with pytest.raises(ValueError):
        inp.load(arrays[0])


def test_graph_takes_capture_launches_out_and_adds_them_per_replay():
    """A step that launches "two kernels": the warm-up's and the capture's
    launches leave the tallies as they were, and each replay adds the
    capture's two to LAUNCHES and LAUNCH_SHAPES."""
    name, key = tpa.NAME, (tpa.NAME, 8, 1)

    def fn(x):
        count_launch(name, 8, 1)
        count_launch(name, 8, 1)
        return x * 2

    before, shapes = LAUNCHES[name], LAUNCH_SHAPES.get(key, 0)
    g = CountingGraph(fn, graphs.StaticInputs([((3,), torch.int32)],
                                              "cpu"))
    assert (LAUNCHES[name], LAUNCH_SHAPES.get(key, 0)) == (before, shapes)
    assert g.launches == {name: 2} and g.warmup_launches == {name: 2}
    assert g.launch_shapes == {key: 2}
    out = g.outputs
    for i in range(1, 4):
        assert g(np.array([i, 2, 3])) is out
        assert out.tolist() == [2 * i, 4, 6]
        assert LAUNCHES[name] == before + 2 * i
        assert LAUNCH_SHAPES[key] == shapes + 2 * i


def test_workspaces_outlive_the_graph_that_read_them(monkeypatch):
    """A wrapper replacing its per-stream buffer with a larger one does not
    free the one a graph captured."""
    ws: dict = {}
    monkeypatch.setattr(graphs, "WORKSPACES", [ws])
    ws[(0, 1)] = old = torch.zeros(4)

    class Held(CountingGraph):
        def _record(self):
            self._keep = [t for d in graphs.WORKSPACES for t in d.values()]
            return super()._record()

    g = Held(lambda x: x + 1, graphs.StaticInputs([((2,), torch.int32)],
                                                 "cpu"))
    ws[(0, 1)] = torch.zeros(64)
    assert any(t is old for t in g._keep)


# ---------------------------------------------------------------------------
# the engine's steps through the stand-in, against the direct call
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("depth", [0, 2])
def test_paged_step_replay_equals_direct_call(standin, depth):
    """The paged decode step at S = 1 and 3, four slots live on ragged
    lengths and one parked: tokens, finite flags and every page but the
    null sink equal the step function's, and the static inputs keep their
    buffers across calls."""
    _check_paged_replay("stablelm-1.6b", depth)


def test_moe_paged_step_replay_equals_direct_call(standin):
    """The same for an MoE model's decode step (granite-moe-1b-a400m, the
    einsum dispatch; MoE pins speculation off, so S = 1 only)."""
    _check_paged_replay("granite-moe-1b-a400m", 0)


def _check_paged_replay(arch, depth):
    _, _, model, params = _models(arch)
    eng = Engine(model, params, plan=_paged_plan(), device="cpu",
                 serve_cfg=ServeConfig(max_len=40, max_slots=5,
                                       page_size=8, spec_depth=depth))
    eng._ensure_pool()
    pool = eng._pool
    _random_state(pool.pages, 1)
    rng = np.random.default_rng(2)
    B, MP = pool.n_slots, pool.max_pages_per_slot
    bt = (1 + np.arange(B * MP, dtype=np.int32)).reshape(B, MP)
    lengths = np.array([30, 7, 0, 19, 11], np.int32)
    act = np.array([1, 1, 1, 1, 0], bool)
    bt[~act] = 0
    lengths[~act] = 0
    S = depth + 1
    for call in range(2):
        toks = rng.integers(0, 256, (B, S)).astype(np.int32)
        start = _clone(pool.pages)
        want = eng._pool_step(params, pool.pages, torch.as_tensor(toks),
                              torch.as_tensor(bt), torch.as_tensor(lengths),
                              torch.as_tensor(act), None)
        want_pages = _clone(pool.pages)
        for t, s in zip(L.tree_leaves(pool.pages), start):
            t.copy_(s)
        got = eng._paged_decode(toks, bt, lengths, act, None)
        _assert_equal(got, want, "tokens, finite")
        _assert_equal([t[1:] for t in L.tree_leaves(pool.pages)],
                      [t[1:] for t in want_pages], "pages")
        graph = eng._graphs[eng._pool_step]
        ptrs = [t.data_ptr() for t in graph.inputs.tensors]
        if call:
            assert ptrs == first
        first = ptrs
    assert list(eng._graphs) == [eng._pool_step]


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-2.7b"])
@pytest.mark.parametrize("depth", [0, 2])
def test_slot_step_replay_equals_direct_call(standin, monkeypatch, arch,
                                            depth):
    """The slot-pool step with its pool update (spec_depth 2 in chunk mode,
    as the smoke serves it), on a random pool with one parked slot: tokens,
    finite flags and every pool leaf equal the step function's plus
    ``pool.update``, and the warm-up leaves the live pool as it was."""
    _, _, model, params = _models(arch)
    eng = Engine(model, params, device="cpu", serve_cfg=ServeConfig(
        max_len=32, max_slots=3, paged="off", spec_depth=depth,
        scan_mode="chunk" if depth else "auto"))
    eng._ensure_pool()
    pool = eng._pool
    _random_state(pool.pool, 3)
    toks = np.random.default_rng(4).integers(0, 256, (3, depth + 1))
    toks = toks.astype(np.int32)
    act = np.array([1, 0, 1], bool)
    start = _clone(pool.pool)
    out, finite, caches = eng._pool_step(params, pool.pool,
                                         torch.as_tensor(toks),
                                         torch.as_tensor(act), None)
    pool.update(caches)
    want = _clone(pool.pool)
    for t, s in zip(L.tree_leaves(pool.pool), start):
        t.copy_(s)
    seen = []

    class Watch(EagerGraph):
        def _record(self):
            seen.append(_clone(pool.pool))
            return super()._record()

    monkeypatch.setattr(engine_mod, "StepGraph", Watch)
    got = eng._slot_decode(toks, act, None)
    _assert_equal(seen[0], start, "live pool after the warm-up")
    _assert_equal(got, (out, finite), "tokens, finite")
    _assert_equal(_clone(pool.pool), want, "pool")


def test_prefill_chunk_with_a_tensor_base(standin):
    """``base`` as a 0-dim int32 tensor writes the pages an int ``base``
    writes, bit for bit, and both equal the JAX package's
    ``paged_prefill_chunk`` within f32 rounding; through the engine, one
    graph of width C serves every slot and chunk index."""
    jmodel, jparams, model, params = _models("stablelm-1.6b")
    cfg = model.cfg
    PS, MP, C = 8, 4, 8
    n_pages = 1 + 2 * MP
    shape = (n_pages, PS, cfg.n_kv_heads, cfg.resolved_head_dim)
    pages = {as_t: {"layers": {f"l{i}": {"k_pages": torch.zeros(shape),
                                         "v_pages": torch.zeros(shape)}
                               for i in range(cfg.n_layers)}}
             for as_t in (False, True)}
    jpages = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          jmodel.paged_cache_spec(n_pages, PS, jnp.float32))
    jplan = JRegionPlan(region_configs={"layer/attn": JRegionConfig()})
    plan = RegionPlan(region_configs={"layer/attn": RegionConfig()})
    jchunk = jax.jit(lambda *a: jmodel.paged_prefill_chunk(*a, jplan))
    bt = (1 + np.arange(2 * MP, dtype=np.int32)).reshape(2, MP)
    rng = np.random.default_rng(5)
    for slot, n in ((0, 19), (1, 6)):
        prompt = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
        for base in range(0, n, C):
            piece = np.zeros((1, C), np.int32)
            part = prompt[base:base + C]
            piece[0, :part.size] = part
            jpages = jchunk(jparams, jpages, jnp.asarray(piece),
                            jnp.asarray(bt[slot]),
                            jnp.asarray(base, jnp.int32))
            for as_t, tree in pages.items():
                b = torch.tensor(base, dtype=torch.int32) if as_t else base
                model.paged_prefill_chunk(params, tree,
                                          torch.from_numpy(piece),
                                          torch.from_numpy(bt[slot]), b, plan)
    _assert_equal(L.tree_leaves(pages[True]), L.tree_leaves(pages[False]),
                  "tensor base vs int base")
    for li, layer in pages[True]["layers"].items():
        for name, t in layer.items():
            want = np.asarray(jpages["layers"][li][name])
            np.testing.assert_allclose(
                t.numpy(), want, rtol=RTOL,
                atol=ATOL * max(1.0, float(np.abs(want).max())),
                err_msg=f"{li}/{name}")


# ---------------------------------------------------------------------------
# served tokens against the JAX engine
# ---------------------------------------------------------------------------


_JAX_SERVES: dict = {}


def _serve_pair(arch, **cfg):
    """Serve one numpy-seeded trace through the JAX engine (once per arch)
    and the port's on the CPU; returns the port's engine after asserting
    equal tokens and step counts."""
    jmodel, jparams, model, params = _models(arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in PROMPTS]
    paged = cfg.get("paged", "auto") != "off"
    if arch not in _JAX_SERVES:
        jreqs = [JRequest(rid=i, prompt=p.copy(), max_new_tokens=g)
                 for i, (p, g) in enumerate(zip(prompts, GENS))]
        jplan = (JRegionPlan(region_configs={"layer/attn": JRegionConfig(
            attn_impl="paged")}) if paged else None)
        jres = JEngine(jmodel, jparams, plan=jplan,
                       serve_cfg=JServeConfig(**cfg)).serve(jreqs)
        _JAX_SERVES[arch] = ([r.out_tokens for r in jreqs], jres["steps"])
    want, steps = _JAX_SERVES[arch]
    treqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=g)
             for i, (p, g) in enumerate(zip(prompts, GENS))]
    eng = Engine(model, params, plan=_paged_plan() if paged else None,
                 device="cpu", serve_cfg=ServeConfig(**cfg))
    launches = dict(LAUNCHES)
    res = eng.serve(treqs)
    assert LAUNCHES == launches         # the CPU path launches no kernel
    for a, b in zip(want, treqs):
        assert b.state is RequestState.DONE, (b.rid, b.state, b.error)
        assert b.out_tokens == a, f"req {b.rid} diverged"
    assert res["steps"] == steps
    return eng


SERVES = {"stablelm-1.6b": dict(max_len=40, max_slots=3, prefill_chunk=8,
                                spec_depth=2),
          "rwkv6-3b": dict(max_len=40, max_slots=3, paged="off",
                           spec_depth=2, prefill_chunk=8)}


@pytest.mark.parametrize("arch", list(SERVES))
def test_cpu_engine_builds_no_graph_and_matches_jax(arch):
    eng = _serve_pair(arch, **SERVES[arch])
    assert eng._graphs == {} and eng._graph_pool is None


@pytest.mark.parametrize("arch", list(SERVES))
def test_graph_path_matches_jax(standin, arch):
    """The same serves through the engine's graph path (the stand-in
    replays): one decode graph, and on the paged pool one prefill-chunk
    graph of width 8."""
    eng = _serve_pair(arch, **SERVES[arch])
    keys = set(eng._graphs)
    want = {eng._pool_step}
    if eng._paged:
        want.add(("prefill_chunk", 8))
    assert keys == want


def test_moe_graph_path_matches_jax(standin):
    """An MoE model on the paged pool through the graph path, with
    ``prefill_chunk`` 8 and ``spec_depth`` 2 asked for: tokens equal the
    JAX engine's, the decode step replays one graph (S = 1), and every
    prompt prefills eagerly in one chunk, so no prefill graph is built."""
    eng = _serve_pair("granite-moe-1b-a400m", max_len=40, max_slots=3,
                      prefill_chunk=8, spec_depth=2)
    assert set(eng._graphs) == {eng._pool_step}
    graph = eng._graphs[eng._pool_step]
    assert graph.inputs.tensors[0].shape == (3, 1)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "rwkv6-3b"])
def test_capture_mid_serve_after_a_replan(standin, monkeypatch, arch):
    """A replan on the fourth step moves the engine to a second step-cache
    key (spec_depth 2; on the slot pool also scan_mode chunk) mid-serve:
    its graph is captured then, its warm-up leaves every live slot's state
    as it was (the paged pool's pages but the null sink; the slot pool's
    every leaf), and the served tokens equal an eager engine's under the
    same replan."""
    _, _, model, params = _models(arch)
    paged = arch == "stablelm-1.6b"
    cfg = dict(max_len=40, max_slots=3, spec_depth=-1, prefill_chunk=8)
    if not paged:
        cfg.update(paged="off", scan_mode="auto")

    def replan(self, n_active):
        self._calls = getattr(self, "_calls", 0) + 1
        if self._calls == 4:
            plan = RegionPlan(region_configs={
                "layer/attn": RegionConfig(attn_impl="paged" if paged
                                           else "", spec_depth=2),
                **({} if paged else {"layer/tmix": RegionConfig(
                    scan_mode="chunk")})})
            key = self._step_cache_key(plan)
            self._pool_steps[key] = self._build_step(plan)
            self._pool_step, self._spec_depth, _ = self._pool_steps[key]

    monkeypatch.setattr(Engine, "_maybe_replan", replan)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in PROMPTS]
    held = []

    class Watch(EagerGraph):
        def _warmup(self, fn):
            live = eng._pool.pages if paged else eng._pool.pool
            cut = (lambda t: t[1:]) if paged else (lambda t: t)
            before = [cut(t).clone() for t in L.tree_leaves(live)]
            super()._warmup(fn)
            held.append(all(torch.equal(cut(t), b) for t, b in
                            zip(L.tree_leaves(live), before)))

    outs = {}
    for graphed in (False, True):
        monkeypatch.setattr(Engine, "_use_graphs", lambda self, g=graphed: g)
        monkeypatch.setattr(engine_mod, "StepGraph", Watch)
        eng = Engine(model, params, plan=_paged_plan() if paged else None,
                     device="cpu", serve_cfg=ServeConfig(**cfg))
        reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=g)
                for i, (p, g) in enumerate(zip(prompts, GENS))]
        res = eng.serve(reqs)
        assert all(r.state is RequestState.DONE for r in reqs)
        assert res["spec"]["max_depth"] == 2
        outs[graphed] = [r.out_tokens for r in reqs]
    decode_graphs = [k for k in eng._graphs if callable(k)]
    assert len(decode_graphs) == 2
    assert held and all(held)
    assert outs[True] == outs[False]


# ---------------------------------------------------------------------------
# on the card (skip here)
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _cuda_model(arch, dev):
    model = build(get_config(arch).reduced())
    return model, model.init(0, dtype=torch.float32, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["paged-1", "paged-3", "chunk",
                                  "rwkv6-3b-0", "rwkv6-3b-2",
                                  "zamba2-2.7b-0", "zamba2-2.7b-2"])
def test_gpu_replay_equals_eager_step(case):
    """Each captured step against its step function on the card, on the
    same inputs from the same pool state: equal tokens and finite flags,
    pages (but the null sink) and caches equal bit for bit."""
    dev = _cuda()
    rng = np.random.default_rng(7)
    if case.startswith("paged") or case == "chunk":
        model, params = _cuda_model("stablelm-1.6b", dev)
        depth = int(case[-1]) - 1 if case != "chunk" else 0
        eng = Engine(model, params, plan=_paged_plan(), device=dev,
                     serve_cfg=ServeConfig(max_len=64, max_slots=4,
                                           page_size=8, prefill_chunk=16,
                                           spec_depth=depth))
        eng._ensure_pool()
        pool = eng._pool
        live = pool.pages
        _random_state(live, 8)
        B, MP = pool.n_slots, pool.max_pages_per_slot
        bt = (1 + np.arange(B * MP, dtype=np.int32)).reshape(B, MP)
        if case == "chunk":
            pool.block_tables[2] = bt[2]
            toks = rng.integers(0, 256, 16).astype(np.int32)

            def eager():
                model.paged_prefill_chunk(
                    params, live, torch.as_tensor(toks[None], device=dev),
                    torch.as_tensor(bt[2], device=dev), 16, eng.plan)

            def graphed():
                eng._paged_prefill(toks, 2, 16)
        else:
            lengths = np.array([50, 7, 33, 0], np.int32)
            act = lengths > 0
            bt[~act] = 0
            toks = rng.integers(0, 256, (B, depth + 1)).astype(np.int32)

            def eager():
                return eng._pool_step(params, live, *(
                    torch.as_tensor(a, device=dev)
                    for a in (toks, bt, lengths, act)), None)

            def graphed():
                return eng._paged_decode(toks, bt, lengths, act, None)
        cut = (lambda t: t[1:])
    else:
        arch, depth = case[:-2], int(case[-1])
        model, params = _cuda_model(arch, dev)
        eng = Engine(model, params, device=dev, serve_cfg=ServeConfig(
            max_len=64, max_slots=4, paged="off", spec_depth=depth,
            scan_mode="chunk" if depth else "auto"))
        eng._ensure_pool()
        pool = eng._pool
        live = pool.pool
        _random_state(live, 9)
        toks = rng.integers(0, 256, (4, depth + 1)).astype(np.int32)
        act = np.array([1, 1, 0, 1], bool)

        def eager():
            out, finite, caches = eng._pool_step(
                params, live, torch.as_tensor(toks, device=dev),
                torch.as_tensor(act, device=dev), None)
            pool.update(caches)
            return out, finite

        def graphed():
            return eng._slot_decode(toks, act, None)
        cut = (lambda t: t)
    start = _clone(live)
    for run in range(2):                # the capture, then a plain replay
        want = eager()
        want_state = [cut(t).clone() for t in L.tree_leaves(live)]
        for t, s in zip(L.tree_leaves(live), start):
            t.copy_(s)
        got = graphed()
        torch.cuda.synchronize()
        if want is not None:
            _assert_equal([t.cpu() for t in got], [t.cpu() for t in want],
                          "tokens, finite")
        _assert_equal([cut(t) for t in L.tree_leaves(live)], want_state,
                      f"state after replay {run}")
        for t, s in zip(L.tree_leaves(live), start):
            t.copy_(s)
    assert len(eng._graphs) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "rwkv6-3b"])
def test_gpu_capture_mid_serve_leaves_live_slots_unchanged(monkeypatch,
                                                           arch):
    """A forced replan on the fourth step captures a second decode graph
    mid-serve: its warm-up and capture leave every live slot's state bit
    for bit as it was, and every request finishes."""
    dev = _cuda()
    model, params = _cuda_model(arch, dev)
    paged = arch == "stablelm-1.6b"
    cfg = dict(max_len=64, max_slots=3, spec_depth=-1, prefill_chunk=8)
    if not paged:
        cfg.update(paged="off")

    def replan(self, n_active):
        self._calls = getattr(self, "_calls", 0) + 1
        if self._calls == 4:
            plan = RegionPlan(region_configs={"layer/attn": RegionConfig(
                attn_impl="paged" if paged else "", spec_depth=2)})
            key = self._step_cache_key(plan)
            self._pool_steps[key] = self._build_step(plan)
            self._pool_step, self._spec_depth, _ = self._pool_steps[key]

    held = []

    class Watch(graphs.StepGraph):
        def _warmup(self, fn):
            live = eng._pool.pages if paged else eng._pool.pool
            cut = (lambda t: t[1:]) if paged else (lambda t: t)
            before = [cut(t).clone() for t in L.tree_leaves(live)]
            super()._warmup(fn)
            self._check = (live, cut, before)

        def _record(self):
            out = super()._record()
            live, cut, before = self._check
            held.append(all(torch.equal(cut(t), b) for t, b in
                            zip(L.tree_leaves(live), before)))
            return out

    monkeypatch.setattr(Engine, "_maybe_replan", replan)
    monkeypatch.setattr(engine_mod, "StepGraph", Watch)
    eng = Engine(model, params, plan=_paged_plan() if paged else None,
                 device=dev, serve_cfg=ServeConfig(**cfg))
    rng = np.random.default_rng(10)
    reqs = [Request(rid=i, prompt=rng.integers(0, 256, n).astype(np.int32),
                    max_new_tokens=g)
            for i, (n, g) in enumerate(zip(PROMPTS, GENS))]
    res = eng.serve(reqs)
    assert all(r.state is RequestState.DONE for r in reqs)
    assert res["spec"]["max_depth"] == 2
    assert len([k for k in eng._graphs if callable(k)]) == 2
    assert held and all(held)


@pytest.mark.gpu
def test_gpu_moe_decode_replay_equals_eager_step():
    """The MoE paged decode step's graph against its step function on the
    card (reduced granite-moe-1b-a400m, the einsum and the scatter
    dispatch), on the same inputs from the same pages: equal tokens and
    finite flags, every page but the null sink equal bit for bit, at the
    capture and at a plain replay."""
    dev = _cuda()
    model, params = _cuda_model("granite-moe-1b-a400m", dev)
    rng = np.random.default_rng(11)
    for impl in ("einsum", "scatter"):
        plan = RegionPlan(region_configs={
            "layer/attn": RegionConfig(attn_impl="paged"),
            "moe": RegionConfig(moe_impl=impl)})
        eng = Engine(model, params, plan=plan, device=dev,
                     serve_cfg=ServeConfig(max_len=64, max_slots=4,
                                           page_size=8))
        eng._ensure_pool()
        live = eng._pool.pages
        _random_state(live, 10)
        B, MP = eng._pool.n_slots, eng._pool.max_pages_per_slot
        bt = (1 + np.arange(B * MP, dtype=np.int32)).reshape(B, MP)
        lengths = np.array([50, 7, 33, 0], np.int32)
        act = lengths > 0
        bt[~act] = 0
        toks = rng.integers(0, 256, (B, 1)).astype(np.int32)
        start = _clone(live)
        for run in range(2):
            want = eng._pool_step(params, live, *(
                torch.as_tensor(a, device=dev)
                for a in (toks, bt, lengths, act)), None)
            want_pages = [t[1:].clone() for t in L.tree_leaves(live)]
            for t, s0 in zip(L.tree_leaves(live), start):
                t.copy_(s0)
            got = eng._paged_decode(toks, bt, lengths, act, None)
            torch.cuda.synchronize()
            _assert_equal([t.cpu() for t in got], [t.cpu() for t in want],
                          f"{impl}: tokens, finite")
            _assert_equal([t[1:] for t in L.tree_leaves(live)], want_pages,
                          f"{impl}: pages after replay {run}")
            for t, s0 in zip(L.tree_leaves(live), start):
                t.copy_(s0)
        assert len(eng._graphs) == 1


@pytest.mark.gpu
def test_gpu_sampling_replays_draw_fresh_tokens():
    """At temperature 1 the graph ends at the guarded logits and the draw
    runs after it from the engine's generator: two replays on the same
    inputs draw different tokens."""
    dev = _cuda()
    model, params = _cuda_model("stablelm-1.6b", dev)
    eng = Engine(model, params, plan=_paged_plan(), device=dev,
                 serve_cfg=ServeConfig(max_len=64, max_slots=8, page_size=8,
                                       temperature=1.0))
    eng._ensure_pool()
    B, MP = eng._pool.n_slots, eng._pool.max_pages_per_slot
    bt = (1 + np.arange(B * MP, dtype=np.int32)).reshape(B, MP)
    lengths = np.full(B, 5, np.int32)
    act = np.ones(B, bool)
    toks = np.arange(B, dtype=np.int32)[:, None]
    gen = torch.Generator(device=dev).manual_seed(0)
    draws = [eng._paged_decode(toks, bt, lengths, act, gen)[0].cpu()
             for _ in range(2)]
    assert not torch.equal(*draws)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "rwkv6-3b"])
def test_gpu_launches_equal_model_calls_times_layers(arch):
    """Counted under replay: the paged kernel once a layer a decode step;
    the scan kernels once a layer a model call (pool steps, prefill calls,
    re-advances); the shape tally adds up to the same launches."""
    dev = _cuda()
    model, params = _cuda_model(arch, dev)
    paged = arch == "stablelm-1.6b"
    cfg = dict(max_len=64, max_slots=3, spec_depth=2, prefill_chunk=8)
    if not paged:
        cfg.update(paged="off")
    eng = Engine(model, params, plan=_paged_plan() if paged else None,
                 device=dev, serve_cfg=ServeConfig(**cfg))
    rng = np.random.default_rng(11)
    reqs = [Request(rid=i, prompt=rng.integers(0, 256, n).astype(np.int32),
                    max_new_tokens=g)
            for i, (n, g) in enumerate(zip(PROMPTS, GENS))]
    from repro_torch.kernels import reset_launches
    reset_launches()
    res = eng.serve(reqs)
    torch.cuda.synchronize()
    names = (("paged_attention_mq",) if paged
             else ("wkv_fused", "wkv_chunk"))
    calls = res["steps"] + (0 if paged else res["slot_calls"]["prefill"]
                            + res["slot_calls"]["readvance"])
    launched = sum(LAUNCHES[n] for n in names)
    assert launched == calls * model.cfg.n_layers
    assert sum(n for k, n in LAUNCH_SHAPES.items()
               if k[0] in names) == launched
