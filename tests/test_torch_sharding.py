"""``repro_torch.core.policy.legal_spec`` and
``repro_torch.distributed.sharding`` against the JAX package's, leaf for
leaf: the legality property tests of ``tests/test_policy.py`` on the same
hypothesis inputs, and the param, optimizer-state (ZeRO-1), cache and
batch specs of all ten registered configs at full width (abstract shapes
only) on four meshes.  Then the port's own pieces: cutting a leaf into
ranks' shards and back, and a collective's count on the meta device.

The JAX package's ``legal_spec`` reads only ``mesh.shape``, so a stand-in
with that dict serves both packages; its ``NamedSharding`` (which needs
real devices) is replaced by the spec it would hold.
"""
import jax
import numpy as np
import pytest
import torch

try:
    import hypothesis.strategies as st
    from hypothesis import given, settings
except ImportError:  # fall back to the deterministic local shim
    from _hypothesis_compat import given, settings
    from _hypothesis_compat import strategies as st

from repro.configs.registry import ARCH_IDS as J_ARCH_IDS
from repro.configs.registry import get_config as jget_config
from repro.core import policy as jpolicy
from repro.distributed import sharding as jsharding
from repro.models.model import build as jbuild
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core import counters
from repro_torch.core import policy as tpolicy
from repro_torch.distributed import comm
from repro_torch.distributed import sharding as tsharding
from repro_torch.models import layers as L
from repro_torch.models.model import build

AXES = [None, "batch", "seq", "embed", "ff", "heads", "kv_heads", "vocab",
        "experts", "ssm_dim"]
MESHES = [(1, 2), (1, 4), (2, 2), (2, 4)]


class FakeMesh:
    """Mesh stand-in with arbitrary axis sizes (no devices needed)."""
    def __init__(self, data, model, pod=0, coords=None):
        self.shape = {"data": data, "model": model}
        if pod:
            self.shape["pod"] = pod
        self.coords = coords or {}


def _entries(spec) -> tuple:
    """A JAX PartitionSpec's entries as the port's spec tuple."""
    return tuple(tuple(e) if isinstance(e, list) else e for e in spec)


def _check_legal(shape, spec, mesh):
    used = set()
    for dim, entry in zip(shape, spec):
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        size = 1
        for n in names:
            assert n in mesh.shape
            assert n not in used, "mesh axis used twice"
            used.add(n)
            size *= mesh.shape[n]
        assert dim % size == 0, f"dim {dim} not divisible by {size}"


@given(
    shape=st.lists(st.integers(1, 512), min_size=1, max_size=4),
    axes=st.lists(st.sampled_from(AXES), min_size=4, max_size=4),
    data=st.sampled_from([2, 4, 16]),
    model=st.sampled_from([2, 4, 16]),
    pod=st.sampled_from([0, 2]),
)
@settings(max_examples=200, deadline=None)
def test_legal_spec_equals_jax_and_is_always_divisible(shape, axes, data,
                                                       model, pod):
    mesh = FakeMesh(data, model, pod)
    spec = tpolicy.legal_spec(shape, axes[: len(shape)],
                              tpolicy.DEFAULT_RULES, mesh)
    jspec = jpolicy.legal_spec(shape, axes[: len(shape)],
                               jpolicy.DEFAULT_RULES, mesh)
    assert spec == _entries(jspec)
    _check_legal(shape, spec, mesh)


@given(
    shape=st.lists(st.sampled_from([1, 3, 5, 7, 20, 60]), min_size=1,
                   max_size=3),
    axes=st.lists(st.sampled_from(AXES), min_size=3, max_size=3),
)
@settings(max_examples=100, deadline=None)
def test_awkward_dims_replicate_as_jax(shape, axes):
    """Dims that don't divide 16 are always replicated, never errored."""
    mesh = FakeMesh(16, 16)
    spec = tpolicy.legal_spec(shape, axes[: len(shape)],
                              tpolicy.DEFAULT_RULES, mesh)
    assert spec == _entries(jpolicy.legal_spec(
        shape, axes[: len(shape)], jpolicy.DEFAULT_RULES, mesh))
    for dim, entry in zip(shape, spec):
        assert entry is None or dim % 16 == 0


def test_vocabularies_the_degree_does_not_divide_stay_whole():
    """internvl2-26b's 92553 and granite's 49155 do not split at tp 2:
    their (un)embedding stays whole, as the JAX package rules."""
    plan = tpolicy.RegionPlan(mesh=FakeMesh(1, 2))
    for arch in ("internvl2-26b", "granite-moe-1b-a400m"):
        specs = tsharding.param_shardings(build(get_config(arch)), plan)
        assert specs["embed"]["tokens"] == ()
    specs = tsharding.param_shardings(build(get_config("stablelm-1.6b")),
                                      plan)
    assert specs["embed"]["tokens"] == ("model",)


def test_plan_carries_its_mesh_through_json():
    mesh = FakeMesh(1, 2)
    plan = tpolicy.default_plan(mesh, "decode")
    assert plan.mesh is mesh and plan.model_size() == 2
    again = tpolicy.RegionPlan.from_json(plan.to_json(), mesh=mesh)
    assert again.mesh is mesh and again.rules == plan.rules
    assert tpolicy.RegionPlan.from_json(plan.to_json()).mesh is None
    assert plan.param_sharding((8, 6), ("ff", "embed")) == ("model",)
    assert plan.param_sharding((7, 6), ("ff", "embed")) == ()
    assert tpolicy.null_plan().param_sharding((8,), ("ff",)) is None


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


class _Sharding:
    """What the JAX package's ``NamedSharding`` would hold."""
    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, spec


def _jflat(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, _Sharding))[0]
    return {"".join(f"/{getattr(k, 'key', k)}" for k in path):
            _entries(leaf.spec) for path, leaf in flat}


@pytest.fixture
def jax_specs(monkeypatch):
    """The JAX package's sharding functions on a stand-in mesh."""
    monkeypatch.setattr(jsharding, "NamedSharding", _Sharding)
    return jsharding


def test_all_ten_configs_are_registered_in_both():
    assert tuple(ARCH_IDS) == tuple(J_ARCH_IDS) and len(ARCH_IDS) == 10


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", list(ARCH_IDS))
def test_shardings_equal_jax_leaf_for_leaf(jax_specs, arch, mesh_shape):
    mesh = FakeMesh(*mesh_shape)
    jmodel, model = jbuild(jget_config(arch)), build(get_config(arch))
    jplan = jpolicy.RegionPlan(mesh=mesh)
    plan = tpolicy.RegionPlan(mesh=mesh)
    # params and the AdamW moments (ZeRO-1 adds the data split)
    ps = _flat(tsharding.param_shardings(model, plan))
    assert ps == _jflat(jax_specs.param_shardings(jmodel, jplan))
    for zero1 in (True, False):
        os_ = _flat(tsharding.opt_state_shardings(model, plan, zero1))
        assert os_ == _jflat(jax_specs.opt_state_shardings(jmodel, jplan,
                                                           zero1))
    # serving caches: the slot cache, and the paged pool where there is one
    jc = jax_specs.cache_shardings(jplan, jmodel.cache_spec(8, 1024))
    assert _flat(tsharding.cache_shardings(plan, model.cache_spec(8, 1024))) \
        == _jflat(jc)
    if model.supports_paged:
        jp = jax_specs.cache_shardings(jplan,
                                       jmodel.paged_cache_spec(513, 16))
        pp = tsharding.cache_shardings(plan, model.paged_cache_spec(513, 16))
        assert _flat(pp) == _jflat(jp)
        assert set(_flat(pp).values()) <= {(None, None, "model"), ()}
    # batches
    shapes = {"tokens": (16, 512), "labels": (16, 512),
              "frames": (16, 3000, 128), "vision_embeds": (16, 256, 4096),
              "other": (16, 4)}
    jb = jax_specs.batch_shardings(jplan, {
        k: jax.ShapeDtypeStruct(v, np.float32) for k, v in shapes.items()})
    assert tsharding.batch_shardings(plan, shapes) == {
        k: _entries(v.spec) for k, v in jb.items()}
    assert tsharding.logits_sharding(plan, (16, 1, 100352)) == _entries(
        jax_specs.logits_sharding(jplan, (16, 1, 100352)).spec)


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_shards_reassemble_every_leaf(mesh_shape):
    """Every rank's shard of every reduced stablelm leaf (:func:`shard_leaf`
    at each mesh coordinate) has :func:`local_shape`, and the shards'
    blocks tile the full leaf exactly."""
    data, model_n = mesh_shape
    model = build(get_config("stablelm-1.6b").reduced())
    params = model.init(0, dtype=torch.float32, device="cpu")
    plan = tpolicy.RegionPlan(mesh=FakeMesh(data, model_n))
    specs = tsharding.param_shardings(model, plan)
    for leaf, spec in zip(L.tree_leaves(params), L.tree_leaves(specs)):
        out = torch.full_like(leaf, float("nan"))
        for d in range(data):
            for m in range(model_n):
                coords = {"data": d, "model": m}
                piece = tsharding.shard_leaf(leaf, spec, plan.mesh, coords)
                assert piece.is_contiguous()
                assert tuple(piece.shape) == tsharding.local_shape(
                    leaf.shape, spec, plan.mesh)
                tsharding.leaf_block(out, spec, plan.mesh,
                                     coords).copy_(piece)
        assert torch.equal(out, leaf)


def test_collectives_on_meta_note_the_ring_cost(monkeypatch):
    """On the meta device an all-reduce runs nothing and notes its bytes
    with the JAX package's ring rule; replicating vocab-sharded logits is
    one all-reduce of the full-vocab buffer, this rank's block in place."""
    mesh = FakeMesh(1, 4, coords={"model": 1})
    mesh.get_group = lambda axis: f"group:{axis}"
    calls = []
    monkeypatch.setattr(torch.distributed, "all_reduce",
                        lambda x, group: calls.append((x.shape, group)))

    def step(x, logits):
        comm.all_reduce(x, mesh)
        return comm.replicate_vocab(logits, 64, mesh)

    rc = counters.collect(step, torch.ones(8, 32),
                          torch.ones(2, 3, 16))
    ar = 8 * 32 * 4 + 2 * 3 * 64 * 4
    assert rc.collective_census == {"all-reduce": 2}
    assert rc.total.collective_bytes == ar
    assert rc.total.link_bytes == 2 * ar * 3 / 4
    assert rc.total.collective_ops == 2
    full = comm.replicate_vocab(torch.arange(4.0)[None], 16, mesh)
    assert full.shape == (1, 16)
    assert full[0, 4:8].tolist() == [0.0, 1.0, 2.0, 3.0]
    assert full.sum() == 6 and calls == [((1, 16), "group:model")]
    assert comm.replicate_vocab(torch.ones(2, 16), 16, mesh).shape == (2, 16)


@pytest.mark.parametrize("n,link", [(1, 0), (2, 100), (4, 150), (16, 187.5)])
def test_all_reduce_cost_is_the_jax_ring_rule(n, link):
    """An all-reduce's shard bytes are its input; its busiest ring link
    carries 2 (n-1)/n of it, as the JAX package's ``_collective_cost``."""
    assert counters.collective_cost("all-reduce", 100, n) == (100, link)
