"""The port's BOTS-analog suite (``repro_torch.bots``) held against the JAX
package's (``repro.bots``) on the CPU, on the same numpy inputs.

Strassen, N Queens and SparseLU are deterministic and are compared value
for value.  Health and Floorplan draw from a PRNG that the port cannot
reproduce (the precedent of ``temperature > 0`` sampling in ROADMAP's
parity rules), so they are held to their invariants and, for Health, to
the JAX package's mean over seeds.  ``gpu`` tests run each deterministic
workload on the card against its CPU run and skip here.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from torch.utils._python_dispatch import TorchDispatchMode

from repro.bots import health as jhealth
from repro.bots import nqueens as jnqueens
from repro.bots import sparselu as jsparselu
from repro.bots import strassen as jstrassen
from repro.bots import suite as jsuite
from repro.core import counters as jcounters
from repro_torch.bots import floorplan, health, nqueens, sparselu, strassen
from repro_torch.bots import suite
from repro_torch.core import counters

CPU = "cpu"


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# Strassen
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("degree", [1, 7, 49])
def test_strassen_equals_jax_on_the_same_inputs(degree):
    jfn, (a, b) = jstrassen.build(n=64, depth=2, degree=degree)
    fn, _ = strassen.build(n=64, depth=2, degree=degree, device=CPU)
    ta, tb = torch.tensor(_np(a)), torch.tensor(_np(b))
    out = fn(ta, tb)
    np.testing.assert_allclose(out.numpy(), _np(jfn(a, b)),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(out.numpy(), strassen.reference(ta, tb),
                               rtol=1e-3, atol=1e-3)


def test_strassen_leaf_calls():
    """At degree 16 the 49 leaf pairs go in chunks of 3: 17 products."""
    fn, args = strassen.build(n=16, depth=2, degree=16, device=CPU)
    rc = counters.collect(fn, *args)
    leaf = 2 * 4 ** 3
    assert rc.total.flops >= 49 * leaf
    calls = []

    class Products(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.bmm.default, torch.ops.aten.mm.default):
                calls.append(args[0].shape[0])
            return func(*args, **(kwargs or {}))

    with Products():
        fn(*args)
    assert len(calls) == 17 and sum(calls) == 49


# ---------------------------------------------------------------------------
# N Queens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,prefix", [(6, 1), (7, 2), (8, 2), (8, 0)])
def test_expand_frontier_equals_jax(n, prefix):
    got = nqueens._expand_frontier(n, prefix)
    want = jnqueens._expand_frontier(n, prefix)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("n,prefix", [(6, 1), (7, 2), (8, 2)])
@pytest.mark.parametrize("degree", [1, 4])
def test_nqueens_batch_counts_equal_jax(n, prefix, degree):
    jfn, (jb,) = jnqueens.build(n=n, prefix=prefix, degree=degree)
    fn, (batches,) = nqueens.build(n=n, prefix=prefix, degree=degree,
                                   device=CPU)
    assert np.array_equal(batches.numpy(), _np(jb))
    want = _np(jax.vmap(functools.partial(
        jnqueens._count_kernel, n, n - prefix))(jb))
    lanes = nqueens.LockstepDFS(n, n - prefix)(batches.reshape(-1, 3))
    got = lanes.reshape(batches.shape[:2]).sum(1)
    assert got.tolist() == want.tolist()
    assert int(fn(batches)) == int(want.sum()) == nqueens.KNOWN[n]


@pytest.mark.parametrize("block", [1, 7, 64, 1000])
def test_nqueens_block_size_does_not_change_counts(block):
    """Steps past the last live lane are no-ops, so a block that does not
    divide the step count gives the same per-lane counts."""
    frontier = torch.from_numpy(nqueens._expand_frontier(9, 2))
    ref = nqueens.LockstepDFS(9, 7, block=1)(frontier)
    got = nqueens.LockstepDFS(9, 7, block=block)(frontier)
    assert torch.equal(got, ref) and int(got.sum()) == nqueens.KNOWN[9]


# ---------------------------------------------------------------------------
# SparseLU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nb,bs,band", [(4, 16, 2), (4, 16, 3), (6, 32, 2)])
def test_make_matrix_bit_for_bit(nb, bs, band):
    blocks, mask = sparselu.make_matrix(nb, bs, band)
    jblocks, jmask = jsparselu.make_matrix(nb, bs, band)
    assert np.array_equal(blocks.numpy(), _np(jblocks))
    assert np.array_equal(mask.numpy(), _np(jmask))
    assert torch.equal(sparselu.band_mask(nb, band, CPU), mask)


@pytest.mark.parametrize("band", [2, 3])
@pytest.mark.parametrize("degree", [1, 4])
def test_sparselu_equals_jax(band, degree):
    jfn, (jblocks,) = jsparselu.build(nb=4, bs=16, band=band, degree=degree)
    fn, (blocks,) = sparselu.build(nb=4, bs=16, band=band, degree=degree,
                                   device=CPU)
    before = blocks.clone()
    lu = fn(blocks)
    assert torch.equal(blocks, before)
    np.testing.assert_allclose(lu.numpy(), _np(jfn(jblocks)),
                               rtol=1e-5, atol=1e-5)
    mats, mask = sparselu.make_matrix(4, 16, band)
    assert sparselu.residual(mats, lu, mask) < 0.05
    ref, _ = sparselu.build(nb=4, bs=16, band=band, degree=1, device=CPU)
    np.testing.assert_allclose(lu.numpy(), ref(blocks).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_sparselu_residual_equals_jax():
    mats, mask = sparselu.make_matrix(4, 16, 3)
    fn, (blocks,) = sparselu.build(nb=4, bs=16, band=3, device=CPU)
    lu = fn(blocks)
    want = jsparselu.residual(jnp.asarray(mats.numpy()),
                              jnp.asarray(lu.numpy()), None)
    assert sparselu.residual(mats, lu, mask) == pytest.approx(want,
                                                              rel=1e-3)


# ---------------------------------------------------------------------------
# Health
# ---------------------------------------------------------------------------


def test_health_step_conserves_patients():
    """Per step and per village: arrivals = change of the queues + the
    newly treated, exactly; service within capacity, referrals within
    the served."""
    V = 512
    capacity = torch.tensor(health.CAPACITY, dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    q = torch.zeros((V, health.LEVELS), dtype=torch.int32)
    t = torch.zeros(V, dtype=torch.int32)
    referred = 0
    for _ in range(24):
        q2, t2, arrivals, service, refer = health.step(q, t, capacity, gen)
        assert torch.equal(arrivals, (q2 - q).sum(-1) + (t2 - t))
        assert bool((service <= capacity).all() and (service >= 0).all())
        assert bool((refer <= service[:, :-1]).all() and (refer >= 0).all())
        assert bool((q2 >= 0).all())
        referred += int(refer.sum())
        q, t = q2, t2
    assert referred > 0


def test_health_mean_treated_agrees_with_jax():
    """The PRNG streams differ, so only the distribution is compared.
    Measured before this bound was set (villages 1024, steps 32, degree 1,
    seeds 0-15 of each package): the port 96556.2 +- 245.5 (sd), JAX
    96338.3 +- 331.7, means 0.23% apart; over 4 seeds the sd of a mean is
    ~0.15%, well inside the 2% bound."""
    got, want = [], []
    jfn, _ = jhealth.build(villages=1024, steps=32)   # one compile
    for seed in range(4):
        fn, args = health.build(villages=1024, steps=32, seed=seed,
                                device=CPU)
        treated, peak = fn(*args)
        assert int(treated) > 0 and int(peak) >= 0
        assert torch.equal(fn(*args)[0], treated)
        got.append(int(treated))
        _, jargs = jhealth.build(villages=1024, steps=32, seed=seed)
        want.append(int(jfn(*jargs)[0]))
    assert abs(np.mean(got) - np.mean(want)) / np.mean(want) < 0.02


@pytest.mark.parametrize("degree", [1, 2, 8])
def test_health_runs_at_each_degree(degree):
    fn, args = health.build(villages=128, steps=8, degree=degree, device=CPU)
    treated, peak = fn(*args)
    assert 0 < int(treated) <= 128 * 8 * 10 and int(peak) >= 0


# ---------------------------------------------------------------------------
# Floorplan
# ---------------------------------------------------------------------------


def _place_cost_np(pos, cells):
    x0, y0 = pos[:, 0], pos[:, 1]
    x1, y1 = x0 + cells[:, 0], y0 + cells[:, 1]
    area = (x1.max() - x0.min()) * (y1.max() - y0.min())
    overlap = 0
    for i in range(len(cells)):
        for j in range(i + 1, len(cells)):
            ox = max(0, min(x1[i], x1[j]) - max(x0[i], x0[j]))
            oy = max(0, min(y1[i], y1[j]) - max(y0[i], y0[j]))
            overlap += ox * oy
    return area, overlap


@settings(deadline=None, max_examples=25)
@given(seed=st.integers(0, 2**31 - 1), n_cells=st.integers(2, 5))
def test_place_cost_equals_numpy(seed, n_cells):
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, floorplan.GRID - 1, (6, n_cells, 2), np.int32)
    cells = floorplan.CELLS[:n_cells]
    area, overlap = floorplan.place_cost(torch.from_numpy(pos),
                                         torch.from_numpy(cells))
    for b in range(6):
        assert (int(area[b]), int(overlap[b])) == _place_cost_np(pos[b],
                                                                 cells)


@pytest.mark.parametrize("degree", [1, 4, 16])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_floorplan_bound_sane(degree, seed):
    fn, args = floorplan.build(degree=degree, seed=seed, device=CPU)
    best = int(fn(*args))
    assert 12 <= best < floorplan.NO_FIT


def test_floorplan_draws_in_range():
    """randint's upper end is exclusive in both packages: corners 0..6."""
    fn, (best0, cells) = floorplan.build(degree=4, device=CPU)
    seen = []

    class Draws(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if "randint" in str(func):
                seen.append(out.clone())
            return out

    with Draws():
        fn(best0, cells)
    draws = torch.stack(seen)
    assert len(seen) == floorplan.SAMPLES // 4
    assert int(draws.min()) == 0 and int(draws.max()) == floorplan.GRID - 2


# ---------------------------------------------------------------------------
# every workload: arguments untouched, calls repeatable, counted on meta
# ---------------------------------------------------------------------------

TINY = {"strassen": dict(n=32, depth=2), "nqueens": dict(n=7, prefix=2),
        "sparselu": dict(nb=3, bs=8, band=1),
        "health": dict(villages=64, steps=4), "floorplan": {}}


def _leaves(out):
    return list(out) if isinstance(out, tuple) else [out]


@pytest.mark.parametrize("name", suite.WORKLOADS)
def test_fn_leaves_args_and_repeats(name):
    fn, args = suite.get_builder(name)(degree=4, device=CPU, **TINY[name])
    before = [a.clone() for a in args]
    outs = [fn(*args) for _ in range(4)]
    for a, b in zip(args, before):
        assert torch.equal(a, b)
    for out in outs[1:]:
        for x, y in zip(_leaves(out), _leaves(outs[0])):
            assert torch.equal(x, y)


class _MetaOnly(TorchDispatchMode):
    """Records every dispatched op that sees a tensor off the meta device."""

    def __init__(self):
        super().__init__()
        self.real = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in counters._tensors((args, kwargs or {}, out)):
            if t.device.type != "meta":
                self.real.append((str(func), t.device))
        return out


# port flops / JAX flops at the JAX package's `build()` default sizes,
# degree 1.
# The bound: within 25% for strassen and sparselu, a factor of 2 for the
# others.  Every workload meets it.  The JAX count takes every broadcast,
# slice, pad and concatenate of the compiled HLO as one flop an element,
# and the threefry PRNG and its samplers expand into elementwise ops; the
# port's count takes the views and broadcasts that correspond by the same
# rule and charges a draw what the JAX count charges the same draw
# (`counters.RANDOM_FLOPS`).  The ratios are pinned so that a change of
# either package's rules shows here.  SparseLU's dense LU masks a full
# block update at every step in JAX, where the port writes only the
# trailing submatrix: that work is not charged, and SparseLU sits near the
# lower end of its bound.
FLOPS_BOUND = {"strassen": 1.25, "sparselu": 1.25, "nqueens": 2.0,
               "health": 2.0, "floorplan": 2.0}
FLOPS_RATIO = {"strassen": 0.9222, "nqueens": 0.7299, "sparselu": 0.8255,
               "health": 0.8823, "floorplan": 0.8154}


@pytest.mark.parametrize("name", suite.WORKLOADS)
def test_collect_counts_on_meta_against_jax(name):
    fn, args = suite.get_builder(name)(degree=1, device=CPU)
    margs = counters.to_meta(args)
    mode = _MetaOnly()
    with mode:
        rc = counters.collect(fn, *margs)
    assert mode.real == []
    c = rc.total
    assert c.flops > 0 and c.bytes > 0 and c.ops > 0
    jfn, jargs = importlib.import_module(f"repro.bots.{name}").build(degree=1)
    jc = jcounters.collect(jax.jit(jfn).lower(*jargs).compile()).total
    ratio = c.flops / jc.flops
    bound = FLOPS_BOUND[name]
    assert 1 / bound <= ratio <= bound, ratio
    assert ratio == pytest.approx(FLOPS_RATIO[name], rel=0.02)


def _jax_flops(f, *args):
    return jcounters.collect(jax.jit(f).lower(*args).compile()).total.flops


_DRAW_N = 4096
#: a draw of _DRAW_N elements in each package (the JAX one from a key)
_DRAWS = {
    "rand": (lambda k: jax.random.uniform(k, (_DRAW_N,)),
             lambda: torch.rand(_DRAW_N, device="meta")),
    "randint": (lambda k: jax.random.randint(k, (_DRAW_N,), 0, 7),
                lambda: torch.randint(0, 7, (_DRAW_N,), dtype=torch.int32,
                                      device="meta")),
    "poisson": (lambda k: jax.random.poisson(k, 3.0, (_DRAW_N,)),
                lambda: torch.poisson(torch.full((_DRAW_N,), 3.0,
                                                 device="meta"))),
    # aten::binomial has no meta kernel: its constant is held alone.  The
    # trial counts are an argument, as health's are (a constant count is
    # folded by XLA)
    "binomial": (lambda k, n: jax.random.binomial(k, n, 0.25), None),
}


@pytest.mark.parametrize("name", sorted(_DRAWS))
def test_random_draw_charge_is_the_jax_count_of_the_draw(name):
    """Each per-element charge of ``counters.RANDOM_FLOPS`` within 1% of
    the JAX count of the same draw alone, per element; and the port's
    count of the draw is that charge an element (the fill of poisson's
    rate counted apart)."""
    jf, tf = _DRAWS[name]
    args = [jax.random.PRNGKey(0)]
    if name == "binomial":
        args.append(jnp.ones((_DRAW_N,), jnp.float32))
    per = _jax_flops(jf, *args) / _DRAW_N
    assert counters.RANDOM_FLOPS[name] == pytest.approx(per, rel=0.01)
    if tf is not None:
        fill = _DRAW_N if name == "poisson" else 0
        assert counters.collect(tf).total.flops == \
            counters.RANDOM_FLOPS[name] * _DRAW_N + fill


#: data movement: (JAX function, port function, input shapes); each
#: counts the same flops in both packages
_MOVES = {
    "slice": (lambda x: x[2:10], lambda x: x[2:10], [(16, 64)]),
    "select": (lambda x: x[3], lambda x: x[3], [(16, 64)]),
    "broadcast": (lambda x: jnp.broadcast_to(x, (8, 64)),
                  lambda x: x.expand(8, 64), [(64,)]),
    "pointwise_broadcast": (lambda a, b: a + b, lambda a, b: a + b,
                            [(8, 64), (64,)]),
    "pad": (lambda x: jnp.pad(x, ((0, 0), (1, 0))),
            lambda x: torch.nn.functional.pad(x, (1, 0)), [(8, 64)]),
    "concatenate": (lambda a, b: jnp.concatenate([a, b]),
                    lambda a, b: torch.cat([a, b]), [(8, 64), (4, 64)]),
}


@pytest.mark.parametrize("name", sorted(_MOVES))
def test_data_movement_counts_as_the_jax_census(name):
    """A broadcast, slice, pad or concatenate alone: the port's flops equal
    the JAX count of the same op (one an element)."""
    jf, tf, shapes = _MOVES[name]
    want = _jax_flops(jf, *(jnp.ones(s, jnp.float32) for s in shapes))
    got = counters.collect(tf, *(torch.ones(s) for s in shapes))
    assert want > 0 and got.total.flops == want


# ---------------------------------------------------------------------------
# the suite: rows, corpus, tree
# ---------------------------------------------------------------------------


def test_time_workload_rows_match_jax():
    for name, size in (("nqueens", dict(n=8, prefix=2)),
                       ("health", dict(villages=128, steps=4))):
        row = suite.time_workload(name, 4, 2, device=CPU, **size)
        jrow = jsuite.time_workload(name, 4, 2, **size)
        assert sorted(row) == sorted(jrow)
        assert row["workload"] == name and row["degree"] == 4
        assert row["wall_s"] > 0 and row["counters"].flops > 0
        if name == "nqueens":
            assert row["result"] == jrow["result"] == 92
        else:
            assert isinstance(row["result"], tuple) and len(row["result"]) == 2
    row = suite.time_workload("sparselu", 1, 1, device=CPU, nb=2, bs=4)
    assert row["result"] is None


def _rows(Counters, seed=0):
    rng = np.random.default_rng(seed)
    rows = []
    for w in suite.WORKLOADS:
        base = dict(flops=float(10 ** rng.uniform(3, 9)),
                    bytes=float(10 ** rng.uniform(3, 9)),
                    ops=int(rng.integers(10, 5000)))
        for d in suite.DEGREES:
            rows.append({"workload": w, "degree": d,
                         "wall_s": float(rng.uniform(0.001, 1.0)),
                         "counters": Counters(**base), "result": None})
    rows.append({"workload": "strassen", "degree": 32, "error": "boom"})
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_corpus_and_tree_equal_jax(seed):
    rows = _rows(counters.Counters, seed)
    jrows = _rows(jcounters.Counters, seed)
    X, y = suite.training_corpus(rows)
    jX, jy = jsuite.training_corpus(jrows)
    assert np.array_equal(X, jX) and y == jy
    tree, jtree = suite.train_tree(rows), jsuite.train_tree(jrows)
    probe = np.concatenate([X, X * 1.5 + 0.1])
    assert tree.predict(probe) == jtree.predict(probe)
    assert tree.to_json() == jtree.to_json()


def test_train_tree_needs_two_workloads():
    rows = [r for r in _rows(counters.Counters) if r["workload"] == "health"]
    assert suite.train_tree(rows) is None


def test_sweep_records_errors():
    rows = suite.sweep(workloads=("nosuch",), degrees=(1,), verbose=False)
    assert rows[0]["workload"] == "nosuch" and "error" in rows[0]


def test_build_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for name in suite.WORKLOADS:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            suite.get_builder(name)(degree=1, **TINY[name])


# ---------------------------------------------------------------------------
# on the card (skip here)
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("degree", [1, 16])
def test_gpu_strassen_matches_cpu(degree):
    dev = _cuda()
    fn, args = strassen.build(n=512, depth=2, degree=degree, device=CPU)
    want = fn(*args)
    got = fn(*(a.to(dev) for a in args)).cpu()
    np.testing.assert_allclose(got.numpy(), want.numpy(),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("degree", [1, 16])
def test_gpu_nqueens_matches_cpu(degree):
    """The CUDA-graph path: capture at the first call, replay after."""
    dev = _cuda()
    fn, args = nqueens.build(n=10, prefix=3, degree=degree, device=dev)
    cfn, cargs = nqueens.build(n=10, prefix=3, degree=degree, device=CPU)
    assert int(fn(*args)) == int(fn(*args)) == int(cfn(*cargs)) == 724
    frontier = torch.from_numpy(nqueens._expand_frontier(9, 2))
    got = nqueens.LockstepDFS(9, 7, block=7)(frontier.to(dev))
    assert torch.equal(got.cpu(), nqueens.LockstepDFS(9, 7)(frontier))


@pytest.mark.gpu
@pytest.mark.parametrize("degree", [1, 4])
def test_gpu_sparselu_matches_cpu(degree):
    dev = _cuda()
    fn, (blocks,) = sparselu.build(nb=8, bs=32, band=3, degree=degree,
                                   device=dev)
    cfn, (cblocks,) = sparselu.build(nb=8, bs=32, band=3, degree=degree,
                                     device=CPU)
    want = cfn(cblocks)
    got = fn(blocks).cpu()
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * scale)


@pytest.mark.gpu
def test_gpu_time_workload_rows():
    _cuda()
    for name, size in (("nqueens", dict(n=8, prefix=2)),
                       ("health", dict(villages=1024, steps=4)),
                       ("floorplan", {})):
        row = suite.time_workload(name, 4, 2, **size)
        assert row["wall_s"] > 0 and row["device_s"] > 0
        assert row["counters"].flops > 0
