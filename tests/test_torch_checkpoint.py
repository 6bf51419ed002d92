"""The port's checkpoints and data pipeline against the JAX package's.

The counterparts of ``tests/test_checkpoint.py``'s seven tests on the
port; checkpoints written by either package restored by the other bit for
bit (f32, and the port's bf16 through its f32 storage); ``batch_at`` equal
to the JAX package's byte for byte at several (step, n_hosts, host_id);
and the elastic helpers.
"""
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import batch_at as jbatch_at
from repro.optim import adamw as jadamw
from repro.train import checkpoint as jck
from repro_torch.data.pipeline import (DataConfig, Prefetcher, batch_at,
                                       iterate)
from repro_torch.models import layers as L
from repro_torch.optim import adamw
from repro_torch.train import checkpoint as ck
from repro_torch.train.elastic import StepWatchdog, reshard


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 8, generator=g),
                       "b": torch.zeros(8)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def test_roundtrip(tmp_path):
    state = _state()
    ck.save(str(tmp_path), 7, state, meta={"arch": "t"})
    restored, step = ck.restore(str(tmp_path), _state(1))
    assert step == 7
    assert torch.equal(restored["params"]["w"], state["params"]["w"])
    assert restored["opt"]["step"].dtype == torch.int32


def test_torn_write_detected(tmp_path):
    state = _state()
    ck.save(str(tmp_path), 1, state)
    ck.save(str(tmp_path), 2, state)
    path = tmp_path / "ckpt_00000002.npz"
    data = path.read_bytes()
    path.write_bytes(data[: len(data) // 2])
    step, manifest = ck.latest_valid(str(tmp_path))
    assert step == 1  # falls back to the older intact checkpoint


def test_gc_keeps_latest(tmp_path):
    state = _state()
    for s in range(1, 6):
        ck.save(str(tmp_path), s, state, keep=2)
    files = sorted(f for f in os.listdir(tmp_path) if f.endswith(".json"))
    assert files == ["ckpt_00000004.json", "ckpt_00000005.json"]


def test_no_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ck.restore(str(tmp_path), _state())


def test_data_pipeline_deterministic():
    cfg = DataConfig(vocab_size=1000, seq_len=16, global_batch=8, seed=3)
    a = batch_at(cfg, 5, "cpu")
    b = batch_at(cfg, 5, "cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert a["tokens"].dtype == torch.int64
    c = batch_at(cfg, 6, "cpu")
    assert not torch.equal(a["tokens"], c["tokens"])


def test_data_pipeline_host_slicing_is_elastic():
    """2-host split reproduces the 1-host batch exactly (elastic re-shard)."""
    whole = batch_at(DataConfig(1000, 16, 8, seed=1), 9, "cpu")["tokens"]
    h0 = batch_at(DataConfig(1000, 16, 8, seed=1, n_hosts=2, host_id=0), 9,
                  "cpu")["tokens"]
    h1 = batch_at(DataConfig(1000, 16, 8, seed=1, n_hosts=2, host_id=1), 9,
                  "cpu")["tokens"]
    assert torch.equal(whole, torch.cat([h0, h1], dim=0))


def test_labels_are_shifted_tokens():
    cfg = DataConfig(vocab_size=50, seq_len=12, global_batch=2, seed=0)
    b = batch_at(cfg, 0, "cpu")
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


@pytest.mark.parametrize("step,n_hosts,host_id", [
    (0, 1, 0), (5, 1, 0), (9, 2, 1), (123, 4, 2), (7, 4, 3)])
def test_batch_at_is_the_jax_packages_byte_for_byte(step, n_hosts, host_id):
    kw = dict(vocab_size=100352, seq_len=33, global_batch=8, seed=11,
              n_hosts=n_hosts, host_id=host_id)
    want = jbatch_at(JDataConfig(**kw), step)
    got = batch_at(DataConfig(**kw), step, "cpu")
    for k in ("tokens", "labels"):
        w = np.asarray(want[k])
        assert w.dtype == np.int32 and got[k].dtype == torch.int64
        assert got[k].numpy().astype(np.int32).tobytes() == w.tobytes()


def test_iterate_and_prefetcher_follow_batch_at():
    cfg = DataConfig(vocab_size=300, seq_len=8, global_batch=4, seed=2)
    pre = Prefetcher(iterate(cfg, 3, device="cpu"), device="cpu")
    for step in (3, 4, 5):
        b = next(pre)
        assert torch.equal(b["tokens"], batch_at(cfg, step, "cpu")["tokens"])


def _train_state_numpy(seed=0):
    """A train state with f32 params and moments and the int32 step, as
    numpy."""
    rng = np.random.default_rng(seed)
    params = {"blocks": {"w": rng.normal(size=(2, 6, 5)).astype(np.float32)},
              "embed": {"tokens": rng.normal(size=(9, 6)).astype(np.float32)},
              "final_norm": {"scale": rng.normal(size=(6,)).astype(
                  np.float32)}}
    mu = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                      params)
    nu = jax.tree.map(lambda a: rng.random(size=a.shape).astype(np.float32),
                      params)
    return {"params": params, "opt": {"step": np.int32(5), "mu": mu,
                                      "nu": nu}}


def _to_torch(tree, dtype=None):
    def leaf(a):
        t = torch.as_tensor(np.asarray(a))
        return t.to(dtype) if dtype is not None and t.is_floating_point() \
            else t
    return L.tree_map(leaf, tree)


def _jax_template(tree):
    return jax.tree.map(lambda a: jnp.zeros(np.shape(a), np.asarray(a).dtype),
                        tree)


def test_jax_written_checkpoint_restores_into_the_port(tmp_path):
    state = _train_state_numpy()
    jck.save(str(tmp_path), 5, jax.tree.map(jnp.asarray, state),
             meta={"arch": "t"})
    template = _to_torch(jax.tree.map(np.zeros_like, state))
    restored, step = ck.restore(str(tmp_path), template)
    assert step == 5
    assert ck.latest_valid(str(tmp_path))[0] == 5
    want = jax.tree.leaves(state)
    got = L.tree_leaves(restored)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.as_tensor(np.asarray(w)).dtype
        assert g.numpy().tobytes() == np.asarray(w).tobytes()


def test_port_written_checkpoint_restores_into_jax(tmp_path):
    state = _train_state_numpy(1)
    ck.save(str(tmp_path), 9, _to_torch(state), meta={"arch": "t"})
    assert jck.latest_valid(str(tmp_path))[0] == 9
    restored, step = jck.restore(str(tmp_path), _jax_template(state))
    assert step == 9
    for g, w in zip(jax.tree.leaves(restored), jax.tree.leaves(state)):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes()


def test_bf16_params_cross_the_format_exactly(tmp_path):
    """bf16 leaves are stored as f32 and cast back through the template,
    in both directions: the port's bf16 params into JAX's bf16 template,
    and back into the port's."""
    state = _train_state_numpy(2)
    bf = _to_torch(state["params"], torch.bfloat16)
    ck.save(str(tmp_path / "a"), 1, {"params": bf})
    jtemplate = {"params": jax.tree.map(
        lambda a: jnp.zeros(a.shape, jnp.bfloat16), state["params"])}
    jrestored, _ = jck.restore(str(tmp_path / "a"), jtemplate)
    for g, w in zip(jax.tree.leaves(jrestored), L.tree_leaves(bf)):
        assert g.dtype == jnp.bfloat16
        assert np.array_equal(np.asarray(g, np.float32), w.float().numpy())
    jck.save(str(tmp_path / "b"), 2, jrestored)
    restored, _ = ck.restore(str(tmp_path / "b"),
                             {"params": L.tree_map(torch.zeros_like, bf)})
    for g, w in zip(L.tree_leaves(restored), L.tree_leaves(bf)):
        assert g.dtype == torch.bfloat16 and torch.equal(g, w)


def test_optimizer_state_layout_matches_jax():
    """init_state's tree, dtypes and shapes are the JAX package's, which
    is what a checkpoint stores."""
    params = _train_state_numpy()["params"]
    jstate = jadamw.init_state(jax.tree.map(jnp.asarray, params))
    state = adamw.init_state(_to_torch(params))
    assert state["step"].dtype == torch.int32 and state["step"].shape == ()
    assert jck._flatten(jstate).keys() == ck._flatten(state).keys()
    for k, v in ck._flatten(state).items():
        w = jck._flatten(jstate)[k]
        assert v.dtype == w.dtype and v.shape == w.shape, k


def test_reshard_places_every_leaf():
    state = _to_torch(_train_state_numpy())
    moved = reshard(state, None, None, device="meta")
    assert all(t.device.type == "meta" for t in L.tree_leaves(moved))
    if not torch.cuda.is_available():   # cuda unless asked: no fallback
        with pytest.raises(RuntimeError, match="device='cpu'"):
            reshard(state)


def test_step_watchdog_flags_a_straggler():
    wd = StepWatchdog(window=50, threshold=3.0)
    times = [0.010 + 0.001 * (i % 3) for i in range(20)] + [0.5]
    for i, dt in enumerate(times):
        wd._t0 = time.perf_counter() - dt      # a step that took dt
        wd.stop(i)
    assert wd.flagged == [20]
