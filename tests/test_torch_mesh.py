"""The port's meshes (``repro_torch.launch.mesh``) over fake process
groups: ``make_host_mesh``'s shape resolution (the tensor-parallel
``model`` degree first, ``data`` fitting into what remains) against the
JAX package's on the same device counts — the three cases of
``tests/test_mesh.py`` — and the production meshes over 256 and 512
ranks.

A fake world is ``torch.distributed``'s ``fake`` backend over a
``FakeStore``: one process plays rank 0 of a world of any size, and
``init_device_mesh`` builds its groups without any communication.
"""
import contextlib

import jax
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.launch import mesh as jmesh
from repro_torch.launch import mesh as tmesh

REQUESTS = [(1, 1), (1, 2), (2, 2), (1, 4), (2, 4), (3, 2), (4, 2), (1, 8),
            (8, 8)]


@contextlib.contextmanager
def fake_world(n: int):
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def port_shapes(n: int) -> dict:
    with fake_world(n):
        out = {}
        for data, model in REQUESTS:
            m = tmesh.make_host_mesh(data, model)
            assert m.mesh_dim_names == ("data", "model")
            out[(data, model)] = tuple(m.shape)
        return out


def jax_shapes(monkeypatch, n: int) -> dict:
    """The JAX package's resolution with ``n`` devices: its
    ``make_host_mesh`` reads only ``len(jax.devices())`` and hands the
    shape to ``jax.make_mesh``."""
    monkeypatch.setattr(jax, "devices", lambda: [None] * n)
    monkeypatch.setattr(jax, "make_mesh",
                        lambda shape, names, **kw: shape)
    return {dm: tuple(jmesh.make_host_mesh(*dm)) for dm in REQUESTS}


def test_host_mesh_single_rank_clamps_everything_to_one(monkeypatch):
    got = port_shapes(1)
    assert set(got.values()) == {(1, 1)}
    assert got == jax_shapes(monkeypatch, 1)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_host_mesh_honors_model_degree_as_jax(monkeypatch, n):
    """Every request resolves as the JAX package resolves it on ``n``
    devices; the tp degrees the ranks can satisfy are granted verbatim."""
    got = port_shapes(n)
    assert got == jax_shapes(monkeypatch, n)
    assert got[(1, 2)] == (1, 2)
    assert got[(1, 8)] == (1, min(8, n))


def test_host_mesh_model_first_on_two_ranks():
    """The regression case of tests/test_mesh.py: (2, 2) on 2 ranks must
    give model=2, not data=2."""
    got = port_shapes(2)
    assert got[(2, 2)] == (1, 2)
    assert got[(4, 2)] == (1, 2)


def test_host_mesh_on_eight_ranks_fits_data_into_the_rest():
    got = port_shapes(8)
    assert got[(3, 2)] == (3, 2)
    assert got[(2, 4)] == (2, 4)
    assert got[(8, 8)] == (1, 8)


@pytest.mark.parametrize("multi_pod,world,shape,names", [
    (False, 256, (16, 16), ("data", "model")),
    (True, 512, (2, 16, 16), ("pod", "data", "model"))])
def test_production_mesh_shape_and_axes(multi_pod, world, shape, names):
    with fake_world(world):
        m = tmesh.make_production_mesh(multi_pod=multi_pod)
        assert tuple(m.shape) == shape and m.mesh_dim_names == names
        assert m.get_group("model").size() == 16


def test_importing_mesh_touches_no_process_group():
    import importlib
    importlib.reload(tmesh)
    assert not dist.is_initialized()


@pytest.mark.parametrize("device,world,cards,want", [
    ("cpu", 2, 0, "gloo"), ("cuda", 2, 1, "gloo"), ("cuda", 2, 2, "nccl"),
    ("cuda", 1, 1, "nccl"), ("cuda", 4, 2, "gloo")])
def test_backend_rule(monkeypatch, device, world, cards, want):
    """NCCL where each rank has a card of its own, gloo where ranks share
    a device."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert tmesh.backend_for(torch.device(device), world) == want
    dev = tmesh.rank_device(torch.device(device), 1, want)
    assert dev == (torch.device("cuda", 1) if want == "nccl"
                   else torch.device(device))
