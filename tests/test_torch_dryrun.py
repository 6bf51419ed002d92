"""The port's dry-run (``repro_torch.launch.dryrun``), report and
hillclimb, against the JAX package's dry-run on reduced stablelm-1.6b.

A JAX child imports ``repro.launch.dryrun`` (which forces 512 host
devices) with ``get_config``/``get_shape`` patched to the reduced config
and small shapes, and lowers and compiles with ``build_lowered``: train,
prefill and decode on a ``("data", "model")`` 2x2 mesh of the first 4
devices, and train on the 16x16 production mesh — four compiles.  The
port counts the same cells with ``run_cell`` over a fake world of 4 and
of 256 ranks.  Per cell: the rank's argument bytes equal XLA's
``argument_size_in_bytes`` exactly; the census flops within 25%; the
collective shard bytes and the peak (argument + temp) bytes at the
ratios measured here, pinned with 2% (``RATIO``), since the two count
different programs: GSPMD's own collectives (no reduce-scatter; ZeRO-1
as all-reduces and all-gathers) and XLA's buffer assignment against the
port's explicit collectives and its eager live bytes.

The decode cell's total flops are pinned, not banded: XLA:CPU's program
upcasts the bf16 cache to f32 and transposes it for every layer's
products, and GSPMD writes the new row into the ``kv_seq``-split cache by
a select over the whole shard — some 15 elementwise ops an element of
the cache a layer, where the port writes the one row and reads the cache
through the products.  Its MLP and logits regions hold the 25% band.
"""
import json
import os
import subprocess
import sys
import types

import pytest

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_config, get_shape
from repro_torch.core import roofline
from repro_torch.core.policy import default_plan
from repro_torch.distributed import sharding as shard_mod
from repro_torch.launch import dryrun, hillclimb, report
from repro_torch.models.model import build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "stablelm-1.6b"
#: cell -> (kind, seq, batch, mesh dims)
CELLS = {"train_2x2": ("train", 64, 8, (2, 2)),
         "prefill_2x2": ("prefill", 32, 8, (2, 2)),
         "decode_2x2": ("decode", 64, 8, (2, 2)),
         "train_16x16": ("train", 64, 32, (16, 16))}
#: port / JAX at each cell: collective shard bytes, peak bytes; and the
#: decode cell's flops (below)
RATIO = {"train_2x2": {"collective": 0.2888, "peak": 0.6961},
         "prefill_2x2": {"collective": 0.5000, "peak": 0.7890},
         "decode_2x2": {"collective": 0.5238, "peak": 0.4117,
                        "flops": 0.4087},
         "train_16x16": {"collective": 0.3188, "peak": 0.7244}}

_JAX_CHILD = r"""
import json, sys
import numpy as np
from repro.launch import dryrun as jd      # forces 512 host devices
import jax
from jax.sharding import Mesh
from repro.configs.base import ShapeConfig
from repro.core import counters
from repro.launch.mesh import make_production_mesh

cells = json.loads(sys.argv[1])
real = jd.get_config
jd.get_config = lambda a: real(a).reduced()
jd.get_shape = lambda s: ShapeConfig(s, cells[s][1], cells[s][2], cells[s][0])
out = {"n_devices": len(jax.devices())}
for name, (kind, seq, batch, dims) in cells.items():
    if tuple(dims) == (16, 16):
        mesh = make_production_mesh(multi_pod=False)
    else:
        mesh = Mesh(np.array(jax.devices()[:4]).reshape(dims),
                    ("data", "model"))
    lowered, _ = jd.build_lowered(sys.argv[2], name, mesh)
    compiled = lowered.compile()
    ma = compiled.memory_analysis()
    rc = counters.collect(compiled)
    out[name] = {
        "argument": int(ma.argument_size_in_bytes),
        "temp": int(ma.temp_size_in_bytes),
        "flops": rc.total.flops, "bytes": rc.total.bytes,
        "collective": rc.total.collective_bytes,
        "census": dict(rc.collective_census),
        "regions": {r: c.flops for r, c in rc.regions.items()}}
print("DRJSON " + json.dumps(out))
"""


def _shape(name):
    kind, seq, batch, _ = CELLS[name]
    return ShapeConfig(name, seq, batch, kind)


@pytest.fixture(scope="module")
def jax_cells():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env.setdefault("JAX_PLATFORMS", "cpu")
    res = subprocess.run([sys.executable, "-c", _JAX_CHILD,
                          json.dumps(CELLS), ARCH], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-6000:]
    line = [ln for ln in res.stdout.splitlines()
            if ln.startswith("DRJSON ")][-1]
    return json.loads(line[len("DRJSON "):])


@pytest.fixture(scope="module")
def port_cells():
    mp = pytest.MonkeyPatch()
    mp.setattr(dryrun, "get_config", lambda a: get_config(a).reduced())
    try:
        out = {}
        for name in CELLS:
            row = dryrun.run_cell(ARCH, _shape(name), False, verbose=False,
                                  microbatch=0, mesh_dims=CELLS[name][3])
            rc = dryrun.count_cell(ARCH, _shape(name), microbatch=0,
                                   mesh_dims=CELLS[name][3])[0]
            out[name] = (row, rc)
        return out
    finally:
        mp.undo()


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_against_jax(jax_cells, port_cells, name):
    j, (p, rc) = jax_cells[name], port_cells[name]
    assert jax_cells["n_devices"] == 512
    mem = p["memory"]
    ratio = {"collective": (p["census_collective_bytes_per_dev"]
                            / max(j["collective"], 1)),
             "peak": mem["peak_bytes_per_device"] / (j["argument"]
                                                     + j["temp"]),
             "flops": p["census_flops_per_dev"] / j["flops"]}
    print(f"\n[dryrun] {name}: argument {mem['argument_size_in_bytes']} "
          f"(JAX {j['argument']}), flops {p['census_flops_per_dev']:.4e} "
          f"(JAX {j['flops']:.4e}), ratios "
          f"{ {k: round(v, 4) for k, v in ratio.items()} }, "
          f"census {p['collective_census']} (JAX {j['census']})")
    assert p["ok"] and p["mesh"] == "x".join(map(str, CELLS[name][3]))
    assert p["chips"] == CELLS[name][3][0] * CELLS[name][3][1]
    assert mem["argument_size_in_bytes"] == j["argument"]
    assert mem["peak_bytes_per_device"] == rc.peak_bytes
    assert mem["temp_size_in_bytes"] == rc.peak_bytes - rc.argument_bytes
    for key, want in RATIO[name].items():
        assert want is not None, (key, ratio[key])
        assert ratio[key] == pytest.approx(want, rel=0.02), (key, ratio)
    if "flops" in RATIO[name]:
        regions = [r for r in j["regions"] if "mlp" in r or r == "logits"]
        assert len(regions) == 3
        for r in regions:
            got = rc.regions[r].flops
            assert abs(got - j["regions"][r]) <= 0.25 * j["regions"][r], r
    else:
        assert abs(ratio["flops"] - 1) <= 0.25, ratio


def test_train_cell_census(port_cells):
    """ZeRO-1 over data: one reduce-scatter and one all-gather a param
    leaf (15 in reduced stablelm-1.6b: every leaf has a dim 2 and 16
    divide), nothing of the kind at prefill and decode."""
    for name in ("train_2x2", "train_16x16"):
        census = port_cells[name][0]["collective_census"]
        assert census["reduce-scatter"] == census["all-gather"] == 15
    for name in ("prefill_2x2", "decode_2x2"):
        assert set(port_cells[name][0]["collective_census"]) == {
            "all-reduce"}


def test_production_mesh_cells_and_the_cli(tmp_path, monkeypatch):
    """``main`` over both production meshes at reduced widths: a row for
    each stablelm shape on 16x16 and 2x16x16 (long_500k skipped: full
    attention); qwen2-moe-a2.7b's decode_32k cell at full width ``ok``,
    4 of its 64 experts a rank, its census with two all-gathers a layer
    (the router's columns, and the per-expert counts of the one 128-token
    group across the 16 data ranks); a cell whose step fails to build
    (``build_step`` made to raise) recorded ``ok: false`` with its error;
    the done cells skipped on a second run; then ``report.py``'s three
    tables and ``hillclimb``'s diagnosis from the rows."""
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: get_config(a).reduced())
    monkeypatch.setattr(dryrun, "get_shape", lambda s: _small(s))
    out = tmp_path / "dryrun_torch.jsonl"
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", ARCH, "--mesh", "both", "--out", str(out)])
    assert e.value.code == 0
    rows = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert {(r["shape"], r["mesh"]) for r in rows} == {
        (s, m) for s in ("train_4k", "prefill_32k", "decode_32k")
        for m in ("16x16", "2x16x16")}
    assert all(r["ok"] for r in rows)
    assert {r["chips"] for r in rows} == {256, 512}
    moe = "qwen2-moe-a2.7b"
    with monkeypatch.context() as m:
        m.setattr(dryrun, "get_config", get_config)
        m.setattr(dryrun, "get_shape", get_shape)
        with pytest.raises(SystemExit) as e:
            dryrun.main(["--arch", moe, "--shape", "decode_32k", "--mesh",
                         "single", "--out", str(out)])
    assert e.value.code == 0
    row = json.loads(out.read_text().splitlines()[-1])
    cfg = get_config(moe)
    assert row["ok"] and (row["arch"], row["mesh"]) == (moe, "16x16")
    assert row["collective_census"]["all-gather"] == 2 * cfg.n_layers
    mesh = types.SimpleNamespace(shape={"data": 16, "model": 16})
    gate = shard_mod.param_shardings(
        build(cfg), default_plan(mesh, "decode"))["blocks"]["mlp"]["gate"]
    assert shard_mod.local_shape((cfg.n_layers, 64, 1, 1), gate,
                                 mesh)[1] == 4

    def broken(*a, **k):
        raise RuntimeError("the step failed to build")
    with monkeypatch.context() as m:
        m.setattr(dryrun, "build_step", broken)
        with pytest.raises(SystemExit) as e:
            dryrun.main(["--arch", "granite-moe-1b-a400m", "--shape",
                         "decode_32k", "--mesh", "single", "--out",
                         str(out)])
    assert e.value.code == 1
    bad = json.loads(out.read_text().splitlines()[-1])
    assert not bad["ok"] and "the step failed to build" in bad["error"]
    assert dryrun._done_cells(str(out)) >= {
        (ARCH, "train_4k", "2x16x16", "baseline")}

    rows = report.load(str(out))
    summary = report.dryrun_summary(rows)
    assert "counted cells: 7" in summary and "failures: 1" in summary
    assert "cells fitting 80 GB/card (H100 SXM): 7/7" in summary
    assert "94 GB" in report.dryrun_summary(rows, roofline.H100_NVL)
    table = report.roofline_table(rows, "2x16x16")
    assert table.count(f"| {ARCH} |") == 3
    assert "worst roofline fraction" in report.pick_hillclimb(rows)


def test_hillclimb_lists_the_largest_collectives(monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: get_config(a).reduced())
    monkeypatch.setattr(dryrun, "get_shape", lambda s: _small(s))
    rc, rl = hillclimb.diagnose(ARCH, "train_4k")
    top = hillclimb.largest_collectives(rc, 5)
    assert len(top) == 5
    assert [t[0] for t in top] == sorted((t[0] for t in top), reverse=True)
    assert {t[1] for t in top} <= {"all-reduce", "reduce-scatter",
                                   "all-gather"}
    out = capsys.readouterr().out
    assert "largest single collectives" in out and "groups= 16" in out


def _small(name):
    """The production shapes cut to reduced sizes (batches the 16x16 and
    2x16x16 meshes' data axes divide)."""
    return {"train_4k": ShapeConfig("train_4k", 32, 32, "train"),
            "prefill_32k": ShapeConfig("prefill_32k", 32, 32, "prefill"),
            "decode_32k": ShapeConfig("decode_32k", 64, 32, "decode"),
            "long_500k": ShapeConfig("long_500k", 128, 1, "decode")}[name]
