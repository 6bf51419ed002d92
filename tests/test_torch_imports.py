"""The port stands alone: it imports neither ``jax`` nor the JAX package
(nor do its examples, ``examples/*_torch.py``), and its entry points
refuse to fall back to the CPU unasked."""
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None           # any `import jax` now raises
import torch
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for m in ("repro_torch.serve.graphs", "repro_torch.optim.adamw",
          "repro_torch.optim.schedule", "repro_torch.data.pipeline",
          "repro_torch.train.checkpoint", "repro_torch.train.elastic",
          "repro_torch.train.trainer", "repro_torch.launch.train",
          "repro_torch.models.moe", "repro_torch.models.whisper",
          "repro_torch.serve.telemetry", "repro_torch.serve.tp",
          "repro_torch.launch.mesh", "repro_torch.distributed.sharding",
          "repro_torch.distributed.comm", "repro_torch.launch.dryrun",
          "repro_torch.launch.report", "repro_torch.launch.hillclimb"):
    assert m in mods, (m, mods)
for m in mods:
    importlib.import_module(m)
import importlib.util, pathlib
examples = sorted(pathlib.Path("examples").glob("*_torch.py"))
assert len(examples) == 4, examples
for path in examples:
    spec = importlib.util.spec_from_file_location(path.stem, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not bad, bad
print(len(mods))
if not torch.cuda.is_available():
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import build
    from repro_torch.launch.train import main as train_main
    from repro_torch.serve.engine import Engine
    model = build(get_config("stablelm-1.6b").reduced())
    params = model.init(0, device="cpu")
    for call in (lambda: Engine(model, params), lambda: model.init(0),
                 lambda: train_main(["--steps", "1"]),
                 lambda: train_main(["--steps", "1", "--ranks", "2"])):
        try:
            call()
        except RuntimeError as e:
            assert "device='cpu'" in str(e), e
        else:
            raise AssertionError("ran on the CPU without being asked")
print("ok")
"""


def test_every_module_imports_without_jax_or_repro():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                          env=dict(os.environ,
                                   PYTHONPATH=str(ROOT / "src")),
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    n_mods, ok = proc.stdout.split()
    assert ok == "ok" and int(n_mods) >= 50


def test_sources_hold_no_forbidden_call():
    """No jax, no JAX-package import, no library attention kernel, no
    torch.compile, in the port, its examples or chip_smoke.py."""
    pat = re.compile(r"^\s*(import jax|from jax|import repro\b(?!_torch)"
                     r"|from repro[. ](?!_torch))"
                     r"|scaled_dot_product_attention|torch\.compile",
                     re.M)
    files = (sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "examples").glob("*_torch.py")))
    for f in files:
        text = f.read_text()
        assert not pat.search(text), f"{f}: {pat.search(text).group(0)}"
