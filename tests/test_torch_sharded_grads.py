"""``sharded_grads.py`` on the CPU at reduced widths: step 0's gradient of
the sharded trainer on (data 1, model 2) against one rank's, leaf by
leaf, as the script prints it (its last line, one JSON object)."""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("arch,extra", [("rwkv6-3b", []),
                                        ("whisper-large-v3", ["--fan-in"]),
                                        ("granite-moe-1b-a400m", [])])
def test_sharded_gradient_equals_one_ranks_leaf_by_leaf(tmp_path, arch,
                                                         extra):
    """Both ranks report the same; the two-rank loss and aux loss (granite's
    experts split over ``model``; 0 for the others) within 1e-5 of one
    rank's and every leaf's norm within 1e-4 of one rank's (f32), the
    leaves listed worst first."""
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "sharded_grads.py"), "--reduced",
         "--device", "cpu", "--arch", arch, "--batch", "2", "--seq", "16",
         *extra], env=env, cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.splitlines()[-1])
    assert got["same_on_every_rank"] and got["mesh"] == [1, 2]
    for key in ("loss", "aux"):
        one = got[key]["one"]
        assert all(abs(t - one) <= 1e-5 * abs(one) for t in got[key]["two"])
    ratios = [r["ratio"] for r in got["leaves"]]
    assert len(ratios) > 10
    assert abs(ratios[0] - 1) <= 1e-4, got["leaves"][:3]
    assert all(abs(r - 1) <= abs(ratios[0] - 1) for r in ratios)
