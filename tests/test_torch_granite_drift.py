"""Where granite's f32 drift between tp 2 and tp 1 starts: layer 0 of
full-width ``granite-moe-1b-a400m`` op by op (``_torch_granite_drift.py``,
two gloo ranks on the CPU, or on one card), at ``Model.init``'s scale and
at each matrix's fan-in.

On the CPU the two ranks' q, k and v round as one rank's, and the first
gap is the ``wo`` all-reduce's (a sum in another order): every op stands
within twice the largest f32 rounding of the ops up to it.  What makes
``Model.init``'s drift wider is the softmax: its scores reach ~230 there
(~5 at the fan-in), so a one-ulp change of q or k moves the MoE input
~40 times as far (~4 times at the fan-in); v's and ``wo``'s
amplification do not depend on the draw.

On the card the half-width q, k and v products of tp 2 round apart from
tp 1's, by about their own rounding, and the softmax carries that to the
MoE input: at ``Model.init``'s scale several times as far as at the
fan-in (``test_on_the_card_q_k_v_round_apart_and_the_softmax_amplifies``,
marked ``gpu``).
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
CHAIN = ("x", "h1", "q", "k", "v", "scores", "probs", "attn", "wo_partial",
         "wo", "residual", "moe_in")
ROUNDING_FACTOR = 2.0       # an op's gap over the chain's largest rounding
SOFTMAX_FACTOR = 5.0        # q, k's amplification at init over fan-in's
# on the card: the MoE input's gap over the first-order sum of q's, k's
# and v's gaps times their amplification (the wo all-reduce and second
# order take the rest), and init's MoE-input gap over the fan-in's
FIRST_ORDER_FACTOR = 2.0
INIT_OVER_FAN_IN = 4.0


def _report(tmp_path, device: str) -> dict:
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_granite_drift.py"),
         str(tmp_path), device], cwd=ROOT, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.splitlines()[-1])


def _gaps_at_rounding(ops: dict, upto: str, draw: str) -> None:
    """Every op's gap up to ``upto`` within ROUNDING_FACTOR of the largest
    own rounding of the ops up to it."""
    worst = 0.0
    for op in CHAIN[:CHAIN.index(upto) + 1]:
        worst = max(worst, ops[op]["own"])
        if "gap" in ops[op]:
            assert ops[op]["gap"] <= ROUNDING_FACTOR * worst, (
                draw, op, ops[op], worst)


def test_layer0_gaps_stand_at_rounding_and_the_softmax_amplifies(tmp_path):
    report = _report(tmp_path, "cpu")
    for draw, got in report.items():
        ops = got["ops"]
        _gaps_at_rounding(ops, "moe_in", draw)
        assert ops["wo"]["gap"] > 0      # the all-reduce sums in its order
    init, fan_in = (report[d]["amplification"] for d in ("init", "fan_in"))
    for op in ("q", "k"):
        assert init[op] >= SOFTMAX_FACTOR * fan_in[op], (op, init, fan_in)
    for op in ("v", "wo"):
        assert init[op] <= 2 * fan_in[op] and fan_in[op] <= 2 * init[op], (
            op, init, fan_in)
    assert (report["init"]["ops"]["scores"]["max"]
            >= 10 * report["fan_in"]["ops"]["scores"]["max"])


@pytest.mark.gpu
def test_on_the_card_q_k_v_round_apart_and_the_softmax_amplifies(tmp_path):
    """On the card q, k, v and the scores of tp 2 stand at rounding, but
    not at 0: the half-width products round apart from tp 1's.  The MoE
    input's gap is what those gaps give through the softmax (within
    FIRST_ORDER_FACTOR of the sum of gap times amplification), and at
    ``Model.init``'s scale it is INIT_OVER_FAN_IN times the fan-in's or
    more."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    report = _report(tmp_path, "cuda")
    for draw, got in report.items():
        ops, amp = got["ops"], got["amplification"]
        _gaps_at_rounding(ops, "scores", draw)
        assert max(ops[op]["gap"] for op in ("q", "k", "v")) > 0, draw
        first_order = sum(amp[op] * ops[op]["gap"] for op in ("q", "k", "v"))
        assert ops["moe_in"]["gap"] <= FIRST_ORDER_FACTOR * first_order, (
            draw, ops["moe_in"], first_order)
    assert (report["init"]["ops"]["moe_in"]["gap"] >= INIT_OVER_FAN_IN
            * report["fan_in"]["ops"]["moe_in"]["gap"])
