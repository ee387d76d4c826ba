"""On the card: a short run of each cell prints a result line that is
correct and names the card; at each cell's own size, the controls one
precision below its configuration and the faults planted in the reference
come out not correct under its limits (skipped without a card)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.tests.conftest import ROOT

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("cell", ["vit_l_bf16.predict_b8", "vit_h_fp32.tune_b8"])
def test_short_run_is_correct(card, cell):
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed", str(2**32 + 11),
                           "--seconds", "3", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert line["metrics"]["setup_s"]["value"] > 0 and list(line)[-1] == "checks"


@pytest.mark.parametrize("cell, wrong", [
    ("vit_l_bf16.predict_b8", ("control_fp8", "fault_ids_altered")),
    ("vit_h_fp32.tune_b8", ("control_tf32", "fault_half_batch", "fault_state_unchanged")),
])
def test_controls_are_not_correct(card, cell, wrong):
    import torch

    from portbench import calibrate, harness

    c = harness.load_cell(cell, 2**32 + 13, 2.0, False, card)
    out = calibrate.READINGS[c.traffic["driver"]](c, True)
    torch.cuda.empty_cache()
    assert out["program"]["correct"], out
    assert not any(out[k]["correct"] for k in wrong), out
