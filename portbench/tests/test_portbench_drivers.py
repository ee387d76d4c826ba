"""Each driver's loop rehearsed on the CPU at a size a test holds (the
plain versions of the port's kernels), and the run's refusal to report
without a card."""

from __future__ import annotations

import subprocess
import sys

import pytest

from portbench.tests.conftest import ROOT, tiny_cell


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_predict_loop(dtype):
    from portbench.drivers import predict_step

    out = predict_step.run(tiny_cell("vit_l_bf16.predict_b8", dtype))
    assert out.correct and out.attempted > 0 and out.memory_peak_bytes == 0
    assert set(out.e2e) == {"setup_s", "predict_tiles_per_s", "predict_p95_ms"}
    assert out.counts["tiles"] == 8 * out.attempted


def test_train_loop_matches_the_reference():
    from portbench.drivers import train_step

    out = train_step.run(tiny_cell("vit_h_fp32.tune_b8", seconds=1.0))
    checks = {name: value for name, value, _ in out.checks}
    assert out.correct and checks["data_rows_differing"] == 0
    # fp32 on the CPU: the port's plain versions and the reference agree to rounding
    assert checks["loss_rel"] < 1e-5 and checks["grad1_leaf"] < 1e-5 and checks["delta_leaf"] < 1e-3
    assert set(out.e2e) == {"setup_s", "train_tiles_per_s"}


def test_traced_run_reports_no_device_metric_from_the_cpu():
    from portbench import run
    from portbench.drivers import predict_step
    from portbench.metrics.flops import Shape

    cell = tiny_cell("vit_l_bf16.predict_b8", trace=True)
    out = predict_step.run(cell)
    assert out.trace is not None and out.trace.kernels() == []
    ctx = run.MetricContext(cell, out, Shape.from_model(cell.model))
    for name in ("mfu.predict", "attn_fwd_roofline_pct.predict", "launches_per_call.predict"):
        value = run.read_metric(name, ctx)
        assert value is None or value == 0


def test_run_refuses_without_a_card():
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "vit_l_bf16.predict_b8", "--seed",
                           str(2**32 + 7), "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA" in proc.stderr
