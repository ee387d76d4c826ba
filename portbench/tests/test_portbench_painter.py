"""The Painter cell: its driver's loop at a size a test holds (a window that
divides the grid and one that pads it), ``metrics/ranged_trace.py`` on
hand-built Chrome-trace events, its readers, and the planted faults of
``calibrate_painter.py`` far above the program; on the card (``gpu``), a
short run of each new cell is correct and, at the cell's own size, the
fp8 control and every fault come out not correct."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from portbench.metrics.ranged_trace import RangedTrace, innermost
from portbench.metrics.trace import WINDOW
from portbench.tests.conftest import ROOT

CELL = "painter_vit_l_bf16.predict_b8"


def painter_cell(window: int, seconds: float = 0.5, trace: bool = False, seed: int = 2**33 + 7):
    """The Painter cell on the CPU in fp32: C 128 (2 heads of 64, so kernel
    #1's path), 3 blocks with block 1 global, a 128×64 canvas (grid 8×4),
    crops of 32 at 64."""
    from portbench import harness

    cell = harness.load_cell(CELL, seed, seconds, trace, torch.device("cpu"))
    m = dict(cell.config["model"], hidden_size=128, num_hidden_layers=3, num_attention_heads=2, mlp_dim=256,
             image_size=[128, 64], pretrain_image_size=64, decoder_hidden_size=16, merge_index=0,
             intermediate_hidden_state_indices=[0, 2], window_size=window, global_attn_indexes=[1])
    cell.config = dict(cell.config, model=m, compute_dtype="float32",
                       run=dict(cell.config["run"], crop_size=32, inpt_size=64))
    cell.traffic = dict(cell.traffic, trace_seconds=seconds, pool=4)
    return cell


@pytest.mark.parametrize("window", [2, 3], ids=["divides", "pads"])
def test_painter_loop(window):
    from portbench.drivers import painter_predict_step

    out = painter_predict_step.run(painter_cell(window))
    assert out.correct and out.attempted > 0 and out.failed == 0
    assert set(out.e2e) == {"setup_s", "predict_tiles_per_s", "predict_p95_ms"}


def test_traced_window_counts_the_ranges():
    """Blocks 0 and 2 are windowed: two ``bst.seggpt.attn_win`` ranges a
    call and four ``bst.seggpt.window`` ranges; on the CPU none of the
    cell's own device metrics reads more than 0."""
    from portbench import run as bench_run
    from portbench.drivers import painter_predict_step
    from portbench.metrics.flops import Shape

    cell = painter_cell(3, trace=True)
    out = painter_predict_step.run(cell)
    calls = out.counts["calls"]
    assert isinstance(out.trace, RangedTrace)
    assert out.trace.ranges_named("bst.seggpt.attn_win") == 2 * calls
    assert out.trace.ranges_named("bst.seggpt.window") == 4 * calls
    ctx = bench_run.MetricContext(cell, out, Shape.from_model(cell.model))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in [m for m in bench_run.per_layer(bench, CELL) if m["name"].endswith(".painter_predict")]:
        value = bench_run.read_metric(m["name"], ctx)
        assert value is None or value == 0, m["name"]


def ranged(events: list[dict], window=(0.0, 1000.0)) -> RangedTrace:
    return RangedTrace.from_events([{"ph": "X", "cat": "user_annotation", "name": WINDOW, "ts": window[0],
                                     "dur": window[1] - window[0], "tid": 1}] + events)


def host(name, a, b, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": a, "dur": b - a, "tid": tid}


def launch(corr, ts, tid=1, cat="cuda_runtime"):
    return {"ph": "X", "cat": cat, "name": "cudaLaunchKernel", "ts": ts, "dur": 1.0, "tid": tid,
            "args": {"correlation": corr}}


def kernel(name, corr, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "args": {"correlation": corr}}


def test_innermost_open_range():
    ranges = [(0, 100, "a"), (10, 40, "b"), (20, 30, "c"), (50, 60, "d")]
    assert innermost(ranges, [5, 15, 25, 35, 45, 55, 70, 120]) == ["a", "b", "c", "b", "a", "d", "a", None]


def test_kernels_take_the_range_of_their_launch():
    """A kernel runs long after its launch; it belongs to the innermost
    ``bst.`` range open on the launching thread, found by correlation id.
    Ranges of another thread, or a kernel with no launch record, give
    none."""
    tr = ranged([
        host("bst.seggpt", 100, 500), host("bst.seggpt.attn", 110, 300), host("bst.seggpt.window", 120, 140),
        host("bst.seggpt.attn_win", 150, 200), host("bst.kernel.attn_qkv_rel", 160, 170),
        host("bst.seggpt.window", 210, 230), host("bst.seggpt.window", 125, 135, tid=2),
        launch(1, 122), launch(2, 165), launch(3, 212), launch(4, 215, cat="cuda_driver"), launch(5, 400),
        launch(6, 600), launch(7, 128, tid=2),
        kernel("pad", 1, 700, 10), kernel("attn_kernel_bf16", 2, 710, 50), kernel("copy", 3, 760, 5),
        kernel("copy2", 4, 765, 7), kernel("gemm", 5, 780, 20), kernel("late", 6, 800, 1),
        kernel("other_thread", 7, 810, 3), kernel("orphan", 99, 820, 2),
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 830, "dur": 4, "args": {"correlation": 8}},
    ])
    names = dict(zip((k[0] for k in tr.device), tr.launch_range))
    assert names == {"pad": "bst.seggpt.window", "attn_kernel_bf16": "bst.kernel.attn_qkv_rel",
                     "copy": "bst.seggpt.window", "copy2": "bst.seggpt.window", "gemm": "bst.seggpt", "late": None,
                     "other_thread": "bst.seggpt.window", "orphan": None, "Memcpy HtoD": None}
    assert [k[0] for k in tr.kernels_in("bst.seggpt.window")] == ["pad", "copy", "copy2", "other_thread"]
    assert tr.device_seconds_in("bst.seggpt.window") == pytest.approx(25e-6)
    assert tr.ranges_named("bst.seggpt.window") == 3 and tr.ranges_named("bst.seggpt.attn_win") == 1
    assert tr.busy_s() == pytest.approx(102e-6)  # still a Trace


class Ctx:
    def __init__(self, tr, model, **counts):
        self.trace, self.counts = tr, counts
        self.cell = type("C", (), {"model": model})()


def test_readers_on_a_hand_built_trace():
    from portbench import run as bench_run

    model = json.loads((ROOT / "portbench" / "configs" / "painter_vit_l_bf16.json").read_text())["model"]
    tr = ranged([host("bst.seggpt.window", 100, 110), launch(1, 105), kernel("pad", 1, 200, 500),
                 host("bst.kernel.attn_qkv_rel", 120, 130), launch(2, 125), kernel("attn_kernel_x", 2, 700, 250)])
    ctx = Ctx(tr, model, calls=2, tiles=16, window_s=1e-3)
    assert bench_run.read_metric("window_layout_ms_per_call.painter_predict", ctx) == pytest.approx(0.25)
    from portbench.metrics import flops, flops_window

    sh = flops_window.WindowShape.from_model(model)
    assert bench_run.read_metric("attn_fwd_roofline_pct.painter_predict", ctx) == pytest.approx(
        100 * flops_window.attention_fwd_bound_s(sh, 16, 2, flops.PEAK_BF16) / 250e-6)
    assert bench_run.read_metric("mfu.painter_predict", ctx) == pytest.approx(
        100 * 16 * flops_window.forward_flops_per_tile(sh) / 1e-3 / flops.MFU_PEAK)
    # no window range in the trace (a model without windows): no reading
    bare = ranged([launch(1, 105), kernel("pad", 1, 200, 500)])
    assert bench_run.read_metric("window_layout_ms_per_call.painter_predict", Ctx(bare, model, calls=2)) is None


@pytest.mark.parametrize("fault", ["fault_all_global", "fault_windows_misplaced"])
def test_planted_faults_read_far_above_the_program(fault):
    """At these widths the scores span less than at the cell's, so the
    faults' verdicts under the cell's limit are read at its own size on the
    card; here each reads far above the program (windows of 2 cut the 8×4
    grid into 4×2 windows, as 14 cuts ViT-L's 56×28)."""
    from portbench import calibrate_painter

    prog = calibrate_painter.program_run(painter_cell(2))[2][0][1]
    with calibrate_painter.FAULTS[fault]():
        got = calibrate_painter.program_run(painter_cell(2))[2][0][1]
    assert got > 10 * prog, (got, prog)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [CELL, "vit_l_bf16.predict_b32"])
def test_short_run_is_correct(card, cell):
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed", str(2**32 + 11),
                           "--seconds", "3", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu" and line["device"]["count"] == 1


@pytest.mark.gpu
def test_traced_window_on_the_card(card):
    """A traced window of the Painter cell: each call opens 16
    ``bst.seggpt.attn_win`` ranges and launches #1 24 times (16 windowed
    blocks, 8 global), makes the entry's 12 syncs, and the layout kernels
    are found under ``bst.seggpt.window``."""
    from portbench import harness
    from portbench.drivers import painter_predict_step
    from portbench.metrics import port_spans

    cell = harness.load_cell(CELL, 2**32 + 17, 1.0, True, card)
    cell.traffic = dict(cell.traffic, trace_seconds=1.0)
    out = painter_predict_step.run(cell)
    calls, tr = out.counts["calls"], out.trace
    assert out.correct and calls > 0
    assert tr.ranges_named("bst.seggpt.attn_win") == 16 * calls
    assert len(tr.kernels([r"attn_kernel"])) == 24 * calls
    assert len(tr.kernels_in("bst.kernel.attn_qkv_rel")) >= 24 * calls
    assert port_spans.syncs_inside(tr, "bst.predict_step") == 12 * calls
    assert tr.device_seconds_in("bst.seggpt.window") > 0


@pytest.mark.gpu
def test_controls_and_faults_are_not_correct(card):
    from portbench import calibrate_painter, harness

    c = harness.load_cell(CELL, 2**32 + 13, 2.0, False, card)
    out = calibrate_painter.painter_seed(c, True)
    torch.cuda.empty_cache()
    assert out["program"]["correct"], out
    wrong = ("control_fp8", "fault_ids_altered", *calibrate_painter.FAULTS)
    assert not any(out[k]["correct"] for k in wrong), out
