"""The EVA-02 cell: its driver's loop at a size a test holds, the operations
of ``metrics/flops_eva02.py`` against a count by hand, its three readers on
a hand-built trace, and the planted faults of ``calibrate_eva02.py`` far
above the program; on the card (``gpu``), a short run is correct, a traced
window launches both new kernels once a block inside their ranges and prints
the three metrics between 0 and 100, and, at the cell's own size, the fp8
control and every fault come out not correct."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from portbench.metrics import flops, flops_eva02
from portbench.metrics.ranged_trace import RangedTrace
from portbench.metrics.trace import WINDOW
from portbench.tests.conftest import ROOT

CELL = "eva02_vit_l_bf16.predict_b8"
NEW_METRICS = ("mfu.eva02_predict", "attn_fwd_roofline_pct.eva02_predict", "mlp_roofline_pct.eva02_predict")


def model_file() -> dict:
    return json.loads((ROOT / "portbench" / "configs" / "eva02_vit_l_bf16.json").read_text())["model"]


def eva02_cell(seconds: float = 0.5, trace: bool = False, seed: int = 2**33 + 9):
    """The EVA-02 cell on the CPU in bf16 (so through both new entries'
    plain versions): C 256 (4 heads of 64; the SwiGLU kernels' least width),
    3 blocks, a 224×112 canvas at patch 14 (grid 16×8, RoPE step: the
    pretrain grid's 56 / 14 = 4 over 8 columns, the cell's 0.5), an MLP of int(256 · 2.6667) = 682,
    crops of 28 at 112 (the prompts' class cells are 16 pixels)."""
    from portbench import harness

    cell = harness.load_cell(CELL, seed, seconds, trace, torch.device("cpu"))
    m = dict(cell.config["model"], hidden_size=256, num_hidden_layers=3, num_attention_heads=4, mlp_dim=682,
             image_size=[224, 112], pretrain_image_size=56, decoder_hidden_size=16, merge_index=0,
             intermediate_hidden_state_indices=[0, 2])
    cell.config = dict(cell.config, model=m, run=dict(cell.config["run"], crop_size=28, inpt_size=112))
    cell.traffic = dict(cell.traffic, trace_seconds=seconds, pool=4)
    return cell


def test_eva02_loop():
    from portbench.drivers import eva02_predict_step

    out = eva02_predict_step.run(eva02_cell())
    assert out.correct and out.attempted > 0 and out.failed == 0
    assert set(out.e2e) == {"setup_s", "predict_tiles_per_s", "predict_p95_ms"}


def test_traced_window_holds_the_new_ranges():
    """Each call opens one ``bst.kernel.attn_qkv_rope`` and one
    ``bst.kernel.swiglu_mlp`` range a block and one ``bst.seggpt.sub_ln``
    (the inner LayerNorm) a block; on the CPU none of the three metrics
    reads more than 0."""
    from portbench import run as bench_run
    from portbench.drivers import eva02_predict_step
    from portbench.metrics.flops import Shape

    cell = eva02_cell(trace=True)
    out = eva02_predict_step.run(cell)
    calls, tr = out.counts["calls"], out.trace
    assert isinstance(tr, RangedTrace) and calls > 0
    for name in ("bst.kernel.attn_qkv_rope", "bst.kernel.swiglu_mlp", "bst.seggpt.sub_ln"):
        assert tr.ranges_named(name) == 3 * calls, name
    ctx = bench_run.MetricContext(cell, out, Shape.from_model(cell.model))
    for name in NEW_METRICS:
        value = bench_run.read_metric(name, ctx)
        assert value is None or value == 0, name


def test_tile_by_hand():
    """EVA-02-L at patch 14 on 896×448: S = 2048, C = 1024, M = 2730; a row
    of a block is 8·S·C² (qkv, proj) + 6·S·C·M (SwiGLU) + 4·S²·C; 27
    layer-rows a tile; the embedding of two canvases and the query-half
    decoder (1024 patches of 14², 4 intermediates, 64 channels)."""
    sh = flops.Shape.from_model(model_file())
    s, c, m = 2048, 1024, 2730
    assert (sh.tokens, sh.mlp, flops.layer_rows(sh), flops_eva02.padded_mlp(sh)) == (s, m, 27, 2752)
    row = 8 * s * c * c + 6 * s * c * m + 4 * s * s * c
    assert flops_eva02.linear_flops(sh) + flops_eva02.attention_flops(sh) == row == 68_711_088_128
    embed = 2 * s * 14 * 14 * 3 * c
    pixels = 1024 * 196
    decoder = 2 * 1024 * 4 * c * 196 * 64 + 2 * pixels * 9 * 64 * 64 + 2 * pixels * 64 * 3
    assert flops_eva02.forward_flops_per_tile(sh) == 27 * row + 2 * embed + decoder
    assert flops_eva02.forward_flops_per_tile(sh) == pytest.approx(1.9802e12, rel=1e-4)


def test_bounds_are_the_operations_at_these_widths():
    sh = flops.Shape.from_model(model_file())
    t, by = flops_eva02.attention_fwd_bound_s(sh, 27, 24, flops.PEAK_BF16)
    assert by == "operations" and t == pytest.approx(27 * 4 * 2048**2 * 1024 / flops.PEAK_BF16)
    t, by = flops_eva02.mlp_fwd_bound_s(sh, 27, 24, flops.PEAK_BF16)
    assert by == "operations" and t == pytest.approx(27 * 6 * 2048 * 1024 * 2730 / flops.PEAK_BF16)


def ranged(events: list[dict], window=(0.0, 1000.0)) -> RangedTrace:
    return RangedTrace.from_events([{"ph": "X", "cat": "user_annotation", "name": WINDOW, "ts": window[0],
                                     "dur": window[1] - window[0], "tid": 1}] + events)


def host(name, a, b, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": a, "dur": b - a, "tid": tid}


def launch(corr, ts):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1.0, "tid": 1,
            "args": {"correlation": corr}}


def kernel(name, corr, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "args": {"correlation": corr}}


class Ctx:
    def __init__(self, tr, model, **counts):
        self.trace, self.counts = tr, counts
        self.cell = type("C", (), {"model": model})()


def test_readers_on_a_hand_built_trace():
    """Each roofline reads the kernels launched inside its own range (the
    RoPE pre-pass and key loop; the MLP's pads, row passes and products) and
    nothing else."""
    from portbench import run as bench_run

    model = model_file()
    tr = ranged([host("bst.kernel.attn_qkv_rope", 100, 110), launch(1, 102), launch(2, 104),
                 kernel("rope_qkv", 1, 200, 40), kernel("attn_kernel_x", 2, 240, 400),
                 host("bst.kernel.swiglu_mlp", 120, 130), launch(3, 122), launch(4, 124),
                 kernel("gemm_a", 3, 640, 300), kernel("ln_wide", 4, 940, 20),
                 host("bst.seggpt", 131, 140), launch(5, 135), kernel("other", 5, 960, 30)])
    ctx = Ctx(tr, model, calls=2, tiles=16, window_s=1e-3)
    sh = flops.Shape.from_model(model)
    rows, launches = 16 * 27, 2 * 24
    assert bench_run.read_metric("attn_fwd_roofline_pct.eva02_predict", ctx) == pytest.approx(
        100 * flops_eva02.attention_fwd_bound_s(sh, rows, launches, flops.PEAK_BF16)[0] / 440e-6)
    assert bench_run.read_metric("mlp_roofline_pct.eva02_predict", ctx) == pytest.approx(
        100 * flops_eva02.mlp_fwd_bound_s(sh, rows, launches, flops.PEAK_BF16)[0] / 320e-6)
    assert bench_run.read_metric("mfu.eva02_predict", ctx) == pytest.approx(
        100 * 16 * flops_eva02.forward_flops_per_tile(sh) / 1e-3 / flops.MFU_PEAK)
    bare = ranged([launch(1, 105), kernel("pad", 1, 200, 500)])
    for name in NEW_METRICS[1:]:
        assert bench_run.read_metric(name, Ctx(bare, model, calls=2, tiles=16)) is None


@pytest.mark.parametrize("fault", ["fault_half_split_rope", "fault_rope_q_only", "fault_no_sub_ln",
                                   "fault_gate_value_swapped"])
def test_planted_faults_read_far_above_the_program(fault):
    """At these widths the scores span less than at the cell's (at the
    init's std 0.02 and C 128 the softmax is nearly flat, so where k turns
    barely matters), so the weights here take std 0.06, and the faults'
    verdicts under the cell's limit are read at its own size on the card.
    Here each reads over five times the program's gap. ``fault_k_bias``
    is left to the card: a k bias of the biases' std turns into
    q·R(t)·b, a score change of a few hundredths at this width, within
    the program's own bf16 gap."""
    from portbench import calibrate_eva02

    def cell():
        c = eva02_cell()
        c.config = dict(c.config, weights=dict(c.config["weights"], std=0.06))
        return c

    prog = calibrate_eva02.program_run(cell())[2][0][1]
    with calibrate_eva02.FAULTS[fault]():
        got = calibrate_eva02.program_run(cell())[2][0][1]
    assert got > 5 * prog, (got, prog)


@pytest.mark.gpu
def test_short_run_is_correct(card):
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELL, "--seed", str(2**32 + 21),
                           "--seconds", "3", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu" and line["device"]["count"] == 1


@pytest.mark.gpu
def test_traced_window_on_the_card(card):
    """A traced window of the cell: each call launches the RoPE attention's
    two kernels and the SwiGLU MLP's four stage kernels 24 times inside
    their ranges (the operands were padded once, in the warm-up), makes the entry's 12 syncs, and the three
    metrics read between 0 and 100."""
    from portbench import harness
    from portbench import run as bench_run
    from portbench.drivers import eva02_predict_step
    from portbench.metrics import port_spans

    cell = harness.load_cell(CELL, 2**32 + 27, 1.0, True, card)
    cell.traffic = dict(cell.traffic, trace_seconds=1.0)
    out = eva02_predict_step.run(cell)
    calls, tr = out.counts["calls"], out.trace
    assert out.correct and calls > 0
    assert len(tr.kernels_in("bst.kernel.attn_qkv_rope")) == 2 * 24 * calls
    assert len(tr.kernels_in("bst.kernel.swiglu_mlp")) == 4 * 24 * calls
    assert port_spans.syncs_inside(tr, "bst.predict_step") == 12 * calls
    ctx = bench_run.MetricContext(cell, out, flops.Shape.from_model(cell.model))
    for name in NEW_METRICS:
        assert 0 < bench_run.read_metric(name, ctx) < 100, name


@pytest.mark.gpu
def test_controls_and_faults_are_not_correct(card):
    """The fp8 control and every planted fault but one read not correct.
    ``fault_k_bias`` reads as the program does (1.49–1.89 on 3 seeds
    against the program's 1.31–2.68 on 24): a k bias of the biases' std
    turns, under RoPE, into a score term q·R(t)·b of a few hundredths, which
    the served ids cannot show and no limit that passes the program can."""
    from portbench import calibrate_eva02, harness

    c = harness.load_cell(CELL, 2**32 + 23, 2.0, False, card)
    out = calibrate_eva02.eva02_seed(c, True)
    torch.cuda.empty_cache()
    assert out["program"]["correct"], out
    wrong = ("control_fp8", "fault_ids_altered", *(f for f in calibrate_eva02.FAULTS if f != "fault_k_bias"))
    assert not any(out[k]["correct"] for k in wrong), out
