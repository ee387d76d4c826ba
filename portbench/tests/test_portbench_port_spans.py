"""``metrics/port_spans.py`` and its four readers on hand-built Chrome-trace
events; on the card (``gpu``), the port's ranges against what they stand
for: the syncs torch's sync-debug mode sees in a predict call, and the
hand-written kernels' launches."""

from __future__ import annotations

import json
import os
import re
import tempfile
import warnings
from collections import Counter

import numpy as np
import pytest
import torch

from portbench import run as bench_run
from portbench.tests.conftest import ROOT
from portbench.metrics import port_spans
from portbench.metrics.trace import WINDOW, Trace

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
READERS = ("model_idle_ms_per_call.predict", "entry_idle_ms_per_call.predict", "host_syncs_per_call.predict",
           "feed_idle_ms_per_step.train")


def trace(host: list[tuple[str, float, float]], device: list[tuple[float, float]], window=(0.0, 1000.0)) -> Trace:
    """A trace from (name, start µs, end µs) host ranges and (start, end)
    device kernels, inside a window."""
    events = [{"ph": "X", "cat": "user_annotation", "name": WINDOW, "ts": window[0], "dur": window[1] - window[0]}]
    events += [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a, "dur": b - a} for n, a, b in host]
    events += [{"ph": "X", "cat": "kernel", "name": f"k{i}", "ts": a, "dur": b - a} for i, (a, b) in enumerate(device)]
    return Trace.from_events(events)


class Ctx:
    def __init__(self, tr, **counts):
        self.trace, self.counts = tr, counts


# two predict calls: entry [100, 450] and [500, 950], the model inside each,
# syncs in the model, in the entry outside it and one outside any call
CALLS = [
    ("bst.predict_step", 100, 450), ("bst.predict.inputs", 100, 150), ("bst.sync", 110, 130),
    ("bst.seggpt", 150, 400), ("bst.seggpt.attn", 160, 260), ("bst.sync", 170, 180),
    ("bst.kernel.attn_qkv_rel", 200, 210), ("bst.predict.decode", 400, 450), ("bst.sync", 420, 440),
    ("bst.predict_step", 500, 950), ("bst.seggpt", 520, 900), ("bst.sync", 530, 540),
    ("bst.sync", 960, 970), ("portbench.predict_step", 90, 990),
]
BUSY = [(0, 50), (120, 140), (200, 380), (600, 880), (990, 1000)]
# idle [50, 120): 50 µs outside, 20 entry; [140, 200): 10 entry, 50 model;
# [380, 600): 20 model, 50 entry, 50 outside (between the calls), 20 entry,
# 80 model; [880, 990): 20 model, 50 entry, 40 outside
SPLIT = {"model": 170e-6, "entry": 150e-6, "feed": 0.0, "outside": 140e-6}


def idle_s(tr: Trace) -> float:
    return tr.window_s - tr.busy_s()


def test_split_by_innermost_layer():
    got = port_spans.idle_split(trace(CALLS, BUSY))
    assert got == pytest.approx(SPLIT, abs=1e-12)


@pytest.mark.parametrize("host, device", [
    (CALLS, BUSY),
    (CALLS, [(999, 1000)]),  # idle all but the last µs
    (CALLS, [(0, 1000)]),  # never idle
    ([("bst.data.wait", 0, 300), ("bst.train_step", 300, 800), ("bst.seggpt", 350, 600),
      ("bst.train.backward", 600, 780)], [(100, 200), (320, 500), (650, 700)]),
    ([("bst.seggpt", -50, 40), ("bst.predict_step", 950, 1200)], [(20, 980)]),  # ranges over the window's edges
])
def test_parts_sum_to_the_idle_time(host, device):
    tr = trace(host, device)
    got = port_spans.idle_split(tr)
    assert set(got) == set(port_spans.LAYERS)
    assert sum(got.values()) == pytest.approx(idle_s(tr), abs=1e-12)
    assert sum(got.values()) == pytest.approx(tr.idle_pct() / 100 * tr.window_s, abs=1e-12)


def test_feed_and_nesting():
    """A feed wait is feed; a model range inside an entry is model; the
    entry's own phases (backward, optimizer) stay entry."""
    tr = trace([("bst.data.wait", 0, 300), ("bst.train_step", 300, 1000), ("bst.seggpt", 400, 600),
                ("bst.seggpt.mlp", 450, 500), ("bst.train.backward", 600, 900)], [(250, 350), (450, 650)])
    got = port_spans.idle_split(tr)
    assert got == pytest.approx({"feed": 250e-6, "model": 50e-6, "entry": 50e-6 + 350e-6, "outside": 0.0}, abs=1e-12)


def test_syncs_count_only_inside_the_entry():
    tr = trace(CALLS, BUSY)
    assert port_spans.syncs_inside(tr, "bst.predict_step") == 4
    assert port_spans.syncs_inside(tr, "bst.train_step") == 0


@pytest.mark.parametrize("metric, counts, want", [
    ("model_idle_ms_per_call.predict", {"calls": 2}, 0.085),
    ("entry_idle_ms_per_call.predict", {"calls": 2}, 0.075),
    ("host_syncs_per_call.predict", {"calls": 2}, 2.0),
    ("feed_idle_ms_per_step.train", {"steps": 2}, 0.0),
])
def test_readers(metric, counts, want):
    assert bench_run.read_metric(metric, Ctx(trace(CALLS, BUSY), **counts)) == pytest.approx(want)


@pytest.mark.parametrize("metric", READERS)
@pytest.mark.parametrize("host", [[], [("portbench.predict_step", 0, 500), ("aten::copy_", 10, 20)]])
def test_readers_read_nothing_without_port_ranges(metric, host):
    """A port without the spans (the parent of this benchmark's readers):
    no number, no error."""
    ctx = Ctx(trace(host, BUSY), calls=2, steps=2)
    assert bench_run.read_metric(metric, ctx) is None
    assert bench_run.read_metric(metric, Ctx(None, calls=2, steps=2)) is None


def test_no_reading_without_device_activity():
    """A trace with the port's ranges but nothing on a device (a run on the
    CPU) reads nothing."""
    tr = trace(CALLS, [])
    assert port_spans.idle_split(tr) is None and port_spans.syncs_inside(tr, "bst.predict_step") is None


@pytest.mark.parametrize("cell", ["vit_l_bf16.predict_b8", "vit_h_fp32.tune_b8"])
def test_cpu_run_reports_none(cell):
    """A traced run of a cell's driver on the CPU at the debug widths holds
    the port's ranges and no device activity: each new reader of the cell
    reads None."""
    from portbench.drivers import predict_step, train_step
    from portbench.metrics.flops import Shape
    from portbench.tests.conftest import tiny_cell

    c = tiny_cell(cell, trace=True)
    out = (predict_step if "predict" in cell else train_step).run(c)
    assert any(n.startswith("bst.") for n, _, _ in out.trace.host) and out.trace.kernels() == []
    ctx = bench_run.MetricContext(c, out, Shape.from_model(c.model))
    for m in bench_run.per_layer(BENCH, cell):
        if m["name"] in READERS:
            assert bench_run.read_metric(m["name"], ctx) is None


# ------------------------------------------------------------------ card

# the port's hand-written kernels, by table row (PERF.md): the names of
# their device functions as the trace shows them
PORT_KERNELS = {
    1: r"flash::wgf::attn_kernel|fill_slots",  # attn_qkv_rel, bf16
    2: r"rows::ln_rows|g90::gemm_kernel",  # ln_mlp's stages
    3: r"flash::tc32::attn_kernel",  # attn_packed, fp32, head_dim 80
    4: r"bwd_q_kernel|bwd_k_kernel|pack_slots",  # attn_bwd
    5: r"ln_vjp_rows",  # ln_mlp_dx's last stage
}
# (hidden, heads, dtype): head_dim 64 in bf16 runs #1, #2, #4, #5; head_dim 80
# in fp32 runs #3 and #4
SMALL = {"hd64_bf16": (256, 4, torch.bfloat16), "hd80_fp32": (160, 2, torch.float32)}


def small_tuner(card, hidden: int, heads: int, dtype):
    from beach_seg_tpu_torch.config import BeachSegConfig
    from beach_seg_tpu_torch.models.seggpt import build_model, tiny_config
    from beach_seg_tpu_torch.ops import build
    from beach_seg_tpu_torch.train import PromptTuner

    build.build(*build.KERNELS)
    cfg = tiny_config(hidden_size=hidden, num_attention_heads=heads, mlp_dim=4 * hidden, num_hidden_layers=2,
                      image_size=(128, 64), patch_size=16, pretrain_image_size=64, decoder_hidden_size=16,
                      merge_index=0, intermediate_hidden_state_indices=(0, 1), initializer_range=0.2,
                      drop_path_rate=0.1)
    model = build_model(cfg, dtype, device=card, seed=5)
    conf = BeachSegConfig(crop_size=32, inpt_size=64, batch_size=2)
    tuner = PromptTuner(model, conf, device=card)
    rng = np.random.default_rng(1)
    prompts = (torch.as_tensor(rng.random((4, 64, 64, 3)).astype(np.float32), device=card),
               torch.as_tensor(rng.integers(0, 4, (4, 64, 64)).astype(np.int32), device=card),
               torch.zeros((4, 64, 64), dtype=torch.bool, device=card))
    predict = {"image_u8": rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8),
               "crop_idx": rng.integers(0, 4, (2,)).astype(np.int32)}
    train = {"image": rng.random((2, 64, 64, 3)).astype(np.float32),
             "mask": rng.integers(0, 4, (2, 64, 64)).astype(np.int32), "nodata": np.zeros((2, 64, 64), bool)}
    return tuner, prompts, predict, train


def chrome_events(prof) -> list[dict]:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def profiled(card, fn) -> list[dict]:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(card)
    return chrome_events(prof)


@pytest.mark.gpu
@pytest.mark.parametrize("geometry", list(SMALL))
def test_sync_ranges_match_sync_debug(card, geometry):
    """One predict call: the ``bst.sync`` ranges inside ``bst.predict_step``
    are as many as the synchronizing operations torch's sync-debug mode
    reports inside the same call."""
    tuner, prompts, batch, _ = small_tuner(card, *SMALL[geometry])

    def call():
        return tuner.predict_step(*prompts, batch, out_size=32)

    call()  # warm: kernels loaded, caches filled
    torch.cuda.synchronize(card)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught if "synchronizing" in str(w.message)]
    events = [e for e in profiled(card, call) if e.get("ph") == "X"]
    start = min(float(e["ts"]) for e in events)
    tr = Trace.from_events([{"ph": "X", "cat": "user_annotation", "name": WINDOW, "ts": start, "dur": 1e12}] + events)
    ranges = port_spans.syncs_inside(tr, "bst.predict_step")
    assert ranges == len(syncs) > 0, (ranges, sorted(Counter(syncs).items()))


@pytest.mark.gpu
def test_port_kernels_launch_inside_kernel_ranges(card):
    """In the raw trace of one predict call and one train step at each small
    geometry, every kernel of table rows #1–#5 was launched from inside a
    ``bst.kernel.*`` range (the launch's runtime call, matched by its
    correlation id, lies in the range); every row is seen."""
    seen = set()
    for geometry, spec in SMALL.items():
        tuner, prompts, batch, train = small_tuner(card, *spec)
        state = tuner.init_state(prompts[0])
        gen = torch.Generator(device=card).manual_seed(3)

        def work():
            tuner.predict_step(*prompts, batch, out_size=32)
            tuner.train_step(state, prompts[1], prompts[2], train, generator=gen)

        work()
        events = [e for e in profiled(card, work) if e.get("ph") == "X"]
        ranges = [(e["ts"], e["ts"] + e["dur"], e.get("tid")) for e in events
                  if e.get("cat") == "user_annotation" and e["name"].startswith("bst.kernel.")]
        launches = {e["args"]["correlation"]: e for e in events
                    if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})}
        for k in (e for e in events if e.get("cat") == "kernel"):
            rows = [r for r, pat in PORT_KERNELS.items() if re.search(pat, k["name"])]
            if not rows:
                continue
            launch = launches.get(k.get("args", {}).get("correlation"))
            assert launch is not None, k["name"]
            assert any(a <= launch["ts"] <= b and tid == launch.get("tid") for a, b, tid in ranges), (geometry, k["name"])
            seen.update(rows)
    assert seen == set(PORT_KERNELS)
