"""The port's spans (``utils/profiling.span`` and the ``bst.*`` ranges at its
layer boundaries) on the CPU: nothing without a profiler, the entry's ranges
nested as the benchmark's reader expects under one, and the same outputs
either way."""

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from beach_seg_tpu_torch.config import BeachSegConfig
from beach_seg_tpu_torch.data.prefetch import prefetch_iterator
from beach_seg_tpu_torch.models.seggpt import build_model, tiny_config
from beach_seg_tpu_torch.train import PromptTuner
from beach_seg_tpu_torch.utils import profiling

N_PROMPTS, B = 4, 2
CFG = dict(initializer_range=0.2)
TRAIN_PHASES = ("bst.train.draws", "bst.train.augment", "bst.seggpt", "bst.train.backward", "bst.train.optimizer",
                "bst.train.confusion")


def ranges(prof) -> list[tuple[str, float, float, int]]:
    """The ``bst.`` ranges of a profile: (name, start µs, end µs, thread), by start."""
    out = [(e.name, e.time_range.start, e.time_range.end, e.thread) for e in prof.events() if e.name.startswith("bst.")]
    return sorted(out, key=lambda r: (r[1], -r[2]))


def inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def children(rs, parent, prefix: str) -> list[str]:
    """Names of the ranges under ``prefix`` that lie inside ``parent``, in time order."""
    return [r[0] for r in rs if r is not parent and r[0].startswith(prefix) and inside(r, parent)]


def traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, ranges(prof)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_config(**CFG)
    h = cfg.image_size[1]
    model = build_model(cfg, device="cpu", seed=3)
    conf = BeachSegConfig(crop_size=h // 2, inpt_size=h, batch_size=B)
    tuner = PromptTuner(model, conf, device="cpu")
    rng = np.random.default_rng(0)
    prompts = (
        torch.as_tensor(rng.random((N_PROMPTS, h, h, 3)).astype(np.float32)),
        torch.as_tensor(rng.integers(0, 4, (N_PROMPTS, h, h)).astype(np.int32)),
        torch.zeros((N_PROMPTS, h, h), dtype=torch.bool),
    )
    predict_batch = {"image_u8": rng.integers(0, 256, (B, h // 2, h // 2, 3), dtype=np.uint8),
                     "crop_idx": rng.integers(0, N_PROMPTS, (B,)).astype(np.int32)}
    train_batch = {"image": rng.random((B, h, h, 3)).astype(np.float32),
                   "mask": rng.integers(0, 4, (B, h, h)).astype(np.int32),
                   "nodata": np.zeros((B, h, h), bool), "valid": np.array([True, False])}
    return cfg, tuner, prompts, predict_batch, train_batch


def predict_call(setup, entry: str):
    _, tuner, prompts, batch, _ = setup
    return getattr(tuner, entry)(*prompts, batch, out_size=batch["image_u8"].shape[1])


def train_call(setup):
    _, tuner, prompts, _, batch = setup
    state = tuner.init_state(prompts[0])
    _, out = tuner.train_step(state, prompts[1], prompts[2], batch, generator=torch.Generator().manual_seed(7))
    return state.prompt_pixels, state.ema_pixels, out["loss"], out["confusion"]


# ------------------------------------------------------------------ span


@pytest.mark.parametrize("traced_run", [False, True])
def test_span_adds_into_traced_or_not(traced_run):
    """``into`` gets each region's host seconds under the name's last part,
    summed over regions, with and without a profiler; the range appears only
    under one."""
    timers = {}

    def run():
        for _ in range(2):
            with profiling.span("bst.scene.paste", into=timers):
                time.sleep(0.01)

    if traced_run:
        _, rs = traced(run)
        assert [r[0] for r in rs] == ["bst.scene.paste"] * 2
    else:
        run()
    assert set(timers) == {"paste"} and timers["paste"] >= 0.02


@pytest.mark.parametrize("name", ["bst.predict_step", "bst.seggpt.attn", "bst.sync"])
def test_span_without_profiler_is_the_shared_null_context(name):
    """No profiler: every span is one shared do-nothing context (no range
    object is made), and so is every sync span, even for a CUDA device."""
    assert profiling.span(name) is profiling.span("bst.other")
    assert profiling.host_sync(torch.device("cuda")) is profiling.span(name)


@pytest.mark.parametrize("device, want", [("cpu", 0), ("cuda", 1)])
def test_host_sync_opens_only_for_the_card(device, want):
    """Under a profiler a sync span opens for a CUDA device only (the
    device need not exist to name it); a copy to the CPU waits for nothing."""
    def run():
        with profiling.host_sync(torch.device(device), np.zeros(3)):
            pass
        return profiling.tensor_from_host([1.0, 2.0], device="cpu")

    out, rs = traced(run)
    assert [r[0] for r in rs] == ["bst.sync"] * want
    assert out.tolist() == [1.0, 2.0]


def test_span_on_a_worker_thread_is_off():
    """The flag is the calling thread's: while a profiler collects on the
    main thread, a span on another thread is the do-nothing context."""
    got = []

    def run():
        t = threading.Thread(target=lambda: got.append(profiling.span("bst.worker")))
        t.start()
        t.join()
        got.append(profiling.span("bst.main"))

    traced(run)
    assert got[0] is profiling.span("bst.off") and got[1] is not got[0]


# ----------------------------------------------------------------- entry


@pytest.mark.parametrize("entry", ["predict_step", "predict_step_probs"])
def test_predict_ranges_nest(setup, entry):
    """One entry range holding inputs, the model and the decode, in that
    order; the model holds its embed, one attn and one mlp range a layer,
    and the decoder; nothing copies to a card on the CPU, so no sync."""
    cfg = setup[0]
    _, rs = traced(lambda: predict_call(setup, entry))
    (top,) = [r for r in rs if r[0] == f"bst.{entry}"]
    assert all(inside(r, top) for r in rs)
    assert children(rs, top, "bst.predict.") == ["bst.predict.inputs", "bst.predict.decode"]
    (model,) = [r for r in rs if r[0] == "bst.seggpt"]
    phases = [r for r in rs if r[0] in ("bst.predict.inputs", "bst.predict.decode")]
    assert phases[0][2] <= model[1] and model[2] <= phases[1][1]
    inner = children(rs, model, "bst.seggpt.")
    n = cfg.num_hidden_layers
    assert inner == ["bst.seggpt.embed"] + ["bst.seggpt.attn", "bst.seggpt.mlp"] * n + ["bst.seggpt.decoder"]
    attn = [r for r in rs if r[0] == "bst.seggpt.attn"]
    assert [children(rs, r, "bst.kernel.") for r in attn] == [["bst.kernel.attn_packed"]] * n  # head_dim 8
    assert not [r for r in rs if r[0] == profiling.SYNC]
    assert len({r[3] for r in rs}) == 1


def test_train_ranges_nest(setup):
    """One ``bst.train_step`` holding its six phases in order; the model's
    loss inside the model; the backward after the model."""
    cfg = setup[0]
    _, rs = traced(lambda: train_call(setup))
    (top,) = [r for r in rs if r[0] == "bst.train_step"]
    got = [r for r in rs if r[0] in TRAIN_PHASES and inside(r, top)]
    assert [r[0] for r in got] == list(TRAIN_PHASES)
    assert all(a[2] <= b[1] for a, b in zip(got, got[1:]))  # one after another, none overlapping
    (model,) = [r for r in rs if r[0] == "bst.seggpt"]
    assert children(rs, model, "bst.seggpt.").count("bst.seggpt.attn") == cfg.num_hidden_layers
    assert "bst.seggpt.loss" in children(rs, model, "bst.seggpt.")


def test_painter_window_ranges_nest():
    """A Painter forward (head_dim 64; blocks 0 and 2 in 3×3 windows that pad
    the 8×4 grid, block 1 global): a windowed block's ``bst.seggpt.attn``
    holds the layout, the windowed attention with #1's wrapper inside it,
    and the layout back; a global block's holds #1's wrapper alone."""
    cfg = tiny_config(hidden_size=128, num_attention_heads=2, num_hidden_layers=3, merge_index=0,
                      intermediate_hidden_state_indices=(2,), window_size=3, global_attn_indexes=(1,),
                      type_tokens=False)
    model = build_model(cfg, device="cpu", seed=3)
    x = [torch.zeros((1, cfg.image_size[1], cfg.image_size[1], 3)) for _ in range(3)]
    _, rs = traced(lambda: model(*x))
    attn = [r for r in rs if r[0] == "bst.seggpt.attn"]
    windowed = ["bst.seggpt.window", "bst.seggpt.attn_win", "bst.kernel.attn_qkv_rel", "bst.seggpt.window"]
    assert [children(rs, r, "bst.") for r in attn] == [windowed, ["bst.kernel.attn_qkv_rel"], windowed]
    for r in (r for r in rs if r[0] == "bst.seggpt.attn_win"):
        assert children(rs, r, "bst.") == ["bst.kernel.attn_qkv_rel"]


@pytest.mark.parametrize("entry", ["predict_step", "predict_step_probs", "train_step"])
def test_outputs_equal_with_and_without_profiler(setup, entry):
    def run():
        return train_call(setup) if entry == "train_step" else (predict_call(setup, entry),)

    plain = run()
    with_prof, _ = traced(run)
    for a, b in zip(plain, with_prof):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ feed


@pytest.mark.parametrize("n, depth", [(5, 2), (3, 1), (0, 2)])
def test_prefetch_waits_on_the_consumer_thread(n, depth):
    """One ``bst.data.wait`` a fetch from the queue, each item and the end,
    all on the consumer's thread (inside the consumer's own range)."""
    def run():
        with torch.profiler.record_function("consumer"):
            return list(prefetch_iterator(iter(range(n)), depth=depth))

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        items = run()
    assert items == list(range(n))
    (consumer,) = [e for e in prof.events() if e.name == "consumer"]
    waits = [e for e in prof.events() if e.name == "bst.data.wait"]
    assert len(waits) == n + 1
    assert all(e.thread == consumer.thread for e in waits)
