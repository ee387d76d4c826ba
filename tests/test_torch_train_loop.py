"""The port's training runtime (beach_seg_tpu_torch.train.loop.run_training)
against the JAX package's on the synthetic scene, and the port alone through
the cases of tests/test_train_loop.py; with the runtime's parts: the loggers'
grid, StepTimer, maybe_trace, the dotenv loader, debug_nans and remat.

Both packages load one weight file written by the JAX package's save_params:
a tiny model (head_dim 8, 3 layers) with its topology stored, drop-path off
and initializer_range 0.2 (at 0.02 a random tiny ViT barely depends on its
input, tests/torch_train_common.py). The augmentations are the identity, so
the only random numbers are the palettes and prompt indices; the port is
handed the ones JAX's key chain gives (one split per train step, then one per
eval batch, loop.py:172, 195) by patching PromptTuner.step_draws and the
eval palette draw, in the test only."""

import csv
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from beach_seg_tpu.config import BeachSegConfig as JConf
from beach_seg_tpu.models.seggpt import convert as jconvert
from beach_seg_tpu.models.seggpt.config import tiny_config as jtiny_config
from beach_seg_tpu.models.seggpt.load import init_random
from beach_seg_tpu.models.seggpt.model import SegGPT as JSegGPT
from beach_seg_tpu.train import checkpoint as jckpt
from beach_seg_tpu.train import loggers as jloggers
from beach_seg_tpu.train.loop import run_training as jrun_training
from beach_seg_tpu.train.prompt_tuner import PromptTuner as JTuner
from beach_seg_tpu.transforms.palette import random_palette as jrandom_palette
from beach_seg_tpu.utils import env as jenv
from beach_seg_tpu.utils import profiling as jprofiling
from beach_seg_tpu.utils.confix import load_yaml as jload_yaml
from beach_seg_tpu_torch.config import BeachSegConfig, PredictionConfig
from beach_seg_tpu_torch.data.dataset import create_scene, materialize_prompts
from beach_seg_tpu_torch.infer.predict import run_predict
from beach_seg_tpu_torch.models.seggpt import build_model, tiny_config
from beach_seg_tpu_torch.train import checkpoint as pckpt
from beach_seg_tpu_torch.train import loggers as ploggers
from beach_seg_tpu_torch.train import loop as ploop
from beach_seg_tpu_torch.train import prompt_tuner as pprompt_tuner
from beach_seg_tpu_torch.train.loop import model_for_config, run_training
from beach_seg_tpu_torch.train.prompt_tuner import PromptTuner
from beach_seg_tpu_torch.utils import env as penv
from beach_seg_tpu_torch.utils import profiling as pprofiling
from beach_seg_tpu_torch.utils.confix import load_yaml
from tests.synthetic_scene import build_scene
from tests.torch_train_common import IDENTITY_AUG, assert_states_close, one_torch_thread, step_draws  # noqa: F401

# the tiny model of the weight file: head_dim 8, 3 layers, a 128×64 canvas
MODEL = dict(image_size=(128, 64), num_hidden_layers=3, merge_index=1, intermediate_hidden_state_indices=(1, 2),
             initializer_range=0.2, drop_path_rate=0.0)
# workers=0: batches assembled on the calling thread; a pool of cpu_count
# threads a run (each resize a threaded BLAS call) oversubscribes a host that
# runs several test processes
RUN = dict(crop_size=32, inpt_size=64, batch_size=2, epochs=2, mesh_data=1, mesh_model=1, log_every_n_steps=1,
           num_viz_images=2, warmup_epochs=0, workers=0, **IDENTITY_AUG)
# the tolerances of the JAX comparison (fp32 on both sides): lr is the same
# fp32 schedule formula, held to 1e-7 relative; the losses come out of
# 3 layers of fp32 products summed in other orders, held to 1e-5 relative
# (GRAD_TOL_DEFAULT's bar for this loss); the prompt state to
# assert_states_close's bounds at the gradients' 1e-5
LR_REL = 1e-7
LOSS_REL = 1e-5
STATE_REL = 1e-5


class KeyChain:
    """JAX's run_training key: PRNGKey(seed), split once per train step and
    once per eval batch."""

    def __init__(self, seed: int):
        self.key = random.PRNGKey(seed)

    def next(self):
        self.key, sub = random.split(self.key)
        return sub


def run_both(kw: dict, model: dict) -> dict:
    """JAX's run_training on ``kw`` with the weight file ``kw["checkpoint"]``
    (written here: JAX's init_random of ``tiny_config(**model)``, with its
    topology), then the port's on the CPU with JAX's draws → both run dirs,
    the port's prompt gradients (recorded per step) and the seconds of each."""
    cfg = jtiny_config(**model)
    params = jax.tree.map(np.asarray, init_random(JSegGPT(cfg), cfg))
    jconvert.save_params(params, kw["checkpoint"], cfg)
    jconf = JConf(**kw)
    t = time.perf_counter()
    jax_dir = jrun_training(jconf)
    jax_s = time.perf_counter() - t

    chain, grads = KeyChain(jconf.seed), []
    step_draws_orig, loss_and_grad_orig = PromptTuner.step_draws, PromptTuner.loss_and_grad

    def draws_from_jax(self, batch, n_prompts, generator, draws=None):
        b = batch["mask"].shape[0]
        return step_draws_orig(self, batch, n_prompts, generator, step_draws(chain.next(), self.num_classes, b, n_prompts))

    def palette_from_jax(generator, num_classes, b):
        return torch.from_numpy(np.array(jrandom_palette(chain.next(), num_classes, b)))

    def record(self, *args, **kwargs):
        out = loss_and_grad_orig(self, *args, **kwargs)
        grads.append({"grad": out[1].numpy().copy()})
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PromptTuner, "step_draws", draws_from_jax)
        mp.setattr(pprompt_tuner, "random_palette", palette_from_jax)
        mp.setattr(PromptTuner, "loss_and_grad", record)
        t = time.perf_counter()
        port_dir = run_training(BeachSegConfig(**kw), device="cpu")
        port_s = time.perf_counter() - t
    return {"kw": kw, "cfg": cfg, "jax": jax_dir, "port": port_dir, "grads": grads, "seconds": (jax_s, port_s)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The scene, the weight file, JAX's run and the port's run with JAX's
    draws (and the port's prompt gradients, recorded per step)."""
    root = tmp_path_factory.mktemp("train_loop")
    scene = build_scene(root / "scene")
    kw = dict(RUN, data=scene, model_training_root=root / "runs", checkpoint=str(root / "weights.npz"))
    return {"root": root, "scene": scene, **run_both(kw, MODEL)}


def _csv(run_dir) -> list[dict]:
    with open(run_dir / "metrics.csv") as f:
        return list(csv.DictReader(f))


def _npz(path) -> dict:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


# ----------------------------------------------------- against JAX's run


def test_prompt_batch_is_bit_equal_to_jax(world):
    want, got = _npz(world["jax"] / "prompt_batch.npz"), _npz(world["port"] / "prompt_batch.npz")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype


def test_conf_yaml_and_classes_match_jax(world):
    for loader, cls in ((jload_yaml, JConf), (load_yaml, BeachSegConfig)):
        assert loader(cls, world["port"] / "conf.yaml") == loader(cls, world["jax"] / "conf.yaml")
    assert (world["port"] / "classes.txt").read_text() == (world["jax"] / "classes.txt").read_text()


def assert_metrics_match_jax(run: dict) -> None:
    """The same rows and columns (but perf/), lr to LR_REL, the losses to
    LOSS_REL, the F1 scores equal: 3 steps an epoch, 2 epochs, one val/loss
    an epoch."""
    want, got = _csv(run["jax"]), _csv(run["port"])
    assert [r["step"] for r in got] == [r["step"] for r in want]
    cols = [c for c in want[0] if not c.startswith("perf/")]
    assert [c for c in got[0] if not c.startswith("perf/")] == cols
    n_loss = 0
    for w, g in zip(want, got):
        assert [c for c in cols if w[c]] == [c for c in cols if g[c]]
        for c in cols:
            if not w[c] or c == "step":
                continue
            a, b = float(w[c]), float(g[c])
            if c == "lr":
                assert abs(b - a) <= LR_REL * abs(a), (w["step"], c, a, b)
            elif c.endswith("loss"):
                assert abs(b - a) <= LOSS_REL * abs(a), (w["step"], c, a, b)
                n_loss += 1
            else:
                assert b == a, (w["step"], c, a, b)
    assert n_loss == 6 + 2


def test_metrics_csv_matches_jax(world):
    assert_metrics_match_jax(world)


def test_checkpoints_and_best_match_jax(world):
    names = lambda d: sorted(p.name for p in (d / "checkpoints").iterdir())  # noqa: E731
    assert names(world["port"]) == names(world["jax"]) == ["step_3", "step_6"]
    best = lambda d: json.loads((d / "best.json").read_text())  # noqa: E731
    assert best(world["port"])["epoch"] == best(world["jax"])["epoch"]
    assert best(world["port"])["val/f1"] == pytest.approx(best(world["jax"])["val/f1"], abs=0)


def assert_tuned_state_matches_jax(run: dict, model: dict) -> None:
    """The final checkpoint of each run (JAX's through Orbax): moments within
    STATE_REL of their scale, tuned and EMA pixels within what Adam can make
    of that (assert_states_close); the exports equal the checkpoints."""
    jconf = JConf(**run["kw"])
    prompts = materialize_prompts(create_scene(BeachSegConfig(**run["kw"]), train=True), BeachSegConfig(**run["kw"]))
    jtuner = JTuner(model=None, conf=jconf, num_prompts=len(prompts["pixels"]), steps_per_epoch=3)
    jstate = jckpt.restore_state(jckpt.latest_checkpoint(run["jax"]), jax.device_get(jtuner.init_state(jnp.asarray(prompts["pixels"]))))
    tuner = PromptTuner(build_model(tiny_config(**model), device="cpu"), BeachSegConfig(**run["kw"]), device="cpu",
                        steps_per_epoch=3)
    state = pckpt.restore_state(pckpt.latest_checkpoint(run["port"]), tuner.init_state(prompts["pixels"]))
    assert len(run["grads"]) == state.step == 6
    lr = max(float(r["lr"]) for r in _csv(run["port"]) if r["lr"])
    assert_states_close(jstate, state, STATE_REL, run["grads"], lr)
    for name, pixels in (("prompt_batch_tuned.npz", state.prompt_pixels), ("prompt_batch_ema.npz", state.ema_pixels)):
        np.testing.assert_array_equal(_npz(run["port"] / name)["image"], pixels.numpy())


def test_tuned_state_matches_jax(world):
    assert_tuned_state_matches_jax(world, MODEL)


def test_port_run_dir_reads_in_jax(world):
    conf = jload_yaml(JConf, world["port"] / "conf.yaml")
    assert conf.crop_size == 32 and conf.epochs == 2 and conf.checkpoint == world["kw"]["checkpoint"]
    for name in ("prompt_batch.npz", "prompt_batch_tuned.npz", "prompt_batch_ema.npz", "prompt_batch_best.npz"):
        pb = jckpt.load_prompt_batch(world["port"] / name)
        assert pb["image"].shape == (5, 64, 64, 3) and pb["image"].dtype == np.float32
        assert list(pb["date"]) == ["20230301"] * 5


# -------------------------------------- tests/test_train_loop.py, ported


def test_run_dir_artifacts(world):
    rd, jd = world["port"], world["jax"]
    assert sorted(p.name for p in rd.iterdir()) == sorted(p.name for p in jd.iterdir() if p.name != "profile")
    conf = load_yaml(BeachSegConfig, rd / "conf.yaml")
    assert (rd / "classes.txt").read_text().splitlines() == list(conf.classes)
    assert (rd / "log.log").stat().st_size > 0
    assert any((rd / "tb").iterdir())
    assert conf.crop_size == 32 and conf.epochs == 2


def test_metrics_recorded(world):
    text = (world["port"] / "metrics.csv").read_text()
    for key in ("train/loss", "train/f1", "val/f1", "val/loss", "lr", "perf/steps_per_sec"):
        assert key in text
    losses = [float(r["train/loss"]) for r in _csv(world["port"]) if r["train/loss"]]
    assert len(losses) == 6 and np.isfinite(losses).all()


def test_prompts_were_tuned(world):
    pre = _npz(world["port"] / "prompt_batch.npz")
    post = _npz(world["port"] / "prompt_batch_tuned.npz")
    assert pre["image"].shape == post["image"].shape
    assert not np.allclose(pre["image"], post["image"])
    np.testing.assert_array_equal(pre["mask"], post["mask"])


def test_ema_export(world):
    """The EMA lags the tuned pixels toward the initial ones (alpha 0.99 a
    step)."""
    pre, ema, tuned = (_npz(world["port"] / f"prompt_batch{s}.npz") for s in ("", "_ema", "_tuned"))
    assert np.isfinite(ema["image"]).all()
    assert not np.allclose(ema["image"], tuned["image"])
    assert np.abs(ema["image"] - pre["image"]).mean() < np.abs(tuned["image"] - pre["image"]).mean()
    np.testing.assert_array_equal(ema["mask"], tuned["mask"])


def test_checkpoint_restore(world):
    conf = load_yaml(BeachSegConfig, world["port"] / "conf.yaml")
    prompts = materialize_prompts(create_scene(conf, train=True), conf)
    model, _ = model_for_config(conf, "cpu")
    tuner = PromptTuner(model, conf, device="cpu")
    state = pckpt.restore_state(pckpt.latest_checkpoint(world["port"]), tuner.init_state(prompts["pixels"]))
    assert state.step == 6 and state.opt_state["count"] == 6
    np.testing.assert_array_equal(state.prompt_pixels.numpy(), _npz(world["port"] / "prompt_batch_tuned.npz")["image"])


def test_epochs_compat_trains_5x(world, tmp_path):
    conf = BeachSegConfig(**dict(world["kw"], epochs=1, num_viz_images=0, model_training_root=tmp_path), epochs_compat=True)
    rd = run_training(conf, device="cpu")
    steps = sorted(int(p.name.split("_")[1]) for p in (rd / "checkpoints").iterdir())
    assert steps == [3, 6, 9, 12, 15]


def test_predict_from_ema_export(world, tmp_path):
    pred_conf = PredictionConfig(data=world["scene"], train_run_dir=world["port"], use_ema=True, batch_size=2,
                                 checkpoint=world["kw"]["checkpoint"], mesh_data=1, mesh_model=1,
                                 prediction_root=tmp_path)
    out = run_predict(pred_conf, device="cpu")
    assert len(list((out / "tif").iterdir())) == 2


def test_best_tracks_the_monitored_metric(world, tmp_path):
    """monitor_metric val/loss in min mode: best.json names the epoch of the
    lowest val/loss in metrics.csv, and prompt_batch_best.npz holds it."""
    conf = BeachSegConfig(**dict(world["kw"], num_viz_images=0, model_training_root=tmp_path), monitor_metric="val/loss",
                          monitor_mode="min")
    rd = run_training(conf, device="cpu")
    val = [float(r["val/loss"]) for r in _csv(rd) if r["val/loss"]]
    best = json.loads((rd / "best.json").read_text())
    assert best["epoch"] == int(np.argmin(val)) and best["val/loss"] == pytest.approx(min(val), rel=1e-12)
    assert (rd / "prompt_batch_best.npz").exists()


# ------------------------------------------------------------ device rule


def test_run_training_needs_cuda_unless_asked_for_the_cpu(world, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training(BeachSegConfig(**dict(world["kw"], model_training_root=tmp_path / "none")))
    assert not (tmp_path / "none").exists()  # it raised before it wrote anything
    with pytest.raises(ValueError, match="must cover the 1 ranks"):
        run_training(BeachSegConfig(**dict(world["kw"], model_training_root=tmp_path / "none", mesh_data=2)), device="cpu")


def test_resume_without_a_checkpoint_raises(world, tmp_path):
    conf = BeachSegConfig(**dict(world["kw"], model_training_root=tmp_path), resume_from=tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        run_training(conf, device="cpu")


# ------------------------------------------------------------ debug_nans


def _nan_prompt(monkeypatch):
    def materialize(scene, conf):
        prompts = materialize_prompts(scene, conf)
        prompts["pixels"][0, 3, 5, 1] = np.nan
        return prompts

    monkeypatch.setattr(ploop, "materialize_prompts", materialize)


def test_debug_nans_raises_on_a_nan_prompt_pixel(world, tmp_path, monkeypatch):
    _nan_prompt(monkeypatch)
    conf = BeachSegConfig(**dict(world["kw"], epochs=1, model_training_root=tmp_path), debug_nans=True)
    with pytest.raises(FloatingPointError, match="train step 0"):
        run_training(conf, device="cpu")


def test_without_debug_nans_a_nan_trains_on(world, tmp_path, monkeypatch):
    _nan_prompt(monkeypatch)
    rd = run_training(BeachSegConfig(**dict(world["kw"], epochs=1, model_training_root=tmp_path)), device="cpu")
    assert not np.isfinite(_npz(rd / "prompt_batch_tuned.npz")["image"]).all()


def test_debug_nans_changes_nothing_without_a_nan(world, tmp_path):
    runs = [run_training(BeachSegConfig(**dict(world["kw"], epochs=1, num_viz_images=0, model_training_root=tmp_path / str(flag)),
                                        debug_nans=flag), device="cpu") for flag in (False, True)]
    for name in ("prompt_batch_tuned.npz", "prompt_batch_ema.npz"):
        np.testing.assert_array_equal(_npz(runs[0] / name)["image"], _npz(runs[1] / name)["image"])
    strip = lambda rows: [{k: v for k, v in r.items() if not k.startswith("perf/")} for r in rows]  # noqa: E731
    assert strip(_csv(runs[0])) == strip(_csv(runs[1]))


# --------------------------------------------------------------- remat


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_remat_gives_the_same_prompt_gradient(dtype):
    """One train step's prompt gradient with each encoder block recomputed in
    the backward equals the one without, bit for bit, with drop-path on
    (the masks are passed in, so the recompute sees the same ones)."""
    cfg = tiny_config(**dict(MODEL, drop_path_rate=0.5))
    conf = BeachSegConfig(crop_size=32, inpt_size=64, batch_size=2)
    rng = np.random.default_rng(0)
    pixels = rng.random((3, 64, 64, 3)).astype(np.float32)
    masks, nodata = rng.integers(0, 4, (3, 64, 64)).astype(np.int32), rng.random((3, 64, 64)) < 0.1
    batch = {"image": rng.random((2, 64, 64, 3)).astype(np.float32), "mask": rng.integers(0, 4, (2, 64, 64)).astype(np.int32),
             "nodata": np.zeros((2, 64, 64), bool), "crop_idx": np.array([0, 2], np.int32)}
    grads = []
    for remat in (False, True):
        model = build_model(cfg, dtype, device="cpu", remat=remat)
        assert model.encoder.remat is remat
        tuner = PromptTuner(model, dataclasses.replace(conf, remat=remat), device="cpu")
        draws = tuner.step_draws(batch, 3, torch.Generator().manual_seed(3))
        assert any(m is not None and not bool(m.all()) for pair in draws["drop_masks"] for m in pair)  # some rows dropped
        calls, block = [], model.encoder.layers_1
        forward = block.forward
        block.forward = lambda *a, **k: calls.append(1) or forward(*a, **k)
        loss, grad, *_ = tuner.loss_and_grad(torch.from_numpy(pixels), masks, nodata, batch, draws)
        assert len(calls) == (2 if remat else 1)  # under remat the backward ran the block's forward again
        grads.append((loss, grad))
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1]) and grads[0][1].abs().max() > 0


def test_model_for_config_passes_remat():
    conf = BeachSegConfig(debug=True, remat=True)
    assert model_for_config(conf, "meta")[0].encoder.remat
    assert not model_for_config(dataclasses.replace(conf, remat=False), "meta")[0].encoder.remat


# ------------------------------------------------- loggers, timer, tracing


def test_example_grid_is_bit_equal_to_jax():
    rng = np.random.default_rng(4)
    args = (rng.random((3, 40, 40, 3)).astype(np.float32), rng.integers(0, 4, (3, 40, 40)), rng.integers(0, 4, (3, 40, 40)),
            rng.random((3, 40, 40, 3)).astype(np.float32), ("nodata", "sand", "water", "veg"), 56)
    want, got = jloggers.example_grid(*args), ploggers.example_grid(*args)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape == (3 * 56, 4 * 56, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ploggers.draw_class_overlay(args[0][0], args[1][0], args[4]),
                                  jloggers.draw_class_overlay(args[0][0], args[1][0], args[4]))


def test_metrics_logger_writes_the_jax_csv(tmp_path):
    for mod, sub in ((jloggers, "jax"), (ploggers, "port")):
        mlog = mod.MetricsLogger(tmp_path / sub)
        mlog.log_scalars({"train/loss": 0.5, "lr": 1e-3}, 0)
        mlog.log_scalars({"val/f1": 0.25}, 1)
        mlog.log_image("val_images", np.zeros((4, 4, 3), np.float32), 0)
        mlog.close()
    assert (tmp_path / "port" / "metrics.csv").read_text() == (tmp_path / "jax" / "metrics.csv").read_text()
    assert any((tmp_path / "port" / "tb").iterdir())


def test_metrics_logger_without_tensorboardx_logs_csv_only(tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_tbx(name, *args, **kwargs):
        if name.startswith("tensorboardX"):
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tbx)
    mlog = ploggers.MetricsLogger(tmp_path)
    assert mlog.tb is None and mlog.kind == "csv"
    mlog.log_scalars({"train/loss": 1.0}, 0)
    mlog.log_image("val_images", np.zeros((4, 4, 3), np.uint8), 0)
    mlog.close()
    assert (tmp_path / "metrics.csv").read_text().splitlines() == ["step,train/loss", "0,1.0"]
    assert not (tmp_path / "tb").exists()


def test_step_timer_matches_jax(monkeypatch):
    """Fed the same clock, both timers discard the same warm-up and give the
    same rate."""
    clock = iter(np.arange(100, dtype=float) * 0.25)
    ticks = []
    for mod in (jprofiling, pprofiling):
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        timer = mod.StepTimer(warmup=2)
        seen = []
        for _ in range(5):
            timer.tick()
            seen.append(timer.steps_per_sec)
        ticks.append(seen)
    assert ticks[0][:2] == ticks[1][:2] == [None, None]
    assert ticks[1][2:] == pytest.approx([1 / 0.25] * 3) and ticks[0][2:] == pytest.approx([1 / 0.25] * 3)


def test_maybe_trace_writes_a_trace_on_the_cpu(tmp_path):
    with pprofiling.maybe_trace(True, tmp_path):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "profile" / pprofiling.TRACE_NAME).read_text())
    assert any("mm" in ev.get("name", "") for ev in trace["traceEvents"])
    with pprofiling.maybe_trace(False, tmp_path / "off"):
        pass
    assert not (tmp_path / "off").exists()


def test_dotenv_matches_jax(tmp_path, monkeypatch):
    (tmp_path / ".env").write_text("# comment\nBST_A=1\nBST_B = 'two'\nnot a pair\nBST_C=\"x=y\"\n")
    (tmp_path / "sub").mkdir()
    assert penv.find_dotenv(tmp_path / "sub") == jenv.find_dotenv(tmp_path / "sub") == tmp_path / ".env"
    assert penv.find_dotenv(tmp_path / "sub", name="absent.env") is None
    for key in ("BST_A", "BST_B", "BST_C"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("BST_A", "kept")
    assert penv.load_dotenv(tmp_path / ".env")
    import os

    assert (os.environ["BST_A"], os.environ["BST_B"], os.environ["BST_C"]) == ("kept", "two", "x=y")
    assert penv.load_dotenv(tmp_path / ".env", override=True) and os.environ["BST_A"] == "1"
    assert not penv.load_dotenv(tmp_path / "missing.env")
