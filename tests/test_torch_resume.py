"""The port's resume after preemption (tests/test_resume.py, ported): a
second run continues from the first run's state checkpoint; with the same
draws it ends where one uninterrupted run ends. And the checkpoint format
itself: written whole or not at all, restored onto the template's devices
and dtypes, refused where it does not fit."""

import dataclasses

import numpy as np
import pytest
import torch

from beach_seg_tpu_torch.config import BeachSegConfig
from beach_seg_tpu_torch.models.seggpt import build_model, save_params, tiny_config
from beach_seg_tpu_torch.train import checkpoint as pckpt
from beach_seg_tpu_torch.train.checkpoint import latest_checkpoint, load_prompt_batch, restore_state, save_state
from beach_seg_tpu_torch.train.loop import run_training
from beach_seg_tpu_torch.train.prompt_tuner import PromptState, PromptTuner
from tests.synthetic_scene import build_scene
from tests.torch_train_common import IDENTITY_AUG, one_torch_thread  # noqa: F401

# a resumed run and an uninterrupted one run the same fp32 arithmetic on the
# same state, so their final states may differ by no more than the CPU
# products' last bits (measured: equal)
RESUME_REL = 1e-6


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """The scene and a tiny model (initializer_range 0.2, drop-path off) in a
    weight file that stores its topology."""
    root = tmp_path_factory.mktemp("resume")
    cfg = tiny_config(image_size=(128, 64), num_hidden_layers=3, merge_index=1, intermediate_hidden_state_indices=(1, 2),
                      initializer_range=0.2, drop_path_rate=0.0)
    save_params(build_model(cfg, device="cpu").state_dict(), root / "weights.npz", cfg)
    return dict(data=build_scene(root / "scene"), model_training_root=root / "runs", crop_size=32, inpt_size=64,
                batch_size=2, checkpoint=str(root / "weights.npz"), num_viz_images=0, mesh_data=1, mesh_model=1,
                warmup_epochs=0, log_every_n_steps=1, workers=0, **IDENTITY_AUG)


def test_resume_continues_training(base):
    rd1 = run_training(BeachSegConfig(epochs=1, **base), device="cpu")
    pixels_e1 = load_prompt_batch(rd1 / "prompt_batch_tuned.npz")["image"]
    rd2 = run_training(BeachSegConfig(epochs=2, resume_from=rd1, **base), device="cpu")
    assert rd2 != rd1
    pixels_e2 = load_prompt_batch(rd2 / "prompt_batch_tuned.npz")["image"]
    assert not np.allclose(pixels_e1, pixels_e2)  # trained further
    steps = [line.split(",")[0] for line in (rd2 / "metrics.csv").read_text().splitlines()[1:]]
    assert steps[0] == "3" and "val/f1" in (rd2 / "metrics.csv").read_text()  # logs from epoch 1 on
    assert sorted(p.name for p in (rd2 / "checkpoints").iterdir()) == ["step_6"]


def test_resumed_run_ends_where_an_uninterrupted_one_ends(base, monkeypatch):
    """Draws keyed by the state's step (the run's own generator restarts
    from the seed on resume, as JAX's key does): 1 epoch + a resume to 3
    against 3 epochs in one run."""
    train_step = PromptTuner.train_step

    def keyed(self, state, masks, nodata, batch, generator=None, draws=None):
        gen = torch.Generator().manual_seed(1000 + state.step)
        return train_step(self, state, masks, nodata, batch, generator=gen)

    monkeypatch.setattr(PromptTuner, "train_step", keyed)
    whole = run_training(BeachSegConfig(epochs=3, **base), device="cpu")
    first = run_training(BeachSegConfig(epochs=1, **base), device="cpu")
    rest = run_training(BeachSegConfig(epochs=3, resume_from=first, **base), device="cpu")
    for name in ("prompt_batch_tuned.npz", "prompt_batch_ema.npz"):
        want, got = load_prompt_batch(whole / name)["image"], load_prompt_batch(rest / name)["image"]
        assert np.abs(got - want).max() <= RESUME_REL * np.abs(want).max(), name
    assert not np.allclose(load_prompt_batch(first / "prompt_batch_tuned.npz")["image"],
                           load_prompt_batch(whole / "prompt_batch_tuned.npz")["image"])
    conf = BeachSegConfig(epochs=3, **base)
    tuner = PromptTuner(build_model(tiny_config(), device="cpu"), conf, device="cpu")
    template = tuner.init_state(np.zeros((5, 64, 64, 3), np.float32))
    a, b = (restore_state(latest_checkpoint(d), template) for d in (whole, rest))
    assert a.step == b.step == 9 and a.opt_state["count"] == b.opt_state["count"] == 9
    for k in ("mu", "nu"):
        assert torch.abs(a.opt_state[k] - b.opt_state[k]).max() <= RESUME_REL * a.opt_state[k].abs().max()


def _state(seed: int = 0, accum: bool = False) -> PromptState:
    g = torch.Generator().manual_seed(seed)
    px = torch.rand((3, 8, 8, 3), generator=g)
    opt = {"mu": torch.rand(px.shape, generator=g), "nu": torch.rand(px.shape, generator=g), "count": 7}
    if accum:
        opt.update(acc=torch.rand(px.shape, generator=g), mini_step=1)
    return PromptState(px, px * 0.5, opt, 7)


@pytest.mark.parametrize("accum", [False, True])
def test_state_round_trips(tmp_path, accum):
    state = _state(accum=accum)
    path = save_state(tmp_path, state)
    assert path == tmp_path / "checkpoints" / "step_7" and latest_checkpoint(tmp_path) == path
    template = dataclasses.replace(_state(1, accum), step=0)
    got = restore_state(path, template)
    assert got.step == 7 and got.opt_state["count"] == 7
    for a, b in ((got.prompt_pixels, state.prompt_pixels), (got.ema_pixels, state.ema_pixels),
                 *((got.opt_state[k], state.opt_state[k]) for k in state.opt_state if k not in ("count", "mini_step"))):
        assert torch.equal(a, b)
    if accum:
        assert got.opt_state["mini_step"] == 1


def test_restore_takes_the_templates_dtype_and_refuses_a_misfit(tmp_path):
    path = save_state(tmp_path, _state())
    template = _state(1)
    template.prompt_pixels = template.prompt_pixels.double()
    assert restore_state(path, template).prompt_pixels.dtype == torch.float64
    small = _state(1)
    small.prompt_pixels = small.prompt_pixels[:2]
    with pytest.raises(ValueError, match="prompt_pixels"):
        restore_state(path, small)
    with pytest.raises(ValueError, match="opt_state"):
        restore_state(path, _state(1, accum=True))


def test_a_write_cut_short_leaves_no_checkpoint(tmp_path, monkeypatch):
    def cut(obj, f):
        open(f, "wb").write(b"half")
        raise KeyboardInterrupt

    monkeypatch.setattr(pckpt.torch, "save", cut)
    with pytest.raises(KeyboardInterrupt):
        save_state(tmp_path, _state())
    assert latest_checkpoint(tmp_path) is None
    assert list((tmp_path / "checkpoints").iterdir()) == []


def test_an_existing_checkpoint_is_not_overwritten(tmp_path):
    save_state(tmp_path, _state(0))
    with pytest.raises(OSError):
        save_state(tmp_path, _state(1))
    got = restore_state(latest_checkpoint(tmp_path), _state(2))
    assert torch.equal(got.prompt_pixels, _state(0).prompt_pixels)
    assert [p.name for p in (tmp_path / "checkpoints").iterdir()] == ["step_7"]
