"""The port's PromptTuner.predict_step against the JAX package's on a tiny
fp32 model (built as tests/test_train_core.py builds its tuner), and the
device rule of the port's entry points."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beach_seg_tpu.config import BeachSegConfig as JConf
from beach_seg_tpu.models.seggpt import convert as jconvert
from beach_seg_tpu.models.seggpt.config import tiny_config as jtiny_config
from beach_seg_tpu.models.seggpt.model import SegGPT as JSegGPT
from beach_seg_tpu.train.prompt_tuner import PromptTuner as JTuner
from beach_seg_tpu_torch.config import BeachSegConfig
from beach_seg_tpu_torch.models.seggpt import build_model, from_jax_params, load_npz, tiny_config
from beach_seg_tpu_torch.train import PromptTuner


@pytest.fixture(scope="module")
def tuners():
    over = dict(drop_path_rate=0.0, initializer_range=0.2)
    jcfg = jtiny_config(**over)
    h = jcfg.image_size[0] // 2
    assert h == jcfg.image_size[1]  # inpt_size = the canvas half makes the center crop the identity
    jmodel = JSegGPT(jcfg)
    zeros = jnp.zeros((1, h, h, 3))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), zeros, zeros, zeros)["params"]
    n_prompts = 4
    jtuner = JTuner(model=jmodel, conf=JConf(crop_size=h // 2, inpt_size=h, batch_size=4), num_prompts=n_prompts, steps_per_epoch=1)
    model = build_model(tiny_config(**over), device="cpu", state=from_jax_params(params, device="cpu"))
    tuner = PromptTuner(model, BeachSegConfig(crop_size=h // 2, inpt_size=h, batch_size=4), device="cpu")
    rng = np.random.default_rng(0)
    prompts = (
        rng.random((n_prompts, h, h, 3)).astype(np.float32),
        rng.integers(0, 4, (n_prompts, h, h)).astype(np.int32),
        np.zeros((n_prompts, h, h), bool),
    )
    return jtuner, params, tuner, prompts, h


def _batches(h):
    rng = np.random.default_rng(1)
    crop_idx = rng.integers(0, 4, (4,)).astype(np.int32)
    return {
        # raw uint8 crops at half the canvas: device PIL resize, then back
        "u8_resized": ({"image_u8": rng.integers(0, 256, (4, h // 2, h // 2, 3), dtype=np.uint8), "crop_idx": crop_idx}, h // 2),
        # raw uint8 crops at the canvas size: no resize, int32 ids
        "u8_native": ({"image_u8": rng.integers(0, 256, (4, h, h, 3), dtype=np.uint8), "crop_idx": crop_idx}, None),
        # the classic float flavor through eval_augment
        "image": ({
            "image": rng.random((4, h, h, 3)).astype(np.float32),
            "mask": rng.integers(0, 4, (4, h, h)).astype(np.int32),
            "nodata": np.zeros((4, h, h), bool),
            "crop_idx": crop_idx,
        }, None),
    }


@pytest.mark.parametrize("flavor", ["u8_resized", "u8_native", "image"])
def test_predict_step_ids_match_jax(tuners, flavor):
    """Ids equal the JAX predict step's. The decode is an argmax over palette
    distances; pred_masks agree within ~1e-6 here, so only a pixel within
    that distance of a decision boundary could flip: none does on these
    inputs, and the bar is exact equality."""
    jtuner, params, tuner, (pixels, masks, nodata), h = tuners
    batch, out_size = _batches(h)[flavor]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = np.asarray(
        jtuner.predict_step(jnp.asarray(pixels), params, jnp.asarray(masks), jnp.asarray(nodata), jbatch, None, True, out_size)
    )
    got = tuner.predict_step(pixels, masks, nodata, batch, out_size=out_size).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert len(np.unique(want)) > 1  # the comparison is not between constant maps
    np.testing.assert_array_equal(got, want)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_device(no_cuda, tuners, tmp_path):
    """With CUDA absent, the builder, the weight loaders and the predict step
    raise unless the caller asks for the CPU; with device="cpu" they run."""
    jtuner, params, tuner, (pixels, masks, nodata), h = tuners
    cfg = tiny_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax_params(params)
    jconvert.save_params(params, tmp_path / "p.npz")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_npz(tmp_path / "p.npz")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PromptTuner(tuner.model, tuner.conf)
    model = build_model(cfg, device="cpu", state=load_npz(tmp_path / "p.npz", device="cpu"))
    assert next(model.parameters()).device.type == "cpu"
    cpu_tuner = PromptTuner(tuner.model, tuner.conf, device="cpu")
    batch, out_size = _batches(h)["u8_resized"]
    ids = cpu_tuner.predict_step(pixels, masks, nodata, batch, out_size=out_size)
    assert ids.dtype == torch.uint8 and tuple(ids.shape) == (4, h // 2, h // 2)
