"""BASELINE.json config #5 on the CPU: multi-class coastal segmentation on an
8-band SuperDove scene with the larger backbone (``backbone="huge"``), the
port against the JAX package on tests/synthetic_scene.build_scene_8band.

- ``create_scene``: the display mosaics (8 bands → ``broad_band``) of the
  reference date (train) and of the predict dates, bit-equal;
- ``run_zero_shot`` on the debug topology (head ×3000, as
  tests/test_torch_zero_shot.py): GeoTIFFs and mask PNGs bit-equal;
- ``run_training`` with ``backbone="huge"`` and a stored 3-layer topology at
  ViT-H's head_dim 80 (C=160, 2 heads) on tests/test_torch_train_loop.py's
  128×64 canvas, the port handed JAX's draws as that file does: lr, losses
  and the tuned state within its LR_REL / LOSS_REL / STATE_REL;
- ``run_predict`` from JAX's EMA export of that run, ``backbone="huge"``:
  GeoTIFFs and mask PNGs bit-equal.

On the card, chip_smoke.py's phase 21 drives the same path at full width."""

import numpy as np
import pytest
from PIL import Image

from beach_seg_tpu.config import BeachSegConfig as JConf
from beach_seg_tpu.config import PredConfig as JPredConf
from beach_seg_tpu.config import PredictionConfig as JPredictionConf
from beach_seg_tpu.data.dataset import create_scene as jcreate_scene
from beach_seg_tpu.geo.tiff import read
from beach_seg_tpu.infer import zero_shot as jzero_shot
from beach_seg_tpu.infer.predict import run_predict as jrun_predict
from beach_seg_tpu_torch.config import BeachSegConfig, PredConfig, PredictionConfig
from beach_seg_tpu_torch.data.dataset import create_scene
from beach_seg_tpu_torch.infer import run_predict, run_zero_shot
from beach_seg_tpu_torch.infer.predict import resolve_config
from beach_seg_tpu_torch.train.loop import config_for
from tests.synthetic_scene import MASK_DATE, OTHER_DATES, build_scene_8band
from tests.test_torch_train_loop import MODEL, RUN, assert_metrics_match_jax, assert_tuned_state_matches_jax, run_both
from tests.test_torch_zero_shot import _weights as zero_shot_weights
from tests.torch_train_common import GEOMETRIES, one_torch_thread  # noqa: F401

# the 3-layer model of test_torch_train_loop.py at ViT-H's head_dim (80)
MODEL_HD80 = dict(MODEL, **GEOMETRIES["hd80"])
DATE = OTHER_DATES[0]  # build_scene_8band's one predict date


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return build_scene_8band(tmp_path_factory.mktemp("superdove") / "scene")


@pytest.fixture(scope="module")
def training(scene, tmp_path_factory):
    """JAX's and the port's run_training (backbone="huge", the hd80 weight
    file), then run_predict in each package from JAX's EMA export."""
    root = tmp_path_factory.mktemp("superdove_train")
    kw = dict(RUN, data=scene, backbone="huge", model_training_root=root / "runs", checkpoint=str(root / "weights.npz"))
    run = run_both(kw, MODEL_HD80)
    pred = dict(data=scene, train_run_dir=run["jax"], use_ema=True, backbone="huge", batch_size=2, mesh_data=1,
                mesh_model=1)
    run["jax_predict"] = jrun_predict(JPredictionConf(**pred, model_training_root=root / "jax_predict"))
    run["port_predict"] = run_predict(PredictionConfig(**pred, model_training_root=root / "port_predict"), device="cpu")
    run["pred"] = pred
    return run


def _assert_same_outputs(got_dir, want_dir, date: str) -> None:
    """Bit-equal class-id GeoTIFFs (data, transform, CRS) and mask PNGs, of
    more than one class."""
    want, got = read(want_dir / "tif" / f"{date}.tif"), read(got_dir / "tif" / f"{date}.tif")
    np.testing.assert_array_equal(got.data, want.data)
    assert got.transform.to_tuple() == want.transform.to_tuple() and got.crs == want.crs
    assert len(np.unique(want.data)) >= 2  # the comparison is not between constant maps
    png = lambda d: np.asarray(Image.open(d / "masks" / f"{date}.png"))  # noqa: E731
    np.testing.assert_array_equal(png(got_dir), png(want_dir))


@pytest.mark.parametrize("train", [True, False], ids=["reference", "predict"])
def test_8band_display_mosaics_are_bit_equal_to_jax(scene, train):
    """merge_tifs → tif_image → broad_band on the 8 bands, and the crops along
    the shoreline, as the JAX package makes them."""
    want, got = jcreate_scene(JConf(data=scene), train=train), create_scene(BeachSegConfig(data=scene), train=train)
    assert sorted(got.date_merged_imgs) == sorted(want.date_merged_imgs) == ([MASK_DATE] if train else list(OTHER_DATES[:1]))
    for date, (img, nodata) in want.date_merged_imgs.items():
        got_img, got_nodata = got.date_merged_imgs[date]
        assert got_img.dtype == img.dtype == np.uint8 and got_img.shape == img.shape and img.shape[-1] == 3
        np.testing.assert_array_equal(got_img, img)
        np.testing.assert_array_equal(got_nodata, nodata)
        assert len(np.unique(img.reshape(-1, 3), axis=0)) > 3  # a display image, not a constant
    assert list(map(tuple, got.crops)) == list(map(tuple, want.crops)) and len(want.crops) > 0


def test_8band_zero_shot_geotiffs_are_bit_equal_to_jax(scene, tmp_path):
    ckpt = tmp_path / "weights.npz"
    zero_shot_weights(ckpt)
    kw = dict(data=scene, zero_shot_crop_size=48, n_prompts=2, batch_size=2, debug=True, mesh_data=1, mesh_model=1,
              checkpoint=str(ckpt))
    want = jzero_shot.run_zero_shot(JPredConf(**kw, model_training_root=tmp_path / "jax"))
    got = run_zero_shot(PredConfig(**kw, model_training_root=tmp_path / "port"), device="cpu")
    _assert_same_outputs(got, want, DATE)


def test_huge_backbone_takes_the_stored_head_dim_80_topology(training):
    cfg = config_for(BeachSegConfig(**training["kw"]))
    assert (cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim, cfg.num_hidden_layers) == (160, 2, 80, 3)
    resolved = resolve_config(PredictionConfig(**training["pred"]))
    assert resolved.backbone == "huge" and resolved.checkpoint == training["kw"]["checkpoint"]


def test_8band_run_training_metrics_match_jax(training):
    assert_metrics_match_jax(training)


def test_8band_run_training_tuned_state_matches_jax(training):
    assert_tuned_state_matches_jax(training, MODEL_HD80)


def test_8band_run_predict_from_the_jax_ema_export_is_bit_equal(training):
    _assert_same_outputs(training["port_predict"], training["jax_predict"], DATE)
