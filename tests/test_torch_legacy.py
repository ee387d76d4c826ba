"""The port's legacy scene engine (beach_seg_tpu_torch.infer.legacy) against
the JAX package's on the synthetic scene, run as
tests/test_line_metrics_legacy.py::test_run_legacy_end_to_end runs the JAX
engine: with the reference date's crops as prompts, and with a prompt
directory whose npz files the port saved (the EMA export preferred).

Both engines read the weight file of tests/test_torch_zero_shot.py (the JAX
init_random weights of the zero-shot debug topology, the head scaled). The
merge is an ascending max of integer ids, so the bar is bit-equal
GeoTIFFs."""

import json

import numpy as np
import pytest
import torch

from beach_seg_tpu.config import LegacyConfig as JLegacyConfig
from beach_seg_tpu.geo.tiff import read
from beach_seg_tpu.infer import legacy as jlegacy
from beach_seg_tpu_torch.config import BeachSegConfig, LegacyConfig
from beach_seg_tpu_torch.data.dataset import create_scene, materialize_prompts
from beach_seg_tpu_torch.infer import legacy as plegacy
from beach_seg_tpu_torch.infer import run_legacy
from beach_seg_tpu_torch.train.checkpoint import save_prompt_batch
from tests.synthetic_scene import build_scene
from tests.test_torch_zero_shot import _weights

RUNS = ("reference_crops", "prompt_ckpt")


def _prompt_dir(scene, path):
    """A train-run directory with the port's two prompt exports: tuned and
    EMA, each the reference crops with their own noise."""
    conf = BeachSegConfig(data=scene, crop_size=48)
    prompts = materialize_prompts(create_scene(conf, train=True), conf)
    rng = np.random.default_rng(9)
    path.mkdir(parents=True)
    for name in ("prompt_batch_tuned.npz", "prompt_batch_ema.npz"):
        pixels = np.clip(prompts["pixels"] + 0.2 * rng.standard_normal(prompts["pixels"].shape), 0, 1).astype(np.float32)
        save_prompt_batch(path / name, pixels, prompts["masks"], prompts["nodata"], prompts["crop_idx"],
                          ["20230301"] * len(pixels))
    return path


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The scene, the weights, the prompt directory, and both packages' runs
    (the port's prompt_ckpt run with CUDA hidden and platform="cpu")."""
    root = tmp_path_factory.mktemp("legacy")
    scene = build_scene(root / "scene")
    _weights(root / "weights.npz")
    prompt_dir = _prompt_dir(scene, root / "train_run")
    kw = dict(data=scene, crop_size=48, n_prompts=2, batch_size=2, debug=True, mesh_data=1, mesh_model=1,
              checkpoint=str(root / "weights.npz"))
    extra = {"reference_crops": {}, "prompt_ckpt": {"prompt_ckpt": prompt_dir}}
    jax_out = {r: jlegacy.run_legacy(JLegacyConfig(**kw, **extra[r], model_training_root=root / f"jax_{r}")) for r in RUNS}
    port = {"reference_crops": run_legacy(LegacyConfig(**kw, model_training_root=root / "port_ref"), device="cpu")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        port["prompt_ckpt"] = run_legacy(LegacyConfig(**kw, **extra["prompt_ckpt"], platform="cpu",
                                                      model_training_root=root / "port_ckpt"))
    port_debug_nans = run_legacy(LegacyConfig(**kw, debug_nans=True, model_training_root=root / "port_debug_nans"),
                                 device="cpu")
    return {"root": root, "kw": kw, "prompt_dir": prompt_dir, "jax": jax_out, "port": port,
            "port_debug_nans": port_debug_nans}


@pytest.mark.parametrize("run", RUNS)
def test_legacy_writes_the_jax_engines_outputs(world, run):
    """The same files (per-class GeoTIFFs and shapefiles), the GeoTIFFs
    bit-equal with their transform and CRS, 1-bit masks of both classes."""
    want_dir, got_dir = world["jax"][run], world["port"][run]
    names = lambda d: sorted(p.name for p in d.iterdir() if p.suffix != ".log")  # noqa: E731
    assert names(got_dir) == names(want_dir)
    tifs = sorted(want_dir.glob("*.tif"))
    assert {p.name.split("_")[0] for p in tifs} == {"WetDryLine", "VegLine"}
    assert any(p.suffix == ".shp" for p in want_dir.iterdir())
    for p in tifs:
        want, got = read(p), read(got_dir / p.name)
        np.testing.assert_array_equal(got.data, want.data)
        assert got.transform.to_tuple() == want.transform.to_tuple() and got.crs == want.crs == "EPSG:32611"
        assert set(np.unique(got.data).tolist()) == {0, 1}


@pytest.mark.parametrize("run", RUNS)
def test_legacy_timings_have_the_jax_keys(world, run):
    want = json.loads((world["jax"][run] / "timings.json").read_text())
    got = json.loads((world["port"][run] / "timings.json").read_text())
    assert sorted(got) == sorted(want)
    assert got["tiles"] == want["tiles"] > 0


def test_legacy_prompts_prefer_the_ema_export(world):
    """A prompt directory gives the EMA npz's crops, a file its own, none the
    reference date's first crops; as the JAX engine stages them."""
    conf = LegacyConfig(**world["kw"], prompt_ckpt=world["prompt_dir"])
    scene = create_scene(conf, train=True, crop_overlap=conf.crop_size // 2)
    ema = plegacy.legacy_prompts(conf, scene)
    tuned = plegacy.legacy_prompts(LegacyConfig(**world["kw"], prompt_ckpt=world["prompt_dir"] / "prompt_batch_tuned.npz"),
                                   scene)
    ema_file = plegacy.legacy_prompts(LegacyConfig(**world["kw"], prompt_ckpt=world["prompt_dir"] / "prompt_batch_ema.npz"),
                                      scene)
    reference = plegacy.legacy_prompts(LegacyConfig(**world["kw"]), scene)
    for a, b in zip(ema, ema_file):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(ema[0], tuned[0]) and not np.array_equal(ema[0], reference[0])
    assert ema[0].shape == reference[0].shape == (2, 448, 448, 3) and ema[0].dtype == np.uint8
    np.testing.assert_array_equal(ema[1], tuned[1])  # the masks: the same crops' labels


def test_class_export_names_match_jax():
    assert plegacy.CLASS_EXPORT_NAMES == jlegacy.CLASS_EXPORT_NAMES


def test_run_legacy_needs_cuda_unless_asked_for_the_cpu(world, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = world["root"] / "no_cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_legacy(LegacyConfig(**world["kw"], model_training_root=out))
    assert not out.exists()  # it raised before it wrote anything


@pytest.mark.parametrize("field, value, error, match", [
    ("mesh_data", 4, ValueError, "must cover the 1 ranks"),
    ("mesh_model", 2, ValueError, "does not divide the 1 ranks"),
    ("platform", "tpu", ValueError, "platform='tpu'"),
])
def test_run_legacy_unported_fields_raise(world, field, value, error, match):
    conf = LegacyConfig(**{**world["kw"], field: value}, model_training_root=world["root"] / "unported")
    with pytest.raises(error, match=match):
        run_legacy(conf)
    assert not (world["root"] / "unported").exists()


def test_debug_nans_changes_no_output(world):
    """debug_nans is a training field: the engine ignores it, as the JAX
    engine does, so a run with it set writes the reference-crops run's
    GeoTIFFs bit for bit, and the same files."""
    want_dir, got_dir = world["port"]["reference_crops"], world["port_debug_nans"]
    names = lambda d: sorted(p.name for p in d.iterdir() if p.suffix != ".log")  # noqa: E731
    assert names(got_dir) == names(want_dir)
    tifs = sorted(want_dir.glob("*.tif"))
    assert tifs
    for p in tifs:
        np.testing.assert_array_equal(read(got_dir / p.name).data, read(p).data)
