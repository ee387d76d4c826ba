"""The port's zero-shot scene engine (beach_seg_tpu_torch.infer.zero_shot)
against the JAX package's on the synthetic scene, run as
tests/test_inference.py::test_run_zero_shot_end_to_end runs the JAX engine,
in both ``rank_compat`` modes; with it the topology and weights it loads
and the device rule.

Both engines read one weight file: the JAX package's init_random for the
zero-shot debug topology, its decoder head scaled up (×3000, as
tests/test_torch_engine.py does) so the random model paints three classes,
written with the JAX save_params with its topology. The votes are integers
and the ensemble canvases agree to ~1e-6 (fp32), so the bar is bit-equal
GeoTIFFs and PNGs: no id here lies that close to a palette-distance tie."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from beach_seg_tpu.config import PredConfig as JPredConf
from beach_seg_tpu.geo.tiff import read
from beach_seg_tpu.infer import zero_shot as jzero_shot
from beach_seg_tpu.models.seggpt import convert as jconvert
from beach_seg_tpu.models.seggpt.load import init_random
from beach_seg_tpu_torch.config import PredConfig
from beach_seg_tpu_torch.infer import run_zero_shot
from beach_seg_tpu_torch.infer import zero_shot as pzero_shot
from beach_seg_tpu_torch.models.seggpt import from_jax_params
from tests.synthetic_scene import OTHER_DATES, build_scene
from tests.torch_train_common import as_jax_fields

HEAD_SCALE = 3000.0
MODES = {"ranked": False, "compat": True}


def _weights(path):
    """The JAX init_random weights of the zero-shot debug topology, the head
    scaled, saved with the topology → (params, config)."""
    model, cfg = jzero_shot.zero_shot_model(JPredConf(debug=True, checkpoint="random"))
    params = jax.tree.map(np.asarray, init_random(model, cfg))
    params["decoder"]["head_kernel"] = params["decoder"]["head_kernel"] * HEAD_SCALE
    jconvert.save_params(params, path, cfg)
    return params, cfg


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The scene, the weight file, the JAX engine's runs in both modes and
    the port's (ranked on device="cpu", compat with CUDA hidden and
    platform="cpu"), with the prompt index of every batch the port ran."""
    root = tmp_path_factory.mktemp("zero_shot")
    scene = build_scene(root / "scene")
    ckpt = root / "weights.npz"
    _weights(ckpt)
    kw = dict(data=scene, zero_shot_crop_size=48, n_prompts=2, batch_size=2, debug=True, mesh_data=1, mesh_model=1,
              checkpoint=str(ckpt))
    jax_out = {m: jzero_shot.run_zero_shot(JPredConf(**kw, rank_compat=rc, model_training_root=root / f"jax_{m}"))
               for m, rc in MODES.items()}
    sels = {m: [] for m in MODES}
    batch = pzero_shot.zero_shot_batch

    def recording(mode):
        def run(model, queries, pp, pm, sel, *args):
            sels[mode].append(sel.clone())
            return batch(model, queries, pp, pm, sel, *args)
        return run

    port = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pzero_shot, "zero_shot_batch", recording("ranked"))
        port["ranked"] = run_zero_shot(PredConfig(**kw, rank_compat=False, model_training_root=root / "port_ranked"),
                                       device="cpu")
        mp.setattr(pzero_shot, "zero_shot_batch", recording("compat"))
        mp.setattr(torch.cuda, "is_available", lambda: False)
        port["compat"] = run_zero_shot(PredConfig(**kw, rank_compat=True, platform="cpu",
                                                  model_training_root=root / "port_compat"))
    port_debug_nans = run_zero_shot(PredConfig(**kw, rank_compat=False, debug_nans=True,
                                               model_training_root=root / "port_debug_nans"), device="cpu")
    return {"root": root, "kw": kw, "jax": jax_out, "port": port, "sels": sels, "port_debug_nans": port_debug_nans}


@pytest.mark.parametrize("date", OTHER_DATES)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_zero_shot_writes_the_jax_engines_outputs(world, mode, date):
    """Bit-equal class-id GeoTIFFs (data, transform, CRS), mask PNGs and
    overlays."""
    want_dir, got_dir = world["jax"][mode], world["port"][mode]
    want, got = read(want_dir / "tif" / f"{date}.tif"), read(got_dir / "tif" / f"{date}.tif")
    np.testing.assert_array_equal(got.data, want.data)
    assert got.transform.to_tuple() == want.transform.to_tuple() and got.crs == want.crs
    assert len(np.unique(want.data)) >= 3  # the comparison is not between constant maps
    for sub in ("masks", "images"):
        png = lambda d: np.asarray(Image.open(d / sub / f"{date}.png"))  # noqa: E731
        np.testing.assert_array_equal(png(got_dir), png(want_dir))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_zero_shot_prompt_images_lines_and_timings(world, mode):
    want_dir, got_dir = world["jax"][mode], world["port"][mode]
    for name in ("prompt_w_label.png", "prompt.png"):
        np.testing.assert_array_equal(np.asarray(Image.open(got_dir / name)), np.asarray(Image.open(want_dir / name)))
    lines = lambda d: sorted(p.name for p in (d / "lines").iterdir())  # noqa: E731
    assert lines(got_dir) == lines(want_dir)
    want = json.loads((want_dir / "timings.json").read_text())
    got = json.loads((got_dir / "timings.json").read_text())
    assert sorted(got) == sorted(want)
    assert got["tiles"] == want["tiles"] > 0


def test_the_two_rank_modes_pick_different_prompts(world):
    """The modes are not the same run twice: the scene's four crops rank
    [1, 2, 0, 3] by sand coverage, so the ranked run's ensembles take crops
    1 and 2 where the compat run's take 0 and 1 (a (Q, P) index a batch)."""
    ranked, compat = (torch.cat(world["sels"][m]) for m in ("ranked", "compat"))
    assert ranked.shape == compat.shape and ranked.shape[1] == 2
    assert not torch.equal(ranked, compat)
    assert {1, 2} <= set(ranked.flatten().tolist()) and set(compat[:, 1].tolist()) <= {0, 1}


@pytest.mark.parametrize("rank_compat", [False, True])
def test_rank_prompt_crops_matches_jax(rank_compat):
    rng = np.random.default_rng(0)
    labels = [rng.integers(0, 4, (8, 8)) * (rng.random((8, 8)) < f) for f in rng.random(9)]
    got = pzero_shot.rank_prompt_crops(labels, rank_compat)
    np.testing.assert_array_equal(got, jzero_shot.rank_prompt_crops(labels, rank_compat))
    assert (got == np.arange(9)).all() == rank_compat


def test_zero_shot_model_reads_the_stored_topology(world, tmp_path):
    """A .npz with stored topology gives its config and weights; without a
    checkpoint file, the debug miniature and ViT-L as the JAX package's."""
    params, cfg = _weights(tmp_path / "w.npz")
    conf = PredConfig(debug=False, checkpoint=str(tmp_path / "w.npz"))
    model, got = pzero_shot.zero_shot_model(conf, "cpu")
    assert as_jax_fields(got) == dataclasses.asdict(cfg)
    want = from_jax_params(params, "cpu")
    assert all(torch.equal(v, want[k]) for k, v in model.state_dict().items()) and sorted(want) == sorted(model.state_dict())
    for debug in (True, False):
        want_cfg = jzero_shot.zero_shot_model(JPredConf(debug=debug, checkpoint="random"))[1]
        assert as_jax_fields(pzero_shot.zero_shot_config(PredConfig(debug=debug, checkpoint="random"))) == \
            dataclasses.asdict(want_cfg)
    bf16 = pzero_shot.zero_shot_model(dataclasses.replace(conf, compute_dtype="bfloat16"), "cpu")[0]
    assert bf16.compute_dtype == torch.bfloat16


def test_run_zero_shot_needs_cuda_unless_asked_for_the_cpu(world, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = world["root"] / "no_cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_zero_shot(PredConfig(**world["kw"], model_training_root=out))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pzero_shot.zero_shot_model(PredConfig(**world["kw"]))
    assert not out.exists()  # it raised before it wrote anything


@pytest.mark.parametrize("field, value, error, match", [
    ("mesh_data", 2, ValueError, "must cover the 1 ranks"),
    ("mesh_model", 2, ValueError, "does not divide the 1 ranks"),
    ("platform", "tpu", ValueError, "platform='tpu'"),
])
def test_run_zero_shot_unported_fields_raise(world, field, value, error, match):
    conf = PredConfig(**{**world["kw"], field: value}, model_training_root=world["root"] / "unported")
    with pytest.raises(error, match=match):
        run_zero_shot(conf)
    assert not (world["root"] / "unported").exists()


@pytest.mark.parametrize("date", OTHER_DATES)
def test_debug_nans_changes_no_output(world, date):
    """debug_nans is a training field: the engine ignores it, as the JAX
    engine does, so a run with it set writes the ranked run's GeoTIFFs and
    PNGs bit for bit."""
    out = world["port_debug_nans"]
    want_dir = world["port"]["ranked"]
    np.testing.assert_array_equal(read(out / "tif" / f"{date}.tif").data, read(want_dir / "tif" / f"{date}.tif").data)
    for sub in ("masks", "images"):
        png = lambda d: np.asarray(Image.open(d / sub / f"{date}.png"))  # noqa: E731
        np.testing.assert_array_equal(png(out), png(want_dir))

