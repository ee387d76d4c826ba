"""The port's golden-parity scripts (scripts/golden_parity_torch.py and
scripts/golden_parity_tuned_torch.py) on the CPU at ``--tiny`` on the
synthetic scene cut to the reference date and its first predict date (one
date keeps the file near a minute), against the installed transformers
SegGpt: both chains' fp32 runs within the scripts' IoU gate; the scripts'
oracles bit-equal to the JAX scripts' (scripts/golden_parity.py,
scripts/golden_parity_tuned.py) on the same weights, scene and tuned
prompts; the NumPy nearest-neighbour back-resize equal to cv2's
INTER_NEAREST; no CPU run when CUDA is asked for and absent."""

import dataclasses
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from beach_seg_tpu.config import BeachSegConfig as JBeachSegConfig
from beach_seg_tpu.config import PredConfig as JPredConfig
from beach_seg_tpu.data.dataset import create_scene as jcreate_scene
from beach_seg_tpu.geo.extent import group_images_by_date as jgroup_images_by_date
from beach_seg_tpu.geo.mosaic import merge_tifs as jmerge_tifs
from beach_seg_tpu_torch.models.seggpt import SegGPTConfig
from beach_seg_tpu_torch.models.seggpt.convert import config_from_hf
from beach_seg_tpu_torch.train.checkpoint import load_prompt_batch
from chip_smoke import scene_view
from tests.synthetic_scene import MASK_DATE, OTHER_DATES, build_scene

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
DATES = OTHER_DATES[:1]


def _script(name: str):
    """scripts/<name>.py as a module (registered, so the tuned script's
    import of golden_parity_torch finds it)."""
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


gp = _script("golden_parity_torch")
gpt = _script("golden_parity_tuned_torch")


def _args(world, *extra):
    return ["--tiny", "--device", "cpu", "--dtype", "float32", "--scene", str(world["scene"]),
            "--checkpoint", str(world["hf"]), "--parity-file", str(world["parity"]), *extra]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The scene, HF's random tiny SegGpt saved once (the probe scales its
    head: these weights paint one class), then both scripts' runs on it."""
    root = tmp_path_factory.mktemp("golden_torch")
    scene = scene_view(build_scene(root / "full"), root / "scene", [MASK_DATE, *DATES])
    hf = root / "hf_seggpt"
    probe_conf = gp.zero_shot_conf(scene, root / "probe", "random", "float32", tiny=True)
    head_scale = gp.random_checkpoint(hf, True, gp.zero_shot_probe(probe_conf, torch.device("cpu")))
    w = {"root": root, "scene": scene, "hf": hf, "parity": root / "PARITY_TORCH.md", "head_scale": head_scale}
    w["zero_shot"] = gp.run(gp.parse_args(_args(w), gp.__doc__))
    w["tuned"] = gpt.run(gp.parse_args(_args(w, "--work", str(root / "tuned")), gpt.__doc__))
    return w


@pytest.fixture(scope="module")
def oracle(world):
    """transformers' SegGpt from the saved directory and its processor."""
    return gp.load_oracle(world["hf"], torch.device("cpu")), gp.hf_api()[2]()


@pytest.mark.parametrize("chain", ["zero_shot", "tuned"])
def test_fp32_chains_meet_the_iou_gate(world, chain):
    res = world[chain]
    rows = res["runs"]["float32"]
    if chain == "tuned":
        # the port's fp32 model within the CPU's rounding of transformers' on the oracle's inputs
        err = res["near_ties"]["float32"]["model_error"]
        assert err["items"] > 0 and err["max_abs_err"] <= 1e-4 * err["max_abs"]
    assert [r["date"] for r in rows] == list(DATES)
    assert res["worst"]["float32"] >= gp.IOU_MIN
    # the gate is not blind: the head was scaled and every class is painted
    assert world["head_scale"] == gp.HEAD_SCALE
    assert gp.blind(res["shares"]) is None


def test_parity_file_holds_both_chains(world):
    text = world["parity"].read_text()
    assert text.startswith("# PARITY_TORCH")
    assert text.index(gp.SECTIONS["zero_shot"]) < text.index(gp.SECTIONS["tuned"])
    for date in DATES:
        assert text.count(f"| float32 | {date} |") == 2
    assert "Card: CPU." in text


def test_zero_shot_oracle_is_the_jax_scripts(world, oracle):
    """The port script's reference_zero_shot equals scripts/golden_parity.py's
    on the same model, scene and crops (48, 2 prompts: that script's)."""
    jgp = _script("golden_parity")
    model, processor = oracle
    conf = JPredConfig(data=world["scene"], zero_shot_crop_size=jgp.CROP_SIZE, n_prompts=jgp.N_PROMPTS,
                       rank_compat=True, mesh_data=1, mesh_model=1)
    scene = jcreate_scene(dataclasses.replace(conf, crop_size=jgp.CROP_SIZE), train=True)
    want = jgp.reference_zero_shot(model, processor, conf, scene)
    got = world["zero_shot"]["reference"]
    assert sorted(got) == sorted(want) == list(DATES)
    for date in want:
        np.testing.assert_array_equal(got[date], want[date])


def test_tuned_oracle_is_the_jax_scripts(world, oracle):
    """The port script's reference_tuned_predict equals
    scripts/golden_parity_tuned.py's on the same model, scene and the tuned
    prompts the port's run_training exported (that script resizes with cv2)."""
    pytest.importorskip("cv2", reason="scripts/golden_parity_tuned.py resizes with cv2")
    jgpt = _script("golden_parity_tuned")
    model, _ = oracle
    conf = JBeachSegConfig(data=world["scene"], crop_size=jgpt.CROP_SIZE, mesh_data=1, mesh_model=1)
    scene = jcreate_scene(conf, train=True)
    groups = jgroup_images_by_date(list((world["scene"] / "SatelliteImagery").glob("*/*.tif")))
    groups.pop(scene.mask_date, None)
    dates = {d: jmerge_tifs(paths, scene.out_shape, scene.out_transform, scene.crs) for d, paths in groups.items()}
    pb = load_prompt_batch(world["tuned"]["run_dir"] / "prompt_batch_tuned.npz")
    want = jgpt.reference_tuned_predict(model, conf, scene, dates, pb["image"], pb["mask"],
                                        palette=jgpt.ref_build_palette(len(conf.classes) - 1))
    got = world["tuned"]["reference"]
    assert sorted(got) == sorted(want) == list(DATES)
    for date in want:
        np.testing.assert_array_equal(got[date], want[date])
    assert np.array_equal(gpt.ref_build_palette(3), jgpt.ref_build_palette(3))


@pytest.mark.parametrize("src,dst", [((448, 448), (112, 112)), ((448, 448), (48, 48)), ((448, 448), (336, 336)),
                                     ((37, 53), (101, 11)), ((101, 7), (37, 45)), ((13, 13), (7, 29))])
def test_resize_nearest_is_cv2_inter_nearest(src, dst):
    cv2 = pytest.importorskip("cv2", reason="the comparison needs cv2")
    a = np.random.default_rng(sum(src) + sum(dst)).integers(0, 256, src, dtype=np.uint8)
    want = cv2.resize(a, (dst[1], dst[0]), interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(gpt.resize_nearest(a, dst), want)


@pytest.mark.parametrize("shares,blind", [([0.3, 0.4, 0.2, 0.1], False), ([0.02, 0.96, 0.01, 0.01], True),
                                          ([0.3, 0.0, 0.69, 0.01], True), ([0.39, 0.3, 0.305, 0.005], True)])
def test_blind_shares_are_named(shares, blind):
    """One class over 95% of the valid pixels, or a labelled class (not
    nodata, class 0) under 1%, leaves the IoU gate blind."""
    assert (gp.blind(shares) is not None) == blind


def test_tuned_differences_are_counted_with_their_margins():
    ref = {"d": np.array([[1, 2], [3, 1]], np.uint8)}
    got = {"d": np.array([[1, 3], [3, 1]], np.uint8)}
    valid = {"d": np.array([[True, True], [True, False]])}
    margins = {"d": np.array([[5.0, 0.25], [0.5, 0.1]], np.float32)}
    ties = gpt.near_ties(ref, got, valid, margins, bound=0.3)
    assert ties["differing_pixels"] == 1 and ties["largest_margin"] == 0.25
    assert ties["valid_pixels_within"] == 1 and ties["valid_pixels"] == 3
    assert ties["differing_below_bound"] == 1


def test_full_width_topology_is_the_ports_default():
    """transformers' SegGptConfig() is BAAI/seggpt-vit-large's topology, the
    port's SegGPTConfig()."""
    assert config_from_hf(gp.hf_config(False)) == SegGPTConfig()


@pytest.mark.parametrize("script", ["zero_shot", "tuned"])
def test_cuda_without_a_card_is_refused(world, monkeypatch, script, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    parity = tmp_path / "PARITY_TORCH.md"
    main = gp.main if script == "zero_shot" else gpt.main
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(["--device", "cuda", "--tiny", "--scene", str(world["scene"]), "--checkpoint", str(world["hf"]),
              "--parity-file", str(parity), "--work", str(tmp_path / "work")])
    assert not parity.exists() and not (tmp_path / "work").exists()
