"""The port's tuned-predict scene engine (beach_seg_tpu_torch.infer.predict)
against the JAX package's on the synthetic scene, run as
tests/test_inference.py runs the JAX engine; with them the pieces it loads:
the weights (load_model_params, model_for_config's stored topology), the
prompt npz files and predict_step_probs.

Both engines read one weight file: the JAX package's init_random, written
with its save_params. Its decoder head is scaled up (×3000) so that the
random model paints three classes over the scene instead of one; the two
packages' own random branches draw different weights by design."""

import dataclasses
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from beach_seg_tpu.config import BeachSegConfig as JConf
from beach_seg_tpu.config import PredictionConfig as JPredConf
from beach_seg_tpu.data.dataset import create_scene as jcreate_scene
from beach_seg_tpu.data.dataset import materialize_prompts as jmaterialize
from beach_seg_tpu.geo.tiff import read
from beach_seg_tpu.infer.predict import resolve_config as jresolve
from beach_seg_tpu.infer.predict import run_predict as jrun_predict
from beach_seg_tpu.models.seggpt import convert as jconvert
from beach_seg_tpu.models.seggpt.config import tiny_config as jtiny_config
from beach_seg_tpu.models.seggpt.load import init_random
from beach_seg_tpu.models.seggpt.model import SegGPT as JSegGPT
from beach_seg_tpu.train import checkpoint as jckpt
from beach_seg_tpu.train.loop import model_for_config as jmodel_for_config
from beach_seg_tpu.train.prompt_tuner import PromptTuner as JTuner
from beach_seg_tpu.utils.confix import save_yaml as jsave_yaml
from beach_seg_tpu.utils.confix import to_dict as jto_dict
from beach_seg_tpu_torch.config import BeachSegConfig, PredictionConfig
from beach_seg_tpu_torch.infer import accumulator as paccumulator
from beach_seg_tpu_torch.infer.predict import resolve_config, run_predict
from beach_seg_tpu_torch.models.seggpt import build_model, from_jax_params, load_model_params, tiny_config
from beach_seg_tpu_torch.models.seggpt.convert import save_params
from beach_seg_tpu_torch.train import PromptTuner
from beach_seg_tpu_torch.train.checkpoint import load_prompt_batch, save_prompt_batch
from beach_seg_tpu_torch.train.loop import config_for, model_for_config
from beach_seg_tpu_torch.utils.confix import to_dict
from tests.synthetic_scene import OTHER_DATES, build_scene
from tests.test_seggpt_parity import make_torch_model

HEAD_SCALE = 3000.0
TIE = 1e-5  # blend mode: ids may differ only where the top two blended votes are this close
TIE_SHARE_MAX = 1e-3  # ... and on at most 0.1% of the scene
PROBS_TOL = 1e-5


def _weights(jconf, path):
    """The JAX package's random weights for the topology ``jconf`` selects,
    the decoder head scaled, written with its save_params (with topology)."""
    model, cfg = jmodel_for_config(jconf)
    params = jax.tree.map(np.asarray, init_random(model, cfg))
    params["decoder"]["head_kernel"] = params["decoder"]["head_kernel"] * HEAD_SCALE
    jconvert.save_params(params, path, cfg)
    return params, cfg


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The scene, one weight file, and the JAX engine's vote and blend runs."""
    root = tmp_path_factory.mktemp("engine")
    scene = build_scene(root / "scene")
    kw = dict(data=scene, crop_size=32, inpt_size=64, batch_size=2, debug=True, mesh_data=1, mesh_model=1)
    ckpt = root / "weights.npz"
    _weights(jresolve(JPredConf(**kw)), ckpt)
    kw["checkpoint"] = str(ckpt)
    runs = {
        "vote": dict(merge="vote", overlap=0),
        "blend": dict(merge="blend", overlap=16),
    }
    jax_out = {name: jrun_predict(JPredConf(**kw, **mode, model_training_root=root / "jax")) for name, mode in runs.items()}
    return {"root": root, "scene": scene, "kw": kw, "runs": runs, "jax": jax_out}


def _tif(run_dir, date) -> np.ndarray:
    r = read(run_dir / "tif" / f"{date}.tif")
    return r.data[0]


@pytest.fixture(scope="module")
def port_vote(world):
    return run_predict(PredictionConfig(**world["kw"], **world["runs"]["vote"], model_training_root=world["root"] / "port"),
                       device="cpu")


@pytest.mark.parametrize("date", OTHER_DATES)
def test_vote_mode_writes_the_jax_engines_geotiffs(world, port_vote, date):
    """Bit-equal class-id GeoTIFFs (data, transform, CRS) and mask PNGs."""
    want_dir = world["jax"]["vote"]
    want, got = read(want_dir / "tif" / f"{date}.tif"), read(port_vote / "tif" / f"{date}.tif")
    np.testing.assert_array_equal(got.data, want.data)
    assert got.transform.to_tuple() == want.transform.to_tuple() and got.crs == want.crs
    assert len(np.unique(want.data)) >= 3  # the comparison is not between constant maps
    png = lambda d: np.asarray(Image.open(d / "masks" / f"{date}.png"))  # noqa: E731
    np.testing.assert_array_equal(png(port_vote), png(want_dir))
    assert (port_vote / "images" / f"{date}.png").exists()


def test_vote_mode_timings_have_the_jax_keys(world, port_vote):
    import json

    want = json.loads((world["jax"]["vote"] / "timings.json").read_text())
    got = json.loads((port_vote / "timings.json").read_text())
    assert sorted(got) == sorted(want)
    assert got["tiles"] == want["tiles"] > 0


def test_blend_mode_matches_jax_but_for_ties(world, monkeypatch):
    """Equal ids except where the port's two largest blended votes lie within
    TIE of each other, on at most TIE_SHARE_MAX of the scene."""
    counters = {}
    save = paccumulator.VoteAccumulator.save_current

    def keep(self):
        counters[self.current_date] = self.current_pred_counter.copy()
        return save(self)

    monkeypatch.setattr(paccumulator.VoteAccumulator, "save_current", keep)
    out = run_predict(PredictionConfig(**world["kw"], **world["runs"]["blend"], model_training_root=world["root"] / "port"),
                      device="cpu")
    for date in OTHER_DATES:
        want, got = _tif(world["jax"]["blend"], date), _tif(out, date)
        top2 = np.sort(counters[date], axis=-1)[..., -2:]
        tie = (top2[..., 1] - top2[..., 0]) <= TIE
        differ = got != want
        assert not (differ & ~tie).any(), f"{date}: {(differ & ~tie).sum()} ids differ away from a tie"
        assert differ.sum() <= TIE_SHARE_MAX * want.size
        assert len(np.unique(want)) >= 2


# ------------------------------------------------------ predict_step_probs


@pytest.fixture(scope="module")
def tuners():
    """A tiny fp32 model in both packages (as tests/test_torch_predict.py),
    and a batch of uint8 crops at the canvas size. The softmax over palette
    distances multiplies a difference in pred_masks by up to 2·|q − p|/τ ≈
    160, so the two packages' fp32 products (~1e-7 of the output apart) stay
    within PROBS_TOL only where the outputs are small: initializer_range 0.1
    keeps them so while 2% of the pixels have no class above 0.9 (at 0.2,
    the maximum difference is 1.7e-5). Crops at the canvas size skip the
    PIL-parity resize, whose uint8 rounding between passes can land one
    level apart in the two packages on a tie."""
    over = dict(drop_path_rate=0.0, initializer_range=0.1)
    jcfg = jtiny_config(**over)
    h = jcfg.image_size[0] // 2
    jmodel = JSegGPT(jcfg)
    zeros = jnp.zeros((1, h, h, 3))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), zeros, zeros, zeros)["params"]
    jtuner = JTuner(model=jmodel, conf=JConf(crop_size=h // 2, inpt_size=h, batch_size=4), num_prompts=4, steps_per_epoch=1)
    model = build_model(tiny_config(**over), device="cpu", state=from_jax_params(params, device="cpu"))
    tuner = PromptTuner(model, BeachSegConfig(crop_size=h // 2, inpt_size=h, batch_size=4), device="cpu")
    rng = np.random.default_rng(0)
    prompts = (
        rng.random((4, h, h, 3)).astype(np.float32),
        rng.integers(0, 4, (4, h, h)).astype(np.int32),
        np.zeros((4, h, h), bool),
    )
    batch = {"image_u8": rng.integers(0, 256, (4, h, h, 3), dtype=np.uint8),
             "crop_idx": rng.integers(0, 4, (4,)).astype(np.int32)}
    return jtuner, params, tuner, prompts, batch, h


@pytest.mark.parametrize("resize", [False, True], ids=["canvas", "out_size"])
@pytest.mark.parametrize("feathered", [False, True], ids=["plain", "feather"])
def test_predict_step_probs_matches_jax(tuners, resize, feathered):
    jtuner, params, tuner, (pixels, masks, nodata), batch, h = tuners
    out_size = h // 2 if resize else None
    size = out_size or h
    ramp = np.sin(np.pi * (np.arange(size) + 0.5) / size) ** 2
    feather = (np.outer(ramp, ramp) + 1e-3)[..., None].astype(np.float32) if feathered else None
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = np.asarray(jtuner.predict_step_probs(
        jnp.asarray(pixels), params, jnp.asarray(masks), jnp.asarray(nodata), jbatch, out_size,
        None if feather is None else jnp.asarray(feather),
    ))
    got = tuner.predict_step_probs(pixels, masks, nodata, batch, out_size, feather).numpy()
    assert got.shape == want.shape == (4, size, size, 4) and got.dtype == np.float32
    assert (np.sort(want, axis=-1)[..., -1] < 0.9).mean() > 0.01  # probabilities that are not all saturated
    np.testing.assert_allclose(got, want, rtol=0, atol=PROBS_TOL)


# ------------------------------------------------- a JAX train run's files


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def jax_train_run(world):
    """A JAX train run dir: its conf.yaml (the JAX save_yaml, with the
    checkpoint and the crop sizes) and its tuned prompt export."""
    root = world["root"]
    ckpt = root / "weights64.npz"
    jconf = JConf(data=world["scene"], crop_size=32, inpt_size=64, debug=True, checkpoint=str(ckpt), batch_size=2)
    _weights(jconf, ckpt)
    run = root / "train_run"
    jsave_yaml(jconf, run / "conf.yaml")
    scene = jcreate_scene(jconf, train=True)
    prompts = jmaterialize(scene, jconf)
    rng = np.random.default_rng(5)
    tuned = np.clip(prompts["pixels"] + 0.1 * rng.standard_normal(prompts["pixels"].shape), 0, 1).astype(np.float32)
    jckpt.save_prompt_batch(run / "prompt_batch_tuned.npz", tuned, prompts["masks"], prompts["nodata"],
                            prompts["crop_idx"], [scene.mask_date] * len(tuned))
    kw = dict(data=world["scene"], train_run_dir=run, batch_size=2, debug=True, mesh_data=1, mesh_model=1)
    return kw, jrun_predict(JPredConf(**kw, model_training_root=root / "jax_tuned"))


@pytest.mark.parametrize("name", ["BeachSegConfig", "PredictionConfig", "LegacyConfig", "PredConfig"])
def test_config_fields_and_defaults_match_jax(name):
    import beach_seg_tpu.config as jconfig
    import beach_seg_tpu_torch.config as pconfig

    jcls, pcls = getattr(jconfig, name), getattr(pconfig, name)
    assert [f.name for f in dataclasses.fields(pcls)] == [f.name for f in dataclasses.fields(jcls)]
    assert to_dict(pcls()) == jto_dict(jcls())
    conf = jcls(workers=3, seed=7)
    assert pconfig.num_workers(pcls(workers=3, seed=7)) == jconfig.num_workers(conf)


def test_jax_conf_yaml_resolves_to_the_same_config(jax_train_run):
    kw, _ = jax_train_run
    want = jto_dict(jresolve(JPredConf(**kw)))
    got = to_dict(resolve_config(PredictionConfig(**kw)))
    assert got == want
    assert got["inpt_size"] == 64 and got["checkpoint"].endswith("weights64.npz")


def test_jax_tuned_run_predicts_the_same_in_the_port(no_cuda, world, jax_train_run):
    """The port reads the JAX run's conf.yaml and prompt npz and writes the
    JAX engine's GeoTIFFs; with CUDA hidden, platform="cpu" asks for the CPU."""
    kw, want_dir = jax_train_run
    out = run_predict(PredictionConfig(**kw, platform="cpu", model_training_root=world["root"] / "port_tuned"))
    for date in OTHER_DATES:
        np.testing.assert_array_equal(_tif(out, date), _tif(want_dir, date))


def test_port_prompt_npz_loads_in_jax(tmp_path):
    rng = np.random.default_rng(2)
    pixels = torch.rand((3, 8, 8, 3), generator=torch.Generator().manual_seed(0))
    masks = rng.integers(0, 4, (3, 8, 8)).astype(np.int32)
    nodata = rng.random((3, 8, 8)) < 0.2
    save_prompt_batch(tmp_path / "p.npz", pixels, masks, nodata, np.arange(3), ["20230301"] * 3)
    want = {"image": pixels.numpy(), "mask": masks, "nodata": nodata, "crop_idx": np.arange(3, dtype=np.int32),
            "date": np.asarray(["20230301"] * 3)}
    for loaded in (jckpt.load_prompt_batch(tmp_path / "p.npz"), load_prompt_batch(tmp_path / "p.npz")):
        assert sorted(loaded) == sorted(want)
        for k, v in want.items():
            assert loaded[k].dtype == v.dtype, k
            np.testing.assert_array_equal(loaded[k], v)


# ---------------------------------------------------------------- weights


def _assert_state_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_load_model_params_from_npz_equals_from_jax_params(world):
    jconf = jresolve(JPredConf(**world["kw"]))
    params, cfg = _weights(jconf, world["root"] / "w_load.npz")
    got = load_model_params(world["root"] / "w_load.npz", config_for(resolve_config(PredictionConfig(**world["kw"]))), "cpu")
    _assert_state_equal(got, from_jax_params(params, "cpu"))


@pytest.mark.parametrize("safe", [True, False], ids=["safetensors", "pytorch_model_bin"])
def test_load_model_params_from_hf_dir_equals_jax_conversion(tmp_path, safe):
    tmodel, hf_cfg = make_torch_model(jtiny_config())
    tmodel.save_pretrained(tmp_path / "hf", safe_serialization=safe)
    assert (tmp_path / "hf" / ("model.safetensors" if safe else "pytorch_model.bin")).exists()
    cfg = tiny_config()
    want = from_jax_params(jconvert.convert_torch_state_dict(tmodel.state_dict(), jconvert.config_from_hf(hf_cfg)), "cpu")
    _assert_state_equal(load_model_params(tmp_path / "hf", cfg, "cpu"), want)


@pytest.mark.parametrize("checkpoint", ["BAAI/seggpt-vit-large", "missing.npz", "no/such/dir"])
def test_load_model_params_never_fetches(monkeypatch, checkpoint):
    def no_network(*args, **kwargs):
        raise AssertionError("the loader tried to open a network connection")

    monkeypatch.setattr(socket.socket, "connect", no_network)
    monkeypatch.setattr(socket, "create_connection", no_network)
    with pytest.raises(FileNotFoundError, match="cannot resolve checkpoint"):
        load_model_params(checkpoint, tiny_config(), "cpu")


def test_model_for_config_takes_the_npz_topology(tmp_path):
    """A checkpoint that stores its topology wins over the conf's preset."""
    stored = tiny_config(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, mlp_dim=64)
    state = build_model(stored, device="cpu").state_dict()
    save_params(state, tmp_path / "w.npz", stored)
    jstate = jconvert.load_params(tmp_path / "w.npz")
    assert jconvert.load_config(tmp_path / "w.npz") == jtiny_config(hidden_size=32, num_hidden_layers=2,
                                                                     num_attention_heads=2, mlp_dim=64)
    conf = BeachSegConfig(checkpoint=str(tmp_path / "w.npz"))
    model, cfg = model_for_config(conf, "cpu", state=load_model_params(conf.checkpoint, config_for(conf), "cpu"))
    assert cfg == stored and model.config == stored
    _assert_state_equal(model.state_dict(), from_jax_params(jstate, "cpu"))
    assert model_for_config(dataclasses.replace(conf, checkpoint="random"), "meta")[1].hidden_size == 1024


# ------------------------------------------------------------ device rule


def test_run_predict_needs_cuda_unless_asked_for_the_cpu(no_cuda, world):
    conf = PredictionConfig(**world["kw"], model_training_root=world["root"] / "no_cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_predict(conf)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model_params("random", tiny_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_for_config(BeachSegConfig(debug=True))
    assert not (world["root"] / "no_cuda").exists()  # it raised before it wrote anything


@pytest.mark.parametrize("field, value, error, match", [
    ("mesh_data", 2, ValueError, "must cover the 1 ranks"),
    ("mesh_model", 2, ValueError, "does not divide the 1 ranks"),
    ("platform", "tpu", ValueError, "platform='tpu'"),
])
def test_unported_fields_raise(world, field, value, error, match):
    conf = PredictionConfig(**{**world["kw"], field: value}, model_training_root=world["root"] / "unported")
    with pytest.raises(error, match=match):
        run_predict(conf)



@pytest.fixture(scope="module")
def port_vote_debug_nans(world):
    conf = PredictionConfig(**world["kw"], **world["runs"]["vote"], debug_nans=True,
                            model_training_root=world["root"] / "port_debug_nans")
    return run_predict(conf, device="cpu")


@pytest.mark.parametrize("date", OTHER_DATES)
def test_debug_nans_changes_no_output(port_vote, port_vote_debug_nans, date):
    """debug_nans is a training field: the engine ignores it, as the JAX
    engine does, so a run with it set writes bit-equal GeoTIFFs and mask
    PNGs."""
    want, got = read(port_vote / "tif" / f"{date}.tif"), read(port_vote_debug_nans / "tif" / f"{date}.tif")
    np.testing.assert_array_equal(got.data, want.data)
    png = lambda d: np.asarray(Image.open(d / "masks" / f"{date}.png"))  # noqa: E731
    np.testing.assert_array_equal(png(port_vote_debug_nans), png(port_vote))
