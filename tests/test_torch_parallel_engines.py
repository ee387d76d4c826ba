"""The port's scene engines and training runtime on a mesh of 2 gloo
processes on the CPU, against the same runs in one process, on the
synthetic scene: run_predict, run_zero_shot and run_legacy with mesh_data=2
(each batch's rows split over the ranks; batches of 3 pad to 4) and with
mesh_model=2 write GeoTIFFs (and mask PNGs, or legacy's shapefiles) bit-equal
to the 1-process runs (the engines the JAX parity tests,
test_torch_engine.py, test_torch_zero_shot.py and test_torch_legacy.py, hold
bit-equal to the JAX package's); run_training with
mesh_data=2 for one epoch writes tuned prompts equal to the 1-process run's
within test_tp_equivalence.py's rtol 1e-5, atol 1e-6; rank 0 alone writes
the outputs."""

import numpy as np
import pytest
from PIL import Image

from beach_seg_tpu.config import PredictionConfig as JPredConf
from beach_seg_tpu.geo.tiff import read
from beach_seg_tpu.infer.predict import resolve_config as jresolve
from beach_seg_tpu_torch.config import BeachSegConfig, LegacyConfig, PredConfig, PredictionConfig
from beach_seg_tpu_torch.infer import run_legacy, run_predict, run_zero_shot
from beach_seg_tpu_torch.train import run_training
from beach_seg_tpu_torch.train.checkpoint import load_prompt_batch
from tests.synthetic_scene import OTHER_DATES, build_scene
from tests.test_torch_engine import _weights as predict_weights
from tests.torch_parallel_common import engine_task, small_canvas_weights, spawn


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 1-process runs in this process, then each on 2 ranks: training
    (crops of 32 at 64, as tests/test_cli.py runs it), predict from its run
    dir (its conf.yaml sets the crop sizes) with the JAX package's random
    weights for that topology, zero-shot (crops of 64) with a small stored
    topology on the 896×448 canvas (torch_parallel_common.SMALL_CANVAS), and
    legacy (crops of 64 at overlap 32, the reference crops as prompts) with
    the same weights; the decoder heads scaled so the random models paint
    three classes. Predict, zero-shot and legacy run under (2, 1) and
    (1, 2), training under (2, 1)."""
    root = tmp_path_factory.mktemp("parallel_engines")
    scene = build_scene(root / "scene")
    train = dict(data=scene, crop_size=32, inpt_size=64, batch_size=2, debug=True, checkpoint="random", epochs=1,
                 num_viz_images=0)
    one = {"training": run_training(BeachSegConfig(**train, model_training_root=root / "one_training"), device="cpu")}
    predict = dict(data=scene, train_run_dir=one["training"], batch_size=3, debug=True,
                   checkpoint=str(root / "predict.npz"))
    predict_weights(jresolve(JPredConf(**predict)), root / "predict.npz")
    small_canvas_weights(root / "zero_shot.npz", head_scale=3000.0)
    zero_shot = dict(data=scene, zero_shot_crop_size=64, n_prompts=2, batch_size=3, debug=True,
                     checkpoint=str(root / "zero_shot.npz"))
    one["predict"] = run_predict(PredictionConfig(**predict, model_training_root=root / "one_predict"), device="cpu")
    one["zero_shot"] = run_zero_shot(PredConfig(**zero_shot, model_training_root=root / "one_zero_shot"), device="cpu")
    legacy = dict(data=scene, crop_size=64, n_prompts=2, batch_size=3, debug=True, checkpoint=str(root / "zero_shot.npz"))
    one["legacy"] = run_legacy(LegacyConfig(**legacy, model_training_root=root / "one_legacy"), device="cpu")
    confs = {"predict": predict, "zero_shot": zero_shot, "legacy": legacy, "training": train}
    runs = {}
    for name, mesh in (("predict", (2, 1)), ("zero_shot", (2, 1)), ("legacy", (2, 1)), ("training", (2, 1)),
                       ("predict_tp", (1, 2)), ("zero_shot_tp", (1, 2)), ("legacy_tp", (1, 2))):
        run = name.split("_tp")[0]
        runs[name] = (run, dict(confs[run], mesh_data=mesh[0], mesh_model=mesh[1], model_training_root=root / f"two_{name}"))
    ranks = spawn(engine_task, 2, {"runs": runs})
    many = {name: [r[name] for r in ranks] for name in runs}
    return {"root": root, "one": one, "many": many}


def _same_dirs(ranks: list) -> None:
    """Both ranks name one run dir, the only one under its stage."""
    assert ranks[0] == ranks[1]
    assert [p.name for p in ranks[0].parent.iterdir()] == [ranks[0].name]


@pytest.mark.parametrize("date", OTHER_DATES)
@pytest.mark.parametrize("name", ["predict", "zero_shot", "predict_tp", "legacy", "legacy_tp", "zero_shot_tp"])
def test_engines_on_two_ranks_write_the_one_rank_outputs(world, name, date):
    got_dir = world["many"][name][0]
    want_dir = world["one"][name.split("_tp")[0]]
    _same_dirs(world["many"][name])
    if name.startswith("legacy"):
        # a 1-bit GeoTIFF and a shoreline shapefile (.shp, .shx, .dbf, .prj) per
        # exported class, for each date whose crops hold data (the first here)
        names = lambda d: sorted(p.name for p in d.iterdir() if f"_{date}." in p.name)  # noqa: E731
        assert names(got_dir) == names(want_dir)
        tifs = [n for n in names(want_dir) if n.endswith(".tif")]
        if date == OTHER_DATES[0]:
            assert {t.split("_")[0] for t in tifs} == {"WetDryLine", "VegLine"}
            assert {n.rsplit(".", 1)[1] for n in names(want_dir)} == {"tif", "shp", "shx", "dbf", "prj"}
        for n in names(want_dir):
            if not n.endswith(".tif"):
                assert (got_dir / n).read_bytes() == (want_dir / n).read_bytes(), n
    else:
        tifs = [f"tif/{date}.tif"]
        png = lambda d: np.asarray(Image.open(d / "masks" / f"{date}.png"))  # noqa: E731
        np.testing.assert_array_equal(png(got_dir), png(want_dir))
    for t in tifs:
        want, got = read(want_dir / t), read(got_dir / t)
        np.testing.assert_array_equal(got.data, want.data)
        assert got.transform.to_tuple() == want.transform.to_tuple() and got.crs == want.crs
        assert len(np.unique(want.data)) >= (2 if name.startswith("legacy") else 3)


@pytest.mark.parametrize("name", ["predict", "zero_shot", "predict_tp", "training", "legacy", "legacy_tp",
                                  "zero_shot_tp"])
def test_two_ranks_write_the_one_rank_files(world, name):
    """The same file names as the 1-process run (rank 1 writes no log in
    the engines; in training it writes log.rank1.log and nothing else)."""
    got_dir, want_dir = world["many"][name][0], world["one"][name.split("_tp")[0]]
    # tensorboard event files carry the time in their names
    files = lambda d: sorted("tb/events" if p.parent.name == "tb" else str(p.relative_to(d))  # noqa: E731
                             for p in d.rglob("*") if p.is_file())
    extra = ["log.rank1.log"] if name == "training" else []
    assert files(got_dir) == sorted(files(want_dir) + extra)


def test_training_on_two_ranks_tunes_the_one_rank_prompts(world):
    got_dir, want_dir = world["many"]["training"][0], world["one"]["training"]
    _same_dirs(world["many"]["training"])
    for name in ("prompt_batch.npz", "prompt_batch_tuned.npz", "prompt_batch_ema.npz"):
        got, want = load_prompt_batch(got_dir / name), load_prompt_batch(want_dir / name)
        np.testing.assert_array_equal(got["mask"], want["mask"])
        np.testing.assert_allclose(got["image"], want["image"], rtol=1e-5, atol=1e-6, err_msg=name)
    assert not np.array_equal(load_prompt_batch(want_dir / "prompt_batch_tuned.npz")["image"],
                              load_prompt_batch(want_dir / "prompt_batch.npz")["image"])
    rows = lambda d: (d / "metrics.csv").read_text().splitlines()  # noqa: E731
    assert len(rows(got_dir)) == len(rows(want_dir))
