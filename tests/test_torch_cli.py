"""The port's command-line entry points (python -m beach_seg_tpu_torch.cli.*)
as subprocesses on the CPU (platform=cpu, one torch thread each), from the
repository root, on the synthetic scene with tests/test_cli.py's arguments:

- train → predict: the printed run dirs hold the files of the same runs made
  in this process (run_training, run_predict), the prompt exports and the
  vote GeoTIFFs equal;
- compare: its JSON equals the JAX package's compare_dirs on the same two
  directories, for two identical runs and for two that differ (the tuned
  and the zero-shot engine's GeoTIFFs of the same dates);
- predict_no_prompt and legacy on the same scene (a small stored topology
  on the 896×448 canvas the HF processor needs: patches of 32, a narrow
  decoder), their outputs equal to the same runs in this process;
- convert_checkpoint on a local HF directory of a random tiny
  SegGptForImageSegmentation: its npz equals, array for array, what the JAX
  package's convert_torch_state_dict + save_params write;
- predict with world_size=2 and mesh_data=2 under the launcher's variables,
  through gloo: both ranks print one run dir, its GeoTIFFs those of the
  1-process run;
- a start that cannot succeed (the launcher's MASTER_PORT held by another
  socket) exits non-zero without running in one process.

Unlike tests/test_cli.py (JAX recompiles per process), these subprocesses
compile nothing and stay unmarked."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from beach_seg_tpu.cli.compare import compare_dirs as jcompare_dirs
from beach_seg_tpu.geo.tiff import read
from beach_seg_tpu.models.seggpt import convert as jconvert
from beach_seg_tpu.models.seggpt.config import SegGPTConfig as JSegGPTConfig
from beach_seg_tpu.models.seggpt.load import _torch_state_dict as jtorch_state_dict
from beach_seg_tpu_torch.config import BeachSegConfig, LegacyConfig, PredConfig, PredictionConfig
from beach_seg_tpu_torch.infer import run_legacy, run_predict, run_zero_shot
from beach_seg_tpu_torch.train import run_training
from tests.synthetic_scene import OTHER_DATES, build_scene
from tests.torch_parallel_common import small_canvas_weights
from tests.torch_train_common import one_torch_thread  # noqa: F401  (autouse: in-process runs on one thread)

ROOT = Path(__file__).resolve().parents[1]
ENV_ARGS = ["crop_size=32", "inpt_size=64", "batch_size=2", "debug=true", "checkpoint=random", "mesh_data=1",
            "mesh_model=1", "num_viz_images=0", "platform=cpu"]


def _env(**launcher) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        env.pop(k, None)
    env.update({k: str(v) for k, v in launcher.items()})
    return env


def _start(module: str, *args: str, **launcher) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-m", f"beach_seg_tpu_torch.cli.{module}", *map(str, args)], cwd=ROOT,
                            env=_env(**launcher), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(proc: subprocess.Popen) -> str:
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, f"{proc.args}\nSTDOUT:{out}\nSTDERR:{err[-3000:]}"
    return out


def _last_line(proc: subprocess.Popen) -> Path:
    return Path(_finish(proc).strip().splitlines()[-1])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _hf_checkpoint(path: Path) -> None:
    """A random tiny HF SegGPT with the default config's 24 layers (the
    converters walk SegGPTConfig()'s layers), saved as model.safetensors."""
    from tests.test_seggpt_parity import make_torch_model

    from beach_seg_tpu.models.seggpt.config import tiny_config

    model, _ = make_torch_model(tiny_config(num_hidden_layers=24, intermediate_hidden_state_indices=(5, 11, 17, 23)))
    model.save_pretrained(path, safe_serialization=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every CLI run, started as soon as its inputs exist and overlapping
    the same runs made in this process."""
    root = tmp_path_factory.mktemp("cli")
    scene = build_scene(root / "scene")
    small_canvas_weights(root / "small.npz")
    small = dict(batch_size=2, debug=True, checkpoint=str(root / "small.npz"))
    zero_shot = dict(small, zero_shot_crop_size=64, n_prompts=2)
    legacy = dict(small, crop_size=48, n_prompts=2)
    args = lambda kw: [f"{k}={str(v).lower() if isinstance(v, bool) else v}" for k, v in kw.items()]  # noqa: E731
    procs = {
        "train": _start("train", f"data={scene}", f"model_training_root={root / 'cli'}", "epochs=1", *ENV_ARGS),
        "zero_shot": _start("predict_no_prompt", f"data={scene}", f"model_training_root={root / 'cli'}", *args(zero_shot),
                            "platform=cpu"),
        "legacy": _start("legacy", f"data={scene}", f"model_training_root={root / 'cli'}", *args(legacy), "platform=cpu"),
    }
    _hf_checkpoint(root / "hf")
    procs["convert"] = _start("convert_checkpoint", root / "hf", root / "converted.npz")
    out = {"root": root, "scene": scene, "train": _last_line(procs["train"])}
    predict = [f"data={scene}", f"train_run_dir={out['train']}", *ENV_ARGS]
    port = _free_port()
    procs["predict"] = _start("predict", *predict, f"model_training_root={root / 'cli'}")
    for r in range(2):
        procs[f"rank{r}"] = _start("predict", *predict, f"model_training_root={root / 'ranks'}", "world_size=2",
                                   "mesh_data=2", RANK=r, WORLD_SIZE=2, LOCAL_RANK=r, MASTER_ADDR="localhost",
                                   MASTER_PORT=port)

    # the same runs in this process
    typed = dict(crop_size=32, inpt_size=64, batch_size=2, debug=True, mesh_data=1, mesh_model=1, num_viz_images=0)
    assert args(typed) == [a for a in ENV_ARGS if not a.startswith(("checkpoint", "platform"))]
    out["train_here"] = run_training(BeachSegConfig(data=scene, model_training_root=root / "here", epochs=1,
                                                    checkpoint="random", **typed), device="cpu")
    out["predict_here"] = run_predict(PredictionConfig(data=scene, train_run_dir=out["train"], batch_size=2, debug=True,
                                                       checkpoint="random", model_training_root=root / "here"), device="cpu")
    out["zero_shot_here"] = run_zero_shot(PredConfig(data=scene, model_training_root=root / "here", **zero_shot),
                                          device="cpu")
    out["legacy_here"] = run_legacy(LegacyConfig(data=scene, model_training_root=root / "here", **legacy), device="cpu")
    for name in ("predict", "rank0", "rank1", "zero_shot", "legacy"):
        out[name] = _last_line(procs[name])
    out["convert_stdout"] = _finish(procs["convert"])
    compares = {other: _start("compare", out["predict"] / "tif", out[other] / "tif") for other in ("predict_here", "zero_shot")}
    out["compare"] = {other: json.loads(_finish(proc)) for other, proc in compares.items()}
    return out


def _files(d: Path) -> list[str]:
    # tensorboard event files carry the time in their names
    return sorted("tb/events" if p.parent.name == "tb" else str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())


def test_train_writes_the_in_process_run(runs):
    from beach_seg_tpu_torch.train.checkpoint import load_prompt_batch

    got, want = runs["train"], runs["train_here"]
    assert _files(got) == _files(want)
    for name in ("prompt_batch.npz", "prompt_batch_tuned.npz", "prompt_batch_ema.npz", "prompt_batch_best.npz"):
        g, w = load_prompt_batch(got / name), load_prompt_batch(want / name)
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=f"{name}:{k}")


@pytest.mark.parametrize("name", ["predict", "zero_shot", "legacy"])
def test_predictors_write_the_in_process_runs(runs, name):
    got, want = runs[name], runs[f"{name}_here"]
    assert _files(got) == _files(want)
    tifs = sorted(want.rglob("*.tif"))
    assert len(tifs) >= len(OTHER_DATES)
    for p in tifs:
        np.testing.assert_array_equal(read(got / p.relative_to(want)).data, read(p).data, err_msg=str(p))


@pytest.mark.parametrize("other", ["predict_here", "zero_shot"], ids=["identical", "different"])
def test_compare_prints_the_jax_compare_dirs(runs, other):
    got = runs["compare"][other]
    want = jcompare_dirs(runs["predict"] / "tif", runs[other] / "tif")
    assert got == want
    assert sorted(got["dates"]) == sorted(OTHER_DATES)
    if other == "predict_here":
        assert got["pixel_agreement"] == 1.0 and got["overall_mean_iou"] == 1.0
    else:
        assert got["pixel_agreement"] < 1.0


def test_convert_checkpoint_writes_the_jax_conversion(runs):
    root = runs["root"]
    params = jconvert.convert_torch_state_dict(jtorch_state_dict(root / "hf"), JSegGPTConfig())
    jconvert.save_params(params, root / "jax_converted.npz")
    with np.load(root / "converted.npz") as got, np.load(root / "jax_converted.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert runs["convert_stdout"].startswith(f"wrote {root / 'converted.npz'} (")


def test_two_rank_predict_through_the_launcher_variables(runs):
    """world_size=2, mesh_data=2, RANK/WORLD_SIZE/MASTER_ADDR/MASTER_PORT
    set as torchrun sets them: one run dir, the 1-process run's GeoTIFFs."""
    assert runs["rank0"] == runs["rank1"]
    assert [p.name for p in runs["rank0"].parent.iterdir()] == [runs["rank0"].name]
    assert _files(runs["rank0"]) == _files(runs["predict"])
    for date in OTHER_DATES:
        np.testing.assert_array_equal(read(runs["rank0"] / "tif" / f"{date}.tif").data,
                                      read(runs["predict"] / "tif" / f"{date}.tif").data)


def test_a_failed_start_exits_without_running_single_process(runs, tmp_path):
    with socket.socket() as held:
        held.bind(("localhost", 0))
        held.listen(1)
        proc = _start("predict", f"data={runs['scene']}", f"train_run_dir={runs['train']}",
                      f"model_training_root={tmp_path}", *ENV_ARGS, RANK=0, WORLD_SIZE=2, LOCAL_RANK=0,
                      MASTER_ADDR="localhost", MASTER_PORT=held.getsockname()[1])
        out, err = proc.communicate(timeout=300)
    assert proc.returncode != 0
    assert "EADDRINUSE" in err or "address already in use" in err, err[-2000:]
    assert not list(tmp_path.iterdir())  # nothing ran: no run dir
