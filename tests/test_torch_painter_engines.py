"""Painter through the port's scene runtime on the CPU: ``run_training``
from a weight file that stores a tiny Painter's topology (windows of 3 that
pad the 8×8 grid of a 128×64 canvas, block 1 global), then ``run_predict``
from that run, which takes the topology from the run's checkpoint. Every
windowed block runs its window layout in both; the vote GeoTIFF holds
class ids."""

import numpy as np

from beach_seg_tpu_torch.config import BeachSegConfig, PredictionConfig
from beach_seg_tpu_torch.geo.tiff import read
from beach_seg_tpu_torch.infer import run_predict
from beach_seg_tpu_torch.models.seggpt import build_model, save_params, tiny_config
from beach_seg_tpu_torch.models.seggpt import model as model_mod
from beach_seg_tpu_torch.train.loop import config_for, run_training
from tests.synthetic_scene import OTHER_DATES, build_scene
from tests.torch_train_common import IDENTITY_AUG


def test_painter_trains_and_predicts_a_scene(tmp_path, monkeypatch):
    cfg = tiny_config(image_size=(128, 64), num_hidden_layers=3, merge_index=1, intermediate_hidden_state_indices=(1, 2),
                      initializer_range=0.2, window_size=3, global_attn_indexes=(1,), type_tokens=False)
    save_params(build_model(cfg, device="cpu").state_dict(), tmp_path / "weights.npz", cfg)
    calls = []
    real = model_mod.window_partition
    monkeypatch.setattr(model_mod, "window_partition", lambda x, w: calls.append(w) or real(x, w))
    kw = dict(data=build_scene(tmp_path / "scene"), crop_size=32, inpt_size=64, batch_size=2,
              checkpoint=str(tmp_path / "weights.npz"), mesh_data=1, mesh_model=1, workers=0)
    conf = BeachSegConfig(model_training_root=tmp_path / "runs", epochs=1, warmup_epochs=0, num_viz_images=0,
                          **IDENTITY_AUG, **kw)
    assert config_for(conf) == cfg
    run_dir = run_training(conf, device="cpu")
    trained = len(calls)
    assert trained > 0 and set(calls) == {3}
    pred_dir = run_predict(PredictionConfig(train_run_dir=run_dir, model_training_root=tmp_path / "pred", **kw),
                           device="cpu")
    assert len(calls) > trained
    ids = read(pred_dir / "tif" / f"{OTHER_DATES[0]}.tif").data
    assert ids.size and set(np.unique(ids).tolist()) <= {0, 1, 2, 3}
