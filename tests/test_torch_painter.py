"""Painter (``painter_config``, ``BeachSegConfig.backbone="painter"``): the
port's windowed and global blocks against the benchmark's plain Painter
(``portbench/reference/painter.py``, float32 PyTorch that owes the port
nothing), on the benchmark's seeded Painter weights at a tiny size in fp32:

- the painted canvas of a forward and the prompt-pixel gradient of the
  nodata loss (``PromptTuner.loss_and_grad`` under the benchmark's draws),
  for a window that divides the 8×4 grid (4) and one that pads it (3, to
  9×6), globals at blocks 2 and 5, through kernel #1's path (head_dim 64)
  and the packed path (head_dim 8);
- ``window_size=0`` runs SegGPT's operations: the output of a model with
  every block global equals it bit for bit;
- ``config_for`` and the ``.npz`` topology.

On the card (``gpu``): the windowed attention at Painter ViT-L's widths
through #1 and #4 at a 14×14 grid against their plain versions, and one
bf16 train step's prompt gradient against the reference's.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from beach_seg_tpu_torch.config import BeachSegConfig
from beach_seg_tpu_torch.models.seggpt import build_model, painter_config, save_params, tiny_config
from beach_seg_tpu_torch.models.seggpt.convert import load_config, load_npz
from beach_seg_tpu_torch.models.seggpt.model import window_partition, window_unpartition
from beach_seg_tpu_torch.ops import cuda_attn
from beach_seg_tpu_torch.train import PromptTuner
from beach_seg_tpu_torch.train.loop import config_for, model_for_config
from portbench.reference import painter as ref
from portbench.reference import seggpt as ref_seggpt
from portbench.traffic import draws as traffic_draws
from portbench.traffic.painter_weights import make_weights

ROOT = Path(__file__).resolve().parents[1]
AUG = json.loads((ROOT / "portbench" / "configs" / "seggpt_vit_h_fp32.json").read_text())["augment"]
H = 32  # crops and prompts: a (64, 32) canvas of 8-pixel patches, an 8×4 grid
GEOMS = {"hd64": dict(hidden_size=128, num_attention_heads=2), "hd8": {}}
WINDOWS = {"divides": 4, "pads": 3}
INIT = {"std": 0.02, "head_std": 0.3}


def tiny_painter(geometry: str, window: int, **over):
    return tiny_config(**GEOMS[geometry], window_size=window, global_attn_indexes=(2, 5), type_tokens=False, **over)


def model_dict(cfg) -> dict:
    """The config as the benchmark's files hold a model (lists, no tuples)."""
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def weights_and_model(cfg, seed: int = 3):
    w = make_weights(model_dict(cfg), INIT, seed, "cpu")
    return w, build_model(cfg, device="cpu", state=w)


def images(seed: int, n: int, b: int = 2) -> list[torch.Tensor]:
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, H, H, 3)).astype(np.float32)) for _ in range(n)]


@pytest.mark.parametrize("window", list(WINDOWS.values()), ids=list(WINDOWS))
@pytest.mark.parametrize("geometry", list(GEOMS))
def test_forward_matches_the_reference(geometry, window):
    """fp32 plain paths on both sides: the port's fused rel-term sums, its
    softmax's order of operations and LayerNorm's one-pass statistics round
    differently from the reference's op-by-op float32, up to 8.4e-7 of the
    canvas's scale over 6 blocks here; the limit is 1e-5 of it (a misplaced
    window or a missed pad moves the canvas by its own scale)."""
    cfg = tiny_painter(geometry, window)
    w, model = weights_and_model(cfg)
    q, p, pm = images(0, 3)
    with torch.no_grad():
        got = model(q, p, pm)["pred_masks"][:, H:]
        want = ref.forward(w, model_dict(cfg), q, p, pm)
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-5 * scale, (got - want).abs().max().item() / scale


@pytest.mark.parametrize("window", list(WINDOWS.values()), ids=list(WINDOWS))
@pytest.mark.parametrize("geometry", list(GEOMS))
def test_prompt_gradient_matches_the_reference(geometry, window):
    """One step's nodata loss and prompt-pixel gradient under the benchmark's
    draws (augmentation, palettes, prompt indices, stochastic depth), through
    the backward of #1 (#4's plain version) or of the packed attention:
    the loss within 1e-5 relative (it reads ≤ 1.1e-7) and the gradient's
    error within 2e-5 of its norm (it reads ≤ 2.1e-6: fp32 sums reordered
    over the batch, the windows and the heads)."""
    cfg = tiny_painter(geometry, window)
    w, model = weights_and_model(cfg)
    conf = BeachSegConfig(batch_size=2, crop_size=H, inpt_size=H, **{k: tuple(v) if isinstance(v, list) else v
                                                                       for k, v in AUG.items() if k != "erasing_ratio"})
    tuner = PromptTuner(model, conf, device="cpu")
    rng = np.random.default_rng(1)
    pixels = torch.from_numpy(rng.random((3, H, H, 3), dtype=np.float32))
    masks = torch.from_numpy(rng.integers(0, 4, (3, H, H)).astype(np.int64))
    nodata = torch.zeros((3, H, H), dtype=torch.bool)
    batch = {"image": torch.from_numpy(rng.random((2, H, H, 3), dtype=np.float32)),
             "mask": torch.from_numpy(rng.integers(1, 4, (2, H, H)).astype(np.int64)),
             "nodata": torch.zeros((2, H, H), dtype=torch.bool), "valid": torch.ones(2, dtype=torch.bool)}
    gen = torch.Generator().manual_seed(7)
    draws = traffic_draws.step_draws(gen, 2, H, 3, 4, AUG, model_dict(cfg))
    loss, grad = tuner.loss_and_grad(pixels, masks, nodata, batch, tuner.step_draws(batch, 3, None, draws))[:2]
    run = {"loss_beta": conf.loss_beta}
    want_loss, want = ref.loss_and_grad(w, model_dict(cfg), run, AUG, pixels, masks, nodata, batch, draws)
    assert want.norm() > 0 and loss.item() == pytest.approx(want_loss.item(), rel=1e-5)
    assert (grad - want).norm().item() <= 2e-5 * want.norm().item()


def test_window_layout_round_trip():
    """Partition then unpartition gives the grid back, padded or not; the
    windows are row-major over the padded grid, the pad zeros."""
    x = torch.arange(2 * 8 * 4 * 3, dtype=torch.float32).reshape(2, 8, 4, 3)
    for win, (hp, wp) in ((4, (8, 4)), (3, (9, 6)), (2, (8, 4))):
        parts, padded = window_partition(x, win)
        assert padded == (hp, wp) and parts.shape == (2 * (hp // win) * (wp // win), win, win, 3)
        assert torch.equal(window_unpartition(parts, win, padded, (8, 4)), x)
        assert torch.equal(parts, ref.window_partition(x, win)[0])
    parts, _ = window_partition(x, 3)
    assert torch.equal(parts[1, :, :1], x[0, :3, 3:4]) and not parts[1, :, 1:].any()  # the right pad


@pytest.mark.parametrize("geometry", list(GEOMS))
def test_window_size_0_is_seggpt(geometry):
    """``window_size=0`` is SegGPT's topology (type tokens, every table the
    grid's); naming every block global under windows of 3 runs the same
    operations: the outputs are equal bit for bit."""
    seggpt = tiny_config(**GEOMS[geometry])
    every = dataclasses.replace(seggpt, window_size=3, global_attn_indexes=tuple(range(seggpt.num_hidden_layers)))
    assert seggpt.block_window(0) == every.block_window(0) == 0
    a, b = build_model(seggpt, device="cpu", seed=2), build_model(every, device="cpu", seed=2)
    assert "embeddings.type_token_instance" in a.state_dict()
    assert a.state_dict()["encoder.layers_0.attention.rel_pos_h"].shape[0] == 2 * seggpt.grid_size[0] - 1
    q, p, pm = images(1, 3)
    with torch.no_grad():
        for kw in ({}, {"embedding_type": "semantic", "decode_query_only": True}):
            assert torch.equal(a(q, p, pm, **kw)["pred_masks"], b(q, p, pm, **kw)["pred_masks"])


def test_painter_drops_the_type_tokens():
    cfg = tiny_painter("hd8", 4)
    state = build_model(cfg, device="meta").state_dict()
    assert not any("type_token" in k for k in state)
    assert state["encoder.layers_0.attention.rel_pos_h"].shape == (7, 8)  # 2·4 − 1 rows
    assert state["encoder.layers_2.attention.rel_pos_h"].shape == (15, 8)  # the 8×4 grid's
    assert state["encoder.layers_2.attention.rel_pos_w"].shape == (7, 8)


@pytest.mark.parametrize("inpt, grid", [(448, (56, 28)), (224, (28, 14)), (336, (42, 21))])
def test_config_for_painter(inpt, grid):
    """The published widths and 8 global blocks on the (2·inpt, inpt)
    canvas; windows of 14 at every input size (21 columns pad to 28)."""
    cfg = config_for(BeachSegConfig(backbone="painter", inpt_size=inpt))
    assert cfg == painter_config(image_size=(2 * inpt, inpt)) and cfg.grid_size == grid
    assert (cfg.hidden_size, cfg.num_hidden_layers, cfg.num_attention_heads, cfg.mlp_dim) == (1024, 24, 16, 4096)
    assert (cfg.window_size, cfg.global_attn_indexes, cfg.type_tokens) == (14, (2, 5, 8, 11, 14, 17, 20, 23), False)
    assert [i for i in range(24) if cfg.block_window(i) == 0] == [2, 5, 8, 11, 14, 17, 20, 23]
    model, got = model_for_config(BeachSegConfig(backbone="painter", inpt_size=inpt), device="meta")
    assert got == cfg and model.encoder.layers_0.window == 14 and model.encoder.layers_2.window == 0


def test_config_checks_its_fields():
    assert tiny_config(global_attn_indexes=[1, 2]).global_attn_indexes == (1, 2)  # JSON lists
    with pytest.raises(ValueError, match="outside"):
        tiny_config(window_size=3, global_attn_indexes=(6,))
    with pytest.raises(ValueError, match="window_size"):
        tiny_config(window_size=-1)


def test_npz_topology_round_trip(tmp_path):
    """A Painter ``.npz`` stores the three fields and builds the same model;
    a SegGPT one stores none of them, so the JAX package reads it."""
    cfg = tiny_painter("hd8", 3)
    w, model = weights_and_model(cfg)
    save_params(model.state_dict(), tmp_path / "p.npz", cfg)
    assert load_config(tmp_path / "p.npz") == cfg
    conf = BeachSegConfig(checkpoint=str(tmp_path / "p.npz"), backbone="large")
    assert config_for(conf) == cfg
    loaded = build_model(config_for(conf), device="cpu", state=load_npz(tmp_path / "p.npz", "cpu"))
    assert all(torch.equal(v, w[k]) for k, v in loaded.state_dict().items()) and set(loaded.state_dict()) == set(w)
    seggpt = tiny_config()
    save_params(build_model(seggpt, device="cpu").state_dict(), tmp_path / "s.npz", seggpt)
    with np.load(tmp_path / "s.npz") as data:
        stored = json.loads(bytes(data["__config_json__"]).decode())
    assert not {"window_size", "global_attn_indexes", "type_tokens"} & set(stored)
    assert load_config(tmp_path / "s.npz") == seggpt


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


BF16_EPS = 2.0**-8


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [64, 128])  # B = 8 after the stream merge, 16 before: 8 windows a row
def test_windowed_attention_at_painter_widths(cuda, rows):
    """#1 and #4 at a 14×14 grid, 16 heads of 64, Painter ViT-L's rows of
    windows, against their plain versions (``test_torch_gpu``'s limits:
    bf16 two steps of max|plain| and the error norm one step of the
    output's; the backward 1% of each output's scale)."""
    from beach_seg_tpu_torch.ops.attention import attention_bwd_plain, rel_tables_padded

    g = torch.Generator(device="cpu").manual_seed(rows)
    c, heads, grid = 1024, 16, (14, 14)
    qkv = torch.randn((rows, 196, 3, c), generator=g)
    bias = 0.1 * torch.randn((3, c), generator=g)
    rh, rw = rel_tables_padded(0.1 * torch.randn((27, 64), generator=g), 0.1 * torch.randn((27, 64), generator=g), grid, grid)
    args = [t.to(cuda, torch.bfloat16).contiguous() for t in (qkv, bias, rh, rw)] + [0.125, 14, heads]
    before = cuda_attn.attn_qkv_rel.launches
    got = cuda_attn.attn_qkv_rel(*args)
    torch.cuda.synchronize()
    assert cuda_attn.attn_qkv_rel.launches == before + 1
    want = cuda_attn.attn_qkv_rel_plain(*args)
    d = got.float() - want.float()
    assert d.abs().max().item() <= min(3e-2, 4 * BF16_EPS * want.float().abs().max().item())
    assert (d.norm() / want.float().norm()).item() <= BF16_EPS
    bh = rows * heads
    r = lambda *sh, sc=1.0: (sc * torch.randn(sh, generator=g)).to(cuda, torch.bfloat16)  # noqa: E731
    bwd = (r(bh, 196, 64), r(bh, 196, 64), r(bh, 196, 64), r(bh, 196, 14, sc=0.5), r(bh, 196, 14, sc=0.5), r(bh, 196, 64), 0.125)
    before = cuda_attn.attn_bwd.launches
    got = cuda_attn.attn_bwd(*bwd)
    torch.cuda.synchronize()
    assert cuda_attn.attn_bwd.launches == before + 1
    for name, a, w in zip(("dq", "dk", "dv", "drh", "drw"), got, attention_bwd_plain(*bwd)):
        err = (a.float() - w.float()).abs().max().item()
        assert err <= 1e-2 * w.float().abs().max().item(), (name, err)


@pytest.mark.gpu
def test_bf16_train_step_prompt_gradient(cuda):
    """One bf16 ``train_step`` of Painter at ViT-L's widths (C 1024, 16 heads
    of 64, MLP 4096) on the 896×448 canvas, 6 blocks (2 and 5 global, the
    rest in 14×14 windows), B = 2 under the benchmark's draws: #1 forward
    and #4 backward at both grids. Its prompt gradient (Adam's first moment
    after one step) against the float32 reference's: cosine ≥ 0.99 and the
    norm within 5%, the room bf16 operands (8 bits) leave over 6 blocks."""
    cfg = painter_config(num_hidden_layers=6, global_attn_indexes=(2, 5), intermediate_hidden_state_indices=(2, 3, 4, 5))
    m = model_dict(cfg)
    w = make_weights(m, INIT, 5, cuda)
    model = build_model(cfg, torch.bfloat16, device=cuda, state=w)
    conf = BeachSegConfig(batch_size=2, crop_size=448, inpt_size=448, compute_dtype="bfloat16",
                          **{k: tuple(v) if isinstance(v, list) else v for k, v in AUG.items() if k != "erasing_ratio"})
    tuner = PromptTuner(model, conf, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    pixels = torch.rand((3, 448, 448, 3), generator=g, device=cuda)
    masks = torch.randint(0, 4, (3, 448, 448), generator=g, device=cuda)
    nodata = torch.zeros((3, 448, 448), dtype=torch.bool, device=cuda)
    batch = {"image": torch.rand((2, 448, 448, 3), generator=g, device=cuda),
             "mask": torch.randint(1, 4, (2, 448, 448), generator=g, device=cuda),
             "nodata": torch.zeros((2, 448, 448), dtype=torch.bool, device=cuda),
             "valid": torch.ones(2, dtype=torch.bool, device=cuda)}
    draws = traffic_draws.step_draws(g, 2, 448, 3, 4, AUG, m)
    state = tuner.init_state(pixels)
    a0, b0 = cuda_attn.attn_qkv_rel.launches, cuda_attn.attn_bwd.launches
    state, metrics = tuner.train_step(state, masks, nodata, batch, draws=draws)
    assert cuda_attn.attn_qkv_rel.launches - a0 == 6 and cuda_attn.attn_bwd.launches - b0 == 6
    got = (state.opt_state["mu"] / 0.1).double()
    del tuner, model, state
    torch.cuda.empty_cache()
    loss, want = ref.loss_and_grad(w, m, {"loss_beta": conf.loss_beta}, AUG, pixels, masks, nodata, batch, draws,
                                   ref_seggpt.FP32)
    want = want.double()
    cos = (got * want).sum() / (got.norm() * want.norm())
    assert float(metrics["loss"]) == pytest.approx(float(loss), rel=1e-2)
    assert cos.item() >= 0.99 and abs(got.norm().item() / want.norm().item() - 1) <= 0.05, (cos.item(), got.norm().item(), want.norm().item())


@pytest.mark.gpu
def test_painter_backbone_trains_and_predicts_a_scene(cuda, tmp_path, monkeypatch):
    """``BeachSegConfig(backbone="painter")`` at its published sizes on the
    card, bf16: ``run_training`` (1 epoch, crops of 112 at 448, batch 8) on
    a 2-date scene written by ``chip_smoke.write_scene``, then
    ``run_predict`` from the run's EMA export on the second date. Both run
    the 16 windowed blocks (the layout called with 14) through #1, and the
    training its backward through #4."""
    import chip_smoke
    from beach_seg_tpu_torch.config import PredictionConfig
    from beach_seg_tpu_torch.geo.tiff import read
    from beach_seg_tpu_torch.infer import run_predict
    from beach_seg_tpu_torch.models.seggpt import model as model_mod
    from beach_seg_tpu_torch.train import run_training

    dates = chip_smoke.write_scene(tmp_path / "scene", n_dates=2)
    calls = []
    real = model_mod.window_partition
    monkeypatch.setattr(model_mod, "window_partition", lambda x, w: calls.append(w) or real(x, w))
    conf = BeachSegConfig(data=tmp_path / "scene", model_training_root=tmp_path / "train", checkpoint="random",
                          backbone="painter", compute_dtype="bfloat16", crop_size=112, inpt_size=448, batch_size=8,
                          epochs=1, num_viz_images=0)
    b0 = cuda_attn.attn_bwd.launches
    run_dir = run_training(conf)
    trained = len(calls)
    assert trained > 0 and set(calls) == {14} and trained % 16 == 0
    assert cuda_attn.attn_bwd.launches > b0
    pred = run_predict(PredictionConfig(data=tmp_path / "scene", model_training_root=tmp_path / "pred",
                                        train_run_dir=run_dir, use_ema=True, batch_size=8, compute_dtype="bfloat16"))
    assert len(calls) > trained
    ids = read(pred / "tif" / f"{dates[1]}.tif").data
    assert ids.size and set(np.unique(ids).tolist()) <= {0, 1, 2, 3}
