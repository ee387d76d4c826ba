"""Scene-level golden parity of the port's prompt-tuned chain: the port's
``train.loop.run_training`` → ``prompt_batch_tuned.npz`` →
``infer.predict.run_predict`` against the reference's own predict loop,
re-run over transformers' SegGpt on the same weights and the same tuned
prompts. The counterpart of scripts/golden_parity_tuned.py, which holds the
JAX chain to the same loop.

    python scripts/golden_parity_tuned_torch.py [--checkpoint DIR] [--dtype float32 [bfloat16]]
        [--device cuda|cpu] [--tiny] [--scene DIR] [--parity-file PATH] [--work DIR]

The oracle (``reference_tuned_predict``) is src/predict.py:232-262 with
src/model.py:132-175 of the reference, per (date, crop) at batch 1: all-nodata
crops skipped, ImageNet normalisation, the crop's own tuned prompt, the
Painter palette on both sides (the reference draws a random palette per
predict forward, an RNG quirk that no two frameworks can share; its eval path
uses Painter's), the L2-argmin decode against the normalised palette, the
nearest-neighbour back-resize of cv2's INTER_NEAREST (``resize_nearest``,
its index rule in NumPy: no cv2 here), then the uint8 one-hot clipped vote
paste and the argmax. It reads the prompts the port's own ``run_training``
exported, as the reference's predict reads its ``prompt_batch.pt``.

Weights, devices, ``--tiny`` and the gate as in scripts/golden_parity_torch.py:
one local HF SegGpt directory for both sides, the oracle in fp32 eager with
TF32 off, the port's training in fp32 (crops of 112, or 48 with ``--tiny``)
and its ``run_predict`` (vote merge) once per ``--dtype``, each held to the
fp32 oracle. Writes the tuned-predict section of PARITY_TORCH.md and exits
non-zero when an fp32 run's worst per-class IoU is below IOU_MIN.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from golden_parity_torch import (  # noqa: E402
    BATCH,
    IOU_MIN,
    class_shares,
    compare,
    load_oracle,
    parse_args,
    prepare,
    read_ids,
    report,
)

from beach_seg_tpu_torch.config import BeachSegConfig, PredictionConfig  # noqa: E402
from beach_seg_tpu_torch.data.dataset import create_scene, get_crop_arrays  # noqa: E402
from beach_seg_tpu_torch.geo.extent import group_images_by_date  # noqa: E402
from beach_seg_tpu_torch.geo.mosaic import merge_tifs  # noqa: E402

EPOCHS = 1  # of the port's training: the export only has to exist
CROP = {"full": 112, "tiny": 48}  # BeachSegConfig's default crops; the JAX script's on its small scene
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def ref_build_palette(num_labels: int) -> np.ndarray:
    """The reference's Painter palette (src/util/ml_util.py:72-89)."""
    base = int(num_labels ** (1 / 3)) + 1
    margin = 256 // base
    colors = [(0, 0, 0)]
    for location in range(num_labels):
        colors.append(
            (
                255 - (location // base**2) * margin,
                255 - ((location % base**2) // base) * margin,
                255 - (location % base) * margin,
            )
        )
    return np.asarray(colors, np.float32)


def resize_nearest(a: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(a, (w, h), interpolation=cv2.INTER_NEAREST)`` for
    ``size`` = (h, w): output index x reads source index floor(x · (1 /
    (w / src_w))), clamped to the last, the scale inverted in double
    precision as OpenCV's resizeNN does."""

    def index(n_out: int, n_in: int) -> np.ndarray:
        inv = 1.0 / (n_out / n_in)
        return np.minimum(np.floor(np.arange(n_out) * inv).astype(np.int64), n_in - 1)

    return a[index(size[0], a.shape[0])[:, None], index(size[1], a.shape[1])[None, :]]


def normalize_chw(img_hwc: np.ndarray) -> torch.Tensor:
    """ImageNet Normalize, channels-first float32 (data.py:218, K.Normalize)."""
    x = (img_hwc.astype(np.float32) - IMAGENET_MEAN) / IMAGENET_STD
    return torch.from_numpy(x.transpose(2, 0, 1)[None].copy())


def tuned_inputs(item: dict, prompt_pixels: np.ndarray, prompt_masks: np.ndarray, palette: np.ndarray) -> tuple:
    """One (date, crop) item's normalised query, its crop's tuned prompt and
    the prompt's palette-painted mask, (1, 3, S, S) each (model.py:132-144)."""
    crop_idx = int(item["crop_idx"])
    color = palette[prompt_masks[crop_idx].astype(np.int64)] / 255.0  # (S, S, 3)
    return normalize_chw(item["image"]), normalize_chw(prompt_pixels[crop_idx]), normalize_chw(color)


def reference_tuned_predict(tmodel, conf: BeachSegConfig, scene, predict_dates: dict, prompt_pixels: np.ndarray,
                            prompt_masks: np.ndarray, palette: np.ndarray, device=None) -> tuple[dict, dict]:
    """src/predict.py:232-262 over the HF model on ``device``, with the
    Painter ``palette``. ``predict_dates``: {date: (mosaic, nodata)};
    ``prompt_pixels`` the tuned prompt images in [0, 1] (the reference's
    ``prompt_batch.pt``), ``prompt_masks`` their label rasters, one per
    crop of ``scene``. → ({date: uint8 ids}, {date: the valid pixels:
    voted and with data}, {date: each pixel's smallest decode margin over
    the crops that voted for it, √d₂ − √d₁ of its two nearest palette
    entries (+inf where no crop voted)}): an output that moves by less
    than half a pixel's margin cannot change its id."""
    num_classes = len(conf.classes)
    pal_norm = (palette / 255.0 - IMAGENET_MEAN) / IMAGENET_STD  # (C, 3)
    ref_masks, valid, margins = {}, {}, {}
    h_out, w_out = scene.out_shape
    with torch.no_grad():
        for date in sorted(predict_dates):
            merged_img, merged_nodata = predict_dates[date]
            date_scene = dataclasses.replace(scene, date_merged_imgs={date: (merged_img, merged_nodata)}, date_masks={})
            pred_counter = np.zeros((*scene.out_shape, num_classes), np.uint8)
            margin = np.full(scene.out_shape, np.inf, np.float32)
            for crop_idx in range(len(scene.crops)):
                item = get_crop_arrays(date_scene, date, crop_idx, conf)
                if item["nodata"].all():  # predict.py:235
                    continue
                query, p_img, p_mask = tuned_inputs(item, prompt_pixels, prompt_masks, palette)
                out = tmodel(pixel_values=query.to(device), prompt_pixel_values=p_img.to(device),
                             prompt_masks=p_mask.to(device), embedding_type="instance")
                pred = out.pred_masks[0].cpu().numpy()  # (3, 2H, W)
                h = pred.shape[1] // 2
                mask_half = pred[:, h:, :].transpose(1, 2, 0)  # (H, W, 3)
                dist = ((mask_half[:, :, None, :] - pal_norm[None, None]) ** 2).sum(-1)
                ids = np.argmin(dist, axis=-1).astype(np.uint8)  # model.py:165-173
                ids = resize_nearest(ids, (conf.crop_size, conf.crop_size))  # predict.py:259
                near = np.sqrt(np.partition(dist, 1, axis=-1)[:, :, :2])
                crop_margin = resize_nearest(near[:, :, 1] - near[:, :, 0], (conf.crop_size, conf.crop_size))
                one_hot = np.eye(num_classes, dtype=np.uint8)[ids]
                xmin, ymin, xmax, ymax = scene.crops[crop_idx]
                dy0, dy1 = max(ymin, 0), min(ymax, h_out)
                dx0, dx1 = max(xmin, 0), min(xmax, w_out)
                sy0, sx0 = dy0 - ymin, dx0 - xmin
                pred_counter[dy0:dy1, dx0:dx1] += one_hot[sy0 : sy0 + (dy1 - dy0), sx0 : sx0 + (dx1 - dx0)]
                np.minimum(margin[dy0:dy1, dx0:dx1], crop_margin[sy0 : sy0 + (dy1 - dy0), sx0 : sx0 + (dx1 - dx0)],
                           out=margin[dy0:dy1, dx0:dx1])
            ref_masks[date] = np.argmax(pred_counter, axis=2).astype(np.uint8)
            valid[date] = (pred_counter.sum(axis=2) > 0) & ~merged_nodata
            margins[date] = margin
    return ref_masks, valid, margins


def model_error(tmodel, model, conf: BeachSegConfig, scene, predict_dates: dict, prompt_pixels: np.ndarray,
                prompt_masks: np.ndarray, palette: np.ndarray, device=None, limit: int = 8) -> dict:
    """The port's SegGPT ``model`` (its engine's forward: query-only decode)
    against the HF model on the oracle's inputs of the first ``limit``
    (date, crop) items with data: the largest |Δ| of the query half's
    outputs and the largest |output|. Two outputs that differ by δ can only
    decode to different ids where a pixel's margin (``reference_tuned_predict``)
    is below 2δ."""
    err = scale = 0.0
    n = 0
    with torch.no_grad():
        for date in sorted(predict_dates):
            date_scene = dataclasses.replace(scene, date_merged_imgs={date: predict_dates[date]}, date_masks={})
            for crop_idx in range(len(scene.crops)):
                item = get_crop_arrays(date_scene, date, crop_idx, conf)
                if item["nodata"].all() or n == limit:
                    continue
                query, p_img, p_mask = (t.to(device) for t in tuned_inputs(item, prompt_pixels, prompt_masks, palette))
                want = tmodel(pixel_values=query, prompt_pixel_values=p_img, prompt_masks=p_mask,
                              embedding_type="instance").pred_masks.permute(0, 2, 3, 1)
                nhwc = [t.permute(0, 2, 3, 1) for t in (query, p_img, p_mask)]
                got = model(*nhwc, embedding_type="instance", decode_query_only=True)["pred_masks"]
                h = want.shape[1] // 2
                err = max(err, (got[:, h:] - want[:, h:]).abs().max().item())
                scale = max(scale, want[:, h:].abs().max().item())
                n += 1
    return {"max_abs_err": err, "max_abs": scale, "items": n}


def near_ties(ref_masks: dict, got: dict, valid: dict, margins: dict, bound: float | None = None) -> dict:
    """Where the engine's ids differ from the oracle's: how many pixels,
    the largest decode margin among them, how many valid pixels have a
    margin at most that large (all of the differing pixels are near ties
    when that count is a small share of the valid pixels), and with
    ``bound`` (2·``model_error``'s |Δ|) how many differing pixels lie
    below it, where the arithmetic alone can flip an id."""
    differ = {d: (got[d] != ref_masks[d]) & valid[d] for d in ref_masks}
    n = sum(int(m.sum()) for m in differ.values())
    top = max((float(margins[d][differ[d]].max()) for d in ref_masks if differ[d].any()), default=0.0)
    below = sum(int(((margins[d] <= top) & valid[d]).sum()) for d in ref_masks) if n else 0
    out = {"differing_pixels": n, "largest_margin": top, "valid_pixels_within": below,
           "valid_pixels": sum(int(v.sum()) for v in valid.values()),
           "median_margin": float(np.median(np.concatenate([margins[d][valid[d]] for d in ref_masks])))}
    if bound is not None:
        out["bound"] = bound
        out["differing_below_bound"] = sum(int((margins[d][differ[d]] < bound).sum()) for d in ref_masks)
    return out


def predict_mosaics(scene_dir: Path, scene) -> dict:
    """{date: (mosaic, nodata)} of every date but the reference's."""
    groups = group_images_by_date(list((Path(scene_dir) / "SatelliteImagery").glob("*/*.tif")))
    groups.pop(scene.mask_date, None)
    return {date: merge_tifs(paths, scene.out_shape, scene.out_transform, scene.crs) for date, paths in groups.items()}


def port_model_error(tmodel, info: dict, conf, scene, mosaics: dict, pb: dict, palette, dtype: str) -> dict:
    """``model_error`` of the port's SegGPT in ``dtype``, built from the
    run's checkpoint as its engines build it."""
    from beach_seg_tpu_torch.models.seggpt import build_model
    from beach_seg_tpu_torch.models.seggpt.load import load_model_params

    device = info["device"]
    state = load_model_params(info["port_checkpoint"], info["config"], device)
    model = build_model(info["config"], torch.bfloat16 if dtype == "bfloat16" else torch.float32, device=device,
                        state=state)
    return model_error(tmodel, model, conf, scene, mosaics, pb["image"], pb["mask"], palette, device)


def train_conf(scene_dir: Path, out: Path, checkpoint: str, tiny: bool) -> BeachSegConfig:
    size = "tiny" if tiny else "full"
    return BeachSegConfig(data=scene_dir, model_training_root=out, checkpoint=checkpoint, crop_size=CROP[size],
                          batch_size=BATCH[size], epochs=EPOCHS, compute_dtype="float32", num_viz_images=0,
                          mesh_data=1, mesh_model=1)


def predict_conf(scene_dir: Path, out: Path, run_dir: Path, dtype: str, tiny: bool) -> PredictionConfig:
    """run_predict from ``run_dir``'s tuned export (its conf.yaml carries the
    checkpoint and crop sizes), vote merge."""
    return PredictionConfig(data=scene_dir, model_training_root=out, prediction_root=out, train_run_dir=run_dir,
                            batch_size=BATCH["tiny" if tiny else "full"], compute_dtype=dtype, merge="vote",
                            mesh_data=1, mesh_model=1)


def run(args) -> dict:
    """The tuned chain: the port's training (fp32) and its run_predict per
    dtype, the oracle once in fp32 on the tuned export, the comparison."""
    from beach_seg_tpu_torch.infer import run_predict
    from beach_seg_tpu_torch.train import run_training
    from beach_seg_tpu_torch.train.checkpoint import load_prompt_batch

    tmp = args.work or Path(tempfile.mkdtemp(prefix="golden_tuned_torch_"))
    try:
        info = prepare(args, tmp)
        device, seconds = info["device"], info["seconds"]
        conf = train_conf(info["scene"], tmp / "train", info["port_checkpoint"], args.tiny)
        t = time.perf_counter()
        run_dir = run_training(conf, device=device)
        seconds["port_run_training"] = time.perf_counter() - t
        runs, out_dirs = {}, {}
        for dtype in args.dtype:
            t = time.perf_counter()
            out_dirs[dtype] = run_predict(predict_conf(info["scene"], tmp / "predict", run_dir, dtype, args.tiny),
                                          device=device)
            seconds[f"port_{dtype}"] = time.perf_counter() - t
        t = time.perf_counter()
        pb = load_prompt_batch(run_dir / "prompt_batch_tuned.npz")
        scene = create_scene(conf, train=True)
        tmodel = load_oracle(info["checkpoint"], device)
        mosaics, palette = predict_mosaics(info["scene"], scene), ref_build_palette(len(conf.classes) - 1)
        ref, valid, margins = reference_tuned_predict(tmodel, conf, scene, mosaics, pb["image"], pb["mask"], palette,
                                                      device)
        seconds["oracle"] = time.perf_counter() - t
        shares = class_shares(ref, valid, len(conf.classes))
        ties = {}
        for dtype, out_dir in out_dirs.items():
            got = read_ids(out_dir, ref)
            runs[dtype] = compare(ref, got, len(conf.classes))
            err = port_model_error(tmodel, info, conf, scene, mosaics, pb, palette, dtype)
            ties[dtype] = {**near_ties(ref, got, valid, margins, 2 * err["max_abs_err"]), "model_error": err}
            print(json.dumps({"chain": "tuned", "dtype": dtype, "near_ties": ties[dtype]}), flush=True)
        del tmodel
        intro = [f"The port's `run_training` (fp32, crops of {conf.crop_size} at {conf.inpt_size}, {EPOCHS} epoch) → "
                 "`prompt_batch_tuned.npz` → `run_predict` (vote) against src/predict.py:232-262 and src/model.py:132-175 "
                 "re-run over HF `SegGptForImageSegmentation` at batch 1 on the same tuned prompts, Painter palette on both "
                 f"sides, same scene ({len(ref)} predict dates) and device ({device.type}). Produced by "
                 f"`python scripts/golden_parity_tuned_torch.py{' --tiny --device cpu' if args.tiny else ''}`; seconds "
                 + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items()) + ".", "",
                 "Pixels whose ids differ from the oracle's, against their decode margins (√d₂ − √d₁ of the two "
                 "nearest palette entries; an output moved by δ flips only margins below 2δ): " + "; ".join(
                     f"{dtype} {t['differing_pixels']} of {t['valid_pixels']} valid pixels, "
                     f"{t['differing_below_bound']} of them below 2·max|Δ| = {t['bound']:.6g} (the port's and HF's "
                     f"outputs on {t['model_error']['items']} crops: max|Δ| {t['model_error']['max_abs_err']:.6g} "
                     f"of max|output| {t['model_error']['max_abs']:.6g}; median margin {t['median_margin']:.6g})"
                     for dtype, t in ties.items()) + "."]
        worst = report("tuned", args, info, runs, shares, conf.classes, intro)
        return {"runs": runs, "worst": worst, "shares": shares, "seconds": seconds, "head_scale": info["head_scale"],
                "reference": ref, "near_ties": ties, "run_dir": run_dir}
    finally:
        if args.work is None:
            shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    res = run(parse_args(argv, __doc__))
    fp32 = res["worst"].get("float32")
    if fp32 is not None and fp32 < IOU_MIN:
        print(f"tuned-predict parity: fp32 worst per-class IoU {fp32:.6f} < {IOU_MIN}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
