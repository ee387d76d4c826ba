"""Scene-level golden parity of the port's zero-shot engine: the port's
``infer.zero_shot.run_zero_shot`` against the reference's own zero-shot
mask-assembly chain, re-run over transformers' SegGpt (BASELINE.md's
"IoU >= 0.999 agreement vs reference masks"). The counterpart of
scripts/golden_parity.py, which holds the JAX engine to the same chain.

    python scripts/golden_parity_torch.py [--checkpoint DIR] [--dtype float32 [bfloat16]]
        [--device cuda|cpu] [--tiny] [--scene DIR] [--parity-file PATH] [--work DIR]

The oracle (``reference_zero_shot``) re-runs predict_no_prompt.py:228-315 of
the reference over ``SegGptForImageSegmentation`` and the PIL
``SegGptImageProcessor``: the nodata of the prompt and query mosaics painted
green, the prompts preprocessed per crop, the ranking tied to crop order
(``rank_compat=True``), the feature-ensemble forward, ``pred_masks.mean(0)``
then ``post_process_semantic_segmentation``, the nodata zeroed, the clipped
one-hot vote paste and the argmax. Scene inputs (mosaics, crops, nodata,
labels) come from the port's geo layer and feed both sides.

Both sides load one local HF SegGpt directory: the port through
``PredConfig(checkpoint=DIR)`` (``models.seggpt.load.load_model_params``),
the oracle through ``SegGptForImageSegmentation.from_pretrained(DIR)``, in
fp32, eager, with TF32 off. Without ``--checkpoint`` the directory holds HF's
own random initialisation at ``SegGptConfig()``'s topology (that of
``BAAI/seggpt-vit-large``) from ``torch.manual_seed(0)``; where those weights
paint one class over more than 95% of the valid pixels, or a labelled class
on fewer than 1% (``blind``), the decoder head is scaled by HEAD_SCALE
before ``save_pretrained`` so the decode follows the features. ``--tiny``: the CPU tests' topology (6 layers of 32 channels) on
the real 896×448 canvas, crops of 48; the engines take that topology from an
npz converted from the directory by the port's loader.

The port runs once for each ``--dtype``; every run is compared with the fp32
oracle. Writes the zero-shot section of PARITY_TORCH.md (never PARITY.md)
and exits non-zero when an fp32 run's worst per-class IoU is below IOU_MIN;
bf16 is reported, not gated. ``--device cuda`` (the default) refuses to run
without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from beach_seg_tpu_torch.config import PredConfig  # noqa: E402
from beach_seg_tpu_torch.data.dataset import create_scene  # noqa: E402
from beach_seg_tpu_torch.geo.extent import group_images_by_date  # noqa: E402
from beach_seg_tpu_torch.geo.masks import crop_tif  # noqa: E402
from beach_seg_tpu_torch.geo.mosaic import merge_tifs  # noqa: E402
from beach_seg_tpu_torch.geo.tiff import read as read_tiff  # noqa: E402
from beach_seg_tpu_torch.models.seggpt.config import SegGPTConfig, tiny_config  # noqa: E402
from beach_seg_tpu_torch.models.seggpt.convert import config_from_hf, save_params  # noqa: E402
from beach_seg_tpu_torch.models.seggpt.load import load_model_params  # noqa: E402

IOU_MIN = 0.999  # BASELINE.json's target: IoU >= 0.999 agreement vs reference masks
# random weights whose reference masks paint one class over more than
# BLIND_SHARE of the valid pixels leave the gate blind (IoU 1 for free), and
# so do masks that paint a labelled class on fewer than MIN_SHARE of them
# (its IoU is 1 for free, or a handful of pixels): such weights get their
# decoder head (weight and bias of decoder.decoder_pred.head) scaled by
# HEAD_SCALE, so the decode follows the features
BLIND_SHARE = 0.95
MIN_SHARE = 0.01
HEAD_SCALE = 3000.0
N_PROMPTS = 2
CROP = {"full": 336, "tiny": 48}  # the zero-shot crops: PredConfig's default; the JAX script's on its small scene
BATCH = {"full": 8, "tiny": 4}
PARITY_FILE = ROOT / "PARITY_TORCH.md"
PREDICT_DATES = 2  # the default scene's: chip_smoke.py phase 22's cut of phase 17's scene
DTYPES = ("float32", "bfloat16")


def hf_api():
    """transformers' SegGpt config and model classes and its PIL image
    processor: 5.x names that one ``SegGptImageProcessorPil`` (its
    ``SegGptImageProcessor`` resizes through torchvision); in 4.x
    ``SegGptImageProcessor`` is the PIL one."""
    from transformers.models.seggpt import SegGptConfig, SegGptForImageSegmentation

    try:
        from transformers.models.seggpt import SegGptImageProcessorPil as processor
    except ImportError:
        from transformers.models.seggpt import SegGptImageProcessor as processor
    return SegGptConfig, SegGptForImageSegmentation, processor


def versions() -> dict:
    import safetensors
    import transformers

    return {"transformers": transformers.__version__, "safetensors": safetensors.__version__,
            "torch": torch.__version__, "processor": hf_api()[2].__name__,
            "allow_tf32": {"cuda.matmul": torch.backends.cuda.matmul.allow_tf32,
                           "cudnn": torch.backends.cudnn.allow_tf32}}


def select_device(name: str) -> torch.device:
    """``name`` as a device, TF32 off for the oracle's products and its
    cuDNN patch-embed conv (cuDNN's TF32 is on by default); a CUDA device
    asked for without one raises SystemExit: nothing falls back to the CPU."""
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("golden parity: --device cuda, but no CUDA device is available (--device cpu runs on the CPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device(name)


def card_line(device: torch.device) -> str:
    """nvidia-smi's name and power limit of the card, or "CPU"."""
    if device.type != "cuda":
        return "CPU"
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def hf_config(tiny: bool):
    """``SegGptConfig()`` (BAAI/seggpt-vit-large's topology), or the CPU
    tests' tiny topology on the real 896×448 canvas, as
    tests/test_seggpt_parity.make_torch_model builds it."""
    hf_cfg_cls = hf_api()[0]
    if not tiny:
        return hf_cfg_cls()
    t = tiny_config(image_size=(896, 448), patch_size=16, pretrain_image_size=448, drop_path_rate=0.0)
    return hf_cfg_cls(
        hidden_size=t.hidden_size, num_hidden_layers=t.num_hidden_layers, num_attention_heads=t.num_attention_heads,
        mlp_dim=t.mlp_dim, image_size=list(t.image_size), patch_size=t.patch_size,
        pretrain_image_size=t.pretrain_image_size, decoder_hidden_size=t.decoder_hidden_size,
        merge_index=t.merge_index, intermediate_hidden_state_indices=list(t.intermediate_hidden_state_indices),
        drop_path_rate=t.drop_path_rate, beta=t.beta, initializer_range=t.initializer_range,
    )


def load_oracle(ckpt_dir: Path, device: torch.device):
    """``SegGptForImageSegmentation.from_pretrained(ckpt_dir)`` on
    ``device`` in fp32, eval mode, eager attention."""
    model = hf_api()[1].from_pretrained(str(ckpt_dir)).to(device=device, dtype=torch.float32).eval()
    impl = getattr(model.config, "_attn_implementation", "eager")
    if impl != "eager":
        raise RuntimeError(f"the oracle runs eager attention, not {impl!r}")
    return model


def reference_zero_shot(tmodel, processor, conf: PredConfig, scene, device=None,
                        max_dates: int | None = None) -> tuple[dict, dict]:
    """The reference's predict_no_prompt.py over the HF model on ``device``:
    create_prompt_dataset greens the nodata (:94-95), prompts are
    preprocessed per crop (:235-247), the ranking ties to crop order (:250),
    and each query crop votes through the Accumulator (:255-315). ``scene``:
    the reference date's scene with crops of ``conf.zero_shot_crop_size``;
    ``max_dates``: the first so many predict dates only. → ({date: uint8
    ids}, {date: the valid pixels: voted and with data})."""
    crop_size, n_prompts = conf.zero_shot_crop_size, conf.n_prompts
    num_classes = len(conf.classes)
    prompt_img, prompt_nodata = scene.date_merged_imgs[scene.mask_date]
    prompt_img = prompt_img.copy()
    prompt_img[prompt_nodata, 1] = 255
    prompt_label = scene.date_masks[scene.mask_date]

    crop_prompts, crop_labels = [], []
    for crop in scene.crops:
        ci, _, cl = crop_tif(crop, prompt_img, prompt_nodata, prompt_label, crop_size)
        inputs = processor.preprocess(prompt_images=[ci], prompt_masks=[cl], num_labels=num_classes - 1,
                                      return_tensors="pt", data_format="channels_first")
        crop_prompts.append(inputs)
        crop_labels.append(cl)
    # (cl != "sand") collapses to a scalar → all keys tie → crop order
    best_crop_idxes = np.argsort([True for _ in crop_labels])

    groups = group_images_by_date(list((Path(conf.data) / "SatelliteImagery").glob("*/*.tif")))
    groups.pop(scene.mask_date, None)
    ref_masks, valid = {}, {}
    h, w = scene.out_shape
    with torch.no_grad():
        for date, img_paths in sorted(groups.items())[:max_dates]:
            merged_img, merged_nodata = merge_tifs(img_paths, scene.out_shape, scene.out_transform, scene.crs)
            merged_img = merged_img.copy()
            merged_img[merged_nodata, 1] = 255
            pred_counter = np.zeros((*scene.out_shape, num_classes), np.uint8)
            for crop_idx, crop in enumerate(scene.crops):
                crop_img, crop_nodata, _ = crop_tif(crop, merged_img, merged_nodata, None, crop_size)
                if np.all(crop_nodata):
                    continue
                if crop_idx in best_crop_idxes[:n_prompts]:
                    crop_idxes = best_crop_idxes[:n_prompts]
                else:
                    crop_idxes = [crop_idx] + best_crop_idxes[: n_prompts - 1].tolist()
                prompts = [crop_prompts[i] for i in crop_idxes]
                inputs = processor.preprocess(images=[crop_img] * len(prompts), num_labels=num_classes - 1,
                                              return_tensors="pt", data_format="channels_first")
                batch_out = tmodel(
                    pixel_values=inputs["pixel_values"].to(device),
                    prompt_pixel_values=torch.concat([p["prompt_pixel_values"] for p in prompts]).to(device),
                    prompt_masks=torch.concat([p["prompt_masks"] for p in prompts]).to(device),
                    embedding_type="instance",
                    feature_ensemble=True,
                )
                batch_out.pred_masks = batch_out.pred_masks.mean(dim=0).unsqueeze(0)
                pred = processor.post_process_semantic_segmentation(
                    batch_out, [(crop_size, crop_size)], num_labels=num_classes - 1
                )[0].cpu().numpy()
                pred[crop_nodata.astype(bool)] = 0
                one_hot = np.eye(num_classes, dtype=np.uint8)[pred]
                # Accumulator.update clip-paste (predict_no_prompt.py:163-186)
                xmin, ymin, xmax, ymax = crop
                dy0, dy1 = max(ymin, 0), min(ymax, h)
                dx0, dx1 = max(xmin, 0), min(xmax, w)
                sy0, sx0 = dy0 - ymin, dx0 - xmin
                pred_counter[dy0:dy1, dx0:dx1] += one_hot[sy0 : sy0 + (dy1 - dy0), sx0 : sx0 + (dx1 - dx0)]
            ref_masks[date] = np.argmax(pred_counter, axis=2).astype(np.uint8)
            valid[date] = (pred_counter.sum(axis=2) > 0) & ~merged_nodata
    return ref_masks, valid


def per_class_iou(a: np.ndarray, b: np.ndarray, num_classes: int) -> list[float]:
    out = []
    for c in range(num_classes):
        inter = int(((a == c) & (b == c)).sum())
        union = int(((a == c) | (b == c)).sum())
        out.append(inter / union if union else 1.0)
    return out


def class_shares(masks: dict, valid: dict, num_classes: int) -> list[float]:
    """Each class's share of the valid pixels of ``masks``, over all dates."""
    counts = sum(np.bincount(masks[d][valid[d]], minlength=num_classes) for d in masks)
    return (counts / max(int(counts.sum()), 1)).tolist()


def read_ids(out_dir: Path, dates) -> dict:
    """{date: the engine's ids} from ``out_dir/tif/<date>.tif``."""
    return {date: read_tiff(out_dir / "tif" / f"{date}.tif").data[0] for date in dates}


def compare(ref_masks: dict, got: dict, num_classes: int) -> list[dict]:
    """The engine's ids of each date against the oracle's: pixel agreement
    and per-class IoU."""
    rows = []
    for date, ref in sorted(ref_masks.items()):
        rows.append({"date": date, "pixel_agreement": float((got[date] == ref).mean()),
                     "iou": per_class_iou(got[date], ref, num_classes)})
    return rows


def worst_iou(rows: list[dict]) -> float:
    return min(min(r["iou"]) for r in rows)


def blind(shares: list[float]) -> str | None:
    """Why reference masks with these class shares (class 0 first: nodata)
    would leave the IoU gate blind, or None."""
    if max(shares) > BLIND_SHARE:
        return f"one class covers {max(shares):.4f} of the valid pixels (> {BLIND_SHARE})"
    if min(shares[1:]) < MIN_SHARE:
        return f"a labelled class covers {min(shares[1:]):.6f} of the valid pixels (< {MIN_SHARE})"
    return None


def random_checkpoint(out_dir: Path, tiny: bool, probe) -> float:
    """HF's own random initialisation of ``hf_config(tiny)`` from
    ``torch.manual_seed(0)``, saved with ``save_pretrained`` into
    ``out_dir``. ``probe(model)`` → the class shares of the model's
    reference masks; where they would leave the gate ``blind``, the
    decoder head is scaled by HEAD_SCALE first. → the factor applied (1.0
    or HEAD_SCALE)."""
    torch.manual_seed(0)
    model = hf_api()[1](hf_config(tiny)).eval()
    shares = probe(model)
    factor = 1.0
    why = blind(shares)
    if why is not None:
        factor = HEAD_SCALE
        with torch.no_grad():
            model.decoder.decoder_pred.head.weight.mul_(factor)
            model.decoder.decoder_pred.head.bias.mul_(factor)
        print(f"random weights: {why} (shares {shares}): decoder head scaled by {factor}", flush=True)
    model.save_pretrained(str(out_dir))
    return factor


def port_checkpoint(ckpt_dir: Path, hf_cfg, tmp: Path, tiny: bool) -> str:
    """The ``checkpoint`` the port's engines take for ``ckpt_dir``: the
    directory itself at full width, whose topology must be the engines'
    default ``SegGPTConfig()`` (BAAI/seggpt-vit-large's); with ``tiny`` an
    npz that stores the topology, converted from the directory by the
    port's loader (the engines take another topology only from an npz)."""
    cfg = config_from_hf(hf_cfg)
    if not tiny:
        if cfg != SegGPTConfig():
            raise SystemExit(f"{ckpt_dir}: config_from_hf gives {cfg}, not the port's SegGPTConfig()")
        return str(ckpt_dir)
    path = tmp / "port_weights.npz"
    save_params(load_model_params(ckpt_dir, cfg, device="cpu"), path, config=cfg)
    return str(path)


def zero_shot_conf(scene_dir: Path, out: Path, checkpoint: str, dtype: str, tiny: bool) -> PredConfig:
    size = "tiny" if tiny else "full"
    return PredConfig(data=scene_dir, model_training_root=out, prediction_root=out, checkpoint=checkpoint,
                      zero_shot_crop_size=CROP[size], n_prompts=N_PROMPTS, batch_size=BATCH[size], rank_compat=True,
                      compute_dtype=dtype, mesh_data=1, mesh_model=1)


def zero_shot_scene(conf: PredConfig):
    """The reference date's scene with crops of the zero-shot size."""
    return create_scene(dataclasses.replace(conf, crop_size=conf.zero_shot_crop_size), train=True)


def zero_shot_probe(conf: PredConfig, device: torch.device):
    """``random_checkpoint``'s probe: the class shares of the oracle's
    zero-shot masks for a model on ``conf``'s scene (its first predict
    date)."""
    scene = zero_shot_scene(conf)
    processor = hf_api()[2]()

    def probe(model) -> list[float]:
        masks, valid = reference_zero_shot(model.to(device), processor, conf, scene, device, max_dates=1)
        return class_shares(masks, valid, len(conf.classes))

    return probe


def prepare(args, tmp: Path) -> dict:
    """The run's device, scene directory and checkpoint: ``--scene`` or
    ``chip_smoke.write_scene``'s scene (the port's writers; 1 reference and
    PREDICT_DATES predict dates); ``--checkpoint`` or ``random_checkpoint``;
    the HF config read back from the directory and the port's checkpoint."""
    device = select_device(args.device)
    t = time.perf_counter()
    if args.scene is not None:
        scene_dir = args.scene
    else:
        import chip_smoke

        scene_dir = tmp / "scene"
        chip_smoke.write_scene(scene_dir, n_dates=PREDICT_DATES)
    seconds = {"scene": time.perf_counter() - t}
    t = time.perf_counter()
    head_scale = None
    ckpt_dir = args.checkpoint
    if ckpt_dir is None:
        ckpt_dir = tmp / "hf_seggpt"
        probe_conf = zero_shot_conf(scene_dir, tmp / "probe", "random", "float32", args.tiny)
        head_scale = random_checkpoint(ckpt_dir, args.tiny, zero_shot_probe(probe_conf, device))
    seconds["hf_build_save"] = time.perf_counter() - t
    hf_cfg = hf_api()[0].from_pretrained(str(ckpt_dir))
    port_ckpt = port_checkpoint(ckpt_dir, hf_cfg, tmp, args.tiny)
    info = {"device": device, "card": card_line(device), "versions": versions(), "scene": scene_dir,
            "checkpoint": ckpt_dir, "port_checkpoint": port_ckpt, "head_scale": head_scale, "seconds": seconds}
    print(json.dumps({k: str(v) if isinstance(v, (Path, torch.device)) else v for k, v in info.items()}), flush=True)
    info["config"] = config_from_hf(hf_cfg)
    return info


def parse_args(argv, description: str) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=description.split("\n\n")[0])
    p.add_argument("--checkpoint", type=Path, help="a local HF SegGpt directory (default: HF's random init, saved)")
    p.add_argument("--dtype", nargs="+", choices=DTYPES, default=list(DTYPES),
                   help="the port's compute dtypes (the oracle is always fp32)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--tiny", action="store_true", help="the CPU tests' topology on the 896x448 canvas, crops of 48")
    p.add_argument("--scene", type=Path, help="a scene directory (default: chip_smoke.write_scene's)")
    p.add_argument("--parity-file", type=Path, default=PARITY_FILE)
    p.add_argument("--work", type=Path, help="keep the run's files here (default: a temporary directory, removed)")
    return p.parse_args(argv)


SECTIONS = {"zero_shot": "## Zero-shot chain", "tuned": "## Tuned-predict chain"}
HEADER = ("# PARITY_TORCH — golden parity of the port (beach_seg_tpu_torch)\n\n"
          "The port's scene engines against the reference's own chains re-run over transformers' SegGpt, on\n"
          "the same weights and scene. Written by `scripts/golden_parity_torch.py` (zero-shot) and\n"
          "`scripts/golden_parity_tuned_torch.py` (tuned predict); `PARITY.md` is the JAX package's.\n")


def write_section(path: Path, chain: str, intro: list[str], runs: dict, classes, card: str) -> None:
    """Replace the ``chain`` section of the parity file (keeping the other
    chain's): ``intro``, then per dtype and date the pixel agreement and
    per-class IoU against the fp32 oracle, each dtype's worst IoU and the
    card's name and power limit."""
    lines = [SECTIONS[chain], "", *intro, "",
             "| dtype | date | pixel agreement | " + " | ".join(f"IoU {c}" for c in classes) + " |",
             "|---|---|---|" + "---|" * len(classes)]
    for dtype, rows in runs.items():
        for r in rows:
            lines.append(f"| {dtype} | {r['date']} | {r['pixel_agreement']:.6f} | "
                         + " | ".join(f"{i:.6f}" for i in r["iou"]) + " |")
    lines += ["", "Worst per-class IoU: " + "; ".join(
        f"{dtype} **{worst_iou(rows):.6f}**" + (f" (gate >= {IOU_MIN})" if dtype == "float32" else " (reported, not gated)")
        for dtype, rows in runs.items()) + ".", "", f"Card: {card}."]
    text = path.read_text() if path.exists() else HEADER
    head, *sections = re.split(r"(?m)^(?=## )", text)
    kept = {sec.splitlines()[0]: sec.rstrip() + "\n" for sec in sections}
    kept[SECTIONS[chain]] = "\n".join(lines) + "\n"
    path.write_text(head.rstrip() + "\n" + "".join("\n" + kept[m] for m in SECTIONS.values() if m in kept))


def report(chain: str, args, info: dict, runs: dict, shares: list[float], classes, intro: list[str]) -> dict:
    """Print the rows, write the section, and → the worst IoU per dtype."""
    for dtype, rows in runs.items():
        for r in rows:
            print(json.dumps({"chain": chain, "dtype": dtype, "date": r["date"], "pixel_agreement": r["pixel_agreement"],
                              "iou": dict(zip(classes, r["iou"]))}))
    worst = {dtype: worst_iou(rows) for dtype, rows in runs.items()}
    v = info["versions"]
    topology = "the tests' tiny topology on the 896×448 canvas" if args.tiny else \
        "`SegGptConfig()` (BAAI/seggpt-vit-large's topology)"
    weights = (f"`{info['checkpoint']}`" if info["head_scale"] is None else
               f"HF's random initialisation at {topology} from `torch.manual_seed(0)`, decoder head ×{info['head_scale']:g}")
    write_section(args.parity_file, chain, [
        *intro, "",
        f"Weights: {weights}; both sides load the one directory (the port: `{Path(info['port_checkpoint']).name}`).",
        f"Oracle: transformers {v['transformers']} (`{v['processor']}`), safetensors {v['safetensors']}, torch "
        f"{v['torch']}, fp32 eager, TF32 off ({v['allow_tf32']}). Reference masks' class shares of the valid pixels: "
        + ", ".join(f"{c} {s:.4f}" for c, s in zip(classes, shares)) + ".",
    ], runs, classes, info["card"])
    print(json.dumps({"chain": chain, "worst_iou": worst, "class_shares": shares, "card": info["card"]}))
    return worst


def run(args) -> dict:
    """The zero-shot chain: the oracle once in fp32, the port once per
    dtype, the comparison. → the rows, worst IoUs, shares and seconds."""
    from beach_seg_tpu_torch.infer import run_zero_shot

    tmp = args.work or Path(tempfile.mkdtemp(prefix="golden_torch_"))
    try:
        info = prepare(args, tmp)
        device, seconds = info["device"], info["seconds"]
        conf = zero_shot_conf(info["scene"], tmp / "out", info["port_checkpoint"], "float32", args.tiny)
        t = time.perf_counter()
        tmodel = load_oracle(info["checkpoint"], device)
        ref, valid = reference_zero_shot(tmodel, hf_api()[2](), conf, zero_shot_scene(conf), device)
        seconds["oracle"] = time.perf_counter() - t
        del tmodel
        shares = class_shares(ref, valid, len(conf.classes))
        runs = {}
        for dtype in args.dtype:
            t = time.perf_counter()
            out_dir = run_zero_shot(dataclasses.replace(conf, compute_dtype=dtype), device=device)
            seconds[f"port_{dtype}"] = time.perf_counter() - t
            runs[dtype] = compare(ref, read_ids(out_dir, ref), len(conf.classes))
        intro = [f"The port's `run_zero_shot` (`rank_compat=true`, crops of {conf.zero_shot_crop_size}, {conf.n_prompts} "
                 "prompts, feature ensemble) against predict_no_prompt.py:228-315 re-run over HF `SegGptForImageSegmentation` "
                 f"on the same scene ({len(ref)} predict dates) and device ({device.type}). Produced by "
                 f"`python scripts/golden_parity_torch.py{' --tiny --device cpu' if args.tiny else ''}`; seconds "
                 + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items()) + "."]
        worst = report("zero_shot", args, info, runs, shares, conf.classes, intro)
        return {"runs": runs, "worst": worst, "shares": shares, "seconds": seconds, "head_scale": info["head_scale"],
                "reference": ref}
    finally:
        if args.work is None:
            shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    res = run(parse_args(argv, __doc__))
    fp32 = res["worst"].get("float32")
    if fp32 is not None and fp32 < IOU_MIN:
        print(f"zero-shot parity: fp32 worst per-class IoU {fp32:.6f} < {IOU_MIN}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
