"""Dataset layer: scene → shoreline crops → fixed-shape device batches
(counterpart of ``beach_seg_tpu/data/dataset.py``, on the port's resizes).

A rebuild of the reference's src/data.py. The reference's
``create_dataset`` orchestration (data.py:130-178) is ported behaviorally:
discover masks/imagery, build the global grid, rasterize water/veg, derive
sand, extract the shoreline, generate zero-overlap crops, merge per-date
mosaics. The torch ``Dataset``/``DataLoader`` pair is replaced by a batch
iterator that emits fixed-shape NHWC numpy batches (padded to the batch size
with a validity mask) — crops are pre-resized host-side with the exact
PIL-parity matrix resizes (BICUBIC image / NEAREST label+nodata,
ref data.py:93-112), so the device step is pure compute.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Iterator

import numpy as np

from beach_seg_tpu_torch.config import BeachSegConfig
from beach_seg_tpu_torch.geo.affine import Affine
from beach_seg_tpu_torch.geo.contours import extract_linestring
from beach_seg_tpu_torch.geo.extent import compute_raster_extent, get_masks, group_images_by_date, infer_date
from beach_seg_tpu_torch.geo.geometry import generate_square_crops_along_line
from beach_seg_tpu_torch.geo.masks import crop_tif, merged_no_data_mask
from beach_seg_tpu_torch.geo.mosaic import merge_tifs
from beach_seg_tpu_torch.geo.rasterize import rasterize
from beach_seg_tpu_torch.geo.shapefile import read_shapefile
from beach_seg_tpu_torch.ops.resize import resize_matrix

logger = logging.getLogger(__name__)


# ----------------------------------------------------------- host resize


def _resize_crop(img: np.ndarray, out_size: int, method: str) -> np.ndarray:
    """(H, W[, C]) resize via the PIL-parity sampling matrices (ops.resize)."""
    in_size = img.shape[0]
    if in_size == out_size:
        return img
    mat = resize_matrix(in_size, out_size, method)
    out = np.einsum("oh,hw...->ow...", mat, np.einsum("pw,hw...->hp...", mat, img.astype(np.float32)))
    return out


def resize_image_bicubic(img: np.ndarray, out_size: int) -> np.ndarray:
    """PIL BICUBIC parity incl. the uint8 intermediate between passes
    (ref data.py:95 uses config.resample = BICUBIC on a uint8 PIL image)."""
    from beach_seg_tpu_torch.ops.resize import resize_pil_uint8

    if img.dtype == np.uint8:
        if img.shape[0] == out_size:
            return img.astype(np.float32)
        return resize_pil_uint8(img, (out_size, out_size)).astype(np.float32)
    return _resize_crop(img, out_size, "bicubic_pil")


def resize_mask_nearest(mask: np.ndarray, out_size: int) -> np.ndarray:
    """PIL NEAREST parity (ref data.py:99-112)."""
    out = _resize_crop(mask.astype(np.float32), out_size, "nearest_pil")
    return np.round(out).astype(mask.dtype)


# ------------------------------------------------------------ geo setup


@dataclasses.dataclass
class Scene:
    """One prepared scene: per-date mosaics + crops + (optional) labels."""

    date_merged_imgs: dict[str, tuple[np.ndarray, np.ndarray]]  # date → (HWC uint8, nodata bool)
    date_masks: dict[str, np.ndarray]  # date → (H, W) uint8 class ids
    crops: list[tuple[int, int, int, int]]
    out_shape: tuple[int, int]
    out_transform: Affine
    crs: str | None
    mask_date: str


def load_labels(
    config: BeachSegConfig, out_shape: tuple[int, int], out_transform: Affine
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Rasterize water/veg shapefiles → (merged_mask, water, veg, nodata)
    (ref data.py:143-153)."""
    mask_dir = Path(config.data) / "Masks"
    veg_paths = get_masks(mask_dir, "Mask_*.shp")
    water_paths = get_masks(mask_dir, "WaterMask_*.shp")

    def rasterize_all(paths) -> np.ndarray:
        geoms = []
        for p in paths:
            gs, _ = read_shapefile(p)
            geoms.extend(gs)
        return rasterize(geoms, out_shape, out_transform) == 1

    veg_mask = rasterize_all(veg_paths)
    water_mask = rasterize_all(water_paths)
    full_no_data = merged_no_data_mask(water_mask, veg_mask)
    sand_mask = ~(full_no_data | water_mask | veg_mask)
    merged = np.zeros(out_shape, np.uint8)
    merged[water_mask] = config.classes.index("water")
    merged[veg_mask] = config.classes.index("veg")
    merged[sand_mask] = config.classes.index("sand")
    assert config.classes.index("nodata") == 0
    return merged, water_mask, veg_mask, full_no_data


def create_scene(config: BeachSegConfig, train: bool, crop_overlap: int = 0) -> Scene:
    """Full geo setup (behavioral port of ref create_dataset, data.py:130-178)."""
    data_dir = Path(config.data)
    mask_dir = data_dir / "Masks"
    veg_paths = get_masks(mask_dir, "Mask_*.shp")
    water_paths = get_masks(mask_dir, "WaterMask_*.shp")
    mask_date = infer_date(veg_paths + water_paths)

    img_paths = list((data_dir / "SatelliteImagery").glob("*/*.tif"))
    groups = group_images_by_date(img_paths)
    ref_imgs = groups.pop(mask_date, [])
    assert len(ref_imgs), f"no reference imagery for mask date {mask_date}"

    out_transform, out_shape, crs = compute_raster_extent(ref_imgs)
    merged_mask, water_mask, _, full_no_data = load_labels(config, out_shape, out_transform)

    water_line = extract_linestring(water_mask, full_no_data)
    assert water_line is not None, "no shoreline found"
    crops = generate_square_crops_along_line(water_line, config.crop_size, crop_overlap)

    date_img_paths = {mask_date: ref_imgs} if train else groups
    date_merged_imgs = {}
    for date, paths in date_img_paths.items():
        logger.info("merging %d image(s) for %s", len(paths), date)
        date_merged_imgs[date] = merge_tifs(paths, out_shape, out_transform, crs)

    return Scene(
        date_merged_imgs=date_merged_imgs,
        date_masks={mask_date: merged_mask},
        crops=crops,
        out_shape=out_shape,
        out_transform=out_transform,
        crs=crs,
        mask_date=mask_date,
    )


# -------------------------------------------------------------- dataset


def get_crop_arrays(
    scene: Scene, date: str, crop_idx: int, config: BeachSegConfig
) -> dict[str, np.ndarray]:
    """One (date, crop) item as model-ready arrays (ref BeachSegDataset
    .get_crop, data.py:81-124): boundless crop → BICUBIC/NEAREST resize to
    inpt_size → image float [0,1] HWC, mask uint8 ids, nodata bool.

    Reproduces the unlabeled-crop hack: when a crop has no labels, pixels with
    data get class 1 ("sand") as a stand-in (data.py:114-116)."""
    img, nodata = scene.date_merged_imgs[date]
    label = scene.date_masks.get(date)
    crop = scene.crops[crop_idx]
    crop_img, crop_nodata, crop_label = crop_tif(crop, img, nodata, label, config.crop_size)
    if crop_label is None:
        crop_label = np.zeros(crop_img.shape[:2], np.uint8)

    size = config.inpt_size
    out_img = np.clip(resize_image_bicubic(crop_img, size), 0, 255).astype(np.float32) / 255.0
    out_label = resize_mask_nearest(crop_label.astype(np.uint8), size)
    out_nodata = resize_mask_nearest(crop_nodata.astype(np.uint8), size).astype(bool)

    if not np.all(out_nodata) and np.all(out_label == 0):
        out_label[~out_nodata] = 1

    return {
        "crop_idx": np.int32(crop_idx),
        "date": date,
        "image": out_img,  # (S, S, 3) float32 [0,1]
        "mask": out_label.astype(np.int32),
        "nodata": out_nodata,
    }


def get_raw_item(
    scene: Scene, date: str, crop_idx: int, config: BeachSegConfig
) -> dict[str, np.ndarray]:
    """One (date, crop) item at CROP resolution, uint8 — the device-side
    preprocessing path: raw (S, S) uint8 crops are ~60× fewer bytes than
    the resized float tensors, and the device resizes them
    (ops.resize.resize_pil_uint8_device, PIL-parity), so the host→device
    copies stay small beside the compute.

    The unlabeled-crop hack (ref data.py:114-116) is applied at crop
    resolution — exactly commutative with the nearest upsample, which is a
    pure source-pixel selection.
    """
    img, nodata = scene.date_merged_imgs[date]
    label = scene.date_masks.get(date)
    crop = scene.crops[crop_idx]
    crop_img, crop_nodata, crop_label = crop_tif(crop, img, nodata, label, config.crop_size)
    if crop_label is None:
        crop_label = np.zeros(crop_img.shape[:2], np.uint8)
    crop_nodata = crop_nodata.astype(bool)
    if not np.all(crop_nodata) and np.all(crop_label == 0):
        crop_label = crop_label.copy()
        crop_label[~crop_nodata] = 1
    return {
        "crop_idx": np.int32(crop_idx),
        "date": date,
        "image_u8": crop_img.astype(np.uint8),  # (S, S, 3)
        "mask": crop_label.astype(np.int32),  # (S, S)
        "nodata": crop_nodata,  # (S, S)
    }


@dataclasses.dataclass
class BeachSegDataset:
    """Index = (date × crop), with per-item nodata stats (ref data.py:37-127).

    ``raw=True`` yields crop-resolution uint8 items (see :func:`get_raw_item`)
    for device-side preprocessing."""

    scene: Scene
    config: BeachSegConfig
    raw: bool = False
    items: list[dict] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        cs = self.config.crop_size
        for date in self.scene.date_merged_imgs:
            full_mask = self.scene.date_masks.get(date)
            img, nodata = self.scene.date_merged_imgs[date]
            for crop_idx in range(len(self.scene.crops)):
                if full_mask is not None:
                    _, _, mask = crop_tif(self.scene.crops[crop_idx], img, nodata, full_mask, cs)
                    count_nodata = int((mask == 0).sum())
                else:
                    count_nodata = 0
                self.items.append(
                    {"date": date, "crop_idx": crop_idx, "pct_nodata": count_nodata / cs / cs}
                )

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        it = self.items[idx]
        fn = get_raw_item if self.raw else get_crop_arrays
        return fn(self.scene, it["date"], it["crop_idx"], self.config)


def materialize_prompts(scene: Scene, config: BeachSegConfig) -> dict[str, np.ndarray]:
    """All reference-date crops stacked as prompt tensors (the reference's
    ``create_prompts=True`` path, data.py:74-76 / model.py:115-130):
    {pixels (P,S,S,3), masks (P,S,S), nodata (P,S,S), crop_idx (P,)}."""
    date = scene.mask_date
    items = [get_crop_arrays(scene, date, i, config) for i in range(len(scene.crops))]
    return {
        "pixels": np.stack([it["image"] for it in items]),
        "masks": np.stack([it["mask"] for it in items]),
        "nodata": np.stack([it["nodata"] for it in items]),
        "crop_idx": np.arange(len(items), dtype=np.int32),
    }


def _assemble(items: list[dict], n_valid: int, rows: tuple[int, int]) -> dict[str, np.ndarray]:
    lo, sz = rows
    out: dict = {"date": [it["date"] for it in items]}
    for k in items[0]:
        if k == "date":
            continue
        vals = [it[k] for it in items]
        out[k] = (
            np.asarray(vals, np.int32) if np.ndim(vals[0]) == 0 else np.stack(vals)
        )
    out["valid"] = np.arange(lo, lo + sz) < n_valid
    return out


def iterate_batches(
    dataset: BeachSegDataset,
    batch_size: int,
    shuffle: bool = False,
    seed: int = 0,
    drop_remainder: bool = False,
    workers: int = 0,
    prefetch_batches: int = 2,
    row_slice: tuple[int, int] | None = None,
) -> Iterator[dict[str, np.ndarray]]:
    """Fixed-shape NHWC batches; ragged tails are padded (repeating the last
    item) with ``valid`` marking real rows — the step sees one shape only.

    ``workers > 0`` assembles crops on a thread pool, ``prefetch_batches``
    batches ahead of the consumer — the analogue of the reference's
    DataLoader ``num_workers`` (ref src/data.py:267-275,
    src/config.py:81-91): host resize work (numpy matmuls, releases the GIL)
    overlaps device steps instead of serializing with them.

    ``row_slice=(start, size)`` emits only that window of every global batch —
    multi-host training: each process builds ONLY its own rows (same seed ⇒
    consistent global order across hosts) and ``parallel.mesh.put_batch``
    assembles the global array shard-by-shard.
    """
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)

    batch_idx: list[tuple[np.ndarray, int]] = []
    for start in range(0, len(order), batch_size):
        idx = order[start : start + batch_size]
        n_valid = len(idx)
        if n_valid < batch_size:
            if drop_remainder:
                break
            idx = np.concatenate([idx, np.repeat(idx[-1:], batch_size - n_valid)])
        batch_idx.append((idx, n_valid))

    if row_slice is not None:
        lo, sz = row_slice
        # per-host window: indices restricted to [lo, lo+sz); "valid" flags
        # computed against the GLOBAL batch then windowed identically
        batch_idx = [(idx[lo : lo + sz], n_valid) for idx, n_valid in batch_idx]
        emit_rows = (lo, sz)
    else:
        emit_rows = (0, batch_size)

    if workers <= 0:
        for idx, n_valid in batch_idx:
            yield _assemble([dataset[i] for i in idx], n_valid, emit_rows)
        return

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=workers) as pool:
        depth = max(1, prefetch_batches)
        pending = [
            [pool.submit(dataset.__getitem__, int(i)) for i in idx]
            for idx, _ in batch_idx[: depth + 1]
        ]
        for b, (idx, n_valid) in enumerate(batch_idx):
            nxt = b + depth + 1
            if nxt < len(batch_idx):
                pending.append(
                    [pool.submit(dataset.__getitem__, int(i)) for i in batch_idx[nxt][0]]
                )
            futures = pending.pop(0)
            yield _assemble([f.result() for f in futures], n_valid, emit_rows)
