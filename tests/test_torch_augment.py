"""The port's train augmentations, random palette and metrics against the
JAX package's. The port's ops take their random numbers as arguments; these
tests draw them from the JAX key exactly as the JAX ops split it, so both
sides run on the same numbers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from beach_seg_tpu.train import metrics as jmetrics
from beach_seg_tpu.transforms import augment as jaug
from beach_seg_tpu_torch.train import metrics as tmetrics
from beach_seg_tpu_torch.transforms import augment as taug
from beach_seg_tpu_torch.transforms import random_palette

B, H, W = 3, 16, 16
# every op on (the flips, jigsaw, channel shift, mosaic at a high rate), and
# identity: every probability and magnitude 0
ALL_ON = dict(
    vertical_flip=0.5, horizontal_flip=0.5, hue=0.2, saturation=0.3, contrast=0.3, brightness=0.3,
    sharpness=1.0, sharpness_p=0.7, erasing_scale=(0.1, 0.3), erasing_p=0.7, gauss_p=0.5,
    channel_shift_limit=0.05, channel_shift_p=0.7, jigsaw_p=0.6, mosaic_p=0.6,
)
# every op on, the resized crop too (no configuration sets resized_crop_p)
CROP_ON = dict(ALL_ON, resized_crop_p=0.7)
IDENTITY = dict(
    vertical_flip=0.0, horizontal_flip=0.0, hue=0.0, saturation=0.0, contrast=0.0, brightness=0.0,
    sharpness_p=0.0, erasing_p=0.0, gauss_p=0.0, channel_shift_p=0.0,
)


def jax_aug_draws(key, shape, p) -> dict:
    """The draws ``jaug.train_augment(key, …)`` takes, split as it splits
    its key (augment.py:350-397), in the port's layout (numpy)."""
    b, h, w = shape
    kb, key = random.split(key)
    d = {}
    if p.mosaic_p > 0:
        kperm, kp = random.split(kb)
        d["mosaic_perms"] = np.stack([np.asarray(random.permutation(random.fold_in(kperm, i), b)) for i in range(4)])
        d["mosaic_apply"] = np.asarray(random.bernoulli(kp, float(p.mosaic_p), (b,)))
    per = []
    for k in random.split(key, b):
        kv, kh, kc, ks, ke, kn, kcs, kj = random.split(k, 8)
        e = {"vflip": random.bernoulli(kv, float(p.vertical_flip)), "hflip": random.bernoulli(kh, float(p.horizontal_flip))}
        kperm, kp = random.split(kj)
        e["jigsaw_perm"] = random.permutation(kperm, p.jigsaw_grid[0] * p.jigsaw_grid[1])
        e["jigsaw_apply"] = random.bernoulli(kp, float(p.jigsaw_p))
        if p.resized_crop_p > 0:
            e.update(resized_crop_draws(random.fold_in(k, 99), p))
        kss, kp = random.split(kcs)
        e["shift"] = random.uniform(kss, (1, 1, 3), minval=-p.channel_shift_limit, maxval=p.channel_shift_limit).reshape(3)
        e["shift_apply"] = random.bernoulli(kp, float(p.channel_shift_p))
        k1, k2, k3, k4 = random.split(kc, 4)
        for name, kk in (("brightness", k1), ("contrast", k2), ("saturation", k3)):
            mag = getattr(p, name)
            e[name] = random.uniform(kk, (), minval=max(0.0, 1 - mag), maxval=1 + mag)
        e["hue"] = random.uniform(k4, (), minval=-p.hue, maxval=p.hue)
        kf, kp = random.split(ks)
        e["sharp_factor"] = random.uniform(kf, (), maxval=p.sharpness)
        e["sharp_apply"] = random.bernoulli(kp, float(p.sharpness_p))
        ka, kr, ky, kx, kp = random.split(ke, 5)
        e["erase_area"] = random.uniform(ka, (), minval=p.erasing_scale[0], maxval=p.erasing_scale[1])
        e["erase_log_r"] = random.uniform(kr, (), minval=jnp.log(p.erasing_ratio[0]), maxval=jnp.log(p.erasing_ratio[1]))
        e["erase_top"] = random.randint(ky, (), 0, h)
        e["erase_left"] = random.randint(kx, (), 0, w)
        e["erase_apply"] = random.bernoulli(kp, float(p.erasing_p))
        knn, kp = random.split(kn)
        e["noise"] = random.normal(knn, (h, w, 3), jnp.float32)
        e["noise_apply"] = random.bernoulli(kp, float(p.gauss_p))
        per.append(e)
    for name in per[0]:
        d[name] = np.stack([np.asarray(e[name]) for e in per])
    return d


def resized_crop_draws(key, p) -> dict:
    """The draws ``jaug.random_resized_crop(key, …)`` takes (augment.py:250-256)."""
    ka, ky, kx, kp = random.split(key, 4)
    return {
        "crop_area": random.uniform(ka, (), minval=p.scale[0], maxval=p.scale[1]),
        "crop_top": random.uniform(ky, ()),
        "crop_left": random.uniform(kx, ()),
        "crop_apply": random.bernoulli(kp, float(p.resized_crop_p)),
    }


def to_torch_draws(d: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _inputs(seed=0, extremes=True):
    rng = np.random.default_rng(seed)
    img = rng.random((B, H, W, 3)).astype(np.float32)
    if extremes:  # exact 0.0 and 1.0, as uint8 imagery gives: the clips' boundaries
        img[:, :3] = 0.0
        img[:, -3:] = 1.0
        img[:, 5, :, 0] = 1.0
    mask = rng.integers(0, 4, (B, H, W)).astype(np.int32)
    nodata = rng.random((B, H, W)) < 0.2
    return img, mask, nodata


@pytest.mark.parametrize("knobs", ["all_on", "identity", "defaults", "crop_on"])
@pytest.mark.parametrize("seed", [0, 1])
def test_train_augment_matches_jax_on_its_draws(knobs, seed):
    p = jaug.AugmentParams(**{"all_on": ALL_ON, "identity": IDENTITY, "defaults": {}, "crop_on": CROP_ON}[knobs])
    img, mask, nodata = _inputs(seed)
    key = random.PRNGKey(10 + seed)
    want = jaug.train_augment(key, jnp.asarray(img), jnp.asarray(mask), jnp.asarray(nodata), p)
    draws = to_torch_draws(jax_aug_draws(key, mask.shape, p))
    tp = taug.AugmentParams(**{f: getattr(p, f) for f in p.__dataclass_fields__})
    got = taug.train_augment(torch.from_numpy(img), torch.from_numpy(mask), torch.from_numpy(nodata), tp, draws=draws)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=2e-5, rtol=0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("knobs", ["all_on", "defaults", "crop_on"])
def test_train_augment_gradient_matches_jax(knobs):
    """The gradient through every op, on an image with exact 0.0 and 1.0
    (the clips' boundaries, where jnp.clip's gradient is 0.5), within 1e-4
    of its scale: the HSV round trip divides by small channel spreads."""
    p = jaug.AugmentParams(**{"all_on": ALL_ON, "defaults": {}, "crop_on": CROP_ON}[knobs])
    img, mask, nodata = _inputs(2)
    key = random.PRNGKey(3)
    wts = np.random.default_rng(5).standard_normal((B, H, W, 3)).astype(np.float32)

    def jloss(x):
        out = jaug.train_augment(key, x, jnp.asarray(mask), jnp.asarray(nodata), p)[0]
        return jnp.sum(out * wts)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(img)))
    draws = to_torch_draws(jax_aug_draws(key, mask.shape, p))
    tp = taug.AugmentParams(**{f: getattr(p, f) for f in p.__dataclass_fields__})
    x = torch.from_numpy(img).requires_grad_(True)
    out = taug.train_augment(x, torch.from_numpy(mask), torch.from_numpy(nodata), tp, draws=draws)[0]
    (got,) = torch.autograd.grad((out * torch.from_numpy(wts)).sum(), x)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max(), rtol=0)


def test_clip_gradient_is_half_at_the_bounds():
    x = torch.tensor([0.0, 0.5, 1.0, -1.0, 2.0], requires_grad=True)
    (g,) = torch.autograd.grad(taug._clip(x, 0.0, 1.0).sum(), x)
    want = jax.grad(lambda a: jnp.clip(a, 0.0, 1.0).sum())(jnp.asarray(x.detach().numpy()))
    np.testing.assert_array_equal(g.numpy(), np.asarray(want))
    assert g.tolist() == [0.5, 1.0, 0.5, 0.0, 0.0]


def test_sample_draws_shapes_and_ranges():
    p = taug.AugmentParams(**ALL_ON)
    d = taug.sample_draws(torch.Generator().manual_seed(0), (B, H, W), p)
    assert d["noise"].shape == (B, H, W, 3) and d["shift"].shape == (B, 3)
    assert sorted(d["mosaic_perms"][0].tolist()) == list(range(B))
    assert sorted(d["jigsaw_perm"][0].tolist()) == [0, 1, 2, 3]
    assert ((d["brightness"] >= 0.7) & (d["brightness"] <= 1.3)).all()
    assert ((d["erase_top"] >= 0) & (d["erase_top"] < H)).all()
    img, mask, nodata = (torch.from_numpy(a) for a in _inputs(0))
    draws = taug.sample_draws(torch.Generator().manual_seed(1), tuple(mask.shape), p)
    out = taug.train_augment(img, mask, nodata, p, draws)
    assert out[0].shape == (B, H, W, 3) and torch.isfinite(out[0]).all()
    assert "crop_area" not in d  # the crop draws only where the crop can run
    pc = taug.AugmentParams(**CROP_ON)
    dc = taug.sample_draws(torch.Generator().manual_seed(2), (B, H, W), pc)
    assert ((dc["crop_area"] >= 0.4) & (dc["crop_area"] <= 1.0)).all() and dc["crop_apply"].dtype == torch.bool
    assert ((dc["crop_top"] >= 0) & (dc["crop_top"] < 1) & (dc["crop_left"] >= 0) & (dc["crop_left"] < 1)).all()
    out = taug.train_augment(img, mask, nodata, pc, dc)
    assert out[0].shape == (B, H, W, 3) and torch.isfinite(out[0]).all()


# the crop's image is one fp32 product of two weight matrices in either
# package, summed in other orders: within 1e-6 (measured 6e-8)
CROP_IMG_TOL = 1e-6


@pytest.mark.parametrize("scale", [(0.4, 1.0), (0.98, 1.0)], ids=["default_scale", "border"])
@pytest.mark.parametrize("seed", [0, 1])
def test_random_resized_crop_matches_jax(scale, seed):
    """The op alone on JAX's draws, per sample as the JAX op runs: image
    within CROP_IMG_TOL, mask and nodata equal. At scale (0.98, 1.0) the crop
    spans nearly the whole tile, so the output's edge pixels sample within
    half a pixel of the tile's border, where the weights are renormalised
    over the in-bounds source pixels."""
    p = jaug.AugmentParams(resized_crop_p=0.5, scale=scale)
    img, mask, nodata = _inputs(seed)
    keys = random.split(random.PRNGKey(20 + seed), B)
    want = [jaug.random_resized_crop(k, jnp.asarray(img[i]), jnp.asarray(mask[i]), jnp.asarray(nodata[i]), p)
            for i, k in enumerate(keys)]
    per = [resized_crop_draws(k, p) for k in keys]
    draws = to_torch_draws({name: np.stack([np.asarray(e[name]) for e in per]) for name in per[0]})
    assert draws["crop_apply"].any()
    got = taug.random_resized_crop(torch.from_numpy(img), torch.from_numpy(mask), torch.from_numpy(nodata), draws)
    for j, tol in ((0, CROP_IMG_TOL), (1, 0), (2, 0)):
        w = np.stack([np.asarray(o[j]) for o in want])
        assert np.abs(got[j].numpy().astype(np.float64) - w).max() <= tol
    assert not np.array_equal(got[0].numpy(), img)  # the applied rows moved
    if scale[0] > 0.9:
        side = np.sqrt(draws["crop_area"].numpy()) * H
        assert (side > H - 1).all()  # each crop reaches within a pixel of two opposite borders


def test_augment_params_from_config():
    from beach_seg_tpu.config import BeachSegConfig as JConf
    from beach_seg_tpu_torch.config import BeachSegConfig

    want = jaug.AugmentParams.from_config(JConf(hue=0.3, jigsaw_p=0.2))
    got = taug.AugmentParams.from_config(BeachSegConfig(hue=0.3, jigsaw_p=0.2))
    assert {f: getattr(got, f) for f in got.__dataclass_fields__} == {f: getattr(want, f) for f in want.__dataclass_fields__}


def test_random_palette_contract():
    pal = random_palette(torch.Generator().manual_seed(0), 4, 64)
    assert pal.dtype == torch.uint8 and tuple(pal.shape) == (64, 4, 3)
    assert (pal[:, 0] == 0).all()
    assert pal[:, 1:].min() < 16 and pal[:, 1:].max() > 240  # spans [0, 256)
    again = random_palette(torch.Generator().manual_seed(0), 4, 64)
    assert torch.equal(pal, again)


@pytest.mark.parametrize("ignore_index", [0, None])
def test_metrics_match_jax(ignore_index):
    rng = np.random.default_rng(4)
    pred = rng.integers(0, 4, (2, 8, 8)).astype(np.int32)
    target = rng.integers(0, 4, (2, 8, 8)).astype(np.int32)
    target[0, :, :3] = pred[0, :, :3]
    want = np.asarray(jmetrics.confusion_update(jnp.asarray(pred), jnp.asarray(target), 4, ignore_index))
    got = tmetrics.confusion_update(torch.from_numpy(pred), torch.from_numpy(target), 4, ignore_index)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    cms = [want, np.diag([0, 3, 0, 2]).astype(np.int32), np.zeros((4, 4), np.int32)]
    for cm in cms:
        np.testing.assert_allclose(
            tmetrics.f1_from_confusion(torch.from_numpy(cm)).numpy(), np.asarray(jmetrics.f1_from_confusion(jnp.asarray(cm))), atol=1e-7
        )
        np.testing.assert_allclose(
            tmetrics.iou_from_confusion(torch.from_numpy(cm)).numpy(), np.asarray(jmetrics.iou_from_confusion(jnp.asarray(cm))), atol=1e-7
        )
