"""The small inference modules of the port against the JAX package's, on the
same seeded numpy inputs: the HF-parity processor (``infer/processor.py``),
the device scatter-add votes (``infer/device_votes.py``), the shoreline
metrics (``geo/line_metrics.py``) and the predict step's random palette
(``PromptTuner.predict_step(painter_palette=False)``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beach_seg_tpu.config import BeachSegConfig as JConf
from beach_seg_tpu.geo.geometry import LineString as JLineString
from beach_seg_tpu.geo.geometry import MultiLineString as JMultiLineString
from beach_seg_tpu.geo.line_metrics import average_symmetric_distance as jasd
from beach_seg_tpu.geo.line_metrics import hausdorff_distance as jhausdorff
from beach_seg_tpu.infer import device_votes as jvotes
from beach_seg_tpu.infer import processor as jproc
from beach_seg_tpu.models.seggpt.config import tiny_config as jtiny_config
from beach_seg_tpu.models.seggpt.model import SegGPT as JSegGPT
from beach_seg_tpu.train.prompt_tuner import PromptTuner as JTuner
from beach_seg_tpu.transforms.palette import random_palette as jrandom_palette
from beach_seg_tpu_torch.config import BeachSegConfig
from beach_seg_tpu_torch.geo.geometry import LineString, MultiLineString
from beach_seg_tpu_torch.geo.line_metrics import average_symmetric_distance, hausdorff_distance
from beach_seg_tpu_torch.infer import device_votes, processor
from beach_seg_tpu_torch.models.seggpt import build_model, from_jax_params, tiny_config
from beach_seg_tpu_torch.train import PromptTuner
from beach_seg_tpu_torch.transforms import random_palette

# ------------------------------------------------------------- processor


def _image(seed: int, h: int, w: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _mask(seed: int, h: int, w: int) -> np.ndarray:
    cells = np.random.default_rng(seed).integers(0, 4, (h // 4 + 1, w // 4 + 1))
    return np.repeat(np.repeat(cells, 4, 0), 4, 1)[:h, :w].astype(np.uint8)


@pytest.mark.parametrize("h, w, size", [(48, 48, 448), (37, 53, 64), (64, 64, 64)])
def test_uint8_preprocess_is_bitwise_jax(h, w, size):
    img, mask = _image(h, h, w), _mask(w, h, w)
    for got, want in (
        (processor.preprocess_image_u8(img, size), jproc.preprocess_image_u8(img, size)),
        (processor.preprocess_mask_u8(mask, 3, size), jproc.preprocess_mask_u8(mask, 3, size)),
        (processor.preprocess_image(img, size), jproc.preprocess_image(img, size)),
        (processor.preprocess_image(img.astype(np.float32), size), jproc.preprocess_image(img.astype(np.float32), size)),
        (processor.preprocess_mask(mask, 3, size), jproc.preprocess_mask(mask, 3, size)),
    ):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_normalize_device_within_one_ulp_of_jax():
    u8 = np.random.default_rng(1).integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    u8[0, 0, :3] = [[0, 0, 0], [255, 255, 255], [128, 64, 32]]
    want = np.asarray(jproc.normalize_device(jnp.asarray(u8)))
    got = processor.normalize_device(torch.from_numpy(u8)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert (np.abs(got - want) <= np.spacing(np.abs(want))).all()
    # the host float64 path the HF processor takes: fp32's rounding of u8/255
    # (half an ulp below 1) over std, within two ulps of the largest |value|
    host = ((u8 / 255.0 - np.asarray(processor.IMAGENET_MEAN)) / np.asarray(processor.IMAGENET_STD)).astype(np.float32)
    assert np.abs(got - host).max() <= 2 * np.spacing(np.abs(host).max())


def _canvases(seed: int, b: int, h: int, w: int) -> np.ndarray:
    """Painted canvases whose query halves sit near the palette colors, with
    noise, so the decode meets every class and some near-ties."""
    rng = np.random.default_rng(seed)
    pal = jproc.build_palette(3).astype(np.float32) / 255.0
    ids = rng.integers(0, 4, (b, h, w))
    rgb = pal[ids] + 0.25 * rng.standard_normal((b, h, w, 3)).astype(np.float32)
    norm = (rgb - np.asarray(jproc.IMAGENET_MEAN, np.float32)) / np.asarray(jproc.IMAGENET_STD, np.float32)
    return np.concatenate([np.zeros_like(norm), norm], axis=1).astype(np.float32)


@pytest.mark.parametrize("target", [(32, 32), (48, 48), (21, 45)], ids=["same", "up", "ragged"])
def test_post_process_semantic_device_matches_jax(target):
    """The same ids as JAX's device decode, also where the target size takes
    the nearest_torch gather; and as the host twin (int32 there)."""
    canvases = _canvases(2, 3, 32, 32)
    want = np.asarray(jproc.post_process_semantic_device(jnp.asarray(canvases), target, 3))
    got = processor.post_process_semantic_device(torch.from_numpy(canvases), target, 3).numpy()
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape == (3, *target)
    assert len(np.unique(want)) == 4
    np.testing.assert_array_equal(got, want)
    host = processor.post_process_semantic(canvases, target, 3)
    np.testing.assert_array_equal(host, jproc.post_process_semantic(canvases, target, 3))
    np.testing.assert_array_equal(host, got.astype(np.int32))


# ----------------------------------------------------------- device votes


def _vote_case(seed: int):
    """Crops reaching past every edge (negative origins too), overlapping
    crops, and rows that are not valid."""
    rng = np.random.default_rng(seed)
    out_shape, cs, nc = (20, 30), 8, 4
    crops = [(-3, -2), (10, 5), (25, 15), (4, 4), (-9, 0), (29, 19), (6, 6), (50, 50)]
    ids = rng.integers(0, nc, (len(crops), cs, cs))
    one_hot = np.eye(nc, dtype=np.int32)[ids]
    valid = np.array([True, True, True, False, True, True, True, True])
    xmins = np.array([c[0] for c in crops], np.int32)
    ymins = np.array([c[1] for c in crops], np.int32)
    return out_shape, nc, one_hot, xmins, ymins, valid


@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_votes_matches_jax(seed):
    out_shape, nc, one_hot, xmins, ymins, valid = _vote_case(seed)
    want = jvotes.zero_counter(out_shape, nc)
    got = device_votes.zero_counter(out_shape, nc)
    for _ in range(2):  # a second batch adds onto the first
        want = jvotes.scatter_votes(want, jnp.asarray(one_hot), jnp.asarray(xmins), jnp.asarray(ymins), jnp.asarray(valid))
        out = device_votes.scatter_votes(got, torch.from_numpy(one_hot), torch.from_numpy(xmins),
                                         torch.from_numpy(ymins), torch.from_numpy(valid))
        assert out is got  # in place
    assert got.dtype == torch.int32 and tuple(got.shape) == (*out_shape, nc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.sum() > 0


def test_scatter_votes_drops_what_lies_outside_and_invalid_rows():
    counter = device_votes.zero_counter((4, 4), 2)
    one_hot = torch.ones((3, 2, 2, 2), dtype=torch.int32)
    # fully above-left, fully below-right, valid but skipped by valid=False
    device_votes.scatter_votes(counter, one_hot, torch.tensor([-2, 4, 1]), torch.tensor([-2, 4, 1]),
                               torch.tensor([True, True, False]))
    assert counter.sum() == 0
    device_votes.scatter_votes(counter, one_hot[:1], torch.tensor([-1]), torch.tensor([3]), torch.tensor([True]))
    assert counter.sum() == 2 and counter[3, 0].tolist() == [1, 1]  # only the in-bounds corner


# ------------------------------------------------------------ line metrics


def _lines(seed: int):
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 100, 23)
    a = np.stack([x, 5 * np.sin(x / 9) + rng.standard_normal(23)], 1)
    b = np.stack([x + 0.5, 5 * np.sin(x / 11) + 3 + rng.standard_normal(23)], 1)
    return a, b


@pytest.mark.parametrize("multi", [False, True], ids=["line", "multiline"])
def test_line_metrics_match_jax(multi):
    a, b = _lines(3)

    def build(line_cls, multi_cls, pts):
        if multi:
            return multi_cls([line_cls(pts[:12]), line_cls(pts[11:])])
        return line_cls(pts)

    pa, pb = build(LineString, MultiLineString, a), LineString(b)
    ja, jb = build(JLineString, JMultiLineString, a), JLineString(b)
    assert average_symmetric_distance(pa, pb, 300) == jasd(ja, jb, 300)
    assert average_symmetric_distance(pb, pa) == jasd(jb, ja)
    assert hausdorff_distance(pa, pb) == jhausdorff(ja, jb)
    assert hausdorff_distance(pa, pa) == 0.0
    assert average_symmetric_distance(LineString([(0, 0), (100, 0)]), LineString([(0, 3), (100, 3)]), 200) == pytest.approx(3.0)


# ---------------------------------------------------- random-palette predict


@pytest.fixture(scope="module")
def tuners():
    """A tiny fp32 model in both packages (as tests/test_torch_predict.py)."""
    over = dict(drop_path_rate=0.0, initializer_range=0.2)
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
    batch = {"image_u8": rng.integers(0, 256, (4, h // 2, h // 2, 3), dtype=np.uint8),
             "crop_idx": rng.integers(0, 4, (4,)).astype(np.int32)}
    return jtuner, params, tuner, prompts, batch, h


def test_random_palette_contract():
    """Class 0 black, every entry in [0, 256), uint8, drawn on the
    generator's device; one seed, one draw."""
    pal = random_palette(torch.Generator().manual_seed(3), 4, 64)
    assert pal.dtype == torch.uint8 and tuple(pal.shape) == (64, 4, 3)
    assert (pal[:, 0] == 0).all()
    assert int(pal.min()) >= 0 and int(pal.max()) < 256 and int(pal[:, 1:].max()) > 200
    assert torch.equal(pal, random_palette(torch.Generator().manual_seed(3), 4, 64))


@pytest.mark.parametrize("out_size", [None, "half"])
def test_random_palette_predict_matches_jax(tuners, out_size):
    """Given JAX's palette draw, the ids equal JAX's predict_step(painter_palette
    =False); drawn from a generator, they equal a call given that draw."""
    jtuner, params, tuner, (pixels, masks, nodata), batch, h = tuners
    size = h // 2 if out_size else None
    key = jax.random.PRNGKey(7)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = np.asarray(jtuner.predict_step(jnp.asarray(pixels), params, jnp.asarray(masks), jnp.asarray(nodata),
                                          jbatch, key, False, size))
    palette = np.array(jrandom_palette(key, 4, 4))
    got = tuner.predict_step(pixels, masks, nodata, batch, out_size=size, painter_palette=False, palette=palette).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert len(np.unique(want)) > 1
    np.testing.assert_array_equal(got, want)
    painter = tuner.predict_step(pixels, masks, nodata, batch, out_size=size).numpy()
    assert (painter != got).any()  # the palette reaches the ids

    drawn = tuner.predict_step(pixels, masks, nodata, batch, out_size=size, painter_palette=False,
                               generator=torch.Generator().manual_seed(5))
    same = tuner.predict_step(pixels, masks, nodata, batch, out_size=size, painter_palette=False,
                              palette=random_palette(torch.Generator().manual_seed(5), 4, 4))
    assert torch.equal(drawn, same)
    with pytest.raises(ValueError, match="generator"):
        tuner.predict_step(pixels, masks, nodata, batch, painter_palette=False)
    with pytest.raises(ValueError, match="painter_palette=False"):  # a palette is not dropped silently
        tuner.predict_step(pixels, masks, nodata, batch, palette=palette)
