"""The port's notebook helpers (beach_seg_tpu_torch.geo.notebook_utils)
against the JAX package's on the same inputs: tests/test_notebook_utils.py's
cases (a square polygon, CLAHE on a seeded image, windowed display reads of
a 4-band scene) plus an 8-band scene, a resized window, and a rotated
rectangle for the rotation helpers. Arrays must be equal; the plot helpers
must draw the same artists, with the same data, on an Agg figure."""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from beach_seg_tpu.geo import geometry as jgeom  # noqa: E402
from beach_seg_tpu.geo import notebook_utils as jnb  # noqa: E402
from beach_seg_tpu.geo.affine import Affine  # noqa: E402
from beach_seg_tpu.geo.tiff import write  # noqa: E402
from beach_seg_tpu_torch.geo import geometry as pgeom  # noqa: E402
from beach_seg_tpu_torch.geo import notebook_utils as pnb  # noqa: E402


def test_polygon_to_mask():
    coords = [(2, 2), (8, 2), (8, 8), (2, 8)]
    want = jnb.polygon_to_mask((12, 12), jgeom.Polygon(coords))
    got = pnb.polygon_to_mask((12, 12), pgeom.Polygon(coords))
    np.testing.assert_array_equal(got, want)
    assert got[5, 5] == 1 and got[0, 0] == 0


@pytest.mark.parametrize("shape", [(32, 32, 3), (40, 24)], ids=["rgb", "gray"])
def test_equalize_adapthist(shape):
    img = np.random.default_rng(0).random(shape).astype(np.float32)
    got = pnb.equalize_adapthist(img, clip_limit=0.02)
    np.testing.assert_array_equal(got, jnb.equalize_adapthist(img, clip_limit=0.02))
    assert got.shape == img.shape and got.dtype == np.float32


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("notebook")
    rng = np.random.default_rng(1)
    t = Affine.from_origin(0, 120, 3, 3)
    paths = {}
    for bands in (4, 8):
        data = rng.integers(100, 4000, (bands, 40, 40)).astype(np.uint16)
        data[:, :3, :5] = 0  # a nodata corner
        paths[bands] = root / f"scene{bands}.tif"
        write(paths[bands], data, t, crs=32611, nodata=0)
    return paths


@pytest.mark.parametrize("bands, win, crop", [
    (4, (5, 5, 25, 25), 32),  # resized 20 → 32
    (4, (0, 0, 20, 20), 20),  # the nodata corner, no resize
    (8, (5, 5, 25, 25), 32),  # broad_band
    (4, (100, 100, 120, 120), 16),  # outside the scene: the all-masked return
], ids=["resized", "nodata_corner", "eight_bands", "outside"])
def test_crop_with_mask(scenes, bands, win, crop):
    want_img, want_mask = jnb.crop_with_mask(scenes[bands], win, crop)
    got_img, got_mask = pnb.crop_with_mask(scenes[bands], win, crop)
    np.testing.assert_array_equal(got_img, want_img)
    np.testing.assert_array_equal(got_mask, want_mask)
    assert got_img.shape == (crop, crop, 3) and got_img.dtype == np.uint8


@pytest.fixture(scope="module")
def rotated():
    """A 70×20 rectangle rotated by 30° in a 100×120 mask."""
    import cv2

    mask = np.zeros((100, 120), np.uint8)
    box = cv2.boxPoints(((60.0, 50.0), (70.0, 20.0), 30.0)).astype(np.int32)
    cv2.fillPoly(mask, [box], 1)
    return mask


def test_align_scene_rotated_bbox(rotated):
    (want_rect, want_box), (got_rect, got_box) = jnb.align_scene_rotated_bbox(rotated), pnb.align_scene_rotated_bbox(rotated)
    assert got_rect == want_rect
    np.testing.assert_array_equal(got_box, want_box)


def test_rotation_matrix_and_rotate_array(rotated):
    want_m, want_size, want_angle = jnb.compute_rotation_matrix_for_mask(rotated)
    got_m, got_size, got_angle = pnb.compute_rotation_matrix_for_mask(rotated)
    np.testing.assert_array_equal(got_m, want_m)
    assert got_size == want_size and got_angle == want_angle
    for interpolation in (None, 0):  # cv2's default INTER_LINEAR, then INTER_NEAREST
        want = jnb.rotate_array(rotated * 255, want_m, want_size, interpolation)
        got = pnb.rotate_array(rotated * 255, got_m, got_size, interpolation)
        np.testing.assert_array_equal(got, want)
    assert got.shape == want_size[::-1]


def _artists(draw) -> list:
    """What ``draw(ax)`` puts on a fresh Agg axes: each artist's type and data."""
    fig, ax = plt.subplots()
    try:
        draw(ax)
        out = [("line", ln.get_color(), ln.get_linewidth(), np.asarray(ln.get_xydata()).tolist()) for ln in ax.lines]
        out += [("image", np.asarray(im.get_array()).tolist()) for im in ax.images]
        out += [("patch", type(p).__name__, p.get_xy(), p.get_width(), p.get_height(), p.get_edgecolor()) for p in ax.patches]
    finally:
        plt.close(fig)
    return out


@pytest.mark.parametrize("multi", [False, True], ids=["line", "multiline"])
def test_plot_line(multi):
    parts = [[(0, 0), (3, 4), (5, 1)], [(6, 6), (9, 2)]]

    def line(geom):
        return geom.MultiLineString([geom.LineString(p) for p in parts]) if multi else geom.LineString(parts[0])

    want = _artists(lambda ax: jnb.plot_line(line(jgeom), "red", ax, linewidth=0.7))
    got = _artists(lambda ax: pnb.plot_line(line(pgeom), "red", ax, linewidth=0.7))
    assert got == want and len(got) == (2 if multi else 1)


def test_plot_mask_and_crops():
    mask = (np.arange(48).reshape(6, 8) % 3 == 0).astype(np.float32)
    crops = [(0, 0, 10, 8), (5, 5, 9, 12)]
    want = _artists(lambda ax: (jnb.plot_mask(mask, "blue", 0.4, ax), jnb.plot_crops(crops, "green", ax)))
    got = _artists(lambda ax: (pnb.plot_mask(mask, "blue", 0.4, ax), pnb.plot_crops(crops, "green", ax)))
    assert got == want
    assert [a[0] for a in got] == ["image", "patch", "patch"]
