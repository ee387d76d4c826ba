"""The port's geo data plane (beach_seg_tpu_torch.geo and its native library)
against the JAX package's on the synthetic scene: every step of the scene
setup bit-equal, with the native library and with its NumPy fallbacks, and
GeoTIFFs that read back bit-equal across the two packages."""

import contextlib
import os
from pathlib import Path

import numpy as np
import pytest

import beach_seg_tpu.geo as jgeo
import beach_seg_tpu_torch.geo as pgeo
from beach_seg_tpu.geo.tiff import read as jread
from beach_seg_tpu.geo.tiff import write as jwrite
from beach_seg_tpu_torch.geo.tiff import read as pread
from beach_seg_tpu_torch.geo.tiff import write as pwrite
from beach_seg_tpu_torch.native import build as pbuild
from tests.synthetic_scene import MASK_DATE, OTHER_DATES, build_scene

CROP = 32
NO_NATIVE = "BEACH_SEG_TPU_NO_NATIVE"


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return build_scene(tmp_path_factory.mktemp("geo_scene"))


@contextlib.contextmanager
def _fallback(on: bool):
    """The NumPy fallbacks of rasterize and contours (the switch both
    packages read on every call); the TIFF codec has none."""
    old = os.environ.get(NO_NATIVE)
    if on:
        os.environ[NO_NATIVE] = "1"
    try:
        yield
    finally:
        os.environ.pop(NO_NATIVE, None)
        if old is not None:
            os.environ[NO_NATIVE] = old


def _setup(geo, scene_dir: Path, numpy_fallback: bool) -> dict:
    """The create_scene steps in ``geo`` (one package's)."""
    mask_dir = scene_dir / "Masks"
    groups = geo.group_images_by_date(list((scene_dir / "SatelliteImagery").glob("*/*.tif")))
    transform, shape, crs = geo.compute_raster_extent(groups[MASK_DATE])

    def raster(pattern):
        geoms = []
        for p in geo.get_masks(mask_dir, pattern):
            geoms.extend(geo.read_shapefile(p)[0])
        return geo.rasterize(geoms, shape, transform) == 1

    with _fallback(numpy_fallback):
        veg, water = raster("Mask_*.shp"), raster("WaterMask_*.shp")
        nodata = geo.merged_no_data_mask(water, veg)
        line = geo.extract_linestring(water, nodata)
    crops = geo.generate_square_crops_along_line(line, CROP, 8)
    mosaics = {d: geo.merge_tifs(paths, shape, transform, crs) for d, paths in groups.items()}
    crop_arrays = [geo.crop_tif(c, *mosaics[MASK_DATE], water.astype(np.uint8), CROP) for c in crops]
    return {
        "extent": (transform.to_tuple(), shape, crs), "veg": veg, "water": water, "nodata": nodata,
        "line": line, "crops": crops, "mosaics": mosaics, "crop_arrays": crop_arrays,
    }


@pytest.fixture(scope="module", params=["native", "numpy"])
def setups(request, scene_dir):
    """Both packages with their native library, or both on the fallbacks."""
    fallback = request.param == "numpy"
    return _setup(jgeo, scene_dir, fallback), _setup(pgeo, scene_dir, fallback)


def test_extent_and_rasters_match_jax(setups):
    want, got = setups
    assert got["extent"] == want["extent"]
    for key in ("veg", "water", "nodata"):
        np.testing.assert_array_equal(got[key], want[key])
    assert want["water"].any() and want["veg"].any()


def test_shoreline_and_crops_match_jax(setups):
    want, got = setups
    assert type(got["line"]).__name__ == type(want["line"]).__name__
    lines = lambda ln: [g.coords for g in getattr(ln, "geoms", [ln])]  # noqa: E731
    for a, b in zip(lines(got["line"]), lines(want["line"]), strict=True):
        np.testing.assert_array_equal(a, b)
    assert got["crops"] == want["crops"] and len(want["crops"]) > 2


def test_mosaics_and_crop_tif_match_jax(setups):
    want, got = setups
    assert sorted(got["mosaics"]) == sorted(want["mosaics"]) == sorted([MASK_DATE, *OTHER_DATES])
    for date, (img, nodata) in want["mosaics"].items():
        np.testing.assert_array_equal(got["mosaics"][date][0], img)
        np.testing.assert_array_equal(got["mosaics"][date][1], nodata)
    for a, b in zip(got["crop_arrays"], want["crop_arrays"], strict=True):
        for x, y in zip(a, b, strict=True):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("compress", [None, "lzw", "deflate"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_tiff_reads_back_across_packages(tmp_path, compress, direction):
    rng = np.random.default_rng(3)
    transform = jgeo.Affine.from_origin(500000.0, 4100000.0, 3.0, 3.0)
    data = rng.integers(0, 4000, (4, 37, 53)).astype(np.uint16)
    write, read = (jwrite, pread) if direction == "jax_to_port" else (pwrite, jread)
    path = tmp_path / "x.tif"
    write(path, data, pgeo.Affine(*transform.to_tuple()) if write is pwrite else transform, crs=32611,
          nodata=0, compress=compress)
    r = read(path)
    np.testing.assert_array_equal(r.data, data)
    assert r.transform.to_tuple() == transform.to_tuple()
    assert r.crs == "EPSG:32611" and r.nodata == 0


def test_native_library_builds_into_the_port_build_dir(tmp_path, monkeypatch):
    """The port's build writes its library into beach_seg_tpu_torch/_build/
    under a name hashed from the sources, and nothing beside the sources."""
    before = set(pbuild._NATIVE_DIR.iterdir())
    monkeypatch.setattr(pbuild, "BUILD_DIR", tmp_path / "_build")
    out = pbuild.build()
    assert out.parent == tmp_path / "_build" and out.name.startswith("libbstnative-") and out.exists()
    assert [p.name for p in out.parent.iterdir()] == [out.name]  # no temporary file left behind
    assert set(pbuild._NATIVE_DIR.iterdir()) == before
    monkeypatch.undo()
    assert pbuild.lib_path().parent == Path(pgeo.__file__).resolve().parents[1] / "_build"
