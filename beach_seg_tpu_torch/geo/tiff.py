"""GeoTIFF read/write over the native codec (ctypes binding of tiffio.cc).

Replaces rasterio's ``open/read/read_masks`` and the GeoTIFF writers
(ref src/util/geo_util.py:57-80,374-422;
src/util/img_util.py:67-95). Data is returned channels-first (C, H, W) to
match rasterio's ``src.read()`` convention used throughout the reference.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from beach_seg_tpu_torch.geo.affine import Affine, bounds as _bounds
from beach_seg_tpu_torch.native.build import load as _load_native

_DTYPES = {
    0: np.uint8,
    1: np.uint16,
    2: np.int16,
    3: np.uint32,
    4: np.int32,
    5: np.float32,
    6: np.float64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


class _BstInfo(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_int32),
        ("height", ctypes.c_int32),
        ("channels", ctypes.c_int32),
        ("dtype", ctypes.c_int32),
        ("transform", ctypes.c_double * 6),
        ("epsg", ctypes.c_int32),
        ("nodata", ctypes.c_double),
        ("has_nodata", ctypes.c_int32),
    ]


def _lib():
    lib = _load_native()
    lib.bst_open.restype = ctypes.c_void_p
    lib.bst_open.argtypes = [ctypes.c_char_p]
    lib.bst_info.argtypes = [ctypes.c_void_p, ctypes.POINTER(_BstInfo)]
    lib.bst_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.bst_close.argtypes = [ctypes.c_void_p]
    lib.bst_write.restype = ctypes.c_int
    lib.bst_write.argtypes = [
        ctypes.c_char_p,
        ctypes.c_void_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_double),
    ]
    return lib


@dataclass
class Raster:
    """An in-memory raster: (C, H, W) data + georeferencing."""

    data: np.ndarray  # (C, H, W)
    transform: Affine
    crs: str | None  # "EPSG:nnnn" or None
    nodata: float | None = None

    @property
    def count(self) -> int:
        return self.data.shape[0]

    @property
    def shape(self) -> tuple[int, int]:
        return self.data.shape[1], self.data.shape[2]

    @property
    def bounds(self) -> tuple[float, float, float, float]:
        return _bounds(self.transform, self.shape)

    def valid_mask(self) -> np.ndarray:
        """(H, W) uint8 validity (255 valid) — rasterio ``read_masks(1)``
        semantics: invalid where band 1 equals the nodata value."""
        if self.nodata is None:
            return np.full(self.shape, 255, np.uint8)
        return np.where(self.data[0] == self.nodata, 0, 255).astype(np.uint8)


def epsg_str(epsg: int) -> str | None:
    return f"EPSG:{epsg}" if epsg else None


def read_info(path: Path | str) -> Raster:
    """Open and return georeferencing only (data array empty)."""
    lib = _lib()
    h = lib.bst_open(str(path).encode())
    if not h:
        raise OSError(f"cannot open TIFF: {path}")
    try:
        info = _BstInfo()
        lib.bst_info(h, ctypes.byref(info))
        return Raster(
            # zero-strided placeholder: carries shape/dtype without allocation
            data=np.broadcast_to(
                np.zeros((1,), _DTYPES[info.dtype]), (info.channels, info.height, info.width)
            ),
            transform=Affine.from_tuple(list(info.transform)),
            crs=epsg_str(info.epsg),
            nodata=info.nodata if info.has_nodata else None,
        )
    finally:
        lib.bst_close(h)


def read(path: Path | str, dtype=None) -> Raster:
    """Read a full GeoTIFF → Raster with (C, H, W) data."""
    lib = _lib()
    h = lib.bst_open(str(path).encode())
    if not h:
        raise OSError(f"cannot open TIFF: {path}")
    try:
        info = _BstInfo()
        lib.bst_info(h, ctypes.byref(info))
        hwc = np.empty((info.height, info.width, info.channels), _DTYPES[info.dtype])
        rc = lib.bst_read(h, hwc.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise OSError(f"TIFF decode failed ({rc}): {path}")
        data = np.ascontiguousarray(hwc.transpose(2, 0, 1))
        if dtype is not None:
            data = data.astype(dtype)
        return Raster(
            data=data,
            transform=Affine.from_tuple(list(info.transform)),
            crs=epsg_str(info.epsg),
            nodata=info.nodata if info.has_nodata else None,
        )
    finally:
        lib.bst_close(h)


def read_window(path: Path | str, window: tuple[int, int, int, int], dtype=None) -> Raster:
    """Windowed read: ``window`` = (x0, y0, width, height) in pixels (must lie
    inside the image). Only the covering strips/tiles are decoded — the
    rasterio ``Window`` read path for huge scenes."""
    lib = _lib()
    lib.bst_read_window.restype = ctypes.c_int
    lib.bst_read_window.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    h = lib.bst_open(str(path).encode())
    if not h:
        raise OSError(f"cannot open TIFF: {path}")
    try:
        info = _BstInfo()
        lib.bst_info(h, ctypes.byref(info))
        x0, y0, w, hh = window
        hwc = np.empty((hh, w, info.channels), _DTYPES[info.dtype])
        rc = lib.bst_read_window(h, x0, y0, w, hh, hwc.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise OSError(f"TIFF window decode failed ({rc}): {path} {window}")
        data = np.ascontiguousarray(hwc.transpose(2, 0, 1))
        if dtype is not None:
            data = data.astype(dtype)
        base = Affine.from_tuple(list(info.transform))
        ox, oy = base.apply(x0, y0)
        return Raster(
            data=data,
            transform=Affine(base.a, base.b, ox, base.d, base.e, oy),
            crs=epsg_str(info.epsg),
            nodata=info.nodata if info.has_nodata else None,
        )
    finally:
        lib.bst_close(h)


_COMPRESSION = {None: 0, "none": 0, "lzw": 1, "deflate": 2}


def write(
    path: Path | str,
    data: np.ndarray,
    transform: Affine | None = None,
    crs: str | int | None = None,
    nodata: float | None = None,
    compress: str | None = "lzw",
) -> None:
    """Write (C, H, W) or (H, W) data as a GeoTIFF (ref save_tif /
    write_mask_tif — masks default to LZW like the reference)."""
    if data.ndim == 2:
        data = data[None]
    c, h, w = data.shape
    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    code = _DTYPE_CODES.get(np.dtype(data.dtype))
    if code is None:
        raise ValueError(f"unsupported dtype {data.dtype}")
    hwc = np.ascontiguousarray(data.transpose(1, 2, 0))

    epsg = 0
    if isinstance(crs, int):
        epsg = crs
    elif isinstance(crs, str) and crs.upper().startswith("EPSG:"):
        epsg = int(crs.split(":")[1])

    tf = None
    if transform is not None:
        tf = (ctypes.c_double * 6)(*transform.to_tuple())
    nd = None if nodata is None else ctypes.byref(ctypes.c_double(float(nodata)))

    rc = _lib().bst_write(
        str(path).encode(),
        hwc.ctypes.data_as(ctypes.c_void_p),
        w,
        h,
        c,
        code,
        tf,
        epsg,
        _COMPRESSION[compress],
        ctypes.cast(nd, ctypes.POINTER(ctypes.c_double)) if nd else None,
    )
    if rc != 0:
        raise OSError(f"TIFF write failed ({rc}): {path}")
