"""Affine geotransforms (replacement for the ``affine`` package used by
rasterio, ref src/util/geo_util.py:10).

Convention matches ``affine.Affine(a, b, c, d, e, f)``:

    x = a·col + b·row + c
    y = d·col + e·row + f

with (col, row) the pixel column/row; (c, f) is the world position of the
top-left corner of pixel (0, 0).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Affine:
    a: float
    b: float
    c: float
    d: float
    e: float
    f: float

    @classmethod
    def identity(cls) -> "Affine":
        return cls(1.0, 0.0, 0.0, 0.0, 1.0, 0.0)

    @classmethod
    def from_origin(cls, west: float, north: float, xsize: float, ysize: float) -> "Affine":
        """North-up transform: pixel (0,0) top-left at (west, north)."""
        return cls(xsize, 0.0, west, 0.0, -ysize, north)

    def __mul__(self, other):
        # affine-package semantics: Affine * Affine composes; Affine * (x, y)
        # transforms a point (the idiom rasterio users write as
        # ``~transform * (x, y)``, ref geo_util.py usage of the affine pkg)
        if isinstance(other, Affine):
            return Affine(
                self.a * other.a + self.b * other.d,
                self.a * other.b + self.b * other.e,
                self.a * other.c + self.b * other.f + self.c,
                self.d * other.a + self.e * other.d,
                self.d * other.b + self.e * other.e,
                self.d * other.c + self.e * other.f + self.f,
            )
        col, row = other
        return self.apply(col, row)

    def __invert__(self) -> "Affine":
        det = self.a * self.e - self.b * self.d
        if det == 0:
            raise ValueError("singular transform")
        ia, ib = self.e / det, -self.b / det
        id_, ie = -self.d / det, self.a / det
        return Affine(ia, ib, -(ia * self.c + ib * self.f), id_, ie, -(id_ * self.c + ie * self.f))

    def apply(self, col: float, row: float) -> tuple[float, float]:
        return (self.a * col + self.b * row + self.c, self.d * col + self.e * row + self.f)

    # rasterio-style: transform * (col, row)
    def __call__(self, col: float, row: float) -> tuple[float, float]:
        return self.apply(col, row)

    def xy(self, row: float, col: float, offset: str = "center") -> tuple[float, float]:
        """World coordinates of a pixel (rasterio transform.xy semantics)."""
        if offset == "center":
            col, row = col + 0.5, row + 0.5
        return self.apply(col, row)

    def rowcol(self, x: float, y: float) -> tuple[int, int]:
        """Integer pixel containing world point (x, y)."""
        inv = ~self
        col, row = inv.apply(x, y)
        import math

        return int(math.floor(row)), int(math.floor(col))

    def to_tuple(self) -> tuple[float, float, float, float, float, float]:
        return (self.a, self.b, self.c, self.d, self.e, self.f)

    @classmethod
    def from_tuple(cls, t) -> "Affine":
        return cls(*[float(v) for v in t])


def bounds(transform: Affine, shape: tuple[int, int]) -> tuple[float, float, float, float]:
    """(left, bottom, right, top) world bounds of a north-up raster."""
    h, w = shape
    x0, y0 = transform.apply(0, 0)
    x1, y1 = transform.apply(w, h)
    return (min(x0, x1), min(y0, y1), max(x0, x1), max(y0, y1))
