"""The host geo/raster data plane (counterpart of ``beach_seg_tpu/geo``,
copied), and the notebooks' helpers (``geo.notebook_utils``)."""

from beach_seg_tpu_torch.geo.affine import Affine, bounds
from beach_seg_tpu_torch.geo.contours import extract_linestring, find_contours
from beach_seg_tpu_torch.geo.extent import (
    compute_raster_extent,
    get_masks,
    group_images_by_date,
    infer_date,
    tif_paths,
)
from beach_seg_tpu_torch.geo.geometry import (
    LineString,
    MultiLineString,
    Polygon,
    generate_square_crops_along_line,
    linemerge,
)
from beach_seg_tpu_torch.geo.masks import crop_tif, merged_no_data_mask, padded_crop, safe_assign_crop
from beach_seg_tpu_torch.geo.mosaic import merge_tifs, reproject
from beach_seg_tpu_torch.geo.rasterize import rasterize
from beach_seg_tpu_torch.geo.shapefile import read_shapefile, save_shapefile
from beach_seg_tpu_torch.geo.tiff import Raster, read, read_info, write
