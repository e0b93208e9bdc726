"""
Grid reprojection (counterpart of ``pysteps_tpu/utils/reprojection.py``;
reference: pysteps/utils/reprojection.py:36,132).  It stays on the host,
as the JAX package's does: tensors are read back to numpy and the results
are numpy arrays.

The reference delegates to rasterio/pyproj.  Here the full cross-projection
path is implemented natively: destination cell centres are mapped to
lon/lat with the built-in inverse projection
(:mod:`pysteps_tpu_torch.utils.projection`), forward-projected into the source
grid, and bilinearly sampled (NaN outside the source domain) — the same
semantics as rasterio's bilinear ``reproject``.
"""

import numpy as np
import torch
from scipy.ndimage import map_coordinates

from pysteps_tpu_torch.exceptions import MissingOptionalDependency
from pysteps_tpu_torch.utils.projection import Proj


def _host(x):
    """A tensor's values as numpy (from any device); anything else as is."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _grid_centers(metadata, shape):
    """1-D cell-centre coordinate vectors (x, y) ordered like the array
    rows/cols (row 0 at y2 for yorigin='upper')."""
    h, w = shape
    x = np.linspace(metadata["x1"], metadata["x2"], w + 1)[:-1]
    x += 0.5 * (x[1] - x[0])
    y = np.linspace(metadata["y1"], metadata["y2"], h + 1)[:-1]
    y += 0.5 * (y[1] - y[0])
    if metadata.get("yorigin", "upper") == "upper":
        y = y[::-1]
    return x, y


def reproject_grids(src_array, dst_array, metadata_src, metadata_dst):
    """Reproject fields onto the grid of ``dst_array``
    (reference: reprojection.py:36; same call signature).

    Parameters follow the reference: ``src_array`` is (t, y, x) (leading
    axes allowed), ``dst_array`` supplies the destination shape, and the
    two metadata dicts carry the projection + extent contract of
    the JAX package's importers.  Returns (reprojected, metadata)
    where metadata is ``metadata_dst`` updated with the source's unit and
    transform keys.
    """
    src_array = np.asarray(_host(src_array), float)
    dst_shape = tuple(np.shape(dst_array)[-2:])
    src_shape = src_array.shape[-2:]

    x_dst, y_dst = _grid_centers(metadata_dst, dst_shape)
    x2d, y2d = np.meshgrid(x_dst, y_dst)

    same_proj = metadata_src.get("projection") == metadata_dst.get("projection")
    if not same_proj:
        try:
            proj_src = Proj(metadata_src["projection"])
            proj_dst = Proj(metadata_dst["projection"])
        except MissingOptionalDependency as err:
            raise MissingOptionalDependency(
                f"cannot reproject between these grids natively ({err}); "
                "pyproj/rasterio are not installed"
            ) from err
        lon, lat = proj_dst(x2d, y2d, inverse=True)
        x2d, y2d = proj_src(lon, lat)

    # fractional source indices of each destination cell centre
    x_src, y_src = _grid_centers(metadata_src, src_shape)
    xpix = x_src[1] - x_src[0]
    cols = (x2d - x_src[0]) / xpix
    ypix = y_src[1] - y_src[0]  # negative for yorigin='upper'
    rows = (y2d - y_src[0]) / ypix

    leading = src_array.shape[:-2]
    flat = src_array.reshape((-1,) + src_shape)
    out = np.stack(
        [
            map_coordinates(
                frame, [rows, cols], order=1, mode="constant",
                cval=np.nan, prefilter=False,
            )
            for frame in flat
        ]
    ).reshape(leading + dst_shape)

    metadata = dict(metadata_dst)
    for key in ("unit", "transform", "accutime", "zerovalue", "threshold"):
        if key in metadata_src:
            metadata[key] = metadata_src[key]
    return out, metadata


def reprojection(src_array, dst_array, metadata_src, metadata_dst):
    """Alias kept for API parity (reference exposes 'reproject_grids')."""
    return reproject_grids(src_array, dst_array, metadata_src, metadata_dst)


def unstructured2regular(src_array, metadata_src, metadata_dst):
    """Nearest-neighbour regrid of unstructured (cell-list) data onto a
    regular grid in the destination projection
    (reference: reprojection.py:132-241, via the built-in projections
    instead of pyproj).

    src_array: (t, n_ens, n_gridcells); metadata_src must carry per-cell
    centre coordinates ``clon``/``clat``.  Returns ((t, n_ens, y, x), dict).
    """
    from scipy.spatial import cKDTree

    for key in ("clon", "clat"):
        if key not in metadata_src:
            raise KeyError(f"cell centre coordinate '{key}' missing in metadata_src")

    x_dst = np.arange(
        np.float32(metadata_dst["x1"]),
        np.float32(metadata_dst["x2"]),
        metadata_dst["xpixelsize"],
    )
    y_dst = np.arange(
        np.float32(metadata_dst["y1"]),
        np.float32(metadata_dst["y2"]),
        metadata_dst["ypixelsize"],
    )
    if metadata_dst["yorigin"] == "upper":
        y_dst = y_dst[::-1]
    xx, yy = np.meshgrid(x_dst, y_dst)

    proj = Proj(metadata_dst["projection"])
    x_src, y_src = proj(metadata_src["clon"], metadata_src["clat"])
    tree = cKDTree(np.stack((np.ravel(x_src), np.ravel(y_src)), axis=1))
    _, ic_out = tree.query(np.stack((xx.ravel(), yy.ravel()), axis=1))
    ic_out = ic_out.reshape(xx.shape)

    r_rprj = np.asarray(_host(src_array))[..., ic_out]

    metadata = metadata_src.copy()
    for key in ("projection", "yorigin", "xpixelsize", "ypixelsize",
                "x1", "x2", "y1", "y2", "cartesian_unit"):
        metadata[key] = metadata_dst[key]
    return r_rprj, metadata
