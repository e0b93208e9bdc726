"""
Basemap plotting (reference: pysteps/visualization/basemaps.py:53,144).

Cartopy-backed when cartopy is installed; otherwise `plot_geography` degrades
to a plain axes with the domain extent (the reference warns and returns
plt.gca() in the same situation).
"""

import warnings

import matplotlib.pyplot as plt
import numpy as np
from matplotlib import gridspec

from pysteps_tpu_torch.exceptions import MissingOptionalDependency

try:
    import cartopy.feature as cfeature
    from cartopy.mpl.geoaxes import GeoAxes

    CARTOPY_IMPORTED = True
except ImportError:
    CARTOPY_IMPORTED = False

VALID_BASEMAPS = ("cartopy",)

# Natural-Earth feature styling: (category, name, edge, face, zorder)
# (reference: basemaps.py:203-280; ocean/land/lakes at z=0, lines at z=15)
_WATER = np.array([0.59375, 0.71484375, 0.8828125])
_LAND = np.array([0.9375, 0.9375, 0.859375])


def plot_geography(proj4str, extent, lw=0.5, drawlonlatlines=False,
                   drawlonlatlabels=True, plot_map="cartopy", scale="50m",
                   subplot=None, **kwargs):
    """Geographic basemap in the data projection (reference: basemaps.py:53).
    Returns a cartopy GeoAxes, or plain axes when cartopy is unavailable."""
    if kwargs:
        warnings.warn(f"plot_geography: ignored keywords {sorted(kwargs)}")
    if plot_map is None:
        return plt.gca()
    if plot_map not in VALID_BASEMAPS:
        raise ValueError(
            f"unsupported plot_map method {plot_map}; supported: {VALID_BASEMAPS}"
        )
    if not CARTOPY_IMPORTED:
        warnings.warn(
            "cartopy is required to draw the geographical map but is not "
            "installed; ignoring the geographic information"
        )
        ax = plt.gca() if subplot is None else plt.subplot(*subplot)
        ax.set_xlim(extent[0], extent[1])
        ax.set_ylim(extent[2], extent[3])
        return ax

    from pysteps_tpu_torch.visualization.utils import proj4_to_cartopy

    crs = proj4_to_cartopy(proj4str)
    return plot_map_cartopy(
        crs, extent, scale,
        drawlonlatlines=drawlonlatlines,
        drawlonlatlabels=drawlonlatlabels,
        lw=lw, subplot=subplot,
    )


def plot_map_cartopy(crs, extent, cartopy_scale="50m", drawlonlatlines=False,
                     drawlonlatlabels=True, lw=0.5, subplot=None):
    """Draw coastlines/countries/rivers with cartopy Natural-Earth features
    (reference: basemaps.py:144-300)."""
    if not CARTOPY_IMPORTED:
        raise MissingOptionalDependency(
            "cartopy is required for plot_map_cartopy but is not installed"
        )

    if subplot is None:
        ax = plt.gca()
    elif isinstance(subplot, gridspec.SubplotSpec):
        ax = plt.subplot(subplot, projection=crs)
    else:
        ax = plt.subplot(*subplot, projection=crs)
    if not isinstance(ax, GeoAxes):
        ax = plt.subplot(ax.get_subplotspec(), projection=crs)
        ax.set_axis_off()

    # ocean at the coarsest of 50m to bound render cost (reference:206)
    ocean_scale = "50m" if cartopy_scale == "10m" else cartopy_scale
    features = [
        ("physical", "ocean", ocean_scale, "none", _WATER, 0, None),
        ("physical", "land", cartopy_scale, "none", _LAND, 0, None),
        ("physical", "lakes", cartopy_scale, "none", _WATER, 0, None),
        ("physical", "rivers_lake_centerlines", cartopy_scale, _WATER, "none", 0, None),
        ("physical", "coastline", cartopy_scale, "black", "none", 15, lw),
        ("cultural", "admin_0_boundary_lines_land", cartopy_scale, "black", "none", 15, lw),
    ]
    for category, name, scl, edge, face, zorder, width in features:
        ax.add_feature(
            cfeature.NaturalEarthFeature(
                category, name, scale=scl, edgecolor=edge, facecolor=face,
                **({"linewidth": width} if width is not None else {}),
            ),
            zorder=zorder,
        )

    if drawlonlatlines:
        grid = ax.gridlines(draw_labels=drawlonlatlabels, linewidth=0.3)
        grid.top_labels = grid.right_labels = False
        grid.y_inline = grid.x_inline = False
        grid.rotate_labels = False

    ax.set_extent(extent, crs)
    return ax
