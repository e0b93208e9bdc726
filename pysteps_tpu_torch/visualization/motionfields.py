"""
Motion-field plotting: quiver, streamplot, and the motion_plot dispatcher
(reference: pysteps/visualization/motionfields.py:27,145,193).  Geodata-aware
via visualization.utils.get_geogrid / get_basemap_axis.  A motion field may
be numpy or a torch tensor on any device, read back to the host once.
"""

import numpy as np

from pysteps_tpu_torch._device import to_numpy
from pysteps_tpu_torch.visualization.utils import get_basemap_axis, get_geogrid

VALID_PLOT_TYPES = ("quiver", "streamplot")


def motion_plot(uv_motion_field, plot_type="quiver", ax=None, geodata=None,
                axis="on", plot_kwargs=None, map_kwargs=None, step=20):
    """Plot a motion field as arrows or stream lines
    (reference: motionfields.py:27-144)."""
    if plot_type == "quiver":
        return quiver(uv_motion_field, ax=ax, geodata=geodata, axis=axis,
                      step=step, quiver_kwargs=plot_kwargs,
                      map_kwargs=map_kwargs)
    if plot_type == "streamplot":
        return streamplot(uv_motion_field, ax=ax, geodata=geodata, axis=axis,
                          streamplot_kwargs=plot_kwargs,
                          map_kwargs=map_kwargs)
    raise ValueError(
        f"unknown plot_type {plot_type}; valid: {VALID_PLOT_TYPES}"
    )


def _grid_for(uv, geodata):
    """Cell-centre grids + axis setup shared by quiver/streamplot."""
    m, n = uv.shape[1:]
    x_grid, y_grid, extent, _, origin = get_geogrid(m, n, geodata=geodata)
    return x_grid, y_grid, extent, origin


def quiver(uv_motion_field, ax=None, geodata=None, axis="on", step=20,
           quiver_kwargs=None, map_kwargs=None):
    """Quiver plot of a (2, m, n) motion field
    (reference: motionfields.py:145)."""
    uv = to_numpy(uv_motion_field)
    quiver_kwargs = quiver_kwargs or {}
    x_grid, y_grid, extent, origin = _grid_for(uv, geodata)
    ax = get_basemap_axis(extent, geodata=geodata, ax=ax, map_kwargs=map_kwargs)

    skip = (slice(None, None, step), slice(None, None, step))
    u = uv[0][skip]
    # image row index grows downward; flip v so arrows point with the flow
    # unless the grid itself has a lower origin
    v = uv[1][skip] if origin == "lower" else -uv[1][skip]
    ax.quiver(x_grid[skip], y_grid[skip], u, v, angles="xy", zorder=20,
              **quiver_kwargs)
    if axis == "off":
        ax.axis("off")
    return ax


def streamplot(uv_motion_field, ax=None, geodata=None, axis="on",
               streamplot_kwargs=None, map_kwargs=None, step=20):
    """Streamplot of a (2, m, n) motion field
    (reference: motionfields.py:193).  ``step`` is accepted for signature
    parity; matplotlib's streamplot integrates on the full grid and
    controls line spacing via streamplot_kwargs['density']."""
    del step
    uv = to_numpy(uv_motion_field)
    streamplot_kwargs = streamplot_kwargs or {}
    x_grid, y_grid, extent, origin = _grid_for(uv, geodata)
    ax = get_basemap_axis(extent, geodata=geodata, ax=ax, map_kwargs=map_kwargs)

    # streamplot requires strictly increasing 1-D coordinates
    x = x_grid[0]
    y = np.sort(y_grid[:, 0])
    v = uv[1] if origin == "lower" else -uv[1]
    ax.streamplot(x, y, uv[0], v, zorder=20, **streamplot_kwargs)
    if axis == "off":
        ax.axis("off")
    return ax
