"""
Precipitation-field plotting (reference:
pysteps/visualization/precipfields.py:33,242,306).  Host-side matplotlib
with the pysteps colorscale; a field may be numpy or a torch tensor on any
device, read back to the host once.
"""

import matplotlib.pyplot as plt
import numpy as np
from matplotlib import colors

from pysteps_tpu_torch._device import to_numpy
PRECIP_VALID_TYPES = ("intensity", "depth", "prob")
PRECIP_VALID_UNITS = ("mm/h", "mm", "dBZ")


def get_colormap(ptype="intensity", units="mm/h", colorscale="pysteps"):
    """Colormap + norm + ticks for precipitation plots
    (reference: precipfields.py:242)."""
    if ptype == "prob":
        cmap = plt.get_cmap("OrRd", 10)
        return cmap, colors.Normalize(vmin=0, vmax=1), np.linspace(0, 1, 11), None

    if colorscale == "pysteps":
        color_list = [
            "#9c7e94", "#640064", "#AF00AF", "#DC00DC", "#3232C8",
            "#0064FF", "#009696", "#00C832", "#64FF00", "#96FF00",
            "#C8FF00", "#FFFF00", "#FFC800", "#FFA000", "#FF7D00",
            "#E11900",
        ]
        if units in ("mm/h", "mm"):
            clevs = [
                0.08, 0.16, 0.25, 0.40, 0.63, 1, 1.6, 2.5, 4, 6.3, 10,
                16, 25, 40, 63, 100, 160,
            ]
        else:  # dBZ
            clevs = list(np.arange(10, 65, 5))
            color_list = color_list[: len(clevs) - 1]
        cmap = colors.LinearSegmentedColormap.from_list(
            "pysteps", color_list, len(clevs) - 1
        )
        cmap.set_over("darkred")
        cmap.set_bad("gray", alpha=0.5)
        cmap.set_under("none")
        norm = colors.BoundaryNorm(clevs, cmap.N)
        return cmap, norm, clevs, None

    cmap = plt.get_cmap("jet")
    return cmap, colors.Normalize(), None, None


def plot_precip_field(
    precip,
    ptype="intensity",
    ax=None,
    geodata=None,
    units="mm/h",
    bbox=None,
    colorscale="pysteps",
    probthr=None,
    title=None,
    colorbar=True,
    axis="on",
    cax=None,
    map_kwargs=None,
    colormap_config=None,
):
    """Plot a precipitation field (reference: precipfields.py:33).

    ``colormap_config`` (any object with cmap/norm/clevs attributes,
    reference: precipfields.py:119-123,521) overrides ``colorscale``."""
    precip = to_numpy(precip)
    if ax is None:
        ax = plt.gca()
    if colormap_config is not None:
        missing = [a for a in ("cmap", "norm", "clevs")
                   if not hasattr(colormap_config, a)]
        if missing:
            raise ValueError(
                f"colormap_config is missing attributes: {missing}"
            )
        cmap, norm, clevs = (
            colormap_config.cmap, colormap_config.norm, colormap_config.clevs
        )
    else:
        cmap, norm, clevs, _ = get_colormap(ptype, units, colorscale)

    extent = None
    if geodata is not None:
        extent = (geodata["x1"], geodata["x2"], geodata["y1"], geodata["y2"])
    field = np.ma.masked_invalid(precip)
    if ptype == "intensity":
        field = np.ma.masked_where(field < (clevs[0] if clevs else 0), field)
    im = ax.imshow(
        field, cmap=cmap, norm=norm, extent=extent, origin="upper",
        interpolation="nearest",
    )
    if colorbar:
        has_levels = clevs is not None and len(np.atleast_1d(clevs)) > 0
        cb = plt.colorbar(
            im, ax=ax, cax=cax, ticks=clevs,
            extend="max" if (has_levels and ptype == "intensity") else "neither",
        )
        cb.set_label(units if ptype == "intensity" else "P(R > thr)")
    if title:
        ax.set_title(title)
    if axis == "off":
        ax.axis("off")
    if bbox is not None:
        ax.set_xlim(bbox[0], bbox[2])
        ax.set_ylim(bbox[1], bbox[3])
    return ax
