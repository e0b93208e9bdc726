"""
Thunderstorm track plotting (reference:
pysteps/visualization/thunderstorms.py:27,62).
"""

import matplotlib.pyplot as plt

from pysteps_tpu_torch._device import to_numpy


def plot_track(track_list, geodata=None, ref_shape=None, ax=None, color="b"):
    """Plot cell tracks as centroid paths (reference: thunderstorms.py:27)."""
    if ax is None:
        ax = plt.gca()
    for track in track_list:
        ax.plot(track.cen_x, track.cen_y, "-o", ms=3, color=color)
    if ref_shape is not None:
        ax.set_xlim(0, ref_shape[1])
        ax.set_ylim(ref_shape[0], 0)
    return ax


def plot_cart_contour(contours, geodata=None, ref_shape=None, ax=None, color="k"):
    """Plot cell contours (reference: thunderstorms.py:62).  ``ref_shape``
    frames the pixel axes when no geodata is given."""
    if ax is None:
        ax = plt.gca()
    if geodata is None and ref_shape is not None:
        ax.set_xlim(0, ref_shape[1])
        ax.set_ylim(ref_shape[0], 0)
    for contour_set in contours:
        for cont in (contour_set if isinstance(contour_set, list) else [contour_set]):
            cont = to_numpy(cont)
            if cont.size:
                ax.plot(cont[:, 1], cont[:, 0], ".", ms=1, color=color)
    return ax
