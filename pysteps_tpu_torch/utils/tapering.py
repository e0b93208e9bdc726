"""2-D tapering (window) functions (counterpart of
``pysteps_tpu/utils/tapering.py``).  Windows are static per shape and are
built host-side with numpy."""

import functools

import numpy as np


def compute_window_function(m, n, func, **kwargs):
    """Radial 2-D window of shape (m, n); ``func`` in {'hann', 'tukey'}.
    Returns a fresh writable float64 numpy array."""
    return _window_cached(m, n, func, tuple(sorted(kwargs.items()))).copy()


@functools.lru_cache(maxsize=32)
def _window_cached(m, n, func, kw_items):
    kwargs = dict(kw_items)
    X, Y = np.meshgrid(np.arange(n), np.arange(m))
    R = np.sqrt(((X / n) - 0.5) ** 2 + ((Y / m) - 0.5) ** 2)
    if func == "hann":
        out = _hann(R)
    elif func == "tukey":
        out = _tukey(R, kwargs.get("alpha", 0.2))
    else:
        raise ValueError(f"invalid window function '{func}'")
    out.flags.writeable = False
    return out


def _hann(R):
    W = 0.5 * (1.0 - np.cos(2.0 * np.pi * (R + 0.5)))
    W[R > 0.5] = 0.0
    return W


def _tukey(R, alpha):
    W = np.ones_like(R)
    ramp = (R < 0.5) & (R > 0.5 * (1.0 - alpha))
    W[ramp] = 0.5 * (
        1.0 + np.cos(np.pi * (R[ramp] / (alpha * 0.5) - 1.0 / alpha + 1.0))
    )
    W[R >= 0.5] = 0.0
    return W


def compute_mask_window_function(mask, func, **kwargs):
    """Window of a non-rectangular domain given by a boolean mask: a Tukey
    ramp over the distance to the nearest pixel outside the mask
    (``r_max`` pixels wide), NaN outside.  The distance is SciPy's exact
    Euclidean distance transform, on the host."""
    from scipy.ndimage import distance_transform_edt

    if func == "hann":
        raise NotImplementedError("hann masked window not implemented")
    if func != "tukey":
        raise ValueError(f"invalid window function '{func}'")
    mask = np.asarray(mask)
    r_max = kwargs.get("r_max", 10.0)
    R = distance_transform_edt(mask.astype(bool))
    W = np.ones(mask.shape)
    inside = mask.astype(bool)
    ramp = inside & (R < r_max)
    W[ramp] = 0.5 * (1.0 + np.cos(np.pi * (R[ramp] / r_max - 1.0)))
    W[~inside] = np.nan
    return W
