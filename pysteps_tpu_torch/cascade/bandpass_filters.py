"""Fourier bandpass filters for the cascade decomposition (counterpart of
``pysteps_tpu/cascade/bandpass_filters.py``).

The weights are static per (shape, n): built on the host in float64 numpy
and returned as numpy arrays; callers move them to their device once.
"""

import functools

import numpy as np


def filter_uniform(shape, n):
    """Single all-pass band: the degenerate cascade."""
    del n
    try:
        height, width = shape
    except TypeError:
        height, width = shape, shape
    r_max = int(max(width, height) / 2) + 1
    return {
        "weights_1d": np.ones((1, r_max)),
        "weights_2d": np.ones((1, height, int(width / 2) + 1)),
        "central_freqs": None,
        "central_wavenumbers": None,
        "shape": (height, width),
    }


@functools.lru_cache(maxsize=32)
def _gaussian_weights(height, width, n, gauss_scale, normalize, include_mean):
    max_length = max(width, height)

    # radial wavenumber grid over the rfft2 half-plane, fftshift-rolled in y
    if height % 2 == 1:
        y = np.arange(-int(height / 2), int(height / 2) + 1)
    else:
        y = np.arange(-int(height / 2), int(height / 2))
    x = np.arange(int(width / 2) + 1)
    y_grid, x_grid = y[:, None], x[None, :]
    dy = int(height / 2) if height % 2 == 0 else int(height / 2) + 1
    r_2d = np.roll(np.sqrt(x_grid * x_grid + y_grid * y_grid), dy, axis=0)

    r_max = int(max_length / 2) + 1
    r_1d = np.arange(r_max)

    # log-spaced band centres: q^k geometric progression up to Nyquist
    q = (0.5 * max_length) ** (1.0 / n)
    centres = [0.5 * (q ** (k - 1) + q**k) for k in range(1, n + 1)]

    def log_q(x):
        with np.errstate(divide="ignore"):
            return np.where(x > 0, np.log(np.maximum(x, 1e-300)) / np.log(q), 0.0)

    def band_weight(r, centre):
        u = log_q(r) - log_q(centre)
        return np.exp(-(u**2) / (2.0 * gauss_scale**2))

    weights_1d = np.stack([band_weight(r_1d, c) for c in centres])
    weights_2d = np.stack([band_weight(r_2d, c) for c in centres])

    if normalize:
        weights_1d /= weights_1d.sum(axis=0, keepdims=True)
        weights_2d /= weights_2d.sum(axis=0, keepdims=True)

    # DC bin: all weight on level 0 (the field mean lives there)
    weights_1d[:, 0] = 0.0
    weights_2d[:, 0, 0] = 0.0
    if include_mean:
        weights_1d[0, 0] = 1.0
        weights_2d[0, 0, 0] = 1.0
    weights_1d.flags.writeable = False
    weights_2d.flags.writeable = False
    return weights_1d, weights_2d, tuple(centres)


def filter_gaussian(
    shape, n, gauss_scale=0.5, d=1.0, normalize=True, include_mean=True
):
    """n log-spaced Gaussian bandpass filters, normalized so the weights of
    each wavenumber sum to one; the DC bin goes to level 0."""
    if n < 3:
        raise ValueError("n must be greater than 2")
    try:
        height, width = shape
    except TypeError:
        height, width = shape, shape

    max_length = max(width, height)
    weights_1d, weights_2d, centres = _gaussian_weights(
        int(height), int(width), int(n), float(gauss_scale),
        bool(normalize), bool(include_mean),
    )
    central_wavenumbers = np.array(centres)
    central_freqs = central_wavenumbers / max_length
    central_freqs[0] = 1.0 / max_length
    central_freqs[-1] = 0.5
    return {
        "weights_1d": weights_1d,
        "weights_2d": weights_2d,
        "central_wavenumbers": central_wavenumbers,
        "central_freqs": d * central_freqs,
        "shape": (height, width),
    }
