"""Fourier-domain statistics (counterpart of
``pysteps_tpu/utils/spectral.py``).  Every function takes leading batch
axes where the JAX one does and runs on its input's device."""

import functools

import numpy as np
import torch

from pysteps_tpu_torch._device import as_device_tensor
from pysteps_tpu_torch.utils.arrays import compute_centred_coord_array


@functools.lru_cache(maxsize=64)
def _radial_bins(m, n):
    """The rounded radius of each pixel of an (m, n) grid (int64, from the
    centre), the number of radial bins, each bin's pixel count (at least
    1) and the largest radius."""
    yc, xc = compute_centred_coord_array(m, n)
    r_grid = np.round(np.sqrt(xc * xc + yc * yc)).astype(np.int64)
    side = max(m, n)
    n_bins = int(side / 2) + 1 if side % 2 == 1 else int(side / 2)
    counts = np.bincount(r_grid.ravel(), minlength=n_bins)[:n_bins]
    return r_grid, n_bins, np.maximum(counts, 1), int(r_grid.max())


def rapsd(field, fft_method="compute", return_freq=False, d=1.0, normalize=False,
          fft=None, **fft_kwargs):
    """Radially averaged power spectral density of a 2-D field.

    ``fft_method=None`` (or ``fft=False``) takes ``field`` as the
    already-centred (fftshifted) PSD; otherwise the PSD is computed from
    the spatial field.  The radial sums are a float32 ``scatter_add_`` (the
    JAX package sums by segment, in another order)."""
    if fft is None:
        fft = fft_method is not None
    m, n = field.shape
    r_grid, n_bins, counts, r_max = _radial_bins(m, n)
    if fft:
        F = torch.fft.fftshift(torch.fft.fft2(field))
        psd = (F.real**2 + F.imag**2) / F.numel()
    else:
        psd = field
    idx = torch.as_tensor(r_grid, device=psd.device).reshape(-1)
    sums = torch.zeros(max(n_bins, r_max + 1), dtype=psd.dtype, device=psd.device)
    sums.scatter_add_(0, idx, psd.reshape(-1))
    result = sums[:n_bins] / torch.as_tensor(counts, dtype=psd.dtype, device=psd.device)
    if normalize:
        result = result / result.sum()
    if return_freq:
        freq = np.fft.fftfreq(max(m, n), d=d)[:n_bins]
        return result, torch.as_tensor(freq, dtype=result.dtype, device=result.device)
    return result


def mean(X, shape):
    """Spatial mean from the DC bin; leading batch axes allowed."""
    return X[..., 0, 0].real / float(shape[0] * shape[1])


def _inner(X, shape):
    """The rfft2 half-plane's columns that stand for two columns of the
    full plane (their conjugate mirrors)."""
    return X[..., :, 1:] if shape[1] % 2 == 1 else X[..., :, 1:-1]


def std(X, shape, use_full_fft=False):
    """Spatial standard deviation via Parseval from rfft2 half-planes, or
    from full fft2 planes with ``use_full_fft``; leading batch axes
    allowed."""
    p = X.real**2 + X.imag**2
    res = torch.sum(p, dim=(-2, -1)) - X[..., 0, 0].real ** 2
    if not use_full_fft:
        # the half-plane holds the conjugate-mirrored columns once: count twice
        res = res + torch.sum(_inner(p, shape), dim=(-2, -1))
    return torch.sqrt(res / float(shape[0] * shape[1]) ** 2)


def corrcoef(X, Y, shape, use_full_fft=False):
    """Correlation coefficient of two fields from their spectra (rfft2
    half-planes, or full planes with ``use_full_fft``); leading batch axes
    allowed."""

    def dot(A, B):
        return torch.sum(A.real * B.real + A.imag * B.imag, dim=(-2, -1))

    def power(A):
        return torch.sum(A.real**2 + A.imag**2, dim=(-2, -1))

    n = dot(X, Y) - (X[..., 0, 0] * Y[..., 0, 0]).real
    d1 = power(X) - X[..., 0, 0].real ** 2
    d2 = power(Y) - Y[..., 0, 0].real ** 2
    if not use_full_fft:
        Xi, Yi = _inner(X, shape), _inner(Y, shape)
        n = n + dot(Xi, Yi)
        d1 = d1 + power(Xi)
        d2 = d2 + power(Yi)
    return n / torch.sqrt(d1 * d2)


def remove_rain_norain_discontinuity(R, device=None):
    """Shift the wet pixels down so that the smallest wet value meets the
    dry value, then subtract the minimum.  NaN-safe.  Runs on the device
    of a tensor ``R``; other input goes to the card unless ``device`` says
    otherwise."""
    R = as_device_tensor(R, device)
    inf = torch.tensor(float("inf"), dtype=R.dtype, device=R.device)
    zerovalue = torch.where(torch.isnan(R), inf, R).amin()
    wet = R > zerovalue
    threshold = torch.where(wet, R, inf).amin()
    R = torch.where(wet, R - (threshold - zerovalue), R)
    return R - torch.where(torch.isnan(R), inf, R).amin()
