"""FFT cascade decomposition and recomposition on ``torch.fft``
(counterpart of the ``*_core`` functions of
``pysteps_tpu/cascade/decomposition.py``).

Every function takes fields with any leading batch axes: ``(..., m, n)``
spatial, ``(..., m, n//2+1)`` spectral, and filter banks
``(k, m, n//2+1)``; the level axis is inserted just before the grid axes.
"""

import torch

from pysteps_tpu_torch.utils import spectral as spectral_utils


def _masked_moments(levels, mask):
    """Per-level mean and std of (..., k, m, n) over the grid, or over a
    boolean (m, n) ``mask``."""
    if mask is None:
        means = levels.mean(dim=(-2, -1))
        stds = levels.std(dim=(-2, -1), correction=0)
    else:
        w = mask.to(levels.dtype)
        cnt = torch.clamp(w.sum(), min=1.0)
        means = (levels * w).sum(dim=(-2, -1)) / cnt
        var = ((levels - means[..., None, None]) ** 2 * w).sum(dim=(-2, -1)) / cnt
        stds = torch.sqrt(var)
    return means, stds


def decompose_core(field, weights_2d, mask=None, normalize=True):
    """Decompose (..., m, n) into levels (..., k, m, n).  Returns (levels,
    means (..., k), stds (..., k)); with ``normalize`` each level is
    standardized (statistics over ``mask`` if given)."""
    shape = field.shape[-2:]
    field_fft = torch.fft.rfft2(field)
    levels = torch.fft.irfft2(field_fft[..., None, :, :] * weights_2d, s=shape)
    means, stds = _masked_moments(levels, mask)
    if normalize:
        levels = (levels - means[..., None, None]) / torch.clamp(
            stds[..., None, None], min=1e-12
        )
    return levels, means, stds


def decompose_spectral_core(field_fft, weights_2d, shape, normalize=True):
    """Spectral-domain decomposition of rfft2 half-planes (..., m, n//2+1)
    into levels (..., k, m, n//2+1).  The mean acts on the DC bin only and
    the std comes from Parseval."""
    levels_fft = field_fft[..., None, :, :] * weights_2d
    means = spectral_utils.mean(levels_fft, shape)
    stds = spectral_utils.std(levels_fft, shape)
    if normalize:
        size = shape[0] * shape[1]
        dc = torch.zeros_like(levels_fft)
        dc[..., 0, 0] = (means * size).to(levels_fft.dtype)
        levels_fft = (levels_fft - dc) / torch.clamp(stds[..., None, None], min=1e-12)
    return levels_fft, means, stds


def recompose_core(levels, means, stds):
    """sum_k (level_k * sigma_k + mu_k) over the level axis."""
    return torch.sum(levels * stds[..., None, None] + means[..., None, None], dim=-3)


def recompose_spectral_core(levels_fft, means, stds, shape):
    """Spectral recompose and inverse FFT to the spatial (..., m, n) field."""
    size = shape[0] * shape[1]
    out_fft = torch.sum(levels_fft * stds[..., None, None], dim=-3)
    dc = torch.zeros_like(out_fft)
    dc[..., 0, 0] = (torch.sum(means, dim=-1) * size).to(out_fft.dtype)
    return torch.fft.irfft2(out_fft + dc, s=tuple(shape))
