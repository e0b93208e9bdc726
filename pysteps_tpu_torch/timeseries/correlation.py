"""Temporal autocorrelation (counterpart of
``pysteps_tpu/timeseries/correlation.py``): global or masked correlations
as reductions, the localized ("moving window") form as separable Gaussian
or uniform convolutions, and the spectral form from rfft2 half-planes."""

import math

import torch

from pysteps_tpu_torch.ops.conv import conv2d
from pysteps_tpu_torch.utils import spectral as spectral_utils


def _masked_corrcoef(a, b, mask):
    w = mask.to(a.dtype)
    cnt = torch.clamp(w.sum(), min=1.0)
    ma = (a * w).sum() / cnt
    mb = (b * w).sum() / cnt
    va = ((a - ma) ** 2 * w).sum()
    vb = ((b - mb) ** 2 * w).sum()
    cov = ((a - ma) * (b - mb) * w).sum()
    return cov / torch.sqrt(torch.clamp(va * vb, min=1e-30))


def _gaussian_kernel1d(radius, device=None):
    half = int(max(round(4.0 * radius), 1))
    x = torch.arange(-half, half + 1, dtype=torch.float32, device=device)
    k = torch.exp(-(x**2) / (2.0 * radius**2))
    return k / k.sum()


def _uniform_kernel1d(radius, device=None):
    size = 2 * int(radius) + 1
    return torch.ones(size, dtype=torch.float32, device=device) / size


def _sep_conv2d(field, k1d):
    """Separable zero-padded "same" correlation of (..., m, n) fields with
    the odd-length 1-D kernel ``k1d`` along both grid axes, in IEEE
    float32 on the card (:func:`ops.conv.conv2d`)."""
    shape = field.shape
    half = (k1d.numel() - 1) // 2
    f = field.reshape(-1, 1, shape[-2], shape[-1])
    k = k1d.to(field.dtype)
    f = conv2d(f, k.reshape(1, 1, -1, 1), padding=(half, 0))
    f = conv2d(f, k.reshape(1, 1, 1, -1), padding=(0, half))
    return f.reshape(shape)


def _window_kernel(window_radius, window, device):
    if window == "gaussian":
        return _gaussian_kernel1d(window_radius, device)
    return _uniform_kernel1d(window_radius, device)


def _moving_window_corrcoef(a, b, window_radius, window="gaussian", mask=None):
    """Per-pixel correlation of two fields over a moving window."""
    if mask is None:
        mask = torch.ones_like(a, dtype=torch.bool)
    w = mask.to(a.dtype)
    k = _window_kernel(window_radius, window, a.device)
    aw = a * w
    bw = b * w
    n = torch.clamp(_sep_conv2d(w, k), min=1e-8)
    ma = _sep_conv2d(aw, k) / n
    mb = _sep_conv2d(bw, k) / n
    va = _sep_conv2d(aw * a, k) / n - ma**2
    vb = _sep_conv2d(bw * b, k) / n - mb**2
    cov = _sep_conv2d(aw * b, k) / n - ma * mb
    return cov / torch.sqrt(torch.clamp(va * vb, min=1e-12))


def temporal_autocorrelation(
    x, d=0, domain="spatial", x_shape=None, mask=None, use_full_fft=False,
    window="gaussian", window_radius=math.inf,
):
    """Lag-l autocorrelations gamma_l = corr(x[-1], x[-1-l]) for
    l = 1..len(x)-1 of a (t, m, n) series (differenced once with ``d=1``).

    ``domain="spatial"``: over the boolean ``mask`` if given, or per pixel
    over a moving window of ``window_radius`` ("gaussian" or "uniform")
    where it is finite.  ``domain="spectral"``: ``x`` holds rfft2
    half-planes (full planes with ``use_full_fft``) of fields of shape
    ``x_shape``.  Returns a list of tensors (0-d, or (m, n) per pixel)."""
    if d == 1:
        x = torch.diff(x, dim=0)
    gamma = []
    for k in range(x.shape[0] - 1):
        if domain == "spatial":
            if window_radius == math.inf:
                m = mask if mask is not None else torch.ones(
                    x.shape[1:], dtype=torch.bool, device=x.device
                )
                cc = _masked_corrcoef(x[-1], x[-(k + 2)], m)
            else:
                cc = _moving_window_corrcoef(
                    x[-1], x[-(k + 2)], window_radius, window=window, mask=mask
                )
        else:
            cc = spectral_utils.corrcoef(
                x[-1], x[-(k + 2)], x_shape, use_full_fft=use_full_fft
            )
        gamma.append(cc)
    return gamma


def temporal_autocorrelation_multivariate(
    x, d=0, mask=None, window="gaussian", window_radius=math.inf
):
    """Lag-l cross-correlation matrices Gamma_0..Gamma_{n-1} of a
    q-variate series x (n, q, m, n_cols): Gamma_l[i, j] = corr(x[-1, i],
    x[-1-l, j]).  With a finite ``window_radius`` each Gamma_l is per pixel,
    of shape (m, n_cols, q, q)."""
    if d == 1:
        x = torch.diff(x, dim=0)
    n, q = x.shape[:2]
    if mask is None:
        mask = torch.ones(x.shape[2:], dtype=torch.bool, device=x.device)
    localized = window_radius != math.inf

    def cc(a, b):
        if localized:
            return _moving_window_corrcoef(a, b, window_radius, window=window, mask=mask)
        return _masked_corrcoef(a, b, mask)

    gamma = []
    for lag in range(n):
        G = torch.stack([
            torch.stack([cc(x[-1, i], x[-(lag + 1), j]) for j in range(q)])
            for i in range(q)
        ])
        if localized:  # (q, q, m, n) -> (m, n, q, q)
            G = torch.movedim(G, (0, 1), (-2, -1))
        gamma.append(G)
    return gamma
