"""Spectral statistics of rfft2 half-planes (counterpart of the
``mean``/``std`` of ``pysteps_tpu/utils/spectral.py``)."""

import torch


def mean(X, shape):
    """Spatial mean from the DC bin; leading batch axes allowed."""
    return X[..., 0, 0].real / float(shape[0] * shape[1])


def std(X, shape):
    """Spatial standard deviation via Parseval from rfft2 half-planes;
    leading batch axes allowed."""
    p = X.real**2 + X.imag**2
    res = torch.sum(p, dim=(-2, -1)) - X[..., 0, 0].real ** 2
    # the half-plane holds the conjugate-mirrored columns once: count twice
    inner = p[..., :, 1:] if shape[1] % 2 == 1 else p[..., :, 1:-1]
    res = res + torch.sum(inner, dim=(-2, -1))
    return torch.sqrt(res / float(shape[0] * shape[1]) ** 2)
