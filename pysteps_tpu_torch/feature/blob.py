"""Blob detection (counterpart of ``pysteps_tpu/feature/blob.py``): the
scale-normalized Laplacian of Gaussian over ``num_sigma`` scales, a
3 x 3 x 3 non-maximum suppression over (sigma, y, x) and the
``max_num_features`` strongest peaks, on the input's device."""

import numpy as np
import torch
import torch.nn.functional as F

from pysteps_tpu_torch._device import as_device_tensor
from pysteps_tpu_torch.ops.conv import sep_corr


def _gaussian_kernel1d(sigma, device):
    half = int(max(round(4.0 * sigma), 1))
    x = torch.arange(-half, half + 1, dtype=torch.float32, device=device)
    k = torch.exp(-(x**2) / (2.0 * sigma**2))
    return k / torch.sum(k)


def _gauss_filter(field, sigma):
    """Separable zero-padded "same" Gaussian blur, rows then columns."""
    k = _gaussian_kernel1d(sigma, field.device)
    return sep_corr(field, k, k)


def _log_cube(field, sigmas):
    """(S, m, n) responses -sigma^2 * Laplacian(Gaussian(field)), the
    Laplacian wrapping around the edges as the JAX module's does."""
    responses = []
    for s in sigmas:
        g = _gauss_filter(field, float(s))
        lap = (
            -4.0 * g
            + torch.roll(g, 1, 0) + torch.roll(g, -1, 0)
            + torch.roll(g, 1, 1) + torch.roll(g, -1, 1)
        )
        responses.append(-(float(s) ** 2) * lap)  # bright blobs -> positive
    return torch.stack(responses)


def detection(input_image, max_num_features=None, method="log", threshold=0.5,
              min_sigma=3, max_sigma=20, num_sigma=10, overlap=0.5,
              return_sigmas=False, device=None, **kwargs):
    """LoG blob detection: an (N, 3) numpy array of (x, y, sigma) rows,
    N <= ``max_num_features`` (25 when None), strongest first; equal
    scores in the order of their flat (sigma, y, x) index, as
    ``jax.lax.top_k`` takes them."""
    field = as_device_tensor(input_image, device, torch.float32)
    field = torch.where(torch.isfinite(field), field, 0.0)

    sigmas = np.linspace(min_sigma, max_sigma, num_sigma)
    cube = _log_cube(field, sigmas)
    # 3-D non-maximum suppression: max pooling pads with -inf
    pooled = F.max_pool3d(cube[None, None], 3, stride=1, padding=1)[0, 0]
    peaks = (cube >= pooled) & (cube > threshold)
    scores = torch.where(peaks, cube, float("-inf")).reshape(-1)

    k = int(max_num_features or 25)
    top_scores, top_idx = torch.sort(scores, descending=True, stable=True)
    top_scores, top_idx = top_scores[:k].cpu().numpy(), top_idx[:k].cpu().numpy()
    si, yi, xi = np.unravel_index(top_idx, tuple(cube.shape))
    valid = np.isfinite(top_scores)
    return np.stack([xi[valid], yi[valid], sigmas[si[valid]]], axis=1).astype(float)
