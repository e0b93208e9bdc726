"""Shi-Tomasi corner detection (counterpart of
``pysteps_tpu/feature/shitomasi.py``): Sobel gradients, the structure
tensor over a box window, its smaller eigenvalue, the quality threshold,
non-maximum suppression over ``min_distance`` (max-pooling) and the
``max_corners`` best scores, as a fixed-size output with a validity
mask."""

import numpy as np
import torch

from pysteps_tpu_torch._device import as_device_tensor
from pysteps_tpu_torch.ops.conv import corr_same, pool_same
from pysteps_tpu_torch.utils.arrays import _nanmin

_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))


def _sobel(img):
    """(gx, gy): the Sobel correlations of ``img``, divided by 8."""
    kx = torch.tensor(_SOBEL_X, dtype=torch.float32, device=img.device) / 8.0
    return corr_same(img, kx), corr_same(img, kx.T.contiguous())


def _box_filter(field, size):
    k = torch.full((size, size), 1.0 / (size * size), device=field.device)
    return corr_same(field, k)


def _shitomasi_core(image, max_corners, quality_level, min_distance, block_size,
                    buffer_mask=0):
    """Corners of one (m, n) image: ((max_corners, 2) float32 (x, y)
    points, (max_corners,) validity).  Equal scores at the cut may be
    taken in another order than ``jax.lax.top_k`` takes them."""
    finite = torch.isfinite(image)
    image = torch.where(finite, image, _nanmin(image))
    mask = finite
    if buffer_mask > 0:
        # shrink the valid mask by buffer_mask pixels (min-pool erosion)
        mask = pool_same(mask.to(torch.float32), 2 * int(buffer_mask) + 1, "min") > 0.5
    gx, gy = _sobel(image.to(torch.float32))
    # the structure tensor over block_size x block_size
    Axx = _box_filter(gx * gx, block_size)
    Axy = _box_filter(gx * gy, block_size)
    Ayy = _box_filter(gy * gy, block_size)
    # its smaller eigenvalue
    tr = (Axx + Ayy) / 2.0
    det_rad = torch.sqrt(torch.clamp(((Axx - Ayy) / 2.0) ** 2 + Axy**2, min=0.0))
    min_eig = torch.where(mask, tr - det_rad, 0.0)

    thr = quality_level * min_eig.max()
    nms = pool_same(min_eig, 2 * int(min_distance) + 1, "max")
    is_peak = (min_eig >= nms) & (min_eig > thr)
    scores = torch.where(is_peak, min_eig, float("-inf"))
    top_scores, top_idx = torch.topk(scores.reshape(-1), max_corners)
    n = image.shape[1]
    valid = torch.isfinite(top_scores) & (top_scores > 0)
    points = torch.stack([top_idx % n, top_idx // n], dim=1).to(torch.float32)
    return points, valid


def detection(input_image, max_corners=1000, max_num_features=None, quality_level=0.01,
              min_distance=10, block_size=5, buffer_mask=5, use_cmask=True,
              return_mask_and_scores=False, device=None, **kwargs):
    """Shi-Tomasi corners of ``input_image``: an (N, 2) numpy array of the
    valid (x, y) corners, fetched from the device (with
    ``return_mask_and_scores``, also the finite mask and None)."""
    if max_num_features is not None:
        max_corners = max_num_features
    image = as_device_tensor(input_image, device, torch.float32)
    buf = int(buffer_mask) if (use_cmask and buffer_mask > 0) else 0
    points, valid = _shitomasi_core(image, int(max_corners), float(quality_level),
                                    int(min_distance), int(block_size), buf)
    points = points[valid].cpu().numpy()
    if return_mask_and_scores:
        return points, torch.isfinite(image).cpu().numpy(), None
    return points


def detection_batch(input_images, max_corners=1000, max_num_features=None,
                    quality_level=0.01, min_distance=10, block_size=5, buffer_mask=5,
                    use_cmask=True, device=None, **kwargs):
    """Corners of each frame of a (T, m, n) stack: a list of (N_t, 2)
    numpy arrays."""
    if max_num_features is not None:
        max_corners = max_num_features
    buf = int(buffer_mask) if (use_cmask and buffer_mask > 0) else 0
    images = as_device_tensor(input_images, device, torch.float32)
    out = []
    for img in images:
        pts, valid = _shitomasi_core(img, int(max_corners), float(quality_level),
                                     int(min_distance), int(block_size), buf)
        out.append(np.asarray(pts[valid].cpu().numpy()))
    return out
