"""Proesmans anisotropic-diffusion optical flow (counterpart of
``pysteps_tpu/motion/proesmans.py``; Proesmans et al. 1994).

Jacobi iterations of the coupled forward and backward flows, coarse to
fine over a Gaussian pyramid: the consistency-weighted average is a 3 x 3
correlation, the brightness update an elementwise solve at the warped
image.  Both directions run as one batch.  The warp is the JAX module's
by branch: on the card the shift-decomposition warp
(``ops/warp.py::warp_shifted_multi``, kernel K1) with the bound
min(16, side // 2) a level, on the CPU the exact bilinear gather.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

from pysteps_tpu_torch._device import as_device_tensor
from pysteps_tpu_torch.ops.conv import conv2d, corr_same
from pysteps_tpu_torch.ops.warp import (
    _grid, bilinear_upsample, bilinear_warp, warp_shifted_multi,
)

_INTENSITY_SCALE = 1.0 / 255.0
_SOBEL = ((1.0, 0.0, -1.0), (2.0, 0.0, -2.0), (1.0, 0.0, -1.0))
_LAP = ((1 / 12, 1 / 6, 1 / 12), (1 / 6, 0.0, 1 / 6), (1 / 12, 1 / 6, 1 / 12))


def _sobel_gradients(img):
    """Forward-difference-signed Sobel gradients (gx, gy) of (..., m, n)
    images in units of 255."""
    kx = torch.tensor(_SOBEL, dtype=torch.float32, device=img.device) / 8.0 * _INTENSITY_SCALE
    return -corr_same(img, kx), -corr_same(img, kx.T.contiguous())


def _conv3(field):
    return corr_same(field, torch.tensor(_LAP, dtype=torch.float32, device=field.device))


def _consistency(V, m, n, max_disp=None):
    """Forward-backward consistency weights gamma (2, m, n) of the flows V
    (2 directions, (u, v), m, n): each direction's flow against the other
    direction's sampled where it points (``max_disp``: the shift warp)."""
    yy, xx = _grid(m, n, V)
    cx = xx + V[:, 0]
    cy = yy + V[:, 1]
    inside = (cx >= 0) & (cx < n) & (cy >= 0) & (cy < m)
    if max_disp is not None:
        back = warp_shifted_multi(V.flip(0), V, int(max_disp), mode="nearest")
    else:
        back = bilinear_warp(V.flip(0), cy[:, None], cx[:, None], mode="nearest")
    c = torch.sqrt((V[:, 0] + back[:, 0]) ** 2 + (V[:, 1] + back[:, 1]) ** 2)
    c_valid = torch.where(inside, c, 0.0)
    K = (0.9 * c_valid.sum(dim=(1, 2))
         / torch.clamp(inside.sum(dim=(1, 2)), min=1))[:, None, None]
    gamma = torch.where(inside, 1.0 / (1.0 + (c / torch.clamp(K, min=1e-8)) ** 2), 1.0)
    return torch.where(K > 1e-8, gamma, 1.0)


def _proesmans_level(R, V0, lam, num_iter, max_disp=None):
    """``num_iter`` Jacobi iterations of the two-way flow at one level: R
    (2, m, n) the image pair, V0 (2, 2, m, n) the forward and backward
    flows (u, v)."""
    m, n = R.shape[1:]
    gx, gy = _sobel_gradients(R)
    yy, xx = _grid(m, n, R)
    interior = (yy >= 1) & (yy <= m - 2) & (xx >= 1) & (xx <= n - 2)
    R2 = R.flip(0)  # direction j warps the other image
    V = V0
    for _ in range(num_iter):
        gamma = _consistency(V, m, n, max_disp)
        sums = _conv3(torch.stack([gamma, gamma * V[:, 0], gamma * V[:, 1]], dim=1))
        wsum = sums[:, 0]
        ok = wsum > 1e-8
        den = torch.clamp(wsum, min=1e-8)
        u_avg = torch.where(ok, sums[:, 1] / den, 0.0)
        v_avg = torch.where(ok, sums[:, 2] / den, 0.0)
        cx = xx + u_avg
        cy = yy + v_avg
        inside = (cx >= 0) & (cx < n - 1) & (cy >= 0) & (cy < m - 1)
        if max_disp is not None:
            warped = warp_shifted_multi(R2[:, None], torch.stack([u_avg, v_avg], dim=1),
                                        int(max_disp), mode="nearest")[:, 0]
        else:
            warped = bilinear_warp(R2, cy, cx, mode="nearest")
        It = (warped - R) * _INTENSITY_SCALE
        ic = lam * It / (1.0 + lam * (gx * gx + gy * gy))
        keep = inside & interior  # the boundary pixels keep their average
        V = torch.stack([torch.where(keep, u_avg - gx * ic, u_avg),
                         torch.where(keep, v_avg - gy * ic, v_avg)], dim=1)
    return V


@functools.lru_cache(maxsize=8)
def _gauss1d_taps(sigma):
    """scipy.ndimage gaussian_filter1d's kernel, truncated at 4 sigma."""
    radius = int(4.0 * sigma + 0.5)
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _gauss_blur(img, sigma):
    """Separable Gaussian blur of (..., m, n) images with scipy's
    mode="mirror" edges (reflection without repeating the edge)."""
    k = torch.as_tensor(_gauss1d_taps(float(sigma)), device=img.device)
    r = (k.shape[0] - 1) // 2
    shape = img.shape
    p = F.pad(img.reshape(-1, 1, *shape[-2:]), (r, r, r, r), mode="reflect")
    p = conv2d(p, k.reshape(1, 1, -1, 1))
    return conv2d(p, k.reshape(1, 1, 1, -1)).reshape(shape)


def _proesmans_full(im1, im2, lam, num_levels, num_iter, filter_std, use_shift, full_output):
    """Prefilter, [0, 255] rescale, Gaussian pyramid and the coarse-to-fine
    two-way diffusion."""
    R = torch.stack([im1, im2])
    if filter_std > 0.0:
        R = _gauss_blur(R, filter_std)
    finite = torch.where(torch.isnan(R), float("inf"), R)
    lo = finite.amin()
    hi = torch.where(torch.isnan(R), float("-inf"), R).amax()
    # a tensor divisor: ``255.0 / t`` is ``t.reciprocal() * 255`` in
    # PyTorch, two roundings where the JAX package divides once
    scale = torch.full_like(lo, 255.0) / torch.clamp(hi - lo, min=1e-9)
    R = torch.nan_to_num((R - lo) * scale)

    pyr = [R]
    for _ in range(num_levels - 1):
        if min(pyr[-1].shape[1:]) < 16:
            break
        pyr.append(_gauss_blur(pyr[-1], 1.0)[:, ::2, ::2])
    V = torch.zeros((2, 2) + tuple(pyr[-1].shape[1:]), dtype=torch.float32, device=R.device)
    for lvl in range(len(pyr) - 1, -1, -1):
        Rl = pyr[lvl]
        md = min(16, min(Rl.shape[1:]) // 2) if use_shift else None
        V = _proesmans_level(Rl, V, float(lam), int(num_iter), md)
        if lvl > 0:
            V = bilinear_upsample(V, tuple(pyr[lvl - 1].shape[1:])) * 2.0
    if full_output:
        return V, _consistency(V, V.shape[2], V.shape[3], 16 if use_shift else None)
    return V[0]


def proesmans(input_images, lam=50.0, num_iter=100, num_levels=6, filter_std=0.0,
              verbose=True, full_output=False, device=None, **kwargs):
    """Proesmans dense flow of a (2, m, n) pair: the (2, m, n) forward
    advection field, or with ``full_output`` the forward and backward
    flows (2, 2, m, n) and their consistency maps (2, m, n).  On the card
    the warp is kernel K1, on the CPU the exact gather."""
    images = as_device_tensor(input_images, device, torch.float32)
    if images.ndim != 3 or images.shape[0] != 2:
        raise ValueError("input_images must have shape (2, m, n)")
    return _proesmans_full(images[-2], images[-1], float(lam), int(num_levels), int(num_iter),
                           float(filter_std), images.is_cuda, bool(full_output))
