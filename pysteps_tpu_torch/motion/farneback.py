"""Farneback polynomial-expansion dense optical flow (counterpart of
``pysteps_tpu/motion/farneback.py``; Farneback 2003).

The quadratic expansion of each image comes from six Gaussian-weighted
moments (separable correlations) and the inverse of their 6 x 6 normal
matrix; each iteration solves a 2 x 2 windowed least-squares system per
pixel.  The warp of the second image's six coefficient planes follows the
JAX module's branch: on the card the shift-decomposition warp
(``ops/warp.py::warp_shifted_multi``, kernel K1, one launch an axis for
all six) with the bound min(16, side // 2) a level, on the CPU the exact
bilinear gather.
"""

import numpy as np
import torch
from scipy.ndimage import gaussian_filter

from pysteps_tpu_torch._device import as_device_tensor
from pysteps_tpu_torch.motion.proesmans import _gauss_blur
from pysteps_tpu_torch.ops.conv import sep_corr
from pysteps_tpu_torch.ops.warp import (
    _grid, bilinear_upsample, bilinear_warp, warp_shifted_multi,
)
from pysteps_tpu_torch.utils.images import morph_opening


def _gauss_kernel(n, sigma, device):
    x = torch.arange(-n, n + 1, dtype=torch.float32, device=device)
    g = torch.exp(-(x**2) / (2 * sigma**2))
    return g / g.sum()


def _poly_exp(img, n=7, sigma=1.5):
    """Quadratic expansion of (m, n) ``img``: per pixel A (2, 2, m, n) =
    [[r4, r6 / 2], [r6 / 2, r5]] and b (2, m, n) = [r2, r3] in Farneback's
    notation, from the moments of the basis {1, x, y, x^2, y^2, xy} under
    the weight g(x) g(y)."""
    dev = img.device
    x = torch.arange(-n, n + 1, dtype=torch.float32, device=dev)
    g = torch.exp(-(x**2) / (2 * sigma**2))
    gx = g * x
    gx2 = g * x * x
    sg, sgx2, sgx4 = g.sum(), gx2.sum(), (g * x**4).sum()
    z = torch.zeros((), device=dev)
    G = torch.stack([torch.stack(row) for row in (
        [sg * sg, z, z, sgx2 * sg, sgx2 * sg, z],
        [z, sgx2 * sg, z, z, z, z],
        [z, z, sgx2 * sg, z, z, z],
        [sgx2 * sg, z, z, sgx4 * sg, sgx2 * sgx2, z],
        [sgx2 * sg, z, z, sgx2 * sgx2, sgx4 * sg, z],
        [z, z, z, z, z, sgx2 * sgx2],
    )])
    Ginv = torch.linalg.inv(G)
    # the moment images <w * basis_k * f>, as (kx, ky) pairs
    M = torch.stack([sep_corr(img, kx, ky) for kx, ky in (
        (g, g), (gx, g), (g, gx), (gx2, g), (g, gx2), (gx, gx))])
    c, bx, by, axx, ayy, axy = torch.einsum("ij,jmn->imn", Ginv, M)
    A = torch.stack([torch.stack([axx, axy / 2]), torch.stack([axy / 2, ayy])])
    return A, torch.stack([bx, by])


def _flow_iteration_impl(img1, img2, flow0, n_iter, poly_n, poly_sigma, winsize,
                         max_disp=None):
    """``n_iter`` flow updates at one level from ``flow0`` (2, m, n)."""
    m, n = img1.shape
    A1, b1 = _poly_exp(img1, poly_n, poly_sigma)
    A2, b2 = _poly_exp(img2, poly_n, poly_sigma)
    yy, xx = _grid(m, n, img1)
    gw = _gauss_kernel(winsize // 2, winsize / 4.0, img1.device)
    chans = torch.cat([A2.reshape(4, m, n), b2], dim=0)
    flow = flow0
    for _ in range(n_iter):
        if max_disp is not None:
            w = warp_shifted_multi(chans, flow, int(max_disp), mode="nearest")
        else:
            w = bilinear_warp(chans, yy + flow[1], xx + flow[0], mode="nearest")
        A2w = w[:4].reshape(2, 2, m, n)
        b2w = w[4:6]
        A = (A1 + A2w) / 2.0
        # the current flow estimate enters as db += A @ flow
        db = -(b2w - b1) / 2.0 + torch.einsum("ijmn,jmn->imn", A, flow)
        # the windowed least squares: A^T A and A^T db, correlated with gw
        G11, G12, G22, h1, h2 = sep_corr(torch.stack([
            A[0, 0] ** 2 + A[1, 0] ** 2,
            A[0, 0] * A[0, 1] + A[1, 0] * A[1, 1],
            A[0, 1] ** 2 + A[1, 1] ** 2,
            A[0, 0] * db[0] + A[1, 0] * db[1],
            A[0, 1] * db[0] + A[1, 1] * db[1],
        ]), gw, gw)
        # G is PSD: its determinant is floored relative to the trace, so that
        # low-texture windows damp toward zero flow
        tr = G11 + G22
        det = torch.maximum(G11 * G22 - G12 * G12, 1e-6 * tr * tr + 1e-30)
        flow = torch.stack([(G22 * h1 - G12 * h2) / det, (G11 * h2 - G12 * h1) / det])
    return flow


def _farneback_full(im1, im2, levels, num_iterations, poly_n, poly_sigma, winsize, use_shift):
    """The [0, 1] range normalization, the pyramid and the coarse-to-fine
    solve."""
    both = torch.stack([im1, im2])
    lo = torch.where(torch.isnan(both), float("inf"), both).amin()
    hi = torch.where(torch.isnan(both), float("-inf"), both).amax()
    scale = 1.0 / torch.clamp(hi - lo, min=1e-9)
    pyr = [(torch.nan_to_num((im1 - lo) * scale), torch.nan_to_num((im2 - lo) * scale))]
    for _ in range(levels - 1):
        a, b = pyr[-1]
        if min(a.shape) < 2 * winsize:
            break
        # the sigma = 1 blur (9 taps, reflected edges) before each decimation
        pyr.append((_gauss_blur(a, 1.0)[::2, ::2], _gauss_blur(b, 1.0)[::2, ::2]))
    flow = torch.zeros((2,) + tuple(pyr[-1][0].shape), dtype=torch.float32, device=im1.device)
    for lvl in range(len(pyr) - 1, -1, -1):
        a, b = pyr[lvl]
        md = min(16, min(a.shape) // 2) if use_shift else None
        flow = _flow_iteration_impl(a, b, flow, num_iterations, poly_n, poly_sigma, winsize, md)
        if lvl > 0:
            flow = bilinear_upsample(flow, tuple(pyr[lvl - 1][0].shape)) * 2.0
    return flow


def farneback(input_images, pyr_scale=0.5, levels=4, winsize=32, iterations=5, poly_n=7,
              poly_sigma=1.5, flags=0, size_opening=0, sigma=0.0, verbose=False, device=None,
              **kwargs):
    """Farneback dense flow (2, m, n) over the last two frames of a
    (T >= 2, m, n) sequence.  ``flags`` is accepted and unused;
    ``size_opening`` declutters the inputs by a morphological opening;
    ``sigma`` > 0 smooths the flow's direction on the host (scipy's
    ``gaussian_filter``), keeping its magnitude."""
    iterations = kwargs.pop("num_iterations", iterations)
    sigma = kwargs.pop("smoothing_sigma", sigma)
    images = as_device_tensor(input_images, device, torch.float32)
    if images.ndim != 3 or images.shape[0] < 2:
        raise ValueError("input_images must be (T>=2, m, n)")
    if verbose:
        print("Computing the motion field with the Farneback method.")
    im1, im2 = images[-2], images[-1]
    if size_opening and size_opening > 0:
        thr = float(torch.where(torch.isnan(images), float("inf"), images).amin())
        im1 = morph_opening(im1, thr, size_opening)
        im2 = morph_opening(im2, thr, size_opening)
    flow = _farneback_full(im1, im2, int(levels), int(iterations), int(poly_n),
                           float(poly_sigma), int(winsize), images.is_cuda)
    if not (sigma and sigma > 0):
        return flow
    host = flow.cpu().numpy()
    mag = np.sqrt(host[0] ** 2 + host[1] ** 2)
    sm = np.stack([gaussian_filter(host[i], sigma, mode="mirror") for i in range(2)])
    sm_mag = np.sqrt(sm[0] ** 2 + sm[1] ** 2)
    return torch.as_tensor(sm / np.maximum(sm_mag, 1e-9) * mag, dtype=torch.float32,
                           device=flow.device)
