"""Pyramidal Lucas-Kanade tracking of sparse features (counterpart of
``pysteps_tpu/tracking/lucaskanade.py``).

Every patch is sampled by separable interpolation matrices, as in the
JAX module: an extended patch around each point is taken once per level
with two banded (hat-weight) matrices, P = Ry @ img @ Cx^T, and each
Newton step resamples the window inside it with small per-point matrices
built from the point's displacement: batched matrix products, no gather
in the loop.  The Newton iterations are a Python loop of fixed length.
"""

import numpy as np
import torch

from pysteps_tpu_torch._device import as_device_tensor
from pysteps_tpu_torch.feature.shitomasi import _sobel
from pysteps_tpu_torch.ops.conv import sep_corr
from pysteps_tpu_torch.utils.arrays import _nanmin

_BLUR_TAPS = (1.0, 4.0, 6.0, 4.0, 1.0)


def _gauss_blur(img):
    k = torch.tensor(_BLUR_TAPS, dtype=torch.float32, device=img.device) / 16.0
    return sep_corr(img, k, k)


def build_pyramid(image, nr_levels):
    """Gaussian pyramid of (..., m, n) images: level 0 is the image, each
    next level the blurred level before it at every other pixel."""
    pyr = [image]
    for _ in range(nr_levels):
        pyr.append(_gauss_blur(pyr[-1])[..., ::2, ::2])
    return pyr


def _tri(x):
    """The bilinear (hat) interpolation weight."""
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _extract_patches(imgs, px, py, half_ext):
    """(C, N, E, E) patches of the C images ``imgs`` (C, m, n) centred at
    the fractional points (px, py), E = 2 half_ext + 1, by banded
    interpolation matrices (renormalized at the edges, which approximates
    edge-clamped sampling)."""
    m, n = imgs.shape[1:]
    dev = imgs.device
    offs = torch.arange(-half_ext, half_ext + 1, dtype=torch.float32, device=dev)
    rows = torch.arange(m, dtype=torch.float32, device=dev)
    cols = torch.arange(n, dtype=torch.float32, device=dev)
    Ry = _tri(rows[None, None, :] - (py[:, None, None] + offs[None, :, None]))
    Cx = _tri(cols[None, None, :] - (px[:, None, None] + offs[None, :, None]))
    Ry = Ry / torch.clamp(Ry.sum(dim=-1, keepdim=True), min=1e-6)
    Cx = Cx / torch.clamp(Cx.sum(dim=-1, keepdim=True), min=1e-6)
    rows_done = torch.einsum("pkm,cmn->cpkn", Ry, imgs)
    return torch.matmul(rows_done, Cx.transpose(1, 2)[None])


def _window_matrices(v, half_win, half_ext):
    """(N, W, E) matrices that select the W-window shifted by each point's
    displacement ``v`` inside its E-extended patch."""
    dev = v.device
    W = 2 * half_win + 1
    E = 2 * half_ext + 1
    i = torch.arange(W, dtype=torch.float32, device=dev)[None, :, None]
    k = torch.arange(E, dtype=torch.float32, device=dev)[None, None, :]
    w = _tri(k - i - float(half_ext - half_win) - v[:, None, None])
    return w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-6)


def _sample(Wy, patch, Wx):
    """Wy @ patch @ Wx^T per point."""
    return torch.matmul(torch.matmul(Wy, patch), Wx.transpose(1, 2))


def _track_level(I, J, Ix, Iy, points, guesses, half_win, n_iter):
    """One pyramid level of LK for every point (N, 2) as (x, y) in this
    level's pixels, from the displacement ``guesses`` (N, 2); returns
    (displacement, solvable, mean |I - J| over the window)."""
    margin = 6
    half_ext = half_win + margin
    px, py = points[:, 0], points[:, 1]
    # the template's window at v = 0 from its extended patches
    patches = _extract_patches(torch.stack([I, Ix, Iy]), px, py, half_ext)
    W0 = _window_matrices(torch.zeros_like(px), half_win, half_ext)
    Ip, Ixp, Iyp = (_sample(W0, patches[c], W0) for c in range(3))
    Gxx = (Ixp * Ixp).sum(dim=(1, 2))
    Gxy = (Ixp * Iyp).sum(dim=(1, 2))
    Gyy = (Iyp * Iyp).sum(dim=(1, 2))
    det = Gxx * Gyy - Gxy * Gxy
    ok = det > 1e-6
    inv_det = 1.0 / torch.clamp(det, min=1e-12)
    # the moving image's extended patches at the guess: Newton covers the
    # level's residual within +- margin
    Jext = _extract_patches(J[None], px + guesses[:, 0], py + guesses[:, 1], half_ext)[0]

    def sample_J(v):
        return _sample(_window_matrices(v[:, 1], half_win, half_ext), Jext,
                       _window_matrices(v[:, 0], half_win, half_ext))

    v = torch.zeros_like(guesses)
    for _ in range(n_iter):
        dI = Ip - sample_J(v)
        bx = (dI * Ixp).sum(dim=(1, 2))
        by = (dI * Iyp).sum(dim=(1, 2))
        vx = v[:, 0] + (Gyy * bx - Gxy * by) * inv_det
        vy = v[:, 1] + (Gxx * by - Gxy * bx) * inv_det
        v_new = torch.clamp(torch.stack([vx, vy], dim=1), -(margin - 1.0), margin - 1.0)
        v = torch.where(ok[:, None], v_new, v)
    # the final residual (OpenCV's `err`), on which the tracks are filtered
    resid = (Ip - sample_J(v)).abs().mean(dim=(1, 2))
    return guesses + v, ok, resid


def _pyr_lk_impl(prvs, next_img, points, nr_levels, half_win, n_iter):
    """Pyramidal LK of the points (N, 2) from ``prvs`` to ``next_img``:
    (displacement (N, 2), solvable at every level, last residual)."""
    pyr_I = build_pyramid(prvs, nr_levels)
    pyr_J = build_pyramid(next_img, nr_levels)
    N = points.shape[0]
    d = torch.zeros((N, 2), dtype=torch.float32, device=points.device)
    ok_all = torch.ones(N, dtype=torch.bool, device=points.device)
    resid = torch.zeros(N, dtype=torch.float32, device=points.device)
    for lvl in range(nr_levels, -1, -1):
        I, J = pyr_I[lvl], pyr_J[lvl]
        Ix, Iy = _sobel(I)
        d, ok, resid = _track_level(I, J, Ix, Iy, points / (2.0**lvl), d, half_win, n_iter)
        ok_all = ok_all & ok
        if lvl > 0:
            d = d * 2.0
    return d, ok_all, resid


def _rescale255(img):
    """Non-finite pixels to the minimum, then the range to [0, 255]."""
    img = torch.where(torch.isfinite(img), img, _nanmin(img))
    lo, hi = img.min(), img.max()
    return (img - lo) / torch.clamp(hi - lo, min=1e-9) * 255.0


def _lk_settings(winsize, criteria):
    half_win = max(int(winsize[0]) // 2, 2)
    n_iter = 20 if criteria is None else int(criteria[1]) if len(criteria) > 1 else 20
    return half_win, n_iter


def _filter_tracks(points, d, ok, resid, shape):
    """Keep the solvable tracks that end inside the domain and, with more
    than 4 of them, whose residual is at most max(5 x their median, 2)
    (the analogue of OpenCV's status)."""
    m, n = shape
    end = points + d
    inside = (end[:, 0] >= 0) & (end[:, 0] <= n - 1) & (end[:, 1] >= 0) & (end[:, 1] <= m - 1)
    ok = ok & inside
    if ok.sum() > 4:
        med = float(np.median(resid[ok]))
        ok = ok & (resid <= max(5.0 * med, 2.0))
    return points[ok], d[ok]


def _track(prvs, nxt, points, nr_levels, half_win, n_iter):
    pts = torch.as_tensor(points, dtype=torch.float32, device=prvs.device)
    d, ok, resid = _pyr_lk_impl(_rescale255(prvs), _rescale255(nxt), pts, int(nr_levels),
                                half_win, n_iter)
    return (points, d.cpu().numpy(), ok.cpu().numpy(), resid.cpu().numpy())


def track_features_batch(prvs_stack, next_stack, points_list, winsize=(50, 50), nr_levels=3,
                         criteria=None, device=None, **kwargs):
    """Track the points of each frame pair of two (T, m, n) stacks;
    ``points_list`` holds a (N_t, 2) array a pair.  Returns a list of
    (xy, uv) numpy pairs."""
    prvs = as_device_tensor(prvs_stack, device, torch.float32)
    nxt = as_device_tensor(next_stack, prvs.device, torch.float32)
    half_win, n_iter = _lk_settings(winsize, criteria)
    out = []
    for t, p in enumerate(points_list):
        p = np.asarray(p, np.float32).reshape(-1, 2)
        if p.shape[0] == 0:
            out.append((np.zeros((0, 2), np.float32), np.zeros((0, 2), np.float32)))
            continue
        out.append(_filter_tracks(*_track(prvs[t], nxt[t], p, nr_levels, half_win, n_iter),
                                  tuple(prvs.shape[1:])))
    return out


def track_features(prvs_image, next_image, points, winsize=(50, 50), nr_levels=3,
                   criteria=None, flags=0, min_eig_thr=1e-4, verbose=False, device=None,
                   **kwargs):
    """Track the sparse ``points`` (N, 2) as (x, y) from ``prvs_image`` to
    ``next_image``; returns (xy, uv) numpy arrays, the start and motion
    of the tracks kept."""
    prvs = as_device_tensor(prvs_image, device, torch.float32)
    nxt = as_device_tensor(next_image, prvs.device, torch.float32)
    points = np.asarray(points, np.float32).reshape(-1, 2)
    if points.shape[0] == 0:
        return np.zeros((0, 2)), np.zeros((0, 2))
    half_win, n_iter = _lk_settings(winsize, criteria)
    xy, uv = _filter_tracks(*_track(prvs, nxt, points, nr_levels, half_win, n_iter),
                            tuple(prvs.shape))
    if verbose:
        print(f"--- {xy.shape[0]} sparse vectors found ---")
    return xy, uv
