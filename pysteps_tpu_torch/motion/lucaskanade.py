"""Dense Lucas-Kanade optical flow (counterpart of
``pysteps_tpu/motion/lucaskanade.py``).

Morphological declutter -> Shi-Tomasi corners (``feature/shitomasi.py``)
-> pyramidal LK tracking (``tracking/lucaskanade.py``) -> outlier removal
-> declustering -> inverse-distance interpolation to a dense (2, m, n)
field.  The standard configuration (Shi-Tomasi, IDW, declustering) runs
as one device pipeline with fixed-size point sets and validity masks
(:func:`_dense_lk_fused`); any other runs the stages one after the other
with the point sets on the host, as the JAX module does.
"""

import time

import numpy as np
import torch

from pysteps_tpu_torch._device import as_device_tensor, device_of
from pysteps_tpu_torch.feature import shitomasi
from pysteps_tpu_torch.feature.shitomasi import _shitomasi_core
from pysteps_tpu_torch.tracking.lucaskanade import (  # noqa: F401 (track_features: API)
    _lk_settings,
    _pyr_lk_impl,
    _rescale255,
    track_features,
    track_features_batch,
)
from pysteps_tpu_torch.utils import cleansing, images, interpolate
from pysteps_tpu_torch.utils.arrays import _nanmin
from pysteps_tpu_torch.utils.images import _morph_opening_core

_INF = float("inf")


def _masked_median(x, ok):
    """The lower median of ``x`` over ``ok`` (the others sort to +inf)."""
    xs = torch.sort(torch.where(ok, x, _INF)).values
    return xs[torch.clamp(ok.sum() - 1, min=0) // 2]


def _knn_radius(d2, k):
    """Each row's squared distance to about its k-th nearest neighbour, by
    25 steps of bisection on the neighbour counts (no sort)."""
    finite_max = torch.where(torch.isinf(d2) | torch.isnan(d2), 0.0, d2).amax()
    lo = torch.zeros(d2.shape[0], dtype=d2.dtype, device=d2.device)
    hi = torch.full_like(lo, 1.0) * (finite_max + 1.0)
    for _ in range(25):
        mid = 0.5 * (lo + hi)
        enough = (d2 <= mid[:, None]).sum(dim=1) >= k
        lo, hi = torch.where(enough, lo, mid), torch.where(enough, mid, hi)
    return hi


def _dense_lk_fused(stack, max_corners, quality_level, min_distance, block_size,
                    buffer_mask, size_opening, nr_levels, half_win, n_iter,
                    nr_std_outlier, k_outlier, decl_scale, cells_y, cells_x,
                    power, idw_k, dist_offset):
    """The dense-LK pipeline on (T, m, n) ``stack`` with every point set at
    ``max_corners`` and a validity mask: declutter, Shi-Tomasi, pyramidal
    LK, residual filter, localized outlier rejection (Mahalanobis distance
    to the k nearest neighbours), declustering to cell means and k-NN
    inverse-distance interpolation.  Returns ((2, m, n) flow, the number
    of vectors used)."""
    T1 = stack.shape[0] - 1
    m, n = stack.shape[1:]
    K = max_corners
    dev = stack.device

    minvals = _nanmin(stack.reshape(stack.shape[0], -1), dim=1)
    filled = torch.where(torch.isfinite(stack), stack, minvals[:, None, None])
    if size_opening > 0:
        cleaned = torch.stack([_morph_opening_core(f, t, size_opening)
                               for f, t in zip(filled, minvals)])
    else:
        cleaned = filled
    masked = torch.where(torch.isfinite(stack[:-1]), stack[:-1], float("nan"))
    corners = [_shitomasi_core(img, K, quality_level, min_distance, block_size, buffer_mask)
               for img in masked]
    pts = torch.stack([c[0] for c in corners])  # (T1, K, 2)
    valid = torch.stack([c[1] for c in corners])
    tracks = [_pyr_lk_impl(_rescale255(cleaned[t]), _rescale255(cleaned[t + 1]), pts[t],
                           nr_levels, half_win, n_iter) for t in range(T1)]
    d = torch.stack([t[0] for t in tracks])
    ok = torch.stack([t[1] for t in tracks])
    resid = torch.stack([t[2] for t in tracks])

    end = pts + d
    inside = ((end[..., 0] >= 0) & (end[..., 0] <= n - 1)
              & (end[..., 1] >= 0) & (end[..., 1] <= m - 1))
    ok = valid & ok & inside
    # residual-based rejection against each pair's median
    med = torch.stack([_masked_median(r, o) for r, o in zip(resid, ok)])
    keep = resid <= torch.clamp(5.0 * med, min=2.0)[:, None]
    ok = ok & torch.where((ok.sum(dim=1) > 4)[:, None], keep, True)

    # localized outlier rejection: Mahalanobis distance to the k nearest
    # neighbours' mean and covariance
    P = T1 * K
    xy = pts.reshape(P, 2)
    uv = d.reshape(P, 2)
    val = ok.reshape(P)
    if nr_std_outlier is not None:
        diff = xy[:, None, :] - xy[None, :, :]
        d2 = (diff * diff).sum(dim=-1)
        d2 = torch.where(val[None, :] & val[:, None], d2, _INF)
        r = _knn_radius(d2, k_outlier + 1)  # +1: includes self
        W = ((d2 <= r[:, None]) & val[None, :]).to(torch.float32)
        cnt = torch.clamp(W.sum(dim=1), min=1.0)
        mu = (W @ uv) / cnt[:, None]
        du = uv[None, :, 0] - mu[:, 0:1]
        dv = uv[None, :, 1] - mu[:, 1:2]
        Suu = (W * du * du).sum(dim=1) / cnt
        Suv = (W * du * dv).sum(dim=1) / cnt
        Svv = (W * dv * dv).sum(dim=1) / cnt
        det = torch.clamp(Suu * Svv - Suv * Suv, min=1e-12)
        zu = uv[:, 0] - mu[:, 0]
        zv = uv[:, 1] - mu[:, 1]
        md2 = (Svv * zu * zu - 2 * Suv * zu * zv + Suu * zv * zv) / det
        val = val & (md2 <= nr_std_outlier**2)

    # decluster to the means of decl_scale cells
    C = cells_y * cells_x
    cell = (torch.clamp((xy[:, 1] / decl_scale).to(torch.int32), 0, cells_y - 1) * cells_x
            + torch.clamp((xy[:, 0] / decl_scale).to(torch.int32), 0, cells_x - 1))
    onehot = ((cell[:, None] == torch.arange(C, device=dev)[None, :])
              & val[:, None]).to(torch.float32)
    ccnt = onehot.sum(dim=0)
    cdiv = torch.clamp(ccnt, min=1.0)[:, None]
    cxy = (onehot.T @ xy) / cdiv
    cuv = (onehot.T @ uv) / cdiv
    cvalid = ccnt >= 1.0

    # k-NN inverse-distance weights within each grid point's k-th radius,
    # over blocks of grid points so that a (points, cells) block stays
    # below 67 M entries
    gy, gx = torch.meshgrid(torch.arange(m, dtype=torch.float32, device=dev),
                            torch.arange(n, dtype=torch.float32, device=dev), indexing="ij")
    grid = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=1)
    G = m * n
    n_valid = cvalid.sum()
    k_eff = torch.clamp(torch.clamp(n_valid, min=1), max=idw_k)

    def idw_block(grid_b):
        gd = grid_b[:, None, :] - cxy[None, :, :]
        gd2 = torch.where(cvalid[None, :], (gd * gd).sum(dim=-1), _INF)
        rg = _knn_radius(gd2, k_eff)
        w = torch.where((gd2 <= rg[:, None]) & cvalid[None, :],
                        (torch.sqrt(gd2) + dist_offset) ** (-power), 0.0)
        wsum = torch.clamp(w.sum(dim=1), min=1e-12)
        return (w @ cuv) / wsum[:, None]

    n_blocks = max(1, -(-(G * C) // 67_000_000))
    gb = -(-G // n_blocks)
    dense_uv = torch.cat([idw_block(grid[s:s + gb]) for s in range(0, G, gb)])
    dense_uv = torch.where(n_valid > 0, dense_uv, 0.0)
    return dense_uv.T.reshape(2, m, n), val.sum()


def dense_lucaskanade(input_images, lk_kwargs=None, fd_method="shitomasi", fd_kwargs=None,
                      interp_method="idwinterp2d", interp_kwargs=None, dense=True,
                      nr_std_outlier=3, k_outlier=30, size_opening=3, decl_scale=20,
                      verbose=False, device=None, **kwargs):
    """Dense LK flow of a (T >= 2, m, n) sequence: a (2, m, n) tensor on
    the run's device, or, with ``dense=False``, the sparse (xy, uv) numpy
    arrays."""
    stack = as_device_tensor(input_images, device_of(input_images, device), torch.float32)
    if stack.ndim != 3 or stack.shape[0] < 2:
        raise ValueError("input_images must be (T>=2, m, n)")
    lk_kwargs = lk_kwargs or {}
    fd_kwargs = fd_kwargs or {}
    interp_kwargs = dict(interp_kwargs or {})
    if verbose:
        print("Computing the motion field with the Lucas-Kanade method.")
        t0 = time.time()
    domain_size = tuple(stack.shape[1:])
    dev = stack.device

    if (dense and fd_method == "shitomasi" and interp_method == "idwinterp2d"
            and decl_scale is not None and decl_scale > 1):
        m, n = domain_size
        fd = dict(fd_kwargs)
        half_win, n_iter = _lk_settings(lk_kwargs.get("winsize", (50, 50)),
                                        lk_kwargs.get("criteria"))
        field, n_vec = _dense_lk_fused(
            stack,
            max_corners=int(fd.get("max_corners", fd.get("max_num_features", 1000))),
            quality_level=float(fd.get("quality_level", 0.01)),
            min_distance=int(fd.get("min_distance", 10)),
            block_size=int(fd.get("block_size", 5)),
            buffer_mask=int(fd.get("buffer_mask", 5)) if fd.get("use_cmask", True) else 0,
            size_opening=int(size_opening or 0),
            nr_levels=int(lk_kwargs.get("nr_levels", 3)),
            half_win=half_win,
            n_iter=n_iter,
            nr_std_outlier=float(nr_std_outlier) if nr_std_outlier is not None else None,
            k_outlier=int(k_outlier),
            decl_scale=float(decl_scale),
            cells_y=-(-m // int(decl_scale)),
            cells_x=-(-n // int(decl_scale)),
            power=float(interp_kwargs.get("power", 0.5)),
            idw_k=int(interp_kwargs.get("k", 20) or 0) or 10**9,
            dist_offset=float(interp_kwargs.get("dist_offset", 0.5)),
        )
        if verbose:
            print(f"--- {int(n_vec)} sparse vectors used ---")
            print(f"--- total time: {time.time() - t0:.2f} seconds ---")
        return field

    # the stages one after the other, the point sets on the host
    frames = stack.cpu().numpy()
    minvals = [float(np.nanmin(f)) if np.any(np.isfinite(f)) else 0.0 for f in frames]
    filled = np.stack([np.where(np.isfinite(f), f, mv) for f, mv in zip(frames, minvals)])
    if size_opening is not None and size_opening > 0:
        cleaned = images.morph_opening_batch(filled, minvals, size_opening, device=dev)
    else:
        cleaned = torch.as_tensor(filled, device=dev)
    masked = np.where(np.isfinite(frames[:-1]), frames[:-1], np.nan)
    points_list = shitomasi.detection_batch(masked, device=dev, **fd_kwargs)

    xy_all, uv_all = [], []
    if any(p.shape[0] for p in points_list):
        for xy, uv in track_features_batch(cleaned[:-1], cleaned[1:], points_list,
                                           **lk_kwargs):
            if xy.shape[0] > 0:
                xy_all.append(xy)
                uv_all.append(uv)
    if not xy_all:
        if dense:
            return torch.zeros((2,) + domain_size, dtype=torch.float32, device=dev)
        return np.zeros((0, 2)), np.zeros((0, 2))
    xy = np.concatenate(xy_all)
    uv = np.concatenate(uv_all)

    if nr_std_outlier is not None and xy.shape[0] > 2:
        outliers = cleansing.detect_outliers(uv, nr_std_outlier, coord=xy, k=k_outlier,
                                             verbose=verbose)
        xy, uv = xy[~outliers], uv[~outliers]
    if not dense:
        return xy, uv
    if decl_scale is not None and decl_scale > 1 and xy.shape[0] > 1:
        xy, uv = cleansing.decluster(xy, uv, decl_scale, 1, verbose)
    if xy.shape[0] == 0:
        return torch.zeros((2,) + domain_size, dtype=torch.float32, device=dev)

    xgrid = np.arange(domain_size[1], dtype=np.float32)
    ygrid = np.arange(domain_size[0], dtype=np.float32)
    interp = (interpolate.rbfinterp2d if interp_method == "rbfinterp2d"
              else interpolate.idwinterp2d)
    uvgrid = interp(xy, uv, xgrid, ygrid, device=dev, **interp_kwargs)
    if verbose:
        print(f"--- total time: {time.time() - t0:.2f} seconds ---")
    return uvgrid.to(torch.float32)
