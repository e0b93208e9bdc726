"""Ensemble statistics (counterpart of
``pysteps_tpu/postprocessing/ensemblestats.py``): reductions over the
member axis 0."""

import numpy as np
import torch

from pysteps_tpu_torch._device import as_device_tensor


def mean(X, ignore_nan=False, X_thr=None, device=None):
    """Ensemble mean over axis 0 (a 2-D field is returned as it is); with
    ``X_thr``, the mean of the members at or above it (0 where none is)."""
    X = as_device_tensor(X, device, torch.float32)
    if X.ndim == 2:
        return X
    if X_thr is not None:
        mask = X >= X_thr
        if ignore_nan:
            mask = mask & torch.isfinite(X)
        cnt = mask.to(X.dtype).sum(dim=0)
        out = torch.where(mask, X, 0.0).sum(dim=0) / torch.clamp(cnt, min=1.0)
        return torch.where(cnt > 0, out, 0.0)
    if ignore_nan:
        return torch.nanmean(X, dim=0)
    return X.mean(dim=0)


def excprob(X, X_thr, ignore_nan=False, device=None):
    """Exceedance probability P(X >= thr) over the members of X
    (n_members, m, n); ``X_thr`` a scalar (one field) or a sequence (one
    field per threshold)."""
    X = as_device_tensor(X, device, torch.float32)
    scalar = np.isscalar(X_thr)
    thrs = torch.atleast_1d(torch.as_tensor(X_thr, dtype=X.dtype, device=X.device))
    exceed = X[None, ...] >= thrs[:, None, None, None]
    if ignore_nan:
        valid = torch.isfinite(X)[None]
        cnt = valid.sum(dim=1)
        P = (exceed & valid).sum(dim=1) / torch.clamp(cnt, min=1)
    else:
        P = exceed.to(X.dtype).mean(dim=1)
    return P[0] if scalar else P


def banddepth(X, thr=None, norm=False, device=None):
    """Band depth of each member (Lopez-Pintado & Romo 2009): the share of
    member pairs whose envelope holds it, averaged over the pixels (with
    ``thr``, over the pixels where some member reaches it); ``norm``
    rescales the depths to [0, 1]."""
    X = as_device_tensor(X, device, torch.float32)
    n = X.shape[0]
    flat = X.reshape(n, -1)
    if thr is not None:
        cols = (flat >= thr).any(dim=0)
        flat = torch.where(cols[None, :], flat, float("nan"))
    # each member's rank per pixel (NaN sorts last)
    order = torch.argsort(flat, dim=0, stable=True)
    ranks = torch.empty_like(order).scatter_(
        0, order, torch.arange(n, device=X.device)[:, None].expand_as(order))
    r = ranks.to(torch.float32) + 1.0
    # (r - 1)(n - r) of the n(n - 1)/2 pairs hold a member of rank r
    valid = torch.isfinite(flat)
    pair_frac = ((r - 1.0) * (n - r)) / (n * (n - 1) / 2.0)
    depth = torch.where(valid, pair_frac, 0.0).sum(dim=1) / torch.clamp(
        valid.sum(dim=1), min=1)
    if norm:
        depth = (depth - depth.min()) / torch.clamp(depth.max() - depth.min(), min=1e-30)
    return depth
