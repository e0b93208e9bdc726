"""Sparse-to-grid interpolation (counterpart of
``pysteps_tpu/utils/interpolate.py``): both interpolators build the dense
(grid points x samples) squared-distance matrix and reduce over the
sample axis, ``topk`` for the k-NN inverse-distance weights, a solve and a
matrix product for the radial basis functions."""

import torch

from pysteps_tpu_torch._device import as_device_tensor, device_of


def _sq_distances(xy_coord, xgrid, ygrid):
    """(G, n) squared distances between the grid's points (row-major over
    ``ygrid`` x ``xgrid``) and the n samples."""
    gy, gx = torch.meshgrid(ygrid, xgrid, indexing="ij")
    grid = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=1)
    diff = grid[:, None, :] - xy_coord[None, :, :]
    return (diff * diff).sum(dim=-1)


def _idw_core(xy_coord, values, xgrid, ygrid, power, k, dist_offset):
    d2 = _sq_distances(xy_coord, xgrid, ygrid)
    if k is not None and k < xy_coord.shape[0]:
        neg_d2, idx = torch.topk(-d2, k, dim=1)
        d2k = -neg_d2
        vals = values[idx]  # (G, k, c)
    else:
        d2k = d2
        vals = values[None].expand((d2.shape[0],) + tuple(values.shape))
    w = (torch.sqrt(d2k) + dist_offset) ** (-power)
    w = w / w.sum(dim=1, keepdim=True)
    return torch.einsum("gk,gkc->gc", w, vals)


def _inputs(xy_coord, values, xgrid, ygrid, device):
    dev = device_of(xy_coord, device)
    xy_coord = as_device_tensor(xy_coord, dev, torch.float32)
    values = as_device_tensor(values, dev, torch.float32)
    xgrid = as_device_tensor(xgrid, dev, torch.float32)
    ygrid = as_device_tensor(ygrid, dev, torch.float32)
    squeeze = values.ndim == 1
    return xy_coord, values[:, None] if squeeze else values, xgrid, ygrid, squeeze


def idwinterp2d(xy_coord, values, xgrid, ygrid, power=0.5, k=20, dist_offset=0.5,
                device=None, **kwargs):
    """Inverse-distance-weighted interpolation of the samples ``values``
    ((n,) or (n, c)) at ``xy_coord`` (n, 2) to the grid ``ygrid`` x
    ``xgrid``, over each grid point's ``k`` nearest samples (all with
    ``k=None``); returns (len(ygrid), len(xgrid)) or (c, ...)."""
    xy_coord, values, xgrid, ygrid, squeeze = _inputs(xy_coord, values, xgrid, ygrid, device)
    if k is not None:
        k = min(int(k), xy_coord.shape[0])
    out = _idw_core(xy_coord, values, xgrid, ygrid, float(power), k, float(dist_offset))
    out = out.T.reshape((values.shape[1], len(ygrid), len(xgrid)))
    return out[0] if squeeze else out


def _rbf_core(xy_coord, values, xgrid, ygrid, epsilon):
    """Gaussian RBF of width ``epsilon``: solve for the coefficients at the
    samples (with a 1e-6 ridge), then sum them at the grid points."""
    n = xy_coord.shape[0]
    diff = xy_coord[:, None, :] - xy_coord[None, :, :]
    d2 = (diff * diff).sum(dim=-1)
    A = torch.exp(-d2 / (2.0 * epsilon**2)) + 1e-6 * torch.eye(n, device=d2.device)
    coeffs = torch.linalg.solve(A, values)
    K = torch.exp(-_sq_distances(xy_coord, xgrid, ygrid) / (2.0 * epsilon**2))
    return K @ coeffs


def rbfinterp2d(xy_coord, values, xgrid, ygrid, device=None, **kwargs):
    """Gaussian radial-basis-function interpolation of the samples to the
    grid; ``epsilon`` (keyword) defaults to twice the mean distance to the
    nearest other sample, clipped to [1, 1e4]."""
    xy_coord, values, xgrid, ygrid, squeeze = _inputs(xy_coord, values, xgrid, ygrid, device)
    eps = kwargs.get("epsilon")
    if eps is None:
        diff = xy_coord[:, None, :] - xy_coord[None, :, :]
        d = torch.sqrt((diff * diff).sum(dim=-1))
        d = d.fill_diagonal_(float("inf"))
        eps = float(torch.clamp(d.amin(dim=1).mean() * 2.0, 1.0, 1e4))
    out = _rbf_core(xy_coord, values, xgrid, ygrid, float(eps))
    out = out.T.reshape((values.shape[1], len(ygrid), len(xgrid)))
    return out[0] if squeeze else out
