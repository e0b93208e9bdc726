"""
Sparse-vector cleansing: declustering and outlier detection (counterpart
of ``pysteps_tpu/utils/cleansing.py``, which runs on the host with numpy
as this copy does).

They work on the small point sets that feature tracking gives, whose size
depends on the data; the dense grid work stays on the device.  The
localized outlier detector takes the k nearest neighbours from a sorted
dense distance matrix.
"""

import numpy as np
import torch


def _host(x):
    """``x`` as a float64 numpy array (a tensor is fetched from its
    device)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=float)


def decluster(coord, input_array, scale, min_samples=1, verbose=False):
    """Median of the points and values that fall in one ``scale``-sized
    cell, for cells with at least ``min_samples`` points."""
    coord = _host(coord)
    input_array = _host(input_array)
    if np.any(~np.isfinite(input_array)):
        raise ValueError("input_array contains non-finite values")
    squeeze = input_array.ndim == 1
    if squeeze:
        input_array = input_array[:, None]
    scale = np.atleast_1d(np.asarray(scale, dtype=float))

    cell = np.floor(coord / scale)
    ucell, inverse, counts = np.unique(
        cell, axis=0, return_inverse=True, return_counts=True
    )
    out_coord, out_vals = [], []
    for i in range(ucell.shape[0]):
        if counts[i] >= min_samples:
            idx = inverse == i
            out_coord.append(np.median(coord[idx], axis=0))
            out_vals.append(np.median(input_array[idx], axis=0))
    out_coord = np.array(out_coord).reshape(-1, coord.shape[1])
    out_vals = np.array(out_vals).reshape(-1, input_array.shape[1])
    if verbose:
        print(f"--- {out_vals.shape[0]} samples left after declustering ---")
    return out_coord, out_vals[:, 0] if squeeze else out_vals


def detect_outliers(input_array, thr, coord=None, k=None, verbose=False):
    """Z-score (one variable) or Mahalanobis (several) outlier detection
    above ``thr``, against all samples or, with ``coord`` and ``k``,
    against each sample's k nearest neighbours."""
    input_array = _host(input_array)
    if np.any(~np.isfinite(input_array)):
        raise ValueError("input_array contains non-finite values")
    if input_array.ndim == 1:
        data = input_array[:, None]
    else:
        data = input_array
    nsamples, nvar = data.shape
    if nsamples < 2:
        return np.zeros(nsamples, dtype=bool)

    if coord is None or k is None:
        if nvar == 1:
            z = np.abs(data[:, 0] - data[:, 0].mean()) / max(data[:, 0].std(), 1e-12)
            outliers = z > thr
        else:
            zdata = data - data.mean(axis=0)
            V = np.cov(zdata.T)
            try:
                VI = np.linalg.inv(V)
                MD = np.sqrt(np.einsum("ni,ij,nj->n", zdata, VI, zdata))
            except np.linalg.LinAlgError:
                MD = np.zeros(nsamples)
            outliers = MD > thr
    else:
        coord = _host(coord)
        if coord.ndim == 1:
            coord = coord[:, None]
        k = int(min(nsamples, k + 1))
        # dense pairwise distances; fine for the O(10^2-10^3) tracked points
        d2 = np.sum((coord[:, None, :] - coord[None, :, :]) ** 2, axis=-1)
        nn = np.argsort(d2, axis=1)[:, :k]  # includes self
        outliers = np.zeros(nsamples, dtype=bool)
        for i in range(nsamples):
            neigh = data[nn[i]]
            if nvar == 1:
                std = max(neigh[:, 0].std(), 1e-12)
                outliers[i] = abs(data[i, 0] - neigh[:, 0].mean()) / std > thr
            else:
                zd = neigh - neigh.mean(axis=0)
                V = np.cov(zd.T)
                try:
                    VI = np.linalg.inv(V)
                    z = data[i] - neigh.mean(axis=0)
                    outliers[i] = np.sqrt(z @ VI @ z) > thr
                except np.linalg.LinAlgError:
                    outliers[i] = False

    if verbose:
        print(f"--- {int(outliers.sum())} outliers detected ---")
    return outliers
