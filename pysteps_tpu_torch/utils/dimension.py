"""Temporal and spatial aggregation and domain reshaping (counterpart of
``pysteps_tpu/utils/dimension.py``; reference:
pysteps/utils/dimension.py:25,120,219,342,454).

Block aggregations are one reshape and one reduction on the input's
device; clip and square are index surgery.  numpy input lands on the card
unless the caller passes ``device="cpu"``; float64 numpy becomes float32,
as ``jnp.asarray`` makes it.
"""

import numpy as np
import torch
import torch.nn.functional as F

from pysteps_tpu_torch._device import as_device_tensor


def _tensor(x, device=None):
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    x = np.asarray(x)
    return as_device_tensor(x, device, torch.float32 if x.dtype == np.float64 else None)


def _nan_extreme(x, dim, op):
    """``jnp.nanmin`` / ``jnp.nanmax`` along ``dim``: NaN where every value
    is NaN."""
    fill = float("inf") if op == "min" else float("-inf")
    filled = torch.where(torch.isnan(x), fill, x)
    out = filled.amin(dim=dim) if op == "min" else filled.amax(dim=dim)
    return torch.where(torch.isnan(x).all(dim=dim), float("nan"), out)


_AGG = {
    "mean": lambda x, dim: x.mean(dim=dim),
    "sum": lambda x, dim: x.sum(dim=dim),
    "nanmean": lambda x, dim: x.nanmean(dim=dim),
    "nansum": lambda x, dim: x.nansum(dim=dim),
    "min": lambda x, dim: x.amin(dim=dim),
    "max": lambda x, dim: x.amax(dim=dim),
    "nanmin": lambda x, dim: _nan_extreme(x, dim, "min"),
    "nanmax": lambda x, dim: _nan_extreme(x, dim, "max"),
}


def aggregate_fields(data, window_size, axis=0, method="mean", trim=False, device=None):
    """Block-aggregate along one or several axes
    (reference: dimension.py:219)."""
    if np.ndim(axis) > 0 and np.ndim(window_size) == 0:
        # scalar window over several axes (reference: dimension.py:219
        # broadcasts the window size)
        window_size = [window_size] * len(np.atleast_1d(axis))
    if np.ndim(window_size) > 0:
        if len(window_size) != len(np.atleast_1d(axis)):
            raise ValueError("window_size and axis must have the same length")
        out = _tensor(data, device)
        for ws, ax in zip(window_size, np.atleast_1d(axis)):
            out = aggregate_fields(out, ws, axis=int(ax), method=method, trim=trim)
        return out

    window_size = int(window_size)
    if window_size <= 0:
        raise ValueError("window_size must be positive")
    data = _tensor(data, device)
    n = data.shape[axis]
    if n % window_size:
        if not trim:
            raise ValueError(
                f"window_size {window_size} does not equally split axis of size {n}"
            )
        n = (n // window_size) * window_size
        data = data.narrow(axis, 0, n)
    if method not in _AGG:
        raise ValueError(f"unknown method {method}")
    axis = axis % data.ndim
    new_shape = (
        data.shape[:axis] + (n // window_size, window_size) + data.shape[axis + 1 :]
    )
    return _AGG[method](data.reshape(new_shape), axis + 1)


def aggregate_fields_time(R, metadata, time_window_min, ignore_nan=False, device=None):
    """Aggregate a (t, m, n) or (l, t, m, n) series in time
    (reference: dimension.py:25)."""
    metadata = dict(metadata)
    R = _tensor(R, device)
    if time_window_min is None:
        return R, metadata
    axis = 0 if R.ndim == 3 else 1
    timestamps = metadata["timestamps"]
    delta = (timestamps[1] - timestamps[0]).seconds / 60
    if delta == time_window_min:
        return R, metadata
    if (R.shape[axis] * delta) % time_window_min:
        raise ValueError("time_window_min does not equally split R")
    nframes = int(time_window_min / delta)
    method = "mean" if metadata["unit"] == "mm/h" else "sum"
    if ignore_nan:
        method = "nan" + method
    R = aggregate_fields(R, nframes, axis=axis, method=method)
    metadata["accutime"] = time_window_min
    metadata["timestamps"] = timestamps[nframes - 1 :: nframes]
    return R, metadata


def aggregate_fields_space(R, metadata, space_window, ignore_nan=False, device=None):
    """Upscale fields spatially by block aggregation
    (reference: dimension.py:120).  ``space_window`` is in metadata units
    (e.g. metres) or a (ywin, xwin) tuple."""
    metadata = dict(metadata)
    R = _tensor(R, device)
    if space_window is None:
        return R, metadata
    axes = {2: (0, 1), 3: (1, 2)}.get(R.ndim, (2, 3))
    if np.isscalar(space_window):
        space_window = (space_window, space_window)
    ydelta = metadata["ypixelsize"]
    xdelta = metadata["xpixelsize"]
    nframes = (int(space_window[0] / ydelta), int(space_window[1] / xdelta))
    if (R.shape[axes[0]] % nframes[0]) or (R.shape[axes[1]] % nframes[1]):
        raise ValueError("space_window does not equally split R")
    method = "mean" if metadata["unit"] == "mm/h" else "sum"
    if ignore_nan:
        method = "nan" + method
    R = aggregate_fields(R, nframes[0], axis=axes[0], method=method)
    R = aggregate_fields(R, nframes[1], axis=axes[1], method=method)
    metadata["ypixelsize"] = space_window[0]
    metadata["xpixelsize"] = space_window[1]
    return R, metadata


def clip_domain(R, metadata, extent=None, device=None):
    """Clip fields to a geographical extent (x1, x2, y1, y2)
    (reference: dimension.py:342)."""
    metadata = dict(metadata)
    R = _tensor(R, device)
    if extent is None:
        return R, metadata
    m, n = R.shape[-2:]
    x = metadata["x1"] + metadata["xpixelsize"] * (np.arange(n) + 0.5)
    if metadata.get("yorigin", "upper") == "upper":
        y = metadata["y2"] - metadata["ypixelsize"] * (np.arange(m) + 0.5)
    else:
        y = metadata["y1"] + metadata["ypixelsize"] * (np.arange(m) + 0.5)
    ix = (x >= extent[0]) & (x <= extent[1])
    iy = (y >= extent[2]) & (y <= extent[3])
    rows = torch.as_tensor(np.flatnonzero(iy), device=R.device)
    cols = torch.as_tensor(np.flatnonzero(ix), device=R.device)
    out = R.index_select(-2, rows).index_select(-1, cols)
    metadata["x1"] = float(x[ix].min() - 0.5 * metadata["xpixelsize"])
    metadata["x2"] = float(x[ix].max() + 0.5 * metadata["xpixelsize"])
    metadata["y1"] = float(y[iy].min() - 0.5 * metadata["ypixelsize"])
    metadata["y2"] = float(y[iy].max() + 0.5 * metadata["ypixelsize"])
    return out, metadata


def square_domain(R, metadata, method="pad", inverse=False, device=None):
    """Pad or crop fields to a square domain; invertible through the
    metadata (reference: dimension.py:454)."""
    metadata = dict(metadata)
    R = _tensor(R, device)
    if not inverse:
        m, n = R.shape[-2:]
        if m == n:
            return R, metadata
        metadata["orig_domain"] = (m, n)
        metadata["square_method"] = method
        if method == "pad":
            side = max(m, n)
            pm, pn = side - m, side - n
            fill = float(_nan_extreme(R.reshape(-1), 0, "min"))
            R = F.pad(R, (pn // 2, pn - pn // 2, pm // 2, pm - pm // 2), value=fill)
        elif method == "crop":
            side = min(m, n)
            i0, j0 = (m - side) // 2, (n - side) // 2
            R = R[..., i0 : i0 + side, j0 : j0 + side]
        else:
            raise ValueError(f"unknown method {method}")
        return R, metadata

    method = metadata.pop("square_method")
    m, n = metadata.pop("orig_domain")
    if method == "pad":
        side = R.shape[-1]
        pm, pn = side - m, side - n
        return R[..., pm // 2 : pm // 2 + m, pn // 2 : pn // 2 + n], metadata
    if method == "crop":
        raise ValueError("cannot invert a crop")
    raise ValueError(f"unknown method {method}")
