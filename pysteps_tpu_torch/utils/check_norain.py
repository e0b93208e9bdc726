"""No-rain gate (counterpart of ``pysteps_tpu/utils/check_norain.py``).
Runs before the forecast: the branch it controls is the zero-forecast
early exit.  A numpy input is gated on the host; a tensor on its own
device, with the same answer."""

import numpy as np
import torch

from pysteps_tpu_torch.utils import tapering


def nanmin(x):
    """numpy's ``nanmin`` of the tensor ``x``, a 0-d tensor on its device:
    NaN only where every value is NaN."""
    nan = torch.isnan(x)
    return torch.where(nan.all(), float("nan"), torch.where(nan, float("inf"), x).amin())


def _below(thr):
    """The largest float32 at most ``thr``: a float32 value lies above it
    exactly where it lies above ``thr`` in float64."""
    with np.errstate(over="ignore"):
        f = np.float32(thr)
    if float(f) > thr:  # in float64: numpy compares a float32 with a float in float32
        f = np.nextafter(f, np.float32(-np.inf))
    return float(f)


def rain_count(precip_arr, precip_thr=None, win_fun=None):
    """The number of values of the tensor ``precip_arr`` above
    ``precip_thr`` (its smallest value if None), after the pixels that the
    ``win_fun`` taper zeroes are set to its smallest value; NaN never
    counts.  A 0-d int64 tensor on the tensor's device, computed without a
    host sync.  The comparison is :func:`check_norain`'s in float64: float32
    values are compared with the largest float32 at most the threshold,
    other dtypes in float64."""
    x = precip_arr.detach()
    if x.dtype not in (torch.float32, torch.float64):
        x = x.double()
    if win_fun is not None:
        taper = tapering.compute_window_function(x.shape[-2], x.shape[-1], win_fun)
        zero = torch.as_tensor(taper == 0.0, device=x.device)
        x = torch.where(zero, nanmin(x), x)
    if precip_thr is None:
        thr = nanmin(x)
    elif x.dtype == torch.float64:
        thr = float(precip_thr)
    else:
        thr = _below(float(precip_thr))
    return torch.count_nonzero(x > thr)


def check_norain(precip_arr, precip_thr=None, norain_thr=0.0, win_fun=None, printmsg=True):
    """True if the (tapered) rain fraction is <= ``norain_thr``.  A tensor
    is counted on its own device (:func:`rain_count`) and only the count
    comes to the host."""
    if isinstance(precip_arr, torch.Tensor):
        rain_frac = int(rain_count(precip_arr, precip_thr, win_fun)) / precip_arr.numel()
    else:
        precip_arr = np.asarray(precip_arr)
        if win_fun is not None:
            taper = tapering.compute_window_function(
                precip_arr.shape[-2], precip_arr.shape[-1], win_fun
            )
        else:
            taper = np.ones(precip_arr.shape[-2:])
        masked = np.array(precip_arr, dtype=float)
        masked[..., taper == 0.0] = np.nanmin(precip_arr)
        if precip_thr is None:
            precip_thr = np.nanmin(masked)
        rain_frac = np.sum(masked > precip_thr) / masked.size
    norain = rain_frac <= norain_thr
    if printmsg:
        print(f"Rain fraction is: {rain_frac}, while minimum fraction is {norain_thr}")
    return bool(norain)


def check_previous_radar_obs(precip, ar_order, check_norain_kwargs=None):
    """Trim the leading dry frames of the inputs before the AR fit and
    lower ``ar_order`` to what is left; rain in the latest frame but none
    in the one before is taken as clutter (a dry AR(2) input).  Returns
    (numpy inputs, ar_order)."""
    if isinstance(precip, torch.Tensor):
        precip = precip.detach().cpu().numpy()
    precip = np.asarray(precip)
    if precip.shape[0] < 2:
        raise ValueError("The radar input must have at least 2 time steps.")
    kw = check_norain_kwargs or {}
    norain_flags = [
        check_norain(
            obs, kw.get("precip_thr"), kw.get("norain_thr", 0.0), kw.get("win_fun"), False
        )
        for obs in precip
    ]
    if norain_flags[-1] or not np.any(norain_flags):
        return precip, ar_order
    if norain_flags[-2]:
        precip = np.ones((3,) + precip.shape[1:]) * np.nanmin(precip)
        print(
            "[WARNING] Precip + no-precip in the 2 latest radar inputs; "
            "set to zero-precip radar input."
        )
        return precip, 2
    last_norain = int(np.max(np.nonzero(norain_flags)[0]))
    precip = precip[last_norain + 1 :]
    if precip.shape[0] - 1 < ar_order:
        print(
            f"[WARNING] Radar input only has {precip.shape[0]} usable steps; "
            f"ar_order reduced to {precip.shape[0] - 1}."
        )
    return precip, min(ar_order, precip.shape[0] - 1)
