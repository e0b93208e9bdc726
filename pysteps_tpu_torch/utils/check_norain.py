"""No-rain gate (counterpart of ``pysteps_tpu/utils/check_norain.py``).
Runs on the host before the forecast: the branch it controls is the
zero-forecast early exit."""

import numpy as np
import torch

from pysteps_tpu_torch.utils import tapering


def check_norain(precip_arr, precip_thr=None, norain_thr=0.0, win_fun=None, printmsg=True):
    """True if the (tapered) rain fraction is <= ``norain_thr``."""
    if isinstance(precip_arr, torch.Tensor):
        precip_arr = precip_arr.detach().cpu().numpy()
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
