"""Extrapolation registry (counterpart of
``pysteps_tpu/extrapolation/interface.py``)."""

import numpy as np
import torch

from pysteps_tpu_torch._device import as_device_tensor
from pysteps_tpu_torch.extrapolation import semilagrangian


def eulerian_persistence(precip, velocity, timesteps, outval=np.nan, **kwargs):
    """Repeat the last field once per lead time; on ``kwargs["device"]``,
    else the field's own device, else the card."""
    del velocity, outval
    num = timesteps if isinstance(timesteps, int) else len(timesteps)
    precip = as_device_tensor(precip, kwargs.get("device"))
    out = precip[None].repeat((num,) + (1,) * precip.ndim)
    if kwargs.get("return_displacement", False):
        return out, torch.zeros((2,) + tuple(precip.shape), device=precip.device)
    return out


def _do_nothing(precip, velocity, timesteps, outval=np.nan, **kwargs):
    return None


_extrapolation_methods = {
    "eulerian": eulerian_persistence,
    "semilagrangian": semilagrangian.extrapolate,
    None: _do_nothing,
    "none": _do_nothing,
}


def get_method(name):
    """The extrapolation function registered under ``name``."""
    if isinstance(name, str):
        name = name.lower()
    try:
        return _extrapolation_methods[name]
    except KeyError:
        raise ValueError(
            f"unknown extrapolation method {name}; "
            f"available: {list(_extrapolation_methods)}"
        ) from None
