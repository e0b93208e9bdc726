"""Lagrangian-persistence nowcast: advect the latest field (counterpart of
``pysteps_tpu/nowcasts/extrapolation.py``)."""

import time

import numpy as np
import torch

from pysteps_tpu_torch import extrapolation as extrap_module
from pysteps_tpu_torch._device import resolve_device


def forecast(
    precip,
    velocity,
    timesteps,
    extrap_method="semilagrangian",
    extrap_kwargs=None,
    measure_time=False,
    device=None,
):
    """Extrapolation nowcast of the (m, n) field ``precip``; returns
    (T, m, n) on ``device``: CUDA unless the caller asks for the CPU (or
    passes CPU tensors)."""
    device = resolve_device(device, precip, velocity)
    extrap_kwargs = dict(extrap_kwargs or {})
    if not isinstance(precip, torch.Tensor):
        precip = np.asarray(precip)
        extrap_kwargs.setdefault(
            "allow_nonfinite_values", bool(np.any(~np.isfinite(precip)))
        )
    if precip.ndim != 2:
        raise ValueError("precip must be a two-dimensional array")

    t0 = time.time()
    extrapolator = extrap_module.get_method(extrap_method)
    out = extrapolator(precip, velocity, timesteps, device=device, **extrap_kwargs)
    if measure_time:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out, 0.0, time.time() - t0
    return out
