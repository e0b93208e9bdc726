"""Local Lagrangian exceedance probability nowcast (counterpart of
``pysteps_tpu/nowcasts/lagrangian_probability.py``; Germann & Zawadzki
2004): extrapolation, binary exceedance, and a circular-kernel mean over
valid pixels whose radius grows linearly with lead time, all leads in one
batched FFT convolution (``torch.fft.rfft2``)."""

import numpy as np
import torch

from pysteps_tpu_torch._device import resolve_device
from pysteps_tpu_torch.nowcasts import extrapolation


def forecast(
    precip,
    velocity,
    timesteps,
    threshold,
    extrap_method="semilagrangian",
    extrap_kwargs=None,
    slope=5,
    device=None,
):
    """P(R >= threshold) within a radius of ``slope`` x lead time; returns
    (T, m, n) on ``device`` (CUDA unless the caller asks for the CPU or
    passes CPU tensors)."""
    device = resolve_device(device, precip, velocity)
    precip_forecast = extrapolation.forecast(
        precip, velocity, timesteps,
        extrap_method=extrap_method, extrap_kwargs=extrap_kwargs, device=device,
    )
    if isinstance(timesteps, int):
        timesteps = np.arange(1, timesteps + 1)
    timesteps = np.asarray(timesteps, float)

    # one centred circular kernel per lead, padded to the largest radius
    r_max = int(np.ceil(max(float(slope * timesteps[-1]), 1.0)))
    k_sz = 2 * r_max + 1
    yy, xx = np.mgrid[-r_max : r_max + 1, -r_max : r_max + 1]
    kernels = np.stack([
        (yy**2 + xx**2 <= max(slope * t, 1.0) ** 2).astype(np.float32)
        for t in timesteps
    ])
    return _lagprob_core(
        precip_forecast, torch.as_tensor(kernels, device=device),
        float(np.float32(threshold)), k_sz,
    )


def _lagprob_core(precip_forecast, kernels, threshold, k_sz):
    """The T neighbourhood means as one FFT convolution zero-padded to a
    multiple of 256 (SAME zero-boundary semantics), each the exceedance
    count over the valid-pixel count, NaN where fewer than half a pixel is
    valid."""
    T, m, n = precip_forecast.shape
    r = (k_sz - 1) // 2
    P_m = int(-((m + k_sz - 1) // -256) * 256)
    P_n = int(-((n + k_sz - 1) // -256) * 256)

    valid = torch.isfinite(precip_forecast)
    exceed = (valid & (precip_forecast >= threshold)).to(torch.float32)
    validf = valid.to(torch.float32)

    fields = torch.cat([exceed, validf], dim=0)  # (2T, m, n)
    Ff = torch.fft.rfft2(fields, s=(P_m, P_n))
    Kf = torch.fft.rfft2(kernels, s=(P_m, P_n))
    conv = torch.fft.irfft2(Ff * torch.cat([Kf, Kf], dim=0), s=(P_m, P_n))
    # the kernels are centred at (r, r): the SAME-aligned window sum of
    # output pixel (i, j) sits at (i + r, j + r)
    conv = conv[:, r : r + m, r : r + n]
    num, den = conv[:T], conv[T:]
    # clip the FFT's rounding into [0, 1]
    prob = torch.clamp(num / torch.clamp(den, min=1e-8), 0.0, 1.0)
    return torch.where(den > 0.5, prob, float("nan"))
