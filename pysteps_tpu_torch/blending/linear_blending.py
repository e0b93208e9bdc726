"""
Linear and salient blending of a nowcast with NWP (counterpart of
``pysteps_tpu/blending/linear_blending.py``; Hwang et al. 2015 for the
saliency weights).

The nowcast runs through the port's ``nowcasts.get_method``; the blend
then stays on the nowcast's device: each lead is an elementwise mix of
tensors (the JAX package's loop runs on numpy), and the saliency ranking
is one sort per field.
"""

import numpy as np
import torch

from pysteps_tpu_torch._device import as_device_tensor, resolve_device
from pysteps_tpu_torch.utils import conversion


def _ranked_salience(precip_nowcast, precip_nwp):
    """Dense-ranked normalized intensity difference in [0, 1]
    (reference: linear_blending.py:289)."""
    max_now = precip_nowcast.max()
    max_nwp = precip_nwp.max()
    norm_now = torch.where(max_now > 0, precip_nowcast / torch.clamp(max_now, min=1e-12), 0.0)
    norm_nwp = torch.where(max_nwp > 0, precip_nwp / torch.clamp(max_nwp, min=1e-12), 0.0)
    diff = (norm_now - norm_nwp).reshape(-1)
    sorted_diff = torch.sort(diff).values
    is_new = torch.ones_like(sorted_diff, dtype=torch.bool)
    is_new[1:] = sorted_diff[1:] != sorted_diff[:-1]
    dense_of_sorted = torch.cumsum(is_new.to(torch.int64), dim=0)
    ranks = dense_of_sorted[torch.searchsorted(sorted_diff, diff)]
    ranked = ranks.to(torch.float32) / torch.clamp(ranks.max(), min=1)
    return ranked.reshape(precip_nowcast.shape)


def _salience_weight(weight, ranked):
    """Salience weight (reference: linear_blending.py:326; Hwang2015)."""
    w = weight
    r = ranked
    term1 = (w * r) / torch.clamp(w * r + (1 - w) * (1 - r), min=1e-12)
    term2 = torch.sqrt(r**2 + w**2) / torch.clamp(
        torch.sqrt(r**2 + w**2) + torch.sqrt((1 - r) ** 2 + (1 - w) ** 2), min=1e-12
    )
    return 0.5 * (term1 + term2)


def _repeat_members(x, n_max):
    """(n, ...) -> (n_max, ...) with member i repeated (n_max + i) // n
    times, the JAX package's ``np.repeat``."""
    n = x.shape[0]
    reps = torch.tensor([(n_max + i) // n for i in range(n)], device=x.device)
    return torch.repeat_interleave(x, reps, dim=0)


def forecast(
    precip,
    precip_metadata,
    velocity,
    timesteps,
    timestep,
    nowcast_method,
    precip_nwp=None,
    precip_nwp_metadata=None,
    start_blending=120,
    end_blending=240,
    fill_nwp=True,
    saliency=False,
    nowcast_kwargs=None,
    device=None,
):
    """Linear or salient blending (reference: linear_blending.py:29).

    Runs ``nowcast_method`` through ``nowcasts.get_method`` on ``device``
    (CUDA unless the caller asks for the CPU or passes CPU tensors),
    converts the nowcast and the NWP to mm/h and ramps the NWP weight
    linearly from 0 at ``start_blending`` minutes to 1 at ``end_blending``.
    Returns a tensor on that device: the nowcast's shape without
    ``precip_nwp``, else the NWP's (members repeated to the larger
    ensemble when either has a member axis)."""
    from pysteps_tpu_torch import nowcasts

    device = resolve_device(device, precip, velocity)
    nowcast_kwargs = dict(nowcast_kwargs or {}, device=device)
    if precip_nwp is not None and tuple(precip_nwp.shape[-2:]) != tuple(np.shape(precip)[-2:]):
        raise ValueError("x/y dimensions of nowcast and NWP must match")

    nowcast_method_func = nowcasts.get_method(nowcast_method)
    if nowcast_method == "sseps":
        precip_nowcast = nowcast_method_func(
            precip, precip_metadata, velocity, timesteps, **nowcast_kwargs
        )
    else:
        precip_nowcast = nowcast_method_func(precip, velocity, timesteps, **nowcast_kwargs)
    precip_nowcast, _ = conversion.to_rainrate(precip_nowcast, precip_metadata, device=device)
    precip_nowcast = precip_nowcast.to(torch.float32).clone()

    if precip_nwp is None:
        return precip_nowcast

    precip_nwp = as_device_tensor(precip_nwp, device, torch.float32)
    if precip_nwp_metadata is not None and precip_nwp_metadata.get("transform") is not None:
        precip_nwp, _ = conversion.to_rainrate(precip_nwp, precip_nwp_metadata, device=device)

    ensemble_nowcast = precip_nowcast.ndim == 4
    ensemble_nwp = precip_nwp.ndim == 4
    if ensemble_nowcast or ensemble_nwp:
        n_now = precip_nowcast.shape[0] if ensemble_nowcast else 1
        n_nwp = precip_nwp.shape[0] if ensemble_nwp else 1
        n_max = max(n_now, n_nwp)
        if not ensemble_nowcast:
            precip_nowcast = precip_nowcast[None].expand((n_max,) + precip_nowcast.shape)
        elif n_now < n_max:
            precip_nowcast = _repeat_members(precip_nowcast, n_max)
        if not ensemble_nwp:
            precip_nwp = precip_nwp[None].expand((n_max,) + precip_nwp.shape)
        elif n_nwp < n_max:
            precip_nwp = _repeat_members(precip_nwp, n_max)
        time_axis = 1
    else:
        time_axis = 0

    n_steps = precip_nowcast.shape[time_axis]
    precip_nwp = torch.nan_to_num(precip_nwp, nan=0.0)
    nan_mask = torch.isnan(precip_nowcast)
    if fill_nwp:
        nwp_cut = precip_nwp.narrow(time_axis, 0, n_steps)
        precip_nowcast = torch.where(nan_mask, nwp_cut, precip_nowcast)
    else:
        precip_nowcast = torch.where(nan_mask, 0.0, precip_nowcast)

    blended = torch.zeros_like(precip_nwp)
    for i in range(precip_nwp.shape[time_axis]):
        t = (i + 1) * timestep
        weight_nwp = (t - start_blending) / (end_blending - start_blending)
        nwp_i = precip_nwp.select(time_axis, i)
        now_i = precip_nowcast.select(time_axis, i) if i < n_steps else torch.zeros_like(nwp_i)
        out_i = blended.select(time_axis, i)
        if weight_nwp <= 0.0:
            out_i.copy_(now_i)
        elif weight_nwp >= 1.0:
            out_i.copy_(nwp_i)
        else:
            weight_nowcast = 1.0 - weight_nwp
            if saliency:
                ws = _salience_weight(weight_nowcast, _ranked_salience(now_i, nwp_i))
                out_i.copy_(ws * now_i + (1 - ws) * nwp_i)
            else:
                out_i.copy_(weight_nwp * nwp_i + weight_nowcast * now_i)
    return blended
