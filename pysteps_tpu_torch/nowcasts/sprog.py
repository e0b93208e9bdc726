"""S-PROG deterministic nowcast (counterpart of
``pysteps_tpu/nowcasts/sprog.py``; Seed 2003 spectral prognosis).

The STEPS machinery without its stochastic terms: Lagrangian alignment,
cascade decomposition, per-level AR(p), a percentile mask that keeps the
wet-area ratio, and CDF matching.  The lead loop is a Python loop.  On
the card, with a grid of at least 144 pixels a side, the displacement
and the warp take kernel K1 with the static bound 48 and the CDF match
the PWL map (K3 or the hierarchical map); on the CPU the exact gather and
the sort matcher, as in the JAX package.
"""

import time

import numpy as np
import torch

from pysteps_tpu_torch import cascade
from pysteps_tpu_torch._device import resolve_device
from pysteps_tpu_torch.cascade.decomposition import recompose_core
from pysteps_tpu_torch.extrapolation.semilagrangian import integrate_displacement, model_warp
from pysteps_tpu_torch.nowcasts import utils as nowcast_utils
from pysteps_tpu_torch.nowcasts.steps import (
    _MAX_DISP,
    _estimate_params,
    _lagrangian_alignment,
    _nanmin,
    _sync,
)
from pysteps_tpu_torch.ops import pallas_histmatch
from pysteps_tpu_torch.postprocessing.probmatching import prepare_cdf_matcher
from pysteps_tpu_torch.timeseries import autoregression


def _sprog_scan(
    window0, velocity, phi, means_last, stds_last, precip_last, precip_min,
    precip_thr, war, mu_0, domain_mask, int_steps, probmatching,
    n_iter, interp_order, max_disp=None, pwl_match=False,
):
    """The lead loop over ``int_steps`` unit steps from the normalized
    cascade window (k, p, m, n); returns (int_steps, m, n).  ``pwl_match``
    chooses the PWL matcher over the sort matcher."""
    m, n = precip_last.shape
    displacement = torch.zeros((2, m, n), dtype=torch.float32, device=precip_last.device)
    pm_match, pm_state = prepare_cdf_matcher(precip_last, pwl_match)
    window = window0
    outputs = []
    for _ in range(int_steps):
        window = autoregression.iterate_ar_model(window, phi)
        field = recompose_core(window[:, -1], means_last, stds_last)
        # keep the wet-area ratio: the smallest values go to the minimum
        mask = nowcast_utils.compute_percentile_mask(field, war)
        field = torch.where(mask, field, precip_min)
        if probmatching == "cdf":
            field = pm_match(field[None], pm_state)[0]
        elif probmatching == "mean":
            wet = field >= precip_thr
            mu_fct = torch.where(wet, field, 0.0).sum() / torch.clamp(wet.sum(), min=1)
            field = torch.where(wet, field - mu_fct + mu_0, field)
        displacement = integrate_displacement(
            velocity, displacement, 1.0, n_iter=n_iter, max_disp=max_disp
        )
        out = model_warp(
            field, displacement, max_disp=max_disp, interp_order=interp_order,
            cval=float("nan"),
        )
        outputs.append(torch.where(domain_mask, float("nan"), out))
    return torch.stack(outputs)


def _sprog_init(
    precip_all, velocity, weights_2d, precip_thr, ar_order, conditional,
    n_iter, interp_order, max_disp=None,
):
    """Initialization: the rain fraction of the no-rain gate, sanitized
    inputs, Lagrangian alignment, cascade and AR estimation, wet-area
    statistics.  Returns (rain_frac, window0, means, stds, gamma, phi,
    precip_last, precip_min, war, mu_0, domain_mask)."""
    rain_frac = (precip_all > precip_thr).float().mean()
    precip = precip_all[-(ar_order + 1):].to(torch.float32)
    precip_min = _nanmin(precip)
    domain_mask = ~torch.isfinite(precip[-1])
    precip = torch.where(torch.isfinite(precip), precip, precip_min)
    m, n = precip.shape[1:]

    if conditional:
        mask_thr = torch.all(precip >= precip_thr, dim=0)
    else:
        mask_thr = torch.ones((m, n), dtype=torch.bool, device=precip.device)

    precip_aligned = _lagrangian_alignment(
        precip, velocity, n_iter=n_iter, interp_order=interp_order,
        max_disp=max_disp,
    )
    cascades_full, means, stds, gamma, phi = _estimate_params(
        precip_aligned, weights_2d, mask_thr, ar_order, conditional
    )
    window0 = cascades_full[:, -ar_order:]
    precip_last = precip[-1]
    wet = precip_last >= precip_thr
    war = (wet & mask_thr).sum() / mask_thr.sum()
    mu_0 = torch.where(wet, precip_last, 0.0).sum() / torch.clamp(wet.sum(), min=1)
    return (
        rain_frac, window0, means, stds, gamma, phi, precip_last,
        precip_min, war, mu_0, domain_mask,
    )


def _scan_path(device, shape, velocity, int_steps):
    """(the init's displacement bound, the loop's, PWL matcher or not) on
    ``device``, by the JAX package's rule: on the card the static bound 48
    for grids of at least 144 pixels a side (else the velocity's bound,
    for the loop only) and the PWL matcher where it applies; on the CPU
    the exact gather and the sort matcher."""
    m, n = shape
    if device.type == "cpu":
        return None, None, False
    pwl = pallas_histmatch.supported(shape)
    if min(m, n) >= 3 * _MAX_DISP:
        return _MAX_DISP, _MAX_DISP, pwl
    vmax = float(velocity.abs().max()) if velocity.numel() else 0.0
    max_disp = max(int(np.ceil(int_steps * (vmax + 0.5))) + 2, 3)
    return None, (max_disp if max_disp <= min(m, n) // 3 else None), pwl


def forecast(
    precip,
    velocity,
    timesteps,
    precip_thr=None,
    norain_thr=0.0,
    n_cascade_levels=6,
    extrap_method="semilagrangian",
    decomp_method="fft",
    bandpass_filter_method="gaussian",
    ar_order=2,
    conditional=False,
    probmatching_method="cdf",
    num_workers=1,
    fft_method="numpy",
    domain="spatial",
    extrap_kwargs=None,
    filter_kwargs=None,
    measure_time=False,
    device=None,
):
    """S-PROG forecast with the JAX package's signature plus ``device``.
    Returns (T, m, n) on ``device``: CUDA unless the caller asks for the
    CPU (or passes CPU tensors)."""
    t0 = time.perf_counter()
    device = resolve_device(device, precip, velocity)
    if not isinstance(precip, torch.Tensor):
        precip = np.asarray(precip)
    if precip.ndim != 3 or precip.shape[0] < ar_order + 1:
        raise ValueError(
            f"precip must be (>=ar_order+1, m, n); got {tuple(precip.shape)}"
        )
    if precip_thr is None:
        raise ValueError("precip_thr required")
    extrap_kwargs = extrap_kwargs or {}
    filter_kwargs = filter_kwargs or {}
    m, n = precip.shape[1:]

    bp_filter = cascade.get_method(bandpass_filter_method)((m, n), n_cascade_levels,
                                                           **filter_kwargs)
    weights_2d = torch.tensor(bp_filter["weights_2d"], dtype=torch.float32, device=device)

    n_iter = extrap_kwargs.get("n_iter", 1)
    interp_order = extrap_kwargs.get("interp_order", 1)

    if isinstance(timesteps, int):
        int_steps = timesteps
        subsel = None
    else:
        subsel = list(timesteps)
        int_steps = int(np.ceil(max(subsel)))

    precip_t = torch.as_tensor(precip, dtype=torch.float32, device=device)
    velocity_t = torch.as_tensor(velocity, dtype=torch.float32, device=device)

    max_disp_init, max_disp, pwl_match = _scan_path(device, (m, n), velocity_t, int_steps)
    (
        rain_frac, window0, means, stds, gamma, phi, precip_last,
        precip_min, war, mu_0, domain_mask,
    ) = _sprog_init(
        precip_t, velocity_t, weights_2d, float(np.float32(precip_thr)),
        ar_order=ar_order, conditional=conditional, n_iter=n_iter,
        interp_order=interp_order, max_disp=max_disp_init,
    )
    _sync(device)
    init_time = time.perf_counter() - t0
    nowcast_utils.print_corrcoefs(gamma)
    nowcast_utils.print_ar_params(phi)
    if float(rain_frac) <= norain_thr:
        print("No precipitation above the threshold found "
              "in the radar field")
        return nowcast_utils.zero_precipitation_forecast(
            None, timesteps, nowcast_utils.to_numpy(precip), device, None, True,
            measure_time, t0,
        )
    t1 = time.perf_counter()
    out = _sprog_scan(
        window0, velocity_t, phi, means[-1], stds[-1], precip_last,
        precip_min, float(np.float32(precip_thr)), war, mu_0, domain_mask,
        int_steps, probmatching_method, n_iter, interp_order, max_disp=max_disp,
        pwl_match=pwl_match,
    )
    _sync(device)
    loop_time = time.perf_counter() - t1

    if subsel is not None:
        out = nowcast_utils.interpolate_leads(out, subsel, axis=0)
    if measure_time:
        return out, init_time, loop_time
    return out
