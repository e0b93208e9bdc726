"""SSEPS: short-space ensemble prediction system, a localized STEPS
(counterpart of ``pysteps_tpu/nowcasts/sseps.py``; Nerini et al. 2017).

As in the JAX package, one global AR state per member evolves beside one
AR state per wet window (each with its own parameters), the window fields
are CDF-matched to their slice of the observation and composited with
flat-Hanning masks, then matched globally, masked and advected on a coarse
displacement carry.  Members form the leading axis of every tensor; the
lead loop is a Python loop.  On the card, when the velocity bounds the
displacement (the JAX package's data-dependent rule), the displacement is
integrated on the 4x coarse grid (kernel K1), the field warped by K2, the
incremental mask updated by K4 and the global match is the PWL map;
on the CPU the exact gather, the max-pool rim and the sort matcher.
Every draw goes through ``noise.fftgenerators._white_normal`` and
``noise.motion._laplace``, which tests replace with the JAX package's.
"""

import time

import numpy as np
import torch

from pysteps_tpu_torch import cascade
from pysteps_tpu_torch._device import resolve_device
from pysteps_tpu_torch.cascade.decomposition import decompose_core
from pysteps_tpu_torch.extrapolation.semilagrangian import (
    coarsen_velocity,
    integrate_displacement_coarse,
    model_warp_coarse,
)
from pysteps_tpu_torch.noise import fftgenerators
from pysteps_tpu_torch.noise import motion as noise_motion
from pysteps_tpu_torch.nowcasts import utils as nowcast_utils
from pysteps_tpu_torch.nowcasts.steps import _lagrangian_alignment, _sync
from pysteps_tpu_torch.ops import pallas_histmatch
from pysteps_tpu_torch.postprocessing.probmatching import (
    _match_cdf_presorted,
    _prepare_cdf_target,
    prepare_cdf_matcher,
)
from pysteps_tpu_torch.timeseries import autoregression
from pysteps_tpu_torch.utils.check_norain import check_norain


def _window_bounds(shape, win_size, overlap):
    """The overlap-widened window boxes (y0, y1, x0, x1) of the grid and
    its (rows, columns) of windows."""
    m, n = shape
    n_wy = int(np.ceil(m / win_size[0]))
    n_wx = int(np.ceil(n / win_size[1]))
    bounds = []
    for i in range(n_wy):
        for j in range(n_wx):
            y0 = int(max(i * win_size[0] - overlap * win_size[0], 0))
            y1 = int(min(y0 + win_size[0] + overlap * win_size[0], m))
            x0 = int(max(j * win_size[1] - overlap * win_size[1], 0))
            x1 = int(min(x0 + win_size[1] + overlap * win_size[1], n))
            bounds.append((y0, y1, x0, x1))
    return (n_wy, n_wx), tuple(bounds)


def _flat_hanning_1d(size):
    T = size / 4.0
    W = size / 2.0
    B = np.linspace(-W, W, int(2 * W))
    R = np.abs(B) - T
    R[R < 0] = 0.0
    A = 0.5 * (1.0 + np.cos(np.pi * R / T))
    A[np.abs(B) > (2 * T)] = 0.0
    return A


def _flat_hanning_mask(shape, bounds):
    """The flat-Hanning composition mask of one window box on the grid."""
    y0, y1, x0, x1 = bounds
    w2d = np.outer(_flat_hanning_1d(y1 - y0), _flat_hanning_1d(x1 - x0))
    if np.any(np.isnan(w2d)):
        w2d[np.isnan(w2d)] = np.min(w2d[w2d > 0])
    w2d[w2d < 1e-3] = 1e-3
    mask = np.zeros(shape)
    mask[y0:y1, x0:x1] = w2d
    return mask


def _window_ar_params(casc_w, ar_order):
    """AR parameters and normalized state of one window (or the whole
    grid), in float32 on the cascade's device: casc_w (k, p+1, wy, wx);
    each lag normalized by its own window mean and std, gamma the plain
    correlation of the normalized lags, (mu, sigma) the last lag's.
    Returns (state (k, p, wy, wx), phi (k, p+1), mu (k,), sigma (k,))."""
    mu_l = casc_w.mean(dim=(2, 3), keepdim=True)
    sd_l = torch.clamp(casc_w.std(dim=(2, 3), correction=0, keepdim=True), min=1e-8)
    norm = (casc_w - mu_l) / sd_l
    gamma = torch.stack(
        [(norm[:, -1] * norm[:, -(lag + 2)]).mean(dim=(1, 2)) for lag in range(ar_order)],
        dim=1,
    )
    if ar_order == 2:
        g2 = autoregression.adjust_lag2_corrcoef2(gamma[:, 0], gamma[:, 1])
        gamma = torch.stack([gamma[:, 0], g2], dim=1)
    phi = autoregression.estimate_ar_params_yw(gamma, check_stationarity=False)
    return norm[:, -ar_order:], phi, mu_l[:, -1, 0, 0], sd_l[:, -1, 0, 0]


def _standardize_levels(levels):
    """Each level of (..., k, wy, wx) to zero mean and unit population
    std over its window."""
    mu = levels.mean(dim=(-2, -1), keepdim=True)
    sd = torch.clamp(levels.std(dim=(-2, -1), correction=0, keepdim=True), min=1e-8)
    return (levels - mu) / sd


def _ar_update(lags, phi, eps):
    """New AR state phi_p+1 eps + sum_i lags[i] phi_(p-i) of a tuple of p
    lags (oldest first, each (E, k, ...)), in the JAX package's order."""
    p = len(lags)
    x_new = phi[:, -1, None, None] * eps
    for i in range(p):
        x_new = x_new + lags[i] * phi[:, p - 1 - i, None, None]
    return x_new


def _sseps_init(precip, velocity, weights_2d, win_size, overlap, war_thr,
                precip_thr, ar_order, n_iter, interp_order, noise_kwargs):
    """Initialization on ``precip``'s device: alignment, global cascade
    and AR parameters, the windows' boxes, masks, matching targets, AR
    states and parameters, and the SSFT noise filter and its composition
    masks.  Returns a dict of the scan's inputs."""
    m, n = precip.shape[1:]
    dev = precip.device
    precip_aligned = _lagrangian_alignment(
        precip, velocity, n_iter=n_iter, interp_order=interp_order
    )
    cascades = decompose_core(precip_aligned, weights_2d, normalize=False)[0].transpose(0, 1)

    _, win_bounds = _window_bounds((m, n), win_size, overlap)
    fh_masks = np.stack([_flat_hanning_mask((m, n), b) for b in win_bounds]).astype(np.float32)
    m_s = fh_masks.sum(axis=0)
    inv_ms = np.where(m_s > 0, 1.0 / np.maximum(m_s, 1e-12), 0.0).astype(np.float32)
    obs = precip[-1]
    local_states = tuple(
        _prepare_cdf_target(obs[y0:y1, x0:x1]) for (y0, y1, x0, x1) in win_bounds
    )

    window, phi_g, mu_g, sigma_g = _window_ar_params(cascades, ar_order)
    casc_gn = _standardize_levels(cascades)
    wet = (obs >= precip_thr).to(torch.float64)
    wet_windows, wstates0, wparams = [], [], []
    if len(win_bounds) > 1:
        for (y0, y1, x0, x1) in win_bounds:
            is_wet = float(wet[y0:y1, x0:x1].mean()) > war_thr
            wet_windows.append(is_wet)
            if is_wet:
                st_w, phi_w, mu_w, sigma_w = _window_ar_params(
                    casc_gn[:, :, y0:y1, x0:x1], ar_order
                )
                wstates0.append(st_w)
                wparams.append((phi_w, mu_w, sigma_w))

    noise_kwargs = dict(noise_kwargs)
    noise_kwargs.setdefault("win_size", win_size)
    noise_kwargs.setdefault("overlap", overlap)
    noise_kwargs.setdefault("war_thr", war_thr)
    ssft_filter = fftgenerators.initialize_nonparam_2d_ssft_filter(
        precip_aligned, **noise_kwargs
    )
    ssft_filt = ssft_filter["field"].to(torch.float32)
    ssft_masks = fftgenerators._ssft_gen_masks(
        ssft_filt.shape, (m, n), 0.2, ssft_filter.get("win_fun", "tukey"), dev
    )
    return dict(
        window=window, phi_g=phi_g, mu_g=mu_g, sigma_g=sigma_g,
        wstates0=tuple(wstates0), wparams=tuple(wparams),
        ssft_filt=ssft_filt, ssft_masks=ssft_masks,
        fh_masks=torch.as_tensor(fh_masks, device=dev),
        inv_ms=torch.as_tensor(inv_ms, device=dev), local_states=local_states,
        win_bounds=win_bounds, wet_windows=tuple(wet_windows),
    )


def _sseps_scan(
    window, mask_prec_init, generator, velocity, phi_g, mu_g, sigma_g,
    wstates0, wparams, ssft_filt, ssft_masks, weights_2d, precip_last,
    precip_min, precip_thr, domain_mask, eps_par, eps_perp, V_n, V_perp,
    fh_masks, inv_ms, local_states, int_steps, mask_method, probmatching,
    mask_rim, struct_radius, E, max_disp=None, vel_pert=False, p_par=None,
    p_perp=None, vsf=1.0, timestep_min=1.0, win_bounds=(), wet_windows=(),
    pwl_match=False, callback=None, t_chunk=None,
):
    """The lead loop over ``int_steps`` unit steps for all ``E`` members.
    Returns the member-major (E, int_steps, m, n) output; with
    ``callback``, hands each lead's (E, m, n) frames to it as host numpy
    arrays, fetched every ``t_chunk`` leads from a buffer of that many,
    and returns None.  ``max_disp`` (None: the exact gather on the full
    grid) and ``pwl_match`` (the PWL matcher, else the sort matcher)
    choose the path; the device of the tensors chooses between the
    kernels and their plain versions."""
    k_levels, p, m, n = window.shape
    dev = precip_last.device
    cascades = tuple(window[:, i].expand(E, k_levels, m, n) for i in range(p))
    wstates = tuple(
        tuple(st[:, i].expand((E,) + st[:, i].shape) for i in range(p)) for st in wstates0
    )
    pm_match, pm_state = prepare_cdf_matcher(precip_last, pwl_match)
    mask_prec = mask_prec_init.expand(E, m, n)
    # the displacement is carried on a coarse grid (full-res pixel units)
    coarse = 4 if (max_disp is not None and m % 4 == 0 and n % 4 == 0) else 1
    vel_c = coarsen_velocity(velocity, coarse)
    V_n_c = coarsen_velocity(V_n, coarse) if vel_pert else None
    V_perp_c = coarsen_velocity(V_perp, coarse) if vel_pert else None
    displacement = torch.zeros((E, 2, m // coarse, n // coarse), dtype=torch.float32, device=dev)
    buf_leads = min(t_chunk, int_steps) if callback is not None else int_steps
    out = torch.empty((E, buf_leads, m, n), dtype=torch.float32, device=dev)
    t0 = 0

    for t in range(int_steps):
        t_total = np.float32((t + 1.0) * timestep_min)
        eps = fftgenerators._generate_ssft_noise(generator, ssft_filt, ssft_masks, (m, n), E)
        eps_levels = decompose_core(eps, weights_2d, normalize=False)[0]  # (E, k, m, n)
        x_new = _ar_update(cascades, phi_g, _standardize_levels(eps_levels))
        cascades = cascades[1:] + (x_new,)
        field = torch.sum(x_new * sigma_g[:, None, None] + mu_g[:, None, None], dim=-3)

        # each wet window's own AR state, recomposed with the double
        # denormalization; every window matched to its observation slice
        # and composited with the flat-Hanning masks
        wstates_new = []
        if len(win_bounds) > 1:
            comp = torch.zeros_like(field)
            for w, (y0, y1, x0, x1) in enumerate(win_bounds):
                if wet_windows[w]:
                    widx = sum(1 for ww in wet_windows[:w] if ww)
                    phi_w, mu_w, sigma_w = wparams[widx]
                    xw = _ar_update(
                        wstates[widx], phi_w,
                        _standardize_levels(eps_levels[..., y0:y1, x0:x1]),
                    )
                    wstates_new.append(wstates[widx][1:] + (xw,))
                    sl = torch.sum(
                        (xw * sigma_w[:, None, None] + mu_w[:, None, None])
                        * sigma_g[:, None, None] + mu_g[:, None, None],
                        dim=-3,
                    )
                else:
                    sl = field[..., y0:y1, x0:x1]
                if probmatching == "cdf":
                    sl = _match_cdf_presorted(sl, *local_states[w])
                comp[..., y0:y1, x0:x1] += sl * fh_masks[w, y0:y1, x0:x1]
            field = torch.where(inv_ms > 0, comp * inv_ms, precip_min)
        wstates = tuple(wstates_new)

        if probmatching == "cdf":
            # global match of the composite against the whole observation
            field = torch.where(field < precip_thr, precip_min, field)
            field = pm_match(field, pm_state)

        fmin = field.amin(dim=(-2, -1), keepdim=True)
        if mask_method == "incremental":
            field = fmin + (field - fmin) * mask_prec
            field = torch.where(field > fmin, field, fmin)
            mask_prec = nowcast_utils.compute_dilated_mask_from_field(
                field, precip_thr, struct_radius, mask_rim
            )
        elif mask_method == "obs":
            field = torch.where(mask_prec > 0, field, fmin)

        if vel_pert:
            a1, b1, c1 = (np.float32(v) for v in p_par)
            a2, b2, c2 = (np.float32(v) for v in p_perp)
            g_par = float(a1 * t_total**b1 + c1)
            g_perp = float(a2 * t_total**b2 + c2)
            vel_j = vel_c + (
                eps_par[:, None, None, None] * g_par * V_n_c
                + eps_perp[:, None, None, None] * g_perp * V_perp_c
            ) / vsf
        else:
            vel_j = vel_c
        displacement = integrate_displacement_coarse(
            vel_j, displacement, 1.0, max_disp=max_disp, coarse=coarse
        )
        warped = model_warp_coarse(
            field, displacement, (m, n), coarse, max_disp=max_disp, cval=float("nan")
        )
        out[:, t - t0] = torch.where(domain_mask, float("nan"), warped)
        if callback is not None and (t + 1 - t0 == buf_leads or t + 1 == int_steps):
            nowcast_utils.stream_leads(out, t + 1 - t0, callback)
            t0 = t + 1
    return None if callback is not None else out


def _scan_path(device, shape, vmax, int_steps):
    """(displacement bound, PWL matcher or not) of the loop on ``device``
    by the JAX package's rule: on the card the bound the speed ``vmax``
    gives over ``int_steps`` leads where it stays within a third of the
    grid, and the PWL matcher where it applies; on the CPU the exact
    gather and the sort matcher."""
    if device.type == "cpu":
        return None, False
    max_disp = max(int(np.ceil(int_steps * (vmax + 0.5))) + 2, 3)
    return (max_disp if max_disp <= min(shape) // 3 else None), pallas_histmatch.supported(shape)


def forecast(
    precip,
    metadata,
    velocity,
    timesteps,
    n_ens_members=24,
    n_cascade_levels=6,
    win_size=256,
    overlap=0.1,
    war_thr=0.1,
    extrap_method="semilagrangian",
    decomp_method="fft",
    bandpass_filter_method="gaussian",
    noise_method="ssft",
    ar_order=2,
    vel_pert_method=None,
    probmatching_method="cdf",
    mask_method="incremental",
    callback=None,
    fft_method="numpy",
    return_output=True,
    seed=None,
    num_workers=1,
    extrap_kwargs=None,
    filter_kwargs=None,
    noise_kwargs=None,
    vel_pert_kwargs=None,
    mask_kwargs=None,
    measure_time=False,
    device=None,
):
    """SSEPS forecast with the JAX package's signature plus ``device``.
    Returns (n_ens_members, T, m, n) on ``device``: CUDA unless the caller
    asks for the CPU (or passes CPU tensors).  ``callback`` gets each
    lead's (E, m, n) frames as host numpy arrays; with
    ``return_output=False`` (and an int ``timesteps``) the loop streams
    them in chunks of at most 4 leads and returns None."""
    t0 = time.perf_counter()
    device = resolve_device(device, precip, velocity)
    precip = nowcast_utils.to_numpy(precip).astype(np.float32)
    extrap_kwargs = dict(extrap_kwargs or {})
    mask_kwargs = dict(mask_kwargs or {})
    filter_kwargs = filter_kwargs or {}
    if isinstance(win_size, int):
        win_size = (win_size, win_size)

    precip_thr = metadata["threshold"]
    timestep = metadata["accutime"]
    kmperpixel = metadata["xpixelsize"] / 1000

    if check_norain(precip, precip_thr, 0.0, None, printmsg=True):
        return nowcast_utils.zero_precipitation_forecast(
            n_ens_members, timesteps, precip, device, callback, return_output,
            measure_time, t0,
        )

    precip = precip[-(ar_order + 1):]
    m, n = precip.shape[1:]
    domain_mask = torch.as_tensor(~np.isfinite(precip[-1]), device=device)
    precip_min = float(np.nanmin(precip))
    precip = np.where(np.isfinite(precip), precip, precip_min)
    precip_t = torch.as_tensor(precip, device=device)
    velocity_t = torch.as_tensor(velocity, dtype=torch.float32, device=device)

    bp_filter = cascade.get_method(bandpass_filter_method)((m, n), n_cascade_levels,
                                                           **filter_kwargs)
    weights_2d = torch.tensor(bp_filter["weights_2d"], dtype=torch.float32, device=device)
    init = _sseps_init(
        precip_t, velocity_t, weights_2d, win_size, overlap, war_thr,
        float(np.float32(precip_thr)), ar_order, extrap_kwargs.get("n_iter", 1),
        extrap_kwargs.get("interp_order", 1), noise_kwargs or {},
    )

    mask_rim = int(mask_kwargs.get("mask_rim", 10))
    mask_f = mask_kwargs.get("mask_f", 1.0)
    n_struct = mask_f * timestep / kmperpixel if kmperpixel else 3.0
    struct_radius = max(int((n_struct - 1) / 2.0), 1)
    wet_last = precip_t[-1] >= precip_thr
    if mask_method == "incremental":
        mask_prec_init = nowcast_utils.compute_dilated_mask(
            wet_last[None], struct_radius, mask_rim
        )[0].to(torch.float32)
    elif mask_method == "obs":
        mask_prec_init = wet_last.to(torch.float32)
    else:
        mask_prec_init = torch.ones((m, n), dtype=torch.float32, device=device)

    generator = torch.Generator(device=device)
    generator.manual_seed(seed if seed is not None else 42)

    # BPS: one Laplace draw a member for each of the parallel and the
    # perpendicular magnitude, scaled by the growing g_par / g_perp
    vel_pert = vel_pert_method is not None
    if vel_pert:
        vp_kwargs = dict(vel_pert_kwargs or {})
        p_par = tuple(float(v) for v in vp_kwargs.get(
            "p_par", noise_motion.get_default_params_bps_par()))
        p_perp = tuple(float(v) for v in vp_kwargs.get(
            "p_perp", noise_motion.get_default_params_bps_perp()))
        vsf = 60.0 / (timestep * (1.0 / kmperpixel))
        eps_par = noise_motion._laplace(generator, (n_ens_members,))
        eps_perp = noise_motion._laplace(generator, (n_ens_members,))
        Nv = torch.linalg.vector_norm(velocity_t, dim=0)
        V_n = torch.where(Nv[None] > 1e-12, velocity_t / torch.clamp(Nv[None], min=1e-12), 0.0)
        V_perp = torch.stack([-V_n[1], V_n[0]])
    else:
        p_par = p_perp = None
        vsf = 1.0
        eps_par = eps_perp = torch.zeros(n_ens_members, device=device)
        V_n = V_perp = torch.zeros_like(velocity_t)

    if isinstance(timesteps, int):
        int_steps = timesteps
        subsel = None
    else:
        subsel = list(timesteps)
        int_steps = int(np.ceil(max(subsel)))

    _sync(device)
    init_time = time.perf_counter() - t0

    # the largest speed, with a 4-sigma margin on the BPS perturbation at
    # the last lead
    vmax = float(velocity_t.abs().max()) if velocity_t.numel() else 0.0
    if vel_pert:
        t_last = int_steps * timestep
        g_par_last = abs(p_par[0] * t_last ** p_par[1] + p_par[2])
        g_perp_last = abs(p_perp[0] * t_last ** p_perp[1] + p_perp[2])
        vmax = vmax + 4.0 * max(g_par_last, g_perp_last) / max(vsf, 1e-6)
    max_disp, pwl_match = _scan_path(device, (m, n), vmax, int_steps)
    stream = callback is not None and not return_output and subsel is None
    t1 = time.perf_counter()
    out = _sseps_scan(
        init["window"], mask_prec_init, generator, velocity_t, init["phi_g"],
        init["mu_g"], init["sigma_g"], init["wstates0"], init["wparams"],
        init["ssft_filt"], init["ssft_masks"], weights_2d, precip_t[-1],
        precip_min, float(np.float32(precip_thr)), domain_mask, eps_par, eps_perp,
        V_n, V_perp, init["fh_masks"], init["inv_ms"], init["local_states"],
        int_steps, mask_method, probmatching_method, mask_rim, struct_radius,
        n_ens_members, max_disp=max_disp, vel_pert=vel_pert, p_par=p_par,
        p_perp=p_perp, vsf=vsf, timestep_min=float(timestep),
        win_bounds=init["win_bounds"], wet_windows=init["wet_windows"],
        pwl_match=pwl_match,
        callback=callback if stream else None, t_chunk=4,
    )
    _sync(device)
    loop_time = time.perf_counter() - t1
    if stream:
        return (None, init_time, loop_time) if measure_time else None

    if subsel is not None:
        out = nowcast_utils.interpolate_leads(out, subsel, axis=1)
    if callback is not None:
        nowcast_utils.stream_leads(out, out.shape[1], callback)
    result = out if return_output else None
    if measure_time:
        return result, init_time, loop_time
    return result
