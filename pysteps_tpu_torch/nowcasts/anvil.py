"""ANVIL nowcast: autoregressive nowcasting of VIL (counterpart of
``pysteps_tpu/nowcasts/anvil.py``; Pulkkinen, Chandrasekar, van
Lier-Walqui & Harkema 2020).

ARI(p, 1) on differenced, non-normalized cascades with per-pixel AR
parameters from Gaussian moving-window correlations, an optional local
R(VIL) regression and a rain-rate mask.  The separable Gaussian filters
are two matrix products with banded Toeplitz matrices (float32, the
zero-padded "SAME" window of the JAX package's convolutions).  The lead
loop is a Python loop; on the card its displacement and warp take
kernel K1 when the velocity bounds the displacement (the JAX package's
data-dependent rule), on the CPU the exact gather.
"""

import time

import numpy as np
import torch

from pysteps_tpu_torch import cascade
from pysteps_tpu_torch._device import resolve_device
from pysteps_tpu_torch.cascade.decomposition import decompose_core
from pysteps_tpu_torch.extrapolation.semilagrangian import integrate_displacement, model_warp
from pysteps_tpu_torch.nowcasts.steps import _lagrangian_alignment, _sync
from pysteps_tpu_torch.nowcasts import utils as nowcast_utils
from pysteps_tpu_torch.timeseries import autoregression


def _gaussian_kernel1d(radius, device=None):
    """Normalized Gaussian taps of standard deviation ``radius`` over
    +-4 ``radius``."""
    half = int(max(round(4.0 * radius), 1))
    x = torch.arange(-half, half + 1, dtype=torch.float32, device=device)
    k = torch.exp(-(x**2) / (2.0 * float(radius) ** 2))
    return k / torch.sum(k)


def _band_matrix(k1d, size):
    """(size, size) matrix T with (T @ f)[i] = sum_t k[t] f[i + t - h]
    over the pixels inside the field: the zero-padded "SAME"
    correlation with the 2h+1 taps ``k1d``."""
    half = (k1d.shape[0] - 1) // 2
    i = torch.arange(size, device=k1d.device)
    off = i[None, :] - i[:, None] + half
    inside = (off >= 0) & (off <= 2 * half)
    return torch.where(inside, k1d[torch.clamp(off, 0, 2 * half)], 0.0)


def _gauss_filter_batch(fields, k1d):
    """Separable Gaussian filter of (..., m, n): vertical, then
    horizontal."""
    m, n = fields.shape[-2:]
    out = _band_matrix(k1d, m) @ fields
    return out @ _band_matrix(k1d, n).T


def _moving_window_corrcoef(x, y, window_radius, mask):
    """Zero-mean localized correlation of x and y over ``mask`` with a
    Gaussian window (global over the mask with ``window_radius=None``)."""
    w = mask.to(torch.float32)
    x = torch.where(mask, x, 0.0)
    y = torch.where(mask, y, 0.0)
    if window_radius is not None:
        k = _gaussian_kernel1d(window_radius, x.device)
        n, ssx, ssy, sxy = _gauss_filter_batch(torch.stack([w, x * x, y * y, x * y]), k)
    else:
        n = w.mean()
        ssx, ssy, sxy = (x * x).mean(), (y * y).mean(), (x * y).mean()
    n = torch.clamp(n, min=1e-6)
    stdx = torch.sqrt(ssx / n)
    stdy = torch.sqrt(ssy / n)
    cov = sxy / n
    ok = (stdx > 1e-8) & (stdy > 1e-8) & (n > 1e-3)
    return torch.where(ok, cov / torch.clamp(stdx * stdy, min=1e-12), 0.0)


def _estimate_ar1_params(gamma):
    """ARI(1, 1) per-pixel parameters from the lag maps ``gamma`` (1, ...)."""
    return torch.stack([1.0 + gamma[0], -gamma[0], torch.zeros_like(gamma[0])])


def _estimate_ar2_params(gamma):
    """ARI(2, 1) per-pixel parameters from the lag maps ``gamma`` (2, ...)."""
    denom = torch.clamp(1.0 - gamma[0] * gamma[0], min=1e-8)
    pd1 = gamma[0] * (1.0 - gamma[1]) / denom
    pd2 = (gamma[1] - gamma[0] * gamma[0]) / denom
    return torch.stack([1.0 + pd1, -pd1 + pd2, -pd2, torch.zeros_like(pd1)])


def _r_vil_regression(vil, r, window_radius):
    """Local linear regression R = a VIL + b over the pixels with VIL > 10
    and R > 0.1, in a Gaussian window.  Returns (a, b)."""
    vil = torch.where(torch.isfinite(vil), vil, 0.0)
    r = torch.where(torch.isfinite(r), r, 0.0)
    mask_vil = vil > 10.0
    mask_obs = mask_vil & (r > 0.1)
    vilm = torch.where(mask_obs, vil, 0.0)
    rm = torch.where(mask_obs, r, 0.0)
    k = _gaussian_kernel1d(window_radius, vil.device)
    n, sx, sx2, sxy, sy = _gauss_filter_batch(
        torch.stack([mask_obs.to(torch.float32), vilm, vilm * vilm, vilm * rm, rm]), k
    )
    det = sx2 * n - sx * sx
    ok = (torch.abs(det) > 1e-8) & (n > 0.01)
    c = 1.0 / torch.where(ok, det, 1.0)
    a = torch.where(ok & mask_vil, c * (n * sxy - sx * sy), 0.0)
    b = torch.where(ok & mask_vil, c * (-sx * sxy + sx2 * sy), 0.0)
    return a, b


def _alignment_validity(velocity, p1, n_iter=1, max_disp=None):
    """(p1, m, n) validity of the Lagrangian alignment: a field of ones
    warped with fill 0 along each input's displacement chain, so pixels
    advected from outside the domain fall below 1."""
    ones = torch.ones(velocity.shape[1:], dtype=torch.float32, device=velocity.device)
    outs = []
    for i in range(p1):
        disp = torch.zeros_like(velocity)
        for _ in range(p1 - 1 - i):
            disp = integrate_displacement(
                velocity, disp, 1.0, n_iter=n_iter, max_disp=max_disp
            )
        outs.append(model_warp(ones, disp, max_disp=max_disp, interp_order=1, cval=0.0))
    return torch.stack(outs)


def _iterate_ari_localized(window, phi):
    """One ARI step with per-pixel parameters: window (k, p, m, n), phi
    (k, p+1, m, n); lag i weighs window[:, -(i+1)] by phi[:, i]."""
    p = window.shape[1]
    coeffs = torch.flip(phi[:, :p], dims=(1,))  # oldest first
    x_new = torch.sum(window * coeffs, dim=1)
    return torch.cat([window[:, 1:], x_new[:, None]], dim=1)


def _anvil_init(vil, velocity, weights_2d, finite_all, ar_order,
                ar_window_radius, n_iter, interp_order):
    """Initialization: Lagrangian alignment and its validity, the
    non-normalized cascades, the Gaussian moving-window lag correlations of
    the differenced cascades, the lag-2 adjustment and the per-pixel ARI
    parameters.  Returns (window0 (k, p+1, m, n), phi (k, p+2, m, n),
    mask, the automatic rain-rate mask)."""
    p1, m, n = vil.shape
    vil_aligned = _lagrangian_alignment(vil, velocity, n_iter=n_iter, interp_order=interp_order)
    valid = _alignment_validity(velocity, p1, n_iter=n_iter)
    mask = finite_all & torch.all(valid > 0.9999, dim=0)
    rr_auto_mask = (vil[-1] < 0.1) & mask

    vil_dec = decompose_core(vil_aligned, weights_2d, normalize=False)[0].transpose(0, 1)
    vil_diff = torch.diff(vil_dec, dim=1)  # (k, p1 - 1, m, n)
    k_levels = vil_diff.shape[0]
    k1d = _gaussian_kernel1d(ar_window_radius, vil.device)
    xs = vil_diff[:, -1]
    ys = torch.stack([vil_diff[:, -(j + 2)] for j in range(ar_order)], dim=1)
    # every filtered field in one batch: the window weight, x^2, and
    # y^2 and x*y of each level and lag
    fields = torch.cat(
        [
            torch.ones((1, m, n), dtype=torch.float32, device=vil.device),
            xs * xs,
            (ys * ys).reshape(-1, m, n),
            (xs[:, None] * ys).reshape(-1, m, n),
        ],
        dim=0,
    )
    filt = _gauss_filter_batch(fields, k1d)
    n_w = torch.clamp(filt[0], min=1e-6)
    ssx = filt[1 : 1 + k_levels]
    ssy = filt[1 + k_levels : 1 + k_levels * (1 + ar_order)].reshape(k_levels, ar_order, m, n)
    sxy = filt[1 + k_levels * (1 + ar_order):].reshape(k_levels, ar_order, m, n)
    stdx = torch.sqrt(ssx / n_w)[:, None]
    stdy = torch.sqrt(ssy / n_w)
    cov = sxy / n_w
    ok = (stdx > 1e-8) & (stdy > 1e-8) & (n_w > 1e-3)
    gamma = torch.where(ok, cov / torch.clamp(stdx * stdy, min=1e-12), 0.0)
    if ar_order == 2:
        g2 = autoregression.adjust_lag2_corrcoef2(gamma[:, 0], gamma[:, 1])
        gamma = torch.stack([gamma[:, 0], g2], dim=1)
        phi = torch.stack([_estimate_ar2_params(g) for g in gamma])
    else:
        phi = torch.stack([_estimate_ar1_params(g) for g in gamma])
    window0 = vil_dec[:, -(ar_order + 1):]
    return window0, phi, mask, rr_auto_mask


def _anvil_scan(
    window0, velocity, phi, mask, rainrate_mask, r_vil_a, r_vil_b,
    domain_mask, int_steps, use_rvil, apply_rainrate_mask,
    n_iter, interp_order, max_disp=None,
):
    """The lead loop over ``int_steps`` unit steps; returns (int_steps, m,
    n) rain rates."""
    m, n = velocity.shape[1:]
    displacement = torch.zeros((2, m, n), dtype=torch.float32, device=velocity.device)
    window = window0
    outputs = []
    for _ in range(int_steps):
        window = _iterate_ari_localized(window, phi)
        vil_f = torch.sum(window[:, -1], dim=0)  # non-normalized recompose
        vil_f = torch.where(mask, vil_f, float("nan"))
        if use_rvil:
            rr = r_vil_a * vil_f + r_vil_b
        else:
            rr = vil_f
            if apply_rainrate_mask:
                rr = torch.where(rainrate_mask, 0.0, rr)
        rr = torch.clamp(rr, min=0.0)
        displacement = integrate_displacement(
            velocity, displacement, 1.0, n_iter=n_iter, max_disp=max_disp
        )
        out = model_warp(
            rr, displacement, max_disp=max_disp, interp_order=interp_order,
            cval=float("nan"),
        )
        outputs.append(torch.where(domain_mask, float("nan"), out))
    return torch.stack(outputs)


def forecast(
    vil,
    velocity,
    timesteps,
    rainrate=None,
    n_cascade_levels=6,
    extrap_method="semilagrangian",
    ar_order=2,
    ar_window_radius=50,
    r_vil_window_radius=3,
    fft_method="numpy",
    apply_rainrate_mask=True,
    num_workers=1,
    extrap_kwargs=None,
    filter_kwargs=None,
    measure_time=False,
    device=None,
):
    """ANVIL forecast with the JAX package's signature plus ``device``.
    ``vil``: (ar_order+2, m, n).  Returns (T, m, n) on ``device``: CUDA
    unless the caller asks for the CPU (or passes CPU tensors)."""
    t0 = time.time()
    device = resolve_device(device, vil, velocity, rainrate)
    vil = np.array(nowcast_utils.to_numpy(vil), dtype=np.float32)
    if vil.ndim != 3 or vil.shape[0] != ar_order + 2:
        raise ValueError(
            f"vil must have shape (ar_order+2, m, n); got {vil.shape}"
        )
    if ar_order not in (1, 2):
        raise ValueError("ar_order must be 1 or 2")
    extrap_kwargs = dict(extrap_kwargs or {})
    filter_kwargs = filter_kwargs or {}
    m, n = vil.shape[1:]

    def dev(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=device)

    domain_mask = dev(~np.isfinite(vil[-1]))
    rainrate_mask0 = (
        dev(vil[-1] < 0.1) if (rainrate is None and apply_rainrate_mask)
        else torch.zeros((m, n), dtype=torch.bool, device=device)
    )
    if rainrate is not None:
        r_vil_a, r_vil_b = _r_vil_regression(
            dev(vil[-1]), dev(rainrate, torch.float32), r_vil_window_radius,
        )
    else:
        r_vil_a = r_vil_b = torch.zeros((m, n), dtype=torch.float32, device=device)

    vil_t = dev(np.where(np.isfinite(vil), vil, 0.0).astype(np.float32))
    finite_all = dev(np.all(np.isfinite(vil), axis=0))
    velocity_t = dev(velocity, torch.float32)

    bp_filter = cascade.get_method("gaussian")((m, n), n_cascade_levels, **filter_kwargs)
    weights_2d = torch.tensor(bp_filter["weights_2d"], dtype=torch.float32, device=device)

    window0, phi, mask, rr_auto_mask = _anvil_init(
        vil_t, velocity_t, weights_2d, finite_all, int(ar_order),
        int(ar_window_radius), int(extrap_kwargs.get("n_iter", 1)),
        int(extrap_kwargs.get("interp_order", 1)),
    )
    if rainrate is None and apply_rainrate_mask:
        rainrate_mask0 = rr_auto_mask

    if isinstance(timesteps, int):
        int_steps = timesteps
        subsel = None
    else:
        subsel = list(timesteps)
        int_steps = int(np.ceil(max(subsel)))

    _sync(device)
    init_time = time.time() - t0

    # the JAX package's data-dependent bound, taken on the card only
    vmax = float(velocity_t.abs().max()) if velocity_t.numel() else 0.0
    max_disp = max(int(np.ceil(int_steps * (vmax + 0.5))) + 2, 3)
    if device.type == "cpu" or max_disp > min(m, n) // 3:
        max_disp = None
    t1 = time.time()
    out = _anvil_scan(
        window0, velocity_t, phi, mask, rainrate_mask0, r_vil_a, r_vil_b,
        domain_mask, int_steps, rainrate is not None, bool(apply_rainrate_mask),
        extrap_kwargs.get("n_iter", 1), extrap_kwargs.get("interp_order", 1),
        max_disp=max_disp,
    )
    _sync(device)
    loop_time = time.time() - t1

    if subsel is not None:
        out = nowcast_utils.interpolate_leads(out, subsel, axis=0)
    if measure_time:
        return out, init_time, loop_time
    return out
