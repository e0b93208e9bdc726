"""LINDA, the Lagrangian integro-difference equation model with
autoregression (counterpart of ``pysteps_tpu/nowcasts/linda.py``;
Pulkkinen, Chandrasekar & Niemi 2021).

Feature detection (at most ``max_num_features`` cells) -> a localized
ARI(p, 1) on the Lagrangian-differenced fields -> one anisotropic
Gaussian convolution kernel per feature (the IDE part) -> the composite
convolution, blended by per-feature window weights -> in the
probabilistic mode, lognormal multiplicative forecast-error
perturbations.

As in the JAX module:
- the features are one leading axis: window weights (F, m, n), kernel
  spectra (F, pm, pn // 2 + 1), one batched FFT convolution for all of
  them on a grid padded by ``_KERNEL_PAD``;
- the kernels are fitted by Adam on the weighted least-squares objective,
  all features at once (one (F, 3) parameter tensor; one backward of the
  summed loss a step gives each feature its own gradient).  The update is
  written out in float32 as optax's ``scale_by_adam`` computes it;
- the lead loop is a Python loop with the members batched; each member
  draws its perturbations from its own ``torch.Generator``;
- advection is the exact bilinear gather (no displacement bound), so
  LINDA launches none of the port's hand kernels.
"""

import math
import time

import numpy as np
import torch
import torch.nn.functional as F

from pysteps_tpu_torch._device import resolve_device
from pysteps_tpu_torch.extrapolation.semilagrangian import integrate_displacement, model_warp
from pysteps_tpu_torch.feature import blob, shitomasi, tstorm
from pysteps_tpu_torch.noise.fftgenerators import _spectral_white
from pysteps_tpu_torch.noise.motion import (
    _laplace,
    get_default_params_bps_par,
    get_default_params_bps_perp,
)
from pysteps_tpu_torch.nowcasts import utils as nowcast_utils
from pysteps_tpu_torch.nowcasts.steps import _lagrangian_alignment, _sync
from pysteps_tpu_torch.ops.warp import warp
from pysteps_tpu_torch.utils.arrays import _nanmin

# zero margin of the "same" FFT convolutions: covers the half-support of
# the widest kernel the optimizer box allows (sigma2 = ratio * sigma1 <=
# 50 px; the wrap-around tail exp(-160^2 / 50^2) < 4e-5)
_KERNEL_PAD = 160

# optax.adam's constants
_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8


def _compute_window_weights(coords, grid_height, grid_width, window_radius):
    """Gaussian window weights around each (y, x) feature: (F, m, n)
    float64 numpy, all ones for a single feature."""
    coords = np.asarray(coords, float)
    yy, xx = np.meshgrid(
        np.arange(grid_height, dtype=float), np.arange(grid_width, dtype=float),
        indexing="ij",
    )
    if coords.shape[0] == 1:
        return np.ones((1, grid_height, grid_width))
    w = np.stack(
        [
            np.exp(-0.5 * (((yy - cy) ** 2 + (xx - cx) ** 2) / window_radius**2))
            for cy, cx in coords
        ]
    )
    return w + 1e-6


def _kernel_ft(params, pm, pn):
    """rfft2 of the normalized anisotropic Gaussian kernels on the padded
    (pm, pn) grid, in closed form: exp(-pi^2 (sigma1^2 fu^2 + sigma2^2
    fv^2)) with (fu, fv) the frequencies rotated by phi.

    ``params`` (..., 3): (phi, log sigma1, log ratio), sigma1 clipped to
    [0.1, 10] and the ratio sigma2 / sigma1 to [0.2, 5].  Returns
    (..., pm, pn // 2 + 1) float32."""
    phi = params[..., 0, None, None]
    sigma1 = torch.clamp(torch.exp(params[..., 1]), 0.1, 10.0)[..., None, None]
    sigma2 = torch.clamp(torch.exp(params[..., 2]), 0.2, 5.0)[..., None, None] * sigma1
    fy = torch.fft.fftfreq(pm, device=params.device)[:, None]
    fx = torch.fft.rfftfreq(pn, device=params.device)[None, :]
    c, s = torch.cos(phi), torch.sin(phi)
    fu = c * fx + s * fy
    fv = -s * fx + c * fy
    return torch.exp(-(math.pi**2) * ((sigma1 * fu) ** 2 + (sigma2 * fv) ** 2))


def _pad(field):
    return F.pad(field, (0, _KERNEL_PAD, 0, _KERNEL_PAD))


def _conv_kernels(field, kernels_ft):
    """"Same" zero-padded convolution of (..., m, n) fields with every
    feature kernel: (..., F, m, n).  The zero margin holds each kernel's
    half-support, so the circular FFT convolution equals the zero-padded
    one."""
    m, n = field.shape[-2:]
    fpad = _pad(field)
    spec = torch.fft.rfft2(fpad)[..., None, :, :] * kernels_ft
    return torch.fft.irfft2(spec, s=fpad.shape[-2:])[..., :m, :n]


def _conv_mask_norm(kernels, mask):
    """Each kernel's convolution of the mask indicator (at least 1e-6):
    dividing by it makes pixels near the edges and the masked-out areas
    proper weighted means of the valid pixels."""
    return torch.clamp(_conv_kernels(mask.to(torch.float32), kernels), min=1e-6)


def _composite_convolution(field, kernels, weights, norm=None):
    """The localized convolution of (..., m, n) fields: every feature's
    kernel (renormalized by ``norm``), blended by the window weights."""
    out = _conv_kernels(field, kernels)
    if norm is not None:
        out = out / norm
    return torch.sum(out * weights, dim=-3)


def _f32(x, device):
    return torch.tensor(np.float32(x), device=device)


def _bias_correction(decay, count, device):
    """optax's ``1 - decay**count`` in float32: the power of the float32
    decay correctly rounded to float32 (XLA's float32 ``pow``)."""
    power = np.float32(np.float64(np.float32(decay)) ** count)
    return _f32(np.float32(1.0) - power, device)


def _adam_update(g, mu, nu, count, lr):
    """One step of ``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8, eps_root
    0) in float32, in optax's order of operations: (the update to add to
    the parameters, the new first moment, the new second moment) for the
    gradient ``g`` at step ``count`` (from 1)."""
    dev = g.device
    mu = _f32(1.0 - _ADAM_B1, dev) * g + _f32(_ADAM_B1, dev) * mu
    nu = _f32(1.0 - _ADAM_B2, dev) * (g * g) + _f32(_ADAM_B2, dev) * nu
    mu_hat = mu / _bias_correction(_ADAM_B1, count, dev)
    nu_hat = nu / _bias_correction(_ADAM_B2, count, dev)
    # the square root through float64: correctly rounded, as XLA's (the
    # CPU build of torch.sqrt misrounds a few float32 values)
    root = torch.sqrt(nu_hat.double()).float()
    update = _f32(-lr, dev) * (mu_hat / (root + _f32(_ADAM_EPS, dev)))
    return update, mu, nu


def _fit_loss(params, src_hat, mask_hat, dstm, wsel):
    """The fit's objective summed over the features: each feature's
    prediction of ``dstm`` (F, m, n) by its mask-renormalized "same"
    convolution of the source whose padded spectrum is ``src_hat``,
    squared errors weighted by ``wsel``."""
    m_, n_ = dstm.shape[-2:]
    pm, pn = m_ + _KERNEL_PAD, n_ + _KERNEL_PAD
    kf = _kernel_ft(params, pm, pn)
    pred = torch.fft.irfft2(kf * src_hat, s=(pm, pn))[..., :m_, :n_]
    norm = torch.fft.irfft2(kf * mask_hat, s=(pm, pn))[..., :m_, :n_]
    pred = pred / torch.clamp(norm, min=1e-6)
    return torch.sum(wsel * (pred - dstm) ** 2)


def _fit_kernels(src, dst, weights, mask, n_steps=150, lr=0.1):
    """Kernel spectra (F, pm, pn // 2 + 1) fitted by weighted least squares
    (the prediction of ``dst`` from ``src`` by each feature's
    mask-renormalized "same" convolution, over the mask where the weight
    exceeds 1e-3), from phi = 0, sigma1 = 1, ratio = 1, with ``n_steps``
    Adam steps of rate ``lr``.  The features' losses are independent, so
    the gradient of their sum is each feature's own.

    The kernel is isotropic at the start, so the first gradient in phi is
    0 but for rounding, and Adam turns its sign into a full step: the fit
    follows the rounding of the FFTs from there."""
    m_, n_ = src.shape
    maskf = mask.to(torch.float32)
    src_hat = torch.fft.rfft2(_pad(torch.where(mask, src, 0.0)))
    mask_hat = torch.fft.rfft2(_pad(maskf))
    dstm = torch.where(mask, dst, 0.0)
    wsel = weights * (weights > 1e-3) * maskf

    params = torch.zeros((weights.shape[0], 3), dtype=torch.float32, device=src.device)
    mu = torch.zeros_like(params)
    nu = torch.zeros_like(params)
    for count in range(1, n_steps + 1):
        p = params.requires_grad_(True)
        (g,) = torch.autograd.grad(_fit_loss(p, src_hat, mask_hat, dstm, wsel), p)
        with torch.no_grad():
            update, mu, nu = _adam_update(g, mu, nu, count, lr)
            params = p.detach() + update
    with torch.no_grad():
        return _kernel_ft(params, m_ + _KERNEL_PAD, n_ + _KERNEL_PAD)


def _fit_psi(src, dst, weights, mask):
    """Each feature's AR(1) coefficient by weighted least squares, clipped
    to [-0.98, 0.98]: (F,)."""
    wm = weights * mask.to(torch.float32)
    num = torch.sum(wm * src * dst, dim=(-2, -1))
    den = torch.clamp(torch.sum(wm * src * src, dim=(-2, -1)), min=1e-12)
    return torch.clamp(num / den, -0.98, 0.98)


def _fit_psi2(src1, src2, dst, weights, mask):
    """Each feature's AR(2) coefficients by weighted 2 x 2 least squares
    (``src1`` the lag-1 predictor, ``src2`` the lag-2 one), projected onto
    the stationarity polygon: (F, 2)."""
    wm = weights * mask.to(torch.float32)

    def wsum(x):
        return torch.sum(x, dim=(-2, -1))

    a11 = wsum(wm * src1 * src1)
    a12 = wsum(wm * src1 * src2)
    a22 = wsum(wm * src2 * src2)
    b1 = wsum(wm * src1 * dst)
    b2 = wsum(wm * src2 * dst)
    det = torch.clamp(a11 * a22 - a12 * a12, min=1e-12)
    psi1 = (a22 * b1 - a12 * b2) / det
    psi2 = (a11 * b2 - a12 * b1) / det
    # psi1 + psi2 <= 0.98, psi2 - psi1 <= 0.98, |psi1| <= 1.98, |psi2| <= 0.98
    psi2 = torch.clamp(psi2, -0.98, 0.98)
    psi1 = torch.minimum(
        torch.maximum(psi1, torch.clamp(psi2 - 0.98, min=-1.98)),
        torch.clamp(0.98 - psi2, max=1.98),
    )
    return torch.stack([psi1, psi2], dim=-1)


def _fit_lognorm_constrained(err, mask):
    """The shape s of a mean-one lognormal ``lognorm(s, loc=-s^2 / 2)`` by
    maximum likelihood over the masked error samples: (s, loc)."""
    from scipy import optimize, stats

    vals = err[mask]

    def negll(s):
        p = stats.lognorm.pdf(vals, s, -0.5 * s**2)
        p = np.where(p > 1e-300, p, 1e-300)
        return -np.sum(np.log(p))

    s_opt = optimize.minimize_scalar(negll, bounds=(1e-3, 20.0), method="Bounded").x
    return float(s_opt), float(-0.5 * s_opt**2)


def _weighted_err_std(f, w):
    """Weighted std of multiplicative errors around 1, omitting values
    within 1e-4 of 1."""
    mask = np.abs(f - 1.0) > 1e-4
    n_nz = np.count_nonzero(mask)
    if n_nz == 0:
        return np.nan
    c = (f[mask].size - 1.0) / n_nz
    return float(np.sqrt(np.sum(w[mask] * (f[mask] - 1.0) ** 2) / (c * np.sum(w[mask]))))


def _sample_acf(field):
    """The sample spatial ACF by the Wiener-Khinchin relation."""
    f = np.fft.rfft2((field - np.mean(field)) / np.std(field))
    return np.fft.irfft2(np.abs(f * np.conj(f)), s=field.shape) / field.size


def _acf_to_gaussian(r, s):
    """A lognormal-space correlation mapped to the Gaussian copula space:
    log(1 + r (e^{s^2} - 1)) / s^2."""
    e = np.expm1(s**2)
    return np.log(np.maximum(1.0 + r * e, 1e-6)) / max(s**2, 1e-12)


def _fit_parametric_acf(acf):
    """The anisotropic exponential ACF c exp(-|r'|) fitted to the sample
    estimate."""
    from scipy import optimize

    m, n = acf.shape
    x = np.fft.ifftshift(np.arange(-(n // 2), n - n // 2))
    y = np.fft.ifftshift(np.arange(-(m // 2), m - m // 2))
    gx, gy = np.meshgrid(x, y)

    def parametric(p):
        c, phi, sigma1, ratio = p
        sigma2 = ratio * sigma1
        phi_r = phi / 180.0 * np.pi
        u = (np.cos(phi_r) * gx + np.sin(phi_r) * gy) / sigma1
        v = (-np.sin(phi_r) * gx + np.cos(phi_r) * gy) / sigma2
        return c * np.exp(-np.sqrt(u * u + v * v))

    def resid(p):
        return (acf - parametric(p)).ravel()

    p_opt = optimize.least_squares(
        resid, np.array((1.0, 0.0, 1.0, 1.0)),
        bounds=((0.01, -np.inf, 0.1, 0.2), (10.0, np.inf, 10.0, 5.0)),
        method="trf", ftol=1e-6, xtol=1e-4, gtol=1e-6,
    )
    return parametric(p_opt.x)


def _tukey_feature_window(m, n, ci, cj, r, alpha=0.5):
    """A separable Tukey window centred on a feature."""
    j, i = np.meshgrid(np.arange(n), np.arange(m))
    out = np.ones((m, n))
    for d, rr in ((np.abs(i - ci), r), (np.abs(j - cj), r)):
        w = np.zeros((m, n))
        inside = d <= rr
        flat = d <= alpha * rr
        ramp = inside & ~flat
        w[ramp] = 0.5 * (1.0 + np.cos(np.pi * (d[ramp] - alpha * rr) / ((1.0 - alpha) * rr)))
        w[flat] = 1.0
        out *= w
    return out


def _estimate_error_model(err, feature_coords, shape, errdist_window_radius,
                          acf_window_radius, localization_window_radius, device=None):
    """Each feature's forecast-error marginal (constrained lognormal shape
    and location, std) and correlation structure (the amplitude spectrum
    of its fitted ACF), from multiplicative one-step hindcast errors
    ``err`` (NaN outside the validity mask); host numpy and scipy.
    Returns the dict of float32 tensors on ``device`` that
    :func:`_perturbations_from_white` takes."""
    m, n = shape
    n_feat = feature_coords.shape[0]
    mask_finite = np.isfinite(err)
    err = np.where(mask_finite, err, 1.0)

    weights_dist = _compute_window_weights(feature_coords, m, n, errdist_window_radius)

    s_list, loc_list, std_list, ampl_list = [], [], [], []
    for i in range(n_feat):
        if n_feat > 1:
            weights_acf = _tukey_feature_window(
                m, n, feature_coords[i, 0], feature_coords[i, 1], acf_window_radius,
            )
        else:
            weights_acf = np.ones((m, n))
        mask = mask_finite & (weights_dist[i] > 0.1)
        valid = np.sum(mask) > 10 and np.sum(np.abs(err[mask] - 1.0) >= 1e-3) > 10
        if valid:
            s, loc = _fit_lognorm_constrained(err, mask)
            mask_acf = weights_acf > 1e-4
            std = _weighted_err_std(err[mask_acf], weights_dist[i][mask_acf])
            valid = np.isfinite(std)
        if valid:
            acf = _acf_to_gaussian(_sample_acf(weights_acf * (err - 1.0) / std), s)
            acf = _fit_parametric_acf(acf)
            ampl = np.sqrt(np.abs(np.fft.rfft2(acf)))
        else:
            s, loc, std = 1e-10, 1e-10, 0.0
            ampl = np.full((m, n // 2 + 1), 1e-10)
        s_list.append(s)
        loc_list.append(loc)
        std_list.append(std)
        ampl_list.append(ampl)

    weights = _compute_window_weights(feature_coords, m, n, localization_window_radius)
    weights /= np.sum(weights, axis=0)
    device = resolve_device(device)
    return {
        key: torch.as_tensor(np.asarray(val, np.float32), device=device)
        for key, val in (("s", s_list), ("loc", loc_list), ("std", std_list),
                         ("ampl", np.stack(ampl_list)), ("weights", weights))
    }


def _degenerate_perturbations(shape, device):
    """The perturbation parameters of the deterministic mode."""
    m, n = shape
    return {
        "s": torch.zeros(1, device=device),
        "loc": torch.zeros(1, device=device),
        "std": torch.zeros(1, device=device),
        "ampl": torch.zeros((1, m, n // 2 + 1), device=device),
        "weights": torch.ones((1, m, n), device=device),
    }


def _member_white(generators, shape):
    """One white rfft2 half-plane spectrum (E, m, n // 2 + 1) a member,
    each from its member's generator."""
    return torch.cat([_spectral_white(g, shape, 1) for g in generators])


def _perturbations_from_white(white, pert_params, shape):
    """The multiplicative perturbation fields (E, m, n) of the white
    spectra ``white`` (E, m, n // 2 + 1): each feature's ACF amplitude
    filters the spectrum, the standardized Gaussian field maps to the
    feature's constrained lognormal, exp(s x) + loc, and the fields blend
    with the interpolation weights (a feature with std 0 gives 1)."""
    x = torch.fft.irfft2(pert_params["ampl"] * white[:, None], s=shape)  # (E, F, m, n)
    x = x / torch.clamp(torch.std(x, dim=(-2, -1), correction=0, keepdim=True), min=1e-12)
    s = pert_params["s"][:, None, None]
    loc = pert_params["loc"][:, None, None]
    pert = torch.exp(s * x) + loc
    pert = torch.where(pert_params["std"][:, None, None] > 0.0, pert, 1.0)
    return torch.sum(pert_params["weights"] * pert, dim=-3)


def _generate_error_perturbations(generators, pert_params, shape):
    """One perturbation field a member, from its generator's white draw."""
    return _perturbations_from_white(_member_white(generators, shape), pert_params, shape)


def _linda_scan(diff_window, forecast0, velocity, kernels_1, kernels_2, norm_1, norm_2,
                interp_weights, psi_field, mask_adv, member_generators, pert_params,
                int_steps, add_perturbations, E, shape, vel_pert=False, vp_coeffs=None,
                eps_par=None, eps_perp=None, V_n=None, V_perp=None, vsf=1.0,
                timestep_min=1.0):
    """The forecast loop over ``int_steps`` unit leads, the E members
    batched: (E, int_steps, m, n).  Each lead iterates the ARI on the
    differences, convolves the differences and the forecast, masks and
    (with ``add_perturbations``) perturbs the forecast, advances each
    member's displacement (by its BPS-perturbed velocity with
    ``vel_pert``) and warps the forecast to Eulerian coordinates by the
    exact bilinear gather."""
    m, n = shape
    maskf = mask_adv.to(torch.float32)
    p = psi_field.shape[0]
    diffs = diff_window.expand((E,) + tuple(diff_window.shape))
    fc = forecast0.expand(E, m, n)
    disp = torch.zeros((E, 2, m, n), dtype=torch.float32, device=forecast0.device)
    if vel_pert:
        eps_par = eps_par.reshape(E, 1, 1, 1)
        eps_perp = eps_perp.reshape(E, 1, 1, 1)
    outs = []
    for t in range(int_steps):
        t_total = (t + 1.0) * timestep_min
        # the ARI iterate with per-pixel psi maps: d_new = sum_i psi_i d[-(i+1)]
        d_new = torch.sum(psi_field * diffs[:, -p:].flip(1), dim=1)
        diffs = torch.cat([diffs[:, 1:], d_new[:, None]], dim=1)
        fc = fc + diffs[:, -1]
        # the IDE smoothing of the differences and the forecast, masked and
        # renormalized
        diffs = _composite_convolution(diffs * maskf, kernels_1, interp_weights, norm_1)
        fc = _composite_convolution(fc * maskf, kernels_2, interp_weights, norm_2)
        out = torch.where(mask_adv, torch.clamp(fc, min=0.0), float("nan"))
        if add_perturbations:
            out = out * _generate_error_perturbations(member_generators, pert_params, shape)
        if vel_pert:
            (a1, b1, c1), (a2, b2, c2) = vp_coeffs
            g_par = a1 * t_total**b1 + c1
            g_perp = a2 * t_total**b2 + c2
            vel = velocity + (eps_par * g_par * V_n + eps_perp * g_perp * V_perp) / vsf
        else:
            vel = velocity
        disp = integrate_displacement(vel, disp, 1.0)
        outs.append(warp(out, disp, order=1, cval=float("nan")))
    return torch.stack(outs, dim=1)


def _linda_init_core(precip, velocity, weights_j, interp_weights, ari_order, n_iter=1,
                     interp_order=1):
    """The initialization: Lagrangian alignment, the advection mask,
    differencing, both kernel fits and the ARI fit.  Returns (kernels_1,
    kernels_2, norm_1, norm_2, psi_field, diff_window, mask_adv,
    precip_lagr[-1], diff_c stack)."""
    precip_min = _nanmin(precip)
    precip_filled = torch.where(torch.isfinite(precip), precip, precip_min)
    precip_lagr = _lagrangian_alignment(
        precip_filled, velocity, n_iter=n_iter, interp_order=interp_order
    )

    # the advection mask: pixels advected in from outside the domain are
    # valid (dry); only pixels whose stencil touched an input NaN are
    # masked.  Each frame's finiteness indicator is advected along the
    # same displacement chain with cval=1.
    p1 = precip.shape[0]
    fin = torch.isfinite(precip).to(torch.float32)
    valid_frames = [fin[-1]]
    disp_v = torch.zeros_like(velocity)
    for k in range(1, p1):
        disp_v = integrate_displacement(velocity, disp_v, 1.0, n_iter=n_iter)
        valid_frames.append(
            model_warp(fin[p1 - 1 - k], disp_v, interp_order=interp_order, cval=1.0)
        )
    mask_adv = torch.all(torch.stack(valid_frames) > 0.999, dim=0)
    maskf = mask_adv.to(torch.float32)
    precip_lagr_diff = torch.diff(precip_lagr, dim=0) * maskf

    # kernel 1: the evolution of the differenced field
    kernels_1 = _fit_kernels(precip_lagr_diff[-2], precip_lagr_diff[-1], weights_j, mask_adv)
    norm_1 = _conv_mask_norm(kernels_1, mask_adv)

    def convolve(field, times):
        for _ in range(times):
            field = _composite_convolution(field * maskf, kernels_1, interp_weights, norm_1)
        return field

    # the older differences, convolved: the regression sources
    diff_c = [convolve(precip_lagr_diff[i], ari_order - i)
              for i in range(precip_lagr_diff.shape[0] - 1)]

    # the ARI parameters
    if ari_order == 1:
        psi_f = _fit_psi(diff_c[-1], precip_lagr_diff[-1], weights_j, mask_adv)
        psi_field = torch.sum(interp_weights * psi_f[:, None, None], dim=0)[None]
    else:
        psi_f = _fit_psi2(diff_c[-1], diff_c[-2], precip_lagr_diff[-1], weights_j, mask_adv)
        psi_field = torch.stack(
            [torch.sum(interp_weights * psi_f[:, i, None, None], dim=0) for i in range(2)]
        )

    # the first forecast step, then kernel 2
    p_ord = psi_field.shape[0]
    diff_stack = torch.stack(diff_c[-p_ord:])
    d_new = torch.sum(psi_field * diff_stack.flip(0), dim=0)
    precip_fct = torch.clamp(precip_lagr[-2] + d_new, min=0.0)
    kernels_2 = _fit_kernels(precip_fct, precip_filled[-1], weights_j, mask_adv)
    norm_2 = _conv_mask_norm(kernels_2, mask_adv)

    # the loop's AR window: the newest ari_order differences, entry j
    # convolved (ari_order - j) times
    win = [convolve(precip_lagr_diff[i], ari_order - (i - 1))
           for i in range(1, precip_lagr_diff.shape[0])]
    return (
        kernels_1, kernels_2, norm_1, norm_2, psi_field, torch.stack(win), mask_adv,
        precip_lagr[-1], torch.stack(diff_c),
    )


def _detect_features(precip_last, feature_method, max_num_features, feature_kwargs,
                     device):
    """The (F, 2) (y, x) feature coordinates of the last observation (one
    feature at the origin for "domain" or when none is found)."""
    if feature_method == "domain":
        return np.zeros((1, 2))
    det_field = np.where(np.isfinite(precip_last), precip_last, 0.0)
    if feature_method == "blob":
        coords_xy = blob.detection(
            det_field, max_num_features=max_num_features, device=device, **feature_kwargs
        )[:, :2]
    elif feature_method == "shitomasi":
        coords_xy = shitomasi.detection(
            det_field, max_num_features=max_num_features, device=device, **feature_kwargs
        )
    elif feature_method == "tstorm":
        # thunderstorm-cell centroids as features
        coords_xy = tstorm.detection(
            det_field, max_num_features=max_num_features, output_feat=True, **feature_kwargs
        )
    else:
        raise NotImplementedError(f"feature detector '{feature_method}'")
    if len(coords_xy) == 0:
        return np.zeros((1, 2))
    return np.fliplr(np.asarray(coords_xy)[:, :2])


def _member_generators(seed, n_members, device):
    """One generator a member, seeded from ``seed`` and the member's index."""
    gens = []
    for i in range(n_members):
        g = torch.Generator(device=device)
        g.manual_seed(int(np.random.SeedSequence([seed, i]).generate_state(1)[0]))
        gens.append(g)
    return gens


def forecast(
    precip,
    velocity,
    timesteps,
    feature_method="blob",
    max_num_features=25,
    feature_kwargs=None,
    ari_order=1,
    kernel_type="anisotropic",
    localization_window_radius=None,
    errdist_window_radius=None,
    acf_window_radius=None,
    extrap_method="semilagrangian",
    extrap_kwargs=None,
    add_perturbations=True,
    pert_thrs=(0.5, 1.0),
    n_ens_members=10,
    vel_pert_method="bps",
    vel_pert_kwargs=None,
    kmperpixel=None,
    timestep=None,
    seed=None,
    num_workers=1,
    use_multiprocessing=False,
    measure_time=False,
    callback=None,
    return_output=True,
    device=None,
):
    """LINDA nowcast with the JAX package's signature plus ``device``.

    ``precip``: (ari_order + 2, m, n) rain-rate fields.  Returns (T, m, n)
    in the deterministic mode (``add_perturbations=False``), else
    (n_ens_members, T, m, n), on ``device``: CUDA unless the caller asks
    for the CPU (or passes CPU tensors).  ``callback`` gets each lead's
    frames as host numpy arrays."""
    t0 = time.time()
    device = resolve_device(device, precip, velocity)
    precip = nowcast_utils.to_numpy(precip).astype(np.float32)
    if precip.ndim != 3 or precip.shape[0] < ari_order + 2:
        raise ValueError(f"precip must have >= ari_order+2 = {ari_order + 2} fields")
    if ari_order not in (1, 2):
        raise ValueError("ari_order must be 1 or 2")
    extrap_kwargs = dict(extrap_kwargs or {})
    feature_kwargs = dict(feature_kwargs or {})
    m, n = precip.shape[1:]
    if localization_window_radius is None:
        localization_window_radius = 0.2 * min(m, n)

    precip = precip[-(ari_order + 2):]
    precip_min = float(np.nanmin(precip))
    precip_filled = np.where(np.isfinite(precip), precip, precip_min)

    feature_coords = _detect_features(
        precip[-1], feature_method, max_num_features, feature_kwargs, device
    )
    print(f"Detected {feature_coords.shape[0]} features.")

    weights = _compute_window_weights(feature_coords, m, n, localization_window_radius)
    interp_weights = torch.as_tensor(
        (weights / weights.sum(axis=0, keepdims=True)).astype(np.float32), device=device
    )
    weights_j = torch.as_tensor(weights.astype(np.float32), device=device)

    velocity_t = torch.as_tensor(velocity, dtype=torch.float32, device=device)
    (
        kernels_1, kernels_2, norm_1, norm_2, psi_field, diff_window, mask_adv,
        precip_lagr_last, diff_c_stack,
    ) = _linda_init_core(
        torch.as_tensor(precip, device=device), velocity_t, weights_j, interp_weights,
        ari_order=ari_order, n_iter=extrap_kwargs.get("n_iter", 1),
        interp_order=extrap_kwargs.get("interp_order", 1),
    )

    # the perturbation parameters (probabilistic mode)
    if add_perturbations:
        if errdist_window_radius is None:
            errdist_window_radius = 0.15 * min(m, n)
        if acf_window_radius is None:
            acf_window_radius = 0.25 * min(m, n)
        # the one-step deterministic hindcast from the inputs but the last,
        # scored against the last observation
        hind = _linda_scan(
            diff_c_stack, torch.as_tensor(precip_filled[-2], device=device), velocity_t,
            kernels_1, kernels_2, norm_1, norm_2, interp_weights, psi_field, mask_adv,
            None, _degenerate_perturbations((m, n), device), 1, False, 1, (m, n),
        )
        fct = nowcast_utils.to_numpy(hind[0, 0])
        obs = precip_filled[-1]
        err = fct / np.where(obs != 0, obs, np.nan)
        err_mask = ((fct >= pert_thrs[1]) & (obs >= pert_thrs[0])) | (
            (fct >= pert_thrs[0]) & (obs >= pert_thrs[1])
        )
        err = np.where(err_mask, err, np.nan)
        pert_params = _estimate_error_model(
            err, feature_coords, (m, n), errdist_window_radius, acf_window_radius,
            localization_window_radius, device=device,
        )
        E = n_ens_members
    else:
        pert_params = _degenerate_perturbations((m, n), device)
        E = 1

    base_seed = seed if seed is not None else 42
    # BPS velocity perturbations: one Laplace draw a member along the flow
    # and one across it
    vel_pert = bool(add_perturbations) and vel_pert_method is not None
    vp_coeffs = None
    eps_par = eps_perp = V_n = V_perp = None
    vsf = 1.0
    if vel_pert:
        if kmperpixel is None or timestep is None:
            raise ValueError("vel_pert_method is set but kmperpixel or timestep is None")
        vpk = dict(vel_pert_kwargs or {})
        p_par = tuple(float(v) for v in vpk.get("vp_par", get_default_params_bps_par()))
        p_perp = tuple(float(v) for v in vpk.get("vp_perp", get_default_params_bps_perp()))
        vsf = 60.0 / (timestep * (1.0 / kmperpixel))
        gen = torch.Generator(device=device)
        gen.manual_seed(base_seed + 7)
        eps_par = _laplace(gen, (n_ens_members,))
        eps_perp = _laplace(gen, (n_ens_members,))
        Nv = torch.linalg.vector_norm(velocity_t, dim=0)
        V_n = torch.where(Nv[None] > 1e-12, velocity_t / torch.clamp(Nv[None], min=1e-12), 0.0)
        V_perp = torch.stack([-V_n[1], V_n[0]])
        vp_coeffs = (p_par, p_perp)

    generators = _member_generators(base_seed, E, device) if add_perturbations else None

    if isinstance(timesteps, int):
        int_steps = timesteps
        subsel = None
    else:
        subsel = list(timesteps)
        int_steps = int(np.ceil(max(subsel)))

    _sync(device)
    init_time = time.time() - t0
    t1 = time.time()
    out = _linda_scan(
        diff_window, precip_lagr_last, velocity_t, kernels_1, kernels_2, norm_1, norm_2,
        interp_weights, psi_field, mask_adv, generators, pert_params, int_steps,
        bool(add_perturbations), E, (m, n), vel_pert=vel_pert, vp_coeffs=vp_coeffs,
        eps_par=eps_par, eps_perp=eps_perp, V_n=V_n, V_perp=V_perp, vsf=vsf,
        timestep_min=float(timestep) if timestep else 1.0,
    )
    _sync(device)
    loop_time = time.time() - t1

    if subsel is not None:
        out = nowcast_utils.interpolate_leads(out, subsel, axis=1)
    if not add_perturbations:
        out = out[0]
    if callback is not None:
        arr = nowcast_utils.to_numpy(out)
        for t in range(arr.shape[0 if not add_perturbations else 1]):
            callback(arr[t] if not add_perturbations else arr[:, t])
    result = out if return_output else None
    if measure_time:
        return result, init_time, loop_time
    return result
