"""
RainFARM stochastic downscaling (counterpart of
``pysteps_tpu/downscaling/rainfarm.py``; reference:
pysteps/downscaling/rainfarm.py; Rebora et al. 2006, D'Onofrio et al.
2014).

The slope fit and the frequency grids are numpy on the host, as in the
JAX package; the noise synthesis, spectral fusion, kernel smoothing and
aggregate conservation run on the input's device (the card unless the
caller passes ``device="cpu"``), every member of an ensemble in one
batched pass.  Randomness comes from one explicit ``torch.Generator``
(the JAX package splits a ``PRNGKey``); the draws are
:func:`_normal_white` and :func:`_uniform_white`, which tests replace
with the JAX package's.  The kernel average is a correlation through
``ops/conv.py`` in IEEE float32.
"""

import math

import numpy as np
import torch

from pysteps_tpu_torch._device import resolve_device
from pysteps_tpu_torch.ops.conv import corr_same
from pysteps_tpu_torch.utils.dimension import aggregate_fields
from pysteps_tpu_torch.utils.spectral import rapsd


def _normal_white(generator, shape):
    """N(0, 1) draws for the rank-order gaussianization."""
    return torch.randn(shape, generator=generator, device=generator.device)


def _uniform_white(generator, shape):
    """U[0, 1) draws for the noise phases: (members, M, N)."""
    return torch.rand(shape, generator=generator, device=generator.device)


def _gaussianize(precip, generator):
    """Rank-order gaussianization (reference: rainfarm.py:28): the sorted
    normal draws placed in the (stable) rank order of ``precip``."""
    flat = precip.reshape(-1)
    order = torch.argsort(flat, stable=True)
    normal_sorted = torch.sort(_normal_white(generator, flat.shape)).values
    out = torch.empty_like(flat).scatter_(0, order, normal_sorted).reshape(precip.shape)
    sd = out.std(unbiased=False)
    return out / torch.where(sd == 0, 1.0, sd)


def _compute_freq_array(array, ds_factor=1):
    freq_i = np.fft.fftfreq(array.shape[0] * ds_factor, d=1 / ds_factor)
    freq_j = np.fft.fftfreq(array.shape[1] * ds_factor, d=1 / ds_factor)
    return np.sqrt(freq_i[:, None] ** 2 + freq_j[None, :] ** 2)


def _log_slope(log_k, log_power_spectrum):
    """Mid-range log-log slope fit (reference: rainfarm.py:54)."""
    lk_min, lk_max = log_k.min(), log_k.max()
    lk_range = lk_max - lk_min
    sel = (lk_min + lk_range / 6 <= log_k) & (log_k <= lk_max - lk_range / 6)
    return -np.polyfit(log_k[sel], log_power_spectrum[sel], 1)[0]


def _estimate_alpha(array, k):
    """Spectral-slope estimate (reference: rainfarm.py:72), on the host."""
    fp_abs = np.abs(np.fft.fft2(np.asarray(array)))
    with np.errstate(divide="ignore"):
        log_ps = np.log(fp_abs**2)
    valid = (k != 0) & np.isfinite(log_ps)
    return _log_slope(np.log(k[valid]), log_ps[valid])


def _compute_noise_field(freq_array_highres, alpha, white):
    """Power-law phase noise of each member's uniform draw ``white``
    (B, M, N) (reference: rainfarm.py:84)."""
    phases = torch.exp(1j * 2 * math.pi * white)
    k = torch.as_tensor(freq_array_highres, dtype=torch.float32, device=white.device)
    amp = torch.where(k > 0, k ** (-alpha / 2.0), 0.0)
    field = phases * amp
    field[..., 0, 0] = 0.0
    return torch.fft.ifft2(field).real


def _apply_spectral_fusion(array_low, array_high, freq_array_low, freq_array_high, ds_factor):
    """Merge the low-resolution field (m, m) with each member's
    high-resolution noise (B, M, M) in the frequency domain
    (reference: rainfarm.py:100; D'Onofrio et al. 2014)."""
    nax = array_low.shape[-1]
    nx = array_high.shape[-1]
    k0 = nax // 2
    dev = array_high.device

    psd_low = rapsd(array_low)[k0 - 1] * nax**2
    psd_high = torch.stack([rapsd(a)[k0 - 1] for a in array_high]) * nx**2
    array_high = array_high * torch.sqrt(psd_low / torch.clamp(psd_high, min=1e-30))[:, None, None]

    fft_low = torch.fft.fft2(array_low)
    fft_high = torch.fft.fft2(array_high)

    merged = torch.zeros((nx, nx), dtype=fft_high.dtype, device=dev)
    merged[0:k0, 0:k0] = fft_low[0:k0, 0:k0]
    merged[nx - k0 : nx, 0:k0] = fft_low[k0 : 2 * k0, 0:k0]
    merged[0:k0, nx - k0 : nx] = fft_low[0:k0, k0 : 2 * k0]
    merged[nx - k0 : nx, nx - k0 : nx] = fft_low[k0 : 2 * k0, k0 : 2 * k0]
    merged[k0, 0] = torch.conj(merged[nx - k0, 0])
    merged[0, k0] = torch.conj(merged[0, nx - k0])

    freq_i = np.tile(np.fft.fftfreq(nx, d=1 / ds_factor), (nx, 1))
    freq_j = freq_i.T
    ddx = np.pi * (1 / nax - 1 / nx) / np.abs(freq_i[0, 1] - freq_i[0, 0])

    mask_high = torch.as_tensor(freq_array_high**2 > freq_array_low[k0, k0] ** 2, device=dev)
    fi = torch.as_tensor(freq_i, dtype=torch.float32, device=dev)
    fj = torch.as_tensor(freq_j, dtype=torch.float32, device=dev)
    phase = torch.exp(-1j * ddx * fi - 1j * ddx * fj)
    merged = fft_high * mask_high + merged * ~mask_high * phase
    return torch.fft.ifft2(merged).real / (nx * nx)


def _compute_kernel_radius(ds_factor):
    return int(round(ds_factor / np.sqrt(np.pi)))


def _make_tophat_kernel(ds_factor):
    radius = _compute_kernel_radius(ds_factor)
    mx, my = np.mgrid[-radius : radius + 0.01, -radius : radius + 0.01]
    tophat = ((mx**2 + my**2) <= radius**2).astype(float)
    return tophat / tophat.sum()


def _make_gaussian_kernel(ds_factor):
    radius = _compute_kernel_radius(ds_factor)
    sigma2 = (ds_factor / 2) ** 2
    x = np.arange(-radius, radius + 1)
    k1 = np.exp(-0.5 / sigma2 * x**2)
    k2 = np.outer(k1, k1)
    return k2 / k2.sum()


_make_kernel = {
    "gaussian": _make_gaussian_kernel,
    "tophat": _make_tophat_kernel,
    "uniform": _make_tophat_kernel,
}


def _balanced_spatial_average(array, kernel):
    """NaN-aware kernel average of (..., M, N) fields (reference:
    rainfarm.py:192): "same" correlations in IEEE float32."""
    valid = torch.isfinite(array)
    filled = torch.where(valid, array, 0.0)
    k = torch.as_tensor(kernel, dtype=torch.float32, device=array.device)
    conv = corr_same(filled, k)
    norm = corr_same(valid.to(torch.float32), k)
    out = conv / torch.clamp(norm, min=1e-12)
    return torch.where(valid, out, float("nan"))


def _downscale_core(
    precip, precip_transformed, alpha, white, threshold,
    ds_factor, kernel_type, spectral_fusion, use_threshold,
):
    """Noise synthesis, optional spectral fusion, kernel smoothing and
    coarse-aggregate conservation of each member's draw ``white``
    (B, m ds, n ds); returns (B, m ds, n ds)."""
    m, n = precip.shape
    freq_array = _compute_freq_array(np.empty((m, n)))
    freq_array_highres = _compute_freq_array(np.empty((m, n)), ds_factor)

    noise_field = _compute_noise_field(freq_array_highres, alpha, white)

    if spectral_fusion:
        noise_field = noise_field / noise_field.shape[-2] ** 2
        noise_field = torch.exp(noise_field)
        noise_field = _apply_spectral_fusion(
            precip_transformed, noise_field, freq_array, freq_array_highres, ds_factor,
        )

    noise_field = noise_field / noise_field.std(dim=(-2, -1), unbiased=False, keepdim=True)
    noise_field = torch.exp(noise_field)

    noise_lowres = aggregate_fields(noise_field, ds_factor, axis=(-2, -1))

    def expand(x):
        return x.repeat_interleave(ds_factor, dim=-2).repeat_interleave(ds_factor, dim=-1)

    precip_expanded = expand(precip)
    noise_lowres_expanded = expand(noise_lowres)

    if kernel_type:
        kernel = _make_kernel[kernel_type](ds_factor)
        precip_expanded = _balanced_spatial_average(precip_expanded, kernel)
        noise_lowres_expanded = _balanced_spatial_average(noise_lowres_expanded, kernel)

    norm_k0 = precip_expanded / torch.clamp(noise_lowres_expanded, min=1e-12)
    precip_highres = noise_field * norm_k0

    if use_threshold:
        precip_highres = torch.where(precip_highres < threshold, 0.0, precip_highres)
    return precip_highres


def _prepare(precip, ds_factor, kernel_type, spectral_fusion, seed, key, device):
    """Checks, the host and device copies of ``precip``, the generator and
    the transformed field of the fusion."""
    if isinstance(precip, torch.Tensor):
        device = precip.device if device is None else device
        precip = precip.detach().cpu().numpy()
    precip = np.asarray(precip, np.float64)
    if not np.isfinite(precip).all():
        raise ValueError("All values in 'precip' must be finite.")
    if not isinstance(ds_factor, int) or ds_factor <= 0:
        raise ValueError("'ds_factor' must be a positive integer.")
    if kernel_type and kernel_type not in _make_kernel:
        raise ValueError(
            f"kernel type '{kernel_type}' is invalid, available: {list(_make_kernel)}"
        )
    if key is None:
        key = torch.Generator(device=resolve_device(device))
        key.manual_seed(seed if seed is not None else 0)
    precip_t = torch.as_tensor(precip, dtype=torch.float32, device=key.device)
    precip_transformed = _gaussianize(precip_t, key) if spectral_fusion else precip_t
    return precip, precip_t, precip_transformed, key


def _alpha(alpha, precip, precip_transformed, spectral_fusion):
    """The given slope, or its host fit (on the gaussianized field when
    the fusion is on)."""
    if alpha is not None:
        return alpha
    return _estimate_alpha(
        precip_transformed.cpu().numpy() if spectral_fusion else precip,
        _compute_freq_array(precip),
    )


def _run(precip_t, precip_transformed, alpha, key, n_members, threshold, ds_factor,
         kernel_type, spectral_fusion):
    m, n = precip_t.shape
    white = _uniform_white(key, (n_members, m * ds_factor, n * ds_factor))
    return _downscale_core(
        precip_t, precip_transformed, float(np.float32(alpha)), white,
        float(np.float32(threshold if threshold is not None else 0.0)),
        ds_factor=ds_factor, kernel_type=kernel_type,
        spectral_fusion=bool(spectral_fusion), use_threshold=threshold is not None,
    )


def downscale(
    precip,
    ds_factor,
    alpha=None,
    threshold=None,
    return_alpha=False,
    kernel_type=None,
    spectral_fusion=False,
    seed=None,
    key=None,
    device=None,
):
    """RainFARM spatial downscaling by ``ds_factor``
    (reference: rainfarm.py:212).  Returns an (m ds, n ds) tensor on
    ``device`` (the card unless the caller asks for the CPU, or the
    device of ``key``, a ``torch.Generator``, when given)."""
    precip, precip_t, precip_transformed, key = _prepare(
        precip, ds_factor, kernel_type, spectral_fusion, seed, key, device
    )
    alpha = _alpha(alpha, precip, precip_transformed, spectral_fusion)
    out = _run(precip_t, precip_transformed, alpha, key, 1, threshold, ds_factor,
               kernel_type, spectral_fusion)[0]
    if return_alpha:
        return out, alpha
    return out


def downscale_ensemble(
    precip,
    ds_factor,
    n_members,
    alpha=None,
    threshold=None,
    kernel_type=None,
    spectral_fusion=False,
    seed=None,
    device=None,
):
    """Batched RainFARM: ``n_members`` independent realizations in one
    batched pass over the members (the JAX package vmaps them).
    Returns (n_members, m ds, n ds)."""
    precip, precip_t, precip_transformed, key = _prepare(
        precip, ds_factor, kernel_type, spectral_fusion, seed, None, device
    )
    alpha = _alpha(alpha, precip, precip_transformed, spectral_fusion)
    return _run(precip_t, precip_transformed, alpha, key, n_members, threshold,
                ds_factor, kernel_type, spectral_fusion)
