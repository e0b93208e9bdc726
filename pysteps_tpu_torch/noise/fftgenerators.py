"""Filtered-noise generators of the STEPS scan (counterpart of
``nonparam_filter_core``, ``_spectral_white``, ``_spectral_phase_white``
and the half-plane paths of ``_generate_fft_noise`` in
``pysteps_tpu/noise/fftgenerators.py``).

Draws come from an explicit ``torch.Generator`` and carry a leading batch
(member) axis.  They cannot reproduce the JAX package's threefry bits, so
tests that compare values hand the JAX draws over by replacing the draw
functions of this module.
"""

import math

import torch

from pysteps_tpu_torch.utils import spectral as spectral_utils


def nonparam_filter_core(fields, taper):
    """Nonparametric noise filter: |mean rfft2(tapered field)| over a
    (p, m, n) stack, after closing each field's rain/no-rain gap and
    zeroing its minimum.  Returns (m, n//2+1)."""
    zerovalue = fields.amin(dim=(-2, -1), keepdim=True)
    wet = fields > zerovalue
    inf = torch.tensor(float("inf"), dtype=fields.dtype, device=fields.device)
    shift = torch.where(wet, fields, inf).amin(dim=(-2, -1), keepdim=True) - zerovalue
    f = torch.where(wet, fields - shift, fields)
    f = f - f.amin(dim=(-2, -1), keepdim=True)
    return torch.abs(torch.fft.rfft2(f * taper).mean(dim=0))


def _hermitianize(col):
    """Impose W[ky] = conj(W[-ky]) on a (..., m) spectral column, keeping
    the per-bin variance."""
    rev = torch.roll(torch.flip(col, dims=(-1,)), 1, dims=-1)
    return (col + torch.conj(rev)) / math.sqrt(2.0)


def _spectral_white(generator, input_shape, batch):
    """rfft2 of white N(0, 1) noise drawn directly in the half-plane:
    (batch, m, n//2+1) complex64."""
    m, n = input_shape
    rf = n // 2 + 1
    z = torch.randn(
        (batch, m, rf, 2), generator=generator, device=generator.device
    ) * math.sqrt(m * n / 2.0)
    W = torch.complex(z[..., 0], z[..., 1])
    W[..., :, 0] = _hermitianize(W[..., :, 0])
    if n % 2 == 0:
        W[..., :, -1] = _hermitianize(W[..., :, -1])
    return W


def _spectral_phase_white(generator, input_shape, batch):
    """Unit-modulus random-phase half-plane spectrum (the spectral-domain
    draw), (batch, m, n//2+1) complex64; the kx=0 column's phases are
    antisymmetric in ky."""
    m, n = input_shape
    rf = n // 2 + 1
    theta = torch.rand(
        (batch, m, rf), generator=generator, device=generator.device
    ) * (2.0 * math.pi)
    hi = m // 2 if m % 2 == 0 else m // 2 + 1
    theta[:, m // 2 + 1 :, 0] = -torch.flip(theta[:, 1:hi, 0], dims=(-1,))
    return torch.polar(torch.ones_like(theta), theta)


def _generate_fft_noise(
    generator, filt, input_shape, batch, domain="spatial", standardize=True
):
    """White noise -> half-plane filter ``filt`` (m, n//2+1) -> noise.

    ``domain="spatial"`` returns (batch, m, n) fields, ``"spectral"`` their
    rfft2 half-planes with the DC bin zeroed.  ``standardize=False`` skips
    the final standardization, which a normalized cascade decomposition of
    the noise cancels anyway."""
    if domain == "spectral":
        fN = _spectral_phase_white(generator, input_shape, batch) * filt
        fN[..., 0, 0] = 0.0
        if not standardize:
            return fN
        return fN / spectral_utils.std(fN, input_shape)[..., None, None]
    if domain != "spatial":
        raise ValueError(f"invalid domain {domain}")
    fN = _spectral_white(generator, input_shape, batch) * filt
    N = torch.fft.irfft2(fN, s=tuple(input_shape))
    if not standardize:
        return N
    mu = N.mean(dim=(-2, -1), keepdim=True)
    sd = N.std(dim=(-2, -1), keepdim=True, correction=0)
    return (N - mu) / sd
