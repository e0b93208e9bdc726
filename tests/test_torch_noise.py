"""Noise of the PyTorch port against the JAX package: the nonparametric
filter (rtol 1e-4, f32 FFTs), the filtered-noise generator in both domains
with the JAX draws handed to the port (1e-4 x max|ref|), and the laws of
the port's own draws (their bits cannot match threefry's)."""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pysteps_tpu.noise import fftgenerators as jfft
from pysteps_tpu_torch.noise import fftgenerators as tfft
from pysteps_tpu_torch.noise import motion as tmotion
from pysteps_tpu_torch.utils import tapering


def _filter(shape):
    rng = np.random.default_rng(0)
    fields = np.maximum(rng.gamma(1.5, 3.0, (3,) + shape) - 2.0, 0.0).astype(np.float32)
    taper = tapering.compute_window_function(*shape, "tukey").astype(np.float32)
    return fields, taper


@pytest.mark.parametrize("shape", [(64, 64), (48, 81)])
def test_nonparam_filter_core(shape):
    fields, taper = _filter(shape)
    ref = np.asarray(jfft.nonparam_filter_core(jnp.asarray(fields), jnp.asarray(taper)))
    out = tfft.nonparam_filter_core(torch.from_numpy(fields), torch.from_numpy(taper)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("domain", ["spectral", "spatial"])
@pytest.mark.parametrize("standardize", [False, True])
def test_generate_fft_noise_with_jax_draws(monkeypatch, domain, standardize):
    shape = (64, 80)
    fields, taper = _filter(shape)
    filt = np.array(jfft.nonparam_filter_core(jnp.asarray(fields), jnp.asarray(taper)))
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    draw = jfft._spectral_phase_white if domain == "spectral" else jfft._spectral_white
    white = np.stack([np.asarray(draw(k, shape)) for k in keys])
    name = "_spectral_phase_white" if domain == "spectral" else "_spectral_white"
    monkeypatch.setattr(tfft, name, lambda gen, shp, batch: torch.from_numpy(white))
    out = tfft._generate_fft_noise(
        None, torch.from_numpy(filt), shape, 2, domain=domain, standardize=standardize
    ).numpy()
    for b in range(2):
        ref = np.asarray(jfft._generate_fft_noise(
            keys[b], jnp.asarray(filt), shape, False, domain=domain,
            standardize=standardize,
        ))
        assert np.abs(out[b] - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("m", [16, 17])
def test_port_draws_are_hermitian(m):
    gen = torch.Generator().manual_seed(1)
    shape = (m, 20)
    theta = torch.angle(tfft._spectral_phase_white(gen, shape, 3))
    np.testing.assert_allclose(
        tfft._spectral_phase_white(gen, shape, 3).abs().numpy(), 1.0, atol=1e-6
    )
    col = theta[:, :, 0].numpy()
    for ky in range(m // 2 + 1, m):
        np.testing.assert_allclose(np.cos(col[:, ky]), np.cos(-col[:, m - ky]), atol=1e-5)
        np.testing.assert_allclose(np.sin(col[:, ky]), np.sin(-col[:, m - ky]), atol=1e-5)
    W = tfft._spectral_white(gen, shape, 2)
    for c in (0, -1):
        colw = W[:, :, c]
        rev = torch.roll(torch.flip(colw, dims=(-1,)), 1, dims=-1)
        np.testing.assert_allclose(colw.numpy(), torch.conj(rev).resolve_conj().numpy(), atol=1e-4)
    # spatial noise from the port's own draw: zero mean, unit std
    N = tfft._generate_fft_noise(gen, torch.ones(m, 11), shape, 4, domain="spatial")
    np.testing.assert_allclose(N.mean(dim=(-2, -1)).numpy(), 0.0, atol=1e-5)
    np.testing.assert_allclose(N.std(dim=(-2, -1), correction=0).numpy(), 1.0, atol=1e-4)


def test_laplace_law():
    """The BPS draws follow Laplace(scale = 1/sqrt(2)): Kolmogorov-Smirnov
    distance below the 0.1% critical value, and the first moments."""
    n = 20000
    x = tmotion._laplace(torch.Generator().manual_seed(7), (n,)).double().numpy()
    b = 1.0 / math.sqrt(2.0)
    xs = np.sort(x)
    cdf = np.where(xs < 0, 0.5 * np.exp(xs / b), 1.0 - 0.5 * np.exp(-xs / b))
    ecdf_hi = np.arange(1, n + 1) / n
    ks = max(np.abs(ecdf_hi - cdf).max(), np.abs(ecdf_hi - 1.0 / n - cdf).max())
    assert ks < 1.95 / math.sqrt(n)
    assert abs(x.mean()) < 4.0 / math.sqrt(n)
    assert abs(x.var() - 1.0) < 0.05
    assert abs(np.abs(x).mean() - b) < 0.02
