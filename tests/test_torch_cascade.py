"""Bandpass filters and FFT cascade decomposition/recomposition of the
PyTorch port against the JAX package, spatial and spectral, on a square
and a non-square grid with an odd width.  Tolerance: 1e-4 x max|ref|
(f32 FFTs of two libraries round differently)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pysteps_tpu import cascade as jcascade
from pysteps_tpu.cascade import decomposition as jdec
from pysteps_tpu_torch import cascade as tcascade
from pysteps_tpu_torch.cascade import decomposition as tdec


def _close(ref, out):
    ref = np.asarray(ref)
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert ref.shape == out.shape
    scale = max(float(np.abs(ref).max()), 1e-12)
    assert np.abs(out - ref).max() <= 1e-4 * scale


SHAPES = [(64, 64), (48, 81)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ["gaussian", "uniform"])
def test_filters(shape, name):
    k = 6 if name == "gaussian" else 1
    ref = jcascade.get_method(name)(shape, k)
    out = tcascade.get_method(name)(shape, k)
    _close(ref["weights_2d"], np.asarray(out["weights_2d"]))
    _close(ref["weights_1d"], np.asarray(out["weights_1d"]))
    with pytest.raises(ValueError):
        tcascade.get_method("nope")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("masked", [False, True])
def test_decompose_recompose_spatial(shape, masked):
    rng = np.random.default_rng(1)
    fields = rng.normal(0.0, 4.0, (2,) + shape).astype(np.float32)
    w = np.array(jcascade.get_method("gaussian")(shape, 6)["weights_2d"], np.float32)
    mask = fields[0] > -1.0 if masked else None
    lv_t, mu_t, sd_t = tdec.decompose_core(
        torch.from_numpy(fields), torch.from_numpy(w),
        mask=None if mask is None else torch.from_numpy(mask),
    )
    rec_t = tdec.recompose_core(lv_t, mu_t, sd_t)
    for b in range(2):
        lv, mu, sd = jdec.decompose_core(
            jnp.asarray(fields[b]), jnp.asarray(w),
            mask=None if mask is None else jnp.asarray(mask),
        )
        _close(lv, lv_t[b])
        _close(mu, mu_t[b])
        _close(sd, sd_t[b])
        _close(jdec.recompose_core(lv, mu, sd), rec_t[b])


@pytest.mark.parametrize("shape", SHAPES)
def test_decompose_recompose_spectral(shape):
    rng = np.random.default_rng(2)
    fields = rng.normal(0.0, 4.0, (2,) + shape).astype(np.float32)
    w = np.array(jcascade.get_method("gaussian")(shape, 6)["weights_2d"], np.float32)
    F_t = torch.fft.rfft2(torch.from_numpy(fields))
    lv_t, mu_t, sd_t = tdec.decompose_spectral_core(F_t, torch.from_numpy(w), shape)
    rec_t = tdec.recompose_spectral_core(lv_t, mu_t, sd_t, shape)
    for b in range(2):
        F = jnp.fft.rfft2(jnp.asarray(fields[b]))
        lv, mu, sd = jdec.decompose_spectral_core(F, jnp.asarray(w), shape)
        _close(lv, lv_t[b])
        _close(mu, mu_t[b])
        _close(sd, sd_t[b])
        _close(jdec.recompose_spectral_core(lv, mu, sd, shape), rec_t[b])
