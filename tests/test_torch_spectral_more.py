"""The rest of the PyTorch port's ``utils`` against the JAX package on the
same numpy inputs: ``rapsd`` (the port sums its radial bins with a
float32 ``scatter_add_``, the JAX package by segment, in another order),
``corrcoef``, ``remove_rain_norain_discontinuity``, ``std`` of full fft2
planes, the centred coordinates, the masked Tukey window and
``check_previous_radar_obs``.  Tolerance: rtol 1e-4 (with 1e-4 x max|ref|
absolute), exact for the host-side numpy functions."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pysteps_tpu.utils import arrays as jarrays
from pysteps_tpu.utils import check_norain as jnorain
from pysteps_tpu.utils import spectral as jspec
from pysteps_tpu.utils import tapering as jtaper
from pysteps_tpu_torch.utils import arrays as tarrays
from pysteps_tpu_torch.utils import check_norain as tnorain
from pysteps_tpu_torch.utils import spectral as tspec
from pysteps_tpu_torch.utils import tapering as ttaper


def _field(shape, seed=0):
    rng = np.random.default_rng(seed)
    return np.maximum(rng.gamma(1.2, 2.0, shape) - 1.5, 0.0).astype(np.float32)


def _close(ref, out, rtol=1e-4):
    ref = np.asarray(ref, np.float64)
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert ref.shape == out.shape
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=rtol * float(np.abs(ref).max()))


@pytest.mark.parametrize("shape", [(64, 64), (63, 80), (96, 71)])
@pytest.mark.parametrize("normalize", [False, True])
def test_rapsd(shape, normalize):
    f = _field(shape)
    ref, fr = jspec.rapsd(jnp.asarray(f), normalize=normalize, return_freq=True, d=0.5)
    out, ft = tspec.rapsd(torch.from_numpy(f), normalize=normalize, return_freq=True, d=0.5)
    _close(ref, out)
    _close(fr, ft, rtol=1e-7)
    # a centred PSD given directly (fft_method=None)
    psd = np.abs(np.fft.fftshift(np.fft.fft2(f))).astype(np.float32) ** 2
    _close(jspec.rapsd(jnp.asarray(psd), fft_method=None),
           tspec.rapsd(torch.from_numpy(psd), fft_method=None))


@pytest.mark.parametrize("shape", [(64, 64), (48, 81)])
@pytest.mark.parametrize("full", [False, True])
def test_corrcoef_and_std(shape, full):
    a = _field(shape, 1)
    b = 0.6 * a + _field(shape, 2)
    fft = np.fft.fft2 if full else np.fft.rfft2
    A = np.stack([fft(a), fft(b)]).astype(np.complex64)
    B = np.stack([fft(b), fft(a + 1)]).astype(np.complex64)
    ref = jspec.corrcoef(jnp.asarray(A), jnp.asarray(B), shape, use_full_fft=full)
    out = tspec.corrcoef(torch.from_numpy(A), torch.from_numpy(B), shape, use_full_fft=full)
    _close(ref, out)
    np.testing.assert_allclose(out[0].item(), np.corrcoef(a.ravel(), b.ravel())[0, 1], rtol=1e-4)
    ref = jspec.std(jnp.asarray(A), shape, use_full_fft=full)
    out = tspec.std(torch.from_numpy(A), shape, use_full_fft=full)
    _close(ref, out)
    np.testing.assert_allclose(out[0].item(), a.std(), rtol=1e-4)


@pytest.mark.parametrize("nan", [False, True])
def test_remove_rain_norain_discontinuity(nan):
    f = 10 * np.log10(np.maximum(_field((64, 64), 3), 0.1)).astype(np.float32)
    if nan:
        f[:4] = np.nan
    ref = np.asarray(jspec.remove_rain_norain_discontinuity(jnp.asarray(f)))
    out = tspec.remove_rain_norain_discontinuity(torch.from_numpy(f)).numpy()
    assert np.array_equal(np.isnan(ref), np.isnan(out))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4 * np.nanmax(np.abs(ref)))


@pytest.mark.parametrize("M, N", [(4, 4), (5, 6), (7, 3)])
def test_centred_coord_array(M, N):
    for r, o in zip(jarrays.compute_centred_coord_array(M, N),
                    tarrays.compute_centred_coord_array(M, N)):
        np.testing.assert_array_equal(r, o)


def test_mask_window_function():
    mask = np.zeros((64, 80), bool)
    mask[5:60, 10:70] = True
    mask[20:30, 20:30] = False
    ref = jtaper.compute_mask_window_function(mask, "tukey", r_max=7.0)
    out = ttaper.compute_mask_window_function(mask, "tukey", r_max=7.0)
    np.testing.assert_array_equal(np.isnan(ref), np.isnan(out))
    np.testing.assert_array_equal(np.nan_to_num(ref), np.nan_to_num(out))
    with pytest.raises(NotImplementedError):
        ttaper.compute_mask_window_function(mask, "hann")
    with pytest.raises(ValueError):
        ttaper.compute_mask_window_function(mask, "bartlett")


@pytest.mark.parametrize("dry", [(), (0,), (0, 1), (2,), (1, 3), (3,)])
def test_check_previous_radar_obs(dry):
    precip = np.stack([_field((32, 32), s) for s in range(4)])
    for i in dry:
        precip[i] = 0.0
    kw = {"precip_thr": 0.1}
    ref, p_ref = jnorain.check_previous_radar_obs(precip, 3, kw)
    out, p_out = tnorain.check_previous_radar_obs(torch.from_numpy(precip), 3, kw)
    assert p_ref == p_out
    np.testing.assert_array_equal(ref, out)
    with pytest.raises(ValueError):
        tnorain.check_previous_radar_obs(precip[:1], 1)
