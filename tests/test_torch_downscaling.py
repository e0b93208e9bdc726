"""RainFARM in the PyTorch port against the JAX package on the CPU.

- the JAX package's own cases (tests/test_downscaling.py: shape per
  ds_factor and kernel, conservation of the coarse aggregates, the slope
  estimate, the batched ensemble) on the port;
- the deterministic parts value by value with JAX's draws handed in: the
  frequency arrays and both kernels exactly, the slope alpha within 1e-12
  (numpy on the host in both), the gaussianization, the phase noise, the
  spectral fusion and the balanced average within 1e-5 of the field's
  largest value (float32 FFTs and convolutions of two libraries), and the
  whole downscaling core with and without a kernel within 1e-4 of it (an
  exponential of the noise amplifies its rounding);
- the whole downscaling in law, with and without the spectral fusion: 16
  realizations each, the quantiles of the multiplier (output over the
  expanded input) within 5%, the realizations' spread within 10%.  With
  the fusion the core is held in law only: it fuses ``exp(noise / N^2)``,
  a field within 1e-6 of 1 whose float32 spectrum off the DC bin is at
  the FFT's rounding in both packages (58% apart at 256^2).
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from helpers import make_synthetic_sequence  # noqa: E402

from pysteps_tpu.downscaling import rainfarm as jrf  # noqa: E402
from pysteps_tpu_torch import downscaling  # noqa: E402
from pysteps_tpu_torch.downscaling import rainfarm  # noqa: E402
from pysteps_tpu_torch.utils.dimension import aggregate_fields  # noqa: E402


@pytest.fixture(scope="module")
def precip_lr():
    frames = make_synthetic_sequence(n_frames=1, shape=(64, 64), seed=3)
    return np.asarray(frames[0], np.float64)


def _rel_close(port, ref, rel):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    np.testing.assert_allclose(port, ref, rtol=0, atol=rel * float(np.nanmax(np.abs(ref))))


ARGS = "alpha,ds_factor,threshold,spectral_fusion,kernel_type"


@pytest.mark.parametrize(ARGS, [
    (1.0, 1, 0, False, None),
    (1, 2, 0, False, "gaussian"),
    (1, 4, 0, False, "tophat"),
    (1, 4, 0, True, "uniform"),
])
def test_rainfarm_shape(precip_lr, alpha, ds_factor, threshold, spectral_fusion, kernel_type):
    out = downscaling.get_method("rainfarm")(
        precip_lr, alpha=alpha, ds_factor=ds_factor, threshold=threshold,
        spectral_fusion=spectral_fusion, kernel_type=kernel_type, seed=4, device="cpu",
    )
    assert out.shape == (precip_lr.shape[0] * ds_factor, precip_lr.shape[1] * ds_factor)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize(ARGS, [
    (1.0, 1, 0, False, None),
    (1, 2, 0, False, None),
    (1, 4, 0, False, None),
    (1, 4, 0, True, None),
])
def test_rainfarm_aggregate(precip_lr, alpha, ds_factor, threshold, spectral_fusion,
                            kernel_type):
    """The JAX package's bound (tests/test_downscaling.py:68-73)."""
    out = downscaling.get_method("rainfarm")(
        precip_lr, alpha=alpha, ds_factor=ds_factor, threshold=threshold,
        spectral_fusion=spectral_fusion, kernel_type=kernel_type, seed=4, device="cpu",
    )
    agg = aggregate_fields(out, ds_factor, axis=(0, 1)).numpy()
    expected = precip_lr.copy()
    expected[expected < threshold] = 0.0
    scale = max(float(np.max(np.abs(expected))), 1e-6)
    assert np.allclose(agg, expected, atol=2e-3 * scale)


@pytest.mark.parametrize("alpha", [1.0, None])
def test_rainfarm_alpha(precip_lr, alpha):
    out, got_alpha = downscaling.get_method("rainfarm")(
        precip_lr, alpha=alpha, ds_factor=2, threshold=0, return_alpha=True, seed=4,
        device="cpu",
    )
    if alpha is None:
        assert np.isfinite(got_alpha) and got_alpha != 1.0
        # the fit is the JAX package's host fit on the same field
        _, jalpha = jrf.downscale(precip_lr, 2, threshold=0, return_alpha=True, seed=4)
        np.testing.assert_allclose(got_alpha, jalpha, rtol=1e-12)
    else:
        assert got_alpha == alpha


def test_rainfarm_ensemble(precip_lr):
    ens = rainfarm.downscale_ensemble(precip_lr, 4, 6, seed=9, device="cpu")
    assert ens.shape == (6, precip_lr.shape[0] * 4, precip_lr.shape[1] * 4)
    scale = max(float(np.max(np.abs(precip_lr))), 1e-6)
    agg = aggregate_fields(ens, 4, axis=(-2, -1)).numpy()
    assert np.allclose(agg, precip_lr[None], atol=2e-3 * scale)
    assert float((ens[0] - ens[1]).std()) > 1e-3


def test_registry_and_input_checks(precip_lr):
    assert downscaling.get_method("RainFARM") is rainfarm.downscale
    with pytest.raises(ValueError):
        downscaling.get_method("nope")
    with pytest.raises(ValueError):
        downscaling.get_method(None)
    bad = precip_lr.copy()
    bad[0, 0] = np.nan
    for kw in (dict(precip=bad, ds_factor=2), dict(precip=precip_lr, ds_factor=2.0),
               dict(precip=precip_lr, ds_factor=2, kernel_type="box")):
        with pytest.raises(ValueError):
            rainfarm.downscale(device="cpu", **kw)


@pytest.mark.parametrize("ds", [1, 2, 4])
def test_frequency_arrays_and_kernels_exact(ds):
    a = np.empty((8, 12))
    np.testing.assert_array_equal(rainfarm._compute_freq_array(a, ds),
                                  jrf._compute_freq_array(a, ds))
    for kind in ("gaussian", "tophat", "uniform"):
        np.testing.assert_array_equal(rainfarm._make_kernel[kind](ds),
                                      jrf._make_kernel[kind](ds))


def test_gaussianize_with_jax_draw(precip_lr, monkeypatch):
    key = jax.random.PRNGKey(3)
    p = jnp.asarray(precip_lr, jnp.float32)
    draw = np.asarray(jax.random.normal(key, (p.size,)))
    monkeypatch.setattr(rainfarm, "_normal_white", lambda g, shape: torch.as_tensor(draw))
    port = rainfarm._gaussianize(torch.tensor(np.asarray(p)), None)
    _rel_close(port, jrf._gaussianize(p, key), 1e-5)


@pytest.mark.parametrize("ds", [2, 4])
def test_noise_field_with_jax_draw(ds):
    key = jax.random.PRNGKey(ds)
    k = jrf._compute_freq_array(np.empty((32, 32)), ds)
    white = np.asarray(jax.random.uniform(key, k.shape))
    port = rainfarm._compute_noise_field(k, 1.7, torch.as_tensor(white)[None])[0]
    _rel_close(port, jrf._compute_noise_field(k, jnp.float32(1.7), key), 1e-5)


def test_spectral_fusion_against_jax(precip_lr):
    ds = 4
    low = np.asarray(jrf._gaussianize(jnp.asarray(precip_lr, jnp.float32),
                                      jax.random.PRNGKey(1)))
    f_low = jrf._compute_freq_array(np.empty((64, 64)))
    f_high = jrf._compute_freq_array(np.empty((64, 64)), ds)
    noise = np.asarray(jrf._compute_noise_field(f_high, jnp.float32(1.5), jax.random.PRNGKey(2)))
    high = np.exp(noise / noise.std())
    port = rainfarm._apply_spectral_fusion(
        torch.as_tensor(low), torch.as_tensor(high)[None], f_low, f_high, ds)[0]
    _rel_close(port, jrf._apply_spectral_fusion(low, jnp.asarray(high), f_low, f_high, ds),
               1e-5)


@pytest.mark.parametrize("kind", ["gaussian", "tophat"])
def test_balanced_spatial_average_against_jax(precip_lr, kind):
    x = np.repeat(np.repeat(precip_lr.astype(np.float32), 4, 0), 4, 1)
    x[10:14, 20:30] = np.nan
    kernel = jrf._make_kernel[kind](4)
    port = rainfarm._balanced_spatial_average(torch.as_tensor(x), kernel)
    ref = np.asarray(jrf._balanced_spatial_average(x, kernel))
    assert np.array_equal(np.isnan(port.numpy()), np.isnan(ref))
    _rel_close(port, ref, 1e-5)


@pytest.mark.parametrize("kernel_type,threshold", [
    (None, None), ("gaussian", 0.5), ("tophat", None),
])
def test_downscale_core_with_jax_draw(precip_lr, kernel_type, threshold):
    spectral_fusion = False
    ds = 4
    key = jax.random.PRNGKey(11)
    p = jnp.asarray(precip_lr, jnp.float32)
    pt = jrf._gaussianize(p, jax.random.PRNGKey(12)) if spectral_fusion else p
    ref = jrf._downscale_core(
        p, pt, jnp.float32(1.8), key, jnp.float32(threshold or 0.0), ds_factor=ds,
        kernel_type=kernel_type, spectral_fusion=spectral_fusion,
        use_threshold=threshold is not None)
    white = np.asarray(jax.random.uniform(key, (256, 256)))
    port = rainfarm._downscale_core(
        torch.tensor(np.asarray(p)), torch.tensor(np.asarray(pt)), 1.8,
        torch.as_tensor(white)[None], float(threshold or 0.0), ds, kernel_type,
        spectral_fusion, threshold is not None)[0]
    _rel_close(port, ref, 1e-4)


@pytest.mark.parametrize("spectral_fusion", [False, True])
def test_downscale_in_law(precip_lr, spectral_fusion):
    port = rainfarm.downscale_ensemble(precip_lr, 4, 16, seed=5, spectral_fusion=spectral_fusion,
                                       device="cpu").double().numpy()
    ref = np.asarray(jrf.downscale_ensemble(precip_lr, 4, 16, seed=5,
                                            spectral_fusion=spectral_fusion), np.float64)
    expanded = np.kron(precip_lr, np.ones((4, 4)))
    wet = expanded > 0.5
    q = (10, 50, 90)
    qp = np.percentile(port[:, wet] / expanded[wet], q)
    qr = np.percentile(ref[:, wet] / expanded[wet], q)
    np.testing.assert_allclose(qp, qr, rtol=0.05)
    sp, sr = port.std(axis=0)[wet].mean(), ref.std(axis=0)[wet].mean()
    assert abs(sp - sr) / sr <= 0.1, (sp, sr)
