"""Temporal autocorrelation and AR(p) estimation of the PyTorch port
against the JAX package.  Tolerance: atol 1e-5."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pysteps_tpu.nowcasts import steps as jsteps
from pysteps_tpu.timeseries import autoregression as jar
from pysteps_tpu.timeseries import correlation as jcorr
from pysteps_tpu_torch.nowcasts import steps as tsteps
from pysteps_tpu_torch.timeseries import autoregression as tar
from pysteps_tpu_torch.timeseries import correlation as tcorr


def _series(seed):
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=(48, 64))
    xs = [x0]
    for _ in range(3):
        xs.append(0.8 * xs[-1] + 0.6 * rng.normal(size=x0.shape))
    return np.stack(xs).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_temporal_autocorrelation(masked):
    x = _series(0)
    mask = (x[-1] > -0.5) if masked else None
    ref = jcorr.temporal_autocorrelation(
        jnp.asarray(x), mask=None if mask is None else jnp.asarray(mask)
    )
    out = tcorr.temporal_autocorrelation(
        torch.from_numpy(x), mask=None if mask is None else torch.from_numpy(mask)
    )
    assert len(ref) == len(out) == 3
    np.testing.assert_allclose([float(g) for g in ref], [float(g) for g in out], atol=1e-5)


def test_adjust_lag2_and_yule_walker():
    rng = np.random.default_rng(1)
    g1 = rng.uniform(0.3, 0.999, 8).astype(np.float32)
    g2 = (g1**2 * rng.uniform(0.5, 1.1, 8)).astype(np.float32)
    ref2 = np.asarray(jar.adjust_lag2_corrcoef2(jnp.asarray(g1), jnp.asarray(g2)))
    out2 = tar.adjust_lag2_corrcoef2(torch.from_numpy(g1), torch.from_numpy(g2)).numpy()
    np.testing.assert_allclose(ref2, out2, atol=1e-5)
    gamma = np.stack([g1, ref2], axis=1)
    ref = np.asarray(jar.estimate_ar_params_yw(jnp.asarray(gamma), check_stationarity=False))
    out = tar.estimate_ar_params_yw(torch.from_numpy(gamma)).numpy()
    np.testing.assert_allclose(ref, out, atol=1e-5)
    ref1 = np.asarray(jar.estimate_ar_params_yw(jnp.asarray(gamma[0])))
    out1 = tar.estimate_ar_params_yw(torch.from_numpy(gamma[0])).numpy()
    np.testing.assert_allclose(ref1, out1, atol=1e-5)


@pytest.mark.parametrize("with_eps", [False, True])
def test_ar_step_lags(with_eps):
    rng = np.random.default_rng(2)
    lags = tuple(rng.normal(size=(3, 4, 16, 16)).astype(np.float32) for _ in range(2))
    phi = rng.uniform(-0.5, 0.9, (4, 3)).astype(np.float32)
    eps = rng.normal(size=(3, 4, 16, 16)).astype(np.float32) if with_eps else None
    ref = jsteps._ar_step_lags(
        tuple(jnp.asarray(x) for x in lags), jnp.asarray(phi),
        eps=None if eps is None else jnp.asarray(eps),
    )
    out = tsteps._ar_step_lags(
        tuple(torch.from_numpy(x) for x in lags), torch.from_numpy(phi),
        eps=None if eps is None else torch.from_numpy(eps),
    )
    for r, o in zip(ref, out):
        np.testing.assert_allclose(np.asarray(r), o.numpy(), atol=1e-5)
