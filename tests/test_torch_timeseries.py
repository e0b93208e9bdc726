"""Temporal autocorrelation and AR(p) / VAR(p) estimation and iteration
of the PyTorch port against the JAX package on the same numpy inputs.
Tolerance: atol 1e-5 for correlations and Yule-Walker fits; rtol 1e-4
(with 1e-4 x max|ref| absolute) for the OLS fits, whose normal equations
sum thousands of float32 products in another order, and for the
moving-window forms (float32 convolutions); exact for the host-side
stationarity tests."""

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


def _close(ref, out, rtol=1e-4):
    ref = np.asarray(ref, np.float64)
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out, np.float64)
    assert ref.shape == out.shape, (ref.shape, out.shape)
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=rtol * max(float(np.abs(ref).max()), 1e-6))


def _closes(refs, outs, rtol=1e-4):
    assert len(refs) == len(outs)
    for r, o in zip(refs, outs):
        _close(r, o, rtol)


def _var_series(seed, n=5, q=2, shape=(24, 32)):
    rng = np.random.default_rng(seed)
    A = np.array([[0.6, 0.2], [-0.1, 0.5]])[:q, :q]
    xs = [rng.normal(size=(q,) + shape)]
    for _ in range(n - 1):
        xs.append(np.einsum("ij,j...->i...", A, xs[-1]) + 0.5 * rng.normal(size=(q,) + shape))
    return np.stack(xs).astype(np.float32)


@pytest.mark.parametrize("d", [0, 1])
def test_temporal_autocorrelation_differenced_and_spectral(d):
    x = _series(3)
    ref = jcorr.temporal_autocorrelation(jnp.asarray(x), d=d)
    out = tcorr.temporal_autocorrelation(torch.from_numpy(x), d=d)
    np.testing.assert_allclose([float(g) for g in ref], [float(g) for g in out], atol=1e-5)
    X = np.fft.rfft2(x).astype(np.complex64)
    ref = jcorr.temporal_autocorrelation(jnp.asarray(X), d=d, domain="spectral",
                                         x_shape=x.shape[1:])
    out = tcorr.temporal_autocorrelation(torch.from_numpy(X), d=d, domain="spectral",
                                         x_shape=x.shape[1:])
    np.testing.assert_allclose([float(g) for g in ref], [float(g) for g in out], atol=1e-5)


@pytest.mark.parametrize("window, radius", [("gaussian", 3.0), ("uniform", 4)])
@pytest.mark.parametrize("masked", [False, True])
def test_temporal_autocorrelation_moving_window(window, radius, masked):
    x = _series(4)
    mask = (x[-1] > -1.0) if masked else None
    kw = dict(window=window, window_radius=radius)
    ref = jcorr.temporal_autocorrelation(
        jnp.asarray(x), mask=None if mask is None else jnp.asarray(mask), **kw)
    out = tcorr.temporal_autocorrelation(
        torch.from_numpy(x), mask=None if mask is None else torch.from_numpy(mask), **kw)
    _closes(ref, out)


@pytest.mark.parametrize("radius", [np.inf, 3.0])
@pytest.mark.parametrize("d", [0, 1])
def test_temporal_autocorrelation_multivariate(radius, d):
    x = _var_series(5)
    ref = jcorr.temporal_autocorrelation_multivariate(jnp.asarray(x), d=d, window_radius=radius)
    out = tcorr.temporal_autocorrelation_multivariate(torch.from_numpy(x), d=d,
                                                      window_radius=radius)
    _closes(ref, out)


def test_adjust_lag2_corrcoef1_and_differenced_yule_walker():
    rng = np.random.default_rng(6)
    g1 = rng.uniform(-0.9, 0.99, 16).astype(np.float32)
    g2 = rng.uniform(-1.0, 1.0, 16).astype(np.float32)
    ref = np.asarray(jar.adjust_lag2_corrcoef1(jnp.asarray(g1), jnp.asarray(g2)))
    out = tar.adjust_lag2_corrcoef1(torch.from_numpy(g1), torch.from_numpy(g2)).numpy()
    np.testing.assert_allclose(ref, out, atol=1e-6)
    gamma = np.stack([g1, ref], axis=1)
    # the innovation coefficient is sqrt(1 - sum gamma phi).  Where the
    # lag-2 clamp puts a row on the stationarity boundary (phi_2 = -1) the
    # argument is 0 up to float32 rounding, and the two libraries' solves
    # round it differently (XLA's CPU forward substitution fuses a
    # multiply-add that LAPACK rounds twice): the root's infinite slope at
    # 0 turns an argument 1.2e-7 apart into roots 3.5e-4 apart.  So the
    # argument is held on every row and the root where the argument is
    # clear of float32 rounding of 0.
    # With d = 1 the root is still taken over the differenced fit's phi,
    # which the ARI(2, 1) coefficients c give back as cumsum(c_1, c_2) - 1.
    gc = np.clip(gamma, -0.9985, 0.9985)
    for d in (0, 1):
        r = np.asarray(jar.estimate_ar_params_yw(jnp.asarray(gamma), d=d))
        o = tar.estimate_ar_params_yw(torch.from_numpy(gamma), d=d).numpy()
        np.testing.assert_allclose(r[:, :-1], o[:, :-1], atol=1e-5)
        phi_r, phi_o = (np.cumsum(x[:, :2], axis=1) - 1.0 if d else x[:, :2] for x in (r, o))
        arg_r = 1.0 - np.sum(gc * phi_r, axis=1, dtype=np.float32)
        arg_o = 1.0 - np.sum(gc * phi_o, axis=1, dtype=np.float32)
        np.testing.assert_allclose(arg_r, arg_o, atol=1e-5)
        clear = np.minimum(arg_r, arg_o) > 4 * np.finfo(np.float32).eps
        assert clear.sum() >= len(clear) // 2
        np.testing.assert_allclose(r[clear, -1], o[clear, -1], atol=1e-5)
    maps = [rng.uniform(0.2, 0.9, (8, 12)).astype(np.float32) for _ in range(2)]
    maps[1] = maps[0] ** 2 * 0.9
    for d in (0, 1):
        r = jar.estimate_ar_params_yw_localized([jnp.asarray(m) for m in maps], d=d)
        o = tar.estimate_ar_params_yw_localized([torch.from_numpy(m) for m in maps], d=d)
        np.testing.assert_allclose(np.asarray(r), o.numpy(), atol=1e-5)
    with pytest.raises(ValueError):
        tar.estimate_ar_params_yw(torch.from_numpy(gamma), d=2)


def test_stationarity_tests_and_the_check():
    rng = np.random.default_rng(7)
    for _ in range(50):
        phi = rng.uniform(-1.5, 1.5, rng.integers(1, 4))
        assert jar.test_ar_stationarity(phi) == tar.test_ar_stationarity(phi)
        mats = [rng.uniform(-0.9, 0.9, (2, 2)) for _ in range(rng.integers(1, 3))]
        assert jar.test_var_stationarity(mats) == tar.test_var_stationarity(mats)
    # gamma_2 far below the lag-1 clamp makes the AR(2) fit nonstationary
    bad = np.array([0.95, -0.9], np.float32)
    with pytest.raises(RuntimeError):
        jar.estimate_ar_params_yw(jnp.asarray(bad))
    with pytest.raises(RuntimeError):
        tar.estimate_ar_params_yw(torch.from_numpy(bad))


@pytest.mark.parametrize("d", [0, 1])
@pytest.mark.parametrize("const, lam", [(False, 0.0), (True, 0.5)])
def test_ols_ar_fit(d, const, lam):
    x = _series(8)
    kw = dict(d=d, include_constant_term=const, lam=lam)
    _close(jar.estimate_ar_params_ols(jnp.asarray(x), 2, **kw),
           tar.estimate_ar_params_ols(torch.from_numpy(x), 2, **kw))
    with pytest.raises(ValueError):
        tar.estimate_ar_params_ols(torch.from_numpy(x[:2]), 2)


@pytest.mark.parametrize("window", ["gaussian", "uniform"])
@pytest.mark.parametrize("d", [0, 1])
def test_ols_ar_fit_localized(window, d):
    x = _series(9)
    kw = dict(d=d, window=window, lam=0.01)
    _close(jar.estimate_ar_params_ols_localized(jnp.asarray(x), 2, 3.0, **kw),
           tar.estimate_ar_params_ols_localized(torch.from_numpy(x), 2, 3.0, **kw))


@pytest.mark.parametrize("d", [0, 1])
def test_var_fits(d):
    x = _var_series(10, n=8)
    _closes(jar.estimate_var_params_ols(jnp.asarray(x), 2, d=d, lam=0.1),
            tar.estimate_var_params_ols(torch.from_numpy(x), 2, d=d, lam=0.1))
    g0 = np.eye(2, dtype=np.float32)
    g1 = np.array([[0.5, 0.1], [0.05, 0.4]], np.float32)
    g2 = np.array([[0.3, 0.05], [0.02, 0.2]], np.float32)
    _closes(jar.estimate_var_params_yw([jnp.asarray(g) for g in (g0, g1, g2)], d=d),
            tar.estimate_var_params_yw([torch.from_numpy(g) for g in (g0, g1, g2)], d=d))


@pytest.mark.parametrize("const", [False, True])
@pytest.mark.parametrize("d", [0, 1])
def test_var_fits_localized(const, d):
    p, h = 1, 1
    x = _var_series(11, n=p + d + h + 1)
    kw = dict(d=d, h=h, include_constant_term=const, lam=0.05)
    _closes(jar.estimate_var_params_ols_localized(jnp.asarray(x), p, 3.0, **kw),
            tar.estimate_var_params_ols_localized(torch.from_numpy(x), p, 3.0, **kw))
    with pytest.raises(ValueError):
        tar.estimate_var_params_ols_localized(torch.from_numpy(x[:2]), p, 3.0, **kw)
    rng = np.random.default_rng(12)
    shp = (2, 2, 6, 8)
    g0 = np.broadcast_to(np.eye(2, dtype=np.float32)[..., None, None], shp).copy()
    g1 = (0.3 + 0.1 * rng.random(shp)).astype(np.float32)
    g2 = (0.1 + 0.05 * rng.random(shp)).astype(np.float32)
    _closes(jar.estimate_var_params_yw_localized([jnp.asarray(g) for g in (g0, g1, g2)]),
            tar.estimate_var_params_yw_localized([torch.from_numpy(g) for g in (g0, g1, g2)]))


@pytest.mark.parametrize("with_eps", [False, True])
def test_iterate_ar_and_var(with_eps):
    rng = np.random.default_rng(13)
    x = rng.normal(size=(3, 2, 16, 16)).astype(np.float32)
    phi = rng.uniform(-0.5, 0.9, (3, 3)).astype(np.float32)
    eps = rng.normal(size=(3, 16, 16)).astype(np.float32) if with_eps else None
    ref = jar.iterate_ar_model(jnp.asarray(x), jnp.asarray(phi),
                               None if eps is None else jnp.asarray(eps))
    out = tar.iterate_ar_model(torch.from_numpy(x), torch.from_numpy(phi),
                               None if eps is None else torch.from_numpy(eps))
    _close(ref, out, 1e-5)
    xv = rng.normal(size=(2, 2, 16, 16)).astype(np.float32)
    mats = [rng.uniform(-0.5, 0.5, (2, 2)).astype(np.float32) for _ in range(3)]
    epsv = rng.normal(size=(2, 16, 16)).astype(np.float32) if with_eps else None
    ref = jar.iterate_var_model(jnp.asarray(xv), [jnp.asarray(m) for m in mats],
                                None if epsv is None else jnp.asarray(epsv))
    out = tar.iterate_var_model(torch.from_numpy(xv), [torch.from_numpy(m) for m in mats],
                                None if epsv is None else torch.from_numpy(epsv))
    _close(ref, out, 1e-5)


@pytest.mark.parametrize("n", [None, 2, 6])
def test_ar_acf(n):
    gamma = [0.8, 0.55]
    ref, out = jar.ar_acf(gamma, n), tar.ar_acf(gamma, n)
    np.testing.assert_allclose(np.asarray(ref, np.float64), np.asarray(out, np.float64),
                               atol=1e-6)
    with pytest.raises(ValueError):
        tar.ar_acf(gamma, 1)
