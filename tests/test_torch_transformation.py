"""Intensity transforms and unit conversions of the PyTorch port against
the JAX package on the same numpy inputs: the four transforms forward and
back with their metadata, their NaN and zero handling, and the conversion
round trips.  Tolerance: rtol 1e-6, with 1e-6 x max|ref| absolute where a
difference cancels to near 0 (1e-5 absolute for NQT, whose normal
quantiles come from two float32 ``ndtri``s)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pysteps_tpu.utils import conversion as jconv
from pysteps_tpu.utils import transformation as jtr
from pysteps_tpu_torch.utils import conversion as tconv
from pysteps_tpu_torch.utils import transformation as ttr


def _rain(seed=0, shape=(64, 64), nan=True):
    rng = np.random.default_rng(seed)
    R = np.maximum(rng.gamma(0.8, 3.0, shape) - 1.0, 0.0).astype(np.float32)
    if nan:
        R[:3, :5] = np.nan
    return R


def _same(ref, out, rtol=1e-6, atol=None):
    ref = np.asarray(ref, np.float64)
    out = out.numpy().astype(np.float64) if isinstance(out, torch.Tensor) else np.asarray(out)
    assert ref.shape == out.shape
    assert np.array_equal(np.isnan(ref), np.isnan(out))
    if atol is None:
        atol = rtol * float(np.max(np.abs(ref[np.isfinite(ref)]), initial=0.0))
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=atol, equal_nan=True)


def _same_meta(ref, out, rtol=1e-6, atol=None):
    assert set(ref) == set(out), (set(ref), set(out))
    for k in ref:
        if isinstance(ref[k], (str, type(None))):
            assert ref[k] == out[k], k
        else:
            _same(ref[k], out[k], rtol=rtol, atol=atol)


@pytest.mark.parametrize("threshold, zerovalue", [(None, None), (0.5, -20.0)])
def test_dB_transform(threshold, zerovalue):
    R = _rain()
    rj, mj = jtr.dB_transform(jnp.asarray(R), threshold=threshold, zerovalue=zerovalue)
    rt, mt = ttr.dB_transform(torch.from_numpy(R), threshold=threshold, zerovalue=zerovalue)
    _same(rj, rt)
    _same_meta(mj, mt)
    # already transformed: unchanged
    assert ttr.dB_transform(rt, mt)[0] is rt
    bj, mbj = jtr.dB_transform(rj, mj, inverse=True)
    bt, mbt = ttr.dB_transform(rt, mt, inverse=True)
    _same(bj, bt)
    _same_meta(mbj, mbt)


@pytest.mark.parametrize("Lambda", [0.0, 0.5, -0.2])
def test_boxcox_transform(Lambda):
    R = _rain(1)
    rj, mj = jtr.boxcox_transform(jnp.asarray(R), Lambda=Lambda)
    rt, mt = ttr.boxcox_transform(torch.from_numpy(R), Lambda=Lambda)
    _same(rj, rt)
    _same_meta(mj, mt)
    bj, mbj = jtr.boxcox_transform(rj, mj, inverse=True)
    bt, mbt = ttr.boxcox_transform(rt, mt, inverse=True)
    _same(bj, bt, rtol=2e-6)
    _same_meta(mbj, mbt)


def test_sqrt_transform():
    R = _rain(2)
    rj, mj = jtr.sqrt_transform(jnp.asarray(R))
    rt, mt = ttr.sqrt_transform(torch.from_numpy(R))
    _same(rj, rt)
    _same_meta(mj, mt)
    meta = {"transform": None, "zerovalue": 0.0, "threshold": 0.1}
    rj, mj = jtr.sqrt_transform(jnp.asarray(R), meta)
    rt, mt = ttr.sqrt_transform(torch.from_numpy(R), meta)
    _same_meta(mj, mt)
    _same(jtr.sqrt_transform(rj, mj, inverse=True)[0], ttr.sqrt_transform(rt, mt, inverse=True)[0])


@pytest.mark.parametrize("a", [0.0, 0.4])
@pytest.mark.parametrize("nan", [False, True])
def test_NQ_transform(a, nan):
    R = _rain(3, nan=nan)
    rj, mj = jtr.NQ_transform(jnp.asarray(R), a=a)
    rt, mt = ttr.NQ_transform(torch.from_numpy(R), a=a)
    # the zeros map to 0 exactly, the NaNs stay NaN
    _same(rj, rt, rtol=0.0, atol=1e-5)
    assert float(torch.sum(rt == 0)) == float(np.sum(np.asarray(rj) == 0)) > 0
    _same_meta(mj, mt, rtol=0.0, atol=1e-5)
    bj, mbj = jtr.NQ_transform(rj, dict(mj), inverse=True)
    bt, mbt = ttr.NQ_transform(rt, dict(mt), inverse=True)
    _same(bj, bt, rtol=0.0, atol=1e-5)
    _same_meta(mbj, mbt, rtol=0.0, atol=1e-5)


def test_interp_matches_jnp_interp_with_ties_and_clamping():
    rng = np.random.default_rng(4)
    xp = np.sort(np.round(rng.normal(size=200), 1)).astype(np.float32)  # many ties
    fp = np.linspace(-3, 3, 200).astype(np.float32)
    x = np.concatenate([rng.normal(scale=2, size=500), xp[::7], [xp[0] - 1, xp[-1] + 1]])
    x = x.astype(np.float32)
    ref = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp)))
    out = ttr._interp(torch.from_numpy(x), torch.from_numpy(xp), torch.from_numpy(fp))
    _same(ref, out, rtol=0.0, atol=1e-6)


def test_ndtri_matches_norm_ppf():
    import jax.scipy.stats as jstats

    pp = np.concatenate([np.linspace(1e-6, 1 - 1e-6, 4001), [1e-7, 0.5, 1 - 1e-7]])
    pp = pp.astype(np.float32)
    ref = np.asarray(jstats.norm.ppf(jnp.asarray(pp)))
    _same(ref, torch.special.ndtri(torch.from_numpy(pp)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("unit", ["mm/h", "mm", "dBZ"])
@pytest.mark.parametrize("transform", [None, "dB", "BoxCox"])
def test_conversion_round_trips(unit, transform):
    R = _rain(5, nan=False) + 0.05
    meta = {"unit": unit, "accutime": 5.0, "threshold": 0.1, "zerovalue": 0.0,
            "transform": None}
    Rj, Rt = jnp.asarray(R), torch.from_numpy(R)
    if transform == "dB":
        Rj, meta_j = jtr.dB_transform(Rj, meta)
        Rt, meta_t = ttr.dB_transform(Rt, meta)
    elif transform == "BoxCox":
        Rj, meta_j = jtr.boxcox_transform(Rj, meta, Lambda=0.3)
        Rt, meta_t = ttr.boxcox_transform(Rt, meta, Lambda=0.3)
    else:
        meta_j = meta_t = meta
    for name in ("to_rainrate", "to_raindepth", "to_reflectivity"):
        rj, mj = getattr(jconv, name)(Rj, meta_j)
        rt, mt = getattr(tconv, name)(Rt, meta_t)
        _same(rj, rt, rtol=2e-6)
        _same_meta(mj, mt, rtol=2e-6)
    # mm/h -> dBZ -> mm/h comes back
    rj, mj = jconv.to_reflectivity(Rj, meta_j)
    rt, mt = tconv.to_reflectivity(Rt, meta_t)
    _same(jconv.to_rainrate(rj, mj)[0], tconv.to_rainrate(rt, mt)[0], rtol=1e-5)


def test_conversion_rejects_unknown_units_and_transforms():
    R = torch.ones(4, 4)
    with pytest.raises(ValueError):
        tconv.to_rainrate(R, {"unit": "furlong", "transform": None})
    with pytest.raises(ValueError):
        tconv.to_reflectivity(R, {"unit": "mm/h", "transform": "cubic"})
