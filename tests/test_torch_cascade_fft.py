"""The dict API of the FFT cascade (``decomposition_fft``,
``recompose_fft``, the registry's "fft" pair), ``spectral_level_stds``
and ``decompose_core(subtract_mean=)`` of the PyTorch port against the JAX
package on the same numpy inputs, at 64^2 and 48 x 70.  Every pair of
input and output domain, with and without ``normalize``, ``mask``,
``subtract_mean`` and ``compact_output``, and the round trip back to the
field.  Tolerance: 1e-4 x max|ref| (float32 FFTs); the level means, which
cancel to rounding noise where the mean is subtracted, 1e-4 x the largest
level std; the DC bin of a spectral level that is normalized or whose
field mean was subtracted, zero up to the rounding of the field's DC term
on both sides, below 1e-3 x max|ref| on each side."""

import itertools

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pysteps_tpu import cascade as jcascade
from pysteps_tpu.cascade import decomposition as jdec
from pysteps_tpu_torch import cascade as tcascade
from pysteps_tpu_torch.cascade import decomposition as tdec

SHAPES = [(64, 64), (48, 70)]


def _field(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (np.maximum(rng.gamma(1.2, 2.0, shape) - 1.5, 0.0) + 0.3).astype(np.float32)


def _close(ref, out, rel=1e-4, scale=None):
    ref = np.asarray(ref)
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert ref.shape == out.shape, (ref.shape, out.shape)
    scale = max(float(np.abs(ref).max()), scale or 1e-6)
    assert float(np.abs(out - ref).max()) <= rel * scale


def _dc_index(d, k):
    """The flat index of level k's DC bin in its array, or None."""
    if not (d["domain"] == "spectral" and (d["normalized"] or "field_mean" in d)):
        return None
    if d["compact_output"]:
        return 0 if bool(np.asarray(d["weight_masks"])[k, 0, 0]) else None
    return 0


def _close_stats(dj, dt):
    """The levels, stds and field mean within 1e-4 of their own size, the
    level means within 1e-4 of the largest std; a spectral level's DC bin
    that should be 0 near 0 on both sides."""
    for k, (lj, lt) in enumerate(zip(dj["cascade_levels"], dt["cascade_levels"])):
        lj = np.array(lj).reshape(-1)
        lt = lt.numpy().reshape(-1)
        dc = _dc_index(dj, k)
        if dc is not None:
            bound = 1e-3 * float(np.abs(lj).max())
            assert abs(lj[dc]) <= bound and abs(lt[dc]) <= bound
            lj[dc] = lt[dc] = 0
        _close(lj, lt)
    for key in ("stds", "field_mean"):
        if key in dj:
            _close(dj[key], dt[key])
    if "means" in dj:
        _close(dj["means"], dt["means"], scale=float(np.abs(np.asarray(dj["stds"])).max()))


def _bp(shape):
    bp = jcascade.get_method("gaussian")(shape, 5)
    return bp, {"weights_2d": np.array(bp["weights_2d"], np.float32), "shape": shape}


CASES = list(itertools.product(
    ["spatial", "spectral"], ["spatial", "spectral"], [False, True], [False, True],
))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("inp, outp, normalize, subtract_mean", CASES)
def test_decomposition_fft_and_round_trip(shape, inp, outp, normalize, subtract_mean):
    f = _field(shape)
    bp_j, bp_t = _bp(shape)
    x = np.fft.rfft2(f).astype(np.complex64) if inp == "spectral" else f
    kw = dict(input_domain=inp, output_domain=outp, normalize=normalize,
              subtract_mean=subtract_mean)
    dj = jdec.decomposition_fft(jnp.asarray(x), bp_j, **kw)
    dt = tdec.decomposition_fft(torch.from_numpy(x), bp_t, **kw)
    assert {k for k in dj} == {k for k in dt}
    _close_stats(dj, dt)
    assert dt["domain"] == outp and dt["normalized"] == normalize
    rj = jdec.recompose_fft(dj, shape=shape)
    rt = tdec.recompose_fft(dt, shape=shape)
    _close(rj, rt)
    # back to the field: the spectral result is the half-plane of a field of
    # this shape
    back = torch.fft.irfft2(rt, s=shape) if outp == "spectral" else rt
    if not subtract_mean or outp == "spatial" or inp == "spatial":
        _close(np.asarray(jnp.fft.irfft2(rj, s=shape)) if outp == "spectral" else rj, back)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("normalize", [False, True])
def test_decomposition_with_mask(shape, normalize):
    f = _field(shape, 1)
    mask = f > 0.5
    bp_j, bp_t = _bp(shape)
    dj = jdec.decomposition_fft(jnp.asarray(f), bp_j, mask=jnp.asarray(mask), normalize=normalize)
    dt = tdec.decomposition_fft(torch.from_numpy(f), bp_t, mask=torch.from_numpy(mask),
                                normalize=normalize)
    _close_stats(dj, dt)
    _close(jdec.recompose_fft(dj), tdec.recompose_fft(dt))
    no_stats = tdec.decomposition_fft(torch.from_numpy(f), bp_t, compute_stats=False)
    assert "means" not in no_stats and "stds" not in no_stats


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("subtract_mean", [False, True])
def test_compact_output(normalize, subtract_mean):
    shape = (64, 64)
    f = _field(shape, 2)
    bp_j, bp_t = _bp(shape)
    kw = dict(output_domain="spectral", compact_output=True, normalize=normalize,
              subtract_mean=subtract_mean)
    dj = jdec.decomposition_fft(jnp.asarray(f), bp_j, **kw)
    dt = tdec.decomposition_fft(torch.from_numpy(f), bp_t, **kw)
    assert dt["compact_output"] and len(dt["cascade_levels"]) == 5
    np.testing.assert_array_equal(np.asarray(dj["weight_masks"]), dt["weight_masks"].numpy())
    _close_stats(dj, dt)
    _close(jdec.recompose_fft(dj), tdec.recompose_fft(dt))


@pytest.mark.parametrize("shape", SHAPES)
def test_spectral_level_stds(shape):
    f = _field(shape, 3)
    w = np.asarray(_bp(shape)[1]["weights_2d"])
    F = np.fft.rfft2(f).astype(np.complex64)
    mj, sj = jdec.spectral_level_stds(jnp.asarray(F), jnp.asarray(w), shape)
    mt, st = tdec.spectral_level_stds(torch.from_numpy(F), torch.from_numpy(w), shape)
    _close(mj, mt)
    _close(sj, st)
    # equal to the statistics of the materialized levels, also in a batch
    _, m2, s2 = tdec.decompose_spectral_core(torch.from_numpy(F), torch.from_numpy(w), shape,
                                             normalize=False)
    _close(m2.numpy(), mt)
    _close(s2.numpy(), st)
    mb, sb = tdec.spectral_level_stds(torch.from_numpy(np.stack([F, 2 * F])),
                                      torch.from_numpy(w), shape)
    _close(np.stack([mt, 2 * mt]), mb)
    _close(np.stack([st, 2 * st]), sb)


@pytest.mark.parametrize("normalize", [False, True])
def test_decompose_core_subtract_mean(normalize):
    shape = (64, 64)
    f = _field(shape, 4)
    w = np.asarray(_bp(shape)[1]["weights_2d"])
    ref = jdec.decompose_core(jnp.asarray(f), jnp.asarray(w), normalize=normalize,
                              subtract_mean=True)
    out = tdec.decompose_core(torch.from_numpy(f), torch.from_numpy(w), normalize=normalize,
                              subtract_mean=True)
    _close(ref[0], out[0])
    _close(ref[1], out[1], scale=float(np.abs(np.asarray(ref[2])).max()))
    _close(ref[2], out[2])


def test_registry_fft_pair():
    dec, rec = tcascade.get_method("fft")
    assert dec is tdec.decomposition_fft and rec is tdec.recompose_fft
    jd, jr = jcascade.get_method("FFT")
    assert jd.__name__ == dec.__name__ and jr.__name__ == rec.__name__
    with pytest.raises(ValueError):
        tcascade.get_method("wavelet")
