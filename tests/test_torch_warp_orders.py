"""The exact warps of every interpolation order in the PyTorch port
(``ops/warp.py``: ``nearest_warp``, ``cubic_warp``, ``bilinear_warp`` and
``warp(order=0|1|3)``) against the JAX package's on the CPU.

Inputs: a 40 x 56 field with NaN pixels and a smooth displacement that
reaches past every edge, from a numpy seed.  Both edge rules ("constant"
with a NaN and a finite fill, "nearest").  Tolerance: order 0 gathers and
must be equal; orders 1 and 3 sum 4 and 16 weighted taps in the same
order, within 1e-6 x max|field|; NaN sets identical.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pysteps_tpu.ops import warp as jwarp
from pysteps_tpu_torch.ops import warp as twarp

M, N = 40, 56


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    field = (rng.normal(0.0, 3.0, (M, N)) + 5.0).astype(np.float32)
    field[rng.random((M, N)) < 0.02] = np.nan
    yy, xx = np.mgrid[0:M, 0:N].astype(np.float32)
    disp = np.stack([
        6.0 * np.sin(yy / 7.0) + rng.normal(0.0, 2.0, (M, N)),
        -5.0 * np.cos(xx / 9.0) + rng.normal(0.0, 2.0, (M, N)),
    ]).astype(np.float32)
    # exact halves, where order 0 rounds half to even
    disp[:, :3, :3] = 0.5
    return field, disp


def _held(ref, out, order, field):
    ref, out = np.asarray(ref), out.numpy()
    assert ref.shape == out.shape
    assert np.array_equal(np.isnan(ref), np.isnan(out))
    if order == 0:
        np.testing.assert_array_equal(np.nan_to_num(out, nan=-1e9), np.nan_to_num(ref, nan=-1e9))
    else:
        err = np.max(np.abs(np.nan_to_num(ref) - np.nan_to_num(out)))
        assert err <= 1e-6 * np.nanmax(np.abs(field)), err


MODES = [("constant", float("nan")), ("constant", -3.0), ("nearest", float("nan"))]


@pytest.mark.parametrize("order", [0, 1, 3])
@pytest.mark.parametrize("mode,cval", MODES)
def test_warp_orders_match_jax(order, mode, cval):
    field, disp = _inputs()
    ref = jwarp.warp(jnp.asarray(field), jnp.asarray(disp), order=order, mode=mode, cval=cval)
    out = twarp.warp(torch.tensor(field), torch.tensor(disp), order=order, mode=mode, cval=cval)
    _held(ref, out, order, field)


@pytest.mark.parametrize("name,order", [("nearest_warp", 0), ("bilinear_warp", 1),
                                        ("cubic_warp", 3)])
@pytest.mark.parametrize("mode,cval", MODES)
def test_samplers_at_coordinates_match_jax(name, order, mode, cval):
    """The samplers at explicit coordinates, on a batch of two fields (the
    port's leading axes against JAX one field at a time)."""
    field, disp = _inputs(1)
    fields = np.stack([field, field[::-1].copy()])
    yy, xx = np.mgrid[0:M, 0:N].astype(np.float32)
    cy, cx = yy + disp[1], xx + disp[0]
    out = getattr(twarp, name)(torch.tensor(fields), torch.tensor(cy), torch.tensor(cx),
                               mode=mode, cval=cval)
    for b in range(2):
        ref = getattr(jwarp, name)(jnp.asarray(fields[b]), jnp.asarray(cy), jnp.asarray(cx),
                                   mode=mode, cval=cval)
        _held(ref, out[b], order, field)


def test_catmull_rom_weights_match_jax_and_interpolate():
    t = np.linspace(0.0, 1.0, 33, dtype=np.float32)
    ref = jwarp._catmull_rom_weights(jnp.asarray(t))
    out = twarp._catmull_rom_weights(torch.tensor(t))
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=1e-7)
    np.testing.assert_allclose(sum(w.numpy() for w in out), 1.0, atol=1e-6)
    # interpolating: the taps at t = 0 are (0, 1, 0, 0)
    np.testing.assert_array_equal([float(w[0]) for w in out], [0.0, 1.0, 0.0, 0.0])


def test_cubic_reproduces_a_linear_ramp_inside():
    """Catmull-Rom is exact on linear data away from the edges."""
    ramp = (np.arange(M, dtype=np.float32)[:, None] * 0.5
            + np.arange(N, dtype=np.float32)[None, :] * 0.25)
    disp = np.full((2, M, N), 0.375, np.float32)
    out = twarp.warp(torch.tensor(ramp), torch.tensor(disp), order=3).numpy()
    inner = out[2:-3, 2:-3]
    np.testing.assert_allclose(inner, (ramp + 0.375 * 0.75)[2:-3, 2:-3], rtol=0, atol=1e-5)
