"""Semi-Lagrangian extrapolation of the PyTorch port
(``extrapolation/semilagrangian.py``: ``extrapolate``, ``semilag_step``;
``extrapolation/interface.py``) against the JAX package on the CPU.

Inputs: a 64 x 80 dB field with NaN pixels and a smooth non-integer
motion, from a numpy seed.  Tolerance: 1e-5 x span of the field, NaN sets
identical (each output is one warp of the input along a displacement
integrated the same way); displacements within 1e-5 px.  On the CPU both
packages take the exact gather; the card's path (the static bound 48,
kernel K1) is held through its plain version against JAX's exact gather
at 160^2.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pysteps_tpu import extrapolation as jextrap
from pysteps_tpu.extrapolation import semilagrangian as jsl
from pysteps_tpu_torch import extrapolation as textrap
from pysteps_tpu_torch.extrapolation import semilagrangian as tsl

M, N = 64, 80


def _inputs(m=M, n=N, seed=3):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:m, 0:n].astype(np.float32)
    field = (20.0 * np.exp(-((yy - m / 2) ** 2 + (xx - n / 3) ** 2) / 300.0)
             + rng.normal(0.0, 0.5, (m, n)) - 5.0).astype(np.float32)
    field[rng.random((m, n)) < 0.01] = np.nan
    vel = np.stack([1.7 + 0.3 * np.sin(yy / 11.0), 0.6 + 0.2 * np.cos(xx / 13.0)])
    return field, vel.astype(np.float32)


def _close(ref, out, span, rel=1e-5):
    ref = np.asarray(ref)
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert ref.shape == out.shape
    assert np.array_equal(np.isnan(ref), np.isnan(out))
    err = np.max(np.abs(np.nan_to_num(ref) - np.nan_to_num(out)), initial=0.0)
    assert err <= rel * span, (err, span)


def _span(field):
    return float(np.nanmax(field) - np.nanmin(field))


CASES = {
    "int": dict(timesteps=3),
    "list": dict(timesteps=[0.5, 1.0, 2.5]),
    "list-vel_timestep": dict(timesteps=[1.0, 3.0], vel_timestep=2.0),
    "order0": dict(timesteps=3, interp_order=0),
    "order3-min": dict(timesteps=2, interp_order=3, outval="min"),
    "n_iter3": dict(timesteps=2, n_iter=3),
    "n_iter0": dict(timesteps=2, n_iter=0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_extrapolate_matches_jax(case):
    field, vel = _inputs()
    kw = dict(CASES[case])
    ts = kw.pop("timesteps")
    ref, ref_d = jsl.extrapolate(field, vel, ts, return_displacement=True, **kw)
    out, out_d = tsl.extrapolate(field, vel, ts, return_displacement=True, device="cpu", **kw)
    assert out.device.type == "cpu"
    _close(ref, out, _span(field))
    _close(ref_d, out_d, 1.0)


def test_displacement_prev_and_precip_none():
    """A chain continued from ``displacement_prev`` equals the longer run;
    ``precip=None`` advances the displacement alone."""
    field, vel = _inputs()
    _, d1 = tsl.extrapolate(None, vel, [1.0], return_displacement=True, device="cpu")
    out, d2 = tsl.extrapolate(field, vel, [1.0], displacement_prev=d1,
                              return_displacement=True, device="cpu")
    ref, ref_d = jsl.extrapolate(field, vel, [1.0, 2.0], return_displacement=True)
    _close(np.asarray(ref)[1:], out, _span(field))
    _close(ref_d, d2, 1.0)
    jnone, jd = jsl.extrapolate(None, vel, 2, return_displacement=True)
    tnone, td = tsl.extrapolate(None, vel, 2, return_displacement=True, device="cpu")
    assert jnone is None and tnone is None
    _close(jd, td, 1.0)


def test_extrapolate_errors_like_jax():
    field, vel = _inputs()
    for f, kw in ((jsl.extrapolate, {}), (tsl.extrapolate, {"device": "cpu"})):
        with pytest.raises(ValueError, match="not monotonically increasing"):
            f(field, vel, [1.0, 3.0, 2.0], **kw)
        with pytest.raises(ValueError, match="return_displacement is False"):
            f(None, vel, 2, **kw)
        with pytest.raises(NotImplementedError):
            f(field, vel, 2, interp_order=2, **kw)


@pytest.mark.parametrize("order", [0, 1, 3])
def test_semilag_step_matches_jax(order):
    field, vel = _inputs()
    disp0 = np.zeros_like(vel)
    ref, ref_d = jsl.semilag_step(jnp.asarray(field), jnp.asarray(vel), jnp.asarray(disp0),
                                  td=1.5, interp_order=order, outval=-7.0)
    out, out_d = tsl.semilag_step(torch.tensor(field), torch.tensor(vel), torch.tensor(disp0),
                                  td=1.5, interp_order=order, outval=-7.0)
    _close(ref, out, _span(field))
    _close(ref_d, out_d, 1.0)


def test_kernel_path_plain_matches_jax_exact_gather():
    """The card's path at 160^2 (the static bound 48: K1 on the 4x coarse
    velocity and for the warp), through its plain version, against the
    JAX package's exact gather on a uniform non-integer motion, on which
    the shift decomposition is exact."""
    field, _ = _inputs(160, 160)
    vel = np.zeros((2, 160, 160), np.float32)
    vel[0], vel[1] = 1.7, 0.6
    ref = jsl.extrapolate(field, vel, 4)
    out, _ = tsl._extrapolate_core(
        torch.tensor(field), torch.tensor(vel), [1.0] * 4, 1, 1, float("nan"),
        torch.zeros((2, 160, 160)), 1.0, max_disp=48,
    )
    _close(ref, out, _span(field), rel=1e-4)


@pytest.mark.parametrize("timesteps", [3, [1, 2.5]])
def test_eulerian_persistence_matches_jax(timesteps):
    field, vel = _inputs()
    ref, ref_d = jextrap.get_method("eulerian")(field, vel, timesteps, return_displacement=True)
    out, out_d = textrap.get_method("eulerian")(field, vel, timesteps, return_displacement=True,
                                                device="cpu")
    _close(ref, out, 1.0, rel=0.0)
    _close(ref_d, out_d, 1.0, rel=0.0)
    assert out_d.dtype == torch.float32


def test_registry_keys_and_errors_match_jax():
    assert list(textrap.interface._extrapolation_methods) == list(
        jextrap.interface._extrapolation_methods)
    field, vel = _inputs()
    for name in (None, "none", "None"):
        assert textrap.get_method(name)(field, vel, 2) is None
    assert textrap.get_method("SemiLagrangian") is tsl.extrapolate
    for mod in (jextrap, textrap):
        with pytest.raises(ValueError) as err:
            mod.get_method("lucas")
        assert str(err.value).startswith("unknown extrapolation method lucas; available: ")
    with pytest.raises(ValueError) as j_err:
        jextrap.get_method("lucas")
    with pytest.raises(ValueError) as t_err:
        textrap.get_method("lucas")
    assert str(j_err.value) == str(t_err.value)
