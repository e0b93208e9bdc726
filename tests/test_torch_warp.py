"""Kernels K1 (axis resample) and K2 (separable warp) of the PyTorch port,
through their plain versions, and the warp primitives built on them,
held against the JAX package on the CPU.

The Pallas kernels run in interpret mode.  Tolerance: 1e-5 x span of the
field (every output is one or two f32 lerps), with identical NaN sets.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pysteps_tpu.extrapolation import semilagrangian as jsl
from pysteps_tpu.ops import pallas_warp as jpw
from pysteps_tpu.ops import warp as jwarp
from pysteps_tpu_torch.extrapolation import semilagrangian as tsl
from pysteps_tpu_torch.ops import pallas_warp as tpw
from pysteps_tpu_torch.ops import warp as twarp


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jpw, "INTERPRET", True)


def _close(ref, out, span):
    ref, out = np.asarray(ref), np.asarray(out)
    assert ref.shape == out.shape
    assert np.array_equal(np.isnan(ref), np.isnan(out))
    err = np.nanmax(np.abs(np.nan_to_num(ref) - np.nan_to_num(out)))
    assert err <= 1e-5 * span, (err, span)


def _field(rng, m, n):
    return (rng.normal(0.0, 5.0, (m, n)) + 10.0).astype(np.float32)


def _smooth_disp(rng, m, n, amp):
    """A smooth (2, m, n) displacement reaching about +-amp pixels."""
    yy, xx = np.meshgrid(np.linspace(0, 3, m), np.linspace(0, 2, n), indexing="ij")
    a, b = rng.uniform(0.5, 1.0, 2)
    dx = amp * (a * np.sin(xx + yy) + 0.1)
    dy = -amp * (b * np.cos(0.7 * xx - yy) - 0.15)
    return np.stack([dx, dy]).astype(np.float32)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("D", [13, 24])
def test_k1_plain_matches_pallas_and_xla(axis, D):
    """|disp| reaches 20 > 13, and 13 is not a multiple of 8: pins the
    clip to [p - D, p + D] with the D given, then to the edges."""
    rng = np.random.default_rng(axis * 100 + D)
    m, n = 64, 96
    field = _field(rng, m, n)
    disp = _smooth_disp(rng, m, n, 20.0)[1 - axis]
    pos = np.arange(field.shape[axis], dtype=np.float32)
    pos = pos[:, None] if axis == 0 else pos[None, :]
    c = pos + disp
    idx0 = np.floor(c).astype(np.int32)
    frac = (c - np.floor(c)).astype(np.float32)

    ref_pallas = jpw.axis_resample_pallas(
        jnp.asarray(field), jnp.asarray(idx0), jnp.asarray(frac), D, axis
    )
    ref_xla = jwarp._axis_resample(
        jnp.asarray(field), jnp.asarray(idx0), jnp.asarray(frac), D, axis
    )
    # two channels sharing one index plane, as warp_shifted_multi calls it
    f2 = torch.from_numpy(np.stack([field, field[::-1].copy()]))
    out = tpw.axis_resample(
        f2, torch.from_numpy(idx0)[None], torch.from_numpy(frac)[None], D, axis
    )
    span = float(np.ptp(field))
    _close(ref_pallas, out[0], span)
    _close(ref_xla, out[0], span)
    ref2 = jwarp._axis_resample(
        jnp.asarray(field[::-1].copy()), jnp.asarray(idx0), jnp.asarray(frac), D, axis
    )
    _close(ref2, out[1], span)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("D,amp", [(13, 20.0), (48, 6.0)])
def test_k2_plain_matches_pallas_and_warp_shifted(masked, D, amp):
    """K2 clips with D rounded up to 8 (13 -> 16), as warp_fused_pallas
    does; warp_shifted with that bound computes the same function."""
    rng = np.random.default_rng(int(amp) + D + masked)
    m, n = 64, 96
    field = _field(rng, m, n)
    disp = _smooth_disp(rng, m, n, amp)
    dy = disp[1]
    disp_t = np.ascontiguousarray(disp.transpose(0, 2, 1))
    cval = np.nan
    ref = jpw.warp_fused_pallas(
        jnp.asarray(field), jnp.asarray(dy), jnp.asarray(disp_t), D,
        jnp.float32(cval), masked=masked,
    )
    out = tpw.warp_fused(
        torch.from_numpy(field)[None], torch.from_numpy(dy)[None],
        torch.from_numpy(disp_t)[None], D, cval, masked=masked,
    )[0]
    span = float(np.ptp(field))
    _close(ref, out, span)
    D8 = -(-D // 8) * 8
    ref_ws = jwarp.warp_shifted(
        jnp.asarray(field), jnp.asarray(disp), D8,
        mode="constant" if masked else "nearest", cval=cval,
    )
    _close(ref_ws, out, span)


def test_warp_shifted_multi_and_exact_warp():
    rng = np.random.default_rng(5)
    m, n = 48, 64
    fields = np.stack([_field(rng, m, n), _field(rng, m, n)])
    disp = _smooth_disp(rng, m, n, 7.0)
    span = float(np.ptp(fields))
    for mode in ("constant", "nearest"):
        ref = jwarp.warp_shifted_multi(
            jnp.asarray(fields), jnp.asarray(disp), 9, mode=mode
        )
        out = twarp.warp_shifted_multi(
            torch.from_numpy(fields), torch.from_numpy(disp), 9, mode=mode
        )
        _close(ref, out, span)
        ref = jwarp.warp(jnp.asarray(fields[0]), jnp.asarray(disp), mode=mode)
        out = twarp.warp(torch.from_numpy(fields[0]), torch.from_numpy(disp), mode=mode)
        _close(ref, out, span)


@pytest.mark.parametrize("coarse", [1, 4])
def test_sample_velocity_shifted(coarse):
    """With coarse=4 the JAX package upsamples with jax.image.resize
    (bilinear); the port's upsampling matrices must reproduce it."""
    rng = np.random.default_rng(coarse)
    m, n = 64, 64
    vel = _smooth_disp(rng, m, n, 3.0)
    disp = _smooth_disp(rng, m, n, 10.0)
    ref = jwarp.sample_velocity_shifted(
        jnp.asarray(vel), jnp.asarray(disp), 16, coarse=coarse
    )
    out = twarp.sample_velocity_shifted(
        torch.from_numpy(vel), torch.from_numpy(disp), 16, coarse=coarse
    )
    _close(ref, out, float(np.ptp(vel)))


def test_bilinear_upsample_matches_jax_image_resize():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 16, 24)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, 64, 96), method="bilinear")
    out = twarp.bilinear_upsample(torch.from_numpy(x), (64, 96))
    _close(ref, out, float(np.ptp(x)))


@pytest.mark.parametrize("max_disp", [None, 24])
def test_integrate_displacement(max_disp):
    rng = np.random.default_rng(3)
    m, n = 64, 64
    vel = _smooth_disp(rng, m, n, 2.5)
    disp = _smooth_disp(rng, m, n, 4.0)
    ref = jsl.integrate_displacement(
        jnp.asarray(vel), jnp.asarray(disp), 1.0, n_iter=1, max_disp=max_disp
    )
    out = tsl.integrate_displacement(
        torch.from_numpy(vel), torch.from_numpy(disp), 1.0, n_iter=1,
        max_disp=max_disp,
    )
    _close(ref, out, float(np.ptp(np.asarray(ref))))


def test_coarse_chain_upsample_and_model_warp_coarse():
    """integrate_displacement_coarse, upsample_planes and
    model_warp_coarse for a 2-member batch against the JAX functions
    called per member (JAX's model_warp_coarse takes warp_shifted on the
    CPU, the port K2: the same function at D = 48)."""
    rng = np.random.default_rng(9)
    m, n, coarse = 64, 64, 4
    vel = _smooth_disp(rng, m, n, 1.7)
    field = np.stack([_field(rng, m, n), _field(rng, m, n)])
    vel_c_j = jsl.coarsen_velocity(jnp.asarray(vel), coarse)
    vel_c_t = tsl.coarsen_velocity(torch.from_numpy(vel), coarse)
    _close(vel_c_j, vel_c_t, float(np.ptp(vel)))

    d_j = [jnp.zeros((2, m // coarse, n // coarse), jnp.float32)] * 2
    d_t = torch.zeros((2, 2, m // coarse, n // coarse))
    for _ in range(3):
        d_j = [
            jsl.integrate_displacement_coarse(vel_c_j, d, 1.0, max_disp=48, coarse=coarse)
            for d in d_j
        ]
        d_t = tsl.integrate_displacement_coarse(vel_c_t, d_t, 1.0, max_disp=48, coarse=coarse)
    span = float(np.ptp(np.asarray(d_j[0])))
    for b in range(2):
        _close(d_j[b], d_t[b], span)
        dy_j, dt_j = jsl.upsample_planes(d_j[b], (m, n), coarse)
        dy_t, dt_t = tsl.upsample_planes(d_t[b], (m, n), coarse)
        _close(dy_j, dy_t, span)
        _close(dt_j, dt_t, span)
    out = tsl.model_warp_coarse(
        torch.from_numpy(field), d_t, (m, n), coarse, max_disp=48
    )
    for b in range(2):
        ref = jsl.model_warp_coarse(
            jnp.asarray(field[b]), d_j[b], (m, n), coarse, max_disp=48
        )
        _close(ref, out[b], float(np.ptp(field)))


@pytest.mark.parametrize("coarse", [1, 4])
def test_upsample_planes_batched(coarse):
    """The port's upsample_planes on a (B, 2, mc, nc) batch gives, member
    by member, the JAX function's dy (m, n) and disp_t (2, n, m): the
    planes the chain and K2 read."""
    rng = np.random.default_rng(5)
    m, n, B = 64, 96, 3
    disp_c = rng.normal(0.0, 3.0, (B, 2, m // coarse, n // coarse)).astype(np.float32)
    dy_t, dt_t = tsl.upsample_planes(torch.from_numpy(disp_c), (m, n), coarse)
    assert dy_t.shape == (B, m, n) and dt_t.shape == (B, 2, n, m)
    assert dy_t.is_contiguous() and dt_t.is_contiguous()
    for b in range(B):
        dy_j, dt_j = jsl.upsample_planes(jnp.asarray(disp_c[b]), (m, n), coarse)
        _close(dy_j, dy_t[b], float(np.ptp(disp_c)))
        _close(dt_j, dt_t[b], float(np.ptp(disp_c)))
