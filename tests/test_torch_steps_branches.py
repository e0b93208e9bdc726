"""Branches of the STEPS scan beyond the headline configuration, through
the public ``forecast`` of the PyTorch port against the JAX package's on
the CPU: the spatial domain, the obs / sprog / no mask, mean / no
matching, ``conditional``, sequential member chunks, bfloat16 output and
a list of (fractional) lead times; and the host-side gate in front of
the scan (tapering windows, the no-rain check and its early exit).

Each case is deterministic (no noise, no velocity perturbation), so the
two must agree value by value: within 1e-3 x span with identical NaN
sets, as the headline deterministic case; in bfloat16, within one bf16
step (2^-7) of the largest magnitude, since values a rounding apart in
f32 may round to neighbouring bf16 numbers.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from helpers import make_synthetic_sequence  # noqa: E402

from pysteps_tpu import nowcasts as jnowcasts  # noqa: E402
from pysteps_tpu.utils import check_norain as jnorain  # noqa: E402
from pysteps_tpu.utils import tapering as jtaper  # noqa: E402
from pysteps_tpu_torch import nowcasts as tnowcasts  # noqa: E402
from pysteps_tpu_torch.utils import check_norain as tnorain  # noqa: E402
from pysteps_tpu_torch.utils import tapering as ttaper  # noqa: E402

SIDE = 64
BASE = dict(
    n_ens_members=2, n_cascade_levels=6, precip_thr=-10.0, kmperpixel=1.0,
    timestep=5, noise_method=None, vel_pert_method=None, seed=3,
)
CASES = {
    "spatial-obs-mean-conditional-list": (
        dict(domain="spatial", mask_method="obs", probmatching_method="mean",
             conditional=True),
        [1, 2.5, 3],
    ),
    "spectral-sprog-nomatch-chunked": (
        dict(domain="spectral", mask_method="sprog", probmatching_method=None,
             member_chunk=1),
        3,
    ),
    "spatial-incremental-cdf": (
        dict(domain="spatial", mask_method="incremental", probmatching_method="cdf"),
        3,
    ),
    "spectral-nomask-cdf-bf16": (
        dict(domain="spectral", mask_method=None, probmatching_method="cdf",
             output_dtype="bfloat16"),
        3,
    ),
}


def _inputs():
    """Three dB frames with dry areas and a non-integer motion (1.7, 0.6)
    px per step, so no sampling position sits on the domain edge."""
    frames = make_synthetic_sequence(
        n_frames=3, shape=(2 * SIDE, 2 * SIDE), velocity=(3.4, 1.2), seed=5,
    )[:, ::2, ::2]
    precip = np.where(
        frames >= 0.1, 10.0 * np.log10(np.maximum(frames, 0.1)), -15.0
    ).astype(np.float32)
    velocity = np.zeros((2, SIDE, SIDE), np.float32)
    velocity[0], velocity[1] = 1.7, 0.6
    return precip, velocity


@pytest.mark.parametrize("case", sorted(CASES))
def test_branch_matches_jax(case):
    extra, timesteps = CASES[case]
    precip, velocity = _inputs()
    kw = dict(BASE, **extra)
    ref = np.asarray(
        jnp.asarray(jnowcasts.get_method("steps")(precip, velocity, timesteps, **kw),
                    jnp.float32)
    )
    out = tnowcasts.get_method("steps")(precip, velocity, timesteps, device="cpu", **kw)
    n_t = timesteps if isinstance(timesteps, int) else len(timesteps)
    assert out.shape == (2, n_t, SIDE, SIDE)
    assert out.dtype == getattr(torch, kw.get("output_dtype", "float32"))
    out = out.float().numpy()
    assert np.array_equal(np.isnan(ref), np.isnan(out))
    assert np.isfinite(ref).mean() > 0.5
    if kw.get("output_dtype") == "bfloat16":
        tol = 2.0**-7 * float(np.nanmax(np.abs(ref)))
    else:
        tol = 1e-3 * float(np.nanmax(ref) - np.nanmin(ref))
    err = float(np.nanmax(np.abs(np.nan_to_num(ref) - np.nan_to_num(out))))
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("func", ["hann", "tukey"])
@pytest.mark.parametrize("shape", [(64, 64), (48, 81)])
def test_window_functions(func, shape):
    ref = np.asarray(jtaper.compute_window_function(*shape, func))
    np.testing.assert_allclose(ttaper.compute_window_function(*shape, func), ref, atol=1e-12)


@pytest.mark.parametrize("win_fun", [None, "tukey"])
@pytest.mark.parametrize("norain_thr", [0.0, 0.05, 0.5])
def test_check_norain(win_fun, norain_thr):
    precip, _ = _inputs()
    for thr in (None, -10.0, 5.0):
        ref = jnorain.check_norain(precip, thr, norain_thr, win_fun, printmsg=False)
        out = tnorain.check_norain(precip, thr, norain_thr, win_fun, printmsg=False)
        assert out == bool(ref)


def _edge_field(thr, dtype, seed):
    """(3, 24, 20) values on the threshold's edge: the largest float32 at
    most ``thr``, the float32 nearest it and the next one up, some far
    below, some NaN (``thr`` None: around a minimum of -15)."""
    rng = np.random.RandomState(seed)
    t32 = np.float32(-15.0 if thr is None else thr)
    edge = np.array([np.nextafter(t32, np.float32(-np.inf)), t32,
                     np.nextafter(t32, np.float32(np.inf)), np.float32(-20.0)])
    if thr is None:
        edge = edge[1:3]
    field = rng.choice(edge, size=(3, 24, 20)).astype(dtype)
    field[rng.rand(*field.shape) < 0.05] = np.nan
    return field


def _numpy_rain_count(field, thr, win_fun):
    """The numpy path's count of rain pixels."""
    taper = (ttaper.compute_window_function(*field.shape[-2:], win_fun) if win_fun
             else np.ones(field.shape[-2:]))
    masked = np.array(field, dtype=float)
    masked[..., taper == 0.0] = np.nanmin(field)
    return int(np.sum(masked > (np.nanmin(masked) if thr is None else thr)))


@pytest.mark.parametrize("win_fun", [None, "tukey"])
@pytest.mark.parametrize("thr", [None, -10.0, 0.1])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_check_norain_tensor_path_on_the_threshold_edge(win_fun, thr, dtype):
    """A tensor is gated on its own device (``rain_count``) with the numpy
    path's answer: values at the threshold, one float32 step either side
    of it, a threshold float32 cannot hold (0.1), NaN pixels, and a rain
    fraction exactly at ``norain_thr``."""
    for seed in range(3):
        field = _edge_field(thr, dtype, seed)
        count = _numpy_rain_count(field, thr, win_fun)
        assert 0 < count < field.size
        assert int(tnorain.rain_count(torch.as_tensor(field), thr, win_fun)) == count
        frac = count / field.size
        for norain_thr in (0.0, frac, np.nextafter(frac, 0.0), np.nextafter(frac, 1.0)):
            ref = tnorain.check_norain(field, thr, norain_thr, win_fun, printmsg=False)
            out = tnorain.check_norain(torch.as_tensor(field), thr, norain_thr, win_fun,
                                       printmsg=False)
            assert out == ref == (frac <= norain_thr)


@pytest.mark.parametrize("timesteps", [3, [1, 2.5]])
def test_norain_forecast_exits_early(timesteps):
    """An all-dry input skips the scan: every member and lead holds the
    input's minimum, as in the JAX package."""
    precip, velocity = _inputs()
    precip = np.full_like(precip, -15.0)
    kw = dict(BASE, precip_thr=-10.0, noise_method="nonparametric")
    ref = np.asarray(jnowcasts.get_method("steps")(precip, velocity, timesteps, **kw))
    out = tnowcasts.get_method("steps")(precip, velocity, timesteps, device="cpu", **kw)
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out.numpy(), ref)
