"""SSEPS in the PyTorch port (``nowcasts/sseps.py``) against the JAX
package's on the CPU at 128^2 (windows of 64, so 4 windows with their own
AR states), 3 members, on the JAX package's own draws: its per-member
white fields of each lead and its BPS Laplace draws are handed to the
port through ``noise.fftgenerators._white_normal`` and
``noise.motion._laplace``.

Tolerance, with identical NaN sets: within 5e-3 x span at every pixel,
1e-4 x span at 99% of them and 1e-5 x span on average.  A lead runs five
sort-based CDF matches (four windows and the whole field); each sorts
packed, quantized values, so a rounding difference can swap two pixels
of tied rank and move each to the neighbouring target quantile: 0.1% to
0.4% of the pixels a lead here, by up to 3.6e-3 x span where the
quantiles lie far apart.  The window AR fits within 1e-4 x their size, the
window boxes and composition masks equal.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from helpers import make_synthetic_sequence  # noqa: E402

from pysteps_tpu import nowcasts as jnowcasts  # noqa: E402
from pysteps_tpu.noise.motion import _laplace as j_laplace  # noqa: E402
from pysteps_tpu.nowcasts import sseps as jsseps  # noqa: E402
from pysteps_tpu_torch import nowcasts as tnowcasts  # noqa: E402
from pysteps_tpu_torch.noise import fftgenerators as tfft  # noqa: E402
from pysteps_tpu_torch.noise import motion as tmotion  # noqa: E402
from pysteps_tpu_torch.nowcasts import sseps as tsseps  # noqa: E402

SIDE, E, SEED = 128, 3, 5
META = {"accutime": 5, "unit": "dBZ", "transform": "dB", "zerovalue": -15.0,
        "threshold": -10.0, "xpixelsize": 1000.0, "ypixelsize": 1000.0}
KW = dict(n_ens_members=E, n_cascade_levels=6, win_size=64, seed=SEED)


@pytest.fixture(scope="module")
def inputs():
    frames = make_synthetic_sequence(
        n_frames=3, shape=(2 * SIDE, 2 * SIDE), velocity=(3.4, 1.2), seed=42,
    )[:, ::2, ::2]
    db = np.where(frames >= 0.1, 10.0 * np.log10(np.maximum(frames, 0.1)), -15.0)
    vel = np.zeros((2, SIDE, SIDE), np.float32)
    vel[0], vel[1] = 1.7, 0.6
    return db.astype(np.float32), vel


def _jax_draws(T):
    """The JAX package's draws: white fields per lead (E, m, n) from the
    key chain fold_in(key_members, i) split once a lead, and the two BPS
    Laplace vectors from split(key_vel, 2E)."""
    key_members, key_vel = jax.random.split(jax.random.PRNGKey(SEED))
    keys = [jax.random.fold_in(key_members, i) for i in range(E)]
    white = []
    for _ in range(T):
        lead = []
        for i in range(E):
            keys[i], k_noise = jax.random.split(keys[i])
            lead.append(np.asarray(jax.random.normal(k_noise, (SIDE, SIDE), jnp.float32)))
        white.append(torch.tensor(np.stack(lead)))
    vkeys = jax.random.split(key_vel, 2 * E)
    laplace = [torch.tensor(np.asarray(jax.vmap(j_laplace)(vkeys[:E]))),
               torch.tensor(np.asarray(jax.vmap(j_laplace)(vkeys[E:])))]
    return white, laplace


def _with_jax_draws(monkeypatch, T):
    white, laplace = _jax_draws(T)
    w_it, l_it = iter(white), iter(laplace)
    monkeypatch.setattr(tfft, "_white_normal", lambda g, shape, batch: next(w_it))
    monkeypatch.setattr(tmotion, "_laplace", lambda g, shape: next(l_it))


def _close(ref, out):
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    assert ref.shape == out.shape
    assert np.array_equal(np.isnan(ref), np.isnan(out))
    span = float(np.nanmax(ref) - np.nanmin(ref))
    diff = np.abs(np.nan_to_num(ref) - np.nan_to_num(out))
    assert diff.max() <= 5e-3 * span, diff.max() / span
    assert (diff <= 1e-4 * span).mean() >= 0.99
    assert diff.mean() <= 1e-5 * span, diff.mean() / span


@pytest.fixture(scope="module")
def jax_runs(inputs):
    db, vel = inputs
    return {
        "plain": np.asarray(jnowcasts.get_method("sseps")(db, dict(META), vel, 5, **KW)),
        "bps": np.asarray(jnowcasts.get_method("sseps")(db, dict(META), vel, 3,
                                                       vel_pert_method="bps", **KW)),
    }


def test_sseps_matches_jax(inputs, jax_runs, monkeypatch):
    db, vel = inputs
    _with_jax_draws(monkeypatch, 5)
    frames = []
    out = tnowcasts.get_method("sseps")(db, dict(META), vel, 5, device="cpu",
                                        callback=frames.append, **KW)
    assert out.device.type == "cpu" and out.shape == (E, 5, SIDE, SIDE)
    _close(jax_runs["plain"], out.numpy())
    assert len(frames) == 5
    for t, f in enumerate(frames):
        assert isinstance(f, np.ndarray)
        np.testing.assert_array_equal(f, out[:, t].numpy())


def test_sseps_bps_matches_jax(inputs, jax_runs, monkeypatch):
    db, vel = inputs
    _with_jax_draws(monkeypatch, 3)
    out = tnowcasts.get_method("sseps")(db, dict(META), vel, 3, vel_pert_method="bps",
                                        device="cpu", **KW)
    _close(jax_runs["bps"], out.numpy())


def test_sseps_streams_chunks_and_returns_none(inputs, jax_runs, monkeypatch):
    """``return_output=False`` with a callback: the loop's buffer holds 4
    leads (the JAX package's chunk), the frames arrive as numpy arrays and
    equal the returning run's on the same draws."""
    db, vel = inputs
    _with_jax_draws(monkeypatch, 5)
    full = tnowcasts.get_method("sseps")(db, dict(META), vel, 5, device="cpu", **KW)
    _with_jax_draws(monkeypatch, 5)
    frames, buffers = [], []
    real_stream = tsseps.nowcast_utils.stream_leads
    monkeypatch.setattr(tsseps.nowcast_utils, "stream_leads",
                        lambda out, k, cb: (buffers.append((out.shape[1], k)),
                                            real_stream(out, k, cb)))
    res = tnowcasts.get_method("sseps")(db, dict(META), vel, 5, device="cpu",
                                        callback=frames.append, return_output=False,
                                        measure_time=True, **KW)
    assert res[0] is None and res[1] >= 0.0 and res[2] >= 0.0
    assert buffers == [(4, 4), (4, 1)]
    assert len(frames) == 5 and all(isinstance(f, np.ndarray) for f in frames)
    np.testing.assert_array_equal(np.stack(frames, axis=1), full.numpy())
    _close(jax_runs["plain"], np.stack(frames, axis=1))


def test_sseps_window_pieces_match_jax(inputs):
    db, _ = inputs
    rng = np.random.default_rng(6)
    for shape, win, overlap in (((128, 128), (64, 64), 0.1), ((100, 130), (48, 64), 0.3)):
        j_grid, j_bounds = jsseps._window_bounds(shape, win, overlap)
        assert tsseps._window_bounds(shape, win, overlap) == (j_grid, j_bounds)
        for b in j_bounds:
            np.testing.assert_array_equal(tsseps._flat_hanning_mask(shape, b),
                                          jsseps._flat_hanning_mask(shape, b))
    casc = rng.normal(size=(6, 3, 40, 56)).astype(np.float32)
    casc[:, 1] += 0.8 * casc[:, 2]
    for p in (1, 2):
        ref = jsseps._window_ar_params(jnp.asarray(casc[:, -(p + 1):]), p)
        out = tsseps._window_ar_params(torch.tensor(casc[:, -(p + 1):]), p)
        for r, o in zip(ref, out):
            r = np.asarray(r)
            assert o.dtype == torch.float32 and o.shape == r.shape
            assert np.max(np.abs(o.numpy() - r)) <= 1e-4 * np.max(np.abs(r))


def test_sseps_no_rain_exit_gives_numpy_frames(inputs):
    db, vel = inputs
    dry = np.full_like(db, -15.0)
    frames = []
    ref = np.asarray(jnowcasts.get_method("sseps")(dry, dict(META), vel, 2, **KW))
    out = tnowcasts.get_method("sseps")(dry, dict(META), vel, 2, device="cpu",
                                        callback=frames.append, **KW)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert len(frames) == 2 and all(isinstance(f, np.ndarray) for f in frames)
