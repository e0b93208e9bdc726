"""The shared nowcast machinery of the PyTorch port
(``nowcasts/utils.py``: ``dilation_kernel``, ``stack_cascades``,
``binned_timesteps``, ``create_timestep_range``, ``print_ar_params``,
``print_corrcoefs``, ``nowcast_main_loop``, and the no-rain exit's
callback) against the JAX package on the CPU.

The tables must print the same text; the main loop's frames, which are
host numpy arrays in both, within 1e-5 x span with identical NaN sets
(each is one exact bilinear warp of the same field).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pysteps_tpu.nowcasts import utils as jutils
from pysteps_tpu_torch.nowcasts import utils as tutils

M, N = 48, 64


@pytest.mark.parametrize("rim", [0, 1, 3])
def test_dilation_kernel(rim):
    np.testing.assert_array_equal(tutils.dilation_kernel(rim), jutils.dilation_kernel(rim))


def test_stack_cascades():
    rng = np.random.default_rng(0)
    decomps = [{"cascade_levels": rng.normal(size=(4, 8, 8)).astype(np.float32)}
               for _ in range(3)]
    ref = jutils.stack_cascades(
        [{"cascade_levels": jnp.asarray(d["cascade_levels"])} for d in decomps], 3)
    out = tutils.stack_cascades(
        [{"cascade_levels": torch.tensor(d["cascade_levels"])} for d in decomps], 3)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("timesteps", [[0, 0.5, 1, 2.25, 3], [1.5], [0, 2, 5]])
def test_binned_timesteps_and_range(timesteps):
    assert tutils.binned_timesteps(timesteps) == jutils.binned_timesteps(timesteps)
    t_range, t_orig, kind = tutils.create_timestep_range(timesteps[1:] or timesteps)
    j_range, j_orig, j_kind = jutils.create_timestep_range(timesteps[1:] or timesteps)
    assert (list(t_range), t_orig, kind) == (list(j_range), j_orig, j_kind)
    assert list(tutils.create_timestep_range(4)[0]) == list(jutils.create_timestep_range(4)[0])


def test_binned_timesteps_errors():
    for bad, msg in (([1, 0.5], "ascending"), ([-1, 2], "negative")):
        for mod in (jutils, tutils):
            with pytest.raises(ValueError, match=msg):
                mod.binned_timesteps(bad)


def test_tables_print_the_same_text(capsys):
    rng = np.random.default_rng(1)
    phi = rng.normal(size=(6, 3)).astype(np.float32)
    gamma = rng.uniform(-1, 1, size=(6, 2)).astype(np.float32)
    jutils.print_ar_params(jnp.asarray(phi))
    jutils.print_corrcoefs(jnp.asarray(gamma))
    ref = capsys.readouterr().out
    tutils.print_ar_params(torch.tensor(phi))
    tutils.print_corrcoefs(torch.tensor(gamma))
    assert capsys.readouterr().out == ref
    assert "Phi-0" in ref and "gamma_2=" in ref


def _loop_inputs():
    rng = np.random.default_rng(2)
    field = (rng.gamma(1.0, 2.0, (M, N))).astype(np.float32)
    vel = np.zeros((2, M, N), np.float32)
    vel[0], vel[1] = 1.3, -0.7
    return field, vel


def _decay(state, params):
    """A model step: the ensemble (or field) decays by ``params``."""
    new = state * params
    return new, new


@pytest.mark.parametrize("ensemble", [False, True])
@pytest.mark.parametrize("timesteps", [3, [0.5, 1.5, 2.0, 3.25]])
def test_nowcast_main_loop_matches_jax(ensemble, timesteps):
    field, vel = _loop_inputs()
    state = np.stack([field, 2.0 * field]) if ensemble else field
    frames = {"jax": [], "torch": []}
    kw = dict(extrap_kwargs={"interp_order": 1}, params=np.float32(0.9), ensemble=ensemble)
    ref = jutils.nowcast_main_loop(field, vel, state, timesteps, "semilagrangian", _decay,
                                   callback=frames["jax"].append, **kw)
    out = tutils.nowcast_main_loop(field, vel, state, timesteps, "semilagrangian", _decay,
                                   callback=frames["torch"].append, device="cpu", **kw)
    assert isinstance(out, np.ndarray) and out.shape == ref.shape
    span = float(np.nanmax(ref) - np.nanmin(ref))
    pairs = [(ref, out)] + list(zip(frames["jax"], frames["torch"]))
    assert len(frames["torch"]) == len(frames["jax"]) > 0
    for r, o in pairs:
        assert isinstance(o, np.ndarray)
        assert np.array_equal(np.isnan(r), np.isnan(o))
        assert np.nanmax(np.abs(np.nan_to_num(r) - np.nan_to_num(o))) <= 1e-5 * span


def test_nowcast_main_loop_eulerian_and_timing():
    field, vel = _loop_inputs()
    out, secs = tutils.nowcast_main_loop(field, vel, field, 2, "eulerian", _decay,
                                         params=np.float32(0.5), measure_time=True,
                                         device="cpu")
    ref, _ = jutils.nowcast_main_loop(field, vel, field, 2, "eulerian", _decay,
                                      params=np.float32(0.5), measure_time=True)
    np.testing.assert_array_equal(out, np.asarray(ref))
    assert secs >= 0.0


def test_zero_precipitation_callback_gets_numpy():
    precip = np.full((3, 8, 8), -15.0, np.float32)
    frames = []
    out = tutils.zero_precipitation_forecast(2, 3, precip, torch.device("cpu"),
                                             callback=frames.append)
    assert out.shape == (2, 3, 8, 8) and len(frames) == 3
    for t, f in enumerate(frames):
        assert isinstance(f, np.ndarray) and f.shape == (2, 8, 8)
        np.testing.assert_array_equal(f, out[:, t].numpy())
