"""STEPS options of the PyTorch port that this slice opened, on the CPU:
the callback's frames (host numpy arrays, as the JAX package hands them
over), the streaming callback (``callback`` with ``return_output=False``:
chunks of at most 6 leads, ``None`` returned) and ``interp_order`` 0 and
3 in the deterministic configuration against the JAX package.

The streamed frames run the same draws in the same order as the full
run, so they must be equal; orders 0 and 3 with identical NaN sets and
the tolerances of ``test_interp_orders_match_jax``.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from helpers import make_synthetic_sequence  # noqa: E402

from pysteps_tpu import nowcasts as jnowcasts  # noqa: E402
from pysteps_tpu_torch import nowcasts as tnowcasts  # noqa: E402
from pysteps_tpu_torch.nowcasts import steps as tsteps  # noqa: E402

SIDE = 64
KW = dict(
    n_ens_members=3, n_cascade_levels=6, precip_thr=-10.0, kmperpixel=1.0, timestep=5,
    noise_method="nonparametric", vel_pert_method="bps", mask_method="incremental",
    probmatching_method="cdf", domain="spectral", seed=7,
)


@pytest.fixture(scope="module")
def inputs():
    frames = make_synthetic_sequence(
        n_frames=3, shape=(2 * SIDE, 2 * SIDE), velocity=(3.4, 1.2), seed=5,
    )[:, ::2, ::2]
    db = np.where(frames >= 0.1, 10.0 * np.log10(np.maximum(frames, 0.1)), -15.0)
    vel = np.zeros((2, SIDE, SIDE), np.float32)
    vel[0], vel[1] = 1.7, 0.6
    return db.astype(np.float32), vel


def test_callback_gets_numpy_frames_of_the_forecast(inputs):
    db, vel = inputs
    frames = []
    out = tnowcasts.get_method("steps")(db, vel, 4, device="cpu", callback=frames.append, **KW)
    assert len(frames) == 4
    for t, f in enumerate(frames):
        assert isinstance(f, np.ndarray) and f.shape == (3, SIDE, SIDE)
        np.testing.assert_array_equal(f, out[:, t].numpy())


@pytest.mark.parametrize("T,chunks", [(8, [(6, 6), (6, 2)]), (3, [(3, 3)])])
def test_streaming_callback_equals_the_full_run(inputs, monkeypatch, T, chunks):
    db, vel = inputs
    full = tnowcasts.get_method("steps")(db, vel, T, device="cpu", **KW)
    frames, buffers = [], []
    real = tsteps.nowcast_utils.stream_leads
    monkeypatch.setattr(tsteps.nowcast_utils, "stream_leads",
                        lambda out, k, cb: (buffers.append((out.shape[1], k)), real(out, k, cb)))
    res = tnowcasts.get_method("steps")(db, vel, T, device="cpu", callback=frames.append,
                                        return_output=False, measure_time=True, **KW)
    assert res[0] is None and res[1] >= 0.0 and res[2] >= 0.0
    assert buffers == chunks
    assert all(isinstance(f, np.ndarray) for f in frames)
    np.testing.assert_array_equal(np.stack(frames, axis=1), full.numpy())


def test_return_output_false_without_callback_returns_none(inputs):
    db, vel = inputs
    assert tnowcasts.get_method("steps")(db, vel, 2, device="cpu", return_output=False,
                                         **KW) is None


@pytest.mark.parametrize("return_output", [True, False])
def test_no_rain_exit_callback_gets_numpy(inputs, return_output):
    db, vel = inputs
    dry = np.full_like(db, -15.0)
    frames = []
    out = tnowcasts.get_method("steps")(dry, vel, 3, device="cpu", callback=frames.append,
                                        return_output=return_output, **KW)
    ref = np.asarray(jnowcasts.get_method("steps")(dry, vel, 3, **KW))
    assert len(frames) == 3
    for t, f in enumerate(frames):
        assert isinstance(f, np.ndarray)
        np.testing.assert_array_equal(f, ref[:, t])
    assert (out is None) == (not return_output)


@pytest.mark.parametrize("probmatching", ["cdf", None])
@pytest.mark.parametrize("order", [0, 3])
def test_interp_orders_match_jax(inputs, order, probmatching):
    """Without matching, within 1e-4 x span.  With the sort-based CDF
    match, 99% of the pixels within 1e-3 x span (the deterministic STEPS
    tolerance), 1e-4 x span on average and all within 5e-3 x span: the
    nearest warp copies pixels, and the copies' tied ranks go to
    neighbouring target quantiles in whichever order rounding leaves
    them."""
    db, vel = inputs
    kw = dict(KW, noise_method=None, vel_pert_method=None, probmatching_method=probmatching,
              extrap_kwargs={"interp_order": order})
    ref = np.asarray(jnowcasts.get_method("steps")(db, vel, 3, **kw))
    out = tnowcasts.get_method("steps")(db, vel, 3, device="cpu", **kw).numpy()
    assert np.array_equal(np.isnan(ref), np.isnan(out))
    span = float(np.nanmax(ref) - np.nanmin(ref))
    diff = np.abs(np.nan_to_num(ref) - np.nan_to_num(out))
    if probmatching is None:
        assert diff.max() <= 1e-4 * span
    else:
        assert diff.max() <= 5e-3 * span
        assert (diff <= 1e-3 * span).mean() >= 0.99 and diff.mean() <= 1e-4 * span
